"""Counter-based Philox4x32-10 RNG, bit-equal to pathtrace_tpu/utils/rng.py.

Every draw is a pure function of (key, logical ray id, path-local
iteration, column), so the port traces the same paths as the JAX
reference and the CUDA kernel (csrc/bounce_kernel.cu) draws the same bits.

torch.uint32 has no shifts on the CPU, so words live in int64 tensors
masked to 32 bits. The 32x32 product is split into 16-bit limbs as in
rng.py:49-61: no intermediate leaves int64's positive range.

Column layout per (ray, iteration) - one row of `uniforms(...)`:
  0: NEE light pick, 1-2: NEE area sample, 3: lobe selector,
  4: microfacet/hemisphere phi, 5: microfacet ry / hemi cos,
  6: russian roulette, 7: reserved.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_COLS = 8

_MASK = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85

COL_LIGHT_PICK = 0
COL_NEE_R1 = 1
COL_NEE_R2 = 2
COL_LOBE = 3
COL_PHI = 4
COL_RY = 5
COL_RR = 6

STREAM_PATH = 0x50415448    # "PATH": bounce-loop draws
STREAM_JITTER = 0x4A495454  # "JITT": subpixel jitter


def _mulhilo(a: int, b: torch.Tensor):
    """32x32 -> (hi, lo) words of a*b for a constant a and int64 words b."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    lo_lo = a0 * b0
    mid1 = a1 * b0
    mid2 = a0 * b1
    hi_hi = a1 * b1
    carry = ((lo_lo >> 16) + (mid1 & 0xFFFF) + (mid2 & 0xFFFF)) >> 16
    hi = hi_hi + (mid1 >> 16) + (mid2 >> 16) + carry
    lo = (lo_lo + ((mid1 + mid2) << 16)) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox4x32 keyed hash. Counters are int64 tensors (or ints) holding
    uint32 words, broadcastable; the key is two Python ints."""
    dev = next((c.device for c in (c0, c1, c2, c3) if torch.is_tensor(c)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev)
          for c in (c0, c1, c2, c3)))
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK
        k1 = (k1 + _PHILOX_W1) & _MASK
    return c0, c1, c2, c3


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1): the top 24 bits."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def make_key(seed: int) -> np.ndarray:
    """Key = uint32[2] Philox key derived from the integer seed."""
    s = np.uint32(seed & _MASK)
    s2 = np.uint32((seed >> 32) & _MASK) ^ np.uint32(0xA5A5A5A5)
    return np.stack([s, s2])


def iter_key(base_key, tag: int) -> np.ndarray:
    """Derive an independent subkey (e.g. per render pass)."""
    k0, k1 = key_words(base_key)
    c0, c1, _, _ = philox4x32(int(tag) & _MASK, 0x5EEDF01D, 0, 1, k0, k1)
    return np.asarray([int(c0), int(c1)], np.uint32)


def key_words(base_key) -> tuple[int, int]:
    """The key's two uint32 words as Python ints."""
    k = np.asarray(base_key, np.uint32)
    return int(k[0]), int(k[1])


def uniforms(base_key, ray_ids: torch.Tensor, iteration,
             num: int = NUM_COLS) -> torch.Tensor:
    """(R, num) float32 uniforms in [0, 1), a pure function of
    (key, ray_id, iteration). `iteration` is an int or a per-lane tensor."""
    assert num <= 8
    k0, k1 = key_words(base_key)
    rid = ray_ids.to(torch.int64) & _MASK
    it = torch.as_tensor(iteration, dtype=torch.int64,
                         device=rid.device).expand_as(rid) & _MASK
    outs = []
    for block in range((num + 3) // 4):
        outs.extend(philox4x32(rid, it, block, STREAM_PATH, k0, k1))
    return _to_unit_float(torch.stack(outs[:num], dim=-1))


def pixel_jitter(base_key, ray_ids: torch.Tensor) -> torch.Tensor:
    """(R, 2) subpixel jitter keyed by logical ray id."""
    k0, k1 = key_words(base_key)
    rid = ray_ids.to(torch.int64) & _MASK
    c0, c1, _, _ = philox4x32(rid, 0, 0, STREAM_JITTER, k0, k1)
    return _to_unit_float(torch.stack([c0, c1], dim=-1))


def randint_from_uniform(u: torch.Tensor, n: int) -> torch.Tensor:
    """Map u in [0,1) to an int32 in [0, n). Replaces `curand(s) % Nl`."""
    return torch.clamp((u * n).to(torch.int32), max=n - 1)


# Path ids run to 2**32 on the primal paths: they are held in int64 and
# Philox takes their low 32 bits as its counter word (uniforms,
# pixel_jitter; kernel B1's `rid`), so every id below 2**32 has its own
# stream. The JAX package holds them in int32 and wraps at 2**31 (ROADMAP
# C9). The replay and wavetape gradients keep the int32 range of the JAX
# package, their only reference (TAPE_ID_LIMIT): a wavetape of 2**31 paths
# would also hold max_iters int32 words a path, 155 GB at the default 18.
PATH_ID_LIMIT = 2 ** 32
TAPE_ID_LIMIT = 2 ** 31


def check_path_ids(num_pix: int, spp: int, sample_offset: int = 0,
                   limit: int = PATH_ID_LIMIT) -> None:
    """Raise when the path ids sample * num_pix + pixel of samples
    [sample_offset, sample_offset + spp) reach `limit`: 2**32, the width of
    the Philox counter word, where two paths would share a stream; or
    TAPE_ID_LIMIT on the replay and wavetape gradient paths."""
    if num_pix * (sample_offset + spp) >= limit:
        what = ("the Philox counter word (uint32) would repeat" if limit == PATH_ID_LIMIT
                else "the replay and wavetape gradients stop at the int32 range")
        raise ValueError(
            f"{num_pix} pixels x {sample_offset + spp} samples reaches "
            f"{num_pix * (sample_offset + spp)} path ids, the limit is {limit}: {what}")
