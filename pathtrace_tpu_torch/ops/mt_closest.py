"""Closest-hit Möller-Trumbore of every ray against every triangle: the
search of scenes without KD cells (port of
pathtrace_tpu/ops/pallas/intersect_kernel.py::mt_closest_pallas /
raycast_pallas and of the raycast_matmul / shadow_matmul contract,
ops/mt_matmul.py:125-223).

`mt_closest` returns, for each ray with its own [t_min, t_max], the closest
triangle of the scene:
- f32 Möller-Trumbore exactly as ops/intersect.py computes it (backface
  cull det >= EPS, 0 <= u <= det, v >= 0, u + v <= det, t = (q.e2)/det);
- equal t resolves to the lowest index (closest_masked), so the result
  equals raycast_brute's bit for bit;
- (hit, t, idx, u, v) with normalized barycentrics; a miss gives t = 0,
  u = v = 0 and idx = max(T - 1, 0) (brute's closest_masked, as
  mt_matmul_closest; the Pallas kernel gives 0 there: idx carries no
  meaning on a miss). An empty (0, 9) table gives every ray a miss with
  idx 0, raycast_brute's value for a scene without triangles.
  Shadow mode selects the same winner and leaves u = v = 0.

On CPU tensors `mt_closest` runs the plain version below; on CUDA tensors
it launches the hand-written kernel (csrc/mt_closest.cu through
ops/cuda/mt_closest.py) or raises. It never falls back.

raycast_mt and shadow_mt wrap it as raycast_matmul and shadow_matmul do:
the search runs detached, and raycast_mt recomputes (t, u, v)
differentiably at the winner (ops/intersect.py::finalize_hit_at).

Not carried over from the TPU path: the 16-feature coefficient fit
(build_mt_coeffs, Scene.with_mt), the (block_r, block_t) grid with its
cross-step carry, and the ray padding.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.models.scene import Scene, Triangles
from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel
from pathtrace_tpu_torch.ops.intersect import (BIG_T, HitRecord, closest_masked,
                                               detached_rows, finalize_hit_at,
                                               finalize_shadow, intersect_tris_all)

MODES = mt_kernel.MODES
# Rays x triangles per Möller-Trumbore batch of the plain version: bounds
# its (rows x T) temporaries (about 50 MB each) on large tables.
PAIR_CHUNK = 1 << 22


def _closest_rows(table, org, dirn, t_min, t_max, closest: bool):
    t, valid, u, v = intersect_tris_all(table[:, 0:3], table[:, 3:6], table[:, 6:9],
                                        org, dirn, t_min, t_max)
    best_t, idx, hit = closest_masked(torch.where(valid, t, torch.full_like(t, float("inf"))))
    zero = torch.zeros_like(best_t)
    if closest:
        pick = idx.long()[:, None]
        u = torch.where(hit, torch.gather(u, 1, pick)[:, 0], zero)
        v = torch.where(hit, torch.gather(v, 1, pick)[:, 0], zero)
    else:
        u = v = zero
    return hit, torch.where(hit, best_t, zero), idx, u, v


def mt_closest_plain(tris: Triangles, org, dirn, t_min, t_max, mode: str = "closest"):
    """The plain PyTorch version of the kernel: the all-pairs search of
    ops/intersect.py::_closest_tri, in row chunks of PAIR_CHUNK pairs."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    table = tris.search_table
    if table.shape[0] == 0:
        zero = torch.zeros((org.shape[0],), device=org.device)
        return (torch.zeros_like(zero, dtype=torch.bool), zero,
                torch.zeros_like(zero, dtype=torch.int32), zero.clone(), zero.clone())
    rows = max(1, PAIR_CHUNK // table.shape[0])
    parts = [_closest_rows(table, org[i:i + rows], dirn[i:i + rows], t_min[i:i + rows],
                           t_max[i:i + rows], mode == "closest")
             for i in range(0, max(org.shape[0], 1), rows)]
    return parts[0] if len(parts) == 1 else tuple(torch.cat(x) for x in zip(*parts))


def mt_closest(tris: Triangles, org, dirn, t_min, t_max, mode: str = "closest"):
    """(hit, t, idx, u, v) of the all-triangles search: the plain version on
    CPU tensors, the CUDA kernel on CUDA tensors; any other device raises."""
    if org.device.type == "cuda":
        return mt_kernel.launch(tris.search_table, org, dirn, t_min, t_max, mode)
    if org.device.type == "cpu":
        return mt_closest_plain(tris, org, dirn, t_min, t_max, mode)
    raise ValueError(f"no all-triangles search for device {org.device}")


def raycast_mt(scene: Scene, org, dirn, t_min=None, t_max=None, *,
               search=mt_closest) -> HitRecord:
    """Closest hit over all triangles, merged with the sphere scan
    (raycast_matmul / raycast_pallas): the winner from the detached search,
    (t, u, v) recomputed differentiably at it. `search` is mt_closest, or
    mt_closest_plain to hold the kernel against its plain version on the
    card."""
    r = org.shape[0]
    if t_min is None:
        t_min = torch.zeros((r,), device=org.device)
    if t_max is None:
        t_max = torch.full((r,), BIG_T, device=org.device)
    hit, t, idx, u, v = search(scene.tris, *detached_rows(org, dirn, t_min, t_max), "closest")
    return finalize_hit_at(scene, org, dirn, t_min, t_max, hit, t, idx, u, v)


def shadow_mt(scene: Scene, org, dirn, t_min, t_max, *, search=mt_closest):
    """(hit, prim_id, is_sphere) of NEE shadow rays (shadow_matmul): the
    winner only, merged with the spheres by finalize_shadow."""
    org, dirn, t_min, t_max = detached_rows(org, dirn, t_min, t_max)
    hit, t, idx, _, _ = search(scene.tris, org, dirn, t_min, t_max, "shadow")
    return finalize_shadow(scene, org, dirn, t_min, t_max, hit, t, idx)
