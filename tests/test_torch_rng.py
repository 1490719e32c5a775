"""The port's Philox RNG is bit-equal to the JAX package's (utils/rng.py).

Equal bits mean equal paths: the port, the CUDA kernel and the JAX
reference trace the same path for the same (key, ray id, iteration), so
images compare pixel by pixel. Tolerance: none, every word and float must
match exactly.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.utils import rng as trng  # noqa: E402

SEEDS = [0, 5, 123, 2**32 + 17, 2**40 + 2**33 + 9]


def _ray_ids(n=4096, seed=0):
    ids = np.random.default_rng(seed).integers(0, 2**31 - 1, n).astype(np.int32)
    ids[:6] = [2**31 - 1, 2**31 - 2, 2**31 - 1000, 0, 1, 65535]  # ends of int32
    return ids


@pytest.mark.parametrize("seed", SEEDS)
def test_make_key_and_iter_key_equal(seed):
    jk = np.asarray(jrng.make_key(seed))
    tk = trng.make_key(seed)
    assert tk.dtype == np.uint32 and np.array_equal(jk, tk)
    for tag in (0, 1000, 1003, 2**31 - 1):
        np.testing.assert_array_equal(np.asarray(jrng.iter_key(jk, tag)),
                                      trng.iter_key(tk, tag))


def test_philox_words_bit_equal():
    r = np.random.default_rng(1)
    c = [r.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32) for _ in range(4)]
    k0, k1 = (int(x) for x in r.integers(0, 2**32, 2, dtype=np.uint64))
    jw = jrng.philox4x32(*[jnp.asarray(x) for x in c], np.uint32(k0), np.uint32(k1))
    tw = trng.philox4x32(*[torch.from_numpy(x.astype(np.int64)) for x in c], k0, k1)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("per_lane", [False, True])
def test_uniforms_bit_equal(seed, per_lane):
    ids = _ray_ids(seed=seed)
    if per_lane:
        it = np.random.default_rng(seed + 1).integers(0, 40, ids.size).astype(np.int32)
        j_it, t_it = jnp.asarray(it), torch.from_numpy(it)
    else:
        j_it = t_it = 7
    a = np.asarray(jrng.uniforms(jrng.make_key(seed), jnp.asarray(ids), j_it))
    b = trng.uniforms(trng.make_key(seed), torch.from_numpy(ids), t_it).numpy()
    assert b.dtype == np.float32 and b.shape == (ids.size, trng.NUM_COLS)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_scalar_and_per_lane_iteration_agree():
    """The wavefront (per-lane iterations) and the lockstep megakernel
    (scalar iteration) draw the same stream (cf. test_rng.py:28)."""
    key = trng.make_key(7)
    ids = torch.arange(64, dtype=torch.int32)
    a = trng.uniforms(key, ids, 5)
    b = trng.uniforms(key, ids, torch.full((64,), 5, dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_pixel_jitter_bit_equal(seed):
    ids = _ray_ids(seed=seed + 10)
    a = np.asarray(jrng.pixel_jitter(jrng.make_key(seed), jnp.asarray(ids)))
    b = trng.pixel_jitter(trng.make_key(seed), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_randint_from_uniform_equal(n):
    u = np.random.default_rng(n).random(4096).astype(np.float32)
    u[:3] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
    a = np.asarray(jrng.randint_from_uniform(jnp.asarray(u), n))
    b = trng.randint_from_uniform(torch.from_numpy(u), n).numpy()
    np.testing.assert_array_equal(a, b)


def test_path_id_limit_raises():
    trng.check_path_ids(256 * 256, 1024)  # 67M ids: fits int32
    with pytest.raises(ValueError, match="2\\*\\*31"):
        trng.check_path_ids(65536, 32768)
