"""The port's Philox RNG is bit-equal to the JAX package's (utils/rng.py).

Equal bits mean equal paths: the port, the CUDA kernel and the JAX
reference trace the same path for the same (key, ray id, iteration), so
images compare pixel by pixel. Tolerance: none, every word and float must
match exactly.

Path ids in [2**31, 2**32): the port holds them in int64, the JAX package
in int32, where they wrap to negative numbers. Philox takes the same 32
bits either way, so the port's draws and jitter equal JAX's at the
int32-bitcast id; the camera pixel does not: JAX's wavefront takes it from
the wrapped id (wavefront.py:43), 2**32 mod num_pix pixels away from the
true one (ROADMAP C9). Ids at 2**32 raise: the counter word would repeat.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.utils import rng as trng  # noqa: E402

SEEDS = [0, 5, 123, 2**32 + 17, 2**40 + 2**33 + 9]


def _high_ids(n=4096, seed=0):
    """uint32 ids in [2**31, 2**32), both ends included."""
    ids = np.random.default_rng(seed).integers(2**31, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ids[:4] = [2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]
    return ids


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


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_draws_past_2_31_equal_jax_at_bitcast_ids(seed):
    """For ids in [2**31, 2**32) the port's int64 ids give JAX's draws and
    jitter at the same bits as int32 (the ids the JAX engines hold)."""
    ids = _high_ids(seed=seed + 20)
    as_int32 = jnp.asarray(ids.view(np.int32))
    assert int(np.asarray(as_int32).min()) < 0  # JAX's ids have wrapped
    t_ids = torch.from_numpy(ids.astype(np.int64))
    it = np.random.default_rng(seed).integers(0, 40, ids.size).astype(np.int32)
    a = np.asarray(jrng.uniforms(jrng.make_key(seed), as_int32, jnp.asarray(it)))
    b = trng.uniforms(trng.make_key(seed), t_ids, torch.from_numpy(it)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    a = np.asarray(jrng.pixel_jitter(jrng.make_key(seed), as_int32))
    b = trng.pixel_jitter(trng.make_key(seed), t_ids).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_jax_regen_wraps_past_2_31_and_the_port_does_not():
    """JAX's _regen_rays on the int32 ids its engine holds past 2**31, at
    6x6, where 2**32 mod 36 = 4: its pixel sits 4 pixels before the id's
    true pixel, while the port aims at the true pixel with the same jitter."""
    from pathtrace_tpu.integrator.wavefront import _regen_rays as jax_regen
    from pathtrace_tpu.models import procedural as jproc
    from pathtrace_tpu_torch.integrator.wavefront import _regen_rays as port_regen
    from torch_port_helpers import port_camera

    cam, num_pix = jproc.default_camera(6, 6), 36
    jkey, tkey = jrng.make_key(3), trng.make_key(3)
    ids = np.arange(2**31 - 40, 2**31 + 40, dtype=np.int64)  # crosses 2**31
    wrapped = jnp.asarray(ids.astype(np.uint32).view(np.int32))  # JAX's int32 path ids
    _, j_dirs, j_pix = jax_regen(cam, wrapped, jkey, num_pix)
    true_pix, high = ids % num_pix, ids >= 2**31
    shift = (true_pix - np.asarray(j_pix)) % num_pix
    assert np.all(shift[high] == 2**32 % num_pix) and np.all(shift[~high] == 0)

    ju = jrng.pixel_jitter(jkey, wrapped)
    t_ids = torch.from_numpy(ids)
    np.testing.assert_array_equal(np.asarray(ju).view(np.uint32),
                                  trng.pixel_jitter(tkey, t_ids).numpy().view(np.uint32))
    want = np.asarray(cam.ray_directions(jnp.asarray(true_pix % 6, jnp.float32),
                                         jnp.asarray(true_pix // 6, jnp.float32),
                                         ju[:, 0], ju[:, 1]))
    _, p_dirs = port_regen(port_camera(cam), t_ids, tkey, num_pix)
    assert np.abs(p_dirs.numpy() - want).max() < 1e-6
    j_dirs = np.asarray(j_dirs)
    assert np.abs(j_dirs[~high] - want[~high]).max() < 1e-6
    assert np.abs(j_dirs[high] - want[high]).max(axis=1).min() > 1e-2  # every one misplaced


def test_path_id_limit_raises():
    trng.check_path_ids(256 * 256, 1024)  # 67M ids
    trng.check_path_ids(65536, 32768)  # 2**31 ids: past int32, below the counter word
    trng.check_path_ids(1080 * 2400, 1024)  # a pass of the reference's job: 2.65e9 ids
    with pytest.raises(ValueError, match="Philox counter word"):
        trng.check_path_ids(65536, 65536)
    with pytest.raises(ValueError, match="int32"):
        trng.check_path_ids(65536, 32768, limit=trng.TAPE_ID_LIMIT)
