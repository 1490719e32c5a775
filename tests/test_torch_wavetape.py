"""The port's record/replay gradients, wavefront tape and train step
(diff/replay.py, diff/wavetape.py, parallel/mesh.py) against the JAX package
and against each other, on Cornell + spheres at 8x8 @ 2 spp (`.with_mt()` on
the JAX side), IntegratorConfig() (Russian roulette on, detached sampling).

- Tapes: the port's record_paths_wavefront against JAX's on the same scene
  and key, decoded word by word: written/hit/sph/reached equal and the prim
  id equal where hit, on >= 99.5% of slots. JAX picks its winners from an
  f32 coefficient fit of Möller-Trumbore, the port from direct MT, so a
  near-tie may go to another triangle and fork the rest of that path.
- Grads: per field of both material tables, max |a - b| over the field's
  max |a| below 1e-3 (gradcheck_tpu.py:87's bar), every grad finite: port
  wavetape against port replay, port scan-AD (diff/grad.py) and JAX
  material_grads_wavetape; films within 1e-3 of the images.
- The train step against material_grads_wavetape with
  loss_grad_img = 2 (film - target), within 1e-4 (the JAX step omits /spp,
  mesh.py:339, and is no oracle).
- A KD scene (sphere_mesh_scene(2), cells of 64): wavetape = scan-AD, with
  the recorder's searches going through the KD route.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.diff import wavetape as jwt  # noqa: E402
from pathtrace_tpu.integrator.config import IntegratorConfig as JaxConfig  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.diff import (material_grads, material_grads_replay,  # noqa: E402
                                      material_grads_wavetape, record_paths,
                                      record_paths_wavefront, replay_paths)
from pathtrace_tpu_torch.diff import wavetape as wt  # noqa: E402
from pathtrace_tpu_torch.diff.grad import MAT_FIELDS  # noqa: E402
from pathtrace_tpu_torch.diff.replay import _camera_rays  # noqa: E402
from pathtrace_tpu_torch.integrator import megakernel  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops import kd_raycast as kd  # noqa: E402
from pathtrace_tpu_torch.parallel.mesh import train_step_wavetape  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from torch_port_helpers import port_camera, port_scene  # noqa: E402

torch.set_num_threads(1)
SPP, LANES, SEED = 2, 64, 3


def assert_grads_close(ref, mine, bar=1e-3):
    """Per field: max |ref - mine| / max |ref| < bar, and mine finite."""
    for a, b in zip(ref, mine):
        for f in MAT_FIELDS:
            x = np.asarray(getattr(a, f), np.float64)
            y = np.asarray(getattr(b, f), np.float64)
            assert np.isfinite(y).all(), f
            if x.size:
                assert np.abs(x - y).max() / max(np.abs(x).max(), 1e-6) < bar, f


@pytest.fixture(scope="module")
def scenes():
    js = jproc.cornell_box_scene(include_spheres=True).with_mt()
    cam = jproc.default_camera(8, 8)
    return js, cam, port_scene(js), port_camera(cam)


@pytest.fixture(scope="module")
def jax_ref(scenes):
    """JAX's tape, film and wavetape grads, once per module (~70 s of XLA
    compiles on the CPU)."""
    js, cam, _, _ = scenes
    cfg, key = JaxConfig(), jrng.make_key(SEED)
    rec, film = jax.jit(lambda s, k: jwt.record_paths_wavefront(s, cam, SPP, k, cfg, LANES))(
        js, key)
    g_tri, g_sph, img = jwt.material_grads_wavetape(js, cam, SPP, key, cfg, lanes=LANES,
                                                    chunk=2 * LANES)
    return np.array(rec), np.asarray(film), (g_tri, g_sph), np.asarray(img)


@pytest.fixture(scope="module")
def port_wavetape(scenes):
    _, _, ts, tc = scenes
    return material_grads_wavetape(ts, tc, SPP, rng.make_key(SEED), IntegratorConfig(),
                                   lanes=LANES, chunk=LANES, device="cpu")


def test_record_tape_matches_jax(scenes, jax_ref):
    _, _, ts, tc = scenes
    rec, film = record_paths_wavefront(ts, tc, SPP, rng.make_key(SEED), IntegratorConfig(),
                                       LANES)
    j_rec, j_film = jax_ref[0], jax_ref[1]
    assert rec.shape == j_rec.shape == (IntegratorConfig().max_iters, 64 * SPP)
    mine = wt.unpack_rec(rec)
    ref = wt.unpack_rec(torch.from_numpy(j_rec))
    same = ((rec & wt._WRT_BIT) != 0) == torch.from_numpy((j_rec & wt._WRT_BIT) != 0)
    for f in ("hit", "sph", "reached"):
        same &= mine[f] == ref[f]
    same &= ~ref["hit"] | (mine["pid"] == ref["pid"])
    assert same.double().mean().item() >= 0.995
    assert ref["hit"].double().mean().item() > 0.1 and mine["reached"].any()
    np.testing.assert_allclose(film.numpy(), j_film, rtol=1e-3, atol=1e-3)


def test_wavetape_matches_jax(jax_ref, port_wavetape):
    g_tri, g_sph, img = port_wavetape
    assert_grads_close(jax_ref[2], (g_tri, g_sph))
    np.testing.assert_allclose(img.numpy(), jax_ref[3], rtol=1e-3, atol=1e-3)


def test_wavetape_matches_replay_and_scan(scenes, port_wavetape):
    """Three backwards of one estimator: the per-sample lockstep replay, the
    lockstep scan-AD, and the wavefront tape."""
    _, _, ts, tc = scenes
    key, cfg = rng.make_key(SEED), IntegratorConfig()
    g_tri, g_sph, img = port_wavetape
    r_tri, r_sph, r_img = material_grads_replay(ts, tc, SPP, key, cfg, device="cpu")
    s_tri, s_sph, loss = material_grads(ts, tc, SPP, key, cfg=cfg, device="cpu")
    for ref in ((r_tri, r_sph), (s_tri, s_sph)):
        assert_grads_close(ref, (g_tri, g_sph))
    torch.testing.assert_close(img, r_img, rtol=1e-3, atol=1e-3)
    assert abs(img.sum().item() - loss.item()) < 1e-3 * loss.item()


def test_replay_primal_equals_record(scenes):
    """The replay rebuilds every hit from the tape: its radiance is the
    recorded radiance bit for bit."""
    _, _, ts, tc = scenes
    key, cfg = rng.make_key(SEED), IntegratorConfig()
    org, dirs, ray_ids = _camera_rays(ts, tc, 1, key)
    rad, records = record_paths(ts, org, dirs, ray_ids, key, cfg)
    assert records["hit"].shape == (cfg.max_iters, 64)
    with torch.no_grad():
        assert torch.equal(replay_paths(ts, records, org, dirs, ray_ids, key, cfg), rad)


def test_train_step_matches_wavetape(scenes):
    _, _, ts, tc = scenes
    key, cfg = rng.make_key(SEED), IntegratorConfig()
    target = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (8, 8, 3)).astype(np.float32))
    loss, (g_tri, g_sph), img = train_step_wavetape(ts, tc, target, SPP, key, cfg, lanes=LANES,
                                                    chunk=LANES, device="cpu")
    _, film = record_paths_wavefront(ts, tc, SPP, key, cfg, LANES)
    ref = material_grads_wavetape(ts, tc, SPP, key, cfg, loss_grad_img=2 * (film.reshape(8, 8, 3)
                                                                            - target),
                                  lanes=LANES, chunk=LANES, device="cpu")
    assert_grads_close(ref[:2], (g_tri, g_sph), bar=1e-4)
    torch.testing.assert_close(img, ref[2], rtol=1e-5, atol=1e-6)
    assert loss.item() == pytest.approx(((ref[2] - target) ** 2).sum().item(), rel=1e-5)


def test_pack_rec_masks_prim_id():
    """A prim id outside 27 bits cannot reach the flag bits."""
    pid = torch.tensor([0, 5, (1 << 27) - 1, -1, 1 << 27], dtype=torch.int32)
    false = torch.zeros(5, dtype=torch.bool)
    words = wt._pack_rec(false, pid, false, false)
    dec = wt.unpack_rec(words)
    assert not dec["hit"].any() and not dec["sph"].any() and not dec["reached"].any()
    assert ((words & wt._WRT_BIT) != 0).all()
    assert dec["pid"][:3].tolist() == [0, 5, (1 << 27) - 1]


def test_kd_scene_wavetape_matches_scan(monkeypatch):
    """The recorder takes the scene's route: KD cells here (B2's plain
    version on the CPU)."""
    scene = procedural.sphere_mesh_scene(2).with_kd_binned(max_tris=64)
    cam = procedural.default_camera(8, 8)
    key, cfg = rng.make_key(SEED), IntegratorConfig()
    calls = []
    plain = kd.kd_closest_plain
    monkeypatch.setattr(kd, "kd_closest_plain", lambda *a: calls.append(a[-1]) or plain(*a))
    assert megakernel.default_raycast(scene).func is kd.raycast_kd
    w_tri, w_sph, img = material_grads_wavetape(scene, cam, SPP, key, cfg, lanes=LANES,
                                                chunk=LANES, device="cpu")
    assert "closest" in calls and "shadow" in calls
    s_tri, s_sph, loss = material_grads(scene, cam, SPP, key, cfg=cfg, device="cpu")
    assert_grads_close((s_tri, s_sph), (w_tri, w_sph))
    assert abs(img.sum().item() - loss.item()) < 1e-3 * loss.item()
