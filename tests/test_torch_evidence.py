"""Path ids past 2**31 through the port's engines, the gradient paths'
guard, and forward-mode derivatives of the render against the JAX package.

- A 6x6 render at 1 spp at sample 59,652,323, whose path ids
  2,147,483,628-2,147,483,663 cross 2**31: through the lockstep render
  (render_sample), the plain wavefront and the fused engine's CPU path,
  every camera ray is the one of pixel id mod 36 with the id's jitter, and
  the engines agree with each other as closely as they do at sample 0
  (their images equal bit for bit at both). On the CPU the fused engine
  is the plain wavefront itself, so its row shows only that its entry
  keys the samples by sample_offset; kernel B1 at ids past 2**31 is held
  against its plain version on the card (chip_smoke.py phase 8, on the
  whole 1080x2400 frame in one launch and on a pixel slice). The JAX
  package's int32 ids would put the ids past 2**31 four pixels off
  (test_torch_rng.py).
- The replay and wavetape gradients refuse path ids from 2**31 on
  (utils/rng.py::TAPE_ID_LIMIT) before they allocate anything.
- Forward mode (diff/grad.py::material_jvp) against JAX's jax.jvp over
  render_with_params and against the port's own reverse mode, on Cornell +
  spheres at 16x16 @ 4 spp with an emittance tangent on the first light
  (tests/test_grad.py:184-215), at its 1e-4: |a - b| / max(|a|, |b|, 1).
  The JAX side is computed once per module. No tangent reaches a search,
  so none can reach a kernel's launch on the card.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.autograd.forward_ad as fwad  # noqa: E402

from pathtrace_tpu.diff.grad import render_with_params as jax_render_with_params  # noqa: E402
from pathtrace_tpu.integrator.config import IntegratorConfig as JaxConfig  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.diff import material_grads, material_grads_replay  # noqa: E402
from pathtrace_tpu_torch.diff import material_grads_wavetape  # noqa: E402
from pathtrace_tpu_torch.diff.grad import MAT_FIELDS, material_jvp  # noqa: E402
from pathtrace_tpu_torch.integrator import megakernel  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.integrator.render import render_sample  # noqa: E402
from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.models.scene import Material  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from torch_port_helpers import port_camera, port_scene  # noqa: E402

torch.set_num_threads(1)
SIDE, NUM_PIX = 6, 36
HIGH_SAMPLE = 2**31 // NUM_PIX  # 59,652,323: ids 2,147,483,628 .. 2,147,483,663


def _true_camera_dirs(camera, ids: torch.Tensor, key) -> torch.Tensor:
    """The camera rays of ids at pixel id mod num_pix, from the jitter."""
    pixel = ids % NUM_PIX
    ju = rng.pixel_jitter(key, ids)
    return camera.ray_directions((pixel % SIDE).float(), (pixel // SIDE).float(),
                                 ju[:, 0], ju[:, 1])


def _capturing_raycast(scene, calls: list):
    """The scene's closest-hit search, recording each call's directions."""
    search = megakernel.default_raycast(scene)

    def raycast(sc, org, dirn, t_min, t_max):
        calls.append(dirn.clone())
        return search(sc, org, dirn, t_min, t_max)

    return raycast


def _engines(sample: int):
    """{engine: (flat (36, 3) image, first closest-hit directions)} of one
    sample at `sample`, with the ids the engines held."""
    scene = procedural.cornell_box_scene(include_spheres=True)
    cam, cfg, key = procedural.default_camera(SIDE, SIDE), IntegratorConfig(), rng.make_key(4)
    out = {}
    calls = []
    img = render_sample(scene, cam, sample, key, cfg, raycast_fn=_capturing_raycast(scene, calls))
    out["lockstep"] = (img, calls[0])
    calls = []
    img, _ = _run_wavefront(scene, cam, 1, key, cfg, NUM_PIX, sample,
                            raycast_fn=_capturing_raycast(scene, calls))
    out["wavefront"] = (img.reshape(NUM_PIX, 3), calls[0])
    img, _ = bk.render_wavefront_fused(scene, cam, 1, key, cfg, NUM_PIX, chunk_spp=1,
                                       sample_offset=sample, device="cpu")
    out["fused"] = (img.reshape(NUM_PIX, 3), None)
    ids = sample * NUM_PIX + torch.arange(NUM_PIX, dtype=torch.int64)
    return out, _true_camera_dirs(cam, ids, key), ids


def test_engines_past_2_31_use_the_true_pixel():
    """The lockstep render and the plain wavefront at ids across 2**31;
    the fused engine's CPU path (the plain wavefront) beside them."""
    high, want, ids = _engines(HIGH_SAMPLE)
    assert int(ids[0]) < 2**31 <= int(ids[-1])
    for name in ("lockstep", "wavefront"):
        assert torch.equal(high[name][1], want), name
    low, want0, _ = _engines(0)
    for name in ("lockstep", "wavefront"):
        assert torch.equal(low[name][1], want0), name
    for engines in (high, low):
        ref = engines["lockstep"][0]
        assert torch.isfinite(ref).all() and ref.mean() > 0
    for engines in (high, low):  # as closely at sample 59,652,323 as at 0: bit for bit
        assert torch.equal(engines["wavefront"][0], engines["lockstep"][0])
        assert torch.equal(engines["fused"][0], engines["wavefront"][0])


@pytest.mark.parametrize("which", ["replay", "wavetape"])
def test_gradient_paths_refuse_ids_past_2_31(which):
    scene = procedural.cornell_box_scene()
    cam, spp = procedural.default_camera(SIDE, SIDE), HIGH_SAMPLE + 1
    args = (scene, cam, spp, rng.make_key(0), IntegratorConfig())
    with pytest.raises(ValueError, match="int32"):
        if which == "replay":
            material_grads_replay(*args, device="cpu")
        else:
            material_grads_wavetape(*args, lanes=NUM_PIX, chunk=NUM_PIX, device="cpu")


JVP_SIDE, JVP_SPP = 16, 4


@pytest.fixture(scope="module")
def jax_jvp():
    """(loss, jvp) of JAX's sum(render_with_params) along the emittance
    tangent of the first light (test_grad.py:184-215), once per module."""
    scene = jproc.cornell_box_scene(include_spheres=True).with_mt()
    cam = jproc.default_camera(JVP_SIDE, JVP_SIDE)
    key = jrng.make_key(0)
    cfg = JaxConfig(rr_bounce=99, detach_sampling=True)

    def loss(mat):
        return jnp.sum(jax_render_with_params(scene, mat, scene.spheres.mat, cam, JVP_SPP, key,
                                              cfg))

    light = int(np.asarray(scene.lights)[0])
    tangent = jax.tree.map(jnp.zeros_like, scene.mat)
    tangent = dataclasses.replace(
        tangent, emittance=jnp.zeros_like(scene.mat.emittance).at[light, 0].set(1.0))
    value, jv = jax.jvp(loss, (scene.mat,), (tangent,))
    return scene, cam, light, float(value), float(jv)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1.0)


def _emittance_tangent(scene, light: int) -> Material:
    tangent = Material(*[torch.zeros_like(getattr(scene.mat, f)) for f in MAT_FIELDS])
    tangent.emittance[light, 0] = 1.0
    return tangent


def test_forward_mode_matches_jax_jvp_and_reverse_mode(jax_jvp, monkeypatch):
    jscene, jcam, light, j_loss, j_jv = jax_jvp
    scene, cam = port_scene(jscene), port_camera(jcam)
    cfg, key = IntegratorConfig(rr_bounce=99, detach_sampling=True), rng.make_key(0)

    # every search input must be free of tangents: they are what a kernel
    # launch reads on the card
    from pathtrace_tpu_torch.ops import mt_closest as mt
    plain = mt.mt_closest_plain
    seen = []

    def search(tris, *args):
        tensors = [getattr(tris, f.name) for f in dataclasses.fields(tris)] + list(args[:4])
        seen.append(any(fwad.unpack_dual(t).tangent is not None for t in tensors
                        if torch.is_tensor(t)))
        return plain(tris, *args)

    monkeypatch.setattr(megakernel, "mt_closest", search)
    loss, jv = material_jvp(scene, cam, JVP_SPP, key, _emittance_tangent(scene, light), cfg=cfg,
                            device="cpu")
    assert seen and not any(seen)
    g_tri, _, r_loss = material_grads(scene, cam, JVP_SPP, key, cfg=cfg, device="cpu")
    rev = g_tri.emittance[light, 0].item()
    assert _rel(loss.item(), r_loss.item()) < 1e-6
    assert _rel(loss.item(), j_loss) < 1e-4
    assert _rel(jv.item(), j_jv) < 1e-4, (jv.item(), j_jv)
    assert _rel(jv.item(), rev) < 1e-4, (jv.item(), rev)


def test_forward_mode_ignores_remat_and_default_tangents():
    """cfg.remat (checkpoints, which keep nothing in forward mode) gives the
    same derivative; zero tangents give zero."""
    scene, cam = procedural.cornell_box_scene(include_spheres=True), procedural.default_camera(6, 6)
    light, key = int(scene.lights[0]), rng.make_key(1)
    tangent = _emittance_tangent(scene, light)
    a = material_jvp(scene, cam, 2, key, tangent, device="cpu")
    b = material_jvp(scene, cam, 2, key, tangent, cfg=IntegratorConfig(remat=True), device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[1].item() > 0
    zero = Material(*[torch.zeros_like(getattr(scene.mat, f)) for f in MAT_FIELDS])
    assert material_jvp(scene, cam, 2, key, zero, device="cpu")[1].item() == 0.0
