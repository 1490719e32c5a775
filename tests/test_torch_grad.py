"""The port's material gradients (diff/grad.py, diff/fd.py, cli grad-check)
against the JAX package.

- Port material_grads against JAX material_grads on Cornell + spheres
  (`.with_mt()` on the JAX side) at 8x8 @ 2 spp, under both of
  test_grad.py's configs (FD_CFG: RR off, live sampler; PROD_CFG: RR off,
  detached sampling). Same RNG, same paths: per field of both material
  tables, max |port - JAX| over the field's max |JAX| below 1e-3, and every
  gradient finite. The losses (image sums) agree to 1e-4.
- The port's frozen-sampler FD against its own production grads at 1e-3,
  the cases of test_grad.py:162-181.
- cfg.remat (checkpoint per lockstep iteration) gives the same loss and
  grads; `cli grad-check --device cpu` passes the strong contract.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from pathtrace_tpu import diff as jdiff  # noqa: E402
from pathtrace_tpu.integrator.config import IntegratorConfig as JaxConfig  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.diff import fd_material_grad, material_grads  # noqa: E402
from pathtrace_tpu_torch.diff.fd import make_frozen_sampler  # noqa: E402
from pathtrace_tpu_torch.diff.grad import MAT_FIELDS, render_with_params  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from torch_port_helpers import port_camera, port_scene  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
CFGS = {"fd": dict(rr_bounce=99, detach_sampling=False),
        "prod": dict(rr_bounce=99, detach_sampling=True)}
SPP = 2


def field_errors(a, b):
    """{field: max |a - b| / max |a|} of two Materials (a: the reference)."""
    out = {}
    for f in MAT_FIELDS:
        x, y = np.asarray(getattr(a, f), np.float64), np.asarray(getattr(b, f), np.float64)
        out[f] = float(np.abs(x - y).max() / max(np.abs(x).max(), 1e-6)) if x.size else 0.0
    return out


@pytest.fixture(scope="module")
def scenes():
    js = jproc.cornell_box_scene(include_spheres=True).with_mt()
    cam = jproc.default_camera(8, 8)
    return js, cam, port_scene(js), port_camera(cam)


@pytest.fixture(scope="module")
def jax_grads(scenes):
    """{config: (g_tri, g_sph, loss)} of the JAX package, once per module
    (one XLA compile of the gradient program per config, ~25 s each)."""
    js, cam, _, _ = scenes
    return {name: jdiff.material_grads(js, cam, SPP, jrng.make_key(0), cfg=JaxConfig(**kw))
            for name, kw in CFGS.items()}


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_material_grads_match_jax(scenes, jax_grads, cfg_name):
    _, _, ts, tc = scenes
    cfg = IntegratorConfig(**CFGS[cfg_name])
    g_tri, g_sph, loss = material_grads(ts, tc, SPP, rng.make_key(0), cfg=cfg, device="cpu")
    j_tri, j_sph, j_loss = jax_grads[cfg_name]
    assert abs(loss.item() - float(j_loss)) < 1e-4 * float(j_loss)
    for mine, ref in ((g_tri, j_tri), (g_sph, j_sph)):
        for f in MAT_FIELDS:
            assert torch.isfinite(getattr(mine, f)).all(), f
        errs = field_errors(ref, mine)
        assert max(errs.values()) < 1e-3, errs
    assert np.abs(np.asarray(g_tri.albedo)).max() > 0 and np.abs(np.asarray(g_sph.albedo)).max() > 0


@pytest.fixture(scope="module")
def production(scenes):
    _, _, ts, tc = scenes
    cfg = IntegratorConfig(**CFGS["prod"])
    g_tri, g_sph, _ = material_grads(ts, tc, SPP, rng.make_key(0), cfg=cfg, device="cpu")
    return cfg, g_tri, g_sph, make_frozen_sampler(ts)


@pytest.mark.parametrize("target,field,idx,h", [
    ("tris", "albedo", (0, 0), 1e-2),
    ("tris", "roughness", (2,), 2e-3),
    ("tris", "specular", (4, 0), 2e-3),
    ("spheres", "albedo", (0, 0), 1e-2),
    ("spheres", "roughness", (0,), 2e-3),
])
def test_frozen_fd_matches_production_grad(scenes, production, target, field, idx, h):
    """test_grad.py:169: frozen-sampling central differences measure the
    detached-sampling derivative, at 1e-3."""
    _, _, ts, tc = scenes
    cfg, g_tri, g_sph, frozen = production
    fd = fd_material_grad(ts, tc, SPP, rng.make_key(0), target, field, idx, h=h, cfg=cfg,
                          sample_mat_fn=frozen, device="cpu")
    ad = float(getattr(g_tri if target == "tris" else g_sph, field)[idx])
    assert abs(ad - fd) / max(abs(fd), abs(ad), 1.0) < 1e-3, (ad, fd)


def test_remat_grads_match(scenes):
    """test_grad.py:125: checkpointed iterations replay the same draws."""
    _, _, ts, tc = scenes
    cfg = IntegratorConfig(**CFGS["fd"])
    a_tri, a_sph, a_loss = material_grads(ts, tc, 1, rng.make_key(4), cfg=cfg, device="cpu")
    b_tri, b_sph, b_loss = material_grads(ts, tc, 1, rng.make_key(4),
                                          cfg=dataclasses.replace(cfg, remat=True), device="cpu")
    assert a_loss.item() == b_loss.item()
    for a, b in ((a_tri, b_tri), (a_sph, b_sph)):
        for f in MAT_FIELDS:
            torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=1e-5, atol=1e-6)


def test_render_with_params_is_differentiable(scenes):
    """Gradients reach leaf materials through render_with_params."""
    _, _, ts, tc = scenes
    albedo = ts.mat.albedo.clone().requires_grad_(True)
    tri = dataclasses.replace(ts.mat, albedo=albedo)
    img = render_with_params(ts, tri, ts.spheres.mat, tc, 1, rng.make_key(1), device="cpu")
    img.sum().backward()
    assert albedo.grad is not None and albedo.grad.abs().sum() > 0


def test_cli_grad_check_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "pathtrace_tpu_torch.cli", "grad-check", "--preset", "cornell64",
         "--width", "8", "--height", "8", "--spp", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    report = json.loads(proc.stdout)
    assert report["pass"] is True and report["mode"] == "strong-1e-3"
    assert len(report["checks"]) == 4 and report["device"] == "cpu"
