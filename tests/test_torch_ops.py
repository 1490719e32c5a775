"""Brute intersection and the four-lobe BSDF of the port vs the JAX package.

Inputs are made with numpy from a seed and handed to both. Both sides
compute in float32 on the CPU, XLA and eager torch rounding differently in
the last ulp, so:
- raycast/shadow: hit, prim_id and is_sphere must agree on >= 99.9% of
  rays; the rest are near-threshold accept flips (a ray grazing an edge or
  a tie between coincident primitives). Float fields are held to
  rtol 1e-5 / atol 1e-5 on the rays whose winner agrees.
- BSDF eval/sample/pdf: rtol 1e-5 / atol 1e-6 on >= 99.9% of elements;
  the rest are near-threshold lobe or accept flips (u_lobe against the
  Fresnel term, hemisphere tests at grazing angles).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.models.scene import Material as JMaterial  # noqa: E402
from pathtrace_tpu.ops import bsdf as jbsdf  # noqa: E402
from pathtrace_tpu.ops import intersect as jx  # noqa: E402
from pathtrace_tpu_torch.models.scene import Material  # noqa: E402
from pathtrace_tpu_torch.ops import bsdf as tbsdf  # noqa: E402
from pathtrace_tpu_torch.ops import intersect as tx  # noqa: E402
from torch_port_helpers import port_scene  # noqa: E402

# Test workers share the CPU; one intra-op thread each is as fast here
# and avoids oversubscription.
torch.set_num_threads(1)

N_RAYS = 4096


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rays(seed, n=N_RAYS):
    """Origins inside the room plus camera-like origins outside it."""
    r = np.random.default_rng(seed)
    org = r.uniform([-19.0, 0.5, -19.0], [19.0, 39.5, 19.0], size=(n, 3)).astype(np.float32)
    org[: n // 8] = np.asarray([0.0, 20.0, 60.0], np.float32)
    return org, _unit(r, n)


def _agree_mask(a, b, frac=0.999):
    m = a == b
    assert m.mean() >= frac, f"agreement {m.mean()}"
    return m


def _close(got, ref, rtol, atol, frac=0.999):
    got, ref = np.asarray(got), np.asarray(ref)
    c = np.isclose(got, ref, rtol=rtol, atol=atol)
    assert c.mean() >= frac, f"close fraction {c.mean()}"


SCENES = {
    "cornell_boxes": lambda: jproc.cornell_box_scene(),
    "cornell_spheres": lambda: jproc.cornell_box_scene(include_spheres=True),
    "glass": lambda: jproc.glass_scene(),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_raycast_brute_matches(name):
    js = SCENES[name]()
    ts = port_scene(js)
    org, d = _rays(1)
    a = jx.raycast_brute(js, jnp.asarray(org), jnp.asarray(d))
    b = tx.raycast_brute(ts, torch.from_numpy(org), torch.from_numpy(d))
    same = (_agree_mask(np.asarray(a.hit), b.hit.numpy())
            & _agree_mask(np.asarray(a.is_sphere), b.is_sphere.numpy())
            & _agree_mask(np.asarray(a.prim_id), b.prim_id.numpy()))
    keep = same & np.asarray(a.hit)
    assert keep.sum() > N_RAYS // 2
    for f in ("t", "p", "normal", "tangent", "bitangent", "uv"):
        _close(getattr(b, f).numpy()[keep], np.asarray(getattr(a, f))[keep], 1e-5, 1e-5)
    _agree_mask(np.asarray(a.front_face)[keep], b.front_face.numpy()[keep])
    for f in dataclasses.fields(Material):
        _close(getattr(b.mat, f.name).numpy()[keep],
               np.asarray(getattr(a.mat, f.name))[keep], 1e-5, 1e-5)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shadow_brute_matches(name):
    js = SCENES[name]()
    ts = port_scene(js)
    org, d = _rays(2)
    tmin = np.full((N_RAYS,), 1e-4, np.float32)
    tmax = np.random.default_rng(3).uniform(1.0, 60.0, N_RAYS).astype(np.float32)
    a = jx.shadow_brute(js, *(jnp.asarray(x) for x in (org, d, tmin, tmax)))
    b = tx.shadow_brute(ts, *(torch.from_numpy(x) for x in (org, d, tmin, tmax)))
    for x, y in zip(a, b):
        _agree_mask(np.asarray(x), y.numpy())


def test_mt_gather_matches():
    js = jproc.cornell_box_scene()
    ts = port_scene(js)
    org, d = _rays(4)
    pid = np.random.default_rng(5).integers(0, js.num_tris, N_RAYS).astype(np.int32)
    tmin = np.zeros((N_RAYS,), np.float32)
    tmax = np.full((N_RAYS,), 999999.0, np.float32)
    a = jx.mt_gather(js.tris, jnp.asarray(pid), *(jnp.asarray(x) for x in (org, d, tmin, tmax)))
    b = tx.mt_gather(ts.tris, torch.from_numpy(pid),
                     *(torch.from_numpy(x) for x in (org, d, tmin, tmax)))
    valid = _agree_mask(np.asarray(a[3]), b[3].numpy()) & np.asarray(a[3])
    for x, y in zip(a[:3], b[:3]):
        _close(y.numpy()[valid], np.asarray(x)[valid], 1e-5, 1e-5)


# --- BSDF -------------------------------------------------------------------

N_BSDF = 8192


def _bsdf_inputs(seed):
    """Random materials covering all four lobes, frames, directions in both
    hemispheres, and draws."""
    r = np.random.default_rng(seed)
    n = N_BSDF
    lobe = np.arange(n) % 4
    opacity = np.where(lobe >= 2, r.uniform(0.0, 0.9, n), 1.0).astype(np.float32)
    rough = np.where(lobe % 2 == 1, r.uniform(0.0, 0.009, n),
                     r.uniform(0.02, 1.0, n)).astype(np.float32)
    mat = dict(emittance=np.zeros((n, 3), np.float32),
               albedo=r.uniform(0.05, 1.0, (n, 3)).astype(np.float32),
               specular=r.uniform(0.0, 0.2, (n, 3)).astype(np.float32),
               opacity=opacity, roughness=rough,
               metallic=r.uniform(0.0, 1.0, n).astype(np.float32))
    normal = _unit(r, n)
    helper = np.where(np.abs(normal[:, 1:2]) < 0.99, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    tangent = np.cross(helper, normal)
    tangent = (tangent / np.linalg.norm(tangent, axis=1, keepdims=True)).astype(np.float32)
    bitangent = np.cross(normal, tangent).astype(np.float32)
    frame = dict(normal=normal, tangent=tangent, bitangent=bitangent,
                 front_face=r.random(n) < 0.7)
    wo = _unit(r, n)
    # mostly on the normal's side, as at a real hit, some behind it
    flip = (np.sum(wo * normal, axis=1) < 0) & (r.random(n) < 0.8)
    wo[flip] *= -1
    wi = _unit(r, n)
    u = r.random((3, n)).astype(np.float32)
    return mat, frame, wo, wi, u


def _both(mat, frame):
    jm = JMaterial(**{k: jnp.asarray(v) for k, v in mat.items()})
    tm = Material(**{k: torch.from_numpy(v) for k, v in mat.items()})
    jf = jbsdf.ShadeFrame(**{k: jnp.asarray(v) for k, v in frame.items()})
    tf = tbsdf.ShadeFrame(**{k: torch.from_numpy(np.asarray(v)) for k, v in frame.items()})
    return jm, tm, jf, tf


def test_select_lobe_covers_all_four():
    mat, frame, *_ = _bsdf_inputs(0)
    jm, tm, _, _ = _both(mat, frame)
    a = np.asarray(jbsdf.select_lobe(jm))
    b = tbsdf.select_lobe(tm).numpy()
    np.testing.assert_array_equal(a, b)
    assert set(b.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("uniform", [False, True])
def test_sample_bsdf_matches(uniform):
    mat, frame, wo, _, u = _bsdf_inputs(1)
    jm, tm, jf, tf = _both(mat, frame)
    a = jbsdf.sample_bsdf(jm, jf, jnp.asarray(wo), *(jnp.asarray(x) for x in u),
                          uniform_hemi=uniform)
    b = tbsdf.sample_bsdf(tm, tf, torch.from_numpy(wo), *(torch.from_numpy(x) for x in u),
                          uniform_hemi=uniform)
    _close(b.numpy(), np.asarray(a), 1e-5, 1e-6)


@pytest.mark.parametrize("wi_from", ["random", "sampled"])
def test_eval_bsdfcos_matches(wi_from):
    mat, frame, wo, wi, u = _bsdf_inputs(2)
    jm, tm, jf, tf = _both(mat, frame)
    if wi_from == "sampled":
        wi = np.array(jbsdf.sample_bsdf(jm, jf, jnp.asarray(wo), *(jnp.asarray(x) for x in u)))
    a = jbsdf.eval_bsdfcos(jm, jf, jnp.asarray(wo), jnp.asarray(wi))
    b = tbsdf.eval_bsdfcos(tm, tf, torch.from_numpy(wo), torch.from_numpy(wi))
    _close(b.numpy(), np.asarray(a), 1e-5, 1e-6)
    assert np.count_nonzero(np.asarray(a)) > N_BSDF  # not a test of zeros


@pytest.mark.parametrize("wi_from", ["random", "sampled"])
@pytest.mark.parametrize("uniform", [False, True])
def test_pdf_bsdf_matches(wi_from, uniform):
    mat, frame, wo, wi, u = _bsdf_inputs(3)
    jm, tm, jf, tf = _both(mat, frame)
    if wi_from == "sampled":
        wi = np.array(jbsdf.sample_bsdf(jm, jf, jnp.asarray(wo), *(jnp.asarray(x) for x in u)))
    a = jbsdf.pdf_bsdf(jm, jf, jnp.asarray(wo), jnp.asarray(wi), uniform_hemi=uniform)
    b = tbsdf.pdf_bsdf(tm, tf, torch.from_numpy(wo), torch.from_numpy(wi),
                       uniform_hemi=uniform)
    _close(b.numpy(), np.asarray(a), 1e-5, 1e-6)
    assert np.count_nonzero(np.asarray(a)) > N_BSDF // 2
