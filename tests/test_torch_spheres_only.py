"""A scene without triangles in the port, against the JAX package.

The scene is procedural.sphere_only_scene(): an emissive sphere and a
diffuse one and no triangle, as JAX's JSON loader builds a document of
spheres alone (json_io.py:105-107). No triangle is emissive, so the scene
has no lights and NEE is skipped.

- Scene.build gives JAX Scene.build's leaves on the same arrays: (0, 3)
  triangle fields, num_lights 0, lights [0], the (1, 13) zero light pack.
- The all-triangles search on the empty (0, 9) table: every ray a miss,
  t = u = v = 0 and idx 0 in both modes, JAX raycast_brute's values for a
  scene without triangles. raycast_mt and shadow_mt against JAX
  raycast_brute and shadow_brute on the same numpy rays: hit, prim_id,
  is_sphere, front_face, uv and the materials equal on every ray; t, p and
  the frame within 1e-6 relative (a few ulp: XLA's CPU code rounds the
  sphere's dot products and roots in another order, measured 1-2 ulp on
  under 1% of rays). The port's own raycast_brute and shadow_brute equal
  raycast_mt and shadow_mt there bit for bit.
- Renders at 8x8 @ 2 spp, the lockstep megakernel and the wavefront,
  against JAX's at the golden bars of tests/test_golden.py (99.9% of
  pixels within 5e-3) and mean within 1%.
- Gradients: wavetape grads equal the lockstep scan-AD grads per field at
  1e-3 (tests/test_torch_wavetape.py's bar); the triangle tables are empty.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.integrator.render import render as jax_render  # noqa: E402
from pathtrace_tpu.integrator.wavefront import (  # noqa: E402
    render_wavefront_chunked as jax_wavefront)
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.models import scene as jscene  # noqa: E402
from pathtrace_tpu.ops import intersect as jintersect  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.diff import material_grads, material_grads_wavetape  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.integrator.render import render  # noqa: E402
from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops import mt_closest as mt  # noqa: E402
from pathtrace_tpu_torch.ops.intersect import (HitRecord, raycast_brute,  # noqa: E402
                                               shadow_brute)
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.math3 import EPS  # noqa: E402
from torch_port_helpers import MAT_FIELDS, scene_to_numpy  # noqa: E402

torch.set_num_threads(1)
SIDE, SPP, SEED = 8, 2, 0


def jax_scene(scene):
    """JAX Scene.build of the port scene's spheres and no triangles."""
    sp = scene.spheres
    mat = jscene.Material(**{f: jnp.asarray(getattr(sp.mat, f).numpy()) for f in MAT_FIELDS})
    spheres = jscene.Spheres(center=jnp.asarray(sp.center.numpy()),
                             radius=jnp.asarray(sp.radius.numpy()), mat=mat)
    none = np.zeros((0, 3, 3), np.float32)
    return jscene.Scene.build(jscene.Triangles.from_vertices(none, none),
                              jscene.Material.make(0), spheres)


@pytest.fixture(scope="module")
def scenes():
    scene = procedural.sphere_only_scene()
    return scene, jax_scene(scene)


def _rays(scene, n=512, seed=1):
    """Random rays, about half toward the spheres, and the camera's rays."""
    g = np.random.default_rng(seed)
    org = g.uniform(-30.0, 40.0, (n, 3)).astype(np.float32)
    aim = scene.spheres.center.numpy()[g.integers(0, 2, n)] - org
    d = np.where(g.random((n, 1)) < 0.5, aim, g.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam = procedural.default_camera(16, 16)
    px, py = cam.pixel_grid("cpu")
    half = torch.full_like(px, 0.5)
    d_cam = cam.ray_directions(px, py, half, half).numpy()
    o_cam = np.broadcast_to(np.asarray(cam.pos, np.float32), d_cam.shape)
    return (np.ascontiguousarray(np.concatenate([org, o_cam]), np.float32),
            np.ascontiguousarray(np.concatenate([d, d_cam]), np.float32))


def test_scene_leaves_equal_jax(scenes):
    scene, js = scenes
    a, b = scene_to_numpy(scene), scene_to_numpy(js)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert scene.num_tris == 0 and scene.num_lights == 0 and scene.light_pack.shape == (1, 13)


@pytest.mark.parametrize("mode", mt.MODES)
def test_empty_table_gives_misses(scenes, mode):
    scene, js = scenes
    org, d = _rays(scene)
    r = org.shape[0]
    t_min, t_max = torch.zeros(r), torch.full((r,), 100.0)
    hit, t, idx, u, v = mt.mt_closest_plain(scene.tris, torch.from_numpy(org),
                                            torch.from_numpy(d), t_min, t_max, mode)
    assert scene.tris.search_table.shape == (0, 9)
    assert not hit.any() and not t.any() and not u.any() and not v.any()
    assert idx.dtype == torch.int32 and not idx.any()
    # JAX's brute search on a scene with neither triangles nor spheres
    bare = jscene.Scene.build(js.tris, js.mat)
    ref = jintersect.raycast_brute(bare, jnp.asarray(org), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(ref.hit), hit.numpy())
    np.testing.assert_array_equal(np.asarray(ref.prim_id), idx.numpy())


def test_raycast_mt_equals_jax_brute(scenes):
    scene, js = scenes
    org, d = _rays(scene)
    mine = mt.raycast_mt(scene, torch.from_numpy(org), torch.from_numpy(d))
    ref = jintersect.raycast_brute(js, jnp.asarray(org), jnp.asarray(d))
    assert 0.2 < mine.hit.float().mean().item() < 0.9
    assert mine.is_sphere[mine.hit].all()
    for f in dataclasses.fields(HitRecord):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name in ("t", "p", "normal", "tangent", "bitangent"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
        elif f.name != "mat":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
    for f in MAT_FIELDS:
        np.testing.assert_array_equal(getattr(mine.mat, f).numpy(),
                                      np.asarray(getattr(ref.mat, f)), err_msg=f)
    # the port's own brute search takes the same branch: bit-equal
    brute = raycast_brute(scene, torch.from_numpy(org), torch.from_numpy(d))
    for f in dataclasses.fields(HitRecord):
        a, b = getattr(brute, f.name), getattr(mine, f.name)
        for x, y in (zip((getattr(a, m) for m in MAT_FIELDS), (getattr(b, m) for m in MAT_FIELDS))
                     if f.name == "mat" else [(a, b)]):
            assert torch.equal(x, y), f.name


def test_shadow_mt_equals_jax_brute(scenes):
    scene, js = scenes
    org, d = _rays(scene, seed=2)
    r = org.shape[0]
    t_min = np.full((r,), EPS, np.float32)
    t_max = np.random.default_rng(3).uniform(0.5, 60.0, r).astype(np.float32)
    mine = mt.shadow_mt(scene, *(torch.from_numpy(x) for x in (org, d, t_min, t_max)))
    ref = jintersect.shadow_brute(js, *(jnp.asarray(x) for x in (org, d, t_min, t_max)))
    assert mine[0].any()
    brute = shadow_brute(scene, *(torch.from_numpy(x) for x in (org, d, t_min, t_max)))
    for a, b, c in zip(mine, ref, brute):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


@pytest.mark.parametrize("engine", ["lockstep", "wavefront"])
def test_render_matches_jax(scenes, engine):
    scene, js = scenes
    cam, jcam = procedural.default_camera(SIDE, SIDE), jproc.default_camera(SIDE, SIDE)
    key, jkey = rng.make_key(SEED), jrng.make_key(SEED)
    if engine == "lockstep":
        img = render(scene, cam, SPP, key, device="cpu").numpy()
        ref = np.asarray(jax_render(js, jcam, SPP, jkey))
    else:
        img = render_wavefront_chunked(scene, cam, SPP, key, device="cpu")[0].numpy()
        ref = np.asarray(jax_wavefront(js, jcam, SPP, jkey)[0])
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert np.isclose(img, ref, rtol=5e-3, atol=5e-3).mean() > 0.999
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.01


def test_wavetape_grads_equal_scan_ad(scenes):
    scene = scenes[0]
    cam, key, cfg = procedural.default_camera(SIDE, SIDE), rng.make_key(3), IntegratorConfig()
    ref = material_grads(scene, cam, SPP, key, cfg=cfg, device="cpu")
    mine = material_grads_wavetape(scene, cam, SPP, key, cfg, lanes=64, chunk=128,
                                   device="cpu")
    for a, b in zip(ref[:2], mine[:2]):
        for f in MAT_FIELDS:
            x, y = getattr(a, f).double(), getattr(b, f).double()
            assert torch.isfinite(y).all(), f
            if x.numel():
                assert (x - y).abs().max() / x.abs().max().clamp(min=1e-6) < 1e-3, f
    assert ref[1].emittance.abs().max() > 0  # the lamp's emission has a gradient
