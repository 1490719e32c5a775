"""The port's SAH BVH (accel/bvh.py, native/, accel/traverse.py,
Scene.with_bvh) against the JAX package's.

- build_bvh, numpy and native backends, equals JAX's numpy builder array
  for array and in prim_order, exactly, on Cornell + spheres and on the
  1,294-triangle sphere_mesh_scene(3); validate_bvh holds; backend="auto"
  takes the numpy builder when g++ cannot build the native one, and
  "native" then raises.
- raycast_bvh equals JAX's, run op by op, on 4,096 rays inside each scene:
  hit, prim_id and is_sphere exact, t/u/v within 1e-6 relative. (Jitted,
  XLA fuses the sphere roots differently: t of 22 of 1,057 grazing sphere
  hits on Cornell + spheres moved by up to 2.3e-5 relative, measured.) On
  the leaf-ordered table it finds mt_closest_plain's winners.
- Scene.with_bvh leaves equal JAX's; a render through raycast_bvh as the
  raycast_fn equals the default all-triangles route over the same scene.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.accel.bvh import build_bvh as jax_build_bvh  # noqa: E402
from pathtrace_tpu.accel.traverse import raycast_bvh as jax_raycast_bvh  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu_torch import native  # noqa: E402
from pathtrace_tpu_torch.accel.bvh import BVH_FIELDS, build_bvh, validate_bvh  # noqa: E402
from pathtrace_tpu_torch.accel.traverse import raycast_bvh  # noqa: E402
from pathtrace_tpu_torch.integrator.render import render  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops.mt_closest import mt_closest_plain  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from torch_port_helpers import port_scene, scene_to_numpy  # noqa: E402

torch.set_num_threads(1)

SCENES = {
    "cornell_spheres": lambda m: m.cornell_box_scene(include_spheres=True),
    "sphere_mesh3": lambda m: m.sphere_mesh_scene(3),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    """(name, JAX scene with BVH, port scene with BVH)."""
    name = request.param
    return name, SCENES[name](jproc).with_bvh(), SCENES[name](procedural).with_bvh()


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_build_equals_jax(name, backend):
    pos = SCENES[name](procedural).positions()
    ref, ref_order = jax_build_bvh(pos, backend="numpy")
    got, order = build_bvh(pos, backend=backend)
    np.testing.assert_array_equal(order, ref_order)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert (got.num_nodes, got.max_leaf, got.max_depth) == (ref.num_nodes, ref.max_leaf,
                                                            ref.max_depth)
    validate_bvh(got, pos, order)


def test_auto_backend_without_gxx(monkeypatch):
    pos = procedural.cornell_box_scene().positions()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got, order = build_bvh(pos, backend="auto")
    ref, ref_order = build_bvh(pos, backend="numpy")
    np.testing.assert_array_equal(order, ref_order)
    assert all(torch.equal(getattr(got, f), getattr(ref, f)) for f in BVH_FIELDS)
    with pytest.raises(RuntimeError, match="native"):
        build_bvh(pos, backend="native")
    with pytest.raises(ValueError, match="backend"):
        build_bvh(pos, backend="cuda")


def test_validate_bvh_catches_a_broken_tree():
    pos = procedural.cornell_box_scene().positions()
    bvh, order = build_bvh(pos)
    with pytest.raises(AssertionError):
        validate_bvh(bvh, pos, order[::-1].copy())


def test_with_bvh_leaves_equal_jax(scenes):
    _, js, ts = scenes
    got, ref = scene_to_numpy(ts), scene_to_numpy(js)
    assert set(got) == set(ref) and "bvh.bmin" in got
    for k in ref:
        if k != "light_pack":
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["light_pack"], ref["light_pack"], rtol=1e-6, atol=1e-7)
    # the JAX scene carried across holds the same BVH
    carried = port_scene(js)
    assert all(torch.equal(getattr(carried.bvh, f), getattr(ts.bvh, f)) for f in BVH_FIELDS)


def _rays(scene, n=4096, seed=0):
    """Rays from random points in the scene's box in random directions."""
    pos = scene.positions().reshape(-1, 3)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    g = np.random.default_rng(seed)
    org = g.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


def test_raycast_bvh_equals_jax_and_the_all_triangles_search(scenes):
    name, js, ts = scenes
    org, d = _rays(ts)
    with jax.disable_jit():  # op by op: XLA's fused sphere roots differ by ~2e-5
        ref = jax_raycast_bvh(js, jnp.asarray(org), jnp.asarray(d))
    got = raycast_bvh(ts, torch.from_numpy(org), torch.from_numpy(d))
    assert got.hit.any()
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.is_sphere.numpy(), np.asarray(ref.is_sphere))
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(ref.prim_id))
    hit = got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-6)
    np.testing.assert_allclose(got.uv.numpy()[hit], np.asarray(ref.uv)[hit], rtol=1e-6,
                               atol=1e-7)
    # the same winners as the all-triangles search over the leaf-ordered table
    r = org.shape[0]
    b_hit, b_t, b_idx, _, _ = mt_closest_plain(ts.tris, torch.from_numpy(org),
                                               torch.from_numpy(d), torch.zeros(r),
                                               torch.full((r,), 999999.0))
    tri = got.hit & ~got.is_sphere
    assert torch.equal(tri, b_hit & ~got.is_sphere)
    assert torch.equal(got.prim_id[tri], b_idx[tri])
    assert torch.equal(got.t[tri], b_t[tri])


def test_raycast_bvh_keeps_the_last_of_equal_t():
    """Camera rays through pixel centers run along shared edges of the
    room's triangles: equal t on two triangles. The walk (as JAX's) keeps
    the last it visits, which in leaf order has the higher id; the
    all-triangles search keeps the lowest id. Everything else is equal."""
    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops.mt_closest import raycast_mt

    scene = procedural.cornell_box_scene(include_spheres=True).with_bvh()
    rays = kd.probe_rays(scene, procedural.default_camera(64, 64), 4, seed=3)["camera"]
    a, b = raycast_bvh(scene, *rays), raycast_mt(scene, *rays)
    ties = a.hit & (a.prim_id != b.prim_id)
    assert torch.equal(a.hit, b.hit) and torch.equal(a.is_sphere, b.is_sphere)
    assert torch.equal(a.t[a.hit], b.t[b.hit])
    assert 0 < int(ties.sum()) < 0.02 * rays[0].shape[0]
    assert bool((a.prim_id[ties] > b.prim_id[ties]).all()) and not a.is_sphere[ties].any()


def test_render_through_raycast_bvh_equals_default_route():
    scene = procedural.cornell_box_scene(include_spheres=True).with_bvh()
    cam = procedural.default_camera(8, 8)
    a = render(scene, cam, 2, rng.make_key(4), raycast_fn=raycast_bvh, device="cpu")
    b = render(scene, cam, 2, rng.make_key(4), device="cpu")
    assert torch.equal(a, b)
