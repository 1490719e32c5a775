"""The port's all-triangles search (ops/mt_closest.py) against brute and the
JAX package.

- The plain version against JAX `mt_closest_pallas` (interpret mode) and
  `mt_matmul_closest` on test_pallas.py's rays (300 on Cornell, 128 on
  sphere_mesh_scene(3)): hit and idx agree on >= 99% of rays, t within
  1e-4 relative where idx agrees. The JAX searches evaluate a 16-feature
  coefficient fit in f32, which rounds differently from direct
  Möller-Trumbore, so near-ties may pick another winner.
- raycast_mt equals the port's raycast_brute bit for bit: hit and t on
  every ray, every other HitRecord field on the rays that hit (a miss's
  attributes are gathered at an arbitrary triangle and carry no meaning),
  on random, surface and tie rays (a duplicated triangle; rays along the
  diagonal two triangles share). shadow_mt equals shadow_brute.
- The plain version's row chunks do not change its result; the dispatcher
  routes by device and the kernel wrapper refuses CPU tensors.
- The winner's differentiable recompute gives finite gradients on a lane
  whose gathered triangle is parallel to the ray (det = 0).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.ops.mt_matmul import mt_matmul_closest  # noqa: E402
from pathtrace_tpu.ops.pallas.intersect_kernel import mt_closest_pallas  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.models.scene import Material, Scene, Triangles  # noqa: E402
from pathtrace_tpu_torch.ops import kd_raycast as kd  # noqa: E402
from pathtrace_tpu_torch.ops import mt_closest as mt  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import build  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel  # noqa: E402
from pathtrace_tpu_torch.ops.intersect import (BIG_T, HitRecord, mt_gather,  # noqa: E402
                                               raycast_brute, shadow_brute)
from pathtrace_tpu_torch.utils.math3 import EPS  # noqa: E402
from torch_port_helpers import port_scene  # noqa: E402

torch.set_num_threads(1)


def _rays(n, seed):
    """test_pallas.py:12-17."""
    g = np.random.default_rng(seed)
    org = g.uniform(-25.0, 45.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(org), torch.from_numpy(d)


def _ranges(n, t_max=BIG_T):
    return torch.zeros((n,)), torch.full((n,), t_max)


@pytest.mark.parametrize("which", ["cornell", "sphere_mesh3"])
def test_plain_matches_jax_searches(which):
    """test_pallas.py:20-53's rays and block shapes."""
    if which == "cornell":
        js, n, seed, blocks = jproc.cornell_box_scene().with_mt(), 300, 0, (128, 128)
    else:
        js, n, seed, blocks = jproc.sphere_mesh_scene(subdivisions=3).with_mt(), 128, 1, (128, 512)
    org, d = _rays(n, seed)
    t_min, t_max = _ranges(n)
    hit, t, idx, _, _ = mt.mt_closest_plain(port_scene(js).tris, org, d, t_min, t_max)
    jargs = [jnp.asarray(x.numpy()) for x in (org, d, t_min, t_max)]
    for ref in (mt_matmul_closest(js.mt, *jargs),
                mt_closest_pallas(js.mt, *jargs, block_r=blocks[0], block_t=blocks[1],
                                  interpret=True)):
        r_hit, r_t, r_idx = (np.asarray(x) for x in ref[:3])
        same = (r_hit == hit.numpy()) & (~r_hit | (r_idx == idx.numpy()))
        assert same.mean() >= 0.99, same.mean()
        both = same & r_hit
        np.testing.assert_allclose(t.numpy()[both], r_t[both], rtol=1e-4)
        assert both.sum() > 0.2 * n


def assert_hits_equal(a: HitRecord, b: HitRecord):
    assert torch.equal(a.hit, b.hit) and torch.equal(a.t, b.t)
    h = a.hit
    for f in dataclasses.fields(HitRecord):
        if f.name in ("hit", "t", "mat"):
            continue
        assert torch.equal(getattr(a, f.name)[h], getattr(b, f.name)[h]), f.name
    for f in dataclasses.fields(Material):
        assert torch.equal(getattr(a.mat, f.name)[h], getattr(b.mat, f.name)[h]), f.name


def _tie_scene():
    """A quad split along its diagonal (triangles 0, 1) and a copy of
    triangle 1 (id 2): rays along the diagonal hit 0 and 1 at equal t, rays
    into triangle 1 hit 1 and 2 at equal t. Lowest id wins."""
    a, b, c, e = [-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]
    pos = np.float32([[a, b, c], [a, c, e], [a, c, e]])
    normals = np.broadcast_to(np.float32([0, 0, 1]), pos.shape)
    return Scene.build(Triangles.from_vertices(pos, normals), Material.make(3))


def _tie_rays():
    s = np.linspace(-0.9, 0.9, 7, dtype=np.float32)
    diag = np.stack([s, s, np.full_like(s, 3.0)], axis=1)
    inside = np.stack([s * 0.3 - 0.5, s * 0.3 + 0.5, np.full_like(s, 3.0)], axis=1)
    org = np.concatenate([diag, inside])
    d = np.broadcast_to(np.float32([0, 0, -1]), org.shape)
    return torch.from_numpy(org), torch.from_numpy(np.ascontiguousarray(d))


SCENES = {
    "spheres": lambda: procedural.cornell_box_scene(include_spheres=True),
    "sphere_mesh3": lambda: procedural.sphere_mesh_scene(3),
    "ties": _tie_scene,
}
RAYS = {
    "random": lambda sc: _rays(256, 2),
    "surface": lambda sc: kd.probe_rays(sc, procedural.default_camera(8, 8), 128, seed=5)
    ["surface"][:2],
    "ties": lambda sc: _tie_rays(),
}
CASES = [("spheres", "random"), ("spheres", "surface"), ("sphere_mesh3", "random"),
         ("sphere_mesh3", "surface"), ("ties", "ties")]


@pytest.mark.parametrize("scene_name,rays", CASES)
def test_raycast_mt_equals_brute(scene_name, rays):
    scene = SCENES[scene_name]()
    org, d = RAYS[rays](scene)
    a = raycast_brute(scene, org, d)
    b = mt.raycast_mt(scene, org, d)
    assert a.hit.float().mean().item() > 0.2
    assert_hits_equal(a, b)
    if rays == "ties":
        assert a.hit.all() and b.prim_id.tolist() == [0] * 7 + [1] * 7


@pytest.mark.parametrize("scene_name,rays", CASES)
def test_shadow_mt_equals_brute(scene_name, rays):
    """Per-ray ranges [EPS, t_max] with t_max drawn per ray."""
    scene = SCENES[scene_name]()
    org, d = RAYS[rays](scene)
    r = org.shape[0]
    t_min = torch.full((r,), EPS)
    t_max = torch.from_numpy(np.random.default_rng(7).uniform(0.5, 60.0, r).astype(np.float32))
    a_hit, a_pid, a_sph = shadow_brute(scene, org, d, t_min, t_max)
    b_hit, b_pid, b_sph = mt.shadow_mt(scene, org, d, t_min, t_max)
    assert torch.equal(a_hit, b_hit) and torch.equal(a_sph, b_sph)
    assert torch.equal(a_pid[a_hit], b_pid[a_hit])


@pytest.mark.parametrize("mode", mt.MODES)
def test_plain_row_chunks_and_misses(monkeypatch, mode):
    """Chunks of rows give the one-chunk result; a miss has t = u = v = 0
    and idx = T - 1 (closest_masked); shadow mode leaves u = v = 0."""
    tris = procedural.sphere_mesh_scene(3).tris
    org, d = _rays(200, 4)
    whole = mt.mt_closest_plain(tris, org, d, *_ranges(200), mode)
    monkeypatch.setattr(mt, "PAIR_CHUNK", 37 * tris.count)
    chunked = mt.mt_closest_plain(tris, org, d, *_ranges(200), mode)
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)
    hit, t, idx, u, v = whole
    assert 0.1 < hit.float().mean().item() < 0.9
    miss = ~hit
    assert (t[miss] == 0).all() and (idx[miss] == tris.count - 1).all()
    assert (u[miss] == 0).all() and (v[miss] == 0).all()
    if mode == "shadow":
        assert not u.any() and not v.any()


def test_routes_by_device(monkeypatch):
    """CPU tensors run the plain version; another device raises; the kernel
    wrapper refuses CPU tensors before it loads (or builds) the library."""
    def no_build():
        raise AssertionError("the kernel wrapper reached the library on CPU tensors")

    monkeypatch.setattr(build, "load_library", no_build)
    tris = procedural.cornell_box_scene().tris
    org, d = _rays(16, 3)
    args = (org, d, *_ranges(16))
    for x, y in zip(mt.mt_closest(tris, *args), mt.mt_closest_plain(tris, *args)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="device"):
        mt.mt_closest(tris, *(x.to("meta") for x in args))
    with pytest.raises(ValueError, match="CUDA"):
        mt_kernel.launch(tris.search_table, *args)
    with pytest.raises(ValueError, match="mode"):
        mt.mt_closest_plain(tris, *args, mode="any")
    assert tris.search_table.shape == (tris.count, mt_kernel.TRI_STRIDE)
    assert torch.equal(tris.search_table[:, 3:6], tris.v1 - tris.v0)


def test_mt_gather_grad_finite_at_zero_det():
    """A lane whose gathered triangle lies in the ray's plane (det = 0):
    inv_det is 0 and the gradient is 0, not 0 * inf."""
    tris = _tie_scene().tris
    org = torch.tensor([[0.0, -5.0, 0.0], [0.2, -0.3, 3.0]], requires_grad=True)
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0]], requires_grad=True)
    t, u, v, valid = mt_gather(tris, torch.zeros(2, dtype=torch.int32), org, d,
                               torch.zeros(2), torch.full((2,), BIG_T))
    assert valid.tolist() == [False, True]
    (t + u + v).sum().backward()
    assert torch.isfinite(org.grad).all() and torch.isfinite(d.grad).all()
    assert not org.grad[0].any()
