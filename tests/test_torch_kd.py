"""The port's KD raycast (ops/kd_raycast.py) against brute and the JAX package.

- The plain version equals the port's raycast_brute bit for bit: hit and
  t on every ray, and every HitRecord field on the rays that hit (a miss's
  attribute fields are gathered at an arbitrary triangle by brute and carry
  no meaning). Random rays and rays that start on the surface
  (test_kdgrid.py:60-90), with and without the reference demo's spheres.
  shadow_kd equals shadow_brute (hit, is_sphere, and the winner on hits)
  on per-ray ranges, and equals JAX shadow_brute on surface rays.
- Ties: two triangles at equal t in different cells resolve to the lower
  original id, as brute does.
- Against JAX raycast_binned_v3 / shadow_binned_v3 in interpret mode
  (patched as test_pair_kernel.py:195-206), whose bf16-split kernel orders
  near-ties differently: hit agreement > 0.995, prim_id equal wherever
  both hit, t within rtol 1e-4 / atol 1e-3; shadow winner identity > 0.99
  on random rays.
- The engines (wavefront static and pool, megakernel) through KD cells
  equal the same engines through brute bit for bit (image and rays), and
  meet test_golden.py's bars against JAX `render` on the same scene
  without KD cells.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu import render as jax_render  # noqa: E402
from pathtrace_tpu.accel import binned as jbinned  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.ops.pallas import pair_kernel  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.accel.binned import ClusterArrays  # noqa: E402
from pathtrace_tpu_torch.accel.kdgrid import crossing_stats  # noqa: E402
from pathtrace_tpu_torch.integrator import megakernel  # noqa: E402
from pathtrace_tpu_torch.integrator.render import render  # noqa: E402
from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_stats  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.models.scene import Material, Scene, Triangles  # noqa: E402
from pathtrace_tpu_torch.ops import kd_raycast as kd  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import build  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel  # noqa: E402
from pathtrace_tpu_torch.ops.intersect import (HitRecord, raycast_brute,  # noqa: E402
                                               shadow_brute)
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.math3 import EPS  # noqa: E402
from torch_port_helpers import port_scene  # noqa: E402

torch.set_num_threads(1)


def _rays(n, seed, lo=-25.0, hi=45.0):
    """test_kdgrid.py:12-17: random origins in and around the room."""
    g = np.random.default_rng(seed)
    org = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(org), torch.from_numpy(d)


def _surface_rays(scene, n, seed):
    """test_kdgrid.py:67-73: origins 1e-3 from random vertices."""
    g = np.random.default_rng(seed)
    v0 = scene.tris.v0.numpy()
    org = (v0[g.integers(0, v0.shape[0], n)] + g.normal(scale=1e-3, size=(n, 3)))
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(org.astype(np.float32)), torch.from_numpy(d)


RAYS = {"random": lambda sc: _rays(512, 0), "surface": lambda sc: _surface_rays(sc, 256, 3)}


@pytest.fixture(scope="module")
def scenes():
    """sphere_mesh_scene(4) with KD cells of 128, without and with the
    reference demo's two spheres."""
    base = procedural.sphere_mesh_scene(4)
    with_spheres = Scene.build(base.tris, base.mat, procedural.reference_demo_spheres())
    return {False: base.with_kd_binned(max_tris=128),
            True: with_spheres.with_kd_binned(max_tris=128)}


def assert_hits_equal(a: HitRecord, b: HitRecord):
    assert torch.equal(a.hit, b.hit) and torch.equal(a.t, b.t)
    h = a.hit
    for f in dataclasses.fields(HitRecord):
        if f.name in ("hit", "t", "mat"):
            continue
        assert torch.equal(getattr(a, f.name)[h], getattr(b, f.name)[h]), f.name
    for f in dataclasses.fields(Material):
        assert torch.equal(getattr(a.mat, f.name)[h], getattr(b.mat, f.name)[h]), f.name


@pytest.mark.parametrize("spheres", [False, True])
@pytest.mark.parametrize("rays", sorted(RAYS))
def test_raycast_kd_equals_brute(scenes, spheres, rays):
    scene = scenes[spheres]
    org, d = RAYS[rays](scene)
    a = raycast_brute(scene, org, d)
    b = kd.raycast_kd(scene, org, d)
    assert 0.2 < a.hit.float().mean().item()
    assert_hits_equal(a, b)
    if spheres:
        assert bool(b.is_sphere.any())


@pytest.mark.parametrize("spheres", [False, True])
@pytest.mark.parametrize("rays", sorted(RAYS))
def test_shadow_kd_equals_brute(scenes, spheres, rays):
    """Per-ray ranges: t in [EPS, t_max] with t_max drawn per ray, so the
    cell cull and the accept test both use each ray's own range."""
    scene = scenes[spheres]
    org, d = RAYS[rays](scene)
    r = org.shape[0]
    t_min = torch.full((r,), EPS)
    t_max = torch.from_numpy(np.random.default_rng(7).uniform(0.5, 60.0, r).astype(np.float32))
    a_hit, a_pid, a_sph = shadow_brute(scene, org, d, t_min, t_max)
    b_hit, b_pid, b_sph = kd.shadow_kd(scene, org, d, t_min, t_max)
    assert 0.05 < a_hit.float().mean().item() < 0.95
    assert torch.equal(a_hit, b_hit) and torch.equal(a_sph, b_sph)
    assert torch.equal(a_pid[a_hit], b_pid[a_hit])


@pytest.mark.parametrize("name", ["camera", "surface", "shadow"])
def test_probe_rays_kd_equals_brute(scenes, name):
    """The ray sets chip_smoke.py and the card tests hold the kernel to,
    through the plain version: equal to brute in both modes."""
    scene = scenes[True]
    org, d, t_min, t_max = kd.probe_rays(scene, procedural.default_camera(16, 16), 256,
                                         seed=1)[name]
    assert org.shape == d.shape == (256, 3) and t_min.shape == t_max.shape == (256,)
    assert_hits_equal(raycast_brute(scene, org, d, t_min, t_max),
                      kd.raycast_kd(scene, org, d, t_min, t_max))
    a_hit, a_pid, a_sph = shadow_brute(scene, org, d, t_min, t_max)
    b_hit, b_pid, b_sph = kd.shadow_kd(scene, org, d, t_min, t_max)
    assert torch.equal(a_hit, b_hit) and torch.equal(a_sph, b_sph)
    assert torch.equal(a_pid[a_hit], b_pid[a_hit])
    assert a_hit.float().mean().item() > 0.5


def _two_cell_tie():
    """Two copies of one triangle, ids 0 and 1, in two same-box cells that
    list id 1 first: a ray through both sees equal t."""
    tri = np.float32([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]])
    pos = np.concatenate([tri, tri])
    cells = ClusterArrays.from_cells(pos, bmin=[[-1, -1, -0.1]] * 2, bmax=[[1, 1, 0.1]] * 2,
                                     prim_start=[0, 1], prim_count=[1, 1], dup_map=[1, 0])
    normals = np.broadcast_to(np.float32([0, 0, 1]), pos.shape)
    scene = Scene.build(Triangles.from_vertices(pos, normals), Material.make(2))
    return dataclasses.replace(scene, clusters=cells)


@pytest.mark.parametrize("mode", kd.MODES)
def test_equal_t_resolves_to_lowest_id(mode):
    scene = _two_cell_tie()
    org = torch.tensor([[0.1, -0.2, 5.0], [0.0, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])  # front face, back face (culled)
    hit, t, u, v, pid = kd.kd_closest_plain(scene.clusters, org, d, torch.zeros(2),
                                            torch.full((2,), 100.0), mode)
    assert hit.tolist() == [True, False] and pid.tolist() == [0, 0]
    assert t[0].item() == 5.0 and t[1].item() == 0.0
    brute = raycast_brute(scene, org, d)
    assert brute.prim_id[0].item() == 0 and brute.t[0].item() == 5.0
    if mode == "closest":
        assert_hits_equal(brute, kd.raycast_kd(scene, org, d))
    else:
        assert (u.tolist(), v.tolist()) == ([0.0, 0.0], [0.0, 0.0])


def test_surface_rays_cross_few_cells(scenes):
    """test_kdgrid.py:75-77: rays leaving the dense surface cross few cells."""
    scene = scenes[False]
    stats = crossing_stats(scene.clusters, *_surface_rays(scene, 256, 3))
    assert stats["max"] <= 20 and 1.0 <= stats["mean"] <= stats["p99"], stats


@pytest.fixture(scope="module")
def jax_kd():
    """The same KD scene in both packages (cells carried across)."""
    js = jproc.sphere_mesh_scene(subdivisions=4).with_kd_binned(max_tris=128)
    return js, port_scene(js)


def _interpret():
    orig = pair_kernel.pair_blocks_search

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    return mock.patch.object(pair_kernel, "pair_blocks_search", patched)


def test_raycast_kd_matches_jax_v3(jax_kd):
    js, ts = jax_kd
    org, d = _rays(512, 0)
    with _interpret():
        a = jbinned.raycast_binned_v3(js, jnp.asarray(org.numpy()), jnp.asarray(d.numpy()))
    b = kd.raycast_kd(ts, org, d)
    a_hit, b_hit = np.asarray(a.hit), b.hit.numpy()
    assert (a_hit == b_hit).mean() > 0.995
    both = a_hit & b_hit
    np.testing.assert_array_equal(np.asarray(a.prim_id)[both], b.prim_id.numpy()[both])
    np.testing.assert_allclose(b.t.numpy()[both], np.asarray(a.t)[both], rtol=1e-4, atol=1e-3)


def _same_winner(a, b) -> np.ndarray:
    """Per ray: equal hit flags and, on hits, equal winning triangle."""
    a_hit, b_hit = np.asarray(a[0]), np.asarray(b[0])
    return (a_hit == b_hit) & (~a_hit | (np.asarray(a[1]) == np.asarray(b[1])))


def test_shadow_kd_matches_jax_v3(jax_kd):
    """Random rays against shadow_binned_v3 (> 0.99). On rays leaving the
    surface, v3's shadow mode (banded bf16 t, no exact recompute) agrees
    with JAX's own shadow_brute on only 95.3% of rays (measured), so there
    the port is held to JAX shadow_brute, exactly."""
    from pathtrace_tpu.ops.intersect import shadow_brute as jax_shadow_brute
    js, ts = jax_kd
    for rays, bar in ((_rays(512, 0), 0.99), (_surface_rays(ts, 256, 3), None)):
        org, d = rays
        r = org.shape[0]
        ranges = (np.full((r,), EPS, np.float32), np.full((r,), 50.0, np.float32))
        jargs = [jnp.asarray(x) for x in (org.numpy(), d.numpy(), *ranges)]
        b_hit, b_pid, _ = kd.shadow_kd(ts, org, d, *(torch.from_numpy(x) for x in ranges))
        b = (b_hit.numpy(), b_pid.numpy())
        if bar is None:
            assert _same_winner(jax_shadow_brute(js, *jargs), b).all()
            continue
        with _interpret():
            a = jbinned.shadow_binned_v3(js, *jargs)
        assert _same_winner(a, b).mean() > bar


ENGINES = {
    "wavefront": lambda sc, cam, key: render_wavefront_stats(sc, cam, 2, key, lanes=256,
                                                             device="cpu"),
    "wavefront_pool": lambda sc, cam, key: render_wavefront_stats(sc, cam, 2, key, lanes=200,
                                                                  device="cpu"),
    "megakernel": lambda sc, cam, key: (render(sc, cam, 2, key, device="cpu"), None),
}


@pytest.fixture(scope="module")
def engine_images(scenes):
    """{engine: ((image, rays) through KD, (image, rays) through brute)} at
    16x16 @ 2 spp."""
    kd_scene = scenes[False]
    brute_scene = dataclasses.replace(kd_scene, clusters=None)
    cam, key = procedural.default_camera(16, 16), rng.make_key(21)
    return {name: (run(kd_scene, cam, key), run(brute_scene, cam, key))
            for name, run in ENGINES.items()}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_kd_equals_brute(engine_images, engine):
    (a, rays_a), (b, rays_b) = engine_images[engine]
    assert torch.equal(a, b)
    assert rays_a == rays_b


def test_engines_kd_match_jax_render(engine_images):
    ref = np.asarray(jax_render(jproc.sphere_mesh_scene(4), jproc.default_camera(16, 16), 2,
                                jrng.make_key(21)))
    for name, ((img, _), _) in engine_images.items():
        img = img.numpy()
        close = np.isclose(img, ref, rtol=5e-3, atol=5e-3)
        assert close.mean() > 0.999, (name, close.mean())
        assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3, name


def test_default_raycast_routes_by_scene(scenes):
    """KD scenes take the KD search, any other scene the all-triangles
    search (ops/mt_closest.py); `search` replaces the route's search."""
    from pathtrace_tpu_torch.ops import mt_closest as mt
    kd_scene = scenes[False]
    brute_scene = dataclasses.replace(kd_scene, clusters=None)
    route = megakernel.default_raycast(brute_scene)
    assert route.func is mt.raycast_mt and route.keywords["search"] is mt.mt_closest
    route = megakernel.default_shadow_raycast(brute_scene, mt.mt_closest_plain)
    assert route.func is mt.shadow_mt and route.keywords["search"] is mt.mt_closest_plain
    route = megakernel.default_raycast(kd_scene)
    assert route.func is kd.raycast_kd and route.keywords["search"] is kd.kd_closest
    route = megakernel.default_shadow_raycast(kd_scene, kd.kd_closest_plain)
    assert route.func is kd.shadow_kd and route.keywords["search"] is kd.kd_closest_plain


def test_kd_closest_routes_by_device(scenes, monkeypatch):
    """CPU tensors run the plain version; a device that is neither CPU nor
    CUDA raises; the kernel wrapper refuses CPU tensors before it loads
    (or builds) the library."""
    def no_build():
        raise AssertionError("the kernel wrapper reached the library on CPU tensors")

    monkeypatch.setattr(build, "load_library", no_build)
    cl = scenes[False].clusters
    org, d = _rays(8, 1)
    r = org.shape[0]
    args = (org, d, torch.zeros(r), torch.full((r,), 1e6))
    for x, y in zip(kd.kd_closest(cl, *args), kd.kd_closest_plain(cl, *args)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="device"):
        kd.kd_closest(cl, *(x.to("meta") for x in args))
    with pytest.raises(ValueError, match="CUDA"):
        kd_kernel.launch(cl, *args)
    with pytest.raises(ValueError, match="mode"):
        kd.kd_closest_plain(cl, *args, mode="any")


def test_kernel_rejects_cell_tables_beyond_shared_memory():
    m = kd_kernel.MAX_CELLS + 1
    pos = np.zeros((1, 3, 3), np.float32)
    cells = ClusterArrays.from_cells(pos, np.zeros((m, 3)), np.ones((m, 3)),
                                     np.zeros(m, np.int64), np.zeros(m, np.int64),
                                     np.zeros(0, np.int64))
    org, d = _rays(4, 2)
    with pytest.raises(ValueError, match="shared memory"):
        kd_kernel.launch(cells, org, d, torch.zeros(4), torch.ones(4))
