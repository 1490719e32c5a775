"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; without a GPU they skip (marker
`gpu`). On the card, run: python -m pytest tests/test_torch_kernel.py -q.
Sizes are chip_smoke.py's phase 3:
- planar Cornell 32x32 @ 8 spp: the JAX package's bars between its engines
  (tests/test_fused.py): > 99% of pixels within 1e-4, mean 2e-3, ray
  counts 1e-3. They also hold with NEE off.
- Cornell with spheres, and the glass scene, 32x32 @ 16 spp: > 99% of
  pixels within 1e-3, mean 2%, ray counts 1e-5. Curved transport is
  chaotic, so test_fused.py holds its engines, which round differently, to
  50% of pixels and 2% of rays; the kernel and its plain version draw the
  same Philox streams and round alike (-fmad=false, IEEE division in both:
  math3.div_scalar), so only a rare last-ulp fork may differ, and a wrong
  lobe that few pixels reach fails. On an H100 both scenes measured
  bit-equal images and equal ray counts.

The KD raycast kernel (csrc/kd_raycast.cu) against kd_closest_plain on
the card, for sphere_mesh_scene(4) with cells of 128 and blob82k with
cells of 1024: camera, surface and shadow rays (kd_raycast.probe_rays) and
the edge sets of kd_raycast.edge_rays (axis-parallel directions, rays
along a cell face, rays that start inside a cell, t_min > 0 segments,
misses, the largest cell), in both modes; equal t across two cells
(duplicated members); a row of 80 cells, more than a warp lists at once;
an empty ray set. Both
compute the same float32 operations with the same tie rule, and the
kernel's walk visits every cell that can hold a nearer hit, so the bar is
chip_smoke.py's phase 5: hit, t, u, v and prim_id bit-equal on every ray.
The wavefront through the kernel against the wavefront through the plain
search at static lanes (one film slot a lane, no atomics): bit-equal image
and rays; and at the bar kept from before, > 99% of pixels within 1e-3,
rays within 1e-5.

The all-triangles kernel (csrc/mt_closest.cu) against mt_closest_plain, in
both modes, on random rays (Cornell + spheres, 38 triangles), on the
1,294-triangle sphere_mesh_scene(3), whose table spans two shared-memory
tiles, and on the 5,134-triangle sphere_mesh_scene(4) (six tiles); at
ray counts 1, 31, 129 and 65,537 (a last block with idle threads, a chunk
of rows shorter than a mask); and on an empty table (a scene without
triangles: every ray a miss, idx 0): the same float32 operations in the
same order with the same tie rule, so hit and idx are bit-equal, and t/u/v
bit-equal where hit. Each call is one launch, the empty table's too. The
fused kernel's reference wavefront takes the plain search too, so it runs
no kernel. A scene of spheres alone renders through the fused kernel (no
triangle, no light) and through the wavefront on the all-triangles kernel,
each bit-equal to its plain version.

The bounce kernel's schedule (one loop per lane over bounce iterations,
paths regenerated in place) against the plain wavefront at the same lanes,
bit for bit: the image and the rays of every lane
(profile_main.schedule_share), with lanes beyond the path pool, several
lanes per pixel, several pixels per lane, glass refraction chains up to
refract_cap, NEE off, max_bounce 1 and 2, path ids whose next strided id
passes 2**31, and the fused engine's default lanes.
"""

import pytest
import torch

from pathtrace_tpu_torch import profile_main
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_stats
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.ops import kd_raycast as kd
from pathtrace_tpu_torch.ops import mt_closest as mt
from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel
from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel
from pathtrace_tpu_torch.utils import rng
from torch_port_helpers import cell_row_scene, two_cell_tie_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


SCENES = {
    "planar": lambda: procedural.cornell_box_scene(),
    "spheres": lambda: procedural.cornell_box_scene(include_spheres=True),
    "glass": lambda: procedural.glass_scene(),  # the pure-refractive lobe
    "sphere_only": procedural.sphere_only_scene,  # no triangle, no light
}


@pytest.mark.parametrize("scene_name,nee,spp,tol,pix_bar,mean_bar,rays_bar", [
    ("planar", True, 8, 1e-4, 0.99, 2e-3, 1e-3),
    ("planar", False, 8, 1e-4, 0.99, 2e-3, 1e-3),
    ("spheres", True, 16, 1e-3, 0.99, 0.02, 1e-5),
    ("glass", True, 16, 1e-3, 0.99, 0.02, 1e-5),
])
def test_kernel_matches_plain(cuda, scene_name, nee, spp, tol, pix_bar, mean_bar, rays_bar):
    scene = SCENES[scene_name]().to(cuda)
    cam = procedural.default_camera(32, 32)
    key, cfg = rng.make_key(5), IntegratorConfig(nee=nee)
    launches = bk.LAUNCHES
    a, rays_a = bk.render_wavefront_fused(scene, cam, spp, key, cfg, lanes=1024,
                                          chunk_spp=spp, device=cuda)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == launches + 1
    b, rays_b = render_wavefront_stats(scene, cam, spp, key, cfg, lanes=1024, device=cuda,
                                       search=mt.mt_closest_plain)
    a, b = a.cpu(), b.cpu()
    assert torch.isclose(a, b, rtol=tol, atol=tol).float().mean().item() > pix_bar
    assert abs(a.mean().item() - b.mean().item()) / b.mean().item() < mean_bar
    assert rays_a == pytest.approx(rays_b, rel=rays_bar)


@pytest.mark.parametrize("lanes", [256, 1024, 4096])
def test_kernel_lane_layouts(cuda, lanes):
    """Several pixels per lane, one, and several lanes per pixel."""
    scene = procedural.cornell_box_scene().to(cuda)
    cam = procedural.default_camera(32, 32)
    key = rng.make_key(2)
    a, ra = bk.render_wavefront_fused(scene, cam, 4, key, lanes=lanes, device=cuda)
    b, rb = render_wavefront_stats(scene, cam, 4, key, lanes=lanes, device=cuda,
                                   search=mt.mt_closest_plain)
    assert torch.isclose(a, b, rtol=1e-4, atol=1e-4).float().mean().item() > 0.99
    assert ra == pytest.approx(rb, rel=1e-3)


def test_kernel_chunked_equals_single(cuda):
    scene = procedural.cornell_box_scene(include_spheres=True).to(cuda)
    cam = procedural.default_camera(8, 8)
    key = rng.make_key(9)
    launches = bk.LAUNCHES
    a, ra = bk.render_wavefront_fused(scene, cam, 8, key, lanes=64, chunk_spp=8, device=cuda)
    b, rb = bk.render_wavefront_fused(scene, cam, 8, key, lanes=64, chunk_spp=2, device=cuda)
    assert bk.LAUNCHES == launches + 1 + 4
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert ra == rb


KD_SCENES = {
    "sphere_mesh": lambda: procedural.sphere_mesh_scene(4).with_kd_binned(max_tris=128),
    "blob82k": lambda: procedural.blob_mesh_scene().with_kd_binned(max_tris=1024),
}


def assert_kd_agree(k, p, what=""):
    """chip_smoke.py's bar between the KD kernel and its plain version:
    hit, t, u, v and prim_id bit-equal on every ray."""
    for name, a, b in zip(("hit", "t", "u", "v", "prim_id"), k, p):
        assert torch.equal(a, b), f"{what}: {name} differs on {int((a != b).sum())} rays"


def _kd_check(scene, sets, mode, hit_floor=0.3):
    """Through the entry the path calls: one launch a set, bit-equal."""
    for name, (org, d, t_min, t_max) in sets.items():
        launches = kd_kernel.LAUNCHES
        k = kd.kd_closest(scene.clusters, org, d, t_min, t_max, mode)
        torch.cuda.synchronize()
        assert kd_kernel.LAUNCHES == launches + 1
        p = kd.kd_closest_plain(scene.clusters, org, d, t_min, t_max, mode)
        assert_kd_agree(k, p, f"{name} rays, {mode}")
        if name not in ("miss", "segment"):
            assert k[0].float().mean().item() > hit_floor, name
        if mode == "shadow":
            assert not bool(k[2].any()) and not bool(k[3].any())


@pytest.mark.parametrize("scene_name", sorted(KD_SCENES))
@pytest.mark.parametrize("mode", kd.MODES)
def test_kd_kernel_matches_plain(cuda, scene_name, mode):
    scene = KD_SCENES[scene_name]().to(cuda)
    rays = kd.probe_rays(scene, procedural.default_camera(64, 64), 4096, seed=3)
    _kd_check(scene, rays, mode)


@pytest.mark.parametrize("scene_name", sorted(KD_SCENES))
@pytest.mark.parametrize("mode", kd.MODES)
def test_kd_kernel_edge_rays(cuda, scene_name, mode):
    scene = KD_SCENES[scene_name]().to(cuda)
    sets = kd.edge_rays(scene, 4096, seed=1)
    assert not bool(kd.kd_closest_plain(scene.clusters, *sets["miss"], mode)[0].any())
    _kd_check(scene, sets, mode)


def test_kd_kernel_ties_and_long_rows(cuda):
    """Equal t in two cells goes to the lower id; a ray crossing 80 cells,
    nearest last in index order, more than a warp lists at once."""
    for scene, rays in (two_cell_tie_scene(), cell_row_scene(80)):
        scene = scene.to(cuda)
        rays = {"synthetic": tuple(x.to(cuda) for x in rays)}
        for mode in kd.MODES:
            _kd_check(scene, rays, mode, hit_floor=0.5)


def test_kd_kernel_empty_ray_set(cuda):
    scene = KD_SCENES["sphere_mesh"]().to(cuda)
    empty = (torch.zeros((0, 3), device=cuda), torch.zeros((0, 3), device=cuda),
             torch.zeros((0,), device=cuda), torch.zeros((0,), device=cuda))
    for mode in kd.MODES:
        out = kd.kd_closest(scene.clusters, *empty, mode)
        assert [x.shape for x in out] == [(0,)] * 5
        assert [x.dtype for x in out] == [torch.bool] + [torch.float32] * 3 + [torch.int32]


def test_kd_kernel_wavefront_matches_plain(cuda):
    scene = KD_SCENES["sphere_mesh"]().to(cuda)
    cam = procedural.default_camera(32, 32)
    key = rng.make_key(4)
    launches = kd_kernel.LAUNCHES
    a, rays_a = render_wavefront_stats(scene, cam, 4, key, lanes=1024, device=cuda)
    after_kernel = kd_kernel.LAUNCHES
    assert after_kernel > launches
    b, rays_b = render_wavefront_stats(scene, cam, 4, key, lanes=1024, device=cuda,
                                       search=kd.kd_closest_plain)
    assert kd_kernel.LAUNCHES == after_kernel  # the plain search launches nothing
    assert torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item() > 0.99
    assert rays_a == pytest.approx(rays_b, rel=1e-5)


@pytest.mark.parametrize("scene_name", sorted(KD_SCENES))
def test_kd_kernel_wavefront_bit_equal(cuda, scene_name):
    """Static lanes, one film slot a lane: no atomics, so the same winners
    give the same image and rays bit for bit."""
    scene = KD_SCENES[scene_name]().to(cuda)
    cam = procedural.default_camera(32, 32)
    key = rng.make_key(6)
    a, rays_a = render_wavefront_stats(scene, cam, 2, key, lanes=1024, device=cuda)
    b, rays_b = render_wavefront_stats(scene, cam, 2, key, lanes=1024, device=cuda,
                                       search=kd.kd_closest_plain)
    assert torch.equal(a, b) and rays_a == rays_b


MT_SCENES = {
    "spheres": lambda: procedural.cornell_box_scene(include_spheres=True),
    "sphere_mesh3": lambda: procedural.sphere_mesh_scene(3),  # 1,294 triangles, two tiles
    "sphere_mesh4": lambda: procedural.sphere_mesh_scene(4),  # 5,134 triangles, six tiles
}


def _random_rays(n, dev, seed=6):
    g = torch.Generator().manual_seed(seed)
    org = (torch.rand((n, 3), generator=g) * 70.0 - 25.0).to(dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1).to(dev)
    return org, d, torch.zeros((n,), device=dev), (torch.rand((n,), generator=g) * 80.0).to(dev)


def _mt_check(tris, name, args, mode, hit_floor=0.1):
    """One launch through the entry the paths call, bit-equal to the plain
    version: hit and idx everywhere, t/u/v where hit."""
    launches = mt_kernel.LAUNCHES
    k_hit, *k = mt.mt_closest(tris, *args, mode)
    torch.cuda.synchronize()
    assert mt_kernel.LAUNCHES == launches + 1
    p_hit, *p = mt.mt_closest_plain(tris, *args, mode)
    assert torch.equal(k_hit, p_hit), name
    assert torch.equal(k[1], p[1]), name
    assert p_hit.float().mean().item() >= hit_floor, name
    for a, b in zip(k, p):
        assert torch.equal(a[p_hit], b[p_hit]), name
    if mode == "shadow":
        assert not bool(k[2].any()) and not bool(k[3].any())


@pytest.mark.parametrize("scene_name", sorted(MT_SCENES))
@pytest.mark.parametrize("mode", mt.MODES)
def test_mt_kernel_matches_plain(cuda, scene_name, mode):
    scene = MT_SCENES[scene_name]().to(cuda)
    rays = kd.probe_rays(scene, procedural.default_camera(64, 64), 4096, seed=3)
    rays["random"] = _random_rays(5000, cuda)  # the last block has idle threads
    for name, args in rays.items():
        _mt_check(scene.tris, name, args, mode)


@pytest.mark.parametrize("n", [1, 31, 129, 65537])
@pytest.mark.parametrize("mode", mt.MODES)
def test_mt_kernel_ragged_ray_counts(cuda, n, mode):
    scene = MT_SCENES["spheres"]().to(cuda)
    _mt_check(scene.tris, f"{n} rays", _random_rays(n, cuda, seed=n), mode, hit_floor=0.0)


@pytest.mark.parametrize("mode", mt.MODES)
def test_mt_kernel_empty_table(cuda, mode):
    """A scene without triangles: one launch, every ray a miss with idx 0."""
    tris = procedural.sphere_only_scene().to(cuda).tris
    assert tris.search_table.shape == (0, mt_kernel.TRI_STRIDE)
    args = _random_rays(4096, cuda)
    _mt_check(tris, "empty table", args, mode, hit_floor=0.0)
    hit, t, idx, u, v = mt.mt_closest(tris, *args, mode)
    assert not hit.any() and not idx.any() and not t.any() and not u.any() and not v.any()


def test_sphere_only_scene_kernels_match_plain(cuda):
    """Spheres alone through the wavefront on the all-triangles kernel (an
    empty table each launch) and through the fused kernel (no triangle, no
    light): each bit-equal to its plain version."""
    scene = procedural.sphere_only_scene().to(cuda)
    cam = procedural.default_camera(32, 32)
    key = rng.make_key(4)
    launches = mt_kernel.LAUNCHES
    a, rays_a = render_wavefront_stats(scene, cam, 4, key, lanes=1024, device=cuda)
    assert mt_kernel.LAUNCHES > launches
    b, rays_b = render_wavefront_stats(scene, cam, 4, key, lanes=1024, device=cuda,
                                       search=mt.mt_closest_plain)
    assert torch.equal(a, b) and rays_a == rays_b and b.mean().item() > 0.0
    launches = bk.LAUNCHES
    c, rays_c = bk.render_wavefront_fused(scene, cam, 4, key, lanes=1024, chunk_spp=4,
                                          device=cuda)
    assert bk.LAUNCHES == launches + 1
    assert torch.equal(c, b) and rays_c == rays_b


def test_mt_kernel_train_step_matches_plain(cuda):
    """The train step through the kernel and through the plain search: the
    same tapes, so the same loss and grads."""
    from pathtrace_tpu_torch.bench import make_train_step
    from pathtrace_tpu_torch.diff.grad import MAT_FIELDS

    launches = mt_kernel.LAUNCHES
    a = make_train_step(cuda, 16, 16, 256, 256)(2)
    assert mt_kernel.LAUNCHES > launches
    b = make_train_step(cuda, 16, 16, 256, 256, search=mt.mt_closest_plain)(2)
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=0)
    for ga, gb in zip(a[1], b[1]):
        for f in MAT_FIELDS:
            torch.testing.assert_close(getattr(ga, f), getattr(gb, f), rtol=1e-5, atol=1e-7)


# name: (scene, film side, spp, lanes, IntegratorConfig fields, sample_offset)
BIT_EQUAL_CASES = {
    "lanes_beyond_pool": ("spheres", 8, 2, 256, {}, 0),
    "lanes_2x_pixels": ("spheres", 32, 8, 2048, {}, 0),
    "pixels_2x_lanes": ("spheres", 32, 8, 512, {}, 0),
    "glass": ("glass", 32, 16, 1024, {}, 0),
    "glass_refract_cap_2": ("glass", 32, 16, 1024, {"refract_cap": 2}, 0),
    "nee_off": ("spheres", 32, 8, 1024, {"nee": False}, 0),
    "max_bounce_1": ("spheres", 32, 8, 1024, {"max_bounce": 1}, 0),
    "max_bounce_2": ("spheres", 32, 8, 1024, {"max_bounce": 2}, 0),
    # the last path ids lie just below 2**31 - 1024; id + lanes passes 2**31
    "path_ids_past_2_31": ("spheres", 32, 4, 2048, {}, 2 ** 31 // 1024 - 4 - 1),
    "default_lanes_64": ("spheres", 64, 64, None, {}, 0),
    "sphere_only": ("sphere_only", 32, 8, 1024, {}, 0),
}


@pytest.mark.parametrize("case", sorted(BIT_EQUAL_CASES))
def test_kernel_bit_equal_to_plain(cuda, case):
    scene_name, side, spp, lanes, fields, offset = BIT_EQUAL_CASES[case]
    scene = SCENES[scene_name]().to(cuda)
    cam = procedural.default_camera(side, side)
    lanes = lanes or bk.auto_fused_config(side * side)
    key, cfg = rng.make_key(8), IntegratorConfig(**fields)
    pack = bk.build_fused_pack(scene)
    launches = bk.LAUNCHES
    img, rays = bk.fused_chunk(pack, cam, spp, offset, key, cfg, lanes)
    _, lane_rays = bk.launch(pack, bk.make_params(cam, cfg, key, pack, lanes, spp, offset))
    torch.cuda.synchronize()
    assert bk.LAUNCHES == launches + 2
    plain = profile_main.schedule_share(scene, cam, spp, key, cfg, lanes, offset,
                                        search=mt.mt_closest_plain)
    assert torch.equal(img, plain["image"])
    assert torch.equal(lane_rays, plain["lane_rays"])
    assert rays == plain["rays"]


# pixel slices (parallel/mesh.py): (scene, side, spp, n_shards, lanes a shard, sample_offset)
SLICE_CASES = {
    "k_pix_2": ("spheres", 32, 16, 2, 256, 0),
    "lanes_over_pixels": ("spheres", 32, 16, 4, 512, 0),
    "glass_8_slices": ("glass", 32, 8, 8, 128, 0),
    # global path ids just below 2**31 on the last slice
    "path_ids_near_2_31": ("spheres", 32, 4, 4, 256, 2 ** 31 // 1024 - 4 - 1),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_kernel_slices_bit_equal(cuda, case):
    """B1 keyed by global path ids: each slice (pix_offset != 0 but the
    first) bit-equal to the plain wavefront over the same slice, and the
    slices together bit-equal to the whole image in one launch."""
    from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront
    from pathtrace_tpu_torch.parallel import mesh as M

    scene_name, side, spp, n, lanes, offset = SLICE_CASES[case]
    scene = SCENES[scene_name]().to(cuda)
    cam = procedural.default_camera(side, side)
    key, cfg = rng.make_key(8), IntegratorConfig()
    pack = bk.build_fused_pack(scene)
    npl = side * side // n
    parts, total = [], 0
    for shard in range(n):
        sliced = dict(pix_offset=shard * npl, num_pix_local=npl)
        img, rays = bk.fused_chunk(pack, cam, spp, offset, key, cfg, lanes, **sliced)
        p_img, p_rays = _run_wavefront(scene, cam, spp, key, cfg, lanes, offset,
                                       search=mt.mt_closest_plain, **sliced)
        assert torch.equal(img, p_img) and rays == p_rays, f"slice {shard}"
        parts.append(img)
        total += rays
    whole, w_rays = bk.fused_chunk(pack, cam, spp, offset, key, cfg, lanes * n)
    assert torch.equal(torch.cat(parts).reshape(side, side, 3), whole) and total == w_rays
    if offset == 0:
        img, rays = M.render_fused_sharded(scene, cam, spp, key, M.make_ray_mesh(cuda), cfg,
                                           lanes * n)
        assert torch.equal(img, whole) and rays == w_rays
