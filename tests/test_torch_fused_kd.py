"""Kernel B1's KD variant (csrc/bounce_kernel.cu, bounce_kernel_kd: the
fused engine on scenes whose triangles exceed shared memory) and the
benchmark's cells for it.

On the CPU (together well under 30 s):
- the refscene_blob82k configuration's raw arrays: 81,958 triangles (the
  blob82k mesh, the room with its light, two boxes), 2 spheres and 2
  emissive triangles;
- the benchmark's fused KD entry run on the CPU, where the fused engine is
  the eager wavefront through the KD cells' plain search
  (kd_closest_plain), against the benchmark's plain reference (brute-force
  search over every triangle) on that scene with its mesh cropped, at
  8x8 @ 2 spp: pixel_gap 0;
- the fused engine's routing: a scene with KD cells packs them and
  launches the KD variant, any other scene the shared-memory kernel; a mesh
  past shared memory without cells is refused with the advice to build
  them;
- the readers of b1kd_roofline and pass_io_ms on synthetic records, and
  the pass entry's checkpoint and PNG on the CPU;
- harness.load_cell on both new cells.

On the card (marker `gpu`; python -m pytest tests/test_torch_fused_kd.py
--noconftest -q -m gpu): the variant bit-equal to the eager wavefront
through kd_closest_plain (image, the rays of every lane, their sum) on
refscene_blob82k and on blob82k_room, also where the next strided path id
passes 2**31 and on pixel slices, and through render_wavefront_fused and
`cli render --preset mesh512 --engine fused`; its pipelined walk bit-equal
to the plain KD wavefront on refscene, mesh512, a row of 80 cells (walks
past the warp's list) and lanes that leave threads of a block idle, its
row counts equal to kd_walk_counts' on the plain wavefront's rays; the
shared-memory kernel, which shares the variant's path step, still at 16
warps per SM within its 108 registers and 32 B of stack, and the variant
at 16 warps per SM within 128 registers.
"""

import contextlib
import ctypes
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark import compare, harness, program, scenes
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
from pathtrace_tpu_torch.ops.cuda import build
from pathtrace_tpu_torch.utils import rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("refscene.image256", "cornell.refjob1")


def _config(name: str) -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def refscene():
    """(config, raw arrays, the port's scene with KD cells of 1024) of
    refscene_blob82k."""
    config = _config("refscene_blob82k")
    arrays = scenes.scene_arrays(config)
    return config, arrays, program.port_scene(arrays, kd_max_tris=1024)


def test_refscene_arrays_hold_the_mesh_room_boxes_and_spheres(refscene):
    _, arrays, scene = refscene
    assert arrays["positions"].shape == (81958, 3, 3)
    assert arrays["sph.center"].shape == (2, 3)
    assert int((np.abs(arrays["mat.emittance"]).sum(axis=1) > 0).sum()) == 2
    assert scene.num_tris == 81958 and scene.num_spheres == 2 and scene.num_lights == 2
    # the mesh comes first and keeps clear of the spheres (radius 13)
    mesh = arrays["positions"][:81920].reshape(-1, 3)
    for c, r in zip(arrays["sph.center"], arrays["sph.radius"]):
        assert np.linalg.norm(mesh - c, axis=1).min() > r


def test_fused_kd_entry_on_the_cpu_equals_the_plain_reference(refscene):
    """The entry's render on the CPU (the wavefront through
    kd_closest_plain) against the brute-force reference, every pixel of
    8x8 @ 2 spp at 64 lanes. The mesh is cropped to its triangles whose
    centroid has x > -4 (3,266 of 81,920; the room, boxes and spheres
    whole), with cells of 128, so that the reference's brute-force search
    takes seconds."""
    config, arrays, _ = refscene
    mesh = np.arange(len(arrays["positions"])) < 81920
    keep = ~mesh | (arrays["positions"].mean(axis=1)[:, 0] > -4.0)
    cropped = {k: v[keep] if v.shape[:1] == keep.shape else v for k, v in arrays.items()}
    assert len(cropped["positions"]) == 3304
    with open(os.path.join(REPO, "benchmark", "traffic", "image256_fused_kd.json")) as f:
        traffic = json.load(f)
    traffic.update(width=8, height=8, lanes=64, kd_max_tris=128,
                   check={"kind": "pixels", "units": 1, "pixels": 64,
                          "limits": {"pixel_gap": 1e-3}})
    ctx = harness.Ctx(config, traffic, cropped, torch.device("cpu"), 0, 1)
    unit = harness.load_module("entries", traffic["entry"]).setup(ctx)
    seed = 3000000021
    key = harness.unit_key(seed, 0)
    out = harness.keep(unit(key, 2), 2, 0)
    nums = compare.check(ctx, [out], [key], seed)
    assert nums["pixel_gap"][0] == 0.0
    assert float(out["image"].mean()) > 0.0


class _Recorder:
    """A stand-in for a launcher of the kernel library: records its calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launchers(monkeypatch):
    """The wrapper's launch path with the library and the CUDA calls
    replaced, so that it runs on CPU tensors: (shared-memory, KD) recorders."""
    smem, kd = _Recorder(), _Recorder()
    monkeypatch.setattr(bk, "_render_fn", lambda: smem)
    monkeypatch.setattr(bk, "_render_kd_fn", lambda: kd)
    monkeypatch.setattr(bk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return smem, kd


def test_the_fused_engine_sends_kd_scenes_to_the_variant(fake_launchers):
    smem, kd = fake_launchers
    mesh = procedural.sphere_mesh_scene(subdivisions=3).with_kd_binned(max_tris=128)
    packs = {}
    for scene, want in ((procedural.cornell_box_scene(include_spheres=True), smem),
                        (mesh, kd)):
        pack = packs[want] = bk.build_fused_pack(scene)
        assert (pack.clusters is not None) == (want is kd)
        params = bk.make_params(procedural.default_camera(8, 8), IntegratorConfig(),
                                rng.make_key(0), pack, 64, 1, 0)
        counts = bk.LAUNCHES, bk.LAUNCHES_KD
        bk.launch(pack, params)
        assert len(want.calls) == 1
        assert (bk.LAUNCHES - counts[0], bk.LAUNCHES_KD - counts[1]) == (
            (1, 0) if want is smem else (0, 1))
    assert smem.calls[0][1] == packs[smem].tri_geo.data_ptr()
    (args,) = kd.calls
    cl = mesh.clusters
    assert args[1] == cl.num_clusters
    assert args[2:8] == tuple(x.data_ptr() for x in (cl.bmin, cl.bmax, cl.prim_start,
                                                    cl.prim_count, cl.members, cl.dup_map))
    assert args[8] == packs[kd].tri_attr.data_ptr()
    # the tail as the shared-memory kernel's: tri_attr, spheres, lights,
    # film, the per-lane counts and the stream
    assert len(args) == 14


class _CountWriter(_Recorder):
    """A launcher stand-in that writes 1000 + i at slot i of the int64
    counts it is given (the second-to-last argument), as many as `slots`."""

    def __init__(self, slots):
        super().__init__()
        self.slots = slots

    def __call__(self, *args):
        counts = (ctypes.c_int64 * self.slots).from_address(args[-2])
        counts[:] = range(1000, 1000 + self.slots)
        return super().__call__(*args)


def test_the_variant_returns_row_counts_beside_the_rays(fake_launchers, monkeypatch):
    """launch hands the KD variant one int64 buffer of 2 x lanes and returns
    its first row as the lanes' rays and its second as their member rows
    tested; the shared-memory kernel gets one row and returns no rows."""
    lanes = 64
    cam = procedural.default_camera(8, 8)
    mesh = bk.build_fused_pack(
        procedural.sphere_mesh_scene(subdivisions=3).with_kd_binned(max_tris=128))
    monkeypatch.setattr(bk, "_render_kd_fn", lambda: _CountWriter(2 * lanes))
    params = bk.make_params(cam, IntegratorConfig(), rng.make_key(0), mesh, lanes, 1, 0)
    film, rays, rows = bk.launch(mesh, params)
    assert film.shape == (lanes, 3) and rays.shape == rows.shape == (lanes,)
    assert rays.dtype == rows.dtype == torch.int64
    assert rays.tolist() == list(range(1000, 1000 + lanes))
    assert rows.tolist() == list(range(1000 + lanes, 1000 + 2 * lanes))
    cornell = bk.build_fused_pack(procedural.cornell_box_scene(include_spheres=True))
    monkeypatch.setattr(bk, "_render_fn", lambda: _CountWriter(lanes))
    params = bk.make_params(cam, IntegratorConfig(), rng.make_key(0), cornell, lanes, 1, 0)
    _, rays, rows = bk.launch(cornell, params)
    assert rows is None and rays.tolist() == list(range(1000, 1000 + lanes))


def test_kd_pack_sizes_its_shared_memory_by_the_cells():
    scene = procedural.sphere_mesh_scene(subdivisions=4)
    with pytest.raises(ValueError, match=r"with_kd_binned\(\)"):
        bk.build_fused_pack(scene)  # 5,134 triangles: past shared memory, no cells
    pack = bk.build_fused_pack(scene.with_kd_binned(max_tris=128))
    # the variant reads no search table: the pack leaves it empty
    assert pack.tri_geo.shape == (0, bk.GEO_STRIDE)
    assert pack.tri_attr.shape == (scene.num_tris, bk.ATTR_STRIDE)
    m = pack.clusters.num_clusters
    assert pack.smem_bytes == bk.kd_smem_bytes(m, scene.num_spheres, scene.num_lights)
    # and each thread's row count of the pipelined walk
    assert pack.smem_bytes == (32 * m + 64 * (scene.num_spheres + scene.num_lights)
                               + 8 * 32 * (bk.BLOCK // 32) + 8 * bk.BLOCK)
    assert pack.smem_bytes <= bk.MAX_SMEM_BYTES


class _Rec:
    """A synthetic harness.Record for the metric readers."""

    def __init__(self, kernels: dict, need: dict, paths: int, lanes: int, units: int = 1):
        self.kernels, self._need, self.paths, self.lanes = kernels, need, paths, lanes
        self.units = [(0.0, 1.0, paths)] * units

    def kernel_seconds(self, kernel):
        return sum(s for name, (s, _) in self.kernels.items() if kernel in name)

    def kernel_launches(self, kernel):
        return sum(n for name, (_, n) in self.kernels.items() if kernel in name)

    def need(self):
        return self._need

    def traced_paths(self):
        return self.paths

    def lanes_per_rank(self):
        return self.lanes

    def bound_s(self, ops, nbytes):
        from benchmark import roofline
        return roofline.bound(ops, nbytes)[0]


def test_b1kd_roofline_reads_the_variant_alone():
    reader = harness.load_module("metrics", "b1kd_roofline")
    need = {"b1_ops": 5000.0, "b3_ops": 4000.0, "b2_ops": 700.0, "cells": (137, 94793)}
    paths, lanes, launches = 1 << 26, 1 << 16, 4
    rec = _Rec({"pt::bounce_kernel_kd(PtParams, pt::KdTables)": (2.0, launches)}, need,
               paths, lanes)
    ops = (5000.0 - 4000.0 + 700.0) * paths
    nbytes = launches * (lanes * 20 + 94793 * 40 + 137 * 32)
    want = 100.0 * max(ops / 67e12, nbytes / 3.35e12) / 2.0
    assert reader.read(rec) == pytest.approx(want, rel=1e-12)
    # the shared-memory kernel alone: nothing to read
    assert reader.read(_Rec({"pt::bounce_kernel(PtParams)": (2.0, 4)}, need, paths,
                            lanes)) is None


def test_pass_io_ms_reads_the_io_spans_over_the_passes(monkeypatch):
    from benchmark import spans

    reader = harness.load_module("metrics", "pass_io_ms")
    ms = 1_000_000
    rec = lambda name, a, b: types.SimpleNamespace(name=name, start_ns=a * ms, end_ns=b * ms)
    recs = [rec("fused.render", 0, 100), rec("io.png", 100, 130), rec("io.checkpoint", 130, 150),
            rec("fused.render", 150, 250), rec("io.png", 250, 270),
            rec("io.checkpoint", 270, 300)]
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    assert reader.read(_Rec({}, {}, 1, 1, units=2)) == pytest.approx((30 + 20 + 20 + 30) / 2)
    # a program without the spans: nothing to read, no error
    monkeypatch.setattr(spans, "program_records", lambda: recs[::3])
    assert reader.read(_Rec({}, {}, 1, 1, units=2)) is None
    monkeypatch.setattr(spans, "program_records", lambda: None)
    assert reader.read(_Rec({}, {}, 1, 1, units=2)) is None


def test_pass_entry_writes_the_running_mean_and_the_checkpoint(monkeypatch, tmp_path):
    """The refjob1 entry at 8x8 on the CPU: each pass's image, a PNG and a
    checkpoint of the running sum; a pass at another spp starts anew."""
    from pathtrace_tpu_torch.io import checkpoint

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    config = _config("cornell_spheres")
    cell = harness.load_cell("cornell.refjob1")
    traffic = dict(cell.traffic, width=8, height=8, lanes=64)
    ctx = harness.Ctx(config, traffic, scenes.scene_arrays(config), torch.device("cpu"), 0, 1)
    unit = harness.load_module("entries", traffic["entry"]).setup(ctx)
    written = checkpoint.BYTES_WRITTEN
    imgs = [unit(harness.unit_key(9, p), spp)["image"] for p, spp in ((-1, 1), (0, 2), (1, 2))]
    (out,) = [p for p in tmp_path.iterdir() if p.name.startswith("render_passes_")]
    state = checkpoint.load_state(str(out / "render.npz"))
    assert state["passes_done"] == 2 and state["spp_per_pass"] == 2
    assert np.array_equal(state["accum_image"], (imgs[1] + imgs[2]).numpy())
    assert (out / "render.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert checkpoint.BYTES_WRITTEN - written >= 3 * os.path.getsize(out / "render.npz")


@pytest.mark.parametrize("name", CELLS)
def test_the_new_cells_load_by_name(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    e2e = {m["name"] for m in cell.end_to_end}
    layer = {m["name"] for m in cell.per_layer}
    assert e2e == {"fused_paths_per_s", "setup_s"}
    assert {"device_idle.fused", "fused_gap_ms"} <= layer
    if name == "refscene.image256":
        assert cell.traffic["entry"] == "render_fused_kd" and cell.traffic["kd_max_tris"] == 1024
        assert "b1kd_roofline" in layer and "b1_roofline" not in layer
    else:
        assert cell.traffic["entry"] == "render_fused_passes"
        assert {"b1_roofline", "pass_io_ms"} <= layer
    harness.load_module("entries", cell.traffic["entry"])
    for m in e2e | layer:
        assert callable(harness.load_module("metrics", m).read)


# ---- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_scene(name: str, cuda):
    config = _config(name)
    return program.port_scene(scenes.scene_arrays(config), kd_max_tris=1024).to(cuda), config


# name: (config, film side, spp, lanes, sample_offset)
KD_CASES = {
    "refscene": ("refscene_blob82k", 32, 4, 1024, 0),
    "refscene_k_pix_2": ("refscene_blob82k", 32, 4, 512, 0),
    "refscene_lanes_2x_pixels": ("refscene_blob82k", 16, 4, 512, 0),
    "blob82k_room": ("blob82k_room", 32, 4, 1024, 0),
    # the last path ids lie just below 2**31 - 1024; id + lanes passes 2**31
    "refscene_path_ids_past_2_31": ("refscene_blob82k", 32, 4, 2048, 2 ** 31 // 1024 - 4 - 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KD_CASES))
def test_kd_variant_bit_equal_to_the_plain_kd_wavefront(cuda, case):
    from pathtrace_tpu_torch import profile_main
    from pathtrace_tpu_torch.ops.kd_raycast import kd_closest_plain

    name, side, spp, lanes, offset = KD_CASES[case]
    scene, config = _card_scene(name, cuda)
    cam = program.port_camera(config, side, side)
    key, cfg = rng.make_key(8), program.port_config(config)
    pack = bk.build_fused_pack(scene)
    launches = bk.LAUNCHES, bk.LAUNCHES_KD
    img, rays = bk.fused_chunk(pack, cam, spp, offset, key, cfg, lanes)
    _, lane_rays, _ = bk.launch(pack, bk.make_params(cam, cfg, key, pack, lanes, spp, offset))
    torch.cuda.synchronize()
    assert (bk.LAUNCHES, bk.LAUNCHES_KD) == (launches[0], launches[1] + 2)
    plain = profile_main.schedule_share(scene, cam, spp, key, cfg, lanes, offset,
                                        search=kd_closest_plain)
    assert torch.equal(img, plain["image"])
    assert torch.equal(lane_rays, plain["lane_rays"])
    assert rays == plain["rays"]


@pytest.mark.gpu
def test_kd_variant_slices_and_render_bit_equal(cuda):
    """render_wavefront_fused in chunks, and pixel slices keyed by global
    ids, against the plain KD wavefront."""
    from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront, accumulate_chunks
    from pathtrace_tpu_torch.ops.kd_raycast import kd_closest_plain

    scene, config = _card_scene("refscene_blob82k", cuda)
    cam = program.port_camera(config, 32, 32)
    key, cfg = rng.make_key(4), program.port_config(config)
    img, rays = bk.render_wavefront_fused(scene, cam, 8, key, cfg, lanes=1024, chunk_spp=4,
                                          device=cuda)
    p_img, p_rays = accumulate_chunks(
        lambda n, offset: _run_wavefront(scene, cam, n, key, cfg, 1024, offset,
                                         search=kd_closest_plain), cam, 8, 4, cuda)
    assert torch.equal(img, p_img) and rays == p_rays
    pack = bk.build_fused_pack(scene)
    for shard in range(4):
        sliced = dict(pix_offset=shard * 256, num_pix_local=256)
        s_img, s_rays = bk.fused_chunk(pack, cam, 4, 0, key, cfg, 256, **sliced)
        q_img, q_rays = _run_wavefront(scene, cam, 4, key, cfg, 256, 0,
                                       search=kd_closest_plain, **sliced)
        assert torch.equal(s_img, q_img) and s_rays == q_rays, f"slice {shard}"


def _walk_scene(name: str, cuda):
    """(scene, camera, config) of a WALK_CASES scene on the card."""
    if name == "refscene":
        scene, config = _card_scene("refscene_blob82k", cuda)
        return scene, lambda w, h: program.port_camera(config, w, h), program.port_config(config)
    if name == "mesh512":
        from pathtrace_tpu_torch.models import presets

        preset = presets.get_preset("mesh512")
        scene = presets.build_preset_scene(preset).to(cuda)
        return scene, procedural.default_camera, preset.cfg or IntegratorConfig()
    # 80 cells in a row along +x (listed farthest first), seen down the row
    # through a 0.5-degree field: every camera ray crosses more cells than
    # a warp lists, so its walk sets cells aside and lists again
    from pathtrace_tpu_torch.core.camera import Camera
    from torch_port_helpers import cell_row_scene

    scene, _ = cell_row_scene(80)
    return (scene.to(cuda),
            lambda w, h: Camera.look_at((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), fovy_deg=0.5,
                                        width=w, height=h),
            IntegratorConfig())


# name: (scene, film side, spp, lanes); lanes 100 leave 28 threads of the
# one block past the lanes, which stay for the walks
WALK_CASES = {
    "refscene": ("refscene", 32, 2, 1024),
    "refscene_lanes_past_the_block": ("refscene", 10, 4, 100),
    "mesh512": ("mesh512", 32, 2, 1024),
    "set_aside_cells": ("cell_row", 16, 2, 256),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_pipelined_walk_bit_equal_to_the_plain_kd_wavefront(cuda, case):
    """The variant's pipelined walk against the plain KD wavefront (image
    and every lane's rays bit-equal); its row counts against kd_walk_counts
    on the plain wavefront's own rays: it tests the member rows of the
    cells the walk rules visit, no more and no fewer."""
    from pathtrace_tpu_torch import profile_main
    from pathtrace_tpu_torch.ops import kd_raycast as kd

    name, side, spp, lanes = WALK_CASES[case]
    scene, camera, cfg = _walk_scene(name, cuda)
    cam, key = camera(side, side), rng.make_key(11)
    pack = bk.build_fused_pack(scene)
    cl = pack.clusters
    # cells whose members do not fill whole rounds of the warp's rows
    assert bool((cl.prim_count % 64 != 0).any())
    params = bk.make_params(cam, cfg, key, pack, lanes, spp, 0)
    _, rays, rows = bk.launch(pack, params)
    torch.cuda.synchronize()
    assert rows.shape == (lanes,) and rows.dtype == torch.int64
    crossed = []

    def tests(org, dirn, t_min, t_max):
        c = kd.kd_walk_counts(cl, org, dirn, t_min, t_max)
        crossed.append(int(c["crossed"].max()))
        return c["tests"].double()

    plain = profile_main.schedule_share(scene, cam, spp, key, cfg, lanes,
                                        search=kd.kd_closest_plain, pair_ops=tests)
    img, _ = bk.fused_chunk(pack, cam, spp, 0, key, cfg, lanes)
    assert torch.equal(img, plain["image"]) and torch.equal(rays, plain["lane_rays"])
    assert int(rows.sum()) == int(plain["mt_ops"]) > 0 and bool((rows >= 0).all())
    if name == "cell_row":
        assert max(crossed) > bk.kd_kernel.LIST_CAP


@pytest.mark.gpu
def test_shared_memory_kernel_keeps_its_registers(cuda):
    """The shared-memory kernel, whose path step the KD variant shares,
    holds its 16 warps per SM with no more registers than its 108 and no
    more stack than its 32 B before the variant (its speed is the
    benchmark's to hold)."""
    scene = procedural.cornell_box_scene(include_spheres=True).to(cuda)
    occ = bk.occupancy(bk.build_fused_pack(scene))
    assert occ["warps_per_sm"] == 16
    assert occ["registers"] <= 108 and occ["local_bytes"] <= 32
    mesh = procedural.sphere_mesh_scene(subdivisions=4).with_kd_binned(max_tris=128).to(cuda)
    # the KD variant keeps the 16 warps per SM that 65,536 lanes fill (3.9
    # blocks of 128 on 132 SMs)
    kd = bk.occupancy(bk.build_fused_pack(mesh))
    assert kd["warps_per_sm"] >= 16 and kd["registers"] <= 128


@pytest.mark.gpu
def test_cli_renders_mesh512_on_the_fused_engine(cuda, tmp_path):
    from pathtrace_tpu_torch import cli

    bk.LAUNCHES_KD = 0
    out = tmp_path / "m.npy"
    assert cli.main(["render", "--preset", "mesh512", "--width", "32", "--height", "32",
                     "--spp", "4", "--engine", "fused", "--out-npy", str(out)]) == 0
    assert bk.LAUNCHES_KD == 1
    assert np.isfinite(np.load(out)).all()
