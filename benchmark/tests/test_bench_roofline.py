"""The frozen roofline counts give the hand-computed numbers at tiny shapes,
and kernel B2's count is taken over KD cells the benchmark builds itself."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import roofline, scenes
from benchmark.reference import core, tracer
from benchmark.roofline.kd import build_cells
from benchmark.roofline.need import Need


def test_published_peaks_and_bound():
    assert roofline.FP32_PEAK == 67e12 and roofline.HBM_RATE == 3.35e12
    assert roofline.bound(67e12, 1.0) == (1.0, "operations")
    t, by = roofline.bound(1.0, 6.7e12)
    assert by == "bytes" and t == pytest.approx(2.0)


def test_shading_counts():
    assert roofline.SHADE_OPS == 465 and roofline.NEE_VISIBLE_OPS == 183


def _tri_table():
    # one triangle in the z = 0 plane facing +z: v0 (0,0,0), e1 (1,0,0), e2 (0,1,0)
    return torch.tensor([[0.0, 0, 0, 1, 0, 0, 0, 1, 0]])


@pytest.mark.parametrize("org, dirn, want", [
    ((0.2, 0.2, 1.0), (0.0, 0.0, -1.0), 14 + 8 + 15 + 7),  # a hit: all four stages
    ((0.2, 0.2, -1.0), (0.0, 0.0, 1.0), 14),               # the back face: culled at det
    ((5.0, 0.2, 1.0), (0.0, 0.0, -1.0), 14 + 8),           # u > det: stops after stage 2
    ((0.2, 5.0, 1.0), (0.0, 0.0, -1.0), 14 + 8 + 15),      # v out: stops after stage 3
])
def test_mt_pair_ops_by_stage(org, dirn, want):
    ops = roofline.mt_pair_ops(_tri_table(), torch.tensor([org]), torch.tensor([dirn]))
    assert ops.tolist() == [want]


def test_need_counts_live_rays_only():
    table = _tri_table()
    need = Need(table)
    org = torch.tensor([[0.2, 0.2, 1.0], [0.2, 0.2, 1.0]])
    dirn = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    z, big = torch.zeros(2), torch.full((2,), 1e6)
    need.observe("closest", org, dirn, z, big, torch.tensor([True, True]), torch.ones(2))
    need.on_bounce({"alive": torch.tensor([True, False]), "live_hit": torch.tensor([True, False]),
                    "reached": None})
    got = need.per_path(1, num_spheres=2)
    assert got["b3_ops"] == 44
    assert got["rays"] == 1
    assert got["b1_ops"] == 44 + 2 * roofline.SPHERE_OPS + roofline.SHADE_OPS


def test_b2_count_walks_the_benchmarks_own_cells():
    # two cells along x, one triangle each; a ray hitting the first cell's
    # triangle needs only that cell's test, plus a slab test per cell
    pos = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[10, 0, 0], [11, 0, 0], [10, 1, 0]]], np.float32)
    cells = build_cells(pos, max_tris=1)
    assert cells.num_cells == 2 and cells.num_members == 2
    need = Need(torch.from_numpy(np.concatenate([pos[:, 0], pos[:, 1] - pos[:, 0],
                                                 pos[:, 2] - pos[:, 0]], axis=1)), cells)
    org, dirn = torch.tensor([[0.2, 0.2, 1.0]]), torch.tensor([[0.0, 0.0, -1.0]])
    need.observe("closest", org, dirn, torch.zeros(1), torch.full((1,), 1e6),
                 torch.tensor([True]), torch.ones(1))
    need.on_bounce({"alive": torch.tensor([True]), "live_hit": torch.tensor([True]),
                    "reached": None})
    assert need.per_path(1, 0)["b2_ops"] == 2 * roofline.SLAB_OPS + 44


def test_kd_cells_match_the_programs_build_for_blob82k():
    # the frozen copy builds the cells the port builds at the cell's parameters
    from pathtrace_tpu_torch.accel.kdgrid import build_kd_clusters

    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/blob82k_room.json")))
    pos = scenes.scene_arrays(cfg)["positions"]
    mine = build_cells(pos, max_tris=1024)
    port = build_kd_clusters(pos, max_tris=1024, rule="hybrid")
    assert (mine.num_cells, mine.num_members) == (157, 95894)
    assert (port.num_clusters, port.num_members) == (157, 95894)
    assert torch.equal(mine.bmin, port.bmin) and torch.equal(mine.bmax, port.bmax)
    assert torch.equal(torch.cat(mine.members), port.members)


def test_need_on_the_reference_matches_a_hand_count_of_its_rays():
    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/cornell_spheres.json")))
    scene = core.Scene.from_arrays(scenes.scene_arrays(cfg), "cpu")
    cam = core.Camera.from_rotation(cfg["camera"]["pos"], cfg["camera"]["rotation_deg"],
                                    cfg["camera"]["fovy_deg"], 8, 8)
    rcfg = tracer.Config()
    need = Need(scene.search_table)
    ids = torch.arange(64)
    tracer.trace(scene, cam, rcfg, core.make_key(7), ids, observe=need.observe,
                 on_bounce=need.on_bounce)
    got = need.per_path(64, scene.num_spheres)
    # every path casts its camera ray; shadow rays are one a live hit
    assert got["closest_rays"] >= 1 and got["shadow_rays"] <= got["closest_rays"]
    assert 14 * 38 <= got["b3_ops"] / got["rays"] <= 44 * 38
