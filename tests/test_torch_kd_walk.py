"""The KD kernel's walk, counted in plain PyTorch on the CPU
(ops/kd_raycast.py::kd_walk_counts), against the plain search.

- The walk's winner (hit, t, prim_id) equals kd_closest_plain's bit for
  bit on sphere_mesh_scene(4) with cells of 128 and on blob82k with cells
  of 1024: kd_raycast.probe_rays' camera, surface and shadow rays and the
  edge sets of kd_raycast.edge_rays (axis-parallel directions, rays along a
  cell face, rays that start inside a cell, t_min > 0 segments, misses, the
  largest cell).
- Cells are visited in ascending (tnear, cell) order, each a crossed cell
  at its slab tnear; every cell that the bound (chip_smoke.py::kd_bound)
  counts as needed, a crossed cell whose tnear is no later than the hit, is
  visited.
- The counts add up: the tests are the members of the visited cells, the
  visits are no more than the crossed cells, and the slab tests are the
  cell count once a ray while its crossed cells fit the list.
- A ray crossing more cells than the list holds, nearest last in index
  order, visits all of them and lists again after each cell set aside; its
  winner still equals the plain search's and brute's. Equal t across two
  cells goes to the lower id.
"""

import pytest
import torch

from pathtrace_tpu_torch.accel.binned import safe_inv_dir, slab_all
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.ops import kd_raycast as kd
from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel
from pathtrace_tpu_torch.ops.intersect import raycast_brute
from torch_port_helpers import cell_row_scene, two_cell_tie_scene

torch.set_num_threads(2)

SCENES = {
    "sphere_mesh": lambda: procedural.sphere_mesh_scene(4).with_kd_binned(max_tris=128),
    "blob82k": lambda: procedural.blob_mesh_scene().with_kd_binned(max_tris=1024),
}
PROBE_SETS = ("camera", "surface", "shadow")
EDGE_SETS = ("axis", "face", "inside", "segment", "miss", "largest")


@pytest.fixture(scope="module")
def ray_sets():
    """{scene: (scene, {set: rays})}: 1,024 probe rays (32x32 camera) and
    256 rays of each edge set."""
    out = {}
    for name, make in SCENES.items():
        scene = make()
        sets = kd.probe_rays(scene, procedural.default_camera(32, 32), 1024, seed=3)
        sets.update(kd.edge_rays(scene, 256, seed=1))
        out[name] = (scene, sets)
    return out


@pytest.fixture(scope="module")
def counted(ray_sets):
    return {(name, s): kd.kd_walk_counts(scene.clusters, *rays)
            for name, (scene, sets) in ray_sets.items() for s, rays in sets.items()}


@pytest.mark.parametrize("set_name", PROBE_SETS + EDGE_SETS)
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_walk_winner_equals_plain(ray_sets, counted, scene_name, set_name):
    scene, sets = ray_sets[scene_name]
    c = counted[scene_name, set_name]
    hit, t, _, _, pid = kd.kd_closest_plain(scene.clusters, *sets[set_name])
    assert torch.equal(c["hit"], hit) and torch.equal(c["t"], t)
    assert torch.equal(c["prim_id"], pid)
    if set_name == "miss":
        assert not bool(hit.any())
    elif set_name not in ("segment", "shadow"):
        assert hit.float().mean().item() > 0.5


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_walk_visits_in_tnear_cell_order(ray_sets, counted, scene_name):
    scene, sets = ray_sets[scene_name]
    cl = scene.clusters
    for s in PROBE_SETS + EDGE_SETS:
        org, d, t_min, t_max = sets[s]
        cross, tnear = slab_all(org, safe_inv_dir(d), cl.bmin, cl.bmax, t_min, t_max)
        c = counted[scene_name, s]
        vis, vtn = c["visited"], c["visited_tn"]
        real = vis >= 0
        assert torch.equal(real.sum(dim=1), c["visits"]), s
        cells = vis.clamp(min=0)
        assert bool(cross.gather(1, cells)[real].all()), s
        assert torch.equal(tnear.gather(1, cells)[real], vtn[real]), s
        # (tnear, cell) strictly ascending along each ray's visits
        later = real[:, 1:]
        same_tn = vtn[:, 1:] == vtn[:, :-1]
        asc = (vtn[:, 1:] > vtn[:, :-1]) | (same_tn & (vis[:, 1:] > vis[:, :-1]))
        assert bool(asc[later].all()), s
        # visited cells are real only as a prefix
        assert bool((real[:, :-1] | ~real[:, 1:]).all()), s


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_walk_visits_every_needed_cell(ray_sets, counted, scene_name):
    scene, sets = ray_sets[scene_name]
    cl = scene.clusters
    for s in PROBE_SETS + EDGE_SETS:
        org, d, t_min, t_max = sets[s]
        cross, tnear = slab_all(org, safe_inv_dir(d), cl.bmin, cl.bmax, t_min, t_max)
        c = counted[scene_name, s]
        reach = torch.where(c["hit"], c["t"], torch.full_like(c["t"], float("inf")))
        need = cross & (tnear <= reach[:, None])
        vis = c["visited"]
        visited = torch.zeros(cross.shape, dtype=torch.int64).scatter_add_(
            1, vis.clamp(min=0), (vis >= 0).long()) > 0
        assert bool(visited[need].all()), s
        assert bool((need.sum(dim=1) <= c["visits"]).all()), s


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_walk_counts_add_up(ray_sets, counted, scene_name):
    scene, sets = ray_sets[scene_name]
    cl = scene.clusters
    count = cl.prim_count.long()
    for s in PROBE_SETS + EDGE_SETS:
        c = counted[scene_name, s]
        vis = c["visited"]
        tests = torch.where(vis >= 0, count[vis.clamp(min=0)], 0).sum(dim=1)
        assert torch.equal(c["tests"], tests), s
        assert bool((c["visits"] <= c["crossed"]).all()), s
        fits = c["crossed"] <= kd_kernel.LIST_CAP
        assert bool((c["slab"][fits] == cl.num_clusters).all()), s


def test_walk_lists_again_past_the_list_cap():
    scene, rays = cell_row_scene(80)
    c = kd.kd_walk_counts(scene.clusters, *rays)
    hit, t, _, _, pid = kd.kd_closest_plain(scene.clusters, *rays)
    brute = raycast_brute(scene, *rays)
    assert bool(hit.all()) and torch.equal(brute.t, t) and torch.equal(brute.prim_id, pid)
    assert torch.equal(c["t"], t) and torch.equal(c["prim_id"], pid)
    assert bool((c["crossed"] == 80).all()) and bool((c["visits"] == 80).all())
    # the list holds the 32 farthest cells first, so each of the 48 nearest
    # is set aside: one listing, then one after each of them
    assert bool((c["slab"] == 80 * (1 + 80 - kd_kernel.LIST_CAP)).all())


def test_walk_tie_across_cells_goes_to_the_lower_id():
    scene, rays = two_cell_tie_scene()
    c = kd.kd_walk_counts(scene.clusters, *rays)
    assert c["hit"].tolist() == [True, False, True] and c["prim_id"].tolist() == [0, 0, 0]
    assert c["visits"].tolist() == [2, 2, 2]
