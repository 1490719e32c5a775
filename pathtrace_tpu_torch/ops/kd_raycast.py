"""Closest-hit raycast over KD cells: the mesh path's search (port of the
contract of pathtrace_tpu/accel/binned.py::raycast_binned_pallas_v3 with
its pair kernel, and of raycast_binned_v3 / shadow_binned_v3 on top).

`kd_closest` returns, for each ray with its own [t_min, t_max], the
closest triangle over the cells its segment crosses:
- f32 Möller-Trumbore exactly as ops/intersect.py computes it (backface
  cull det >= EPS, 0 <= u <= det, v >= 0, u + v <= det, t = (q.e2)/det);
- equal t resolves to the lowest original triangle id, brute's rule
  (closest_masked), so the result equals raycast_brute's bit for bit;
- (hit, t, u, v, prim_id) with normalized barycentrics and prim_id in
  the scene's triangle order (the member slots' dup_map ids); misses give
  t = u = v = 0 and prim_id 0. Shadow mode selects the same winner
  (closest-hit, not any-hit: NEE accepts only when the winner IS the
  sampled light) and leaves u = v = 0.

On CPU tensors `kd_closest` runs the plain version below; on CUDA tensors
it launches the hand-written kernel (csrc/kd_raycast.cu through
ops/cuda/kd_raycast.py) or raises. It never falls back.

Not carried over from the TPU path (workarounds for a fixed-shape
dispatch): the slot budget, the v3 pair dispatch and its overflow repair,
the bf16 split products and accept band, the top-2 recompute and the
packed scatter-min key.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtrace_tpu_torch.accel.binned import ClusterArrays, safe_inv_dir, slab_all
from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel
from pathtrace_tpu_torch.ops.intersect import (BIG_T, HitRecord, closest_masked,
                                               detached_rows, finalize_hit_at,
                                               finalize_shadow, intersect_tris_all)
from pathtrace_tpu_torch.utils.math3 import EPS

MODES = ("closest", "shadow")
# Rays per Möller-Trumbore batch inside one cell: bounds the (rows x 1024)
# temporaries of the plain version (about 100 MB each on the card).
ROW_CHUNK = 8192
_NO_ID = torch.iinfo(torch.int32).max


def kd_closest_plain(clusters: ClusterArrays, org, dirn, t_min, t_max,
                     mode: str = "closest"):
    """The plain PyTorch version of the KD kernel: slab-test every cell,
    then for each cell run Möller-Trumbore on its members for the rays that
    cross it and keep, per ray, the least (t, original id)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    r = org.shape[0]
    dev = org.device
    best_t = torch.full((r,), float("inf"), device=dev)
    best_id = torch.full((r,), _NO_ID, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), device=dev)
    best_v = torch.zeros((r,), device=dev)
    cross, _ = slab_all(org, safe_inv_dir(dirn), clusters.bmin, clusters.bmax, t_min, t_max)
    # the crossing rays of every cell, grouped by cell (one host sync)
    _, ray_of_pair = torch.nonzero(cross.t(), as_tuple=True)
    per_cell = torch.split(ray_of_pair, cross.sum(dim=0).tolist())
    starts, counts = clusters.prim_start.tolist(), clusters.prim_count.tolist()
    for cell_rays, s, n in zip(per_cell, starts, counts):
        if cell_rays.numel() == 0:
            continue
        mem = clusters.members[s:s + n]
        ids = clusters.dup_map[s:s + n]
        for c0 in range(0, cell_rays.numel(), ROW_CHUNK):
            rows = cell_rays[c0:c0 + ROW_CHUNK]
            t, valid, u, v = intersect_tris_all(mem[:, 0:3], mem[:, 3:6], mem[:, 6:9],
                                                org[rows], dirn[rows], t_min[rows],
                                                t_max[rows])
            # ids ascend within a cell, so the lowest column is the lowest id
            ct, col, chit = closest_masked(torch.where(valid, t, torch.full_like(t, float("inf"))))
            cid = ids[col.long()]
            bt, bi = best_t[rows], best_id[rows]
            better = chit & ((ct < bt) | ((ct == bt) & (cid < bi)))
            best_t[rows] = torch.where(better, ct, bt)
            best_id[rows] = torch.where(better, cid, bi)
            if mode == "closest":
                pick = col.long()[:, None]
                best_u[rows] = torch.where(better, torch.gather(u, 1, pick)[:, 0], best_u[rows])
                best_v[rows] = torch.where(better, torch.gather(v, 1, pick)[:, 0], best_v[rows])
    hit = best_id != _NO_ID
    zero = torch.zeros_like(best_t)
    return (hit, torch.where(hit, best_t, zero), best_u, best_v,
            torch.where(hit, best_id, torch.zeros_like(best_id)))


SLAB_WIDEN = 1.00000024  # the far bound's widening (slab_all), also the exit rule's


def _reach(best_t):
    """The walk's exit rule: a cell whose tnear lies beyond this holds no
    hit nearer than best_t."""
    return torch.maximum(best_t, best_t * SLAB_WIDEN)


def kd_walk_counts(clusters: ClusterArrays, org, dirn, t_min, t_max) -> dict:
    """The KD kernel's work on these rays, counted by its own rules in plain
    PyTorch (no kernel runs). Each ray visits its crossed cells in ascending
    (tnear, cell) order and stops before the first whose tnear exceeds its
    best t so far times SLAB_WIDEN; the winner is the least (t, original id)
    of the visited cells' members. Returns, per ray:

    visited, visited_tn: (R, V) the cells in visiting order and their
        tnear, -1 and inf past the last; visits: (R,) how many;
    tests: the Möller-Trumbore tests the walk issues (every member of every
        visited cell);
    slab: the walk's slab tests, the cell count for each time it lists the
        crossed cells after its cursor: once, and again after visiting a
        cell set aside because it was not among the first kd_kernel.LIST_CAP
        of them by index;
    crossed: the cells the segment crosses;
    hit, t, prim_id: the walk's winner (t = 0, prim_id = 0 on a miss)."""
    r, m = org.shape[0], clusters.num_clusters
    dev = org.device
    cross, tnear = slab_all(org, safe_inv_dir(dirn), clusters.bmin, clusters.bmax, t_min, t_max)
    key = torch.where(cross, tnear, torch.full_like(tnear, float("inf")))
    # (tnear, cell) order: a stable sort keeps cells of equal tnear in index order
    order = torch.sort(key, dim=1, stable=True).indices
    crossed = cross.sum(dim=1)
    count = clusters.prim_count.long()
    cells = torch.arange(m, device=dev)[None, :]

    def listing(after):
        return after & (torch.cumsum(after.long(), dim=1) <= kd_kernel.LIST_CAP)

    best_t = torch.full((r,), float("inf"), device=dev)
    best_id = torch.full((r,), _NO_ID, dtype=torch.int32, device=dev)
    visits = torch.zeros((r,), dtype=torch.int64, device=dev)
    tests = torch.zeros((r,), dtype=torch.int64, device=dev)
    listings = torch.ones((r,), dtype=torch.int64, device=dev)
    listed = listing(cross)
    visited, visited_tn = [], []
    for k in range(int(crossed.max()) if r else 0):
        cell = order[:, k]
        tn = key.gather(1, cell[:, None])[:, 0]
        walking = (visits == k) & (k < crossed) & (tn <= _reach(best_t))
        if not bool(walking.any()):
            break
        for c in torch.unique(cell[walking]).tolist():
            rows = torch.nonzero(walking & (cell == c))[:, 0]
            s, n = int(clusters.prim_start[c]), int(count[c])
            mem = clusters.members[s:s + n]
            t, valid, _, _ = intersect_tris_all(mem[:, 0:3], mem[:, 3:6], mem[:, 6:9],
                                                org[rows], dirn[rows], t_min[rows], t_max[rows])
            ct, col, chit = closest_masked(torch.where(valid, t, torch.full_like(t, float("inf"))))
            cid = clusters.dup_map[s:s + n][col.long()]
            bt, bi = best_t[rows], best_id[rows]
            better = chit & ((ct < bt) | ((ct == bt) & (cid < bi)))
            best_t[rows] = torch.where(better, ct, bt)
            best_id[rows] = torch.where(better, cid, bi)
        tests += torch.where(walking, count[cell], 0)
        visits += walking.long()
        visited.append(torch.where(walking, cell, -1))
        visited_tn.append(torch.where(walking, tn, torch.full_like(tn, float("inf"))))
        # a visited cell outside the list was set aside: list again after it
        again = walking & ~listed.gather(1, cell[:, None])[:, 0]
        listings += again.long()
        after = cross & ((key > tn[:, None]) | ((key == tn[:, None]) & (cells > cell[:, None])))
        listed = torch.where(again[:, None], listing(after), listed)
    visited = torch.stack(visited, 1) if visited else torch.full((r, 0), -1, device=dev)
    visited_tn = (torch.stack(visited_tn, 1) if visited_tn
                  else torch.full((r, 0), float("inf"), device=dev))
    hit = best_id != _NO_ID
    return {
        "visited": visited, "visited_tn": visited_tn, "visits": visits, "tests": tests,
        "slab": m * listings, "crossed": crossed,
        "hit": hit, "t": torch.where(hit, best_t, torch.zeros_like(best_t)),
        "prim_id": torch.where(hit, best_id, torch.zeros_like(best_id)),
    }


def kd_closest(clusters: ClusterArrays, org, dirn, t_min, t_max, mode: str = "closest"):
    """(hit, t, u, v, prim_id) of the KD search: the plain version on CPU
    tensors, the CUDA kernel on CUDA tensors; any other device raises."""
    if org.device.type == "cuda":
        return kd_kernel.launch(clusters, org, dirn, t_min, t_max, mode)
    if org.device.type == "cpu":
        return kd_closest_plain(clusters, org, dirn, t_min, t_max, mode)
    raise ValueError(f"no KD raycast for device {org.device}")


def raycast_kd(scene: Scene, org, dirn, t_min=None, t_max=None, *,
               search=kd_closest) -> HitRecord:
    """Closest hit through the KD cells, merged with the sphere scan and
    shaded by finalize_hit_at (raycast_binned_v3, binned.py:804-837): the
    search runs detached, (t, u, v) are recomputed differentiably at the
    winner. `search` is the cell search (kd_closest; kd_closest_plain to
    hold the kernel against its plain version on the card)."""
    r = org.shape[0]
    if t_min is None:
        t_min = torch.zeros((r,), device=org.device)
    if t_max is None:
        t_max = torch.full((r,), BIG_T, device=org.device)
    hit, t, u, v, pid = search(scene.clusters, *detached_rows(org, dirn, t_min, t_max),
                               "closest")
    return finalize_hit_at(scene, org, dirn, t_min, t_max, hit, t, pid, u, v)


def shadow_kd(scene: Scene, org, dirn, t_min, t_max, *, search=kd_closest):
    """(hit, prim_id, is_sphere) of NEE shadow rays through the KD cells
    (shadow_binned_v3, binned.py:840-863), merged with the spheres as
    shadow_brute does (finalize_shadow)."""
    org, dirn, t_min, t_max = detached_rows(org, dirn, t_min, t_max)
    hit, t, _, _, pid = search(scene.clusters, org, dirn, t_min, t_max, "shadow")
    return finalize_shadow(scene, org, dirn, t_min, t_max, hit, t, pid)


def probe_rays(scene: Scene, camera: Camera, n: int, seed: int = 0) -> dict:
    """The kinds of rays the mesh path hands the KD search, for holding the
    kernel against its plain version: {name: (org, dirn, t_min, t_max)} on
    the scene's device.

    camera:  one ray per pixel through its center, on [0, BIG_T];
    surface: n rays leaving random points of random triangles, EPS above
             the front face, into random directions of that hemisphere, on
             [0, BIG_T] (the bounce rays);
    shadow:  from the same points to random points of random lights, on
             [EPS, dist + 1] (the NEE rays).
    """
    dev = scene.device
    g = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    px, py = camera.pixel_grid(dev)
    half = torch.full_like(px, 0.5)
    d_cam = camera.ray_directions(px, py, half, half)
    o_cam = f32(np.broadcast_to(np.asarray(camera.pos, np.float32), tuple(d_cam.shape)))
    r = d_cam.shape[0]

    def on_triangles(tris, count):
        b = g.random((count, 2))
        b = np.where(b.sum(1, keepdims=True) > 1.0, 1.0 - b, b)
        e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
        return tris[:, 0] + b[:, :1] * e1 + b[:, 1:] * e2, np.cross(e1, e2)

    pos = scene.positions().astype(np.float64)
    p, gn = on_triangles(pos[g.integers(0, pos.shape[0], n)], n)
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-30)
    org = p + EPS * gn
    d = g.normal(size=(n, 3))
    d *= np.where((d * gn).sum(1, keepdims=True) < 0.0, -1.0, 1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lp = scene.light_pack[:max(scene.num_lights, 1)].cpu().numpy().astype(np.float64)
    q, _ = on_triangles(lp[g.integers(0, lp.shape[0], n)][:, :9].reshape(n, 3, 3), n)
    to_light = q - org
    dist = np.linalg.norm(to_light, axis=1)
    return {
        "camera": (o_cam, d_cam, torch.zeros((r,), device=dev),
                   torch.full((r,), BIG_T, device=dev)),
        "surface": (f32(org), f32(d), torch.zeros((n,), device=dev),
                    torch.full((n,), BIG_T, device=dev)),
        "shadow": (f32(org), f32(to_light / dist[:, None]), torch.full((n,), EPS, device=dev),
                   f32(dist + 1.0)),
    }


def edge_rays(scene: Scene, n: int, seed: int = 0) -> dict:
    """Rays at the edges of the KD search's rules, for holding the kernel
    against its plain version: {name: (org, dirn, t_min, t_max)} on the
    scene's device, n rays each (t in [0, BIG_T] unless named).

    axis:    axis-parallel directions (two components exactly 0: safe_inv's
             1e30 path) from random points of the cells' bounds;
    face:    rays that start on a face of a random cell and run in its
             plane (one component exactly 0);
    inside:  rays that start inside a random cell;
    segment: t_min > 0 segments between random points of the bounds, on
             [0.1 .. 0.5 of the distance, the distance] (shadow-like);
    miss:    rays that start outside the bounds and leave them;
    largest: rays from random points of the bounds toward random points of
             the cell with the most members.
    """
    cl = scene.clusters
    dev = scene.device
    g = np.random.default_rng(seed)
    bmin, bmax = cl.bmin.cpu().numpy(), cl.bmax.cpu().numpy()
    lo, hi = bmin.min(axis=0), bmax.max(axis=0)
    rows = np.arange(n)

    def unit(d):
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    def rays(org, d, t_min=None, t_max=None):
        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        t_min = np.zeros(n) if t_min is None else t_min
        t_max = np.full(n, BIG_T) if t_max is None else t_max
        return f32(org), f32(d), f32(t_min), f32(t_max)

    out = {}
    axis_d = np.zeros((n, 3))
    axis_d[rows, g.integers(0, 3, n)] = g.choice([-1.0, 1.0], n)
    out["axis"] = rays(g.uniform(lo, hi, (n, 3)), axis_d)
    cell = g.integers(0, cl.num_clusters, n)
    ax = g.integers(0, 3, n)
    org = g.uniform(bmin[cell], bmax[cell])
    org[rows, ax] = np.where(g.random(n) < 0.5, bmin[cell, ax], bmax[cell, ax])
    d = g.normal(size=(n, 3))
    d[rows, ax] = 0.0
    out["face"] = rays(org, unit(d))
    out["inside"] = rays(g.uniform(bmin[cell], bmax[cell]), unit(g.normal(size=(n, 3))))
    org, q = g.uniform(lo, hi, (n, 3)), g.uniform(lo, hi, (n, 3))
    dist = np.linalg.norm(q - org, axis=1)
    out["segment"] = rays(org, (q - org) / dist[:, None], g.uniform(0.1, 0.5, n) * dist, dist)
    away = unit(g.normal(size=(n, 3)))
    out["miss"] = rays((lo + hi) / 2 + away * np.linalg.norm(hi - lo), away)
    big = int(cl.prim_count.argmax())
    org = g.uniform(lo, hi, (n, 3))
    out["largest"] = rays(org, unit(g.uniform(bmin[big], bmax[big], (n, 3)) - org))
    return out
