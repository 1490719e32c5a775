"""Non-overlapping KD cells for the mesh raycast (port of
pathtrace_tpu/accel/kdgrid.py, pure numpy, copied because importing
pathtrace_tpu imports jax).

Cells are axis-aligned boxes that do not overlap, so a ray's candidate set
is the set of cells its segment crosses, bounded by the cell grid and not
by surface density. A triangle is listed in every cell its AABB overlaps
(conservative), and the member slots map back to original triangle ids
through dup_map. A no-progress leaf (every member spans the cut) is
chunked into several cells that share one box; closest-hit stays exact
because the search compares (t, original id) across all visited cells.

Dropped from the JAX build: the MXU coefficient tiles (build_mt_coeffs),
a TPU formulation (ROADMAP "Not to port").
"""

from __future__ import annotations

import numpy as np
import torch

from pathtrace_tpu_torch.accel.binned import ClusterArrays, safe_inv_dir, slab_all


def build_kd_clusters(positions: np.ndarray, max_tris: int = 256,
                      pad_bounds: float = 1e-3, rule: str = "midpoint",
                      shrink: bool = True) -> ClusterArrays:
    """(T, 3, 3) world triangles -> ClusterArrays.

    Recursive cut along the cell's widest axis until <= max_tris members.
    rule="midpoint" cuts the box center (fat cells, fewer crossings per
    ray); "median" cuts the member-centroid median; "hybrid" cuts midpoint
    globally and the centroid median for the final split (<= 2 max_tris
    members), so leaves fill up. Empty children are dropped. With
    `shrink`, each leaf's box is tightened to its members' bounds (padded)
    intersected with the cell.
    """
    if rule not in ("midpoint", "median", "hybrid"):
        raise ValueError(f"unknown KD split rule {rule!r}")
    positions = np.asarray(positions, np.float32)
    t = positions.shape[0]
    tri_min = positions.min(axis=1)
    tri_max = positions.max(axis=1)
    cent = (tri_min + tri_max) * 0.5
    root_min = tri_min.min(axis=0) - pad_bounds
    root_max = tri_max.max(axis=0) + pad_bounds

    cells = []   # (bmin, bmax, member_ids)

    def emit(ids, bmin, bmax):
        # depth-capped / no-progress leaves may exceed max_tris: chunk
        # into same-box cells
        for s in range(0, len(ids), max_tris):
            sub = ids[s:s + max_tris]
            if shrink:
                mb_min = np.maximum(tri_min[sub].min(axis=0) - pad_bounds, bmin)
                mb_max = np.minimum(tri_max[sub].max(axis=0) + pad_bounds, bmax)
                cells.append((mb_min, mb_max, sub))
            else:
                cells.append((bmin, bmax, sub))

    def split(ids: np.ndarray, bmin: np.ndarray, bmax: np.ndarray, depth: int):
        if len(ids) == 0:
            return
        if len(ids) <= max_tris or depth > 30:
            emit(ids, bmin, bmax)
            return
        c = cent[ids]
        if rule == "hybrid" and len(ids) <= 2 * max_tris:
            axis = int(np.argmax(bmax - bmin))
            cut = float(np.median(c[:, axis]))
            if not (bmin[axis] < cut < bmax[axis]):
                cut = 0.5 * (bmin[axis] + bmax[axis])
        elif rule in ("midpoint", "hybrid"):
            axis = int(np.argmax(bmax - bmin))
            cut = 0.5 * (bmin[axis] + bmax[axis])
        else:
            spread = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(spread))
            cut = float(np.median(c[:, axis]))
            if not (bmin[axis] < cut < bmax[axis]):
                cut = 0.5 * (bmin[axis] + bmax[axis])
        bmax_l = bmax.copy()
        bmax_l[axis] = cut
        bmin_r = bmin.copy()
        bmin_r[axis] = cut
        eps = pad_bounds
        left = ids[tri_min[ids, axis] <= cut + eps]
        right = ids[tri_max[ids, axis] >= cut - eps]
        if len(left) == len(ids) and len(right) == len(ids):
            emit(ids, bmin, bmax)  # no progress: every tri spans the cut
            return
        split(left, bmin, bmax_l, depth + 1)
        split(right, bmin_r, bmax, depth + 1)

    split(np.arange(t, dtype=np.int64), root_min.astype(np.float64),
          root_max.astype(np.float64), 0)

    bmin = np.stack([c[0] for c in cells]).astype(np.float32)
    bmax = np.stack([c[1] for c in cells]).astype(np.float32)
    counts = np.array([len(c[2]) for c in cells], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dup_map = np.concatenate([c[2] for c in cells])
    return ClusterArrays.from_cells(positions, bmin, bmax, starts, counts, dup_map)


def crossing_stats(clusters: ClusterArrays, org: torch.Tensor, dirn: torch.Tensor,
                   t_max: float = 999999.0) -> dict:
    """Cells crossed per ray on [0, t_max]: mean, p99 and max."""
    r = org.shape[0]
    cross, _ = slab_all(org, safe_inv_dir(dirn), clusters.bmin, clusters.bmax,
                        torch.zeros((r,), device=org.device),
                        torch.full((r,), t_max, device=org.device))
    h = cross.sum(dim=1).cpu().numpy()
    return dict(mean=float(h.mean()), p99=float(np.percentile(h, 99)), max=int(h.max()))
