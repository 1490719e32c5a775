"""KD cells over a triangle soup, built by the benchmark's own frozen copy
of the port's build (accel/kdgrid.py, hybrid rule), so that kernel B2's
needed work is counted over the cells it walks at the cell's parameters.

Cells are axis-aligned boxes that do not overlap; a triangle is a member of
every cell its bounding box overlaps; a leaf that cannot be split is
chunked into same-box cells of at most max_tris members.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Cells:
    bmin: torch.Tensor     # (M, 3)
    bmax: torch.Tensor     # (M, 3)
    members: list          # M tensors (n_m, 9): [v0 | e1 | e2] of each member

    @property
    def num_cells(self) -> int:
        return self.bmin.shape[0]

    @property
    def num_members(self) -> int:
        return sum(m.shape[0] for m in self.members)

    def to(self, device) -> "Cells":
        return Cells(self.bmin.to(device), self.bmax.to(device),
                     [m.to(device) for m in self.members])


def build_cells(positions: np.ndarray, max_tris: int, pad: float = 1e-3) -> Cells:
    """Midpoint cuts along the widest axis, the centroid median for the last
    split (at most 2 max_tris members), each leaf tightened to its members."""
    positions = np.asarray(positions, np.float32)
    tri_min, tri_max = positions.min(axis=1), positions.max(axis=1)
    cent = (tri_min + tri_max) * 0.5
    cells = []

    def emit(ids, bmin, bmax):
        for s in range(0, len(ids), max_tris):
            sub = ids[s:s + max_tris]
            cells.append((np.maximum(tri_min[sub].min(axis=0) - pad, bmin),
                          np.minimum(tri_max[sub].max(axis=0) + pad, bmax), sub))

    def split(ids, bmin, bmax, depth):
        if len(ids) == 0:
            return
        if len(ids) <= max_tris or depth > 30:
            emit(ids, bmin, bmax)
            return
        axis = int(np.argmax(bmax - bmin))
        cut = 0.5 * (bmin[axis] + bmax[axis])
        if len(ids) <= 2 * max_tris:
            med = float(np.median(cent[ids][:, axis]))
            cut = med if bmin[axis] < med < bmax[axis] else cut
        bmax_l, bmin_r = bmax.copy(), bmin.copy()
        bmax_l[axis] = bmin_r[axis] = cut
        left = ids[tri_min[ids, axis] <= cut + pad]
        right = ids[tri_max[ids, axis] >= cut - pad]
        if len(left) == len(ids) and len(right) == len(ids):
            emit(ids, bmin, bmax)
            return
        split(left, bmin, bmax_l, depth + 1)
        split(right, bmin_r, bmax, depth + 1)

    split(np.arange(positions.shape[0]), (tri_min.min(axis=0) - pad).astype(np.float64),
          (tri_max.max(axis=0) + pad).astype(np.float64), 0)
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    rows = lambda ids: f32(np.concatenate([positions[ids, 0], positions[ids, 1] - positions[ids, 0],
                                           positions[ids, 2] - positions[ids, 0]], axis=1))
    return Cells(f32(np.stack([c[0] for c in cells])), f32(np.stack([c[1] for c in cells])),
                 [rows(c[2]) for c in cells])


def slab(org, dirn, bmin, bmax, t_min, t_max):
    """(R, M) whether each ray's segment crosses each cell, and its entry t;
    the far bound widened by 1.00000024 so a grazing segment counts."""
    big = torch.where(dirn >= 0.0, torch.full_like(dirn, 1e30), torch.full_like(dirn, -1e30))
    inv = torch.where(torch.abs(dirn) > 1e-12, 1.0 / dirn, big)
    t0 = (bmin[None] - org[:, None]) * inv[:, None]
    t1 = (bmax[None] - org[:, None]) * inv[:, None]
    tnear = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=-1), t_min[:, None])
    tfar = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1), t_max[:, None]) * 1.00000024
    return tnear <= tfar, tnear
