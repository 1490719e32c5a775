"""KD cell tables and the slab test (the parts of pathtrace_tpu/accel/binned.py
that the port's KD raycast needs).

`ClusterArrays` holds non-overlapping KD cells (accel/kdgrid.py) over a
member table in which a triangle appears once for every cell its AABB
overlaps. Cell m owns member slots [prim_start[m], prim_start[m] +
prim_count[m]); slot j holds the triangle's v0, e1 = v1 - v0 and
e2 = v2 - v0 (float32, computed as Triangles.e1/e2 compute them) and its
original triangle id dup_map[j]. Within a cell, slots are in ascending
original id (the KD build filters an ascending id list).

Not carried over: the MXU coefficient tiles (`coeffs`), the BVH-subtree
clusters (v1/v2) and the v3 pair dispatch; those are TPU formulations
(ROADMAP "Not to port").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ClusterArrays:
    bmin: torch.Tensor        # (M, 3) float32
    bmax: torch.Tensor        # (M, 3) float32
    prim_start: torch.Tensor  # (M,) int32 first member slot
    prim_count: torch.Tensor  # (M,) int32 member slots
    dup_map: torch.Tensor     # (D,) int32 original triangle id per slot
    members: torch.Tensor     # (D, 9) float32 [v0 | e1 | e2] per slot

    @property
    def num_clusters(self) -> int:
        return self.bmin.shape[0]

    @property
    def num_members(self) -> int:
        return self.dup_map.shape[0]

    @staticmethod
    def from_cells(positions: np.ndarray, bmin, bmax, prim_start, prim_count,
                   dup_map) -> "ClusterArrays":
        """Cell table over the (T, 3, 3) triangle positions; the member rows
        are gathered from them through dup_map. Raises when the slots do
        not tile [0, D) cell by cell in ascending id order."""
        positions = np.asarray(positions, np.float32)
        start = np.asarray(prim_start, np.int64)
        count = np.asarray(prim_count, np.int64)
        dup = np.asarray(dup_map, np.int64)
        if (start != np.concatenate([[0], np.cumsum(count)[:-1]])).any() \
                or count.sum() != dup.size:
            raise ValueError("cell slots must be contiguous and cover dup_map")
        for s, n in zip(start, count):
            if (np.diff(dup[s:s + n]) <= 0).any():
                raise ValueError("member ids must ascend within each cell")
        p = positions[dup]
        members = np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=1)
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
        i32 = lambda a: torch.from_numpy(np.array(a, np.int32))
        return ClusterArrays(bmin=f32(bmin), bmax=f32(bmax), prim_start=i32(start),
                             prim_count=i32(count), dup_map=i32(dup), members=f32(members))


def safe_inv_dir(dirn: torch.Tensor) -> torch.Tensor:
    """1/dir with components of |d| <= 1e-12 replaced by +-1e30
    (accel/traverse.py:47-52), so the slab arithmetic stays NaN-free."""
    big = torch.where(dirn >= 0.0, torch.full_like(dirn, 1e30), torch.full_like(dirn, -1e30))
    return torch.where(torch.abs(dirn) > 1e-12, 1.0 / dirn, big)


def slab_all(org, inv_d, bmin, bmax, t_min, t_max):
    """(R, M) cell crossing and entry t for per-ray ranges
    (binned.py:148-156): the far bound is widened by 1.00000024 so a
    segment that grazes a face still counts."""
    t0 = (bmin[None, :, :] - org[:, None, :]) * inv_d[:, None, :]
    t1 = (bmax[None, :, :] - org[:, None, :]) * inv_d[:, None, :]
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    tnear = torch.maximum(torch.amax(tlo, dim=-1), t_min[:, None])
    tfar = torch.minimum(torch.amin(thi, dim=-1), t_max[:, None]) * 1.00000024
    return tnear <= tfar, tnear
