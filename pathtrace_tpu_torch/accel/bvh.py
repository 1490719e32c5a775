"""SAH BVH builder -> flat threaded arrays (port of
pathtrace_tpu/accel/bvh.py, numpy, copied because importing pathtrace_tpu
imports jax).

The reference's SAHBVH build (bvh.cpp:426-511): top-down, a leaf at <= 4
prims (bvh.cpp:441); prims sorted by centroid (the vertices' sum times
0.333333, bvh.cpp:100-103) in DESCENDING order along a round-robin axis
x -> y -> z (bvh.cpp:451-454); the split minimizing CSA[i-1]*i +
(CSAtot - CSA[i-1])*(n-i) over prefix sums of the prims' parallelogram
areas (bvh.cpp:458-477); AABBs bottom-up (bvh.cpp:392-419, 505-508).

The tree is emitted in pre-order with threaded skip links (next_hit /
next_miss), so a walk needs no per-ray stack (accel/traverse.py), and with
the permutation that makes every leaf's prims contiguous (the reference's
LoadFromBVH, CudaPrimitive.cu:84-90). The C++ builder (native/) builds the
same arrays faster; this numpy version is the semantic reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LEAF_SIZE = 4  # reference leaf threshold (bvh.cpp:441)

# The tensor leaves a scene carries across (Scene.from_numpy).
BVH_FIELDS = ("bmin", "bmax", "next_hit", "next_miss", "prim_start", "prim_count")


@dataclasses.dataclass(frozen=True)
class BVHArrays:
    """Flat threaded BVH. Node i's children are i+1 (left) and next_hit of
    the left subtree's end (right) in pre-order; a walk needs only
    next_hit / next_miss."""

    bmin: torch.Tensor        # (N, 3) float32
    bmax: torch.Tensor        # (N, 3) float32
    next_hit: torch.Tensor    # (N,) int32: node after a hit AABB (first child;
    #                           for a leaf its next_miss)
    next_miss: torch.Tensor   # (N,) int32: node after a missed AABB (skip), -1 ends
    prim_start: torch.Tensor  # (N,) int32: a leaf's first reordered prim, -1 if inner
    prim_count: torch.Tensor  # (N,) int32: a leaf's prim count, 0 if inner
    num_nodes: int
    max_leaf: int
    max_depth: int

    @staticmethod
    def from_numpy(bmin, bmax, next_hit, next_miss, prim_start, prim_count,
                   max_depth: int) -> "BVHArrays":
        count = np.asarray(prim_count, np.int32)
        t = lambda a, dt: torch.from_numpy(np.array(a, dt))  # a writable copy
        return BVHArrays(bmin=t(bmin, np.float32), bmax=t(bmax, np.float32),
                         next_hit=t(next_hit, np.int32), next_miss=t(next_miss, np.int32),
                         prim_start=t(prim_start, np.int32), prim_count=t(count, np.int32),
                         num_nodes=int(count.shape[0]),
                         max_leaf=int(count.max()) if count.size else 0,
                         max_depth=int(max_depth))


def _centroids(positions: np.ndarray) -> np.ndarray:
    """Mean of the three vertices with the reference's 0.333333 factor
    (bvh.cpp:100-103)."""
    return positions.sum(axis=1) * 0.333333


def _parallelogram_area(positions: np.ndarray) -> np.ndarray:
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    return np.linalg.norm(np.cross(e1, e2), axis=-1)


def build_bvh(positions: np.ndarray, leaf_size: int = LEAF_SIZE, backend: str = "auto"):
    """(BVHArrays, prim_order) of (T, 3, 3) world-space triangle vertices;
    prim_order is the permutation into leaf-contiguous order.

    backend: "native" (the C++ builder, native/; raises if it cannot be
    built), "numpy", or "auto" (native where g++ builds it, else numpy).
    Both build the same arrays (tests/test_torch_bvh.py)."""
    positions = np.asarray(positions, np.float32)
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"backend={backend!r}: auto, native or numpy")
    if backend in ("auto", "native") and positions.shape[0] > 0:
        from pathtrace_tpu_torch import native

        out = native.build_bvh_native(positions, leaf_size)
        if out is not None:
            *arrays, prim_order, max_depth = out
            return BVHArrays.from_numpy(*arrays, max_depth), prim_order
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable (g++ could not build "
                               "native/bvh_builder.cpp)")
    t = positions.shape[0]
    cent = _centroids(positions)
    areas = _parallelogram_area(positions)

    # recursive split on an explicit stack (Python's recursion limit is too
    # low for large scenes), into a pointer-free tree in lists
    nodes_bmin, nodes_bmax = [], []
    nodes_left, nodes_right = [], []
    nodes_prims = []  # np.ndarray for a leaf, None for an inner node
    nodes_depth = []

    prim_min = positions.min(axis=1)
    prim_max = positions.max(axis=1)

    def new_node(depth):
        nodes_bmin.append(None)
        nodes_bmax.append(None)
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_prims.append(None)
        nodes_depth.append(depth)
        return len(nodes_bmin) - 1

    root = new_node(0)
    stack = [(root, np.arange(t, dtype=np.int64), 0, 0)]  # (node, ids, axis, depth)
    while stack:
        node, ids, axis, depth = stack.pop()
        if ids.size <= leaf_size:
            nodes_prims[node] = ids
            nodes_bmin[node] = prim_min[ids].min(axis=0)
            nodes_bmax[node] = prim_max[ids].max(axis=0)
            continue
        # descending centroid sort along the round-robin axis (bvh.cpp:451-454)
        order = np.argsort(-cent[ids, axis], kind="stable")
        ids = ids[order]
        csa = np.cumsum(areas[ids])
        n = ids.size
        i = np.arange(1, n)
        cost = csa[:-1] * i + (csa[-1] - csa[:-1]) * (n - i)
        split = int(np.argmin(cost)) + 1
        left = new_node(depth + 1)
        right = new_node(depth + 1)
        nodes_left[node], nodes_right[node] = left, right
        next_axis = (axis + 1) % 3
        stack.append((left, ids[:split], next_axis, depth + 1))
        stack.append((right, ids[split:], next_axis, depth + 1))

    # bottom-up AABBs of inner nodes: children come after their parents, so
    # reverse index order is a topological order
    for node in range(len(nodes_bmin) - 1, -1, -1):
        if nodes_prims[node] is None:
            left, right = nodes_left[node], nodes_right[node]
            nodes_bmin[node] = np.minimum(nodes_bmin[left], nodes_bmin[right])
            nodes_bmax[node] = np.maximum(nodes_bmax[left], nodes_bmax[right])

    # pre-order flatten with skip threading and the prim reorder
    n_nodes = len(nodes_bmin)
    bmin = np.empty((n_nodes, 3), np.float32)
    bmax = np.empty((n_nodes, 3), np.float32)
    next_hit = np.full(n_nodes, -1, np.int32)
    next_miss = np.full(n_nodes, -1, np.int32)
    prim_start = np.full(n_nodes, -1, np.int32)
    prim_count = np.zeros(n_nodes, np.int32)
    prim_order = np.empty(t, np.int64)

    flat_idx = {}
    order_stack = [(root, -1)]  # (node, its miss target), resolved below
    dfs = []
    while order_stack:
        node, miss = order_stack.pop()
        flat_idx[node] = len(dfs)
        dfs.append((node, miss))
        if nodes_prims[node] is None:
            # the left child next; the right child's miss is this node's miss
            order_stack.append((nodes_right[node], miss))
            order_stack.append((nodes_left[node], nodes_right[node]))

    prim_cursor = 0
    for idx, (node, miss) in enumerate(dfs):
        bmin[idx] = nodes_bmin[node]
        bmax[idx] = nodes_bmax[node]
        miss_idx = flat_idx[miss] if miss != -1 else -1
        next_miss[idx] = miss_idx
        if nodes_prims[node] is None:
            next_hit[idx] = flat_idx[nodes_left[node]]
        else:
            ids = nodes_prims[node]
            prim_start[idx] = prim_cursor
            prim_count[idx] = ids.size
            prim_order[prim_cursor:prim_cursor + ids.size] = ids
            prim_cursor += ids.size
            next_hit[idx] = miss_idx

    if prim_cursor != t:
        raise AssertionError(f"{prim_cursor} of {t} prims placed in leaves")
    max_depth = int(max(nodes_depth)) if nodes_depth else 0
    return (BVHArrays.from_numpy(bmin, bmax, next_hit, next_miss, prim_start, prim_count,
                                 max_depth), prim_order)


def validate_bvh(bvh: BVHArrays, positions: np.ndarray, prim_order: np.ndarray) -> None:
    """Structural invariants (JAX bvh.py:205-240): every prim in exactly one
    leaf, each leaf's AABB holds its prims, links well formed and strictly
    forward in pre-order (so every walk ends). Raises AssertionError."""
    prim_start = bvh.prim_start.cpu().numpy()
    prim_count = bvh.prim_count.cpu().numpy()
    bmin = bvh.bmin.cpu().numpy()
    bmax = bvh.bmax.cpu().numpy()
    reordered = np.asarray(positions)[prim_order]

    covered = np.zeros(reordered.shape[0], bool)
    for i in range(bvh.num_nodes):
        s, c = prim_start[i], prim_count[i]
        if s < 0:
            continue
        assert c >= 1
        assert not covered[s:s + c].any(), "prim in two leaves"
        covered[s:s + c] = True
        pm = reordered[s:s + c].reshape(-1, 3)
        assert (pm >= bmin[i] - 1e-4).all() and (pm <= bmax[i] + 1e-4).all(), \
            "leaf AABB does not contain its prims"
    assert covered.all(), "some prim not in any leaf"
    nh = bvh.next_hit.cpu().numpy()
    nm = bvh.next_miss.cpu().numpy()
    assert ((nh >= -1) & (nh < bvh.num_nodes)).all()
    assert ((nm >= -1) & (nm < bvh.num_nodes)).all()
    idx = np.arange(bvh.num_nodes)
    assert ((nh == -1) | (nh > idx)).all()
    assert ((nm == -1) | (nm > idx)).all()
