"""Stackless BVH walk (port of pathtrace_tpu/accel/traverse.py:36-133),
in plain PyTorch.

The builder threads the tree with skip links (accel/bvh.py: next_hit,
next_miss), so every ray carries only its current node: each step of the
walk gathers that node's box for all rays, runs the slab test and, at a
leaf, at most max_leaf masked Möller-Trumbore tests, until every ray has
left the tree (the reference's per-thread `int stack[128]` walk,
CudaUtil.cuh:93-148, without the stack). It has no kernel: the port routes
scenes through the all-triangles search (B3) or the KD cells (B2), which
find the same winners (integrator/megakernel.default_raycast), and
raycast_bvh is reachable as a raycast_fn, as the JAX package's is.

The slab test is the robust one with Ize's 1.00000024 t_max factor; the
reference's Normalize(inv(dir)) rescaling (CudaUtil.cuh:70) is not
replicated, as in the JAX package (pruning only, the estimator is the
same). Boxes are tested against [t_min, closest t], leaf prims against the
running closest t, spheres after the tree (CudaUtil.cuh:107, 137-145).
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.ops.intersect import BIG_T, HitRecord, finalize_hit_at, mt_gather

# Robust slab-test expansion factor (Ize, "Robust BVH Ray Traversal"; the
# reference uses the same constant, CudaUtil.cuh:86).
TMAX_FUDGE = 1.00000024


def slab_test(org, inv_d, bmin, bmax, t_min, t_max) -> torch.Tensor:
    """(R,) robust slab test of each ray against its box; inv_d from
    safe_inv_dir."""
    t0 = (bmin - org) * inv_d
    t1 = (bmax - org) * inv_d
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    tnear = torch.maximum(tlo.amax(dim=-1), t_min)
    tfar = torch.minimum(thi.amin(dim=-1), t_max) * TMAX_FUDGE
    return tnear <= tfar


def safe_inv_dir(dirn) -> torch.Tensor:
    """1/dir with +-inf replaced by +-1e30 (keeps the slab arithmetic free
    of NaN when an origin lies on a slab plane)."""
    big = 1e30
    s = torch.where(dirn >= 0.0, 1.0, -1.0)
    return torch.where(dirn.abs() > 1e-12, 1.0 / dirn, s * big)


def raycast_bvh(scene: Scene, org: torch.Tensor, dirn: torch.Tensor,
                t_min=None, t_max=None) -> HitRecord:
    """Closest hit through scene.bvh (Scene.with_bvh), a drop-in for
    raycast_brute on the device of `org`. The walk runs on detached rays;
    (t, u, v) are recomputed differentiably at the chosen triangle, so
    gradients flow as through the brute search."""
    bvh = scene.bvh
    if bvh is None:
        raise ValueError("scene has no BVH; call Scene.with_bvh()")
    dev = org.device
    r = org.shape[0]
    if t_min is None:
        t_min = torch.zeros((r,), device=dev)
    if t_max is None:
        t_max = torch.full((r,), BIG_T, device=dev)
    o, d, tn, tx = (x.detach() for x in (org, dirn, t_min, t_max))
    inv_d = safe_inv_dir(d)
    max_leaf = max(bvh.max_leaf, 1)

    node = torch.zeros((r,), dtype=torch.int64, device=dev)  # the root
    best_t = torch.full((r,), BIG_T, device=dev)
    best_prim = torch.zeros((r,), dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), device=dev)
    best_v = torch.zeros((r,), device=dev)
    tri_hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    while bool((node >= 0).any()):
        active = node >= 0
        nidx = node.clamp(min=0)
        # prune against the running closest t (CudaUtil.cuh:107)
        cur_max = torch.where(tri_hit, best_t, tx)
        ahit = slab_test(o, inv_d, bvh.bmin[nidx], bvh.bmax[nidx], tn, cur_max) & active
        pstart = bvh.prim_start[nidx]
        pcnt = bvh.prim_count[nidx]
        leaf_visit = ahit & (pstart >= 0)
        for k in range(max_leaf):
            valid_k = leaf_visit & (k < pcnt)
            pid = torch.where(valid_k, pstart + k, 0)
            cur_max = torch.where(tri_hit, best_t, tx)
            t, u, v, ok = mt_gather(scene.tris, pid, o, d, tn, cur_max)
            better = valid_k & ok
            best_t = torch.where(better, t, best_t)
            best_prim = torch.where(better, pid, best_prim)
            best_u = torch.where(better, u, best_u)
            best_v = torch.where(better, v, best_v)
            tri_hit = tri_hit | better
        nxt = torch.where(ahit, bvh.next_hit[nidx], bvh.next_miss[nidx]).to(torch.int64)
        node = torch.where(active, nxt, node)
    return finalize_hit_at(scene, org, dirn, t_min, t_max, tri_hit, best_t, best_prim,
                           best_u, best_v)
