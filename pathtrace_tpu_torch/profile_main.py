"""Where a path's time goes on one GPU, under torch.profiler.

    python -m pathtrace_tpu_torch.profile_main
    PROFILE_SCENE=mesh python -m pathtrace_tpu_torch.profile_main
    PROFILE_SCENE=train python -m pathtrace_tpu_torch.profile_main

Renders the job once to warm up, once timed, and once under
torch.profiler, and prints ONE JSON line: wall ms of the timed render and
of the profiled one (the profiler slows the host), device-busy ms (the
summed device time of the kernels and copies the profiler recorded), the
device's idle share against the timed wall (1 - busy / wall_ms) and
against the profiled one, the number of device launches, and the device ms
and launch count of the kernels that took the most device time, with the
card's name and power limit. Only device activity is recorded, which keeps
the profiler's own host cost low. Needs a CUDA device. PROFILE_SCENE picks
the job:

- cornell (default): the call `cli render --engine fused` makes, Cornell
  box with two spheres, 256x256 @ 1024 spp, chunks of 256 spp;
- mesh: `BENCH_SCENE=mesh`'s scene, film and lanes (blob82k with KD
  cells of 1024 through the wavefront engine and the KD raycast kernel)
  at 8 spp, one chunk. The eager wavefront launches thousands of small
  kernels per iteration; a trace of the bench's 64 spp takes the profiler
  many minutes to process.
- train: `BENCH_SCENE=train`'s step (Cornell + spheres 128x128, recording
  sweep through the all-triangles kernel, chunked replay backward) at
  PROFILE_SPP spp (default 8; the bench runs 64), for the same reason.

`schedule_share` (with `PathIterations` and `useful_share`) counts, from
the plain wavefront, how much of a warp's time the bounce kernel's lanes
spend on a path's work under two schedules of the same paths, and the
hits, shadow rays and triangle-test work that the kernel's bound charges:
the least-time model (`bound`, `mt_pair_ops`, `b1_ops`) sits beside it.
"""

from __future__ import annotations

import json
import os
import time


class PathIterations:
    """on_iteration hook of integrator/wavefront.py::_run_wavefront that
    records each path's bounce iterations on the device, without a host
    sync: iters[path id - base_path] is the path's last lane_iter + 1."""

    def __init__(self, total_paths: int, base_path: int, device):
        import torch
        self.base_path = base_path
        self.iters = torch.zeros((total_paths,), dtype=torch.int64, device=device)

    def __call__(self, ray_ids, lane_iter, alive):
        import torch
        idx = torch.where(alive, ray_ids - self.base_path, 0)
        val = torch.where(alive, lane_iter.to(torch.int64) + 1, 0)
        self.iters.scatter_reduce_(0, idx, val, "amax")


def useful_share(iters, lanes: int, warp: int = 32) -> tuple[float, float]:
    """(nested, in place): the share of a warp's lane-iterations that do a
    path's work, when lane i traces the path offsets i, i + lanes, ... (the
    static strided assignment; iters[offset] as PathIterations records) and
    a warp holds `warp` consecutive lanes. Nested: each path runs to its end
    before the lane's next starts, so a warp's round lasts its longest path.
    In place: one loop over iterations that regenerates ended paths, so a
    warp lasts as long as its busiest lane."""
    import torch
    n = iters.numel()
    rounds, warps = -(-n // lanes), -(-lanes // warp)
    grid = torch.zeros((rounds * lanes,), dtype=torch.int64, device=iters.device)
    grid[:n] = iters
    g = torch.zeros((rounds, warps * warp), dtype=torch.int64, device=iters.device)
    g[:, :lanes] = grid.view(rounds, lanes)
    g = g.view(rounds, warps, warp)
    useful = float(iters.sum())
    nested = float(g.amax(dim=2).sum()) * warp
    in_place = float(g.sum(dim=0).amax(dim=1).sum()) * warp
    return useful / nested, useful / in_place


def schedule_share(scene, camera, spp: int, base_key, cfg, lanes: int, sample_offset: int = 0,
                   search=None, pair_ops=None) -> dict:
    """The plain static wavefront (the bounce kernel's plain version) over
    these paths, with counts: image and rays as _run_wavefront returns
    them; lane_rays, the rays each lane traced (one closest-hit ray per live
    iteration, one shadow ray per live hit when NEE runs); iters, each
    path's iterations; hits, the live hits (each shaded once); nee_rays;
    visible, the shadow rays that reached the sampled light; mt_ops, when
    pair_ops(org, dirn, t_min, t_max) -> (R,) float64 is given, its sum over
    each live lane's closest-hit ray and each live hit's shadow ray; and the useful
    shares of useful_share. `search` as in megakernel.default_raycast. The
    counts stay on the device until the run ends."""
    import torch

    from pathtrace_tpu_torch.integrator.megakernel import (default_raycast,
                                                           default_shadow_raycast,
                                                           shadow_visibility)
    from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront

    num_pix = camera.width * camera.height
    raycast = default_raycast(scene, search)
    visible = shadow_visibility(default_shadow_raycast(scene, search))
    recorder = PathIterations(num_pix * spp, sample_offset * num_pix, scene.device)
    lane_rays = torch.zeros((lanes,), dtype=torch.int64, device=scene.device)
    # hits, nee_rays, visible
    counts = torch.zeros((3,), dtype=torch.int64, device=scene.device)
    mt_ops = torch.zeros((), dtype=torch.float64, device=scene.device)
    step = {}

    def counted_raycast(sc, org, dirn, t_min, t_max):
        hit = raycast(sc, org, dirn, t_min, t_max)
        step["hit"] = hit.hit
        if pair_ops is not None:
            step["closest"] = pair_ops(org, dirn, t_min, t_max)
        return hit

    def counted_visible(sc, org, dirn, t_min, t_max, light_tri):
        step["reached"] = visible(sc, org, dirn, t_min, t_max, light_tri)
        if pair_ops is not None:
            step["shadow"] = pair_ops(org, dirn, t_min, t_max)
        return step["reached"]

    def on_iteration(ray_ids, lane_iter, alive):
        recorder(ray_ids, lane_iter, alive)
        lane_rays.add_(alive.to(torch.int64))
        live_hit = alive & step["hit"]
        counts[0] += live_hit.sum()
        if "reached" in step:  # NEE ran: one shadow ray per live hit
            lane_rays.add_(live_hit.to(torch.int64))
            counts[1] += live_hit.sum()
            counts[2] += (live_hit & step["reached"]).sum()
        if pair_ops is not None:
            mt_ops.add_(torch.where(alive, step["closest"], 0.0).sum())
            if "shadow" in step:
                mt_ops.add_(torch.where(live_hit, step["shadow"], 0.0).sum())
        step.clear()

    with torch.no_grad():
        img, rays = _run_wavefront(scene, camera, spp, base_key, cfg, lanes, sample_offset,
                                   search=search, raycast_fn=counted_raycast,
                                   visible_fn=counted_visible, on_iteration=on_iteration)
    nested, in_place = useful_share(recorder.iters, lanes)
    hits, nee_rays, reached = counts.tolist()
    return {"image": img, "rays": rays, "lane_rays": lane_rays, "iters": recorder.iters,
            "hits": hits, "nee_rays": nee_rays, "visible": reached,
            "mt_ops": float(mt_ops) if pair_ops is not None else None,
            "nested": nested, "in_place": in_place}


# Least-time model of a kernel's work on one H100 SXM (NVIDIA's data sheet):
# FP32 outside the tensor cores, and HBM3. chip_smoke.py and
# tools/torch_reference_frame.py reckon every kernel's bound with it.
FP32_PEAK = 67e12   # operations/s
HBM_RATE = 3.35e12  # bytes/s
# FP32 operations, counted from the sources: the stages of one
# Möller-Trumbore test (csrc/mt.cuh), each needed only where the one before
# passed: p = dir x e2 and det (14); tvec and u where det >= EPS (8); q, v
# and u + v where 0 <= u <= det (15); 1/det and t where v >= 0 and
# u + v <= det (7) (mt_pair_ops counts them from a run's rays). One sphere
# test (intersect_spheres_all), one ray-cell slab test (two corner
# subtractions and products, 12). Integer work (Philox) is not counted, so
# the bound stays a least time.
MT_STAGE_OPS = (14, 8, 15, 7)
SPHERE_OPS, SLAB_OPS = 28, 12
# One bounce's shading of a gltfpbr surface (the room's walls), counted by
# hand from csrc/bsdf.cuh and csrc/bounce_kernel.cu function by function:
# + - * / and sqrt count 1, and so does each special function (powf, sinf,
# cosf, atanf); comparisons, selects, min, max and abs count 0; a value a
# function computes twice counts once (dot(n, wi) in eval_gltfpbr). Parts:
# dot 5, cross 9, normalize 10, lerp 10, fresnel_schlick 21 (16 when it
# shares its sqlen test), microfacet_distribution 13, microfacet_shadowing
# 41 (31 when it shares the eval's two dots). The sample is the diffuse
# branch, which the walls take for all but their small Fresnel share.
# SHADE_PARTS is charged to every shaded hit; NEE_VISIBLE_PARTS, NEE's BSDF
# term, only to a hit whose shadow ray reaches the sampled light: the
# kernel's nee() returns before it otherwise.
SHADE_PARTS = {
    "hit frame (barycentric interpolation, three normalizes, hit point)": 90,
    "emission test": 5,
    "NEE light sample": 41,
    "sample_gltfpbr (Fresnel mean 34, cosine hemisphere 34)": 68,
    "eval_gltfpbr": 147,
    "pdf_gltfpbr": 84,
    "dead-sample test": 5,
    "weight, next ray, Russian roulette": 25,
}
NEE_VISIBLE_PARTS = {
    "cos_a and pdf": 20,
    "eval_gltfpbr": 147,
    "contribution": 16,
}
SHADE_OPS = sum(SHADE_PARTS.values())  # 465
NEE_VISIBLE_OPS = sum(NEE_VISIBLE_PARTS.values())  # 183
RAY_BYTES = 32      # org, dir, t_min, t_max: float32
HIT_BYTES = 17      # hit (1), t, u, v, idx (4 each)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of ops at FP32_PEAK and bytes at
    HBM_RATE."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def mt_pair_ops(table, org, dirn):
    """(R,) float64: the FP32 operations that the Möller-Trumbore tests of
    each ray against the rows [v0 | e1 | e2] of `table` need, stage by stage
    (MT_STAGE_OPS); the kernels run all four stages for every pair."""
    import torch

    from pathtrace_tpu_torch.utils.math3 import EPS

    v0, e1, e2 = (table[None, :, i:i + 3] for i in (0, 3, 6))
    rows = max(1, (1 << 22) // max(table.shape[0], 1))
    out = []
    for i in range(0, org.shape[0], rows):
        o, d = org[i:i + rows, None, :], dirn[i:i + rows, None, :]
        p = torch.linalg.cross(d.expand(-1, table.shape[0], -1), e2.expand(d.shape[0], -1, -1))
        det = (p * e1).sum(-1)
        tvec = o - v0
        u = (p * tvec).sum(-1)
        v = (torch.linalg.cross(tvec, e1.expand_as(tvec)) * d).sum(-1)
        s1 = det >= EPS
        s2 = s1 & (u >= 0) & (u <= det)
        s3 = s2 & (v >= 0) & (u + v <= det)
        a, b, c, e = MT_STAGE_OPS
        out.append((a + b * s1.double() + c * s2.double() + e * s3.double()).sum(-1))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.float64, device=org.device)


def kd_walk_ops(clusters, org, dirn, t_min, t_max):
    """(R,) float64: the FP32 operations the KD walk of each ray on [t_min,
    t_max] needs (the bounce kernel's KD variant, kernel B2): a slab test of
    every cell, and the Möller-Trumbore stages (mt_pair_ops) over the
    members of each cell the segment crosses no later than its hit (every
    crossed cell on a miss), which the walk's exit cannot skip."""
    import torch

    from pathtrace_tpu_torch.accel.binned import safe_inv_dir, slab_all
    from pathtrace_tpu_torch.ops.kd_raycast import kd_closest_plain

    hit, t, _, _, _ = kd_closest_plain(clusters, org, dirn, t_min, t_max, "shadow")
    cross, tnear = slab_all(org, safe_inv_dir(dirn), clusters.bmin, clusters.bmax, t_min, t_max)
    need = cross & (tnear <= torch.where(hit, t, torch.full_like(t, float("inf")))[:, None])
    ops = torch.full((org.shape[0],), float(clusters.num_clusters * SLAB_OPS),
                     dtype=torch.float64, device=org.device)
    for m, (start, count) in enumerate(zip(clusters.prim_start.tolist(),
                                           clusters.prim_count.tolist())):
        rays = need[:, m].nonzero()[:, 0]
        if rays.numel() and count:
            ops.index_add_(0, rays, mt_pair_ops(clusters.members[start:start + count],
                                                org[rays], dirn[rays]))
    return ops


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) dataclass."""
    import dataclasses

    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def b1_ops(scene, need: dict) -> float:
    """The bounce kernel's FP32 operations on the paths that schedule_share
    counted (`need`, with pair_ops = mt_pair_ops over the scene's search
    table, or kd_walk_ops over its KD cells for the KD variant): the
    Möller-Trumbore stages (and slab tests) each ray needs, a sphere test per
    ray and sphere, one shading per hit, and NEE's BSDF term per shadow ray
    that reached the light."""
    return (need["mt_ops"] + need["rays"] * scene.num_spheres * SPHERE_OPS
            + need["hits"] * SHADE_OPS + need["visible"] * NEE_VISIBLE_OPS)


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.utils import rng
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    camera = procedural.default_camera(256, 256)
    key = rng.iter_key(rng.make_key(0), 1000)
    cfg = IntegratorConfig()
    which = os.environ.get("PROFILE_SCENE", "cornell")
    if which == "train":
        spp = int(os.environ.get("PROFILE_SPP", 8))
        job = (f"train step cornell+spheres 128x128@{spp}spp lanes {bench.TRAIN_LANES} "
               f"chunk {bench.TRAIN_CHUNK}")
        camera = procedural.default_camera(128, 128)
        step = bench.make_train_step(dev)

        def run(n):  # (image, rays): the step counts no rays
            loss, grads, img = step(n)
            bench.check_train_output(loss, grads, img)
            return img, None
    elif which == "mesh":
        scene = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024).to(dev)
        spp, job = 8, f"blob82k 256x256@8spp wavefront-kd lanes {bench.MESH_LANES}"

        def run(n):
            return render_wavefront_chunked(scene, camera, n, key, cfg, bench.MESH_LANES,
                                            chunk_spp=n, device=dev)
    elif which == "cornell":
        scene = procedural.cornell_box_scene(include_spheres=True).to(dev)
        spp, job = 1024, "cornell+spheres 256x256@1024spp fused"

        def run(n):
            return bk.render_wavefront_fused(scene, camera, n, key, cfg,
                                             lanes=bk.auto_fused_config(256 * 256),
                                             chunk_spp=min(n, 256), device=dev)
    else:
        raise ValueError(f"PROFILE_SCENE={which!r}: cornell, mesh or train")

    run(1 if which == "train" else 4)  # warm-up: builds the kernel library, launches it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(spp)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img, rays = run(spp)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("non-finite pixels in the profiled image")
    num_paths = camera.width * camera.height * spp
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(json.dumps({
        "job": job,
        "wall_ms": wall_ms,
        "profiled_wall_ms": prof_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "profiled_idle_share": 1 - busy_ms / prof_wall_ms,
        "device_launches": sum(e.count for e in kernels),
        "paths_per_sec": num_paths / wall_ms * 1e3,
        "rays_per_path": None if rays is None else rays / num_paths,
        "top_kernels": [{"name": e.key, "device_ms": e.self_device_time_total / 1e3,
                         "launches": e.count} for e in kernels[:6]],
        "port_kernels": [{"name": e.key, "device_ms": e.self_device_time_total / 1e3,
                          "launches": e.count,
                          "busy_share": e.self_device_time_total / 1e3 / busy_ms}
                         for e in kernels if "pt::" in e.key],
        "card": bench.nvidia_smi_line(),
    }))


if __name__ == "__main__":
    main()
