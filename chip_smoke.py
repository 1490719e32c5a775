"""GPU smoke run of the PyTorch/CUDA port (pathtrace_tpu_torch).

    python3 chip_smoke.py

Drives the port's three paths on one NVIDIA GPU: the main path, the Cornell
box with two spheres at 256x256 @ 1024 spp through the fused engine's CUDA
bounce kernel (the call `cli render --engine fused` makes); the mesh path,
blob82k at 256x256 @ 64 spp through the wavefront engine and the KD raycast
kernel (the call `BENCH_SCENE=mesh` benchmarks); and the training path, one
train step on Cornell + spheres at 128x128 @ 64 spp whose recording sweep
runs the all-triangles closest-hit kernel (the call `BENCH_SCENE=train`
benchmarks). Phases, one line each (or one per comparison):

  1. environment: torch, CUDA, nvcc, the card's name and power limit;
     fails unless the card is compute capability 9.0 (Hopper);
  2. build: compiles csrc/*.cu with nvcc (seconds);
  3. kernel vs its plain PyTorch version on the card, at the JAX package's
     bars between its engines (tests/test_fused.py), and bit-equal (image
     and rays);
  4. main path: the 256^2 @ 1024 spp render on the kernel (launch count,
     finite image, rays per path, mean within 2% of the plain version at
     32 spp, seconds, paths/s, rays/s); the kernel against its plain version
     at the main path's scene, film and lanes at 32 spp (times; bit-equal
     image and rays); from that plain run, each path's iterations and the
     useful warp-iteration share of the nested and the in-place schedule
     (profile_main.schedule_share), beside the kernel's registers, spills and
     resident blocks per SM; then the CLI once as a subprocess;
  5. the mesh path: blob82k (the 82k-triangle OBJ asset in the Cornell
     room, KD cells of 1024) through the wavefront engine and the KD
     raycast kernel. First the kernel against its plain version on
     blob82k and on sphere_mesh_scene(4) with cells of 128: 65,536 camera
     rays at 256x256, 65,536 rays leaving the surface, 65,536 shadow rays
     and 16,384 rays of each edge set (kd_raycast.edge_rays), in both
     modes, hit, t, u, v and prim_id bit-equal; on blob82k each probe set's
     kernel ms, bound, kernel over bound, plain ms and MT tests issued and
     needed, and the kernel's registers and resident warps per SM. Then
     256x256 @ 64 spp in chunks of 64 spp at the bench's lanes
     (launch count, finite image, rays per path, seconds, paths/s, rays/s);
     the same path through the plain version at 4 spp (times; image and
     rays bit-equal, means within 2%); 48x48 @ 4 spp
     against the committed golden (tests/golden/blob82k_48x48_4spp_seed11.npy,
     at tools/tpu_cpu_agreement.py's bar); then `cli render --preset
     mesh512` at 64x64 @ 4 spp as a subprocess.
  6. the training path: the all-triangles kernel against its plain version
     on 65,536 camera rays at 256x256 on Cornell + spheres, 65,536 rays
     leaving the surface and 65,536 shadow rays, camera rays on the
     1,294-triangle sphere_mesh_scene(3) (two shared-memory tiles) and the
     5,134-triangle sphere_mesh_scene(4) (six), 1,048,576 camera rays, one
     per lane of the train step's recording sweep, random rays in ragged
     counts (1, 31, 65,537) and on an empty table (a scene without
     triangles), in both modes: hit and idx bit-equal, t/u/v bit-equal where
     hit; times (the kernel's as the mean of 20 launches). Then the inputs
     of every launch of one recording sweep of the train step at 128x128 @
     64 spp (bench.train_sweep_searches): each launch bit-equal to the plain
     version, the sweep's kernel ms (mean of 20 sweeps), its bound and the
     kernel over the bound. Then one train step at 128x128 @ 64 spp after a
     warm-up (launch counts of B3 and of the material gathers and
     backwards, seconds, paths/s, finite loss and grads), and one more
     under torch.profiler: its device time by kernel, the material kernels'
     share, and no PyTorch index backward left; the
     step at 4 spp through the kernel and through the plain search (loss and
     grads within 1e-5 relative per field); wavetape grads against the
     lockstep scan-AD grads at 24x24 @ 8 spp (per field, max error over the
     field's max below 1e-3); then `cli grad-check` at 16x16 @ 4 spp as a
     subprocess. The material gather and its gradient (csrc/mat_gather.cu)
     at the train step's shape, 262,144 lanes of a taped bounce against the
     38-row triangle and 2-row sphere tables, 12 floats: forward bit-equal
     to plain indexing, the backward bit-identical over two runs and within
     1e-4 of the terms' magnitude of PyTorch's index backward (the largest
     absolute difference of either is max_abs_err); the kernels'
     event and device ms, the plain version's and PyTorch's index backward's
     (library_ms), the bound (bytes at 3.35 TB/s). A scene of spheres
     alone (procedural.sphere_only_scene: no triangle, no light) at 64x64
     @ 8 spp through the wavefront on the all-triangles kernel and through
     the fused kernel, each bit-equal to the plain wavefront (image and
     rays), finite, mean above 0. Last, `cli
     render` as a subprocess, the same render two ways, --out-npy bit for
     bit: 4 passes straight, and 2 passes with --checkpoint then --resume
     --passes 4, on --engine fused and --engine wavefront; and one --no-nee
     render, which must exit 0.
  7. pixel-slice sharding (parallel/mesh.py) on a NCCL group of world size
     1: render_fused_sharded at the main path's width (Cornell + spheres
     256x256 @ 1024 spp, one launch of the bounce kernel keyed by global
     path ids: launch count, seconds, paths/s, mean within 2% of phase 4's);
     the slice bodies for N = 2 and 4 run in turn at 256x256 @ 64 spp with
     65,536 / N lanes, bit-equal to the whole film and rays; the kernel on
     slices with pix_offset != 0 at 32x32 @ 16 spp against its plain
     version, bit-equal; its registers and warps per SM no worse than before
     pixel slices (108 and 16 on sm_90a).
     train_step_wavetape_sharded at 128x128 @ 64 spp (all-triangles kernel
     launches, seconds) bit-equal to train_step_wavetape in loss, grads and
     image. render_wavefront_sharded on sphere_mesh_scene(6) with KD cells
     (multihost1024's scene) at 256x256 @ 8 spp (KD kernel launches,
     paths/s), its 2 slices bit-equal. The native SAH BVH build of that
     scene (seconds); raycast_bvh against the all-triangles kernel on
     65,536 Cornell camera rays (the same hits, spheres and t; exact ties
     resolved the other way counted); a JSON scene (walls, box, icosphere,
     sphere, assets/blob82k.obj) loaded with its BVH and KD cells and
     rendered at 64x64 @ 16 spp through the KD kernel, bit-equal to the
     plain search.
  8. the device-validation tools (tools/torch_*.py) at small depth: the
     reference's own job at its full resolution, 1080x2400 (Cornell +
     spheres through the fused engine, 2,592,000 lanes), 2 passes x 4 spp,
     straight and with the accumulator reloaded from its checkpoint after
     pass 1, bit-equal (paths/s, B1 launches, a valid PNG); B1 against its
     plain version on that whole frame in one launch of 2,592,000 lanes, one
     pixel a lane, at the sample whose path ids cross 2**31, and on a
     65,536-pixel slice of it at 2 spp across 2**31, bit-equal, and ids
     past 2**32 refused before any launch; mesh gradients, the wavetape
     against scan-AD on blob82k with KD cells of 1024 at 32x32 @ 4 spp
     through B2 (per field below 1e-3, the primals within 1e-3, B2
     launches; the material backward over 641 tiles), and both again
     through the plain KD search (primals bit-equal, grads within 1e-5);
     forward mode against reverse mode on a
     random tangent of the six material fields at 16x16 @ 4 spp through B3
     (below 1e-3, B3 launches), and the forward mode again through the
     plain search (bit-equal); the five rows of
     tools/torch_card_cpu_agreement.py against the committed CPU goldens;
     the phase's seconds.
  9. scaling (tools/torch_scaling_bench.py as a subprocess, under `torchrun
     --nproc_per_node=1`: a NCCL group of one) at small depth: the main path
     at 256x256 @ 64 spp, the mesh path at 64x64 @ 4 spp, the train step at
     32x32 @ 8 spp, each row after its check pass (bit-equal to the
     one-process call) with the kernel's launches in the timed run; B1, B2
     and B3 against their plain versions on the rank's card (and, with more
     than one card, from the launcher on every card); the six sharded entry
     points against one process; the collectives' ms; the phase's seconds.
     With more than one card the sweep goes up to their count; on one card
     the N > 1 rows come from docs/torch_scaling_bench.json (a four-card
     run of the tool).

Phases 3 and 4 hold the fused kernel against the wavefront through the
plain searches only. It then prints the card line, a JSON line describing
each kernel (times, the plain version's time, and the bound: the least time
the card could take for the kernel's work at its FP32 peak and memory rate,
from this run's inputs), and last {"ok": true, "device": {...}}. Any
failure raises (non-zero exit) and no result line is printed. Needs no
network; imports no JAX.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the least-time model of every kernel's work (FP32 peak and HBM rate of one
# H100 SXM, operations counted from the sources)
from pathtrace_tpu_torch.profile_main import (HIT_BYTES, RAY_BYTES, SLAB_OPS,  # noqa: E402
                                              b1_ops, bound, mt_pair_ops, tensor_bytes)


def fail(msg: str):
    raise RuntimeError(msg)


# The bounce kernel as ptxas built it for sm_90a before it took pixel slices
# (global path ids): a thread's registers and the resident warps per SM on
# the main path's pack. The slice arithmetic must not cost the whole-image
# launch either.
B1_MAX_REGISTERS, B1_MIN_WARPS_PER_SM = 108, 16


def timed_launches(fn, n: int = 20) -> float:
    """Mean milliseconds of n calls of fn() after one warm-up call, between
    two synchronized CUDA events."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20) -> dict:
    """{kernel name: device milliseconds a call of fn()}, under
    torch.profiler over n calls after one warm-up call: the device's own
    time, which the event times above exceed wherever the host launches
    more slowly than the card runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def timed(fn):
    """(result, milliseconds) of fn() between two synchronized CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_png(path: str, width: int, height: int) -> None:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, dims = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(tag + body):
            fail(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            dims = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if dims != (width, height) or len(zlib.decompress(idat)) != height * (1 + 3 * width):
        fail(f"{path}: IHDR {dims} or pixel data does not match {width}x{height} RGB")


def run_cli(args: list, out: str, size: int, tag: str) -> None:
    """`cli render` as a subprocess; fails unless it exits 0 and writes a
    valid size x size PNG to `out`."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch.cli", "render", *args,
                           "--out", out], cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"cli render exited {proc.returncode}:\n{proc.stderr}")
    check_png(out, size, size)
    print(f"[{tag}] render {' '.join(args)}: exit 0, valid {size}x{size} PNG, "
          f"{time.perf_counter() - t0:.1f} s; {proc.stdout.strip().splitlines()[-1]}",
          flush=True)


def kd_bound(clusters, org, dirn, t_min, t_max, hit, t) -> tuple[float, str, float]:
    """(bound_ms, bound_by, MT tests) of the KD raycast on these rays: the
    slab test of every cell and the MT tests of the members of each cell a
    ray crosses no later than its hit (every crossed cell on a miss), which
    is what the early exit cannot skip, each charged the stages it needs
    (mt_pair_ops); bytes: the rays, their results, and the cell and member
    tables once."""
    import torch

    from pathtrace_tpu_torch.accel.binned import safe_inv_dir, slab_all

    cross, tnear = slab_all(org, safe_inv_dir(dirn), clusters.bmin, clusters.bmax, t_min, t_max)
    reach = torch.where(hit, t, torch.full_like(t, float("inf")))
    need = cross & (tnear <= reach[:, None])
    tests = (need.double() @ clusters.prim_count.double()).sum().item()
    mt_ops = 0.0
    for m, (start, count) in enumerate(zip(clusters.prim_start.tolist(),
                                           clusters.prim_count.tolist())):
        rays = need[:, m].nonzero()[:, 0]
        if rays.numel() and count:
            mt_ops += mt_pair_ops(clusters.members[start:start + count], org[rays],
                                  dirn[rays]).sum().item()
    r = org.shape[0]
    ops = mt_ops + r * clusters.num_clusters * SLAB_OPS + 3 * r
    return (*bound(ops, r * (RAY_BYTES + HIT_BYTES) + tensor_bytes(clusters)), tests)


def kd_compare(scenes: dict, cam) -> tuple[float, float, float, tuple]:
    """[5 kd compare]: the KD kernel against its plain version on the card,
    hit, t, u, v and prim_id bit-equal on every ray, in both modes, on each
    KD scene: 65,536 camera, surface and shadow rays (probe_rays) and 16,384
    rays of each edge set (edge_rays). On blob82k, for each probe set and
    mode: the kernel's ms (one launch, as the kernels line has always
    timed it, and the mean of 20 back-to-back launches), its bound
    (kd_bound) and the kernel over the bound, the plain version's ms, and
    the MT tests and slab tests the walk issues (kd_walk_counts) against
    the MT tests the bound needs; then the kernel's registers and resident
    warps per SM. Returns the kernel's single-launch and the plain
    version's ms for the camera rays in closest mode (the wavefront's first
    bounce at 256x256), the largest t/u/v difference over every compared
    ray, and kd_bound of those rays."""
    import torch

    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel

    timing, max_err = None, 0.0
    for scene_name, scene in scenes.items():
        cl = scene.clusters
        sets = kd.probe_rays(scene, cam, cam.width * cam.height, seed=3)
        sets.update(kd.edge_rays(scene, 16384, seed=1))
        for name, args in sets.items():
            probe = name in ("camera", "surface", "shadow")
            timed_here = probe and scene_name == "blob82k"
            if timed_here:
                counts = kd.kd_walk_counts(cl, *args)
            for mode in kd.MODES:
                k, k_ms = timed(lambda: kd.kd_closest(cl, *args, mode))
                p, p_ms = timed(lambda: kd.kd_closest_plain(cl, *args, mode))
                if k[0].numel():
                    max_err = max(max_err, *((a - b).abs().max().item()
                                             for a, b in zip(k[1:4], p[1:4])))
                for field, a, b in zip(("hit", "t", "u", "v", "prim_id"), k, p):
                    if not torch.equal(a, b):
                        fail(f"KD kernel is not bit-equal to its plain version: {field} "
                             f"differs on {int((a != b).sum())} of {a.numel()} {name} rays "
                             f"({scene_name}, {mode})")
                line = (f"[5 kd compare] {scene_name} {name} rays {args[0].shape[0]} {mode}: "
                        f"hit rate {p[0].double().mean().item():.4f}, bit-equal")
                if timed_here:
                    mean_ms = timed_launches(lambda: kd.kd_closest(cl, *args, mode))
                    if mode == "closest":
                        b_ms, b_by, need = kd_bound(cl, *args, p[0], p[1])
                    per_ray = lambda x: x.double().mean().item()
                    line += (f"; kernel {k_ms:.4f} ms one launch, {mean_ms:.4f} ms mean of 20; "
                             f"bound {b_ms:.6f} ms ({b_by}), kernel/bound {k_ms / b_ms:.1f}x "
                             f"(mean of 20: {mean_ms / b_ms:.1f}x); plain {p_ms:.3f} ms; MT "
                             f"tests issued {per_ray(counts['tests']):.1f} a ray, needed "
                             f"{need / args[0].shape[0]:.1f}; slab tests "
                             f"{per_ray(counts['slab']):.1f} a ray; cells visited "
                             f"{per_ray(counts['visits']):.3f} a ray")
                    if (name, mode) == ("camera", "closest"):
                        timing = (k_ms, p_ms, (b_ms, b_by, need))
                print(line, flush=True)
    occ = kd_kernel.occupancy(scenes["blob82k"].clusters.num_clusters)
    print(f"[5 kd compare] kernel, {kd_kernel.TEAM} threads a ray: {occ['registers']} registers, "
          f"{occ['local_bytes']} B local memory a thread, {occ['blocks_per_sm']} resident "
          f"blocks of {occ['block']} ({occ['warps_per_sm']} warps) per SM", flush=True)
    print(f"[5 kd compare] max abs err t/u/v over every compared ray {max_err:.3e}", flush=True)
    return timing[0], timing[1], max_err, timing[2][:2]


def mesh_phase(smi: str) -> dict:
    """Phase 5, the mesh path; returns its kernels-line entry."""
    import numpy as np
    import torch

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import (render_wavefront_chunked,
                                                          render_wavefront_stats)
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel
    from pathtrace_tpu_torch.utils import rng

    t0 = time.perf_counter()
    mesh = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024).to("cuda")
    print(f"[5 mesh] blob82k: {mesh.num_tris} triangles, {mesh.clusters.num_clusters} KD "
          f"cells, {mesh.clusters.num_members} member slots, loaded and built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cam = procedural.default_camera(256, 256)
    spheres = procedural.sphere_mesh_scene(4).with_kd_binned(max_tris=128).to("cuda")
    k_ms, p_ms, max_err, (b_ms, b_by) = kd_compare({"sphere_mesh": spheres, "blob82k": mesh},
                                                   cam)

    # the mesh path: what `BENCH_SCENE=mesh` runs
    cfg = IntegratorConfig()
    key = rng.make_key(0)
    lanes, spp = bench.MESH_LANES, 64
    kd_kernel.LAUNCHES = bk.LAUNCHES = 0
    (img, rays), ms = timed(lambda: render_wavefront_chunked(
        mesh, cam, spp, key, cfg, lanes, chunk_spp=64, device="cuda"))
    launches = kd_kernel.LAUNCHES
    paths = 256 * 256 * spp
    print(f"[5 mesh] blob82k 256x256@{spp}spp lanes {lanes}: {launches} KD kernel launches "
          f"({bk.LAUNCHES} bounce kernel), {ms / 1e3:.4f} s, "
          f"{paths / ms * 1e3 / 1e6:.4f}M paths/s, {rays / ms * 1e3 / 1e6:.3f}M rays/s, "
          f"{rays / paths:.4f} rays/path, mean {img.mean().item():.6f} on {smi}", flush=True)
    if launches < 1:
        fail("the mesh path launched no KD raycast kernel")
    if not bool(torch.isfinite(img).all()):
        fail("non-finite pixels in the mesh-path image")
    if not 1.0 <= rays / paths <= 2 * cfg.max_iters:
        fail(f"rays per path {rays / paths} outside [1, {2 * cfg.max_iters}]")

    # the same scene, film and lanes at 4 spp through the kernel and through
    # the plain search: the same winners, and at these static lanes one film
    # slot a lane (no atomics), so the same image and rays bit for bit
    (k_img, k_rays), k4_ms = timed(lambda: render_wavefront_stats(
        mesh, cam, 4, key, cfg, lanes, device="cuda"))
    (p_img, p_rays), p4_ms = timed(lambda: render_wavefront_stats(
        mesh, cam, 4, key, cfg, lanes, device="cuda", search=kd.kd_closest_plain))
    agree = torch.isclose(k_img, p_img, rtol=1e-3, atol=1e-3).double().mean().item()
    rays_rel = abs(k_rays - p_rays) / p_rays
    main_rel = abs(img.mean().item() - p_img.mean().item()) / p_img.mean().item()
    print(f"[5 mesh] 256x256@4spp lanes {lanes}: kernel {k4_ms:.3f} ms, plain {p4_ms:.3f} ms "
          f"({p4_ms / k4_ms:.1f}x); pixel agreement {agree:.6f} at 0.001, max abs err "
          f"{(k_img - p_img).abs().max().item():.3e}, rays {k_rays} vs {p_rays} (rel "
          f"{rays_rel:.3e}); mean rel diff main@64 vs plain@4 {main_rel:.3e}", flush=True)
    if not (torch.equal(k_img, p_img) and k_rays == p_rays):
        fail("the mesh path through the kernel is not bit-equal to its plain version")
    if main_rel > 0.02:
        fail("mesh-path image mean is not within 2% of the plain version's")

    # the committed golden, at tools/tpu_cpu_agreement.py's bar
    ref = np.load(os.path.join(REPO, "tests", "golden", "blob82k_48x48_4spp_seed11.npy"))
    g_img, _ = render_wavefront_stats(mesh, procedural.default_camera(48, 48), 4,
                                      rng.make_key(11), cfg, 2304, device="cuda")
    g_img = g_img.cpu().numpy()
    g_agree = np.isclose(g_img, ref, rtol=5e-3, atol=5e-3).mean()
    g_rel = abs(g_img.mean() - ref.mean()) / ref.mean()
    print(f"[5 mesh] golden blob82k 48x48@4spp: pixel agreement {g_agree:.6f} at 5e-3, "
          f"mean rel {g_rel:.3e}", flush=True)
    if g_agree <= 0.995 or g_rel > 1e-3:
        fail("the mesh path disagrees with the committed blob82k golden")

    with tempfile.TemporaryDirectory() as tmp:
        run_cli(["--preset", "mesh512", "--width", "64", "--height", "64", "--spp", "4"],
                os.path.join(tmp, "mesh512.png"), 64, "5 cli")

    return {"name": "kd_raycast", "route": "cuda",
            "source": "pathtrace_tpu_torch/csrc/kd_raycast.cu",
            "replaces": "pathtrace_tpu/ops/pallas/pair_kernel.py:142",
            "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def mt_compare(scene, sets: dict, tag: str) -> dict:
    """[6 mt compare]: the all-triangles kernel against its plain version on
    the card, both modes: hit and idx bit-equal, t/u/v bit-equal where hit.
    The kernel's time is the mean of 20 launches (one launch of 65,536 rays
    lasts about as long as its launch overhead). Returns {(set, mode):
    (kernel ms, plain ms, max abs err of t/u/v)}."""
    import torch

    from pathtrace_tpu_torch.ops import mt_closest as mt

    times = {}
    for name, args in sets.items():
        for mode in mt.MODES:
            k_hit, *k = mt.mt_closest(scene.tris, *args, mode)
            k_ms = timed_launches(lambda: mt.mt_closest(scene.tris, *args, mode))
            (p_hit, *p), p_ms = timed(lambda: mt.mt_closest_plain(scene.tris, *args, mode))
            k_t, k_idx, k_u, k_v = (x[p_hit] for x in k)
            p_t, p_idx, p_u, p_v = (x[p_hit] for x in p)
            equal = (torch.equal(k_hit, p_hit) and torch.equal(k_idx, p_idx)
                     and all(torch.equal(a, b) for a, b in ((k_t, p_t), (k_u, p_u), (k_v, p_v))))
            err = max(((a - b).abs().max().item() if a.numel() else 0.0)
                      for a, b in ((k_t, p_t), (k_u, p_u), (k_v, p_v)))
            print(f"[6 mt compare] {tag} {name} rays {args[0].shape[0]} x {scene.num_tris} "
                  f"triangles {mode}: hit rate {p_hit.double().mean().item():.4f}, bit-equal "
                  f"{equal}, max abs err t/u/v {err:.3e}; kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms ({p_ms / k_ms:.1f}x)", flush=True)
            if not equal:
                fail(f"the all-triangles kernel disagrees with its plain version ({tag} {name} "
                     f"{mode})")
            times[name, mode] = (k_ms, p_ms, err)
    return times


def grad_errors(ref, mine) -> dict:
    """{field: max |ref - mine| / max |ref|} over both material tables."""
    from pathtrace_tpu_torch.diff.grad import MAT_FIELDS

    out = {}
    for table, a, b in (("tri", ref[0], mine[0]), ("sph", ref[1], mine[1])):
        for f in MAT_FIELDS:
            x, y = getattr(a, f).double(), getattr(b, f).double()
            out[f"{table}.{f}"] = ((x - y).abs().max() / x.abs().max().clamp(min=1e-6)).item()
    return out


def train_phase(smi: str) -> dict:
    """Phase 6, the training path; returns its kernels-line entry."""
    import torch

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.diff import material_grads, material_grads_wavetape
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.ops.cuda import mat_gather as mg_kernel
    from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel
    from pathtrace_tpu_torch.utils import rng

    # (a) the kernel against its plain version: camera rays at 256x256
    # (65,536), bounce rays, NEE rays; tables of two and six tiles; the
    # train step's launch shape, one ray per recording lane (1,048,576
    # camera rays at 1024x1024, the sweep's first bounce); ragged ray
    # counts; an empty table

    def random_rays(count: int, seed: int):
        g = torch.Generator().manual_seed(seed)
        org = (torch.rand((count, 3), generator=g) * 70.0 - 25.0).to("cuda")
        d = torch.nn.functional.normalize(torch.randn((count, 3), generator=g), dim=1)
        return (org, d.to("cuda"), torch.zeros((count,), device="cuda"),
                (torch.rand((count,), generator=g) * 80.0).to("cuda"))

    scene = procedural.cornell_box_scene(include_spheres=True).to("cuda")
    cam = procedural.default_camera(256, 256)
    sets = kd.probe_rays(scene, cam, cam.width * cam.height, seed=3)
    mt.mt_closest(scene.tris, *sets["camera"], "closest")  # loads the library
    times = mt_compare(scene, sets, "cornell+spheres")
    big = procedural.sphere_mesh_scene(3).to("cuda")
    times.update(mt_compare(big, {"mesh camera": kd.probe_rays(big, cam, 4, seed=3)["camera"]},
                            "sphere_mesh3"))
    tiles = procedural.sphere_mesh_scene(4).to("cuda")
    times.update(mt_compare(tiles, {"mesh camera": kd.probe_rays(tiles, cam, 4, seed=3)["camera"]},
                            "sphere_mesh4"))
    side = int(bench.TRAIN_LANES ** 0.5)
    lanes_set = kd.probe_rays(scene, procedural.default_camera(side, side), 4, seed=3)["camera"]
    times.update(mt_compare(scene, {"lanes camera": lanes_set}, "cornell+spheres"))
    times.update(mt_compare(scene, {f"random {n}": random_rays(n, n) for n in (1, 31, 65537)},
                            "cornell+spheres"))
    times.update(mt_compare(procedural.sphere_only_scene().to("cuda"),
                            {"random": random_rays(4096, 7)}, "empty table"))
    max_err = max(e for _, _, e in times.values())
    r, n = lanes_set[0].shape[0], scene.num_tris
    l_ms = times["lanes camera", "closest"][0]
    ops = mt_pair_ops(scene.tris.search_table, lanes_set[0], lanes_set[1]).sum().item()
    b_ms, b_by = bound(ops, r * (RAY_BYTES + HIT_BYTES) + n * 9 * 4)
    print(f"[6 mt compare] bound of {r} camera rays x {n} triangles: {ops:.4e} FP32 operations "
          f"needed ({ops / (r * n):.2f} a pair), {b_ms:.6f} ms ({b_by}); the kernel takes "
          f"{l_ms / b_ms:.1f}x its bound", flush=True)

    # the kernel on its path's own inputs: every launch of one recording
    # sweep of the train step, bit-equal to the plain version, timed as the
    # mean of 20 sweeps, against the bound of the same rays
    _, sweep = bench.train_sweep_searches("cuda")
    table = scene.tris.search_table
    p_ms = ops = nbytes = 0.0
    for *args, mode in sweep:
        k = mt.mt_closest(scene.tris, *args, mode)
        p, ms = timed(lambda: mt.mt_closest_plain(scene.tris, *args, mode))
        p_ms += ms
        if not all(torch.equal(a, b) for a, b in zip(k, p)):
            fail(f"the all-triangles kernel disagrees with its plain version on a train-sweep "
                 f"launch ({mode})")
        ops += mt_pair_ops(table, args[0], args[1]).sum().item()
        nbytes += args[0].shape[0] * (RAY_BYTES + HIT_BYTES) + tensor_bytes(table)

    def run_sweep():
        for *args, mode in sweep:
            mt.mt_closest(scene.tris, *args, mode)

    launches_a_sweep = len(sweep)
    k_ms = timed_launches(run_sweep) / launches_a_sweep
    p_ms /= launches_a_sweep
    b_ms, b_by = bound(ops / launches_a_sweep, nbytes / launches_a_sweep)
    print(f"[6 mt sweep] {launches_a_sweep} launches of one recording sweep at 128x128@64spp "
          f"({sweep[0][0].shape[0]} rays x {n} triangles each), every one bit-equal: kernel "
          f"{k_ms:.5f} ms a launch ({k_ms * launches_a_sweep:.4f} ms a sweep, mean of 20 sweeps), "
          f"plain {p_ms:.3f} ms a launch; bound {b_ms:.6f} ms a launch ({b_by}; "
          f"{ops / launches_a_sweep:.4e} FP32 operations needed, "
          f"{ops / (launches_a_sweep * sweep[0][0].shape[0] * n):.2f} a pair); the kernel takes "
          f"{k_ms / b_ms:.1f}x its bound; {mt_kernel.occupancy(n)} on {smi}", flush=True)
    del sweep

    # (b) the training path: one step at the production shape after a warm-up
    step = bench.make_train_step("cuda")
    step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # phase 6a's ray sets, the scenes
    spp, paths = 64, 128 * 128 * 64
    mt_kernel.LAUNCHES = 0
    mg_kernel.GATHER_LAUNCHES = mg_kernel.SCATTER_LAUNCHES = 0
    (loss, grads, img), ms = timed(lambda: step(spp))
    launches = mt_kernel.LAUNCHES
    mat_launches = {"gather": mg_kernel.GATHER_LAUNCHES, "scatter": mg_kernel.SCATTER_LAUNCHES}
    print(f"[6 train] train step cornell+spheres 128x128@{spp}spp lanes {bench.TRAIN_LANES} "
          f"chunk {bench.TRAIN_CHUNK}: {launches} all-triangles kernel launches, material "
          f"gathers {mat_launches['gather']}, backwards {mat_launches['scatter']}, "
          f"{ms / 1e3:.4f} s, {paths / ms * 1e3 / 1e6:.4f}M paths/s, "
          f"loss {loss.item():.6f}, peak memory "
          f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.3f} GB above the "
          f"{held / 1e9:.3f} GB held before the step, on {smi}", flush=True)
    if launches < 1:
        fail("the training path launched no all-triangles kernel")
    if mat_launches["gather"] < 1 or mat_launches["scatter"] < 1:
        fail("the training path did not gather and sum its materials through the material "
             "kernels")
    bench.check_train_output(loss, grads, img)

    # the step's device time by kernel: no index backward of PyTorch's left
    ops = device_ms(lambda: step(spp), n=1)
    mat_ms = sum(v for k, v in ops.items() if "pt::mat_" in k)
    index_bwd = sorted(k for k in ops if "indexing_backward" in k)
    print(f"[6 train] the step's device time: busy {sum(ops.values()):.1f} ms of {ms:.1f} ms, "
          f"material kernels {mat_ms:.3f} ms "
          f"({', '.join(f'{k} {v:.3f}' for k, v in ops.items() if 'pt::mat_' in k)}), "
          f"PyTorch index backward kernels {index_bwd or 'none'}", flush=True)
    if index_bwd:
        fail("PyTorch's index backward still runs in the train step")

    # (c) the step at 4 spp through the kernel and through the plain search:
    # bit-equal winners, so equal tapes, loss and grads
    kern = bench.make_train_step("cuda")(4)
    plain = bench.make_train_step("cuda", search=mt.mt_closest_plain)(4)
    errs = grad_errors(plain[1], kern[1])
    loss_rel = abs(kern[0].item() - plain[0].item()) / plain[0].item()
    print(f"[6 train] 128x128@4spp kernel vs plain search: loss rel {loss_rel:.3e}, max grad "
          f"rel err {max(errs.values()):.3e} ({max(errs, key=errs.get)})", flush=True)
    if loss_rel > 1e-5 or max(errs.values()) > 1e-5:
        fail("the train step through the kernel disagrees with the plain search")

    # (d) wavetape grads against the lockstep scan-AD grads on the card
    cam24 = procedural.default_camera(24, 24)
    cfg, key = IntegratorConfig(), rng.make_key(0)
    g_scan = material_grads(scene, cam24, 8, key, cfg=cfg, device="cuda")
    g_tape = material_grads_wavetape(scene, cam24, 8, key, cfg, lanes=24 * 24 * 8,
                                     chunk=24 * 24 * 8, device="cuda")
    bench.check_train_output(g_scan[2], g_tape[:2], g_tape[2])
    errs = grad_errors(g_scan, g_tape)
    print(f"[6 train] 24x24@8spp wavetape vs scan-AD: max grad rel err "
          f"{max(errs.values()):.3e} ({max(errs, key=errs.get)}), all finite", flush=True)
    if max(errs.values()) > 1e-3:
        fail("wavetape grads disagree with the scan-AD grads")

    # (e) the gradient oracle as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch.cli", "grad-check",
                           "--preset", "cornell64", "--width", "16", "--height", "16",
                           "--spp", "4"], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        fail(f"cli grad-check exited {proc.returncode}:\n{proc.stderr}\n{proc.stdout}")
    report = json.loads(proc.stdout)
    print(f"[6 cli] grad-check cornell64 16x16@4spp: exit 0, pass {report['pass']}, mode "
          f"{report['mode']}, max rel err {report['max_rel_err']:.3e}, device "
          f"{report['device']}, {time.perf_counter() - t0:.1f} s", flush=True)
    if report["pass"] is not True:
        fail("cli grad-check did not pass")

    return ({"name": "mt_closest", "route": "cuda",
             "source": "pathtrace_tpu_torch/csrc/mt_closest.cu",
             "replaces": "pathtrace_tpu/ops/pallas/intersect_kernel.py:30",
             "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
            {"launches": mat_launches, "step_s": ms / 1e3, "busy_ms": sum(ops.values()),
             "mat_ms": mat_ms})


def mat_phase(smi: str, step: dict) -> dict:
    """Phase 6, the material gather and its gradient (csrc/mat_gather.cu)
    at the train step's shape: a replay chunk's 262,144 lanes at their
    second bounce (the taped triangle and sphere ids of 64x64 @ 64 spp),
    Cornell's 38-row triangle and 2-row sphere tables, six fields of 12
    floats. Forward bit-equal to plain indexing; the backward bit-identical
    over two runs and within 1e-4 of the terms' magnitude of PyTorch's
    index backward, max_abs_err the largest absolute difference of the
    forward from plain indexing and of the backward from PyTorch's; event and device times of the kernels, the plain
    version (indexing and index_add_) and PyTorch's index backward (the
    parent's path, library_ms); the bound: every byte once at 3.35 TB/s.
    Returns its kernels-line entry, with the train step's seconds and
    launch counts from train_phase."""
    import torch

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.diff.grad import MAT_FIELDS
    from pathtrace_tpu_torch.diff.wavetape import record_paths_wavefront, unpack_rec
    from pathtrace_tpu_torch.ops import mat_gather as mg
    from pathtrace_tpu_torch.ops.cuda import mat_gather as mg_kernel

    scene, camera, _, cfg, key = bench.train_problem("cuda", 64, 64)
    records, _ = record_paths_wavefront(scene, camera, 64, key, cfg, lanes=262144)
    rec = unpack_rec(records[1])
    rows, zero = rec["pid"].shape[0], torch.zeros_like(rec["pid"])
    cases = {"triangles": (scene.mat, torch.where(rec["hit"] & ~rec["sph"], rec["pid"], zero)),
             "spheres": (scene.spheres.mat, torch.where(rec["sph"], rec["pid"], zero))}
    g = torch.Generator().manual_seed(0)
    cot = [torch.randn((rows, 3) if f in ("emittance", "albedo", "specular") else (rows,),
                       generator=g).cuda() for f in MAT_FIELDS]
    total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "library_device_ms": 0.0, "bytes": 0}
    worst = max_abs = 0.0

    def abs_err(xs, ys) -> float:
        return max((a.double() - b.double()).abs().max().item() for a, b in zip(xs, ys))

    for name, (mat, idx) in cases.items():
        tables = [getattr(mat, f) for f in MAT_FIELDS]
        k = tables[0].shape[0]
        fwd_err = abs_err(mg_kernel.gather(tables, idx), mg.gather_plain(tables, idx))
        if fwd_err != 0.0:
            fail(f"the material gather is not bit-equal to plain indexing ({name})")
        first, second = mg_kernel.scatter(idx, cot, k), mg_kernel.scatter(idx, cot, k)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"the material gradient differs between two runs ({name})")
        leaves = [t.detach().clone().requires_grad_(True) for t in tables]
        outs = [t[idx.long()] for t in leaves]
        lib = lambda: torch.autograd.grad(outs, leaves, cot, retain_graph=True)
        mags = mg.scatter_plain(idx, [c.abs().double() for c in cot], k)
        want = lib()
        max_abs = max(max_abs, fwd_err, abs_err(first, want))
        for a, b, m in zip(first, want, mags):
            live = m > 0
            err = ((a.double() - b.double()).abs()[live] / m[live]).max().item()
            worst = max(worst, err)
        both = lambda: mg_kernel.scatter(idx, cot, k) + mg_kernel.gather(tables, idx)
        plain = lambda: mg.scatter_plain(idx, cot, k) + list(mg.gather_plain(tables, idx))
        k_ms, p_ms, l_ms = timed_launches(both), timed_launches(plain), timed_launches(lib)
        k_dev = device_ms(both)
        l_dev = device_ms(lib)
        mat_dev = {n: v for n, v in k_dev.items() if "pt::mat_" in n}
        nbytes = 2 * (idx.numel() * idx.element_size() + rows * 12 * 4 + k * 12 * 4)
        b_ms, b_by = bound(0.0, nbytes)
        print(f"[6 mat] {name}: {rows} lanes x {k} rows, 12 floats; forward bit-equal, "
              f"backward bit-identical over two runs; kernels {k_ms:.4f} ms (events; device "
              f"{sum(mat_dev.values()):.4f}: "
              f"{', '.join(f'{n} {v:.4f}' for n, v in mat_dev.items())}), plain {p_ms:.4f} ms, "
              f"PyTorch's index backward {l_ms:.4f} ms (device {sum(l_dev.values()):.4f}); "
              f"bound {b_ms:.5f} ms ({b_by}, {nbytes} bytes)", flush=True)
        total["ms"] += k_ms
        total["device_ms"] += sum(mat_dev.values())
        total["plain_ms"] += p_ms
        total["library_ms"] += l_ms
        total["library_device_ms"] += sum(l_dev.values())
        total["bytes"] += nbytes
    if worst > 1e-4:
        fail(f"the material gradient is {worst:.3e} of the terms' magnitude from PyTorch's "
             f"index backward")
    b_ms, b_by = bound(0.0, total["bytes"])
    print(f"[6 mat] both tables: kernels {total['ms']:.4f} ms (device "
          f"{total['device_ms']:.4f}), bound {b_ms:.5f} ms, {total['device_ms'] / b_ms:.1f}x; "
          f"PyTorch's index backward {total['library_ms']:.4f} ms (device "
          f"{total['library_device_ms']:.4f}); gradient within {worst:.3e} of the terms' "
          f"magnitude, {max_abs:.3e} absolute; the train step {step['step_s']:.4f} s with "
          f"{step['launches']} material kernel calls, on {smi}", flush=True)
    return {"name": "mat_gather", "route": "cuda",
            "source": "pathtrace_tpu_torch/csrc/mat_gather.cu", "replaces": None,
            "launches": step["launches"], "max_abs_err": max_abs, "ms": total["device_ms"],
            "event_ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": total["library_device_ms"],
            "library_event_ms": total["library_ms"], "grad_rel_to_magnitude": worst,
            "step_s": step["step_s"], "step_busy_ms": step["busy_ms"],
            "step_mat_ms": step["mat_ms"],
            "note": "forward and backward at the train step's shape; the "
                    "gradient's error is relative to the sum of the terms' magnitudes"}


def parity_phase(smi: str) -> None:
    """Phase 6, last: a scene of spheres alone through the all-triangles
    kernel and the fused kernel, and `cli render`'s multi-pass flags."""
    import numpy as np
    import torch

    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_stats
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel
    from pathtrace_tpu_torch.utils import rng

    scene = procedural.sphere_only_scene().to("cuda")
    cam = procedural.default_camera(64, 64)
    cfg, key, lanes, spp = IntegratorConfig(), rng.make_key(2), 4096, 8
    mt_kernel.LAUNCHES = bk.LAUNCHES = 0
    w_img, w_rays = render_wavefront_stats(scene, cam, spp, key, cfg, lanes, device="cuda")
    f_img, f_rays = bk.render_wavefront_fused(scene, cam, spp, key, cfg, lanes=lanes,
                                              chunk_spp=spp, device="cuda")
    mt_launches, bk_launches = mt_kernel.LAUNCHES, bk.LAUNCHES
    p_img, p_rays = render_wavefront_stats(scene, cam, spp, key, cfg, lanes, device="cuda",
                                           search=mt.mt_closest_plain)
    print(f"[6 spheres] sphere_only_scene ({scene.num_tris} triangles, {scene.num_spheres} "
          f"spheres, {scene.num_lights} lights) {cam.width}x{cam.height}@{spp}spp lanes {lanes}: "
          f"wavefront "
          f"{mt_launches} all-triangles kernel launches, fused {bk_launches} bounce kernel "
          f"launch(es); bit-equal to the plain wavefront: wavefront "
          f"{torch.equal(w_img, p_img) and w_rays == p_rays}, fused "
          f"{torch.equal(f_img, p_img) and f_rays == p_rays}; rays {p_rays}, mean "
          f"{p_img.mean().item():.6f}", flush=True)
    if mt_launches < 1 or bk_launches < 1:
        fail("the sphere-only scene launched no kernel")
    if not (torch.equal(w_img, p_img) and w_rays == p_rays and torch.equal(f_img, p_img)
            and f_rays == p_rays):
        fail("the sphere-only scene through the kernels is not bit-equal to its plain version")
    if not bool(torch.isfinite(p_img).all()) or p_img.mean().item() <= 0.0:
        fail("the sphere-only image is not finite or is black")

    # `cli render` as a user runs it: 4 passes straight against 2 passes
    # with a checkpoint resumed to 4 (the same samples per pass, so the same
    # keys), --out-npy bit for bit; and --no-nee
    base = ["--preset", "cornell64", "--width", "64", "--height", "64"]
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("fused", "wavefront"):
            out = {}
            for name, flags in (("straight", ["--spp", "16", "--passes", "4"]),
                                ("first", ["--spp", "8", "--passes", "2", "--checkpoint"]),
                                ("resumed", ["--spp", "16", "--passes", "4", "--resume",
                                             "--checkpoint"])):
                if flags[-1] == "--checkpoint":
                    flags = flags + [os.path.join(tmp, f"{engine}.npz")]
                npy = os.path.join(tmp, f"{engine}_{name}.npy")
                run_cli([*base, "--engine", engine, *flags, "--out-npy", npy],
                        os.path.join(tmp, f"{engine}_{name}.png"), 64, "6 cli resume")
                out[name] = np.load(npy)
            same = np.array_equal(out["straight"], out["resumed"])
            print(f"[6 cli resume] --engine {engine}: 2 passes + --resume to 4 bit-equal to 4 "
                  f"passes straight: {same}; mean {out['straight'].mean():.6f} on {smi}",
                  flush=True)
            if not same or not np.isfinite(out["straight"]).all():
                fail(f"a resumed render differs from the uninterrupted one (--engine {engine})")
        run_cli([*base, "--spp", "8", "--no-nee"], os.path.join(tmp, "no_nee.png"), 64,
                "6 cli resume")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_phase(smi: str, main_mean: float, main_occ: dict) -> None:
    """Phase 7: pixel-slice sharding (parallel/mesh.py) on a NCCL group of
    world size 1, N-slice splits run in turn on the card, the BVH and a
    JSON scene."""
    import json as json_mod

    import numpy as np
    import torch

    from pathtrace_tpu_torch import bench, native
    from pathtrace_tpu_torch.accel.bvh import build_bvh
    from pathtrace_tpu_torch.accel.traverse import raycast_bvh
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront, render_wavefront_stats
    from pathtrace_tpu_torch.models import json_io, procedural
    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel
    from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel
    from pathtrace_tpu_torch.parallel import distributed
    from pathtrace_tpu_torch.parallel import mesh as M
    from pathtrace_tpu_torch.utils import rng

    cfg = IntegratorConfig()
    distributed.initialize(f"tcp://localhost:{free_port()}", 1, 0, device="cuda")
    try:
        ray_mesh = distributed.global_ray_mesh("cuda")
        print(f"[7 shard] process group {torch.distributed.get_backend()} world size "
              f"{ray_mesh.world_size}, rank {ray_mesh.rank} on {ray_mesh.device}", flush=True)
        if torch.distributed.get_backend() != "nccl":
            fail("the sharded path did not get a NCCL group")

        # the main path's width through render_fused_sharded: B1 keyed by
        # global path ids, one launch over the rank's slice
        scene = procedural.cornell_box_scene(include_spheres=True).to("cuda")
        cam = procedural.default_camera(256, 256)
        key = rng.iter_key(rng.make_key(0), 1000)
        lanes, spp = bk.auto_fused_config(256 * 256), 1024
        # warm-up: the group's first collective sets up its NCCL communicator
        # (on an H100 80GB HBM3 a cold first call took 0.766 s, a warm one 0.33 s)
        M.render_fused_sharded(scene, cam, 4, key, ray_mesh, cfg, lanes)
        bk.LAUNCHES = 0
        (img, rays), ms = timed(lambda: M.render_fused_sharded(scene, cam, spp, key, ray_mesh,
                                                               cfg, lanes))
        launches = bk.LAUNCHES
        paths = 256 * 256 * spp
        rel = abs(img.mean().item() - main_mean) / main_mean
        print(f"[7 shard] render_fused_sharded cornell+spheres 256x256@{spp}spp lanes {lanes}, "
              f"world size 1: {launches} bounce kernel launch(es), {ms / 1e3:.4f} s, "
              f"{paths / ms * 1e3 / 1e6:.3f}M paths/s, {rays / ms * 1e3 / 1e6:.3f}M rays/s, "
              f"mean rel diff vs phase 4's chunked render {rel:.3e} on {smi}", flush=True)
        if launches < 1 or not bool(torch.isfinite(img).all()) or rel > 0.02:
            fail("render_fused_sharded launched no kernel, or its image is not finite or "
                 "not within 2% of the main path's")

        # N slices run in turn on the card against the whole render, bit for bit
        whole, w_rays = M.render_fused_shard(scene, cam, 64, key, 0, 1, cfg, 65536)
        for n in (2, 4):
            parts = [M.render_fused_shard(scene, cam, 64, key, i, n, cfg, 65536 // n)
                     for i in range(n)]
            same = (torch.equal(torch.cat([p[0] for p in parts]), whole)
                    and sum(p[1] for p in parts) == w_rays)
            print(f"[7 shard] 256x256@64spp in {n} slices of lanes {65536 // n}: bit-equal to "
                  f"the 1-slice film and rays: {same}", flush=True)
            if not same:
                fail(f"{n} slices of kernel B1 differ from the whole render")

        # B1 on slices with pix_offset != 0 against its plain version
        cam32 = procedural.default_camera(32, 32)
        for shard, n, lanes32 in ((1, 2, 256), (3, 4, 512)):
            k_img, k_rays = M.render_fused_shard(scene, cam32, 16, key, shard, n, cfg, lanes32)
            npl = 1024 // n
            p_img, p_rays = _run_wavefront(scene, cam32, 16, key, cfg, lanes32,
                                           pix_offset=shard * npl, num_pix_local=npl,
                                           search=mt.mt_closest_plain)
            err = (k_img - p_img).abs().max().item()
            print(f"[7 shard] B1 vs plain, 32x32@16spp slice {shard} of {n} (pix_offset "
                  f"{shard * npl}, lanes {lanes32}): max abs err {err:.3e}, rays {k_rays} vs "
                  f"{p_rays}", flush=True)
            if err != 0.0 or k_rays != p_rays:
                fail(f"B1 on slice {shard} of {n} is not bit-equal to its plain version")
        print(f"[7 shard] B1 with global path ids: {main_occ['registers']} registers, "
              f"{main_occ['warps_per_sm']} warps per SM (phase 4's build); before pixel "
              f"slices: {B1_MAX_REGISTERS}, {B1_MIN_WARPS_PER_SM}", flush=True)
        if (main_occ["registers"] > B1_MAX_REGISTERS
                or main_occ["warps_per_sm"] < B1_MIN_WARPS_PER_SM):
            fail("the bounce kernel with global path ids takes more registers or holds fewer "
                 "warps per SM than before pixel slices")

        # the production train step, world size 1, against the one-device step
        b_scene, b_cam, target, b_cfg, b_key = bench.train_problem("cuda")
        mt_kernel.LAUNCHES = 0
        (s_loss, s_grads, s_img), s_ms = timed(lambda: M.train_step_wavetape_sharded(
            b_scene, b_cam, target, 64, b_key, ray_mesh, b_cfg, bench.TRAIN_LANES,
            bench.TRAIN_CHUNK))
        mt_launches = mt_kernel.LAUNCHES
        o_loss, o_grads, o_img = bench.make_train_step("cuda")(64)
        same = (torch.equal(s_loss, o_loss) and torch.equal(s_img, o_img)
                and max(grad_errors(o_grads, s_grads).values()) == 0.0)
        print(f"[7 train] train_step_wavetape_sharded 128x128@64spp world size 1: "
              f"{mt_launches} all-triangles kernel launches, {s_ms / 1e3:.4f} s; bit-equal to "
              f"train_step_wavetape in loss, grads and image: {same}", flush=True)
        if mt_launches < 1 or not same:
            fail("the sharded train step launched no B3 or differs from the one-device step")

        # the mesh path sharded: multihost1024's scene through the KD kernel
        t0 = time.perf_counter()
        mesh_scene = procedural.sphere_mesh_scene(6).with_kd_binned().to("cuda")
        kd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if native.get_lib() is None:
            fail("g++ could not build the native BVH builder")
        gxx_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_bvh(mesh_scene.positions(), backend="native")
        bvh_s = time.perf_counter() - t0
        print(f"[7 bvh/json] sphere_mesh_scene(6), {mesh_scene.num_tris} triangles: native SAH "
              f"BVH build {bvh_s:.3f} s (its g++ build {gxx_s:.3f} s before; KD cells "
              f"{kd_s:.3f} s)", flush=True)
        kd_kernel.LAUNCHES = 0
        (m_img, m_rays), m_ms = timed(lambda: M.render_wavefront_sharded(
            mesh_scene, cam, 8, key, ray_mesh, cfg, 65536))
        kd_launches = kd_kernel.LAUNCHES
        parts = [M.render_wavefront_shard(mesh_scene, cam, 8, key, i, 2, cfg, 32768)
                 for i in range(2)]
        same = (torch.equal(torch.cat([p[0] for p in parts]).reshape(256, 256, 3), m_img)
                and sum(p[1] for p in parts) == m_rays)
        print(f"[7 mesh] render_wavefront_sharded sphere_mesh_scene(6) 256x256@8spp lanes "
              f"65536, world size 1: {kd_launches} KD kernel launches, {m_ms / 1e3:.4f} s, "
              f"{256 * 256 * 8 / m_ms * 1e3 / 1e6:.4f}M paths/s; 2 slices of lanes 32768 "
              f"bit-equal: {same}", flush=True)
        if kd_launches < 1 or not same or not bool(torch.isfinite(m_img).all()):
            fail("the sharded mesh path launched no B2, or its 2-slice split differs")
        del mesh_scene

        # raycast_bvh (plain PyTorch) against B3 on Cornell camera rays
        bvh_scene = procedural.cornell_box_scene(include_spheres=True).with_bvh().to("cuda")
        org, dirs, t_min, t_max = kd.probe_rays(bvh_scene, cam, 4, seed=3)["camera"]
        a = raycast_bvh(bvh_scene, org, dirs, t_min, t_max)
        b = mt.raycast_mt(bvh_scene, org, dirs, t_min, t_max)
        # equal t on two triangles (rays along shared edges): B3 keeps the
        # lowest id, the BVH walk the last it visits, a higher id in leaf order
        ties = a.hit & (a.prim_id != b.prim_id)
        same = (torch.equal(a.hit, b.hit) and torch.equal(a.is_sphere, b.is_sphere)
                and torch.equal(a.t[a.hit], b.t[b.hit])
                and bool((a.prim_id[ties] > b.prim_id[ties]).all())
                and not bool(a.is_sphere[ties].any()))
        print(f"[7 bvh/json] raycast_bvh vs B3 (raycast_mt) on {org.shape[0]} Cornell camera "
              f"rays, {int(a.hit.sum())} hits: same hits, spheres and t: {same}; same winner "
              f"but on {int(ties.sum())} exact ties, where the walk keeps the later triangle",
              flush=True)
        if not same:
            fail("raycast_bvh and B3 find different winners")

        # a JSON scene with the blob82k OBJ: BVH order, then KD cells (B2)
        doc = {"camera": {"pos": [0, 20, 60], "look_at": [0, 18, 0], "width": 64, "height": 64},
               "objects": [
                   {"type": "cornell_walls"},
                   {"type": "box", "center": [-12, 5, -8], "half_extents": [4, 5, 4],
                    "material": {"albedo": [0.7, 0.7, 0.7]}},
                   {"type": "icosphere", "radius": 4, "center": [12, 4, 6], "subdivisions": 2,
                    "material": {"albedo": [0.3, 0.6, 0.3], "roughness": 0.3}},
                   {"type": "sphere", "center": [-10, 16, 6], "radius": 4,
                    "material": {"metallic": 1.0, "roughness": 0.2}},
                   {"type": "obj", "path": os.path.join(REPO, "assets", "blob82k.obj")}]}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "scene.json")
            with open(path, "w") as f:
                json_mod.dump(doc, f)
            t0 = time.perf_counter()
            j_scene, j_cam = json_io.load_scene(path)
            load_s = time.perf_counter() - t0
        j_scene = j_scene.to("cuda")
        kd_kernel.LAUNCHES = 0
        k_img, k_rays = render_wavefront_stats(j_scene, j_cam, 16, key, cfg, 16384,
                                               device="cuda")
        kd_launches = kd_kernel.LAUNCHES
        p_img, p_rays = render_wavefront_stats(j_scene, j_cam, 16, key, cfg, 16384,
                                               device="cuda", search=kd.kd_closest_plain)
        same = torch.equal(k_img, p_img) and k_rays == p_rays
        print(f"[7 bvh/json] JSON scene (walls, box, icosphere, sphere, blob82k.obj): "
              f"{j_scene.num_tris} triangles, BVH {j_scene.bvh.num_nodes} nodes, "
              f"{j_scene.clusters.num_clusters} KD cells, loaded in {load_s:.2f} s; 64x64@16spp: "
              f"{kd_launches} KD kernel launches, bit-equal to the plain search: {same}, mean "
              f"{k_img.mean().item():.6f}", flush=True)
        if kd_launches < 1 or not same or not bool(np.isfinite(k_img.cpu().numpy()).all()):
            fail("the JSON scene did not route through B2 or differs from the plain search")
    finally:
        torch.distributed.destroy_process_group()


def evidence_phase(smi: str) -> None:
    """Phase 8: the reference's own job at its full resolution, B1 on a slice
    of it at path ids across 2**31, the 2**32 refusal, mesh gradients
    through B2, forward mode through B3, and the five card-vs-CPU agreement
    rows, each through the tool that runs it at full size
    (tools/torch_reference_frame.py, tools/torch_gradcheck_card.py,
    tools/torch_card_cpu_agreement.py). Each comparison through a kernel
    is also made through its plain version."""
    import torch

    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.ops.cuda import mat_gather as mg_kernel
    from pathtrace_tpu_torch.utils import rng

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_card_cpu_agreement as agreement
    import torch_gradcheck_card as gradcheck
    import torch_reference_frame as reference

    t_phase = time.perf_counter()
    # the reference's job at 1080x2400, 2 passes x 4 spp: straight, and with
    # the accumulator dropped after pass 1 and reloaded from its checkpoint
    w, h = 1080, 2400
    with tempfile.TemporaryDirectory() as tmp:
        straight, s_img = reference.render_job(w, h, 2, 4, device="cuda", out_dir=tmp,
                                               resume_at=0, write_png=False)
        resumed, r_img = reference.render_job(w, h, 2, 4, device="cuda", out_dir=tmp,
                                              resume_at=1)
        check_png(os.path.join(tmp, f"torch_reference_frame_{w}x{h}_2x4spp.png"), w, h)
    same = torch.equal(s_img, r_img)
    print(f"[8 reference] cornell+spheres {w}x{h}, 2 passes x 4 spp, lanes {resumed['lanes']}: "
          f"{resumed['b1_launches']} B1 launches, {resumed['wall_seconds']:.4f} s, "
          f"{resumed['paths_per_sec'] / 1e6:.3f}M paths/s, {resumed['rays_per_sec'] / 1e6:.3f}M "
          f"rays/s (straight: {straight['paths_per_sec'] / 1e6:.3f}M); resumed after pass "
          f"{resumed['resumed_at_pass']} from the checkpoint, bit-equal to the straight run: "
          f"{same}; mean {resumed['image_mean']:.6f} on {smi}", flush=True)
    if not (same and resumed["pass"] and straight["pass"] and resumed["resumed_at_pass"] == 1
            and resumed["b1_launches"] == 2):
        fail("the reference job at full resolution failed, or its resume is not bit-equal")

    # B1 against its plain version on the reference job's own launch: the
    # whole frame, 2,592,000 lanes, one pixel a lane, at the sample whose
    # path ids cross 2**31 (the JAX package's int32 ids would wrap there:
    # ROADMAP C9)
    scene = procedural.cornell_box_scene(include_spheres=True).to("cuda")
    cam, cfg = procedural.default_camera(w, h), IntegratorConfig()
    key = rng.iter_key(rng.make_key(0), 1000)
    num_pix = w * h
    lanes, sample = bk.auto_fused_config(num_pix), 2 ** 31 // num_pix
    first, last = sample * num_pix, (sample + 1) * num_pix - 1
    bk.LAUNCHES = 0
    (k_img, k_rays), k_ms = timed(lambda: bk.render_wavefront_fused(
        scene, cam, 1, key, cfg, lanes, chunk_spp=1, sample_offset=sample, device="cuda"))
    launches = bk.LAUNCHES
    (p_img, p_rays), p_ms = timed(lambda: _run_wavefront(
        scene, cam, 1, key, cfg, lanes, sample, search=mt.mt_closest_plain))
    err = (k_img - p_img).abs().max().item()
    print(f"[8 ids] B1 vs plain on the whole {w}x{h} frame, {lanes} lanes ({launches} launch), "
          f"sample {sample}: path ids {first}-{last} across 2**31; max abs err {err:.3e}, rays "
          f"{k_rays} vs {p_rays}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
    if not (first < 2 ** 31 <= last and launches == 1 and torch.equal(k_img, p_img)
            and k_rays == p_rays and bool(torch.isfinite(k_img).all())):
        fail("B1 is not bit-equal to its plain version on the whole frame across 2**31")

    # and on a 65,536-pixel slice of that frame whose path ids cross 2**31 in
    # its first sample (the slice's branch of the kernel's global ids)
    npl = 65536
    pix0 = 2 ** 31 - sample * num_pix - npl // 2
    first, last = sample * num_pix + pix0, (sample + 1) * num_pix + pix0 + npl - 1
    k_img, k_rays = bk.render_wavefront_fused(scene, cam, 2, key, cfg, npl, chunk_spp=2,
                                              sample_offset=sample, pix_offset=pix0,
                                              num_pix_local=npl, device="cuda")
    p_img, p_rays = _run_wavefront(scene, cam, 2, key, cfg, npl, sample, pix_offset=pix0,
                                   num_pix_local=npl, search=mt.mt_closest_plain)
    err = (k_img - p_img).abs().max().item()
    print(f"[8 ids] B1 vs plain on pixels [{pix0}, {pix0 + npl}) of {w}x{h}, samples "
          f"{sample}-{sample + 1}: path ids {first}-{last} across 2**31; max abs err {err:.3e}, "
          f"rays {k_rays} vs {p_rays}", flush=True)
    if not (first < 2 ** 31 <= last and err == 0.0 and k_rays == p_rays
            and bool(torch.isfinite(k_img).all())):
        fail("B1 is not bit-equal to its plain version at path ids across 2**31")
    launches = bk.LAUNCHES
    try:
        bk.render_wavefront_fused(scene, cam, 1, key, cfg, num_pix,
                                  sample_offset=2 ** 32 // num_pix, device="cuda")
    except ValueError as e:
        refused = "Philox" in str(e) and bk.LAUNCHES == launches
        print(f"[8 ids] sample {2 ** 32 // num_pix} (ids past 2**32): refused before any "
              f"launch: {refused} ({e})", flush=True)
    else:
        refused = False
    if not refused:
        fail("path ids at 2**32 were not refused")

    # mesh gradients through B2: the wavetape against scan-AD on blob82k
    blob = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024).to("cuda")
    scatter0 = mg_kernel.SCATTER_LAUNCHES
    m = gradcheck.mesh_grads("cuda", blob)
    scatters = mg_kernel.SCATTER_LAUNCHES - scatter0
    tiles = -(-blob.num_tris // mg_kernel.tile_rows(12))
    print(f"[8 grads] mesh {m['scene']} {m['resolution'][0]}x{m['resolution'][1]}@{m['spp']}spp: "
          f"{m['b2_launches']} B2 launches, {scatters} material backwards "
          f"({blob.num_tris}-row table in {tiles} tiles), wavetape vs scan-AD max rel err "
          f"{max(m['wavetape_vs_scan_ad_max_rel_err'].values()):.3e}, primal max abs diff "
          f"{m['primal_max_abs_diff']:.3e}, {m['seconds']:.2f} s", flush=True)
    p = m["plain_search"]
    print(f"[8 grads] the same through the plain KD search: {p['launches']} kernel launches, "
          f"primals bit-equal: {p['primal_equal']}, grads max rel err wavetape "
          f"{max(p['max_rel_err']['wavetape'].values()):.3e}, scan-AD "
          f"{max(p['max_rel_err']['scan_ad'].values()):.3e} (bar {gradcheck.PLAIN_GRAD_TOL})",
          flush=True)
    if not (m["pass"] and p["pass"]) or scatters < 1:
        fail("mesh gradients through B2 disagree with scan-AD or with the plain search, or "
             "took no material backward")

    # forward mode against reverse mode, every search through B3
    f = gradcheck.forward_vs_reverse("cuda", 16, 4)
    print(f"[8 grads] forward vs reverse, cornell+spheres 16x16@4spp, random tangent over the "
          f"six fields: jvp {f['jvp']:.6f}, vjp dot {f['vjp_dot']:.6f}, rel err "
          f"{f['rel_err']:.3e}; the forward render's B3 launches {f['forward_launches']['b3']}, "
          f"{f['forward_seconds']:.2f} s (reverse {f['reverse_seconds']:.2f} s)", flush=True)
    p = f["plain_search"]
    print(f"[8 grads] forward mode through the plain search: jvp {p['jvp']:.6f}, loss "
          f"{p['loss']:.6f}, {p['launches']} kernel launches, bit-equal to B3's: {p['equal']}",
          flush=True)
    if not f["pass"] or f["forward_launches"]["b3"] < 1:
        fail("forward mode disagrees with reverse mode or with the plain search, or launched "
             "no B3")

    # the five rows of the card-vs-CPU agreement against the committed goldens
    for row in agreement.agreement_rows("cuda", blob):
        print(f"[8 agreement] {row['run']} vs {row['golden']}: pixel agreement "
              f"{row['pixel_agreement']:.6f} (bar {row['min_agree']}), mean rel "
              f"{row['mean_rel_diff']:.3e} (bar {row['max_mean_rel']}), ok {row['ok']}",
              flush=True)
        if not row["ok"]:
            fail(f"{row['run']} disagrees with the CPU golden {row['golden']}")
    print(f"[8 done] phase 8 in {time.perf_counter() - t_phase:.2f} s", flush=True)


def scale_phase() -> None:
    """Phase 9: the scaling sweep at small depth through its tool, as a
    subprocess; fails on any failed check or a path that launched no
    kernel."""
    import torch

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    sizes = [n for n in (1, 2, 4) if n <= count]
    if count > 1:
        print(f"[9 scale] {count} cards: the sweep runs N = {sizes}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scale.json")
        proc = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                            "torch_scaling_bench.py"),
                               "--smoke", "--sizes", ",".join(map(str, sizes)), "--json", out],
                              cwd=REPO, stdout=subprocess.PIPE, text=True, timeout=900)
        if proc.returncode != 0 or not os.path.exists(out):
            fail(f"tools/torch_scaling_bench.py failed (exit {proc.returncode}):\n"
                 f"{proc.stdout[-3000:]}")
        with open(out) as f:
            report = json.load(f)
    if not report["device_guard"]:
        print("[9 scale] one card: the launcher's kernels on cards other than the current one "
              "need a second card (docs/torch_scaling_bench.json holds them on cuda:0-3)",
              flush=True)
    for g in report["device_guard"]:
        if "error" in g:
            fail(f"a kernel launch on {g['device']} failed: {g['error']}")
        print(f"[9 scale] launcher, current device {g['current_device']}: on {g['device']} B1 "
              f"{g['B1']['bit_equal']} ({g['B1']['launches']} launch), B2 "
              f"{g['B2']['bit_equal']}, B3 {g['B3']['bit_equal']} bit-equal to plain", flush=True)
    for run in report["runs"]:
        checks = run["kernel_checks"]
        eps = run["entry_points"]
        print(f"[9 scale] N={run['n_devices']} ({run['backend']}, {', '.join(run['devices'])}): "
              f"per-rank B1/B2/B3 bit-equal to plain: "
              f"{[(c['B1']['bit_equal'], c['B2']['bit_equal'], c['B3']['bit_equal']) for c in checks]}; "
              f"six entry points vs one process: "
              f"{ {k: v['pass'] for k, v in eps.items() if isinstance(v, dict)} }; "
              f"{run['wall_seconds']:.2f} s with start-up", flush=True)
    for sweep in report["sweeps"]:
        for row in sweep["rows"]:
            launches = sum(c[sweep["kernel"]] for c in row["rank_launches"])
            coll = row.get("collectives", {}).get("max_over_ranks", {})
            print(f"[9 scale] {sweep['name']} {sweep['mode']} {row['camera'][0]}x"
                  f"{row['camera'][1]}@{row['spp']}spp lanes {row['lanes']} N={row['n_devices']}: "
                  f"{launches} {sweep['kernel']} launches, {row['seconds']:.4f} s, "
                  f"{row['paths_per_sec'] / 1e6:.3f}M paths/s, "
                  f"{row['rays_per_sec_per_chip'] / 1e6:.3f}M rays/s a card, efficiency "
                  f"{row['efficiency_vs_1']:.4f}; check at {row['check']['spp']} spp bit-equal "
                  f"{row['check']['bit_equal']}, rays {row['check']['rays_equal']}"
                  + (f", grads max rel err {row['check']['grads_max_rel_err']:.3e}"
                     if "grads_max_rel_err" in row["check"] else "") + "; collectives "
                  + ", ".join(f"{k} {v:.4f}" for k, v in coll.items()), flush=True)
            if launches < 1:
                fail(f"the {sweep['name']} sweep launched no {sweep['kernel']}")
    if not report["pass"]:
        fail("the scaling sweep failed a check (its report's pass is false)")
    committed = os.path.join(REPO, "docs", "torch_scaling_bench.json")
    if count == 1 and not os.path.exists(committed):
        print("[9 scale] one card here, and no docs/torch_scaling_bench.json: N > 1 not "
              "measured", flush=True)
    elif count == 1:
        with open(committed) as f:
            cards = json.load(f)
        for sweep in cards["sweeps"]:
            effs = ", ".join(f"N={r['n_devices']} {r['efficiency_vs_1']:.4f}"
                             for r in sweep["rows"] if r["n_devices"] > 1)
            print(f"[9 scale] one card here: the N > 1 rows come from "
                  f"docs/torch_scaling_bench.json ({cards['card']}, {cards['power_limit']}): "
                  f"{sweep['name']} {sweep['mode']} efficiency_vs_1 {effs}", flush=True)
    print(f"[9 done] phase 9 in {time.perf_counter() - t_phase:.2f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_stats
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.ops.cuda import build
    from pathtrace_tpu_torch.profile_main import schedule_share
    from pathtrace_tpu_torch.utils import rng

    # 1. environment
    smi = bench.nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{bench.nvcc_version()}' "
          f"gpu '{smi}' capability {cap}", flush=True)
    if cap != (9, 0):
        fail(f"need a Hopper card (capability (9, 0)), got {cap}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build_s = time.perf_counter() - t0
    with open(lib_path + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"[2 build] {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}; "
          f"{' | '.join(ptxas)}", flush=True)

    # 3. kernel vs plain version on the card (bars of tests/test_fused.py);
    # the wavefront takes the plain all-triangles search, so the reference
    # runs no kernel
    cfg = IntegratorConfig()
    cam32 = procedural.default_camera(32, 32)
    key = rng.make_key(5)
    for spheres, spp in ((False, 8), (True, 16)):
        scene = procedural.cornell_box_scene(include_spheres=spheres).to("cuda")
        a, rays_a = bk.render_wavefront_fused(scene, cam32, spp, key, cfg, lanes=1024,
                                              chunk_spp=spp, device="cuda")
        b, rays_b = render_wavefront_stats(scene, cam32, spp, key, cfg, lanes=1024,
                                           device="cuda", search=mt.mt_closest_plain)
        a, b = a.cpu().double(), b.cpu().double()
        tol = 1e-4 if not spheres else 1e-3
        agree = torch.isclose(a, b, rtol=tol, atol=tol).double().mean().item()
        mean_rel = abs(a.mean().item() - b.mean().item()) / b.mean().item()
        rays_rel = abs(rays_a - rays_b) / rays_b
        err = (a - b).abs().max().item()
        print(f"[3 compare] spheres={spheres} 32x32@{spp}spp lanes 1024: pixel "
              f"agreement {agree:.6f} at {tol:g}, mean rel {mean_rel:.3e}, rays "
              f"{rays_a} vs {rays_b} (rel {rays_rel:.3e}), max abs err {err:.3e}",
              flush=True)
        if not spheres:
            ok = agree > 0.99 and mean_rel < 2e-3 and rays_rel < 1e-3
        else:
            ok = agree > 0.5 and mean_rel < 0.02 and rays_rel < 0.02
        # and bit for bit: the same draws, winners and roundings, the same sums
        ok = ok and err == 0.0 and rays_a == rays_b
        if not ok:
            fail(f"kernel disagrees with its plain version (spheres={spheres})")

    # 4. main path: what `cli render --engine fused` runs, at the bench shape
    scene = procedural.cornell_box_scene(include_spheres=True).to("cuda")
    cam = procedural.default_camera(256, 256)
    pass_key = rng.iter_key(rng.make_key(0), 1000)
    lanes = bk.auto_fused_config(256 * 256)
    spp = 1024
    bk.LAUNCHES = 0
    (img, rays), ms = timed(lambda: bk.render_wavefront_fused(
        scene, cam, spp, pass_key, cfg, lanes=lanes, chunk_spp=min(spp, 256),
        device="cuda"))
    launches = bk.LAUNCHES
    paths = 256 * 256 * spp
    rays_per_path = rays / paths
    print(f"[4 main] cornell+spheres 256x256@{spp}spp lanes {lanes}: {launches} "
          f"kernel launches, {ms / 1e3:.4f} s, {paths / ms * 1e3 / 1e6:.3f}M paths/s, "
          f"{rays / ms * 1e3 / 1e6:.3f}M rays/s, {rays_per_path:.4f} rays/path, "
          f"mean {img.mean().item():.6f} on {smi}", flush=True)
    if launches < 1:
        fail("the main path launched no bounce kernel")
    if not bool(torch.isfinite(img).all()):
        fail("non-finite pixels in the main-path image")
    if not 1.0 <= rays_per_path <= 2 * cfg.max_iters:
        fail(f"rays per path {rays_per_path} outside [1, {2 * cfg.max_iters}]")

    # kernel and plain version at the main path's scene, film and lanes, at
    # 32 spp (the plain version is too slow for 1024): times, per-pixel
    # agreement, ray counts, means. Both sides draw the same Philox streams,
    # round alike (-fmad=false, IEEE division) and sum each film slot in the
    # same path order, so the images are bit-equal and the rays equal.
    (k_img, k_rays), k_ms = timed(lambda: bk.render_wavefront_fused(
        scene, cam, 32, pass_key, cfg, lanes=lanes, chunk_spp=32, device="cuda"))
    (p_img, p_rays), p_ms = timed(lambda: render_wavefront_stats(
        scene, cam, 32, pass_key, cfg, lanes=lanes, device="cuda", search=mt.mt_closest_plain))
    main_rel = abs(img.mean().item() - p_img.mean().item()) / p_img.mean().item()
    k32_rel = abs(k_img.mean().item() - p_img.mean().item()) / p_img.mean().item()
    k_img, p_img = k_img.double(), p_img.double()
    agree = torch.isclose(k_img, p_img, rtol=1e-3, atol=1e-3).double().mean().item()
    rays_rel = abs(k_rays - p_rays) / p_rays
    max_abs_err = (k_img - p_img).abs().max().item()
    print(f"[4 main] 256x256@32spp lanes {lanes}: kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms ({p_ms / k_ms:.1f}x); pixel agreement {agree:.6f} at 0.001, "
          f"max abs err {max_abs_err:.3e}, rays {k_rays} vs {p_rays} (rel "
          f"{rays_rel:.3e}); mean rel diff vs plain@32: main@1024 {main_rel:.3e}, "
          f"kernel@32 {k32_rel:.3e}; on {smi}", flush=True)
    if main_rel > 0.02 or k32_rel > 0.02:
        fail("main-path image mean is not within 2% of the plain version's")
    if agree <= 0.99 or rays_rel > 1e-5 or max_abs_err != 0.0 or k_rays != p_rays:
        fail("kernel is not bit-equal to its plain version at the main path's shape")
    # its least time at 32 spp: the MT stages that the traced rays need
    # against every triangle, every sphere test, one shading per hit and
    # NEE's BSDF term per shadow ray that reached the light; bytes: the scene
    # once, the film once. The count runs the plain wavefront again on the
    # same paths (profile_main.schedule_share).
    table = scene.tris.search_table
    need = schedule_share(scene, cam, 32, pass_key, cfg, lanes, search=mt.mt_closest_plain,
                          pair_ops=lambda org, dirn: mt_pair_ops(table, org, dirn))
    mt_ops, hits, c_rays, iters = need["mt_ops"], need["hits"], need["rays"], need["iters"]
    main_ops = b1_ops(scene, need)
    b1_ms, b1_by = bound(main_ops, tensor_bytes(scene) + k_img.numel() * 4)
    print(f"[4 main] bound at 32spp: {mt_ops:.4e} MT operations needed over {c_rays} rays "
          f"({mt_ops / (c_rays * scene.num_tris):.2f} a pair), {hits} shaded hits, "
          f"{need['visible']} of their shadow rays reached the light; {main_ops:.4e} FP32 "
          f"operations, {b1_ms:.3f} ms ({b1_by}); the kernel takes {k_ms / b1_ms:.1f}x its "
          f"bound", flush=True)
    if c_rays != p_rays or not torch.equal(need["image"], p_img.float()):
        fail(f"the bound's count saw {c_rays} rays, the plain version traced {p_rays}, or "
             f"its image differs")
    chunk_ms, chunk_bound = ms / launches, b1_ms * min(spp, 256) / 32
    print(f"[4 main] per launch of {min(spp, 256)} spp on the main path: {chunk_ms:.3f} ms; bound "
          f"{chunk_bound:.3f} ms (the 32 spp count scaled by {min(spp, 256) // 32}), "
          f"{chunk_ms / chunk_bound:.1f}x its bound", flush=True)
    if int(iters.sum()) + need["nee_rays"] != p_rays:
        fail("the paths' iterations and the NEE rays do not add up to the plain version's rays")
    nested, in_place = need["nested"], need["in_place"]
    occ = bk.occupancy(bk.build_fused_pack(scene))
    print(f"[4 main] schedule at 32spp lanes {lanes}: {iters.numel()} paths, mean "
          f"{iters.double().mean().item():.4f} iterations, longest {int(iters.max())}; useful "
          f"warp-iteration share nested {nested:.4f}, in place {in_place:.4f}; kernel "
          f"{occ['registers']} registers, {occ['local_bytes']} B local memory (stack frame "
          f"and spills) a thread, {occ['blocks_per_sm']} resident blocks of {occ['block']} ("
          f"{occ['warps_per_sm']} warps) per SM on {occ['sms']} SMs: one wave holds "
          f"{occ['wave_lanes']} lanes, {lanes / occ['wave_lanes']:.3f} waves", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        run_cli(["--preset", "cornell64", "--engine", "fused"],
                os.path.join(tmp, "cornell64.png"), 64, "4 cli")

    kd_entry = mesh_phase(smi)
    mt_entry, step = train_phase(smi)
    mat_entry = mat_phase(smi, step)
    parity_phase(smi)
    shard_phase(smi, img.mean().item(), occ)
    evidence_phase(smi)
    scale_phase()

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "bounce_kernel",
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/bounce_kernel.cu",
        "replaces": "pathtrace_tpu/ops/pallas/bounce_kernel.py:411",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b1_ms,
        "bound_by": b1_by,
        "library_ms": None,
        "note": "keyed by global path ids on a pixel slice (PtParams num_pix_total, "
                "pix_offset), held bit-equal on slices in phase 7 and at path ids across "
                "2**31 in phase 8",
        "inlines": {"name": "bsdf_t lobes (B1b)", "source": "pathtrace_tpu_torch/csrc/bsdf.cuh",
                    "replaces": "pathtrace_tpu/ops/pallas/bsdf_t.py:203-409"},
    }, kd_entry, mt_entry, mat_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
