"""Same-card A/B of builds of the KD raycast kernel (csrc/kd_raycast.cu).

    mkdir -p _scratch/parent
    git archive <commit> pathtrace_tpu_torch/csrc | tar -x -C _scratch/parent
    python tools/torch_kd_ab.py \\
        --variant parent=_scratch/parent/pathtrace_tpu_torch/csrc \\
        --variant tree=pathtrace_tpu_torch/csrc --runs 20 --spp 64 --render-runs 10

Each --variant NAME=DIR is a directory holding a kd_raycast.cu and the
headers it includes. It is compiled with build.py's flags (-fmad=false, no
fast math) into its own library under pathtrace_tpu_torch/_build/ab/, all
at once (tools/torch_bounce_ab.py::build_variant), and driven on one card
through this package's wrapper (ops/cuda/kd_raycast.py::launch), with the
variant's launcher in place of the package's (a library without
pt_kd_occupancy, the one-thread-a-ray kernel of earlier commits, through a
plain ctypes entry of the same signature). Jobs, on blob82k with KD cells
of 1024:

- probe: kd_raycast.probe_rays' camera rays at 256x256 and 65,536 surface
  and shadow rays, each in both modes: --runs launches of every
  configuration in turns (forward on even runs, backward on odd ones),
  each between two CUDA events; median, min and max ms a launch (--runs 0:
  the bit-equality check alone);
- render: 256x256 renders through the wavefront engine at lanes 65,536 in
  one chunk (render_wavefront_chunked, the mesh path): --render-runs rounds
  at --spp, each a render of every configuration, in turns (forward on
  even rounds, backward on odd ones: A B B A for two), each its wall ms and
  the process's CPU seconds; with two configurations, the rounds in which
  the second's wall is the longer; then one render of each at
  --profile-spp (default --spp, 0: none) under torch.profiler: the device
  ms of the KD kernels (every device kernel whose name holds pt::kd), the
  KD calls, the device-busy ms, and, at --spp, the device's idle share
  against the median wall.

It fails unless every configuration's output is bit-equal to the plain
version's (ops/kd_raycast.py::kd_closest_plain) on every probe set and
mode, and every configuration's image and ray count are bit-equal to the
first's. Prints one line per build (ptxas registers and spills), one per
job and configuration, the card's name and power limit, and one JSON line
with all of it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_bounce_ab import build_variant  # noqa: E402


class OneThreadLauncher:
    """The ctypes entry of the one-thread-a-ray kernel of earlier commits
    behind the interface of ops/cuda/kd_raycast.py::Launcher."""

    def __init__(self, lib):
        self.fn = lib.pt_kd_raycast
        self.fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 16
        self.fn.restype = ctypes.c_int

    def __call__(self, num_rays, num_cells, closest, ptrs, stream):
        return self.fn(num_rays, num_cells, closest, *ptrs, stream)


def build_all(variants: dict) -> dict:
    """{name: (launcher, ptxas lines)}: every variant's kd_raycast.cu
    compiled at once (one nvcc each), then linked."""
    from pathtrace_tpu_torch.ops.cuda import build
    from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel

    nvcc = build.find_nvcc()
    dirs = {n: build_variant(n, d) for n, d in variants.items()}
    names = list(dirs)
    obj = {n: os.path.join(dirs[n], "kd_raycast.o") for n in names}
    lib = {n: os.path.join(dirs[n], "libkd.so") for n in names}
    results = build._run_all([build.compile_command(nvcc, os.path.join(dirs[n], "kd_raycast.cu"),
                                                    obj[n]) for n in names])
    for n, (rc, out) in zip(names, results):
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{out}")
    links = build._run_all([build.link_command(nvcc, [obj[n]], lib[n]) for n in names])
    for n, (rc, out) in zip(names, links):
        if rc != 0:
            raise RuntimeError(f"link failed for {n}:\n{out}")
    out = {}
    for n, (_, log) in zip(names, results):
        cdll = ctypes.CDLL(lib[n])
        launcher = (kd_kernel.Launcher(cdll) if hasattr(cdll, "pt_kd_occupancy")
                    else OneThreadLauncher(cdll))
        out[n] = (launcher, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, metavar="NAME=DIR")
    ap.add_argument("--runs", type=int, default=20, help="launches a probe job and configuration")
    ap.add_argument("--spp", type=int, default=8, help="samples per pixel of the render job")
    ap.add_argument("--profile-spp", type=int, default=None,
                    help="samples per pixel of the profiled render (default --spp; 0: none)")
    ap.add_argument("--render-runs", type=int, default=2, help="0: no render job")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel
    from pathtrace_tpu_torch.utils import rng
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = bench.nvidia_smi_line()
    variants = dict(v.split("=", 1) for v in args.variant)
    libs = build_all(variants)
    for n, (launcher, ptxas) in libs.items():
        print(f"[build] {n}: {' | '.join(ptxas)}", flush=True)
    configs = list(libs)
    profile_spp = args.spp if args.profile_spp is None else args.profile_spp

    def use(c):
        """Launch variant c's kernel where the package launches its own."""
        launcher = libs[c][0]
        kd_kernel._launcher = lambda: launcher

    scene = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024).to(dev)
    cam = procedural.default_camera(256, 256)
    rays = kd.probe_rays(scene, cam, 256 * 256, seed=3)
    report = {"card": smi, "runs": args.runs, "builds": {n: p for n, (_, p) in libs.items()},
              "occupancy": {}, "probe": {}, "render": {}}
    for c in configs:
        if isinstance(libs[c][0], kd_kernel.Launcher):
            use(c)
            occ = kd_kernel.occupancy(scene.clusters.num_clusters)
            report["occupancy"][c] = occ
            print(f"[occupancy] {c}: {json.dumps(occ)}", flush=True)

    unequal = []
    for name, ray_args in rays.items():
        for mode in kd.MODES:
            plain = kd.kd_closest_plain(scene.clusters, *ray_args, mode)
            times = {c: [] for c in configs}
            for c in configs:  # warm-up and the bit-equality check
                use(c)
                out = kd_kernel.launch(scene.clusters, *ray_args, mode)
                differ = [int((a != b).sum()) for a, b in zip(out, plain)]
                if any(differ):
                    unequal.append(f"{c} on {name} rays, {mode}: rays differing in "
                                   f"(hit, t, u, v, prim_id) {differ}")
                    print(f"[probe] NOT BIT-EQUAL {unequal[-1]}", flush=True)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            for i in range(args.runs):
                for c in (configs if i % 2 == 0 else configs[::-1]):
                    use(c)
                    torch.cuda.synchronize()
                    ev[0].record()
                    kd_kernel.launch(scene.clusters, *ray_args, mode)
                    ev[1].record()
                    torch.cuda.synchronize()
                    times[c].append(ev[0].elapsed_time(ev[1]))
            job = report["probe"][f"{name}/{mode}"] = {}
            for c in configs if args.runs else []:
                t = times[c]
                med = statistics.median(t)
                job[c] = {"median_ms": med, "min_ms": min(t), "max_ms": max(t)}
                print(f"[probe] {name} {mode} {c}: median {med:.4f} ms (min {min(t):.4f}, "
                      f"max {max(t):.4f}) over {len(t)} launches", flush=True)
    if unequal:
        raise RuntimeError("not bit-equal to the plain version: " + "; ".join(unequal))
    print("[probe] every configuration bit-equal to the plain version on every set and mode",
          flush=True)
    if args.render_runs < 1:
        print(smi)
        print(json.dumps(report))
        return 0

    cfg = IntegratorConfig()
    key = rng.iter_key(rng.make_key(0), 1000)  # profile_main's pass key

    def render(c, spp: int, profiled: bool):
        """(image, rays), timings: wall ms and the process's CPU seconds of
        one render, or under the profiler the device ms of everything and of
        the KD kernels."""
        use(c)
        calls = kd_kernel.LAUNCHES
        run = lambda: render_wavefront_chunked(scene, cam, spp, key, cfg, bench.MESH_LANES,
                                               chunk_spp=spp, device=dev)
        if not profiled:
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            out = run()
            torch.cuda.synchronize()
            return out, {"wall_ms": (time.perf_counter() - t0) * 1e3,
                         "cpu_s": time.process_time() - c0}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        kd_events = [e for e in events if "pt::kd" in e.key]
        return out, {
            "device_busy_ms": sum(e.self_device_time_total for e in events) / 1e3,
            "kd_device_ms": sum(e.self_device_time_total for e in kd_events) / 1e3,
            "kd_calls": kd_kernel.LAUNCHES - calls,
            "kd_kernels": {e.key: [e.self_device_time_total / 1e3, e.count] for e in kd_events}}

    outs, walls, cpus = {}, {c: [] for c in configs}, {c: [] for c in configs}
    for c in configs:  # warm-up
        outs[c] = render(c, args.spp, False)[0]
    for i in range(args.render_runs):  # wall clock, in turns, before any profiling
        for c in (configs if i % 2 == 0 else configs[::-1]):
            (img, n_rays), row = render(c, args.spp, False)
            walls[c].append(row["wall_ms"])
            cpus[c].append(row["cpu_s"])
            if not (torch.equal(img, outs[c][0]) and n_rays == outs[c][1]):
                raise RuntimeError(f"render {c}: a run differs from the warm-up")
    ref = outs[configs[0]]
    for c in configs:
        if not (torch.equal(outs[c][0], ref[0]) and outs[c][1] == ref[1]):
            raise RuntimeError(f"render: {c} is not bit-equal to {configs[0]}")
        wall = statistics.median(walls[c])
        report["render"][c] = {"spp": args.spp, "wall_ms": walls[c], "wall_ms_median": wall,
                               "cpu_s": cpus[c], "rays": outs[c][1]}
        print(f"[render] blob82k 256x256@{args.spp}spp lanes {bench.MESH_LANES} {c}: wall "
              f"{', '.join(f'{w:.1f}' for w in walls[c])} ms (median {wall:.1f}); process CPU "
              f"{', '.join(f'{x:.2f}' for x in cpus[c])} s (median "
              f"{statistics.median(cpus[c]):.2f}); rays {outs[c][1]}", flush=True)
    print(f"[render] every configuration bit-equal to {configs[0]} (image and rays)", flush=True)
    if len(configs) == 2:
        a, b = configs
        longer = sum(y > x for x, y in zip(walls[a], walls[b]))
        report["render"]["rounds_second_longer"] = [longer, len(walls[a])]
        print(f"[render] {b}'s wall longer than {a}'s in {longer} of {len(walls[a])} rounds; "
              f"median of {b} / {a} per round "
              f"{statistics.median(y / x for x, y in zip(walls[a], walls[b])):.4f}", flush=True)
    for c in configs if profile_spp else []:
        row = render(c, profile_spp, True)[1]
        calls, kd_ms, busy = row["kd_calls"], row["kd_device_ms"], row["device_busy_ms"]
        report["render"][c]["profiled"] = {**row, "spp": profile_spp}
        idle = ""
        if profile_spp == args.spp:
            idle_share = 1 - busy / report["render"][c]["wall_ms_median"]
            report["render"][c]["idle_share"] = idle_share
            idle = f"; idle share {idle_share:.4f} against the median wall"
        print(f"[render] profiled blob82k 256x256@{profile_spp}spp {c}: KD device {kd_ms:.3f} ms "
              f"over {calls} calls ({kd_ms / calls:.4f} ms a call; kernels "
              f"{json.dumps(row['kd_kernels'])}); device busy {busy:.3f} ms{idle}", flush=True)
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
