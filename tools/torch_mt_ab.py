"""Same-card A/B of builds of the all-triangles kernel (csrc/mt_closest.cu).

    mkdir -p _scratch/parent
    git archive <commit> pathtrace_tpu_torch/csrc | tar -x -C _scratch/parent
    python tools/torch_mt_ab.py \\
        --variant parent=_scratch/parent/pathtrace_tpu_torch/csrc \\
        --variant tree=pathtrace_tpu_torch/csrc --rounds 4 --train-runs 4

Each --variant NAME=DIR is a directory holding a mt_closest.cu and the
headers it includes, with the C entry pt_mt_closest of this package. It is
compiled with build.py's flags (-fmad=false, no fast math) into its own
library under pathtrace_tpu_torch/_build/ab/, all at once
(tools/torch_bounce_ab.py::build_variant), and driven on one card through
this package's wrapper (ops/cuda/mt_closest.py::launch) with the variant's
launcher in place of the package's.

Inputs, all on Cornell + spheres (38 triangles) unless named:
- the train sweep: the (org, dir, t_min, t_max, mode) of every launch of
  one recording sweep of the train step (BENCH_SCENE=train's problem,
  128x128 @ --spp, one lane a path; bench.train_sweep_searches);
- probe sets: kd_raycast.probe_rays' camera rays at 256x256 and 65,536
  surface and shadow rays, camera rays on the 1,294-triangle
  sphere_mesh_scene(3) and on the 5,134-triangle sphere_mesh_scene(4);
- edge sets, checked and not timed: ragged ray counts 1, 31, 129 and 65,537
  of random rays, and an empty (0, 9) table.

Every variant's (hit, t, idx, u, v) must equal the plain version's
(ops/mt_closest.py::mt_closest_plain) bit for bit on every set and mode
(the variants named by --skip-empty skip the empty table: the kernel
of earlier commits gave idx -1 there). Times: in each of --rounds rounds
every variant in turns (forward on even rounds, backward on odd ones: A B
B A for two), the mean ms of --launches back-to-back launches of each probe
set and mode, and of the whole sweep (--launches repetitions of its
launches), once between two CUDA events (host time between launches
included where the host is slower than the card) and once as the device
time that torch.profiler records; per variant the medians over rounds. With
--train-runs N, N rounds of one train step each (bench.make_train_step at
128x128 @ --spp) in turns: seconds a step. Prints one line per build
(ptxas registers and spills, resident warps per SM), one per job and
variant, the card's name and power limit, and one JSON line with all of it.
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


def build_all(variants: dict) -> dict:
    """{name: (ctypes library, ptxas lines)}: every variant's mt_closest.cu
    compiled at once (one nvcc each), then linked."""
    from pathtrace_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    dirs = {n: build_variant(n, d) for n, d in variants.items()}
    names = list(dirs)
    obj = {n: os.path.join(dirs[n], "mt_closest.o") for n in names}
    lib = {n: os.path.join(dirs[n], "libmt.so") for n in names}
    results = build._run_all([build.compile_command(nvcc, os.path.join(dirs[n], "mt_closest.cu"),
                                                    obj[n]) for n in names])
    for n, (rc, out) in zip(names, results):
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{out}")
    links = build._run_all([build.link_command(nvcc, [obj[n]], lib[n]) for n in names])
    for n, (rc, out) in zip(names, links):
        if rc != 0:
            raise RuntimeError(f"link failed for {n}:\n{out}")
    return {n: (ctypes.CDLL(lib[n]),
                [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln])
            for n, (_, out) in zip(names, results)}


def launcher_of(lib):
    fn = lib.pt_mt_closest
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


def occupancy_of(lib, num_tris: int):
    """(registers, local bytes, blocks per SM, threads a block), or None for
    a library without pt_mt_occupancy."""
    if not hasattr(lib, "pt_mt_occupancy"):
        return None
    out = (ctypes.c_int * 4)()
    lib.pt_mt_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.pt_mt_occupancy.restype = ctypes.c_int
    if lib.pt_mt_occupancy(num_tris, ctypes.addressof(out)) != 0:
        raise RuntimeError("occupancy query failed")
    return tuple(out)


def random_rays(n: int, dev, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    org = (torch.rand((n, 3), generator=g) * 70.0 - 25.0).to(dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1).to(dev)
    return org, d, torch.zeros((n,), device=dev), (torch.rand((n,), generator=g) * 80.0).to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=4, help="timing rounds (0: checks only)")
    ap.add_argument("--launches", type=int, default=20, help="launches a timed mean")
    ap.add_argument("--spp", type=int, default=64, help="samples per pixel of the train sweep")
    ap.add_argument("--train-runs", type=int, default=0, help="rounds of whole train steps")
    ap.add_argument("--skip-empty", action="append", default=[], metavar="NAME")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = bench.nvidia_smi_line()
    variants = dict(v.split("=", 1) for v in args.variant)
    libs = build_all(variants)
    configs = list(libs)
    fns = {c: launcher_of(libs[c][0]) for c in configs}

    def use(c):
        """Launch variant c's kernel where the package launches its own."""
        mt_kernel._closest_fn = lambda: fns[c]

    report = {"card": smi, "rounds": args.rounds, "launches": args.launches, "builds": {},
              "sets": {}, "sweep": {}, "train": {}}

    use(configs[0])
    scene, sweep = bench.train_sweep_searches(dev, args.spp)
    cam = procedural.default_camera(256, 256)
    sets = {f"cornell+spheres {k}": (scene, v)
            for k, v in kd.probe_rays(scene, cam, 256 * 256, seed=3).items()}
    for sub in (3, 4):
        s = procedural.sphere_mesh_scene(sub).to(dev)
        sets[f"sphere_mesh{sub} camera"] = (s, kd.probe_rays(s, cam, 4, seed=3)["camera"])
    timed_sets = list(sets)
    for n in (1, 31, 129, 65537):
        sets[f"ragged {n}"] = (scene, random_rays(n, dev, n))
    empty = procedural.sphere_only_scene().to(dev)
    sets["empty table"] = (empty, random_rays(4096, dev, 7))
    for c in configs:
        occ = {n: occupancy_of(libs[c][0], n) for n in (38, 5134)}
        report["builds"][c] = {"ptxas": libs[c][1], "occupancy": occ}
        warps = {n: o[2] * o[3] // 32 for n, o in occ.items() if o}
        print(f"[build] {c}: {' | '.join(libs[c][1])}; resident warps per SM at 38 / 5,134 "
              f"rows {warps or 'not queried'}", flush=True)

    unequal = []

    def check(c, name, out, plain):
        differ = [int((a != b).sum()) for a, b in zip(out, plain)]
        if any(differ):
            unequal.append(f"{c} on {name}: rays differing in (hit, t, idx, u, v) {differ}")
            print(f"[check] NOT BIT-EQUAL {unequal[-1]}", flush=True)

    for name, (s, rays) in sets.items():
        for mode in mt.MODES:
            plain = mt.mt_closest_plain(s.tris, *rays, mode)
            for c in configs:
                if name == "empty table" and c in args.skip_empty:
                    continue
                use(c)
                check(c, f"{name} {mode}", mt_kernel.launch(s.tris.search_table, *rays, mode),
                      plain)
    for j, (*rays, mode) in enumerate(sweep):
        plain = mt.mt_closest_plain(scene.tris, *rays, mode)
        for c in configs:
            use(c)
            check(c, f"sweep launch {j} {mode}",
                  mt_kernel.launch(scene.tris.search_table, *rays, mode), plain)
    if unequal:
        raise RuntimeError("not bit-equal to the plain version: " + "; ".join(unequal))
    print(f"[check] every variant bit-equal to the plain version on every set and mode and on "
          f"the {len(sweep)} sweep launches", flush=True)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def mean_ms(fn, reps: int) -> tuple[float, float]:
        """(ms between two CUDA events, device ms under torch.profiler), each
        over reps calls of fn, divided by reps."""
        fn()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        return ev[0].elapsed_time(ev[1]) / reps, busy / 1e3 / reps

    def run_sweep():
        for *rays, mode in sweep:
            mt_kernel.launch(scene.tris.search_table, *rays, mode)

    times = {c: {} for c in configs}
    for i in range(args.rounds):
        for c in (configs if i % 2 == 0 else configs[::-1]):
            use(c)
            for name in timed_sets:
                s, rays = sets[name]
                for mode in mt.MODES:
                    ms = mean_ms(lambda: mt_kernel.launch(s.tris.search_table, *rays, mode),
                                 args.launches)
                    times[c].setdefault(f"{name} {mode}", []).append(ms)
            times[c].setdefault("sweep", []).append(mean_ms(run_sweep, args.launches))
    for c in configs if args.rounds else []:
        for job, t in times[c].items():
            ev_ms, dev_ms = [x[0] for x in t], [x[1] for x in t]
            med, dmed = statistics.median(ev_ms), statistics.median(dev_ms)
            row = {"ms": ev_ms, "median_ms": med, "device_ms": dev_ms, "median_device_ms": dmed}
            if job == "sweep":
                report["sweep"][c] = row
                print(f"[sweep] {len(sweep)} launches of {sweep[0][0].shape[0]} rays {c}: median "
                      f"{med:.4f} ms a sweep ({med / len(sweep):.5f} a launch), device "
                      f"{dmed:.4f} ms ({dmed / len(sweep):.5f} a launch); device rounds "
                      f"{', '.join(f'{x:.4f}' for x in dev_ms)}", flush=True)
            else:
                report["sets"].setdefault(job, {})[c] = row
                print(f"[probe] {job} {c}: median {med:.5f} ms, device {dmed:.5f} ms (means of "
                      f"{args.launches}); device rounds {', '.join(f'{x:.5f}' for x in dev_ms)}",
                      flush=True)

    if args.train_runs:
        step = bench.make_train_step(dev)
        walls = {c: [] for c in configs}
        for c in configs:  # warm-up
            use(c)
            step(1)
        for i in range(args.train_runs):
            for c in (configs if i % 2 == 0 else configs[::-1]):
                use(c)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(args.spp)
                torch.cuda.synchronize()
                walls[c].append(time.perf_counter() - t0)
        for c in configs:
            report["train"][c] = {"seconds": walls[c], "median_s": statistics.median(walls[c])}
            print(f"[train] step 128x128@{args.spp}spp {c}: {', '.join(f'{x:.3f}' for x in walls[c])}"
                  f" s (median {statistics.median(walls[c]):.3f})", flush=True)
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
