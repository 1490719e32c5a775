"""Same-card A/B of builds of the bounce kernel (csrc/bounce_kernel.cu).

    mkdir -p _scratch/parent
    git archive <commit> pathtrace_tpu_torch/csrc | tar -x -C _scratch/parent
    python tools/torch_bounce_ab.py \\
        --variant parent=_scratch/parent/pathtrace_tpu_torch/csrc \\
        --variant tree=pathtrace_tpu_torch/csrc --lanes 65536,131072 --runs 5

Each --variant NAME=DIR is a directory holding a bounce_kernel.cu and the
headers it includes, with the same PtParams and table layouts as this
package. Each is compiled with build.py's flags (-fmad=false, no fast math)
into its own library under pathtrace_tpu_torch/_build/ab/, all at once, and
driven on one card through the fused engine's own chunk code
(ops/cuda/bounce_kernel.py::fused_chunk), with the variant's launcher in
place of the package's. A configuration is a variant at one lane count.
Jobs:

- b1: one launch at 256x256 @ 32 spp on Cornell + spheres (chip_smoke.py
  phase 4's kernel shape), CUDA events around the launch;
- cornell: the main path, Cornell + spheres 256x256 @ 1024 spp in 4
  launches of 256 spp (the call `cli render --engine fused` makes), host
  wall clock around a synchronized render;
- glass: glass_scene() at the same shape;
- kd: one launch of the KD variant at 256x256 @ 32 spp on the benchmark's
  refscene_blob82k, KD cells of 1024 (chip_smoke.py phase 10's shape), CUDA
  events around the launch. A variant's pt_bounce_render_kd takes the
  arguments of this package's.

--jobs picks among them (all four by default).

Every configuration is warmed up once, then each job runs --runs times,
the configurations in turns (forward on even runs, backward on odd ones:
parent, change, change, parent). Every variant at one lane count computes
the same function, so the script fails unless their images and ray counts
are bit-equal. Prints one line per build (ptxas registers and spills), one
per job and configuration (median, min, max, every run), and one JSON line
with all of it and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_variant(name: str, src_dir: str) -> str:
    """A build directory of its own for one variant, named by a hash of its
    sources, with the sources copied in."""
    from pathtrace_tpu_torch.ops.cuda import build

    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for f in sorted(os.listdir(src_dir)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(src_dir, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    out_dir = os.path.join(build.BUILD_DIR, "ab", f"{name}-{h.hexdigest()[:12]}")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src_dir, f), out_dir)
    return out_dir


def build_all(variants: dict) -> dict:
    """{name: (ctypes library, ptxas lines)}: every variant compiled at once
    (one nvcc each), then linked."""
    from pathtrace_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    dirs = {n: build_variant(n, d) for n, d in variants.items()}
    cu = {n: os.path.join(d, "bounce_kernel.cu") for n, d in dirs.items()}
    obj = {n: os.path.join(d, "bounce_kernel.o") for n, d in dirs.items()}
    lib = {n: os.path.join(d, "lib.so") for n, d in dirs.items()}
    names = list(dirs)
    results = build._run_all([build.compile_command(nvcc, cu[n], obj[n]) for n in names])
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, metavar="NAME=DIR")
    ap.add_argument("--lanes", default="65536", help="comma-separated lane counts")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--jobs", default="b1,cornell,glass,kd", help="comma-separated jobs")
    args = ap.parse_args(argv)

    import torch

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import accumulate_chunks
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.utils import rng
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    variants = dict(v.split("=", 1) for v in args.variant)
    libs = build_all(variants)
    fns = {n: (bk.render_fn_of(lib), bk.render_kd_fn_of(lib)) for n, (lib, _) in libs.items()}
    for n, (_, ptxas) in libs.items():
        print(f"[build] {n}: {' | '.join(ptxas)}", flush=True)
    lanes_list = [int(x) for x in args.lanes.split(",")]
    configs = [(n, lanes) for n in variants for lanes in lanes_list]

    cam = procedural.default_camera(256, 256)
    key = rng.iter_key(rng.make_key(0), 1000)  # the main path's pass key
    cfg = IntegratorConfig()
    packs = {"cornell": bk.build_fused_pack(
        procedural.cornell_box_scene(include_spheres=True).to(dev)),
             "glass": bk.build_fused_pack(procedural.glass_scene().to(dev))}
    names = args.jobs.split(",")
    if "kd" in names:
        from benchmark import program, scenes

        with open(os.path.join(REPO, "benchmark", "configs", "refscene_blob82k.json")) as f:
            config = json.load(f)
        packs["kd"] = bk.build_fused_pack(
            program.port_scene(scenes.scene_arrays(config), kd_max_tris=1024).to(dev))
        kd_view = (program.port_camera(config, 256, 256), program.port_config(config))

    def use(fn):
        """Launch the variant's launchers `fn` where the package launches
        its own."""
        bk._render_fn = lambda: fn[0]
        bk._render_kd_fn = lambda: fn[1]

    def one_launch(pack, camera, config):
        def run(fn, lanes):
            use(fn)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            out = bk.fused_chunk(pack, camera, 32, 0, key, config, lanes)
            ev[1].record()
            torch.cuda.synchronize()
            return out, ev[0].elapsed_time(ev[1])
        return run

    def path(scene):
        def run(fn, lanes):
            use(fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = accumulate_chunks(
                lambda n, o: bk.fused_chunk(packs[scene], cam, n, o, key, cfg, lanes),
                cam, 1024, 256, dev)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3
        return run

    runs = {"b1": one_launch(packs["cornell"], cam, cfg), "cornell": path("cornell"),
            "glass": path("glass")}
    if "kd" in packs:
        runs["kd"] = one_launch(packs["kd"], *kd_view)
    jobs = {job: runs[job] for job in names}
    report = {"card": bench.nvidia_smi_line(), "runs": args.runs,
              "builds": {n: p for n, (_, p) in libs.items()}, "jobs": {}}
    for job, run in jobs.items():
        times = {c: [] for c in configs}
        outs = {}
        for c in configs:  # warm-up
            outs[c] = run(fns[c[0]], c[1])[0]
        for i in range(args.runs):
            for c in (configs if i % 2 == 0 else configs[::-1]):
                (img, rays), ms = run(fns[c[0]], c[1])
                times[c].append(ms)
                if not (torch.equal(img, outs[c][0]) and rays == outs[c][1]):
                    raise RuntimeError(f"{job} {c}: a run differs from the warm-up")
        for lanes in lanes_list:
            ref = outs[configs[0][0], lanes]
            for n in variants:
                img, rays = outs[n, lanes]
                if not (torch.equal(img, ref[0]) and rays == ref[1]):
                    raise RuntimeError(f"{job}: {n} at lanes {lanes} is not bit-equal to "
                                       f"{configs[0][0]}")
        paths = 256 * 256 * (32 if job in ("b1", "kd") else 1024)
        report["jobs"][job] = {}
        for c in configs:
            t = times[c]
            med = statistics.median(t)
            row = {"median_ms": med, "min_ms": min(t), "max_ms": max(t), "runs_ms": t,
                   "paths_per_sec": paths / med * 1e3, "rays": outs[c][1]}
            report["jobs"][job][f"{c[0]}@{c[1]}"] = row
            print(f"[{job}] {c[0]} lanes {c[1]}: median {med:.3f} ms (min {min(t):.3f}, max "
                  f"{max(t):.3f}; {paths / med * 1e-3:.3f}M paths/s), runs "
                  f"{', '.join(f'{x:.3f}' for x in t)}; rays {outs[c][1]}", flush=True)
        print(f"[{job}] every variant bit-equal at each lane count (image and rays)", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
