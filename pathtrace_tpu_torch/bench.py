"""Headline benchmark of the port: rays/s on one GPU.

    python -m pathtrace_tpu_torch.bench
    BENCH_SCENE=mesh python -m pathtrace_tpu_torch.bench
    BENCH_SCENE=train python -m pathtrace_tpu_torch.bench

Prints ONE JSON line with the schema of the repo's bench.py:
{"metric", "value", "unit", "vs_baseline", "detail"}. vs_baseline is camera
paths/s over BASELINE.md's derived ~54M paths/s for the reference (a
GTX-10xx figure, not a measurement of this port). rays/s counts closest-hit
plus shadow traversals, as bench.py does.

Scenes: cornell and glass render with the fused CUDA engine (the CLI's
call, chunks of 256 spp; default 256x256 @ 1024 spp). mesh is blob82k
(assets/blob82k.obj in the Cornell room, KD cells of 1024) through the
wavefront engine and the KD raycast kernel, chunks of 64 spp (default
256x256 @ 64 spp, 65536 lanes), as the JAX bench.py renders it. train is
one training step (parallel/mesh.py::train_step_wavetape, the JAX package's
production step config, tools/gradcheck_tpu.py): Cornell + spheres,
128x128 @ 64 spp, L2 loss against a zero target; one wavefront recording
sweep through the all-triangles kernel, then the chunked replay backward.
Its line reports paths/s (value), seconds per step and the kernel's
launches per step; vs_baseline is null, since the reference renders only.

Environment: BENCH_SCENE=cornell|glass|mesh|train, BENCH_W, BENCH_H,
BENCH_SPP, BENCH_LANES, BENCH_CHUNK (train: paths per replay chunk),
BENCH_REPEATS.
Needs a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

REF_PATHS_PER_SEC = 54e6  # BASELINE.md derived ballpark (13-min DiffuseRoom)
# Default wavefront width of the mesh bench: one lane per pixel at 256x256,
# the static strided assignment. It ran 2-9% faster than the 49152 lanes
# (pool assignment) that the JAX bench chose against a TPU stride problem:
# fewer iterations, each bound by host-side launches (PERF.md).
MESH_LANES = 65536
# Recording lanes and replay chunk (paths) of the train step, chosen on an
# H100 at 128x128 @ 64 spp (PERF.md): with every path in one lane the
# recording sweep is 17 iterations instead of 186 at 65,536 lanes, and the
# step is bound by host-side launches per iteration, not by lane count.
# Chunks of 262,144 paths beat 65,536 (more chunks, each as costly on the
# host) and 1,048,576 (one chunk replays every path to the longest length).
TRAIN_LANES = 1048576
TRAIN_CHUNK = 262144


def _run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return out.stdout.strip()


def nvidia_smi_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return (out.splitlines() or ["unavailable"])[0]


def card_fields(dev) -> dict:
    """{"device", "card", "power_limit"} of a run on `dev`: the card's name
    and power limit as nvidia-smi prints them (first card), both None on the
    CPU, where no card was measured."""
    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        return {"device": str(dev), "card": None, "power_limit": None}
    name, _, limit = nvidia_smi_line().partition(", ")
    return {"device": str(dev), "card": name, "power_limit": limit or None}


def nvcc_version() -> str:
    from pathtrace_tpu_torch.ops.cuda import build
    try:
        nvcc = build.find_nvcc()
    except RuntimeError:
        return "unavailable"
    return _run([nvcc, "--version"]).splitlines()[-1]


def train_problem(dev, w: int = 128, h: int = 128):
    """(scene, camera, target, cfg, key) of BENCH_SCENE=train: Cornell +
    spheres at w x h against a zero target."""
    import torch

    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.utils import rng

    return (procedural.cornell_box_scene(include_spheres=True).to(dev),
            procedural.default_camera(w, h), torch.zeros((h, w, 3), device=dev),
            IntegratorConfig(), rng.make_key(0))


def make_train_step(dev, w: int = 128, h: int = 128, lanes: int = TRAIN_LANES,
                    chunk: int = TRAIN_CHUNK, search=None):
    """step(spp) -> (loss, (tri grads, sphere grads), image): the train
    step of train_problem (`search` as in megakernel.default_raycast)."""
    from pathtrace_tpu_torch.parallel.mesh import train_step_wavetape

    scene, camera, target, cfg, key = train_problem(dev, w, h)

    def step(spp: int):
        return train_step_wavetape(scene, camera, target, spp, key, cfg,
                                   lanes=min(lanes, w * h * spp),
                                   chunk=min(chunk, w * h * spp), device=dev,
                                   search=search)

    return step


def train_sweep_searches(dev, spp: int = 64, w: int = 128, h: int = 128):
    """(scene, [(org, dirn, t_min, t_max, mode), ...]): the inputs of every
    all-triangles search of one recording sweep of the train step (the
    kernel's launch shapes on the training path), captured by wrapping its
    search; each tuple holds copies, about 32 MB at 1,048,576 lanes."""
    from pathtrace_tpu_torch.diff.wavetape import record_paths_wavefront
    from pathtrace_tpu_torch.ops import mt_closest as mt

    scene, camera, _, cfg, key = train_problem(dev, w, h)
    calls = []

    def search(tris, org, dirn, t_min, t_max, mode):
        calls.append((org.clone(), dirn.clone(), t_min.clone(), t_max.clone(), mode))
        return mt.mt_closest(tris, org, dirn, t_min, t_max, mode)

    record_paths_wavefront(scene, camera, spp, key, cfg, min(TRAIN_LANES, w * h * spp),
                           search=search)
    return scene, calls


def check_train_output(loss, grads, img) -> None:
    """Raise unless the step's loss, grads and image are finite."""
    import torch

    from pathtrace_tpu_torch.diff.grad import MAT_FIELDS

    fields = [getattr(m, f) for m in grads for f in MAT_FIELDS]
    if not all(bool(torch.isfinite(x).all()) for x in [loss, img, *fields]):
        raise RuntimeError("non-finite loss, image or grads in the train step")


def train_bench(dev, repeats: int) -> None:
    """BENCH_SCENE=train: seconds per step, best of `repeats`, and the
    seconds of its recording sweep alone (the rest is the replay backward)."""
    import torch

    from pathtrace_tpu_torch.diff.wavetape import record_paths_wavefront
    from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel

    w = int(os.environ.get("BENCH_W", 128))
    h = int(os.environ.get("BENCH_H", 128))
    spp = int(os.environ.get("BENCH_SPP", 64))
    lanes = int(os.environ.get("BENCH_LANES", TRAIN_LANES))
    chunk = int(os.environ.get("BENCH_CHUNK", TRAIN_CHUNK))
    step = make_train_step(dev, w, h, lanes, chunk)
    step(1)  # warm-up: builds the kernel library and launches it
    torch.cuda.reset_peak_memory_stats(dev)  # the peak of the timed steps alone
    dt, launches = float("inf"), 0
    for _ in range(repeats):
        torch.cuda.synchronize()
        launches0 = mt_kernel.LAUNCHES
        t0 = time.perf_counter()
        loss, grads, img = step(spp)
        torch.cuda.synchronize()
        dt = min(dt, time.perf_counter() - t0)
        launches = mt_kernel.LAUNCHES - launches0
    check_train_output(loss, grads, img)
    paths = w * h * spp
    scene, camera, _, cfg, key = train_problem(dev, w, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    record_paths_wavefront(scene, camera, spp, key, cfg, min(lanes, paths))
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    smi = nvidia_smi_line()
    print(json.dumps({
        "metric": f"paths_per_sec_train_step_{w}x{h}_{spp}spp",
        "value": round(paths / dt, 1),
        "unit": "paths/s",
        "vs_baseline": None,
        "detail": {
            "seconds_per_step": round(dt, 4),
            "record_seconds": round(record_s, 4),
            "loss": loss.item(),
            "resolution": [w, h],
            "spp": spp,
            "lanes": lanes,
            "chunk_paths": chunk,
            "repeats": repeats,
            "engine": "wavetape-mt-cuda",
            "mt_closest_launches_per_step": launches,
            "peak_memory_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 3),
            "device": torch.cuda.get_device_name(dev),
            "power_limit": smi.split(",")[-1].strip(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc_version(),
        },
    }))


def main() -> None:
    import torch

    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel
    from pathtrace_tpu_torch.utils import rng
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    which = os.environ.get("BENCH_SCENE", "cornell")
    if which == "train":
        return train_bench(dev, int(os.environ.get("BENCH_REPEATS", 3)))
    mesh = which == "mesh"
    w = int(os.environ.get("BENCH_W", 256))
    h = int(os.environ.get("BENCH_H", 256))
    spp = int(os.environ.get("BENCH_SPP", 64 if mesh else 1024))
    default_lanes = MESH_LANES if mesh else bk.auto_fused_config(w * h)
    lanes = int(os.environ.get("BENCH_LANES", default_lanes))
    # fused: the CLI's chunking; mesh: the JAX bench's 64-spp chunks
    chunk = int(os.environ.get("BENCH_CHUNK", min(spp, 64 if mesh else 256)))
    repeats = int(os.environ.get("BENCH_REPEATS", 5))
    if which == "glass":
        scene = procedural.glass_scene()
    elif which == "cornell":
        scene = procedural.cornell_box_scene(include_spheres=True)
    elif mesh:
        scene = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024)
    else:
        raise ValueError(f"BENCH_SCENE={which!r}: the port has cornell, glass, mesh "
                         "and train")
    scene = scene.to(dev)
    camera = procedural.default_camera(w, h)
    cfg = IntegratorConfig()
    key = rng.make_key(0)

    if mesh:  # the wavefront engine; every ray goes through the KD kernel
        counter, engine = kd_kernel, "wavefront-kd-cuda"

        def run(n, c):
            return render_wavefront_chunked(scene, camera, n, key, cfg, lanes,
                                            chunk_spp=c, device=dev)
    else:
        counter, engine = bk, "fused-cuda"

        def run(n, c):  # the call `cli render --engine fused` makes
            return bk.render_wavefront_fused(scene, camera, n, key, cfg, lanes,
                                             chunk_spp=c, device=dev)

    run(4, 4)  # warm-up: builds the kernel library and launches it once
    torch.cuda.synchronize()
    launches0 = counter.LAUNCHES
    dt = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, nrays = run(spp, chunk)
        torch.cuda.synchronize()
        dt = min(dt, time.perf_counter() - t0)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("non-finite pixels in the benchmark image")

    paths = w * h * spp
    paths_per_sec = paths / dt
    rays_per_path = nrays / paths
    smi = nvidia_smi_line()
    print(json.dumps({
        "metric": f"rays_per_sec_per_gpu_{which}_{spp}spp",
        "value": round(paths_per_sec * rays_per_path, 1),
        "unit": "rays/s",
        "vs_baseline": round(paths_per_sec / REF_PATHS_PER_SEC, 4),
        "detail": {
            "paths_per_sec": round(paths_per_sec, 1),
            "rays_per_path": round(rays_per_path, 3),
            "resolution": [w, h],
            "spp": spp,
            "lanes": lanes,
            "chunk_spp": chunk,
            "seconds": round(dt, 4),
            "repeats": repeats,
            "engine": engine,
            "kernel_launches": counter.LAUNCHES - launches0,
            "device": torch.cuda.get_device_name(dev),
            "power_limit": smi.split(",")[-1].strip(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc_version(),
        },
    }))


if __name__ == "__main__":
    main()
