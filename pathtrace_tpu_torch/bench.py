"""Headline benchmark of the port: rays/s on one GPU.

    python -m pathtrace_tpu_torch.bench
    BENCH_SCENE=mesh python -m pathtrace_tpu_torch.bench

Prints ONE JSON line with the schema of the repo's bench.py:
{"metric", "value", "unit", "vs_baseline", "detail"}. vs_baseline is camera
paths/s over BASELINE.md's derived ~54M paths/s for the reference (a
GTX-10xx figure, not a measurement of this port). rays/s counts closest-hit
plus shadow traversals, as bench.py does.

Scenes: cornell and glass render with the fused CUDA engine (the CLI's
call, chunks of 256 spp; default 256x256 @ 1024 spp). mesh is blob82k
(assets/blob82k.obj in the Cornell room, KD cells of 1024) through the
wavefront engine and the KD raycast kernel, chunks of 64 spp (default
256x256 @ 64 spp, 65536 lanes), as the JAX bench.py renders it.

Environment: BENCH_SCENE=cornell|glass|mesh, BENCH_W, BENCH_H, BENCH_SPP,
BENCH_LANES, BENCH_CHUNK, BENCH_REPEATS. Needs a CUDA device; there is no
CPU fallback.
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


def nvcc_version() -> str:
    from pathtrace_tpu_torch.ops.cuda import build
    try:
        nvcc = build.find_nvcc()
    except RuntimeError:
        return "unavailable"
    return _run([nvcc, "--version"]).splitlines()[-1]


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
        raise ValueError(f"BENCH_SCENE={which!r}: the port has cornell, glass and mesh")
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
