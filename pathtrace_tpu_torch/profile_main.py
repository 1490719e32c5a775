"""Where the main path's time goes on one GPU, under torch.profiler.

    python -m pathtrace_tpu_torch.profile_main

Runs the call `cli render --engine fused` makes (Cornell box with two
spheres, 256x256 @ 1024 spp, chunks of 256 spp) once to warm up, then once
under torch.profiler, and prints ONE JSON line: wall ms of the profiled
render, device-busy ms (sum of the device time of every op), the device's
idle share (1 - busy / wall), and the device ms and call count of the ops
that took the most device time, with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import time


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.utils import rng
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    scene = procedural.cornell_box_scene(include_spheres=True).to(dev)
    camera = procedural.default_camera(256, 256)
    key = rng.iter_key(rng.make_key(0), 1000)
    cfg = IntegratorConfig()
    spp = 1024

    def run(n):
        return bk.render_wavefront_fused(scene, camera, n, key, cfg,
                                         lanes=bk.auto_fused_config(256 * 256),
                                         chunk_spp=min(n, 256), device=dev)

    run(4)  # warm-up: builds the kernel library and launches it once
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img, rays = run(spp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("non-finite pixels in the profiled image")
    ops = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(json.dumps({
        "job": f"cornell+spheres 256x256@{spp}spp fused",
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "paths_per_sec": 256 * 256 * spp / wall_ms * 1e3,
        "rays_per_path": rays / (256 * 256 * spp),
        "top_ops": [{"name": e.key, "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in ops[:6]],
        "card": bench.nvidia_smi_line(),
    }))


if __name__ == "__main__":
    main()
