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
"""

from __future__ import annotations

import json
import os
import time


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
                         for e in kernels if e.key.startswith("pt::")],
        "card": bench.nvidia_smi_line(),
    }))


if __name__ == "__main__":
    main()
