"""GPU smoke run of the PyTorch/CUDA port (pathtrace_tpu_torch).

    python3 chip_smoke.py

Drives the port's two paths on one NVIDIA GPU: the main path, the Cornell
box with two spheres at 256x256 @ 1024 spp through the fused engine's CUDA
bounce kernel (the call `cli render --engine fused` makes), and the mesh
path, blob82k at 256x256 @ 64 spp through the wavefront engine and the KD
raycast kernel (the call `BENCH_SCENE=mesh` benchmarks). Phases, one line
each (or one per comparison):

  1. environment: torch, CUDA, nvcc, the card's name and power limit;
     fails unless the card is compute capability 9.0 (Hopper);
  2. build: compiles csrc/*.cu with nvcc (seconds);
  3. kernel vs its plain PyTorch version on the card, at the JAX package's
     bars between its engines (tests/test_fused.py);
  4. main path: the 256^2 @ 1024 spp render on the kernel (launch count,
     finite image, rays per path, mean within 2% of the plain version at
     32 spp, seconds, paths/s, rays/s); the kernel against its plain version
     at the main path's scene, film and lanes at 32 spp (times; > 99% of
     pixels within 1e-3, ray counts within 1e-5); then the CLI once as a
     subprocess;
  5. the mesh path: blob82k (the 82k-triangle OBJ asset in the Cornell
     room, KD cells of 1024) through the wavefront engine and the KD
     raycast kernel. First the kernel against its plain version on 65,536
     camera rays at 256x256, 65,536 rays leaving the surface and 65,536
     shadow rays, in both modes (hit and prim_id agree on >= 99.99% of
     rays, t/u/v within 1e-6 relative where both hit the same triangle;
     times). Then 256x256 @ 64 spp in chunks of 64 spp at the bench's lanes
     (launch count, finite image, rays per path, seconds, paths/s, rays/s);
     the same path through the plain version at 4 spp (times; > 99% of
     pixels within 1e-3, rays within 1e-5, means within 2%); 48x48 @ 4 spp
     against the committed golden (tests/golden/blob82k_48x48_4spp_seed11.npy,
     at tools/tpu_cpu_agreement.py's bar); then `cli render --preset
     mesh512` at 64x64 @ 4 spp as a subprocess.

It then prints the card line, a JSON line describing each kernel, and last
{"ok": true, "device": {...}}. Any failure raises (non-zero exit) and no
result line is printed. Needs no network; imports no JAX.
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


def fail(msg: str):
    raise RuntimeError(msg)


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


def kd_compare(mesh, cam) -> tuple[float, float, float]:
    """[5 kd compare]: the KD kernel against its plain version on the card,
    on 65,536 camera, surface and shadow rays in both modes. Returns the
    kernel's and the plain version's ms for the camera rays in closest mode
    (the wavefront's first bounce at 256x256) and the largest t/u/v error."""
    from pathtrace_tpu_torch.ops import kd_raycast as kd

    rays = kd.probe_rays(mesh, cam, cam.width * cam.height, seed=3)
    kd.kd_closest(mesh.clusters, *rays["camera"], "closest")  # loads the library
    timing, max_err = None, 0.0
    for name, args in rays.items():
        for mode in kd.MODES:
            k, k_ms = timed(lambda: kd.kd_closest(mesh.clusters, *args, mode))
            p, p_ms = timed(lambda: kd.kd_closest_plain(mesh.clusters, *args, mode))
            same = (k[0] == p[0]) & (~p[0] | (k[4] == p[4]))
            agree = same.double().mean().item()
            both = same & p[0]
            err, close = 0.0, True
            for a, b in ((a[both], b[both]) for a, b in zip(k[1:4], p[1:4])):
                e = (a - b).abs()
                err = max(err, e.max().item() if e.numel() else 0.0)
                close = close and bool((e <= 1e-6 + 1e-6 * b.abs()).all())
            max_err = max(max_err, err)
            print(f"[5 kd compare] {name} rays {args[0].shape[0]} {mode}: hit rate "
                  f"{p[0].double().mean().item():.4f}, hit+prim_id agreement {agree:.6f}, "
                  f"max abs err t/u/v {err:.3e}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                  f"({p_ms / k_ms:.1f}x)", flush=True)
            if agree < 0.9999 or not close:
                fail(f"KD kernel disagrees with its plain version ({name}, {mode})")
            if (name, mode) == ("camera", "closest"):
                timing = (k_ms, p_ms)
    return timing[0], timing[1], max_err


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
    k_ms, p_ms, max_err = kd_compare(mesh, cam)

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
    # the plain search: same paths and same winners, film sums reordered
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
    if agree <= 0.99 or rays_rel > 1e-5:
        fail("the mesh path through the kernel disagrees with its plain version")
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
            "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_stats
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    from pathtrace_tpu_torch.ops.cuda import build
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

    # 3. kernel vs plain version on the card (bars of tests/test_fused.py)
    cfg = IntegratorConfig()
    cam32 = procedural.default_camera(32, 32)
    key = rng.make_key(5)
    for spheres, spp in ((False, 8), (True, 16)):
        scene = procedural.cornell_box_scene(include_spheres=spheres).to("cuda")
        a, rays_a = bk.render_wavefront_fused(scene, cam32, spp, key, cfg, lanes=1024,
                                              chunk_spp=spp, device="cuda")
        b, rays_b = render_wavefront_stats(scene, cam32, spp, key, cfg, lanes=1024,
                                           device="cuda")
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
    # agreement, ray counts, means. Both sides draw the same Philox streams
    # and round alike (-fmad=false, IEEE division), so only a rare last-ulp
    # fork of a sphere path may differ: > 99% of pixels within 1e-3, rays
    # within 1e-5.
    (k_img, k_rays), k_ms = timed(lambda: bk.render_wavefront_fused(
        scene, cam, 32, pass_key, cfg, lanes=lanes, chunk_spp=32, device="cuda"))
    (p_img, p_rays), p_ms = timed(lambda: render_wavefront_stats(
        scene, cam, 32, pass_key, cfg, lanes=lanes, device="cuda"))
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
    if agree <= 0.99 or rays_rel > 1e-5:
        fail("kernel disagrees with its plain version at the main path's shape")

    with tempfile.TemporaryDirectory() as tmp:
        run_cli(["--preset", "cornell64", "--engine", "fused"],
                os.path.join(tmp, "cornell64.png"), 64, "4 cli")

    kd_entry = mesh_phase(smi)

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
    }, kd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
