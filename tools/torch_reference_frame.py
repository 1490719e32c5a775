"""Render the reference's default job through the port's fused engine:
1080x2400 @ 8 passes x 1024 spp (the JAX package's tools/reference_frame.py).

The reference renders this job and nothing else (main.cpp:15-16 screen
size; CudaUtil.cuh:18-19 NUM_MULTI_SAMPLE=8 x NUM_SAMPLE=1024; a PNG after
every pass, pathtracer.cu:236-246). Cornell box with two spheres, kernel B1
(csrc/bounce_kernel.cu) at auto_fused_config(2,592,000) = 2,592,000 lanes,
one pixel a lane, in launches of 256 spp: 32 launches. One pass holds
2,592,000 x 1024 = 2,654,208,000 path ids, past 2**31 (utils/rng.py::
check_path_ids). The checkpoint (io/checkpoint.py) is written after every
pass; after pass 4 the accumulator is dropped and reloaded from disk before
the run goes on, as the JAX tool does.

    python tools/torch_reference_frame.py                  # on the card, ~2 min
    RF_W=12 RF_H=27 RF_PASSES=4 RF_SPP=2 RF_LANES=324 \\
        python tools/torch_reference_frame.py --device cpu --out-dir /tmp/rf

Environment: RF_W, RF_H, RF_PASSES, RF_SPP (spp a pass), RF_LANES (default
auto_fused_config), RF_CHUNK (spp a launch, 256), RF_RESUME_AT (pass after
which the accumulator is reloaded, 4; 0 for none). Prints one JSON summary;
on the card it also writes docs/torch_reference_frame.json (--json to write
elsewhere). The PNGs and the checkpoint go to --out-dir (_scratch/ by
default, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from pathtrace_tpu_torch import bench  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.io import checkpoint as ckpt  # noqa: E402
from pathtrace_tpu_torch.io import image as imageio  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import build  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.device import resolve_device  # noqa: E402

REFERENCE = ("the reference's default job (main.cpp:15-16, CudaUtil.cuh:18-19); its README's "
             "DiffuseRoom_MS8x2048spp_13min.png implies ~54M paths/s on a GTX-10xx "
             "(BASELINE.md)")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_bound(scene, camera, key, cfg, lanes: int, chunk_spp: int) -> dict:
    """The least time of one chunk_spp launch of B1 on this job, reckoned as
    chip_smoke.py reckons B1's, with the package's model
    (profile_main.bound, b1_ops): the work of the frame's first sample
    counted on the plain wavefront (profile_main.schedule_share), times
    chunk_spp; bytes: the scene and the film once."""
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.profile_main import (b1_ops, bound, mt_pair_ops,
                                                  schedule_share, tensor_bytes)

    table = scene.tris.search_table
    need = schedule_share(scene, camera, 1, key, cfg, lanes, search=mt.mt_closest_plain,
                          pair_ops=lambda org, dirn, *_: mt_pair_ops(table, org, dirn))
    ops = b1_ops(scene, need)
    ms, by = bound(ops * chunk_spp, tensor_bytes(scene) + 12 * camera.width * camera.height)
    return {"bound_ms_a_launch": ms, "bound_by": by, "operations_a_sample": ops,
            "rays_a_sample": need["rays"], "hits_a_sample": need["hits"]}


def render_job(width: int = 1080, height: int = 2400, passes: int = 8, spp: int = 1024, *,
               device="cuda", out_dir: str = os.path.join(REPO, "_scratch"), lanes=None,
               chunk_spp: int = 256, resume_at: int = 4, seed: int = 0, write_png: bool = True,
               with_bound: bool = False):
    """(summary dict, (H, W, 3) final image on the device) of `passes`
    passes of `spp` samples through the fused engine, pass p keyed
    rng.iter_key(make_key(seed), 1000 + p) as `cli render` keys it. The
    checkpoint is saved after every pass; after pass `resume_at` (0: never)
    the accumulator is dropped and reloaded from the file. PNGs of the
    running mean and the final image go to out_dir when write_png. On the
    card each launch of B1 is timed with CUDA events; with_bound adds the
    bound of a launch (launch_bound)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    scene = procedural.cornell_box_scene(include_spheres=True).to(dev)
    camera = procedural.default_camera(width, height)
    cfg, key = IntegratorConfig(), rng.make_key(seed)
    lanes = bk.auto_fused_config(width * height) if lanes is None else lanes
    chunk_spp = min(chunk_spp, spp)
    ck = os.path.join(out_dir, f"torch_reference_frame_{width}x{height}.ckpt.npz")
    build_s = 0.0
    if dev.type == "cuda":  # build the kernel library outside the timing
        t0 = time.perf_counter()
        build.load_library()
        build_s = time.perf_counter() - t0

    bk.LAUNCHES = 0
    events = []  # (start, end) CUDA events around each launch of B1
    summary, final = _passes(scene, camera, cfg, key, lanes, passes, spp, chunk_spp,
                             resume_at, seed, out_dir, ck, write_png, dev, events)
    launch_ms = [a.elapsed_time(b) for a, b in events]
    summary.update(build_seconds=build_s, b1_launches=bk.LAUNCHES)
    want_launches = passes * -(-spp // chunk_spp) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        summary.update(b1_ms_a_launch=sum(launch_ms) / len(launch_ms),
                       b1_ms_launches=launch_ms, b1_device_seconds=sum(launch_ms) / 1e3)
        if with_bound:
            summary.update(launch_bound(scene, camera, rng.iter_key(key, 1000), cfg, lanes,
                                        chunk_spp))
            summary["b1_over_bound"] = summary["b1_ms_a_launch"] / summary["bound_ms_a_launch"]
    summary.update(**bench.card_fields(dev))
    summary["pass"] = bool(summary["finite"] and summary["b1_launches"] == want_launches
                           and (summary["resumed_at_pass"] is not None
                                or not 0 < resume_at < passes))
    return summary, final


def _passes(scene, camera, cfg, key, lanes, passes, spp, chunk_spp, resume_at, seed, out_dir,
            ck, write_png, dev, events):
    """The passes of render_job: (summary without the card's fields, final
    image); each launch of B1 appends its CUDA events to `events`."""
    width, height = camera.width, camera.height
    accum = torch.zeros((height, width, 3), device=dev)
    rays, pass_seconds, resumed = 0, [], None
    _sync(dev)
    t0 = time.perf_counter()
    for p in range(passes):
        tp = time.perf_counter()
        img, n = bk.render_wavefront_fused(scene, camera, spp, rng.iter_key(key, 1000 + p), cfg,
                                           lanes, chunk_spp=chunk_spp, launch_events=events,
                                           device=dev)
        accum = accum + img
        rays += n
        _sync(dev)
        pass_seconds.append(time.perf_counter() - tp)
        print(f"[pass {p}] {spp} spp in {pass_seconds[-1]:.3f} s", file=sys.stderr, flush=True)
        if write_png:
            imageio.write_png(os.path.join(out_dir, "torch_reference_frame_progress.png"),
                              accum / (p + 1))
        ckpt.save_state(ck, accum, p + 1, seed, spp)
        if p + 1 == resume_at and p + 1 < passes:
            del accum  # a real resume: the running sum comes back from the file
            state = ckpt.load_state(ck)
            if state["passes_done"] != p + 1 or state["spp_per_pass"] != spp:
                raise RuntimeError(f"{ck} holds pass {state['passes_done']}, not {p + 1}")
            accum = torch.as_tensor(state["accum_image"], device=dev)
            resumed = p + 1
            print(f"[resume] reloaded the accumulator from {ck} at pass {p + 1}",
                  file=sys.stderr, flush=True)
    final = accum / passes
    _sync(dev)
    wall = time.perf_counter() - t0
    if write_png:
        imageio.write_png(os.path.join(
            out_dir, f"torch_reference_frame_{width}x{height}_{passes}x{spp}spp.png"), final)

    paths = width * height * passes * spp
    summary = {
        "resolution": [width, height], "passes": passes, "spp_per_pass": spp,
        "total_spp": passes * spp, "scene": "cornell_box_scene(include_spheres=True)",
        "engine": "fused (kernel B1)" if dev.type == "cuda" else "fused (plain wavefront)",
        "lanes": lanes, "chunk_spp": chunk_spp,
        "path_ids_a_pass": width * height * spp,
        "wall_seconds": wall, "pass_seconds": pass_seconds,
        "camera_paths": paths, "paths_per_sec": paths / wall,
        "rays": rays, "rays_per_sec": rays / wall, "rays_per_path": rays / paths,
        "resumed_at_pass": resumed, "image_mean": final.mean().item(),
        "channel_sums": [float(x) for x in final.double().sum(dim=(0, 1)).tolist()],
        "finite": bool(torch.isfinite(final).all()), "reference": REFERENCE,
    }
    return summary, final


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs the plain "
                    "wavefront in place of kernel B1")
    ap.add_argument("--out-dir", default=os.path.join(REPO, "_scratch"),
                    help="PNGs and the checkpoint")
    ap.add_argument("--json", default=None, help="summary file (default on the card: "
                    "docs/torch_reference_frame.json; on the CPU: none)")
    args = ap.parse_args(argv)
    env = os.environ.get
    lanes = env("RF_LANES")
    summary, _ = render_job(int(env("RF_W", 1080)), int(env("RF_H", 2400)),
                            int(env("RF_PASSES", 8)), int(env("RF_SPP", 1024)),
                            device=args.device, out_dir=args.out_dir,
                            lanes=int(lanes) if lanes else None,
                            chunk_spp=int(env("RF_CHUNK", 256)),
                            resume_at=int(env("RF_RESUME_AT", 4)), with_bound=True)
    out = args.json or (os.path.join(REPO, "docs", "torch_reference_frame.json")
                        if summary["card"] else None)
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
