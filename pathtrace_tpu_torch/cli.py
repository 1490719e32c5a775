"""Command-line harness for the port: the `render` subcommand.

    python -m pathtrace_tpu_torch.cli render --preset cornell64 --engine fused --out out.png

The device defaults to cuda; without a GPU the command fails rather than
render on the CPU. Ask for the CPU with --device cpu (every engine then
runs its plain PyTorch version).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_render(args) -> int:
    import torch

    from pathtrace_tpu_torch.integrator.render import render
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked
    from pathtrace_tpu_torch.io import image as imageio
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.models.presets import build_preset_scene, get_preset
    from pathtrace_tpu_torch.ops.cuda.bounce_kernel import (auto_fused_config,
                                                            render_wavefront_fused)
    from pathtrace_tpu_torch.utils import rng
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    preset = get_preset(args.preset)
    scene = build_preset_scene(preset).to(dev)
    w = args.width or preset.width
    h = args.height or preset.height
    spp = args.spp or preset.spp
    camera = procedural.default_camera(w, h)
    passes = max(args.passes, 1)
    spp_per_pass = max(spp // passes, 1)
    cfg = preset.cfg

    accum = torch.zeros((h, w, 3), device=dev)
    key = rng.make_key(args.seed)
    for p in range(passes):
        t0 = time.perf_counter()
        pass_key = rng.iter_key(key, 1000 + p)
        if args.engine == "fused":
            pass_img, _ = render_wavefront_fused(
                scene, camera, spp_per_pass, pass_key, cfg,
                lanes=auto_fused_config(w * h), chunk_spp=min(spp_per_pass, 256),
                device=dev)
        elif args.engine == "wavefront":
            pass_img, _ = render_wavefront_chunked(scene, camera, spp_per_pass,
                                                   pass_key, cfg, device=dev)
        else:
            pass_img = render(scene, camera, spp_per_pass, pass_key, cfg, device=dev)
        accum = accum + pass_img
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"[pass {p}] {spp_per_pass}spp in {dt:.2f}s", file=sys.stderr)
        if args.out:
            imageio.write_png(args.out, accum / (p + 1))
    if args.out_npy:
        imageio.write_npy(args.out_npy, accum / passes)
    print(json.dumps({"passes": passes, "spp": spp_per_pass * passes,
                      "resolution": [w, h], "engine": args.engine,
                      "device": str(dev)}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pathtrace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="headless render to PNG/npy")
    pr.add_argument("--preset", default="cornell64")
    pr.add_argument("--width", type=int, default=0)
    pr.add_argument("--height", type=int, default=0)
    pr.add_argument("--spp", type=int, default=0)
    pr.add_argument("--passes", type=int, default=1)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", default="result.png")
    pr.add_argument("--out-npy", default="")
    pr.add_argument("--engine", default="wavefront",
                    choices=("wavefront", "megakernel", "fused"))
    pr.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    pr.set_defaults(fn=cmd_render)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
