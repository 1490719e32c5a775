"""Command-line harness for the port: the `render` and `grad-check`
subcommands.

    python -m pathtrace_tpu_torch.cli render --preset cornell64 --engine fused --out out.png
    python -m pathtrace_tpu_torch.cli render --passes 4 --checkpoint ck.npz --resume
    python -m pathtrace_tpu_torch.cli grad-check --preset cornell64 --width 16 --height 16 --spp 4

The device defaults to cuda; without a GPU the command fails rather than
run on the CPU. Ask for the CPU with --device cpu (every kernel then runs
its plain PyTorch version).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_render(args) -> int:
    import dataclasses

    import torch

    from pathtrace_tpu_torch.integrator.render import render
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked
    from pathtrace_tpu_torch.io import checkpoint as ckpt
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
    if args.hemisphere != cfg.hemisphere:
        cfg = dataclasses.replace(cfg, hemisphere=args.hemisphere)
    if args.no_nee:
        cfg = dataclasses.replace(cfg, nee=False)

    start_pass = 0
    accum = torch.zeros((h, w, 3), device=dev)
    if args.resume and args.checkpoint:
        try:
            state = ckpt.load_state(args.checkpoint)
        except FileNotFoundError:
            pass  # nothing to resume: start at pass 0
        else:
            accum = torch.as_tensor(state["accum_image"], device=dev)
            start_pass = state["passes_done"]
            print(f"[resume] at pass {start_pass}", file=sys.stderr)

    key = rng.make_key(args.seed)
    for p in range(start_pass, passes):
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
        if args.checkpoint:
            ckpt.save_state(args.checkpoint, accum, p + 1, args.seed, spp_per_pass)
    if args.out_npy:
        imageio.write_npy(args.out_npy, accum / passes)
    print(json.dumps({"passes": passes, "spp": spp_per_pass * passes,
                      "resolution": [w, h], "engine": args.engine,
                      "device": str(dev)}))
    return 0


def cmd_grad_check(args) -> int:
    """Autograd material gradients against the finite-difference oracle
    (JAX cli.py:94-160); prints one JSON report, exits 0 iff it passes."""
    from pathtrace_tpu_torch.diff import fd_material_grad_auto, material_grads
    from pathtrace_tpu_torch.diff.fd import make_frozen_sampler
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.models.presets import build_preset_scene, get_preset
    from pathtrace_tpu_torch.utils import rng
    from pathtrace_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    scene = build_preset_scene(get_preset(args.preset)).to(dev)
    camera = procedural.default_camera(args.width or 32, args.height or 32)
    key = rng.make_key(args.seed)
    spp = args.spp or 8
    if args.quick:
        # loose mode: FD of the live sampler (detach_sampling off) with
        # per-parameter tolerances up to 1e-1; Russian roulette off, its
        # survival flips would show as O(1/h) spikes
        cfg = IntegratorConfig(rr_bounce=99, detach_sampling=False)
        frozen = None
        tol_of = {"albedo": 2e-2, "emittance": 2e-2, "roughness": 1e-1, "specular": 5e-2}
        fd_kwargs = {}
    else:
        # strong contract (default): production gradients (detach_sampling)
        # against frozen-sampling adaptive central differences with
        # Richardson extrapolation, at 1e-3
        cfg = IntegratorConfig(rr_bounce=99, detach_sampling=True)
        frozen = make_frozen_sampler(scene)
        tol_of = dict.fromkeys(("albedo", "emittance", "roughness", "specular"), 1e-3)
        fd_kwargs = dict(h_min=1e-4, agree=0.001, richardson=True)

    g_tri, _, loss = material_grads(scene, camera, spp, key, cfg=cfg, device=dev)
    light = int(scene.lights[0])
    checks = []
    for field, idx, h0 in [("albedo", (0, 0), 2e-2), ("emittance", (light, 0), 5e-2),
                           ("roughness", (2,), 1e-2), ("specular", (4, 0), 1e-2)]:
        fd, h_used, conv = fd_material_grad_auto(
            scene, camera, spp, key, "tris", field, idx, h0=h0, cfg=cfg,
            sample_mat_fn=frozen, device=dev, **fd_kwargs)
        ad = float(getattr(g_tri, field)[idx])
        rel = abs(ad - fd) / max(abs(fd), abs(ad), 1.0)
        tol = tol_of[field]
        checks.append({"param": f"{field}{list(idx)}", "autodiff": ad, "fd": fd,
                       "fd_h": h_used, "fd_converged": conv, "rel_err": rel,
                       "tol": tol, "ok": rel < tol})
    ok = all(c["ok"] for c in checks)
    print(json.dumps({"loss": float(loss), "mode": "quick" if args.quick else "strong-1e-3",
                      "max_rel_err": max(c["rel_err"] for c in checks), "checks": checks,
                      "device": str(dev), "pass": ok}, indent=2))
    return 0 if ok else 1


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
    pr.add_argument("--checkpoint", default="",
                    help=".npz written after each pass (io/checkpoint.py)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint at the pass it reached")
    pr.add_argument("--engine", default="wavefront",
                    choices=("wavefront", "megakernel", "fused"))
    pr.add_argument("--hemisphere", default="cosine", choices=("cosine", "uniform"),
                    help="diffuse hemisphere sampling A/B (Bxdf.cuh:23-41); the fused "
                         "engine samples cosine only and raises on uniform")
    pr.add_argument("--no-nee", dest="no_nee", action="store_true",
                    help="disable next-event estimation (README.md:56-58 A/B)")
    pr.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    pr.set_defaults(fn=cmd_render)

    pg = sub.add_parser("grad-check", help="autograd vs the FD oracle")
    pg.add_argument("--preset", default="cornell64")
    pg.add_argument("--width", type=int, default=0)
    pg.add_argument("--height", type=int, default=0)
    pg.add_argument("--spp", type=int, default=0)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--quick", action="store_true",
                    help="loose live-sampler FD mode; default: the strong "
                         "frozen-sampling contract at 1e-3")
    pg.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    pg.set_defaults(fn=cmd_grad_check)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
