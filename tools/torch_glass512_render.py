"""glass512 at its full BASELINE configuration: the glass scene at 512x512 @
1024 spp through the fused engine, kernel B1 (the JAX package's
tools/glass512_render.py; BASELINE.json configs[3]).

65,536 lanes, launches of 256 spp (the CLI's chunking): 4 launches after a
4-spp warm-up that builds the kernel library.

    python tools/torch_glass512_render.py                  # on the card, seconds
    python tools/torch_glass512_render.py --device cpu --side 16 --spp 2

Prints one JSON summary; on the card at 512x512 @ 1024 spp it also writes
docs/torch_glass512_render.json (--json to write elsewhere). The PNG goes
to --out-dir (_scratch/ by default, which git ignores).
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
from pathtrace_tpu_torch.io import image as imageio  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.device import resolve_device  # noqa: E402


def render_glass(device="cuda", side: int = 512, spp: int = 1024, chunk_spp: int = 256,
                 out_dir=None, lanes=None) -> dict:
    """Summary of one timed render after a 4-spp warm-up; lanes default to
    auto_fused_config."""
    dev = resolve_device(device)
    scene = procedural.glass_scene().to(dev)
    cam, cfg, key = procedural.default_camera(side, side), IntegratorConfig(), rng.make_key(0)
    lanes = bk.auto_fused_config(side * side) if lanes is None else lanes
    bk.render_wavefront_fused(scene, cam, 4, key, cfg, lanes, chunk_spp=4, device=dev)
    bk.LAUNCHES = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    img, rays = bk.render_wavefront_fused(scene, cam, spp, key, cfg, lanes,
                                          chunk_spp=min(chunk_spp, spp), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        imageio.write_png(os.path.join(out_dir, "torch_glass512_render.png"), img)
    paths = side * side * spp
    finite = bool(torch.isfinite(img).all())
    return {"scene": "glass_scene() (metal sphere, delta-glass sphere)",
            "resolution": [side, side], "spp": spp, "lanes": lanes,
            "chunk_spp": min(chunk_spp, spp),
            "engine": "fused (kernel B1)" if dev.type == "cuda" else "fused (plain wavefront)",
            "wall_seconds": dt, "paths": paths, "paths_per_sec": paths / dt,
            "rays": rays, "rays_per_sec": rays / dt, "b1_launches": bk.LAUNCHES,
            "image_mean": img.mean().item(), "finite": finite,
            "baseline_config": "BASELINE.json configs[3] (512^2 @ 1024 spp)",
            **bench.card_fields(dev),
            "pass": finite and img.mean().item() > 0 and (bk.LAUNCHES > 0 or dev.type != "cuda")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--out-dir", default=os.path.join(REPO, "_scratch"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = render_glass(args.device, args.side, args.spp, out_dir=args.out_dir)
    path = args.json or (os.path.join(REPO, "docs", "torch_glass512_render.json")
                         if out["card"] and (args.side, args.spp) == (512, 1024) else None)
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
