"""The bunny-class mesh render: blob82k at 512x512 @ 256 spp through the
wavefront engine and the KD raycast, kernel B2 (the JAX package's
tools/mesh512_render.py; the reference renders ~70k-triangle OBJ scenes,
Img/Render/bunny.png).

assets/blob82k.obj in the Cornell room, KD cells of 1024, 65,536 lanes
(the bench's MESH_LANES, four pixels a lane), chunks of 32 spp, after a
4-spp warm-up that builds the kernel library.

    python tools/torch_mesh512_render.py                   # on the card, ~4 min
    python tools/torch_mesh512_render.py --device cpu --side 8 --spp 1 --lanes 64

Prints one JSON summary; on the card at 512x512 @ 256 spp it also writes
docs/torch_mesh512_render.json (--json to write elsewhere). The PNG goes to
--out-dir (_scratch/ by default, which git ignores).
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
from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked  # noqa: E402
from pathtrace_tpu_torch.io import image as imageio  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.device import resolve_device  # noqa: E402


def render_mesh(device="cuda", side: int = 512, spp: int = 256, lanes: int = bench.MESH_LANES,
                chunk_spp: int = 32, out_dir=None) -> dict:
    """Summary of one timed render after a 4-spp warm-up."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    scene = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024).to(dev)
    scene_s = time.perf_counter() - t0
    cam, cfg, key = procedural.default_camera(side, side), IntegratorConfig(), rng.make_key(0)
    render_wavefront_chunked(scene, cam, min(4, spp), key, cfg, lanes, chunk_spp=4, device=dev)
    kd_kernel.LAUNCHES = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    img, rays = render_wavefront_chunked(scene, cam, spp, key, cfg, lanes,
                                         chunk_spp=min(chunk_spp, spp), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        imageio.write_png(os.path.join(out_dir, "torch_mesh512_render.png"), img)
    paths = side * side * spp
    finite = bool(torch.isfinite(img).all())
    return {"scene": f"blob82k (assets/blob82k.obj) in the Cornell room, {scene.num_tris} "
                     f"triangles, {scene.clusters.num_clusters} KD cells of <= 1024",
            "resolution": [side, side], "spp": spp, "lanes": lanes,
            "chunk_spp": min(chunk_spp, spp),
            "engine": ("wavefront + KD raycast (kernel B2)" if dev.type == "cuda"
                       else "wavefront + KD raycast (plain search)"),
            "scene_seconds": scene_s, "wall_seconds": dt, "paths": paths,
            "paths_per_sec": paths / dt, "rays": rays, "rays_per_sec": rays / dt,
            "b2_launches": kd_kernel.LAUNCHES, "image_mean": img.mean().item(),
            "finite": finite, "reference_analog": "bunny-class render, Img/Render/bunny.png",
            **bench.card_fields(dev),
            "pass": finite and img.mean().item() > 0
            and (kd_kernel.LAUNCHES > 0 or dev.type != "cuda")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--lanes", type=int, default=bench.MESH_LANES)
    ap.add_argument("--out-dir", default=os.path.join(REPO, "_scratch"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = render_mesh(args.device, args.side, args.spp, args.lanes, out_dir=args.out_dir)
    path = args.json or (os.path.join(REPO, "docs", "torch_mesh512_render.json")
                         if out["card"] and (args.side, args.spp) == (512, 256) else None)
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
