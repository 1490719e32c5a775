"""A long render in passes, as `cli render --passes N --out --checkpoint`
runs it: each pass is ops/cuda/bounce_kernel.py::render_wavefront_fused
(kernel B1, chunks of chunk_spp), added to the running sum; then the
running mean goes to a PNG (io/image.py::write_png) and the sum to the
resumable checkpoint (io/checkpoint.py::save_state), both in a temporary
directory of the run that is removed when the process exits. A unit is one
pass and returns that pass's image. A pass at another spp than the one
before starts a new job (the warm-up pass is one of its own). The
checkpoint's seed field holds the first word of the pass's key."""

import atexit
import os
import shutil
import tempfile

import torch

from benchmark import program


def setup(ctx):
    from pathtrace_tpu_torch.io import checkpoint
    from pathtrace_tpu_torch.io import image
    from pathtrace_tpu_torch.ops.cuda.bounce_kernel import render_wavefront_fused

    tr = ctx.traffic
    scene = program.port_scene(ctx.arrays).to(ctx.device)
    camera = program.port_camera(ctx.config, tr["width"], tr["height"])
    cfg = program.port_config(ctx.config)
    out = tempfile.mkdtemp(prefix="render_passes_")
    atexit.register(shutil.rmtree, out, True)
    png, ck = os.path.join(out, "render.png"), os.path.join(out, "render.npz")
    job = {"spp": None, "passes": 0, "accum": None}

    def unit(key, spp):
        if job["spp"] != spp:
            job.update(spp=spp, passes=0,
                       accum=torch.zeros((tr["height"], tr["width"], 3), device=ctx.device))
        img, _ = render_wavefront_fused(scene, camera, spp, program.port_key(key), cfg,
                                        lanes=tr["lanes"], chunk_spp=min(spp, tr["chunk_spp"]),
                                        device=ctx.device)
        job["accum"] = job["accum"] + img
        job["passes"] += 1
        image.write_png(png, job["accum"] / job["passes"])
        checkpoint.save_state(ck, job["accum"], job["passes"], int(key[0]), spp)
        return {"image": img}

    return unit
