"""The training path: parallel/mesh.py::train_step_wavetape, one recording
sweep through the wavefront (kernel B3 on the card), then the chunked,
length-sorted replay backward. A unit is one step of the L2 loss against
the traffic's target (zero), keyed per step."""

import torch

from benchmark import program


def setup(ctx):
    from pathtrace_tpu_torch.diff.grad import MAT_FIELDS
    from pathtrace_tpu_torch.parallel.mesh import train_step_wavetape

    tr = ctx.traffic
    scene = program.port_scene(ctx.arrays).to(ctx.device)
    camera = program.port_camera(ctx.config, tr["width"], tr["height"])
    cfg = program.port_config(ctx.config)
    target = torch.zeros((tr["height"], tr["width"], 3), device=ctx.device)

    def unit(key, spp):
        paths = tr["width"] * tr["height"] * spp
        loss, (g_tri, g_sph), img = train_step_wavetape(
            scene, camera, target, spp, program.port_key(key), cfg,
            lanes=min(tr["lanes"], paths), chunk=min(tr["chunk_paths"], paths),
            device=ctx.device)
        grads = {f"{side}.{f}": getattr(g, f) for side, g in (("tri", g_tri), ("sph", g_sph))
                 for f in MAT_FIELDS}
        return {"loss": loss.detach(), "image": img.detach(), "grads": grads}

    return unit
