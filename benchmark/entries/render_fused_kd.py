"""The fused engine on a mesh: ops/cuda/bounce_kernel.py::render_wavefront_fused
on a scene with KD cells (Scene.with_kd_binned at the traffic's
kd_max_tris), the call `cli render --engine fused` makes on a mesh preset:
one launch of kernel B1's KD variant a chunk. A unit is one image of the
traffic's film and spp."""

from benchmark import program


def setup(ctx):
    from pathtrace_tpu_torch.ops.cuda.bounce_kernel import render_wavefront_fused

    tr = ctx.traffic
    scene = program.port_scene(ctx.arrays, kd_max_tris=tr["kd_max_tris"]).to(ctx.device)
    camera = program.port_camera(ctx.config, tr["width"], tr["height"])
    cfg = program.port_config(ctx.config)

    def unit(key, spp):
        img, _ = render_wavefront_fused(scene, camera, spp, program.port_key(key), cfg,
                                        lanes=tr["lanes"], chunk_spp=min(spp, tr["chunk_spp"]),
                                        device=ctx.device)
        return {"image": img}

    return unit
