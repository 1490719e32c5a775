"""The mesh path: integrator/wavefront.py::render_wavefront_chunked, the
eager regenerating wavefront, every closest-hit and shadow ray through the
scene's KD cells (kernel B2 on the card). A unit is one image."""

from benchmark import program


def setup(ctx):
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked

    tr = ctx.traffic
    scene = program.port_scene(ctx.arrays, kd_max_tris=tr.get("kd_max_tris")).to(ctx.device)
    camera = program.port_camera(ctx.config, tr["width"], tr["height"])
    cfg = program.port_config(ctx.config)

    def unit(key, spp):
        img, _ = render_wavefront_chunked(scene, camera, spp, program.port_key(key), cfg,
                                          lanes=tr["lanes"], chunk_spp=min(spp, tr["chunk_spp"]),
                                          device=ctx.device)
        return {"image": img}

    return unit
