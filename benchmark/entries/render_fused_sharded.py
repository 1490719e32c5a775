"""The sharded main path: parallel/mesh.py::render_fused_sharded, one
process a card over torch.distributed (NCCL), each rank one launch of
kernel B1 over its contiguous pixel band keyed by global path ids, then the
all-gather of the bands and the all-reduce of the ray count. A unit is one
pass of the whole film; every rank holds the gathered image."""

from benchmark import program


def setup(ctx):
    from pathtrace_tpu_torch.parallel.mesh import make_ray_mesh, render_fused_sharded

    tr = ctx.traffic
    scene = program.port_scene(ctx.arrays).to(ctx.device)
    camera = program.port_camera(ctx.config, tr["width"], tr["height"])
    cfg = program.port_config(ctx.config)
    mesh = make_ray_mesh(ctx.device)

    def unit(key, spp):
        img, _ = render_fused_sharded(scene, camera, spp, program.port_key(key), mesh, cfg,
                                      lanes=tr["lanes"])
        return {"image": img}

    return unit
