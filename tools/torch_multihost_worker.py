"""One rank of a multi-process run of the port's sharded entry points.

    python tools/torch_multihost_worker.py RANK WORLD_SIZE INIT_FILE OUT.npz [DEVICE]
    torchrun --nproc_per_node=N tools/torch_multihost_worker.py OUT.npz [DEVICE]

Joins a process group of WORLD_SIZE ranks through the shared file INIT_FILE
(torch.distributed's file:// rendezvous), or the one torchrun sets up in
the environment. DEVICE defaults to the card in both modes: NCCL, each
rank on cuda:LOCAL_RANK (cuda:RANK with a file and no LOCAL_RANK). With
DEVICE cpu the group is gloo. It renders
Cornell + spheres at 16x16 @ 4 spp through render_wavefront_sharded (256
lanes in all) and takes one train_step_wavetape_sharded against a fixed
target at 8x8 @ 4 spp. Rank 0 writes the gathered image, the ray
count, the loss and the grads to OUT.npz; tests/test_torch_sharding.py
holds them against one process.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtrace_tpu_torch.diff.grad import MAT_FIELDS  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.parallel import distributed, mesh  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

WIDTH, SPP, LANES = 16, 4, 256
TRAIN_WIDTH, TRAIN_SPP, TRAIN_LANES, TRAIN_CHUNK = 8, 4, 64, 64


def train_target(width: int) -> np.ndarray:
    """The fixed target image of the train step."""
    return np.random.default_rng(11).uniform(0.0, 0.5, (width, width, 3)).astype(np.float32)


def run(ray_mesh) -> dict:
    """The sharded render and train step on `ray_mesh`, as numpy arrays."""
    import torch

    scene = procedural.cornell_box_scene(include_spheres=True)
    cfg = IntegratorConfig()
    img, rays = mesh.render_wavefront_sharded(scene, procedural.default_camera(WIDTH, WIDTH),
                                              SPP, rng.make_key(3), ray_mesh, cfg, LANES)
    loss, (g_tri, g_sph), timg = mesh.train_step_wavetape_sharded(
        scene, procedural.default_camera(TRAIN_WIDTH, TRAIN_WIDTH),
        torch.from_numpy(train_target(TRAIN_WIDTH)), TRAIN_SPP, rng.make_key(5), ray_mesh,
        cfg, TRAIN_LANES, TRAIN_CHUNK)
    out = {"img": img.cpu().numpy(), "rays": np.int64(rays), "loss": loss.detach().cpu().numpy(),
           "train_img": timg.cpu().numpy()}
    for name, g in (("tri", g_tri), ("sph", g_sph)):
        for f in MAT_FIELDS:
            out[f"{name}.{f}"] = getattr(g, f).cpu().numpy()
    return out


def main(argv) -> int:
    if len(argv) <= 3:  # under torchrun
        out_path, device = argv[1], argv[2] if len(argv) > 2 else "cuda"
        distributed.initialize(device=device)
        rank = int(os.environ["RANK"])
    else:
        rank, world, init_file, out_path = int(argv[1]), int(argv[2]), argv[3], argv[4]
        device = argv[5] if len(argv) > 5 else f"cuda:{os.environ.get('LOCAL_RANK', rank)}"
        distributed.initialize(f"file://{init_file}", world, rank, device=device)
    try:
        ray_mesh = distributed.global_ray_mesh(device)
        info = distributed.process_info()
        out = run(ray_mesh)
        if rank == 0:
            np.savez(out_path, process_count=info["process_count"],
                     global_devices=info["global_devices"], **out)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
