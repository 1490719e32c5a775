"""One rank of a multi-process run of the port's sharded entry points.

    python tools/torch_multihost_worker.py RANK WORLD_SIZE INIT_FILE OUT.npz [DEVICE]
    torchrun --nproc_per_node=N tools/torch_multihost_worker.py OUT.npz [DEVICE]

Joins a process group of WORLD_SIZE ranks through the shared file INIT_FILE
(torch.distributed's file:// rendezvous), or the one torchrun sets up in
the environment. DEVICE defaults to the card in both modes: NCCL, each
rank on cuda:LOCAL_RANK (cuda:RANK with a file and no LOCAL_RANK). With
DEVICE cpu the group is gloo. It runs the six sharded entry points on
Cornell + spheres: render_wavefront_sharded and render_fused_sharded at
16x16 @ 4 spp (256 lanes in all), train_step_wavetape_sharded against a
fixed target at 8x8 @ 4 spp, and render_sharded, render_grad_sharded and
train_step_replay_sharded at 8x8 @ 1 spp. Rank 0 writes the gathered
images, the ray counts, the losses and the grads to OUT.npz;
tests/test_torch_sharding.py holds them against one process (`compare`),
as tools/torch_scaling_bench.py does on the cards.
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
LOCKSTEP_SPP = 1
# loss and grads are sums over the ranks, taken in another order than one
# process takes them (tests/test_torch_sharding.py's bar)
GRAD_RTOL = 1e-5


def train_target(width: int) -> np.ndarray:
    """The fixed target image of the train step."""
    return np.random.default_rng(11).uniform(0.0, 0.5, (width, width, 3)).astype(np.float32)


def grad_arrays(prefix: str, loss, grads) -> dict:
    """{prefix + "loss", prefix + "tri.<field>", prefix + "sph.<field>"}:
    numpy arrays of a step's loss and (tri, sphere) material grads."""
    out = {f"{prefix}loss": loss.detach().cpu().numpy()}
    for name, g in zip(("tri", "sph"), grads):
        for f in MAT_FIELDS:
            out[f"{prefix}{name}.{f}"] = getattr(g, f).cpu().numpy()
    return out


def run(ray_mesh) -> dict:
    """The six sharded entry points on `ray_mesh`, as numpy arrays: images
    (`*img`), ray counts (`*rays`), losses (`*loss`) and grads (the rest)."""
    import torch

    scene = procedural.cornell_box_scene(include_spheres=True)
    cfg = IntegratorConfig()
    cam = procedural.default_camera(WIDTH, WIDTH)
    img, rays = mesh.render_wavefront_sharded(scene, cam, SPP, rng.make_key(3), ray_mesh, cfg,
                                              LANES)
    f_img, f_rays = mesh.render_fused_sharded(scene, cam, SPP, rng.make_key(3), ray_mesh, cfg,
                                              LANES)
    t_cam = procedural.default_camera(TRAIN_WIDTH, TRAIN_WIDTH)
    target = torch.from_numpy(train_target(TRAIN_WIDTH))
    loss, grads, timg = mesh.train_step_wavetape_sharded(
        scene, t_cam, target, TRAIN_SPP, rng.make_key(5), ray_mesh, cfg, TRAIN_LANES,
        TRAIN_CHUNK)
    l_img = mesh.render_sharded(scene, t_cam, LOCKSTEP_SPP, rng.make_key(7), ray_mesh, cfg)
    g_loss, g_grads = mesh.render_grad_sharded(scene, t_cam, target, LOCKSTEP_SPP,
                                               rng.make_key(9), ray_mesh, cfg)
    r_loss, r_grads, r_img = mesh.train_step_replay_sharded(scene, t_cam, target, LOCKSTEP_SPP,
                                                            rng.make_key(9), ray_mesh, cfg)
    out = {"img": img.cpu().numpy(), "rays": np.int64(rays), "fused_img": f_img.cpu().numpy(),
           "fused_rays": np.int64(f_rays), "train_img": timg.cpu().numpy(),
           "lockstep_img": l_img.cpu().numpy(), "replay_img": r_img.cpu().numpy()}
    out.update(grad_arrays("", loss, grads))
    out.update(grad_arrays("grad.", g_loss, g_grads))
    out.update(grad_arrays("replay.", r_loss, r_grads))
    return out


def compare(got: dict, ref: dict) -> dict:
    """run()'s arrays of N ranks (or grad_arrays of a step) against one
    process's: images bit-equal, ray counts exact, losses and grads within
    GRAD_RTOL of the reference's largest magnitude. Returns {"bit_equal",
    "rays_equal", "grads_rel_err" (max |got - ref| / max |ref| by key),
    "grads_max_rel_err", "pass"}."""
    images = [k for k in ref if k.endswith("img")]
    counts = [k for k in ref if k.endswith("rays")]
    sums = [k for k in ref if k not in images and k not in counts]
    rel = {k: float(np.abs(got[k] - ref[k]).max()) / max(float(np.abs(ref[k]).max()), 1e-12)
           for k in sums}
    out = {"bit_equal": all(np.array_equal(got[k], ref[k]) for k in images),
           "rays_equal": all(int(got[k]) == int(ref[k]) for k in counts),
           "grads_rel_err": rel, "grads_max_rel_err": max(rel.values(), default=0.0)}
    out["pass"] = out["bit_equal"] and out["rays_equal"] and out["grads_max_rel_err"] <= GRAD_RTOL
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
