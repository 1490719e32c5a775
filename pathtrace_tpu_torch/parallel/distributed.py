"""Multi-process bootstrap over torch.distributed (port of
pathtrace_tpu/parallel/distributed.py).

One process per device: `torchrun --nproc_per_node=N` on the cards (NCCL),
or N processes on the CPU (gloo). Each rank renders its pixel slice
(parallel/mesh.py); the scene is replicated, film slices are gathered and
loss, grads and ray counts all-reduced over the process group. A single
process without the torchrun environment needs no group: initialize() is
then a no-op and the mesh has one rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pathtrace_tpu_torch.parallel.mesh import RayMesh, make_ray_mesh


def local_device(device="cuda") -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK} for "cuda" (torchrun sets
    LOCAL_RANK; 0 without it), the device itself otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda") -> None:
    """torch.distributed.init_process_group for this process: NCCL when
    `device` is a CUDA device (which becomes the current one), gloo on the
    CPU. Without arguments it reads the torchrun environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with no arguments and none of it
    set it is a no-op (a single process), as the JAX package's is."""
    given = {k: v for k, v in (("init_method", init_method), ("world_size", world_size),
                               ("rank", rank)) if v is not None}
    if not given and "WORLD_SIZE" not in os.environ:
        return  # a single process
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # with nothing given, torch.distributed's env:// rendezvous reads torchrun's variables
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **given)


def global_ray_mesh(device="cuda") -> RayMesh:
    """The mesh over every rank of the process group (one rank when no
    group is initialized), on this rank's device."""
    return make_ray_mesh(local_device(device))


def process_info() -> dict:
    """This process's place in the group, with JAX's keys: process index
    and count, and the devices it and the group hold (one device a
    process)."""
    initialized = dist.is_initialized()
    count = dist.get_world_size() if initialized else 1
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }
