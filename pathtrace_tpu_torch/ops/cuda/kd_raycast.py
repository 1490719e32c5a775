"""Wrapper of the KD-cell raycast kernel (csrc/kd_raycast.cu).

`launch` checks the cell table and the rays (contiguous CUDA tensors of
the kernel's dtypes and shapes, one device, a cell table that fits one
block's shared memory), allocates the outputs, and launches one thread per
ray on the current stream. It raises on anything else; it never falls
back to the plain version (ops/kd_raycast.py::kd_closest_plain), which
ops/kd_raycast.py::kd_closest runs for CPU tensors.

The library is built by nvcc at first launch (ops/cuda/build.py);
importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pathtrace_tpu_torch.ops.cuda import build

# Kernel launches made by `launch` in this process. chip_smoke.py resets it
# before driving the main path and reads it after.
LAUNCHES = 0

MEMBER_STRIDE = 9      # [v0 | e1 | e2] per member slot
CELL_SMEM_BYTES = 32   # bmin bmax start count, float32 / int32
MAX_SMEM_BYTES = 232448
MAX_CELLS = MAX_SMEM_BYTES // CELL_SMEM_BYTES


@functools.cache
def _raycast_fn():
    """The library's launcher, after checking once per process that its
    member row width and cell record are the ones this module packs."""
    lib = build.load_library()
    layout = (ctypes.c_int * 2)()
    lib.pt_kd_layout.argtypes = [ctypes.c_void_p]
    lib.pt_kd_layout.restype = ctypes.c_int
    lib.pt_kd_layout(ctypes.addressof(layout))
    if tuple(layout) != (MEMBER_STRIDE, CELL_SMEM_BYTES):
        raise RuntimeError(f"kernel library layout {tuple(layout)} does not match the "
                           f"wrapper's {(MEMBER_STRIDE, CELL_SMEM_BYTES)}")
    fn = lib.pt_kd_raycast
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 16
    fn.restype = ctypes.c_int
    return fn


def launch(clusters, org, dirn, t_min, t_max, mode: str = "closest"):
    """One launch: (hit bool, t, u, v, prim_id int32), each (R,), for the
    rays against the scene's KD cells (ops/kd_raycast.py states the
    contract). mode is "closest" or "shadow" (u = v = 0)."""
    global LAUNCHES
    if mode not in ("closest", "shadow"):
        raise ValueError(f"mode must be 'closest' or 'shadow', got {mode!r}")
    r, m, d = org.shape[0], clusters.num_clusters, clusters.num_members
    if m > MAX_CELLS:
        raise ValueError(f"{m} KD cells need {m * CELL_SMEM_BYTES} bytes of shared memory; "
                         f"the kernel holds at most {MAX_CELLS} cells ({MAX_SMEM_BYTES} bytes)")
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the KD kernel runs on CUDA tensors, got {dev}")
    build.check_tensor("org", org, torch.float32, (r, 3), dev)
    build.check_tensor("dirn", dirn, torch.float32, (r, 3), dev)
    build.check_tensor("t_min", t_min, torch.float32, (r,), dev)
    build.check_tensor("t_max", t_max, torch.float32, (r,), dev)
    build.check_tensor("bmin", clusters.bmin, torch.float32, (m, 3), dev)
    build.check_tensor("bmax", clusters.bmax, torch.float32, (m, 3), dev)
    build.check_tensor("prim_start", clusters.prim_start, torch.int32, (m,), dev)
    build.check_tensor("prim_count", clusters.prim_count, torch.int32, (m,), dev)
    build.check_tensor("members", clusters.members, torch.float32, (d, MEMBER_STRIDE), dev)
    build.check_tensor("dup_map", clusters.dup_map, torch.int32, (d,), dev)
    with torch.cuda.device(dev):
        hit = torch.empty((r,), dtype=torch.bool, device=dev)
        t, u, v = (torch.empty((r,), device=dev) for _ in range(3))
        pid = torch.empty((r,), dtype=torch.int32, device=dev)
        if r == 0:
            return hit, t, u, v, pid
        fn = _raycast_fn()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in (clusters.bmin, clusters.bmax, clusters.prim_start,
                                       clusters.prim_count, clusters.members, clusters.dup_map,
                                       org, dirn, t_min, t_max, hit, t, u, v, pid)]
        err = fn(r, m, int(mode == "closest"), *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"KD raycast kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return hit, t, u, v, pid
