"""Wrapper of the all-triangles closest-hit kernel (csrc/mt_closest.cu).

`launch` checks the triangle table and the rays (contiguous CUDA tensors of
the kernel's dtypes and shapes, one device), allocates the outputs, and
launches one thread per ray on the current stream. It raises on anything
else; it never falls back to the plain version
(ops/mt_closest.py::mt_closest_plain), which ops/mt_closest.py::mt_closest
runs for CPU tensors. An empty (0, 9) table, a scene without triangles, is
launched like any other: the kernel scans no row and writes every ray a
miss.

The library is built by nvcc at first launch (ops/cuda/build.py);
importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pathtrace_tpu_torch.ops.cuda import build

# Kernel launches made by `launch` in this process. chip_smoke.py resets it
# before driving a path and reads it after.
LAUNCHES = 0

TRI_STRIDE = 9   # [v0 | e1 | e2] per triangle
TILE = 1024      # triangles per shared-memory tile
MODES = ("closest", "shadow")


@functools.cache
def _closest_fn():
    """The library's launcher, after checking once per process that its
    triangle row width and tile are the ones this module assumes."""
    lib = build.load_library()
    layout = (ctypes.c_int * 2)()
    lib.pt_mt_layout.argtypes = [ctypes.c_void_p]
    lib.pt_mt_layout.restype = ctypes.c_int
    lib.pt_mt_layout(ctypes.addressof(layout))
    if tuple(layout) != (TRI_STRIDE, TILE):
        raise RuntimeError(f"kernel library layout {tuple(layout)} does not match the "
                           f"wrapper's {(TRI_STRIDE, TILE)}")
    fn = lib.pt_mt_closest
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


def occupancy(num_tris: int) -> dict:
    """The closest-mode kernel as built and as the current card holds it
    for a table of num_tris rows: registers and local-memory bytes (stack
    frame and spills) a thread, resident blocks and warps per SM, threads a
    block."""
    lib = build.load_library()
    out = (ctypes.c_int * 4)()
    lib.pt_mt_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.pt_mt_occupancy.restype = ctypes.c_int
    err = lib.pt_mt_occupancy(num_tris, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"all-triangles kernel occupancy query failed: cudaError {err}")
    regs, local, blocks, block = out
    return {"registers": regs, "local_bytes": local, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * block // 32, "block": block}


def launch(table, org, dirn, t_min, t_max, mode: str = "closest"):
    """One launch: (hit bool, t, idx int32, u, v), each (R,), of the rays
    against the (T, 9) triangle table [v0 | e1 | e2] (ops/mt_closest.py
    states the contract). mode is "closest" or "shadow" (u = v = 0)."""
    global LAUNCHES
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the all-triangles kernel runs on CUDA tensors, got {dev}")
    r, n = org.shape[0], table.shape[0]
    build.check_tensor("table", table, torch.float32, (n, TRI_STRIDE), dev)
    build.check_tensor("org", org, torch.float32, (r, 3), dev)
    build.check_tensor("dirn", dirn, torch.float32, (r, 3), dev)
    build.check_tensor("t_min", t_min, torch.float32, (r,), dev)
    build.check_tensor("t_max", t_max, torch.float32, (r,), dev)
    with torch.cuda.device(dev):
        hit = torch.empty((r,), dtype=torch.bool, device=dev)
        t, u, v = (torch.empty((r,), device=dev) for _ in range(3))
        idx = torch.empty((r,), dtype=torch.int32, device=dev)
        if r == 0:
            return hit, t, idx, u, v
        fn = _closest_fn()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in (table, org, dirn, t_min, t_max, hit, t, idx, u, v)]
        err = fn(r, n, int(mode == "closest"), *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"all-triangles kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return hit, t, idx, u, v
