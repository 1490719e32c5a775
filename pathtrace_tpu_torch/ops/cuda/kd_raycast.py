"""Wrapper of the KD-cell raycast kernel (csrc/kd_raycast.cu).

`launch` checks the cell table and the rays (contiguous CUDA tensors of
the kernel's dtypes and shapes, one device, a cell table that fits one
block's shared memory beside its warps' lists), allocates the outputs, and
launches on the current stream, one warp a ray. It raises on anything
else; it never falls back to the plain version
(ops/kd_raycast.py::kd_closest_plain), which ops/kd_raycast.py::kd_closest
runs for CPU tensors.

The library is built by nvcc at first launch (ops/cuda/build.py);
importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pathtrace_tpu_torch.ops.cuda import build
from pathtrace_tpu_torch.utils.profiling import span

# Kernel launches made by `launch` in this process. chip_smoke.py resets it
# before driving the main path and reads it after.
LAUNCHES = 0

MEMBER_STRIDE = 9      # [v0 | e1 | e2] per member slot
CELL_SMEM_BYTES = 32   # bmin bmax start count, float32 / int32
BLOCK = 256            # threads of a block
LIST_CAP = 32          # crossed cells a warp lists in shared memory (8 B each)
TEAM = 32              # threads a ray
MAX_SMEM_BYTES = 232448
# the most cells whose table fits beside the block's lists
MAX_CELLS = (MAX_SMEM_BYTES - 8 * LIST_CAP * (BLOCK // TEAM)) // CELL_SMEM_BYTES


class Launcher:
    """The library's entry points, after checking once that its member row,
    cell record, list, team and block are the ones this module assumes."""

    def __init__(self, lib):
        layout = (ctypes.c_int * 4)()
        lib.pt_kd_layout.argtypes = [ctypes.c_void_p]
        lib.pt_kd_layout.restype = ctypes.c_int
        block = lib.pt_kd_layout(ctypes.addressof(layout))
        want = (MEMBER_STRIDE, CELL_SMEM_BYTES, LIST_CAP, TEAM, BLOCK)
        if (*layout, block) != want:
            raise RuntimeError(f"kernel library layout {(*layout, block)} does not match the "
                               f"wrapper's {want}")
        self.lib = lib
        lib.pt_kd_raycast.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 16
        lib.pt_kd_raycast.restype = ctypes.c_int
        lib.pt_kd_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.pt_kd_occupancy.restype = ctypes.c_int

    def __call__(self, num_rays, num_cells, closest, ptrs, stream) -> int:
        """ptrs: bmin, bmax, prim_start, prim_count, members, dup_map, org,
        dirn, t_min, t_max, hit, t, u, v, prim_id."""
        return self.lib.pt_kd_raycast(num_rays, num_cells, closest, *ptrs, stream)

    def occupancy(self, num_cells: int) -> tuple:
        out = (ctypes.c_int * 4)()
        err = self.lib.pt_kd_occupancy(num_cells, ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"KD kernel occupancy query failed: cudaError {err}")
        return tuple(out)


@functools.cache
def _launcher() -> Launcher:
    return Launcher(build.load_library())


def occupancy(num_cells: int) -> dict:
    """The kernel as built and as the current card holds it at `num_cells`
    cells: registers and local-memory bytes (stack frame and spills) a
    thread, resident blocks and warps per SM, threads a block."""
    regs, local, blocks, block = _launcher().occupancy(num_cells)
    return {"registers": regs, "local_bytes": local, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * block // 32, "block": block}


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
                         f"the kernel holds at most {MAX_CELLS} cells")
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
        fn = _launcher()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in (clusters.bmin, clusters.bmax, clusters.prim_start,
                                       clusters.prim_count, clusters.members, clusters.dup_map,
                                       org, dirn, t_min, t_max, hit, t, u, v, pid)]
        with span("b2.launch"):
            err = fn(r, m, int(mode == "closest"), ptrs, stream)
    if err != 0:
        raise RuntimeError(f"KD raycast kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return hit, t, u, v, pid
