"""Wrapper of the material gather and its gradient (csrc/mat_gather.cu).

`gather(tables, idx)` launches one copy of the rows idx of up to six tables
(float32, (K, 3) or (K,), one K) and returns the gathered (N, 3) / (N,)
outputs. `scatter(idx, grads, k_rows)` returns the gradient tables of the
(N, 3) / (N,) gradients at idx, summed in an order fixed by N, K and the
columns, so bit-identical from run to run: the table in tiles of
`tile_rows` rows, at most MAX_BLOCKS blocks over tiles and lane ranges
(`scatter_ranges`). Both check their tensors, allocate what they return,
launch on the current stream and never synchronise: an index outside
[0, K) traps in the kernel. They raise on anything else and never fall
back to the plain version (ops/mat_gather.py), which CPU tensors take.

The library is built by nvcc at first launch (ops/cuda/build.py);
importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pathtrace_tpu_torch.ops.cuda import build

# Calls made in this process: GATHER_LAUNCHES gathers (one launch each),
# SCATTER_LAUNCHES backwards (two launches each: the block-local sums and
# the fixed-order pass over the blocks). chip_smoke.py resets them before a
# train step and reads them after.
GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0

BLOCK = 256             # threads a block
WARPS = BLOCK // 32     # private copies of a tile a block
MAX_FIELDS = 6
MAX_WIDTH = 3
SMEM_BYTES = 48 * 1024  # the warps' copies of a tile
MAX_BLOCKS = 264        # blocks of a scatter (two an SM of an H100), where the table has
                        # at most that many tiles


class MatFields(ctypes.Structure):
    """pt::MatFields: the tables (or gradients) read, the outputs written,
    each field's width and first column in the K x cols table."""

    _fields_ = [("src", ctypes.c_void_p * MAX_FIELDS), ("dst", ctypes.c_void_p * MAX_FIELDS),
                ("width", ctypes.c_int * MAX_FIELDS), ("col", ctypes.c_int * MAX_FIELDS),
                ("count", ctypes.c_int), ("cols", ctypes.c_int)]


@functools.cache
def _lib():
    """The library, after checking once per process that its constants and
    MatFields are the ones this module packs."""
    lib = build.load_library()
    layout = (ctypes.c_int * 5)()
    lib.pt_mat_layout.argtypes = [ctypes.c_void_p]
    lib.pt_mat_layout.restype = ctypes.c_int
    size = lib.pt_mat_layout(ctypes.addressof(layout))
    want = (BLOCK, WARPS, MAX_FIELDS, MAX_WIDTH, SMEM_BYTES)
    if tuple(layout) != want or size != ctypes.sizeof(MatFields):
        raise RuntimeError(f"kernel library layout {tuple(layout)}/{size} bytes does not match "
                           f"the wrapper's {want}/{ctypes.sizeof(MatFields)} bytes")
    lib.pt_mat_gather.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                       ctypes.POINTER(MatFields), ctypes.c_void_p]
    lib.pt_mat_gather.restype = ctypes.c_int
    lib.pt_mat_scatter.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.POINTER(MatFields), ctypes.c_void_p, ctypes.c_void_p]
    lib.pt_mat_scatter.restype = ctypes.c_int
    return lib


def _width(x: torch.Tensor) -> int:
    """Floats a row: 1 for a (K,) field, w for a (K, w) one."""
    return 1 if x.dim() == 1 else x.shape[1]


def tile_rows(cols: int) -> int:
    """Rows of a tile of a K x cols gradient table: as many as WARPS float32
    copies of them fit SMEM_BYTES (128 for the 12 columns of a whole
    Material, 512 for one (K, 3) field)."""
    return SMEM_BYTES // (WARPS * cols * 4)


def scatter_ranges(k_rows: int, cols: int) -> int:
    """The most lane ranges a scatter takes, and so the rows of its
    partials: MAX_BLOCKS blocks shared by the table's tiles, at least one a
    tile."""
    return max(1, MAX_BLOCKS // -(-k_rows // tile_rows(cols)))


def _check_idx(idx: torch.Tensor) -> None:
    if idx.device.type != "cuda" or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx: need an int32 or int64 CUDA tensor, got {idx.dtype} on "
                         f"{idx.device}")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx: need a contiguous 1-D tensor, got shape {tuple(idx.shape)}")


def _fields(srcs, dsts) -> MatFields:
    if not 1 <= len(srcs) <= MAX_FIELDS:
        raise ValueError(f"need 1 to {MAX_FIELDS} fields, got {len(srcs)}")
    f = MatFields()
    col = 0
    for i, (s, d) in enumerate(zip(srcs, dsts)):
        f.src[i], f.dst[i] = s.data_ptr(), d.data_ptr()
        f.width[i], f.col[i] = _width(s), col
        col += f.width[i]
    f.count, f.cols = len(srcs), col
    return f


def gather(tables, idx: torch.Tensor) -> list:
    """[table[idx] for table in tables] in one launch: (N, w) or (N,) each."""
    global GATHER_LAUNCHES
    _check_idx(idx)
    dev, k_rows = idx.device, tables[0].shape[0]
    for i, t in enumerate(tables):
        if t.dim() > 2 or not 1 <= _width(t) <= MAX_WIDTH:
            raise ValueError(f"table {i}: need shape (K,) or (K, 1..{MAX_WIDTH}), got "
                             f"{tuple(t.shape)}")
        build.check_tensor(f"table {i}", t, torch.float32, (k_rows, *t.shape[1:]), dev)
    n = idx.shape[0]
    with torch.cuda.device(dev):
        outs = [torch.empty((n, *t.shape[1:]), device=dev) for t in tables]
        if n == 0:
            return outs
        err = _lib().pt_mat_gather(n, k_rows, int(idx.dtype == torch.int64), idx.data_ptr(),
                                   ctypes.byref(_fields(tables, outs)),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"material gather launch failed: cudaError {err}")
    GATHER_LAUNCHES += 1
    return outs


def scatter(idx: torch.Tensor, grads, k_rows: int) -> list:
    """The gradient tables (K, w) or (K,) of the gradients at idx: table k
    row sums every grads row r with idx[r] == k. grads: (N, w) or (N,)
    float32 CUDA tensors, made contiguous here."""
    global SCATTER_LAUNCHES
    _check_idx(idx)
    dev, n = idx.device, idx.shape[0]
    grads = [g.contiguous() for g in grads]
    for i, g in enumerate(grads):
        if g.dim() > 2 or not 1 <= _width(g) <= MAX_WIDTH:
            raise ValueError(f"gradient {i}: need shape (N,) or (N, 1..{MAX_WIDTH}), got "
                             f"{tuple(g.shape)}")
        build.check_tensor(f"gradient {i}", g, torch.float32, (n, *g.shape[1:]), dev)
    cols = sum(_width(g) for g in grads)
    with torch.cuda.device(dev):
        alloc = torch.empty if n else torch.zeros
        outs = [alloc((k_rows, *g.shape[1:]), device=dev) for g in grads]
        if n == 0:
            return outs
        partial = torch.empty((scatter_ranges(k_rows, cols), k_rows * cols), device=dev)
        err = _lib().pt_mat_scatter(n, k_rows, int(idx.dtype == torch.int64), partial.shape[0],
                                    idx.data_ptr(), ctypes.byref(_fields(grads, outs)),
                                    partial.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"material gradient launch failed: cudaError {err}")
    SCATTER_LAUNCHES += 1
    return outs
