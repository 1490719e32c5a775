"""Gather of material rows, and its gradient, for the replay's autograd.

`gather(tables, idx)` returns table[idx] for each table, (K, 3) or (K,)
float32 fields of one Material (models/scene.py::Material.gather) or a
single field (integrator/megakernel.py's light emittance). On CUDA tensors
it always runs MatGather: one launch of the hand-written copy
(csrc/mat_gather.cu through ops/cuda/mat_gather.py), a backward that sums
the gradient rows without a sort or a serial walk over equal indices,
which PyTorch's index backward (index_put_ with accumulation) spends
~20 ms on at 262,144 lanes, and a forward-mode tangent gathered by the same
copy (diff/grad.py::material_jvp). CPU tensors take plain indexing,
`table[idx.long()]`.

MatGather on CPU tensors is the plain version of the kernels: the same
gather, and index_add_ for the backward. Its gradients on the card match
the plain version's to float32 summation order, and are bit-identical from
run to run.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.ops.cuda import mat_gather as mg_kernel


def gather_plain(tables, idx: torch.Tensor) -> tuple:
    """table[idx] for each table, as PyTorch indexing computes it."""
    idx = idx.long()
    return tuple(t[idx] for t in tables)


def scatter_plain(idx: torch.Tensor, grads, k_rows: int) -> list:
    """The plain version of the kernels' backward: each gradient's rows
    summed into a (K, ...) table at idx."""
    idx = idx.long()
    return [torch.zeros((k_rows, *g.shape[1:]), dtype=g.dtype, device=g.device)
            .index_add_(0, idx, g) for g in grads]


def _gather(tables, idx: torch.Tensor) -> tuple:
    if idx.device.type == "cuda":
        return tuple(mg_kernel.gather([t.contiguous() for t in tables], idx))
    return gather_plain(tables, idx)


class MatGather(torch.autograd.Function):
    """(table[idx] for table in tables) with the kernels on CUDA tensors and
    the plain version on CPU tensors; idx gets no gradient. A table without
    a forward-mode tangent gives its outputs a zero tangent."""

    @staticmethod
    def forward(ctx, idx, *tables):
        idx = idx.contiguous()
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)
        ctx.k_rows = tables[0].shape[0]
        ctx.like = [(t.shape[1:], t.dtype) for t in tables]
        return _gather(tables, idx)

    @staticmethod
    def jvp(ctx, _, *tangents):
        (idx,) = ctx.saved_tensors
        live = [t for t in tangents if t is not None]
        got = iter(_gather(live, idx) if live else ())
        return tuple(next(got) if t is not None
                     else torch.zeros((idx.shape[0], *row), dtype=dtype, device=idx.device)
                     for t, (row, dtype) in zip(tangents, ctx.like))

    @staticmethod
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        live = [i for i, g in enumerate(grads) if g is not None and ctx.needs_input_grad[1 + i]]
        out = [None] * (1 + len(grads))
        if not live:
            return tuple(out)
        scatter = mg_kernel.scatter if idx.device.type == "cuda" else scatter_plain
        for i, g in zip(live, scatter(idx, [grads[i] for i in live], ctx.k_rows)):
            out[1 + i] = g
        return tuple(out)


def gather(tables, idx: torch.Tensor) -> tuple:
    """table[idx] for each table: MatGather on CUDA tensors, plain indexing
    on CPU tensors."""
    if idx.device.type == "cuda":
        return MatGather.apply(idx, *tables)
    return gather_plain(tables, idx)
