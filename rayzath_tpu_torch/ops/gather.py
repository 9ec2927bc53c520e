"""Row gathers from small tables, with a backward that sums per row.

Counterpart of ``rayzath_tpu/ops/gather.py``. There ``gather_rows`` takes
the rows of a table of at most 128 rows as a one-hot product on the MXU, so
its transpose, the table's gradient, is a dense reduction of the cotangents
onto each row. Here the forward is the hand-written gather G1 and the
backward the hand-written per-row sum G2 (``csrc/gather_rows.cu``):
:func:`gather_rows_fwd` and :func:`gather_rows_grad` take the plain
versions :func:`gather_rows_plain` and :func:`gather_rows_grad_plain` for
tensors on the CPU, launch the kernels for tensors on a CUDA device, and
count their launches in a ``launches`` attribute; any other device raises
(after the kernel library's load, which raises without a card or nvcc),
and there is no fallback. G2 sums in float64 and rounds once, so it gives
the exact sum to float32 rounding, as the plain version does. A table
whose [N, K] float64 fits in shared memory (``rz_gather_grad_partials`` >
0: the material, light and opacity tables) is summed in a fixed order, so
two calls give the same bits, as the JAX product does; a larger table
(the texture atlases) takes float64 atomics, whose order varies from call
to call (the float32 result only where a sum lies within ~1e-16 of a
rounding boundary).

What bounds them on an H100 (the ``.cu`` file's header says more): both
are bound by bytes, G1 also by the latency of its dependent loads (an
index, then that row) and G2 by the instructions each ray costs. G1
writes a 16-byte word per thread, one uint4 row vector where the width is
a multiple of 4. G2 shuffles no value: on a small table its lanes are
columns that keep a running sum per row over consecutive rays and add it
to their own shared slice when the row changes; on an atlas each warp
groups its 32 rays by row and each lane sums one (row, column) pair
before one atomic add.

The one-hot product's bf16 limb split is left out: a gather is a copy, so
G1 returns ``table[idx]``'s bits; the JAX package's table gradients are
rounded to bf16 by its transpose (ROADMAP C), the port's are not.
"""
from __future__ import annotations

import math

import torch

from . import _kernels
from ._kernels import counted, launch as _launch, ptr as _ptr

#: element types G1 copies (as 4-byte words)
_WORDS = (torch.float32, torch.int32)
_INDEX = (torch.int32, torch.int64)


def _clamped(idx, n: int):
    """``idx`` clamped into [0, n), as JAX clamps an out-of-range take."""
    return torch.clamp(idx, 0, max(n - 1, 0))


def gather_rows_plain(table, idx):
    """``table[idx]`` with each index clamped into the table:
    idx.shape + table.shape[1:]."""
    return table[_clamped(idx, table.shape[0]).long()]


def gather_rows_grad_plain(idx, g, n: int):
    """[n, K] float32: the rows of the cotangent ``g`` (idx.shape + K, K
    the product of the table's trailing dims) summed per clamped index, in
    float64 and rounded once, so that it is the exact sum to float32
    rounding whatever order another version adds in."""
    m, k = idx.numel(), _cotangent_width(idx, g)
    out = torch.zeros((n, k), dtype=torch.float64, device=g.device)
    out.index_add_(0, _clamped(idx, n).reshape(-1).long(),
                   g.reshape(m, k).to(torch.float64))
    return out.to(torch.float32)


def _cotangent_width(idx, g) -> int:
    """K of a cotangent idx.shape + K (raises on another shape)."""
    if g.shape[:idx.dim()] != idx.shape:
        raise ValueError(f"cotangent {tuple(g.shape)} does not start with the "
                         f"index shape {tuple(idx.shape)}")
    return math.prod(g.shape[idx.dim():])


@counted()
def gather_rows_fwd(table, idx):
    """G1: ``table[idx]`` (each index clamped into the table), shape
    idx.shape + table.shape[1:]. CPU tensors take
    :func:`gather_rows_plain`; CUDA tensors launch the kernel (float32 or
    int32 tables, int32 or int64 indices), which copies the rows' bits."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    lib = _kernels.load()
    dev = _kernels.card(table.device)
    table, idx = table.contiguous(), idx.contiguous()
    _kernels.check(dev, "idx", idx, _INDEX)
    _kernels.check(dev, "table", table, _WORDS)
    n, k = table.shape[0], math.prod(table.shape[1:])
    out = torch.empty(tuple(idx.shape) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=dev)
    m = idx.numel()
    if m and k:
        if n == 0:
            raise ValueError("gather_rows from an empty table")
        _launch(gather_rows_fwd, lib.rz_gather_rows, dev, _ptr(table),
                _ptr(idx), int(idx.dtype == torch.int64), m, k, n, _ptr(out))
    return out


@counted()
def gather_rows_grad(idx, g, n: int):
    """G2: [n, K] float32, the rows of ``g`` (idx.shape + K) summed per
    clamped index (:func:`gather_rows_grad_plain`). CPU tensors take the
    plain version; CUDA tensors launch the kernel, which sums in float64
    and rounds once: in a fixed order through shared memory when [n, K]
    float64 fits in 48 KB (two calls, the same bits), with float64 atomics
    when it does not."""
    if g.device.type == "cpu":
        return gather_rows_grad_plain(idx, g, n)
    lib = _kernels.load()
    dev = _kernels.card(g.device)
    idx, g = idx.contiguous(), g.contiguous()
    _kernels.check(dev, "idx", idx, _INDEX)
    _kernels.check(dev, "g", g, torch.float32)
    m, k = idx.numel(), _cotangent_width(idx, g)
    if not (m and k and n):
        if m and k:
            raise ValueError("gather_rows_grad onto an empty table")
        return torch.zeros((n, k), dtype=torch.float32, device=dev)
    parts = lib.rz_gather_grad_partials(m, n, k)
    f64 = dict(dtype=torch.float64, device=dev)
    # the small path's per-block partials, or the atomic path's accumulator
    scratch = torch.empty(parts, **f64) if parts else torch.zeros(n * k, **f64)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    _launch(gather_rows_grad, lib.rz_gather_rows_grad, dev, _ptr(idx),
            int(idx.dtype == torch.int64), _ptr(g), m, k, n, _ptr(scratch),
            _ptr(out))
    return out


class _Gather(torch.autograd.Function):
    """:func:`gather_rows` for a table that needs a gradient: G1 forward,
    G2 backward (the index gets none)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return gather_rows_fwd(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = gather_rows_grad(idx, g, ctx.table_shape[0])
        return d.reshape(ctx.table_shape), None


def gather_rows(table, idx):
    """``table[idx]``: table [N, ...] (float32, or int32 for index tables),
    idx int32 or int64 of any shape, clamped into [0, N) as JAX's take
    clamps it (callers clip it already). Returns idx.shape +
    table.shape[1:]. Differentiable in ``table``: its gradient is the
    cotangent's rows summed per index (G2), never torch's index
    backward."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _Gather.apply(table, idx)
    return gather_rows_fwd(table, idx)
