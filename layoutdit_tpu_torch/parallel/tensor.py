"""Megatron's operators over a model group (``parallel/mesh.py``'s
``ModelGroup``): tensor, sequence and expert parallelism written out.

JAX shards the encoder's weights over a mesh's ``model`` axis
(``layoutdit_tpu/parallel/sharding.py``) and lets GSPMD place the
collectives; with ``sequence_parallel`` it pins the residual stream to
``P(None, 'model', None)`` at every block boundary and lets XLA derive
the Megatron-SP schedule. The port runs one process a rank and writes the
collectives out, as ``torch.autograd.Function``s whose backward is the
forward's transpose:

  * ``copy_in``: identity forward (the values as float32), all-reduce
    backward (the input of a column-parallel product: each rank's
    gradient is its heads' part);
  * ``reduce_out``: all-reduce forward, identity backward (the output of
    a row-parallel product, each rank's a partial sum);
  * under sequence parallelism, ``gather_tokens`` (all-gather on the
    token dim forward, reduce-scatter backward) in place of ``copy_in``
    and ``scatter_tokens`` (reduce-scatter forward, all-gather backward)
    in place of ``reduce_out``; ``split_tokens`` enters the token-sharded
    stream (each rank keeps its part, the backward all-gathers) and
    ``collect_tokens`` leaves it at the taps (all-gather forward, each
    rank's part of the replicated gradient backward);
  * ``gather_weight``: a weight's shards all-gathered forward and its
    gradient reduce-scattered backward (ring attention's projections).

The partial sums are float32, so that the group's sum is rounded once,
where one process's GEMM rounds its float32 accumulator once (bf16
partials, each rounded on its rank, put a two-layer bf16 model's worst
gradient leaf 9.7e-2 of max |ref| from one process's; float32 partials,
4.5e-3: ``tests/test_torch_tensor_parallel.py``). ``row_linear`` (a row-parallel product) gives its partial in
float32; ``reduce_out`` / ``scatter_tokens`` sum it in float32 and the
caller adds the bias and rounds once. ``copy_in`` / ``gather_tokens``
hand the region a float32 carrier of the input's values, and
``column_linear`` (a column-parallel product on it) runs the product in
the compute dtype but leaves its input gradient, each rank's partial, in
float32 for the group's sum, rounded once to the input's dtype.

The token count rarely divides the degree (4097 tokens at 1024 px, 197
at 224 px): a rank holds ``ceil(N / mp)`` tokens, the last one's tail
zero rows. The gathers slice back to N before the column-parallel
region and the scatters pad the row-parallel output after it, so padded
rows never reach the attention or the MoE router; LayerNorm keeps a zero
row finite, and the taps drop the padding.

A group of one makes every operator the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.parallel.mesh import ModelGroup


def shard_len(n: int, size: int) -> int:
    """Tokens a rank holds of ``n`` split over ``size`` ranks."""
    return math.ceil(n / size)


def _pad_tokens(x: torch.Tensor, total: int) -> torch.Tensor:
    return x if x.shape[1] == total else F.pad(x, (0, 0, 0, total - x.shape[1]))


def _all_reduce(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """The sum over the group in float32, rounded once to ``x``'s dtype."""
    return group.comm.all_reduce_(x.float().contiguous().clone()).to(x.dtype)


def _reduce_scatter(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    return group.comm.reduce_scatter(x.float(), 1).to(x.dtype)


def _carrier(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values as float32 (``x`` itself, as a view, if it is)."""
    return x.view_as(x) if x.dtype == torch.float32 else x.float()


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] accumulated and returned in float32: on the card
    cuBLAS's bf16 product with a float32 output; on the CPU the float32
    product of the same values (a product of two bf16 values is exact in
    float32)."""
    if a.dtype == torch.float32:
        return a @ b.float()
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.dtype = group, x.dtype
        return _carrier(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group).to(ctx.dtype), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.total, ctx.dtype = group, x.shape[1] * group.size, x.dtype
        return _carrier(group.comm.all_gather(x, 1)[:, :n])

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(_pad_tokens(g, ctx.total), ctx.group).to(ctx.dtype),
                None, None)


class _ColumnLinear(torch.autograd.Function):
    """x W^T + b in W's dtype on a region's float32 carrier ``x``; the
    input gradient, this rank's partial, stays float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        xw = x.to(w.dtype)
        ctx.save_for_backward(xw, w)
        ctx.has_bias = b is not None
        return F.linear(xw, w, b)

    @staticmethod
    def backward(ctx, g):
        xw, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = mm_f32(g2, w).reshape(*g.shape[:-1], w.shape[1])
        if ctx.needs_input_grad[1]:
            dw = g2.t() @ xw.reshape(-1, xw.shape[-1])
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g2.sum(0)
        return dx, dw, db


class _RowLinear(torch.autograd.Function):
    """x W^T in float32 (this rank's partial sum) for x, W in the compute
    dtype; the float32 gradient is rounded back to it, exactly, as it is
    one of the compute dtype's values."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.to(x.dtype).reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ w).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = g2.t() @ x.reshape(-1, x.shape[-1])
        return dx, dw


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        n, size = y.shape[1], group.size
        ctx.group, ctx.n = group, n
        return _reduce_scatter(_pad_tokens(y, shard_len(n, size) * size), group)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.comm.all_gather(g.contiguous(), 1)[:, :ctx.n], None


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, size = x.shape[1], group.size
        k = shard_len(n, size)
        ctx.group, ctx.n = group, n
        return _pad_tokens(x, k * size).narrow(1, group.rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.comm.all_gather(g.contiguous(), 1)[:, :ctx.n], None


class _CollectTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.k = group, x.shape[1]
        return group.comm.all_gather(x.contiguous(), 1)[:, :n]

    @staticmethod
    def backward(ctx, g):
        k, size = ctx.k, ctx.group.size
        return _pad_tokens(g, k * size).narrow(1, ctx.group.rank * k, k).contiguous(), None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.comm.all_gather(w.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.comm.reduce_scatter(g.float(), ctx.dim).to(g.dtype), None, None


def _on(group: ModelGroup | None) -> bool:
    return group is not None and group.size > 1


def copy_in(x: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """Enter a column-parallel region: ``x``'s values as the float32
    carrier ``column_linear`` takes, the float32 partial gradients
    all-reduced backward and rounded once to ``x``'s dtype."""
    return _CopyIn.apply(x, group) if _on(group) else x


def reduce_out(x: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """Leave a row-parallel region: the ranks' partial sums summed (in
    float32 for ``row_linear``'s float32 partials)."""
    return _ReduceOut.apply(x, group) if _on(group) else x


def gather_tokens(x: torch.Tensor, group: ModelGroup | None, n: int) -> torch.Tensor:
    """Token shards [B, k, D] -> the whole sequence [B, n, D] (padding
    dropped) as ``copy_in``'s float32 carrier; the backward reduce-scatters
    in float32 and rounds once to ``x``'s dtype."""
    return _GatherTokens.apply(x, group, n) if _on(group) else x


def scatter_tokens(y: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """Partial sums over the whole sequence [B, n, D] -> this rank's token
    shard of their sum [B, ceil(n / mp), D] (zero-padded at the end)."""
    return _ScatterTokens.apply(y, group) if _on(group) else y


def column_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                  ) -> torch.Tensor:
    """A column-parallel product x W^T + b in W's dtype on ``copy_in`` /
    ``gather_tokens``' carrier ``x`` (values of W's dtype; any ``x`` in
    W's dtype too): the forward is one process's product; the input
    gradient is left in float32 for the group's sum."""
    return _ColumnLinear.apply(x, w, b)


def row_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product x W^T (``x`` and ``w`` in the compute dtype)
    -> this rank's float32 partial sum, for ``reduce_out`` /
    ``scatter_tokens``; the caller adds the bias and rounds once."""
    return _RowLinear.apply(x, w)


def split_tokens(x: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """A replicated [B, n, D] -> this rank's token shard; the backward
    all-gathers the shards' gradients."""
    return _SplitTokens.apply(x, group) if _on(group) else x


def collect_tokens(x: torch.Tensor, group: ModelGroup | None, n: int) -> torch.Tensor:
    """Token shards -> the replicated [B, n, D] (a tap); the backward
    keeps this rank's part of the (replicated) gradient."""
    return _CollectTokens.apply(x, group, n) if _on(group) else x


def gather_weight(w: torch.Tensor, group: ModelGroup | None, dim: int) -> torch.Tensor:
    """A weight's shards on ``dim`` -> the whole weight; its gradient
    reduce-scattered back to this rank's shard."""
    return _GatherWeight.apply(w, group, dim) if _on(group) else w


def gather_qkv(t: torch.Tensor, group: ModelGroup | None, dim: int = 0) -> torch.Tensor:
    """The fused qkv's shards ([q_m; k_m; v_m] rows on ``dim``, see
    ``parallel/sharding.py``) -> the whole [q; k; v] along ``dim``,
    differentiable (``gather_weight``)."""
    if not _on(group):
        return t
    full = gather_weight(t, group, dim)  # [q_0; k_0; v_0; q_1; ...]
    shape = full.shape
    d = shape[dim] // (3 * group.size)
    parts = full.unflatten(dim, (group.size, 3, d)).transpose(dim, dim + 1)
    return parts.reshape(shape)


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x`` in value, ``factor`` times its gradient: a term every rank
    of a model group computes whole (the MoE load-balance loss), counted
    once when the group sums the gradients."""
    if factor == 1.0:
        return x
    scaled = x * factor
    return x.detach() + (scaled - scaled.detach())
