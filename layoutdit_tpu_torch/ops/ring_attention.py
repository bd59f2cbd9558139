"""Ring attention: exact attention over a token-sharded model group (port
of ``layoutdit_tpu/ops/ring_attention.py``).

Under sequence parallelism each rank of a model group holds ``k =
ceil(N / P)`` of the sequence's N tokens (the last rank's tail is
padding). Ring attention keeps Q, K, V and the output sharded for the
whole computation: in P steps each rank attends its queries to the
visiting K/V block and passes the block on to the next rank
(``Comm.ppermute``: to rank + 1, from rank - 1), merging the steps'
partial results by their log-sum-exp, the online-softmax recurrence of
JAX's ``_ring_body``. Memory per rank: O(N / P) plus one [k, k] tile.

The backward is the standard ring backward, written out (autograd does
not differentiate through a send): from the merged output O and the
global lse, every step recomputes its block's probabilities, dQ
accumulates at home, and the dK / dV accumulators travel with their
K / V block, arriving home after P rotations.

Each block is a square [k, k] attention, the flash kernels' layout
(``ops/flash_attention.py``, rows 3-5: the forward, dq and dkdv kernels)
with the block's valid-key count ``n_keys``, which masks the padding
that only the last rank's block holds; a block with no valid key is
skipped. On the CPU the wrappers run their plain versions, per block.

As JAX's, it takes no attention bias (relative-position models use the
other routes) and needs the token-sharded stream (``models/vit.py``).
"""

from __future__ import annotations

import torch

from layoutdit_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
from layoutdit_tpu_torch.parallel.mesh import ModelGroup


def block_keys(n: int, k: int, j: int) -> int:
    """The valid keys of block ``j`` (tokens j*k .. j*k + k - 1) of a
    sequence of ``n`` tokens."""
    return min(max(n - j * k, 0), k)


def _step_keys(n: int, k: int, j: int) -> int | None:
    """``n_keys`` for the flash wrappers: None for a full block."""
    nk = block_keys(n, k, j)
    return None if nk == k else nk


def _bh_to_rows(t: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, k] -> [B, k, H, 1], to weigh [B, k, H, D] rows."""
    return t.view(b, h, -1).permute(0, 2, 1)[..., None]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, scale):
        b, kl, h, _ = q.shape
        size, rank = group.size, group.rank
        o = lse = None
        kb, vb = k, v
        for s in range(size):
            j = (rank - s) % size
            if block_keys(n, kl, j) > 0:
                o_s, lse_s = flash_attention_fwd(q, kb, vb, None, scale, _step_keys(n, kl, j))
                if o is None:
                    o, lse = o_s.float(), lse_s
                else:  # merge by the log-sum-exp: the online-softmax step
                    new = torch.logaddexp(lse, lse_s)
                    o = (o * _bh_to_rows(torch.exp(lse - new), b, h)
                         + o_s.float() * _bh_to_rows(torch.exp(lse_s - new), b, h))
                    lse = new
            if s < size - 1:
                kb, vb = group.comm.ppermute(kb), group.comm.ppermute(vb)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.n, ctx.scale = group, n, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, n, scale = ctx.group, ctx.n, ctx.scale
        size, rank, kl = group.size, group.rank, q.shape[1]
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kb, vb = k, v
        for s in range(size):
            j = (rank - s) % size
            if block_keys(n, kl, j) > 0:
                dq_s, dk_s, dv_s, _ = flash_attention_bwd(
                    q, kb, vb, o, lse, do, None, scale, n_keys=_step_keys(n, kl, j))
                dq += dq_s.float()
                dk += dk_s.float()
                dv += dv_s.float()
            if s < size - 1:
                kb, vb = group.comm.ppermute(kb), group.comm.ppermute(vb)
            # the accumulators travel with their block; after the last
            # step's rotation each is home
            dk, dv = group.comm.ppermute(dk), group.comm.ppermute(dv)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: ModelGroup,
                   n: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the whole sequence of ``n`` tokens,
    from this rank's token shards q, k, v [B, k, H, D] (rank r holds tokens
    r*k .. r*k + k - 1; those past ``n`` are padding, masked as keys)
    -> this rank's output rows [B, k, H, D], differentiable in q, k, v."""
    if group.size * q.shape[1] < n:
        raise ValueError(f"ring_attention: {group.size} shards of {q.shape[1]} tokens do not "
                         f"hold {n}")
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), group, n,
                                float(scale))
