"""Mixture-of-Experts MLP for the ViT encoder (port of
``layoutdit_tpu/ops/moe.py``): Switch/GShard routing at a static
per-group capacity.

Routing, as in the JAX package:
  * router logits and softmax in fp32;
  * top-k by iterative first-index argmax (``torch.argmax`` also returns
    the first maximum); the top-1 gate is the raw probability, top-k > 1
    gates are renormalised over the chosen k with a 1e-9 floor;
  * capacity C = max(k, ceil(S * k * capacity_factor / E)) slots per
    expert and batch row, filled choice-major (every first choice before
    any second), in token order within a choice; a token past its
    expert's capacity gets zero output from it (the residual carries it);
  * Switch's load-balance loss E * sum_e f_e * P_e over the first choice,
    averaged over every token, CLS included;
  * the expert GELU exact and in fp32; the expert biases added in fp32 to
    fp32 accumulators, the result cast to the compute dtype after the
    combine.

Where the JAX package dispatches and combines with one-hot einsums over
[B, S, E, C] (shape-static for XLA), this port moves the tokens by index:
each kept (token, choice) owns one slot, so the dispatch is an
``index_select`` of token rows into the [E, B*C, D] expert batch (empty
slots read a zero row) and the combine a gather of each token's slots
from the experts' output, times its gate. The values are the einsums'
(one-hot products select exactly), the shapes stay static (no
data-dependent size: ``torch.export`` traces it), and the work is O(S*D)
instead of O(S*E*C*D). The backward's scatter-adds put at most k values
into a token's row and one into an expert slot's, so they sum in one
order on every run (a + b is b + a); only the zero row, which no one
reads, takes many.

The expert products are batched matmuls over [E, B*C, D] x [E, D, F] and
[E, B*C, F] x [E, F, D], left to torch (JAX leaves them to XLA). They run
as ``baddbmm`` on the compute dtype's values widened to fp32, the bias as
the fp32 addend: the products of two bf16 values are exact in fp32, so
this is JAX's bf16-in, fp32-accumulate, fp32-bias product. Each stage
runs under a ``record_function`` range: ``moe_router``, ``moe_dispatch``,
``moe_experts`` and ``moe_combine``.

Expert parallelism (``tp``, a model group; JAX shards the stacked
experts' E dim over the ``model`` axis and lets GSPMD exchange tokens):
the input is replicated over the group (after the token gather under
sequence parallelism), so every rank routes every token with the
replicated router, fills only the slots of its own E / mp experts,
combines their gated outputs and leaves the sum over the group, in
float32, to the caller's ``reduce_out``. No all-to-all; the routing, the capacity slots
and the load-balance loss are the one-process ones, the loss's gradient
counted once over the group (``parallel.tensor.scale_grad``).

Parameters, in the JAX package's layouts: ``router/weight`` [D, E],
``moe_in/{weight [E, D, F], bias [E, F]}``, ``moe_out/{weight [E, F, D],
bias [E, D]}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from layoutdit_tpu_torch.parallel.mesh import ModelGroup, global_mean
from layoutdit_tpu_torch.parallel.tensor import scale_grad


def moe_capacity(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Static per-group expert capacity (at least ``top_k`` slots)."""
    return max(top_k, int(math.ceil(tokens * top_k * capacity_factor / num_experts)))


def trunc_normal(shape, std, generator, device) -> torch.Tensor:
    """fp32 normal(0, std) truncated at +-2 std (JAX's truncated_normal(-2,
    2) x std), drawn from ``generator``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                       generator=generator)


def init_moe_mlp_params(hidden_size: int, intermediate_size: int, num_experts: int,
                        generator: torch.Generator, device, initializer_range: float = 0.02
                        ) -> dict:
    """One MoE layer's parameters: truncated-normal (+-2 std) kernels at
    ``initializer_range`` drawn from ``generator`` (router, then the
    experts' in and out kernels), zero biases."""
    d, f, e = hidden_size, intermediate_size, num_experts
    std = initializer_range
    return {
        "router": {"weight": trunc_normal((d, e), std, generator, device)},
        "moe_in": {"weight": trunc_normal((e, d, f), std, generator, device),
                   "bias": torch.zeros((e, f), dtype=torch.float32, device=device)},
        "moe_out": {"weight": trunc_normal((e, f, d), std, generator, device),
                    "bias": torch.zeros((e, d), dtype=torch.float32, device=device)},
    }


def route(y: torch.Tensor, router: torch.Tensor, num_experts: int, top_k: int, capacity: int):
    """The routing of ``y`` [B, S, D]: per choice j, each token's expert
    ``experts[j]`` [B, S], its gate ``gates[j]`` [B, S] (fp32), its slot
    in that expert's queue ``slots[j]`` [B, S] and whether the slot is
    within capacity ``kept[j]``; and the fp32 load-balance loss. The
    token counts run over [B, E, S] one-hots, the token axis innermost,
    where the scans and sums over tokens are contiguous."""
    b, s, _ = y.shape
    e = num_experts
    probs = torch.softmax(torch.matmul(y.float(), router.float()), dim=-1)  # [B, S, E]
    remaining = probs
    experts, gates, counts = [], [], None
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        oh = F.one_hot(idx, e).to(probs.dtype)
        experts.append(idx)
        gates.append((remaining * oh).sum(-1))
        remaining = remaining * (1.0 - oh)
    gates = torch.stack(gates)  # [k, B, S]
    if top_k > 1:
        gates = gates / torch.clamp(gates.sum(0, keepdim=True), min=1e-9)
    # slots: choice-major, token order within a choice (integer counts)
    fill = torch.zeros((b, e), dtype=torch.int64, device=y.device)
    slots, kept = [], []
    for idx in experts:
        oh = F.one_hot(idx, e).transpose(1, 2).contiguous()  # int64 [B, E, S]
        if counts is None:
            counts = oh.sum(dim=(0, 2))  # first choices an expert
        rank = torch.cumsum(oh, dim=-1) - oh
        pos = rank.gather(1, idx[:, None, :])[:, 0] + fill.gather(1, idx)
        keep = pos < capacity
        slots.append(pos)
        kept.append(keep)
        fill = fill + (oh * keep[:, None, :]).sum(-1)
    # means over every token of the global batch, before their product
    frac = global_mean(counts.to(probs.dtype) / (b * s))
    aux = e * torch.sum(frac * global_mean(probs.reshape(b * s, e).mean(0)))
    return experts, gates, slots, kept, aux


def moe_mlp(y: torch.Tensor, params: dict, num_experts: int, top_k: int = 1,
            capacity_factor: float = 1.25, tp: ModelGroup | None = None,
            dtype: torch.dtype | None = None,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse MLP over ``y`` [B, S, D] (the block's post-LN input): each
    token to its top-k experts at static capacity, the experts' GELU MLPs,
    the gated outputs summed. -> (out [B, S, D] in the compute dtype
    ``dtype`` (y's by default), the fp32 load-balance loss). Under ``tp``
    the experts are this rank's E / mp (``params``' shards), ``y`` the
    region's float32 carrier of ``dtype`` values
    (``parallel.tensor.copy_in``: its gradient, this rank's partial, stays
    float32) and ``out`` their float32 part of the sum."""
    dtype = y.dtype if dtype is None else dtype
    b, s, d = y.shape
    e, k = num_experts, top_k
    c = moe_capacity(s, e, k, capacity_factor)
    size = 1 if tp is None else tp.size
    if e % size:
        raise ValueError(f"num_experts={e} does not split over model_parallel={size} ranks")
    local, first = e // size, 0 if tp is None else tp.rank * (e // size)
    with record_function("moe_router"):
        experts, gates, slots, kept, aux = route(y, params["router"]["weight"], e, k, c)
        aux = scale_grad(aux, 1.0 / size)
    with record_function("moe_dispatch"):
        rows = torch.arange(b, device=y.device)[:, None] * c  # [B, 1]
        # each kept (token, choice) of this rank's experts -> its slot in
        # the [E_local, B, C] expert batch; the rest to the dump slot
        if size > 1:
            kept = [keep & (idx >= first) & (idx < first + local)
                    for idx, keep in zip(experts, kept)]
        e = local
        flat = [torch.where(keep, (idx - first) * (b * c) + rows + pos, e * b * c)
                for idx, pos, keep in zip(experts, slots, kept)]
        token = torch.arange(b * s, device=y.device)
        # the token filling each slot; empty slots (and the dump slot
        # e*b*c that overflow tokens write) read row b*s, zeros
        source = torch.full((e * b * c + 1,), b * s, dtype=torch.int64, device=y.device)
        for f in flat:
            source.scatter_(0, f.reshape(-1), token)
        y_rows = torch.cat([y.reshape(b * s, d), y.new_zeros(1, d)])
        xin = y_rows.index_select(0, source[:-1]).view(e, b * c, d)
    with record_function("moe_experts"):
        w_in = params["moe_in"]["weight"].to(dtype).float()
        h = torch.baddbmm(params["moe_in"]["bias"].float()[:, None, :], xin.float(), w_in)
        h = F.gelu(h).to(dtype)
        w_out = params["moe_out"]["weight"].to(dtype).float()
        out_e = torch.baddbmm(params["moe_out"]["bias"].float()[:, None, :], h.float(), w_out)
    with record_function("moe_combine"):
        out_rows = out_e.reshape(e * b * c, d)
        out = None
        for f, gate, keep in zip(flat, gates, kept):
            picked = out_rows.index_select(0, f.reshape(-1).clamp(max=e * b * c - 1))
            part = torch.where(keep.reshape(-1, 1), gate.reshape(-1, 1) * picked, 0.0)
            out = part if out is None else out + part
    return out.view(b, s, d).to(dtype if size == 1 else torch.float32), aux
