"""Gradient reduction and FSDP over the port's parameter leaves (port of
the data-parallel half of ``layoutdit_tpu/parallel/sharding.py``).

Data parallelism: every rank holds the whole tree; after the backward
the gradients are summed over the ranks in buckets (``all_reduce_``) and
divided by the degree, so every rank applies the same update.

FSDP, JAX's ``_fsdp_spec`` rule: a leaf of at least ``FSDP_MIN_ELEMENTS``
elements shards its largest dim that the degree divides (the first of
equal ones); smaller leaves, and those with no such dim, stay
replicated. At rest the parameters, both AdamW moments and the EMA are
shards (``FsdpLayout.shard``); before the step the parameters are
all-gathered (``gather``); after the backward the gradients are
reduce-scattered back to shards (``reduce_grads``), and the optimizer
updates the shards, its clip norm and finite test taken over the whole
gradient (``global_norm``, ``everywhere``).

Why collectives over the leaves and not DDP or ``fully_shard``: the
port's model is a dict of leaf tensors with its own optax-layout
optimizer (``train/optim.py``), not an ``nn.Module`` with a
``torch.optim`` optimizer. DDP and ``fully_shard`` wrap modules and hook
their parameters; DTensor leaves would reach every kernel wrapper, which
take plain tensors. A shard dim per leaf and four collectives do the same
work inside the trainer's own step, and the checkpoints keep the one-card
layout (the lead rank gathers, then writes).

One difference from JAX, where XLA gathers each weight at its use: the
whole tree is gathered before the forward, so a step's peak holds the
full parameters and gradients beside the shards; between steps only the
shards live. The Megatron specs of tensor parallelism wait for the
model-parallel half of ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from layoutdit_tpu_torch.parallel.mesh import Comm, DataMesh

# leaves smaller than this stay replicated under FSDP (JAX's
# _FSDP_MIN_ELEMENTS): sharding a LayerNorm scale saves nothing and costs
# a collective
FSDP_MIN_ELEMENTS = 2 ** 14
# DDP's default bucket: large enough to amortise a collective's latency
BUCKET_BYTES = 25 * 2 ** 20


def all_reduce_(tensors: list[torch.Tensor], comm: Comm) -> None:
    """Each tensor summed over the ranks, in place, in buckets of one
    dtype of up to ``BUCKET_BYTES`` (a larger tensor goes alone)."""
    bucket: list[torch.Tensor] = []
    size = 0

    def flush():
        if bucket:
            flat = comm.all_reduce_(torch.cat([t.reshape(-1) for t in bucket]))
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))
            bucket.clear()

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(t)
        size += nbytes
    flush()


def fsdp_dim(shape: tuple[int, ...], degree: int) -> int | None:
    """The dim a leaf of ``shape`` shards over ``degree`` ranks, or None
    (replicated): JAX's ``_fsdp_spec`` on a leaf with no model-axis
    spec."""
    if math.prod(shape or (0,)) < FSDP_MIN_ELEMENTS:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % degree == 0:
            return i
    return None


class FsdpLayout:
    """The shard dim of each of a list of leaves (None: replicated) over
    ``mesh``'s ranks, and the moves between full tensors and shards."""

    def __init__(self, shapes: list[tuple[int, ...]], mesh: DataMesh):
        self.mesh = mesh
        self.comm = mesh.comm
        self.dims = [fsdp_dim(tuple(s), mesh.degree) for s in shapes]

    def subset(self, keep: list[bool]) -> "FsdpLayout":
        """The layout of the leaves where ``keep`` is True."""
        sub = FsdpLayout([], self.mesh)
        sub.dims = [d for d, k in zip(self.dims, keep, strict=True) if k]
        return sub

    def shard(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Full tensors (the same on every rank) -> this rank's shards,
        new tensors; a replicated one is kept as it is."""
        out = []
        for t, d in zip(tensors, self.dims, strict=True):
            if d is None:
                out.append(t)
            else:
                k = t.shape[d] // self.mesh.degree
                out.append(t.detach().narrow(d, self.mesh.rank * k, k).clone())
        return out

    def gather(self, shards: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shards -> the full tensors (a replicated one as it is)."""
        return [s if d is None else self.comm.all_gather(s.detach(), d)
                for s, d in zip(shards, self.dims, strict=True)]

    def reduce_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Full local gradients -> their sums over the ranks: a shard for
        a sharded leaf (reduce-scatter), the whole for a replicated one
        (``all_reduce_``, in place)."""
        replicated = [g for g, d in zip(grads, self.dims, strict=True) if d is None]
        all_reduce_(replicated, self.comm)
        return [g if d is None else self.comm.reduce_scatter(g, d)
                for g, d in zip(grads, self.dims, strict=True)]

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient from this rank's part of it:
        the shards' squares summed over the ranks, the replicated leaves'
        counted once."""
        def sq(ts):
            return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                    else torch.zeros((), device=grads[0].device))

        sharded = sq([g for g, d in zip(grads, self.dims, strict=True) if d is not None])
        replicated = sq([g for g, d in zip(grads, self.dims, strict=True) if d is None])
        return torch.sqrt(self.comm.all_reduce_(sharded) + replicated)

    def everywhere(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean scalar, True where it is True on every rank."""
        t = flag.to(torch.int32).reshape(1)
        return self.comm.all_reduce_(t, op=dist.ReduceOp.MIN)[0].bool()
