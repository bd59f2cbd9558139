"""Gradient reduction, FSDP and the tensor-parallel leaf layout over the
port's parameter leaves (port of ``layoutdit_tpu/parallel/sharding.py``).

Data parallelism: every rank holds the whole tree; after the backward
the gradients are summed over the ranks in buckets (``all_reduce_``) and
divided by the degree, so every rank applies the same update.

FSDP, JAX's ``_fsdp_spec`` rule: a leaf of at least ``FSDP_MIN_ELEMENTS``
elements shards its largest dim that the degree divides (the first of
equal ones) and that the model axis leaves unsharded; smaller leaves,
and those with no such dim, stay replicated. At rest the parameters,
both AdamW moments and the EMA are shards (``FsdpLayout.shard``);
before the step the parameters are
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
shards live.

Tensor parallelism (``TpLayout``, JAX's ``_vit_layer_specs`` and
``detector_param_specs`` leaf for leaf): the port stores torch's
[out, in] weights, so JAX's column-parallel ``P(None, model)`` is dim 0
here and row-parallel ``P(model, None)`` dim 1.

  * column-parallel (dim 0, bias too): the encoder's ``qkv`` and
    ``mlp_in``, the box head's ``fc6``; row-parallel (dim 1, the bias
    replicated and added once after the reduce): ``attn_out``,
    ``mlp_out``, ``fc7``;
  * the fused ``qkv`` is [q; k; v] rows: model rank m holds
    ``[q_m; k_m; v_m]``, the same slice of each third (three strided
    blocks), so its local heads are H / mp and the zero K-bias slot is
    the middle third of its shard;
  * LoRA: on a column-parallel projection (the q / k / v adapters beside
    ``qkv``, ``mlp_in``) A [d_in, r] is replicated and B [r, d_out]
    shards dim 1; on a row-parallel one A shards dim 0 and B is
    replicated;
  * MoE (expert parallelism): ``moe_in`` / ``moe_out`` weights and
    biases shard dim 0, the expert dim; the router is replicated;
  * everything else is replicated.

A replicated leaf used inside the model-parallel region has a partial
gradient on each rank, which the ranks of a model group must sum
(``TpLayout.partial``): the replicated LoRA factors, the router (each
rank's experts' part; the load-balance term counted once,
``tensor.scale_grad``) and the relative-position tables (each rank
gathers its heads' columns); under sequence parallelism also the
LayerNorms, the layer scales and the row-parallel biases, which act on
token shards. The other replicated leaves' gradients are the same on
every rank of the group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from layoutdit_tpu_torch.parallel.mesh import Comm, DataMesh, ModelGroup
from layoutdit_tpu_torch.parallel.tensor import gather_qkv

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


def fsdp_dim(shape: tuple[int, ...], degree: int, tp_dim: int | None = None) -> int | None:
    """The dim a leaf of (full) ``shape`` shards over ``degree`` ranks, or
    None (replicated): JAX's ``_fsdp_spec``, the largest dim that the
    degree divides (the first of equal ones), skipping ``tp_dim``, the dim
    the model axis already shards (FSDP over a tensor-parallel mesh)."""
    if math.prod(shape or (0,)) < FSDP_MIN_ELEMENTS:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != tp_dim and shape[i] % degree == 0:
            return i
    return None


def _tp_dim(spec) -> int | None:
    """The dim a ``tp_spec`` shards (the fused qkv's strided rows: dim 0)."""
    return 0 if spec == QKV else spec


class FsdpLayout:
    """The shard dim of each of a list of leaves (None: replicated) over
    ``mesh``'s data ranks, and the moves between full tensors and shards.

    Over a tensor-parallel mesh (``tp``, the leaves' ``TpLayout``; their
    ``shapes`` are this rank's TP shards) a leaf's FSDP dim is chosen on
    its full shape, skipping the dim the model axis shards, as JAX's
    ``_fsdp_spec`` extends the TP spec; the rank's TP shard is then
    sharded over its data group. The gather thus runs before the TP
    operators see their shards, and the reduce-scatter after the model
    group's partial sums (``TpLayout.reduce_partial``). The clip norm sums
    a leaf's squares over the axes that shard it, each leaf counted once."""

    def __init__(self, shapes: list[tuple[int, ...]], mesh: DataMesh,
                 tp: "TpLayout | None" = None):
        self.mesh = mesh
        self.comm = mesh.comm
        self.tp = tp
        specs = tp.specs if tp is not None else [None] * len(shapes)
        size = tp.group.size if tp is not None else 1
        self.dims = []
        for shape, spec in zip(shapes, specs, strict=True):
            full, d = list(shape), _tp_dim(spec)
            if d is not None:
                full[d] *= size
            self.dims.append(fsdp_dim(tuple(full), mesh.degree, d))

    def subset(self, keep: list[bool]) -> "FsdpLayout":
        """The layout of the leaves where ``keep`` is True."""
        sub = FsdpLayout([], self.mesh)
        sub.dims = [d for d, k in zip(self.dims, keep, strict=True) if k]
        sub.tp = None if self.tp is None else self.tp.subset(keep)
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
        counted once; over a model axis too, each leaf's squares summed
        over the data and model groups that shard it."""
        if self.tp is None:
            return _global_norm(grads, self.dims, self.comm)
        tp = [s is not None for s in self.tp.specs]
        fsdp = [d is not None for d in self.dims]

        def sq(keep):
            ts = [g for g, k in zip(grads, keep) if k]
            return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                    else torch.zeros((), device=grads[0].device))

        both = self.comm.all_reduce_(sq([a and b for a, b in zip(tp, fsdp)]))
        data_only = self.comm.all_reduce_(sq([b and not a for a, b in zip(tp, fsdp)]))
        model_only = sq([a and not b for a, b in zip(tp, fsdp)])
        neither = sq([not a and not b for a, b in zip(tp, fsdp)])
        return torch.sqrt(self.tp.comm.all_reduce_(both + model_only) + data_only + neither)

    def everywhere(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean scalar, True where it is True on every rank."""
        return _everywhere(flag, self.mesh.everyone)


def _global_norm(grads: list[torch.Tensor], dims: list, comm: Comm) -> torch.Tensor:
    """sqrt(the sharded leaves' (dim not None) squares summed over
    ``comm`` + the replicated leaves' squares, counted once)."""
    def sq(ts):
        return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                else torch.zeros((), device=grads[0].device))

    sharded = sq([g for g, d in zip(grads, dims, strict=True) if d is not None])
    replicated = sq([g for g, d in zip(grads, dims, strict=True) if d is None])
    return torch.sqrt(comm.all_reduce_(sharded) + replicated)


def _everywhere(flag: torch.Tensor, comm: Comm) -> torch.Tensor:
    t = flag.to(torch.int32).reshape(1)
    return comm.all_reduce_(t, op=dist.ReduceOp.MIN)[0].bool()


# --------------------------------------------------- tensor parallelism

_COL = ("mlp_in", "fc6")
_ROW = ("attn_out", "mlp_out", "fc7")
_LORA_COL = ("q", "k", "v", "mlp_in")
_EXPERTS = ("moe_in", "moe_out")
_SP_PARTIAL = ("ln1", "ln2", "lambda_1", "lambda_2")
QKV = "qkv"


def tp_spec(path: str) -> int | str | None:
    """The model-axis layout of the leaf at ``path`` (``tree_paths``): the
    dim it shards, ``"qkv"`` for the fused projection's strided rows, or
    None (replicated)."""
    keys = path.split("/")
    name, leaf = keys[-2] if len(keys) > 1 else "", keys[-1]
    in_layers = "vit" in keys and "layers" in keys
    if not (in_layers or "box_head" in keys):
        return None
    if in_layers and name == QKV:
        return QKV
    if leaf in ("lora_a", "lora_b"):
        if not in_layers:
            return None
        if name in _LORA_COL:
            return 1 if leaf == "lora_b" else None
        return 0 if leaf == "lora_a" and name in _ROW else None
    if name in _EXPERTS and in_layers:
        return 0
    if name in _COL:
        return 0
    if name in _ROW and leaf == "weight":
        return 1
    return None


def tp_partial(path: str, sequence_parallel: bool, pipelined: bool = False) -> bool:
    """Whether the leaf at ``path``, replicated over a model group, gets a
    partial gradient on each rank (summed over the group). A ``pipelined``
    encoder runs whole on every rank of the group (``parallel/pipeline.py``),
    so none of its leaves does."""
    keys = path.split("/")
    if "vit" not in keys or pipelined:
        return False
    name, leaf = keys[-2], keys[-1]
    if leaf.endswith("rel_pos_table"):
        return True
    if "layers" not in keys or tp_spec(path) is not None:
        return False
    if leaf in ("lora_a", "lora_b") or name == "router":
        return True
    if sequence_parallel:
        return name in _SP_PARTIAL or leaf in _SP_PARTIAL or (
            name in _ROW and leaf == "bias")
    return False


def _shard_one(t: torch.Tensor, spec, size: int, rank: int) -> torch.Tensor:
    if spec is None:
        return t
    if spec == QKV:
        d = t.shape[0] // (3 * size)
        if d * 3 * size != t.shape[0]:
            raise ValueError(f"qkv rows {t.shape[0]} do not split into 3 x {size} blocks")
        return t.detach().unflatten(0, (3, size, d))[:, rank].flatten(0, 1).clone()
    if t.shape[spec] % size:
        raise ValueError(f"a leaf of shape {tuple(t.shape)} does not split over {size} "
                         f"model-parallel ranks on dim {spec}")
    k = t.shape[spec] // size
    return t.detach().narrow(spec, rank * k, k).clone()


class TpLayout:
    """The model-axis layout of a list of leaves (their ``tree_paths``)
    over ``group``: which dim each shards (``specs``) and which
    replicated ones have partial gradients (``partial``); the moves
    between full tensors and shards, the gradient sum over the group,
    and the clip norm and finite test over the whole gradient."""

    def __init__(self, paths: list[str], group: ModelGroup, pipelined: bool = False):
        self.group = group
        self.comm = group.comm
        self.specs = [tp_spec(p) for p in paths]
        self.partial = [tp_partial(p, group.sequence_parallel, pipelined) for p in paths]

    def subset(self, keep: list[bool]) -> "TpLayout":
        """The layout of the leaves where ``keep`` is True."""
        sub = TpLayout([], self.group)
        sub.specs = [s for s, k in zip(self.specs, keep, strict=True) if k]
        sub.partial = [p for p, k in zip(self.partial, keep, strict=True) if k]
        return sub

    def shard(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Full tensors (the same on every rank) -> this rank's shards
        (new tensors; a replicated one as it is)."""
        return [_shard_one(t, s, self.group.size, self.group.rank)
                for t, s in zip(tensors, self.specs, strict=True)]

    @torch.no_grad()
    def gather(self, shards: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shards -> the full tensors (a replicated one as it is)."""
        out = []
        for t, s in zip(shards, self.specs, strict=True):
            if s is None:
                out.append(t)
            elif s == QKV:
                out.append(gather_qkv(t.detach(), self.group))
            else:
                out.append(self.comm.all_gather(t.detach(), s))
        return out

    def reduce_partial(self, grads: list[torch.Tensor]) -> None:
        """The partial gradients summed over the model group, in place."""
        all_reduce_([g for g, p in zip(grads, self.partial, strict=True) if p], self.comm)

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient from this rank's part of it:
        the shards' squares summed over the group, the replicated leaves'
        (the same on every rank by then) counted once."""
        return _global_norm(grads, self.specs, self.comm)

    def everywhere(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean scalar, True where it is True on every rank of the
        group."""
        return _everywhere(flag, self.comm)
