"""GPipe pipeline stages for the ViT encoder (port of
``layoutdit_tpu/parallel/pipeline.py``).

JAX stacks the L encoder layers on a leading axis sharded over the mesh's
``pipe`` axis and runs one SPMD program per stage inside a ``shard_map``:
at tick t stage s applies its L / S layers to the microbatch it holds and
``ppermute``s the boundary activation to stage s + 1. The port runs the
same schedule with one process per stage (``parallel/mesh.py``'s pipe
group, ``PipeGroup``):

  * stage s owns layers [s L/S, (s+1) L/S) of the per-layer list (the
    port keeps the list: stacking the layers, as JAX's
    ``stack_layer_params`` does for its scan, would copy every weight each
    step; ``stage_layers`` is JAX's ``shard_stacked_layers``);
  * M microbatches and S stages take T = M + S - 1 ticks. Stage 0 injects
    microbatch t; at every tick every stage sends its boundary activation
    to the next by ``Comm.ppermute`` over [(i, (i + 1) % S)], JAX's cyclic
    permutation, so each tick's sends and receives pair on every rank. A
    stage computes only inside its live window t in [s, s + M - 1]
    (JAX computes junk outside it and never stores it; here the bubble
    ticks send a tensor that no one stores);
  * each stage keeps its layers' outputs for its live microbatches, so an
    FPN tap (layers d/3, d/2, 2d/3, d) works where it falls inside a
    stage. After the last tick each tap is broadcast from its stage to
    every stage of the group.

The backward is the reverse pipeline, and it runs explicitly: the whole
schedule is one ``torch.autograd.Function`` whose backward walks the ticks
in reverse order, microbatch by microbatch, takes the gradient of each
stage-tick's outputs (its taps' and, from stage s + 1, its boundary's)
with ``torch.autograd.grad``, and ``ppermute``s each boundary input's
gradient back by one stage. Every rank thus runs the same sequence of
point-to-point steps in both directions, whatever order autograd's engine
would pick inside one rank: no send waits on a receive posted later. With
``remat`` (JAX's ``pcfg.remat or remat``) each stage-tick runs under
``torch.utils.checkpoint`` and is recomputed in that backward.

Where the head and the parameters live: the parameters are whole on every
stage (JAX's are replicated over ``pipe`` at rest), and the taps go to
every stage, which runs the head, as JAX's head runs replicated over
``pipe`` on the gathered layer outputs. The head's gradients are thus the
same on every stage and its tap gradients local to each tap's owner: no
send is needed for them. A stage returns gradients for its own layers
only, stage 0 for the embedding; ``reduce_pipe_grads`` then sums the
encoder's gradients over the pipe group and takes the last stage's for
everything else, so every stage applies the same update and keeps the
same parameters. This design was chosen over running the head on the
last stage alone and broadcasting its gradients: both send the same
bytes (the taps one way, or the head's gradients and the taps'
gradients the other), and this one needs no second schedule for the
head.

Inside a stage the encoder's layers are whole on each rank of a model
group, as JAX's ``shard_map`` (whose in_specs name only ``pipe``) gathers
them: the stage gathers each tensor-parallel leaf's shards before its
first tick and hands back, in the backward, this rank's shard of the
layer's gradient. Attention inside a stage takes the port's length
routing to the hand kernels (flash at N = 4097, the short kernels at
N <= 256), where JAX forces XLA's attention inside its stage program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map, tree_paths
from layoutdit_tpu_torch.parallel.mesh import ModelGroup, PipeGroup
from layoutdit_tpu_torch.parallel.sharding import _shard_one, all_reduce_, tp_spec
from layoutdit_tpu_torch.parallel.tensor import gather_qkv


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """How to pipeline the encoder; pass it as ``vit_forward(pipeline=...)``
    (threaded through ``detector_loss``). ``group``: this rank's pipe
    group; the GPipe bubble is (S-1)/(M+S-1) of the ticks, fewer with more
    ``n_microbatches``; ``remat`` recomputes each stage-tick in the
    backward."""

    group: PipeGroup
    n_microbatches: int = 4
    remat: bool = False

    @property
    def n_stages(self) -> int:
        return self.group.size

    @property
    def stage(self) -> int:
        return self.group.rank


def stage_layers(layers: list, pcfg: PipelineConfig) -> tuple[int, list]:
    """(index of the first, the layers) that ``pcfg``'s stage owns: L / S
    consecutive layers (JAX ``shard_stacked_layers``'s block of the layer
    axis). Raises JAX's error when S does not divide L."""
    n, s = len(layers), pcfg.n_stages
    if n % s:
        raise ValueError(f"num layers {n} not divisible by {s} stages")
    per = n // s
    return pcfg.stage * per, layers[pcfg.stage * per:(pcfg.stage + 1) * per]


def bubble(n_stages: int, n_microbatches: int) -> float:
    """The share of a stage's ticks that are idle: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


class _Schedule(torch.autograd.Function):
    """The pipelined stack: (x, shared bias, this stage's leaves) -> the
    taps, each [B, N, D] on every stage. See the module docstring."""

    @staticmethod
    def forward(ctx, run: "_Run", x, shared, *leaves):
        ctx.run = run
        return tuple(run.forward(x, shared, leaves))

    @staticmethod
    def backward(ctx, *tap_grads):
        run, ctx.run = ctx.run, None  # one backward; its graphs go with it
        gx, gshared, gleaves = run.backward(tap_grads)
        return (None, gx, gshared, *gleaves)


class _Run:
    """One call's schedule, and what its backward needs."""

    def __init__(self, pcfg: PipelineConfig, block: Callable, first: int, structure: list,
                 taps: tuple[int, ...], specs: list, tp: ModelGroup | None, train: bool):
        self.pcfg, self.block, self.first = pcfg, block, first
        self.structure, self.taps = structure, taps
        self.specs, self.tp, self.train = specs, tp, train
        self.comm = pcfg.group.comm
        per = len(structure)
        # this stage's taps, by their index (1-based) in the stack
        self.own = [t for t in taps if first < t <= first + per]

    # ----------------------------------------------------------- leaves

    def _full(self, leaves: tuple) -> list[torch.Tensor]:
        """This stage's leaves whole on every rank of the model group."""
        out = []
        for t, spec in zip(leaves, self.specs):
            if spec is None or self.tp is None:
                out.append(t.detach())
            elif spec == "qkv":
                out.append(gather_qkv(t.detach(), self.tp))
            else:
                out.append(self.tp.comm.all_gather(t.detach(), spec))
        return out

    def _stage(self, h: torch.Tensor, shared, leaves: list) -> list[torch.Tensor]:
        """This stage's layers on one microbatch -> each layer's output."""
        it = iter(leaves)
        layers = tree_map(lambda _: next(it), self.structure)
        ys = []
        for layer in layers:
            h = self.block(h, layer, shared)
            ys.append(h)
        return ys

    # ---------------------------------------------------------- forward

    def forward(self, x: torch.Tensor, shared, leaves: tuple) -> list[torch.Tensor]:
        pcfg = self.pcfg
        s, n_st, m_count = pcfg.stage, pcfg.n_stages, pcfg.n_microbatches
        b = x.shape[0]
        if b % m_count:
            raise ValueError(f"local batch {b} not divisible by {m_count} microbatches")
        mb = b // m_count
        full = self._full(leaves)
        self.leaves = [t.requires_grad_(r.requires_grad) if self.train else t
                       for t, r in zip(full, leaves)]
        self.shared = None
        if shared is not None:
            self.shared = shared.detach().requires_grad_(self.train and shared.requires_grad)
        self.x_grad = self.train and x.requires_grad
        self.token_shape, self.dtype, self.device = x.shape[1:], x.dtype, x.device
        xs = x.detach().split(mb)
        per = len(self.structure)
        keep = {t - self.first - 1 for t in self.own} | {per - 1}
        self.saved: dict[int, tuple] = {}  # microbatch -> (input, {layer: output})
        outs: dict[int, list] = {t: [None] * m_count for t in self.own}
        state = torch.zeros_like(xs[0])
        ticks = m_count + n_st - 1
        for t in range(ticks):
            if s == 0:
                state = xs[min(t, m_count - 1)]
            m = t - s
            send = state
            if 0 <= m < m_count:
                inp = state.detach()
                if self.train:
                    inp.requires_grad_(s > 0 or self.x_grad)
                with torch.set_grad_enabled(self.train):
                    if self.train and pcfg.remat:
                        ys = checkpoint(self._stage, inp, self.shared, self.leaves,
                                        use_reentrant=False)
                    else:
                        ys = self._stage(inp, self.shared, self.leaves)
                kept = {j: ys[j] for j in keep}
                if self.train:
                    self.saved[m] = (inp, kept)
                for tap in self.own:
                    outs[tap][m] = kept[tap - self.first - 1].detach()
                send = ys[-1].detach()
            if t < ticks - 1:
                state = self.comm.ppermute(send, 1)
        # every tap from its stage to every stage
        result = []
        for tap in self.taps:
            owner = (tap - 1) // per
            if owner == s:
                h = torch.cat(outs[tap])
            else:
                h = xs[0].new_empty((b, *xs[0].shape[1:]))
            result.append(self.comm.broadcast_(h, owner))
        return result

    # --------------------------------------------------------- backward

    def backward(self, tap_grads: tuple):
        pcfg = self.pcfg
        s, n_st, m_count = pcfg.stage, pcfg.n_stages, pcfg.n_microbatches
        per = len(self.structure)
        grads = {t: g for t, g in zip(self.taps, tap_grads) if t in self.own}
        mb = next(iter(self.saved.values()))[0].shape[0]
        wanted = [t for t in self.leaves if t.requires_grad]
        if self.shared is not None and self.shared.requires_grad:
            wanted.append(self.shared)
        acc = [None] * len(wanted)
        gx = [None] * m_count
        incoming = None
        ticks = m_count + n_st - 1
        for t in reversed(range(ticks)):
            m = t - s
            send = None
            if 0 <= m < m_count:
                inp, kept = self.saved.pop(m)
                outs, gouts = [], []
                for j, y in kept.items():
                    g = None
                    tap = self.first + j + 1
                    if tap in grads and grads[tap] is not None:
                        g = grads[tap][m * mb:(m + 1) * mb]
                    if j == per - 1 and incoming is not None and s < n_st - 1:
                        g = incoming if g is None else g + incoming
                    if g is not None:
                        outs.append(y)
                        gouts.append(g.to(y.dtype))
                inputs = ([inp] if inp.requires_grad else []) + wanted
                got = (torch.autograd.grad(outs, inputs, gouts, allow_unused=True)
                       if outs else [None] * len(inputs))
                if inp.requires_grad:
                    g_in, got = got[0], got[1:]
                    if g_in is None:
                        g_in = torch.zeros_like(inp)
                    if s == 0:
                        gx[m] = g_in
                    send = g_in
                for i, g in enumerate(got):
                    if g is not None:
                        acc[i] = g if acc[i] is None else acc[i] + g
            if t > 0:
                if send is None:  # a bubble tick: nothing to send back
                    send = torch.zeros((mb, *self.token_shape), dtype=self.dtype,
                                       device=self.device)
                incoming = self.comm.ppermute(send.contiguous(), -1)
        self.saved = {}
        gshared = None
        if self.shared is not None and self.shared.requires_grad:
            gshared = acc.pop()
        gleaves = []
        it = iter(acc)
        for t, spec in zip(self.leaves, self.specs):
            g = next(it) if t.requires_grad else None
            if g is not None and spec is not None and self.tp is not None:
                g = _shard_one(g, spec, self.tp.size, self.tp.rank)
            gleaves.append(g)
        x_grad = torch.cat(gx) if s == 0 and self.x_grad else None
        return x_grad, gshared, gleaves


def pipeline_encoder(layers: list, x: torch.Tensor, pcfg: PipelineConfig, block: Callable,
                     taps: tuple[int, ...], shared_bias: torch.Tensor | None = None,
                     tp: ModelGroup | None = None) -> dict[int, torch.Tensor]:
    """Run the encoder layers over the pipeline (JAX ``pipeline_encoder``).

    layers: every layer's parameter dict (stage s runs its block,
      ``stage_layers``); under ``tp`` their tensor-parallel leaves are this
      rank's shards, whole inside the stage.
    x: [B, N, D] embedded tokens, this data rank's batch, the same on
      every stage.
    block(h, layer, shared_bias) -> h: one encoder layer (its own
      relative-position bias gathered inside, as JAX's ``_layer_rel_bias``).
    taps: the layers (1-based) whose outputs come back; JAX returns every
      layer's output [L, B, N, D] sharded over ``pipe`` and the caller
      indexes it, here only the taps are broadcast.
    -> {tap: [B, N, D]} on every stage, differentiable."""
    first, mine = stage_layers(layers, pcfg)
    if any(not 0 < t <= len(layers) for t in taps):
        raise ValueError(f"taps {taps} outside layers 1..{len(layers)}")
    leaves = tree_leaves(mine)
    paths = tree_paths(mine)
    specs = ([tp_spec(f"vit/layers/{p}") for p in paths]
             if tp is not None and tp.size > 1 else [None] * len(leaves))
    run = _Run(pcfg, block, first, mine, tuple(taps), specs,
               tp if tp is not None and tp.size > 1 else None, torch.is_grad_enabled())
    outs = _Schedule.apply(run, x, shared_bias, *leaves)
    return dict(zip(taps, outs))


def reduce_pipe_grads(grads: list[torch.Tensor], paths: list[str], pcfg: PipelineConfig,
                      ) -> None:
    """After the backward, in place: the encoder's gradients (each stage
    holds its own layers', stage 0 the embedding's, every stage its part
    of a shared relative-position table's) summed over the pipe group;
    every other leaf's, computed the same on every stage, taken from the
    last stage (the others' zeroed, then the same sum)."""
    last = pcfg.stage == pcfg.n_stages - 1
    with torch.no_grad():
        for g, p in zip(grads, paths, strict=True):
            if "vit" not in p.split("/") and not last:
                g.zero_()
    all_reduce_(grads, pcfg.group.comm)
