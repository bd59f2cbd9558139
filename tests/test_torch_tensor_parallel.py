"""Tensor, sequence and expert parallelism of the port
(``parallel/tensor.py``, ``parallel/sharding.py``'s ``TpLayout``,
``models/vit.py``) on the CPU, in one process: the ranks of a data x
model mesh are threads over ``ThreadComm`` groups (``test_torch_parallel``),
one hub a model group, one a data group and one for the world.

  * The leaf layout against JAX's ``detector_param_specs`` on a 1 x 4 CPU
    mesh: each rank's shards of JAX's tree, mapped by ``params_from_jax``,
    equal the port's shards of the mapped tree, LoRA and MoE leaves too.
  * ``detector_loss`` and its gradients under TP and TP + SP over every
    family against one process (``TP_RTOL``) and against JAX's jitted
    loss on the same mesh (``tests/test_parallel.py``'s loss rtol 2e-5,
    the gradients ``GRAD_RTOL``); the SP-partial leaves one by one, and
    missing without their model-group sum; tokens that do not divide the
    degree (N = 17, 65, 197 at mp = 2 and 4).
  * MoE with expert parallelism: the routing, the aux loss 1e-6.
  * A 2 x 2 ``Trainer`` (DP x TP) with accumulation, clipping, skipping and
    EMA against one process; checkpoints TP 2 -> 1 and 1 -> 2 to the same
    bits; the SP-with-windows refusal and the ring-without-SP degrade;
    remat "full" and "dots" under TP + SP to the same bits.
"""

from __future__ import annotations

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.parallel import sharding as jax_sharding
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
    tree_paths,
)
from layoutdit_tpu_torch.parallel import mesh as pmesh
from layoutdit_tpu_torch.parallel import sharding as psharding
from layoutdit_tpu_torch.train import trainer as port_trainer
from test_torch_cascade import _jax_priorities
from test_torch_mask import _gt_masks
from test_torch_parallel import (
    ThreadComm,
    _Hub,
    _batch,
    _family,
    _port_step,
    _rc,
    _rel,
)
from test_torch_train import fixture_dir  # noqa: F401 (fixture)

# TP / SP against one process, both float32 on the CPU: the same
# arithmetic but for the sums over the model group (row-parallel partial
# sums, the SP-partial gradients) and the shards' GEMM shapes (relative,
# losses and per-leaf Frobenius; DP's DP_RTOL)
TP_RTOL = 1e-5
# FCOS's GroupNorm towers amplify the encoder's last-bit differences: the
# worst leaf of its TP step is 4.5e-5 from one process (fcos_head's first
# conv bias, the FPN's last layer), where every other family stays under
# 3e-6; JAX's own family test holds it at 1e-4 / 1e-3
FCOS_TP_RTOL = 1e-4
# against JAX's jitted loss on the same mesh: tests/test_parallel.py's
# loss tolerance; the gradients as the family tests hold the one-process
# port to JAX (relative Frobenius a leaf)
JAX_LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-3
# a naive step that skips the model-group sum of the SP-partial leaves
# misses by far more (each rank holds about 1/mp of those gradients)
MISS = 0.1
# the MoE load-balance loss under expert parallelism: the same routing
# and the same means, summed in another order
AUX_TOL = 1e-6
# a bf16 TP + SP step against one process's bf16 step: every gradient
# leaf within max |ref| / 64 (the card's rule for data parallelism)
BF16_TP_TOL = 1 / 64


def _max_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


class RingComm(ThreadComm):
    """``ThreadComm`` with the ring's point-to-point step."""

    def ppermute(self, t, shift=1):
        return self.hub.exchange(self.rank, t.detach().clone())[(self.rank - shift) % self.world]


def run_mesh(fn, dp: int = 1, mp: int = 2, sp: bool = False) -> list:
    """``fn(mesh)`` on dp x mp threads, each with a ``DataMesh`` whose
    model group, data group and world are ``RingComm`` groups (rank =
    data index x mp + model index) -> the results in rank order."""
    world = dp * mp
    hubs = [_Hub(world)] + [_Hub(mp) for _ in range(dp)] + [_Hub(dp) for _ in range(mp)]
    out, errors = [None] * world, []

    def body(rank):
        d, m = divmod(rank, mp)
        mesh = pmesh.DataMesh(
            degree=dp, rank=d, comm=RingComm(hubs[1 + dp + m], d),
            model=pmesh.ModelGroup(mp, m, RingComm(hubs[1 + d], m), sequence_parallel=sp),
            world=RingComm(hubs[0], rank))
        try:
            out[rank] = fn(mesh)
        except BaseException as e:  # surfaced below
            errors.append(e)
            for h in hubs:
                h.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def run_group(fn, mp: int = 2, sp: bool = False) -> list:
    """``fn(model_group)`` on mp threads of one model group."""
    return run_mesh(lambda mesh: fn(mesh.model), 1, mp, sp)


def shard_tree(tree: dict, group) -> tuple[dict, psharding.TpLayout]:
    """A full tree -> (this rank's shards as a tree, the layout)."""
    layout = psharding.TpLayout(tree_paths(tree), group)
    it = iter(layout.shard(tree_leaves(tree)))
    return tree_map(lambda _: next(it), tree), layout


# ----------------------------------------------------------- the layout


def _jax_shard(tree, specs, m: int, mp: int):
    """Rank m's part of a JAX tree by its PartitionSpecs (``model`` axis)."""
    def cut(leaf, spec):
        leaf = np.asarray(leaf)
        for dim, axis in enumerate(spec):
            if axis == "model":
                k = leaf.shape[dim] // mp
                leaf = np.take(leaf, np.arange(m * k, (m + 1) * k), axis=dim)
        return leaf

    return jax.tree_util.tree_map(cut, tree, specs, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("extra", [
    {},
    {"lora_rank": 4, "lora_targets": ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")},
    {"num_experts": 4, "moe_every_n": 2},
    {"dit_base": True},
])
def test_leaf_layout_matches_jax_specs(extra):
    """For each rank m of a 1 x 4 mesh: the port's shards of the mapped
    tree are ``params_from_jax`` of rank m's part of JAX's tree by
    ``detector_param_specs`` (the fused qkv's [q_m; k_m; v_m] rows, the
    [out, in] transposes, LoRA's A / B, the experts' dim, fc6 / fc7). At
    dit-base's widths (two of its layers) too."""
    from layoutdit_tpu.config.constructs import MeshConfig as JaxMesh
    from layoutdit_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from test_torch_parallel import _rcnn_configs

    vit = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, image_size=64)
    if extra.pop("dit_base", False):
        vit = dict(hidden_size=768, num_hidden_layers=2, num_attention_heads=12,
                   intermediate_size=3072, image_size=64)
    jcfg, _ = _rcnn_configs({**vit, **extra})
    jparams = jax.tree_util.tree_map(np.array, jax.jit(
        jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    mesh = jax_build_mesh(JaxMesh(data_parallel=1, model_parallel=4),
                          devices=jax.devices()[:4], strict=True)
    specs = jax_sharding.detector_param_specs(jparams, mesh)
    full = params_from_jax(jparams)
    got = run_group(lambda g: tree_leaves(shard_tree(full, g)[0]), mp=4)
    n_sharded = 0
    for m in range(4):
        want = tree_leaves(params_from_jax(_jax_shard(jparams, specs, m, 4)))
        assert len(want) == len(got[m])
        for path, a, b in zip(tree_paths(full), got[m], want):
            assert a.shape == b.shape and torch.equal(a, b), path
        n_sharded += sum(a.shape != f.shape for a, f in zip(got[m], tree_leaves(full)))
    assert n_sharded > 0


# ------------------------------------------------------------- families


def _tp_step(jparams, pcfg, batch, gt_masks, priorities, mesh, reduce_partial=True):
    """The port's losses and gradients on a data x model mesh: this rank's
    shards, its data index's rows, the partial gradients summed over the
    model group, every gradient averaged over the data group, gathered
    back to the one-card layout -> (losses, gradient leaves)."""
    params = params_from_jax(jparams)
    params, layout = shard_tree(params, mesh.model)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    k = batch[0].shape[0] // mesh.degree
    rows = slice(mesh.rank * k, (mesh.rank + 1) * k)
    xs = [torch.from_numpy(np.array(x[rows])) for x in batch]
    pri = None if priorities is None else port_det.SamplerPriorities(
        *(p[rows] for p in priorities))
    masks = None if gt_masks is None else torch.from_numpy(gt_masks[rows])
    with pmesh.losses_over(mesh):
        losses = port_det.detector_loss(params, *xs, pcfg, pri, gt_masks=masks, tp=mesh.model)
    sum(losses.values()).backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in tree_leaves(params)]
    if reduce_partial:
        layout.reduce_partial(grads)
    if mesh.degree > 1:
        psharding.all_reduce_(grads, mesh.comm)
        torch._foreach_div_(grads, float(mesh.degree))
    out = {k_: v.detach().clone() for k_, v in losses.items()}
    if mesh.degree > 1:
        for v in out.values():
            mesh.comm.all_reduce_(v)
        out = {k_: v / mesh.degree for k_, v in out.items()}
    return {k_: float(v) for k_, v in out.items()}, layout.gather(grads)


def _jax_tp_step(jparams, jcfg, batch, gt_masks, rng, dp, mp, sp):
    """JAX's losses and gradients on a dp x mp CPU mesh, the parameters
    sharded by ``shard_params`` and the batch over ``data`` (with ``sp``,
    the encoder's stream constrained to the token axis, as
    ``tests/test_parallel.py`` runs it)."""
    from layoutdit_tpu.config.constructs import MeshConfig as JaxMesh
    from layoutdit_tpu.parallel.mesh import batch_sharding, build_mesh, sequence_sharding

    mcfg = JaxMesh(data_parallel=dp, model_parallel=mp, sequence_parallel=sp)
    mesh = build_mesh(mcfg, devices=jax.devices()[:dp * mp], strict=True)
    seq = sequence_sharding(mesh, mcfg) if sp else None
    data = batch_sharding(mesh)

    def total(p, *xs):
        d = jax_det.detector_loss(p, rng, *xs[:4], jcfg, gt_masks=xs[4] if len(xs) > 4 else None,
                                  seq_sharding=seq)
        return sum(d.values()), d

    xs = list(batch) + ([gt_masks] if gt_masks is not None else [])
    step = jax.jit(jax.value_and_grad(total, has_aux=True),
                   in_shardings=(None,) + (data,) * len(xs))
    (_, losses), grads = step(jax_sharding.shard_params(jparams, mesh), *xs)
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, grads)))


def _assert_close_to_one(tp, one, one_grads, rtol=TP_RTOL):
    losses, grads = tp
    assert set(losses) == set(one)
    for k in one:
        assert abs(losses[k] - one[k]) <= rtol * max(abs(one[k]), 1e-6), (k, losses[k], one[k])
    for g, w in zip(grads, tree_leaves(one_grads), strict=True):
        assert _rel(g, w) <= rtol or float(w.abs().max()) < 1e-6, _rel(g, w)


FAMILIES = ["faster_rcnn", "cascade", "mask", "fcos", "detr", "moe", "retinanet"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_tp_detector_loss_equals_one_process(family, sp):
    """Every family's ``detector_loss`` and gradients on a 1 x 2 mesh (the
    encoder's heads, MLP columns or experts and the box head's columns
    split over the group; with SP the 17 tokens as 9 + 8 + a padded row)
    against one process on the same batch."""
    jparams, jcfg, pcfg = _family(family)
    batch = _batch()
    gt_masks = _gt_masks(batch[1], batch[3]) if pcfg.with_mask else None
    rng = jax.random.PRNGKey(7)
    pri = (_jax_priorities(rng, pcfg, *batch[2].shape)
           if pcfg.detector_kind == "faster_rcnn" else None)
    one, one_grads = _port_step(jparams, pcfg, batch, gt_masks, pri)
    tp = run_mesh(lambda m: _tp_step(jparams, pcfg, batch, gt_masks, pri, m), 1, 2, sp)
    _assert_close_to_one(tp[0], one, one_grads, FCOS_TP_RTOL if family == "fcos" else TP_RTOL)
    # both ranks hold the same losses and gathered gradients
    assert tp[0][0] == tp[1][0]
    assert all(torch.equal(a, b) for a, b in zip(tp[0][1], tp[1][1]))


def _rcnn_family():
    """Faster R-CNN at the family tests' budget (not ``SAMPLE_ALL``: with
    every candidate sampled the one-process port is already up to 1.3e-3
    from JAX's one-device gradients on this batch, ROADMAP queue 3)."""
    from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
    from layoutdit_tpu.models import backbone as jax_backbone
    from layoutdit_tpu.models import vit as jax_vit
    from layoutdit_tpu_torch.config import DetectionBudget
    from layoutdit_tpu_torch.models import backbone as port_backbone
    from test_torch_cascade import BUDGET, VIT
    from test_torch_cascade import _jax_params as rcnn_params

    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=JaxBudget(**BUDGET))
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**BUDGET))
    return rcnn_params(jcfg), jcfg, pcfg


@pytest.mark.parametrize("dp,mp,sp", [(1, 2, False), (1, 2, True), (2, 2, False), (2, 2, True)])
def test_tp_matches_jax_model_parallel_mesh(dp, mp, sp):
    """Faster R-CNN over a dp x mp mesh (the batch over the data ranks,
    the encoder and box head over the model ranks) against JAX's
    ``detector_loss`` jitted on the same CPU mesh with its parameters
    sharded (``tests/test_parallel.py:89-148``): the losses 2e-5, every
    gradient leaf ``GRAD_RTOL``. On the 2 x 2 mesh with sequence
    parallelism JAX's gradients are those of neither its one-device step
    nor the port's (42 leaves off by up to 94%, its losses right; ROADMAP
    queue 3): there the losses are compared, as JAX's own test does, and
    the port's gradients against JAX's one-device step's."""
    jparams, jcfg, pcfg = _rcnn_family()
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    pri = _jax_priorities(rng, pcfg, *batch[2].shape)
    losses, grads = run_mesh(lambda m: _tp_step(jparams, pcfg, batch, None, pri, m),
                             dp, mp, sp)[0]
    want, jgrads = _jax_tp_step(jparams, jcfg, batch, None, rng, dp, mp, sp)
    assert set(want) == set(losses)
    for k in want:
        np.testing.assert_allclose(losses[k], want[k], rtol=JAX_LOSS_RTOL, atol=1e-7, err_msg=k)
    if dp > 1 and sp:
        mesh_grads = jgrads
        _, jgrads = _jax_tp_step(jparams, jcfg, batch, None, rng, 1, 1, False)
        off = [_rel(a, b) for a, b in zip(mesh_grads, jgrads)]
        print(f"JAX's {dp} x {mp} SP gradients against its one-device step: "
              f"{sum(o > GRAD_RTOL for o in off)} leaves over {GRAD_RTOL}, worst {max(off):.3g}")
    it = iter(grads)
    flat_p = jax.tree_util.tree_leaves(params_to_jax(tree_map(
        lambda _: next(it), params_from_jax(jparams))))
    assert len(flat_p) == len(jgrads)
    for g, w in zip(flat_p, jgrads):
        assert _rel(g, w) <= GRAD_RTOL, _rel(g, w)


def test_sp_partial_leaves_one_by_one():
    """Under TP + SP the LayerNorms, layer scales and row-parallel biases
    act on token shards: each of their gradients, summed over the model
    group, equals one process's leaf by leaf; without the sum every one
    of them misses, and the leaves that are not partial stay right."""
    jparams, _, pcfg = _family("faster_rcnn")
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    pri = _jax_priorities(rng, pcfg, *batch[2].shape)
    _, one_grads = _port_step(jparams, pcfg, batch, None, pri)
    paths = tree_paths(one_grads)
    want = tree_leaves(one_grads)
    partial = [psharding.tp_partial(p, True) for p in paths]
    sp_only = [psharding.tp_partial(p, True) and not psharding.tp_partial(p, False)
               for p in paths]
    assert sum(sp_only) == 2 * 8  # per layer: ln1, ln2 (2 leaves each), 2 lambdas, 2 row biases
    _, good = run_mesh(lambda m: _tp_step(jparams, pcfg, batch, None, pri, m), 1, 2, True)[0]
    _, naive = run_mesh(lambda m: _tp_step(jparams, pcfg, batch, None, pri, m,
                                           reduce_partial=False), 1, 2, True)[0]
    for path, g, n, w, is_partial in zip(paths, good, naive, want, partial):
        assert _rel(g, w) <= TP_RTOL, path
        if is_partial:
            assert _rel(n, w) > MISS, path
        else:
            assert _rel(n, w) <= TP_RTOL or float(w.abs().max()) < 1e-6, path


# -------------------------------------------------------------- encoder


def _encoder(n_side: int, heads=4, **extra):
    """An encoder whose stream has 1 + n_side^2 tokens (8 px patches)."""
    cfg = port_vit.ViTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=heads,
                             intermediate_size=64, patch_size=8, image_size=8 * n_side, **extra)
    params = port_vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    for t in tree_leaves(params):
        t.data += 0.05 * torch.randn(t.shape, generator=gen)
    return cfg, params


def encoder_step(cfg, params, pixels, tp=None, impl="auto", remat=False, policy="full"):
    """Taps (1, 2), their squares' sum (+ the MoE loss) and its gradient
    in the one-card layout."""
    tree = {"backbone": {"vit": params}}
    tree = tree_map(lambda t: t.detach().clone(), tree)
    layout = None
    if tp is not None:
        tree, layout = shard_tree(tree, tp)
    leaves = tree_leaves(tree)
    for t in leaves:
        t.requires_grad_(True)
    aux = {}
    taps = port_vit.vit_forward(tree["backbone"]["vit"], pixels, cfg, taps=(1, 2), tp=tp,
                                attention_impl=impl, remat=remat, remat_policy=policy,
                                aux_out=aux)
    loss = sum((t.float() ** 2).sum() for t in taps) + aux["moe_aux"]
    loss.backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    if layout is not None:
        layout.reduce_partial(grads)
        grads = layout.gather(grads)
    return [t.detach() for t in taps], aux["moe_aux"].detach(), grads


def _assert_encoder_close(got, want):
    for a, b in zip(got[0], want[0]):
        assert _rel(a, b) <= TP_RTOL
    for a, b in zip(got[2], want[2], strict=True):
        assert _rel(a, b) <= TP_RTOL or float(b.abs().max()) < 1e-6


@pytest.mark.parametrize("n_side,mp", [(8, 2), (8, 4), (14, 2), (14, 4)])
@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_encoder_tokens_that_do_not_divide(n_side, mp, sp):
    """N = 65 and N = 197 tokens over 2 and 4 ranks (33 + 32, 17 x 3 + 14,
    99 + 98, 50 x 3 + 47): taps and gradients against one process."""
    cfg, params = _encoder(n_side)
    pixels = torch.rand((2, 3, 8 * n_side, 8 * n_side), generator=torch.Generator().manual_seed(2))
    want = encoder_step(cfg, params, pixels)
    got = run_group(lambda g: encoder_step(cfg, params, pixels, g), mp, sp)
    for rank in got:
        _assert_encoder_close(rank, want)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_moe_expert_parallelism(top_k, sp):
    """Four experts over two ranks (two each), at a capacity that drops
    tokens: the routing is every rank's whole one, so the load-balance
    loss equals one process's (1e-6) and so do the taps and gradients."""
    cfg, params = _encoder(8, num_experts=4, moe_every_n=1, moe_top_k=top_k,
                           moe_capacity_factor=0.75)
    pixels = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(3))
    from layoutdit_tpu_torch.ops.moe import moe_capacity, route

    y = torch.randn(2, 65, 32, generator=torch.Generator().manual_seed(4))
    router = params["layers"][0]["router"]["weight"]
    c = moe_capacity(65, 4, top_k, 0.75)
    experts, _, slots, kept, _ = route(y, router, 4, top_k, c)
    assert not all(bool(k.all()) for k in kept)  # the capacity drops tokens
    want = encoder_step(cfg, params, pixels)
    got = run_group(lambda g: encoder_step(cfg, params, pixels, g), 2, sp)
    for rank in got:
        assert abs(float(rank[1]) - float(want[1])) <= AUX_TOL
        _assert_encoder_close(rank, want)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_under_tp_sp(policy):
    """Remat "full" and "dots" under TP + SP: the collectives run again in
    the recompute, in one order on every rank; taps and gradients the
    same bits as without remat."""
    cfg, params = _encoder(8)
    pixels = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(5))
    plain = run_group(lambda g: encoder_step(cfg, params, pixels, g), 2, True)
    remat = run_group(lambda g: encoder_step(cfg, params, pixels, g, remat=True, policy=policy),
                      2, True)
    for a, b in zip(plain, remat):
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_sp_windows_refused_and_ring_without_sp_degrades():
    """JAX's guards: sequence parallelism with active windows raises; ring
    without it runs the length routing (TP alone, and one process)."""
    cfg, params = _encoder(8, window_size=4, global_attn_layers=(2,))
    pixels = torch.rand((1, 3, 64, 64))
    with pytest.raises(ValueError, match="sequence parallelism"):
        run_group(lambda g: encoder_step(cfg, params, pixels, g), 2, True)
    want = encoder_step(cfg, params, pixels)
    ring_one = encoder_step(cfg, params, pixels, impl="ring")
    assert all(torch.equal(a, b) for a, b in zip(ring_one[0], want[0]))
    got = run_group(lambda g: encoder_step(cfg, params, pixels, g, impl="ring"), 2, False)
    _assert_encoder_close(got[0], want)


def test_heads_and_experts_that_do_not_split_raise():
    cfg, params = _encoder(4, heads=2)
    with pytest.raises(ValueError, match="num_attention_heads=2"):
        run_group(lambda g: encoder_step(cfg, params, torch.rand(1, 3, 32, 32), g), 4)
    cfg, params = _encoder(4, num_experts=2, moe_every_n=1)
    with pytest.raises(ValueError, match="split over"):
        run_group(lambda g: encoder_step(cfg, params, torch.rand(1, 3, 32, 32), g), 4)


# --------------------------------------------------------------- trainer


def _model(rc, seed=0):
    cfg = dataclasses.replace(port_det.DetectorConfig.from_model_config(
        rc.model, rc.compute_dtype), image_size=64)
    gen = torch.Generator().manual_seed(seed)
    return port_det.DetectorModel(port_det.init_detector(cfg, gen, device="cpu"), cfg)


def _full_state(trainer) -> list[torch.Tensor]:
    """Parameters, moments and EMA in the one-card layout (collective)."""
    tx = trainer._opt_state_for_checkpoint()
    ema = tx["ema"] if trainer.ema_params is not None else None
    tx = tx["tx"] if ema is not None else tx
    state = [*tree_leaves(trainer._one_card(trainer.params)), *tx["mu"], *tx["nu"],
             *(tree_leaves(ema) if ema is not None else [])]
    return [t.detach().clone() for t in state]


def _steps(rc, mesh, n=2):
    trainer = port_trainer.Trainer(rc, _model(rc), device="cpu", mesh=mesh)
    losses = []
    for _, batch in zip(range(n), trainer.dataloader):
        loss, _ = trainer.train_step(batch)
        if mesh is not None and mesh.degree > 1:
            loss = mesh.comm.all_reduce_(loss.clone()) / mesh.degree
        losses.append(float(loss))
    trainer.dataloader.close()
    return losses, _full_state(trainer), trainer


def test_trainer_dp_x_tp_equals_one_process(fixture_dir, tmp_path):  # noqa: F811
    """A 2 x 2 mesh (two data ranks, each a model group of two) takes two
    updates with A=2 accumulation, clipping (a norm the step reaches),
    non-finite skipping and EMA: the losses and the whole state against
    one process (the moments and EMA ``STATE_RTOL``-style 1e-4, the
    parameters within 2 lr a step)."""
    train = dict(grad_accumulation_steps=2, grad_clip_norm=0.05, skip_nonfinite_updates=2,
                 ema_decay=0.9, learning_rate=1e-3)
    rc = _rc(fixture_dir, tmp_path, **train)
    one_losses, one_state, one = _steps(rc, None)
    n_params = len(tree_leaves(one.params))
    got = run_mesh(lambda m: _steps(rc, m)[:2], 2, 2, True)
    for losses, state in got:
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        for i, (a, b) in enumerate(zip(state, one_state, strict=True)):
            assert a.shape == b.shape, i
            if i < n_params:
                assert float((a - b).abs().max()) <= 2 * 1e-3 * 2 * (1 + 1e-3), i
            else:
                assert _rel(a.float(), b.float()) <= 1e-4 or float(b.abs().max()) < 1e-12, i


def test_checkpoints_across_model_degrees(fixture_dir, tmp_path):  # noqa: F811
    """TP 2 -> 1: a 1 x 2 trainer's checkpoint resumed by one process holds
    the gathered state's bits. 1 -> 2: one process's checkpoint resumed
    on a 1 x 2 mesh gives each rank the slices of it, and gathering them
    gives its bits back."""
    rc = _rc(fixture_dir, tmp_path, ema_decay=0.9)

    def save_tp(mesh):
        _, state, trainer = _steps(rc, mesh, n=1)
        path = trainer.save_checkpoint(1, stem="tp")
        return path, state

    (path, tp_state), _ = run_mesh(save_tp, 1, 2, True)
    one = port_trainer.Trainer(rc, _model(rc, seed=5), device="cpu")
    one.resume(path)
    assert all(torch.equal(a, b) for a, b in zip(_full_state(one), tp_state, strict=True))
    one.dataloader.close()
    one_path = one.save_checkpoint(1, stem="one")

    def resume_tp(mesh):
        trainer = port_trainer.Trainer(rc, _model(rc, seed=6), device="cpu", mesh=mesh)
        trainer.resume(one_path)
        trainer.dataloader.close()
        return _full_state(trainer)

    for state in run_mesh(resume_tp, 1, 2, True):
        assert all(torch.equal(a, b) for a, b in zip(state, tp_state, strict=True))


def test_mesh_rules(monkeypatch):
    """JAX's ``build_mesh(strict=True)``: rank = data x mp + model, -1
    takes the world over mp, a layout that leaves processes out raises;
    FSDP over a model axis (refused, naming queue 1 item 7, before the
    slice that ported it) builds, its data group FSDP-sharded."""
    from layoutdit_tpu_torch.config import MeshConfig

    class World:
        def __init__(self, n):
            self.world, self.rank = n, 0

    with pytest.raises(ValueError, match="does not divide"):
        pmesh.build_mesh_for_batch(MeshConfig(model_parallel=3), 8, comm=World(4))
    with pytest.raises(ValueError, match="needs 2 processes"):
        pmesh.build_mesh_for_batch(MeshConfig(data_parallel=1, model_parallel=2), 8,
                                   comm=World(4))
    monkeypatch.setattr(pmesh, "mesh_groups", lambda layout, comm: {
        "data": World(layout.shape[0]), "model": World(layout.shape[1])})
    fsdp_tp = pmesh.build_mesh_for_batch(MeshConfig(model_parallel=2, fsdp=True), 8,
                                         comm=World(4))
    assert (fsdp_tp.degree, fsdp_tp.fsdp, fsdp_tp.model.size) == (2, True, 2)
    got = run_mesh(lambda m: (m.rank, m.model.rank, m.rows(8).tolist(), m.lead, m.size), 2, 2)
    assert [g[:2] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert got[0][2] == got[1][2] == [0, 1, 2, 3] and got[2][2] == [4, 5, 6, 7]
    assert [g[3] for g in got] == [True, False, False, False] and got[0][4] == 4


@pytest.mark.parametrize("family", ["faster_rcnn", "retinanet"])
def test_tp_sp_bf16_step_within_max_ref_over_64(family):
    """In bf16 the TP + SP step of the two-layer encoder holds every
    gradient leaf within ``BF16_TP_TOL`` of max |ref| of one process's
    bf16 step: the partial sums of both sides of a column- / row-parallel
    pair are float32 and rounded once after the group's sum
    (``parallel/tensor.py``), as one process's GEMM rounds its float32
    accumulator once. bf16 partials rounded on each rank put the worst
    leaf 9.7e-2 away (RetinaNet's coarsest FPN layer), as far as one
    process's bf16 step is from its float32 one (the control, printed);
    float32 partials, 4.5e-3 (Faster R-CNN 6.8e-3). (Through dit-large's
    24 bf16 layers on the card both sides drift a few % from float32
    whatever the sums; ``chip_smoke.py`` holds them to a float32
    control.)"""
    jparams, _, pcfg = _family(family)
    bcfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    batch = _batch()
    pri = (_jax_priorities(jax.random.PRNGKey(7), pcfg, *batch[2].shape)
           if family == "faster_rcnn" else None)
    _, one = _port_step(jparams, bcfg, batch, None, pri)
    _, one32 = _port_step(jparams, pcfg, batch, None, pri)
    _, tp = run_mesh(lambda m: _tp_step(jparams, bcfg, batch, None, pri, m), 1, 2, True)[0]
    paths = tree_paths(one)
    worst = max((_max_ratio(g, w), p) for g, w, p in zip(tp, tree_leaves(one), paths))
    control = max((_max_ratio(w, r), p) for w, r, p in
                  zip(tree_leaves(one), tree_leaves(one32), paths))
    print(f"bf16 TP + SP {family} step: worst leaf {worst[1]} {worst[0]:.3g} of max |ref|; "
          f"one process bf16 against float32: worst leaf {control[1]} {control[0]:.3g}")
    assert worst[0] <= BF16_TP_TOL, worst
