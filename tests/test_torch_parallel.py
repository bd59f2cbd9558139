"""Data parallelism and FSDP of the port (``layoutdit_tpu_torch/parallel``)
on the CPU, in one process: the ranks are threads over ``ThreadComm``,
an in-process stand-in for a ``torch.distributed`` group with the
collectives of ``parallel.mesh.Comm``.

  * Every family's ``detector_loss`` over two ranks' rows, with the
    batch-wide normalizers taken over the global batch
    (``losses_over``) and the gradients averaged, against one process on
    the global batch (float32, ``DP_RTOL``) and against JAX's
    ``detector_loss`` jitted on a 2-device CPU mesh with the batch
    sharded (the family tests' tolerances); the same without
    ``losses_over`` must miss, except RetinaNet's per-image mean.
  * The trainer: the DP and FSDP steps of two ranks (accumulation, clip,
    skipping, EMA, bf16 moments) against one process's, FSDP against DP;
    one rank in a group of one to the same bits as no group;
    checkpoints across world sizes to the same bits; the SIGTERM stop
    agreed.
  * The loader's rows, the DP eval, the mesh rules, JAX's FSDP rule.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.parallel import sharding as jax_sharding
from layoutdit_tpu_torch.config import MeshConfig, run_config_from_dict
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionLoader
from layoutdit_tpu_torch.eval.evaluator import Evaluator
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.parallel import mesh as pmesh
from layoutdit_tpu_torch.parallel import sharding as psharding
from layoutdit_tpu_torch.train import trainer as port_trainer
from test_torch_cascade import BUDGET as RCNN_BUDGET
from test_torch_cascade import STAGES
from test_torch_cascade import VIT as RCNN_VIT
from test_torch_cascade import _jax_params as rcnn_params
from test_torch_cascade import _jax_priorities
from test_torch_detr import _configs as detr_configs
from test_torch_fcos import _configs as fcos_configs
from test_torch_fcos import _jax_params as fcos_params
from test_torch_mask import _gt_masks
from test_torch_moe_detector import BUDGET as MOE_BUDGET
from test_torch_moe_detector import MOE, _spread_routers
from test_torch_moe_detector import VIT as MOE_VIT
from test_torch_retinanet import _configs as retinanet_configs
from test_torch_retinanet import _jax_params as retinanet_params
from test_torch_train import fixture_dir  # noqa: F401 (fixture)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# the DP step against one process on the global batch, both float32 on
# the CPU: the same arithmetic but for the sums over the ranks and the
# per-rank GEMM shapes (relative, losses and per-leaf Frobenius)
DP_RTOL = 1e-5
# against JAX's step on the 2-device mesh: the family tests' tolerances,
# but for the mask family's gradients: with every RoI candidate sampled
# (104 an image, SAMPLE_ALL) the one-process port is up to 2.6e-3 from
# JAX's one-device step on this batch (losses to 1e-7), and JAX's own
# one-device and 2-device steps differ by up to 7.7e-4; the DP step adds
# less than DP_RTOL to the port's distance
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
MASK_GRAD_RTOL = 3e-3
# a loss normalised over the local batch misses the global one by more
MISS = 1e-3
# the trainer's moments and EMA after two steps (relative Frobenius): the
# ranks' sums and GEMM shapes move the last bits of every forward, and
# two AdamW steps carry them on
STATE_RTOL = 1e-4


# ------------------------------------------------------- the stand-in group


class _Hub:
    """What the ranks of one ``ThreadComm`` group exchange through."""

    def __init__(self, world: int):
        self.world = world
        self.barrier = threading.Barrier(world, timeout=120)
        self.slots = [None] * world

    def exchange(self, rank: int, value) -> list:
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()  # every rank has read before the next write
        return out


class ThreadComm:
    """``parallel.mesh.Comm``'s collectives between threads of one
    process; sums run in rank order."""

    backend = "threads"
    device = torch.device("cpu")

    def __init__(self, hub: _Hub, rank: int):
        self.hub, self.rank, self.world = hub, rank, hub.world

    def _sum(self, t):
        vals = self.hub.exchange(self.rank, t.detach().clone())
        out = vals[0].clone()
        for v in vals[1:]:
            out += v
        return out

    def all_reduce_(self, t, op=dist.ReduceOp.SUM):
        if op == dist.ReduceOp.SUM:
            t.copy_(self._sum(t))
        else:
            vals = torch.stack(self.hub.exchange(self.rank, t.detach().clone()))
            t.copy_(vals.amax(0) if op == dist.ReduceOp.MAX else vals.amin(0))
        return t

    def broadcast_(self, t, src=0):
        t.copy_(self.hub.exchange(self.rank, t.detach().clone())[src])
        return t

    def all_gather(self, shard, dim):
        return torch.cat(self.hub.exchange(self.rank, shard.detach().clone()), dim)

    def reduce_scatter(self, t, dim):
        total = self._sum(t)
        k = total.shape[dim] // self.world
        return total.narrow(dim, self.rank * k, k).contiguous()

    def all_gather_object(self, obj):
        return self.hub.exchange(self.rank, obj)

    def broadcast_object(self, obj, src=0):
        return self.hub.exchange(self.rank, obj)[src]

    def any(self, flag):
        return any(self.hub.exchange(self.rank, bool(flag)))


def run_ranks(fn, world: int = 2, fsdp: bool = False) -> list:
    """``fn(mesh)`` on ``world`` threads, one ``DataMesh`` each -> their
    results in rank order; a rank's exception is re-raised (and breaks
    the others' waits)."""
    hub = _Hub(world)
    out, errors = [None] * world, []

    def body(rank):
        try:
            out[rank] = fn(pmesh.DataMesh(world, rank, ThreadComm(hub, rank), fsdp=fsdp))
        except BaseException as e:  # surfaced below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


# ------------------------------------------------------------- families


def _batch(b=4, g=4, seed=5):
    """A global batch whose images hold 4, 3, 1 and 2 gt boxes: the ranks'
    counts differ, so a local normaliser misses the global one."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, 3, 64, 64)).astype(np.float32)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    gt_valid = np.zeros((b, g), bool)
    for i, n in enumerate((4, 3, 1, 2)[:b]):
        xy = rng.uniform(0, 36, (n, 2))
        wh = rng.uniform(12, 28, (n, 2))
        gt_boxes[i, :n] = np.concatenate([xy, np.minimum(xy + wh, 63)], -1)
        gt_labels[i, :n] = rng.integers(1, 6, n)
        gt_valid[i, :n] = True
    return images, gt_boxes, gt_labels, gt_valid


# the two-stage samplers take every anchor (1023 at 64 px) and every RoI
# candidate (100 proposals + 4 gt slots) they may: their sampled counts,
# the normalisers, then differ from image to image
SAMPLE_ALL = dict(rpn_batch_size_per_image=1023, box_batch_size_per_image=104)


def _rcnn_configs(vit=RCNN_VIT, budget=RCNN_BUDGET, **extra):
    from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
    from layoutdit_tpu.models import backbone as jax_backbone
    from layoutdit_tpu.models import vit as jax_vit
    from layoutdit_tpu_torch.config import DetectionBudget
    from layoutdit_tpu_torch.models import backbone as port_backbone
    from layoutdit_tpu_torch.models import vit as port_vit

    budget = {**budget, **SAMPLE_ALL}
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**vit), fpn_out_channels=32),
        image_size=64, budget=JaxBudget(**budget), **extra)
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**vit),
                                              fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**budget), **extra)
    return jcfg, pcfg


def _family(name: str):
    """(JAX params as numpy, JAX config, port config) of a tiny model."""
    if name in ("faster_rcnn", "cascade", "mask"):
        extra = {"cascade": dict(cascade_iou_threshs=STAGES), "mask": dict(with_mask=True)}
        jcfg, pcfg = _rcnn_configs(**extra.get(name, {}))
        return rcnn_params(jcfg), jcfg, pcfg
    if name == "fcos":
        jcfg, pcfg = fcos_configs()
        return fcos_params(jcfg), jcfg, pcfg
    if name == "retinanet":
        jcfg, pcfg = retinanet_configs()
        return retinanet_params(jcfg), jcfg, pcfg
    if name == "detr":
        jcfg, pcfg = detr_configs()
    else:  # moe: Faster R-CNN over an encoder whose layers are MoE
        jcfg, pcfg = _rcnn_configs({**MOE_VIT, **MOE}, MOE_BUDGET)
    p = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    p = jax.tree_util.tree_map(np.array, p)
    vit = p["backbone"]["vit"]
    vit["pos_embed"] = (0.02 * np.random.default_rng(2).standard_normal(
        vit["pos_embed"].shape)).astype(np.float32)
    return (_spread_routers(p) if name == "moe" else p), jcfg, pcfg


def _jax_mesh_step(jparams, jcfg, batch, gt_masks, rng):
    """JAX's losses and gradients with the batch sharded over a 2-device
    CPU mesh (its data-parallel step)."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    rep, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))

    def total(p, key, *xs):
        d = jax_det.detector_loss(p, key, *xs[:4], jcfg, gt_masks=xs[4] if len(xs) > 4 else None)
        return sum(d.values()), d

    xs = list(batch) + ([gt_masks] if gt_masks is not None else [])
    step = jax.jit(jax.value_and_grad(total, has_aux=True),
                   in_shardings=(rep, rep) + (data,) * len(xs))
    (_, losses), grads = step(jparams, rng, *xs)
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def _port_step(jparams, pcfg, batch, gt_masks, priorities, mesh=None, reduce=True):
    """The port's losses and (rank-averaged) gradients on ``mesh``'s rows
    of ``batch`` (all of it without a mesh); ``reduce=False``: the naive
    local normalisers. -> (losses, gradient tree in the port's layout)."""
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    rows = slice(None)
    if mesh is not None:
        k = batch[0].shape[0] // mesh.degree
        rows = slice(mesh.rank * k, (mesh.rank + 1) * k)
    xs = [torch.from_numpy(np.array(x[rows])) for x in batch]
    pri = None if priorities is None else port_det.SamplerPriorities(
        *(p[rows] for p in priorities))
    masks = None if gt_masks is None else torch.from_numpy(gt_masks[rows])
    with pmesh.losses_over(mesh if (mesh is not None and reduce) else pmesh.DataMesh()):
        losses = port_det.detector_loss(params, *xs, pcfg, pri, gt_masks=masks)
    sum(losses.values()).backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in tree_leaves(params)]
    out = {k: v.detach() for k, v in losses.items()}
    if mesh is not None:
        psharding.all_reduce_(grads, mesh.comm)
        torch._foreach_div_(grads, float(mesh.degree))
        for v in out.values():
            mesh.comm.all_reduce_(v)
        out = {k: v / mesh.degree for k, v in out.items()}
    it = iter(grads)
    return {k: float(v) for k, v in out.items()}, tree_map(lambda _: next(it), params)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


FAMILIES = ["faster_rcnn", "cascade", "mask", "fcos", "detr", "moe", "retinanet"]


@pytest.mark.parametrize("family", FAMILIES)
def test_dp_step_equals_the_global_batch_step(family):
    """Two ranks' ``detector_loss`` (their rows of the global batch and of
    its sampler draws) with ``losses_over``, the gradients averaged: the
    global batch's losses and gradients, as one process and as JAX's
    2-device mesh give them. Without ``losses_over`` the normalisers are
    the ranks' own and the step misses, but for RetinaNet, whose
    per-image means average exactly over equal shards."""
    jparams, jcfg, pcfg = _family(family)
    batch = _batch()
    gt_masks = _gt_masks(batch[1], batch[3]) if pcfg.with_mask else None
    rng = jax.random.PRNGKey(7)
    pri = (_jax_priorities(rng, pcfg, *batch[2].shape)
           if pcfg.detector_kind == "faster_rcnn" else None)
    one, one_grads = _port_step(jparams, pcfg, batch, gt_masks, pri)
    dp, dp_grads = run_ranks(lambda m: _port_step(jparams, pcfg, batch, gt_masks, pri, m))[0]
    assert set(dp) == set(one)
    for k in one:
        assert abs(dp[k] - one[k]) <= DP_RTOL * max(abs(one[k]), 1e-6), (k, dp[k], one[k])
    for path_g, g in zip(tree_leaves(dp_grads), tree_leaves(one_grads)):
        assert _rel(path_g, g) <= DP_RTOL or float(g.abs().max()) < 1e-6, _rel(path_g, g)

    want, jgrads = _jax_mesh_step(jparams, jcfg, batch, gt_masks, rng)
    assert set(want) == set(dp)
    for k in want:
        np.testing.assert_allclose(dp[k], want[k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat_p = jax.tree_util.tree_leaves(params_to_jax(dp_grads))
    assert len(flat_j) == len(flat_p)
    tol = MASK_GRAD_RTOL if pcfg.with_mask else GRAD_RTOL
    for (path, w), g in zip(flat_j, flat_p):
        assert _rel(g, w) <= tol, (jax.tree_util.keystr(path), _rel(g, w))

    naive = run_ranks(lambda m: _port_step(jparams, pcfg, batch, gt_masks, pri, m,
                                           reduce=False)[0])[0]
    miss = max(abs(naive[k] - one[k]) / max(abs(one[k]), 1e-6) for k in one)
    if family == "retinanet":
        assert miss <= DP_RTOL
    else:
        assert miss > MISS, miss


def test_global_helpers_outside_and_at_one_rank():
    """Outside ``losses_over`` and in a group of one the helpers give the
    local values' bits (a one-rank group costs nothing)."""
    x = torch.tensor([0.3, 1.7], requires_grad=True)
    c = torch.tensor(5)
    assert pmesh.global_count(c) is c and pmesh.rank_share(x) is x and pmesh.global_mean(x) is x

    def one(mesh):
        with pmesh.losses_over(mesh):
            y = pmesh.global_mean(x)
            return (pmesh.rank_share(x.sum()) / pmesh.global_count(c), y)

    ratio, y = run_ranks(one, world=1)[0]
    assert torch.equal(ratio, x.sum() / c) and torch.equal(y, x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(2))


# --------------------------------------------------------------- trainer


def _rc(fixture_dir, tmp_path, **train):
    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["train_config"].update(train)
    return run_config_from_dict(raw)


def _model(rc, seed=0):
    cfg = dataclasses.replace(port_det.DetectorConfig.from_model_config(
        rc.model, rc.compute_dtype), image_size=64)
    gen = torch.Generator().manual_seed(seed)
    return port_det.DetectorModel(port_det.init_detector(cfg, gen, device="cpu"), cfg)


def _state(trainer) -> list[torch.Tensor]:
    """Parameters, moments and EMA, as a checkpoint holds them."""
    ema = trainer.ema_params
    state = [*tree_leaves(trainer.params), *trainer.opt_state["mu"], *trainer.opt_state["nu"],
             *(tree_leaves(ema) if ema is not None else [])]
    return [t.detach() for t in state]


def _assert_state_close(got: list, want: list, n_params: int, steps: int, lr: float) -> None:
    """The moments and EMA to ``STATE_RTOL`` a leaf (relative Frobenius);
    the parameters within ``steps`` x 2 lr an element: an AdamW update is
    about lr * sign(g), and where g is rounding noise around 0 (a gradient
    that is 0 in exact arithmetic) the ranks' sums may give it either
    sign."""
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a.shape == b.shape
        if i < n_params:
            assert float((a - b).abs().max()) <= 2 * lr * steps * (1 + 1e-3), i
        else:
            assert _rel(a.float(), b.float()) <= STATE_RTOL or float(b.abs().max()) < 1e-12, i


def _steps(rc, mesh, n=2, seed=0):
    """``n`` train steps of a fresh trainer on ``mesh`` over the first
    global batches of epoch 0 -> (mean losses per step, the state)."""
    trainer = port_trainer.Trainer(rc, _model(rc, seed), device="cpu", mesh=mesh)
    losses = []
    with trainer.sharded():
        for _, batch in zip(range(n), trainer.dataloader):
            loss, _ = trainer.train_step(batch)
            if mesh is not None and mesh.comm is not None:
                loss = mesh.comm.all_reduce_(loss.clone()) / mesh.degree
            losses.append(float(loss))
    trainer.dataloader.close()
    return losses, _state(trainer)


# float32 first moments: a bf16 one would round the ulps the ranks' sums
# move to a whole bf16 step (the checkpoint test takes bf16)
TRAIN = dict(grad_accumulation_steps=2, grad_clip_norm=0.05, ema_decay=0.9,
             skip_nonfinite_updates=2, weight_decay=0.01)


@pytest.fixture
def small_fsdp_threshold(monkeypatch):
    """The tiny model's leaves are below 2**14 elements: shard from 64, as
    JAX's own FSDP tests lower theirs."""
    monkeypatch.setattr(psharding, "FSDP_MIN_ELEMENTS", 64)


@pytest.mark.parametrize("lora", [False, True])
def test_trainer_dp_and_fsdp_steps_equal_one_process(fixture_dir, tmp_path, lora,  # noqa: F811
                                                     small_fsdp_threshold):
    """Two steps of two ranks (A = 2 micro-batches each, clipping, finite
    test, EMA; and LoRA adapters over a frozen, sharded encoder): the DP
    state equals one process's on the global batches, and the FSDP state
    (sharded inside, gathered on the way out) equals the DP state."""
    rc = _rc(fixture_dir, tmp_path, **TRAIN, **(dict(lora_freeze_base=True) if lora else {}))
    if lora:
        rc = dataclasses.replace(rc, model=dataclasses.replace(
            rc.model, vit_overrides={**rc.model.vit_overrides, "lora_rank": 4}))
    one_losses, one = _steps(rc, None)
    dp = run_ranks(lambda m: _steps(rc, m))
    fsdp = run_ranks(lambda m: _steps(rc, m), fsdp=True)
    assert len(one) == len(dp[0][1]) == len(fsdp[0][1])
    np.testing.assert_allclose(dp[0][0], one_losses, rtol=DP_RTOL)
    np.testing.assert_allclose(fsdp[0][0], dp[0][0], rtol=DP_RTOL)
    for a, b in zip(dp[0][1], dp[1][1]):  # the ranks agree bit for bit
        assert torch.equal(a, b)
    n = len(tree_leaves(_model(rc).params))
    _assert_state_close(dp[0][1], one, n, steps=2, lr=rc.train.learning_rate)
    _assert_state_close(fsdp[0][1], dp[0][1], n, steps=2, lr=rc.train.learning_rate)


def test_fsdp_shards_at_rest(fixture_dir, tmp_path, small_fsdp_threshold):  # noqa: F811
    """Inside ``sharded()`` a sharded leaf's tensor is freed between steps
    and its shard, moments and EMA are 1/2 of it; a step outside raises."""
    rc = _rc(fixture_dir, tmp_path, ema_decay=0.9)

    def body(mesh):
        trainer = port_trainer.Trainer(rc, _model(rc), device="cpu", mesh=mesh)
        full = [t.numel() for t in trainer._leaves]
        with pytest.raises(RuntimeError, match="sharded"):
            trainer.train_step(next(iter(trainer.dataloader)))
        with trainer.sharded():
            dims = trainer._layout.dims
            assert any(d is not None for d in dims)
            for leaf, rest, mu, ema, n, d in zip(trainer._leaves, trainer._rest,
                                                 trainer.opt_state["mu"],
                                                 tree_leaves(trainer.ema_params), full, dims):
                held = n if d is None else n // 2
                assert rest.numel() == mu.numel() == ema.numel() == held
                assert leaf.numel() == (n if d is None else 0)
        assert [t.numel() for t in trainer._leaves] == full
        trainer.dataloader.close()

    run_ranks(body, fsdp=True)


def test_one_rank_group_gives_the_plain_bits(fixture_dir, tmp_path):  # noqa: F811
    """A group of one (the card's NCCL world of 1) runs every collective
    of the step and ends with the bits of no group."""
    rc = _rc(fixture_dir, tmp_path, **TRAIN)
    plain = _steps(rc, None)
    grouped = run_ranks(lambda m: _steps(rc, m), world=1)[0]
    assert plain[0] == grouped[0]
    assert all(torch.equal(a, b) for a, b in zip(plain[1], grouped[1]))


@pytest.mark.parametrize("fsdp", [False, True])
def test_checkpoints_cross_world_sizes(fixture_dir, tmp_path, fsdp,  # noqa: F811
                                       small_fsdp_threshold):
    """A world-2 checkpoint (rank 0 writes the one-card file, FSDP's
    gathered) resumes at world 1 with the same bits, and a world-1
    checkpoint at world 2 on both ranks (bf16 first moments)."""
    rc = _rc(fixture_dir, tmp_path, **TRAIN, adam_mu_dtype="bfloat16")

    def two(mesh):
        trainer = port_trainer.Trainer(rc, _model(rc), device="cpu", mesh=mesh)
        with trainer.sharded():
            trainer.train_step(next(iter(trainer.dataloader)))
            path = trainer.save_checkpoint(1)
        trainer.dataloader.close()
        return path, _state(trainer)

    (path, state), _ = run_ranks(two, fsdp=fsdp)
    one = port_trainer.Trainer(rc, _model(rc, seed=3), device="cpu")
    one.resume(path)
    assert all(torch.equal(a, b) for a, b in zip(_state(one), state))

    path1 = one.save_checkpoint(2, tag="w1")

    def resume(mesh):
        trainer = port_trainer.Trainer(rc, _model(rc, seed=4), device="cpu", mesh=mesh)
        trainer.resume(path1)
        with trainer.sharded():  # sharded and gathered back unchanged
            pass
        return _state(trainer)

    for got in run_ranks(resume, fsdp=fsdp):
        assert all(torch.equal(a, b) for a, b in zip(got, _state(one)))


def test_sigterm_stop_is_agreed(fixture_dir, tmp_path):  # noqa: F811
    """A SIGTERM seen by rank 1 alone stops both ranks."""
    rc = _rc(fixture_dir, tmp_path)

    def body(mesh):
        trainer = port_trainer.Trainer(rc, _model(rc), device="cpu", mesh=mesh)
        trainer._guard = port_trainer._PreemptionGuard()
        trainer._guard.preempted = mesh.rank == 1
        return trainer._preempted()

    assert run_ranks(body) == [True, True]


# ------------------------------------------------------ loader, eval, mesh


@pytest.mark.parametrize("accum", [1, 2])
def test_loader_rows_make_the_global_batch(fixture_dir, accum):  # noqa: F811
    """Two ranks' loaders (``DataMesh.rows``) over a shuffled, flipped
    epoch with a mid-epoch resume: their batches, put back in the global
    slots, are the global batch bit for bit (an epoch's padded remainder
    included)."""
    root = os.path.join(fixture_dir, "samples")
    ann = os.path.join(fixture_dir, "samples.json")
    kw = dict(batch_size=4, shuffle=True, num_workers=2, image_size=64, max_gt=16, seed=3,
              augment_hflip=0.5, device="cpu")

    def epoch(rows):
        loader = DetectionLoader(PubLayNetDataset(root + "/", ann), rows=rows, **kw)
        loader.set_epoch(1)
        loader.skip_batches(1)
        out = list(loader)
        loader.close()
        return out

    want = epoch(None)
    assert len(want) == 1  # 8 pages, batch 4, one skipped
    ranks = [epoch(pmesh.DataMesh(2, r).rows(4, accum)) for r in range(2)]
    for i, w in enumerate(want):
        slots = np.concatenate([pmesh.DataMesh(2, r).rows(4, accum) for r in range(2)])
        order = np.argsort(slots)
        for field in ("images", "gt_boxes", "gt_labels", "gt_valid"):
            got = torch.cat([getattr(r[i], field) for r in ranks])[order]
            assert torch.equal(got, getattr(w, field)), field
        for field in ("image_ids", "orig_sizes", "image_valid"):
            got = np.concatenate([getattr(r[i], field) for r in ranks])[order]
            np.testing.assert_array_equal(got, getattr(w, field))
    # with A micro-batches, rank r's micro-batch a is its part of the global one
    assert pmesh.DataMesh(2, 1).rows(8, 2).tolist() == [2, 3, 6, 7]


@pytest.mark.parametrize("world", [2, 3])
def test_dp_eval_equals_one_rank(fixture_dir, tmp_path, world):  # noqa: F811
    """``Evaluator.score()`` over ranks: each predicts its rows, rank 0
    writes ``predictions.json`` and every rank returns its metrics, equal
    to one rank's; a batch of 4 over 3 ranks falls back to each rank
    predicting the whole split."""
    rc = _rc(fixture_dir, tmp_path)
    model = _model(rc)
    one = Evaluator(model, rc, device="cpu")
    want = one.score()
    with open(one.predictions_path) as f:
        want_preds = json.load(f)
    os.remove(one.predictions_path)

    def body(mesh):
        ev = Evaluator(model, rc, device="cpu", comm=mesh.comm)
        return ev._sharded, ev.score()

    got = run_ranks(body, world=world)
    assert {s for s, _ in got} == {world == 2}
    for _, metrics in got:
        assert metrics == want
    with open(one.predictions_path) as f:
        assert json.load(f) == want_preds


def test_mesh_rules(monkeypatch):
    """JAX's rules: -1 is every rank, a degree is clamped to divide the
    batch (loudly), more than the world raises; the port also refuses a
    degree that leaves processes idle and a micro-batch the ranks do not
    divide."""
    assert pmesh.resolve_degree(-1, 4, 16) == 4
    assert pmesh.resolve_degree(-1, 3, 16) == 2
    assert pmesh.resolve_degree(2, 4, 16) == 2
    with pytest.raises(ValueError, match="only 2"):
        pmesh.resolve_degree(4, 2, 16)
    hub = _Hub(2)

    def mesh(dp, batch, accum=1, fsdp=False):
        cfg = MeshConfig(data_parallel=dp, fsdp=fsdp)
        return pmesh.build_mesh_for_batch(cfg, batch, accum, comm=ThreadComm(hub, 0))

    m = mesh(-1, 16, fsdp=True)
    assert (m.degree, m.rank, m.fsdp) == (2, 0, True)
    with pytest.raises(ValueError, match="2 processes are running"):
        mesh(1, 16)
    with pytest.raises(ValueError, match="does not split"):
        mesh(-1, 6, accum=2)
    single = pmesh.build_mesh_for_batch(MeshConfig(fsdp=True), 16)
    assert (single.degree, single.comm, single.fsdp) == (1, None, False)


@pytest.mark.parametrize("shape", [(), (7,), (64, 64), (128, 130), (3, 99, 1024),
                                   (12544, 1024), (1024, 3, 16, 16), (2304,), (99, 199)])
@pytest.mark.parametrize("dp", [2, 4])
def test_fsdp_dim_follows_jax(shape, dp):
    """``fsdp_dim`` is JAX's ``_fsdp_spec`` on a leaf without a model-axis
    spec: the first largest dim that ``dp`` divides, from 2**14 elements."""
    spec = jax_sharding._fsdp_spec(np.zeros(shape, np.int8), P(), "data", dp)
    want = next((i for i, a in enumerate(spec) if a == "data"), None)
    assert psharding.fsdp_dim(shape, dp) == want
