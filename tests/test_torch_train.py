"""The ported training slice vs the JAX package on the CPU, float32, tiny
widths: matcher and samplers fed JAX's own sampler draws, the RPN and
Fast R-CNN losses, the whole ``detector_loss`` with its gradients and one
AdamW update, the learning-rate schedule, the loader, checkpoints and a
two-epoch ``Trainer`` run; plus the short-attention and RoIAlign
backward kernels against their plain versions on the card."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
from layoutdit_tpu.data.dataset import PubLayNetDataset as JaxDataset
from layoutdit_tpu.data.pipeline import DetectionLoader as JaxLoader
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.models.detection import roi_heads as jax_roi
from layoutdit_tpu.models.detection import rpn as jax_rpn
from layoutdit_tpu_torch.config import DetectionBudget, TrainingConfig, run_config_from_dict
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionLoader
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection import roi_heads as port_roi
from layoutdit_tpu_torch.models.detection import rpn as port_rpn
from layoutdit_tpu_torch.models.weights_io import (
    k_bias_slots,
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train import trainer as port_trainer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, image_size=64)
BUDGET = dict(rpn_pre_nms_top_n_train=200, rpn_post_nms_top_n_train=100,
              box_batch_size_per_image=32)
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3  # relative Frobenius, per leaf
PARAM_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_trainer():
    """The JAX trainer module, imported where a test needs it: it pulls in
    flax and optax, which the card's machine may lack, and the `cuda`
    tests of this file must still collect there."""
    from layoutdit_tpu.train import trainer

    return trainer


def _jax_draws(key, b, n):
    """The uniforms one vmapped JAX sampler draws: per image
    split(key_i) -> (positives, negatives), as [B, 2, n]."""
    out = []
    for k in jax.random.split(key, b):
        k_pos, k_neg = jax.random.split(k)
        out.append([np.asarray(jax.random.uniform(k_pos, (n,))),
                    np.asarray(jax.random.uniform(k_neg, (n,)))])
    return torch.from_numpy(np.asarray(out))


def _jax_priorities(rng, b, n_anchors, n_cand):
    """``detector_loss``'s draws: split(rng) -> (rpn, roi) keys."""
    k_rpn, k_roi = jax.random.split(rng)
    return port_det.SamplerPriorities(
        rpn=_jax_draws(k_rpn, b, n_anchors), roi=_jax_draws(k_roi, b, n_cand)
    )


@pytest.fixture(scope="module")
def models():
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=JaxBudget(**BUDGET),
    )
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**BUDGET),
    )
    jparams = jax.jit(jax_det.init_detector_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg
    )
    jparams["backbone"]["vit"]["pos_embed"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(1), jparams["backbone"]["vit"]["pos_embed"].shape
    )
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, jcfg, pcfg


def _batch():
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    gt_boxes = np.array(
        [[[5, 5, 30, 40], [20, 10, 60, 50], [33, 2, 63, 20], [0, 0, 0, 0]],
         [[10, 10, 50, 60], [2, 40, 20, 62], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    gt_labels = np.array([[1, 3, 5, 0], [2, 4, 0, 0]], np.int32)
    gt_valid = np.array([[True, True, True, False], [True, True, False, False]])
    return images, gt_boxes, gt_labels, gt_valid


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(jcfg):
    """jit of the JAX detector_loss and its gradients, traced once per
    config for the tests below (same shapes)."""

    def total(p, rng, *batch):
        d = jax_det.detector_loss(p, rng, *batch, jcfg)
        return sum(d.values()), d

    return jax.jit(jax.value_and_grad(total, has_aux=True))


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def test_detector_loss_grads_and_update_match_jax(models):
    jparams, jcfg, pcfg = models
    assert_loss_grads_and_update_match(jparams, jcfg, pcfg, *_batch())


def assert_loss_grads_and_update_match(jparams, jcfg, pcfg, images, gt_boxes, gt_labels,
                                       gt_valid):
    """The port's ``detector_loss`` against the JAX package's on the same
    weights, batch and sampler draws: the four losses, every gradient
    leaf (via ``params_to_jax``) and one AdamW update through each
    package's optimizer."""
    rng = jax.random.PRNGKey(7)
    b, g = gt_labels.shape
    (_, want), jgrads = _jax_loss_and_grads(jcfg)(jparams, rng, images, gt_boxes, gt_labels,
                                                  gt_valid)

    params = params_from_jax(jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    n_anchors = sum(h * w for h, w in pcfg.grid_sizes) * pcfg.num_anchors_per_cell
    pri = _jax_priorities(rng, b, n_anchors, pcfg.budget.rpn_post_nms_top_n_train + g)
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels),
                                 _t(gt_valid), pcfg, pri)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=LOSS_RTOL,
                                   err_msg=name)
    sum(got.values()).backward()

    grads = params_to_jax(tree_map(lambda t: t.grad, params))
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    flat_j, tree_j = jax.tree_util.tree_flatten_with_path(jgrads)
    flat_p = jax.tree_util.tree_leaves(grads)
    assert len(flat_j) == len(flat_p)
    for (path, w), g in zip(flat_j, flat_p):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert _rel_frob(g, w) <= GRAD_RTOL, (jax.tree_util.keystr(path), _rel_frob(g, w))

    # one AdamW update through each package's optimizer
    tc = dict(weight_decay=0.01, grad_clip_norm=1.0)  # lr: the default 1e-4
    import optax

    tx = _jax_trainer().make_optimizer(JaxTrainingConfig(**tc), steps_per_epoch=4)
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    jnew = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates))
    cfg = TrainingConfig(**tc)
    k_bias = k_bias_slots(params)
    assert all(float(b.grad[s].abs().max()) < 1e-6 for b, s in k_bias)  # rounding noise
    for b, slot in k_bias:  # as the trainer does before each update
        b.grad[slot] = 0.0
    opt = port_trainer.AdamW(cfg, steps_per_epoch=4)
    opt.update(opt.init(leaves), leaves, [t.grad for t in leaves])
    assert all(not b[s].any() for b, s in k_bias)  # the K-bias slot stays zero
    new = params_to_jax(params)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jnew)[0],
                            jax.tree_util.tree_leaves(new)):
        np.testing.assert_allclose(g, w, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_image_without_gt_keeps_gradients_finite(models):
    """One image of the batch has no valid gt box. The losses match JAX's;
    the port's gradients stay finite where the JAX package's do not (its
    RPN encodes the zero padding box for sampler slots it does not take,
    log(0) -> inf, and 0 * inf through the masked smooth-L1 gives NaN;
    the port zeroes those slots' targets)."""
    jparams, jcfg, pcfg = models
    images, gt_boxes, gt_labels, gt_valid = _batch()
    gt_valid[1] = False
    rng = jax.random.PRNGKey(11)
    (_, want), _ = _jax_loss_and_grads(jcfg)(jparams, rng, images, gt_boxes, gt_labels,
                                             gt_valid)
    params = params_from_jax(jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    n_anchors = sum(h * w for h, w in pcfg.grid_sizes) * pcfg.num_anchors_per_cell
    got = port_det.detector_loss(
        params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid), pcfg,
        _jax_priorities(rng, 2, n_anchors, BUDGET["rpn_post_nms_top_n_train"] + 4))
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    sum(got.values()).backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


# ----------------------------------------------------- matcher and samplers


def _boxes(rng, n, size=64.0):
    xy = rng.uniform(-8, size, (n, 2))
    wh = rng.uniform(1, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "low_quality_ties", "no_valid_gt"])
def test_match_anchors_to_gt_matches_jax(rng, case):
    anchors = _boxes(rng, 300)
    gt = _boxes(rng, 5)
    valid = np.array([True, True, False, True, True])
    if case == "low_quality_ties":
        # a gt that overlaps nothing (best IoU 0: every zero-IoU anchor
        # ties it) and one that equals an anchor twice over
        gt[0] = [500, 500, 510, 510]
        anchors[7] = anchors[11] = gt[1]
    if case == "no_valid_gt":
        valid[:] = False
    want = jax_rpn.match_anchors_to_gt(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
                                       0.7, 0.3, True)
    got = port_rpn.match_anchors_to_gt(_t(anchors), _t(gt), _t(valid), 0.7, 0.3, True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if case != "no_valid_gt":  # the index is meaningless without a gt
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[1] == 1).any() or case == "no_valid_gt"


def test_balanced_sample_with_pos_matches_jax(rng):
    labels = rng.choice([1, 0, -1], size=(3, 400), p=[0.1, 0.6, 0.3])
    labels[1, :] = np.where(labels[1] == 1, 0, labels[1])  # no positives
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    pri = _jax_draws(jax.random.PRNGKey(5), 3, 400)
    got = port_rpn.balanced_sample_with_pos(_t(labels), pri, 64, 0.5)
    for i in range(3):
        want = jax_rpn.balanced_sample_with_pos(jnp.asarray(labels[i]), keys[i], 64, 0.5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def _proposals(rng, b=2, p=60):
    boxes = np.stack([_boxes(rng, p) for _ in range(b)])
    valid = rng.uniform(size=(b, p)) < 0.9
    return boxes, valid


def test_select_training_samples_matches_jax(rng):
    props, pvalid = _proposals(rng)
    _, gt, labels, gvalid = _batch()
    budget = DetectionBudget(box_batch_size_per_image=32)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    pri = _jax_draws(jax.random.PRNGKey(9), 2, props.shape[1] + gt.shape[1])
    got = port_roi.select_training_samples(_t(props), _t(pvalid), _t(gt), _t(labels),
                                           _t(gvalid), budget, pri)
    for i in range(2):
        want = jax_roi.select_training_samples_single(
            jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(gt[i]),
            jnp.asarray(labels[i]), jnp.asarray(gvalid[i]), JaxBudget(box_batch_size_per_image=32),
            keys[i],
        )
        np.testing.assert_array_equal(got.rois[i].numpy(), np.asarray(want.rois))
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(got.reg_targets[i].numpy(), np.asarray(want.reg_targets),
                                   rtol=1e-6, atol=1e-6)
    assert (got.labels > 0).any()


def test_rpn_and_fastrcnn_losses_match_jax(rng):
    _, gt, labels, gvalid = _batch()
    anchors = _boxes(rng, 300)
    obj = rng.standard_normal((2, 300)).astype(np.float32)
    deltas = 0.1 * rng.standard_normal((2, 300, 4)).astype(np.float32)
    budget = dict(rpn_batch_size_per_image=64)
    want = jax_rpn.rpn_loss(jnp.asarray(obj), jnp.asarray(deltas), jnp.asarray(anchors),
                            jnp.asarray(gt), jnp.asarray(gvalid), JaxBudget(**budget),
                            jax.random.PRNGKey(2))
    got = port_rpn.rpn_loss(_t(obj), _t(deltas), _t(anchors), _t(gt), _t(gvalid),
                            DetectionBudget(**budget), _jax_draws(jax.random.PRNGKey(2), 2, 300))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-7)
    assert float(got[1]) > 0

    props, pvalid = _proposals(rng)
    samples = port_roi.select_training_samples(
        _t(props), _t(pvalid), _t(gt), _t(labels), _t(gvalid),
        DetectionBudget(box_batch_size_per_image=32),
        _jax_draws(jax.random.PRNGKey(4), 2, props.shape[1] + gt.shape[1]))
    s = samples.rois.shape[1]
    logits = rng.standard_normal((2, s, 6)).astype(np.float32)
    reg = 0.1 * rng.standard_normal((2, s, 24)).astype(np.float32)
    jsamples = jax_roi.TrainingSamples(*(jnp.asarray(x.numpy()) for x in samples))
    want = jax_roi.fastrcnn_loss(jnp.asarray(logits), jnp.asarray(reg), jsamples)
    got = port_roi.fastrcnn_loss(_t(logits), _t(reg), samples)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-7)
    assert float(got[1]) > 0


# ---------------------------------------------------------- schedule, config


@pytest.mark.parametrize("kw", [
    {}, {"lr_schedule": "cosine", "num_epochs": 3},
    {"warmup_steps": 7, "step_size": 1, "gamma": 0.5},
    {"lr_schedule": "cosine", "warmup_steps": 4, "num_epochs": 2},
])
def test_lr_schedule_matches_jax(kw):
    want = _jax_trainer().make_lr_schedule(JaxTrainingConfig(**kw), steps_per_epoch=5)
    got = port_trainer.make_lr_schedule(TrainingConfig(**kw), steps_per_epoch=5)
    for count in range(0, 80, 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, err_msg=str(count))


def test_training_config_defaults_and_waiting_fields():
    jax_defaults = JaxTrainingConfig()
    for name, value in vars(TrainingConfig()).items():
        assert getattr(jax_defaults, name) == value, name
    rc = run_config_from_dict({"train_config": {"enable_profile": False, "num_epochs": 3}})
    assert rc.train.num_epochs == 3  # a waiting field at its default loads
    # warm-starting and LoRA are ported: their fields load at any value
    rc = run_config_from_dict({"detection_model_config": {"previous_layout_dit_checkpoint": "x"},
                               "train_config": {"lora_freeze_base": False}})
    assert rc.model.previous_layout_dit_checkpoint == "x" and not rc.train.lora_freeze_base
    # the profiler is ported: enable_profile loads at any value
    assert run_config_from_dict({"train_config": {"enable_profile": True}}).train.enable_profile
    # the device field is ported (config.resolve_device); a TPU is refused
    assert run_config_from_dict({"train_config": {"device": "cpu"}}).train.device == "cpu"
    with pytest.raises(ValueError, match="device.*TPU"):
        run_config_from_dict({"train_config": {"device": "tpu"}})
    with pytest.raises(ValueError, match="not supported"):
        run_config_from_dict({"train_config": {"no_such_field": 1}})
    with pytest.raises(ValueError, match="lr_schedule"):
        TrainingConfig(lr_schedule="linear")


# ------------------------------------------------------- loader, trainer


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_fixture"))
    make_fixture(root, n_images=8, split="samples", seed=1)
    write_fixture_config(root, epochs=2, batch_size=4, tiny_model=True)
    return root


@pytest.mark.parametrize("hflip", [0.0, 0.5])
def test_loader_matches_jax(fixture_dir, hflip):
    root = os.path.join(fixture_dir, "samples")
    ann = os.path.join(fixture_dir, "samples.json")
    kw = dict(batch_size=3, shuffle=True, num_workers=2, image_size=64, max_gt=16, seed=4,
              augment_hflip=hflip)
    jl = JaxLoader(JaxDataset(root + "/", ann), device_put=False, use_native=False, **kw)
    pl = DetectionLoader(PubLayNetDataset(root + "/", ann), device="cpu", **kw)
    flipped = 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 3  # 8 images, batch 3, last one padded
        for j, p in zip(jb, pb):
            np.testing.assert_array_equal(p.image_ids, j.image_ids)
            np.testing.assert_array_equal(p.image_valid, j.image_valid)
            np.testing.assert_array_equal(p.orig_sizes, j.orig_sizes)
            np.testing.assert_array_equal(p.gt_boxes.numpy(), j.gt_boxes)
            np.testing.assert_array_equal(p.gt_labels.numpy(), j.gt_labels)
            np.testing.assert_array_equal(p.gt_valid.numpy(), j.gt_valid)
            np.testing.assert_allclose(p.images.numpy(), j.images, atol=1e-5)
            flipped += int((p.images.numpy() != p.images.numpy()[..., ::-1]).any(axis=(1, 2, 3))
                           [j.image_valid].sum())
    assert flipped > 0
    pl.close()
    jl.close()


def test_trainer_two_epochs_checkpoint_and_resume(fixture_dir, tmp_path):
    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    rc = run_config_from_dict(raw)
    cfg = port_det.DetectorConfig.from_model_config(rc.model, rc.compute_dtype)
    cfg = dataclasses.replace(cfg, image_size=64)

    def model(seed):
        gen = torch.Generator().manual_seed(seed)
        return port_det.DetectorModel(port_det.init_detector(cfg, gen, device="cpu"), cfg)

    trainer = port_trainer.Trainer(rc, model(0), device="cpu")
    trainer.train()
    assert trainer.epoch == 2 and trainer.updates == 4
    assert all(np.isfinite(trainer.loss_history))
    run_dir = os.path.join(str(tmp_path), "fixture")
    with open(os.path.join(run_dir, "metrics", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # the JAX trainer's keys (trainer.py _run_epoch)
    assert [set(r) for r in recs] == [{"epoch", "loss", "images_per_sec", "learning_rate"}] * 2
    assert [r["epoch"] for r in recs] == [1, 2]
    assert recs[1]["loss"] == trainer.loss_history[1]
    ckpt = os.path.join(run_dir, "model_checkpoints", "epoch_2.pt")
    assert os.path.exists(ckpt)

    # resume into a trainer built from other weights: params, optimizer
    # state, epoch, update count and the sampler generator come back
    other = port_trainer.Trainer(rc, model(1), device="cpu")
    other.resume(ckpt)
    assert other.epoch == 2 and other.updates == 4
    assert other.loss_history == trainer.loss_history
    for a, b in zip(tree_leaves(other.params),
                    tree_leaves(trainer.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sa, sb = other.opt_state, trainer.opt_state
    assert set(sa) == set(sb) == {"mu", "nu", "count", "schedule_count"}
    for key in ("mu", "nu"):
        for a, b in zip(sa[key], sb[key], strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(sa["count"]) == int(sa["schedule_count"]) == 4
    assert torch.equal(other.generator.get_state(), trainer.generator.get_state())


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trainer_step_launches_the_kernels(cuda, fixture_dir, tmp_path):
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["precision"] = {"compute_dtype": "bfloat16"}
    rc = run_config_from_dict(raw)
    cfg = port_det.DetectorConfig.from_model_config(rc.model, rc.compute_dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    trainer = port_trainer.Trainer(
        rc, port_det.DetectorModel(port_det.init_detector(cfg, gen, device=cuda), cfg))
    counters = (sa.short_attention, sa.short_attention_bwd, ra.roi_align_fwd, ra.roi_align_bwd)
    before = [c.launches for c in counters]
    batch = next(iter(trainer.dataloader))
    loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    layers = cfg.backbone.vit.num_hidden_layers
    assert [c.launches - n for c, n in zip(counters, before)] == [layers, layers, 1, 1]
