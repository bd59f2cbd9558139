"""The port's Cascade R-CNN (``models/detection/cascade.py`` and the
detector's cascade path) against the JAX package on the CPU, float32, at
``tests/test_cascade.py``'s tiny sizes (hidden 32, 2 layers, 64 px, FPN
32, budgets 100/50/32/10), on parameters carried with ``params_from_jax``:
the stage matcher (labels exact), ``refine_boxes``, ``cascade_mean_scores``
and ``cascade_stage_loss`` (1e-6), the whole ``detector_loss`` (losses
1e-4, every gradient leaf 1e-3 relative Frobenius) and ``detector_predict``
(boxes 1e-3, scores 1e-4), the weight round trip, a JAX ``.msgpack``
resumed, the export of a cascade model, and on the card the RoIAlign pair
on refined boxes with degenerate ones among them."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import cascade as jax_cascade
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import cascade as port_cascade
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.ops import roi_align as port_roi
from layoutdit_tpu_torch.train import checkpoint as port_ckpt

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=64, image_size=64)
BUDGET = dict(rpn_pre_nms_top_n_train=100, rpn_pre_nms_top_n_test=50,
              rpn_post_nms_top_n_train=100, rpn_post_nms_top_n_test=50,
              box_batch_size_per_image=32, box_detections_per_img=10)
STAGES = (0.5, 0.6, 0.7)
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3  # relative Frobenius, per leaf
UNIT_TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _jax_draws(key, b, n):
    """The uniforms one vmapped JAX sampler draws, as [B, 2, n]."""
    out = []
    for k in jax.random.split(key, b):
        k_pos, k_neg = jax.random.split(k)
        out.append([np.asarray(jax.random.uniform(k_pos, (n,))),
                    np.asarray(jax.random.uniform(k_neg, (n,)))])
    return torch.from_numpy(np.asarray(out))


def _jax_priorities(rng, pcfg, b, g):
    """``detector_loss``'s draws: split(rng) -> (rpn, roi) keys."""
    k_rpn, k_roi = jax.random.split(rng)
    n_anchors = sum(h * w for h, w in pcfg.grid_sizes) * pcfg.num_anchors_per_cell
    return port_det.SamplerPriorities(
        rpn=_jax_draws(k_rpn, b, n_anchors),
        roi=_jax_draws(k_roi, b, pcfg.budget.rpn_post_nms_top_n_train + g))


def _configs(**extra):
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=JaxBudget(**BUDGET), **extra)
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**VIT),
                                              fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**BUDGET), **extra)
    return jcfg, pcfg


def _jax_params(jcfg, seed=0):
    p = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    # JAX's zero position embeddings tie anchors on uniform regions
    p["backbone"]["vit"]["pos_embed"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(1), p["backbone"]["vit"]["pos_embed"].shape)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = _configs(cascade_iou_threshs=STAGES)
    return _jax_params(jcfg), jcfg, pcfg


def _batch():
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    gt_boxes = np.array(
        [[[5, 5, 30, 40], [20, 10, 60, 50], [33, 2, 63, 20], [0, 0, 0, 0]],
         [[10, 10, 50, 60], [2, 40, 20, 62], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    gt_labels = np.array([[1, 3, 5, 0], [2, 4, 0, 0]], np.int32)
    gt_valid = np.array([[True, True, True, False], [True, True, False, False]])
    return images, gt_boxes, gt_labels, gt_valid


def _boxes(rng, n, size=64.0):
    xy = rng.uniform(-8, size, (n, 2))
    wh = rng.uniform(0.5, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------- unit pieces


def test_match_boxes_to_gt_matches_jax():
    rng = np.random.default_rng(0)
    b, s = 3, 80
    boxes = np.stack([_boxes(rng, s) for _ in range(b)])
    gt = np.stack([_boxes(rng, 5) for _ in range(b)])
    boxes[0, :4] = gt[0, 1]  # exact matches, and a gt repeated (argmax ties)
    gt[0, 3] = gt[0, 1]
    gt_labels = rng.integers(1, 6, (b, 5)).astype(np.int32)
    gt_valid = np.array([[True, True, False, True, True], [True] * 5, [False] * 5])
    box_valid = rng.uniform(size=(b, s)) < 0.85
    for thresh, w in zip(STAGES, port_cascade.DEFAULT_STAGE_REG_WEIGHTS):
        got = port_cascade.match_boxes_to_gt(_t(boxes), _t(box_valid), _t(gt), _t(gt_labels),
                                             _t(gt_valid), thresh, w)
        for i in range(b):
            want = jax_cascade.match_boxes_to_gt_single(
                jnp.asarray(boxes[i]), jnp.asarray(box_valid[i]), jnp.asarray(gt[i]),
                jnp.asarray(gt_labels[i]), jnp.asarray(gt_valid[i]), thresh, w)
            np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))
            np.testing.assert_allclose(got.reg_targets[i].numpy(), np.asarray(want.reg_targets),
                                       rtol=UNIT_TOL, atol=UNIT_TOL)
        assert (got.labels > 0).any() and not got.labels[2].any()


def test_refine_boxes_and_mean_scores_match_jax():
    """Deltas that push boxes past every edge: the clip gives boxes of
    zero width or height, as later stages do at a page's border."""
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 64)
    boxes[:8] = [[0, 0, 4, 4], [60, 60, 64, 64], [-5, 10, 2, 20], [62, 0, 70, 9],
                 [0, 0, 0, 0], [10, 10, 10, 30], [30, 63, 40, 64], [1, 1, 64, 64]]
    deltas = rng.normal(0, 2.0, (64, 4)).astype(np.float32)
    deltas[:4] = [[-40, -40, 0, 0], [40, 40, 0, 0], [-30, 0, 1, 0], [30, 0, 0, 1]]
    for w in port_cascade.DEFAULT_STAGE_REG_WEIGHTS:
        got = port_cascade.refine_boxes(_t(boxes), _t(deltas), w, (64, 64)).numpy()
        want = np.asarray(jax_cascade.refine_boxes(jnp.asarray(boxes), jnp.asarray(deltas), w,
                                                   (64, 64)))
        np.testing.assert_allclose(got, want, rtol=UNIT_TOL, atol=UNIT_TOL)
    w_h = np.minimum(got[:, 2] - got[:, 0], got[:, 3] - got[:, 1])
    assert (w_h == 0).any()
    logits = [rng.normal(0, 3, (2, 40, 6)).astype(np.float32) for _ in STAGES]
    got = port_cascade.cascade_mean_scores([_t(x) for x in logits]).numpy()
    want = np.asarray(jax_cascade.cascade_mean_scores([jnp.asarray(x) for x in logits]))
    np.testing.assert_allclose(got, want, rtol=UNIT_TOL, atol=UNIT_TOL)


def test_cascade_stage_loss_matches_jax():
    rng = np.random.default_rng(2)
    b, s = 2, 32
    logits = rng.normal(0, 2, (b, s, 6)).astype(np.float32)
    reg = rng.normal(0, 0.3, (b, s, 4)).astype(np.float32)
    labels = rng.integers(0, 6, (b, s))
    targets = np.where(labels[..., None] > 0, rng.normal(0, 0.3, (b, s, 4)), 0).astype(np.float32)
    valid = rng.uniform(size=(b, s)) < 0.8
    got = port_cascade.cascade_stage_loss(_t(logits), _t(reg), _t(labels), _t(targets),
                                          _t(valid))
    want = jax_cascade.cascade_stage_loss(jnp.asarray(logits), jnp.asarray(reg),
                                          jnp.asarray(labels.astype(np.int32)),
                                          jnp.asarray(targets), jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=UNIT_TOL, atol=UNIT_TOL)
    assert float(got[1]) > 0


# ------------------------------------------------------------ the detector


def test_params_structure_and_round_trip(models):
    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    assert "box_head" not in params and set(params["cascade_heads"]) == {"s0", "s1", "s2"}
    for st in params["cascade_heads"].values():
        assert st["box_predictor"]["bbox"]["weight"].shape == (4, 1024)  # class-agnostic
        assert st["box_predictor"]["cls"]["weight"].shape == (6, 1024)
    back = params_to_jax(params)
    flat_j, tree_j = jax.tree_util.tree_flatten(jparams)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for w, g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w)
    # the port's own init has the same structure
    mine = port_det.init_detector(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [t.shape for t in tree_leaves(mine)] == [t.shape for t in tree_leaves(params)]


def test_detector_loss_and_gradients_match_jax(models):
    jparams, jcfg, pcfg = models
    images, gt_boxes, gt_labels, gt_valid = _batch()
    rng = jax.random.PRNGKey(7)

    def total(p, rng, *batch):
        d = jax_det.detector_loss(p, rng, *batch, jcfg)
        return sum(d.values()), d

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jparams, rng, images, gt_boxes, gt_labels, gt_valid)
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                                 pcfg, _jax_priorities(rng, pcfg, 2, 4))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    sum(got.values()).backward()
    grads = params_to_jax(tree_map(lambda t: t.grad, params))
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_p = jax.tree_util.tree_leaves(grads)
    assert len(flat_j) == len(flat_p)
    for (path, w), g in zip(flat_j, flat_p):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert _rel_frob(g, w) <= GRAD_RTOL, (jax.tree_util.keystr(path), _rel_frob(g, w))
    # every stage's head learns (the refined boxes carry no gradient)
    for i in range(3):
        assert np.abs(grads["cascade_heads"][f"s{i}"]["box_head"]["fc7"]["kernel"]).max() > 0


@pytest.fixture(scope="module")
def predictions(models):
    jparams, jcfg, pcfg = models
    images = np.random.default_rng(5).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_det.detector_predict(p, x, jcfg))(jparams, images)
    with torch.no_grad():
        got = port_det.detector_predict(params_from_jax(jparams), _t(images), pcfg)
    return images, got, jax.tree_util.tree_map(np.asarray, want)


def test_detector_predict_matches_jax(predictions):
    _, got, want = predictions
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    v = want.valid
    assert v.sum() > 0
    np.testing.assert_array_equal(got.labels.numpy()[v], want.labels[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want.boxes[v], atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-4)


def test_jax_msgpack_resumes_in_the_port(models, tmp_path):
    """JAX's ``save_checkpoint`` of the cascade model with its AdamW state
    -> the port's reader: the parameters bit for bit, the moments in the
    port's leaf order, a model restored in place."""
    # flax and optax, which the card's machine may lack: imported here so
    # that this file's `cuda` tests collect there
    from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
    from layoutdit_tpu.train.trainer import make_optimizer

    jparams, _, pcfg = models
    tx = make_optimizer(JaxTrainingConfig(), steps_per_epoch=4)
    path = str(tmp_path / "epoch_1.msgpack")
    jax_save(path, jparams, tx.init(jparams), epoch=1, extra={"step": 3})
    state = port_ckpt.load_checkpoint(path, map_location="cpu")
    assert state["epoch"] == 1
    want = tree_leaves(params_from_jax(jparams))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]), want, strict=True))
    mu = state["opt_state"]["mu"]
    assert [t.shape for t in mu] == [t.shape for t in want]
    model = port_det.DetectorModel(
        port_det.init_detector(pcfg, torch.Generator().manual_seed(1), device="cpu"), pcfg)
    from layoutdit_tpu_torch.models.model import LayoutDetectionModel

    shell = object.__new__(LayoutDetectionModel)
    shell.device, shell.params, shell.cfg = torch.device("cpu"), model.params, pcfg
    shell.restore_checkpoint(path)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(model.params), want))


def test_cascade_export_equals_live(models, predictions, tmp_path):
    from layoutdit_tpu_torch.export import ExportedDetector, export_detector

    jparams, _, pcfg = models
    images, live, _ = predictions
    manifest = export_detector(params_from_jax(jparams), pcfg, str(tmp_path), image_sizes=(64,),
                               batch_size=2, device="cpu")
    assert manifest["image_sizes"] == [64]
    out = ExportedDetector(str(tmp_path), device="cpu").predict(_t(images),
                                                                torch.ones(2, 2) * 64)
    np.testing.assert_array_equal(out["valid"], live.valid.numpy())
    np.testing.assert_array_equal(out["labels"], live.labels.numpy())
    np.testing.assert_allclose(out["boxes"], live.boxes.numpy(), atol=1e-5)
    np.testing.assert_allclose(out["scores"], live.scores.numpy(), atol=1e-6)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_roi_kernels_on_refined_degenerate_boxes(cuda):
    """Rows 7-8 at P=7 on a later stage's boxes: refined and clipped to a
    224 px page, zero-width and zero-height ones at the edges among them,
    against their plain versions on the same inputs."""
    gen = torch.Generator().manual_seed(0)
    b, k, c = 2, 256, 64
    feats = [torch.randn(b, c, s, s, generator=gen) for s in (56, 28, 14, 7, 4)]
    xy = torch.rand(b, k, 2, generator=gen) * 224
    boxes = torch.cat([xy, xy + torch.rand(b, k, 2, generator=gen) * 112], -1)
    deltas = torch.randn(b, k, 4, generator=gen) * 3
    deltas[:, :16, :2] = 60.0  # pushed past the bottom-right edge
    deltas[:, 16:32, :2] = -60.0  # past the top-left one
    refined = port_cascade.refine_boxes(boxes, deltas, (20.0, 20.0, 10.0, 10.0), (224, 224))
    span = torch.minimum(refined[..., 2] - refined[..., 0], refined[..., 3] - refined[..., 1])
    assert (span == 0).sum() >= 16
    valid = torch.rand(b, k, generator=gen) < 0.9
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
    levels = port_roi.roi_levels(refined, 5, 224.0, 4, valid)
    want = port_roi.roi_align_plain([f.bfloat16() for f in feats], refined, levels, scales, 7, 2)
    feats_c = [f.to(cuda, torch.bfloat16).contiguous(memory_format=torch.channels_last)
               for f in feats]
    got = port_roi.roi_align_fwd(feats_c, refined.to(cuda), levels.to(cuda), scales, 7, 2)
    tol = float(want.float().abs().max()) / 64
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol
    dout = torch.randn(want.shape, generator=gen).bfloat16()
    want_d = port_roi.roi_align_bwd_plain(dout, refined, levels, feats_c, scales, 7, 2)
    got_d = port_roi.roi_align_bwd(dout.to(cuda), refined.to(cuda), levels.to(cuda), feats_c,
                                   scales, 7, 2)
    for g, w in zip(got_d, want_d):
        t = max(float(w.float().abs().max()) / 64, 1e-4)
        assert float((g.cpu().float() - w.float()).abs().max()) <= t
