"""The port's RetinaNet (``models/detection/retinanet.py`` and the
detector's ``retinanet`` path) against the JAX package on the CPU,
float32, on the tiny detector of ``tests/test_torch_train.py`` (hidden 64,
2 layers, 64 px; FPN 64) with ``configs/retinanet.json``'s 9 anchors a
cell, on parameters carried with ``params_from_jax``: the head (outputs
and their flatten order, 1e-5), ``sigmoid_focal_loss`` and
``retinanet_loss`` (1e-5, their gradients 1e-4), the anchors, the
postprocess (valid count, labels and scores equal, boxes 1e-4), the whole
``detector_loss`` and ``detector_predict``, an image with no valid gt, the
weight round trip, a JAX ``.msgpack`` resumed, the export on the CPU, and
on the card a predict against the CPU's."""

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
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.models.detection import retinanet as jax_retina
from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection import retinanet as port_retina
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.train import checkpoint as port_ckpt

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, image_size=64)
FPN = 64
# configs/retinanet.json's anchors: 3 sizes x 3 ratios a level
ANCHOR_SIZES = ((32, 40, 50), (64, 80, 101), (128, 161, 203), (256, 322, 406), (512, 645, 812))
RATIOS = ((0.5, 1.0, 2.0),) * 5
A = 9
UNIT_TOL = 1e-5
GRAD_TOL = 1e-4
DET_LOSS_RTOL = 1e-5
DET_GRAD_RTOL = 1e-3  # relative Frobenius, per leaf, through the whole detector


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _configs(image_size=64, **budget):
    vit = {**VIT, "image_size": image_size}
    common = dict(image_size=image_size, detector_kind="retinanet",
                  anchor_sizes=tuple(tuple(float(x) for x in s) for s in ANCHOR_SIZES),
                  aspect_ratios=RATIOS)
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**vit), fpn_out_channels=FPN),
        budget=JaxBudget(**budget), **common)
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**vit),
                                              fpn_out_channels=FPN),
        budget=DetectionBudget(**budget), **common)
    return jcfg, pcfg


def _jax_params(jcfg, seed=0):
    p = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree_util.tree_map(np.array, p)
    p["backbone"]["vit"]["pos_embed"] = 0.02 * np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), p["backbone"]["vit"]["pos_embed"].shape))
    # logits that spread over the thresholds: a wider final class conv and
    # a bias above the focal prior, so the postprocess has candidates
    cls = p["retinanet_head"]["cls"]["final"]
    cls["kernel"] = cls["kernel"] * 60.0
    cls["bias"] = cls["bias"] + 3.0
    return p


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = _configs()
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


def _head_inputs(rng, b=2, grids=(8, 4, 2, 1)):
    return [rng.normal(0, 1, (b, FPN, g, g)).astype(np.float32) for g in grids]


# ------------------------------------------------------------- unit pieces


def test_head_forward_matches_jax(models):
    jparams, _, _ = models
    feats = _head_inputs(np.random.default_rng(0))
    want = jax_retina.retinanet_head_forward(jparams["retinanet_head"],
                                             [jnp.asarray(f) for f in feats], A)
    params = params_from_jax(jparams)
    with torch.no_grad():
        got = port_retina.retinanet_head_forward(params["retinanet_head"],
                                                 [_t(f) for f in feats], A)
    assert got[0].shape == (2, A * (64 + 16 + 4 + 1), 6) and got[1].shape[-1] == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=UNIT_TOL, atol=UNIT_TOL)


def test_anchors_match_jax():
    for size in (64, 224):
        jcfg, pcfg = _configs(image_size=size)
        want, want_counts = jax_det._retinanet_anchors(jcfg)
        got, counts = port_det._anchors(pcfg, torch.device("cpu"))
        assert counts == want_counts
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert counts == (9 * 28 * 28, 9 * 14 * 14, 9 * 7 * 7, 9 * 4 * 4)  # 9405 at 224 px
    assert pcfg.num_anchors_per_cell == A


def test_sigmoid_focal_loss_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 4, (3, 50, 6)).astype(np.float32)
    t = (rng.uniform(size=x.shape) < 0.2).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    got = port_retina.sigmoid_focal_loss(xt, _t(t))
    want = jax_retina.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=UNIT_TOL, atol=1e-7)
    got.sum().backward()
    wgrad = jax.grad(lambda v: jax_retina.sigmoid_focal_loss(v, jnp.asarray(t)).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wgrad), rtol=GRAD_TOL, atol=1e-7)


def _loss_inputs(rng, anchors_np):
    n = anchors_np.shape[0]
    logits = rng.normal(-2, 2, (3, n, 6)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (3, n, 4)).astype(np.float32)
    gt_boxes = np.zeros((3, 4, 4), np.float32)
    gt_boxes[0, :3] = [[5, 5, 30, 40], [20, 10, 60, 50], [33, 2, 63, 20]]
    gt_boxes[1, :2] = [[10, 10, 50, 60], [2, 40, 20, 62]]
    gt_labels = np.array([[1, 3, 5, 0], [2, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    gt_valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], bool)  # image 2: no gt
    return logits, deltas, gt_boxes, gt_labels, gt_valid


def test_retinanet_loss_and_gradients_match_jax():
    _, pcfg = _configs()
    anchors, _ = port_det._anchors(pcfg, torch.device("cpu"))
    logits, deltas, gt_boxes, gt_labels, gt_valid = _loss_inputs(np.random.default_rng(2),
                                                                 anchors.numpy())
    budget = JaxBudget()

    def jloss(lg, dl):
        return jax_retina.retinanet_loss(lg, dl, jnp.asarray(anchors.numpy()),
                                         jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                                         jnp.asarray(gt_valid), budget)

    want = jloss(jnp.asarray(logits), jnp.asarray(deltas))
    lt, dt = _t(logits).requires_grad_(True), _t(deltas).requires_grad_(True)
    got = port_retina.retinanet_loss(lt, dt, anchors, _t(gt_boxes), _t(gt_labels),
                                     _t(gt_valid), DetectionBudget())
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=UNIT_TOL)
    assert float(got[1].detach()) > 0
    sum(got).backward()
    wg = jax.grad(lambda a, b: sum(jloss(a, b)), argnums=(0, 1))(jnp.asarray(logits),
                                                                 jnp.asarray(deltas))
    for g, w in zip((lt.grad, dt.grad), wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=1e-8)


def test_no_gt_image_gives_finite_losses_and_gradients(models):
    """Every image without a valid gt (ROADMAP queue 3): the matched gt is
    the anchor itself, so the losses and every gradient stay finite, the
    box loss 0, as JAX's."""
    jparams, jcfg, pcfg = models
    images, gt_boxes, gt_labels, _ = _batch()
    gt_valid = np.zeros((2, 4), bool)
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels),
                                 _t(gt_valid), pcfg, None)
    want = jax.jit(lambda p: jax_det.detector_loss(p, jax.random.PRNGKey(0), images, gt_boxes,
                                                   gt_labels, gt_valid, jcfg))(jparams)
    assert set(got) == set(want) == {"loss_classification", "loss_bbox_reg"}
    for k in want:
        assert np.isfinite(float(got[k].detach()))
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=DET_LOSS_RTOL)
    assert float(got["loss_bbox_reg"].detach()) == 0.0
    sum(got.values()).backward()
    assert all(torch.isfinite(t.grad).all() for t in tree_leaves(params) if t.grad is not None)


def test_postprocess_matches_jax():
    """Logits spread over the 0.05 threshold, so each level has fewer
    candidates than its cap at some images and more at others; boxes
    pushed past the page by the deltas get clipped."""
    _, pcfg = _configs()
    budget = dict(retinanet_topk_candidates=200, retinanet_detections_per_img=50)
    anchors, counts = port_det._anchors(pcfg, torch.device("cpu"))
    rng = np.random.default_rng(4)
    n = anchors.shape[0]
    logits = rng.normal(-4, 2.5, (3, n, 6)).astype(np.float32)
    logits[2] -= 6.0  # an image with almost no candidate
    deltas = rng.normal(0, 0.6, (3, n, 4)).astype(np.float32)
    got = port_retina.retinanet_postprocess(_t(logits), _t(deltas), anchors, counts, (64, 64),
                                            DetectionBudget(**budget))
    for i in range(3):
        want = jax_retina.retinanet_postprocess_single(
            jnp.asarray(logits[i]), jnp.asarray(deltas[i]), jnp.asarray(anchors.numpy()), counts,
            (64, 64), JaxBudget(**budget))
        v = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid[i].numpy(), v)
        np.testing.assert_array_equal(got.labels[i].numpy()[v], np.asarray(want.labels)[v])
        np.testing.assert_array_equal(got.scores[i].numpy(), np.asarray(want.scores))
        np.testing.assert_allclose(got.boxes[i].numpy()[v], np.asarray(want.boxes)[v],
                                   atol=1e-4)
    assert got.valid[0].sum() == 50 and got.valid[2].sum() < 50


# ------------------------------------------------------------ the detector


def test_params_structure_and_round_trip(models):
    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    assert set(params) == {"backbone", "retinanet_head"}
    head = params["retinanet_head"]
    assert list(head["cls"]) == ["conv1", "conv2", "conv3", "conv4", "final"]
    assert head["cls"]["final"]["weight"].shape == (A * 6, FPN, 3, 3)
    assert head["reg"]["final"]["weight"].shape == (A * 4, FPN, 3, 3)
    back = params_to_jax(params)
    flat_j, tree_j = jax.tree_util.tree_flatten(jparams)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for w, g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w)
    mine = port_det.init_detector(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [t.shape for t in tree_leaves(mine)] == [t.shape for t in tree_leaves(params)]
    prior = -np.log(99.0)
    np.testing.assert_allclose(mine["retinanet_head"]["cls"]["final"]["bias"].numpy(), prior,
                               rtol=1e-6)
    assert float(mine["retinanet_head"]["reg"]["final"]["bias"].abs().max()) == 0.0
    assert abs(float(mine["retinanet_head"]["cls"]["conv1"]["weight"].std()) - 0.01) < 1e-3


def test_detector_loss_and_gradients_match_jax(models):
    jparams, jcfg, pcfg = models
    images, gt_boxes, gt_labels, gt_valid = _batch()

    def total(p, *batch):
        d = jax_det.detector_loss(p, jax.random.PRNGKey(0), *batch, jcfg)
        return sum(d.values()), d

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jparams, images, gt_boxes, gt_labels, gt_valid)
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    assert port_det.draw_priorities(pcfg, 2, 4, torch.Generator()) is None
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                                 pcfg, None)
    assert set(got) == set(want) == {"loss_classification", "loss_bbox_reg"}
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]),
                                   rtol=DET_LOSS_RTOL, err_msg=name)
    sum(got.values()).backward()
    # p2 (level 0) feeds no head: its output conv gets no gradient, JAX's zeros
    grads = params_to_jax(tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
                                   params))
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_p = jax.tree_util.tree_leaves(grads)
    assert len(flat_j) == len(flat_p)
    for (path, w), g in zip(flat_j, flat_p):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert _rel_frob(g, w) <= DET_GRAD_RTOL, (jax.tree_util.keystr(path), _rel_frob(g, w))


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
    assert got.boxes.shape == (2, 300, 4)  # retinanet_detections_per_img
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    v = want.valid
    assert v.sum() > 20
    np.testing.assert_array_equal(got.labels.numpy()[v], want.labels[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want.boxes[v], atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-4)


def test_masks_and_modifiers_are_refused(models):
    _, _, pcfg = models
    with pytest.raises(ValueError, match="no mask branch"):
        port_det.detector_predict({}, torch.zeros(1, 3, 64, 64), pcfg, with_masks=True)
    _, base = _configs()
    import dataclasses

    for kw, match in (({"with_mask": True}, "mask branch"),
                      ({"cascade_iou_threshs": (0.5, 0.6)}, "cascade"),
                      ({"retinanet_levels": (1, 5)}, "out of range"),
                      ({"retinanet_levels": ()}, "out of range")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(base, **kw)
        with pytest.raises(ValueError, match=match):
            jax_det.DetectorConfig(detector_kind="retinanet", **kw)


def test_jax_msgpack_resumes_in_the_port(models, tmp_path):
    """JAX's ``save_checkpoint`` of the RetinaNet model with its AdamW
    state -> the port's reader: the parameters bit for bit, the moments in
    the port's leaf order, a model restored in place."""
    from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
    from layoutdit_tpu.train.trainer import make_optimizer

    from layoutdit_tpu_torch.models.model import LayoutDetectionModel

    jparams, _, pcfg = models
    tx = make_optimizer(JaxTrainingConfig(), steps_per_epoch=4)
    path = str(tmp_path / "epoch_1.msgpack")
    jax_save(path, jparams, tx.init(jparams), epoch=1, extra={"step": 3})
    state = port_ckpt.load_checkpoint(path, map_location="cpu")
    assert state["epoch"] == 1
    want = tree_leaves(params_from_jax(jparams))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]), want, strict=True))
    assert [t.shape for t in state["opt_state"]["mu"]] == [t.shape for t in want]
    shell = object.__new__(LayoutDetectionModel)
    shell.device, shell.cfg = torch.device("cpu"), pcfg
    shell.params = port_det.init_detector(pcfg, torch.Generator().manual_seed(1), device="cpu")
    shell.restore_checkpoint(path)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(shell.params), want))


def test_export_equals_live(models, predictions, tmp_path):
    from layoutdit_tpu_torch.export import ExportedDetector, export_detector

    jparams, _, pcfg = models
    images, live, _ = predictions
    export_detector(params_from_jax(jparams), pcfg, str(tmp_path), image_sizes=(64,),
                    batch_size=2, device="cpu")
    out = ExportedDetector(str(tmp_path), device="cpu").predict(_t(images),
                                                                torch.ones(2, 2) * 64)
    np.testing.assert_array_equal(out["valid"], live.valid.numpy())
    np.testing.assert_array_equal(out["labels"], live.labels.numpy())
    np.testing.assert_allclose(out["boxes"], live.boxes.numpy(), atol=1e-5)
    np.testing.assert_allclose(out["scores"], live.scores.numpy(), atol=1e-6)


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_predict_on_the_card():
    """``detector_predict`` on the card in bf16, with a tiny encoder of
    head dim 32 (the kernels take bf16 and D in 32, 64, 128): row 1 once a
    layer, the head's outputs against the CPU's plain path on the same
    weights (max |err| <= max |CPU| / 32), and detections, at score
    threshold 0, finite and inside the page."""
    import dataclasses

    from layoutdit_tpu_torch.models.backbone import backbone_forward
    from layoutdit_tpu_torch.ops import short_attention as sa

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _, cfg = _configs(**{"retinanet_score_thresh": 0.0})
    vit = dataclasses.replace(cfg.backbone.vit, num_attention_heads=2)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                              backbone=dataclasses.replace(cfg.backbone, vit=vit))
    params = port_det.init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    images = _t(np.random.default_rng(6).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))

    def heads(p, x):
        x = port_det._normalize(x, cfg).to(cfg.dtype)
        feats = backbone_forward(p["backbone"], x, cfg.backbone, compute_dtype=cfg.dtype)
        return port_det._one_stage_heads(p, feats, cfg)

    on_card = tree_map(lambda t: t.cuda(), params)
    with torch.no_grad():
        want = heads(params, images)
        sa.short_attention.launches = 0
        got = heads(on_card, images.cuda())
        assert sa.short_attention.launches == vit.num_hidden_layers
        for g, w in zip(got, want):
            tol = float(w.float().abs().max()) / 32
            assert float((g.float().cpu() - w.float()).abs().max()) <= tol
        dets = port_det.detector_predict(on_card, images.cuda(), cfg)
    v = dets.valid.cpu()
    assert v.sum() > 0
    boxes = dets.boxes.cpu()[v]
    assert torch.isfinite(boxes).all() and (boxes >= 0).all() and (boxes <= 64).all()
    assert torch.isfinite(dets.scores.cpu()).all()



# --------------------------------------------------- train, score, serve


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config

    root = str(tmp_path_factory.mktemp("one_stage_fixture"))
    make_fixture(root, n_images=8, split="samples", seed=2)
    write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)
    return root


@pytest.mark.parametrize("family", ["retinanet", "fcos"])
def test_one_stage_model_trains_scores_and_serves(family, fixture_dir, tmp_path):
    """The tiny fixture config with ``detector`` set: ``Trainer`` (no
    sampler draws, the family's loss keys), ``Evaluator.score()`` and
    ``BatchInferenceEngine``, with the family's score threshold at 0 so
    that random weights give detections (up to the family's budget a
    page)."""
    import json

    from layoutdit_tpu_torch.config import run_config_from_dict
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.train.trainer import Trainer

    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["detection_model_config"].update(
        detector=family, detection_budget={f"{family}_score_thresh": 0.0})
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["train_config"].update(tensorboard=False)
    rc = run_config_from_dict(raw)
    model = build_model(rc, device="cpu")
    assert set(model.params) == {"backbone", f"{family}_head"}
    trainer = Trainer(rc, model, device="cpu")
    state = trainer.generator.get_state()
    loss, parts = trainer.train_step(next(iter(trainer.dataloader)))
    assert torch.equal(trainer.generator.get_state(), state)  # nothing drawn
    keys = {"loss_classification", "loss_bbox_reg"} | (
        {"loss_bbox_ctrness"} if family == "fcos" else set())
    assert set(parts) == keys and np.isfinite(float(loss))
    trainer.train()
    assert len(trainer.loss_history) == 1 and np.isfinite(trainer.loss_history[0])
    metrics = Evaluator(model, rc, device="cpu").score()
    assert metrics is not None and all(np.isfinite(v) for v in metrics.values())
    engine = BatchInferenceEngine(port_det.DetectorModel(model.params, model.cfg),
                                  image_sizes=(64,), batch_size=2, score_thresh=0.0,
                                  device="cpu")
    names = sorted(os.listdir(os.path.join(fixture_dir, "samples")))[:3]
    pages = [open(os.path.join(fixture_dir, "samples", n), "rb").read() for n in names]
    per_page = 300 if family == "retinanet" else 100
    for r in engine.predict_pages(pages):
        assert 0 < len(r.boxes) <= per_page and r.masks is None
        assert (r.labels >= 1).all() and (r.labels <= 5).all()
