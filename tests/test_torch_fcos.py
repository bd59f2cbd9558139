"""The port's FCOS (``models/detection/fcos.py`` and the detector's
``fcos`` path) against the JAX package on the CPU, float32, on the tiny
detector of ``tests/test_torch_train.py`` (hidden 64, 2 layers, 64 px;
FPN 64, so GroupNorm's 32 groups hold 2 channels each), on parameters
carried with ``params_from_jax``: GroupNorm and the head (outputs and
their flatten order, 1e-5), the reference points' strides at 224 and 64
px, the matcher (indices equal, an area tie under 8 px^2 among them), the
linear coder and GIoU (1e-6), ``fcos_loss`` (1e-5, its gradients 1e-4),
the postprocess (valid count, labels and scores equal, boxes 1e-4), the
whole ``detector_loss`` and ``detector_predict``, an image with no valid
gt, the weight round trip, a JAX ``.msgpack`` resumed, the export on the
CPU, and on the card a predict against the CPU's."""

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
from layoutdit_tpu.models.detection import fcos as jax_fcos
from layoutdit_tpu.ops import boxes as jax_boxes
from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection import fcos as port_fcos
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.ops import boxes as port_boxes
from layoutdit_tpu_torch.train import checkpoint as port_ckpt

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, image_size=64)
FPN = 64
UNIT_TOL = 1e-5
BOX_TOL = 1e-6
GRAD_TOL = 1e-4
DET_LOSS_RTOL = 1e-5
DET_GRAD_RTOL = 1e-3  # relative Frobenius, per leaf, through the whole detector


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _configs(image_size=64, **budget):
    vit = {**VIT, "image_size": image_size}
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**vit), fpn_out_channels=FPN),
        budget=JaxBudget(**budget), image_size=image_size, detector_kind="fcos")
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**vit),
                                              fpn_out_channels=FPN),
        budget=DetectionBudget(**budget), image_size=image_size, detector_kind="fcos")
    return jcfg, pcfg


def _jax_params(jcfg, seed=0, spread=True):
    p = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree_util.tree_map(np.array, p)
    p["backbone"]["vit"]["pos_embed"] = 0.02 * np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), p["backbone"]["vit"]["pos_embed"].shape))
    rng = np.random.default_rng(9)
    head = p["fcos_head"]
    for tower in ("cls_tower", "reg_tower"):  # GroupNorm affines away from (1, 0)
        for conv in head[tower].values():
            conv["gn_scale"] = rng.uniform(0.5, 1.5, conv["gn_scale"].shape).astype(np.float32)
            conv["gn_bias"] = rng.normal(0, 0.2, conv["gn_bias"].shape).astype(np.float32)
    if not spread:
        return p
    # scores that spread over the 0.2 threshold: wider class and
    # center-ness convs and the class bias above the focal prior
    head["cls_logits"]["kernel"] = head["cls_logits"]["kernel"] * 60.0
    head["cls_logits"]["bias"] = head["cls_logits"]["bias"] + 3.0
    head["ctrness"]["kernel"] = head["ctrness"]["kernel"] * 60.0
    head["bbox_reg"]["bias"] = head["bbox_reg"]["bias"] + 1.0
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


def _boxes(rng, n, size=64.0, lo=1.0, hi=None):
    xy = rng.uniform(-4, size, (n, 2))
    wh = rng.uniform(lo, hi or size / 1.5, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------- unit pieces


def test_group_norm_and_head_match_jax():
    """At the init's output convs (std 0.01)."""
    jparams = _jax_params(_configs()[0], spread=False)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, FPN, 5, 7)).astype(np.float32)
    conv = jparams["fcos_head"]["cls_tower"]["conv1"]
    want = jax_fcos._group_norm(jnp.asarray(x), jnp.asarray(conv["gn_scale"]),
                                jnp.asarray(conv["gn_bias"]))
    got = port_fcos.group_norm(_t(x), _t(conv["gn_scale"]), _t(conv["gn_bias"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=UNIT_TOL, atol=UNIT_TOL)
    # bf16 in, bf16 out, statistics in float32
    assert port_fcos.group_norm(_t(x).bfloat16(), _t(conv["gn_scale"]),
                                _t(conv["gn_bias"])).dtype == torch.bfloat16

    feats = [rng.normal(0, 1, (2, FPN, g, g)).astype(np.float32) for g in (8, 4, 2, 1)]
    want = jax_fcos.fcos_head_forward(jparams["fcos_head"], [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port_fcos.fcos_head_forward(params_from_jax(jparams)["fcos_head"],
                                          [_t(f) for f in feats])
    assert got[0].shape == (2, 85, 6) and got[1].shape == (2, 85, 4) and got[2].shape == (2, 85)
    assert float(got[1].min()) >= 0  # ReLU'd distances
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=UNIT_TOL, atol=UNIT_TOL)


def test_strides_and_anchors_match_jax():
    """The stride of a level is ``image_size // grid``: 56 for the pool
    level at 224 px (not 64), 64 at 64 px."""
    for size, strides in ((224, (8, 16, 32, 56)), (64, (8, 16, 32, 64))):
        jcfg, pcfg = _configs(image_size=size)
        want, want_counts = jax_det._fcos_anchors(jcfg)
        got, counts = port_det._anchors(pcfg, torch.device("cpu"))
        assert counts == want_counts
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        starts = np.cumsum((0,) + counts[:-1])
        assert tuple(int(got[s, 2] - got[s, 0]) for s in starts) == strides


def test_linear_coder_and_giou_match_jax():
    rng = np.random.default_rng(1)
    ref = _boxes(rng, 200)
    tgt = _boxes(rng, 200)
    tgt[:5] = ref[:5]  # identical pairs
    tgt[5:10, 2:] = tgt[5:10, :2]  # empty targets
    tgt[10:15] = tgt[10:15] + 200  # disjoint
    for fn_p, fn_j in ((port_boxes.encode_boxes_linear, jax_boxes.encode_boxes_linear),
                       (port_boxes.generalized_box_iou, jax_boxes.generalized_box_iou)):
        got = fn_p(_t(ref), _t(tgt)).numpy()
        want = np.asarray(fn_j(jnp.asarray(ref), jnp.asarray(tgt)))
        np.testing.assert_allclose(got, want, rtol=BOX_TOL, atol=BOX_TOL)
    codes = rng.uniform(0, 3, (200, 4)).astype(np.float32)
    for norm in (True, False):
        got = port_boxes.decode_boxes_linear(_t(codes), _t(ref), normalize_by_size=norm).numpy()
        want = np.asarray(jax_boxes.decode_boxes_linear(jnp.asarray(codes), jnp.asarray(ref),
                                                        normalize_by_size=norm))
        np.testing.assert_allclose(got, want, rtol=BOX_TOL, atol=BOX_TOL)


def test_match_matches_jax_with_an_area_tie():
    """Random gts over every level, and a cell inside two gts of areas 100
    and 96: in float32, 1e8 - 100 and 1e8 - 96 round to the same value, so
    the tie goes to the lower index (the LARGER gt), as in JAX."""
    _, pcfg = _configs()
    anchors, counts = port_det._anchors(pcfg, torch.device("cpu"))
    rng = np.random.default_rng(2)
    b, g = 4, 12
    gt = np.stack([_boxes(rng, g, lo=2.0, hi=60.0) for _ in range(b)])
    gt[0, 0] = [11, 11, 21, 21]  # area 100, center (16, 16)
    gt[0, 1] = [12, 10, 20, 22]  # area 96, the same center
    gt_valid = rng.uniform(size=(b, g)) < 0.8
    gt_valid[0, :2] = True
    gt_valid[3] = False
    got = port_fcos.fcos_match(anchors, counts, _t(gt), _t(gt_valid), 1.5)
    for i in range(b):
        want = jax_fcos.fcos_match_single(jnp.asarray(anchors.numpy()), counts,
                                          jnp.asarray(gt[i]), jnp.asarray(gt_valid[i]), 1.5)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    cell = int(np.nonzero((anchors.numpy() == [12, 12, 20, 20]).all(1))[0][0])  # center (16, 16)
    assert int(got[0, cell]) == 0  # float32 tie: the lower index, not the smaller area
    assert (got[:3] >= 0).sum() > 10 and not (got[3] >= 0).any()


def _loss_inputs(rng, n):
    logits = rng.normal(-2, 2, (3, n, 6)).astype(np.float32)
    ltrb = rng.uniform(0, 2, (3, n, 4)).astype(np.float32)
    ctr = rng.normal(0, 1, (3, n)).astype(np.float32)
    gt_boxes = np.zeros((3, 4, 4), np.float32)
    gt_boxes[0, :3] = [[5, 5, 30, 40], [20, 10, 60, 50], [33, 2, 63, 20]]
    gt_boxes[1, :2] = [[10, 10, 50, 60], [2, 40, 20, 62]]
    gt_labels = np.array([[1, 3, 5, 0], [2, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    gt_valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], bool)  # image 2: no gt
    return logits, ltrb, ctr, gt_boxes, gt_labels, gt_valid


def test_fcos_loss_and_gradients_match_jax():
    _, pcfg = _configs()
    anchors, counts = port_det._anchors(pcfg, torch.device("cpu"))
    logits, ltrb, ctr, gt_boxes, gt_labels, gt_valid = _loss_inputs(np.random.default_rng(4),
                                                                    anchors.shape[0])

    def jloss(lg, lt, ct):
        return jax_fcos.fcos_loss(lg, lt, ct, jnp.asarray(anchors.numpy()), counts,
                                  jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                                  jnp.asarray(gt_valid), JaxBudget())

    want = jloss(jnp.asarray(logits), jnp.asarray(ltrb), jnp.asarray(ctr))
    ins = [_t(x).requires_grad_(True) for x in (logits, ltrb, ctr)]
    got = port_fcos.fcos_loss(*ins, anchors, counts, _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                              DetectionBudget())
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=UNIT_TOL)
    assert all(float(g.detach()) > 0 for g in got)
    sum(got).backward()
    wg = jax.grad(lambda *a: sum(jloss(*a)), argnums=(0, 1, 2))(
        jnp.asarray(logits), jnp.asarray(ltrb), jnp.asarray(ctr))
    for g, w in zip(ins, wg):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=1e-8)


def test_no_gt_image_gives_finite_losses_and_gradients(models):
    """No image with a valid gt (ROADMAP queue 3): every target box is the
    cell's own square, so the three losses and every gradient stay finite,
    the box and center-ness losses 0, as JAX's."""
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
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(float(got[k].detach()))
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=DET_LOSS_RTOL)
    assert float(got["loss_bbox_reg"].detach()) == float(got["loss_bbox_ctrness"].detach()) == 0
    sum(got.values()).backward()
    assert all(torch.isfinite(t.grad).all() for t in tree_leaves(params) if t.grad is not None)


def test_postprocess_matches_jax():
    _, pcfg = _configs()
    budget = dict(fcos_topk_candidates=150, fcos_detections_per_img=40)
    anchors, counts = port_det._anchors(pcfg, torch.device("cpu"))
    rng = np.random.default_rng(5)
    n = anchors.shape[0]
    logits = rng.normal(-1, 2.5, (3, n, 6)).astype(np.float32)
    logits[2] -= 8.0  # an image with almost no candidate
    ltrb = rng.uniform(0, 2.5, (3, n, 4)).astype(np.float32)
    ctr = rng.normal(0, 2, (3, n)).astype(np.float32)
    got = port_fcos.fcos_postprocess(_t(logits), _t(ltrb), _t(ctr), anchors, counts, (64, 64),
                                     DetectionBudget(**budget))
    for i in range(3):
        want = jax_fcos.fcos_postprocess_single(
            jnp.asarray(logits[i]), jnp.asarray(ltrb[i]), jnp.asarray(ctr[i]),
            jnp.asarray(anchors.numpy()), counts, (64, 64), JaxBudget(**budget))
        v = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid[i].numpy(), v)
        np.testing.assert_array_equal(got.labels[i].numpy()[v], np.asarray(want.labels)[v])
        np.testing.assert_array_equal(got.scores[i].numpy(), np.asarray(want.scores))
        np.testing.assert_allclose(got.boxes[i].numpy()[v], np.asarray(want.boxes)[v],
                                   atol=1e-4)
    assert got.valid[0].sum() == 40 and got.valid[2].sum() < 40


# ------------------------------------------------------------ the detector


def test_params_structure_and_round_trip(models):
    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    assert set(params) == {"backbone", "fcos_head"}
    head = params["fcos_head"]
    assert list(head) == ["cls_tower", "reg_tower", "cls_logits", "bbox_reg", "ctrness"]
    assert list(head["reg_tower"]["conv4"]) == ["weight", "bias", "gn_scale", "gn_bias"]
    assert head["cls_logits"]["weight"].shape == (6, FPN, 3, 3)
    assert head["ctrness"]["weight"].shape == (1, FPN, 3, 3)
    back = params_to_jax(params)
    flat_j, tree_j = jax.tree_util.tree_flatten(jparams)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for w, g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w)
    mine = port_det.init_detector(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [t.shape for t in tree_leaves(mine)] == [t.shape for t in tree_leaves(params)]
    np.testing.assert_allclose(mine["fcos_head"]["cls_logits"]["bias"].numpy(), -np.log(99.0),
                               rtol=1e-6)
    assert float(mine["fcos_head"]["cls_tower"]["conv1"]["gn_scale"].min()) == 1.0


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
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                                 pcfg, None)
    assert set(got) == set(want) == {"loss_classification", "loss_bbox_reg",
                                     "loss_bbox_ctrness"}
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
    assert got.boxes.shape == (2, 100, 4)  # fcos_detections_per_img
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    v = want.valid
    assert v.sum() > 20
    np.testing.assert_array_equal(got.labels.numpy()[v], want.labels[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want.boxes[v], atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-4)


def test_jax_msgpack_resumes_in_the_port(models, tmp_path):
    """JAX's ``save_checkpoint`` of the FCOS model with its AdamW state ->
    the port's reader: the parameters bit for bit (the GroupNorm affines
    among them), the moments in the port's leaf order, a model restored
    in place."""
    from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
    from layoutdit_tpu.train.trainer import make_optimizer

    from layoutdit_tpu_torch.models.model import LayoutDetectionModel

    jparams, _, pcfg = models
    tx = make_optimizer(JaxTrainingConfig(), steps_per_epoch=4)
    path = str(tmp_path / "epoch_1.msgpack")
    jax_save(path, jparams, tx.init(jparams), epoch=1, extra={"step": 3})
    state = port_ckpt.load_checkpoint(path, map_location="cpu")
    want = tree_leaves(params_from_jax(jparams))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]), want, strict=True))
    assert [t.shape for t in state["opt_state"]["nu"]] == [t.shape for t in want]
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
    _, cfg = _configs(**{"fcos_score_thresh": 0.0})
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
