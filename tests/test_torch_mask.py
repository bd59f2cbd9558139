"""The port's Mask R-CNN (``models/detection/mask_head.py``, the detector's
mask branch, the segm evaluation) against the JAX package on the CPU,
float32, at ``tests/test_mask_head.py``'s tiny sizes (hidden 32, 2
layers, 64 px, FPN 32, budgets 100/50/32/10) on parameters carried with
``params_from_jax``: ``mask_head_forward`` (1e-5; the transposed conv's
weight is transposed and flipped, and a transpose alone fails the
tolerance), the projected targets (exact but where JAX's pooled value is
within 1e-6 of 0.5), ``maskrcnn_loss`` (1e-6), the whole
``detector_loss`` (losses 1e-4, gradients 1e-3), ``detector_predict``
with masks (boxes 1e-3, scores and masks 1e-4), ``CocoEvaluator("segm")``
(1e-12), ``Evaluator.score()`` with the segm metrics (1e-4), the weight
round trip and a JAX ``.msgpack`` resumed; and on the card the RoIAlign
pair at the mask path's P = 14 shapes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import LayoutDitConfig
from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
from layoutdit_tpu.eval.coco_eval import CocoEvaluator as JaxCocoEvaluator
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.models.detection import mask_head as jax_mh
from layoutdit_tpu.ops import roi_align as jax_roi
from layoutdit_tpu_torch.config import load_run_config
from layoutdit_tpu_torch.eval.coco_eval import COCO_KEYS, CocoEvaluator
from layoutdit_tpu_torch.eval.evaluator import Evaluator
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection import mask_head as port_mh
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.ops import roi_align as port_roi
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train import checkpoint as port_ckpt
from test_torch_cascade import (
    GRAD_RTOL,
    LOSS_RTOL,
    UNIT_TOL,
    _batch,
    _configs,
    _jax_params,
    _jax_priorities,
    _rel_frob,
    _t,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

HEAD_TOL = 1e-5
MASK_TOL = 1e-4
COCO_TOL = 1e-12
METRIC_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = _configs(with_mask=True)
    assert pcfg.gt_mask_size == jcfg.gt_mask_size == 32
    return _jax_params(jcfg), jcfg, pcfg


def _gt_masks(gt_boxes, gt_valid, m=32, scale=0.5):
    """A filled rectangle per gt box, with a notch cut out, at M = 32."""
    b, g = gt_valid.shape
    gm = np.zeros((b, g, m, m), np.uint8)
    for i in range(b):
        for j in range(g):
            if gt_valid[i, j]:
                x1, y1, x2, y2 = (gt_boxes[i, j] * scale).astype(int)
                gm[i, j, y1:y2, x1:x2] = 1
                gm[i, j, y1:(y1 + y2) // 2, x1:(x1 + x2) // 2] = 0
    return gm


# ------------------------------------------------------------- unit pieces


def test_mask_head_forward_matches_jax_and_needs_the_flip(models):
    jparams, _, _ = models
    head_j = jparams["mask_head"]
    head_p = params_from_jax(jparams)["mask_head"]
    rng = np.random.default_rng(0)
    pooled = rng.standard_normal((6, 32, 14, 14)).astype(np.float32)
    want = np.asarray(jax_mh.mask_head_forward(head_j, jnp.asarray(pooled)))
    got = port_mh.mask_head_forward(head_p, _t(pooled)).numpy()
    assert got.shape == want.shape == (6, 6, 28, 28)
    np.testing.assert_allclose(got, want, rtol=HEAD_TOL, atol=HEAD_TOL)
    # a carrier that only transposes the kernel is not JAX's function
    transposed = dict(head_p, deconv={
        "weight": _t(np.asarray(head_j["deconv"]["kernel"]).transpose(1, 0, 2, 3)),
        "bias": head_p["deconv"]["bias"]})
    wrong = port_mh.mask_head_forward(transposed, _t(pooled)).numpy()
    assert np.abs(wrong - want).max() > 100 * HEAD_TOL


def test_project_masks_on_boxes_matches_jax():
    rng = np.random.default_rng(1)
    b, g, k, m = 2, 3, 24, 32
    gm = (rng.uniform(size=(b, g, m, m)) < 0.5).astype(np.uint8)
    xy = rng.uniform(-6, 60, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 40, (b, k, 2))], -1).astype(np.float32)
    matched = rng.integers(0, g, (b, k))
    got = port_mh.project_masks_on_boxes(_t(gm), _t(boxes), _t(matched), 64, 28).numpy()
    for i in range(b):
        want = np.asarray(jax_mh.project_masks_on_boxes(
            jnp.asarray(gm[i]), jnp.asarray(boxes[i]), jnp.asarray(matched[i]), 64, 28))
        pooled = np.stack([np.asarray(jax_roi.roi_align(
            jnp.asarray(gm[i, matched[i, j]], jnp.float32)[None], jnp.asarray(boxes[i, j])[None],
            spatial_scale=0.5, output_size=28, sampling_ratio=1))[0, 0] for j in range(k)])
        far = np.abs(pooled - 0.5) > 1e-6
        np.testing.assert_array_equal(got[i][far], want[far])
        assert far.mean() > 0.9 and 0 < want.mean() < 1


def test_maskrcnn_loss_and_probs_match_jax():
    rng = np.random.default_rng(2)
    k, ncbg, p = 8, 6, 28
    logits = rng.normal(0, 3, (k, ncbg, p, p)).astype(np.float32)
    labels = rng.integers(1, ncbg, (k,))
    targets = (rng.uniform(size=(k, p, p)) < 0.4).astype(np.float32)
    pos = np.array([True, True, False, True, False, True, True, False])
    got = port_mh.maskrcnn_loss(_t(logits), _t(labels), _t(targets), _t(pos))
    want = jax_mh.maskrcnn_loss(jnp.asarray(logits), jnp.asarray(labels.astype(np.int32)),
                                jnp.asarray(targets), jnp.asarray(pos))
    np.testing.assert_allclose(float(got), float(want), rtol=UNIT_TOL, atol=UNIT_TOL)
    got = port_mh.mask_probs_for_labels(_t(logits), _t(labels)).numpy()
    want = np.asarray(jax_mh.mask_probs_for_labels(jnp.asarray(logits),
                                                   jnp.asarray(labels.astype(np.int32))))
    np.testing.assert_allclose(got, want, rtol=UNIT_TOL, atol=UNIT_TOL)


# ------------------------------------------------------------ the detector


def test_params_round_trip(models):
    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    assert params["mask_head"]["deconv"]["weight"].shape == (256, 256, 2, 2)
    assert list(params["mask_head"]) == ["fcn1", "fcn2", "fcn3", "fcn4", "deconv", "logits"]
    flat_j, tree_j = jax.tree_util.tree_flatten(jparams)
    flat_b, tree_b = jax.tree_util.tree_flatten(params_to_jax(params))
    assert tree_j == tree_b
    for w, g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w)
    mine = port_det.init_detector(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [t.shape for t in tree_leaves(mine)] == [t.shape for t in tree_leaves(params)]


def test_detector_loss_and_gradients_match_jax(models):
    jparams, jcfg, pcfg = models
    images, gt_boxes, gt_labels, gt_valid = _batch()
    gm = _gt_masks(gt_boxes, gt_valid)
    rng = jax.random.PRNGKey(9)

    def total(p, rng, *batch, gt_masks):
        d = jax_det.detector_loss(p, rng, *batch, jcfg, gt_masks=gt_masks)
        return sum(d.values()), d

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jparams, rng, images, gt_boxes, gt_labels, gt_valid, gt_masks=jnp.asarray(gm))
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                                 pcfg, _jax_priorities(rng, pcfg, 2, 4), gt_masks=_t(gm))
    assert set(got) == set(want) and "loss_mask" in got
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
    assert np.abs(grads["mask_head"]["deconv"]["kernel"]).max() > 0
    with pytest.raises(ValueError, match="gt_masks"):
        port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                               pcfg, _jax_priorities(rng, pcfg, 2, 4))


def test_detector_predict_with_masks_matches_jax(models):
    jparams, jcfg, pcfg = models
    images = np.random.default_rng(5).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    dets_j, probs_j = jax.jit(lambda p, x: jax_det.detector_predict(p, x, jcfg, with_masks=True))(
        jparams, images)
    dets_j, probs_j = jax.tree_util.tree_map(np.asarray, dets_j), np.asarray(probs_j)
    with torch.no_grad():
        dets, probs = port_det.detector_predict(params_from_jax(jparams), _t(images), pcfg,
                                                with_masks=True)
    v = dets_j.valid
    assert v.sum() > 0 and probs.shape == probs_j.shape == (2, 10, 28, 28)
    np.testing.assert_array_equal(dets.valid.numpy(), v)
    np.testing.assert_array_equal(dets.labels.numpy()[v], dets_j.labels[v])
    np.testing.assert_allclose(dets.boxes.numpy()[v], dets_j.boxes[v], atol=1e-3)
    np.testing.assert_allclose(dets.scores.numpy(), dets_j.scores, atol=1e-4)
    np.testing.assert_allclose(probs.numpy(), probs_j, atol=MASK_TOL)
    assert not probs.numpy()[~v].any()
    with pytest.raises(ValueError, match="with_mask"):
        port_det.detector_predict(params_from_jax(jparams), _t(images),
                                  _configs()[1], with_masks=True)


def test_jax_msgpack_of_a_mask_model_resumes(models, tmp_path):
    # flax and optax, which the card's machine may lack: imported here so
    # that this file's `cuda` tests collect there
    from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
    from layoutdit_tpu.train.trainer import make_optimizer

    jparams, _, _ = models
    tx = make_optimizer(JaxTrainingConfig(), steps_per_epoch=4)
    path = str(tmp_path / "epoch_2.msgpack")
    jax_save(path, jparams, tx.init(jparams), epoch=2)
    state = port_ckpt.load_checkpoint(path, map_location="cpu")
    want = tree_leaves(params_from_jax(jparams))
    assert state["epoch"] == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]), want, strict=True))
    assert [t.shape for t in state["opt_state"]["nu"]] == [t.shape for t in want]


# ----------------------------------------------------------- segm scoring


def _rle_string(counts) -> str:
    """pycocotools' ``rleToString``: the compressed form ``decode_compressed_rle`` reads."""
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append(chr((c | (0x20 if more else 0)) + 48))
    return "".join(out)


def _runs(mask: np.ndarray) -> list[int]:
    flat = mask.T.ravel()
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return ([0] + runs) if flat[0] else runs


def _random_segm_coco(rng, n_images=5):
    """Polygon, uncompressed and compressed RLE gt (crowds and absent
    areas among them, the last image without gt), and predictions as
    pasted windows, RLE dicts and polygons: jittered gt, duplicates and
    random ones."""
    cats = [{"id": 1, "name": "text"}, {"id": 2, "name": "table"}]
    images = [{"id": i + 1, "width": 120, "height": 90, "file_name": f"{i}.jpg"}
              for i in range(n_images)]
    anns, preds = [], []
    for img in images[:-1]:
        for _ in range(int(rng.integers(2, 6))):
            x, y = rng.uniform(0, 80), rng.uniform(0, 60)
            w, h = rng.uniform(4, 40), rng.uniform(4, 30)
            kind = rng.integers(0, 3)
            if kind == 0:
                seg = [[x, y, x + w, y, x + w * 0.7, y + h, x, y + h * 0.8]]
            else:
                m = np.zeros((90, 120), np.uint8)
                m[int(y):int(y + h), int(x):int(x + w)] = 1
                m[int(y):int(y + h / 2), int(x):int(x + w / 3)] = 0
                runs = _runs(m)
                seg = {"size": [90, 120], "counts": runs if kind == 1 else _rle_string(runs)}
            ann = {"id": len(anns) + 1, "image_id": img["id"], "category_id": int(rng.integers(1, 3)),
                   "bbox": [x, y, w, h], "segmentation": seg,
                   "iscrowd": int(rng.uniform() < 0.1)}
            if rng.uniform() < 0.5:
                ann["area"] = w * h
            anns.append(ann)
            for _ in range(int(rng.integers(0, 3))):
                dx, dy = rng.normal(0, 2, 2)
                win = np.ones((max(int(h + dy), 1), max(int(w + dx), 1)), np.uint8)
                win[: win.shape[0] // 3, : win.shape[1] // 2] = 0
                preds.append({"image_id": img["id"], "category_id": ann["category_id"],
                              "bbox": [x + dx, y + dy, w, h], "score": float(rng.uniform()),
                              "segmentation": (int(max(x + dx, 0)), int(max(y + dy, 0)), win)})
        preds.append({"image_id": img["id"], "category_id": 1, "bbox": [5.0, 5.0, 30.0, 20.0],
                      "score": round(float(rng.uniform()), 1),
                      "segmentation": [[5.0, 5.0, 35.0, 5.0, 35.0, 25.0, 5.0, 25.0]]})
    preds.append({"image_id": images[-1]["id"], "category_id": 2, "bbox": [1.0, 1.0, 9.0, 9.0],
                  "score": 0.7, "segmentation": (1, 1, np.ones((9, 9), np.uint8))})
    return {"images": images, "annotations": anns, "categories": cats}, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segm_coco_evaluator_matches_jax(seed):
    coco, preds = _random_segm_coco(np.random.default_rng(seed))
    got = CocoEvaluator(coco, "segm").evaluate(preds, per_category=True)
    want = JaxCocoEvaluator(coco, iou_type="segm").evaluate(preds, per_category=True)
    assert list(got) == list(want) and set(COCO_KEYS) <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= COCO_TOL, (k, got[k], w)
    assert got["mAP"] > 0


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """The tiny mask detector on an 8-page fixture, scored by both
    evaluators on the same weights (random position embeddings and a
    wider box-predictor and mask-logit scale, so no score or mask pixel
    sits at float32 rounding of a decision)."""
    from layoutdit_tpu.eval.evaluator import Evaluator as JaxEvaluator
    from layoutdit_tpu.models.model import build_model as jax_build_model

    root = str(tmp_path_factory.mktemp("mask_eval"))
    make_fixture(root, n_images=8, split="samples", seed=5)
    path = write_fixture_config(root, epochs=1, batch_size=3, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"]["with_mask"] = True
    raw["eval_config"].update(num_images=2, max_per_image=4)
    runs = {}
    for side in ("jax", "port"):
        raw["eval_config"]["eval_base_path"] = os.path.join(root, side)
        with open(path, "w") as f:
            json.dump(raw, f)
        runs[side] = path if side == "port" else LayoutDitConfig(**raw)
    rc = load_run_config(runs["port"])
    jmodel = jax_build_model(runs["jax"], seed=0, warm_start=False)
    gen = np.random.default_rng(0)
    p = jmodel.params
    vit = p["backbone"]["vit"]
    vit["pos_embed"] = jnp.asarray(gen.normal(0, 0.02, vit["pos_embed"].shape), np.float32)
    cls = p["box_predictor"]["cls"]
    cls["kernel"] = jnp.asarray(gen.normal(0, 0.1, cls["kernel"].shape), np.float32)
    lg = p["mask_head"]["logits"]
    lg["kernel"] = jnp.asarray(gen.normal(0, 0.5, lg["kernel"].shape), np.float32)
    pmodel = build_model(rc, device="cpu")
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    with torch.no_grad():
        for dst, src in zip(tree_leaves(pmodel.params), tree_leaves(carried), strict=True):
            dst.copy_(src)
    want = JaxEvaluator(model=jmodel, layout_dit_config=runs["jax"]).score()
    evaluator = Evaluator(pmodel, rc, device="cpu")
    got = evaluator.score()
    return {"got": got, "want": want, "evaluator": evaluator,
            "jax_dir": os.path.join(root, "jax", "fixture"),
            "port_dir": os.path.join(root, "port", "fixture")}


def test_evaluator_score_with_segm_matches_jax(scored):
    got, want = scored["got"], scored["want"]
    assert {f"segm_{k}" for k in COCO_KEYS} <= set(got)
    assert list(got) == list(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= METRIC_TOL, (k, got[k], w)
    assert scored["evaluator"].paste_seconds > 0
    with open(os.path.join(scored["port_dir"], "predictions.json")) as f:
        mine = json.load(f)
    with open(os.path.join(scored["jax_dir"], "predictions.json")) as f:
        theirs = json.load(f)
    assert len(mine) == len(theirs) > 0
    seg = mine[0]["segmentation"]  # COCO uncompressed RLE over the page
    assert set(seg) == {"size", "counts"} and sum(seg["counts"]) == seg["size"][0] * seg["size"][1]


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(16, 128), (4, 100)])  # training's positives; predict's D
def test_roi_kernels_at_the_mask_shapes(cuda, b, k):
    """Rows 7-8 at P = 14 on a 224 px pyramid (C = 256, channels-last),
    with about half the slots invalid (level -1), against their plain
    versions."""
    gen = torch.Generator().manual_seed(k)
    feats = [torch.randn(b, 256, s, s, generator=gen).bfloat16() for s in (56, 28, 14, 7, 4)]
    xy = torch.rand(b, k, 2, generator=gen) * 200
    rois = torch.cat([xy, xy + 4 + torch.rand(b, k, 2, generator=gen) * 150], -1)
    valid = torch.rand(b, k, generator=gen) < 0.5
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
    levels = port_roi.roi_levels(rois, 5, 224.0, 4, valid)
    want = port_roi.roi_align_plain(feats, rois, levels, scales, 14, 2)
    feats_c = [f.to(cuda).contiguous(memory_format=torch.channels_last) for f in feats]
    got = port_roi.roi_align_fwd(feats_c, rois.to(cuda), levels.to(cuda), scales, 14, 2)
    assert float((got.cpu().float() - want.float()).abs().max()) <= (
        float(want.float().abs().max()) / 64)
    assert not got[~valid.to(cuda)].any()
    dout = torch.randn(want.shape, generator=gen).bfloat16()
    want_d = port_roi.roi_align_bwd_plain(dout, rois, levels, feats, scales, 14, 2)
    got_d = port_roi.roi_align_bwd(dout.to(cuda), rois.to(cuda), levels.to(cuda), feats_c,
                                   scales, 14, 2)
    for g, w in zip(got_d, want_d):
        assert float((g.cpu().float() - w.float()).abs().max()) <= max(
            float(w.float().abs().max()) / 64, 1e-4)
