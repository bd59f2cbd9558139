"""The port's DETR (``models/detection/detr.py`` and the detector's
``detr`` path) against the JAX package on the CPU, float32, at JAX's tiny
DETR (``tests/test_detr.py``: hidden 32, 2 layers, 64 px, FPN 32; 16
queries, 2 decoder layers, d 32, 4 heads, FFN 64), on parameters carried
with ``params_from_jax``: the sine embedding (1e-6), the attention and the
decoder (1e-5), the matcher's cost (1e-6) and its assignment (exact), the
losses with JAX's assignment passed in (1e-6) and whole (1e-5, aux on and
off, shared matching), ``detector_loss`` (1e-5, every gradient leaf 1e-3
relative Frobenius), ``detector_predict``, a batch with no gt, the init's
distributions, the weight round trip, a JAX ``.msgpack`` resumed, the
refusals, the export, ``Trainer`` / ``score()`` / the engine on the CPU,
and on the card a predict and a step."""

import dataclasses
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
from layoutdit_tpu.models.detection import detr as jax_detr
from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection import detr as port_detr
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
    tree_paths,
)
from layoutdit_tpu_torch.ops import matching
from layoutdit_tpu_torch.train import checkpoint as port_ckpt

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=64, image_size=64)
FPN = 32
DETR = dict(detr_num_queries=16, detr_layers=2, detr_dim=32, detr_heads=4, detr_ffn_dim=64)
HEADS = DETR["detr_heads"]
EMBED_TOL = 1e-6
UNIT_TOL = 1e-5
COST_TOL = 1e-6
LEVEL_LOSS_TOL = 1e-6
LOSS_RTOL = 1e-5
DET_GRAD_RTOL = 1e-3  # relative Frobenius, per leaf, through the whole detector
# the postprocess's scores: XLA's and torch's exp differ by an ulp
SCORE_TOL = 1e-6
BOX_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _configs(vit=VIT, **kw):
    kw = {**DETR, **kw}
    common = dict(image_size=vit["image_size"], detector_kind="detr", **kw)
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**vit), fpn_out_channels=FPN),
        budget=JaxBudget(), **common)
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**vit),
                                              fpn_out_channels=FPN),
        budget=DetectionBudget(), **common)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = _configs()
    p = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(np.array, p), jcfg, pcfg


def _batch():
    """JAX's tiny batch (``tests/test_detr.py::_tiny_batch``) with a third
    slot of padding in both images."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    gt_boxes = np.array([[[5, 5, 30, 40], [20, 10, 60, 50], [0, 0, 0, 0]],
                         [[10, 10, 50, 60], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    gt_labels = np.array([[1, 3, 0], [2, 0, 0]], np.int32)
    gt_valid = np.array([[True, True, False], [True, False, False]])
    return images, gt_boxes, gt_labels, gt_valid


def _head_outputs(rng, n_l=2, b=2, q=16):
    logits = rng.normal(0, 2, (n_l, b, q, 6)).astype(np.float32)
    boxes = rng.uniform(0.05, 0.95, (n_l, b, q, 4)).astype(np.float32)
    return logits, boxes


def _gt01(gt_boxes, gt_valid, size=64):
    gt01 = np.asarray(jax_detr._xyxy_to_cxcywh(jnp.asarray(gt_boxes))) / size
    return np.where(gt_valid[..., None], gt01, 0.0).astype(np.float32)


# ------------------------------------------------------------- unit pieces


@pytest.mark.parametrize("h,w,d", [(4, 4, 32), (5, 7, 32), (14, 14, 256), (64, 64, 256)])
def test_sine_position_embedding_matches_jax(h, w, d):
    got = port_detr.sine_position_embedding(h, w, d)
    assert got.shape == (h * w, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_detr.sine_position_embedding(h, w, d)),
                               atol=EMBED_TOL, rtol=0)


@pytest.mark.parametrize("attn", ["self_attn", "cross_attn"])
def test_attention_matches_jax(models, attn):
    jparams, _, _ = models
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 16, 32)).astype(np.float32)
    kv = rng.normal(0, 1, (2, 20, 32)).astype(np.float32)
    jp = jparams["detr"]["decoder"]["layer1"][attn]
    want = jax_detr._attention(jp, jnp.asarray(q), jnp.asarray(kv) + 1.0, jnp.asarray(kv), HEADS)
    pp = params_from_jax(jparams)["detr"]["decoder"][1][attn]
    got = port_detr._attention(pp, _t(q), _t(kv) + 1.0, _t(kv), HEADS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=UNIT_TOL, rtol=UNIT_TOL)


@pytest.mark.parametrize("intermediate", [True, False])
def test_detr_forward_matches_jax(models, intermediate):
    jparams, _, _ = models
    feat = np.random.default_rng(2).normal(0, 1, (2, FPN, 4, 5)).astype(np.float32)
    wl, wb = jax_detr.detr_forward(jparams["detr"], jnp.asarray(feat), HEADS,
                                   return_intermediate=intermediate)
    with torch.no_grad():
        gl, gb = port_detr.detr_forward(params_from_jax(jparams)["detr"], _t(feat), HEADS,
                                        return_intermediate=intermediate)
    n_l = 2 if intermediate else 1
    assert gl.shape == (n_l, 2, 16, 6) and gb.shape == (n_l, 2, 16, 4)
    assert gl.dtype == gb.dtype == torch.float32
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=UNIT_TOL, rtol=UNIT_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=UNIT_TOL, rtol=UNIT_TOL)


def _jax_costs_and_matches(monkeypatch, logits, boxes, gt01, gt_labels, gt_valid):
    """JAX's ``_match_single`` per (layer, image), the cost it hands its
    solver captured: -> (costs [L*B, G, Q], matches [L*B, G])."""
    costs = []
    solve = jax_detr.linear_sum_assignment

    def capture(cost):
        costs.append(np.asarray(cost))
        return solve(cost)

    monkeypatch.setattr(jax_detr, "linear_sum_assignment", capture)
    matches = [np.asarray(jax_detr._match_single(
        jnp.asarray(logits[i, j]), jnp.asarray(boxes[i, j]), jnp.asarray(gt01[j]),
        jnp.asarray(gt_labels[j]), jnp.asarray(gt_valid[j])))
        for i in range(logits.shape[0]) for j in range(logits.shape[1])]
    return np.stack(costs), np.stack(matches)


def test_match_cost_and_assignment_match_jax(monkeypatch):
    """The batched cost equals JAX's per-image one (padded rows 0), and the
    one matcher call over the stacked [L*B] problems gives JAX's indices."""
    _, gt_boxes, gt_labels, gt_valid = _batch()
    logits, boxes = _head_outputs(np.random.default_rng(3))
    gt01 = _gt01(gt_boxes, gt_valid)
    want_cost, want_match = _jax_costs_and_matches(monkeypatch, logits, boxes, gt01, gt_labels,
                                                   gt_valid)
    rep = (2, 1, 1)
    got_cost = port_detr.match_cost(_t(logits).reshape(4, 16, 6), _t(boxes).reshape(4, 16, 4),
                                    _t(gt01).repeat(rep), _t(gt_labels).repeat(rep[:2]),
                                    _t(gt_valid).repeat(rep[:2]))
    assert got_cost.shape == (4, 3, 16)
    np.testing.assert_allclose(got_cost.numpy(), want_cost, atol=COST_TOL, rtol=COST_TOL)
    assert not got_cost[:, 2].any() and not got_cost[1::2, 1].any()  # padded rows
    got = port_detr.detr_match(_t(logits), _t(boxes), _t(gt01), _t(gt_labels), _t(gt_valid))
    np.testing.assert_array_equal(got.reshape(4, 3).numpy(), want_match)
    np.testing.assert_array_equal(matching.linear_sum_assignment(_t(want_cost)).numpy(),
                                  want_match)


def test_loss_one_level_matches_jax_with_its_match():
    _, gt_boxes, gt_labels, gt_valid = _batch()
    logits, boxes = _head_outputs(np.random.default_rng(4), n_l=1)
    gt01 = _gt01(gt_boxes, gt_valid)
    match = np.array([[3, 7, 11], [0, 5, 9]], np.int32)
    num = np.float32(3.0)
    want = jax_detr.detr_loss_one_level(jnp.asarray(logits[0]), jnp.asarray(boxes[0]),
                                        jnp.asarray(gt01), jnp.asarray(gt_labels),
                                        jnp.asarray(gt_valid), jnp.asarray(num), 0.1,
                                        match=jnp.asarray(match))
    got = port_detr.detr_loss_one_level(_t(logits[0]), _t(boxes[0]), _t(gt01), _t(gt_labels),
                                        _t(gt_valid), torch.tensor(num), 0.1, _t(match))
    assert set(got) == set(want) == {"loss_ce", "loss_bbox", "loss_giou"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LEVEL_LOSS_TOL, err_msg=k)


@pytest.mark.parametrize("aux,shared", [(True, False), (False, False), (True, True)])
def test_detr_loss_and_its_gradients_match_jax(aux, shared):
    images, gt_boxes, gt_labels, gt_valid = _batch()
    logits, boxes = _head_outputs(np.random.default_rng(5), n_l=2 if aux else 1)

    def jloss(lg, bx):
        return jax_detr.detr_loss(lg, bx, jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                                  jnp.asarray(gt_valid), 64, 0.1, aux, shared_matching=shared)

    want = jloss(jnp.asarray(logits), jnp.asarray(boxes))
    lt, bt = _t(logits).requires_grad_(True), _t(boxes).requires_grad_(True)
    before = matching.linear_sum_assignment.launches
    got = port_detr.detr_loss(lt, bt, _t(gt_boxes), _t(gt_labels), _t(gt_valid), 64, 0.1, aux,
                              shared_matching=shared)
    assert matching.linear_sum_assignment.launches == before  # the CPU: no kernel
    keys = {"loss_ce", "loss_bbox", "loss_giou"}
    assert set(got) == set(want) == keys | ({f"{k}_aux0" for k in keys} if aux else set())
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    sum(got.values()).backward()
    wg = jax.grad(lambda a, b: sum(jloss(a, b).values()), argnums=(0, 1))(jnp.asarray(logits),
                                                                          jnp.asarray(boxes))
    for g, w in zip((lt.grad, bt.grad), wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (3, 50, 6)).astype(np.float32)
    boxes = rng.uniform(0, 1, (3, 50, 4)).astype(np.float32)
    boxes[0, :5, 2:] = 0.9  # boxes over the page's edge: clipped
    want = jax_detr.detr_postprocess(jnp.asarray(logits), jnp.asarray(boxes), 64, 0.3)
    got = port_detr.detr_postprocess(_t(logits), _t(boxes), 64, 0.3)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=SCORE_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=BOX_TOL, rtol=0)
    assert 0 < got.valid.sum() < got.valid.numel()
    assert (got.scores[:, :-1] >= got.scores[:, 1:]).all()  # sorted


# ------------------------------------------------------------ the detector


def test_init_distributions():
    """xavier-uniform matrices (within the bound, its std), normal(0, 1)
    query embeddings, zero biases, LayerNorms at one and zero, the tree of
    JAX's init."""
    jcfg, pcfg = _configs(detr_dim=64, detr_heads=8, detr_num_queries=100, detr_ffn_dim=256)
    mine = port_det.init_detector(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(mine) == {"backbone", "detr"}
    want = jax.eval_shape(lambda k: jax_det.init_detector_params(k, jcfg), jax.random.PRNGKey(0))
    got = params_to_jax(mine)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
    head = mine["detr"]
    for path, t in zip(tree_paths(head), tree_leaves(head)):
        if path == "query_embed":
            assert abs(float(t.mean())) < 0.05 and abs(float(t.std()) - 1.0) < 0.05
        elif path.endswith("bias"):
            assert float(t.abs().max()) == 0.0, path
        elif "ln" in path or "decoder_norm" in path:
            assert float((t - 1.0).abs().max()) == 0.0, path
        else:
            bound = (6.0 / sum(t.shape)) ** 0.5
            assert float(t.abs().max()) <= bound, path
            assert abs(float(t.std()) / (bound / 3 ** 0.5) - 1.0) < 0.1, path


def test_params_round_trip(models):
    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    assert set(params) == {"backbone", "detr"}
    head = params["detr"]
    assert len(head["decoder"]) == 2
    assert head["decoder"][0]["self_attn"]["in_proj"]["weight"].shape == (96, 32)
    assert head["proj"]["weight"].shape == (32, FPN) and head["query_embed"].shape == (16, 32)
    np.testing.assert_array_equal(head["decoder"][1]["ffn1"]["weight"].numpy(),
                                  jparams["detr"]["decoder"]["layer1"]["ffn1"]["kernel"].T)
    back = params_to_jax(params)
    flat_j, tree_j = jax.tree_util.tree_flatten(jparams)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for w, g in zip(flat_j, flat_b):
        np.testing.assert_array_equal(g, w)
    mine = port_det.init_detector(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [t.shape for t in tree_leaves(mine)] == [t.shape for t in tree_leaves(params)]


def test_params_for_inference_keep_the_layer_norms_in_fp32(models):
    jparams, _, _ = models
    cast = port_det.params_for_inference(params_from_jax(jparams), torch.bfloat16)["detr"]
    layer = cast["decoder"][0]
    assert all(layer[n]["weight"].dtype == torch.float32 for n in ("ln1", "ln2", "ln3"))
    assert cast["decoder_norm"]["weight"].dtype == torch.float32
    assert layer["ffn1"]["weight"].dtype == cast["query_embed"].dtype == torch.bfloat16


def test_detector_loss_and_gradients_match_jax(models):
    jparams, jcfg, pcfg = models
    images, gt_boxes, gt_labels, gt_valid = _batch()

    def total(p, *batch):
        d = jax_det.detector_loss(p, jax.random.PRNGKey(1), *batch, jcfg)
        return sum(d.values()), d

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jparams, images, gt_boxes, gt_labels, gt_valid)
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    assert port_det.draw_priorities(pcfg, 2, 3, torch.Generator()) is None
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                                 pcfg, None)
    keys = {"loss_ce", "loss_bbox", "loss_giou"}
    assert set(got) == set(want) == keys | {f"{k}_aux0" for k in keys}
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=LOSS_RTOL,
                                   err_msg=name)
    sum(got.values()).backward()
    # the FPN levels the decoder never reads get no gradient: JAX's zeros
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
    images = np.random.default_rng(7).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_det.detector_predict(p, x, jcfg))(jparams, images)
    with torch.no_grad():
        got = port_det.detector_predict(params_from_jax(jparams), _t(images), pcfg)
    return images, got, jax.tree_util.tree_map(np.asarray, want)


def test_detector_predict_matches_jax(predictions):
    _, got, want = predictions
    assert got.boxes.shape == (2, 16, 4)  # one detection a query
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert want.valid.all()  # detr_score_thresh 0
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, atol=BOX_TOL, rtol=0)


def test_no_gt_batch_stays_finite(models):
    """No valid gt anywhere: every query's target is "no object", the box
    losses 0 (divided by the floor of 1), every gradient finite, as JAX's."""
    jparams, jcfg, pcfg = models
    images, gt_boxes, gt_labels, _ = _batch()
    gt_valid = np.zeros((2, 3), bool)
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                                 pcfg, None)
    want = jax.jit(lambda p: jax_det.detector_loss(p, jax.random.PRNGKey(0), images, gt_boxes,
                                                   gt_labels, gt_valid, jcfg))(jparams)
    for k in want:
        assert np.isfinite(float(got[k].detach()))
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert float(got["loss_bbox"].detach()) == float(got["loss_giou"].detach()) == 0.0
    sum(got.values()).backward()
    assert all(torch.isfinite(t.grad).all() for t in tree_leaves(params) if t.grad is not None)


@pytest.mark.parametrize("change,match", [
    (dict(with_mask=True), "mask branch"),
    (dict(cascade_iou_threshs=(0.5, 0.6)), "cascade"),
    (dict(detr_level=5), "detr_level 5 out of range"),
    (dict(detr_level=-1), "out of range"),
    (dict(detr_dim=30), "divide by detr_heads"),
])
def test_config_refusals(change, match):
    _, base = _configs()
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(base, **change)
    with pytest.raises(ValueError, match=match):
        _configs(**change)


def test_more_gt_slots_than_queries_is_refused(models):
    _, jcfg, pcfg = models
    images = np.zeros((1, 3, 64, 64), np.float32)
    gt = np.zeros((1, 17, 4), np.float32)
    args = (gt, np.zeros((1, 17), np.int32), np.zeros((1, 17), bool))
    with pytest.raises(ValueError, match="max_gt_boxes 17 exceeds detr_num_queries 16"):
        port_det.detector_loss({}, _t(images), *map(_t, args), pcfg, None)
    with pytest.raises(ValueError, match="max_gt_boxes 17 exceeds detr_num_queries 16"):
        jax_det.detector_loss({}, jax.random.PRNGKey(0), images, *args, jcfg)
    with pytest.raises(ValueError, match="no mask branch"):
        port_det.detector_predict({}, _t(images), pcfg, with_masks=True)


def test_jax_msgpack_resumes_in_the_port(models, tmp_path):
    """JAX's ``save_checkpoint`` of the DETR model with its AdamW state ->
    the port's reader: the parameters bit for bit, the moments in the
    port's leaf order, a model restored in place."""
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
    """The exported 64 px program (no matcher, no host read in DETR's
    predict) against the live predict."""
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


def test_convergence_detr_families(tmp_path, monkeypatch):
    """``tools/convergence.py --family detr | detr_shared`` with ``--n-train``
    and ``--epochs``: the overrides of ``scripts/convergence_matrix.py``;
    DETR held to the flagship's mAP and AP50 floors (no loss ratio),
    ``detr_shared`` to none."""
    import importlib.util

    from layoutdit_tpu_torch.tools import convergence

    spec = importlib.util.spec_from_file_location(
        "convergence_matrix", os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                                           "convergence_matrix.py"))
    matrix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(matrix)
    pages = []
    monkeypatch.setattr("layoutdit_tpu_torch.tools.make_fixture.make_fixture",
                        lambda root, n_images, **k: pages.append(n_images))
    for family in ("detr", "detr_shared"):
        assert convergence.FAMILY_KNOBS[family] == matrix.FAMILY_KNOBS[family]
        os.makedirs(tmp_path / family)
        rc = convergence.recipe_config(str(tmp_path / family), "float32", family=family,
                                       n_train=1024, epochs=100)
        assert rc.model.detector == "detr" and rc.train.num_epochs == 100
        assert rc.model.detr_shared_matching == (family == "detr_shared")
        assert rc.data.max_gt_boxes == 32 <= rc.model.detr_num_queries
    assert pages == [1024, convergence.VAL_PAGES] * 2
    flat = [1.0] * 100
    low = {"mAP": 0.40, "AP50": 0.60}
    run = {"loss": flat, "epochs_asked": 100, "metrics": low}
    assert convergence.floor_failures({**run, "family": "detr"}) == [
        "mAP 0.4000 < 0.45", "AP50 0.6000 < 0.7"]
    assert convergence.floor_failures({**run, "family": "detr_shared"}) == []
    assert convergence.floor_failures({**run, "family": "detr",
                                       "metrics": {"mAP": 0.45, "AP50": 0.70}}) == []
    assert convergence.floor_failures({**run, "family": "detr", "epochs_asked": 48})[0].startswith(
        "expected 48 finite epoch losses")


# --------------------------------------------------- train, score, serve


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config

    root = str(tmp_path_factory.mktemp("detr_fixture"))
    make_fixture(root, n_images=8, split="samples", seed=2)
    write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)
    return root


@pytest.mark.parametrize("shared", [False, True])
def test_detr_trains_scores_and_serves(shared, fixture_dir, tmp_path):
    """The tiny fixture config with ``detector: detr`` (2 decoder layers
    of d 64, 40 queries for its 32 gt slots): ``Trainer`` (no sampler
    draws, DETR's loss keys), ``Evaluator.score()`` and
    ``BatchInferenceEngine`` (one detection a query a page)."""
    import json

    from layoutdit_tpu_torch.config import run_config_from_dict
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.train.trainer import Trainer

    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["detection_model_config"].update(
        detector="detr", detr_layers=2, detr_dim=64, detr_heads=4, detr_ffn_dim=128,
        detr_num_queries=40, detr_shared_matching=shared)
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["train_config"].update(tensorboard=False)
    rc = run_config_from_dict(raw)
    model = build_model(rc, device="cpu")
    assert set(model.params) == {"backbone", "detr"}
    trainer = Trainer(rc, model, device="cpu")
    state = trainer.generator.get_state()
    loss, parts = trainer.train_step(next(iter(trainer.dataloader)))
    assert torch.equal(trainer.generator.get_state(), state)  # nothing drawn
    keys = {"loss_ce", "loss_bbox", "loss_giou"}
    assert set(parts) == keys | {f"{k}_aux0" for k in keys} and np.isfinite(float(loss))
    trainer.train()
    assert len(trainer.loss_history) == 1 and np.isfinite(trainer.loss_history[0])
    metrics = Evaluator(model, rc, device="cpu").score()
    assert metrics is not None and all(np.isfinite(v) for v in metrics.values())
    engine = BatchInferenceEngine(port_det.DetectorModel(model.params, model.cfg),
                                  image_sizes=(224,), batch_size=2, score_thresh=0.0,
                                  device="cpu")
    names = sorted(os.listdir(os.path.join(fixture_dir, "samples")))[:3]
    pages = [open(os.path.join(fixture_dir, "samples", n), "rb").read() for n in names]
    for r in engine.predict_pages(pages):
        assert len(r.boxes) == 40 and r.masks is None
        assert (r.labels >= 1).all() and (r.labels <= 5).all()


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_predict_and_step_on_the_card():
    """DETR on the card in bf16 with a tiny encoder of head dim 32 (the
    kernels take bf16 and D in 32, 64, 128): the decoder's outputs against
    the CPU's plain path on the same weights (max |err| <= max |CPU| /
    32), detections finite and inside the page with no matcher launch, and
    one training loss with one matcher launch and finite gradients."""
    from layoutdit_tpu_torch.models.backbone import backbone_forward
    from layoutdit_tpu_torch.ops import short_attention as sa

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    vit = {**VIT, "hidden_size": 64, "intermediate_size": 128}
    _, cfg = _configs(vit=vit)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = port_det.init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    images, gt_boxes, gt_labels, gt_valid = _batch()

    def decoder(p, x):
        x = port_det._normalize(x, cfg).to(cfg.dtype)
        feats = backbone_forward(p["backbone"], x, cfg.backbone, compute_dtype=cfg.dtype)
        return port_detr.detr_forward(p["detr"], feats[cfg.detr_level], cfg.detr_heads)

    on_card = tree_map(lambda t: t.cuda(), params)
    with torch.no_grad():
        want = decoder(params, _t(images))
        sa.short_attention.launches = 0
        before = matching.linear_sum_assignment.launches
        got = decoder(on_card, _t(images).cuda())
        assert sa.short_attention.launches == vit["num_hidden_layers"]
        for g, w in zip(got, want):
            tol = float(w.float().abs().max()) / 32
            assert float((g.float().cpu() - w.float()).abs().max()) <= tol
        dets = port_det.detector_predict(on_card, _t(images).cuda(), cfg)
    assert matching.linear_sum_assignment.launches == before
    boxes = dets.boxes.cpu()
    assert dets.valid.all() and torch.isfinite(boxes).all()
    assert (boxes >= 0).all() and (boxes <= 64).all() and torch.isfinite(dets.scores).all()
    for t in tree_leaves(on_card):
        t.requires_grad_(True)
    losses = port_det.detector_loss(on_card, _t(images).cuda(), _t(gt_boxes).cuda(),
                                    _t(gt_labels).cuda(), _t(gt_valid).cuda(), cfg, None)
    assert matching.linear_sum_assignment.launches == before + 1
    sum(losses.values()).backward()
    assert all(torch.isfinite(t.grad).all() for t in tree_leaves(on_card) if t.grad is not None)
