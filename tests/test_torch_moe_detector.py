"""The mixture-of-experts detector in the port against the JAX package
on the CPU, float32, tiny widths (``configs/moe.json``'s model cut to two
layers of width 64, both MoE): ``detector_loss`` with ``loss_moe_aux``
for Faster R-CNN, RetinaNet and DETR; ``weights_io`` both ways; a JAX
``.msgpack`` of an MoE run resumed; warm-starting an MoE encoder as JAX
does; the exported program against the live predict.

Tolerances: ``test_torch_train``'s check (losses 1e-4, every gradient
leaf 1e-3 relative Frobenius, one AdamW update 1e-5); the single-stage
and DETR losses 1e-4; weights and checkpoints bit for bit; the export as
``test_torch_export.py``'s (boxes 1e-5, scores 1e-6, labels and valid
equal)."""

import os

import jax
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.config.constructs import ModelConfig as JaxModelConfig
from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.models.model import LayoutDetectionModel as JaxModel
from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
from layoutdit_tpu_torch.config import DetectionBudget, run_config_from_dict
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import model as port_model
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
    tree_paths,
    vit_params_to_jax,
)
from layoutdit_tpu_torch.train import checkpoint as ckpt
from test_torch_train import (
    BUDGET,
    _batch,
    _jax_trainer,
    _t,
    assert_loss_grads_and_update_match,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LOSS_RTOL = 1e-4
MOE = dict(num_experts=4, moe_every_n=1, moe_capacity_factor=1.0)
VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
           image_size=64)
TINY_HF = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
               image_size=64, patch_size=16)


def _spread_routers(jparams, seed=1):
    """Random routers (JAX's init routes almost every token to one expert
    at these widths), numpy leaves."""
    rng = np.random.default_rng(seed)
    for layer in jparams["backbone"]["vit"]["layers"]:
        layer["router"]["kernel"] = rng.standard_normal(
            layer["router"]["kernel"].shape).astype(np.float32)
    return jparams


@pytest.fixture(scope="module")
def models():
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT, **MOE),
                                             fpn_out_channels=32),
        image_size=64, budget=JaxBudget(**BUDGET))
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**VIT, **MOE),
                                              fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**BUDGET))
    jparams = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                                       jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    vit = jparams["backbone"]["vit"]
    vit["pos_embed"] = (0.02 * np.random.default_rng(2).standard_normal(
        vit["pos_embed"].shape)).astype(np.float32)
    return _spread_routers(jparams), jcfg, pcfg


def test_faster_rcnn_loss_with_moe_aux_matches_jax(models):
    """``detector_loss`` of a Faster R-CNN whose two encoder layers are
    MoE: the five losses (``loss_moe_aux`` among them), every gradient
    leaf and one AdamW update against JAX's; the gradients reach the
    routers and both expert banks."""
    jparams, jcfg, pcfg = models
    assert_loss_grads_and_update_match(jparams, jcfg, pcfg, *_batch())
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    images, gt_boxes, gt_labels, gt_valid = _batch()
    pri = port_det.draw_priorities(pcfg, 2, 4, torch.Generator().manual_seed(0))
    losses = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels),
                                    _t(gt_valid), pcfg, pri)
    assert float(losses["loss_moe_aux"]) >= 2 * 0.01 - 1e-6  # two layers, weight 0.01
    sum(losses.values()).backward()
    for layer in params["backbone"]["vit"]["layers"]:
        for leaf in ("router", "moe_in", "moe_out"):
            assert float(layer[leaf]["weight"].grad.abs().max()) > 0, leaf


FAMILIES = {
    "retinanet": dict(detector="retinanet"),
    "detr": dict(detector="detr", detr_num_queries=8, detr_layers=2, detr_dim=32,
                 detr_heads=2, detr_ffn_dim=64),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_single_stage_and_detr_losses_carry_moe_aux(family):
    """RetinaNet and DETR over an MoE encoder: the losses' keys
    (``loss_moe_aux`` among them) and values against JAX's."""
    overrides = {k: v for k, v in VIT.items() if k != "image_size"}
    mc = dict(num_classes=5, image_size=64, fpn_out_channels=32, **FAMILIES[family],
              vit_overrides={**overrides, **MOE})
    jcfg = jax_det.DetectorConfig.from_model_config(JaxModelConfig(**mc))
    pcfg = port_det.DetectorConfig.from_model_config(
        run_config_from_dict({"detection_model_config": mc}).model)
    jparams = _spread_routers(jax.tree_util.tree_map(
        np.asarray, jax_det.init_detector_params(jax.random.PRNGKey(0), jcfg)))
    images, gt_boxes, gt_labels, gt_valid = _batch()
    want = jax_det.detector_loss(jparams, jax.random.PRNGKey(0), images, gt_boxes, gt_labels,
                                 gt_valid, jcfg)
    got = port_det.detector_loss(params_from_jax(jparams), _t(images), _t(gt_boxes),
                                 _t(gt_labels), _t(gt_valid), pcfg, None)
    assert "loss_moe_aux" in got and set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=name)


def test_weights_both_ways_and_the_init_tree(models):
    """``params_from_jax`` and ``params_to_jax`` carry ``router``,
    ``moe_in`` and ``moe_out`` bit for bit, and the port's own init has
    the same paths, shapes and key order."""
    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    layer = params["backbone"]["vit"]["layers"][0]
    assert list(layer) == ["ln1", "ln2", "qkv", "attn_out", "router", "moe_in", "moe_out",
                           "lambda_1", "lambda_2"]
    assert tuple(layer["moe_in"]["weight"].shape) == (4, 64, 128)
    back = params_to_jax(params)
    fj, tj = jax.tree_util.tree_flatten_with_path(jparams)
    fb, tb = jax.tree_util.tree_flatten_with_path(back)
    assert tj == tb
    for (path, w), (_, g) in zip(fj, fb):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    init = port_det.init_detector(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert [(k, tuple(v.shape)) for k, v in zip(tree_paths(init),
                                                 tree_leaves(init))] == [
        (k, tuple(v.shape)) for k, v in zip(tree_paths(params),
                                            tree_leaves(params))]


def test_jax_msgpack_of_an_moe_run_resumes_bit_for_bit(models, tmp_path):
    """A JAX ``save_checkpoint`` of the MoE detector after one AdamW
    update: the port's ``load_checkpoint`` and a model's
    ``restore_checkpoint`` give JAX's parameters and moments bit for
    bit."""
    import optax

    jparams, jcfg, pcfg = models
    tx = _jax_trainer().make_optimizer(JaxTrainingConfig(weight_decay=0.01), steps_per_epoch=4)
    grads = jax.tree_util.tree_map(lambda p: np.full_like(p, 1e-3), jparams)
    updates, state = tx.update(grads, tx.init(jparams), jparams)
    jnew = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates))
    path = str(tmp_path / "epoch_1.msgpack")
    jax_save(path, jnew, state, epoch=1, extra={"updates": 1})
    loaded = ckpt.load_checkpoint(path, map_location="cpu")
    fj = jax.tree_util.tree_leaves(jnew)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_jax(loaded["params"])), fj,
                    strict=True):
        np.testing.assert_array_equal(g, w)
    adam = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: type(s).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState")
    it = iter(loaded["opt_state"]["mu"])
    got_mu = params_to_jax(tree_map(lambda _: next(it), loaded["params"]))
    for g, w in zip(jax.tree_util.tree_leaves(got_mu), jax.tree_util.tree_leaves(adam.mu),
                    strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
    mc = run_config_from_dict({"detection_model_config": {
        "image_size": 64, "fpn_out_channels": 32, "detection_budget": BUDGET,
        "vit_overrides": {k: v for k, v in {**VIT, **MOE}.items() if k != "image_size"}}}).model
    model = port_model.LayoutDetectionModel(mc, compute_dtype="float32", device="cpu",
                                            warm_start=False)
    model.restore_checkpoint(path)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_jax(model.params)), fj, strict=True):
        np.testing.assert_array_equal(g, w)


def _dense_hf_state_dict(path):
    """A tiny dense HF ``BeitModel``'s state_dict written to ``path``."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BeitConfig(**{**TINY_HF, "use_absolute_position_embeddings": True,
                                     "use_relative_position_bias": False,
                                     "layer_scale_init_value": 0.1, "use_mask_token": True})
    torch.manual_seed(0)
    torch.save(transformers.BeitModel(cfg).state_dict(), path)
    return path


def test_warm_start_into_an_moe_encoder_follows_jax(tmp_path):
    """Warm-starting an MoE encoder, in both packages: a converted
    ``.msgpack`` (no experts in it) raises; an HF state_dict replaces the
    encoder by the checkpoint's dense one, the experts dropped, so the
    model runs dense with ``loss_moe_aux`` 0 (ROADMAP queue 3)."""
    overrides = {k: v for k, v in TINY_HF.items() if k != "image_size"}
    mc = dict(image_size=64, fpn_out_channels=32, vit_overrides={**overrides, **MOE},
              detection_budget=BUDGET)
    dense = jax_vit.ViTConfig(**TINY_HF)
    msgpack = str(tmp_path / "dense.msgpack")
    jax_save(msgpack, jax.tree_util.tree_map(
        np.asarray, jax_vit.init_vit_params(jax.random.PRNGKey(0), dense)), None, epoch=0,
        extra={"preset": "tiny", "kind": "vit_encoder"})
    pmc = run_config_from_dict({"detection_model_config": mc}).model
    with pytest.raises(Exception):
        JaxModel(JaxModelConfig(**mc), previous_layout_dit_checkpoint=msgpack,
                 compute_dtype="float32")
    with pytest.raises(ValueError, match="experts"):
        port_model.LayoutDetectionModel(pmc, compute_dtype="float32", device="cpu",
                                        previous_layout_dit_checkpoint=msgpack)
    pth = _dense_hf_state_dict(str(tmp_path / "dense.pth"))
    jm = JaxModel(JaxModelConfig(**mc), previous_layout_dit_checkpoint=pth,
                  compute_dtype="float32")
    pm = port_model.LayoutDetectionModel(pmc, compute_dtype="float32", device="cpu",
                                         previous_layout_dit_checkpoint=pth)
    for layers in (jm.params["backbone"]["vit"]["layers"], pm.params["backbone"]["vit"]["layers"]):
        assert all("mlp_in" in layer and "router" not in layer for layer in layers)
    want = jax.tree_util.tree_map(np.asarray, jm.params["backbone"]["vit"])
    got = vit_params_to_jax(pm.params["backbone"]["vit"])
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got), strict=True):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    images, gt_boxes, gt_labels, gt_valid = _batch()
    pri = port_det.draw_priorities(pm.cfg, 2, 4, torch.Generator().manual_seed(0))
    losses = pm.loss(_t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid), pri)
    assert float(losses["loss_moe_aux"]) == 0.0


def test_export_equals_live(models, tmp_path):
    """The MoE detector exported (one program for its 64 px bucket; the
    export loops over buckets alike) and run by ``ExportedDetector``: its
    detections are the live ``detector_predict``'s."""
    from layoutdit_tpu_torch.export import ExportedDetector, export_detector

    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    export_detector(params, pcfg, str(tmp_path), image_sizes=(64,), batch_size=2,
                    device="cpu")
    art = ExportedDetector(str(tmp_path), device="cpu")
    images = _t(np.random.default_rng(64).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        live = port_det.detector_predict(params, images, pcfg)
    out = art.predict(images, torch.full((2, 2), 64.0))
    np.testing.assert_array_equal(out["valid"], live.valid.numpy())
    np.testing.assert_array_equal(out["labels"], live.labels.numpy())
    np.testing.assert_allclose(out["boxes"], live.boxes.numpy(), atol=1e-5)
    np.testing.assert_allclose(out["scores"], live.scores.numpy(), atol=1e-6)
    assert live.valid.any()
