"""The ported train step with ViTDet windows vs the JAX package on the
CPU, float32, tiny widths: ``detector_loss`` at a config whose global
layers see 257 tokens (the flash route) and whose windowed layers see
16-token windows and the 1-token CLS (the short route), with its
gradients and one AdamW update, without and with BEiT relative-position
tables (the bias and its gradient through the flash route, against the
JAX package's Pallas flash kernels, dbias included, in interpret mode);
plus windowed trainer steps on the card that launch every kernel the
expected number of times."""

import dataclasses
import os
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from test_torch_train import _batch, assert_loss_grads_and_update_match

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.ops import flash_attention as jax_flash
from layoutdit_tpu_torch.config import DetectionBudget, load_run_config
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.ops.short_attention import MAX_N as SHORT_MAX_N
from layoutdit_tpu_torch.tools.make_fixture import make_fixture
from layoutdit_tpu_torch.train import trainer as port_trainer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# 128 px with 8 px patches: a 16 x 16 grid, N = 257 in the global layers
# (1, 2 and 4: the taps of a 4-layer encoder), 4 x 4 windows in layer 3
VIT = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
           intermediate_size=128, image_size=128, patch_size=8, window_size=4)
BUDGET = dict(rpn_pre_nms_top_n_train=200, rpn_post_nms_top_n_train=100,
              box_batch_size_per_image=32)


# the encoder of configs/train_1024_window_relpos.json: a table per layer,
# no absolute position embeddings
RELPOS = dict(use_relative_position_bias=True, use_absolute_position_embeddings=False)


def _configs(vit_kw: dict, attention_impl: str = "auto"):
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**vit_kw), fpn_out_channels=32),
        image_size=128, budget=JaxBudget(**BUDGET), attention_impl=attention_impl,
    )
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**vit_kw),
                                              fpn_out_channels=32),
        image_size=128, budget=DetectionBudget(**BUDGET),
    )
    vit = pcfg.backbone.vit
    assert vit.grid_size ** 2 + 1 > SHORT_MAX_N  # the global layers take the flash route
    assert [vit.is_global_layer(i) for i in range(1, 5)] == [True, True, False, True]
    return jcfg, pcfg


def _check_against_jax(jcfg, pcfg, randomize):
    """``assert_loss_grads_and_update_match`` on JAX's init with the leaves
    ``randomize`` names overwritten (JAX initialises them to zero)."""
    jparams = jax.jit(jax_det.init_detector_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg
    )
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    randomize(jparams["backbone"]["vit"])
    images, gt_boxes, gt_labels, gt_valid = _batch()  # 64 px boxes, scaled to 128 px
    images = np.random.default_rng(5).uniform(0, 1, (2, 3, 128, 128)).astype(np.float32)
    assert_loss_grads_and_update_match(jparams, jcfg, pcfg, images, 2 * gt_boxes, gt_labels,
                                       gt_valid)


def test_windowed_detector_loss_grads_and_update_match_jax():
    def randomize(vit):
        vit["pos_embed"] = np.asarray(0.02 * jax.random.normal(
            jax.random.PRNGKey(1), vit["pos_embed"].shape))

    _check_against_jax(*_configs(VIT), randomize)


def test_relpos_windowed_detector_loss_grads_and_update_match_jax():
    """Relative-position tables in every layer, no absolute embeddings.
    The JAX side runs its global layers through the Pallas flash kernels
    in interpret mode (``attention_impl="pallas"``), so its bias gradient
    is ``_dbias_kernel``'s; its windows take the XLA path. The port's
    bias gradient flows back through the gather into each
    ``rel_pos_table`` leaf, held to JAX's at the helper's 1e-3."""
    jcfg, pcfg = _configs({**VIT, **RELPOS}, attention_impl="pallas")
    rng = np.random.default_rng(6)

    def randomize(vit):
        assert "pos_embed" not in vit
        for layer in vit["layers"]:  # non-zero, so a wrong index would show
            layer["rel_pos_table"] = (0.5 * rng.standard_normal(
                layer["rel_pos_table"].shape)).astype(np.float32)

    orig = jax_flash.flash_attention
    with mock.patch.object(jax_flash, "flash_attention",
                           lambda *a, **kw: orig(*a, **{**kw, "interpret": True})):
        _check_against_jax(jcfg, pcfg, randomize)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _train_step_launches(cuda, tmp_path, config: str) -> tuple[list[int], object]:
    """One train step of ``configs/<config>`` on the card -> the launches
    of short forward / backward, flash forward / dq / dkdv / dbias and
    RoIAlign forward / backward, and the encoder's config."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    base = load_run_config(str(REPO / "configs" / config))
    rc = dataclasses.replace(
        base, train=dataclasses.replace(base.train, train_base_path=str(tmp_path),
                                        train_input="samples"),
        eval_base_path=str(tmp_path))
    make_fixture(str(tmp_path), n_images=rc.data.batch_size, split="samples",
                 image_size=rc.model.image_size, seed=2)
    cfg = port_det.DetectorConfig.from_model_config(rc.model, rc.compute_dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    trainer = port_trainer.Trainer(
        rc, port_det.DetectorModel(port_det.init_detector(cfg, gen, device=cuda), cfg))
    counters = (sa.short_attention, sa.short_attention_bwd, fa.flash_attention_fwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
                fa.flash_attention_bwd_dbias, ra.roi_align_fwd, ra.roi_align_bwd)
    before = [c.launches for c in counters]
    it = iter(trainer.dataloader)
    batch = next(it)
    it.close()
    loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    vit = cfg.backbone.vit
    n_global = sum(vit.is_global_layer(i) for i in range(1, vit.num_hidden_layers + 1))
    assert (n_global, vit.num_hidden_layers - n_global) == (4, 8)
    return [c.launches - n for c, n in zip(counters, before)], vit


@pytest.mark.cuda
def test_windowed_trainer_step_launches_the_kernels(cuda, tmp_path):
    """One train step of ``configs/train_1024_window.json`` (dit-base,
    1024 px, batch 4, 16 x 16 windows) launches each kernel as often as
    the config says: per windowed layer two short attentions (windows
    and CLS), per global layer one flash attention, each with its
    backward, no dbias (no bias), and one RoIAlign forward and
    backward."""
    launches, _ = _train_step_launches(cuda, tmp_path, "train_1024_window.json")
    assert launches == [16, 16, 4, 4, 4, 0, 1, 1]


@pytest.mark.cuda
def test_relpos_trainer_step_launches_the_kernels(cuda, tmp_path):
    """One train step of ``configs/train_1024_window_relpos.json`` (the
    same with a relative-position table per layer): every layer's
    attention with a bias goes to the flash kernels, forward, dq, dkdv and
    dbias (4 global layers over 4097 tokens, 8 windowed layers over
    64 x 256-token windows), and only the CLS token of the windowed layers
    to the short kernels."""
    launches, vit = _train_step_launches(cuda, tmp_path, "train_1024_window_relpos.json")
    assert vit.use_relative_position_bias and not vit.use_absolute_position_embeddings
    assert launches == [8, 8, 12, 12, 12, 12, 1, 1]
