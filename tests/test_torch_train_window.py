"""The ported train step with ViTDet windows vs the JAX package on the
CPU, float32, tiny widths: ``detector_loss`` at a config whose global
layers see 257 tokens (the flash route) and whose windowed layers see
16-token windows and the 1-token CLS (the short route), with its
gradients and one AdamW update; plus a windowed trainer step on the card
that launches every kernel the expected number of times."""

import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_train import _batch, assert_loss_grads_and_update_match

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
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


def test_windowed_detector_loss_grads_and_update_match_jax():
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=128, budget=JaxBudget(**BUDGET),
    )
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=128, budget=DetectionBudget(**BUDGET),
    )
    vit = pcfg.backbone.vit
    assert vit.grid_size ** 2 + 1 > SHORT_MAX_N  # the global layers take the flash route
    assert [vit.is_global_layer(i) for i in range(1, 5)] == [True, True, False, True]
    jparams = jax.jit(jax_det.init_detector_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg
    )
    jparams["backbone"]["vit"]["pos_embed"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(1), jparams["backbone"]["vit"]["pos_embed"].shape
    )
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    images, gt_boxes, gt_labels, gt_valid = _batch()  # 64 px boxes, scaled to 128 px
    images = np.random.default_rng(5).uniform(0, 1, (2, 3, 128, 128)).astype(np.float32)
    assert_loss_grads_and_update_match(jparams, jcfg, pcfg, images, 2 * gt_boxes, gt_labels,
                                       gt_valid)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_windowed_trainer_step_launches_the_kernels(cuda, tmp_path):
    """One train step of ``configs/train_1024_window.json`` (dit-base,
    1024 px, batch 4, 16 x 16 windows) launches each kernel as often as
    the config says: per windowed layer two short attentions (windows
    and CLS), per global layer one flash attention, each with its
    backward, and one RoIAlign forward and backward."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    base = load_run_config(str(REPO / "configs" / "train_1024_window.json"))
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
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv, ra.roi_align_fwd,
                ra.roi_align_bwd)
    before = [c.launches for c in counters]
    it = iter(trainer.dataloader)
    batch = next(it)
    it.close()
    loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    vit = cfg.backbone.vit
    n_global = sum(vit.is_global_layer(i) for i in range(1, vit.num_hidden_layers + 1))
    n_windowed = vit.num_hidden_layers - n_global
    assert (n_global, n_windowed) == (4, 8)
    want = [2 * n_windowed, 2 * n_windowed, n_global, n_global, n_global, 1, 1]
    assert [c.launches - n for c, n in zip(counters, before)] == want
