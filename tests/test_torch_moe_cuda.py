"""The card's side of the mixture-of-experts encoder and bf16 scores
(marked ``cuda``; they skip without a GPU). No JAX here: the card's
machine has none, and each test compares with the port's plain versions
on the CPU.

    python -m pytest tests/test_torch_moe_cuda.py -q -m cuda

Tolerances: ``moe_mlp`` in fp32 on the card against the CPU's at 1e-5
with the same routing, its backward the same bits on two runs; bf16 on
the card against fp32 on the CPU, max |err| <= max |CPU| / 32 (a few bf16
roundings through two encoder layers); the short kernel against the
bf16-score plain attention within 0.05 (bf16 probabilities)."""

import numpy as np
import pytest
import torch

from layoutdit_tpu_torch.config import run_config_from_dict
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map
from layoutdit_tpu_torch.ops import moe

pytestmark = pytest.mark.cuda
BUDGET = {"rpn_pre_nms_top_n_train": 200, "rpn_post_nms_top_n_train": 100,
          "rpn_pre_nms_top_n_test": 100, "rpn_post_nms_top_n_test": 100,
          "box_batch_size_per_image": 32}
MOE_VIT = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 128, "num_experts": 4, "moe_every_n": 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _moe_params(gen, d=64, f=128, e=4):
    p = moe.init_moe_mlp_params(d, f, e, gen, "cpu")
    p["router"]["weight"] = torch.randn(d, e, generator=gen)
    p["moe_in"]["bias"] = 0.1 * torch.randn(e, f, generator=gen)
    return p


def test_moe_mlp_on_the_card(cuda):
    """fp32 on the card: the CPU's routing and outputs, the backward the
    same bits on two runs (the index scatter-adds sum at most two values a
    row); bf16 within its tolerance."""
    gen = torch.Generator().manual_seed(0)
    p = _moe_params(gen)
    y = torch.randn(4, 197, 64, generator=gen)
    for k in (1, 2):
        want, aux = moe.moe_mlp(y, p, 4, k, 1.0)
        on_card = tree_map(lambda t: t.cuda().requires_grad_(True), p)
        grads = []
        for _ in range(2):
            yc = y.cuda().requires_grad_(True)
            got, aux_c = moe.moe_mlp(yc, on_card, 4, k, 1.0)
            (got.square().sum() + aux_c).backward()
            grads.append([yc.grad] + [t.grad.clone() for t in tree_leaves(on_card)])
            for t in tree_leaves(on_card):
                t.grad = None
        torch.testing.assert_close(got.detach().cpu(), want, rtol=1e-5, atol=1e-5)
        assert float(aux_c) == pytest.approx(float(aux), abs=1e-6)
        for a, b in zip(*grads):
            assert torch.equal(a, b)
        bf = tree_map(lambda t: t.cuda(), p)
        got_bf, _ = moe.moe_mlp(y.cuda().bfloat16(), bf, 4, k, 1.0)
        assert float((got_bf.float().cpu() - want).abs().max()) <= float(want.abs().max()) / 32


def _cfg(**vit):
    mc = run_config_from_dict({"detection_model_config": {
        "image_size": 64, "fpn_out_channels": 32, "detection_budget": BUDGET,
        "vit_overrides": {**MOE_VIT, **vit}}}).model
    return port_det.DetectorConfig.from_model_config(mc, precision_dtype="bfloat16")


def test_moe_step_and_request_on_the_card(cuda):
    """The MoE detector in bf16 on the card: the encoder's taps within the
    tolerance of fp32 on the CPU's plain path, row 1 once a layer in a
    request; a train step with ``loss_moe_aux``, rows 1-2 once a layer,
    gradients into every router and expert bank, finite."""
    from layoutdit_tpu_torch.ops import short_attention as sa

    cfg = _cfg()
    params = port_det.init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    for layer in params["backbone"]["vit"]["layers"]:
        layer["router"]["weight"] = torch.randn(layer["router"]["weight"].shape,
                                                generator=torch.Generator().manual_seed(1))
    images = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (2, 3, 64, 64))
                              .astype(np.float32))
    x = port_det._normalize(images, cfg)
    with torch.no_grad():
        want = port_vit.vit_forward(params["backbone"]["vit"], x, cfg.backbone.vit, taps=(1, 2))
        on_card = tree_map(lambda t: t.cuda(), params)
        sa.short_attention.launches = 0
        got = port_vit.vit_forward(on_card["backbone"]["vit"], x.cuda().bfloat16(),
                                   cfg.backbone.vit, taps=(1, 2),
                                   compute_dtype=torch.bfloat16)
        assert sa.short_attention.launches == 2
        for g, w in zip(got, want):
            assert float((g.float().cpu() - w).abs().max()) <= float(w.abs().max()) / 32
        dets = port_det.detector_predict(on_card, images.cuda(), cfg)
        assert torch.isfinite(dets.boxes).all()
    for t in tree_leaves(on_card):
        t.requires_grad_(True)
    sa.short_attention.launches = sa.short_attention_bwd.launches = 0
    boxes = torch.tensor([[[5, 5, 30, 40], [20, 10, 60, 50]]] * 2, device="cuda")
    labels = torch.ones(2, 2, dtype=torch.long, device="cuda")
    valid = torch.ones(2, 2, dtype=torch.bool, device="cuda")
    pri = port_det.draw_priorities(cfg, 2, 2, torch.Generator(device="cuda").manual_seed(0))
    losses = port_det.detector_loss(on_card, images.cuda(), boxes, labels, valid, cfg, pri)
    assert "loss_moe_aux" in losses and all(torch.isfinite(v) for v in losses.values())
    sum(losses.values()).backward()
    assert sa.short_attention.launches == 2 and sa.short_attention_bwd.launches == 2
    for layer in on_card["backbone"]["vit"]["layers"]:
        for leaf in ("router", "moe_in", "moe_out"):
            g = layer[leaf]["weight"].grad
            assert torch.isfinite(g).all() and float(g.abs().max()) > 0, leaf


def test_bf16_scores_on_the_card(cuda):
    """``score_dtype="bfloat16"``: the short kernel ignores it, as JAX's
    kernel routes do; it stays within 0.05 of the bf16-score plain
    attention at the 224 px shape (B 2, N 197, H 12, D 64)."""
    from layoutdit_tpu_torch.ops import short_attention as sa

    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 197, 3 * 768, generator=gen).cuda().bfloat16()
    sa.short_attention.launches = 0
    got = port_vit.attention_core(qkv, 12, score_dtype="bfloat16")
    assert sa.short_attention.launches == 1
    assert torch.equal(got, port_vit.attention_core(qkv, 12))
    want = port_vit.bf16_score_attention_plain(qkv, 12)
    assert float((got.float() - want.float()).abs().max()) <= 0.05
