"""The card's side of warm start, ResNet-50, LoRA and int8 (marked
``cuda``; they skip without a GPU). No JAX here: the card's machine has
none, and each test compares with the port's plain versions on the CPU.

    python -m pytest tests/test_torch_finetune_cuda.py -q -m cuda

Tolerances: int8 GEMMs exact in int32, the W8A8 linear's float output
1e-6 relative (the same dequantization in another order of fp32
products); bf16 on the card against fp32 on the CPU, max |err| <= max
|CPU| / 32 (a few bf16 roundings through a ResNet or two encoder
layers)."""

import numpy as np
import pytest
import torch

from layoutdit_tpu_torch.config import run_config_from_dict
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map, tree_paths
from layoutdit_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda
BUDGET = {"rpn_pre_nms_top_n_train": 200, "rpn_post_nms_top_n_train": 100,
          "rpn_pre_nms_top_n_test": 100, "rpn_post_nms_top_n_test": 100,
          "box_batch_size_per_image": 32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg(**model):
    mc = run_config_from_dict({"detection_model_config": {
        "image_size": 64, "fpn_out_channels": 32, "detection_budget": BUDGET, **model}}).model
    return port_det.DetectorConfig.from_model_config(mc, precision_dtype="bfloat16")


def _batch(device):
    images = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (2, 3, 64, 64))
                              .astype(np.float32)).to(device)
    boxes = torch.tensor([[[5, 5, 30, 40], [20, 10, 60, 50]]] * 2, device=device)
    labels = torch.ones(2, 2, dtype=torch.long, device=device)
    return images, boxes, labels, torch.ones(2, 2, dtype=torch.bool, device=device)


def test_int8_gemm_on_the_card(cuda):
    """``torch._int_mm`` on the card against the CPU's at the 224 px qkv
    shape, exact; 16 rows or fewer raise (never a fallback)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 197, 768)).astype(np.float32))
    p = quant.quantize_linear({"weight": torch.from_numpy(
        rng.standard_normal((2304, 768)).astype(np.float32)), "bias": torch.zeros(2304)})
    xq, _ = quant.quantize_activations(x.reshape(-1, 768))
    assert torch.equal(quant._int_mm(xq.cuda(), p["weight_q"].cuda()).cpu(),
                       quant._int_mm(xq, p["weight_q"]))
    want = quant.int8_linear(x, p)
    got = quant.int8_linear(x.cuda(), tree_map(lambda t: t.cuda(), p))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="more than 16 rows"):
        quant.int8_linear(x[:1, :16].cuda(), tree_map(lambda t: t.cuda(), p))


def test_resnet_predict_and_step_on_the_card(cuda):
    """ResNet-50 + FPN in bf16 on the card: the pyramid channels-last and
    within the tolerance of fp32 on the CPU, RoIAlign (rows 7-8) launched
    once a pass and no attention kernel; a train step's losses finite."""
    from layoutdit_tpu_torch.models import resnet
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    cfg = _cfg(backbone_type="resnet50")
    params = port_det.init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    images, boxes, labels, valid = _batch("cpu")
    x = port_det._normalize(images, cfg)
    with torch.no_grad():
        want = resnet.resnet_fpn_forward(params["backbone"], x)
        on_card = tree_map(lambda t: t.cuda(), params)
        got = resnet.resnet_fpn_forward(on_card["backbone"], x.cuda(), torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.stride(1) == 1
        assert float((g.float().cpu() - w).abs().max()) <= float(w.abs().max()) / 32
    ra.roi_align_fwd.launches = ra.roi_align_bwd.launches = sa.short_attention.launches = 0
    with torch.no_grad():
        dets = port_det.detector_predict(on_card, images.cuda(), cfg)
    assert ra.roi_align_fwd.launches == 1 and sa.short_attention.launches == 0
    assert torch.isfinite(dets.boxes).all()
    for t in tree_leaves(on_card):
        t.requires_grad_(True)
    pri = port_det.draw_priorities(cfg, 2, 2, torch.Generator(device="cuda").manual_seed(0))
    losses = port_det.detector_loss(on_card, *_batch("cuda"), cfg, pri)
    sum(losses.values()).backward()
    assert ra.roi_align_bwd.launches == 1
    assert all(torch.isfinite(v) for v in losses.values())


def test_lora_step_on_the_card(cuda):
    """A LoRA detector (head dim 32, bf16) on the card: a train step with
    the encoder frozen gives gradients to the adapters and none to the base
    weights, rows 1-2 launched once a layer."""
    from layoutdit_tpu_torch.models.lora import trainable_mask
    from layoutdit_tpu_torch.ops import short_attention as sa

    cfg = _cfg(lora_rank=4, lora_alpha=8.0,
               vit_overrides={"hidden_size": 64, "num_hidden_layers": 2,
                              "num_attention_heads": 2, "intermediate_size": 128})
    params = port_det.init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    mask = trainable_mask(on_card)
    for t, m in zip(tree_leaves(on_card), mask):
        t.requires_grad_(m)
    sa.short_attention.launches = sa.short_attention_bwd.launches = 0
    pri = port_det.draw_priorities(cfg, 2, 2, torch.Generator(device="cuda").manual_seed(0))
    losses = port_det.detector_loss(on_card, *_batch("cuda"), cfg, pri)
    sum(losses.values()).backward()
    assert sa.short_attention.launches == 2 and sa.short_attention_bwd.launches == 2
    for path, t, m in zip(tree_paths(on_card), tree_leaves(on_card), mask):
        if path.endswith("lora_a"):
            assert t.grad is not None  # zero while B is zero, but computed
        if not m:
            assert t.grad is None, path
    assert any(p.endswith("lora_b") and t.grad.abs().sum() > 0
               for p, t in zip(tree_paths(on_card), tree_leaves(on_card)))
