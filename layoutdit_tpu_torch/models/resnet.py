"""ResNet-50 + FPN backbone (port of ``layoutdit_tpu/models/resnet.py``):
torchvision's ``resnet_fpn_backbone("resnet50", trainable_layers=5,
extra_blocks=LastLevelMaxPool())``, the reference's other backbone.

  * the convolutions are cuDNN's ``F.conv2d`` (JAX computes them with
    ``conv_general_dilated``, outside any Pallas kernel), OIHW kernels
    with no bias, torch's explicit "pad 1" on the stride-2 3x3 convs;
  * BatchNorm is an affine map from the stored statistics,
    y = (x - mean) / sqrt(var + eps) * weight + bias, folded into one
    scale and shift. As in the JAX package the statistics are ordinary
    parameters: nothing stops their gradient, and the optimizer trains
    ``mean`` and ``var`` like any weight (torchvision's FrozenBatchNorm
    never does). A step can drive ``var`` below zero, where JAX's
    sqrt(var + eps) is NaN; the port clamps ``var`` at zero inside the
    square root (the same bits wherever ``var`` >= 0, ROADMAP queue 3);
  * the stem's 3x3 / 2 max-pool pads with -inf (torch's);
  * the trunk runs channels-last, so the FPN's levels come out
    channels-last in the compute dtype (``pool`` a strided view of p5),
    the layout the RoIAlign kernels read, as the DiT pyramid's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.models.fpn import fpn_forward_from_laterals, init_fpn_params
from layoutdit_tpu_torch.models.fpn import conv2d as conv2d_bias

STAGE_BLOCKS = (3, 4, 6, 3)  # resnet50
STAGE_CHANNELS = (256, 512, 1024, 2048)
BN_EPS = 1e-5


def _conv(x: torch.Tensor, p: dict, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, p["weight"].to(x.dtype), None, stride, padding)


def _frozen_bn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x * scale + shift per channel, the scale and shift from the
    statistics in float32 (JAX's order of operations), cast to x's dtype."""
    root = torch.sqrt(torch.clamp(p["var"], min=0.0) + BN_EPS)
    scale = (p["weight"] / root).to(x.dtype)
    shift = (p["bias"] - p["mean"] * p["weight"] / root).to(x.dtype)
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _kaiming_conv(out_ch: int, in_ch: int, k: int, generator, device) -> torch.Tensor:
    """torch's ResNet init: kaiming_normal_(fan_out, relu)."""
    std = math.sqrt(2.0 / (out_ch * k * k))
    t = torch.empty((out_ch, in_ch, k, k), dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=generator)


def _bn_params(ch: int, device) -> dict:
    return {"weight": torch.ones(ch, device=device), "bias": torch.zeros(ch, device=device),
            "mean": torch.zeros(ch, device=device), "var": torch.ones(ch, device=device)}


def init_resnet50_params(generator: torch.Generator, device) -> dict:
    """The trunk's parameters, with the JAX package's distributions."""
    params = {"stem": {"conv": {"weight": _kaiming_conv(64, 3, 7, generator, device)},
                       "bn": _bn_params(64, device)},
              "stages": []}
    in_ch = 64
    for blocks, out_ch in zip(STAGE_BLOCKS, STAGE_CHANNELS):
        mid = out_ch // 4
        stage = []
        for bi in range(blocks):
            block = {
                "conv1": {"weight": _kaiming_conv(mid, in_ch, 1, generator, device)},
                "bn1": _bn_params(mid, device),
                "conv2": {"weight": _kaiming_conv(mid, mid, 3, generator, device)},
                "bn2": _bn_params(mid, device),
                "conv3": {"weight": _kaiming_conv(out_ch, mid, 1, generator, device)},
                "bn3": _bn_params(out_ch, device),
            }
            if bi == 0:
                block["downsample"] = {
                    "conv": {"weight": _kaiming_conv(out_ch, in_ch, 1, generator, device)},
                    "bn": _bn_params(out_ch, device),
                }
            stage.append(block)
            in_ch = out_ch
        params["stages"].append(stage)
    return params


def _bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    identity = x
    out = F.relu(_frozen_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = F.relu(_frozen_bn(_conv(out, p["conv2"], stride=stride, padding=1), p["bn2"]))
    out = _frozen_bn(_conv(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        identity = _frozen_bn(_conv(x, p["downsample"]["conv"], stride=stride),
                              p["downsample"]["bn"])
    return F.relu(out + identity)


def resnet50_forward(params: dict, pixels: torch.Tensor) -> list[torch.Tensor]:
    """[B, 3, H, W] -> [C2, C3, C4, C5] (strides 4 / 8 / 16 / 32),
    channels-last."""
    x = pixels.contiguous(memory_format=torch.channels_last)
    x = _conv(x, params["stem"]["conv"], stride=2, padding=3)
    x = F.relu(_frozen_bn(x, params["stem"]["bn"]))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # pads with -inf
    feats = []
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            x = _bottleneck(x, block, 2 if (bi == 0 and si > 0) else 1)
        feats.append(x)
    return feats


def init_resnet_fpn_params(generator: torch.Generator, device, out_channels: int = 256) -> dict:
    return {"resnet": init_resnet50_params(generator, device),
            "fpn": init_fpn_params(list(STAGE_CHANNELS), out_channels, generator, device)}


def resnet_fpn_forward(params: dict, pixels: torch.Tensor,
                       compute_dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """[B, 3, H, W] normalized pixels -> [p2, p3, p4, p5, pool], each
    channels-last in ``compute_dtype`` (torchvision's FPN with
    LastLevelMaxPool)."""
    feats = resnet50_forward(params["resnet"], pixels.to(compute_dtype))
    laterals = [conv2d_bias(f, p) for f, p in zip(feats, params["fpn"]["inner"])]
    out = fpn_forward_from_laterals(params["fpn"], laterals, extra_max_pool=True)
    return [t if t.stride(1) == 1 else t.contiguous(memory_format=torch.channels_last)
            for t in out]


def resnet50_state_dict_to_params(state_dict, device="cpu") -> dict:
    """A torchvision ``resnet50`` state_dict -> the trunk's parameters
    (an ImageNet warm start): convs pass through as OIHW, each BN's
    ``running_mean`` / ``running_var`` become ``mean`` / ``var``."""

    def t(name):
        v = state_dict[name]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)

    def bn(prefix):
        return {"weight": t(prefix + ".weight"), "bias": t(prefix + ".bias"),
                "mean": t(prefix + ".running_mean"), "var": t(prefix + ".running_var")}

    params = {"stem": {"conv": {"weight": t("conv1.weight")}, "bn": bn("bn1")}, "stages": []}
    for si, blocks in enumerate(STAGE_BLOCKS, start=1):
        stage = []
        for bi in range(blocks):
            pre = f"layer{si}.{bi}"
            block = {
                "conv1": {"weight": t(pre + ".conv1.weight")}, "bn1": bn(pre + ".bn1"),
                "conv2": {"weight": t(pre + ".conv2.weight")}, "bn2": bn(pre + ".bn2"),
                "conv3": {"weight": t(pre + ".conv3.weight")}, "bn3": bn(pre + ".bn3"),
            }
            if pre + ".downsample.0.weight" in state_dict:
                block["downsample"] = {"conv": {"weight": t(pre + ".downsample.0.weight")},
                                       "bn": bn(pre + ".downsample.1")}
            stage.append(block)
        params["stages"].append(stage)
    return params
