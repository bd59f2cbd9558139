"""Feature Pyramid Network (torchvision parity; port of
``layoutdit_tpu/models/fpn.py``): 1x1 laterals, nearest top-down
upsample + add, 3x3 output convs, and LastLevelMaxPool as a stride-2
slice. Convs are NCHW with OIHW kernels, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.ops.interpolate import max_pool_stride2


def conv2d(x: torch.Tensor, p: dict, padding: int = 0) -> torch.Tensor:
    """NCHW conv with an OIHW kernel + bias (torch Conv2d semantics)."""
    return F.conv2d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype), padding=padding)


def _kaiming_uniform_conv(out_ch, in_ch, k, generator, device, a=1.0):
    """torchvision FPN conv init: kaiming_uniform_(a=1), bias zeros."""
    bound = math.sqrt(6.0 / ((1 + a * a) * in_ch * k * k))
    t = torch.empty((out_ch, in_ch, k, k), dtype=torch.float32, device=device)
    return t.uniform_(-bound, bound, generator=generator)


def init_fpn_params(
    in_channels_list: list[int], out_channels: int, generator: torch.Generator, device
) -> dict:
    inner, layer = [], []
    for in_ch in in_channels_list:
        inner.append({
            "weight": _kaiming_uniform_conv(out_channels, in_ch, 1, generator, device),
            "bias": torch.zeros(out_channels, device=device),
        })
        layer.append({
            "weight": _kaiming_uniform_conv(out_channels, out_channels, 3, generator, device),
            "bias": torch.zeros(out_channels, device=device),
        })
    return {"inner": inner, "layer": layer}


def nearest_upsample_to(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') to an explicit size:
    src_idx = floor(dst * in / out). [..., C, H, W] -> [..., C, out_h,
    out_w] in channels-last memory: it gathers on the [..., H, W, C] view,
    so the FPN's top-down sum and its output conv stay channels-last."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    rows = (torch.arange(out_h, device=x.device) * in_h) // out_h
    cols = (torch.arange(out_w, device=x.device) * in_w) // out_w
    return x.movedim(-3, -1)[..., rows, :, :][..., cols, :].movedim(-1, -3)


def fpn_forward_from_laterals(
    params: dict, laterals: list[torch.Tensor], extra_max_pool: bool = True
) -> list[torch.Tensor]:
    """Top-down + 3x3 stage over precomputed laterals (fine -> coarse)."""
    layer = params["layer"]
    last_inner = laterals[-1]
    results = [conv2d(last_inner, layer[-1], padding=1)]
    for idx in range(len(laterals) - 2, -1, -1):
        top_down = nearest_upsample_to(
            last_inner, laterals[idx].shape[-2], laterals[idx].shape[-1]
        )
        last_inner = laterals[idx] + top_down
        results.insert(0, conv2d(last_inner, layer[idx], padding=1))
    if extra_max_pool:
        results.append(max_pool_stride2(results[-1]))
    return results
