"""RPN head, TwoMLPHead box head and FastRCNN predictor (port of
``layoutdit_tpu/models/detection/heads.py``).

Prediction tensors are flattened to torchvision's (H, W, A) anchor order
so they align with ``anchors.grid_anchors``. fc6 contracts the pooled
RoIs in RoIAlign's native layout [K, P(x), P(y), C]: its weight is
[rep, Px*Py*C] in that order, so the pooled tensor only needs a flatten.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.models.fpn import conv2d
from layoutdit_tpu_torch.parallel.mesh import ModelGroup
from layoutdit_tpu_torch.parallel.tensor import column_linear, copy_in, reduce_out, row_linear


def _normal_conv(out_ch, in_ch, k, generator, device, std=0.01):
    t = torch.empty((out_ch, in_ch, k, k), dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=generator)


def _torch_linear(in_f, out_f, generator, device) -> dict:
    """torch nn.Linear default init: kaiming_uniform(a=sqrt(5)) weight,
    uniform(+-1/sqrt(fan_in)) bias; weight [out, in]."""
    bound_w = math.sqrt(6.0 / ((1 + 5.0) * in_f))
    bound_b = 1.0 / math.sqrt(in_f)
    w = torch.empty((out_f, in_f), dtype=torch.float32, device=device)
    b = torch.empty((out_f,), dtype=torch.float32, device=device)
    return {
        "weight": w.uniform_(-bound_w, bound_w, generator=generator),
        "bias": b.uniform_(-bound_b, bound_b, generator=generator),
    }


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.linear(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype))


def init_rpn_head_params(in_channels: int, num_anchors: int, generator, device) -> dict:
    def conv(out_ch, k):
        return {
            "weight": _normal_conv(out_ch, in_channels, k, generator, device),
            "bias": torch.zeros(out_ch, device=device),
        }

    return {"conv": conv(in_channels, 3), "cls": conv(num_anchors, 1),
            "bbox": conv(num_anchors * 4, 1)}


def rpn_head_forward(
    params: dict, feats: list[torch.Tensor], num_anchors: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (objectness [B, N], deltas [B, N, 4]) over all levels in
    (level, y, x, anchor) order."""
    logits_all, deltas_all = [], []
    for feat in feats:
        b = feat.shape[0]
        t = F.relu(conv2d(feat, params["conv"], padding=1))
        logits = conv2d(t, params["cls"])  # [B, A, H, W]
        deltas = conv2d(t, params["bbox"])  # [B, 4A, H, W]
        h, w = logits.shape[-2:]
        logits_all.append(logits.permute(0, 2, 3, 1).reshape(b, h * w * num_anchors))
        deltas_all.append(
            deltas.reshape(b, num_anchors, 4, h, w)
            .permute(0, 3, 4, 1, 2)
            .reshape(b, h * w * num_anchors, 4)
        )
    return torch.cat(logits_all, dim=1), torch.cat(deltas_all, dim=1)


def init_box_head_params(in_features: int, rep_size: int, generator, device) -> dict:
    """TwoMLPHead params; fc6's input order is the pooled native layout
    (px, py, c)."""
    return {
        "fc6": _torch_linear(in_features, rep_size, generator, device),
        "fc7": _torch_linear(rep_size, rep_size, generator, device),
    }


def box_head_forward(params: dict, pooled: torch.Tensor,
                     tp: ModelGroup | None = None) -> torch.Tensor:
    """Pooled RoIs [K, Px, Py, C] -> [K, rep] (TwoMLPHead). Under ``tp``
    (JAX ``sharding.py:124-137``) fc6 is column-parallel and fc7
    row-parallel, this rank's shards: the ReLU between them runs on
    [K, rep / mp], one all-reduce of fc7's float32 partials, its bias
    added once before the one rounding (``parallel/tensor.py``)."""
    x = pooled.reshape(pooled.shape[0], -1)
    if tp is None or tp.size == 1:
        return F.relu(linear(F.relu(linear(x, params["fc6"])), params["fc7"]))
    dt = x.dtype
    fc6, fc7 = params["fc6"], params["fc7"]
    x = F.relu(column_linear(copy_in(x, tp), fc6["weight"].to(dt), fc6["bias"].to(dt)))
    y = reduce_out(row_linear(x, fc7["weight"].to(dt)), tp)
    return F.relu((y + fc7["bias"].to(dt).float()).to(dt))


def init_predictor_params(rep_size: int, num_classes_bg: int, generator, device,
                          reg_classes: int | None = None) -> dict:
    """FastRCNNPredictor params; ``reg_classes`` regression branches (the
    default, ``num_classes_bg``, is per class; a cascade stage passes 1,
    class-agnostic)."""
    reg = num_classes_bg if reg_classes is None else reg_classes
    return {
        "cls": _torch_linear(rep_size, num_classes_bg, generator, device),
        "bbox": _torch_linear(rep_size, reg * 4, generator, device),
    }


def predictor_forward(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return linear(x, params["cls"]), linear(x, params["bbox"])
