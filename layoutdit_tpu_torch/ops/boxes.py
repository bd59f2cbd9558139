"""Box primitives for the serving path (torchvision semantics).

Port of ``layoutdit_tpu/ops/boxes.py``: boxes are ``[x1, y1, x2, y2]``
float tensors, and ``decode_boxes`` is torchvision's
``BoxCoder.decode_single`` with the ``log(1000/16)`` clamp on dw/dh.
"""

from __future__ import annotations

import math

import torch

# torchvision's bbox_xform_clip (box decode exp() guard).
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def clip_boxes_to_image(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Clamp xyxy boxes to [0, W] x [0, H] (torchvision clip_boxes_to_image)."""
    x1 = boxes[..., 0].clamp(0.0, width)
    y1 = boxes[..., 1].clamp(0.0, height)
    x2 = boxes[..., 2].clamp(0.0, width)
    y2 = boxes[..., 3].clamp(0.0, height)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True for boxes with BOTH sides >= min_size (torchvision
    remove_small_boxes)."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def decode_boxes(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Apply regression ``deltas`` [..., 4] to ``boxes`` [..., 4] (xyxy)."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h

    return torch.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w,
            pred_cy + 0.5 * pred_h,
        ],
        dim=-1,
    )
