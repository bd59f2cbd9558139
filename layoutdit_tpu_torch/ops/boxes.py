"""Box primitives (torchvision semantics).

Port of ``layoutdit_tpu/ops/boxes.py``: boxes are ``[x1, y1, x2, y2]``
float tensors; ``encode_boxes``/``decode_boxes`` are torchvision's
``BoxCoder.encode_single``/``decode_single``, the latter with the
``log(1000/16)`` clamp on dw/dh.
"""

from __future__ import annotations

import math

import torch

# torchvision's bbox_xform_clip (box decode exp() guard).
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: [..., M, 4] x [..., N, 4] -> [..., M, N] (xyxy; 0
    where the union is empty)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


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


def encode_boxes(
    reference_boxes: torch.Tensor,
    proposals: torch.Tensor,
    weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Encode gt ``reference_boxes`` relative to ``proposals`` (anchors):
    torchvision ``BoxCoder.encode_single`` with ``weights``
    (``box_reg_weights`` for the box head)."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0]
    ex_h = proposals[..., 3] - proposals[..., 1]
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


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
