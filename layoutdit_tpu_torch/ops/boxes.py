"""Box primitives (torchvision semantics).

Port of ``layoutdit_tpu/ops/boxes.py``: boxes are ``[x1, y1, x2, y2]``
float tensors; ``encode_boxes``/``decode_boxes`` are torchvision's
``BoxCoder.encode_single``/``decode_single``, the latter with the
``log(1000/16)`` clamp on dw/dh; ``encode_boxes_linear`` /
``decode_boxes_linear`` its ``BoxLinearCoder`` (FCOS),
``generalized_box_iou`` the elementwise GIoU of FCOS's box loss and of
DETR's cost and loss, and ``cxcywh_to_xyxy`` / ``xyxy_to_cxcywh`` DETR's
box formats (JAX ``models/detection/detr.py``'s private pair).
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


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """ELEMENTWISE generalized IoU of aligned box sets: [..., 4] x [..., 4]
    -> [...] (torchvision ``generalized_box_iou_loss``'s pairing: IoU -
    (enclosure - union) / enclosure); an empty union gives IoU 0, an empty
    enclosure GIoU = IoU."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    wh_e = (torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
            - torch.minimum(boxes1[..., :2], boxes2[..., :2])).clamp(min=0.0)
    enclosure = wh_e[..., 0] * wh_e[..., 1]
    return torch.where(enclosure > 0, iou - (enclosure - union) / enclosure, iou)


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] (cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


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


def encode_boxes_linear(reference_boxes: torch.Tensor, targets: torch.Tensor,
                        normalize_by_size: bool = True) -> torch.Tensor:
    """torchvision ``BoxLinearCoder.encode`` (FCOS): the (l, t, r, b)
    distances from each reference box's center to its target's sides,
    divided by the reference box's size with ``normalize_by_size``."""
    ctr_x = 0.5 * (reference_boxes[..., 0] + reference_boxes[..., 2])
    ctr_y = 0.5 * (reference_boxes[..., 1] + reference_boxes[..., 3])
    out = torch.stack([ctr_x - targets[..., 0], ctr_y - targets[..., 1],
                       targets[..., 2] - ctr_x, targets[..., 3] - ctr_y], dim=-1)
    if normalize_by_size:
        w = reference_boxes[..., 2] - reference_boxes[..., 0]
        h = reference_boxes[..., 3] - reference_boxes[..., 1]
        out = out / torch.stack([w, h, w, h], dim=-1)
    return out


def decode_boxes_linear(rel_codes: torch.Tensor, boxes: torch.Tensor,
                        normalize_by_size: bool = True) -> torch.Tensor:
    """torchvision ``BoxLinearCoder.decode`` (FCOS): the inverse of
    ``encode_boxes_linear``."""
    ctr_x = 0.5 * (boxes[..., 0] + boxes[..., 2])
    ctr_y = 0.5 * (boxes[..., 1] + boxes[..., 3])
    if normalize_by_size:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        rel_codes = rel_codes * torch.stack([w, h, w, h], dim=-1)
    return torch.stack([ctr_x - rel_codes[..., 0], ctr_y - rel_codes[..., 1],
                        ctr_x + rel_codes[..., 2], ctr_y + rel_codes[..., 3]], dim=-1)
