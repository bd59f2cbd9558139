"""Detection postprocess (port of
``layoutdit_tpu/models/detection/roi_heads.py::postprocess_detections_single``),
batched over images: softmax -> per-class decode -> clip -> score and
size filters -> per-class NMS -> top ``box_detections_per_img``, padded
with a valid mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes, small_box_mask
from layoutdit_tpu_torch.ops.nms import batched_nms_mask


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4]
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int (1..NC)
    valid: torch.Tensor  # [B, D] bool


def postprocess_detections(
    class_logits: torch.Tensor,  # [B, P, NC+1]
    box_regression: torch.Tensor,  # [B, P, (NC+1)*4]
    proposals: torch.Tensor,  # [B, P, 4]
    prop_valid: torch.Tensor,  # [B, P]
    image_size: tuple[int, int],
    budget: DetectionBudget,
) -> Detections:
    """torchvision RoIHeads.postprocess_detections for a batch."""
    b, p, nc_bg = class_logits.shape
    nc = nc_bg - 1

    scores = torch.softmax(class_logits.float(), dim=-1)
    boxes = decode_boxes(
        box_regression.float().reshape(b, p, nc_bg, 4),
        proposals[:, :, None, :],
        budget.box_reg_weights,
    )
    boxes = clip_boxes_to_image(boxes, image_size[0], image_size[1])

    # drop the background column, flatten to [B, P*NC]
    boxes = boxes[:, :, 1:, :].reshape(b, p * nc, 4)
    scores = scores[:, :, 1:].reshape(b, p * nc)
    labels = torch.arange(1, nc_bg, dtype=torch.int32, device=scores.device).repeat(p)
    valid = (
        prop_valid.repeat_interleave(nc, dim=1)
        & (scores > budget.box_score_thresh)
        & small_box_mask(boxes, 1e-2)
    )

    # NMS over ALL score-threshold survivors, as torchvision does
    cand_scores = torch.where(valid, scores, float("-inf"))
    top_scores, top_idx = cand_scores.topk(p * nc, dim=1)
    boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    labels = labels[top_idx]
    keep = batched_nms_mask(
        boxes, top_scores, labels, budget.box_nms_thresh,
        valid=torch.isfinite(top_scores),
    )
    final_scores = torch.where(keep, top_scores, float("-inf"))
    out_scores, out_idx = final_scores.topk(budget.box_detections_per_img, dim=1)
    ok = torch.isfinite(out_scores)
    return Detections(
        boxes=torch.gather(boxes, 1, out_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(ok, out_scores, torch.zeros_like(out_scores)),
        labels=torch.gather(labels, 1, out_idx),
        valid=ok,
    )
