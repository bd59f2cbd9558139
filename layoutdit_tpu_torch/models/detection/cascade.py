"""Cascade R-CNN head (port of ``layoutdit_tpu/models/detection/cascade.py``),
batched over images.

N refinement stages (three by default) with rising foreground IoU
thresholds, each with its own TwoMLPHead and a class-agnostic predictor
(4 deltas, per-stage BoxCoder weights). In training, stage 0 takes the
Fast R-CNN samples; each later stage relabels the previous stage's
refined boxes at its threshold, with no resampling, and the refined
boxes are detached between stages. At inference the boxes are refined
through every stage, and the class scores are the mean of the stages'
softmaxes, each on its own input boxes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models.detection.roi_heads import Detections
from layoutdit_tpu_torch.models.detection.rpn import smooth_l1, stable_topk
from layoutdit_tpu_torch.ops.boxes import (
    box_iou,
    clip_boxes_to_image,
    decode_boxes,
    encode_boxes,
    small_box_mask,
)
from layoutdit_tpu_torch.ops.nms import batched_nms_mask
from layoutdit_tpu_torch.parallel.mesh import global_count, rank_share

# per-stage defaults of the Cascade R-CNN paper (section 4.2), as
# detectron2 and mmdetection adopt them
DEFAULT_STAGE_IOUS = (0.5, 0.6, 0.7)
DEFAULT_STAGE_REG_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)
DEFAULT_STAGE_LOSS_WEIGHTS = (1.0, 0.5, 0.25)


class StageTargets(NamedTuple):
    labels: torch.Tensor  # [B, S] int (0 = background)
    reg_targets: torch.Tensor  # [B, S, 4]


def match_boxes_to_gt(
    boxes: torch.Tensor,  # [B, S, 4] the stage's input boxes
    box_valid: torch.Tensor,  # [B, S]
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_labels: torch.Tensor,  # [B, G]
    gt_valid: torch.Tensor,  # [B, G]
    fg_iou_thresh: float,
    reg_weights: tuple[float, float, float, float],
) -> StageTargets:
    """JAX's ``match_boxes_to_gt_single`` over a batch (detectron2's
    ``_match_and_label_boxes``): every valid box takes its best gt (the
    first of equal ones); at ``fg_iou_thresh`` or above it takes that
    gt's class and regression target, else background."""
    iou = box_iou(gt_boxes, boxes)  # [B, G, S]
    iou = torch.where(gt_valid[:, :, None] & box_valid[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=1)
    matched_idx = iou.argmax(dim=1)  # first maximum, as jnp.argmax
    is_pos = box_valid & (matched_vals >= fg_iou_thresh) & gt_valid.any(dim=1, keepdim=True)
    labels = torch.where(is_pos, torch.gather(gt_labels, 1, matched_idx).to(torch.int64), 0)
    gt_m = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
    reg_targets = encode_boxes(gt_m, boxes, reg_weights)
    reg_targets = torch.where(is_pos[..., None], reg_targets, torch.zeros_like(reg_targets))
    return StageTargets(labels=labels, reg_targets=reg_targets)


def cascade_stage_loss(
    class_logits: torch.Tensor,  # [B, S, NC+1]
    box_regression: torch.Tensor,  # [B, S, 4] class-agnostic
    labels: torch.Tensor,  # [B, S]
    reg_targets: torch.Tensor,  # [B, S, 4]
    valid: torch.Tensor,  # [B, S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """One stage's (loss_cls, loss_box), normalised as ``fastrcnn_loss``
    (CE mean over the sampled slots; smooth-L1 summed over the positives
    / the sampled count) with one regression branch for every class."""
    num = global_count(valid.sum()).clamp(min=1)  # over the global batch
    logp = torch.log_softmax(class_logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss_cls = rank_share(torch.where(valid, ce, torch.zeros_like(ce)).sum()) / num
    pos = valid & (labels > 0)
    l1 = smooth_l1(box_regression.float() - reg_targets, beta=1.0 / 9).sum(-1)
    loss_box = rank_share(torch.where(pos, l1, torch.zeros_like(l1)).sum()) / num
    return loss_cls, loss_box


def refine_boxes(
    boxes: torch.Tensor,  # [..., 4]
    deltas: torch.Tensor,  # [..., 4] class-agnostic
    reg_weights: tuple[float, float, float, float],
    image_size: tuple[int, int],
) -> torch.Tensor:
    """A stage's regression applied to its boxes, clipped to the image
    (boxes at an edge may come out with zero width or height)."""
    out = decode_boxes(deltas.float(), boxes, reg_weights)
    return clip_boxes_to_image(out, image_size[0], image_size[1])


def cascade_mean_scores(per_stage_logits: list[torch.Tensor]) -> torch.Tensor:
    """The mean of the stages' class posteriors (fp32 softmax each)."""
    probs = [torch.softmax(lg.float(), dim=-1) for lg in per_stage_logits]
    return sum(probs) / len(probs)


def postprocess_cascade(
    scores: torch.Tensor,  # [B, P, NC+1] stage-averaged posteriors
    boxes: torch.Tensor,  # [B, P, 4] final refined boxes (clipped)
    prop_valid: torch.Tensor,  # [B, P]
    budget: DetectionBudget,
) -> Detections:
    """JAX's ``postprocess_cascade_single`` over a batch: every class
    shares its proposal's box; score and size filters, per-class NMS over
    every survivor, then the top ``box_detections_per_img``. Both top-k's
    break ties by the lower index, as ``jax.lax.top_k``."""
    b, p, nc_bg = scores.shape
    nc = nc_bg - 1
    flat_scores = scores[:, :, 1:].reshape(b, p * nc)
    flat_boxes = boxes.repeat_interleave(nc, dim=1)  # [B, P*NC, 4]
    labels = torch.arange(1, nc_bg, dtype=torch.int32, device=scores.device).repeat(p)
    valid = (
        prop_valid.repeat_interleave(nc, dim=1)
        & (flat_scores > budget.box_score_thresh)
        & small_box_mask(flat_boxes, 1e-2)
    )
    cand_scores = torch.where(valid, flat_scores, float("-inf"))
    top_scores, top_idx = stable_topk(cand_scores, p * nc)
    flat_boxes = torch.gather(flat_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    labels = labels[top_idx]
    keep = batched_nms_mask(flat_boxes, top_scores, labels, budget.box_nms_thresh,
                            valid=torch.isfinite(top_scores))
    final_scores = torch.where(keep, top_scores, float("-inf"))
    out_scores, out_idx = stable_topk(final_scores, budget.box_detections_per_img)
    ok = torch.isfinite(out_scores)
    return Detections(
        boxes=torch.gather(flat_boxes, 1, out_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(ok, out_scores, torch.zeros_like(out_scores)),
        labels=torch.gather(labels, 1, out_idx),
        valid=ok,
    )
