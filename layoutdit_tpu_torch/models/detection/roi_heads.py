"""RoI heads (port of ``layoutdit_tpu/models/detection/roi_heads.py``),
batched over images: training-sample selection and the Fast R-CNN loss,
and the detection postprocess (softmax -> per-class decode -> clip ->
score and size filters -> per-class NMS -> top ``box_detections_per_img``,
padded with a valid mask).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models.detection.rpn import smooth_l1, stable_topk
from layoutdit_tpu_torch.ops.boxes import (
    box_iou,
    clip_boxes_to_image,
    decode_boxes,
    encode_boxes,
    small_box_mask,
)
from layoutdit_tpu_torch.ops.nms import batched_nms_mask


class TrainingSamples(NamedTuple):
    rois: torch.Tensor  # [B, S, 4]
    valid: torch.Tensor  # [B, S] bool
    labels: torch.Tensor  # [B, S] int (0 = background)
    reg_targets: torch.Tensor  # [B, S, 4]


def select_training_samples(
    proposals: torch.Tensor,  # [B, P, 4]
    prop_valid: torch.Tensor,  # [B, P]
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_labels: torch.Tensor,  # [B, G]
    gt_valid: torch.Tensor,  # [B, G]
    budget: DetectionBudget,
    priorities: torch.Tensor,  # [B, 2, P + G] uniform [0, 1): positives, negatives
) -> TrainingSamples:
    """torchvision RoIHeads.select_training_samples: gt appended to the
    proposals, Matcher(0.5, 0.5) without low-quality matches,
    ``box_batch_size_per_image`` slots of which at most
    ``box_positive_fraction`` positive, picked by random-priority top-k."""
    s = budget.box_batch_size_per_image
    max_pos = int(s * budget.box_positive_fraction)

    cand = torch.cat([proposals, gt_boxes], dim=1)  # [B, P+G, 4]
    cand_valid = torch.cat([prop_valid, gt_valid], dim=1)
    iou = box_iou(gt_boxes, cand)  # [B, G, P+G]
    iou = torch.where(gt_valid[:, :, None] & cand_valid[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=1)
    matched_idx = iou.argmax(dim=1)  # first maximum, as jnp.argmax

    any_gt = gt_valid.any(dim=1, keepdim=True)
    is_pos = cand_valid & (matched_vals >= budget.box_fg_iou_thresh) & any_gt
    is_neg = cand_valid & ~is_pos
    num_pos = is_pos.sum(1, keepdim=True).clamp(max=max_pos)
    num_neg = torch.minimum(is_neg.sum(1, keepdim=True), s - num_pos)

    ninf = torch.full_like(priorities[:, 0], float("-inf"))
    _, pos_idx = stable_topk(torch.where(is_pos, priorities[:, 0], ninf), s)
    _, neg_idx = stable_topk(torch.where(is_neg, priorities[:, 1], ninf), s)

    slot = torch.arange(s, device=proposals.device)[None]
    take_pos = slot < num_pos
    neg_at = torch.gather(neg_idx, 1, (slot - num_pos).clamp(min=0))
    idx = torch.where(take_pos, pos_idx, neg_at)
    valid = take_pos | (slot - num_pos < num_neg)

    rois = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 4))
    m = torch.gather(matched_idx, 1, idx)
    labels = torch.where(take_pos, torch.gather(gt_labels, 1, m).to(torch.int64), 0)
    labels = labels * valid
    gt_m = torch.gather(gt_boxes, 1, m[..., None].expand(-1, -1, 4))
    reg_targets = encode_boxes(gt_m, rois, budget.box_reg_weights)
    reg_targets = torch.where(take_pos[..., None], reg_targets, torch.zeros_like(reg_targets))
    return TrainingSamples(rois=rois, valid=valid, labels=labels, reg_targets=reg_targets)


def fastrcnn_loss(
    class_logits: torch.Tensor,  # [B, S, NC+1]
    box_regression: torch.Tensor,  # [B, S, (NC+1)*4]
    samples: TrainingSamples,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_classifier, loss_box_reg), torchvision fastrcnn_loss: CE mean
    over the sampled slots; smooth_l1(beta=1/9) of the positives'
    matched-class deltas, summed / the sampled count."""
    b, s, nc_bg = class_logits.shape
    valid = samples.valid
    num = valid.sum().clamp(min=1)

    logp = torch.log_softmax(class_logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, samples.labels[..., None])[..., 0]
    loss_cls = torch.where(valid, ce, torch.zeros_like(ce)).sum() / num

    pos = valid & (samples.labels > 0)
    reg = box_regression.float().reshape(b, s, nc_bg, 4)
    cls_idx = samples.labels.clamp(min=0)
    reg_for_label = torch.gather(reg, 2, cls_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    l1 = smooth_l1(reg_for_label - samples.reg_targets, beta=1.0 / 9).sum(-1)
    loss_box = torch.where(pos, l1, torch.zeros_like(l1)).sum() / num
    return loss_cls, loss_box


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
