"""RPN proposal filtering at inference (port of
``layoutdit_tpu/models/detection/rpn.py::filter_proposals``).

Per-level top-k -> decode -> clip -> small-box / score masks -> NMS
within each FPN level -> top ``post_nms_top_n`` (padded, with a valid
mask), for the whole batch at once: the levels of every image are padded
to one length and go through ``nms_mask`` as one [B * L] batch of
problems, so one fixpoint sweep serves all of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes, small_box_mask
from layoutdit_tpu_torch.ops.nms import nms_mask


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [B, P, 4]
    scores: torch.Tensor  # [B, P] sigmoid objectness (-inf for padding)
    valid: torch.Tensor  # [B, P] bool


def _per_level_topk(objectness, deltas, anchors, level_counts, pre_nms_top_n):
    """Top min(pre_nms_top_n, n_level) per level -> lists of per-level
    (logits [B, k], deltas [B, k, 4], anchors [B, k, 4])."""
    parts = []
    start = 0
    b = objectness.shape[0]
    for count in level_counts:
        k = min(pre_nms_top_n, count)
        ob = objectness[:, start:start + count]
        dl = deltas[:, start:start + count]
        an = anchors[start:start + count].expand(b, count, 4)
        if k < count:
            ob, idx = ob.topk(k, dim=1)
            dl = torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4))
            an = torch.gather(an, 1, idx[..., None].expand(-1, -1, 4))
        parts.append((ob, dl, an))
        start += count
    return parts


def filter_proposals(
    objectness: torch.Tensor,  # [B, N]
    deltas: torch.Tensor,  # [B, N, 4]
    anchors: torch.Tensor,  # [N, 4]
    level_counts: tuple[int, ...],
    image_size: tuple[int, int],
    budget: DetectionBudget,
) -> Proposals:
    """Inference proposals (``rpn_*_test`` budgets)."""
    pre_n = budget.rpn_pre_nms_top_n_test
    post_n = budget.rpn_post_nms_top_n_test
    b = objectness.shape[0]
    parts = _per_level_topk(objectness, deltas, anchors, level_counts, pre_n)
    logits = torch.cat([p[0] for p in parts], dim=1)
    d = torch.cat([p[1] for p in parts], dim=1)
    a = torch.cat([p[2] for p in parts], dim=1)

    boxes = decode_boxes(d.float(), a)
    boxes = clip_boxes_to_image(boxes, image_size[0], image_size[1])
    scores = torch.sigmoid(logits.float())
    valid = small_box_mask(boxes, budget.rpn_min_size)
    valid &= scores >= budget.rpn_score_thresh

    # NMS within each level (torchvision batched_nms over levels): pad
    # the levels to one length and run them as one batch of problems
    ks = [p[0].shape[1] for p in parts]
    kmax = max(ks)
    n_lv = len(ks)
    boxes_g = boxes.new_zeros(b, n_lv, kmax, 4)
    scores_g = scores.new_full((b, n_lv, kmax), float("-inf"))
    valid_g = valid.new_zeros(b, n_lv, kmax)
    start = 0
    for li, k in enumerate(ks):
        boxes_g[:, li, :k] = boxes[:, start:start + k]
        scores_g[:, li, :k] = scores[:, start:start + k]
        valid_g[:, li, :k] = valid[:, start:start + k]
        start += k
    keep_g = nms_mask(boxes_g, scores_g, budget.rpn_nms_thresh, valid=valid_g)
    keep = torch.cat([keep_g[:, li, :k] for li, k in enumerate(ks)], dim=1)

    sort_scores = torch.where(keep, scores, float("-inf"))
    top_scores, top_idx = sort_scores.topk(post_n, dim=1)
    return Proposals(
        boxes=torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        scores=top_scores,
        valid=torch.isfinite(top_scores),
    )
