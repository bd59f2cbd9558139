"""Region Proposal Network: proposal filtering, target assignment, loss
(port of ``layoutdit_tpu/models/detection/rpn.py``).

``filter_proposals``: per-level top-k -> decode -> clip -> small-box /
score masks -> NMS within each FPN level -> top ``post_nms_top_n``
(padded, with a valid mask), for the whole batch at once: the levels of
every image are padded to one length and go through ``nms_mask`` as one
[B * L] batch of problems, so one fixpoint sweep serves all of them.

Training: the anchor-to-gt matcher with low-quality matches, the
balanced 256 @ 0.5 sampler, BCE objectness and smooth-L1 (beta 1/9) box
loss normalised over the whole batch's sampled count. The vmap over
images of the JAX version is written out as a batch dimension.

Picks follow ``jax.lax.top_k``: descending, ties to the lower index
(``stable_topk``), since the sampler's priorities are indexed by slot and
``torch.topk`` promises no order among ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.ops.boxes import (
    box_iou,
    clip_boxes_to_image,
    decode_boxes,
    encode_boxes,
    small_box_mask,
)
from layoutdit_tpu_torch.ops.nms import nms_mask
from layoutdit_tpu_torch.parallel.mesh import global_count, rank_share


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [B, P, 4]
    scores: torch.Tensor  # [B, P] sigmoid objectness (-inf for padding)
    valid: torch.Tensor  # [B, P] bool


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last dim, descending, ties broken by the lower
    index (``jax.lax.top_k``)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


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
            ob, idx = stable_topk(ob, k)
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
    training: bool = False,
) -> Proposals:
    """Proposals with the ``rpn_*_train`` budgets when ``training``, else
    ``rpn_*_test``. The inputs are only ranked, never differentiated
    (torchvision detaches the objectness), so they are detached here."""
    objectness, deltas = objectness.detach(), deltas.detach()
    pre_n = budget.rpn_pre_nms_top_n_train if training else budget.rpn_pre_nms_top_n_test
    post_n = budget.rpn_post_nms_top_n_train if training else budget.rpn_post_nms_top_n_test
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
    top_scores, top_idx = stable_topk(sort_scores, post_n)
    return Proposals(
        boxes=torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        scores=top_scores,
        valid=torch.isfinite(top_scores),
    )


# ------------------------------------------------------------------ targets


def match_anchors_to_gt(
    anchors: torch.Tensor,  # [N, 4]
    gt_boxes: torch.Tensor,  # [..., G, 4]
    gt_valid: torch.Tensor,  # [..., G]
    high_thresh: float,
    low_thresh: float,
    allow_low_quality: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """torchvision Matcher -> (matched_idx [..., N], labels [..., N]);
    labels 1 = positive, 0 = negative, -1 = ignore. With
    ``allow_low_quality`` every anchor that ties a gt's best IoU becomes
    positive, with no > 0 guard (torchvision's behaviour); with no valid
    gt everything is background."""
    iou = box_iou(gt_boxes, anchors)  # [..., G, N]
    iou = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=-2)
    matched_idx = iou.argmax(dim=-2)  # first maximum, as jnp.argmax

    labels = torch.where(
        matched_vals >= high_thresh,
        torch.ones_like(matched_idx),
        torch.where(matched_vals < low_thresh, torch.zeros_like(matched_idx),
                    torch.full_like(matched_idx, -1)),
    )
    if allow_low_quality:
        highest_per_gt = iou.max(dim=-1, keepdim=True).values  # [..., G, 1]
        ties = (iou == highest_per_gt) & gt_valid[..., :, None]
        labels = torch.where(ties.any(dim=-2), torch.ones_like(labels), labels)
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, torch.zeros_like(labels))
    return matched_idx, labels


def balanced_sample_with_pos(
    labels: torch.Tensor,  # [..., N] in {1, 0, -1}
    priorities: torch.Tensor,  # [..., 2, N] uniform [0, 1): positives, negatives
    batch_size: int,
    positive_fraction: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torchvision BalancedPositiveNegativeSampler by random-priority
    top-k -> (sampled mask [..., N], pos_idx [..., max_pos],
    pos_take [..., max_pos]): the sampled positives as indices, so the
    box targets are computed on max_pos rows only."""
    pos = labels == 1
    neg = labels == 0
    max_pos = int(batch_size * positive_fraction)
    num_pos = pos.sum(-1, keepdim=True).clamp(max=max_pos)
    num_neg = torch.minimum(neg.sum(-1, keepdim=True), batch_size - num_pos)

    ninf = torch.full_like(priorities[..., 0, :], float("-inf"))
    _, pos_idx = stable_topk(torch.where(pos, priorities[..., 0, :], ninf), max_pos)
    pos_take = torch.arange(max_pos, device=labels.device) < num_pos
    _, neg_idx = stable_topk(torch.where(neg, priorities[..., 1, :], ninf), batch_size)
    neg_take = torch.arange(batch_size, device=labels.device) < num_neg

    mask = torch.zeros_like(pos).scatter(-1, pos_idx, pos_take)
    mask |= torch.zeros_like(neg).scatter(-1, neg_idx, neg_take)
    return mask, pos_idx, pos_take


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def rpn_loss(
    objectness: torch.Tensor,  # [B, N] logits
    deltas: torch.Tensor,  # [B, N, 4]
    anchors: torch.Tensor,  # [N, 4]
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_valid: torch.Tensor,  # [B, G]
    budget: DetectionBudget,
    priorities: torch.Tensor,  # [B, 2, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_objectness, loss_rpn_box_reg), torchvision compute_loss: BCE
    mean over the sampled anchors; smooth_l1(beta=1/9) summed over the
    sampled positives / the sampled count, both over the whole batch (the
    global batch under ``parallel.mesh.losses_over``)."""
    midx, labels = match_anchors_to_gt(
        anchors, gt_boxes, gt_valid, budget.rpn_fg_iou_thresh,
        budget.rpn_bg_iou_thresh, allow_low_quality=True,
    )
    sampled, pos_idx, pos_take = balanced_sample_with_pos(
        labels, priorities, budget.rpn_batch_size_per_image, budget.rpn_positive_fraction,
    )
    # regression targets at the sampled positive slots only; slots not
    # taken get zero targets (their loss is masked either way, and a zero
    # keeps a degenerate gt's infinite target out of the gradient)
    gt_idx = torch.gather(midx, 1, pos_idx)
    gt_pos = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    reg_targets = encode_boxes(gt_pos, anchors[pos_idx])
    reg_targets = torch.where(pos_take[..., None], reg_targets, torch.zeros_like(reg_targets))
    dl = torch.gather(deltas, 1, pos_idx[..., None].expand(-1, -1, 4)).float()
    l1 = smooth_l1(dl - reg_targets, beta=1.0 / 9).sum(-1)
    l1_sum = torch.where(pos_take, l1, torch.zeros_like(l1)).sum()

    num_sampled = global_count(sampled.sum()).clamp(min=1)
    ob = objectness.float()
    bce = ob.clamp(min=0) - ob * (labels == 1) + torch.log1p(torch.exp(-ob.abs()))
    loss_obj = rank_share(torch.where(sampled, bce, torch.zeros_like(bce)).sum()) / num_sampled
    return loss_obj, rank_share(l1_sum) / num_sampled
