"""FCOS anchor-free single-stage head (port of
``layoutdit_tpu/models/detection/fcos.py``), batched over images.

torchvision ``FCOS`` semantics over a subset of the shared pyramid
(``fcos_levels``): every cell is one reference point, a stride-sized
square used only as the linear coder's reference.

  * towers: 4 x (conv 3x3 C -> C, GroupNorm(32), ReLU) for the class and
    the regression branch; a conv 3x3 to NC+1 class logits (focal prior
    bias), a conv 3x3 + ReLU to the (l, t, r, b) distances and a conv 3x3
    to one center-ness logit, both off the regression tower;
  * assignment (``fcos_match``): a cell takes a gt when its center lies
    within ``fcos_center_sampling_radius`` x its stride of the gt's
    center, strictly inside the gt, with its largest distance in the
    level's range stride x [4, 8) (the first level open below, the last
    above); ties go to the smaller gt by JAX's float32 score
    match * (1e8 - area), which ties areas within a float32 step of 1e8
    (8 px^2) and then takes the lower index;
  * losses: sigmoid focal over every cell, GIoU on the decoded foreground
    boxes, BCE of the center-ness against sqrt of the ltrb ratios, each
    over the BATCH's max(1, num_fg);
  * inference: score sqrt(sigmoid(cls) * sigmoid(ctr)), per-level
    threshold and top-k, linear decode, clip, class-aware NMS across
    levels.

GroupNorm takes its statistics and affine in float32 and casts back, as
JAX's ``_group_norm`` does, whatever the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models.detection.heads import _normal_conv
from layoutdit_tpu_torch.models.detection.retinanet import (
    PRIOR_BIAS,
    _gather_rows,
    nms_and_top,
    select_candidates,
    sigmoid_focal_loss,
)
from layoutdit_tpu_torch.models.detection.roi_heads import Detections
from layoutdit_tpu_torch.models.fpn import conv2d
from layoutdit_tpu_torch.ops.boxes import (
    clip_boxes_to_image,
    decode_boxes_linear,
    encode_boxes_linear,
    generalized_box_iou,
)
from layoutdit_tpu_torch.parallel.mesh import global_count, rank_share

GN_GROUPS = 32


def init_fcos_head_params(in_channels: int, num_classes_bg: int, generator: torch.Generator,
                          device, num_convs: int = 4) -> dict:
    """The two towers (convs normal(std 0.01), GroupNorm scale 1 and bias
    0) and the three output convs; the class bias at the focal prior."""
    def conv(out_ch, bias=0.0):
        return {"weight": _normal_conv(out_ch, in_channels, 3, generator, device),
                "bias": torch.full((out_ch,), bias, device=device)}

    def tower():
        return {f"conv{i + 1}": {**conv(in_channels),
                                 "gn_scale": torch.ones(in_channels, device=device),
                                 "gn_bias": torch.zeros(in_channels, device=device)}
                for i in range(num_convs)}

    return {"cls_tower": tower(), "reg_tower": tower(),
            "cls_logits": conv(num_classes_bg, PRIOR_BIAS), "bbox_reg": conv(4),
            "ctrness": conv(1)}


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = GN_GROUPS, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over [B, C, H, W] in float32, cast back to x's dtype."""
    g = min(groups, x.shape[1])
    return F.group_norm(x.float(), g, scale.float(), bias.float(), eps).to(x.dtype)


def _run_tower(p: dict, x: torch.Tensor) -> torch.Tensor:
    i = 1
    while f"conv{i}" in p:
        c = p[f"conv{i}"]
        x = F.relu(group_norm(conv2d(x, c, padding=1), c["gn_scale"], c["gn_bias"]))
        i += 1
    return x


def _cells(x: torch.Tensor) -> torch.Tensor:
    """[B, K, H, W] -> [B, H*W, K]."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def fcos_head_forward(params: dict, feats: list[torch.Tensor]
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shared head over the selected levels -> (cls_logits [B, N,
    NC+1], ltrb [B, N, 4] (ReLU'd), ctrness [B, N]) in (level, y, x) cell
    order."""
    cls_all, reg_all, ctr_all = [], [], []
    for feat in feats:
        ct = _run_tower(params["cls_tower"], feat)
        rt = _run_tower(params["reg_tower"], feat)
        cls_all.append(_cells(conv2d(ct, params["cls_logits"], padding=1)))
        reg_all.append(_cells(F.relu(conv2d(rt, params["bbox_reg"], padding=1))))
        ctr_all.append(_cells(conv2d(rt, params["ctrness"], padding=1))[..., 0])
    return torch.cat(cls_all, 1), torch.cat(reg_all, 1), torch.cat(ctr_all, 1)


def fcos_match(
    anchors: torch.Tensor,  # [N, 4] stride-sized squares
    level_counts: tuple[int, ...],
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_valid: torch.Tensor,  # [B, G]
    center_sampling_radius: float,
) -> torch.Tensor:
    """JAX's ``fcos_match_single`` over a batch -> the matched gt index
    per cell [B, N] (-1 = background)."""
    n = anchors.shape[0]
    ctr = 0.5 * (anchors[:, :2] + anchors[:, 2:])  # [N, 2]
    sizes = anchors[:, 2] - anchors[:, 0]  # [N]
    gt_ctr = 0.5 * (gt_boxes[..., :2] + gt_boxes[..., 2:])  # [B, G, 2]

    match = ((ctr[None, :, None, :] - gt_ctr[:, None, :, :]).abs().amax(-1)
             < center_sampling_radius * sizes[None, :, None])  # [B, N, G]
    cx, cy = ctr[None, :, None, 0], ctr[None, :, None, 1]
    gb = gt_boxes[:, None]  # [B, 1, G, 4]
    dist = torch.stack([cx - gb[..., 0], cy - gb[..., 1], gb[..., 2] - cx, gb[..., 3] - cy],
                       dim=-1)  # [B, N, G, 4]
    match &= dist.amin(-1) > 0

    lower = sizes * 4.0
    upper = sizes * 8.0
    lower[:level_counts[0]] = 0.0
    upper[n - level_counts[-1]:] = float("inf")
    max_dist = dist.amax(-1)
    match &= (max_dist > lower[None, :, None]) & (max_dist < upper[None, :, None])
    match &= gt_valid[:, None, :]

    # ties -> the smaller gt, by torchvision's (and JAX's) float32 score
    areas = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    scored = match.float() * (1e8 - areas.float())[:, None, :]
    best = scored.amax(-1)
    idx = scored.argmax(-1)  # the first maximum, as jnp.argmax
    return torch.where(best < 1e-5, -1, idx)


def fcos_loss(
    cls_logits: torch.Tensor,  # [B, N, NC+1]
    ltrb: torch.Tensor,  # [B, N, 4]
    ctrness: torch.Tensor,  # [B, N]
    anchors: torch.Tensor,  # [N, 4]
    level_counts: tuple[int, ...],
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_labels: torch.Tensor,  # [B, G]
    gt_valid: torch.Tensor,  # [B, G]
    budget: DetectionBudget,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss_classification, loss_bbox_reg, loss_bbox_ctrness), each a
    sum over the batch over the batch's max(1, num_fg). Off the
    foreground the target box is the cell's own square, which keeps every
    ratio finite."""
    nc_bg = cls_logits.shape[-1]
    matched = fcos_match(anchors, level_counts, gt_boxes, gt_valid,
                         budget.fcos_center_sampling_radius)
    fg = matched >= 0
    num_fg = global_count(fg.sum()).clamp(min=1).float()  # over the global batch
    safe = matched.clamp(min=0)
    tgt_labels = torch.where(fg, torch.gather(gt_labels, 1, safe).long(), 0)
    anchors_b = anchors.expand(matched.shape[0], -1, -1)
    tgt_boxes = torch.where(fg[..., None], _gather_rows(gt_boxes, safe), anchors_b)

    onehot = F.one_hot(tgt_labels, nc_bg) * fg[..., None]
    loss_cls = rank_share(sigmoid_focal_loss(cls_logits, onehot).sum()) / num_fg

    giou = generalized_box_iou(decode_boxes_linear(ltrb.float(), anchors_b), tgt_boxes)
    loss_reg = rank_share(torch.where(fg, 1.0 - giou, torch.zeros_like(giou)).sum()) / num_fg

    reg_targets = encode_boxes_linear(anchors_b, tgt_boxes)
    lr, tb = reg_targets[..., 0::2], reg_targets[..., 1::2]
    ratio = (lr.amin(-1) * tb.amin(-1)) / (lr.amax(-1).clamp(min=1e-12)
                                           * tb.amax(-1).clamp(min=1e-12))
    ctr_targets = ratio.clamp(min=0.0).sqrt()
    x = ctrness.float()
    bce = x.clamp(min=0) - x * ctr_targets + torch.log1p(torch.exp(-x.abs()))
    loss_ctr = rank_share(torch.where(fg, bce, torch.zeros_like(bce)).sum()) / num_fg
    return loss_cls, loss_reg, loss_ctr


def fcos_postprocess(
    cls_logits: torch.Tensor,  # [B, N, NC+1]
    ltrb: torch.Tensor,  # [B, N, 4]
    ctrness: torch.Tensor,  # [B, N]
    anchors: torch.Tensor,  # [N, 4]
    level_counts: tuple[int, ...],
    image_size: tuple[int, int],
    budget: DetectionBudget,
) -> Detections:
    """torchvision ``FCOS.postprocess_detections`` for a batch (JAX's
    ``fcos_postprocess_single`` per image)."""
    scores = torch.sqrt(torch.sigmoid(cls_logits.float())
                        * torch.sigmoid(ctrness.float())[..., None])
    top_s, top_a, top_l = select_candidates(scores, level_counts, budget.fcos_score_thresh,
                                            budget.fcos_topk_candidates)
    boxes = []
    start = 0
    for count, a_idx in zip(level_counts, top_a):
        rel = _gather_rows(ltrb[:, start:start + count].float(), a_idx)
        an = anchors[start:start + count][a_idx]
        boxes.append(clip_boxes_to_image(decode_boxes_linear(rel, an),
                                         image_size[0], image_size[1]))
        start += count
    return nms_and_top(torch.cat(boxes, 1), torch.cat(top_s, 1), torch.cat(top_l, 1),
                       budget.fcos_nms_thresh, budget.fcos_detections_per_img)
