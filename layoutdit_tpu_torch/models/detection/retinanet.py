"""RetinaNet single-stage head (port of
``layoutdit_tpu/models/detection/retinanet.py``), batched over images.

torchvision ``RetinaNet`` semantics over a subset of the shared pyramid
(``retinanet_levels``, default strides 8..64 at 224 px):

  * two subnets, 4 x (conv 3x3 C -> C, ReLU) then a conv 3x3 to A*(NC+1)
    sigmoid class logits or A*4 deltas; every conv normal(std 0.01), the
    final class bias at the focal prior -log((1 - p) / p), p = 0.01;
  * the anchor matcher of the RPN (fg 0.5, bg 0.4, low-quality matches);
  * sigmoid focal loss (alpha 0.25, gamma 2) over the non-ignored anchors
    and L1 over the foreground ones, each divided by the image's own
    max(1, num_fg), then averaged over the batch;
  * inference per level: score threshold, top ``retinanet_topk_candidates``,
    decode, clip; then class-aware NMS across levels and the top
    ``retinanet_detections_per_img``. Class 0 (background, never a
    target) is left out of the candidates, as in JAX.

The convolutions are cuDNN's (``F.conv2d``), as JAX computes them with
XLA outside any Pallas kernel. Every top-k breaks ties by the lower
index (``rpn.stable_topk``), as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.models.detection.heads import _normal_conv
from layoutdit_tpu_torch.models.detection.roi_heads import Detections
from layoutdit_tpu_torch.models.detection.rpn import match_anchors_to_gt, stable_topk
from layoutdit_tpu_torch.models.fpn import conv2d
from layoutdit_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes, encode_boxes
from layoutdit_tpu_torch.ops.nms import batched_nms_mask

FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0
PRIOR_PROBABILITY = 0.01
PRIOR_BIAS = -math.log((1.0 - PRIOR_PROBABILITY) / PRIOR_PROBABILITY)


def init_retinanet_head_params(in_channels: int, num_anchors: int, num_classes_bg: int,
                               generator: torch.Generator, device, num_convs: int = 4) -> dict:
    """Both subnets: convs normal(std 0.01), biases zero but the final
    class bias, at the focal prior for every class and anchor."""
    def subnet(out_final, final_bias):
        p = {f"conv{i + 1}": {
            "weight": _normal_conv(in_channels, in_channels, 3, generator, device),
            "bias": torch.zeros(in_channels, device=device),
        } for i in range(num_convs)}
        p["final"] = {"weight": _normal_conv(out_final, in_channels, 3, generator, device),
                      "bias": torch.full((out_final,), final_bias, device=device)}
        return p

    return {"cls": subnet(num_anchors * num_classes_bg, PRIOR_BIAS),
            "reg": subnet(num_anchors * 4, 0.0)}


def _run_subnet(p: dict, x: torch.Tensor) -> torch.Tensor:
    i = 1
    while f"conv{i}" in p:
        x = F.relu(conv2d(x, p[f"conv{i}"], padding=1))
        i += 1
    return conv2d(x, p["final"], padding=1)


def _flatten(x: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """[B, A*K, H, W] -> [B, H*W*A, K] in (y, x, anchor) order."""
    b, _, h, w = x.shape
    return x.reshape(b, num_anchors, -1, h, w).permute(0, 3, 4, 1, 2).reshape(
        b, h * w * num_anchors, -1)


def retinanet_head_forward(params: dict, feats: list[torch.Tensor], num_anchors: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared head over the selected levels -> (cls_logits [B, N,
    NC+1], deltas [B, N, 4]) in (level, y, x, anchor) order, aligned with
    ``anchors.grid_anchors`` over the same levels."""
    cls_all, reg_all = [], []
    for feat in feats:
        cls_all.append(_flatten(_run_subnet(params["cls"], feat), num_anchors))
        reg_all.append(_flatten(_run_subnet(params["reg"], feat), num_anchors))
    return torch.cat(cls_all, dim=1), torch.cat(reg_all, dim=1)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = FOCAL_ALPHA, gamma: float = FOCAL_GAMMA) -> torch.Tensor:
    """Elementwise focal loss (torchvision ``sigmoid_focal_loss``,
    reduction 'none'), in float32."""
    x = logits.float()
    t = targets.float()
    p = torch.sigmoid(x)
    ce = x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = p * t + (1.0 - p) * (1.0 - t)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1.0 - alpha) * (1.0 - t)) * loss
    return loss


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, G, C], idx [B, N] -> [B, N, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def retinanet_loss(
    cls_logits: torch.Tensor,  # [B, N, NC+1]
    deltas: torch.Tensor,  # [B, N, 4]
    anchors: torch.Tensor,  # [N, 4]
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_labels: torch.Tensor,  # [B, G] int 1..NC
    gt_valid: torch.Tensor,  # [B, G] bool
    budget: DetectionBudget,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_classification, loss_bbox_reg): each image's sums over its
    own max(1, num_fg), then the mean over the batch. Off the foreground
    the matched gt is the anchor itself, so encode's log stays finite (a
    padded gt row is [0, 0, 0, 0])."""
    nc_bg = cls_logits.shape[-1]
    midx, labels = match_anchors_to_gt(
        anchors, gt_boxes, gt_valid, budget.retinanet_fg_iou_thresh,
        budget.retinanet_bg_iou_thresh, allow_low_quality=True,
    )
    fg = labels == 1
    num_fg = fg.sum(-1).clamp(min=1).float()  # [B]

    target_cls = torch.where(fg, torch.gather(gt_labels, 1, midx).long(), 0)
    onehot = F.one_hot(target_cls, nc_bg) * fg[..., None]
    focal = sigmoid_focal_loss(cls_logits, onehot)
    focal = torch.where((labels != -1)[..., None], focal, torch.zeros_like(focal))
    loss_cls = focal.sum((1, 2)) / num_fg

    anchors_b = anchors.expand_as(deltas)
    gt_matched = torch.where(fg[..., None], _gather_rows(gt_boxes, midx), anchors_b)
    l1 = (deltas.float() - encode_boxes(gt_matched, anchors_b)).abs().sum(-1)
    loss_reg = torch.where(fg, l1, torch.zeros_like(l1)).sum(-1) / num_fg
    return loss_cls.mean(), loss_reg.mean()


def select_candidates(
    scores: torch.Tensor,  # [B, N, NC+1] probabilities, float32
    level_counts: tuple[int, ...],
    score_thresh: float,
    topk: int,
) -> tuple[list[torch.Tensor], list[torch.Tensor], list[torch.Tensor]]:
    """Per level: class 0 dropped, scores at or under ``score_thresh`` to
    -inf, the top min(``topk``, count*NC) -> per-level lists of (scores
    [B, k], cell indices into the level [B, k], labels 1..NC [B, k] int32).
    Shared by RetinaNet and FCOS."""
    b, _, nc_bg = scores.shape
    nc = nc_bg - 1
    out_s, out_a, out_l = [], [], []
    start = 0
    for count in level_counts:
        flat = scores[:, start:start + count, 1:].reshape(b, count * nc)
        cand = torch.where(flat > score_thresh, flat, float("-inf"))
        top_s, top_i = stable_topk(cand, min(topk, count * nc))
        out_s.append(top_s)
        out_a.append(top_i // nc)
        out_l.append((top_i % nc).to(torch.int32) + 1)
        start += count
    return out_s, out_a, out_l


def nms_and_top(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                nms_thresh: float, detections: int) -> Detections:
    """The candidates of every level (-inf = none) -> class-aware NMS,
    then the top ``detections`` (fewer when there are fewer candidates),
    padded with a valid mask."""
    keep = batched_nms_mask(boxes, scores, labels, nms_thresh, valid=torch.isfinite(scores))
    final = torch.where(keep, scores, float("-inf"))
    out_s, out_i = stable_topk(final, min(detections, final.shape[1]))
    ok = torch.isfinite(out_s)
    return Detections(
        boxes=_gather_rows(boxes, out_i),
        scores=torch.where(ok, out_s, torch.zeros_like(out_s)),
        labels=torch.gather(labels, 1, out_i),
        valid=ok,
    )


def retinanet_postprocess(
    cls_logits: torch.Tensor,  # [B, N, NC+1]
    deltas: torch.Tensor,  # [B, N, 4]
    anchors: torch.Tensor,  # [N, 4]
    level_counts: tuple[int, ...],
    image_size: tuple[int, int],
    budget: DetectionBudget,
) -> Detections:
    """torchvision ``RetinaNet.postprocess_detections`` for a batch
    (JAX's ``retinanet_postprocess_single`` per image)."""
    scores = torch.sigmoid(cls_logits.float())
    top_s, top_a, top_l = select_candidates(scores, level_counts, budget.retinanet_score_thresh,
                                            budget.retinanet_topk_candidates)
    boxes = []
    start = 0
    for count, a_idx in zip(level_counts, top_a):
        dl = _gather_rows(deltas[:, start:start + count].float(), a_idx)
        an = anchors[start:start + count][a_idx]
        boxes.append(clip_boxes_to_image(decode_boxes(dl, an), image_size[0], image_size[1]))
        start += count
    return nms_and_top(torch.cat(boxes, 1), torch.cat(top_s, 1), torch.cat(top_l, 1),
                       budget.retinanet_nms_thresh, budget.retinanet_detections_per_img)
