"""DETR set-prediction head (port of
``layoutdit_tpu/models/detection/detr.py``), batched over images.

facebookresearch/detr's recipe, as the JAX package runs it:

  * memory: one pyramid level (``detr_level``, stride 16 by default)
    projected 1x1 to d_model, plus 2D sine position embeddings
    (normalized, temperature 1e4) added to the attention keys;
  * decoder: post-norm layers (query self-attention with the query
    embedding added to q and k, cross-attention into the memory, FFN);
    a final LayerNorm on every layer's output;
  * heads, shared across layers: a linear to NC+1 class logits (class 0
    is "no object", the port's background) and a 3-layer ReLU MLP to
    sigmoid (cx, cy, w, h) in [0, 1] of the page;
  * matching: per image and decoder layer, the exact Hungarian assignment
    over cost = -prob(gt class) + 5 L1(cxcywh) - 2 GIoU, every problem of
    a step in one ``ops.matching.linear_sum_assignment`` call (one kernel
    launch on the card), under ``no_grad``;
  * losses: CE over all queries (background weight ``eos_coef``, torch's
    weighted mean) and 5 L1 + 2 (1 - GIoU) over the matched pairs divided
    by the batch's gt count, per decoder layer with ``aux_loss``;
  * inference: softmax, each query's best foreground class, all queries
    returned by score (a stable sort), no NMS.

The attention is plain PyTorch with fp32 scores and softmax, as JAX's is
plain jnp: its scores and P V products take bf16 operands exactly and
accumulate in fp32, as JAX's ``preferred_element_type=float32`` does.
Matrices are xavier-uniform, the query embeddings normal(0, 1), biases
zero, drawn from a ``torch.Generator`` in JAX's key order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from layoutdit_tpu_torch.models.detection.roi_heads import Detections
from layoutdit_tpu_torch.ops.boxes import (
    clip_boxes_to_image,
    cxcywh_to_xyxy,
    generalized_box_iou,
    xyxy_to_cxcywh,
)
from layoutdit_tpu_torch.ops.matching import linear_sum_assignment
from layoutdit_tpu_torch.parallel.mesh import global_count, rank_share

CLASS_WEIGHT = 1.0
BBOX_WEIGHT = 5.0
GIOU_WEIGHT = 2.0
LN_EPS = 1e-5


# ----------------------------------------------------------------- params


def _linear_params(d_in: int, d_out: int, generator, device) -> dict:
    """xavier-uniform [d_out, d_in] weight (JAX's [d_in, d_out] kernel's
    bound), zero bias."""
    bound = math.sqrt(6.0 / (d_in + d_out))
    w = torch.empty((d_out, d_in), dtype=torch.float32, device=device)
    return {"weight": w.uniform_(-bound, bound, generator=generator),
            "bias": torch.zeros(d_out, device=device)}


def _ln_params(d: int, device) -> dict:
    return {"weight": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}


def init_detr_params(in_channels: int, num_classes_bg: int, generator: torch.Generator,
                     device, d_model: int = 256, num_layers: int = 6, ffn_dim: int = 2048,
                     num_queries: int = 100) -> dict:
    """The head's parameters (JAX ``init_detr_params``'s tree; the heads
    shape nothing, the packed in-projection is [3d, d]): the decoder
    layers' draws first (self-attention in/out, cross-attention in/out,
    ffn1, ffn2), then the input projection, the query embeddings, the
    class head and the box MLP."""

    def mha():
        return {"in_proj": _linear_params(d_model, 3 * d_model, generator, device),
                "out_proj": _linear_params(d_model, d_model, generator, device)}

    layers = []
    for _ in range(num_layers):
        self_attn, cross_attn = mha(), mha()
        layers.append({
            "self_attn": self_attn, "cross_attn": cross_attn,
            "ln1": _ln_params(d_model, device), "ln2": _ln_params(d_model, device),
            "ln3": _ln_params(d_model, device),
            "ffn1": _linear_params(d_model, ffn_dim, generator, device),
            "ffn2": _linear_params(ffn_dim, d_model, generator, device),
        })
    proj = _linear_params(in_channels, d_model, generator, device)
    query = torch.empty((num_queries, d_model), dtype=torch.float32, device=device)
    query.normal_(0.0, 1.0, generator=generator)
    class_head = _linear_params(d_model, num_classes_bg, generator, device)
    bbox_mlp = {"fc1": _linear_params(d_model, d_model, generator, device),
                "fc2": _linear_params(d_model, d_model, generator, device),
                "fc3": _linear_params(d_model, 4, generator, device)}
    return {"proj": proj, "query_embed": query, "decoder": layers,
            "decoder_norm": _ln_params(d_model, device), "class_head": class_head,
            "bbox_mlp": bbox_mlp}


# ---------------------------------------------------------------- forward


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype))


def _layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """fp32 statistics and affine, cast back (JAX ``_layer_norm``)."""
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"], p["bias"], LN_EPS).to(x.dtype)


def _attention(p: dict, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """torch ``nn.MultiheadAttention`` semantics with the packed qkv
    projection ``in_proj`` [3d, d]; scores and softmax in fp32. Shapes
    [B, N, d]."""
    d = q_in.shape[-1]
    dh = d // num_heads
    w, b = p["in_proj"]["weight"].to(q_in.dtype), p["in_proj"]["bias"].to(q_in.dtype)
    q = F.linear(q_in, w[:d], b[:d])
    k = F.linear(k_in, w[d:2 * d], b[d:2 * d])
    v = F.linear(v_in, w[2 * d:], b[2 * d:])

    def split(x):  # [B, N, d] -> [B, h, N, dh]
        return x.unflatten(-1, (num_heads, dh)).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1).to(q_in.dtype)
    out = torch.matmul(probs.float(), vh.float()).to(q_in.dtype)
    return _linear(p["out_proj"], out.transpose(1, 2).flatten(2))


def sine_position_embedding(h: int, w: int, d_model: int, device=None) -> torch.Tensor:
    """DETR ``PositionEmbeddingSine`` (normalize=True, temperature 1e4,
    scale 2 pi) -> [h*w, d_model] float32: the first half y-features, the
    second x, each interleaved sin / cos."""
    half = d_model // 2
    eps = 1e-6
    scale = 2 * math.pi
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (h + eps) * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (w + eps) * scale
    dim_t = 10000.0 ** (2 * (torch.arange(half, device=device) // 2) / half)

    def enc(coord):  # [n] -> [n, half]
        v = coord[:, None] / dim_t[None, :]
        return torch.stack([torch.sin(v[:, 0::2]), torch.cos(v[:, 1::2])], dim=2).reshape(
            coord.shape[0], half)

    pos_y = enc(y).repeat_interleave(w, dim=0)  # y varies slowly
    pos_x = enc(x).repeat(h, 1)
    return torch.cat([pos_y, pos_x], dim=-1)


def detr_forward(params: dict, feat: torch.Tensor, num_heads: int,
                 return_intermediate: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """feat [B, C, H, W] (one pyramid level) -> (class logits [L, B, Q,
    NC+1] fp32, boxes [L, B, Q, 4] fp32 sigmoid cxcywh in [0, 1]); L is
    the decoder's depth, or 1 (the last layer) without
    ``return_intermediate``."""
    b, _, h, w = feat.shape
    mem = _linear(params["proj"], feat.flatten(2).transpose(1, 2))
    pos = sine_position_embedding(h, w, mem.shape[-1], mem.device).to(mem.dtype)[None]
    qpos = params["query_embed"].to(mem.dtype)[None]
    tgt = torch.zeros((b, *params["query_embed"].shape), dtype=mem.dtype, device=mem.device)
    mem_pos = mem + pos
    intermediates = []
    for lp in params["decoder"]:
        q = tgt + qpos
        tgt = _layer_norm(lp["ln1"], tgt + _attention(lp["self_attn"], q, q, tgt, num_heads))
        tgt = _layer_norm(lp["ln2"], tgt + _attention(lp["cross_attn"], tgt + qpos, mem_pos,
                                                      mem, num_heads))
        ff = _linear(lp["ffn2"], F.relu(_linear(lp["ffn1"], tgt)))
        tgt = _layer_norm(lp["ln3"], tgt + ff)
        intermediates.append(_layer_norm(params["decoder_norm"], tgt))
    hs = torch.stack(intermediates if return_intermediate else intermediates[-1:])
    logits = _linear(params["class_head"], hs).float()
    x = F.relu(_linear(params["bbox_mlp"]["fc1"], hs))
    x = F.relu(_linear(params["bbox_mlp"]["fc2"], x))
    boxes = torch.sigmoid(_linear(params["bbox_mlp"]["fc3"], x).float())
    return logits, boxes


# ------------------------------------------------------------------- loss


def match_cost(logits: torch.Tensor, boxes01: torch.Tensor, gt01: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """The matcher's cost of each problem (JAX ``_match_single``'s, as
    vmapped): logits [N, Q, K], boxes01 [N, Q, 4] and gt01 [N, G, 4]
    cxcywh in [0, 1], gt_labels / gt_valid [N, G] -> [N, G, Q] float32,
    the padded gt slots' rows 0 (a constant row cannot change what the
    real slots win)."""
    n, q, _ = logits.shape
    g = gt01.shape[1]
    prob = torch.softmax(logits.float(), dim=-1)
    cost_class = -torch.gather(prob, 2, gt_labels.long()[:, None, :].expand(n, q, g))
    cost_bbox = (boxes01[:, :, None, :] - gt01[:, None, :, :]).abs().sum(-1)
    cost_giou = -generalized_box_iou(cxcywh_to_xyxy(boxes01)[:, :, None, :],
                                     cxcywh_to_xyxy(gt01)[:, None, :, :])
    cost = BBOX_WEIGHT * cost_bbox + CLASS_WEIGHT * cost_class + GIOU_WEIGHT * cost_giou
    cost = torch.where(gt_valid[:, None, :], cost, torch.zeros_like(cost))
    return cost.transpose(1, 2)


def detr_loss_one_level(logits: torch.Tensor, boxes01: torch.Tensor, gt01: torch.Tensor,
                        gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                        num_boxes: torch.Tensor, eos_coef: float,
                        match: torch.Tensor) -> dict[str, torch.Tensor]:
    """One decoder layer's weighted losses: logits [B, Q, K] fp32, boxes01
    [B, Q, 4], gt01 [B, G, 4] cxcywh in [0, 1], match [B, G] (the query of
    each gt slot), ``num_boxes`` the batch's gt count (>= 1)."""
    b, q = logits.shape[:2]
    match = match.long()
    # the gt labels scattered onto their queries (padded slots give 0)
    tgt_class = torch.zeros((b, q), dtype=torch.int64, device=logits.device).scatter_reduce(
        1, match, torch.where(gt_valid, gt_labels.long(), 0), reduce="amax")
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, tgt_class[..., None])[..., 0]
    wts = torch.where(tgt_class == 0, eos_coef, 1.0)
    # torch's weighted-mean CE, over the global batch
    loss_ce = rank_share((wts * ce).sum()) / global_count(wts.sum())

    pred = torch.gather(boxes01, 1, match[..., None].expand(-1, -1, 4))  # [B, G, 4]
    l1 = (pred - gt01).abs().sum(-1)
    giou = generalized_box_iou(cxcywh_to_xyxy(pred), cxcywh_to_xyxy(gt01))
    zero = torch.zeros_like(l1)
    loss_bbox = rank_share(torch.where(gt_valid, l1, zero).sum()) / num_boxes
    loss_giou = rank_share(torch.where(gt_valid, 1.0 - giou, zero).sum()) / num_boxes
    return {"loss_ce": CLASS_WEIGHT * loss_ce, "loss_bbox": BBOX_WEIGHT * loss_bbox,
            "loss_giou": GIOU_WEIGHT * loss_giou}


def detr_match(logits: torch.Tensor, boxes01: torch.Tensor, gt01: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """The assignment of every (layer, image) problem in one solve:
    logits [L, B, Q, K], boxes01 [L, B, Q, 4] -> [L, B, G], the query of
    each gt slot; under ``no_grad`` and ``record_function("matcher")``."""
    n_l, b, q, k = logits.shape
    with record_function("matcher"), torch.no_grad():
        rep = (n_l, 1, 1)
        cost = match_cost(logits.detach().reshape(n_l * b, q, k),
                          boxes01.detach().reshape(n_l * b, q, 4), gt01.repeat(rep),
                          gt_labels.repeat(rep[:2]), gt_valid.repeat(rep[:2]))
        return linear_sum_assignment(cost).reshape(n_l, b, -1)


def detr_loss(logits: torch.Tensor, boxes01: torch.Tensor, gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor, gt_valid: torch.Tensor, image_size: int,
              eos_coef: float, aux_loss: bool,
              shared_matching: bool = False) -> dict[str, torch.Tensor]:
    """DETR's SetCriterion over the last decoder layer, and with
    ``aux_loss`` each earlier one (keys suffixed ``_aux{i}``), weights
    folded in. gt_boxes [B, G, 4] xyxy in image pixels.

    One matcher call solves every problem of the step: each (layer,
    image) pair, or with ``shared_matching`` the last layer's only, its
    assignment reused by every auxiliary loss (1/L of the solve, a
    departure from the paper)."""
    gt01 = xyxy_to_cxcywh(gt_boxes.float()) / image_size
    gt01 = torch.where(gt_valid[..., None], gt01, torch.zeros_like(gt01))
    num_boxes = global_count(gt_valid.sum()).clamp(min=1).float()  # over the global batch
    every = aux_loss and not shared_matching
    match = detr_match(logits if every else logits[-1:], boxes01 if every else boxes01[-1:],
                       gt01, gt_labels, gt_valid)
    losses = detr_loss_one_level(logits[-1], boxes01[-1], gt01, gt_labels, gt_valid,
                                 num_boxes, eos_coef, match[-1])
    if aux_loss:
        for i in range(logits.shape[0] - 1):
            aux = detr_loss_one_level(logits[i], boxes01[i], gt01, gt_labels, gt_valid,
                                      num_boxes, eos_coef, match[-1] if shared_matching
                                      else match[i])
            losses.update({f"{k}_aux{i}": v for k, v in aux.items()})
    return losses


# ---------------------------------------------------------------- predict


def detr_postprocess(logits: torch.Tensor, boxes01: torch.Tensor, image_size: int,
                     score_thresh: float) -> Detections:
    """logits [B, Q, K], boxes01 [B, Q, 4] (the last layer) -> every query
    a detection (its best foreground class), sorted by score (stable),
    ``valid = score > score_thresh``; boxes xyxy in image pixels."""
    prob = torch.softmax(logits.float(), dim=-1)
    fg = prob[..., 1:]
    scores = fg.amax(-1)
    labels = fg.argmax(-1).to(torch.int32) + 1
    boxes = clip_boxes_to_image(cxcywh_to_xyxy(boxes01.float()) * image_size, image_size,
                                image_size)
    order = torch.argsort(-scores, dim=-1, stable=True)
    scores = torch.gather(scores, 1, order)
    return Detections(boxes=torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
                      scores=scores, labels=torch.gather(labels, 1, order),
                      valid=scores > score_thresh)
