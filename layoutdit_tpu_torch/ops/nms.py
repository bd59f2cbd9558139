"""Batched greedy NMS as a keep-mask (torchvision semantics).

Port of ``layoutdit_tpu/ops/nms.py``, same results: sort by score
(stable, descending), keep a box unless a previously KEPT box overlaps it
with IoU strictly greater than the threshold, tested division-free as
``inter > thr * union``; padding rows carry a score of -inf (or
``valid=False``) and neither survive nor suppress.

The greedy chain is resolved by the JAX package's exact monotone
fixpoint (kept/dead/unknown tri-state; every sweep settles at least the
highest-scoring unsettled box). Here it runs over ALL candidates of a
problem at once and over a leading batch of problems (images x FPN
levels for the RPN, images for the per-class stage), so one sweep serves
every problem. The JAX ``while_loop`` condition becomes a host read of
"did anything change"; that read is a device-to-host sync, so the loop
runs several sweeps between reads (a sweep after convergence changes
nothing), 4 at first and twice as many after each read that found the
fixpoint still moving, up to 64: a problem with a long suppression chain
(the evenly spaced, equally scored anchors of a blank page settle about
one box per sweep) costs a logarithmic number of reads. The reads are
counted in ``nms_mask.host_syncs``.
The JAX version's ``tile`` is a scheduling choice that does not change
the result, so the port has no such parameter.
"""

from __future__ import annotations

import torch

FIRST_SWEEPS = 4
MAX_SWEEPS = 64


def _greedy_fixpoint(overlap: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """overlap [G, N, N] bool (r < c in score order and IoU > thr);
    alive [G, N] -> kept [G, N] (exact greedy)."""
    kept = torch.zeros_like(alive)
    dead = ~alive
    sweeps = FIRST_SWEEPS
    while True:
        kept0, dead0 = kept, dead
        for _ in range(sweeps):
            unknown = ~kept & ~dead
            by_kept = (overlap & kept[..., :, None]).any(dim=-2)
            dead = dead | (alive & by_kept)
            blocker = kept | (unknown & alive)
            by_blocker = (overlap & blocker[..., :, None]).any(dim=-2)
            kept = kept | (alive & ~dead & ~by_blocker)
        nms_mask.host_syncs += 1
        if not bool(((kept != kept0) | (dead != dead0)).any()):
            return kept
        sweeps = min(2 * sweeps, MAX_SWEEPS)


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy NMS keep-mask over a batch of problems.

    Args:
      boxes: [..., N, 4] xyxy.
      scores: [..., N]; padding should be -inf (or pass ``valid``).
      iou_threshold: suppress when IoU > threshold (strict).
      valid: optional [..., N] bool; False rows are never kept and never
        suppress.

    Returns:
      [..., N] bool keep-mask in the ORIGINAL box order.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    if n == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    if valid is not None:
        scores = torch.where(valid.reshape(-1, n), scores, float("-inf"))
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.isfinite(torch.gather(scores, 1, order))

    x1, y1, x2, y2 = boxes_s.unbind(-1)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    iw = torch.minimum(x2[:, :, None], x2[:, None, :]) - torch.maximum(
        x1[:, :, None], x1[:, None, :]
    )
    ih = torch.minimum(y2[:, :, None], y2[:, None, :]) - torch.maximum(
        y1[:, :, None], y1[:, None, :]
    )
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    union = area[:, :, None] + area[:, None, :] - inter
    overlap = inter > iou_threshold * union
    overlap &= torch.ones(n, n, dtype=torch.bool, device=overlap.device).triu(1)

    kept = _greedy_fixpoint(overlap, valid_s)
    keep = torch.zeros_like(kept).scatter(1, order, kept)
    return keep.reshape(*lead, n)


nms_mask.host_syncs = 0


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Category-aware NMS (torchvision batched_nms coordinate offset):
    boxes [..., N, 4] with different ``idxs`` never suppress each other.
    The offset is taken per problem, as the JAX version vmapped per
    image does."""
    if boxes.shape[-2] == 0:
        return torch.zeros(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    finite = torch.where(torch.isfinite(boxes), boxes, 0.0)
    max_coord = finite.amax(dim=(-2, -1), keepdim=True)[..., 0]  # [..., 1]
    offsets = idxs.to(boxes.dtype) * (max_coord + 1.0)
    shifted = boxes + offsets[..., None]
    return nms_mask(shifted, scores, iou_threshold, valid=valid)
