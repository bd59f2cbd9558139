"""Mask R-CNN head (port of ``layoutdit_tpu/models/detection/mask_head.py``):
torchvision's ``MaskRCNNHeads`` + ``MaskRCNNPredictor`` + ``maskrcnn_loss``
over the RoI pipeline, batched over images.

  * training runs the branch on the positive sampled slots only, the
    first ``max_pos`` slots of ``TrainingSamples`` (the sampler packs the
    positives first);
  * each target is the matched gt's mask cropped under its proposal by a
    single-channel RoIAlign (sampling ratio 1) over the [G, M, M] gt
    block, binarised at 0.5;
  * the head is 4 x (conv 3x3, ReLU), a 2x2 stride-2 transposed conv,
    ReLU, a 1x1 conv to NC+1 channels; each positive reads its own
    class's channel (channel 0, the background, is never trained or
    read);
  * the loss is BCE-with-logits averaged over the positives' pixels.

The convolutions are cuDNN's (``F.conv2d``, ``F.conv_transpose2d``), as
JAX computes them with XLA outside any Pallas kernel.

The transposed conv's weight is torch's ``ConvTranspose2d`` layout
[in, out, kH, kW]. The JAX tree stores JAX's ``conv_transpose`` kernel
[out, in, kH, kW] (OIHW), which with stride 2 and a 2x2 kernel computes
out[2i + a] = x[i] W[1 - a]: the carrier (``models/weights_io.py``)
transposes dims (0, 1) and flips both spatial dims.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.models.fpn import conv2d
from layoutdit_tpu_torch.ops.roi_align import roi_align
from layoutdit_tpu_torch.parallel.mesh import global_count, rank_share


def _kaiming_normal(shape, fan_out: int, generator, device) -> torch.Tensor:
    """torchvision's mask-head init: kaiming_normal_(fan_out, relu)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def init_mask_head_params(in_channels: int, num_classes_bg: int, generator, device,
                          hidden: int = 256, num_convs: int = 4) -> dict:
    params: dict = {}
    c_in = in_channels
    for i in range(num_convs):
        params[f"fcn{i + 1}"] = {
            "weight": _kaiming_normal((hidden, c_in, 3, 3), hidden * 9, generator, device),
            "bias": torch.zeros(hidden, device=device),
        }
        c_in = hidden
    params["deconv"] = {  # [in, out, 2, 2]: ConvTranspose2d's layout
        "weight": _kaiming_normal((c_in, hidden, 2, 2), hidden * 4, generator, device),
        "bias": torch.zeros(hidden, device=device),
    }
    params["logits"] = {
        "weight": _kaiming_normal((num_classes_bg, hidden, 1, 1), num_classes_bg, generator,
                                  device),
        "bias": torch.zeros(num_classes_bg, device=device),
    }
    return params


def mask_head_forward(params: dict, pooled: torch.Tensor) -> torch.Tensor:
    """[K, C, P, P] pooled RoI features -> [K, NC+1, 2P, 2P] float32 logits."""
    x = pooled
    i = 1
    while f"fcn{i}" in params:
        x = F.relu(conv2d(x, params[f"fcn{i}"], padding=1))
        i += 1
    d = params["deconv"]
    x = F.relu(F.conv_transpose2d(x, d["weight"].to(x.dtype), d["bias"].to(x.dtype), stride=2))
    return conv2d(x, params["logits"]).float()


def project_masks_on_boxes(
    gt_masks: torch.Tensor,  # [B, G, M, M] {0, 1}, M-space
    boxes: torch.Tensor,  # [B, K, 4] xyxy in image space
    matched_gt: torch.Tensor,  # [B, K] index into G
    image_size: int,
    out_size: int,
) -> torch.Tensor:
    """torchvision ``project_masks_on_boxes``: each matched gt mask cropped
    under its box to [out_size, out_size] by RoIAlign (sampling ratio 1),
    binarised at 0.5 -> [B, K, out, out] float32. The spatial scale
    M / image_size maps image-space boxes onto the M x M block.

    In JAX this is XLA's ``ops/roi_align.py::roi_align``, not a Pallas
    kernel; its counterpart on both devices is the port's separable
    ``roi_align`` (two batched float32 matmuls), not a fallback from a
    kernel."""
    b, k = matched_gt.shape
    m = gt_masks.shape[-1]
    idx = matched_gt[..., None, None].expand(-1, -1, m, m)
    per_roi = torch.gather(gt_masks.float(), 1, idx).reshape(b * k, 1, m, m)
    pooled = roi_align(per_roi, boxes.detach().reshape(b * k, 1, 4), m / float(image_size),
                       output_size=out_size, sampling_ratio=1)  # [B*K, 1, 1, P, P]
    return (pooled.reshape(b, k, out_size, out_size) >= 0.5).float()


def _own_class(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[K, NC+1, P, P] -> [K, P, P]: each row's channel ``labels``."""
    p = mask_logits.shape[-1]
    cls = labels.clamp(min=0).long()[:, None, None, None].expand(-1, 1, p, p)
    return torch.gather(mask_logits, 1, cls)[:, 0]


def maskrcnn_loss(
    mask_logits: torch.Tensor,  # [K, NC+1, P, P] positives-only slots
    labels: torch.Tensor,  # [K] 1..NC for the positives
    targets: torch.Tensor,  # [K, P, P] float {0, 1}
    pos_valid: torch.Tensor,  # [K] bool
) -> torch.Tensor:
    """torchvision ``maskrcnn_loss``: BCE-with-logits of each positive's
    own-class map, averaged over every positive pixel."""
    p = mask_logits.shape[-1]
    logit = _own_class(mask_logits, labels)
    bce = logit.clamp(min=0.0) - logit * targets + torch.log1p(torch.exp(-logit.abs()))
    bce = torch.where(pos_valid[:, None, None], bce, torch.zeros_like(bce))
    denom = global_count(pos_valid.sum()).clamp(min=1) * p * p  # over the global batch
    return rank_share(bce.sum()) / denom


def mask_probs_for_labels(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Inference: the sigmoid of each detection's own-class map
    (torchvision ``maskrcnn_inference``) -> [K, P, P] float32."""
    return torch.sigmoid(_own_class(mask_logits, labels).float())
