"""The DiT + FPN + Faster R-CNN detector at inference (port of the
``faster_rcnn`` path of ``layoutdit_tpu/models/detection/detector.py``).

``detector_predict(params, images, cfg)``: images [B, 3, S, S] in [0, 1]
-> padded per-image ``Detections`` in S-space; ``rescale_detections``
maps them back to page coordinates. Cascade, masks and the single-stage
families are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.profiler import record_function

from layoutdit_tpu_torch.config import DetectionBudget, ModelConfig
from layoutdit_tpu_torch.models import vit as vit_mod
from layoutdit_tpu_torch.models.backbone import (
    BackboneConfig,
    backbone_forward,
    init_backbone_params,
)
from layoutdit_tpu_torch.models.detection.anchors import grid_anchors
from layoutdit_tpu_torch.models.detection.heads import (
    box_head_forward,
    init_box_head_params,
    init_predictor_params,
    init_rpn_head_params,
    predictor_forward,
    rpn_head_forward,
)
from layoutdit_tpu_torch.models.detection.roi_heads import (
    Detections,
    postprocess_detections,
)
from layoutdit_tpu_torch.models.detection.rpn import filter_proposals
from layoutdit_tpu_torch.ops.roi_align import multiscale_roi_align

BOX_HEAD_REP = 1024


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static model description (subset of the JAX DetectorConfig)."""

    backbone: BackboneConfig = BackboneConfig()
    num_classes: int = 5
    image_size: int = 224
    image_mean: tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: tuple[float, float, float] = (0.5, 0.5, 0.5)
    anchor_sizes: tuple[tuple[float, ...], ...] = ((32,), (64,), (128,), (256,), (512,))
    aspect_ratios: tuple[tuple[float, ...], ...] = ((0.5, 1.0, 2.0),) * 5
    roi_output_size: int = 7
    roi_sampling_ratio: int = 2
    budget: DetectionBudget = DetectionBudget()
    compute_dtype: str = "float32"

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.anchor_sizes[0]) * len(self.aspect_ratios[0])

    @property
    def grid_sizes(self) -> tuple[tuple[int, int], ...]:
        g = self.image_size // self.backbone.vit.patch_size
        sizes = [int(g * s) for s in self.backbone.scales]
        sizes.append((sizes[-1] + 1) // 2)  # pool level: ceil(p5/2)
        return tuple((s, s) for s in sizes)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @classmethod
    def from_model_config(cls, mc: ModelConfig, precision_dtype: str = "float32"):
        vit_cfg = vit_mod.DIT_BASE
        overrides = dict(mc.vit_overrides or {})
        ov_size = overrides.pop("image_size", mc.image_size)
        if ov_size != mc.image_size:
            raise ValueError(
                f"vit_overrides.image_size={ov_size} conflicts with "
                f"detection_model_config.image_size={mc.image_size}"
            )
        vit_cfg = dataclasses.replace(vit_cfg, image_size=mc.image_size, **overrides)
        return cls(
            backbone=BackboneConfig(vit=vit_cfg, fpn_out_channels=mc.fpn_out_channels),
            num_classes=mc.num_classes,
            image_size=mc.image_size,
            image_mean=tuple(mc.image_mean),
            image_std=tuple(mc.image_std),
            anchor_sizes=tuple(tuple(float(x) for x in s) for s in mc.anchor_sizes),
            aspect_ratios=tuple(tuple(float(x) for x in r) for r in mc.aspect_ratios),
            roi_output_size=mc.roi_output_size,
            roi_sampling_ratio=mc.roi_sampling_ratio,
            budget=mc.detection_budget,
            compute_dtype=precision_dtype,
        )


class DetectorModel(NamedTuple):
    """What the serving engine needs: parameters and their config."""

    params: dict
    cfg: DetectorConfig


def init_detector(cfg: DetectorConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters with the JAX package's init distributions,
    drawn from ``generator`` (which must live on ``device``)."""
    c = cfg.backbone.fpn_out_channels
    in_features = c * cfg.roi_output_size ** 2
    return {
        "backbone": init_backbone_params(cfg.backbone, generator, device),
        "rpn_head": init_rpn_head_params(c, cfg.num_anchors_per_cell, generator, device),
        "box_head": init_box_head_params(in_features, BOX_HEAD_REP, generator, device),
        "box_predictor": init_predictor_params(
            BOX_HEAD_REP, cfg.num_classes + 1, generator, device
        ),
    }


# kept in float32: LayerNorm applies them in fp32, and the position
# embeddings are resampled in fp32 before the cast
_FP32_PARAMS = ("ln1", "ln2", "pos_embed")


def params_for_inference(params: dict, dtype: torch.dtype) -> dict:
    """A copy of ``params`` with every tensor that the forward pass casts
    to the compute dtype at each use already in that dtype (the same
    rounding, done once instead of per call)."""
    def cast(tree, name=""):
        if name in _FP32_PARAMS:
            return tree
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, name) for v in tree]
        return tree.to(dtype)

    return cast(params)


def _normalize(images: torch.Tensor, cfg: DetectorConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.image_std, dtype=torch.float32, device=images.device)
    return (images - mean[None, :, None, None]) / std[None, :, None, None]


@functools.lru_cache(maxsize=16)
def _anchors(cfg: DetectorConfig, device: torch.device) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Anchors of one bucket, copied to the device once."""
    a, counts = grid_anchors(
        (cfg.image_size, cfg.image_size), cfg.grid_sizes, cfg.anchor_sizes,
        cfg.aspect_ratios,
    )
    return torch.from_numpy(a).to(device), counts


def detector_predict(
    params: dict, images: torch.Tensor, cfg: DetectorConfig
) -> Detections:
    """Inference -> padded per-image detections (boxes in S-space).

    Its stages run under ``torch.profiler.record_function`` ranges
    (``backbone``, ``rpn``, ``roi_heads``, ``postprocess``) so a profiler
    trace splits a request by stage; without a profiler they cost a few
    microseconds."""
    anchors, counts = _anchors(cfg, images.device)
    size = (cfg.image_size, cfg.image_size)
    with record_function("backbone"):
        x = _normalize(images.float(), cfg).to(cfg.dtype)
        feats = backbone_forward(
            params["backbone"], x, cfg.backbone, compute_dtype=cfg.dtype
        )
    with record_function("rpn"):
        objectness, deltas = rpn_head_forward(
            params["rpn_head"], feats, cfg.num_anchors_per_cell
        )
        props = filter_proposals(objectness, deltas, anchors, counts, size, cfg.budget)
    with record_function("roi_heads"):
        b, k = props.boxes.shape[:2]
        pooled = multiscale_roi_align(
            feats, props.boxes, list(cfg.backbone.spatial_scales),
            output_size=cfg.roi_output_size,
            sampling_ratio=cfg.roi_sampling_ratio,
            canonical_scale=float(cfg.image_size),
            roi_mask=props.valid,
            native_layout=True,
        )  # [B, K, Px, Py, C]
        rep = box_head_forward(
            params["box_head"], pooled.reshape(b * k, *pooled.shape[2:]).to(cfg.dtype)
        )
        class_logits, box_regression = predictor_forward(params["box_predictor"], rep)
    with record_function("postprocess"):
        return postprocess_detections(
            class_logits.reshape(b, k, -1), box_regression.reshape(b, k, -1),
            props.boxes, props.valid, size, cfg.budget,
        )


def rescale_detections(
    dets: Detections, orig_sizes: torch.Tensor, image_size: int
) -> Detections:
    """Map boxes from model space back to original page space.

    orig_sizes: [B, 2] (height, width).
    """
    ratio_h = orig_sizes[:, 0:1] / image_size
    ratio_w = orig_sizes[:, 1:2] / image_size
    scale = torch.stack([ratio_w, ratio_h, ratio_w, ratio_h], dim=-1)  # [B, 1, 4]
    return dets._replace(boxes=dets.boxes * scale)
