"""Configuration for the port: frozen dataclasses and a JSON loader.

A subset of the JAX package's pydantic schema (``config/constructs.py``)
with the same defaults: the two-stage ``DetectionBudget``, the serving
fields of ``ModelConfig`` and ``DataLoaderConfig``. The machine with the
GPU has no pydantic, so these are plain frozen dataclasses, and
``load_config`` reads ``detection_model_config`` and
``data_loader_config`` from the same JSON files the JAX package reads
(e.g. ``configs/serving_1024.json``). A key the port does not know
raises instead of being dropped.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class DetectionBudget:
    """Static budgets of the two-stage detector (torchvision FasterRCNN
    defaults; ``constructs.py::DetectionBudget``)."""

    rpn_pre_nms_top_n_train: int = 2000
    rpn_pre_nms_top_n_test: int = 1000
    rpn_post_nms_top_n_train: int = 2000
    rpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_fg_iou_thresh: float = 0.7
    rpn_bg_iou_thresh: float = 0.3
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_score_thresh: float = 0.0
    rpn_min_size: float = 1e-3
    rpn_nms_tile: int = 512

    box_fg_iou_thresh: float = 0.5
    box_bg_iou_thresh: float = 0.5
    box_batch_size_per_image: int = 512
    box_positive_fraction: float = 0.25
    box_reg_weights: tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_detections_per_img: int = 100
    box_nms_tile: int = 512


@dataclasses.dataclass(frozen=True)
class DataLoaderConfig:
    """Host input settings (``constructs.py::DataLoaderConfig``)."""

    batch_size: int = 16
    shuffle: bool = True
    num_workers: int = 2
    prefetch_depth: int = 2
    max_gt_boxes: int = 128
    augment_hflip: float = 0.0
    image_shards_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Serving fields of ``constructs.py::ModelConfig``, same defaults.

    ``attention_impl`` and ``roi_impl`` pick implementations of one
    function in the JAX package; the port keeps them for the config
    files' sake and routes by sequence length on the card
    (``models/vit.py``)."""

    backbone_type: str = "dit"
    num_classes: int = 5
    anchor_sizes: tuple[tuple[int, ...], ...] = ((32,), (64,), (128,), (256,), (512,))
    aspect_ratios: tuple[tuple[float, ...], ...] = ((0.5, 1.0, 2.0),) * 5
    image_size: int = 224
    image_mean: tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: tuple[float, float, float] = (0.5, 0.5, 0.5)
    fpn_out_channels: int = 256
    roi_output_size: int = 7
    roi_sampling_ratio: int = 2
    detection_budget: DetectionBudget = DetectionBudget()
    attention_impl: str = "auto"
    roi_impl: str = "xla"
    vit_overrides: Optional[dict] = None


def _tupled(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def _build(cls, data: dict, where: str):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(f"{where}: keys not supported by the port: {unknown}")
    kwargs = {}
    for k, v in data.items():
        if k == "detection_budget":
            v = _build(DetectionBudget, v, f"{where}.detection_budget")
        elif k != "vit_overrides":
            v = _tupled(v)
        kwargs[k] = v
    return cls(**kwargs)


def load_config(path: str) -> tuple[ModelConfig, DataLoaderConfig]:
    """Read ``detection_model_config`` and ``data_loader_config`` from a
    config JSON file; absent sections take their defaults."""
    with open(path) as f:
        raw = json.load(f)
    mc = _build(ModelConfig, raw.get("detection_model_config", {}),
                "detection_model_config")
    if mc.backbone_type != "dit":
        raise ValueError(
            f"backbone_type {mc.backbone_type!r}: the port serves dit-base only"
        )
    dl = _build(DataLoaderConfig, raw.get("data_loader_config", {}),
                "data_loader_config")
    return mc, dl
