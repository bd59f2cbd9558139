"""The DiT + FPN detector (port of
``layoutdit_tpu/models/detection/detector.py``) in three families
(``detector_kind``): Faster R-CNN with its two modifiers, the Cascade
R-CNN head (``cascade_iou_threshs``: one box head and class-agnostic
predictor per stage, ``cascade.py``) and the Mask R-CNN branch
(``with_mask``: ``mask_head.py``); and the single-stage RetinaNet
(``retinanet.py``) and FCOS (``fcos.py``), whose heads run on a subset of
the pyramid (``retinanet_levels``, ``fcos_levels``) with no proposal or
RoI stage; and the set-prediction DETR (``detr.py``), whose decoder
cross-attends to one level (``detr_level``) and whose loss matches its
queries to the gt by an exact Hungarian assignment (``ops/matching.py``).

``detector_predict(params, images, cfg)``: images [B, 3, S, S] in [0, 1]
-> padded per-image ``Detections`` in S-space, and with
``with_masks=True`` also each detection's own-class mask probabilities
[B, D, 2P, 2P]; ``rescale_detections`` maps the boxes back to page
coordinates. ``detector_loss(params, images, gt ..., cfg, priorities,
gt_masks)`` -> the four training losses, and ``loss_mask`` for a mask
model; a single-stage model gives torchvision's loss keys
(``loss_classification``, ``loss_bbox_reg`` and FCOS's
``loss_bbox_ctrness``); DETR ``loss_ce``, ``loss_bbox`` and ``loss_giou``,
and with ``detr_aux_loss`` the same per earlier decoder layer, suffixed
``_aux{i}``. DETR predicts ``detr_num_queries`` detections an image, with
no NMS.

The backbone (``run_backbone``) is the DiT pyramid or, with
``backbone_kind`` "resnet50", ResNet-50 + FPN (``models/resnet.py``),
whose RoI heads pool from p2..p5 only, as torchvision's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from layoutdit_tpu_torch.config import DetectionBudget, ModelConfig
from layoutdit_tpu_torch.models import resnet as resnet_mod
from layoutdit_tpu_torch.models import vit as vit_mod
from layoutdit_tpu_torch.models.backbone import (
    BackboneConfig,
    backbone_forward,
    init_backbone_params,
)
from layoutdit_tpu_torch.models.detection import cascade as cascade_mod
from layoutdit_tpu_torch.models.detection import detr as detr_mod
from layoutdit_tpu_torch.models.detection import fcos as fcos_mod
from layoutdit_tpu_torch.models.detection import mask_head as mask_mod
from layoutdit_tpu_torch.models.detection import retinanet as retina_mod
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
    fastrcnn_loss,
    postprocess_detections,
    select_training_samples,
)
from layoutdit_tpu_torch.models.detection.rpn import filter_proposals, rpn_loss
from layoutdit_tpu_torch.ops.roi_align import multiscale_roi_align
from layoutdit_tpu_torch.parallel.mesh import ModelGroup
from layoutdit_tpu_torch.utils.cache import cached_unless_traced

BOX_HEAD_REP = 1024


def _vit_overrides(overrides: dict) -> dict:
    """``vit_overrides`` as ``ViTConfig`` fields (the MoE keys and
    ``score_dtype`` among them); a key that is not one raises."""
    fields = {f.name for f in dataclasses.fields(vit_mod.ViTConfig)}
    out = {}
    for k, v in overrides.items():
        if k not in fields:
            raise ValueError(f"vit_overrides.{k}={v!r}: not a field of the encoder's config")
        # JSON carries lists; the config stays hashable
        out[k] = tuple(v) if k in ("global_attn_layers", "lora_targets") else v
    return out


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
    remat: bool = False
    remat_policy: str = "full"  # "full" | "dots"; see vit_forward
    # "ring": ring attention under sequence parallelism (vit_forward);
    # every other value routes by sequence length, as "ring" without it
    attention_impl: str = "auto"
    # Cascade R-CNN: per-stage foreground IoU thresholds (empty = one
    # box head), and per-stage loss weights (empty = the paper's,
    # cascade.DEFAULT_STAGE_LOSS_WEIGHTS, cut to the stage count)
    cascade_iou_threshs: tuple[float, ...] = ()
    cascade_stage_loss_weights: tuple[float, ...] = ()
    # Mask R-CNN: the branch, its RoI pool size (masks come out at twice
    # that), and the side M of the [B, G, M, M] gt block (0: image_size // 2)
    with_mask: bool = False
    mask_roi_output_size: int = 14
    mask_gt_size: int = 0
    # the family: "faster_rcnn", or the single-stage "retinanet" and
    # "fcos", whose heads run on these pyramid levels (indices into
    # p2..p5 + pool); RetinaNet's anchor rows follow the same indices,
    # FCOS's reference points are stride-sized squares
    detector_kind: str = "faster_rcnn"
    retinanet_levels: tuple[int, ...] = (1, 2, 3, 4)
    fcos_levels: tuple[int, ...] = (1, 2, 3, 4)
    # DETR's decoder (facebookresearch/detr's defaults), its loss's
    # background weight, auxiliary losses, one shared assignment, and the
    # pyramid level it cross-attends to (2: stride 16)
    detr_num_queries: int = 100
    detr_layers: int = 6
    detr_dim: int = 256
    detr_heads: int = 8
    detr_ffn_dim: int = 2048
    detr_eos_coef: float = 0.1
    detr_aux_loss: bool = True
    detr_level: int = 2
    detr_shared_matching: bool = False
    # "dit" (the ViT pyramid) or "resnet50" (models/resnet.py), whose RoI
    # heads pool from p2..p5 only, no pool level, as torchvision's do
    backbone_kind: str = "dit"

    def __post_init__(self):
        """JAX's ``__post_init_validate__``: no cascade or mask modifier
        on a single-stage or set-prediction family, its levels inside the
        pyramid, DETR's width a multiple of its heads."""
        kind = self.detector_kind
        if kind not in ("faster_rcnn", "retinanet", "fcos", "detr"):
            raise ValueError(f"unknown detector_kind {kind!r}")
        if kind == "faster_rcnn":
            return
        if self.cascade_iou_threshs:
            raise ValueError("cascade_iou_threshs is a Faster R-CNN modifier; "
                             f"detector={kind!r} has no cascade variant")
        if self.with_mask:
            raise ValueError(f"with_mask requires the RoI pipeline; detector={kind!r} has no "
                             "mask branch")
        if kind == "detr":
            n_levels = len(self.grid_sizes)
            if not 0 <= self.detr_level < n_levels:
                raise ValueError(f"detr_level {self.detr_level} out of range for the "
                                 f"{n_levels}-level pyramid")
            if self.detr_dim % self.detr_heads:
                raise ValueError("detr_dim must divide by detr_heads")
            return
        levels = self.one_stage_levels
        n_levels = len(self.grid_sizes)
        if not levels or any(not 0 <= i < n_levels for i in levels):
            raise ValueError(f"{kind}_levels {levels} out of range for the {n_levels}-level "
                             "pyramid")
        if kind == "retinanet" and len({len(self.anchor_sizes[i]) * len(self.aspect_ratios[i])
                                        for i in levels}) != 1:
            raise ValueError(f"retinanet_levels {levels}: every level needs the same number "
                             "of anchors a cell (one shared head)")

    @property
    def one_stage_levels(self) -> tuple[int, ...]:
        """The pyramid levels a single-stage head runs on."""
        return self.retinanet_levels if self.detector_kind == "retinanet" else self.fcos_levels

    @property
    def num_anchors_per_cell(self) -> int:
        """Anchors a cell: the RPN's (level 0's row), or RetinaNet's over
        its levels (the same on each)."""
        lv = self.retinanet_levels[0] if self.detector_kind == "retinanet" else 0
        return len(self.anchor_sizes[lv]) * len(self.aspect_ratios[lv])

    @property
    def gt_mask_size(self) -> int:
        return self.mask_gt_size or self.image_size // 2

    @property
    def cascade_reg_weights(self) -> tuple[tuple[float, float, float, float], ...]:
        """Per-stage BoxCoder weights: the paper's for the first three
        stages, the last repeated beyond."""
        d = cascade_mod.DEFAULT_STAGE_REG_WEIGHTS
        return tuple(d[min(i, len(d) - 1)] for i in range(len(self.cascade_iou_threshs)))

    @property
    def cascade_loss_weights(self) -> tuple[float, ...]:
        if self.cascade_stage_loss_weights:
            return self.cascade_stage_loss_weights
        d = cascade_mod.DEFAULT_STAGE_LOSS_WEIGHTS
        return tuple(d[min(i, len(d) - 1)] for i in range(len(self.cascade_iou_threshs)))

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
        """As JAX ``detector.py:166-194``: the backbone type's preset, then
        ``vit_overrides``, the image size and the windows over it."""
        vit_cfg = vit_mod.DIT_LARGE if mc.backbone_type == "dit-large" else vit_mod.DIT_BASE
        overrides = _vit_overrides(mc.vit_overrides or {})
        ov_size = overrides.pop("image_size", mc.image_size)
        if ov_size != mc.image_size:
            raise ValueError(
                f"vit_overrides.image_size={ov_size} conflicts with "
                f"detection_model_config.image_size={mc.image_size}"
            )
        vit_cfg = dataclasses.replace(vit_cfg, image_size=mc.image_size, **overrides)
        if mc.window_size > 0:  # JAX detector.py:189-194
            vit_cfg = dataclasses.replace(vit_cfg, window_size=mc.window_size,
                                          global_attn_layers=tuple(mc.window_global_layers))
        if mc.lora_rank > 0:  # JAX detector.py:195-206
            if mc.backbone_type == "resnet50":
                raise ValueError("lora_rank targets the pretrained DiT/BEiT encoder; the "
                                 "resnet50 backbone has no LoRA support")
            vit_cfg = dataclasses.replace(vit_cfg, lora_rank=mc.lora_rank,
                                          lora_alpha=mc.lora_alpha,
                                          lora_targets=tuple(mc.lora_targets))
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
            remat=mc.remat,
            remat_policy=mc.remat_policy,
            attention_impl=mc.attention_impl,
            cascade_iou_threshs=tuple(mc.cascade_iou_threshs),
            with_mask=mc.with_mask,
            detector_kind=mc.detector,
            retinanet_levels=tuple(mc.retinanet_levels),
            fcos_levels=tuple(mc.fcos_levels),
            detr_num_queries=mc.detr_num_queries,
            detr_layers=mc.detr_layers,
            detr_dim=mc.detr_dim,
            detr_heads=mc.detr_heads,
            detr_ffn_dim=mc.detr_ffn_dim,
            detr_eos_coef=mc.detr_eos_coef,
            detr_aux_loss=mc.detr_aux_loss,
            detr_level=mc.detr_level,
            detr_shared_matching=mc.detr_shared_matching,
            backbone_kind="resnet50" if mc.backbone_type == "resnet50" else "dit",
        )

    @property
    def roi_levels(self) -> int:
        """The pyramid levels the RoI heads pool from: p2..p5 + pool for
        the DiT pyramid, p2..p5 for ResNet-50 (torchvision's featmap names
        "0".."3")."""
        return 4 if self.backbone_kind == "resnet50" else 5


class DetectorModel(NamedTuple):
    """What the serving engine needs: parameters and their config."""

    params: dict
    cfg: DetectorConfig


def init_detector(cfg: DetectorConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters with the JAX package's init distributions,
    drawn from ``generator`` (which must live on ``device``). A cascade
    model has ``cascade_heads/s{i}`` (a box head and a class-agnostic
    predictor per stage) in place of ``box_head`` and ``box_predictor``;
    a mask model also has ``mask_head``. A single-stage model has the
    backbone and ``retinanet_head`` or ``fcos_head`` only, DETR the
    backbone and ``detr``."""
    c = cfg.backbone.fpn_out_channels
    in_features = c * cfg.roi_output_size ** 2
    if cfg.backbone_kind == "resnet50":
        backbone = resnet_mod.init_resnet_fpn_params(generator, device, c)
    else:
        backbone = init_backbone_params(cfg.backbone, generator, device)
    if cfg.detector_kind == "retinanet":
        return {"backbone": backbone, "retinanet_head": retina_mod.init_retinanet_head_params(
            c, cfg.num_anchors_per_cell, cfg.num_classes + 1, generator, device)}
    if cfg.detector_kind == "fcos":
        return {"backbone": backbone, "fcos_head": fcos_mod.init_fcos_head_params(
            c, cfg.num_classes + 1, generator, device)}
    if cfg.detector_kind == "detr":
        return {"backbone": backbone, "detr": detr_mod.init_detr_params(
            c, cfg.num_classes + 1, generator, device, d_model=cfg.detr_dim,
            num_layers=cfg.detr_layers, ffn_dim=cfg.detr_ffn_dim,
            num_queries=cfg.detr_num_queries)}
    params = {
        "backbone": backbone,
        "rpn_head": init_rpn_head_params(c, cfg.num_anchors_per_cell, generator, device),
    }
    if cfg.cascade_iou_threshs:
        params["cascade_heads"] = {
            f"s{i}": {
                "box_head": init_box_head_params(in_features, BOX_HEAD_REP, generator, device),
                "box_predictor": init_predictor_params(
                    BOX_HEAD_REP, cfg.num_classes + 1, generator, device, reg_classes=1
                ),
            }
            for i in range(len(cfg.cascade_iou_threshs))
        }
    else:
        params["box_head"] = init_box_head_params(in_features, BOX_HEAD_REP, generator, device)
        params["box_predictor"] = init_predictor_params(
            BOX_HEAD_REP, cfg.num_classes + 1, generator, device
        )
    if cfg.with_mask:
        params["mask_head"] = mask_mod.init_mask_head_params(c, cfg.num_classes + 1, generator,
                                                             device)
    return params


# kept in float32: LayerNorm applies them in fp32 (DETR's decoder has
# ln1-3 and decoder_norm), the position embeddings are resampled in fp32
# before the cast, the relative-position bias enters the scores in fp32,
# a ResNet's BatchNorm folds its statistics in fp32, and an MoE router
# computes its logits in fp32
_FP32_PARAMS = ("ln1", "ln2", "ln3", "decoder_norm", "pos_embed", "rel_pos_table",
                "shared_rel_pos_table", "bn", "bn1", "bn2", "bn3", "router")
# whose biases stay float32: the experts add them to fp32 accumulators
_FP32_BIASES = ("moe_in", "moe_out")


def params_for_inference(params: dict, dtype: torch.dtype) -> dict:
    """A copy of ``params`` with every tensor that the forward pass casts
    to the compute dtype at each use already in that dtype (the same
    rounding, done once instead of per call). An int8 linear
    (``ops/quant.py``) stays as it is: its int8 codes, and its scales and
    bias, which it applies in float32."""
    def cast(tree, name=""):
        if name in _FP32_PARAMS:
            return tree
        if isinstance(tree, dict):
            if "weight_q" in tree:
                return tree
            return {k: v if k == "bias" and name in _FP32_BIASES else cast(v, k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, name) for v in tree]
        return tree.to(dtype)

    return cast(params)


def _normalize(images: torch.Tensor, cfg: DetectorConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.image_std, dtype=torch.float32, device=images.device)
    return (images - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)


def run_backbone(params: dict, images: torch.Tensor, cfg: DetectorConfig,
                 remat: bool = False, aux_out: dict | None = None,
                 tp: ModelGroup | None = None, pipeline=None) -> list[torch.Tensor]:
    """Images [B, 3, S, S] in [0, 1] -> the pyramid [p2, p3, p4, p5, pool],
    channels-last in the compute dtype, from the DiT encoder or ResNet-50
    (JAX ``_run_backbone``); ``remat``: the encoder's activation
    checkpointing, as the config sets it (a ResNet has none); ``aux_out``
    receives the DiT encoder's ``"moe_aux"``; ``tp``: this rank's model
    group (tensor, sequence and expert parallelism of the encoder,
    ``models/vit.py``), the pyramid the same on every rank of it;
    ``pipeline``: the encoder's GPipe stages (``vit_forward``)."""
    x = _normalize(images.float(), cfg).to(cfg.dtype)
    if cfg.backbone_kind == "resnet50":
        if tp is not None and tp.size > 1:
            raise ValueError("model_parallel > 1 shards the DiT encoder; a ResNet-50 "
                             "backbone has no model-parallel layout")
        if pipeline is not None:
            raise ValueError("pipeline_parallel > 1 stages the DiT encoder's layers; a "
                             "ResNet-50 backbone has no pipeline layout")
        return resnet_mod.resnet_fpn_forward(params["backbone"], x, compute_dtype=cfg.dtype)
    return backbone_forward(params["backbone"], x, cfg.backbone, compute_dtype=cfg.dtype,
                            remat=remat and cfg.remat, remat_policy=cfg.remat_policy,
                            aux_out=aux_out, tp=tp, attention_impl=cfg.attention_impl,
                            pipeline=pipeline)


def _with_moe_aux(losses: dict, aux_out: dict, cfg: DetectorConfig) -> dict:
    """``loss_moe_aux`` = ``moe_aux_weight`` x the encoder's summed
    load-balance loss, for a DiT backbone with experts (JAX
    ``detector.py:643-650``); the trainer sums it with the others."""
    vit = cfg.backbone.vit
    if cfg.backbone_kind == "dit" and vit.num_experts > 0:
        losses["loss_moe_aux"] = vit.moe_aux_weight * aux_out["moe_aux"]
    return losses


@cached_unless_traced(maxsize=16)
def _anchors(cfg: DetectorConfig, device: torch.device) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Anchors of one bucket, copied to the device once: the RPN's over
    every level; RetinaNet's over its levels, the anchor rows of the same
    indices (JAX ``_retinanet_anchors``); FCOS's one stride-sized square
    a cell over its levels, the stride ``image_size // grid`` (JAX
    ``_fcos_anchors``: 56 px for the pool level at 224 px)."""
    size = (cfg.image_size, cfg.image_size)
    if cfg.detector_kind == "faster_rcnn":
        a, counts = grid_anchors(size, cfg.grid_sizes, cfg.anchor_sizes, cfg.aspect_ratios)
    else:
        lv = cfg.one_stage_levels
        grids = tuple(cfg.grid_sizes[i] for i in lv)
        if cfg.detector_kind == "retinanet":
            sizes = tuple(cfg.anchor_sizes[i] for i in lv)
            ratios = tuple(cfg.aspect_ratios[i] for i in lv)
        else:
            sizes = tuple((float(cfg.image_size // g[0]),) for g in grids)
            ratios = ((1.0,),) * len(lv)
        a, counts = grid_anchors(size, grids, sizes, ratios)
    return torch.from_numpy(a).to(device), counts


def _pool_and_predict(head: dict, feats, rois, roi_valid, cfg: DetectorConfig, tp=None):
    """RoIs [B, K, 4] -> (class_logits [B, K, NC+1], box_regression
    [B, K, R*4]) through one box head (``head``: the model's, or one
    cascade stage's), pooled at ``roi_output_size`` by RoIAlign."""
    b, k = rois.shape[:2]
    n = cfg.roi_levels
    pooled = multiscale_roi_align(
        feats[:n], rois, list(cfg.backbone.spatial_scales[:n]),
        output_size=cfg.roi_output_size,
        sampling_ratio=cfg.roi_sampling_ratio,
        canonical_scale=float(cfg.image_size),
        roi_mask=roi_valid,
        native_layout=True,
    )  # [B, K, Px, Py, C]
    rep = box_head_forward(
        head["box_head"], pooled.reshape(b * k, *pooled.shape[2:]).to(cfg.dtype), tp
    )
    class_logits, box_regression = predictor_forward(head["box_predictor"], rep)
    return class_logits.reshape(b, k, -1), box_regression.reshape(b, k, -1)


def _base_head(params: dict) -> dict:
    return {"box_head": params["box_head"], "box_predictor": params["box_predictor"]}


def _mask_logits(params: dict, feats, rois, roi_valid, cfg: DetectorConfig) -> torch.Tensor:
    """RoIs [B, K, 4] -> mask logits [B, K, NC+1, 2P, 2P] (P =
    ``mask_roi_output_size``): RoIAlign at P, then the mask head, under a
    ``record_function("mask_head")`` range. The pooled [B, K, Px, Py, C]
    is copied to [B*K, C, Py, Px] for the convolutions."""
    with record_function("mask_head"):
        b, k = rois.shape[:2]
        n = cfg.roi_levels
        pooled = multiscale_roi_align(
            feats[:n], rois, list(cfg.backbone.spatial_scales[:n]),
            output_size=cfg.mask_roi_output_size,
            sampling_ratio=cfg.roi_sampling_ratio,
            canonical_scale=float(cfg.image_size),
            roi_mask=roi_valid,
        )  # [B, K, C, Py, Px], a permuted view of the kernel's layout
        x = pooled.reshape(b * k, *pooled.shape[2:]).to(cfg.dtype).contiguous()
        logits = mask_mod.mask_head_forward(params["mask_head"], x)
        return logits.reshape(b, k, *logits.shape[1:])


def _cascade_predict(params: dict, feats, props, cfg: DetectorConfig, tp=None) -> Detections:
    """Boxes refined through every stage (``roi_heads``); the stages'
    posteriors averaged, then per-class NMS (``postprocess``)."""
    size = (cfg.image_size, cfg.image_size)
    boxes, valid = props.boxes, props.valid
    per_stage_logits = []
    with record_function("roi_heads"):
        for i in range(len(cfg.cascade_iou_threshs)):
            class_logits, box_reg = _pool_and_predict(
                params["cascade_heads"][f"s{i}"], feats, boxes, valid, cfg, tp
            )
            per_stage_logits.append(class_logits)
            boxes = cascade_mod.refine_boxes(boxes, box_reg, cfg.cascade_reg_weights[i], size)
    with record_function("postprocess"):
        scores = cascade_mod.cascade_mean_scores(per_stage_logits)
        return cascade_mod.postprocess_cascade(scores, boxes, valid, cfg.budget)


def _one_stage_heads(params: dict, feats, cfg: DetectorConfig) -> tuple:
    """The single-stage head over its levels: RetinaNet's (cls_logits,
    deltas), FCOS's (cls_logits, ltrb, ctrness)."""
    lv = [feats[i] for i in cfg.one_stage_levels]
    if cfg.detector_kind == "retinanet":
        return retina_mod.retinanet_head_forward(params["retinanet_head"], lv,
                                                 cfg.num_anchors_per_cell)
    return fcos_mod.fcos_head_forward(params["fcos_head"], lv)


def _one_stage_predict(params: dict, images: torch.Tensor, cfg: DetectorConfig,
                       tp=None) -> Detections:
    """RetinaNet's or FCOS's inference under the ranges ``backbone``,
    ``head`` and ``postprocess``."""
    anchors, counts = _anchors(cfg, images.device)
    size = (cfg.image_size, cfg.image_size)
    with record_function("backbone"):
        feats = run_backbone(params, images, cfg, tp=tp)
    with record_function("head"):
        out = _one_stage_heads(params, feats, cfg)
    with record_function("postprocess"):
        if cfg.detector_kind == "retinanet":
            return retina_mod.retinanet_postprocess(*out, anchors, counts, size, cfg.budget)
        return fcos_mod.fcos_postprocess(*out, anchors, counts, size, cfg.budget)


def _detr_predict(params: dict, images: torch.Tensor, cfg: DetectorConfig,
                  tp=None) -> Detections:
    """DETR's inference under the ranges ``backbone``, ``head`` (the
    decoder and its heads, the last layer only) and ``postprocess``."""
    with record_function("backbone"):
        feats = run_backbone(params, images, cfg, tp=tp)
    with record_function("head"):
        logits, boxes01 = detr_mod.detr_forward(params["detr"], feats[cfg.detr_level],
                                                cfg.detr_heads, return_intermediate=False)
    with record_function("postprocess"):
        return detr_mod.detr_postprocess(logits[-1], boxes01[-1], cfg.image_size,
                                         cfg.budget.detr_score_thresh)


def detector_predict(
    params: dict, images: torch.Tensor, cfg: DetectorConfig, with_masks: bool = False,
    tp: ModelGroup | None = None,
):
    """Inference -> padded per-image detections (boxes in S-space); with
    ``with_masks`` (a mask model), ``(Detections, mask_probs [B, D, 2P,
    2P])``: each detection's own-class sigmoid map in box-relative
    coordinates (``eval/masks.py`` pastes them), 0 for invalid slots.

    A single-stage model gives up to its family's
    ``{retinanet,fcos}_detections_per_img`` detections an image; DETR one
    per query, ``detr_num_queries``, sorted by score, those over
    ``detr_score_thresh`` valid.

    Its stages run under ``torch.profiler.record_function`` ranges
    (``backbone``, ``rpn``, ``roi_heads``, ``postprocess``, and
    ``mask_head``; a single-stage or DETR model's ``backbone``, ``head``
    and ``postprocess``) so a profiler trace splits a request by stage;
    without a profiler they cost a few microseconds.

    ``tp``: this rank's model group, ``params``' encoder and box-head
    leaves its shards (``parallel/sharding.py``); the ranks of a group
    predict the same images together and get the same detections."""
    if with_masks and not cfg.with_mask:
        if cfg.detector_kind != "faster_rcnn":
            raise ValueError(f"detector={cfg.detector_kind!r} has no mask branch")
        raise ValueError("with_masks=True needs a model with the mask branch (with_mask)")
    if cfg.detector_kind == "detr":
        return _detr_predict(params, images, cfg, tp)
    if cfg.detector_kind != "faster_rcnn":
        return _one_stage_predict(params, images, cfg, tp)
    anchors, counts = _anchors(cfg, images.device)
    size = (cfg.image_size, cfg.image_size)
    with record_function("backbone"):
        feats = run_backbone(params, images, cfg, tp=tp)
    with record_function("rpn"):
        objectness, deltas = rpn_head_forward(
            params["rpn_head"], feats, cfg.num_anchors_per_cell
        )
        props = filter_proposals(objectness, deltas, anchors, counts, size, cfg.budget)
    if cfg.cascade_iou_threshs:
        dets = _cascade_predict(params, feats, props, cfg, tp)
    else:
        with record_function("roi_heads"):
            class_logits, box_regression = _pool_and_predict(
                _base_head(params), feats, props.boxes, props.valid, cfg, tp
            )
        with record_function("postprocess"):
            dets = postprocess_detections(
                class_logits, box_regression, props.boxes, props.valid, size, cfg.budget,
            )
    if not with_masks:
        return dets
    logits = _mask_logits(params, feats, dets.boxes, dets.valid, cfg)
    b, d = logits.shape[:2]
    probs = mask_mod.mask_probs_for_labels(
        logits.reshape(b * d, *logits.shape[2:]), dets.labels.reshape(b * d)
    ).reshape(b, d, *logits.shape[-2:])
    return dets, torch.where(dets.valid[..., None, None], probs, torch.zeros_like(probs))


class SamplerPriorities(NamedTuple):
    """Uniform [0, 1) draws for the two samplers: slot ``[:, 0]`` ranks
    the positives, ``[:, 1]`` the negatives."""

    rpn: torch.Tensor  # [B, 2, num_anchors]
    roi: torch.Tensor  # [B, 2, rpn_post_nms_top_n_train + G]


def draw_priorities(
    cfg: DetectorConfig, batch: int, max_gt: int, generator: torch.Generator
) -> SamplerPriorities | None:
    """Sampler priorities from ``generator`` (on the device it names).
    The JAX package draws these with ``jax.random.uniform``, which torch
    cannot reproduce; tests pass JAX's draws in instead. A single-stage or
    DETR model samples nothing: None, and no draw."""
    if cfg.detector_kind != "faster_rcnn":
        return None
    device = generator.device
    n_anchors = sum(h * w for h, w in cfg.grid_sizes) * cfg.num_anchors_per_cell
    n_cand = cfg.budget.rpn_post_nms_top_n_train + max_gt
    return SamplerPriorities(
        rpn=torch.rand((batch, 2, n_anchors), generator=generator, device=device),
        roi=torch.rand((batch, 2, n_cand), generator=generator, device=device),
    )


def detector_loss(
    params: dict,
    images: torch.Tensor,  # [B, 3, S, S] in [0, 1]
    gt_boxes: torch.Tensor,  # [B, G, 4] xyxy in S-space
    gt_labels: torch.Tensor,  # [B, G] int 1..NC
    gt_valid: torch.Tensor,  # [B, G] bool
    cfg: DetectorConfig,
    priorities: SamplerPriorities | None,  # None for a single-stage or DETR model
    gt_masks: torch.Tensor | None = None,  # [B, G, M, M] {0, 1}, a mask model's
    tp: ModelGroup | None = None,
    pipeline=None,
) -> dict[str, torch.Tensor]:
    """Training forward -> the four-loss dict of the JAX package's
    ``detector_loss`` (and the reference trainer): ``loss_objectness``,
    ``loss_rpn_box_reg``, ``loss_classifier``, ``loss_box_reg``, fp32
    scalars; a cascade model sums its stages' losses, weighted, into the
    last two; a mask model adds ``loss_mask``. A single-stage model gives
    ``loss_classification`` and ``loss_bbox_reg``, and FCOS
    ``loss_bbox_ctrness`` too (torchvision's keys, as JAX's); DETR
    ``loss_ce``, ``loss_bbox``, ``loss_giou`` and, with ``detr_aux_loss``,
    the same for each earlier decoder layer, suffixed ``_aux{i}``.

    The predictions run under a ``record_function("forward")`` range, with
    ``"backbone"``, ``"rpn"`` (a single-stage or DETR model's ``"head"``)
    and ``"mask_head"`` ranges inside it as in ``detector_predict``, and the
    losses under ``"loss"``, DETR's cost and assignment under
    ``"matcher"`` inside it. A DiT encoder with experts adds
    ``loss_moe_aux`` (``moe_aux_weight`` x its load-balance loss) to every
    family's losses.

    ``tp``: this rank's model group (``detector_predict``'s); the ranks of
    a group take the same rows and give the same losses, whose gradients
    the trainer reduces as ``parallel/sharding.py`` says. ``pipeline``: a
    ``parallel.pipeline.PipelineConfig``, the encoder run as GPipe stages
    (JAX ``detector_loss(..., pipeline=)``); every stage then runs the
    head on the gathered taps, and the trainer reduces the gradients over
    the pipe group (``parallel.pipeline.reduce_pipe_grads``)."""
    if cfg.with_mask and gt_masks is None:
        raise ValueError("cfg.with_mask=True requires gt_masks [B, G, M, M] "
                         "(the data loader's load_masks)")
    if cfg.detector_kind == "detr":
        return _detr_loss(params, images, gt_boxes, gt_labels, gt_valid, cfg, tp, pipeline)
    if cfg.detector_kind != "faster_rcnn":
        return _one_stage_loss(params, images, gt_boxes, gt_labels, gt_valid, cfg, tp,
                               pipeline)
    anchors, counts = _anchors(cfg, images.device)
    size = (cfg.image_size, cfg.image_size)
    aux_out: dict = {}
    with record_function("forward"):
        with record_function("backbone"):
            feats = run_backbone(params, images, cfg, remat=True, aux_out=aux_out, tp=tp,
                                     pipeline=pipeline)
        with record_function("rpn"):
            objectness, deltas = rpn_head_forward(params["rpn_head"], feats,
                                                  cfg.num_anchors_per_cell)
            props = filter_proposals(objectness, deltas, anchors, counts, size, cfg.budget,
                                     training=True)
        samples = select_training_samples(
            props.boxes, props.valid, gt_boxes, gt_labels, gt_valid, cfg.budget,
            priorities.roi,
        )
        if cfg.cascade_iou_threshs:
            stages = _cascade_stages(params, feats, samples, gt_boxes, gt_labels, gt_valid,
                                     cfg, tp)
        else:
            class_logits, box_regression = _pool_and_predict(
                _base_head(params), feats, samples.rois, samples.valid, cfg, tp
            )
        if cfg.with_mask:
            max_pos = int(cfg.budget.box_batch_size_per_image * cfg.budget.box_positive_fraction)
            mask_rois = samples.rois[:, :max_pos]
            mask_labels = samples.labels[:, :max_pos]
            mask_valid = samples.valid[:, :max_pos] & (mask_labels > 0)
            mask_logits = _mask_logits(params, feats, mask_rois, mask_valid, cfg)
    with record_function("loss"):
        loss_obj, loss_rpn_box = rpn_loss(
            objectness, deltas, anchors, gt_boxes, gt_valid, cfg.budget, priorities.rpn
        )
        if cfg.cascade_iou_threshs:
            loss_cls = loss_box = 0.0
            for lw, (class_logits, box_reg, targets) in zip(cfg.cascade_loss_weights, stages):
                lc, lb = cascade_mod.cascade_stage_loss(class_logits, box_reg, targets.labels,
                                                        targets.reg_targets, samples.valid)
                loss_cls = loss_cls + lw * lc
                loss_box = loss_box + lw * lb
        else:
            loss_cls, loss_box = fastrcnn_loss(class_logits, box_regression, samples)
        losses = {
            "loss_objectness": loss_obj,
            "loss_rpn_box_reg": loss_rpn_box,
            "loss_classifier": loss_cls,
            "loss_box_reg": loss_box,
        }
        if cfg.with_mask:
            out = 2 * cfg.mask_roi_output_size
            targets = mask_mod.project_masks_on_boxes(
                gt_masks, mask_rois, samples.matched_gt[:, :max_pos], cfg.image_size, out
            )
            b, k = mask_rois.shape[:2]
            losses["loss_mask"] = mask_mod.maskrcnn_loss(
                mask_logits.reshape(b * k, *mask_logits.shape[2:]), mask_labels.reshape(b * k),
                targets.reshape(b * k, out, out), mask_valid.reshape(b * k),
            )
    return _with_moe_aux(losses, aux_out, cfg)


def _one_stage_loss(params, images, gt_boxes, gt_labels, gt_valid,
                    cfg: DetectorConfig, tp=None, pipeline=None) -> dict[str, torch.Tensor]:
    """RetinaNet's or FCOS's training losses (JAX ``detector_loss``'s
    single-stage branches)."""
    anchors, counts = _anchors(cfg, images.device)
    aux_out: dict = {}
    with record_function("forward"):
        with record_function("backbone"):
            feats = run_backbone(params, images, cfg, remat=True, aux_out=aux_out, tp=tp,
                                     pipeline=pipeline)
        with record_function("head"):
            out = _one_stage_heads(params, feats, cfg)
    with record_function("loss"):
        if cfg.detector_kind == "retinanet":
            loss_cls, loss_reg = retina_mod.retinanet_loss(
                *out, anchors, gt_boxes, gt_labels, gt_valid, cfg.budget)
            losses = {"loss_classification": loss_cls, "loss_bbox_reg": loss_reg}
        else:
            loss_cls, loss_reg, loss_ctr = fcos_mod.fcos_loss(
                *out, anchors, counts, gt_boxes, gt_labels, gt_valid, cfg.budget)
            losses = {"loss_classification": loss_cls, "loss_bbox_reg": loss_reg,
                      "loss_bbox_ctrness": loss_ctr}
        return _with_moe_aux(losses, aux_out, cfg)


def _detr_loss(params, images, gt_boxes, gt_labels, gt_valid,
               cfg: DetectorConfig, tp=None, pipeline=None) -> dict[str, torch.Tensor]:
    """DETR's training losses (JAX ``detector_loss``'s DETR branch): the
    Hungarian assignment needs a query for every (padded) gt slot."""
    if gt_boxes.shape[1] > cfg.detr_num_queries:
        raise ValueError(
            f"max_gt_boxes {gt_boxes.shape[1]} exceeds detr_num_queries "
            f"{cfg.detr_num_queries}: the Hungarian assignment needs a query per (padded) "
            "gt slot")
    aux_out: dict = {}
    with record_function("forward"):
        with record_function("backbone"):
            feats = run_backbone(params, images, cfg, remat=True, aux_out=aux_out, tp=tp,
                                     pipeline=pipeline)
        with record_function("head"):
            logits, boxes01 = detr_mod.detr_forward(params["detr"], feats[cfg.detr_level],
                                                    cfg.detr_heads,
                                                    return_intermediate=cfg.detr_aux_loss)
    with record_function("loss"):
        return _with_moe_aux(
            detr_mod.detr_loss(logits, boxes01, gt_boxes, gt_labels, gt_valid, cfg.image_size,
                               cfg.detr_eos_coef, cfg.detr_aux_loss,
                               shared_matching=cfg.detr_shared_matching),
            aux_out, cfg)


def _cascade_stages(params, feats, samples, gt_boxes, gt_labels, gt_valid,
                    cfg: DetectorConfig, tp=None) -> list:
    """Each cascade stage's (class_logits, box_regression, its targets)
    in training: stage 0 on the samples (relabelled only when its
    BoxCoder weights are not the budget's), each later stage on the
    previous stage's refined boxes, detached (the paper's section 3.4),
    relabelled at its own threshold."""
    size = (cfg.image_size, cfg.image_size)
    boxes, valid = samples.rois, samples.valid
    n = len(cfg.cascade_iou_threshs)
    out = []
    for i, thresh in enumerate(cfg.cascade_iou_threshs):
        w_reg = cfg.cascade_reg_weights[i]
        if i == 0 and tuple(cfg.budget.box_reg_weights) == tuple(w_reg):
            targets = cascade_mod.StageTargets(samples.labels, samples.reg_targets)
        else:
            targets = cascade_mod.match_boxes_to_gt(boxes, valid, gt_boxes, gt_labels,
                                                    gt_valid, thresh, w_reg)
        class_logits, box_reg = _pool_and_predict(
            params["cascade_heads"][f"s{i}"], feats, boxes, valid, cfg, tp
        )
        out.append((class_logits, box_reg, targets))
        if i + 1 < n:
            boxes = cascade_mod.refine_boxes(boxes, box_reg.detach(), w_reg, size)
    return out


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
