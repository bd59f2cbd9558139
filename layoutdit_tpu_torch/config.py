"""Configuration for the port: frozen dataclasses and a JSON loader.

A subset of the JAX package's pydantic schema (``config/constructs.py``)
with the same defaults: the ``DetectionBudget`` of the two-stage, the
single-stage and the set-prediction families, the serving
fields of ``ModelConfig`` and ``DataLoaderConfig``, the training fields
of ``TrainingConfig`` and the evaluator's fields of ``EvalConfig``. The
machine with the GPU has no pydantic, so these are plain frozen
dataclasses. ``load_config`` reads ``detection_model_config`` and
``data_loader_config`` from the same JSON files the JAX package reads
(e.g. ``configs/serving_1024.json``); ``load_run_config`` reads a whole
training config, and ``get_run_config`` the one ``LAYOUTDIT_CONFIG``
names. A key the port does not know raises instead of being dropped,
and a JAX field the port does not act on yet loads only at its default
value.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from layoutdit_tpu_torch.utils.paths import fs_for, open_path


@dataclasses.dataclass(frozen=True)
class DetectionBudget:
    """Static budgets of the detectors (``constructs.py::DetectionBudget``):
    the two-stage ones at torchvision FasterRCNN's defaults, the
    ``retinanet_*`` and ``fcos_*`` ones at torchvision RetinaNet's and
    FCOS's, and DETR's score threshold; each family reads only its own."""

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

    retinanet_fg_iou_thresh: float = 0.5
    retinanet_bg_iou_thresh: float = 0.4
    retinanet_score_thresh: float = 0.05
    retinanet_nms_thresh: float = 0.5
    retinanet_detections_per_img: int = 300
    retinanet_topk_candidates: int = 1000  # a level's cap before the NMS

    fcos_score_thresh: float = 0.2
    fcos_nms_thresh: float = 0.6
    fcos_detections_per_img: int = 100
    fcos_topk_candidates: int = 1000
    # cells match a gt only within radius x their stride of its center
    fcos_center_sampling_radius: float = 1.5

    # DETR: every query is a detection (no NMS); this gates ``valid`` only
    detr_score_thresh: float = 0.0


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


# the encoders the port runs (JAX ``BackboneType``)
BACKBONES = ("dit", "dit-large", "resnet50")
# the detector families the port runs (JAX ``ModelConfig.detector``)
DETECTORS = ("faster_rcnn", "retinanet", "fcos", "detr")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Serving and training fields of ``constructs.py::ModelConfig``,
    same defaults.

    ``attention_impl`` and ``roi_impl`` pick implementations of one
    function in the JAX package; the port keeps them for the config
    files' sake and routes by sequence length on the card
    (``models/vit.py``). ``window_size`` and ``window_global_layers``
    are the ViTDet windows of ``constructs.py:440-443``; ``remat`` and
    ``remat_policy`` the encoder's activation checkpointing
    (``constructs.py:455-461``). ``detector`` picks the family:
    ``faster_rcnn`` (with the cascade and mask modifiers), the
    single-stage ``retinanet`` and ``fcos``, whose heads run on the
    pyramid levels ``retinanet_levels`` / ``fcos_levels`` (indices into
    p2..p5 + pool), or the set-prediction ``detr``, whose decoder
    (``detr_*``, facebookresearch/detr's defaults as JAX's
    ``constructs.py:403-418``) cross-attends to level ``detr_level``."""

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
    window_size: int = 0
    window_global_layers: tuple[int, ...] = ()
    # activation checkpointing of the encoder's layers (models/vit.py):
    # "full" saves a layer's input only, "dots" also the outputs of its
    # projection matmuls
    remat: bool = False
    remat_policy: str = "full"
    vit_overrides: Optional[dict] = None
    # the two modifiers of the faster_rcnn family (constructs.py:381, :449):
    # Cascade R-CNN's per-stage foreground IoU thresholds (empty = one
    # box head), and the Mask R-CNN branch
    cascade_iou_threshs: tuple[float, ...] = ()
    with_mask: bool = False
    detector: str = "faster_rcnn"
    retinanet_levels: tuple[int, ...] = (1, 2, 3, 4)
    fcos_levels: tuple[int, ...] = (1, 2, 3, 4)
    detr_num_queries: int = 100
    detr_layers: int = 6
    detr_dim: int = 256
    detr_heads: int = 8
    detr_ffn_dim: int = 2048
    # the background ("no object") class weight of the CE loss
    detr_eos_coef: float = 0.1
    # a loss per decoder layer, and (shared_matching) one assignment, the
    # final layer's, reused by every auxiliary loss
    detr_aux_loss: bool = True
    detr_shared_matching: bool = False
    detr_level: int = 2
    # warm start: a DiT/BEiT encoder checkpoint (HF .bin/.pth, or a
    # converted .msgpack) loaded into the encoder only (models/model.py)
    previous_layout_dit_checkpoint: Optional[str] = None
    # LoRA adapters on the encoder's projections (models/lora.py); 0 = off
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple[str, ...] = ("q", "v")

    def __post_init__(self):
        if self.detector not in DETECTORS:
            raise ValueError(f"unknown detector {self.detector!r}; the port runs {DETECTORS}")
        if self.backbone_type not in BACKBONES:
            raise ValueError(f"backbone_type {self.backbone_type!r}: the port runs {BACKBONES}")
        if self.remat_policy not in ("full", "dots"):  # JAX vit.py:893-896
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; use 'full' or 'dots'"
            )


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The fields of ``constructs.py::TrainingConfig`` the trainer
    uses, same defaults. ``train_base_path``/``train_input`` locate the
    data as in the JAX package (``{base}/{input}/`` images,
    ``{base}/{input}.json`` annotations)."""

    train_base_path: str = "gs://layoutdit/data"
    train_input: str = "single"
    num_epochs: int = 25
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    step_size: int = 10
    gamma: float = 0.1
    checkpoint_interval: int = 10
    seed: int = 0
    grad_clip_norm: float = 0.0
    lr_schedule: str = "step"
    warmup_steps: int = 0
    # COCO eval of the eval split every N epochs (0 = off), and an early
    # stop after this many evals without a new best mAP (0 = off)
    eval_interval: int = 0
    early_stop_patience: int = 0
    # run state (train/trainer.py, train/optim.py): an EMA of the
    # parameters (0 = off), micro-batches per update, steps per stacked
    # batch (0 = auto, 1 on the card), non-finite updates skipped in a row
    # before they apply (0 = off), Adam's first-moment dtype, periodic
    # checkpoints kept (0 = all), background checkpoint writes, and
    # TensorBoard events under {run}/tb
    ema_decay: float = 0.0
    grad_accumulation_steps: int = 1
    steps_per_dispatch: int = 0
    skip_nonfinite_updates: int = 0
    adam_mu_dtype: str = "float32"
    keep_checkpoints: int = 0
    async_checkpoint: bool = True
    tensorboard: bool = True
    # with lora_rank > 0: train the adapters and the heads only, the rest
    # of the encoder frozen (no optimizer moments); False trains everything
    lora_freeze_base: bool = True
    # Trainer.train() under torch.profiler, its trace written under
    # trace_log_dir and uploaded to {artifacts}/{run}/profiler/
    enable_profile: bool = False
    trace_log_dir: str = "./log/traces"

    def __post_init__(self):
        if self.lr_schedule not in ("step", "cosine"):
            raise ValueError(f"lr_schedule must be 'step' or 'cosine', got {self.lr_schedule!r}")
        if self.adam_mu_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"adam_mu_dtype must be 'float32' or 'bfloat16', got {self.adam_mu_dtype!r}"
            )


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """The evaluator's fields of ``constructs.py::EvalConfig``, same
    defaults: ``score_thresh`` drops detections below it; the overlays
    draw the top ``max_per_image`` boxes on up to ``num_images`` pages
    into ``{visualize_dirpath_prefix}_{preds,gt}/``; ``per_category_metrics``
    adds ``AP-{name}`` / ``AP50-{name}`` to the 12 COCO metrics.
    ``eval_input`` and ``eval_base_path``, which the trainer reads too,
    are fields of ``RunConfig``."""

    score_thresh: float = 0.0
    max_per_image: int = 10
    visualize_dirpath_prefix: str = "visualizations"
    num_images: Optional[int] = 20
    per_category_metrics: bool = True
    # a mask model also pastes its masks and reports the 12 segm metrics
    # as segm_mAP, segm_AP50, ... beside the bbox ones
    segm_metrics: bool = True


# Fields of the JAX schema the port reads but does not act on yet: each
# maps to (its JAX default, what it waits for). A config that leaves one
# at its default loads; one that sets it otherwise is refused, naming the
# work it waits for, rather than silently trained without it.
_WAITING = {
    "train_config": {
        "device": ("auto", "the port runs on the CUDA card (no device field)"),
    },
    "eval_config": {
        "device": ("auto", "the port runs on the CUDA card (no device field)"),
    },
}


def _tupled(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def _check_keys(data: dict, known: set, where: str, waiting: Optional[dict] = None) -> None:
    """Raise on a key that is neither ``known`` nor waiting, and on a
    waiting key set to anything but its JAX default."""
    waiting = waiting or {}
    unknown = sorted(set(data) - known - set(waiting))
    if unknown:
        raise ValueError(f"{where}: keys not supported by the port: {unknown}")
    for k, v in data.items():
        if k in waiting and k not in known and v != waiting[k][0]:
            raise ValueError(
                f"{where}.{k}={v!r}: not supported by the port yet; it waits for {waiting[k][1]}"
            )


def _build(cls, data: dict, where: str, waiting: Optional[dict] = None):
    known = {f.name for f in dataclasses.fields(cls)}
    _check_keys(data, known, where, waiting)
    kwargs = {}
    for k, v in data.items():
        if k not in known:
            continue
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
    mc = _build(ModelConfig, raw.get("detection_model_config", {}), "detection_model_config")
    dl = _build(DataLoaderConfig, raw.get("data_loader_config", {}),
                "data_loader_config")
    return mc, dl


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """What the trainer reads from a config file: the model, loader and
    training sections, the compute dtype (``precision.compute_dtype``),
    and where the data and the run's artifacts live.

    ``local_mode`` switches the training data to the eval split, as the
    JAX package's ``resolve_split`` does; artifacts go to
    ``{eval_base_path or "."}/{run_name}`` (``metrics/metrics.jsonl``,
    ``model_checkpoints/{epoch_n,best}.pt``, ``predictions.json`` and the
    overlays)."""

    model: ModelConfig = ModelConfig()
    data: DataLoaderConfig = DataLoaderConfig()
    train: TrainingConfig = TrainingConfig()
    eval: EvalConfig = EvalConfig()
    compute_dtype: str = "bfloat16"
    # precision.param_dtype: carried as the JAX schema has it, which reads
    # it nowhere; the parameters stay float32 in both packages
    param_dtype: str = "float32"
    run_name: str = "test"
    local_mode: bool = False
    eval_input: str = "samples"
    eval_base_path: Optional[str] = "gs://layoutdit"

    @property
    def artifact_dir(self) -> str:
        return f"{self.eval_base_path or '.'}/{self.run_name}"

    def train_split(self) -> tuple[str, str]:
        """(images_root, annotations_json) of the training data."""
        base = self.train.train_base_path
        segment = self.eval_input if self.local_mode else self.train.train_input
        return f"{base}/{segment}/", f"{base}/{segment}.json"

    def eval_split(self) -> tuple[str, str]:
        """(images_root, annotations_json) of the eval data: the eval
        split under the training data's base, as in the JAX evaluator."""
        base = self.train.train_base_path
        return f"{base}/{self.eval_input}/", f"{base}/{self.eval_input}.json"


# the JAX schema's MeshConfig fields (constructs.py) and the values at
# which its build_mesh resolves to one device (parallel/mesh.py:139):
# then fsdp shards over one device, which changes nothing
_MESH_ONE_DEVICE = {"model_parallel": 1, "pipeline_parallel": 1, "dcn_data_parallel": 1,
                    "sequence_parallel": False, "enable_distributed_init": False}
_MESH_FREE = {"data_parallel", "fsdp", "axis_names", "pipeline_microbatches",
              "coordinator_address", "num_processes", "process_id",
              "heartbeat_timeout_s", "shutdown_timeout_s"}


def _check_one_device_mesh(mesh: dict) -> None:
    """Accept a ``mesh_config`` that resolves to one device, as the JAX
    package's ``build_mesh`` resolves it on one chip: ``data_parallel`` 1,
    or -1 (every device) with at most one visible card, and every other
    axis 1 with no sequence parallelism and no distributed init. Any
    other mesh raises."""
    unknown = sorted(set(mesh) - set(_MESH_ONE_DEVICE) - _MESH_FREE)
    if unknown:
        raise ValueError(f"mesh_config: keys not supported by the port: {unknown}")
    waits = ("it waits for the parallelism slice (ROADMAP queue 1 item 7); the port "
             "trains on one card")
    for k, one in _MESH_ONE_DEVICE.items():
        if mesh.get(k, one) != one:
            raise ValueError(f"mesh_config.{k}={mesh[k]!r}: not supported by the port; {waits}")
    dp = mesh.get("data_parallel", -1)
    devices = torch.cuda.device_count() if dp <= 0 else dp  # <= 0: every device
    if devices > 1:
        raise ValueError(
            f"mesh_config.data_parallel={dp!r} resolves to {devices} devices: not supported "
            f"by the port; {waits}"
        )


# "_comment": the prose some config files carry at the top, read by no one
_RUN_KEYS = {"train_config", "data_loader_config", "detection_model_config",
             "precision", "run_name", "local_mode", "eval_config", "mesh_config", "_comment"}


def run_config_from_dict(raw: dict) -> RunConfig:
    """A ``RunConfig`` from a parsed config JSON (the JAX package's
    ``LayoutDitConfig`` layout); absent sections take their defaults."""
    unknown = sorted(set(raw) - _RUN_KEYS)
    if unknown:
        raise ValueError(f"keys not supported by the port: {unknown}")
    _check_one_device_mesh(raw.get("mesh_config") or {})
    mc = _build(ModelConfig, raw.get("detection_model_config", {}), "detection_model_config")
    precision = raw.get("precision", {})
    _check_keys(precision, {"compute_dtype", "param_dtype"}, "precision")
    ev = dict(raw.get("eval_config", {}))
    paths = {k: ev.pop(k) for k in ("eval_input", "eval_base_path") if k in ev}
    return RunConfig(
        model=mc,
        data=_build(DataLoaderConfig, raw.get("data_loader_config", {}), "data_loader_config"),
        train=_build(TrainingConfig, raw.get("train_config", {}), "train_config",
                     _WAITING["train_config"]),
        eval=_build(EvalConfig, ev, "eval_config", _WAITING["eval_config"]),
        compute_dtype=precision.get("compute_dtype", "bfloat16"),
        param_dtype=precision.get("param_dtype", "float32"),
        run_name=raw.get("run_name", "test"),
        local_mode=bool(raw.get("local_mode") or False),
        eval_input=paths.get("eval_input", "samples"),
        eval_base_path=paths.get("eval_base_path", "gs://layoutdit"),
    )


def load_run_config(path: str) -> RunConfig:
    """``run_config_from_dict`` of a config JSON file, local or at a
    ``scheme://`` URL."""
    with open_path(path, "r") as f:
        return run_config_from_dict(json.load(f))


def get_run_config() -> RunConfig:
    """The run's config (counterpart of the JAX package's
    ``get_layout_dit_config``): the JSON file that the ``LAYOUTDIT_CONFIG``
    environment variable names (local or a ``scheme://`` URL), which must
    exist, or the defaults when it is unset. There is no probe of the
    JAX package's default gs:// location."""
    path = os.getenv("LAYOUTDIT_CONFIG")
    if not path:
        return RunConfig()
    if not fs_for(path).exists(path):
        raise FileNotFoundError(f"LAYOUTDIT_CONFIG={path} does not exist")
    return load_run_config(path)

