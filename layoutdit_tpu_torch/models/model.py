"""``LayoutDetectionModel``: the model object the trainer, the evaluator
and ``main`` share (port of ``layoutdit_tpu/models/model.py``).

A thin stateful shell around the detector's parameter tree and its
``DetectorConfig`` (``models/detection/detector.py``): random
initialisation from a seed, ``predict``, ``loss``, and full-state
checkpoints: written in the port's ``.pt`` format, restored from a
``.pt`` or from the JAX package's ``.msgpack`` (``train/checkpoint.py``).

Warm start, as in the JAX model (the reference's ``model.py:65-70``):
the encoder alone is loaded from ``previous_layout_dit_checkpoint`` (the
argument or the config's field), or, when neither is set and
``warm_start`` is true, from the local pretrained checkpoint that
``LAYOUTDIT_DIT_{BASE,LARGE}_PTH`` names, provided the configured encoder
is that preset's architecture (image size, windows and LoRA fields
aside). An HF ``.bin`` / ``.pth`` / ``.safetensors`` state_dict or a
converted ``.msgpack`` (``models/weights_io.py``); the encoder keeps the
checkpoint's position embeddings, which the forward resamples to the
configured grid. A LoRA model gets fresh adapters beside the loaded
weights (B = 0: the warm-started forward is the pretrained one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from layoutdit_tpu_torch.config import ModelConfig, RunConfig
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorConfig,
    SamplerPriorities,
    detector_loss,
    detector_predict,
    init_detector,
)
from layoutdit_tpu_torch.models import vit as vit_mod
from layoutdit_tpu_torch.models.lora import add_lora_params
from layoutdit_tpu_torch.models.weights_io import (
    RESIZABLE_LEAVES,
    copy_params_,
    load_beit_checkpoint,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.tools.convert_hf_checkpoint import local_checkpoint
from layoutdit_tpu_torch.train.checkpoint import (
    checkpoint_file,
    load_checkpoint,
    save_checkpoint,
)

logger = get_logger(__name__)

_PRESETS = {"dit": ("dit-base", vit_mod.DIT_BASE), "dit-large": ("dit-large", vit_mod.DIT_LARGE)}


class LayoutDetectionModel:
    """The detector's parameters and config.

    Args:
      model_config: ``ModelConfig`` (the ``detection_model_config``
        section).
      compute_dtype: ``precision.compute_dtype`` ("bfloat16" or
        "float32"); the parameters stay float32.
      seed: seeds the ``torch.Generator`` the weights are drawn from.
      device: where the parameters live; "cuda" unless the caller asks
        for the CPU. A CUDA device with no GPU present raises.
      previous_layout_dit_checkpoint: an encoder checkpoint to warm-start
        from (over the config's field).
      warm_start: probe ``LAYOUTDIT_DIT_{BASE,LARGE}_PTH`` when no
        checkpoint is given; False for callers that restore a full
        checkpoint right after (predict, serve, export).
    """

    def __init__(self, model_config: ModelConfig, compute_dtype: str = "bfloat16",
                 seed: int = 0, device: str | torch.device = "cuda",
                 previous_layout_dit_checkpoint: Optional[str] = None,
                 warm_start: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LayoutDetectionModel: no CUDA device is available")
        self.model_config = model_config
        self.cfg = DetectorConfig.from_model_config(model_config, precision_dtype=compute_dtype)
        self._seed = seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_detector(self.cfg, gen, device=self.device)
        ckpt = previous_layout_dit_checkpoint or model_config.previous_layout_dit_checkpoint
        if not ckpt and warm_start:
            ckpt = self._local_pretrained()
        if ckpt:
            self.load_dit_encoder(ckpt)

    def _local_pretrained(self) -> Optional[str]:
        """The ``LAYOUTDIT_DIT_*_PTH`` checkpoint of the backbone's preset,
        when the configured encoder is that preset's architecture with its
        image size, windows and LoRA fields masked out (JAX
        ``model.py:58-110``)."""
        preset = _PRESETS.get(self.model_config.backbone_type)
        if preset is None:
            return None
        name, ref = preset
        vit = self.cfg.backbone.vit
        arch_match = dataclasses.replace(
            vit, image_size=ref.image_size, lora_rank=ref.lora_rank,
            lora_alpha=ref.lora_alpha, lora_targets=ref.lora_targets,
            window_size=ref.window_size, global_attn_layers=ref.global_attn_layers,
        ) == ref
        path = local_checkpoint(name)
        if path and arch_match:
            logger.info("Warm-starting from local pretrained %s checkpoint %s "
                        "(env LAYOUTDIT_DIT_*_PTH)", name, path)
            return path
        if path:
            logger.warning("Local pretrained %s checkpoint present but the configured encoder "
                           "architecture differs from the preset (vit_overrides?); training "
                           "from random init.", name)
        return None

    def load_dit_encoder(self, path: str) -> None:
        """Warm-start the encoder alone from ``path`` (the reference's
        ``strict=False`` load into ``backbone.dit``), then, for a LoRA
        model, add fresh adapters beside the loaded weights."""
        if self.cfg.backbone_kind != "dit":
            raise ValueError("previous_layout_dit_checkpoint warm-starts the DiT encoder; the "
                             f"{self.cfg.backbone_kind} backbone has none")
        vit_cfg = self.cfg.backbone.vit
        vit = load_beit_checkpoint(path, vit_cfg, self.device)
        if vit_cfg.lora_rank > 0:
            gen = torch.Generator(device=self.device).manual_seed(self._seed ^ 0x10FA)
            vit = add_lora_params(vit, vit_cfg, gen)
        self.params["backbone"]["vit"] = vit
        logger.info("Warm-started DiT encoder from %s", path)

    def num_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.params))

    # ------------------------------------------------------------ compute

    def loss(self, images, gt_boxes, gt_labels, gt_valid,
             priorities: SamplerPriorities, gt_masks=None) -> dict[str, torch.Tensor]:
        """The training losses (``detector_loss``)."""
        return detector_loss(self.params, images, gt_boxes, gt_labels, gt_valid, self.cfg,
                             priorities, gt_masks=gt_masks)

    def predict(self, images: torch.Tensor, with_masks: bool = False):
        """Padded per-image detections in model space, and a mask model's
        mask probabilities with ``with_masks`` (``detector_predict``)."""
        with torch.no_grad():
            return detector_predict(self.params, images, self.cfg, with_masks=with_masks)

    # --------------------------------------------------------- checkpoint

    def save_checkpoint(self, base_path: str, run_name: str, epoch_num: int,
                        opt_state: Optional[dict] = None, extra: Optional[dict] = None,
                        stem: Optional[str] = None) -> str:
        """Full-state checkpoint at
        ``{base}/{run}/model_checkpoints/{stem or epoch_<n>}.pt``."""
        path = checkpoint_file(f"{base_path or '.'}/{run_name}", epoch_num, stem)
        save_checkpoint(path, tree_map(lambda t: t.detach().cpu(), self.params),
                        opt_state, epoch_num, extra or {})
        logger.info("Saved checkpoint to %s", path)
        return path

    def restore_checkpoint(self, path: str) -> dict:
        """Copy a checkpoint's parameters into this model's tensors (in
        place, so a trainer holding them sees them too) and return the
        whole state (``params``, ``opt_state``, ``epoch``, ``extra``). A
        ``.msgpack`` path is read as the JAX package writes it; a
        ``.orbax`` one raises (queue 1 item 7). Leaves match by path and
        shape; only the encoder's position embeddings and relative-position
        tables may differ (a model warm-started at another image size keeps
        the checkpoint's): the tree then holds the checkpoint's tensors
        there. Any other difference (another ``num_classes``, FPN width or
        head) raises."""
        state = load_checkpoint(path, map_location=self.device)
        copy_params_(self.params, state["params"], resizable=RESIZABLE_LEAVES)
        return state


def build_model(config: RunConfig, seed: int = 0, device: str | torch.device = "cuda",
                warm_start: bool = True) -> LayoutDetectionModel:
    """The model of a run's config (``main``'s first step); ``warm_start``
    False skips the ``LAYOUTDIT_DIT_*_PTH`` probe, for callers that restore
    a full checkpoint right after."""
    return LayoutDetectionModel(config.model, compute_dtype=config.compute_dtype, seed=seed,
                                device=device, warm_start=warm_start)
