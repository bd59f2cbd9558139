"""``LayoutDetectionModel``: the model object the trainer, the evaluator
and ``main`` share (port of ``layoutdit_tpu/models/model.py``).

A thin stateful shell around the detector's parameter tree and its
``DetectorConfig`` (``models/detection/detector.py``): random
initialisation from a seed, ``predict``, ``loss``, and full-state
checkpoints: written in the port's ``.pt`` format, restored from a
``.pt`` or from the JAX package's ``.msgpack`` (``train/checkpoint.py``).

The JAX model warm-starts the encoder from a local pretrained DiT
checkpoint when ``LAYOUTDIT_DIT_{BASE,LARGE}_PTH`` names one. Reading
those checkpoints is not ported yet, so in the port that variable
raises instead of falling back to random weights.
"""

from __future__ import annotations

import os
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
from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map
from layoutdit_tpu_torch.train.checkpoint import (
    checkpoint_file,
    load_checkpoint,
    save_checkpoint,
)

logger = get_logger(__name__)

# the JAX package's warm-start variables (tools/convert_hf_checkpoint.py),
# with its legacy alias
WARM_START_ENV = ("LAYOUTDIT_DIT_BASE_PTH", "LAYOUTDIT_DIT_LARGE_PTH", "LAYOUTDIT_DIT_BASE_CKPT")


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
    """

    def __init__(self, model_config: ModelConfig, compute_dtype: str = "bfloat16",
                 seed: int = 0, device: str | torch.device = "cuda"):
        for name in WARM_START_ENV:
            if os.environ.get(name):
                raise RuntimeError(
                    f"{name} is set: warm-starting the encoder from a pretrained DiT "
                    "checkpoint is not supported by the port yet; it waits for "
                    "tools/convert_hf_checkpoint.py (ROADMAP queue 1 item 6). Unset it "
                    "to train from random weights."
                )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LayoutDetectionModel: no CUDA device is available")
        self.model_config = model_config
        self.cfg = DetectorConfig.from_model_config(model_config, precision_dtype=compute_dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_detector(self.cfg, gen, device=self.device)

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
        ``.orbax`` one raises (queue 1 item 7)."""
        state = load_checkpoint(path, map_location=self.device)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.params), tree_leaves(state["params"]),
                                strict=True):
                dst.copy_(src)
        return state


def build_model(config: RunConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> LayoutDetectionModel:
    """The model of a run's config (``main``'s first step)."""
    return LayoutDetectionModel(config.model, compute_dtype=config.compute_dtype, seed=seed,
                                device=device)
