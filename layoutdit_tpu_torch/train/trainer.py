"""Trainer for the ``faster_rcnn`` detector (port of
``layoutdit_tpu/train/trainer.py``, single card).

The JAX trainer's recipe: AdamW (b1 0.9, b2 0.999, eps 1e-8) with the
configured learning-rate schedule evaluated per update count
(``make_lr_schedule``: StepLR by epoch, or half-cosine, with optional
linear warmup), optional global-norm clipping with optax's formula, the
sum of the four detector losses, "Epoch i/N, Loss: x" logging, one
``metrics.jsonl`` record per epoch with the JAX keys, and a checkpoint
every ``checkpoint_interval`` epochs.

Differences from the JAX trainer, on purpose:
  * the train step runs eagerly under ``record_function`` ranges
    (``forward``, ``loss`` in ``detector_loss``; ``backward``,
    ``optimizer`` here), so a profiler trace splits a step by stage;
  * the samplers' priorities come from a ``torch.Generator`` on the
    device seeded from ``train_config.seed`` (JAX draws them with
    ``jax.random``, which torch cannot reproduce);
  * the fused qkv's K-bias slot, which the JAX tree does not have, is
    held at zero: its gradient is zeroed before clipping and the update,
    so AdamW never moves it and the clip norm does not count it;
  * checkpoints are ``torch.save`` files (``train/checkpoint.py``).
Waiting for later slices: EMA, gradient accumulation, multi-step
dispatch, preemption handling, mid-training evaluation, TensorBoard,
the loss-curve PNG, profiler upload and LoRA masks.
"""

from __future__ import annotations

import json
import math
import os
import time

import torch
from torch.profiler import record_function

from layoutdit_tpu_torch.config import RunConfig, TrainingConfig
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionBatch, DetectionLoader
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorModel,
    detector_loss,
    draw_priorities,
)
from layoutdit_tpu_torch.models.weights_io import k_bias_slots, tree_leaves, tree_map
from layoutdit_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

logger = get_logger(__name__)


def make_lr_schedule(train_cfg: TrainingConfig, steps_per_epoch: int):
    """Update count -> learning rate, the JAX trainer's values:
    ``step`` = lr * gamma^(epoch // step_size) with epoch = count //
    steps_per_epoch; ``cosine`` = half-cosine decay to 0 over the run;
    either times min(1, (count + 1) / warmup_steps) when warming up."""

    def lr_schedule(count: int) -> float:
        if train_cfg.lr_schedule == "cosine":
            total = max(1, train_cfg.num_epochs * steps_per_epoch)
            t = min(count, total) / total
            base = train_cfg.learning_rate * 0.5 * (1 + math.cos(math.pi * t))
        else:
            epoch = count // max(1, steps_per_epoch)
            base = train_cfg.learning_rate * train_cfg.gamma ** (epoch // train_cfg.step_size)
        if train_cfg.warmup_steps > 0:
            base *= min(1.0, (count + 1) / train_cfg.warmup_steps)
        return base

    return lr_schedule


def make_optimizer(params: list[torch.Tensor], train_cfg: TrainingConfig) -> torch.optim.AdamW:
    """AdamW with optax's constants (b1 0.9, b2 0.999, eps 1e-8) and the
    configured decoupled weight decay; the learning rate is set before
    each step from ``make_lr_schedule``."""
    return torch.optim.AdamW(
        params, lr=train_cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=train_cfg.weight_decay,
    )


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: g * min(1, max_norm / ||g||) over
    all gradients (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
    In place, on the device, without a host sync; returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.clamp(max_norm / norm, max=1.0)
    torch._foreach_mul_(grads, factor)
    return norm


def apply_update(
    optimizer: torch.optim.Optimizer,
    leaves: list[torch.Tensor],
    k_bias: list[tuple[torch.Tensor, slice]],
    grad_clip_norm: float,
    lr: float,
) -> None:
    """One optimizer update from the leaves' ``.grad``: the K-bias slots
    (``weights_io.k_bias_slots``) are held at zero gradient first, so the
    clip norm does not count them and AdamW leaves them at zero, then the
    optional global-norm clip, then the step at ``lr``."""
    for bias, k_slot in k_bias:
        bias.grad[k_slot] = 0.0
    if grad_clip_norm > 0:
        clip_by_global_norm([t.grad for t in leaves], grad_clip_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


class Trainer:
    """``Trainer(config, model).train()``: the epoch loop over the
    config's training split.

    Args:
      config: ``RunConfig`` (``config.load_run_config`` of a JAX-layout
        config JSON).
      model: ``DetectorModel``; its parameters are moved to ``device``,
        made trainable and updated in place.
      device: "cuda" unless the caller asks for the CPU. A CUDA device
        with no GPU present raises.
    """

    def __init__(self, config: RunConfig, model: DetectorModel,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device is available")
        self.config = config
        self.cfg = model.cfg
        if config.data.image_shards_dir:
            raise ValueError(
                "data_loader_config.image_shards_dir: tar shards are not supported by the "
                "port yet; they wait for a later slice"
            )
        self.params = tree_map(lambda t: t.to(self.device), model.params)
        self._leaves = tree_leaves(self.params)
        for t in self._leaves:
            t.requires_grad_(True)
        self._k_bias = k_bias_slots(self.params)
        tc = config.train
        images_root, ann_json = config.train_split()
        self.dataloader = DetectionLoader(
            PubLayNetDataset(images_root, ann_json),
            batch_size=config.data.batch_size,
            shuffle=config.data.shuffle,
            num_workers=config.data.num_workers,
            image_size=self.cfg.image_size,
            max_gt=config.data.max_gt_boxes,
            seed=tc.seed,
            drop_last=True,  # constant shapes per step
            prefetch_depth=config.data.prefetch_depth,
            augment_hflip=config.data.augment_hflip,
            device=self.device,
        )
        self.optimizer = make_optimizer(self._leaves, tc)
        self.lr_schedule = make_lr_schedule(tc, len(self.dataloader))
        self.generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.epoch = 0
        self.updates = 0
        self.loss_history: list[float] = []
        self.metrics_history: list[dict] = []

    # ------------------------------------------------------------ step

    def train_step(self, batch: DetectionBatch) -> tuple[torch.Tensor, dict]:
        """One update on ``batch`` -> (total loss, the four losses), device
        scalars (no host sync)."""
        b, g = batch.gt_labels.shape
        priorities = draw_priorities(self.cfg, b, g, self.generator)
        losses = detector_loss(
            self.params, batch.images, batch.gt_boxes, batch.gt_labels, batch.gt_valid,
            self.cfg, priorities,
        )
        loss = sum(losses.values())
        with record_function("backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("optimizer"):
            apply_update(self.optimizer, self._leaves, self._k_bias,
                         self.config.train.grad_clip_norm, self.lr_schedule(self.updates))
        self.updates += 1
        return loss.detach(), {k: v.detach() for k, v in losses.items()}

    # ------------------------------------------------------------ loops

    def _run_epoch(self, epoch: int) -> float:
        tc = self.config.train
        t0 = time.perf_counter()
        self.dataloader.set_epoch(epoch)
        losses, n_images = [], 0
        for batch in self.dataloader:
            loss, _ = self.train_step(batch)
            losses.append(loss)
            n_images += int(batch.image_valid.sum())
        # one host read of the epoch's losses, at its end
        avg = float(torch.stack(losses).mean()) if losses else 0.0
        dt = max(time.perf_counter() - t0, 1e-9)
        self.loss_history.append(avg)
        self.metrics_history.append({
            "epoch": epoch + 1,
            "loss": avg,
            "images_per_sec": round(n_images / dt, 2),
            "learning_rate": float(self.lr_schedule(self.updates)),
        })
        logger.info("Epoch %d/%d, Loss: %.4f (%.1f img/s)",
                    epoch + 1, tc.num_epochs, avg, n_images / dt)
        return avg

    def train(self) -> None:
        tc = self.config.train
        try:
            for epoch in range(self.epoch, tc.num_epochs):
                self._run_epoch(epoch)
                self._save_metrics()
                if (epoch + 1) % tc.checkpoint_interval == 0:
                    path = self.save_checkpoint(epoch + 1)
                    logger.info("Saved checkpoint to %s", path)
                self.epoch = epoch + 1
        finally:
            self.dataloader.close()

    # ------------------------------------------------------- artifacts

    def checkpoint_path(self, epoch: int) -> str:
        return f"{self.config.artifact_dir}/model_checkpoints/epoch_{epoch}.pt"

    def save_checkpoint(self, epoch: int) -> str:
        return save_checkpoint(
            self.checkpoint_path(epoch),
            tree_map(lambda t: t.detach().cpu(), self.params),
            self.optimizer.state_dict(), epoch,
            extra={
                "loss_history": self.loss_history,
                "metrics_history": self.metrics_history,
                "updates": self.updates,
                "generator_state": self.generator.get_state(),
            },
        )

    def resume(self, path: str) -> None:
        """Restore parameters (in place), optimizer state, epoch, update
        count, histories and the sampler generator from a checkpoint."""
        state = load_checkpoint(path, map_location=self.device)
        with torch.no_grad():
            for dst, src in zip(self._leaves, tree_leaves(state["params"]), strict=True):
                dst.copy_(src)
        self.optimizer.load_state_dict(state["opt_state"])
        extra = state["extra"]
        self.epoch = state["epoch"]
        self.updates = extra["updates"]
        self.loss_history = list(extra["loss_history"])
        self.metrics_history = list(extra["metrics_history"])
        self.generator.set_state(extra["generator_state"].cpu())
        logger.info("Resumed from %s at epoch %d", path, self.epoch)

    def _save_metrics(self) -> None:
        """Rewrite ``metrics/metrics.jsonl`` (one record per epoch)."""
        path = f"{self.config.artifact_dir}/metrics/metrics.jsonl"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for rec in self.metrics_history:
                f.write(json.dumps(rec) + "\n")

