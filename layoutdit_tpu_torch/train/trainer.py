"""Trainer for the ``faster_rcnn`` detector (port of
``layoutdit_tpu/train/trainer.py``, single card).

The JAX trainer's recipe: AdamW (b1 0.9, b2 0.999, eps 1e-8) with the
configured learning-rate schedule evaluated per update count
(``make_lr_schedule``: StepLR by epoch, or half-cosine, with optional
linear warmup), optional global-norm clipping with optax's formula, the
sum of the four detector losses, "Epoch i/N, Loss: x" logging, one
``metrics.jsonl`` record per epoch with the JAX keys, and a checkpoint
every ``checkpoint_interval`` epochs; with ``eval_interval``, a COCO
evaluation of the eval split every that many epochs whose mAP joins the
epoch's record, a rolling ``model_checkpoints/best.pt`` at each new best,
and an early stop after ``early_stop_patience`` evals without one.

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
Waiting for later slices: EMA (so the raw parameters are scored),
gradient accumulation, multi-step dispatch, preemption handling and
mid-epoch resume, data-parallel evaluation, TensorBoard, the loss-curve
PNG, profiler upload and LoRA masks.
"""

from __future__ import annotations

import json
import math
import os
import re
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
from layoutdit_tpu_torch.models.model import LayoutDetectionModel
from layoutdit_tpu_torch.models.weights_io import k_bias_slots, tree_leaves, tree_map
from layoutdit_tpu_torch.train.checkpoint import (
    CHECKPOINT_DIR,
    checkpoint_file,
    load_checkpoint,
    save_checkpoint,
)

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
      model: ``LayoutDetectionModel`` or ``DetectorModel`` whose
        parameters live on ``device``; they are made trainable and
        updated in place, so after ``train()`` the model holds the
        trained weights, as the JAX trainer leaves them in its model,
        and the mid-training evaluator scores the same object.
      device: "cuda" unless the caller asks for the CPU. A CUDA device
        with no GPU present raises, and so do parameters elsewhere.
    """

    def __init__(self, config: RunConfig, model: LayoutDetectionModel | DetectorModel,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer: no CUDA device is available")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.model = model
        self.cfg = model.cfg
        if config.data.image_shards_dir:
            raise ValueError(
                "data_loader_config.image_shards_dir: tar shards are not supported by the "
                "port yet; they wait for a later slice"
            )
        self.params = model.params
        self._leaves = tree_leaves(self.params)
        if any(t.device != self.device for t in self._leaves):
            raise ValueError(f"Trainer: the model's parameters must live on {self.device}, "
                             "the trainer's device")
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
        # mid-training eval (TrainingConfig.eval_interval)
        self.best_map = float("-inf")
        self.best_checkpoint_path: str | None = None
        self._evals_since_best = 0  # mid-evals since the last best mAP
        self._evaluator = None  # built on the first mid-eval

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

    def _mid_eval(self, epoch: int) -> None:
        """Score the eval split (``TrainingConfig.eval_interval``): the mAP
        joins the epoch's ``metrics_history`` record (NaN when there was
        no prediction), and a new finite best writes
        ``model_checkpoints/best.pt``. Before the first finite best, a NaN
        does not count toward the early stop, so a run never stops without
        a best checkpoint."""
        if self._evaluator is None:
            from layoutdit_tpu_torch.eval.evaluator import Evaluator

            self._evaluator = Evaluator(self.model, self.config, device=self.device)
        metrics = self._evaluator.score()
        m = float(metrics["mAP"]) if metrics else float("nan")
        if self.metrics_history:
            self.metrics_history[-1]["mAP"] = m
        logger.info("Eval at epoch %d: mAP=%.4f", epoch + 1, m)
        if math.isfinite(m) and m > self.best_map:
            self._evals_since_best = 0
            self.best_map = m
            self.best_checkpoint_path = self.save_checkpoint(
                epoch + 1, stem="best", extra={"mAP": m, "epoch": epoch + 1})
            logger.info("New best mAP %.4f -> %s", m, self.best_checkpoint_path)
        elif math.isfinite(self.best_map):
            self._evals_since_best += 1

    def train(self) -> None:
        tc = self.config.train
        try:
            for epoch in range(self.epoch, tc.num_epochs):
                self._run_epoch(epoch)
                stop_early = False
                if tc.eval_interval > 0 and (epoch + 1) % tc.eval_interval == 0:
                    self._mid_eval(epoch)
                    # the best checkpoint holds the winning weights; the
                    # remaining epochs would be waste
                    stop_early = 0 < tc.early_stop_patience <= self._evals_since_best
                self._save_metrics()
                if (epoch + 1) % tc.checkpoint_interval == 0:
                    path = self.save_checkpoint(epoch + 1)
                    logger.info("Saved checkpoint to %s", path)
                self.epoch = epoch + 1
                if stop_early:
                    logger.info("Early stop at epoch %d: no mAP improvement in %d evals "
                                "(best %.4f)", epoch + 1, self._evals_since_best, self.best_map)
                    break
        finally:
            self.dataloader.close()

    # ------------------------------------------------------- artifacts

    def checkpoint_dir(self) -> str:
        return f"{self.config.artifact_dir}/{CHECKPOINT_DIR}"

    def checkpoint_path(self, epoch: int) -> str:
        return checkpoint_file(self.config.artifact_dir, epoch)

    def save_checkpoint(self, epoch: int, stem: str | None = None,
                        extra: dict | None = None) -> str:
        """The whole training state at ``epoch_{epoch}.pt`` (or
        ``{stem}.pt``): parameters, optimizer state, and in the extras the
        histories, the update count, the sampler generator and the
        mid-eval trackers, so a resumed run neither overwrites
        ``best.pt`` with worse weights nor restarts the early-stop clock;
        ``extra`` adds entries (``best.pt``'s ``mAP`` and ``epoch``)."""
        return save_checkpoint(
            checkpoint_file(self.config.artifact_dir, epoch, stem),
            tree_map(lambda t: t.detach().cpu(), self.params),
            self.optimizer.state_dict(), epoch,
            extra={
                "loss_history": self.loss_history,
                "metrics_history": self.metrics_history,
                "updates": self.updates,
                "generator_state": self.generator.get_state(),
                "best_map": self.best_map if math.isfinite(self.best_map) else None,
                "best_checkpoint_path": self.best_checkpoint_path,
                "evals_since_best": self._evals_since_best,
                **(extra or {}),
            },
        )

    def resume_candidates(self) -> list[str]:
        """This run's ``epoch_{n}.pt`` checkpoints, newest epoch first
        (``best.pt`` tracks eval quality, not training progress, and is
        not one of them); empty when there is none."""
        try:
            names = os.listdir(self.checkpoint_dir())
        except FileNotFoundError:
            return []
        epochs = [int(m.group(1)) for m in map(re.compile(r"epoch_(\d+)\.pt").fullmatch, names)
                  if m]
        return [self.checkpoint_path(e) for e in sorted(epochs, reverse=True)]

    def resume(self, path: str) -> None:
        """Restore parameters (in place), optimizer state, epoch, update
        count, histories, the sampler generator and the mid-eval trackers
        from a checkpoint. ``"auto"`` takes the newest readable
        ``epoch_{n}.pt`` of this run, falling back to the next-newest when
        one does not load, and starts fresh when there is none."""
        if path == "auto":
            candidates = self.resume_candidates()
            if not candidates:
                logger.info("--resume auto: no checkpoint under %s; starting fresh",
                            self.checkpoint_dir())
                return
            state = None
            for candidate in candidates:
                try:
                    state = load_checkpoint(candidate, map_location=self.device)
                # torch.load raises many types on a truncated or foreign
                # file (RuntimeError, UnpicklingError, EOFError, IndexError)
                except Exception as exc:  # noqa: BLE001
                    logger.warning("--resume auto: %s unreadable (%s); trying next-newest",
                                   candidate, exc)
                    continue
                path = candidate
                break
            if state is None:
                raise RuntimeError(
                    f"--resume auto: all {len(candidates)} checkpoints under "
                    f"{self.checkpoint_dir()} are unreadable; refusing to restart from scratch"
                )
        else:
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
        bm = extra.get("best_map")
        self.best_map = float(bm) if bm is not None else float("-inf")
        self.best_checkpoint_path = extra.get("best_checkpoint_path")
        self._evals_since_best = int(extra.get("evals_since_best", 0))
        logger.info("Resumed from %s at epoch %d", path, self.epoch)

    def _save_metrics(self) -> None:
        """Rewrite ``metrics/metrics.jsonl`` (one record per epoch)."""
        path = f"{self.config.artifact_dir}/metrics/metrics.jsonl"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for rec in self.metrics_history:
                f.write(json.dumps(rec) + "\n")

