"""Trainer for the ``faster_rcnn`` detector, with its cascade and mask
modifiers, the single-stage ``retinanet`` and ``fcos``, and the
set-prediction ``detr`` (port of ``layoutdit_tpu/train/trainer.py``,
single card). A mask model's loader rasterises the gt masks
(``gt_masks``), which reach each step; over tar shards it raises, as
JAX's. A single-stage or DETR model's step draws no sampler priorities
(``draw_priorities`` gives None); a DETR step solves its assignments in
one matcher launch.

The JAX trainer's recipe and run state:
  * optax's AdamW chain (``train/optim.py``): the configured
    learning-rate schedule per update, optional global-norm clipping,
    bf16 first moments (``adam_mu_dtype``) and the skipping of
    non-finite updates (``skip_nonfinite_updates``), whose count joins
    each epoch's record as ``skipped_nonfinite_steps``;
  * gradient accumulation (``grad_accumulation_steps`` = A): the batch
    splits into A micro-batches, each with its own sampler draws; their
    gradients are summed in float32 and divided by A, their losses
    averaged, and one update follows;
  * an EMA of the parameters (``ema_decay``): a float32 copy updated as
    ema * d + p * (1 - d) after every step, a skipped one included; the
    mid-training eval scores it, ``best.pt`` holds it, checkpoints carry
    ``{"tx": optimizer state, "ema": EMA}``;
  * ``steps_per_dispatch`` = S: the loader stacks S batches and the
    trainer runs their S steps in turn. JAX scans them in one device
    program; here they stay a host loop, because the NMS fixpoint reads
    the host once a sweep (``ops/nms.py``), which rules out capturing S
    steps in one CUDA graph. 0 (auto) resolves to 1: the card has no
    per-dispatch round trip to amortise;
  * preemption: on SIGTERM the in-flight dispatch finishes, then the
    whole state goes synchronously to ``epoch_<n>_preempt.pt`` with the
    step reached in the epoch, and the loop ends; ``resume`` continues
    that epoch from the next step (single process: no agreement between
    hosts);
  * checkpoints every ``checkpoint_interval`` epochs, written off the
    training thread with ``async_checkpoint``, the newest
    ``keep_checkpoints`` of them kept; ``resume("auto")`` takes the
    newest readable one;
  * the sum of the detector's losses, "Epoch i/N, Loss: x" logging,
    one ``metrics.jsonl`` record per epoch with the JAX keys, the same
    scalars in TensorBoard event files under ``{run}/tb`` (``tensorboard``),
    and the loss curve ``{run}/loss_history/loss_curve.png`` at the end
    of ``train()``;
  * with ``eval_interval``, a COCO evaluation of the eval split every
    that many epochs whose mAP joins the epoch's record, a rolling
    ``best.pt`` at each new best, and an early stop after
    ``early_stop_patience`` evals without one.

Differences from the JAX trainer, on purpose:
  * the train step runs eagerly under ``record_function`` ranges
    (``forward``, ``loss`` in ``detector_loss``; ``backward``,
    ``optimizer`` here), so a profiler trace splits a step by stage;
  * the samplers' priorities come from a ``torch.Generator`` on the
    device seeded from ``train_config.seed`` (JAX draws them with
    ``jax.random``, which torch cannot reproduce); its state rides the
    checkpoints, so a resumed run draws what the uninterrupted one drew;
  * the fused qkv's K-bias slot, which the JAX tree does not have, is
    held at zero: its gradient is zeroed before clipping and the update,
    so the optimizer never moves it and the clip norm does not count it;
  * checkpoints are ``torch.save`` files (``train/checkpoint.py``), and
    the loss curve is skipped, with a warning, where matplotlib is not
    installed.
``resume`` also takes the JAX trainer's ``.msgpack`` checkpoints
(parameters, optimizer state and EMA, epoch, and the extras JAX
restores; the sampler generator starts from the seed, since a JAX run
has none). With ``data_loader_config.image_shards_dir`` the pages are
read out of tar shards (``data/shards.py``). Every artifact path may be
a ``scheme://`` URL (``utils/paths.py``).
A LoRA model (``lora_rank`` > 0) with ``lora_freeze_base`` trains its
adapters and everything outside the encoder, as JAX's masked optimizer
does: the frozen encoder's tensors take no gradient (autograd skips
their weight-gradient products), hold no moments and keep their bits;
the clip norm covers the trainable gradients only; the EMA, as JAX's,
covers every parameter.
With ``enable_profile``, ``train()`` runs under ``torch.profiler`` (CPU
and CUDA activities on the card, CPU alone on the CPU), writes its chrome
trace under ``trace_log_dir`` and, from the lead process, uploads that
directory's files to ``{artifacts}/{run}/profiler/<relative path>``
(JAX ``_save_traces``).
Waiting for a later slice: data-parallel evaluation.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time

import torch
from torch.profiler import record_function

from layoutdit_tpu_torch.config import RunConfig
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionBatch, DetectionLoader
from layoutdit_tpu_torch.data.shards import make_sharded_dataset
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorModel,
    detector_loss,
    draw_priorities,
)
from layoutdit_tpu_torch.models.model import LayoutDetectionModel
from layoutdit_tpu_torch.models.lora import num_trainable, trainable_mask
from layoutdit_tpu_torch.models.weights_io import (
    copy_params_,
    k_bias_slots,
    tree_leaves,
    tree_map,
)
from layoutdit_tpu_torch.train.checkpoint import (
    CHECKPOINT_DIR,
    AsyncCheckpointWriter,
    checkpoint_file,
    list_resume_candidates,
    load_checkpoint,
    prune_checkpoints,
    save_checkpoint,
)
from layoutdit_tpu_torch.train.optim import AdamW, make_lr_schedule  # noqa: F401 (re-export)
from layoutdit_tpu_torch.utils.paths import join_path, open_path

logger = get_logger(__name__)


class _PreemptionGuard:
    """SIGTERM -> a graceful stop: the handler only sets a flag, which the
    epoch loop reads after each dispatch. A handler can be installed from
    the main thread only; elsewhere the trainer runs without the guard.
    The previous handler comes back on exit."""

    def __init__(self):
        self.preempted = False
        self._old = None
        self._installed = False

    def __enter__(self):
        try:
            self._old = signal.signal(signal.SIGTERM, self._handle)
            self._installed = True
        except ValueError:  # not the main thread
            self._installed = False
        return self

    def _handle(self, signum, frame):
        self.preempted = True
        logger.warning("SIGTERM received: will checkpoint and stop after the in-flight step")

    def __exit__(self, *exc):
        if self._installed:
            signal.signal(signal.SIGTERM, self._old)
        return False


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
        tc = config.train
        self.accum = max(1, tc.grad_accumulation_steps)
        if config.data.batch_size % self.accum:
            raise ValueError(
                f"data_loader_config.batch_size {config.data.batch_size} is not divisible by "
                f"train_config.grad_accumulation_steps {self.accum}"
            )
        self._leaves = tree_leaves(model.params)
        if any(t.device != self.device for t in self._leaves):
            raise ValueError(f"Trainer: the model's parameters must live on {self.device}, "
                             "the trainer's device")
        self._trainable = None
        if self.cfg.backbone.vit.lora_rank > 0 and tc.lora_freeze_base \
                and self.cfg.backbone_kind == "dit":
            self._trainable = trainable_mask(model.params)
            n_train, n_total = num_trainable(model.params)
            logger.info("LoRA fine-tune: %d / %d params trainable (%.1f%%); frozen encoder "
                        "weights get no optimizer moments", n_train, n_total,
                        100.0 * n_train / max(1, n_total))
        for t, m in zip(self._leaves, self._trainable or [True] * len(self._leaves)):
            t.requires_grad_(m)
        self._train_leaves = [t for t in self._leaves if t.requires_grad]
        self._k_bias = k_bias_slots(model.params)
        if tc.steps_per_dispatch > 0:
            self.steps_per_dispatch = tc.steps_per_dispatch
        else:
            self.steps_per_dispatch = 1
            logger.info("steps_per_dispatch auto -> 1: steps are dispatched from a host loop "
                        "on the card, so stacking batches amortises no round trip")
        self._build_dataloader()
        self.optimizer = AdamW(tc, len(self.dataloader))
        self.opt_state = self.optimizer.init(self._leaves, self._trainable)
        self.lr_schedule = self.optimizer.lr_schedule
        # EMA of the parameters: its own float32 tensors, never aliasing them
        self.ema_params = (tree_map(lambda t: t.detach().clone(), model.params)
                           if tc.ema_decay > 0 else None)
        self.generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.epoch = 0
        self.updates = 0
        self.loss_history: list[float] = []
        self.metrics_history: list[dict] = []
        self._start_step = 0  # mid-epoch resume offset (set by resume())
        self._partial_steps = 0  # steps done when a preemption cut an epoch
        self._guard: _PreemptionGuard | None = None
        self._skipped_logged = 0
        # mid-training eval (TrainingConfig.eval_interval)
        self.best_map = float("-inf")
        self.best_checkpoint_path: str | None = None
        self._evals_since_best = 0  # mid-evals since the last best mAP
        self._evaluator = None  # built on the first mid-eval

    @property
    def params(self) -> dict:
        return self.model.params

    def _build_dataloader(self) -> None:
        images_root, ann_json = self.config.train_split()
        dl = self.config.data
        with_mask = self.cfg.with_mask
        if dl.image_shards_dir:
            if with_mask:  # as JAX's trainer
                raise ValueError("with_mask training is not wired to tar-shard datasets yet; "
                                 "use the plain images_root/annotations layout")
            dataset = make_sharded_dataset(dl.image_shards_dir, ann_json)
        else:
            dataset = PubLayNetDataset(images_root, ann_json, with_segmentation=with_mask)
        self.dataloader = DetectionLoader(
            dataset,
            batch_size=dl.batch_size,
            shuffle=dl.shuffle,
            num_workers=dl.num_workers,
            image_size=self.cfg.image_size,
            max_gt=dl.max_gt_boxes,
            seed=self.config.train.seed,
            drop_last=True,  # constant shapes per step
            prefetch_depth=dl.prefetch_depth,
            augment_hflip=dl.augment_hflip,
            stack_batches=self.steps_per_dispatch,
            device=self.device,
            load_masks=with_mask,
            mask_size=self.cfg.gt_mask_size,
        )

    # ------------------------------------------------------------ step

    def train_step(self, batch: DetectionBatch) -> tuple[torch.Tensor, dict]:
        """One update on ``batch`` -> (total loss, the losses of
        ``detector_loss``), device scalars (no host sync).
        With A micro-batches, each draws its own sampler priorities and
        the losses are their means."""
        micro = self.config.data.batch_size // self.accum
        parts = []
        for a in range(self.accum):
            rows = slice(a * micro, (a + 1) * micro)
            gt_labels = batch.gt_labels[rows]
            priorities = draw_priorities(self.cfg, micro, gt_labels.shape[1], self.generator)
            losses = detector_loss(
                self.model.params, batch.images[rows], batch.gt_boxes[rows], gt_labels,
                batch.gt_valid[rows], self.cfg, priorities,
                gt_masks=None if batch.gt_masks is None else batch.gt_masks[rows],
            )
            loss = sum(losses.values())
            with record_function("backward"):
                # the leaves' .grad sums the micro-batches' float32 gradients
                loss.backward()
            parts.append((loss.detach(), {k: v.detach() for k, v in losses.items()}))
        with record_function("optimizer"):
            grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                     for t in self._train_leaves]
            if self.accum > 1:
                torch._foreach_div_(grads, float(self.accum))
            for bias, k_slot in self._k_bias:
                if bias.grad is not None:
                    bias.grad[k_slot] = 0.0
            self.optimizer.update(self.opt_state, self._train_leaves, grads)
            for t in self._train_leaves:
                t.grad = None
            if self.ema_params is not None:
                d = self.config.train.ema_decay
                ema = tree_leaves(self.ema_params)
                with torch.no_grad():
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, torch._foreach_mul(self._leaves, 1 - d))
        self.updates += 1
        if self.accum == 1:
            return parts[0]
        loss = torch.stack([p[0] for p in parts]).mean()
        return loss, {k: torch.stack([p[1][k] for p in parts]).mean() for k in parts[0][1]}

    def _dispatch(self, batch: DetectionBatch, steps: int) -> list[torch.Tensor]:
        """The ``steps`` steps of a plain (1) or stacked (S) batch, in turn."""
        if steps == 1:
            return [self.train_step(batch)[0]]
        return [self.train_step(DetectionBatch(
            images=batch.images[s], gt_boxes=batch.gt_boxes[s], gt_labels=batch.gt_labels[s],
            gt_valid=batch.gt_valid[s], image_ids=batch.image_ids, orig_sizes=batch.orig_sizes,
            image_valid=batch.image_valid,
            gt_masks=None if batch.gt_masks is None else batch.gt_masks[s]))[0]
            for s in range(steps)]

    # ------------------------------------------------------------ loops

    def _run_epoch(self, epoch: int) -> float:
        tc = self.config.train
        t0 = time.perf_counter()
        # a mid-epoch resume skips the steps the preempted run made
        skip, self._start_step = self._start_step, 0
        self._partial_steps = 0
        self.dataloader.set_epoch(epoch)
        if skip:
            self.dataloader.skip_batches(skip)
        n_steps, n_new, n_images = skip, 0, 0
        losses = []
        for batch in self.dataloader:
            steps = batch.images.shape[0] if batch.images.dim() == 5 else 1
            losses += self._dispatch(batch, steps)
            n_steps += steps
            n_new += steps
            n_images += int(batch.image_valid.sum())
            if self._guard is not None and self._guard.preempted:
                self._partial_steps = n_steps
                break
        if n_new == 0:
            logger.info("Epoch %d already complete at the resume point", epoch + 1)
            return self.loss_history[-1] if self.loss_history else 0.0
        # one host read of the epoch's losses, at its end
        avg = float(torch.stack(losses).mean())
        dt = max(time.perf_counter() - t0, 1e-9)
        self.loss_history.append(avg)
        rec = {
            "epoch": epoch + 1,
            "loss": avg,
            "images_per_sec": round(n_images / dt, 2),
            "learning_rate": float(self.lr_schedule(self.updates)),
        }
        if tc.skip_nonfinite_updates > 0:
            rec["skipped_nonfinite_steps"] = int(self.opt_state["total_notfinite"])
            if rec["skipped_nonfinite_steps"] > self._skipped_logged:
                logger.warning("%d non-finite gradient step(s) skipped so far this run "
                               "(parameters and moments untouched on those)",
                               rec["skipped_nonfinite_steps"])
                self._skipped_logged = rec["skipped_nonfinite_steps"]
        self.metrics_history.append(rec)
        logger.info("Epoch %d/%d, Loss: %.4f (%.1f img/s)",
                    epoch + 1, tc.num_epochs, avg, n_images / dt)
        return avg

    def _mid_eval(self, epoch: int) -> None:
        """Score the eval split (``TrainingConfig.eval_interval``), the EMA
        weights when there are some: the mAP joins the epoch's
        ``metrics_history`` record (NaN when there was no prediction), and
        a new finite best writes ``model_checkpoints/best.pt`` with the
        weights scored. Before the first finite best, a NaN does not
        count toward the early stop, so a run never stops without a best
        checkpoint."""
        if self._evaluator is None:
            from layoutdit_tpu_torch.eval.evaluator import Evaluator

            self._evaluator = Evaluator(self.model, self.config, device=self.device)
        saved = None
        if self.ema_params is not None:
            # the evaluator reads model.params at each score()
            saved, self.model.params = self.model.params, self.ema_params
        try:
            metrics = self._evaluator.score()
            m = float(metrics["mAP"]) if metrics else float("nan")
            if self.metrics_history:
                self.metrics_history[-1]["mAP"] = m
            logger.info("Eval at epoch %d: mAP=%.4f", epoch + 1, m)
            if math.isfinite(m) and m > self.best_map:
                self._evals_since_best = 0
                self.best_map = m
                self.best_checkpoint_path = self.save_checkpoint(
                    epoch + 1, stem="best",
                    extra={"mAP": m, "epoch": epoch + 1, "ema": self.ema_params is not None})
                logger.info("New best mAP %.4f -> %s", m, self.best_checkpoint_path)
            elif math.isfinite(self.best_map):
                self._evals_since_best += 1
        finally:
            if saved is not None:
                self.model.params = saved

    def train(self) -> None:
        tc = self.config.train
        profiler = None
        if tc.enable_profile:  # the card's activity too on the card
            from torch.profiler import ProfilerActivity, profile

            profiler = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else []))
            profiler.start()
        writer = AsyncCheckpointWriter() if tc.async_checkpoint else None
        tb = None
        if tc.tensorboard:
            from layoutdit_tpu_torch.utils.tensorboard import TensorBoardWriter

            tb = TensorBoardWriter(f"{self.config.artifact_dir}/tb")
        try:
            with _PreemptionGuard() as guard:
                self._guard = guard
                for epoch in range(self.epoch, tc.num_epochs):
                    self._run_epoch(epoch)
                    if self._partial_steps or guard.preempted:
                        # cut mid-epoch: resume continues the epoch after its
                        # last step; a SIGTERM after the epoch's last step
                        # resumes at the next epoch. Synchronous: the grace
                        # window may be short.
                        done_epoch = epoch if self._partial_steps else epoch + 1
                        if writer is not None:
                            writer.wait()
                        path = self.save_checkpoint(
                            done_epoch, tag="preempt",
                            extra={"step_in_epoch": self._partial_steps})
                        self.epoch = done_epoch
                        logger.warning("Preempted at epoch %d step %d; saved %s; resume with "
                                       "--resume %s", epoch + 1, self._partial_steps, path, path)
                        break
                    stop_early = False
                    if tc.eval_interval > 0 and (epoch + 1) % tc.eval_interval == 0:
                        self._mid_eval(epoch)
                        # the best checkpoint holds the winning weights; the
                        # remaining epochs would be waste
                        stop_early = 0 < tc.early_stop_patience <= self._evals_since_best
                    if tb is not None and self.metrics_history and \
                            self.metrics_history[-1].get("epoch") == epoch + 1:
                        tb.scalars({f"train/{k}": v for k, v in self.metrics_history[-1].items()
                                    if k != "epoch"}, step=epoch + 1)
                        tb.flush()
                    self._save_metrics()
                    if (epoch + 1) % tc.checkpoint_interval == 0:
                        path = self.save_checkpoint(epoch + 1, writer=writer)
                        logger.info("Saved checkpoint to %s%s", path,
                                    " (async)" if writer is not None else "")
                        prune_checkpoints(self.checkpoint_dir(), tc.keep_checkpoints, epoch + 1)
                    self.epoch = epoch + 1
                    if stop_early:
                        logger.info("Early stop at epoch %d: no mAP improvement in %d evals "
                                    "(best %.4f)", epoch + 1, self._evals_since_best,
                                    self.best_map)
                        break
        finally:
            self._guard = None
            try:
                if writer is not None:
                    writer.close()  # the checkpoints are on disk when train() returns
            finally:
                if tb is not None:
                    tb.close()
                self.dataloader.close()
                if profiler is not None:
                    profiler.stop()
        self._save_loss()
        self._save_metrics()
        if profiler is not None:
            os.makedirs(tc.trace_log_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(
                tc.trace_log_dir, f"{self.config.run_name}.{time.time_ns()}.pt.trace.json"))
            self._save_traces()

    def _save_traces(self) -> None:
        """Upload every file under ``trace_log_dir`` to
        ``{artifacts}/{run}/profiler/`` keeping its relative path (JAX
        ``_save_traces``); the lead process only."""
        if torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
            return
        root = self.config.train.trace_log_dir.rstrip("/")
        remote_root = f"{self.config.artifact_dir}/profiler"
        for dirpath, _, filenames in os.walk(root):
            for name in filenames:
                local = os.path.join(dirpath, name)
                rel = os.path.relpath(local, root).replace(os.sep, "/")
                remote = join_path(remote_root, rel)
                with open(local, "rb") as src, open_path(remote, "wb") as dst:
                    dst.write(src.read())
                logger.info("Uploaded trace %s -> %s", rel, remote)

    # ------------------------------------------------------- artifacts

    def checkpoint_dir(self) -> str:
        return f"{self.config.artifact_dir}/{CHECKPOINT_DIR}"

    def checkpoint_path(self, epoch: int, tag: str | None = None) -> str:
        return checkpoint_file(self.config.artifact_dir, epoch, tag=tag)

    def _opt_state_for_checkpoint(self):
        if self.ema_params is None:
            return self.opt_state
        return {"tx": self.opt_state, "ema": self.ema_params}

    def save_checkpoint(self, epoch: int, stem: str | None = None, tag: str | None = None,
                        extra: dict | None = None,
                        writer: AsyncCheckpointWriter | None = None) -> str:
        """The whole training state at ``epoch_{epoch}.pt`` (or
        ``epoch_{epoch}_{tag}.pt``, or ``{stem}.pt``): parameters (the EMA
        weights in ``best.pt``, which holds what the mid-eval scored),
        optimizer state and EMA, and in the extras the histories, the
        update count, the sampler generator, the mid-eval trackers (so a
        resumed run neither overwrites ``best.pt`` with worse weights nor
        restarts the early-stop clock) and the resolved
        ``steps_per_dispatch``; ``extra`` adds entries (``best.pt``'s
        ``mAP``, a preemption's ``step_in_epoch``). With ``writer``, the
        state is snapshot to the host here and written in the background."""
        path = checkpoint_file(self.config.artifact_dir, epoch, stem, tag)
        params = self.ema_params if stem == "best" and self.ema_params is not None \
            else self.model.params
        extra = self.checkpoint_extra(extra)
        if writer is not None:
            writer.save(path, params, self._opt_state_for_checkpoint(), epoch, extra)
            return path
        return save_checkpoint(path, tree_map(lambda t: t.detach().cpu(), params),
                               self._opt_state_for_checkpoint(), epoch, extra)

    def checkpoint_extra(self, extra: dict | None = None) -> dict:
        """The extras a checkpoint carries (see ``save_checkpoint``), with
        ``extra``'s entries added."""
        return {
            "loss_history": self.loss_history,
            "metrics_history": self.metrics_history,
            "updates": self.updates,
            "generator_state": self.generator.get_state(),
            "best_map": self.best_map if math.isfinite(self.best_map) else None,
            "best_checkpoint_path": self.best_checkpoint_path,
            "evals_since_best": self._evals_since_best,
            "steps_per_dispatch": self.steps_per_dispatch,
            **(extra or {}),
        }

    def resume_candidates(self) -> list[str]:
        """This run's ``epoch_{n}`` and ``epoch_{n}_preempt`` checkpoints
        (``.pt``, or the JAX trainer's ``.msgpack``), best first
        (``list_resume_candidates``)."""
        return [p for _, _, p in list_resume_candidates(self.checkpoint_dir())]

    def resume(self, path: str) -> None:
        """Restore parameters (in place), optimizer state and EMA, epoch
        and step in it, update count, histories, the sampler generator,
        the mid-eval trackers and the original run's
        ``steps_per_dispatch`` from a checkpoint. ``"auto"`` takes the
        newest readable checkpoint of this run (a preemption's save of an
        epoch after its periodic one), falling back to the next-newest
        when one does not load, and starts fresh when there is none."""
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
            logger.info("--resume auto: resuming from %s", path)
        else:
            state = load_checkpoint(path, map_location=self.device)
        opt_state = state["opt_state"]
        if opt_state is None:
            # a JAX checkpoint saved without its optimizer state (a
            # converted model): the weights only, as the JAX trainer does
            logger.warning("%s has no optimizer state; resuming weights only", path)
        elif "param_groups" in opt_state:
            raise ValueError(
                f"{path}: its optimizer state is a torch.optim.AdamW state_dict, written by "
                "an earlier trainer of the port; this trainer resumes only its own optax-"
                "layout state (train/optim.py). Its weights load with "
                "LayoutDetectionModel.restore_checkpoint."
            )
        elif ("ema" in opt_state) != (self.ema_params is not None):
            raise ValueError(f"{path}: the checkpoint {'has' if 'ema' in opt_state else 'lacks'} "
                             "an EMA of the parameters and this run's ema_decay disagrees")
        tx = None
        if opt_state is not None:
            tx = opt_state["tx"] if self.ema_params is not None else opt_state
            if (set(tx) != set(self.opt_state)
                    or tx["mu"][0].dtype != self.opt_state["mu"][0].dtype):
                raise ValueError(
                    f"{path}: its optimizer state ({sorted(tx)}, mu {tx['mu'][0].dtype}) does "
                    "not match this run's skip_nonfinite_updates, adam_mu_dtype and LoRA "
                    "freezing (lora_freeze_base)"
                )
            if "trainable" in tx and not torch.equal(tx["trainable"].cpu(),
                                                     self.opt_state["trainable"].cpu()):
                raise ValueError(f"{path}: its optimizer's trainable mask differs from this "
                                 "run's (another lora_targets?)")
        try:
            copy_params_(self.model.params, state["params"])
            if tx is not None and self.ema_params is not None:
                copy_params_(self.ema_params, opt_state["ema"])
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
        if tx is not None:
            self.opt_state = tx
        extra = state["extra"]
        self.epoch = state["epoch"]
        self.loss_history = list(extra.get("loss_history", []))
        self.metrics_history = list(extra.get("metrics_history", []))
        # a JAX checkpoint carries no generator: the samplers draw from the
        # seed's stream (torch cannot reproduce jax.random's anyway)
        if extra.get("generator_state") is not None:
            self.generator.set_state(
                torch.as_tensor(extra["generator_state"], dtype=torch.uint8).cpu())
        bm = extra.get("best_map")
        self.best_map = float(bm) if bm is not None else float("-inf")
        self.best_checkpoint_path = extra.get("best_checkpoint_path")
        self._evals_since_best = int(extra.get("evals_since_best") or 0)
        self._start_step = int(extra.get("step_in_epoch") or 0)
        # JAX counts the updates from the epoch and the step in it
        self.updates = int(extra.get("updates", self.epoch * len(self.dataloader)
                                     + self._start_step))
        saved_s = int(extra.get("steps_per_dispatch") or 0)
        if saved_s and saved_s != self.steps_per_dispatch:
            logger.info("Resume: adopting the checkpoint's steps_per_dispatch=%d (this run "
                        "resolved %d)", saved_s, self.steps_per_dispatch)
            self.steps_per_dispatch = saved_s
            self.dataloader.close()
            self._build_dataloader()
        logger.info("Resumed from %s at epoch %d%s", path, self.epoch,
                    f" step {self._start_step}" if self._start_step else "")

    def _save_loss(self) -> None:
        """The loss curve, ``{run}/loss_history/loss_curve.png``; without
        matplotlib, a warning and no file."""
        try:
            import matplotlib
        except ImportError:
            logger.warning("matplotlib is not installed: no loss curve written")
            return
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(range(1, len(self.loss_history) + 1), self.loss_history, marker="o")
        ax.set_xlabel("Epoch")
        ax.set_ylabel("Average Loss")
        ax.set_title("Training Loss per Epoch")
        path = f"{self.config.artifact_dir}/loss_history/loss_curve.png"
        logger.info("Saving loss to %s", path)
        with open_path(path, "wb") as f:
            fig.savefig(f, format="png", bbox_inches="tight")
        plt.close(fig)

    def _save_metrics(self) -> None:
        """Rewrite ``metrics/metrics.jsonl`` (one record per epoch)."""
        path = f"{self.config.artifact_dir}/metrics/metrics.jsonl"
        with open_path(path, "w") as f:
            for rec in self.metrics_history:
                f.write(json.dumps(rec) + "\n")
