"""Training checkpoints with ``torch.save``/``torch.load`` (the JAX
package writes msgpack; loading those waits for a later slice, since it
needs flax/msgpack), their retention, the resume candidates, and an
asynchronous writer (port of ``layoutdit_tpu/train/checkpoint.py``).

A checkpoint holds the parameter tree, the optimizer state (the
trainer's ``optim.AdamW`` state, or ``{"tx": ..., "ema": ...}`` with an
EMA of the parameters), the epoch and a dict of extras (histories, the
sampler generator's state). It is written to a temporary file in the
same directory and renamed over the target, so a crash mid-write never
leaves a truncated checkpoint under the final name. Loading uses
``weights_only=True``: only tensors and plain containers are unpickled.

File names: ``epoch_<n>.pt`` (periodic), ``epoch_<n>_preempt.pt`` (a
preemption's save, which may stop mid-epoch) and ``best.pt`` (the best
mid-training eval).
"""

from __future__ import annotations

import copy
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)

# a run's checkpoints live under {run_dir}/CHECKPOINT_DIR
CHECKPOINT_DIR = "model_checkpoints"
_NAME = re.compile(r"epoch_(\d+)(?:_([a-z]+))?\.pt$")


def checkpoint_file(run_dir: str, epoch: int | None = None, stem: str | None = None,
                    tag: str | None = None) -> str:
    """A run's checkpoint file: ``{run_dir}/model_checkpoints/epoch_{epoch}.pt``,
    ``epoch_{epoch}_{tag}.pt`` with a ``tag`` (``preempt``), or
    ``{stem}.pt`` when ``stem`` is given (``best``)."""
    name = stem or (f"epoch_{epoch}_{tag}" if tag else f"epoch_{epoch}")
    return f"{run_dir}/{CHECKPOINT_DIR}/{name}.pt"


def save_checkpoint(path: str, params: dict, opt_state, epoch: int, extra: dict) -> str:
    """Write ``{params, opt_state, epoch, extra}`` to ``path`` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    state = {"params": params, "opt_state": opt_state, "epoch": int(epoch),
             "extra": extra}
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, map_location: str | torch.device) -> dict:
    """The dict ``save_checkpoint`` wrote, tensors on ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def host_snapshot(tree):
    """A copy of a tree of tensors (dicts, lists, tuples, scalars) on the
    host that shares no storage with it: what a background write may read
    while training goes on changing the originals in place."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_snapshot(v) for v in tree)
    return copy.deepcopy(tree)


class AsyncCheckpointWriter:
    """Checkpoint writes off the training thread.

    ``save`` snapshots everything to the host on the caller's thread (the
    trainer updates its parameters, moments and EMA in place, so a write
    that read them later would race the next step), then serialises and
    writes on one worker thread. At most one write is in flight: a second
    ``save`` first waits for the first. A write's error is raised on the
    training thread, by the next ``save``, ``wait`` or ``close``."""

    def __init__(self):
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Future | None = None

    def save(self, path: str, params: dict, opt_state, epoch: int, extra: dict) -> None:
        self.wait()
        snapshot = host_snapshot((params, opt_state, extra))
        self._pending = self._executor.submit(save_checkpoint, path, snapshot[0], snapshot[1],
                                              epoch, snapshot[2])

    def wait(self) -> None:
        """Block until the in-flight write lands; raise its error here."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._executor.shutdown(wait=True)


def _list_checkpoints(root: str) -> list[tuple[int, str, str]]:
    """(epoch, tag, path) of every ``epoch_<n>[_tag].pt`` under ``root``
    (``best.pt`` never matches); empty when the directory is absent."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    return [(int(m.group(1)), m.group(2) or "", f"{root}/{n}")
            for n in names for m in [_NAME.fullmatch(n)] if m]


def prune_checkpoints(root: str, keep: int, current_epoch: int) -> list[str]:
    """Keep the newest ``keep`` periodic checkpoints under ``root`` and
    delete the rest; tagged saves (``*_preempt``) and ``best.pt`` are
    never touched. ``current_epoch`` counts as present even while its
    asynchronous write is in flight. Returns the deleted paths."""
    if keep <= 0:
        return []
    found = [(e, p) for e, tag, p in _list_checkpoints(root) if not tag]
    keep_set = set(sorted({e for e, _ in found} | {current_epoch}, reverse=True)[:keep])
    deleted = []
    for e, path in found:
        if e not in keep_set:
            os.remove(path)
            deleted.append(path)
            logger.info("Pruned checkpoint %s (keep_checkpoints=%d)", path, keep)
    return deleted


def list_resume_candidates(root: str) -> list[tuple[int, int, str]]:
    """Resumable checkpoints under ``root``, best first: ``(epoch,
    is_preempt, path)`` of the periodic and preemption saves, ordered by
    (epoch, preempt after periodic) descending, since a preemption save
    of epoch N may carry steps past the periodic one. ``best.pt`` tracks
    eval quality, not progress, and is not one of them."""
    return sorted(((e, int(tag == "preempt"), p) for e, tag, p in _list_checkpoints(root)
                   if tag in ("", "preempt")), reverse=True)
