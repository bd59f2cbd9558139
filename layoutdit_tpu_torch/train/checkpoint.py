"""Training checkpoints: the port's ``torch.save`` files, the JAX
package's msgpack files, their retention, the resume candidates, and an
asynchronous writer (port of ``layoutdit_tpu/train/checkpoint.py``).

A checkpoint holds the parameter tree, the optimizer state (the
trainer's ``optim.AdamW`` state, or ``{"tx": ..., "ema": ...}`` with an
EMA of the parameters), the epoch and a dict of extras (histories, the
sampler generator's state). The trainer writes ``.pt`` files, to a
temporary file in the same directory renamed over the target, so a
crash mid-write never leaves a truncated checkpoint under the final
name. Loading a ``.pt`` uses ``weights_only=True``: only tensors and
plain containers are unpickled.

``load_checkpoint`` also reads the JAX trainer's ``.msgpack`` files
(``b"LDTPU1\n"`` then flax msgpack of ``{"params", "opt_state", "meta":
{"epoch", "extra" (JSON text), "has_opt_state"}}``) with the port's own
decoder (``utils/flax_msgpack.py``) and maps them onto the port's trees
(``models/weights_io.py``); ``save_as_jax`` writes that format from the
port's state. Every path may be local or a ``scheme://`` URL
(``utils/paths.py``).

It reads the JAX package's sharded ``.orbax`` checkpoint directories
too (``save_checkpoint_sharded``: what JAX writes whenever its
parameters are sharded, under tensor parallelism, FSDP or on several
hosts) through ``train/orbax_read.py``, which needs neither orbax nor
JAX; their trees map through the same ``params_from_jax`` /
``train_state_from_jax`` as the msgpack's, so both give the port the
same state. The port writes ``.pt`` only.

File names: ``epoch_<n>.{pt,msgpack,orbax}`` (periodic),
``epoch_<n>_preempt.*`` (a preemption's save, which may stop mid-epoch)
and ``best.*`` (the best mid-training eval). An ``.orbax`` checkpoint is
a directory with a ``<name>.meta.json`` beside it.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from layoutdit_tpu_torch.train import orbax_read
from layoutdit_tpu_torch.utils import flax_msgpack
from layoutdit_tpu_torch.utils.paths import LocalFS, fs_for, open_path, read_bytearray

logger = get_logger(__name__)

# a run's checkpoints live under {run_dir}/CHECKPOINT_DIR
CHECKPOINT_DIR = "model_checkpoints"
# the JAX package's name pattern (train/checkpoint.py, _list_checkpoints)
# with the port's .pt beside its .msgpack and .orbax
_NAME = re.compile(r"epoch_(\d+)(?:_([a-z]+))?\.(pt|msgpack|orbax)$")
# the JAX package's checkpoint magic
JAX_MAGIC = b"LDTPU1\n"


def checkpoint_file(run_dir: str, epoch: int | None = None, stem: str | None = None,
                    tag: str | None = None) -> str:
    """A run's checkpoint file: ``{run_dir}/model_checkpoints/epoch_{epoch}.pt``,
    ``epoch_{epoch}_{tag}.pt`` with a ``tag`` (``preempt``), or
    ``{stem}.pt`` when ``stem`` is given (``best``)."""
    name = stem or (f"epoch_{epoch}_{tag}" if tag else f"epoch_{epoch}")
    return f"{run_dir}/{CHECKPOINT_DIR}/{name}.pt"


def _write_atomic(path: str, write) -> str:
    """``write(f)`` into a temporary file beside ``path`` (``open_path``
    makes the directory), then renamed over it (the ``.tmp`` suffix never
    matches a checkpoint name)."""
    path = os.fspath(path)
    fs = fs_for(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open_path(tmp, "wb") as f:
            write(f)
        fs.replace(tmp, path)
    finally:
        if fs.exists(tmp):
            fs.remove(tmp)
    return path


def save_checkpoint(path: str | os.PathLike, params: dict, opt_state, epoch: int,
                    extra: dict) -> str:
    """Write ``{params, opt_state, epoch, extra}`` to ``path`` atomically."""
    state = {"params": params, "opt_state": opt_state, "epoch": int(epoch),
             "extra": extra}
    return _write_atomic(path, lambda f: torch.save(state, f))


def _write_jax(path: str, params: dict, opt_state, epoch: int, extra: dict) -> str:
    """``{params, opt_state, meta}`` (JAX-layout trees) as the JAX
    package's ``.msgpack`` checkpoint at ``path``, atomically, written
    piece by piece."""
    extra = {k: v.tolist() if isinstance(v, torch.Tensor) else v for k, v in extra.items()}
    payload = {
        "params": params,
        "opt_state": {} if opt_state is None else opt_state,
        "meta": {"epoch": int(epoch), "extra": json.dumps(extra),
                 "has_opt_state": opt_state is not None},
    }
    parts = flax_msgpack.dump_parts(flax_msgpack.state_dict(payload))

    def write(f):
        f.write(JAX_MAGIC)
        for part in parts:
            f.write(part)

    return _write_atomic(path, write)


def save_as_jax(path: str, params: dict, opt_state, epoch: int, extra: dict,
                clip: bool) -> str:
    """The port's state as the JAX trainer's ``.msgpack`` checkpoint at
    ``path``: parameters through ``params_to_jax``, the optimizer state
    (and EMA) through ``train_state_to_jax`` (``clip``: the run clips
    gradients), tensors in ``extra`` as lists of numbers (JSON)."""
    return _write_jax(path, params_to_jax(params),
                      None if opt_state is None else train_state_to_jax(opt_state, params, clip),
                      epoch, extra)


def save_jax_params(path: str, params: dict, extra: dict, epoch: int = 0) -> str:
    """A params-only ``.msgpack`` of a tree already in the JAX layout
    (numpy leaves): a converted encoder (``tools/convert_hf_checkpoint.py``)
    or a merged model (``tools/merge_lora.py``)."""
    return _write_jax(path, params, None, epoch, extra)


def _load_jax(path: str, map_location) -> dict:
    """A JAX ``.msgpack`` checkpoint as the port's state dict."""
    buf = read_bytearray(path)
    if not buf.startswith(JAX_MAGIC):
        raise ValueError(f"{path} is not a layoutdit_tpu checkpoint")
    raw = flax_msgpack.lists_from_state_dict(
        flax_msgpack.loads(memoryview(buf)[len(JAX_MAGIC):]))
    meta = raw.get("meta", {})
    return _from_jax(raw, bool(meta.get("has_opt_state")), int(meta.get("epoch", 0)),
                     json.loads(meta.get("extra", "{}")), map_location)


def _from_jax(raw: dict, has_opt_state: bool, epoch: int, extra: dict, map_location) -> dict:
    """JAX's ``{params, opt_state}`` trees (flax's state-dict form) -> the
    port's state dict."""
    opt_state = None
    if has_opt_state:
        opt_state = train_state_from_jax(raw["opt_state"], map_location, raw["params"])
    return {"params": params_from_jax(raw["params"], map_location), "opt_state": opt_state,
            "epoch": epoch, "extra": extra}


def _load_orbax(path: str, map_location) -> dict:
    """A JAX ``.orbax`` checkpoint directory as the port's state dict
    (``train/orbax_read.py``; epoch, extras and ``has_opt_state`` from
    the sibling ``.meta.json``, as JAX's ``load_checkpoint_sharded``)."""
    raw = flax_msgpack.lists_from_state_dict(orbax_read.read_tree(path))
    meta = orbax_read.read_meta(path)
    has_opt = bool(meta.get("has_opt_state", "opt_state" in raw))
    return _from_jax(raw, has_opt and "opt_state" in raw, int(meta.get("epoch", 0)),
                     meta.get("extra") or {}, map_location)


def load_checkpoint(path: str | os.PathLike, map_location: str | torch.device) -> dict:
    """``{params, opt_state, epoch, extra}`` of a checkpoint, tensors on
    ``map_location``: a ``.pt`` file as ``save_checkpoint`` wrote it, or a
    JAX ``.msgpack`` file or ``.orbax`` directory mapped onto the port's
    trees (``opt_state`` is None when it has none; its extras are the JAX
    trainer's)."""
    path = os.fspath(path)
    if path.rstrip("/").endswith(".orbax"):
        return _load_orbax(path.rstrip("/"), map_location)
    if path.endswith(".msgpack"):
        return _load_jax(path, map_location)
    with open_path(path, "rb") as f:
        return torch.load(f, map_location=map_location, weights_only=True)


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
    """(epoch, tag, path) of every ``epoch_<n>[_tag].{pt,msgpack,orbax}``
    under ``root`` (``best.*`` never matches); empty when the directory is
    absent."""
    try:
        names = fs_for(root).listdir(root)
    except FileNotFoundError:
        return []
    return [(int(m.group(1)), m.group(2) or "", f"{root}/{n}")
            for n in names for m in [_NAME.fullmatch(n)] if m]


def _remove_tree(fs, path: str) -> None:
    """A directory and everything under it."""
    if isinstance(fs, LocalFS):
        shutil.rmtree(path)
    else:
        fs.fs.rm(path, recursive=True)


def prune_checkpoints(root: str, keep: int, current_epoch: int) -> list[str]:
    """Keep the newest ``keep`` periodic checkpoints under ``root`` and
    delete the rest; tagged saves (``*_preempt``) and ``best.*`` are
    never touched. ``current_epoch`` counts as present even while its
    asynchronous write is in flight. An ``.orbax`` directory goes with its
    files and its ``.meta.json``, as JAX prunes it. Returns the deleted
    paths."""
    if keep <= 0:
        return []
    fs = fs_for(root)
    found = [(e, p) for e, tag, p in _list_checkpoints(root) if not tag]
    keep_set = set(sorted({e for e, _ in found} | {current_epoch}, reverse=True)[:keep])
    deleted = []
    for e, path in found:
        if e not in keep_set:
            if path.endswith(".orbax"):
                _remove_tree(fs, path)
                if fs.exists(f"{path}.meta.json"):
                    fs.remove(f"{path}.meta.json")
            else:
                fs.remove(path)
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
