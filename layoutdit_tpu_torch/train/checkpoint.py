"""Training checkpoints with ``torch.save``/``torch.load`` (the JAX
package writes msgpack; loading those waits for a later slice, since it
needs flax/msgpack).

A checkpoint holds the parameter tree, the optimizer's ``state_dict``,
the epoch and a dict of extras (histories, the sampler generator's
state). It is written to a temporary file in the same directory and
renamed over the target, so a crash mid-write never leaves a truncated
checkpoint under the final name. Loading uses ``weights_only=True``:
only tensors and plain containers are unpickled.
"""

from __future__ import annotations

import os

import torch

# a run's checkpoints live under {run_dir}/CHECKPOINT_DIR
CHECKPOINT_DIR = "model_checkpoints"


def checkpoint_file(run_dir: str, epoch: int | None = None, stem: str | None = None) -> str:
    """A run's checkpoint file: ``{run_dir}/model_checkpoints/epoch_{epoch}.pt``,
    or ``{stem}.pt`` there when ``stem`` is given (``best``)."""
    return f"{run_dir}/{CHECKPOINT_DIR}/{stem or f'epoch_{epoch}'}.pt"


def save_checkpoint(path: str, params: dict, opt_state: dict, epoch: int,
                    extra: dict) -> str:
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
