"""The ``.orbax`` fixture of the port's reader (``train/orbax_read.py``):
JAX's ``save_checkpoint_sharded`` of a tiny RetinaNet state (encoder
hidden 16, 2 layers, 8 px patches, FPN 8 channels) with
the JAX trainer's AdamW chain after one update (clipping, bf16 ``mu``,
``apply_if_finite``) and an EMA, the parameters and moments placed by
``shard_params`` on a CPU mesh: 4 x 2 data x model (tensor parallelism)
or, with ``fsdp``, FSDP over 8 data devices.

    python tests/fixtures/orbax_fixture.py

rewrites the committed ``retinanet_tp.orbax`` (with its ``.meta.json``)
and ``retinanet_tp.sha256.json``, the SHA-256 of each leaf of the state
the port loads from it, which ``chip_smoke.py`` checks on the card.
It imports JAX; the tests import ``write`` and ``leaf_hashes``.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "retinanet_tp.orbax"
HASHES = HERE / "retinanet_tp.sha256.json"
EXTRA = {"loss_history": [1.5], "updates": 2, "steps_per_dispatch": 1}


def _configs():
    from layoutdit_tpu.config.constructs import DetectionBudget
    from layoutdit_tpu.models import backbone as jax_backbone
    from layoutdit_tpu.models import vit as jax_vit
    from layoutdit_tpu.models.detection import detector as jax_det

    vit = jax_vit.ViTConfig(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=32, patch_size=8, image_size=64)
    return jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=vit, fpn_out_channels=8), image_size=64,
        detector_kind="retinanet", num_classes=3, budget=DetectionBudget())


@functools.lru_cache(maxsize=1)
def state():
    """(params, opt_state as the JAX trainer checkpoints it) of the tiny
    RetinaNet, numpy leaves, the same on every call (computed once)."""
    import jax
    import numpy as np

    from layoutdit_tpu.config.constructs import TrainingConfig
    from layoutdit_tpu.models.detection import detector as jax_det
    from layoutdit_tpu.train.trainer import make_optimizer

    cfg = _configs()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    params["backbone"]["vit"]["pos_embed"] = (0.02 * np.random.default_rng(1).standard_normal(
        params["backbone"]["vit"]["pos_embed"].shape)).astype(np.float32)
    tx = make_optimizer(TrainingConfig(weight_decay=0.01, grad_clip_norm=1.0,
                                       adam_mu_dtype="bfloat16", skip_nonfinite_updates=2),
                        steps_per_epoch=2)
    opt = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: np.float32(0.1) * p + np.float32(1e-3), params)
    _, opt = jax.jit(tx.update)(grads, opt, params)
    ema = jax.tree_util.tree_map(lambda p: np.float32(0.9) * p, params)
    return params, {"tx": jax.tree_util.tree_map(np.asarray, opt), "ema": ema}


def write(path: str, fsdp: bool = False) -> tuple:
    """``state()`` through JAX's ``save_checkpoint_sharded`` at ``path``, the
    leaves sharded over 8 CPU devices: tensor parallel 4 x 2, or FSDP 8
    -> (params, opt_state) as placed, templates for JAX's load."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from layoutdit_tpu.parallel.sharding import shard_params
    from layoutdit_tpu.train.checkpoint import save_checkpoint_sharded

    params, opt = state()
    shape = (8, 1) if fsdp else (4, 2)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), ("data", "model"))
    place = lambda tree: shard_params(tree, mesh, fsdp=fsdp)  # noqa: E731
    sharded = place(params)
    tx = opt["tx"]
    # the moments take the parameters' layout, as jit-ed tx.init gives it
    inner = tx.inner_state[1][0]
    inner = inner._replace(mu=place(inner.mu), nu=place(inner.nu))
    tx = tx._replace(inner_state=(tx.inner_state[0], (inner, *tx.inner_state[1][1:])))
    opt = {"tx": tx, "ema": place(opt["ema"])}
    save_checkpoint_sharded(path, sharded, opt, epoch=2, extra=EXTRA)
    return sharded, opt


def leaf_hashes(state: dict) -> dict:
    """{name: SHA-256 of its bytes} of a port state dict's tensors (params,
    moments, counts, EMA), named by their place in it."""
    import torch

    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            out[prefix] = hashlib.sha256(raw.numpy().tobytes()).hexdigest() + f":{t.dtype}"
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)

    walk("", {"params": state["params"], "opt_state": state["opt_state"]})
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, str(HERE.parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write(str(FIXTURE))
    from layoutdit_tpu_torch.train.checkpoint import load_checkpoint

    hashes = leaf_hashes(load_checkpoint(str(FIXTURE), map_location="cpu"))
    HASHES.write_text(json.dumps(hashes, indent=1, sort_keys=True) + "\n")
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    print(f"wrote {FIXTURE} ({size} bytes) and {len(hashes)} leaf hashes")
