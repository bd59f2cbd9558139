"""The flagship convergence recipe, run through the port: the tiny
detector fine-tuned for 48 epochs on 128 synthetic pages and scored on
32 held-out ones, with the JAX package's floors
(``tests/test_convergence.py::test_synthetic_fixture_multiepoch_convergence``,
``docs/convergence.md`` "Recipe").

  * data: ``make_fixture`` pages, a ``samples`` split of 128 (seed 0)
    to train on and a ``val`` split of 32 (seed 777) to score;
  * model: ``write_fixture_config(tiny_model=True)``'s detector (hidden
    64, 2 layers, 2 heads, FPN 64 channels), batch 8;
  * schedule: cosine from 2e-4 with 48 warmup steps, 48 epochs, a
    checkpoint at the end;
  * floors: held-out mAP >= 0.45, AP50 >= 0.70, AP50 >= 0.3 for text,
    title, list and figure, and the mean loss of the last 4 epochs under
    0.4 x that of the first 4.

The compute dtype is the caller's: ``float32`` as the JAX test runs it,
``bfloat16`` on the card, whose kernels take bf16 only.

Usage: python -m layoutdit_tpu_torch.tools.convergence [--device cuda|cpu]
           [--dtype bfloat16|float32] [--eval-interval 16] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

EPOCHS = 48
TRAIN_PAGES = 128
VAL_PAGES = 32
BATCH = 8
FLOOR_MAP = 0.45
FLOOR_AP50 = 0.70
FLOOR_CLASS_AP50 = 0.3
FLOOR_CLASSES = ("text", "title", "list", "figure")
LOSS_RATIO = 0.4


def recipe_config(root: str, compute_dtype: str, eval_interval: int = 0, seed: int = 0):
    """Write the recipe's pages and config under ``root`` -> its ``RunConfig``
    (``seed`` is ``train.seed``: the weights' and the samplers' seed; the
    pages stay those of seeds 0 and 777)."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config

    make_fixture(root, n_images=TRAIN_PAGES, split="samples", seed=0)
    make_fixture(root, n_images=VAL_PAGES, split="val", seed=777)
    path = write_fixture_config(root, split="samples", epochs=EPOCHS, batch_size=BATCH,
                                tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_input"] = "val"
    # local_mode would train on the eval split: train on the 128 pages
    raw["local_mode"] = False
    raw["train_config"].update(checkpoint_interval=EPOCHS, lr_schedule="cosine",
                               learning_rate=2e-4, warmup_steps=48,
                               eval_interval=eval_interval, seed=seed)
    raw["precision"] = {"compute_dtype": compute_dtype}
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)
    return load_run_config(path)


def run_recipe(root: str, compute_dtype: str, device: str = "cuda",
               eval_interval: int = 0, seed: int = 0) -> dict:
    """Train and score the recipe under ``root`` -> the loss curve, the
    mid-training mAPs, the held-out metrics, wall times and steps/s."""
    import torch

    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.train.trainer import Trainer

    rc = recipe_config(root, compute_dtype, eval_interval, seed)
    model = build_model(rc, seed=rc.train.seed, device=device)
    trainer = Trainer(rc, model, device=device)
    t0 = time.perf_counter()
    trainer.train()
    if device != "cpu":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = Evaluator(model, rc, device=device).score()
    score_s = time.perf_counter() - t0
    return {
        "compute_dtype": compute_dtype, "epochs": trainer.epoch, "steps": trainer.updates,
        "loss": trainer.loss_history,
        "mAP_at_epoch": {r["epoch"]: r["mAP"] for r in trainer.metrics_history if "mAP" in r},
        "metrics": metrics, "train_s": train_s, "score_s": score_s,
        "steps_per_s": trainer.updates / train_s,
    }


def floor_failures(result: dict) -> list[str]:
    """The floors ``result`` misses (empty when it meets them all)."""
    losses, m = result["loss"], result["metrics"]
    out = []
    if len(losses) != EPOCHS or not np.isfinite(losses).all():
        out.append(f"expected {EPOCHS} finite epoch losses, got {losses}")
    elif not np.mean(losses[-4:]) < LOSS_RATIO * np.mean(losses[:4]):
        out.append(f"last-4 loss {np.mean(losses[-4:]):.4f} not under {LOSS_RATIO} x first-4 "
                   f"{np.mean(losses[:4]):.4f}")
    if m is None:
        return out + ["no predictions on the held-out pages"]
    if not m["mAP"] >= FLOOR_MAP:
        out.append(f"mAP {m['mAP']:.4f} < {FLOOR_MAP}")
    if not m["AP50"] >= FLOOR_AP50:
        out.append(f"AP50 {m['AP50']:.4f} < {FLOOR_AP50}")
    out += [f"AP50-{c} {m[f'AP50-{c}']:.4f} < {FLOOR_CLASS_AP50}" for c in FLOOR_CLASSES
            if not m[f"AP50-{c}"] >= FLOOR_CLASS_AP50]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--eval-interval", type=int, default=16)
    ap.add_argument("--out", default=None, help="keep the run's files here (default: a temp dir)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        os.makedirs(root, exist_ok=True)
        result = run_recipe(root, args.dtype, args.device, args.eval_interval)
    failures = floor_failures(result)
    print(json.dumps({**result, "floor_failures": failures}))
    if failures:
        raise SystemExit(f"convergence: {failures}")


if __name__ == "__main__":
    main()
