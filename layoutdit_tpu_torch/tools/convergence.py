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
on the CPU; ``bfloat16`` on the card, where float32 serves (the forward
kernels have float32 forms) but does not train (the backward kernels
take bf16 only: the trainer refuses a float32 model on a CUDA device
whose backward reaches one, as every DiT recipe's does).

``--family`` picks the detector as ``scripts/convergence_matrix.py``
does: ``faster_rcnn`` (the flagship), ``cascade`` (three stages at IoU
0.5 / 0.6 / 0.7), ``mask`` (the Mask R-CNN branch, which adds the segm
metrics), the single-stage ``retinanet`` and ``fcos``, or ``detr`` and
``detr_shared`` (DETR at its defaults, the latter with one assignment
shared by every decoder layer's loss). JAX pins no floors for the two
modifiers; they are held to the flagship's held-out mAP and AP50 floors
(the mask family also on its segm mAP and AP50), and report the rest. The
single-stage families are held to JAX's own floors
(``tests/test_convergence.py::test_family_multiepoch_convergence``):
RetinaNet mAP >= 0.22, AP50 >= 0.45; FCOS mAP >= 0.55, AP50 >= 0.75;
both a last-4 loss under 0.6 x the first 4. DETR memorises 128 pages
(``docs/convergence.md``): its recipe is ``--n-train 1024 --epochs 100``,
held to the flagship's mAP and AP50 floors; ``detr_shared`` has none and
reports its numbers.

Usage: python -m layoutdit_tpu_torch.tools.convergence [--device cuda|cpu]
           [--dtype bfloat16|float32] [--eval-interval 16] [--out DIR]
           [--family faster_rcnn|cascade|mask|retinanet|fcos|detr|detr_shared]
           [--n-train 128] [--epochs 48]
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
# scripts/convergence_matrix.py's overrides: the two faster_rcnn
# modifiers and the single-stage families
FAMILY_KNOBS = {
    "faster_rcnn": {},
    "cascade": {"cascade_iou_threshs": [0.5, 0.6, 0.7]},
    "mask": {"with_mask": True},
    "retinanet": {"detector": "retinanet"},
    "fcos": {"detector": "fcos"},
    "detr": {"detector": "detr"},
    "detr_shared": {"detector": "detr", "detr_shared_matching": True},
}
# reported with no floor (JAX pins none and the port's bar is not set)
NO_FLOOR = ("detr_shared",)
# JAX's held-out (mAP, AP50) floors of the single-stage families and their
# loss ratio (tests/test_convergence.py:36-40, :55)
ONE_STAGE_FLOORS = {"retinanet": (0.22, 0.45), "fcos": (0.55, 0.75)}
ONE_STAGE_LOSS_RATIO = 0.6


def recipe_config(root: str, compute_dtype: str, eval_interval: int = 0, seed: int = 0,
                  family: str = "faster_rcnn", n_train: int = TRAIN_PAGES,
                  epochs: int = EPOCHS):
    """Write the recipe's pages and config under ``root`` -> its ``RunConfig``
    (``seed`` is ``train.seed``: the weights' and the samplers' seed; the
    pages stay those of seeds 0 and 777; ``family`` a key of
    ``FAMILY_KNOBS``; ``n_train`` pages trained on for ``epochs``)."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config

    make_fixture(root, n_images=n_train, split="samples", seed=0)
    make_fixture(root, n_images=VAL_PAGES, split="val", seed=777)
    path = write_fixture_config(root, split="samples", epochs=epochs, batch_size=BATCH,
                                tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_input"] = "val"
    # local_mode would train on the eval split: train on the samples
    raw["local_mode"] = False
    raw["train_config"].update(checkpoint_interval=epochs, lr_schedule="cosine",
                               learning_rate=2e-4, warmup_steps=48,
                               eval_interval=eval_interval, seed=seed)
    raw["precision"] = {"compute_dtype": compute_dtype}
    raw["detection_model_config"].update(FAMILY_KNOBS[family])
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)
    return load_run_config(path)


def run_recipe(root: str, compute_dtype: str, device: str = "cuda",
               eval_interval: int = 0, seed: int = 0, family: str = "faster_rcnn",
               n_train: int = TRAIN_PAGES, epochs: int = EPOCHS) -> dict:
    """Train and score the recipe under ``root`` -> the loss curve, the
    mid-training mAPs, the held-out metrics, wall times and steps/s."""
    import torch

    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.train.trainer import Trainer

    rc = recipe_config(root, compute_dtype, eval_interval, seed, family, n_train, epochs)
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
        "family": family, "compute_dtype": compute_dtype, "n_train": n_train,
        "epochs_asked": epochs, "epochs": trainer.epoch, "steps": trainer.updates,
        "loss": trainer.loss_history,
        "mAP_at_epoch": {r["epoch"]: r["mAP"] for r in trainer.metrics_history if "mAP" in r},
        "metrics": metrics, "train_s": train_s, "score_s": score_s,
        "steps_per_s": trainer.updates / train_s,
    }


def floor_failures(result: dict) -> list[str]:
    """The floors ``result`` misses (empty when it meets them all): the
    flagship's all of them; a modifier family's and DETR's the held-out mAP
    and AP50 (and for ``mask`` the segm mAP and AP50), with finite losses;
    a single-stage family's JAX floors and loss ratio; ``detr_shared``
    finite losses and predictions only."""
    losses, m = result["loss"], result["metrics"]
    family = result.get("family", "faster_rcnn")
    epochs = result.get("epochs_asked", EPOCHS)
    ratio = {"faster_rcnn": LOSS_RATIO}.get(
        family, ONE_STAGE_LOSS_RATIO if family in ONE_STAGE_FLOORS else None)
    out = []
    if len(losses) != epochs or not np.isfinite(losses).all():
        out.append(f"expected {epochs} finite epoch losses, got {losses}")
    elif ratio is not None and not np.mean(losses[-4:]) < ratio * np.mean(losses[:4]):
        out.append(f"last-4 loss {np.mean(losses[-4:]):.4f} not under {ratio} x first-4 "
                   f"{np.mean(losses[:4]):.4f}")
    if m is None:
        return out + ["no predictions on the held-out pages"]
    if family in NO_FLOOR:
        return out
    floor_map, floor_ap50 = ONE_STAGE_FLOORS.get(family, (FLOOR_MAP, FLOOR_AP50))
    if not m["mAP"] >= floor_map:
        out.append(f"mAP {m['mAP']:.4f} < {floor_map}")
    if not m["AP50"] >= floor_ap50:
        out.append(f"AP50 {m['AP50']:.4f} < {floor_ap50}")
    if family == "mask":
        for key, floor in (("segm_mAP", FLOOR_MAP), ("segm_AP50", FLOOR_AP50)):
            if not m.get(key, float("nan")) >= floor:
                out.append(f"{key} {m.get(key)} < {floor}")
    if family != "faster_rcnn":
        return out
    out += [f"AP50-{c} {m[f'AP50-{c}']:.4f} < {FLOOR_CLASS_AP50}" for c in FLOOR_CLASSES
            if not m[f"AP50-{c}"] >= FLOOR_CLASS_AP50]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--eval-interval", type=int, default=16)
    ap.add_argument("--out", default=None, help="keep the run's files here (default: a temp dir)")
    ap.add_argument("--family", default="faster_rcnn", choices=sorted(FAMILY_KNOBS))
    ap.add_argument("--n-train", type=int, default=TRAIN_PAGES, help="train-split pages")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        os.makedirs(root, exist_ok=True)
        result = run_recipe(root, args.dtype, args.device, args.eval_interval,
                            family=args.family, n_train=args.n_train, epochs=args.epochs)
    failures = floor_failures(result)
    print(json.dumps({**result, "floor_failures": failures}))
    if failures:
        raise SystemExit(f"convergence: {failures}")


if __name__ == "__main__":
    main()
