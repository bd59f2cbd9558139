"""LoRA against a full fine-tune from the same pretrained weights: held-out
quality and cost (the port's counterpart of ``scripts/lora_quality.py``
and of ``tests/test_lora.py::test_lora_r8_quality_floor_vs_full_ft``).

    python -m layoutdit_tpu_torch.tools.lora_quality [--device cuda|cpu] \\
        [--dtype bfloat16|float32]

  1. "pretrain": the tiny detector trained on 128 synthetic pages drawn
     with seed 42 (the stand-in for a pretrained model);
  2. fine-tune on another 128-page split (seed 0), both from the same
     pretrained weights: the full fine-tune, and LoRA r8 (adapters on q
     and v, the encoder frozen; the adapters' fresh init leaves the
     pretrained forward as it is);
  3. score each on the held-out 32-page split (seed 777).

Each run reports held-out mAP and AP50, trainable parameters, the
optimizer state's bytes, wall time and steps/s; the floors are JAX's test's
(pretrain mAP > 0.3, full fine-tune mAP > 0.45, LoRA r8 >= 0.85 x the full
fine-tune's mAP). The recipe's settings are JAX's (``_cfg``: batch 8,
cosine from 2e-4 with 48 warmup steps).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

PRETRAIN_PAGES, TRAIN_PAGES, VAL_PAGES = 128, 128, 32
EPOCHS = 24
# JAX's floors (tests/test_lora.py:415-444)
PRETRAIN_FLOOR, FULL_FLOOR, R8_SHARE = 0.3, 0.45, 0.85


def _cfg(root: str, split: str, epochs: int, compute_dtype: str, lora_rank: int = 0):
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.tools.make_fixture import write_fixture_config

    path = write_fixture_config(root, split=split, epochs=epochs, batch_size=8, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_input"] = "val"
    raw["local_mode"] = False  # train on the split, not on eval_input
    raw["run_name"] = f"{split}_r{lora_rank}"
    raw["train_config"].update(checkpoint_interval=epochs, lr_schedule="cosine",
                               learning_rate=2e-4, warmup_steps=48, tensorboard=False)
    raw["precision"] = {"compute_dtype": compute_dtype}
    raw["detection_model_config"]["lora_rank"] = lora_rank
    out = os.path.join(root, f"{split}_r{lora_rank}.json")
    with open(out, "w") as f:
        json.dump(raw, f, indent=2)
    return load_run_config(out)


def _train(rc, device: str, pretrained: dict | None = None) -> tuple[dict, dict]:
    """Train ``rc``'s model (from ``pretrained`` where a leaf's path and
    shape match: the adapters keep their fresh init) and score it."""
    import torch

    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.models.lora import num_trainable
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_paths
    from layoutdit_tpu_torch.train.trainer import Trainer

    model = build_model(rc, seed=rc.train.seed, device=device, warm_start=False)
    if pretrained is not None:
        with torch.no_grad():
            for path, t in zip(tree_paths(model.params), tree_leaves(model.params)):
                src = pretrained.get(path)
                if src is not None and src.shape == t.shape:
                    t.copy_(src)
    trainer = Trainer(rc, model, device=device)
    t0 = time.perf_counter()
    trainer.train()
    if device != "cpu":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    state = trainer.opt_state
    opt_bytes = sum(t.numel() * t.element_size() for key in ("mu", "nu") for t in state[key])
    metrics = Evaluator(model, rc, device=device).score()
    n_train = (num_trainable(model.params)[0] if rc.model.lora_rank
               else sum(t.numel() for t in tree_leaves(model.params)))
    params = {p: t.detach().clone() for p, t in zip(tree_paths(model.params),
                                                     tree_leaves(model.params))}
    return {"lora_rank": rc.model.lora_rank, "mAP": metrics["mAP"], "AP50": metrics["AP50"],
            "trainable_params": int(n_train), "opt_state_bytes": int(opt_bytes),
            "train_s": train_s, "steps": trainer.updates,
            "steps_per_s": trainer.updates / train_s, "loss": trainer.loss_history}, params


def run(root: str, device: str = "cuda", compute_dtype: str = "bfloat16",
        epochs: int = EPOCHS) -> dict:
    """The recipe under ``root`` -> {"pretrain", "full_ft", "lora_r8"}."""
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture

    make_fixture(root, n_images=PRETRAIN_PAGES, split="pretrain", seed=42)
    make_fixture(root, n_images=TRAIN_PAGES, split="samples", seed=0)
    make_fixture(root, n_images=VAL_PAGES, split="val", seed=777)
    out = {}
    out["pretrain"], pretrained = _train(_cfg(root, "pretrain", epochs, compute_dtype), device)
    out["full_ft"], _ = _train(_cfg(root, "samples", epochs, compute_dtype), device, pretrained)
    out["lora_r8"], _ = _train(_cfg(root, "samples", epochs, compute_dtype, 8), device,
                               pretrained)
    return out


def floor_failures(result: dict) -> list[str]:
    """JAX's floors that ``result`` misses (none: an empty list)."""
    fails = []
    if not result["pretrain"]["mAP"] > PRETRAIN_FLOOR:
        fails.append(f"pretrain mAP {result['pretrain']['mAP']:.4f} <= {PRETRAIN_FLOOR}")
    full = result["full_ft"]["mAP"]
    if not full > FULL_FLOOR:
        fails.append(f"full fine-tune mAP {full:.4f} <= {FULL_FLOOR}")
    if not result["lora_r8"]["mAP"] >= R8_SHARE * full:
        fails.append(f"LoRA r8 mAP {result['lora_r8']['mAP']:.4f} < {R8_SHARE} x {full:.4f}")
    return fails


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        result = run(tmp, args.device, args.dtype)
    result["floor_failures"] = floor_failures(result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
