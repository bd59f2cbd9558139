"""Fold trained LoRA adapters into the base weights for serving and
export (port of ``layoutdit_tpu/tools/merge_lora.py``, its CLI and
output).

    LAYOUTDIT_CONFIG=cfg.json python -m layoutdit_tpu_torch.tools.merge_lora \\
        --checkpoint ckpt.pt|ckpt.msgpack --out merged.msgpack [--device cuda|cpu]

Loads a checkpoint trained with ``lora_rank`` > 0 into the config's
model on ``--device`` ("cuda", the default, or "cpu"), folds every
adapter into its weight there (W += alpha/r A B, ``models/lora.py``) and
writes a params-only checkpoint in the JAX package's ``.msgpack`` format,
rank-0 layout, ``extra={"merged_lora": true}``: it loads under a config with ``lora_rank: 0``, in either
package, serves with no adapter cost, and is the form ``--int8``
quantizes.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="Fold LoRA adapters into the base weights")
    ap.add_argument("--checkpoint", required=True,
                    help="fine-tuned checkpoint (lora_rank > 0): the port's .pt or a JAX "
                         ".msgpack")
    ap.add_argument("--out", required=True, help="output .msgpack path for the merged params")
    ap.add_argument("--device", default="cuda",
                    help="where the model is loaded and merged: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.out.endswith(".msgpack"):
        ap.error("--out: the merged checkpoint is written in the .msgpack format")

    from layoutdit_tpu_torch.config import get_run_config
    from layoutdit_tpu_torch.log import get_logger
    from layoutdit_tpu_torch.models.lora import has_lora, merge_lora_detector
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.train.checkpoint import save_as_jax

    logger = get_logger(__name__)
    cfg = get_run_config()
    if cfg.model.lora_rank <= 0:
        raise SystemExit("config has lora_rank=0 — the checkpoint template would not carry "
                         "adapters; point LAYOUTDIT_CONFIG at the training config")
    model = build_model(cfg, device=args.device, warm_start=False)
    model.restore_checkpoint(args.checkpoint)
    if not has_lora(model.params["backbone"]["vit"]):
        raise SystemExit(f"{args.checkpoint} carries no LoRA adapters")
    merged = merge_lora_detector(model.params, model.cfg.backbone.vit)
    out = save_as_jax(args.out, merged, None, 0, {"merged_lora": True}, clip=False)
    logger.info("merged LoRA checkpoint written to %s (load with lora_rank=0)", out)
    return out


if __name__ == "__main__":
    main()
