"""Export a detector to a self-contained serving artifact (port of
``layoutdit_tpu/tools/export_model.py``).

    LAYOUTDIT_CONFIG=cfg.json python -m layoutdit_tpu_torch.tools.export_model \\
        --out /path/to/artifact [--checkpoint ckpt.pt|ckpt.msgpack] \\
        [--sizes 224,1024] [--batch-size 8] [--device cuda|cpu] [--int8]

The artifact (``export.py``: one ``torch.export`` program per bucket and
the flat weights) runs with torch, numpy and ``layoutdit_tpu_torch.ops``
alone, on the device it was exported for (``--device``, "cuda" by
default, plays the part of the JAX tool's ``--platforms``). Without
``--checkpoint`` the config's model is random, drawn from its
``train.seed``. ``--int8`` quantizes the encoder (``ops/quant.py``, LoRA
adapters merged first) before the trace: the artifact holds the int8
codes and runs the W8A8 products; the serving box does no quantization.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Export a detector to a serving artifact")
    ap.add_argument("--out", required=True, help="artifact directory (local or a URL)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint to export (.pt or a JAX .msgpack); default: the "
                         "config's model drawn from train.seed")
    ap.add_argument("--sizes", default="224", help="comma-separated serving bucket sizes")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the programs are traced and will run: cuda (default) or cpu")
    ap.add_argument("--int8", action="store_true",
                    help="int8 W8A8 encoder (ops/quant.py), quantized before the trace")
    args = ap.parse_args(argv)

    from layoutdit_tpu_torch.config import get_run_config
    from layoutdit_tpu_torch.export import export_detector
    from layoutdit_tpu_torch.log import get_logger
    from layoutdit_tpu_torch.models.lora import merge_lora_detector
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.ops.quant import quantize_detector_params

    logger = get_logger(__name__)
    config = get_run_config()
    model = build_model(config, seed=config.train.seed, device=args.device,
                        warm_start=not args.checkpoint)
    if args.checkpoint:
        model.restore_checkpoint(args.checkpoint)
    params = model.params
    if args.int8:
        params = quantize_detector_params(merge_lora_detector(params, model.cfg.backbone.vit))
    manifest = export_detector(
        params, model.cfg, args.out, image_sizes=[int(s) for s in args.sizes.split(",")],
        batch_size=args.batch_size, device=args.device,
    )
    logger.info("exported %s -> %s", {k: v for k, v in manifest.items() if k != "leaf_dtypes"},
                args.out)
    return manifest


if __name__ == "__main__":
    main()
