"""Export a detector to a self-contained serving artifact (port of
``layoutdit_tpu/tools/export_model.py``).

    LAYOUTDIT_CONFIG=cfg.json python -m layoutdit_tpu_torch.tools.export_model \\
        --out /path/to/artifact [--checkpoint ckpt.pt|ckpt.msgpack] \\
        [--sizes 224,1024] [--batch-size 8] [--device cuda|cpu]

The artifact (``export.py``: one ``torch.export`` program per bucket and
the flat weights) runs with torch, numpy and ``layoutdit_tpu_torch.ops``
alone, on the device it was exported for (``--device``, "cuda" by
default, plays the part of the JAX tool's ``--platforms``). Without
``--checkpoint`` the config's model is random, drawn from its
``train.seed``. ``--int8`` is refused: it waits for ``ops/quant.py``
(ROADMAP queue 1 item 6).
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
                    help="refused: waits for ops/quant.py (ROADMAP queue 1 item 6)")
    args = ap.parse_args(argv)

    from layoutdit_tpu_torch.config import get_run_config
    from layoutdit_tpu_torch.export import export_detector
    from layoutdit_tpu_torch.log import get_logger
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.tools.predict import INT8_REFUSED

    if args.int8:
        raise SystemExit(INT8_REFUSED)
    logger = get_logger(__name__)
    config = get_run_config()
    model = build_model(config, seed=config.train.seed, device=args.device)
    if args.checkpoint:
        model.restore_checkpoint(args.checkpoint)
    manifest = export_detector(
        model.params, model.cfg, args.out, image_sizes=[int(s) for s in args.sizes.split(",")],
        batch_size=args.batch_size, device=args.device,
    )
    logger.info("exported %s -> %s", {k: v for k, v in manifest.items() if k != "leaf_dtypes"},
                args.out)
    return manifest


if __name__ == "__main__":
    main()
