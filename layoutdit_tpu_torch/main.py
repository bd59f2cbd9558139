"""The port's command line (port of ``layoutdit_tpu/main.py``): config,
then model, then train, then score, then visualize.

    LAYOUTDIT_CONFIG=cfg.json python -m layoutdit_tpu_torch.main [--local_mode]
        [--resume PATH|auto] [--skip-train] [--skip-eval] [--device cuda|cpu]

  * ``LAYOUTDIT_CONFIG`` names a JSON config (the JAX package's
    layout), local or at a ``scheme://`` URL; without it the defaults
    hold. The data and the artifact base (``eval_base_path``) may be
    URLs too (``utils/paths.py``; fsspec is imported only for them).
  * ``--local_mode`` trains on the eval split, as in the JAX package.
  * ``--resume`` applies when training: a checkpoint path (the port's
    ``.pt`` or the JAX trainer's ``.msgpack``, local or a URL), or
    ``auto`` for the newest one of the run (a fresh start when there is
    none).
  * ``--skip-train`` scores the freshly built model; ``--skip-eval``
    trains only.
  * ``--device``: "cuda" (the default) or "cpu".

The JAX flag ``--read_config`` (a probe of the fixed remote config
``gs://layoutdit/layout_dit_config.json``) is refused: name the config
in ``LAYOUTDIT_CONFIG`` instead.
"""

from __future__ import annotations

import argparse
import dataclasses

from layoutdit_tpu_torch.config import get_run_config
from layoutdit_tpu_torch.eval.evaluator import Evaluator
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.train.trainer import Trainer

logger = get_logger(__name__)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="LayoutDit training and evaluation (PyTorch)")
    parser.add_argument("--local_mode", action="store_true",
                        help="Train on the eval split (the local samples)")
    parser.add_argument("--read_config", action="store_true",
                        help="Not supported by the port: set LAYOUTDIT_CONFIG to the config file")
    parser.add_argument("--resume", default=None,
                        help="Checkpoint to resume from (.pt, or a JAX .msgpack; local or a "
                             "URL), or 'auto' for the newest checkpoint of the run (a fresh "
                             "start when there is none)")
    parser.add_argument("--skip-train", action="store_true", help="Evaluate only")
    parser.add_argument("--skip-eval", action="store_true", help="Train only")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.read_config:
        parser.error("--read_config: the port probes no fixed remote config; point "
                     "LAYOUTDIT_CONFIG at the JSON file (local or a URL) instead")

    config = get_run_config()
    if args.local_mode:
        config = dataclasses.replace(config, local_mode=True)
    logger.info("Starting LayoutDit training (args=%s)", vars(args))

    model = build_model(config, seed=config.train.seed, device=args.device)
    logger.info("Initialized model (%.1fM params)", model.num_params() / 1e6)

    if not args.skip_train:
        trainer = Trainer(config, model, device=args.device)
        if args.resume:
            trainer.resume(args.resume)
        trainer.train()  # model.params is the trained tree
        if trainer.ema_params is not None:
            # the raw weights stay in the checkpoints' params slot
            logger.info("Evaluating with EMA parameters (decay=%s)", config.train.ema_decay)
            model.params = trainer.ema_params

    if not args.skip_eval:
        evaluator = Evaluator(model, config, device=args.device)
        metrics = evaluator.score()
        if metrics is not None:
            logger.info("Final metrics: %s", metrics)
        evaluator.visualize_preds()
        evaluator.visualize_gt()


if __name__ == "__main__":
    main()
