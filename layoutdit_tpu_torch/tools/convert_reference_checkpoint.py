"""Convert a reference full-detector torch checkpoint to a ``.msgpack``
checkpoint (port of ``layoutdit_tpu/tools/convert_reference_checkpoint.py``).

    python -m layoutdit_tpu_torch.tools.convert_reference_checkpoint \\
        --torch run/model_checkpoints/epoch_20_cpu.pth --out converted.msgpack \\
        [--config partial_cfg.json]

The reference saves ``torch.save(LayoutDetectionModel.state_dict())``:
torchvision's FasterRCNN over the DiT + FPN backbone. Every weight
converts (encoder, FPN, RPN head, box head, predictor,
``models/weights_io.py::detector_state_dict_to_params``) into the target
config's model, checked shape for shape; a cascade config is refused. The
output is the JAX package's params-only ``.msgpack`` (``extra={"source"}``):
it restores in either package as parameters only, with fresh optimizer
state (``--resume`` / ``restore_checkpoint``), and serves directly.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Convert a reference torch detector checkpoint")
    parser.add_argument("--torch", required=True, dest="torch_path",
                        help="reference .pth (local or a URL)")
    parser.add_argument("--out", required=True, help="output .msgpack checkpoint path")
    parser.add_argument("--config", default=None,
                        help="config JSON of the target model (default: the library defaults)")
    args = parser.parse_args(argv)
    if args.config:
        os.environ["LAYOUTDIT_CONFIG"] = args.config

    import torch

    from layoutdit_tpu_torch.config import get_run_config
    from layoutdit_tpu_torch.log import get_logger
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig
    from layoutdit_tpu_torch.models.weights_io import detector_state_dict_to_params
    from layoutdit_tpu_torch.train.checkpoint import save_as_jax
    from layoutdit_tpu_torch.utils.paths import open_path

    logger = get_logger(__name__)
    with open_path(args.torch_path, "rb") as f:
        # a state_dict is plain tensors: never run an external file's pickle code
        state_dict = torch.load(f, map_location="cpu", weights_only=True)
    logger.info("Loaded %d torch tensors from %s", len(state_dict), args.torch_path)
    config = get_run_config()
    cfg = DetectorConfig.from_model_config(config.model, precision_dtype=config.compute_dtype)
    params = detector_state_dict_to_params(state_dict, cfg)
    out = save_as_jax(args.out, params, None, 0, {"source": args.torch_path}, clip=False)
    logger.info("Wrote converted checkpoint to %s", out)
    return out


if __name__ == "__main__":
    main()
