"""Print the port's effective run config as JSON (port of
``layoutdit_tpu/tools/show_config.py``).

Shows what a run would use: the defaults, merged with the JSON file that
``LAYOUTDIT_CONFIG`` names (``config.get_run_config``; there is no probe
of a default ``gs://`` location, as the port's loader has none), in the
JAX package's layout (``train_config``, ``data_loader_config``,
``detection_model_config``, ``precision``, ``eval_config``,
``run_name``, ``local_mode``), keys sorted.

    python -m layoutdit_tpu_torch.tools.show_config [--diff]

``--diff`` prints only the fields that differ from the defaults, as
dotted keys ("train_config.num_epochs").
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from layoutdit_tpu_torch.config import RunConfig, get_run_config


def run_config_as_dict(rc: RunConfig) -> dict:
    """``rc`` in the JAX config file's layout (tuples print as JSON lists)."""
    return {
        "train_config": dataclasses.asdict(rc.train),
        "data_loader_config": dataclasses.asdict(rc.data),
        "detection_model_config": dataclasses.asdict(rc.model),
        "precision": {"compute_dtype": rc.compute_dtype, "param_dtype": rc.param_dtype},
        "eval_config": {**dataclasses.asdict(rc.eval), "eval_input": rc.eval_input,
                        "eval_base_path": rc.eval_base_path},
        "run_name": rc.run_name,
        "local_mode": rc.local_mode,
    }


def flatten(d: dict, prefix: str = "") -> dict:
    """Nested sections -> dotted keys."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Show the effective config")
    parser.add_argument("--diff", action="store_true",
                        help="only the fields that differ from the defaults")
    args = parser.parse_args(argv)
    cfg = run_config_as_dict(get_run_config())
    if args.diff:
        defaults = flatten(run_config_as_dict(RunConfig()))
        cfg = {k: v for k, v in flatten(cfg).items() if defaults.get(k) != v}
    print(json.dumps(cfg, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
