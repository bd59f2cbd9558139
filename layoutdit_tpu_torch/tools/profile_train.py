"""Profile the port's train step on the GPU, stage by stage.

Builds the trainer of a config (the port's default, dit-base at 224 px
and batch 16, unless ``--config`` names a JSON file) with random weights
from ``--seed`` over a temporary fixture of synthetic pages, runs
``--warmup`` steps on one batch, then one more under ``torch.profiler``
and prints, from that step's chrome trace: its wall time, the device's
busy time (union of kernel and copy intervals) and idle share, host time
and device work launched in each stage (the ``record_function`` ranges
``forward``, ``loss``, ``backward``, ``optimizer``; inside the forward
``backbone`` and ``rpn`` (a single-stage or DETR model's ``head``);
inside the loss DETR's ``matcher``, its cost and assignment; inside the
backward ``rel_pos_table_grad``,
the relative-position tables' gradient, summed over its calls), the
kernels that
take the most device time, and the NMS host syncs of the step. The last
line is one JSON object with the same numbers.

    python -m layoutdit_tpu_torch.tools.profile_train \\
        [--config cfg.json] [--trace-dir build/traces]

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from layoutdit_tpu_torch.config import RunConfig, TrainingConfig, run_config_from_dict
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorConfig,
    DetectorModel,
    init_detector,
)
from layoutdit_tpu_torch.ops import nms
from layoutdit_tpu_torch.tools.make_fixture import make_fixture
from layoutdit_tpu_torch.tools.profile_serving import summarize_trace
from layoutdit_tpu_torch.train.trainer import Trainer

STAGES = ("forward", "backbone", "rpn", "head", "mask_head", "loss", "matcher", "backward",
          "optimizer", "rel_pos_table_grad")
REPO = Path(__file__).resolve().parents[2]


def profile_step(trainer: Trainer, warmup: int, trace: Path, batch=None) -> dict:
    """``warmup`` steps, then one traced, on ``batch`` (default: the
    loader's first)."""
    if batch is None:
        it = iter(trainer.dataloader)
        batch = next(it)
        it.close()
    for _ in range(warmup):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    nms.nms_mask.host_syncs = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        out = summarize_trace(json.load(f), STAGES)
    return {"images": int(batch.image_valid.sum()), "wall_ms": wall_ms,
            "nms_host_syncs": nms.nms_mask.host_syncs, **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="config JSON (the JAX package's layout); default: the port's defaults")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--trace-dir", default=str(REPO / "build" / "traces"),
                    help="the step's chrome trace is written here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    base = run_config_from_dict(raw)
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        tc = {**vars(base.train), "train_base_path": tmp, "train_input": "samples"}
        rc = RunConfig(model=base.model, data=base.data, train=TrainingConfig(**tc),
                       compute_dtype=base.compute_dtype, run_name="profile_train",
                       eval_base_path=tmp)
        make_fixture(tmp, n_images=rc.data.batch_size, split="samples", seed=args.seed,
                     image_size=rc.model.image_size)
        cfg = DetectorConfig.from_model_config(rc.model, precision_dtype=rc.compute_dtype)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        trainer = Trainer(rc, DetectorModel(init_detector(cfg, gen, device="cuda"), cfg))
        r = profile_step(trainer, args.warmup, trace_dir / "train_step.json")
    out = {"device": torch.cuda.get_device_name(0), "image_size": cfg.image_size,
           "batch": rc.data.batch_size, "compute_dtype": rc.compute_dtype, **r}
    print(f"train step, {r['images']} images at {cfg.image_size} px: wall {r['wall_ms']:.3f} ms, "
          f"traced span {r['span_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
          f"idle share {r['device_idle_share']:.3f}, NMS host syncs {r['nms_host_syncs']}")
    for name, st in r["stages"].items():
        print(f"  stage {name}: host {st.get('host_ms', 0):.3f} ms, device work launched "
              f"{st.get('device_ms', 0):.3f} ms, {st.get('calls', 0)} call(s)")
    for k in r["top_kernels"]:
        print(f"  kernel {k['device_ms']:9.3f} ms  x{k['calls']:<5d} {k['name']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
