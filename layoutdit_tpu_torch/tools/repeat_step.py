"""Is the port's train step repeatable on the GPU, bit for bit?

Builds a config's detector (the port's default, dit-base at 224 px and
batch 16, unless ``--config`` names a JSON file) with random weights
from ``--seed``, takes one batch of synthetic pages, and computes the
gradient of the summed detector losses ``--runs`` times from the same
parameters, batch and sampler-generator state. It prints the losses of
each run, and every gradient leaf that differs from the first run's, in
backward order (the last parameter first), with its largest difference;
the first of them names the layer whose backward varies. Then one more
run under ``torch.use_deterministic_algorithms(True, warn_only=True)``
lists the nondeterministic torch kernels the step reaches (diagnosis
only: the flag is set back before returning). With
``--compare-interpolate`` the runs are repeated with the backbone's
pyramid resize done by ``F.interpolate`` (whose bilinear backward sums
with atomics) in place of the port's two-matmul form, and both forms of
that resize are timed alone, forward and backward, at the step's
shapes. The last line is one JSON object with the same findings.

    python -m layoutdit_tpu_torch.tools.repeat_step [--config cfg.json]

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import warnings

import torch

from layoutdit_tpu_torch.config import RunConfig, run_config_from_dict
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionLoader
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorConfig,
    detector_loss,
    draw_priorities,
    init_detector,
)
from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_paths
from layoutdit_tpu_torch.models import backbone
from layoutdit_tpu_torch.ops import _build
from layoutdit_tpu_torch.ops.interpolate import resize_bilinear, resize_bilinear_matmul
from layoutdit_tpu_torch.tools.make_fixture import make_fixture


def step_gradients(params: dict, batch, cfg: DetectorConfig, seed: int):
    """(losses as floats, gradient leaves) of one step's summed losses,
    with sampler priorities from a generator seeded ``seed``."""
    leaves = tree_leaves(params)
    gen = torch.Generator(device=batch.images.device).manual_seed(seed)
    b, g = batch.gt_labels.shape
    losses = detector_loss(params, batch.images, batch.gt_boxes, batch.gt_labels,
                           batch.gt_valid, cfg, draw_priorities(cfg, b, g, gen))
    grads = torch.autograd.grad(sum(losses.values()), leaves)
    return {k: float(v.detach()) for k, v in losses.items()}, [t.detach() for t in grads]


def compare_runs(params: dict, batch, cfg: DetectorConfig, runs: int, seed: int) -> dict:
    """``runs`` gradients from the same state against the first: the
    differing leaves in backward order, with their max |difference|."""
    names = tree_paths(params)
    ref_losses, ref = step_gradients(params, batch, cfg, seed)
    times, differing, loss_runs = [], {}, [ref_losses]
    for _ in range(runs - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, grads = step_gradients(params, batch, cfg, seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        loss_runs.append(losses)
        for name, a, b in zip(names, ref, grads):
            if not torch.equal(a, b):
                d = float((a.float() - b.float()).abs().max())
                rel = float((a.float() - b.float()).norm() / a.float().norm().clamp(min=1e-30))
                prev = differing.get(name, (0.0, 0.0))
                differing[name] = (max(prev[0], d), max(prev[1], rel))
    order = [n for n in reversed(names) if n in differing]
    return {
        "losses": loss_runs, "losses_equal": all(r == ref_losses for r in loss_runs),
        "leaves": len(names), "differing_leaves": len(order),
        "backward_order": [{"leaf": n, "max_abs_diff": differing[n][0],
                            "rel_frobenius": differing[n][1]} for n in order],
        "grad_ms": times,
    }


def nondeterministic_alerts(params: dict, batch, cfg: DetectorConfig, seed: int) -> list[str]:
    """The warnings torch raises for nondeterministic kernels in one step."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step_gradients(params, batch, cfg, seed)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
    return sorted({str(w.message).splitlines()[0] for w in caught})


def resize_cost(cfg: DetectorConfig, batch: int, iters: int = 20) -> dict:
    """ms of the pyramid's 4x and 2x resizes, forward and backward, on
    bf16 channels-last laterals of the step's shape: ``F.interpolate``
    against the two-matmul form (CUDA events over ``iters`` runs)."""
    g = cfg.image_size // cfg.backbone.vit.patch_size
    c = cfg.backbone.fpn_out_channels
    x = torch.randn((batch, c, g, g), device="cuda", dtype=torch.bfloat16)
    x = x.to(memory_format=torch.channels_last).requires_grad_(True)
    out = {}
    for name, fn in (("interpolate", resize_bilinear), ("matmul", resize_bilinear_matmul)):
        def run():
            ys = [fn(x, int(g * s), int(g * s)) for s in cfg.backbone.scales if s > 1]
            torch.autograd.grad(sum(y.float().sum() for y in ys), x)
        run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / iters
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="config JSON (the JAX package's layout); default: the port's defaults")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--compare-interpolate", action="store_true",
                    help="repeat the runs with F.interpolate as the pyramid's resize")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repeat_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    rc: RunConfig = run_config_from_dict(raw)
    cfg = DetectorConfig.from_model_config(rc.model, precision_dtype=rc.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_detector(cfg, gen, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    with tempfile.TemporaryDirectory() as tmp:
        make_fixture(tmp, n_images=rc.data.batch_size, split="samples", seed=args.seed,
                     image_size=rc.model.image_size)
        loader = DetectionLoader(
            PubLayNetDataset(f"{tmp}/samples/", f"{tmp}/samples.json"),
            batch_size=rc.data.batch_size, shuffle=False, image_size=cfg.image_size,
            max_gt=rc.data.max_gt_boxes, device="cuda")
        batch = next(iter(loader))
        loader.close()

    out = {"device": torch.cuda.get_device_name(0), "image_size": cfg.image_size,
           "batch": rc.data.batch_size, "compute_dtype": rc.compute_dtype}
    step_gradients(params, batch, cfg, args.seed)  # warm-up
    out["default"] = compare_runs(params, batch, cfg, args.runs, args.seed)
    out["alerts"] = nondeterministic_alerts(params, batch, cfg, args.seed)
    if args.compare_interpolate:
        form = backbone.resize_bilinear_matmul
        backbone.resize_bilinear_matmul = resize_bilinear  # F.interpolate, for the comparison
        try:
            out["interpolate"] = compare_runs(params, batch, cfg, args.runs, args.seed)
        finally:
            backbone.resize_bilinear_matmul = form
        out["resize_ms"] = resize_cost(cfg, rc.data.batch_size)
        print(f"pyramid resizes alone, forward + backward: {out['resize_ms']}")
    for key in ("default", "interpolate"):
        if key not in out:
            continue
        r = out[key]
        print(f"{key}: {r['differing_leaves']} of {r['leaves']} gradient leaves differ over "
              f"{args.runs} runs; losses equal: {r['losses_equal']}; gradient ms {r['grad_ms']}")
        for d in r["backward_order"][:12]:
            print(f"  {d['leaf']}: max |diff| {d['max_abs_diff']:.6g}, relative "
                  f"{d['rel_frobenius']:.6g}")
    print("nondeterministic alerts: " + ("; ".join(out["alerts"]) or "none"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
