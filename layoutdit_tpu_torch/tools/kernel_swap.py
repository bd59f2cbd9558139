"""Which kernel, if any, costs the card's recipe its ``table`` AP?

A diagnosis tool. It runs the flagship recipe (``tools/convergence.py``,
``run_recipe``) on the card in bf16 over ``train.seed`` 0, 1 and 2, in
three arms:

  * ``kernels``: the path as it is, every kernel launched;
  * ``plain_short``: the short-attention pair (kernel-table rows 1-2)
    replaced by ``short_attention_plain`` / ``short_attention_bwd_plain``
    on the CUDA tensors (fp32 P and dS);
  * ``plain_roi``: the RoIAlign pair (rows 7-8) replaced by
    ``roi_align_plain`` / ``roi_align_bwd_plain``.

The swap is a patch of the wrappers' module names inside this tool only,
undone after each run; the wrappers themselves still refuse a CUDA
tensor on their plain path. Each run prints its arm, the swapped
wrappers' launch counts (0 when swapped), the held-out mAP, AP50 and
per-class AP50. The last line is one JSON object with every run and two
verdicts on ``table`` AP50:

  * ``unpaired``: an arm's kernels are at fault when the ``kernels``
    arm's mean is below that arm's by more than the larger max - min
    spread of the two;
  * ``paired``: the per-seed differences (the plain arm's run minus the
    kernels' run at the same seed); the kernels are at fault when their
    mean exceeds ``T_CRIT`` times its standard error (a two-sided paired
    t test at 5%, for the seeds run).

    python -m layoutdit_tpu_torch.tools.kernel_swap [--seeds 0 1 2]
        [--arms kernels plain_short plain_roi]
    python -m layoutdit_tpu_torch.tools.kernel_swap --from LOG [LOG ...]

``--from`` runs nothing: it gives the verdicts over the runs of earlier
calls, read from the last line of each log.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import tempfile

import numpy as np
import torch

from layoutdit_tpu_torch.ops import roi_align as roi_mod
from layoutdit_tpu_torch.ops import short_attention as short_mod
from layoutdit_tpu_torch.tools import convergence

CLASSES = ("text", "title", "list", "table", "figure")
ARMS = ("kernels", "plain_short", "plain_roi")
# two-sided 5% critical values of Student's t by degrees of freedom
T_CRIT = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447, 7: 2.365, 8: 2.306,
          9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179, 13: 2.160, 14: 2.145, 15: 2.131}


def _plain_short_bwd(q, k, v, o, do, scale=None, out=None):
    grads = short_mod.short_attention_bwd_plain(q, k, v, o, do, scale)
    if out is None:
        return grads
    for dst, src in zip(out, grads):
        dst.copy_(src)
    return out


def _plain_roi_bwd(dout, rois, levels, features, spatial_scales, output_size=7,
                   sampling_ratio=2):
    return roi_mod.roi_align_bwd_plain(dout, rois, levels, features, spatial_scales,
                                       output_size, sampling_ratio)


@contextlib.contextmanager
def swapped(arm: str):
    """Within the block, the arm's kernel wrappers are their plain versions
    as the autograd ``Function``s look them up (module globals)."""
    swaps = {
        "kernels": [],
        "plain_short": [(short_mod, "short_attention", short_mod.short_attention_plain),
                        (short_mod, "short_attention_bwd", _plain_short_bwd)],
        "plain_roi": [(roi_mod, "roi_align_fwd", roi_mod.roi_align_plain),
                      (roi_mod, "roi_align_bwd", _plain_roi_bwd)],
    }[arm]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _wrappers():
    return {"short_fwd": short_mod.short_attention, "short_bwd": short_mod.short_attention_bwd,
            "roi_fwd": roi_mod.roi_align_fwd, "roi_bwd": roi_mod.roi_align_bwd}


def run_arm(arm: str, seed: int) -> dict:
    """One recipe run of ``arm`` at ``train.seed = seed`` -> its metrics and
    the kernels' launch counts in the run."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as root, swapped(arm):
        result = convergence.run_recipe(root, "bfloat16", "cuda", eval_interval=16, seed=seed)
    m = result["metrics"]
    return {
        "arm": arm, "seed": seed, "mAP": m["mAP"], "AP50": m["AP50"],
        **{f"AP50-{c}": m[f"AP50-{c}"] for c in CLASSES},
        "launches": {k: fn.launches for k, fn in wrappers.items()},
        "train_s": result["train_s"],
        "floor_failures": convergence.floor_failures(result),
    }


def verdict(runs: list[dict]) -> dict:
    """Both rules over ``runs``, for each plain arm against ``kernels``:
    ``unpaired`` (the means, the larger spread) and ``paired`` (the
    per-seed differences, their mean, standard error and t)."""
    table: dict = {}
    for r in runs:
        table.setdefault(r["arm"], {})[r["seed"]] = r["AP50-table"]
    out = {}
    if "kernels" not in table:
        return out
    base = table["kernels"]
    for arm in ("plain_short", "plain_roi"):
        if arm not in table:
            continue
        other = table[arm]
        a, b = np.asarray(list(base.values())), np.asarray(list(other.values()))
        spread = max(np.ptp(a), np.ptp(b))
        diffs = np.asarray([other[s] - base[s] for s in sorted(base) if s in other])
        paired = {"seeds": len(diffs), "diffs": diffs.tolist(),
                  "plain_ahead": int((diffs > 0).sum())}
        if len(diffs) >= 2:
            se = float(diffs.std(ddof=1) / np.sqrt(len(diffs)))
            t = float(diffs.mean() / se) if se > 0 else float("inf") * np.sign(diffs.mean())
            paired.update(mean=float(diffs.mean()), se=se, t=t,
                          t_crit=T_CRIT[len(diffs) - 1],
                          kernels_at_fault=bool(t > T_CRIT[len(diffs) - 1]))
        out[arm] = {"unpaired": {"kernels_mean": float(a.mean()), "plain_mean": float(b.mean()),
                                 "spread": float(spread),
                                 "kernels_at_fault": bool(b.mean() - a.mean() > spread)},
                    "paired": paired}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    ap.add_argument("--from", dest="logs", nargs="+", metavar="LOG",
                    help="give the verdicts over the runs in these logs; run nothing")
    args = ap.parse_args()
    if args.logs:
        runs = []
        for log in args.logs:
            with open(log) as f:
                runs += json.loads(f.read().strip().splitlines()[-1])["runs"]
        print(json.dumps({"runs": runs, "verdict": verdict(runs)}))
        return
    if not torch.cuda.is_available():
        raise SystemExit("kernel_swap: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    runs = []
    for seed in args.seeds:
        for arm in args.arms:
            print(f"arm {arm}, train.seed {seed}", flush=True)
            runs.append(run_arm(arm, seed))
            print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs, "verdict": verdict(runs)}))


if __name__ == "__main__":
    main()
