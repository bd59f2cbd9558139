"""Profile the port's serving path on the GPU, stage by stage.

Builds the detector of a config at full width (random weights from
``--seed``), serves one batch-sized request per bucket to warm up, then
serves each bucket's request again under ``torch.profiler`` and prints,
per bucket, from the request's chrome trace: its wall time, the host
time before the first device work (page decode, H2D), the device's busy
time (union of kernel and copy intervals) and idle share, host time,
device span and device work launched of each detector stage
(``detector_predict``'s ``record_function`` ranges), the kernels that
take the most device time, and the NMS host syncs. The last line is one
JSON object with the same numbers.

    python -m layoutdit_tpu_torch.tools.profile_serving \\
        [--config configs/serving_1024.json] [--buckets 224 1024] \\
        [--trace-dir build/traces]

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from layoutdit_tpu_torch.config import load_config
from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorConfig,
    DetectorModel,
    init_detector,
)
from layoutdit_tpu_torch.ops import nms

STAGES = ("backbone", "rpn", "head", "roi_heads", "postprocess", "mask_head")
# kernels listed by device time: enough to reach the short-attention
# backward of a windowed train step, below the NMS, the copies and the GEMMs
TOP_KERNELS = 24
REPO = Path(__file__).resolve().parents[2]


def _pages(size: int, n: int, rng: np.random.Generator) -> list[np.ndarray]:
    """n uint8 pages of a portrait aspect that route to the ``size`` bucket."""
    h = int(size * 0.95)
    return [rng.integers(0, 256, (h - 2 * i, int(h * 0.77) + i, 3), dtype=np.uint8)
            for i in range(n)]


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def summarize_trace(trace: dict, stages: tuple[str, ...] = STAGES) -> dict:
    """Stage and device times from a chrome trace of one request (or one
    train step, with its stage names), each summed over the stage's calls,
    and the TOP_KERNELS kernels with the most device time; microsecond
    timestamps, categories as torch.profiler writes them."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    t0 = min(e["ts"] for e in ev)
    t1 = max(e["ts"] + e["dur"] for e in ev)
    work = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in work])
    # host time of each launch, by correlation id: a stage's device time is
    # the work launched inside its host range, on any thread (autograd
    # launches the backward's kernels from its own thread, outside the
    # range's device-side annotation); cuBLAS launches through the driver
    # API (cuda_driver), the rest through the runtime
    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    by_stage: dict[str, dict] = {}
    for e in ev:
        if e["name"] in stages and e.get("cat") in ("user_annotation", "gpu_user_annotation"):
            st = by_stage.setdefault(e["name"], {})
            if e["cat"] == "gpu_user_annotation":
                st["device_span_ms"] = st.get("device_span_ms", 0.0) + e["dur"] / 1e3
                continue
            st["calls"] = st.get("calls", 0) + 1
            st["host_ms"] = st.get("host_ms", 0.0) + e["dur"] / 1e3
            lo, hi = e["ts"], e["ts"] + e["dur"]
            st["device_ms"] = st.get("device_ms", 0.0) + sum(
                w["dur"] for w in work
                if lo <= launched.get(w.get("args", {}).get("correlation"), -1) <= hi
            ) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in work:
        by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:TOP_KERNELS]
    return {
        "span_ms": (t1 - t0) / 1e3,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy * 1e3 / (t1 - t0),
        "host_before_device_ms": (min(e["ts"] for e in work) - t0) / 1e3,
        "stages": by_stage,
        "top_kernels": [
            {"name": n[:90], "calls": len(d), "device_ms": sum(d)} for n, d in top
        ],
    }


def profile_bucket(engine, pages, trace: Path) -> dict:
    engine.predict_pages(pages)  # warm-up
    torch.cuda.synchronize()
    nms.nms_mask.host_syncs = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict_pages(pages)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        out = summarize_trace(json.load(f))
    return {"pages": len(pages), "wall_ms": wall_ms,
            "nms_host_syncs": nms.nms_mask.host_syncs, **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(REPO / "configs" / "serving_1024.json"))
    ap.add_argument("--buckets", type=int, nargs="+", default=[224, 1024])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=str(REPO / "build" / "traces"),
                    help="one chrome trace per bucket is written here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")

    mc, dl = load_config(args.config)
    cfg = DetectorConfig.from_model_config(mc, precision_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = DetectorModel(init_detector(cfg, gen, device="cuda"), cfg)
    engine = BatchInferenceEngine(model, image_sizes=args.buckets, batch_size=dl.batch_size)
    rng = np.random.default_rng(args.seed)
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)

    out = {"device": torch.cuda.get_device_name(0), "buckets": {}}
    for size in args.buckets:
        trace = trace_dir / f"serving_{size}.json"
        r = profile_bucket(engine, _pages(size, dl.batch_size, rng), trace)
        out["buckets"][size] = r
        print(f"bucket {size}: {r['pages']} pages, wall {r['wall_ms']:.3f} ms, traced span "
              f"{r['span_ms']:.3f} ms, host before first device work "
              f"{r['host_before_device_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
              f"idle share {r['device_idle_share']:.3f}, NMS host syncs {r['nms_host_syncs']}")
        for name, st in r["stages"].items():
            print(f"  stage {name}: host {st.get('host_ms', 0):.3f} ms, device span "
                  f"{st.get('device_span_ms', 0):.3f} ms, device work launched "
                  f"{st.get('device_ms', 0):.3f} ms")
        for k in r["top_kernels"]:
            print(f"  kernel {k['device_ms']:9.3f} ms  x{k['calls']:<5d} {k['name']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
