#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``layoutdit_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``layoutdit_tpu_torch/csrc`` (one
nvcc per source, in parallel), holds each kernel against its plain
PyTorch version at the serving path's shapes and times both, then serves
requests through ``BatchInferenceEngine`` with dit-base Faster R-CNN at
full width (``configs/serving_1024.json``, random weights from a seed) in
the 224 and 1024 px buckets, checks the detections and the encoder
against a float32 CPU reference, and checks that every kernel ran on that
path. It prints one JSON line describing the kernels, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
Any failed check raises, and the exit code is not 0. It imports nothing
of JAX or of ``layoutdit_tpu``, and it exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "serving_1024.json"

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# bf16 outputs of a kernel vs its plain version (both accumulate in fp32
# and round once to bf16; the attention kernels also round P to bf16
# before the P V product): max |kernel - plain| <= max |plain| / 64,
# i.e. a few bf16 roundings at the top of the output's range.
BF16_REL_TOL = 1.0 / 64
# encoder taps, bf16 on the card vs float32 on the CPU, after 12 layers:
# ||card - cpu|| / ||cpu|| (Frobenius)
ENCODER_REL_TOL = 5e-2
# each serving request is timed this many times (host clock, one request
# at a time); the spread between runs is printed beside the median
REQUEST_REPEATS = 5


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """-> (max |got - want|, its tolerance); raises past the tolerance."""
    err = (got.float() - want.float()).abs().max().item()
    tol = want.float().abs().max().item() * BF16_REL_TOL
    print(f"  {name}: max_abs_err {err:.6g} (tolerance {tol:.6g})")
    if not err <= tol:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err, tol


def _qkv(gen, b, n, h, d):
    """q, k, v as the encoder makes them: strided views of one fused
    [B, N, 3*H*D] bf16 projection."""
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    hd = h * d
    return [qkv[..., i * hd:(i + 1) * hd].view(b, n, h, d) for i in range(3)]


def phase_short(gen) -> dict:
    from layoutdit_tpu_torch.ops import short_attention as sa

    b, n, h, d = 4, 197, 12, 64
    q, k, v = _qkv(gen, b, n, h, d)
    err, tol = _check_close("short_attention", sa.short_attention(q, k, v),
                            sa.short_attention_plain(q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes = 4 * b * n * h * d * 2
    bound, by = _bound_ms(nbytes, 4 * b * h * n * n * d)
    return {
        "name": "short_attention", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/short_attention.cu",
        "replaces": "layoutdit_tpu/ops/short_attention.py:79",
        "shape": f"B={b} N={n} H={h} D={d} bf16",
        "max_abs_err": err, "tolerance": tol,
        "ms": _time_ms(lambda: sa.short_attention(q, k, v), 50),
        "plain_ms": _time_ms(lambda: sa.short_attention_plain(q, k, v), 20),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: sdpa(qt, kt, vt), 50),
    }


def phase_flash(gen) -> dict:
    from layoutdit_tpu_torch.ops import flash_attention as fa

    b, n, h, d = 4, 4097, 12, 64
    q, k, v = _qkv(gen, b, n, h, d)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v)
    err, tol = _check_close("flash_attention", o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  flash_attention lse: max_abs_err {lse_err:.6g} (tolerance 0.01)")
    if not lse_err <= 1e-2:
        raise RuntimeError("flash_attention: lse disagrees with its plain version")
    del o_ref, lse_ref

    bias = 0.5 * torch.randn(h, n, n, generator=gen, device="cuda")
    ob, _ = fa.flash_attention_fwd(q, k, v, bias)
    bias_err, bias_tol = _check_close("flash_attention (bias)", ob,
                                      fa.flash_attention_plain(q, k, v, bias)[0])

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    io_bytes = 4 * b * n * h * d * 2 + b * h * n * 4
    flops = 4 * b * h * n * n * d
    bound, by = _bound_ms(io_bytes, flops)
    bias_bound, bias_by = _bound_ms(io_bytes + h * n * n * 4, flops)
    mask = bias[None].to(torch.bfloat16)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/flash_attention.cu",
        "replaces": "layoutdit_tpu/ops/flash_attention.py:180",
        "shape": f"B={b} N={n} H={h} D={d} bf16, no bias",
        "max_abs_err": err, "tolerance": tol,
        "ms": _time_ms(lambda: fa.flash_attention_fwd(q, k, v), 10),
        "plain_ms": _time_ms(lambda: fa.flash_attention_plain(q, k, v), 3),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: sdpa(qt, kt, vt), 10),
        "bias_replaces": "layoutdit_tpu/ops/flash_attention.py:64",
        "bias_max_abs_err": bias_err, "bias_tolerance": bias_tol,
        "bias_ms": _time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias), 5),
        "bias_plain_ms": _time_ms(lambda: fa.flash_attention_plain(q, k, v, bias), 2),
        "bias_bound_ms": bias_bound, "bias_bound_by": bias_by,
        "bias_library_ms": _time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), 5),
    }


def _roi_inputs(gen, image: int, b=4, k=512, c=256):
    """A pyramid of the serving path's shapes and 512 RoIs per image with
    log-uniform sizes (all levels used), a fifth of them masked."""
    g = image // 16
    sizes = (4 * g, 2 * g, g, g // 2, (g // 2 + 1) // 2)
    feats = [torch.randn(b, c, s, s, generator=gen, device="cuda").to(torch.bfloat16)
             for s in sizes]
    u = lambda *shape: torch.rand(*shape, generator=gen, device="cuda")  # noqa: E731
    wh = torch.exp(math.log(4.0) + u(b, k, 2) * math.log(image / 4.0))
    xy = u(b, k, 2) * image - wh / 2
    rois = torch.cat([xy, xy + wh], dim=-1)
    mask = u(b, k) > 0.2
    return feats, rois, mask


def _roi_touched_bytes(feats, rois, levels, scales, p, g) -> int:
    """Bytes of feature pixels the RoIs need: a pixel counts once per
    image and level if any RoI gives it a non-zero bilinear weight."""
    from layoutdit_tpu_torch.ops.roi_align import build_roi_weights

    b, k = rois.shape[:2]
    c = feats[0].shape[1]
    pixels = 0
    for li, (f, s) in enumerate(zip(feats, scales)):
        for i in range(b):
            sel = levels[i] == li
            if not bool(sel.any()):
                continue
            wy, wx = build_roi_weights(rois[i][sel], s, tuple(f.shape[-2:]), p, g)
            rows = (wy > 0).any(dim=1)  # [M, H]
            cols = (wx > 0).any(dim=1)  # [M, W]
            pixels += int((rows[:, :, None] & cols[:, None, :]).any(dim=0).sum())
    return pixels * c * feats[0].element_size()


def phase_roi(gen) -> dict:
    from layoutdit_tpu_torch.ops import roi_align as ra

    p, g = 7, 2
    entry = {
        "name": "roi_align", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/roi_align.cu",
        "replaces": "layoutdit_tpu/ops/roi_align_pallas.py:49",
        "library_ms": None,
    }
    for image in (224, 1024):
        feats, rois, mask = _roi_inputs(gen, image)
        scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
        levels = ra.roi_levels(rois, 5, float(image), roi_mask=mask)
        got = ra.roi_align_fwd(feats, rois, levels, scales, p, g)
        err, tol = _check_close(f"roi_align {image} px", got,
                                ra.roi_align_plain(feats, rois, levels, scales, p, g))
        b, k = rois.shape[:2]
        c = feats[0].shape[1]
        nbytes = (_roi_touched_bytes(feats, rois, levels, scales, p, g)
                  + rois.numel() * 4 + b * k * p * p * c * 2)
        bound, by = _bound_ms(nbytes, b * k * p * p * c * g * g * 4 * 2)
        cl = [f.contiguous(memory_format=torch.channels_last) for f in feats]
        timing = {
            "shape": f"B={b} K={k} C={c} P={p} pyramid {image} px bf16",
            "max_abs_err": err, "tolerance": tol,
            "ms": _time_ms(lambda: ra.roi_align_fwd(feats, rois, levels, scales, p, g), 20),
            "kernel_only_ms": _time_ms(
                lambda: ra.roi_align_fwd(cl, rois, levels, scales, p, g), 20),
            "plain_ms": _time_ms(
                lambda: ra.roi_align_plain(feats, rois, levels, scales, p, g), 2),
            "bound_ms": bound, "bound_by": by,
        }
        if image == 1024:
            entry.update(timing)  # the heavier bucket is the headline
        else:
            entry.update({f"b224_{key}": val for key, val in timing.items()})
    return entry


def _counts() -> dict:
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    return {
        "short_attention": sa.short_attention.launches,
        "flash_attention": fa.flash_attention_fwd.launches,
        "roi_align": ra.roi_align_fwd.launches,
    }


def _reset_counts() -> None:
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    sa.short_attention.launches = 0
    fa.flash_attention_fwd.launches = 0
    ra.roi_align_fwd.launches = 0
    nms.nms_mask.host_syncs = 0


def _check_pages(pages, results) -> int:
    if len(results) != len(pages):
        raise RuntimeError("serving: one result per page expected")
    n_dets = 0
    for page, r in zip(pages, results):
        h, w = page.shape[:2]
        if len(r.boxes) == 0:
            raise RuntimeError(f"serving: no detections on a {h}x{w} page")
        ok = (
            np.isfinite(r.boxes).all() and np.isfinite(r.scores).all()
            and (r.boxes[:, [0, 1]] >= -1e-3).all()
            and (r.boxes[:, 2] <= w + 1e-2).all() and (r.boxes[:, 3] <= h + 1e-2).all()
            and (r.boxes[:, 2] >= r.boxes[:, 0]).all() and (r.boxes[:, 3] >= r.boxes[:, 1]).all()
            and ((r.labels >= 1) & (r.labels <= 5)).all()
        )
        if not ok:
            raise RuntimeError(f"serving: detections outside a {h}x{w} page or not finite")
        n_dets += len(r.boxes)
    return n_dets


def _encoder_reference(model, images: dict) -> None:
    """Encoder taps of one page per bucket: bf16 with the kernels on the
    card vs float32 plain versions on the CPU, same weights."""
    from layoutdit_tpu_torch.eval.serving import _to_device
    from layoutdit_tpu_torch.models.detection.detector import _normalize
    from layoutdit_tpu_torch.models.vit import vit_forward

    cfg = model.cfg
    vit_cpu = _to_device(model.params["backbone"]["vit"], torch.device("cpu"))
    for size, img in images.items():
        x = _normalize(img[None].cpu(), cfg)
        with torch.inference_mode():
            got = vit_forward(model.params["backbone"]["vit"], x.cuda().to(torch.bfloat16),
                              cfg.backbone.vit, cfg.backbone.taps, torch.bfloat16)
            want = vit_forward(vit_cpu, x, cfg.backbone.vit, cfg.backbone.taps, torch.float32)
        for tap, gt, wt in zip(cfg.backbone.taps, got, want):
            rel = ((gt.float().cpu() - wt).norm() / wt.norm()).item()
            print(f"  encoder {size} px tap {tap}: relative error {rel:.4g} "
                  f"(tolerance {ENCODER_REL_TOL})")
            if not rel <= ENCODER_REL_TOL:
                raise RuntimeError("encoder on the card disagrees with the CPU reference")


def phase_serving(kernels: list[dict]) -> dict:
    from layoutdit_tpu_torch.config import load_config
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.ops import nms

    mc, dl = load_config(str(CONFIG))
    cfg = DetectorConfig.from_model_config(mc, precision_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = DetectorModel(init_detector(cfg, gen, device="cuda"), cfg)
    engine = BatchInferenceEngine(model, image_sizes=(224, 1024), batch_size=dl.batch_size)
    print(f"  dit-base Faster R-CNN, hidden {cfg.backbone.vit.hidden_size}, "
          f"{cfg.backbone.vit.num_hidden_layers} layers, buckets {engine.image_sizes}, "
          f"batch {engine.batch_size}, post-NMS {cfg.budget.rpn_post_nms_top_n_test}")

    rng = np.random.default_rng(0)
    small = [rng.integers(0, 256, (200 + 3 * i, 160 + 2 * i, 3), dtype=np.uint8)
             for i in range(8)]
    large = [rng.integers(0, 256, (1000 - 5 * i, 770 + 4 * i, 3), dtype=np.uint8)
             for i in range(4)]
    requests = [("224 px bucket", small), ("1024 px bucket", large),
                ("both buckets", small[:4] + large[:2])]

    engine.predict_pages(small[:4] + large[:4])  # warm-up, not counted
    torch.cuda.synchronize()

    _reset_counts()
    latencies = {name: [] for name, _ in requests}
    n_dets = {}
    for _ in range(REQUEST_REPEATS):
        for name, pages in requests:
            t0 = time.perf_counter()
            results = engine.predict_pages(pages)
            torch.cuda.synchronize()
            latencies[name].append(time.perf_counter() - t0)
            n_dets[name] = _check_pages(pages, results)
    for name, pages in requests:
        ts = sorted(latencies[name])
        print(f"  request ({name}): {len(pages)} pages, {n_dets[name]} detections, latency "
              f"median {np.median(ts) * 1e3:.2f} ms (min {ts[0] * 1e3:.2f}, max "
              f"{ts[-1] * 1e3:.2f}, {len(ts)} runs), "
              f"{len(pages) / np.median(ts):.2f} pages/s")
    counts = _counts()
    syncs = nms.nms_mask.host_syncs
    print(f"  launches during serving ({REQUEST_REPEATS} rounds of the requests): {counts}; "
          f"NMS host syncs: {syncs}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} was not launched on the serving path")

    _encoder_reference(model, {
        s: engine._upload_batch([engine._decode_page(p)], s)[0][0]
        for s, p in ((224, small[0]), (1024, large[0]))
    })
    return {
        "rounds": REQUEST_REPEATS,
        "latency_ms": {k: sorted(t * 1e3 for t in v) for k, v in latencies.items()},
        "median_pages_per_s": {
            name: len(pages) / float(np.median(latencies[name])) for name, pages in requests
        },
        "nms_host_syncs": syncs,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    if not (ROOT / "layoutdit_tpu_torch").is_dir() or not CONFIG.is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from layoutdit_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    print("phase build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"  built {list(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    print("phase kernels")
    kernels = [phase_short(gen), phase_flash(gen), phase_roi(gen)]
    torch.cuda.empty_cache()

    print("phase serving")
    serving = phase_serving(kernels)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": serving}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
