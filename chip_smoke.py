#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``layoutdit_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``layoutdit_tpu_torch/csrc`` (one
nvcc per source, in parallel), holds each forward and backward kernel
against its plain PyTorch version at the shapes of the serving and
training paths (the flash kernels also at a ragged N = 65, and to the
same bits on a second launch) and times both, with each flash kernel's
share of its bound (phases ``kernels`` and ``kernels_bwd``; the RoIAlign
pair on the pyramid in the detector's layout, channels-last with the
fifth level a strided view, also at the (14, 2) size a mask head takes,
the backward to the same bits on a second run and its footprint pass to
``roi_footprints``), holds the
fused RoIAlign probes' kernels (``ops/roi_fused.py``) to their
plain versions at the probe's K = 8192, and the fused form to the
RoIAlign kernel on real RoIs, times them beside the two-GEMM yardstick
and runs the probe tool as the probe path (phase ``probes``), then
serves requests through ``BatchInferenceEngine`` with dit-base
Faster R-CNN at full width (``configs/serving_1024.json``, random weights
from a seed) in the 224 and 1024 px buckets and checks the detections
and the encoder against a float32 CPU reference (phase ``serving``),
then trains the port's default config (dit-base, 224 px, batch 16) with
``Trainer`` over synthetic pages: one epoch, then steps on a repeated
batch whose loss must fall, and the encoder's gradients against a
float32 CPU reference (phase ``train``); trains the same config with
the JAX trainer's run state on (EMA, two micro-batches an update, bf16
first moments, non-finite skipping, two steps a dispatch, asynchronous
checkpoints kept two at a time, TensorBoard, a mid-training eval every
epoch) for 3 epochs, preempts a second run with SIGTERM mid-epoch and
resumes it to the first run's bits, and checks the accumulated gradient,
a NaN step, the files kept, the events and ``best.pt`` (phase
``train_state``); packs pages into tar shards, requires the native COCO
parser (built with g++ into ``build/native/``) and times it against
``json.loads`` on a file of PubLayNet val's size, writes two steps of
the default config as a JAX-format ``.msgpack`` checkpoint with the
port's encoder and as a ``.pt``, resumes the first over the shards and
the second over the files, and holds the two runs to the same bits
(phase ``io``); does the same as ``train`` with the
windowed high-res config ``configs/train_1024_window.json`` (dit-base,
1024 px, batch 4, 16 x 16 windows, four global layers; phase
``train_1024``) and with its BEiT-layout variant
``configs/train_1024_window_relpos.json`` (a relative-position table in
every layer: every biased attention on the flash kernels, the bias
gradient on the dbias kernel; phase ``train_1024_relpos``). Then it runs
the port's command line, ``layoutdit_tpu_torch.main``, at the default
config: one epoch with a mid-training COCO eval, the final score of
held-out pages, ``predictions.json``, ``best.pt`` and the overlays, and
``best.pt`` scored again to the mAP it records (phase ``main``); and the
JAX package's flagship convergence recipe through the port in bf16
(``tools/convergence.py``: the tiny detector, 48 epochs), held to the
JAX test's held-out mAP and AP50 floors (phase ``convergence``). It
checks that every kernel ran on its path, the right number of times a
train step, and the probes' kernels on none but theirs. One profiled request
per serving bucket and one profiled 224 px train step print the
``backbone`` and ``rpn`` stage times, which the pyramid's layout moves.
It prints JSON lines for serving, training and the kernels, the card's
name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the exit
code is not 0. It imports nothing of JAX or of ``layoutdit_tpu``, and it
exits non-zero without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "serving_1024.json"
TRAIN_1024_CONFIG = ROOT / "configs" / "train_1024_window.json"
RELPOS_CONFIG = ROOT / "configs" / "train_1024_window_relpos.json"

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# bf16 outputs of a kernel vs its plain version (both accumulate in fp32
# and round once to bf16; the attention kernels also round P to bf16
# before the P V product): max |kernel - plain| <= max |plain| / 64,
# i.e. a few bf16 roundings at the top of the output's range.
BF16_REL_TOL = 1.0 / 64
# dbias, fp32 out, kernel vs plain version: both form S and dP from the
# same bf16 inputs in fp32 and keep dS in fp32, so they differ by fp32
# summation order only (measured about 1e-6 of max |plain|). Its values
# are heavy-tailed (max |plain| far above the mean, printed beside), so
# the bf16 rule above would pass a tile wrong by a typical value.
DBIAS_REL_TOL = 1e-4
# absolute floor of the tolerance for gradients that are 0 in exact
# arithmetic (the short backward's dq and dk at N=1)
SINGLE_TOKEN_FLOOR = 1e-4
# encoder taps, bf16 on the card vs float32 on the CPU, after 12 layers:
# ||card - cpu|| / ||cpu|| (Frobenius)
ENCODER_REL_TOL = 5e-2
# encoder + FPN gradients, bf16 on the card vs float32 on the CPU, same
# weights and cotangent, after 12 layers forward and back
GRAD_REL_TOL = 5e-2
# each serving request is timed this many times (host clock, one request
# at a time); the spread between runs is printed beside the median
REQUEST_REPEATS = 5
SERVING_KERNELS = ("short_attention", "flash_attention", "roi_align")
# the fused RoIAlign probes' kernels: launched on the probe path only
PROBE_KERNELS = ("roi_fused_a", "roi_fused_a0", "roi_fused_e")
# the probe path: RoIs and launches of each kernel's timing
PROBE_K = 8192
PROBE_ITERS = 20
# train phase: one epoch of this many steps through Trainer.train(), then
# steps on one repeated batch (the first TRAIN_WARMUP not timed), over
# which the loss must fall by TRAIN_MIN_DROP (the JAX e2e overfit check)
TRAIN_EPOCH_STEPS = 4
TRAIN_REPEATS = 20
TRAIN_WARMUP = 2
TRAIN_MIN_DROP = 0.10


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


# a spin kernel of this many cycles (tens of ms) holds the stream while
# the host queues the calls that _device_ms times
SPIN_CYCLES = 100_000_000


def _device_ms(fn, iters: int) -> float:
    """Device time per call: the calls are queued behind a spin kernel, so
    the card runs them back to back however long the host takes to launch
    each (for a kernel of microseconds ``_time_ms`` measures the host).
    Raises if the host took longer to queue them than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= spin.elapsed_time(start):
        raise RuntimeError("_device_ms: the spin ended before the calls were queued")
    return start.elapsed_time(end) / iters


def _check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                 floor: float = 0.0, rel: float = BF16_REL_TOL) -> tuple[float, float]:
    """-> (max |got - want|, its tolerance); raises past the tolerance,
    max |want| * ``rel`` or ``floor`` if that is larger."""
    err = (got.float() - want.float()).abs().max().item()
    tol = max(want.float().abs().max().item() * rel, floor)
    print(f"  {name}: max_abs_err {err:.6g} (tolerance {tol:.6g})")
    if not err <= tol:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err, tol


def _print_share(label: str, ms: float, bound: float, by: str) -> None:
    print(f"  {label}: {ms:.6g} ms, bound {bound:.6g} ms ({by}), "
          f"share of the bound {bound / ms:.4f}")


def _qkv(gen, b, n, h, d):
    """q, k, v as the encoder makes them: strided views of one fused
    [B, N, 3*H*D] bf16 projection."""
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    hd = h * d
    return [qkv[..., i * hd:(i + 1) * hd].view(b, n, h, d) for i in range(3)]


def _short_fwd_case(gen, b, n, h=12, d=64) -> dict:
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, b, n, h, d)
    err, tol = _check_close(f"short_attention B={b} N={n}", sa.short_attention(q, k, v),
                            sa.short_attention_plain(q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes = 4 * b * n * h * d * 2
    bound, by = _bound_ms(nbytes, 4 * b * h * n * n * d)
    ms = _device_ms(lambda: sa.short_attention(q, k, v), 50)
    _print_share(f"short_attention B={b} N={n}", ms, bound, by)
    return {
        "shape": f"B={b} N={n} H={h} D={d} bf16",
        "max_abs_err": err, "tolerance": tol,
        "ms": ms,  # the card's time (_device_ms); call_ms with the host's
        "call_ms": _time_ms(lambda: sa.short_attention(q, k, v), 50),
        "plain_ms": _time_ms(lambda: sa.short_attention_plain(q, k, v), 20),
        "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
        "library_ms": _device_ms(lambda: sdpa(qt, kt, vt), 50),
        "library_call_ms": _time_ms(lambda: sdpa(qt, kt, vt), 50),
    }


# the short kernels' other shapes on the windowed 1024 px train step: its
# 64 windows of 16 x 16 patches (4 images x 16) and the CLS token alone
WINDOW_SHAPES = {"w256": (64, 256), "n1": (4, 1)}

# the convergence recipe's shapes (write_fixture_config(tiny_model=True)
# at batch 8, 224 px): 2 heads of 32 over N = 197, an FPN of 64 channels,
# RoIAlign over box_batch_size_per_image RoIs in training and
# rpn_post_nms_top_n_test in evaluation; phase_convergence checks the
# recipe's config against them
RECIPE = {"batch": 8, "image": 224, "heads": 2, "head_dim": 32, "channels": 64,
          "train_rois": 128, "eval_rois": 300}
# the train_state phase's micro-batch: the default batch of 16 in A = 2
# micro-batches, at dit-base widths (the "micro_" cases of rows 1, 2, 7, 8)
MICRO_BATCH = 8


def phase_short(gen) -> dict:
    entry = {
        "name": "short_attention", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/short_attention.cu",
        "replaces": "layoutdit_tpu/ops/short_attention.py:79",
        **_short_fwd_case(gen, 16, 197),
    }
    for key, (b, n) in WINDOW_SHAPES.items():
        entry.update({f"{key}_{k}": v for k, v in _short_fwd_case(gen, b, n).items()})
    entry.update({f"recipe_{k}": v for k, v in _short_fwd_case(
        gen, RECIPE["batch"], 197, RECIPE["heads"], RECIPE["head_dim"]).items()})
    entry.update({f"micro_{k}": v for k, v in _short_fwd_case(gen, MICRO_BATCH, 197).items()})
    return entry


# timed launches of the flash forward (row 3) at each shape
FLASH_FWD_ITERS = 10


def _flash_fwd_case(gen, q, k, v, with_bias: bool, timed: bool = True) -> dict | None:
    """The flash forward at one shape (a random [H, N, N] fp32 bias with
    ``with_bias``) against its plain version, o and lse, and a second
    launch giving the same bits; unless not ``timed``, timed per call and
    on the card alone (``_device_ms``) beside SDPA (the bias as a bf16
    attn_mask)."""
    from layoutdit_tpu_torch.ops import flash_attention as fa

    b, n, h, d = q.shape
    bias = 0.5 * torch.randn(h, n, n, generator=gen, device="cuda") if with_bias else None
    label = f"flash_attention B={b} N={n}" + (" (bias)" if with_bias else "")
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, bias)
    err, tol = _check_close(label, o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  {label} lse: max_abs_err {lse_err:.6g} (tolerance 0.01)")
    if not lse_err <= 1e-2:
        raise RuntimeError(f"{label}: lse disagrees with its plain version")
    again = fa.flash_attention_fwd(q, k, v, bias)
    if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
        raise RuntimeError(f"{label}: two launches gave different bits")
    del o_ref, lse_ref, again
    if not timed:
        return None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None if bias is None else bias[None].to(torch.bfloat16)
    nbytes = 4 * b * n * h * d * 2 + b * h * n * 4 + (0 if bias is None else h * n * n * 4)
    bound, by = _bound_ms(nbytes, 4 * b * h * n * n * d)
    kernel = lambda: fa.flash_attention_fwd(q, k, v, bias)  # noqa: E731
    library = lambda: sdpa(qt, kt, vt, attn_mask=mask)  # noqa: E731
    device_ms = _device_ms(kernel, FLASH_FWD_ITERS)
    _print_share(f"{label} on the card", device_ms, bound, by)
    return {
        "shape": f"B={b} N={n} H={h} D={d} bf16, q/k/v strided in fused [B, N, 3HD]"
                 + (f", fp32 bias [{h}, {n}, {n}]" if with_bias else ", no bias"),
        "max_abs_err": err, "tolerance": tol, "lse_max_abs_err": lse_err,
        "ms": _time_ms(kernel, FLASH_FWD_ITERS),  # per call; device_ms on the card alone
        "device_ms": device_ms,
        "plain_ms": _time_ms(lambda: fa.flash_attention_plain(q, k, v, bias), 2),
        "bound_ms": bound, "bound_by": by, "bound_share": bound / device_ms,
        "library_ms": _time_ms(library, FLASH_FWD_ITERS),
        "library_device_ms": _device_ms(library, FLASH_FWD_ITERS),
    }


def phase_flash(gen) -> dict:
    """The flash forward (row 3) at the main paths' shapes: B=4 N=4097
    without a bias (1024 px serving, the windowed step's global layers)
    and with one (the rel-pos step's global layers), and B=64 N=256 with
    one (its 16 x 16 windows, one bias for all windows); first, untimed
    checks at the ragged N = 65 (one valid row in the second 64-row tile)
    without and with a bias."""
    h, d = 12, 64
    for with_bias in (False, True):
        _flash_fwd_case(gen, *_qkv(gen, 2, 65, h, d), with_bias, timed=False)
    b, n = 4, 4097
    q, k, v = _qkv(gen, b, n, h, d)
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/flash_attention.cu",
        "replaces": "layoutdit_tpu/ops/flash_attention.py:180",
        "bias_replaces": "layoutdit_tpu/ops/flash_attention.py:64",
        **_flash_fwd_case(gen, q, k, v, False),
    }
    entry.update({f"bias_{k}": v for k, v in _flash_fwd_case(gen, q, k, v, True).items()})
    del q, k, v
    wb, wn = WINDOW_SHAPES["w256"]
    entry.update({f"w256_bias_{k}": v for k, v in
                  _flash_fwd_case(gen, *_qkv(gen, wb, wn, h, d), True).items()})
    torch.cuda.empty_cache()
    return entry


def _roi_inputs(gen, image: int, b=4, k=512, c=256):
    """A pyramid of the serving path's shapes in the detector's own layout
    (p2..p5 channels-last, the fifth level the strided view
    p5[..., ::2, ::2], as the FPN makes it) and 512 RoIs per image with
    log-uniform sizes (all levels used), a fifth of them masked."""
    g = image // 16
    feats = [torch.randn(b, c, s, s, generator=gen, device="cuda").to(torch.bfloat16)
             .contiguous(memory_format=torch.channels_last) for s in (4 * g, 2 * g, g, g // 2)]
    feats.append(feats[-1][..., ::2, ::2])
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


ROI_SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]


def _roi_fwd_case(gen, image: int, b: int, p: int = 7, g: int = 2, k: int = 512,
                  c: int = 256) -> dict:
    """Row 7 on the detector's pyramid layout, against its plain version,
    timed per call (the wrapper included: it copies nothing)."""
    from layoutdit_tpu_torch.ops import roi_align as ra

    feats, rois, mask = _roi_inputs(gen, image, b=b, k=k, c=c)
    scales = ROI_SCALES
    levels = ra.roi_levels(rois, 5, float(image), roi_mask=mask)
    got = ra.roi_align_fwd(feats, rois, levels, scales, p, g)
    err, tol = _check_close(f"roi_align {image} px B={b} K={k} C={c} P={p}", got,
                            ra.roi_align_plain(feats, rois, levels, scales, p, g))
    b, k = rois.shape[:2]
    c = feats[0].shape[1]
    nbytes = (_roi_touched_bytes(feats, rois, levels, scales, p, g)
              + rois.numel() * 4 + b * k * p * p * c * 2)
    bound, by = _bound_ms(nbytes, b * k * p * p * c * g * g * 4 * 2)
    ms = _time_ms(lambda: ra.roi_align_fwd(feats, rois, levels, scales, p, g), 20)
    _print_share(f"roi_align {image} px B={b} K={k} C={c} P={p}", ms, bound, by)
    return {
        "shape": f"B={b} K={k} C={c} P={p} G={g} pyramid {image} px bf16, channels-last, "
                 "fifth level a strided view",
        "max_abs_err": err, "tolerance": tol, "ms": ms,
        "plain_ms": _time_ms(lambda: ra.roi_align_plain(feats, rois, levels, scales, p, g), 2),
        "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
    }


def phase_roi(gen) -> dict:
    """Row 7: 224 px at the train step's B=16 (serving's batch is 4),
    1024 px at serving's B=4 (the headline), the (14, 2) instantiation
    a mask head takes at 1024 px, and the convergence recipe's training
    and evaluation shapes (C = 64)."""
    entry = {
        "name": "roi_align", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/roi_align.cu",
        "replaces": "layoutdit_tpu/ops/roi_align_pallas.py:49",
        "library_ms": None,
    }
    entry.update({f"b224_{k}": v for k, v in _roi_fwd_case(gen, 224, 16).items()})
    entry.update(_roi_fwd_case(gen, 1024, 4))
    entry.update({f"p14_{k}": v for k, v in _roi_fwd_case(gen, 1024, 4, p=14).items()})
    for key in ("train", "eval"):
        entry.update({f"recipe_{key}_{k}": v for k, v in _roi_fwd_case(
            gen, RECIPE["image"], RECIPE["batch"], k=RECIPE[f"{key}_rois"],
            c=RECIPE["channels"]).items()})
    entry.update({f"micro_{k}": v for k, v in _roi_fwd_case(gen, 224, MICRO_BATCH).items()})
    torch.cuda.empty_cache()
    return entry


def _short_bwd_case(gen, b, n, h=12, d=64) -> dict:
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, b, n, h, d)
    o = sa.short_attention(q, k, v)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="cuda")
    out = tuple(sa.split_qkv(dqkv, h))
    got = sa.short_attention_bwd(q, k, v, o, do, out=out)
    again = torch.empty_like(dqkv)
    sa.short_attention_bwd(q, k, v, o, do, out=tuple(sa.split_qkv(again, h)))
    want = sa.short_attention_bwd_plain(q, k, v, o, do)
    # at N=1 the softmax is constant, so dq and dk are 0 in exact
    # arithmetic: both sides give fp32 rounding noise of dO.v - dO.o (terms
    # of order 10), which the relative tolerance cannot measure; the floor
    # is far below one bf16 ulp of that call's dv (|dv| of order 1)
    floor = SINGLE_TOKEN_FLOOR if n == 1 else 0.0
    errs, tols = zip(*(_check_close(f"short_attention_bwd B={b} N={n} {name}", g, w, floor)
                       for name, g, w in zip(("dq", "dk", "dv"), got, want)))
    del want
    if not torch.equal(dqkv, again):
        raise RuntimeError(f"short_attention_bwd B={b} N={n}: two runs gave different gradients")
    del again

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ot = sdpa(qt, kt, vt)
    dot = do.transpose(1, 2)
    nbytes = 8 * b * n * h * d * 2  # q, k, v, o, dO in; dq, dk, dv out
    bound, by = _bound_ms(nbytes, 10 * b * h * n * n * d)
    ms = _device_ms(lambda: sa.short_attention_bwd(q, k, v, o, do, out=out), 20)
    _print_share(f"short_attention_bwd B={b} N={n}", ms, bound, by)
    grad = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    return {
        "shape": f"B={b} N={n} H={h} D={d} bf16, q/k/v and dq/dk/dv strided in fused [B, N, 3HD]",
        "max_abs_err": max(errs), "tolerance": tols[errs.index(max(errs))],
        "ms": ms,  # the card's time (_device_ms); call_ms with the host's
        "call_ms": _time_ms(lambda: sa.short_attention_bwd(q, k, v, o, do, out=out), 20),
        "plain_ms": _time_ms(lambda: sa.short_attention_bwd_plain(q, k, v, o, do), 5),
        "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
        "library_ms": _device_ms(grad, 20),
        "library_call_ms": _time_ms(grad, 20),
    }


def phase_short_bwd(gen) -> dict:
    """Short attention backward at the 224 px train step's shape, and at
    the windowed 1024 px step's: q, k, v as strided views of one fused
    projection, the gradient written into one fused [B, N, 3*H*D] tensor,
    against the plain version on the same bf16 inputs; a second run must
    give the same bits (no atomics)."""
    entry = {
        "name": "short_attention_bwd", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/short_attention.cu",
        "replaces": "layoutdit_tpu/ops/short_attention.py:90",
        **_short_bwd_case(gen, 16, 197),
    }
    for key, (b, n) in WINDOW_SHAPES.items():
        entry.update({f"{key}_{k}": v for k, v in _short_bwd_case(gen, b, n).items()})
    entry.update({f"recipe_{k}": v for k, v in _short_bwd_case(
        gen, RECIPE["batch"], 197, RECIPE["heads"], RECIPE["head_dim"]).items()})
    entry.update({f"micro_{k}": v for k, v in _short_bwd_case(gen, MICRO_BATCH, 197).items()})
    print("  short_attention_bwd: two runs gave the same bits at every shape")
    return entry


# timed launches of each flash backward kernel (rows 4-6)
FLASH_BWD_ITERS = 20


def _flash_bwd_case(gen, b: int, n: int, with_bias: bool, h=12, d=64,
                    timed: bool = True) -> dict | None:
    """Flash attention backward at one shape: q, k, v as strided views of
    one fused projection, dq, dk, dv written into one fused [B, N, 3*H*D]
    gradient, and with a bias [H, N, N] its fp32 gradient, each against
    the plain version on the same bf16 inputs; a second run must give the
    same bits (no atomics). Each kernel is timed alone (dq first: it
    writes the delta the others read), unless not ``timed``. The plain
    version computes every gradient in one call; so does SDPA's backward,
    the yardstick, timed with the bias as a constant attn_mask and, for
    dbias, as one that requires a gradient."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import short_attention as sa

    scale = 1.0 / math.sqrt(d)
    q, k, v = _qkv(gen, b, n, h, d)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="cuda")
    again = torch.empty_like(dqkv)
    out = tuple(sa.split_qkv(dqkv, h))
    bias = 0.5 * torch.randn(h, n, n, generator=gen, device="cuda") if with_bias else None
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    dbias = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, out=out, bias_grad=with_bias)[3]
    dbias2 = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, out=tuple(sa.split_qkv(again, h)),
                                    bias_grad=with_bias)[3]
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, bias)
    label = f"flash_attention_bwd B={b} N={n}" + (" (bias)" if with_bias else "")
    errs = {name: _check_close(f"{label} {name}", g, w)
            for name, g, w in zip(("dq", "dk", "dv"), out, want)}
    if with_bias:
        errs["dbias"] = _check_close(f"{label} dbias", dbias, want[3], rel=DBIAS_REL_TOL)
        fro = ((dbias - want[3]).norm() / want[3].norm()).item()
        print(f"    mean |plain| {want[3].abs().mean().item():.6g}, relative Frobenius {fro:.6g}")
    del want
    if not (torch.equal(dqkv, again) and (not with_bias or torch.equal(dbias, dbias2))):
        raise RuntimeError(f"{label}: two runs gave different gradients")
    del dbias2
    if not timed:
        return None
    delta = torch.empty(b * h, n, dtype=torch.float32, device="cuda")
    dq, dk, dv = out
    res = {
        "dq": (errs["dq"], _time_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, bias, scale, dq, delta),
            FLASH_BWD_ITERS)),
        "dkdv": (max(errs["dk"], errs["dv"]), _time_ms(
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, lse, do, delta, bias, scale, dk, dv),
            FLASH_BWD_ITERS)),
        "plain": _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, bias), 2),
    }
    if with_bias:
        dbias_fn = lambda: fa.flash_attention_bwd_dbias(  # noqa: E731
            q, k, v, lse, do, delta, bias, scale, dbias)
        res["dbias"] = (errs["dbias"], _time_ms(dbias_fn, FLASH_BWD_ITERS))
        res["dbias_device"] = _device_ms(dbias_fn, FLASH_BWD_ITERS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dot = do.transpose(1, 2)
    masks = {"library": None if bias is None else bias[None].to(torch.bfloat16)}
    if with_bias:
        masks["library_dbias"] = masks["library"].clone().requires_grad_(True)
    for key, mask in masks.items():
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ot = sdpa(qt, kt, vt, attn_mask=mask)
        wrt = (qt, kt, vt) if mask is None or not mask.requires_grad else (qt, kt, vt, mask)
        grad = lambda: torch.autograd.grad(ot, wrt, dot, retain_graph=True)  # noqa: E731
        res[key] = _time_ms(grad, FLASH_BWD_ITERS)
        if key == "library_dbias":
            res["library_dbias_device"] = _device_ms(grad, FLASH_BWD_ITERS)
        del ot, qt, kt, vt, grad
    torch.cuda.empty_cache()
    return res


def phase_flash_bwd(gen) -> list[dict]:
    """The flash backward kernels at the 1024 px train steps' shapes: the
    global layers (B=4, N=4097, H=12, D=64) without and with a bias, and
    the rel-pos step's 16 x 16 windows (B=64, N=256) with one (each
    ``_flash_bwd_case``): rows dkdv, dq and dbias of the kernel table.
    First, untimed, the ragged N = 65 (one valid row in the second tile of
    64) without and with a bias."""
    for with_bias in (False, True):
        _flash_bwd_case(gen, 2, 65, with_bias, timed=False)
    b, n, h, d = 4, 4097, 12, 64
    res = {"": _flash_bwd_case(gen, b, n, False), "bias_": _flash_bwd_case(gen, b, n, True)}
    wb, wn = WINDOW_SHAPES["w256"]
    res["w256_bias_"] = _flash_bwd_case(gen, wb, wn, True)
    print("  flash_attention_bwd: two runs gave the same bits, with and without bias")

    def work(b, n):
        """(bytes, operations) of each kernel and of the whole backward at
        one shape, without the bias's bytes; the bias [H, N, N] fp32."""
        row = b * n * h * d * 2  # one bf16 [B, N, H, D] tensor
        vec = b * h * n * 4  # one fp32 [B*H, N] vector
        flops = 2 * b * h * n * n * d  # one N x N x D product over all heads
        # dq: S, dP and dQ from q, k, v, o, dO, lse; out dq and delta.
        # dkdv: S, dP, dV and dK from q, k, v, dO, lse, delta; out dk and dv.
        # dbias: S and dP from q, k, v, dO, lse, delta; out dbias (the bias
        # read and dbias written counted by the caller).
        return {"dq": (6 * row + 2 * vec, 3 * flops), "dkdv": (6 * row + 2 * vec, 4 * flops),
                "dbias": (4 * row + 2 * vec, 2 * flops),
                "pair": (8 * row + vec, 5 * flops)}, h * n * n * 4

    entries = []
    # (no-bias kernel body, bias kernel body) lines in the JAX source
    for part, (line, bias_line) in (("dkdv", (280, 217)), ("dq", (286, 253))):
        entry = {
            "name": f"flash_attention_bwd_{part}", "route": "cuda",
            "source": "layoutdit_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"layoutdit_tpu/ops/flash_attention.py:{line}",
            "bias_replaces": f"layoutdit_tpu/ops/flash_attention.py:{bias_line}",
            "plain_and_library_compute": "every gradient in one call (compare with pair_ms)",
        }
        for key, bb, nn in (("", b, n), ("bias_", b, n), ("w256_bias_", wb, wn)):
            w, bias_bytes = work(bb, nn)
            if not key:
                bias_bytes = 0
            (err, tol), ms = res[key][part]
            bound, by = _bound_ms(w[part][0] + bias_bytes, w[part][1])
            pair_bound, pair_by = _bound_ms(w["pair"][0] + bias_bytes, w["pair"][1])
            _print_share(f"flash_attention_bwd_{part} {key or 'nobias_'}B={bb} N={nn}", ms,
                         bound, by)
            entry.update({
                f"{key}bound_share": bound / ms,
                f"{key}shape": f"B={bb} N={nn} H={h} D={d} bf16"
                               + (f", fp32 bias [{h}, {nn}, {nn}]" if key else ", no bias")
                               + ", q/k/v and dq/dk/dv strided in fused [B, N, 3HD]",
                f"{key}max_abs_err": err, f"{key}tolerance": tol, f"{key}ms": ms,
                f"{key}plain_ms": res[key]["plain"], f"{key}bound_ms": bound,
                f"{key}bound_by": by, f"{key}library_ms": res[key]["library"],
                f"{key}pair_ms": res[key]["dq"][1] + res[key]["dkdv"][1],
                f"{key}pair_bound_ms": pair_bound, f"{key}pair_bound_by": pair_by,
            })
        entries.append(entry)

    entry = {
        "name": "flash_attention_bwd_dbias", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/flash_attention.cu",
        "replaces": "layoutdit_tpu/ops/flash_attention.py:292",
        "plain_and_library_compute": "every gradient in one call, the bias's included",
    }
    for key, bb, nn in (("", b, n), ("w256_", wb, wn)):
        w, bias_bytes = work(bb, nn)
        r = res[key + "bias_"]
        (err, tol), ms = r["dbias"]
        # the bias read once and dbias written once
        bound, by = _bound_ms(w["dbias"][0] + 2 * bias_bytes, w["dbias"][1])
        _print_share(f"flash_attention_bwd_dbias B={bb} N={nn} on the card", r["dbias_device"],
                     bound, by)
        entry.update({
            f"{key}shape": f"B={bb} N={nn} H={h} D={d} bf16, fp32 bias and dbias [{h}, {nn}, "
                           f"{nn}]",
            f"{key}max_abs_err": err, f"{key}tolerance": tol,
            f"{key}ms": ms,  # per call; device_ms on the card alone
            f"{key}device_ms": r["dbias_device"], f"{key}plain_ms": r["plain"],
            f"{key}bound_ms": bound, f"{key}bound_by": by,
            f"{key}bound_share": bound / r["dbias_device"],
            f"{key}library_ms": r["library_dbias"],
            f"{key}library_device_ms": r["library_dbias_device"],
        })
    entries.append(entry)
    return entries


def _roi_bwd_case(gen, image: int, b: int, k: int = 512, p: int = 7, c: int = 256) -> dict:
    """Row 8 on the detector's pyramid layout against its plain version,
    the same bits on a second run (raises otherwise), its footprint pass
    against ``roi_footprints``; timed per call, the wrapper included."""
    from layoutdit_tpu_torch.ops import roi_align as ra

    g = 2
    feats, rois, mask = _roi_inputs(gen, image, b=b, k=k, c=c)
    scales = ROI_SCALES
    levels = ra.roi_levels(rois, 5, float(image), roi_mask=mask)
    dout = torch.randn(b, k, p, p, c, generator=gen, device="cuda").to(torch.bfloat16)
    label = f"roi_align_bwd {image} px B={b} K={k} C={c} P={p}"
    got = ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g)
    want = ra.roi_align_bwd_plain(dout, rois, levels, feats, scales, p, g)
    errs, tols = zip(*(_check_close(f"{label} level {i}", gl, wl)
                       for i, (gl, wl) in enumerate(zip(got, want))))
    again = ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError(f"{label}: two runs gave different bits")
    hw = [tuple(f.shape[-2:]) for f in feats]
    if not torch.equal(ra.roi_footprints_kernel(rois, levels, hw, scales, p, g),
                       ra.roi_footprints(rois, levels, hw, scales, p, g)):
        raise RuntimeError(f"{label}: the footprint pass disagrees with roi_footprints")
    print(f"  {label}: two runs give the same bits; footprint pass equal to roi_footprints")
    del want, again

    n_valid = int((levels >= 0).sum())
    pyramid = sum(f.numel() for f in feats) * 2
    nbytes = n_valid * p * p * c * 2 + pyramid + rois.numel() * 4 + levels.numel() * 4
    # 4 taps x G^2 samples of one multiply-add each per dout element, fp32
    # outside the tensor cores
    t_ops = n_valid * p * p * c * g * g * 4 * 2 / PEAK_FP32_FLOPS * 1e3
    bound, by = _bound_ms(nbytes, 0.0)
    if t_ops > bound:
        bound, by = t_ops, "operations"
    ms = _time_ms(lambda: ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g), 10)
    _print_share(label, ms, bound, by)
    return {
        "shape": f"B={b} K={k} ({n_valid} valid) C={c} P={p} G={g} pyramid {image} px bf16, "
                 "channels-last, fifth level a strided view",
        "max_abs_err": max(errs), "tolerance": tols[errs.index(max(errs))],
        "same_bits_on_rerun": True, "footprints_equal_spec": True, "ms": ms,
        "plain_ms": _time_ms(
            lambda: ra.roi_align_bwd_plain(dout, rois, levels, feats, scales, p, g), 2),
        "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
    }


def phase_roi_bwd(gen) -> dict:
    """RoIAlign backward (row 8) at the 224 px train step's shape (B=16,
    K=512, a fifth of the RoIs invalid), at the 1024 px step's (B=4, its
    pyramid), with the (14, 2) instantiation at 224 px and at the
    convergence recipe's training shape (B=8, K=128, C=64), against the
    plain version on the same bf16 dout. The kernel sums each dF element
    in a fixed order, so a second run must give the same bits."""
    entry = {
        "name": "roi_align_bwd", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/roi_align.cu",
        "replaces": "layoutdit_tpu/ops/roi_align_pallas.py:67",
        **_roi_bwd_case(gen, 224, 16),
        "library_ms": None,
    }
    entry.update({f"b1024_{k}": v for k, v in _roi_bwd_case(gen, 1024, 4).items()})
    torch.cuda.empty_cache()
    entry.update({f"p14_{k}": v for k, v in _roi_bwd_case(gen, 224, 16, p=14).items()})
    entry.update({f"recipe_{k}": v for k, v in _roi_bwd_case(
        gen, RECIPE["image"], RECIPE["batch"], k=RECIPE["train_rois"],
        c=RECIPE["channels"]).items()})
    entry.update({f"micro_{k}": v for k, v in _roi_bwd_case(gen, 224, MICRO_BATCH).items()})
    torch.cuda.empty_cache()
    return entry


def _probe_work(k: int, c: int, h: int, w: int) -> dict:
    """(bytes, operations) of the probes' functions at K RoIs: each input
    read once (f, and the weights as the bf16 the kernels read), each
    output written once; the dense products as the function defines them
    (the first [K * 7, H] x [H, C * W], the second per RoI [7, W] x
    [W, 7 * C])."""
    p = 7
    ins = (c * h * w + k * p * h + k * p * w) * 2
    first = 2 * k * p * c * h * w
    second = 2 * k * p * p * c * w
    return {"fused": (ins + k * p * p * c * 2, first + second),
            "first": (ins - k * p * w * 2 + k * p * w * c * 2, first)}


def phase_probes(gen, kernels: list[dict]) -> list[dict]:
    """The fused RoIAlign probes (rows 9-11), then their path.

    On the probe's inputs at K = 8192 (``probe_inputs``: 0/1 weights) each
    kernel against its plain version, timed beside its bound, its plain
    version and the yardstick (``two_gemm``: two cuBLAS calls, which the
    port never takes; for row 10, which stops at t, its one matrix
    product). Row 9 on real RoIs: one 224 px pyramid with 8192 RoIs
    through ``roi_atlas`` (timed apart) into ``variant_a`` (kb 16),
    against row 7's ``multiscale_roi_align`` on the same pyramid and
    RoIs. The atlas form's forward and custom backward
    (``pooled_from_weights_native``, two matrix products each) at rows
    7-8's 224 px train shapes (B = 16, K = 512), against rows 7-8. Last,
    the probe path: the probe tool, ``tools/probe_roi_fused.main``, with the
    counts set to 0 just before it."""
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import roi_fused as rf
    from layoutdit_tpu_torch.tools import probe_roi_fused as tool

    k = PROBE_K
    f, wy, wx = tool.probe_inputs(k, "cuda")
    c, h, w = f.shape
    shape = f"K={k} P=7 C={c} atlas H={h} W={w} bf16, the probe's 0/1 weights"
    work = _probe_work(k, c, h, w)
    two_gemm_ms = _time_ms(lambda: rf.two_gemm(f, wy, wx), PROBE_ITERS)
    ref = rf.two_gemm(f, wy, wx)
    plain = rf.variant_a_plain(f, wy, wx)
    print(f"  two_gemm (yardstick) {two_gemm_ms:.4f} ms")

    def fused(name, fn, plain_fn, line, kbs):
        """Rows 9 and 11, each kb against row 9's plain version (row 11's
        is that, laid out as its kernel writes it)."""
        bound, by = _bound_ms(*work["fused"])
        entry = {"name": name, "route": "cuda", "source": "layoutdit_tpu_torch/csrc/roi_fused.cu",
                 "replaces": f"scripts/probe_roi_fused.py:{line}", "shape": f"{shape}, kb={kbs[0]}",
                 "bound_ms": bound, "bound_by": by,
                 "plain_ms": _time_ms(lambda: plain_fn(f, wy, wx), 2),
                 "library_ms": two_gemm_ms,
                 "library": "two_gemm: two cuBLAS calls, not one PyTorch call"}
        for kb in kbs:
            got = fn(f, wy, wx, kb=kb)
            err, tol = _check_close(f"{name} kb={kb}", got, plain)
            yard = (got.float() - ref.float()).abs().max().item()
            print(f"    against two_gemm: max_abs_diff {yard:.6g}")
            del got
            key = "" if kb == kbs[0] else f"kb{kb}_"
            entry.update({f"{key}max_abs_err": err, f"{key}tolerance": tol,
                          f"{key}two_gemm_max_abs_diff": yard,
                          f"{key}ms": _time_ms(lambda: fn(f, wy, wx, kb=kb), PROBE_ITERS)})
        return entry

    a = fused("roi_fused_a", rf.variant_a, rf.variant_a_plain, 101, (8, 16))
    e = fused("roi_fused_e", rf.variant_e, lambda *x: rf.variant_e_plain(*x, kb=8), 187, (8,))
    e["kernel_only_ms"] = _time_ms(lambda: rf.variant_e(f, wy, wx, kb=8, kernel_layout=True),
                                   PROBE_ITERS)
    del ref, plain

    bound, by = _bound_ms(*work["first"])
    wy2 = wy.to(torch.bfloat16).reshape(k * 7, h)
    f2 = f.permute(1, 2, 0).reshape(h, w * c)
    a0 = {"name": "roi_fused_a0", "route": "cuda", "source": "layoutdit_tpu_torch/csrc/roi_fused.cu",
          "replaces": "scripts/probe_roi_fused.py:150", "shape": f"{shape}, kb=16",
          "bound_ms": bound, "bound_by": by,
          "library_ms": _time_ms(lambda: torch.matmul(wy2, f2), PROBE_ITERS),
          "library": "torch.matmul [K*7, H] x [H, W*C]: rows (k, py, w), no relayout"}
    del wy2, f2
    for relayout in (False, True):
        want = rf.variant_a0_plain(f, wy, relayout)
        err, tol = _check_close(f"roi_fused_a0 kb=16 relayout={relayout}",
                                rf.variant_a0(f, wy, kb=16, relayout=relayout), want)
        del want
        key = "relayout_" if relayout else ""
        a0.update({f"{key}max_abs_err": err, f"{key}tolerance": tol,
                   f"{key}ms": _time_ms(lambda: rf.variant_a0(f, wy, kb=16, relayout=relayout),
                                        PROBE_ITERS)})
    a0["plain_ms"] = _time_ms(lambda: rf.variant_a0_plain(f, wy, False), 2)
    del f, wy, wx
    torch.cuda.empty_cache()

    # row 9 on real RoIs against row 7
    scales = ROI_SCALES
    feats, rois, mask = _roi_inputs(gen, 224, b=1, k=k)
    with torch.no_grad():
        atlas = lambda: ra.roi_atlas(feats, rois, scales, roi_mask=mask)  # noqa: E731
        f_cat, wy_cat, wx_cat = (t[0] for t in atlas())
        row7 = lambda: ra.multiscale_roi_align(feats, rois, scales, roi_mask=mask,  # noqa: E731
                                               native_layout=True)
        err, tol = _check_close("roi_fused_a kb=16 on real RoIs against roi_align (row 7)",
                                rf.variant_a(f_cat, wy_cat, wx_cat, kb=16), row7()[0])
        a.update({
            "real_rois_shape": f"one 224 px pyramid (C=256, atlas H={f_cat.shape[1]} "
                               f"W={f_cat.shape[2]}), K={k} RoIs, a fifth masked, kb=16",
            "real_rois_max_abs_err": err, "real_rois_tolerance": tol,
            "real_rois_ms": _time_ms(lambda: rf.variant_a(f_cat, wy_cat, wx_cat, kb=16),
                                     PROBE_ITERS),
            "real_rois_atlas_ms": _time_ms(atlas, 5),
            "real_rois_roi_align_ms": _time_ms(row7, PROBE_ITERS),
            "real_rois_two_gemm_ms": _time_ms(lambda: rf.two_gemm(f_cat, wy_cat, wx_cat),
                                              PROBE_ITERS),
        })
        print(f"  real RoIs: roi_fused_a {a['real_rois_ms']:.4f} ms (atlas and weights "
              f"{a['real_rois_atlas_ms']:.4f}), roi_align (row 7) "
              f"{a['real_rois_roi_align_ms']:.4f}, two_gemm {a['real_rois_two_gemm_ms']:.4f}")
    del feats, rois, mask, f_cat, wy_cat, wx_cat
    torch.cuda.empty_cache()

    # the atlas form at rows 7-8's 224 px train shapes, against them
    feats, rois, mask = _roi_inputs(gen, 224, b=16, k=512)
    levels = ra.roi_levels(rois, 5, 224.0, roi_mask=mask)
    f_cat, wy_cat, wx_cat = ra.roi_atlas(feats, rois, scales, roi_mask=mask)
    fwd = lambda: ra.pooled_from_weights_native(f_cat, wy_cat, wx_cat)  # noqa: E731
    with torch.no_grad():
        err, tol = _check_close("atlas two-GEMM forward B=16 K=512 against roi_align (row 7)",
                                fwd(), ra.roi_align_fwd(feats, rois, levels, scales))
    dout = torch.randn(16, 512, 7, 7, 256, generator=gen, device="cuda").to(torch.bfloat16)
    bwd = lambda: ra._pooled_native_bwd(dout, wy_cat, wx_cat, f_cat.shape,  # noqa: E731
                                        f_cat.dtype)
    df, off, errs = bwd(), 0, []
    for i, g in enumerate(ra.roi_align_bwd(dout, rois, levels, feats, scales)):
        hl, wl = g.shape[-2:]
        errs.append(_check_close(f"atlas two-GEMM backward level {i} against roi_align_bwd "
                                 "(row 8)", df[..., off:off + hl, :wl], g))
        off += hl
    del df
    note = "atlas two-GEMM (pooled_from_weights_native): two calls; not one PyTorch call"
    for entry, fn, (e_, t_) in ((_entry(kernels, "roi_align"), fwd, (err, tol)),
                                (_entry(kernels, "roi_align_bwd"), bwd, max(errs))):
        entry.update({"b224_atlas_two_gemm_ms": _time_ms(fn, 10), "atlas_two_gemm": note,
                      "b224_atlas_two_gemm_max_abs_diff": e_})
    del feats, rois, mask, levels, f_cat, wy_cat, wx_cat, dout
    torch.cuda.empty_cache()

    # the probe path: the probe tool, as a user runs it
    _reset_counts()
    tool.main(["--k", str(k), "--iters", str(PROBE_ITERS)])
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  launches on the probe path: {counts}")
    entries = [a, a0, e]
    for entry in kernels + entries:
        entry["probe_launches"] = counts[entry["name"]]
    for entry in entries:
        if entry["probe_launches"] <= 0:
            raise RuntimeError(f"{entry['name']} was not launched on the probe path")
    return entries


def _entry(kernels: list[dict], name: str) -> dict:
    return next(k for k in kernels if k["name"] == name)


def _counters():
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import roi_fused as rf
    from layoutdit_tpu_torch.ops import short_attention as sa

    return {
        "short_attention": sa.short_attention,
        "short_attention_bwd": sa.short_attention_bwd,
        "flash_attention": fa.flash_attention_fwd,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
        "flash_attention_bwd_dbias": fa.flash_attention_bwd_dbias,
        "roi_align": ra.roi_align_fwd,
        "roi_align_bwd": ra.roi_align_bwd,
        "roi_fused_a": rf.variant_a,
        "roi_fused_a0": rf.variant_a0,
        "roi_fused_e": rf.variant_e,
    }


def _counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _reset_counts() -> None:
    from layoutdit_tpu_torch.ops import nms

    for fn in _counters().values():
        fn.launches = 0
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
    from layoutdit_tpu_torch.models.detection.detector import _normalize
    from layoutdit_tpu_torch.models.vit import vit_forward
    from layoutdit_tpu_torch.models.weights_io import tree_map

    cfg = model.cfg
    vit_cpu = tree_map(lambda t: t.cpu(), model.params["backbone"]["vit"])
    for size, img in images.items():
        x = _normalize(img[None].cpu(), cfg)
        with torch.inference_mode():
            got = vit_forward(model.params["backbone"]["vit"], x.cuda().to(torch.bfloat16),
                              cfg.backbone.vit, cfg.backbone.taps, torch.bfloat16)
            want = vit_forward(vit_cpu, x, cfg.backbone.vit, cfg.backbone.taps, torch.float32)
        for tap, gt, wt in zip(cfg.backbone.taps, got, want):
            rel = _rel_err(gt, wt)
            print(f"  encoder {size} px tap {tap}: relative error {rel:.4g} "
                  f"(tolerance {ENCODER_REL_TOL})")
            if not rel <= ENCODER_REL_TOL:
                raise RuntimeError("encoder on the card disagrees with the CPU reference")


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float().cpu() - want.float()).norm() / want.float().norm()).item()


def _gradient_reference(backbone_params: dict, cfg, images: torch.Tensor) -> dict:
    """Encoder + FPN gradients under a fixed cotangent on the FPN outputs
    (no sampling involved): bf16 with the kernels on the card against
    float32 plain versions on the CPU, same weights, for the patch
    embedding, layer 1's qkv, the first global layer's qkv when windows
    are on (layer 1 is then windowed), the last layer's mlp_out, and the
    relative-position tables of the same layers where the encoder has
    them."""
    from layoutdit_tpu_torch.models.backbone import backbone_forward
    from layoutdit_tpu_torch.models.detection.detector import _normalize
    from layoutdit_tpu_torch.models.weights_io import tree_map

    vit_cfg = cfg.backbone.vit
    layers = [1]
    if vit_cfg.window_size > 0:
        layers.append(next(i for i in range(1, vit_cfg.num_hidden_layers + 1)
                           if vit_cfg.is_global_layer(i)))
    tables = layers if vit_cfg.use_relative_position_bias else []
    names = (["patch_embed"] + [f"layer {i} qkv" for i in layers]
             + [f"layer {vit_cfg.num_hidden_layers} mlp_out"]
             + [f"layer {i} rel_pos_table" for i in tables])

    def grads(p, x, dtype, cots):
        vit = p["vit"]
        wanted = ([vit["patch_embed"]["weight"]]
                  + [vit["layers"][i - 1]["qkv"]["weight"] for i in layers]
                  + [vit["layers"][-1]["mlp_out"]["weight"]]
                  + [vit["layers"][i - 1]["rel_pos_table"] for i in tables])
        feats = backbone_forward(p, x.to(dtype), cfg.backbone, compute_dtype=dtype)
        total = sum((f.float() * c).sum() for f, c in zip(feats, cots))
        return torch.autograd.grad(total, wanted)

    x = _normalize(images.float(), cfg)
    gen = torch.Generator().manual_seed(1)
    c = cfg.backbone.fpn_out_channels
    # bf16-representable, so both sides see the same cotangent
    cots = [torch.randn((x.shape[0], c, h, w), generator=gen).to(torch.bfloat16).float()
            for h, w in cfg.grid_sizes]
    got = grads(tree_map(lambda t: t.detach().clone().requires_grad_(True), backbone_params),
                x, torch.bfloat16, [t.cuda() for t in cots])
    want = grads(tree_map(lambda t: t.detach().cpu().requires_grad_(True), backbone_params),
                 x.cpu(), torch.float32, cots)
    out = {}
    for name, g, w in zip(names, got, want):
        rel = _rel_err(g, w)
        print(f"  gradient of {name}: relative error {rel:.4g} (tolerance {GRAD_REL_TOL})")
        if not rel <= GRAD_REL_TOL:
            raise RuntimeError(f"gradient of {name} on the card disagrees with the CPU reference")
        out[name] = rel
    return out


def _launches_per_step(cfg) -> dict:
    """Kernel launches one train step makes, from the config: per encoder
    layer one short or one flash attention (N = grid^2 + 1 tokens), or,
    in a windowed layer, two attentions (the windows and the CLS token),
    each with its backward; one RoIAlign forward and backward. Without a
    relative-position bias the short kernels take N <= 256 (windows
    included) and the flash kernels longer sequences; with one, every
    attention but the CLS token's carries a bias and goes to the flash
    kernels, whose backward then adds the dbias kernel."""
    from layoutdit_tpu_torch.ops.short_attention import MAX_N as SHORT_MAX_N

    vit = cfg.backbone.vit
    g = cfg.image_size // vit.patch_size
    windowed = sum(0 < vit.window_size < g and not vit.is_global_layer(i)
                   for i in range(1, vit.num_hidden_layers + 1))
    full = vit.num_hidden_layers - windowed
    if vit.use_relative_position_bias or vit.use_shared_relative_position_bias:
        flash = dbias = full + windowed
        short = windowed
    else:
        flash, dbias = (full if g * g + 1 > SHORT_MAX_N else 0), 0
        short = full - flash + 2 * windowed
        if windowed and vit.window_size ** 2 > SHORT_MAX_N:
            raise RuntimeError("a window is longer than the short kernel takes")
    return {"short_attention": short, "short_attention_bwd": short, "flash_attention": flash,
            "flash_attention_bwd_dq": flash, "flash_attention_bwd_dkdv": flash,
            "flash_attention_bwd_dbias": dbias, "roi_align": 1, "roi_align_bwd": 1,
            **{name: 0 for name in PROBE_KERNELS}}


def _train_run(label: str, base, kernels: list[dict], grad_images: int,
               check_taps: bool, table_std: float = 0.0, profile_stages: bool = False) -> dict:
    """A training config at full width (bf16 over fp32 masters, random
    weights from seed 0; relative-position tables, which initialise to
    zero, drawn with std ``table_std`` from seed 1) through
    ``Trainer(config, model).train()`` for one epoch over synthetic pages
    at its image size in a temp dir, then ``TRAIN_REPEATS`` steps on one
    repeated batch (timed, losses finite and falling), launch counts per
    step as the config implies, and the encoder's gradients (and, with
    ``check_taps``, its taps) against a float32 CPU reference; with
    ``profile_stages``, one more step under the profiler, whose backbone
    and rpn stage times are printed."""
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture
    from layoutdit_tpu_torch.tools.profile_train import profile_step
    from layoutdit_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        rc = dataclasses.replace(
            base,
            train=dataclasses.replace(base.train, train_base_path=tmp, train_input="samples",
                                      num_epochs=1, checkpoint_interval=1),
            run_name="chip_smoke", eval_base_path=tmp,
        )
        b = rc.data.batch_size
        make_fixture(tmp, n_images=TRAIN_EPOCH_STEPS * b, split="samples", seed=0,
                     image_size=rc.model.image_size)
        cfg = DetectorConfig.from_model_config(rc.model, precision_dtype=rc.compute_dtype)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_detector(cfg, gen, device="cuda")
        if table_std:  # so that the bias shapes every softmax
            tgen = torch.Generator(device="cuda").manual_seed(1)
            for layer in params["backbone"]["vit"]["layers"]:
                t = layer["rel_pos_table"]
                t.copy_(table_std * torch.randn(t.shape, generator=tgen, device="cuda"))
        model = DetectorModel(params, cfg)
        trainer = Trainer(rc, model)
        vit = cfg.backbone.vit
        windows = (f", {vit.window_size} x {vit.window_size} windows, global layers "
                   f"{[i for i in range(1, vit.num_hidden_layers + 1) if vit.is_global_layer(i)]}"
                   if vit.window_size else "")
        if vit.use_relative_position_bias:
            shape = list(params["backbone"]["vit"]["layers"][0]["rel_pos_table"].shape)
            windows += (f", a relative-position table {shape} per layer (std {table_std}), "
                        f"absolute position embeddings "
                        f"{'on' if vit.use_absolute_position_embeddings else 'off'}")
        print(f"  dit-base Faster R-CNN, hidden {vit.hidden_size}, {vit.num_hidden_layers} "
              f"layers, {vit.num_attention_heads} heads, MLP {vit.intermediate_size}, image "
              f"{cfg.image_size} px, batch {b}, {rc.compute_dtype} over fp32 parameters, "
              f"pre/post-NMS {cfg.budget.rpn_pre_nms_top_n_train}/"
              f"{cfg.budget.rpn_post_nms_top_n_train}{windows}")
        per_step = _launches_per_step(cfg)

        # the main path: the trainer's own epoch loop
        _reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts, steps = _counts(), trainer.updates
        epoch_syncs = nms.nms_mask.host_syncs
        print(f"  Trainer.train(): {steps} steps in {epoch_s:.3f} s (first steps include "
              f"cuBLAS/cuDNN set-up), loss {trainer.loss_history}, launches {counts}, "
              f"NMS host syncs {epoch_syncs}")
        for name, want in per_step.items():
            if counts[name] != want * steps:
                raise RuntimeError(f"{label}: {name} launched {counts[name]} times in {steps} "
                                   f"steps, expected {want} a step")
        for k in kernels:
            k[f"{label}_launches"] = counts[k["name"]]
        ckpt = Path(trainer.checkpoint_path(1))
        metrics = Path(rc.artifact_dir) / "metrics" / "metrics.jsonl"
        if not (ckpt.is_file() and metrics.is_file() and np.isfinite(trainer.loss_history).all()):
            raise RuntimeError(f"{label}: no checkpoint, no metrics or a non-finite epoch loss")

        # one repeated batch: timing, finite losses, the overfit check
        it = iter(trainer.dataloader)
        batch = next(it)
        it.close()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times, history = [], []
        for _ in range(TRAIN_REPEATS):
            t0 = time.perf_counter()
            loss, parts = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            history.append({"loss": float(loss), **{k: float(v) for k, v in parts.items()}})
        peak = torch.cuda.max_memory_allocated()
        counts = _counts()
        syncs = nms.nms_mask.host_syncs / TRAIN_REPEATS
        for name, want in per_step.items():
            if counts[name] != want * TRAIN_REPEATS:
                raise RuntimeError(f"{label}: {name} launched {counts[name]} times in "
                                   f"{TRAIN_REPEATS} steps, expected {want} a step")
        if not all(np.isfinite(list(h.values())).all() for h in history):
            raise RuntimeError(f"{label}: a non-finite loss: {history}")
        first, last = history[0]["loss"], np.mean([h["loss"] for h in history[-3:]])
        print(f"  repeated batch, {TRAIN_REPEATS} steps: loss {first:.4f} -> {last:.4f} "
              f"(mean of the last 3; must fall by {TRAIN_MIN_DROP:.0%})")
        for h in (history[0], history[-1]):
            print("    " + ", ".join(f"{k} {v:.4f}" for k, v in h.items()))
        if not last <= (1 - TRAIN_MIN_DROP) * first:
            raise RuntimeError(f"{label}: the loss did not fall on a repeated batch")
        timed = sorted(times[TRAIN_WARMUP:])
        med = float(np.median(timed))
        print(f"  step time median {med * 1e3:.3f} ms (min {timed[0] * 1e3:.3f}, max "
              f"{timed[-1] * 1e3:.3f}, {len(timed)} steps), {b / med:.2f} images/s, peak "
              f"memory {peak / 2**30:.3f} GiB, NMS host syncs {syncs:.1f} a step")

        if check_taps:
            _encoder_reference(DetectorModel(trainer.params, cfg),
                               {cfg.image_size: batch.images[0]})
        grads = _gradient_reference(trainer.params["backbone"], cfg, batch.images[:grad_images])
        stages = None
        if profile_stages:
            r = profile_step(trainer, 1, Path(tmp) / "train_step.json")
            stages = _print_stages(f"{label} step, {b} images", r)
    return {
        "stages": stages,
        "epoch_steps": steps, "epoch_s": epoch_s, "epoch_loss": trainer.loss_history,
        "step_ms": [t * 1e3 for t in times], "median_step_ms": med * 1e3,
        "images_per_s": b / med, "peak_memory_bytes": peak,
        "nms_host_syncs_per_step": syncs, "loss_first": first, "loss_last3_mean": last,
        "losses": history, "launches_per_step": per_step, "gradient_rel_err": grads,
    }


def phase_train(kernels: list[dict]) -> dict:
    """The port's default training config: dit-base at 224 px, batch 16
    (``_train_run``; gradients checked on two images)."""
    from layoutdit_tpu_torch.config import RunConfig

    out = _train_run("train", RunConfig(), kernels, grad_images=2, check_taps=False,
                     profile_stages=True)
    return {"config": "default RunConfig: dit-base, 224 px, batch 16, bf16 over fp32", **out}


def phase_train_1024(kernels: list[dict]) -> dict:
    """The JAX package's high-res train config, ``train_1024_window.json``:
    dit-base at 1024 px, batch 4, 16 x 16 windows in 8 layers (short
    kernels over 256-token windows and the 1-token CLS), full attention
    over 4097 tokens in the 4 global layers (flash forward and backward
    kernels); taps and gradients checked on one image."""
    from layoutdit_tpu_torch.config import load_run_config

    out = _train_run("train_1024", load_run_config(str(TRAIN_1024_CONFIG)), kernels,
                     grad_images=1, check_taps=True)
    return {"config": "configs/train_1024_window.json: dit-base, 1024 px, batch 4, window 16, "
                      "bf16 over fp32", **out}


def _table_gradient(vit, device="cuda") -> dict:
    """The gradient of a relative-position table, the backward of its
    gather: one layer's fp32 [H, N, N] dbias summed into the [entries, H]
    table per offset, at the global layers' index (N = 4097 at 1024 px)
    and at a window's (N = 256). The port's backward (``_rel_table_grad``:
    sums over diagonal bands) must give the same bits twice and agree with
    the scatter it was chosen over, timed beside it: autograd's backward
    of the plain gather, ``index_put_`` with ``accumulate=True``."""
    from layoutdit_tpu_torch.models.vit import _gather_rel_bias, _rel_index, _rel_pos_num_entries

    gen = torch.Generator(device=device).manual_seed(2)
    h, g = vit.num_attention_heads, vit.grid_size
    out = {}
    for key, ws in (("global", 0), ("window", vit.window_size)):
        idx = _rel_index(torch.device(device), g, ws)
        table = torch.zeros(_rel_pos_num_entries(vit), h, device=device, requires_grad=True)
        bias = _gather_rel_bias(table, g, ws)
        plain = table.t()[:, idx]
        dbias = torch.randn(bias.shape, generator=gen, device=device)

        def port():
            return torch.autograd.grad(bias, table, dbias, retain_graph=True)[0]

        def sorted_add():
            return torch.autograd.grad(plain, table, dbias, retain_graph=True)[0]

        first = port()
        if not torch.equal(first, port()):
            raise RuntimeError("table gradient: two runs gave different bits")
        diff = (sorted_add() - first).abs().max().item()
        if not diff <= 1e-4 * first.abs().max().item():
            raise RuntimeError(f"table gradient: index_put_ differs by {diff}")
        n = bias.shape[-1]
        bound, by = _bound_ms(h * n * n * 4 + first.numel() * 4, 0.0)
        out[key] = {
            "shape": f"dbias [{h}, {n}, {n}] fp32 -> table {list(table.shape)}",
            "ms": _time_ms(port, 5),
            "index_put_accumulate_ms": _time_ms(sorted_add, 3),
            "index_put_max_abs_diff": diff,
            "bound_ms": bound, "bound_by": by,
        }
        print(f"  table gradient {key} N={n}: diagonal sums {out[key]['ms']:.4f} ms, index_put_ "
              f"(sorted) {out[key]['index_put_accumulate_ms']:.4f} ms (max diff {diff:.6g}), "
              f"bound {bound:.4f} ms")
        del bias, plain, dbias
        torch.cuda.empty_cache()
    return out


def phase_train_1024_relpos(kernels: list[dict]) -> dict:
    """``train_1024_window_relpos.json``: the windowed 1024 px config with
    a BEiT relative-position table per layer and no absolute position
    embeddings. The tables start from std 0.5 (not zero), so the bias
    shapes every softmax; every attention but the CLS token's goes to the
    flash kernels with its [12, N, N] bias (the global layers over 4097
    tokens, the windows at B=64 N=256) and back through the dbias kernel;
    taps and gradients (two layers' tables included) checked on one
    image; the table gradient timed against autograd's scatter."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig

    rc = load_run_config(str(RELPOS_CONFIG))
    out = _train_run("train_1024_relpos", rc, kernels, grad_images=1, check_taps=True,
                     table_std=0.5)
    vit = DetectorConfig.from_model_config(rc.model, rc.compute_dtype).backbone.vit
    return {"config": "configs/train_1024_window_relpos.json: BEiT-base layout (dit-base widths, "
                      "a relative-position table per layer, no absolute position embeddings), "
                      "1024 px, batch 4, window 16, bf16 over fp32", **out,
            "table_gradient": _table_gradient(vit)}


# main phase: the port's command line over make_fixture pages, a training
# split and a held-out eval split of these sizes and seeds
MAIN_TRAIN_PAGES = 32
MAIN_VAL_PAGES = 16
MAIN_KERNELS = ("short_attention", "short_attention_bwd", "roi_align", "roi_align_bwd")
# the main phase's throughput windows: a split of this many pages (seed
# 778) trained on for THROUGHPUT_EPOCHS epochs (the first not counted)
# and scored THROUGHPUT_SCORES times, then once more under the profiler
THROUGHPUT_PAGES = 256
THROUGHPUT_EPOCHS = 4
THROUGHPUT_SCORES = 3


def _spread(values: list[float]) -> dict:
    return {"median": float(np.median(values)), "min": min(values), "max": max(values),
            "n": len(values)}


def _throughput(tmp: str, rc) -> dict:
    """Train images/s and eval pages/s of the main phase's config over
    THROUGHPUT_PAGES pages, each as median, min and max: the trainer's
    own per-epoch images/s (the epochs after the first; loader waits
    included) and the wall time of ``Evaluator.score()`` over the whole
    split (COCOeval included); then the device's busy time and idle share
    over one more ``score()`` traced by the profiler (``summarize_trace``;
    the profiler's own host cost inflates the idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture
    from layoutdit_tpu_torch.tools.profile_serving import summarize_trace
    from layoutdit_tpu_torch.train.trainer import Trainer

    make_fixture(tmp, n_images=THROUGHPUT_PAGES, split="window", seed=778)
    wc = dataclasses.replace(
        rc, run_name="throughput", eval_input="window",
        train=dataclasses.replace(rc.train, train_input="window", num_epochs=THROUGHPUT_EPOCHS,
                                  eval_interval=0, checkpoint_interval=THROUGHPUT_EPOCHS + 1))
    model = build_model(wc, device="cuda")
    trainer = Trainer(wc, model)
    trainer.train()
    train_ips = [r["images_per_sec"] for r in trainer.metrics_history]
    evaluator = Evaluator(model, wc)
    score_s = []
    for _ in range(THROUGHPUT_SCORES):
        t0 = time.perf_counter()
        evaluator.score()
        torch.cuda.synchronize()
        score_s.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluator.score()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    trace = Path(tmp) / "score_trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        summary = summarize_trace(json.load(f))
    out = {
        "pages": THROUGHPUT_PAGES, "train_steps_per_epoch": len(trainer.dataloader),
        "train_epoch_images_per_s": _spread(train_ips[1:]), "train_images_per_s_by_epoch": train_ips,
        "score_s": _spread(score_s), "eval_pages_per_s": _spread(
            [THROUGHPUT_PAGES / t for t in score_s]),
        "traced_score": {"wall_s": traced_s, "span_ms": summary["span_ms"],
                         "device_busy_ms": summary["device_busy_ms"],
                         "device_idle_share": summary["device_idle_share"],
                         "stages": summary["stages"]},
    }
    ips, pps = out["train_epoch_images_per_s"], out["eval_pages_per_s"]
    print(f"  throughput over {THROUGHPUT_PAGES} pages: train {ips['median']:.2f} images/s "
          f"(median of epochs 2-{THROUGHPUT_EPOCHS}, min {ips['min']:.2f}, max "
          f"{ips['max']:.2f}; by epoch {train_ips}); score() {pps['median']:.2f} pages/s "
          f"(median of {THROUGHPUT_SCORES}, min {pps['min']:.2f}, max {pps['max']:.2f})")
    print(f"  one score() traced: {traced_s:.3f} s wall, device busy "
          f"{summary['device_busy_ms']:.1f} ms of {summary['span_ms']:.1f} ms, idle share "
          f"{summary['device_idle_share']:.4f}; " + ", ".join(
              f"{n} device {st.get('device_ms', 0.0):.1f} ms / host {st.get('host_ms', 0.0):.1f} "
              f"ms" for n, st in summary["stages"].items()))
    return out


def phase_main(kernels: list[dict], card: str) -> dict:
    """``python -m layoutdit_tpu_torch.main`` in this process at the
    default config (dit-base, 224 px, batch 16, bf16, random weights from
    seed 0): one epoch over 32 pages with a mid-training eval and a
    checkpoint, then the final COCO score of 16 held-out pages and both
    overlays. Checks the logged metrics, ``predictions.json``,
    ``epoch_1.pt`` and ``best.pt`` (which must load, and whose recorded
    mAP ``metrics.jsonl`` must show), the overlays, and that the run
    launched the short-attention and RoIAlign pairs and no other kernel;
    then scores ``best.pt`` again with a new ``build_model`` and
    ``Evaluator``, which must give the mAP it records."""
    import logging
    import os

    from PIL import Image

    from layoutdit_tpu_torch import main as port_main
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.eval.coco_eval import COCO_KEYS
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.tools.make_fixture import (
        CATEGORIES,
        make_fixture,
        write_fixture_config,
    )
    from layoutdit_tpu_torch.train.checkpoint import load_checkpoint

    logged = []

    class FinalMetrics(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Final metrics"):
                logged.append(record.args)

    handler = FinalMetrics()
    log_root = logging.getLogger("layoutdit_tpu_torch")
    with tempfile.TemporaryDirectory() as tmp:
        make_fixture(tmp, n_images=MAIN_TRAIN_PAGES, split="samples", seed=0)
        make_fixture(tmp, n_images=MAIN_VAL_PAGES, split="val", seed=777)
        cfg_path = write_fixture_config(tmp, split="samples", epochs=1, batch_size=16)
        with open(cfg_path) as f:
            raw = json.load(f)
        raw["local_mode"] = False
        raw["eval_config"]["eval_input"] = "val"
        raw["train_config"].update(eval_interval=1, checkpoint_interval=1)
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        rc = load_run_config(cfg_path)
        print(f"  port main, default model config (dit-base, {rc.model.image_size} px), batch "
              f"{rc.data.batch_size}, {rc.compute_dtype}; {MAIN_TRAIN_PAGES} training pages "
              f"(seed 0), {MAIN_VAL_PAGES} held-out pages (seed 777), 1 epoch, eval_interval 1")

        saved_env = os.environ.get("LAYOUTDIT_CONFIG")
        os.environ["LAYOUTDIT_CONFIG"] = cfg_path
        log_root.addHandler(handler)
        try:
            _reset_counts()
            t0 = time.perf_counter()
            port_main.main([])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            counts = _counts()
        finally:
            log_root.removeHandler(handler)
            if saved_env is None:
                os.environ.pop("LAYOUTDIT_CONFIG")
            else:
                os.environ["LAYOUTDIT_CONFIG"] = saved_env
        print(f"  main: {main_s:.3f} s, launches {counts}")
        for name, n in counts.items():
            if (n > 0) != (name in MAIN_KERNELS):
                raise RuntimeError(f"main: {name} launched {n} times")
        for k in kernels:
            k["main_launches"] = counts[k["name"]]

        if len(logged) != 1:
            raise RuntimeError(f"main: {len(logged)} 'Final metrics' records logged")
        metrics = logged[0]
        wanted = list(COCO_KEYS) + [f"AP50-{c['name']}" for c in CATEGORIES]
        if not all(k in metrics and math.isfinite(metrics[k]) and -1 <= metrics[k] <= 1
                   for k in wanted):
            raise RuntimeError(f"main: metrics missing or out of range: {metrics}")
        print("  final metrics: " + ", ".join(f"{k} {metrics[k]:.4f}" for k in wanted))

        run = Path(rc.artifact_dir)
        with open(run / "predictions.json") as f:
            preds = json.load(f)
        if not preds:
            raise RuntimeError("main: predictions.json is empty")
        ckpts = run / "model_checkpoints"
        with open(run / "metrics" / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        best = load_checkpoint(ckpts / "best.pt", map_location="cpu")
        if not (len(records) == 1 and records[0]["mAP"] == best["extra"]["mAP"]
                and records[0]["mAP"] == metrics["mAP"]):
            raise RuntimeError(f"main: best.pt records mAP {best['extra']['mAP']}, "
                               f"metrics.jsonl {records}, final {metrics['mAP']}")
        build_model(rc, device="cuda").restore_checkpoint(str(ckpts / "epoch_1.pt"))

        num_images = rc.eval.num_images
        with open(Path(tmp) / "val.json") as f:
            gt_pages = {a["image_id"] for a in json.load(f)["annotations"]}
        for kind, pages in (("preds", {p["image_id"] for p in preds}), ("gt", gt_pages)):
            out_dir = run / f"{rc.eval.visualize_dirpath_prefix}_{kind}"
            jpegs = sorted(out_dir.glob("*.jpg"))
            if len(jpegs) != min(num_images, len(pages)):
                raise RuntimeError(f"main: {len(jpegs)} {kind} overlays, expected "
                                   f"{min(num_images, len(pages))}")
            for jpeg in jpegs:
                with Image.open(jpeg) as im:
                    im.load()
        print(f"  {len(preds)} predictions, epoch_1.pt and best.pt load, "
              f"{min(num_images, len(gt_pages))} overlays of each kind")

        # the same weights on the same pages: the same mAP
        model = build_model(rc, device="cuda")
        model.restore_checkpoint(str(ckpts / "best.pt"))
        evaluator = Evaluator(model, rc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = evaluator.score()
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        if again is None or again["mAP"] != best["extra"]["mAP"]:
            raise RuntimeError(f"main: best.pt scored again gives mAP "
                               f"{again and again['mAP']}, it records {best['extra']['mAP']}")
        print(f"  best.pt scored again: mAP {again['mAP']:.6f} (equal to its record); "
              f"score() {score_s:.3f} s for {MAIN_VAL_PAGES} pages")
        window = _throughput(tmp, rc)
    return {
        "card": card, "main_s": main_s, "rescore_s": score_s, "rescore_pages": MAIN_VAL_PAGES,
        "throughput": window, "metrics": metrics, "predictions": len(preds),
    }


def phase_convergence(kernels: list[dict], card: str) -> dict:
    """The JAX package's flagship convergence recipe through the port
    (``tools/convergence.py``: the tiny detector, 48 epochs on 128
    pages, scored on 32 held-out ones), in bf16 on the card, whose
    kernels take bf16 only (the JAX test runs float32 on the CPU). Holds
    it to the JAX test's floors and prints the curve: the loss per epoch
    and the mAP at epochs 16, 32 and 48."""
    from layoutdit_tpu_torch.tools import convergence

    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig

    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        result = convergence.run_recipe(tmp, "bfloat16", "cuda", eval_interval=16)
        counts = _counts()
        rc = load_run_config(str(Path(tmp) / "cfg.json"))
    cfg = DetectorConfig.from_model_config(rc.model, rc.compute_dtype)
    vit = cfg.backbone.vit
    shapes = {"batch": rc.data.batch_size, "image": cfg.image_size,
              "heads": vit.num_attention_heads,
              "head_dim": vit.hidden_size // vit.num_attention_heads,
              "channels": cfg.backbone.fpn_out_channels,
              "train_rois": cfg.budget.box_batch_size_per_image,
              "eval_rois": cfg.budget.rpn_post_nms_top_n_test}
    if shapes != RECIPE:
        raise RuntimeError(f"convergence: the recipe's shapes {shapes} are not the ones the "
                           f"kernels phases checked, {RECIPE}")
    for name, n in counts.items():
        if (n > 0) != (name in MAIN_KERNELS):
            raise RuntimeError(f"convergence: {name} launched {n} times")
    for k in kernels:
        k["convergence_launches"] = counts[k["name"]]
    m = result["metrics"]
    print(f"  {result['steps']} steps in {result['train_s']:.3f} s "
          f"({result['steps_per_s']:.3f} steps/s), score {result['score_s']:.3f} s")
    print("  loss per epoch: " + ", ".join(f"{x:.4f}" for x in result["loss"]))
    print(f"  mAP at epochs: {result['mAP_at_epoch']}")
    if m is not None:
        print(f"  held-out mAP {m['mAP']:.4f}, AP50 {m['AP50']:.4f}; " + ", ".join(
            f"AP50-{name} {m['AP50-' + name]:.4f}"
            for name in ("text", "title", "list", "table", "figure")))
    failures = convergence.floor_failures(result)
    if failures:
        raise RuntimeError(f"convergence: the recipe missed its floors: {failures}")
    return {"card": card, **result}


# train_state phase: the default config with the JAX trainer's run state
# turned on, over TRAIN_STATE_PAGES pages (4 updates an epoch at batch 16)
# and TRAIN_STATE_VAL_PAGES held-out ones; a run that sends itself SIGTERM
# in epoch TRAIN_STATE_PREEMPT[0], step TRAIN_STATE_PREEMPT[1], then
# resumes, must end with the uninterrupted run's bits
TRAIN_STATE = dict(ema_decay=0.999, grad_accumulation_steps=2, adam_mu_dtype="bfloat16",
                   skip_nonfinite_updates=3, steps_per_dispatch=2, keep_checkpoints=2,
                   async_checkpoint=True, tensorboard=True, checkpoint_interval=1,
                   eval_interval=1, num_epochs=3)
TRAIN_STATE_PAGES = 64
TRAIN_STATE_VAL_PAGES = 16
TRAIN_STATE_PREEMPT = (2, 2)
# steps timed at A = 1 and at A = 2 on one repeated batch (the first one
# not timed); steps run per variant for the peak memory
TRAIN_STATE_TIMED = 6
TRAIN_STATE_PEAK_STEPS = 2


class _OneBatch:
    """A loader of one epoch of one batch (the non-finite step's epoch)."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return iter([self.batch])

    def __len__(self):
        return 1

    def set_epoch(self, epoch):
        pass

    def skip_batches(self, n):
        pass

    def close(self):
        pass


def _run_state(trainer, ema: bool = True) -> list:
    """Parameters, EMA (with ``ema``), moments and counts of a trainer."""
    from layoutdit_tpu_torch.models.weights_io import tree_leaves

    st = trainer.opt_state
    return (tree_leaves(trainer.params) + (tree_leaves(trainer.ema_params) if ema else [])
            + st["mu"] + st["nu"] + [st["count"], st["schedule_count"]]
            + ([st["notfinite_count"], st["total_notfinite"]] if ema else []))


def _same_scalar(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def _train_state_checks(rc, kernels) -> dict:
    """On a trainer of its own: the peak memory of four variants, A = 2
    against A = 1 step times with the launches per update, the
    accumulated gradient against its micro-batches' (check 1), a
    non-finite step (check 2), and a save's blocking time, async and
    sync."""
    from layoutdit_tpu_torch.models.detection.detector import detector_loss, draw_priorities
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.train.checkpoint import AsyncCheckpointWriter, host_snapshot
    from layoutdit_tpu_torch.train.trainer import Trainer

    tc = rc.train
    model = build_model(rc, device="cuda", seed=1)
    first = Trainer(dataclasses.replace(rc, train=dataclasses.replace(tc, steps_per_dispatch=1)),
                    model)
    it = iter(first.dataloader)
    batch = next(it)
    it.close()
    first.dataloader.close()
    del first
    # peak memory of each variant over its first steps, then the step
    # times of the last two (the same global batch, A = 1 and A = 2)
    variants = {
        "A1_fp32_mu": dict(ema_decay=0.0, adam_mu_dtype="float32", grad_accumulation_steps=1),
        "A1_fp32_mu_ema": dict(adam_mu_dtype="float32", grad_accumulation_steps=1),
        "A1_bf16_mu_ema": dict(grad_accumulation_steps=1),
        "A2_bf16_mu_ema": {},
    }
    per_update = {name: 0 for name in _counters()}
    per_update.update(short_attention=24, short_attention_bwd=24, roi_align=2, roi_align_bwd=2)
    peaks, steps, trainer = {}, {}, None
    for name, changes in variants.items():
        del trainer
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(dataclasses.replace(rc, train=dataclasses.replace(tc, **changes)),
                          model)
        for _ in range(TRAIN_STATE_PEAK_STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        if not name.endswith("bf16_mu_ema"):
            continue
        times = []
        _reset_counts()
        for _ in range(TRAIN_STATE_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts, syncs = _counts(), nms.nms_mask.host_syncs / TRAIN_STATE_TIMED
        steps[name] = {**_spread(times[1:]), "nms_host_syncs_per_update": syncs}
        print(f"  {name}: step median {steps[name]['median']:.3f} ms (min "
              f"{steps[name]['min']:.3f}, max {steps[name]['max']:.3f}), NMS host syncs "
              f"{syncs:.1f} an update")
    for k, want in per_update.items():  # check 7, over the A = 2 updates
        if counts[k] != want * TRAIN_STATE_TIMED:
            raise RuntimeError(f"train_state: {k} launched {counts[k]} times in "
                               f"{TRAIN_STATE_TIMED} updates, expected {want} an update")
    print("  peak GiB: " + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items())
          + f"; launches an update at A = 2: {per_update}")

    # check 1: the accumulated gradient is the mean of the micro-batches'
    state = trainer.generator.get_state()
    micro = rc.data.batch_size // tc.grad_accumulation_steps
    alone = []
    for a in range(tc.grad_accumulation_steps):
        rows = slice(a * micro, (a + 1) * micro)
        pri = draw_priorities(trainer.cfg, micro, batch.gt_labels.shape[1], trainer.generator)
        losses = detector_loss(trainer.params, batch.images[rows], batch.gt_boxes[rows],
                               batch.gt_labels[rows], batch.gt_valid[rows], trainer.cfg, pri)
        grads = torch.autograd.grad(sum(losses.values()), trainer._leaves, allow_unused=True)
        alone.append([torch.zeros_like(t) if g is None else g
                      for g, t in zip(grads, trainer._leaves)])
    mean = [g0 + g1 for g0, g1 in zip(*alone)]
    torch._foreach_div_(mean, 2.0)
    for bias, k_slot in trainer._k_bias:
        mean[next(i for i, t in enumerate(trainer._leaves) if t is bias)][k_slot] = 0.0
    del alone
    trainer.generator.set_state(state)
    seen = {}

    def spy(opt_state, params, grads):
        seen["grads"] = [g.clone() for g in grads]

    real_update = trainer.optimizer.update
    trainer.optimizer.update = spy
    trainer.train_step(batch)
    trainer.optimizer.update = real_update
    differing = sum(not torch.equal(a, b) for a, b in zip(seen["grads"], mean))
    print(f"  check 1: the accumulated gradient against the mean of its 2 micro-batches' "
          f"computed alone: {differing} of {len(mean)} leaves differ (bit equality required)")
    if differing:
        raise RuntimeError("train_state: the accumulated gradient is not the micro-batches' mean")
    del seen, mean

    # check 2: a batch holding a NaN pixel moves no parameter, moment or
    # count (the EMA still decays toward the unchanged parameters)
    before = [t.clone() for t in _run_state(trainer, ema=False)]
    skipped_before = int(trainer.opt_state["total_notfinite"])
    bad = dataclasses.replace(batch, images=batch.images.clone())
    bad.images[0, 0, 0, 0] = float("nan")
    loader, trainer.dataloader = trainer.dataloader, _OneBatch(bad)
    trainer._run_epoch(0)
    trainer.dataloader = loader
    record = trainer.metrics_history[-1]
    unchanged = sum(torch.equal(x, y) for x, y in zip(before, _run_state(trainer, ema=False)))
    print(f"  check 2: a step on a NaN pixel left {unchanged} of {len(before)} parameter, "
          f"moment and count tensors unchanged; the epoch's record: skipped_nonfinite_steps "
          f"{record.get('skipped_nonfinite_steps')}")
    if unchanged != len(before) or record.get("skipped_nonfinite_steps") != skipped_before + 1:
        raise RuntimeError("train_state: a non-finite step moved the state or was not counted")
    del before

    # the loop's blocking time per save, async (snapshot) and sync
    with tempfile.TemporaryDirectory() as tmp:
        trainer.config = dataclasses.replace(trainer.config, eval_base_path=tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_snapshot((trainer.params, trainer._opt_state_for_checkpoint()))
        copy_s = time.perf_counter() - t0
        writer = AsyncCheckpointWriter()
        t0 = time.perf_counter()
        trainer.save_checkpoint(1, writer=writer)
        async_s = time.perf_counter() - t0
        writer.close()
        async_total_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = trainer.save_checkpoint(2)
        sync_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
    print(f"  a save blocks the loop {async_s:.3f} s async ({async_total_s:.3f} s to disk), "
          f"{sync_s:.3f} s sync; the device-to-host copy alone {copy_s:.3f} s; "
          f"{size / 2**30:.3f} GiB a checkpoint")
    return {
        "peak_gib": peaks, "step_ms": steps,
        "step_ratio_A2_to_A1": steps["A2_bf16_mu_ema"]["median"]
        / steps["A1_bf16_mu_ema"]["median"],
        "accumulated_gradient_bitwise": True, "nonfinite_step_skipped": True,
        "save_blocking_s": {"async": async_s, "sync": sync_s, "async_to_disk": async_total_s,
                            "device_to_host_copy": copy_s},
        "checkpoint_gib": size / 2**30,
    }


def phase_train_state(kernels: list[dict], card: str) -> dict:
    """The trainer's run state at full width (the default config, dit-base
    at 224 px, batch 16, bf16, with EMA 0.999, A = 2 micro-batches, bf16
    first moments, non-finite skipping, S = 2 steps a dispatch, async
    checkpoints every epoch, 2 kept, TensorBoard, a mid-eval every
    epoch; 3 epochs of 4 updates): the uninterrupted run is the path
    whose launches are counted; then a run preempted by SIGTERM in epoch
    2, step 2, resumed by a fresh trainer with ``resume("auto")``, must
    end with its parameters, EMA, moments and counts bit for bit. Checks
    the files kept, the TensorBoard events against ``metrics.jsonl``,
    ``best.pt``'s EMA weights, then ``_train_state_checks``."""
    import os
    import shutil
    import signal

    from layoutdit_tpu_torch.config import RunConfig
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture
    from layoutdit_tpu_torch.train.checkpoint import load_checkpoint
    from layoutdit_tpu_torch.models.weights_io import tree_leaves
    from layoutdit_tpu_torch.train.trainer import Trainer
    from layoutdit_tpu_torch.utils.tensorboard import read_events

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        make_fixture(tmp, n_images=TRAIN_STATE_PAGES, split="samples", seed=0)
        make_fixture(tmp, n_images=TRAIN_STATE_VAL_PAGES, split="val", seed=777)
        base = RunConfig()
        rc = dataclasses.replace(
            base, train=dataclasses.replace(base.train, train_base_path=tmp,
                                            train_input="samples", **TRAIN_STATE),
            eval_input="val", eval_base_path=tmp)
        print(f"  default config (dit-base, {rc.model.image_size} px, batch "
              f"{rc.data.batch_size}, {rc.compute_dtype}) with {TRAIN_STATE}; "
              f"{TRAIN_STATE_PAGES} training pages, {TRAIN_STATE_VAL_PAGES} held out")

        # the main path: the uninterrupted run
        model = build_model(dataclasses.replace(rc, run_name="uninterrupted"), device="cuda")
        uninterrupted = Trainer(dataclasses.replace(rc, run_name="uninterrupted"), model)
        updates_per_epoch = len(uninterrupted.dataloader)
        _reset_counts()
        t0 = time.perf_counter()
        uninterrupted.train()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _counts()
        updates = uninterrupted.updates
        print(f"  uninterrupted: {updates} updates in {run_s:.3f} s, loss "
              f"{uninterrupted.loss_history}, launches {counts}")
        for name, n in counts.items():
            if name in ("short_attention_bwd", "roi_align_bwd"):
                want = (24 if name == "short_attention_bwd" else 2) * updates
                if n != want:
                    raise RuntimeError(f"train_state: {name} launched {n} times, expected {want}")
            elif name in ("short_attention", "roi_align"):
                if n < (24 if name == "short_attention" else 2) * updates:
                    raise RuntimeError(f"train_state: {name} launched {n} times")
            elif n:
                raise RuntimeError(f"train_state: {name} launched {n} times")
        for k in kernels:
            k["train_state_launches"] = counts[k["name"]]

        # checks 4-6 on the uninterrupted run's files
        run = Path(tmp) / "uninterrupted"
        kept = sorted(p.name for p in (run / "model_checkpoints").iterdir())
        if kept != ["best.pt", "epoch_2.pt", "epoch_3.pt"]:
            raise RuntimeError(f"train_state: checkpoints kept {kept}")
        with open(run / "metrics" / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        (events_file,) = (run / "tb").iterdir()
        events = read_events(str(events_file))[1:]
        for e, r in zip(events, records, strict=True):
            want = {f"train/{k}": float(np.float32(v)) for k, v in r.items() if k != "epoch"}
            if e["step"] != r["epoch"] or set(e["scalars"]) != set(want) or not all(
                    _same_scalar(e["scalars"][k], v) for k, v in want.items()):
                raise RuntimeError(f"train_state: TensorBoard event {e} against record {r}")
        best = load_checkpoint(run / "model_checkpoints" / "best.pt", map_location="cpu")
        best_epoch = best["extra"]["epoch"]
        best_is_ema = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(best["params"]), tree_leaves(best["opt_state"]["ema"]), strict=True))
        raw = load_checkpoint(run / "model_checkpoints" / "epoch_3.pt", map_location="cpu")
        if not best_is_ema or best["extra"]["ema"] is not True or all(
                torch.equal(a, b) for a, b in zip(tree_leaves(best["params"]),
                                                  tree_leaves(raw["params"]))):
            raise RuntimeError("train_state: best.pt does not hold the EMA weights")
        del best, raw
        print(f"  kept {kept}; {len(events)} TensorBoard events equal metrics.jsonl; best.pt "
              f"(epoch {best_epoch}) holds the EMA; mAP by epoch {[r.get('mAP') for r in records]}; skipped "
              f"{[r.get('skipped_nonfinite_steps') for r in records]}")
        shutil.rmtree(run / "model_checkpoints")  # 1.5 GiB a file; the disk need not hold both

        # check 3: preempted in epoch 2, step 2; a fresh trainer resumes
        prc = dataclasses.replace(rc, run_name="preempted")
        preempted = Trainer(prc, build_model(prc, device="cuda"))
        dispatch = preempted._dispatch
        calls = {"n": 0}
        epoch, step = TRAIN_STATE_PREEMPT
        at_call = ((epoch - 1) * updates_per_epoch + step) // rc.train.steps_per_dispatch

        def dispatch_then_sigterm(*a):
            out = dispatch(*a)
            calls["n"] += 1
            if calls["n"] == at_call:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        preempted._dispatch = dispatch_then_sigterm
        preempted.train()
        saved = load_checkpoint(Path(tmp) / "preempted" / "model_checkpoints"
                                / f"epoch_{epoch - 1}_preempt.pt", map_location="cpu")
        if saved["epoch"] != epoch - 1 or saved["extra"]["step_in_epoch"] != step:
            raise RuntimeError(f"train_state: the preemption saved epoch {saved['epoch']} step "
                               f"{saved['extra']['step_in_epoch']}")
        del saved, preempted
        torch.cuda.empty_cache()
        resumed = Trainer(prc, build_model(prc, device="cuda"))
        t0 = time.perf_counter()
        resumed.resume("auto")
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed.train()
        kept_b = sorted(p.name for p in (Path(tmp) / "preempted" / "model_checkpoints").iterdir())
        if kept_b != ["best.pt", f"epoch_{epoch - 1}_preempt.pt", "epoch_2.pt", "epoch_3.pt"]:
            raise RuntimeError(f"train_state: the preempted run kept {kept_b}")
        differing = sum(not torch.equal(a, b) for a, b in zip(
            _run_state(resumed), _run_state(uninterrupted), strict=True))
        print(f"  check 3: SIGTERM in epoch {epoch}, step {step}: epoch_{epoch - 1}_preempt.pt "
              f"at step {step}; resume('auto') in {resume_s:.3f} s; {differing} of "
              f"{len(_run_state(resumed))} parameter, EMA, moment and count tensors differ from "
              f"the uninterrupted run's (bit equality required); kept {kept_b}")
        if differing:
            raise RuntimeError("train_state: the resumed run differs from the uninterrupted one")
        num_params = model.num_params()
        del resumed, uninterrupted, model
        torch.cuda.empty_cache()
        checks = _train_state_checks(rc, kernels)
    out = {
        "card": card, "config": {"default RunConfig": True, **TRAIN_STATE},
        "pages": TRAIN_STATE_PAGES, "held_out_pages": TRAIN_STATE_VAL_PAGES,
        "num_params": num_params, "uninterrupted_s": run_s, "updates": updates,
        "loss": [r["loss"] for r in records], "mAP": [r.get("mAP") for r in records],
        "resume_s": resume_s, **checks,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"  train_state phase: {out['phase_s']:.1f} s, {num_params} parameters")
    return out


# the io phase: make_fixture pages packed into tar shards (at least
# IO_MIN_SHARDS), the native COCO parser timed on a synthetic file of
# PubLayNet val's size (IO_PARSE_IMAGES pages, IO_PARSE_BOXES boxes each,
# with polygons), IO_STEPS train steps of the default config with an EMA,
# bf16 first moments and non-finite skipping (IO_TRAIN), then that
# state as a JAX-format msgpack checkpoint and as a .pt, each resumed by a
# fresh trainer and trained one more epoch: from the shards after the
# msgpack, from the files after the .pt
IO_PAGES = 64
IO_MIN_SHARDS = 2
IO_PARSE_IMAGES = 11245
IO_PARSE_BOXES = 20
IO_STEPS = 2
IO_TRAIN = dict(ema_decay=0.999, adam_mu_dtype="bfloat16", skip_nonfinite_updates=3)


def _synthetic_coco_bytes(n_images: int, boxes: int, seed: int) -> bytes:
    """A COCO annotations file of ``n_images`` pages with ``boxes`` boxes
    each (a polygon per box, as PubLayNet's), values from ``seed``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 500, (n_images * boxes, 2)).round(2)
    wh = rng.uniform(5, 300, (n_images * boxes, 2)).round(2)
    cats = rng.integers(1, 6, n_images * boxes)
    anns = []
    for j, ((x, y), (w, h), c) in enumerate(zip(xy.tolist(), wh.tolist(), cats.tolist())):
        anns.append({"segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]],
                     "area": round(w * h, 3), "iscrowd": 0, "image_id": j // boxes,
                     "bbox": [x, y, w, h], "category_id": c, "id": j})
    images = [{"file_name": f"PMC{i:07d}_00000{i % 10}.jpg", "height": 792, "width": 612,
               "id": i} for i in range(n_images)]
    cats_ = [{"supercategory": "", "id": i, "name": n}
             for i, n in enumerate(("text", "title", "list", "table", "figure"), 1)]
    return json.dumps({"images": images, "annotations": anns, "categories": cats_}).encode()


def _io_parse(card: str) -> dict:
    """The native parser against ``json.loads`` on a file of PubLayNet
    val's size -> both parse times; raises where the parser is missing."""
    from layoutdit_tpu_torch.native import cocojson

    if not cocojson.available():
        raise RuntimeError("io: the native COCO parser is not available (g++ build failed)")
    raw = _synthetic_coco_bytes(IO_PARSE_IMAGES, IO_PARSE_BOXES, seed=5)
    t0 = time.perf_counter()
    arr = cocojson.parse_coco_bytes(raw)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coco = json.loads(raw)
    json_s = time.perf_counter() - t0
    if arr is None or len(arr.ann_id) != len(coco["annotations"]) or \
            not np.array_equal(arr.ann_bbox, np.asarray([a["bbox"] for a in coco["annotations"]])):
        raise RuntimeError("io: the native parse of the synthetic file differs from json.loads")
    print(f"  parse of {len(raw) / 2**20:.1f} MiB ({IO_PARSE_IMAGES} pages, "
          f"{len(coco['annotations'])} boxes with polygons): native {native_s:.3f} s, "
          f"json.loads {json_s:.3f} s ({json_s / native_s:.1f}x); {card}")
    return {"mib": len(raw) / 2**20, "images": IO_PARSE_IMAGES,
            "annotations": len(coco["annotations"]), "native_s": native_s, "json_loads_s": json_s}


def _differing(a: list, b: list) -> int:
    return sum(not torch.equal(x, y) for x, y in zip(a, b, strict=True))


def phase_io(kernels: list[dict], card: str) -> dict:
    """Storage and data I/O at full width (the default config, dit-base at
    224 px, batch 16, bf16; ``IO_TRAIN``: EMA, bf16 ``mu``, non-finite
    skipping): ``make_fixture`` pages packed into tar
    shards by ``data/shards.build_shards``, their annotations read by the native
    parser (its arrays equal to the ``json.loads`` path's), the parser
    timed; ``IO_STEPS`` steps, written as ``epoch_1.msgpack`` with the
    port's encoder of the JAX format and as ``epoch_1.pt``. The main path:
    a fresh trainer over the shards takes the msgpack with
    ``resume("auto")`` (its device tensors equal the saved ones bit for
    bit) and trains an epoch; beside it, a fresh trainer over the files
    resumes the ``.pt`` and trains the same epoch. Their states after the
    first step and after the epoch must be the same bits."""
    import os

    from layoutdit_tpu_torch.config import RunConfig
    from layoutdit_tpu_torch.data.dataset import PubLayNetDataset, read_bytes
    from layoutdit_tpu_torch.data.shards import build_shards
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture
    from layoutdit_tpu_torch.train.checkpoint import save_as_jax
    from layoutdit_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    parse = _io_parse(card)
    with tempfile.TemporaryDirectory() as tmp:
        make_fixture(tmp, n_images=IO_PAGES, split="samples", seed=0)
        images, ann = os.path.join(tmp, "samples"), os.path.join(tmp, "samples.json")
        page_bytes = sum(os.path.getsize(os.path.join(images, n)) for n in os.listdir(images))
        shards = os.path.join(tmp, "shards")
        with open(ann) as f:
            names = [img["file_name"] for img in json.load(f)["images"]]
        build_shards(names, lambda n: read_bytes(os.path.join(images, n)), shards,
                     shard_size_bytes=page_bytes // (IO_MIN_SHARDS + 1))
        with open(os.path.join(shards, "index.json")) as f:
            n_shards = len(json.load(f)["shards"])
        if n_shards < IO_MIN_SHARDS:
            raise RuntimeError(f"io: {n_shards} shard(s), expected at least {IO_MIN_SHARDS}")
        native = PubLayNetDataset(images, ann)
        os.environ["LAYOUTDIT_NO_NATIVE_COCO"] = "1"
        try:
            plain = PubLayNetDataset(images, ann)
        finally:
            del os.environ["LAYOUTDIT_NO_NATIVE_COCO"]
        if not native.native or plain.native or native.ids != plain.ids or not all(
                np.array_equal(native.load_target(i)[k], plain.load_target(i)[k])
                for i in native.ids for k in ("boxes", "labels")):
            raise RuntimeError("io: the native parse of the pages' annotations differs from "
                               "json.loads (or was not taken)")
        print(f"  {IO_PAGES} pages ({page_bytes / 2**20:.2f} MiB) in {n_shards} shards; the "
              f"native parser's targets equal json.loads'")

        base = RunConfig()
        rc = dataclasses.replace(base, train=dataclasses.replace(
            base.train, train_base_path=tmp, train_input="samples", num_epochs=2, **IO_TRAIN),
            eval_base_path=tmp, run_name="pt")
        sharded = dataclasses.replace(rc, run_name="jax_format", data=dataclasses.replace(
            rc.data, image_shards_dir=shards))

        # the state: IO_STEPS steps from the files
        first = Trainer(rc, build_model(rc, seed=0))
        it = iter(first.dataloader)
        for _ in range(IO_STEPS):
            first.train_step(next(it))
        it.close()
        first.dataloader.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msgpack = save_as_jax(f"{sharded.artifact_dir}/model_checkpoints/epoch_1.msgpack",
                              first.params, first._opt_state_for_checkpoint(), 1,
                              first.checkpoint_extra(), clip=rc.train.grad_clip_norm > 0)
        write_s = time.perf_counter() - t0
        first.save_checkpoint(1)
        size = os.path.getsize(msgpack)
        saved = [t.clone() for t in _run_state(first)]
        num_params = first.model.num_params()
        del first, it
        torch.cuda.empty_cache()

        def resumed(config, path):
            trainer = Trainer(config, build_model(config, seed=1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.resume(path)
            torch.cuda.synchronize()
            return trainer, time.perf_counter() - t0

        def train_epoch(trainer):
            after_first = {}
            dispatch = trainer._dispatch

            def spy(*a):
                out = dispatch(*a)
                if not after_first:
                    after_first["state"] = [t.clone() for t in _run_state(trainer)]
                return out

            trainer._dispatch = spy
            trainer.train()
            torch.cuda.synchronize()
            trainer._dispatch = dispatch
            return after_first["state"]

        # the main path: resume the msgpack, then an epoch from the shards
        _reset_counts()
        from_jax, resume_s = resumed(sharded, "auto")
        if from_jax.resume_candidates() != [msgpack]:
            raise RuntimeError(f"io: resume('auto') saw {from_jax.resume_candidates()}")
        restored = _differing(_run_state(from_jax), saved)
        if restored or from_jax.epoch != 1 or not from_jax.dataloader.dataset.native:
            raise RuntimeError(f"io: the msgpack resume differs in {restored} tensors (epoch "
                               f"{from_jax.epoch})")
        jax_first = train_epoch(from_jax)
        counts = _counts()
        from_pt, pt_resume_s = resumed(rc, "auto")
        pt_first = train_epoch(from_pt)
        first_diff = _differing(jax_first, pt_first)
        epoch_diff = _differing(_run_state(from_jax), _run_state(from_pt))
        rate = {name: t.metrics_history[-1]["images_per_sec"]
                for name, t in (("shards", from_jax), ("files", from_pt))}
        print(f"  {num_params} parameters, EMA, bf16 mu, apply_if_finite: epoch_1.msgpack "
              f"{size / 2**30:.3f} GiB written in {write_s:.3f} s; resume('auto') took it in "
              f"{resume_s:.3f} s (the .pt {pt_resume_s:.3f} s), 0 of {len(saved)} tensors "
              f"differ from the saved state; {card}")
        print(f"  one step after the msgpack resume (shards) against one after the .pt resume "
              f"(files): {first_diff} tensors differ; after the epoch {epoch_diff} (bit "
              f"equality required); epoch images/s from shards {rate['shards']}, from files "
              f"{rate['files']}; launches {counts}; {card}")
        if first_diff or epoch_diff or from_jax.loss_history != from_pt.loss_history:
            raise RuntimeError("io: the run resumed from msgpack over shards differs from the "
                               "run resumed from .pt over files")
        steps = len(from_jax.dataloader)
        del from_jax, from_pt, saved, jax_first, pt_first
    for name, n in counts.items():
        want = {"short_attention": 12, "short_attention_bwd": 12, "roi_align": 1,
                "roi_align_bwd": 1}.get(name, 0) * steps
        if n != want:
            raise RuntimeError(f"io: {name} launched {n} times in {steps} steps, "
                               f"expected {want}")
    for k in kernels:
        k["io_launches"] = counts[k["name"]]
    out = {"card": card, "pages": IO_PAGES, "shards": n_shards, "parse": parse,
           "num_params": num_params, "msgpack_gib": size / 2**30, "msgpack_write_s": write_s,
           "msgpack_resume_s": resume_s, "pt_resume_s": pt_resume_s,
           "epoch_images_per_s": rate, "launches": counts,
           "phase_s": time.perf_counter() - t_phase}
    print(f"  io phase: {out['phase_s']:.1f} s")
    return out


# stages whose device time the pyramid's layout moves (the convolutions
# of the backbone's FPN and of the RPN head), printed from one profiled
# request per bucket and one profiled 224 px train step
LAYOUT_STAGES = ("backbone", "rpn")


def _print_stages(label: str, r: dict) -> dict:
    """The LAYOUT_STAGES of one profiled request or step (``summarize_trace``)."""
    out = {name: r["stages"].get(name, {}) for name in LAYOUT_STAGES}
    print(f"  {label}: device busy {r['device_busy_ms']:.4f} ms, " + ", ".join(
        f"stage {n} device work {st.get('device_ms', 0.0):.4f} ms (host "
        f"{st.get('host_ms', 0.0):.4f} ms)" for n, st in out.items()))
    return out


def phase_serving(kernels: list[dict]) -> dict:
    from layoutdit_tpu_torch.config import load_config
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.tools.profile_serving import profile_bucket

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
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            raise RuntimeError(f"{name} was not launched on the serving path")
    for name in PROBE_KERNELS:
        if counts[name]:
            raise RuntimeError(f"{name} was launched on the serving path")
    for k in kernels:
        k["serving_launches"] = counts[k["name"]]

    _encoder_reference(model, {
        s: engine._upload_batch([engine._decode_page(p)], s)[0][0]
        for s, p in ((224, small[0]), (1024, large[0]))
    })
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        for size, pages in ((224, small[:dl.batch_size]), (1024, large[:dl.batch_size])):
            r = profile_bucket(engine, pages, Path(tmp) / f"serving_{size}.json")
            stages[size] = _print_stages(f"serving {size} px, {len(pages)} pages", r)
    return {
        "rounds": REQUEST_REPEATS, "stages": stages,
        "latency_ms": {k: sorted(t * 1e3 for t in v) for k, v in latencies.items()},
        "median_pages_per_s": {
            name: len(pages) / float(np.median(latencies[name])) for name, pages in requests
        },
        "nms_host_syncs": syncs,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    if not ((ROOT / "layoutdit_tpu_torch").is_dir() and CONFIG.is_file()
            and TRAIN_1024_CONFIG.is_file() and RELPOS_CONFIG.is_file()):
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
            if any(w in line for w in ("Function properties", "registers", "spill", "warning",
                                       "Potential Performance")):
                print(f"  {name}: {line.strip()}")
    from layoutdit_tpu_torch.ops import flash_attention as fa

    smem = fa._lib().flash_attention_smem_bytes
    print(f"  flash_attention: dynamic shared memory: forward {smem(0, 0)} / {smem(0, 1)} "
          f"bytes, dq {smem(1, 0)} / {smem(1, 1)}, dkdv {smem(2, 0)} / {smem(2, 1)} (without / "
          f"with a bias), dbias {smem(3, 4)} (B = 4, rows resident) / {smem(4, 0)} (streamed)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    print("phase kernels")
    kernels = [phase_short(gen), phase_flash(gen), phase_roi(gen)]
    torch.cuda.empty_cache()
    print("phase kernels_bwd")
    kernels += [phase_short_bwd(gen), *phase_flash_bwd(gen), phase_roi_bwd(gen)]
    torch.cuda.empty_cache()
    print("phase probes")
    kernels += phase_probes(gen, kernels)
    torch.cuda.empty_cache()

    print("phase serving")
    serving = phase_serving(kernels)
    torch.cuda.empty_cache()

    print("phase train")
    train = phase_train(kernels)
    torch.cuda.empty_cache()

    print("phase train_state")
    train_state = phase_train_state(kernels, card)
    torch.cuda.empty_cache()

    print("phase io")
    io = phase_io(kernels, card)
    torch.cuda.empty_cache()

    print("phase train_1024")
    train_1024 = phase_train_1024(kernels)
    torch.cuda.empty_cache()

    print("phase train_1024_relpos")
    train_1024_relpos = phase_train_1024_relpos(kernels)
    torch.cuda.empty_cache()

    print("phase main")
    main_run = phase_main(kernels, card)
    torch.cuda.empty_cache()

    print("phase convergence")
    conv = phase_convergence(kernels, card)
    paths = ("probe", "serving", "train", "train_state", "io", "train_1024",
             "train_1024_relpos", "main", "convergence")
    for k in kernels:
        k["launches"] = sum(k[f"{path}_launches"] for path in paths)
        if k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} was launched on no path")

    print(json.dumps({"serving": serving}))
    print(json.dumps({"train": train}))
    print(json.dumps({"train_state": train_state}))
    print(json.dumps({"io": io}))
    print(json.dumps({"train_1024": train_1024}))
    print(json.dumps({"train_1024_relpos": train_1024_relpos}))
    print(json.dumps({"main": main_run}))
    print(json.dumps({"convergence": conv}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
