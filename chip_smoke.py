#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``layoutdit_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``layoutdit_tpu_torch/csrc`` (one
nvcc per source, in parallel), holds each forward and backward kernel
against its plain PyTorch version at the shapes of the serving and
training paths and times both (phases ``kernels`` and ``kernels_bwd``),
then serves requests through ``BatchInferenceEngine`` with dit-base
Faster R-CNN at full width (``configs/serving_1024.json``, random weights
from a seed) in the 224 and 1024 px buckets and checks the detections
and the encoder against a float32 CPU reference (phase ``serving``),
then trains the port's default config (dit-base, 224 px, batch 16) with
``Trainer`` over synthetic pages: one epoch, then steps on a repeated
batch whose loss must fall, and the encoder's gradients against a
float32 CPU reference (phase ``train``), and does the same with the
windowed high-res config ``configs/train_1024_window.json`` (dit-base,
1024 px, batch 4, 16 x 16 windows, four global layers; phase
``train_1024``). It checks that every kernel ran on its path, the right
number of times a train step. It prints JSON lines for serving, training
and the kernels, the card's name and power limit, and as its last line
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

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# bf16 outputs of a kernel vs its plain version (both accumulate in fp32
# and round once to bf16; the attention kernels also round P to bf16
# before the P V product): max |kernel - plain| <= max |plain| / 64,
# i.e. a few bf16 roundings at the top of the output's range.
BF16_REL_TOL = 1.0 / 64
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


def _check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                 floor: float = 0.0) -> tuple[float, float]:
    """-> (max |got - want|, its tolerance); raises past the tolerance,
    max |want| * BF16_REL_TOL or ``floor`` if that is larger."""
    err = (got.float() - want.float()).abs().max().item()
    tol = max(want.float().abs().max().item() * BF16_REL_TOL, floor)
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


def _short_fwd_case(gen, b, n, h=12, d=64) -> dict:
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, b, n, h, d)
    err, tol = _check_close(f"short_attention B={b} N={n}", sa.short_attention(q, k, v),
                            sa.short_attention_plain(q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes = 4 * b * n * h * d * 2
    bound, by = _bound_ms(nbytes, 4 * b * h * n * n * d)
    return {
        "shape": f"B={b} N={n} H={h} D={d} bf16",
        "max_abs_err": err, "tolerance": tol,
        "ms": _time_ms(lambda: sa.short_attention(q, k, v), 50),
        "plain_ms": _time_ms(lambda: sa.short_attention_plain(q, k, v), 20),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: sdpa(qt, kt, vt), 50),
    }


# the short kernels' other shapes on the windowed 1024 px train step: its
# 64 windows of 16 x 16 patches (4 images x 16) and the CLS token alone
WINDOW_SHAPES = {"w256": (64, 256), "n1": (4, 1)}


def phase_short(gen) -> dict:
    entry = {
        "name": "short_attention", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/short_attention.cu",
        "replaces": "layoutdit_tpu/ops/short_attention.py:79",
        **_short_fwd_case(gen, 16, 197),
    }
    for key, (b, n) in WINDOW_SHAPES.items():
        entry.update({f"{key}_{k}": v for k, v in _short_fwd_case(gen, b, n).items()})
    return entry


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
    # 224 px at the train step's B=16 (serving's batch is 4), 1024 px at
    # serving's B=4
    for image, b in ((224, 16), (1024, 4)):
        feats, rois, mask = _roi_inputs(gen, image, b=b)
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


def _short_bwd_case(gen, b, n, h=12, d=64) -> dict:
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, b, n, h, d)
    o = sa.short_attention(q, k, v)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="cuda")
    out = tuple(sa.split_qkv(dqkv, h))
    got = sa.short_attention_bwd(q, k, v, o, do, out=out)
    want = sa.short_attention_bwd_plain(q, k, v, o, do)
    # at N=1 the softmax is constant, so dq and dk are 0 in exact
    # arithmetic: both sides give fp32 rounding noise of dO.v - dO.o (terms
    # of order 10), which the relative tolerance cannot measure; the floor
    # is far below one bf16 ulp of that call's dv (|dv| of order 1)
    floor = SINGLE_TOKEN_FLOOR if n == 1 else 0.0
    errs, tols = zip(*(_check_close(f"short_attention_bwd B={b} N={n} {name}", g, w, floor)
                       for name, g, w in zip(("dq", "dk", "dv"), got, want)))
    del want

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ot = sdpa(qt, kt, vt)
    dot = do.transpose(1, 2)
    nbytes = 8 * b * n * h * d * 2  # q, k, v, o, dO in; dq, dk, dv out
    bound, by = _bound_ms(nbytes, 10 * b * h * n * n * d)
    return {
        "shape": f"B={b} N={n} H={h} D={d} bf16, q/k/v and dq/dk/dv strided in fused [B, N, 3HD]",
        "max_abs_err": max(errs), "tolerance": tols[errs.index(max(errs))],
        "ms": _time_ms(lambda: sa.short_attention_bwd(q, k, v, o, do, out=out), 20),
        "plain_ms": _time_ms(lambda: sa.short_attention_bwd_plain(q, k, v, o, do), 5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(
            lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), 20),
    }


def phase_short_bwd(gen) -> dict:
    """Short attention backward at the 224 px train step's shape, and at
    the windowed 1024 px step's: q, k, v as strided views of one fused
    projection, the gradient written into one fused [B, N, 3*H*D] tensor,
    against the plain version on the same bf16 inputs."""
    entry = {
        "name": "short_attention_bwd", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/short_attention.cu",
        "replaces": "layoutdit_tpu/ops/short_attention.py:90",
        **_short_bwd_case(gen, 16, 197),
    }
    for key, (b, n) in WINDOW_SHAPES.items():
        entry.update({f"{key}_{k}": v for k, v in _short_bwd_case(gen, b, n).items()})
    return entry


def phase_flash_bwd(gen) -> list[dict]:
    """Flash attention backward at the 1024 px train step's shape (B=4,
    N=4097, H=12, D=64), with and without a [H, N, N] bias: q, k, v as
    strided views of one fused projection, dq, dk, dv written into one
    fused [B, N, 3*H*D] gradient, against the plain version on the same
    bf16 inputs; a second run must give the same bits (no atomics). Each
    of its two kernels is timed alone (dq first: it writes the delta the
    dkdv kernel reads). The plain version and SDPA's backward compute
    dq, dk and dv in one call, so their times stand beside the pair's."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import short_attention as sa

    b, n, h, d = 4, 4097, 12, 64
    scale = 1.0 / math.sqrt(d)
    q, k, v = _qkv(gen, b, n, h, d)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="cuda")
    again = torch.empty_like(dqkv)
    out = tuple(sa.split_qkv(dqkv, h))
    bias = 0.5 * torch.randn(h, n, n, generator=gen, device="cuda")
    res = {}
    for key, bb in (("", None), ("bias_", bias)):
        o, lse = fa.flash_attention_fwd(q, k, v, bb)
        fa.flash_attention_bwd(q, k, v, o, lse, do, bb, out=out)
        fa.flash_attention_bwd(q, k, v, o, lse, do, bb, out=tuple(sa.split_qkv(again, h)))
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, bb)
        label = "flash_attention_bwd" + (" (bias)" if bb is not None else "")
        errs = {name: _check_close(f"{label} {name}", g, w)
                for name, g, w in zip(("dq", "dk", "dv"), out, want)}
        del want
        if not torch.equal(dqkv, again):
            raise RuntimeError(f"{label}: two runs gave different gradients")
        delta = torch.empty(b * h, n, dtype=torch.float32, device="cuda")
        dq, dk, dv = out
        res[key + "dq"] = (errs["dq"], _time_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, bb, scale, dq, delta), 5))
        res[key + "dkdv"] = (max(errs["dk"], errs["dv"]), _time_ms(
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, lse, do, delta, bb, scale, dk, dv), 5))
        res[key + "plain"] = _time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, bb), 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ot = sdpa(qt, kt, vt, attn_mask=None if bb is None else bb[None].to(torch.bfloat16))
        res[key + "library"] = _time_ms(
            lambda: torch.autograd.grad(ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
            5)
        del ot, qt, kt, vt, o, lse
        torch.cuda.empty_cache()
    print("  flash_attention_bwd: two runs gave the same bits, with and without bias")

    row = b * n * h * d * 2  # one bf16 [B, N, H, D] tensor
    vec = b * h * n * 4  # one fp32 [B*H, N] vector
    bias_bytes = h * n * n * 4
    flops = 2 * b * h * n * n * d  # one N x N x D product over all heads
    # dq: S, dP and dQ from q, k, v, o, dO, lse; out dq and delta.
    # dkdv: S, dP, dV and dK from q, k, v, dO, lse, delta; out dk and dv.
    work = {"dq": (6 * row + 2 * vec, 3 * flops), "dkdv": (6 * row + 2 * vec, 4 * flops)}
    pair_bound, pair_by = _bound_ms(8 * row + vec, 5 * flops)
    pair_bias_bound, pair_bias_by = _bound_ms(8 * row + vec + bias_bytes, 5 * flops)
    entries = []
    # (no-bias kernel body, bias kernel body) lines in the JAX source
    for part, (line, bias_line) in (("dkdv", (280, 217)), ("dq", (286, 253))):
        nbytes, ops = work[part]
        bound, by = _bound_ms(nbytes, ops)
        bias_bound, bias_by = _bound_ms(nbytes + bias_bytes, ops)
        (err, tol), ms = res[part]
        (bias_err, bias_tol), bias_ms = res["bias_" + part]
        entries.append({
            "name": f"flash_attention_bwd_{part}", "route": "cuda",
            "source": "layoutdit_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"layoutdit_tpu/ops/flash_attention.py:{line}",
            "shape": f"B={b} N={n} H={h} D={d} bf16, no bias, q/k/v and dq/dk/dv strided in "
                     "fused [B, N, 3HD]",
            "max_abs_err": err, "tolerance": tol, "ms": ms,
            "plain_ms": res["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": res["library"],
            "plain_and_library_compute": "dq, dk and dv in one call (compare with pair_ms)",
            "pair_ms": res["dq"][1] + res["dkdv"][1],
            "pair_bound_ms": pair_bound, "pair_bound_by": pair_by,
            "bias_replaces": f"layoutdit_tpu/ops/flash_attention.py:{bias_line}",
            "bias_max_abs_err": bias_err, "bias_tolerance": bias_tol, "bias_ms": bias_ms,
            "bias_plain_ms": res["bias_plain"], "bias_bound_ms": bias_bound,
            "bias_bound_by": bias_by, "bias_library_ms": res["bias_library"],
            "bias_pair_ms": res["bias_dq"][1] + res["bias_dkdv"][1],
            "bias_pair_bound_ms": pair_bias_bound, "bias_pair_bound_by": pair_bias_by,
        })
    return entries


def _roi_bwd_case(gen, image: int, b: int, k: int = 512) -> dict:
    from layoutdit_tpu_torch.ops import roi_align as ra

    p, g = 7, 2
    feats, rois, mask = _roi_inputs(gen, image, b=b, k=k)
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
    levels = ra.roi_levels(rois, 5, float(image), roi_mask=mask)
    c = feats[0].shape[1]
    dout = torch.randn(b, k, p, p, c, generator=gen, device="cuda").to(torch.bfloat16)
    got = ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g)
    want = ra.roi_align_bwd_plain(dout, rois, levels, feats, scales, p, g)
    errs, tols = zip(*(_check_close(f"roi_align_bwd {image} px level {i}", gl, wl)
                       for i, (gl, wl) in enumerate(zip(got, want))))
    # a second run must agree within the atomics' reordering
    again = ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g)
    rerun = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, again))
    print(f"  roi_align_bwd {image} px: two runs differ by at most {rerun:.6g}")
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
    return {
        "shape": f"B={b} K={k} ({n_valid} valid) C={c} P={p} pyramid {image} px bf16",
        "max_abs_err": max(errs), "tolerance": tols[errs.index(max(errs))],
        "rerun_max_abs_diff": rerun,
        "ms": _time_ms(lambda: ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g), 10),
        "plain_ms": _time_ms(
            lambda: ra.roi_align_bwd_plain(dout, rois, levels, feats, scales, p, g), 2),
        "bound_ms": bound, "bound_by": by,
    }


def phase_roi_bwd(gen) -> dict:
    """RoIAlign backward at the 224 px train step's shape (B=16, K=512, a
    fifth of the RoIs invalid) and at the 1024 px step's (B=4, its
    pyramid), against the plain version on the same bf16 dout. The kernel
    adds with fp32 atomics in an order that changes from run to run: that
    moves the fp32 sum by a few ulps, far inside the one bf16 rounding of
    the output the tolerance allows."""
    entry = {
        "name": "roi_align_bwd", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/roi_align.cu",
        "replaces": "layoutdit_tpu/ops/roi_align_pallas.py:67",
        **_roi_bwd_case(gen, 224, 16),
        "library_ms": None,
    }
    entry.update({f"b1024_{k}": v for k, v in _roi_bwd_case(gen, 1024, 4).items()})
    return entry


def _counters():
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    return {
        "short_attention": sa.short_attention,
        "short_attention_bwd": sa.short_attention_bwd,
        "flash_attention": fa.flash_attention_fwd,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
        "roi_align": ra.roi_align_fwd,
        "roi_align_bwd": ra.roi_align_bwd,
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
    are on (layer 1 is then windowed), and the last layer's mlp_out."""
    from layoutdit_tpu_torch.models.backbone import backbone_forward
    from layoutdit_tpu_torch.models.detection.detector import _normalize
    from layoutdit_tpu_torch.models.weights_io import tree_map

    vit_cfg = cfg.backbone.vit
    layers = [1]
    if vit_cfg.window_size > 0:
        layers.append(next(i for i in range(1, vit_cfg.num_hidden_layers + 1)
                           if vit_cfg.is_global_layer(i)))
    names = (["patch_embed"] + [f"layer {i} qkv" for i in layers]
             + [f"layer {vit_cfg.num_hidden_layers} mlp_out"])

    def grads(p, x, dtype, cots):
        vit = p["vit"]
        wanted = ([vit["patch_embed"]["weight"]]
                  + [vit["layers"][i - 1]["qkv"]["weight"] for i in layers]
                  + [vit["layers"][-1]["mlp_out"]["weight"]])
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
    in a windowed layer, two short ones (the windows and the CLS token),
    each with its backward; one RoIAlign forward and backward."""
    from layoutdit_tpu_torch.ops.short_attention import MAX_N as SHORT_MAX_N

    vit = cfg.backbone.vit
    g = cfg.image_size // vit.patch_size
    windowed = sum(0 < vit.window_size < g and not vit.is_global_layer(i)
                   for i in range(1, vit.num_hidden_layers + 1))
    full = vit.num_hidden_layers - windowed
    flash = full if g * g + 1 > SHORT_MAX_N else 0
    short = full - flash + 2 * windowed
    if windowed and vit.window_size ** 2 > SHORT_MAX_N:
        raise RuntimeError("a window is longer than the short kernel takes")
    return {"short_attention": short, "short_attention_bwd": short, "flash_attention": flash,
            "flash_attention_bwd_dq": flash, "flash_attention_bwd_dkdv": flash,
            "roi_align": 1, "roi_align_bwd": 1}


def _train_run(label: str, base, kernels: list[dict], grad_images: int,
               check_taps: bool) -> dict:
    """A training config at full width (bf16 over fp32 masters, random
    weights from seed 0) through ``Trainer(config, model).train()`` for
    one epoch over synthetic pages at its image size in a temp dir, then
    ``TRAIN_REPEATS`` steps on one repeated batch (timed, losses finite
    and falling), launch counts per step as the config implies, and the
    encoder's gradients (and, with ``check_taps``, its taps) against a
    float32 CPU reference."""
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture
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
        model = DetectorModel(init_detector(cfg, gen, device="cuda"), cfg)
        trainer = Trainer(rc, model)
        vit = cfg.backbone.vit
        windows = (f", {vit.window_size} x {vit.window_size} windows, global layers "
                   f"{[i for i in range(1, vit.num_hidden_layers + 1) if vit.is_global_layer(i)]}"
                   if vit.window_size else "")
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
    return {
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

    out = _train_run("train", RunConfig(), kernels, grad_images=2, check_taps=False)
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
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            raise RuntimeError(f"{name} was not launched on the serving path")
    for k in kernels:
        k["serving_launches"] = counts[k["name"]]

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
    if not ((ROOT / "layoutdit_tpu_torch").is_dir() and CONFIG.is_file()
            and TRAIN_1024_CONFIG.is_file()):
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
    print("phase kernels_bwd")
    kernels += [phase_short_bwd(gen), *phase_flash_bwd(gen), phase_roi_bwd(gen)]
    torch.cuda.empty_cache()

    print("phase serving")
    serving = phase_serving(kernels)
    torch.cuda.empty_cache()

    print("phase train")
    train = phase_train(kernels)
    torch.cuda.empty_cache()

    print("phase train_1024")
    train_1024 = phase_train_1024(kernels)
    for k in kernels:
        k["launches"] = sum(k[f"{path}_launches"] for path in ("serving", "train", "train_1024"))

    print(json.dumps({"serving": serving}))
    print(json.dumps({"train": train}))
    print(json.dumps({"train_1024": train_1024}))
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
