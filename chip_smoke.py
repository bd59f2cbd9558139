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
then deploys that model: its registered kernel operators' host cost per
call against their direct launches, a ``torch.export`` artifact of both
buckets run in a fresh process that imports no model, config or eval
code (``--exported-child``) and held to the live engine's detections,
16 concurrent JPEG requests and a corrupt page over HTTP, the predict
tool with planned buckets, and the native JPEG decode against PIL
(phase ``deploy``; ``--only deploy`` runs that phase alone after the
build, without the last lines), then serves the same model in float32
(``precision.compute_dtype`` "float32" in the config's raw dict) in
both buckets beside the bf16 engine of the same weights, holds its
detections to a float32 control whose wrappers are all plain versions
(every page the same count, scores and boxes within 1e-4 of max |ref|)
and scores 8 fixture pages in float32, the float32 forms of rows 1, 3
and 7 launched and no plain version (phase ``serve_f32``; its kernel
cases, each float32 form against its plain version at the serving
shapes and the main paths' others beside SDPA with fp32 inputs, run
alone on the card after phase ``flash_masked``; ``--only serve_f32`` runs
both after the build), then trains the port's default config (dit-base, 224 px, batch 16) with
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
gradient on the dbias kernel; phase ``train_1024_relpos``), and with
that file's window set to 14: ViTDet's layout at 1024 px, the 64 x 64
grid padded to 70 x 70, each windowed layer's attention on the masked
flash kernels with its bias and the [25, 196] key mask, an epoch of
three steps and one served 1024 px batch counted, taps and gradients
(the tables' among them) against the float32 plain path (phase
``train_1024_w14``, also ``--only train_1024_w14`` after the build).
Phase ``flash_masked`` (also ``--only flash_masked`` after the build)
holds rows 3-6 with a key mask to their plain versions at that
window shape, at 224 px with ``pad_tokens_to`` 256 and a bias and at
1024 px with ``pad_tokens_to`` 4224 (rows 3-5), directly and through
``attention_core`` with autograd: the same bits on a second run, the
dropped keys' dk and dv 0, an all-True mask the unmasked kernels'
bits, times beside SDPA with the mask (and, for dbias, SDPA's backward
with the bias as a mask that requires a gradient). Phase
``encoder`` covers the encoder's options: the short kernels with the
key mask of ViTDet-L's 14 x 14 windows over a 1024 px page (the grid
padded, 25 windows of 196 slots), held to their plain versions and, with
an all-True mask, to the unmasked kernels' bits, and rows 1-5 at
dit-large's shapes, all beside SDPA; dit-large trained at 1024 px in that
layout (``configs/train_1024_large_window14.json``) with remat off,
"full" and "dots" (the same gradient bits from one state, peak memory
ordered full < dots < off, taps and gradients against float32 plain
versions on the card); ``configs/fsdp_large.json`` as it is (dit-large,
224 px, two micro-batches, remat, its mesh on this one card); and
dit-large serving both buckets. Then it runs
the port's command line, ``layoutdit_tpu_torch.main``, at the default
config: one epoch with a mid-training COCO eval, the final score of
held-out pages, ``predictions.json``, ``best.pt`` and the overlays, and
``best.pt`` scored again to the mAP it records (phase ``main``); and the
JAX package's flagship convergence recipe through the port in bf16
(``tools/convergence.py``: the tiny detector, 48 epochs), held to the
JAX test's held-out mAP and AP50 floors (phase ``convergence``). Then
phase ``families`` (``--only families`` alone, after the build) holds
the RoIAlign pair to its plain versions at a mask head's P = 14 shapes
and on refined cascade boxes with zero-size ones, then serves and trains
Cascade R-CNN (``configs/cascade_dp.json``, dit-large) and Mask R-CNN
(``configs/mask_rcnn.json``, dit-base, masks pasted into the pages),
scores the mask model with the segm metrics (both families' recipes run
in bf16 at the flagship's floors in phase ``recipes``). Then phase
``one_stage`` (``--only one_stage`` alone, after the build) serves
RetinaNet (``configs/retinanet.json``) and FCOS (``configs/fcos.json``),
dit-base, in the 224 and 1024 px buckets, each request at the config's
score threshold and at 0 (every candidate into the NMS), profiles a
request per bucket by stage (``backbone``, ``head``, ``postprocess``),
trains each, scores 64 pages, exports the 224 px bucket and holds the
artifact's detections to the live ones, with no RoIAlign launch anywhere
(both recipes run in bf16 to JAX's floors in phase ``recipes``). Then
phase ``recipes`` runs the four family recipes (cascade, mask, RetinaNet,
FCOS) and the LoRA recipe, each in a fresh process (``--recipe-child``),
all at once on the card. Last, phase ``detr`` (``--only detr`` alone, after the build) holds
DETR's
matcher kernel (row M1, ``csrc/matching.cu``) to its plain version, the
same indices and step counts, at a train step's problems, and times it
beside the plain version and scipy; serves ``configs/detr.json``
(dit-base, 100 queries, 6 decoder layers) in both buckets, 100 detections
a page, a request per bucket profiled by stage; exports the 224 px bucket
against the live engine; trains it paper-exact and with shared matching
(a traced step each, its ``matcher`` range) and scores 64 pages, the
matcher launched once a train step and never in predict. DETR's two
recipes (``tools/convergence.py --family
detr|detr_shared --n-train 1024 --epochs 100``) run outside the default
run, ``--only detr_recipe``. Then phase ``finetune`` (``--only
finetune``): a dit-base state_dict made from the manifest's names and
shapes, converted by ``tools/convert_hf_checkpoint.py`` and warm-started
by ``previous_layout_dit_checkpoint`` and by ``LAYOUTDIT_DIT_BASE_PTH``
(the encoder the checkpoint's bits); ``configs/lora.json`` (r16 on q and
v) trained at 224 px, batch 16, through ``Trainer`` (the first forward
the adapter-free model's bits, the frozen encoder's bits kept, every
adapter moved, moments for the trainable leaves only), timed beside the
full fine-tune; ``tools/merge_lora.py``; the merged model served in bf16
and int8 in both buckets (the int8 encoder within 0.03 of the bf16 one,
the same detection counts) and its 224 px bucket exported with
``--int8``, the artifact's detections the live int8 engine's bits. Then
phase ``resnet`` (``--only resnet``): the ResNet-50 + FPN Faster R-CNN
served in both buckets, profiled by stage, trained at 224 px, batch 16,
scored over 64 pages and exported, with RoIAlign launched and no
attention kernel. Phase ``recipes`` also runs ``tools/lora_quality.py``
(the full fine-tune and LoRA r8 from the same pretrained weights, r8 held
to 0.85 x the full fine-tune's held-out mAP) beside the family recipes;
``--only lora_recipe`` runs it alone. Last, phase ``moe`` (``--only
moe``): ``configs/moe.json`` (dit-base, 8 experts in 6 of 12 layers,
top-1, capacity 1.25) served in the 224 and 1024 px buckets beside the
dense model, its ``backbone`` device ms against the dense one's and the
share of tokens dropped at capacity; one epoch and 20 steps at 224 px,
batch 16, beside the dense flagship step (step ms, images/s, peak GiB);
two gradients of one state the same bits; a traced step and a traced
1024 px request split into the MoE ranges (router, dispatch, experts,
combine); the 224 px bucket exported and held to the live engine; the
short kernel against the bf16-score plain attention. Last, phase
``parallel`` (``--only parallel``): the port's ``main`` under a one-card
NCCL group against ``main`` alone (the same bits), the plain and the
NCCL trainer's steps in turns, two ranks sharing the card over gloo
(``--parallel-child``; NCCL refuses two ranks on one GPU) for the DP and
FSDP steps' gradients against one process's step, both peaks, and the
DP eval against one process at the ranks' batch, and two serving
replicas on the card against one engine. Last, phase
``model_parallel`` (``--only model_parallel``): rows 3-5 with a valid-key
count, and ``configs/train_tp_sp.json``'s tensor, sequence and expert
parallelism, ring attention, the TP checkpoint and TP serving on two
gloo ranks sharing the card (``--model-parallel-child``), against one
process and a float32 control.

The phases above are described one by one; they run in this order: the
build, phases ``kernels``, ``kernels_bwd``, ``flash_masked``, the kernel cases of
``serve_f32`` and ``probes``, and the timed
kernel cases of phases ``encoder``, ``families`` and ``detr`` (phase
``kernels_large``) alone on the card; then the recipes (phase
``recipes`` and phase ``convergence``'s, ``--recipe-child``) and a
second process (``--lane-child``: phases ``io``, ``families``,
``one_stage``, ``detr``, ``finetune``, ``resnet`` and ``moe``, one after
another) start, and the main process runs ``serving``, ``deploy``,
``serve_f32``, ``train``, ``train_state``, ``train_1024``, ``train_1024_relpos``,
``train_1024_w14``, ``encoder``, ``main`` and ``parallel`` beside them; ``model_parallel``
runs last, alone. The times of the phases that overlap are taken with
the others running beside them. It
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

import contextlib
import dataclasses
import gc
import json
import math
import shutil
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
LARGE_CONFIG = ROOT / "configs" / "train_1024_large_window14.json"
FSDP_LARGE_CONFIG = ROOT / "configs" / "fsdp_large.json"

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
REQUEST_REPEATS = 3
SERVING_KERNELS = ("short_attention", "flash_attention", "roi_align")
# the fused RoIAlign probes' kernels: launched on the probe path only
PROBE_KERNELS = ("roi_fused_a", "roi_fused_a0", "roi_fused_e")
# the probe path: RoIs and launches of each kernel's timing
PROBE_K = 8192
PROBE_ITERS = 20
# launches of each probe kernel held to the first one's bits: a race
# shows in some launches only
PROBE_REPEATS = 10
# train phase: one epoch of this many steps through Trainer.train(), then
# steps on one repeated batch (the first TRAIN_WARMUP not timed), over
# which the loss must fall by TRAIN_MIN_DROP (the JAX e2e overfit check)
TRAIN_EPOCH_STEPS = 4
TRAIN_REPEATS = 20
TRAIN_WARMUP = 2
TRAIN_MIN_DROP = 0.10


def _bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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


def _qkv(gen, b, n, h, d, dtype=torch.bfloat16):
    """q, k, v as the encoder makes them: strided views of one fused
    [B, N, 3*H*D] projection in ``dtype``."""
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").to(dtype)
    hd = h * d
    return [qkv[..., i * hd:(i + 1) * hd].view(b, n, h, d) for i in range(3)]


def _mask_work(b, n, key_mask) -> tuple[int, int]:
    """(bytes of the mask, key columns the data needs summed over the
    batch: N a row without a mask, the kept keys of its row with one)."""
    from layoutdit_tpu_torch.ops.short_attention import key_mask_rows

    if key_mask is None:
        return 0, b * n
    return key_mask.numel(), int(key_mask_rows(key_mask, b).sum())


def _sdpa_mask(b, key_mask):
    """SDPA's boolean attn_mask [B, 1, 1, N] (True takes part) for a key
    mask read modulo its rows."""
    from layoutdit_tpu_torch.ops.short_attention import key_mask_rows

    return None if key_mask is None else key_mask_rows(key_mask, b)[:, None, None]


def _short_fwd_case(gen, b, n, h=12, d=64, key_mask=None) -> dict:
    """Row 1 at one shape against its plain version, timed on the card
    alone and per call, beside SDPA. The training form (o and lse) gives
    the inference form's bits and the plain lse within 1e-2. With a key
    mask [rows, N]: the mask in the plain version and SDPA too, and the
    kernel under an all-True mask giving the unmasked kernel's bits. The
    bound counts Q, K, V, O and the mask once, and the products over the
    kept keys only."""
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, b, n, h, d)
    label = f"short_attention B={b} N={n} H={h}" + (" (key mask)" if key_mask is not None else "")
    o = sa.short_attention(q, k, v, key_mask=key_mask)
    want, want_lse = sa.short_attention_plain(q, k, v, key_mask=key_mask, return_lse=True)
    err, tol = _check_close(label, o, want)
    o_train, lse = sa.short_attention(q, k, v, key_mask=key_mask, return_lse=True)
    lse_err = (lse - want_lse).abs().max().item()
    if not (torch.equal(o_train, o) and lse_err <= 1e-2):
        raise RuntimeError(f"{label}: the lse form gave other bits or an lse off by {lse_err}")
    print(f"  {label}: the lse form gives the same o, lse max_abs_err {lse_err:.6g}")
    del o, want, want_lse, o_train, lse
    if key_mask is not None:
        everything = torch.ones_like(key_mask)
        if not torch.equal(sa.short_attention(q, k, v, key_mask=everything),
                           sa.short_attention(q, k, v)):
            raise RuntimeError(f"{label}: an all-True mask changed the kernel's bits")
        print(f"  {label}: an all-True mask gives the unmasked kernel's bits")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask_t = _sdpa_mask(b, key_mask)
    mask_bytes, cols = _mask_work(b, n, key_mask)
    nbytes = 4 * b * n * h * d * 2 + mask_bytes
    bound, by = _bound_ms(nbytes, 4 * h * n * cols * d)
    kernel = lambda: sa.short_attention(q, k, v, key_mask=key_mask)  # noqa: E731
    library = lambda: sdpa(qt, kt, vt, attn_mask=mask_t)  # noqa: E731
    ms = _device_ms(kernel, 50)
    _print_share(label, ms, bound, by)
    return {
        "shape": f"B={b} N={n} H={h} D={d} bf16"
                 + (f", key mask [{key_mask.shape[0]}, {n}]" if key_mask is not None else ""),
        "max_abs_err": err, "tolerance": tol,
        "ms": ms,  # the card's time (_device_ms); call_ms with the host's
        "call_ms": _time_ms(kernel, 50),
        "plain_ms": _time_ms(lambda: sa.short_attention_plain(q, k, v, key_mask=key_mask), 20),
        "lse_err": lse_err,
        "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
        "library_ms": _device_ms(library, 50),
        "library_call_ms": _time_ms(library, 50),
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


def _roi_inputs(gen, image: int, b=4, k=512, c=256, dtype=torch.bfloat16):
    """A pyramid of the serving path's shapes in the detector's own layout
    (p2..p5 channels-last, the fifth level the strided view
    p5[..., ::2, ::2], as the FPN makes it), in ``dtype``, and 512 RoIs
    per image with log-uniform sizes (all levels used), a fifth of them
    masked."""
    g = image // 16
    feats = [torch.randn(b, c, s, s, generator=gen, device="cuda").to(dtype)
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


def _short_bwd_case(gen, b, n, h=12, d=64, key_mask=None) -> dict:
    """Row 2 at one shape (see ``_short_fwd_case``; with a key mask also
    the dropped keys' dk and dv rows exactly 0)."""
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, b, n, h, d)
    o, lse = sa.short_attention(q, k, v, key_mask=key_mask, return_lse=True)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="cuda")
    out = tuple(sa.split_qkv(dqkv, h))
    got = sa.short_attention_bwd(q, k, v, o, do, out=out, key_mask=key_mask, lse=lse)
    again = torch.empty_like(dqkv)
    sa.short_attention_bwd(q, k, v, o, do, out=tuple(sa.split_qkv(again, h)), key_mask=key_mask,
                           lse=lse)
    want = sa.short_attention_bwd_plain(q, k, v, o, do, key_mask=key_mask)
    label = f"short_attention_bwd B={b} N={n} H={h}" + (" (key mask)" if key_mask is not None
                                                        else "")
    # at N=1 the softmax is constant, so dq and dk are 0 in exact
    # arithmetic: both sides give fp32 rounding noise of dO.v - dO.o (terms
    # of order 10), which the relative tolerance cannot measure; the floor
    # is far below one bf16 ulp of that call's dv (|dv| of order 1)
    floor = SINGLE_TOKEN_FLOOR if n == 1 else 0.0
    errs, tols = zip(*(_check_close(f"{label} {name}", g, w, floor)
                       for name, g, w in zip(("dq", "dk", "dv"), got, want)))
    del want
    if not torch.equal(dqkv, again):
        raise RuntimeError(f"{label}: two runs gave different gradients")
    del again
    if key_mask is not None:
        dropped = ~_sdpa_mask(b, key_mask)[:, 0, 0]  # [B, N]
        if got[1][dropped].any() or got[2][dropped].any():
            raise RuntimeError(f"{label}: a dropped key has a non-zero dk or dv row")
        everything = torch.ones_like(key_mask)
        if not all(torch.equal(x, y) for x, y in zip(
                sa.short_attention_bwd(q, k, v, o, do, key_mask=everything, lse=lse),
                sa.short_attention_bwd(q, k, v, o, do, lse=lse))):
            raise RuntimeError(f"{label}: an all-True mask changed the kernel's bits")
        print(f"  {label}: dropped keys' dk, dv rows 0; an all-True mask gives the unmasked "
              f"kernel's bits")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ot = sdpa(qt, kt, vt, attn_mask=_sdpa_mask(b, key_mask))
    dot = do.transpose(1, 2)
    mask_bytes, cols = _mask_work(b, n, key_mask)
    nbytes = 8 * b * n * h * d * 2 + mask_bytes  # q, k, v, o, dO in; dq, dk, dv out
    bound, by = _bound_ms(nbytes, 10 * h * n * cols * d)
    kernel = lambda: sa.short_attention_bwd(q, k, v, o, do, out=out, key_mask=key_mask,  # noqa
                                            lse=lse)
    ms = _device_ms(kernel, 20)
    _print_share(label, ms, bound, by)
    grad = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    return {
        "shape": f"B={b} N={n} H={h} D={d} bf16, q/k/v and dq/dk/dv strided in fused [B, N, 3HD]"
                 + (f", key mask [{key_mask.shape[0]}, {n}]" if key_mask is not None else ""),
        "max_abs_err": max(errs), "tolerance": tols[errs.index(max(errs))],
        "ms": ms,  # the card's time (_device_ms); call_ms with the host's
        "call_ms": _time_ms(kernel, 20),
        "plain_ms": _time_ms(lambda: sa.short_attention_bwd_plain(q, k, v, o, do,
                                                                  key_mask=key_mask), 5),
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


def _flash_bwd_work(b: int, n: int, h: int, d: int = 64):
    """(bytes, operations) of each flash backward kernel and of the whole
    backward at one shape, without the bias's bytes; and the bias [H, N, N]
    fp32's bytes."""
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


def _flash_bwd_entry(entry: dict, part: str, key: str, r: dict, b: int, n: int, h: int,
                     with_bias: bool, d: int = 64) -> None:
    """``entry`` (row 4 or 5 of the kernels line) gains the ``key``-prefixed
    numbers of its kernel (``part``: dq or dkdv) from one
    ``_flash_bwd_case`` result ``r``."""
    w, bias_bytes = _flash_bwd_work(b, n, h, d)
    if not with_bias:
        bias_bytes = 0
    (err, tol), ms = r[part]
    bound, by = _bound_ms(w[part][0] + bias_bytes, w[part][1])
    pair_bound, pair_by = _bound_ms(w["pair"][0] + bias_bytes, w["pair"][1])
    _print_share(f"flash_attention_bwd_{part} {key or 'nobias_'}B={b} N={n} H={h}", ms,
                 bound, by)
    entry.update({
        f"{key}bound_share": bound / ms,
        f"{key}shape": f"B={b} N={n} H={h} D={d} bf16"
                       + (f", fp32 bias [{h}, {n}, {n}]" if with_bias else ", no bias")
                       + ", q/k/v and dq/dk/dv strided in fused [B, N, 3HD]",
        f"{key}max_abs_err": err, f"{key}tolerance": tol, f"{key}ms": ms,
        f"{key}plain_ms": r["plain"], f"{key}bound_ms": bound,
        f"{key}bound_by": by, f"{key}library_ms": r["library"],
        f"{key}pair_ms": r["dq"][1] + r["dkdv"][1],
        f"{key}pair_bound_ms": pair_bound, f"{key}pair_bound_by": pair_by,
    })


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
            _flash_bwd_entry(entry, part, key, res[key], bb, nn, h, with_bias=bool(key))
        entries.append(entry)

    entry = {
        "name": "flash_attention_bwd_dbias", "route": "cuda",
        "source": "layoutdit_tpu_torch/csrc/flash_attention.cu",
        "replaces": "layoutdit_tpu/ops/flash_attention.py:292",
        "plain_and_library_compute": "every gradient in one call, the bias's included",
    }
    for key, bb, nn in (("", b, n), ("w256_", wb, wn)):
        w, bias_bytes = _flash_bwd_work(bb, nn, h, d)
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


# The masked flash kernels' shapes (rows 3-6 with a key mask, read modulo
# its rows): dit-base at 1024 px in 14 x 14 windows, the 64 x 64 grid
# padded to 70 x 70 (25 windows of 196 slots, the mask [25, 196] over four
# pages, a [12, 196, 196] relative-position bias); 224 px with
# pad_tokens_to=256 and a bias (197 real tokens, the bias zero on the
# padding, as the encoder pads it), at the train step's batch of 16; 1024
# px with pad_tokens_to=4224 and no bias (4097 real tokens; rows 3-5)
FLASH_MASKED_CASES = {"w14": dict(b=100, n=196, grid=64, ws=14, bias=True),
                      "pad224": dict(b=16, n=256, real=197, bias=True),
                      "pad4224": dict(b=4, n=4224, real=4097, bias=False)}


def _flash_masked_mask(case: dict) -> torch.Tensor:
    """The key mask [rows, N] of a FLASH_MASKED_CASES entry, on the card:
    the window mask of ``models/vit.py`` or a prefix of the real tokens."""
    from layoutdit_tpu_torch.models.vit import _window_key_mask

    if "ws" in case:
        return _window_key_mask(case["grid"], case["grid"], case["ws"]).cuda()
    return (torch.arange(case["n"], device="cuda") < case["real"])[None]


def _flash_masked_case(gen, b: int, n: int, key_mask: torch.Tensor, with_bias: bool,
                       h: int = 12, d: int = 64) -> dict:
    """Rows 3-6 with a key mask at one shape, against their plain
    versions on the same bf16 inputs (o, lse; dq, dk, dv; dbias with a
    bias); a second run must give the same bits, the dropped keys' dk and
    dv rows must be exactly 0, and an all-True mask must give the
    unmasked kernels' bits (forward and backward). Each kernel is timed on
    the card alone (``_device_ms``) beside SDPA with the mask (boolean, or
    with a bias the bias with the dropped keys at -inf, bf16); with a bias
    the dbias kernel beside SDPA's whole backward with the bias (bf16)
    as a mask that requires a gradient, plus a constant [B, 1, 1, N] mask
    of 0 and -inf: autograd sums dS over the batch, as the kernel does.
    The bounds count the kept keys' work: K and V rows, products and bias
    columns a kept key needs (as ``n_keys``'s)."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import short_attention as sa

    scale = 1.0 / math.sqrt(d)
    rows = key_mask.shape[0]
    label = (f"flash masked B={b} N={n} H={h} mask [{rows}, {n}]"
             + (" (bias)" if with_bias else ""))
    q, k, v = _qkv(gen, b, n, h, d)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    bias = None
    if with_bias:
        bias = 0.5 * torch.randn(h, n, n, generator=gen, device="cuda")
        if rows == 1:  # pad_tokens_to: zeros on the padded entries
            real = key_mask[0]
            bias = bias * (real[:, None] & real[None, :])
    keep = sa.key_mask_rows(key_mask, b)  # [B, N]
    everything = torch.ones_like(key_mask)

    o, lse = fa.flash_attention_fwd(q, k, v, bias, scale, key_mask=key_mask)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, bias, scale, key_mask=key_mask)
    errs = {"o": _check_close(f"{label} o", o, o_ref)}
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  {label} lse: max_abs_err {lse_err:.6g} (tolerance 0.01)")
    if not lse_err <= 1e-2:
        raise RuntimeError(f"{label}: lse disagrees with its plain version")
    del o_ref, lse_ref
    again = fa.flash_attention_fwd(q, k, v, bias, scale, key_mask=key_mask)
    if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
        raise RuntimeError(f"{label}: two forward launches gave different bits")
    unmasked = fa.flash_attention_fwd(q, k, v, bias, scale)
    if not all(torch.equal(x, y) for x, y in zip(
            unmasked, fa.flash_attention_fwd(q, k, v, bias, scale, key_mask=everything))):
        raise RuntimeError(f"{label}: an all-True mask changed the forward's bits")
    del again

    dqkv = torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="cuda")
    again = torch.empty_like(dqkv)
    out = tuple(sa.split_qkv(dqkv, h))
    dbias = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, scale, out=out,
                                   bias_grad=with_bias, key_mask=key_mask)[3]
    dbias2 = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, scale,
                                    out=tuple(sa.split_qkv(again, h)), bias_grad=with_bias,
                                    key_mask=key_mask)[3]
    if not (torch.equal(dqkv, again) and (not with_bias or torch.equal(dbias, dbias2))):
        raise RuntimeError(f"{label}: two backward runs gave different bits")
    del again, dbias2
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, bias, scale, key_mask=key_mask)
    for name, g, w in zip(("dq", "dk", "dv"), out, want):
        errs[name] = _check_close(f"{label} {name}", g, w)
    if with_bias:
        errs["dbias"] = _check_close(f"{label} dbias", dbias, want[3], rel=DBIAS_REL_TOL)
    del want
    if out[1][~keep].any() or out[2][~keep].any():
        raise RuntimeError(f"{label}: a dropped key with a nonzero dk or dv")
    plain_grads = fa.flash_attention_bwd(q, k, v, *unmasked, do, bias, scale, bias_grad=with_bias)
    all_grads = fa.flash_attention_bwd(q, k, v, *unmasked, do, bias, scale, bias_grad=with_bias,
                                       key_mask=everything)
    if not all(x is y or torch.equal(x, y) for x, y in zip(plain_grads, all_grads)):
        raise RuntimeError(f"{label}: an all-True mask changed the backward's bits")
    del plain_grads, all_grads, unmasked
    print(f"  {label}: the same bits on a second run, the dropped keys' dk and dv 0, an "
          "all-True mask the unmasked kernels' bits")

    # the work the data needs: per batch element its row's kept keys
    kept = int(keep.sum())
    mask_bytes = key_mask.numel()
    row, kv_row, vec = b * n * h * d * 2, kept * h * d * 2, b * h * n * 4
    flops = 2 * h * n * kept * d  # one product over the kept keys
    bias_bytes = h * n * int(keep.any(0).sum()) * 4 if with_bias else 0
    bounds = {"fwd": _bound_ms(2 * row + 2 * kv_row + vec + bias_bytes + mask_bytes, 2 * flops),
              "dq": _bound_ms(4 * row + 2 * kv_row + 2 * vec + bias_bytes + mask_bytes,
                              3 * flops),
              "dkdv": _bound_ms(4 * row + 2 * kv_row + 2 * vec + bias_bytes + mask_bytes,
                                4 * flops)}
    delta = torch.empty(b * h, n, dtype=torch.float32, device="cuda")
    dq, dk, dv = out
    calls = {
        "fwd": lambda: fa.flash_attention_fwd(q, k, v, bias, scale, key_mask=key_mask),
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, bias, scale, dq, delta, -1,
                                                key_mask),
        "dkdv": lambda: fa.flash_attention_bwd_dkdv(q, k, v, lse, do, delta, bias, scale, dk, dv,
                                                    -1, key_mask),
    }
    if with_bias:
        # the bias read and dbias written, the kept columns' S and dP
        bounds["dbias"] = _bound_ms(2 * row + 2 * kv_row + 2 * vec + 2 * bias_bytes + mask_bytes,
                                    2 * flops)
        calls["dbias"] = lambda: fa.flash_attention_bwd_dbias(q, k, v, lse, do, delta, bias,
                                                              scale, dbias, key_mask)
    res = {"shape": f"B={b} N={n} H={h} D={d} bf16, key mask [{rows}, {n}] ({kept} of {b * n} "
                    "keys kept)" + (f", fp32 bias [{h}, {n}, {n}]" if with_bias else ", no bias"),
           "lse_max_abs_err": lse_err}
    for part, fn in calls.items():
        ms = _device_ms(fn, FLASH_BWD_ITERS)
        err, tol = errs["o"] if part == "fwd" else (
            max(errs["dk"], errs["dv"]) if part == "dkdv" else errs[part])
        bound, by = bounds[part]
        _print_share(f"{label} {part} on the card", ms, bound, by)
        res[part] = {"ms": ms, "max_abs_err": err, "tolerance": tol, "bound_ms": bound,
                     "bound_by": by, "bound_share": bound / ms}
    res["plain_ms"] = {
        "fwd": _time_ms(lambda: fa.flash_attention_plain(q, k, v, bias, scale,
                                                         key_mask=key_mask), 2),
        "bwd": _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, bias, scale,
                                                             key_mask=key_mask), 2)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn = keep[:, None, None, :]  # [B, 1, 1, N]
    if with_bias:
        attn = torch.where(attn, bias[None], float("-inf")).to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ot = sdpa(qt, kt, vt, attn_mask=attn)
    dot = do.transpose(1, 2)
    res["library_ms"] = {
        "fwd": _device_ms(lambda: sdpa(qt, kt, vt, attn_mask=attn), FLASH_BWD_ITERS),
        "bwd": _device_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                          FLASH_BWD_ITERS)}
    del qt, kt, vt, ot, attn
    if with_bias:
        shared = bias.to(torch.bfloat16).requires_grad_()
        drop = torch.zeros(b, 1, 1, n, dtype=torch.bfloat16, device="cuda").masked_fill(
            ~keep[:, None, None, :], float("-inf"))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ot = sdpa(qt, kt, vt, attn_mask=shared[None] + drop)
        wrt = (qt, kt, vt, shared)
        lib_dbias = torch.autograd.grad(ot, wrt, dot, retain_graph=True)[3].float()
        fro = ((lib_dbias - dbias).norm() / dbias.norm()).item()
        print(f"  {label}: SDPA's dbias against the kernel's: relative Frobenius {fro:.6g}")
        res["library_dbias_rel_frobenius"] = fro
        res["library_ms"]["dbias"] = _device_ms(
            lambda: torch.autograd.grad(ot, wrt, dot, retain_graph=True), FLASH_BWD_ITERS)
        del qt, kt, vt, ot, wrt, shared, drop, lib_dbias
    print(f"  {label}: SDPA with the mask {res['library_ms']}, plain {res['plain_ms']}")
    torch.cuda.empty_cache()
    return res


def _masked_core_case(gen, b: int, n: int, key_mask: torch.Tensor, with_bias: bool,
                      h: int = 12, d: int = 64) -> dict:
    """``models/vit.py``'s ``attention_core`` with a key mask (and a bias
    that requires a gradient) on the card, forward and backward through
    autograd: it must launch each masked flash kernel once (dbias with a
    bias) and agree with the plain versions (the bf16 rule; dbias 1e-4),
    the plain backward at the kernels' o (delta = rowsum(dO o O) comes
    from it)."""
    from layoutdit_tpu_torch.models.vit import attention_core
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import short_attention as sa

    label = f"attention_core B={b} N={n} mask [{key_mask.shape[0]}, {n}]" + (
        " (bias)" if with_bias else "")
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    bias = 0.5 * torch.randn(h, n, n, generator=gen, device="cuda") if with_bias else None
    cot = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    names = ("flash_attention_masked", "flash_attention_bwd_dq_masked",
             "flash_attention_bwd_dkdv_masked", "flash_attention_bwd_dbias_masked")
    before = _counts()
    x = qkv.clone().requires_grad_()
    bb = None if bias is None else bias.clone().requires_grad_()
    out = attention_core(x, h, key_mask=key_mask, bias=bb)
    out.backward(cot)
    launched = {name: _counts()[name] - before[name] for name in names}
    if launched != dict(zip(names, (1, 1, 1, int(with_bias)))):
        raise RuntimeError(f"{label}: masked flash launches {launched}")
    q, k, v = sa.split_qkv(qkv, h)
    o, lse = fa.flash_attention_plain(q, k, v, bias, key_mask=key_mask)
    errs = {"o": _check_close(f"{label} o", out, o)[0]}
    dq, dk, dv, dbias = fa.flash_attention_bwd_plain(q, k, v, out.detach(), lse, cot, bias,
                                                     key_mask=key_mask)
    errs["dqkv"] = _check_close(f"{label} dqkv", x.grad, torch.cat(
        [t.reshape(b, n, -1) for t in (dq, dk, dv)], dim=-1))[0]
    if with_bias:
        errs["dbias"] = _check_close(f"{label} dbias", bb.grad, dbias, rel=DBIAS_REL_TOL)[0]
    del qkv, x, bb, out, o, lse, dq, dk, dv, dbias
    torch.cuda.empty_cache()
    return {"launches": launched, "max_abs_err": errs}


def phase_flash_masked(gen) -> list[dict]:
    """Rows 3-6 with a key mask (``_flash_masked_case``) at the three
    FLASH_MASKED_CASES shapes, one kernels-line entry a masked kernel (the
    dbias kernel's without the bias-free case), and each shape through
    ``attention_core`` (``_masked_core_case``)."""
    res = {}
    for key, case in FLASH_MASKED_CASES.items():
        mask = _flash_masked_mask(case)
        res[key] = _flash_masked_case(gen, case["b"], case["n"], mask, case["bias"])
        res[key]["attention_core"] = _masked_core_case(gen, case["b"], case["n"], mask,
                                                       case["bias"])
    # the kernel bodies in the JAX source: with a bias (the slice's path),
    # without one
    jax_src = "layoutdit_tpu/ops/flash_attention.py"
    parts = {"fwd": ("flash_attention_masked", {"replaces": f"{jax_src}:64",
                                                "nobias_replaces": f"{jax_src}:180"}),
             "dkdv": ("flash_attention_bwd_dkdv_masked", {"replaces": f"{jax_src}:217",
                                                          "nobias_replaces": f"{jax_src}:280"}),
             "dq": ("flash_attention_bwd_dq_masked", {"replaces": f"{jax_src}:253",
                                                      "nobias_replaces": f"{jax_src}:286"}),
             "dbias": ("flash_attention_bwd_dbias_masked", {"replaces": f"{jax_src}:292"})}
    entries = []
    for part, (name, replaces) in parts.items():
        entry = {"name": name, "route": "cuda",
                 "source": "layoutdit_tpu_torch/csrc/flash_attention.cu", **replaces}
        first = True
        for key, r in res.items():
            if part not in r:
                continue
            numbers = {**r[part], "shape": r["shape"],
                       "attention_core": r["attention_core"],
                       "plain_ms": r["plain_ms"]["fwd" if part == "fwd" else "bwd"],
                       "library_ms": r["library_ms"][part if part in ("fwd", "dbias")
                                                     else "bwd"]}
            if part == "dbias":
                numbers["plain_and_library_compute"] = ("every gradient in one call, the "
                                                        "bias's included")
                numbers["library_dbias_rel_frobenius"] = r["library_dbias_rel_frobenius"]
            elif part != "fwd":
                numbers["plain_and_library_compute"] = "every gradient in one call"
            if first:  # the window shape: the slice's main path
                entry.update(numbers)
                first = False
            entry.update({f"{key}_{k}": v for k, v in numbers.items()})
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


def _einsum_order(eq: str, names: list[str], *operands) -> str:
    """The contraction order ``torch.einsum`` takes for these operands, as
    nested pairs of their ``names``: opt_einsum's path where PyTorch uses
    it, else left to right."""
    oe = torch.backends.opt_einsum
    if not (oe.enabled and oe.is_available()):
        return "left to right (no opt_einsum)"
    terms = list(names)
    for pair in oe.get_opt_einsum().contract_path(eq, *operands, optimize=oe.strategy)[0]:
        picked = [terms[i] for i in sorted(pair)]
        for i in sorted(pair, reverse=True):
            del terms[i]
        terms.append(f"({' x '.join(picked)})")
    return f"opt_einsum {oe.strategy}: {terms[0]}"


def _same_bits(name: str, first: torch.Tensor, fn) -> None:
    """Raise unless PROBE_REPEATS more launches give ``first``'s bits."""
    for i in range(PROBE_REPEATS):
        if not torch.equal(fn(), first):
            raise RuntimeError(f"{name}: launch {i + 2} differs from the first")


def phase_probes(gen, kernels: list[dict]) -> list[dict]:
    """The fused RoIAlign probes (rows 9-11), then their path.

    On the probe's inputs at K = 8192 (``probe_inputs``: 0/1 weights) each
    kernel (rows 9 and 11 at kb 8 and 16) against its plain version and
    against itself on PROBE_REPEATS more launches (the same bits), timed
    beside its bound (``bound_share``), its plain version, one PyTorch
    call of the same function (rows 9 and 11: ``torch.einsum``, checked
    like a kernel, its contraction order printed) and the yardstick
    (``two_gemm``: two cuBLAS calls, which the port never takes; for row
    10, which stops at t, its one matrix product, and ``fill_`` of t's
    bytes). Row 11's ``ms`` is its kernel alone, ``relayout_ms`` the call
    with the wrapper's relayout to [K, 7, 7, C], ``row9_ratio`` its
    kernel against row 9 in the same phase. Row 9 on
    real RoIs: one 224 px pyramid with 8192 RoIs through ``roi_atlas``
    (timed apart) into ``variant_a`` (kb 16), against row 7's
    ``multiscale_roi_align`` on the same pyramid and RoIs. The atlas
    form's forward and custom backward (``pooled_from_weights_native``,
    two matrix products each) at rows 7-8's 224 px train shapes (B = 16,
    K = 512), against rows 7-8. Last, the probe path: the probe tool,
    ``tools/probe_roi_fused.main``, with the counts set to 0 just before
    it."""
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
    # one PyTorch call of rows 9 and 11's function, on bf16 weights cast
    # before the timing; checked like a kernel
    eq = "kph,chw,kqw->kqpc"
    wyb, wxb = wy.to(torch.bfloat16), wx.to(torch.bfloat16)
    one_call = lambda: torch.einsum(eq, wyb, f, wxb)  # noqa: E731
    einsum_err, einsum_tol = _check_close("torch.einsum (one call)", one_call(), plain)
    einsum_ms = _time_ms(one_call, PROBE_ITERS)
    order = _einsum_order(eq, ["wy", "f", "wx"], wyb, f, wxb)
    print(f"  torch.einsum {eq} {einsum_ms:.4f} ms, contraction order {order}")
    del wyb, wxb

    def fused(name, fn, timed, plain_fn, line, kbs):
        """Rows 9 and 11, each kb against row 9's plain version (row 11's
        is that, laid out as its kernel writes it); ``timed`` is the call
        timed as the kernel's ``ms``."""
        bound, by = _bound_ms(*work["fused"])
        entry = {"name": name, "route": "cuda", "source": "layoutdit_tpu_torch/csrc/roi_fused.cu",
                 "replaces": f"scripts/probe_roi_fused.py:{line}", "shape": f"{shape}, kb={kbs[0]}",
                 "bound_ms": bound, "bound_by": by,
                 "plain_ms": _time_ms(lambda: plain_fn(f, wy, wx), 2),
                 "library_ms": einsum_ms,
                 "library": f"torch.einsum {eq}: one call on bf16 operands, contraction "
                            f"order {order}",
                 "library_max_abs_err": einsum_err, "library_tolerance": einsum_tol,
                 "two_gemm_ms": two_gemm_ms,
                 "two_gemm": "two cuBLAS calls (pooled_from_weights_native)"}
        for kb in kbs:
            got = fn(f, wy, wx, kb=kb)
            err, tol = _check_close(f"{name} kb={kb}", got, plain)
            yard = (got.float() - ref.float()).abs().max().item()
            print(f"    against two_gemm: max_abs_diff {yard:.6g}")
            _same_bits(f"{name} kb={kb}", got, lambda: fn(f, wy, wx, kb=kb))
            del got
            key = "" if kb == kbs[0] else f"kb{kb}_"
            ms = _time_ms(lambda: timed(f, wy, wx, kb=kb), PROBE_ITERS)
            _print_share(f"{name} kb={kb}", ms, bound, by)
            entry.update({f"{key}max_abs_err": err, f"{key}tolerance": tol,
                          f"{key}two_gemm_max_abs_diff": yard, f"{key}ms": ms,
                          f"{key}bound_share": bound / ms})
        return entry

    a = fused("roi_fused_a", rf.variant_a, rf.variant_a, rf.variant_a_plain, 101, (8, 16))
    # row 11: ms is the kernel alone (its channel-major layout), relayout_ms
    # the wrapper's default call with the relayout to [K, 7, 7, C]
    e = fused("roi_fused_e", rf.variant_e,
              lambda *x, kb: rf.variant_e(*x, kb=kb, kernel_layout=True),
              lambda *x: rf.variant_e_plain(*x, kb=8), 187, (8, 16))
    for kb, key in ((8, ""), (16, "kb16_")):
        e[f"{key}relayout_ms"] = _time_ms(lambda: rf.variant_e(f, wy, wx, kb=kb), PROBE_ITERS)
        e[f"{key}row9_ratio"] = e[f"{key}ms"] / a[f"{key}ms"]
        print(f"  roi_fused_e kb={kb}: with the relayout {e[f'{key}relayout_ms']:.6g} ms; "
              f"kernel alone / row 9 {e[f'{key}row9_ratio']:.4f}")
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
    # the card's rate for t's bytes written alone: fill_ of a tensor of t's size
    t_out = torch.empty(k * 7 * w, c, dtype=torch.bfloat16, device="cuda")
    a0["fill_ms"] = _time_ms(lambda: t_out.fill_(1.0), PROBE_ITERS)
    print(f"  fill_ of t's {t_out.numel() * 2 / 1e9:.4f} GB: {a0['fill_ms']:.4f} ms")
    del t_out
    for relayout in (False, True):
        want = rf.variant_a0_plain(f, wy, relayout)
        got = rf.variant_a0(f, wy, kb=16, relayout=relayout)
        err, tol = _check_close(f"roi_fused_a0 kb=16 relayout={relayout}", got, want)
        _same_bits(f"roi_fused_a0 relayout={relayout}", got,
                   lambda: rf.variant_a0(f, wy, kb=16, relayout=relayout))
        del want, got
        key = "relayout_" if relayout else ""
        ms = _time_ms(lambda: rf.variant_a0(f, wy, kb=16, relayout=relayout), PROBE_ITERS)
        _print_share(f"roi_fused_a0 relayout={relayout}", ms, bound, by)
        a0.update({f"{key}max_abs_err": err, f"{key}tolerance": tol, f"{key}ms": ms,
                   f"{key}bound_share": bound / ms})
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
    from layoutdit_tpu_torch.ops import matching as lsa
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
        "linear_sum_assignment": lsa.linear_sum_assignment,
    }


# the float32 forms of rows 1, 3 and 7 (float32 serving), a part of their
# kernels' launches, each with an entry of its own in the kernels line
F32 = {"short_attention_f32": "short_attention",
       "flash_attention_f32": "flash_attention",
       "roi_align_f32": "roi_align"}


# the attention kernels' launches with a key mask (padded window slots,
# pad_tokens_to's padding), a part of their launches; the flash kernels'
# masked forms have entries of their own in the kernels line
MASKED = {"short_attention_masked": "short_attention",
          "short_attention_bwd_masked": "short_attention_bwd",
          "flash_attention_masked": "flash_attention",
          "flash_attention_bwd_dq_masked": "flash_attention_bwd_dq",
          "flash_attention_bwd_dkdv_masked": "flash_attention_bwd_dkdv",
          "flash_attention_bwd_dbias_masked": "flash_attention_bwd_dbias"}


def _counts() -> dict:
    counters = _counters()
    return {**{name: fn.launches for name, fn in counters.items()},
            **{name: counters[of].masked_launches for name, of in MASKED.items()},
            **{name: counters[of].f32_launches for name, of in F32.items()}}


def _reset_counts() -> None:
    from layoutdit_tpu_torch.ops import nms

    for fn in _counters().values():
        fn.launches = 0
    for of in MASKED.values():
        _counters()[of].masked_launches = 0
    for of in F32.values():
        _counters()[of].f32_launches = 0
    nms.nms_mask.host_syncs = 0


def _check_pages(pages, results, allow_empty: bool = False) -> int:
    if len(results) != len(pages):
        raise RuntimeError("serving: one result per page expected")
    n_dets = 0
    for page, r in zip(pages, results):
        h, w = page.shape[:2]
        if len(r.boxes) == 0 and not allow_empty:
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


def _plain_attention():
    """The float32 reference's context: every attention wrapper swapped for
    its plain version on the card (``kernel_swap.swapped``). The CPU's
    cores are shared with the processes that run beside the main one, and
    an encoder at 1024 px would take them for tens of seconds."""
    from layoutdit_tpu_torch.tools.kernel_swap import swapped

    return swapped("plain_attention")


def _encoder_reference(model, images: dict) -> None:
    """Encoder taps of one page per bucket: bf16 with the kernels on the
    card vs float32 plain versions, same weights (``_plain_attention``)."""
    from layoutdit_tpu_torch.models.detection.detector import _normalize
    from layoutdit_tpu_torch.models.vit import vit_forward
    from layoutdit_tpu_torch.models.weights_io import tree_map

    cfg = model.cfg
    vit_ref = tree_map(lambda t: t.float(), model.params["backbone"]["vit"])
    for size, img in images.items():
        x = _normalize(img[None].float(), cfg).cuda()
        with torch.inference_mode():
            got = vit_forward(model.params["backbone"]["vit"], x.to(torch.bfloat16),
                              cfg.backbone.vit, cfg.backbone.taps, torch.bfloat16)
            with _plain_attention():
                want = vit_forward(vit_ref, x, cfg.backbone.vit, cfg.backbone.taps,
                                   torch.float32)
        for tap, gt, wt in zip(cfg.backbone.taps, got, want):
            rel = _rel_err(gt, wt)
            print(f"  encoder {size} px tap {tap}: relative error {rel:.4g} against float32 on "
                  f"the card, plain attention (tolerance {ENCODER_REL_TOL})")
            if not rel <= ENCODER_REL_TOL:
                raise RuntimeError("encoder on the card disagrees with the float32 reference")


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float().to(want.device) - want).norm() / want.norm()).item()


def _gradient_reference(backbone_params: dict, cfg, images: torch.Tensor) -> dict:
    """Encoder + FPN gradients under a fixed cotangent on the FPN outputs
    (no sampling involved): bf16 with the kernels on the card against
    float32 plain versions (``_plain_attention``), same weights, for the patch
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
    with _plain_attention():
        want = grads(tree_map(lambda t: t.detach().to(torch.float32, copy=True)
                              .requires_grad_(True), backbone_params),
                     x.cuda(), torch.float32, [t.cuda() for t in cots])
    out = {}
    for name, g, w in zip(names, got, want):
        rel = _rel_err(g, w)
        print(f"  gradient of {name}: relative error {rel:.4g} (tolerance {GRAD_REL_TOL})")
        if not rel <= GRAD_REL_TOL:
            raise RuntimeError(f"gradient of {name} on the card disagrees with the float32 "
                               "reference")
        out[name] = rel
    return out


def _launches_per_step(cfg) -> dict:
    """Kernel launches one train step (one micro-batch) makes, from the
    config: per encoder layer one short or one flash attention (N =
    grid^2 + 1 tokens), or, in a windowed layer, two attentions (the
    windows and the CLS token), each with its backward; one RoIAlign
    forward and backward. Without a relative-position bias the short
    kernels take N <= 256 (windows included) and the flash kernels longer
    sequences; with one, every attention but the CLS token's carries a
    bias and goes to the flash kernels, whose backward then adds the dbias
    kernel. Windows over a grid they do not divide carry a key mask (the
    ``_masked`` counts, a part of the short kernels', or with a bias of
    the flash kernels'). With ``remat`` the backward runs each layer's
    forward again, attention kernels included."""
    from layoutdit_tpu_torch.ops.short_attention import MAX_N as SHORT_MAX_N

    vit = cfg.backbone.vit
    g = cfg.image_size // vit.patch_size
    windowed = sum(0 < vit.window_size < g and not vit.is_global_layer(i)
                   for i in range(1, vit.num_hidden_layers + 1))
    full = vit.num_hidden_layers - windowed
    masked = windowed if windowed and g % vit.window_size else 0
    if vit.use_relative_position_bias or vit.use_shared_relative_position_bias:
        flash = dbias = full + windowed
        short = windowed
        flash_masked, short_masked = masked, 0
    else:
        flash, dbias = (full if g * g + 1 > SHORT_MAX_N else 0), 0
        short = full - flash + 2 * windowed
        if windowed and vit.window_size ** 2 > SHORT_MAX_N:
            raise RuntimeError("a window is longer than the short kernel takes")
        flash_masked, short_masked = 0, masked
    fwd = 2 if cfg.remat else 1
    return {"short_attention": fwd * short, "short_attention_bwd": short,
            "short_attention_masked": fwd * short_masked,
            "short_attention_bwd_masked": short_masked,
            "flash_attention": fwd * flash, "flash_attention_bwd_dq": flash,
            "flash_attention_bwd_dkdv": flash, "flash_attention_bwd_dbias": dbias,
            "flash_attention_masked": fwd * flash_masked,
            "flash_attention_bwd_dq_masked": flash_masked,
            "flash_attention_bwd_dkdv_masked": flash_masked,
            "flash_attention_bwd_dbias_masked": flash_masked,
            "roi_align": 1, "roi_align_bwd": 1, **{name: 0 for name in PROBE_KERNELS}}


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
    from layoutdit_tpu_torch.tools.profile_train import profile_step
    from layoutdit_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        rc = _fixture_run(base, tmp, TRAIN_EPOCH_STEPS * base.data.batch_size)
        rc = dataclasses.replace(rc, train=dataclasses.replace(rc.train, checkpoint_interval=1))
        b = rc.data.batch_size
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
        _check_launches(label, counts, per_step, steps)
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
        _check_launches(label, counts, per_step, TRAIN_REPEATS)
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


# the train_1024_w14 path: an epoch of this many steps at batch 4
W14_STEPS = 3
W14_WINDOW = 14


def phase_train_1024_w14(kernels: list[dict]) -> dict:
    """``train_1024_window_relpos.json`` with ``window_size`` 14 (the file
    as it is, the window overridden): ViTDet's layout at 1024 px, the 64 x
    64 grid padded to 70 x 70 (25 windows of 196 slots), with a BEiT
    relative-position table per layer (drawn at std 0.5 from seed 1, as
    ``train_1024_relpos``'s), so that every windowed layer's attention goes
    to the masked flash kernels with its [12, 196, 196] bias and the
    [25, 196] key mask (100 windows a batch of 4): forward, dq, dkdv and
    dbias; the global layers to the unmasked flash kernels and the CLS
    token to the short ones. The path: ``Trainer.train()`` for one epoch of
    W14_STEPS steps over synthetic pages, launches per step from the
    config, then one 1024 px batch of the trained model served through
    ``BatchInferenceEngine`` (the masked forward again); both are counted.
    Checked beside it: the encoder's taps and gradients of one image (two
    layers' tables among them) against the port's float32 plain path on
    the card."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.train.trainer import Trainer

    label = "train_1024_w14"
    base = load_run_config(str(RELPOS_CONFIG))
    base = dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                               window_size=W14_WINDOW))
    with tempfile.TemporaryDirectory() as tmp:
        rc = _fixture_run(base, tmp, W14_STEPS * base.data.batch_size)
        b = rc.data.batch_size
        cfg = DetectorConfig.from_model_config(rc.model, precision_dtype=rc.compute_dtype)
        vit = cfg.backbone.vit
        params = init_detector(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        tgen = torch.Generator(device="cuda").manual_seed(1)
        for layer in params["backbone"]["vit"]["layers"]:
            t = layer["rel_pos_table"]
            t.copy_(0.5 * torch.randn(t.shape, generator=tgen, device="cuda"))
        trainer = Trainer(rc, DetectorModel(params, cfg))
        per_step = _launches_per_step(cfg)
        print(f"  dit-base Faster R-CNN, {vit.num_hidden_layers} layers, image {cfg.image_size} "
              f"px, batch {b}, {vit.window_size} x {vit.window_size} windows over the "
              f"{vit.grid_size} x {vit.grid_size} grid, a relative-position table "
              f"{list(params['backbone']['vit']['layers'][0]['rel_pos_table'].shape)} per "
              f"layer; launches a step {per_step}")
        if not per_step["flash_attention_bwd_dbias_masked"]:
            raise RuntimeError(f"{label}: the config gives the masked flash kernels no work")

        _reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts, steps = _counts(), trainer.updates
        print(f"  Trainer.train(): {steps} steps in {epoch_s:.3f} s, loss "
              f"{trainer.loss_history}, launches {counts}")
        _check_launches(label, counts, per_step, steps)
        if not np.isfinite(trainer.loss_history).all():
            raise RuntimeError(f"{label}: a non-finite epoch loss")

        model = DetectorModel(trainer.params, cfg)
        engine = BatchInferenceEngine(model, image_sizes=(cfg.image_size,), batch_size=b)
        rng = np.random.default_rng(2)
        pages = [rng.integers(0, 256, (1000 - 5 * i, 770 + 4 * i, 3), dtype=np.uint8)
                 for i in range(b)]
        _reset_counts()
        t0 = time.perf_counter()
        results = engine.predict_pages(pages)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
        served = _counts()
        n_dets = _check_pages(pages, results)
        print(f"  one {cfg.image_size} px batch of {b} pages served: {n_dets} detections in "
              f"{serve_ms:.1f} ms (the first, not warmed up), launches {served}")
        if served["flash_attention_masked"] != per_step["flash_attention_masked"]:
            raise RuntimeError(f"{label}: serving launched the masked flash forward "
                               f"{served['flash_attention_masked']} times")
        for k in kernels:
            k[f"{label}_launches"] = counts[k["name"]] + served[k["name"]]

        it = iter(trainer.dataloader)
        batch = next(it)
        it.close()
        _encoder_reference(model, {cfg.image_size: batch.images[0]})
        grads = _gradient_reference(trainer.params["backbone"], cfg, batch.images[:1])
    return {"config": "configs/train_1024_window_relpos.json with window_size 14: BEiT-base "
                      "layout, 1024 px, batch 4, 14 x 14 windows over a padded grid, bf16 over "
                      "fp32",
            "epoch_steps": steps, "epoch_s": epoch_s, "epoch_loss": trainer.loss_history,
            "launches_per_step": per_step, "serving_launches": served,
            "serving_first_batch_ms": serve_ms, "serving_detections": n_dets,
            "gradient_rel_err": grads}


# encoder phase: dit-large at 1024 px in ViTDet-L's window-14 layout
# (remat off, "full" and "dots"), the repo's dit-large recipe as it is,
# and dit-large serving; timed steps per arm after untimed ones
ENCODER_WARMUP = 2
ENCODER_STEPS = 4
FSDP_STEPS = 2
REMAT_ARMS = (("off", False, "full"), ("full", True, "full"), ("dots", True, "dots"))
# arms' gradients from one state: bit equality expected; a leaf that
# differs is named and held to this relative Frobenius error
ARM_GRAD_RTOL = 1e-3
# the training arms' CLS token and position embeddings, drawn (seed 1)
# where JAX's init leaves them zero: a zero CLS row stays zero through
# every layer, a windowed layer isolates it, and each LayerNorm of it
# (eps 1e-12) scales its gradient by 1e6, so at dit-large's width and
# depth the CLS path's gradients overflow in both packages
EMBED_STD = 0.02
LARGE_SERVING_ROUNDS = 2


def _encoder_kernels(gen, kernels: list[dict]) -> None:
    """(a) Rows 1-2 with the key mask of ViTDet-L's layout at 1024 px (the
    64 x 64 grid in 14 x 14 windows, padded to 70 x 70: 25 windows of 196
    slots, the mask [25, 196] read modulo over 4 pages, B = 100, H = 16),
    held to their plain versions and, under an all-True mask, to the
    unmasked kernels' bits; rows 1-2 unmasked at dit-large's 224 px shape
    (B = 16, N = 197, H = 16); rows 3-5 without a bias at its 1024 px
    global layers (B = 4, N = 4097, H = 16). Each timed beside SDPA (with
    the mask as a boolean attn_mask). The entries of the kernels line gain
    the numbers under ``large_*`` keys."""
    from layoutdit_tpu_torch.models.vit import _window_key_mask

    h = 16
    mask = _window_key_mask(64, 64, 14).cuda()
    b = 4 * mask.shape[0]
    fwd, bwd = _entry(kernels, "short_attention"), _entry(kernels, "short_attention_bwd")
    for key, case in (("large_w14_masked_", dict(b=b, n=196, key_mask=mask)),
                      ("large224_", dict(b=16, n=197))):
        fwd.update({key + k: v for k, v in _short_fwd_case(gen, h=h, **case).items()})
        bwd.update({key + k: v for k, v in _short_bwd_case(gen, h=h, **case).items()})
    torch.cuda.empty_cache()
    q, k, v = _qkv(gen, 4, 4097, h, 64)
    _entry(kernels, "flash_attention").update(
        {f"large_{k}": v for k, v in _flash_fwd_case(gen, q, k, v, False).items()})
    del q, k, v
    res = _flash_bwd_case(gen, 4, 4097, False, h=h)
    for part in ("dq", "dkdv"):
        _flash_bwd_entry(_entry(kernels, f"flash_attention_bwd_{part}"), part, "large_", res,
                         4, 4097, h, with_bias=False)
    torch.cuda.empty_cache()


def _add_launches(kernels: list[dict], counts: dict) -> None:
    for k in kernels:
        k["encoder_launches"] = k.get("encoder_launches", 0) + counts[k["name"]]
        k["encoder_masked_launches"] = k.get("encoder_masked_launches", 0) + counts.get(
            k["name"] + "_masked", 0)


def _check_launches(label: str, counts: dict, per_step: dict, steps: int) -> None:
    for name, want in per_step.items():
        if counts[name] != want * steps:
            raise RuntimeError(f"{label}: {name} launched {counts[name]} times in {steps} "
                               f"steps, expected {want} a step")


def _fixture_run(base, tmp: str, pages: int):
    """``base`` with its training data in ``tmp`` (``pages`` synthetic
    pages at its image size, seed 0) and its artifacts there, one epoch."""
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture

    rc = dataclasses.replace(
        base,
        train=dataclasses.replace(base.train, train_base_path=tmp, train_input="samples",
                                  num_epochs=1),
        run_name="chip_smoke", eval_base_path=tmp,
    )
    make_fixture(tmp, n_images=pages, split="samples", seed=0, image_size=rc.model.image_size)
    return rc


def _allocated_gib() -> float:
    """GiB allocated on the card once the garbage of earlier phases is
    collected: what a peak measured from here starts from."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def _timed_steps(trainer, batch, steps: int) -> tuple[list[float], list[float]]:
    """(step ms, losses) of ``steps`` updates on one batch."""
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    if not np.isfinite(losses).all():
        raise RuntimeError(f"a non-finite loss: {losses}")
    return times, losses


def _large_window14_train(kernels: list[dict]) -> dict:
    """(b) ``configs/train_1024_large_window14.json`` at full width in
    bf16 over fp32 masters (random weights, seed 0), in three arms: remat
    off, "full" (the config's own) and "dots". First the three arms'
    gradients from one state, at JAX's init (its non-finite leaves listed;
    the arms must give the same bits, NaN and inf included) and with the
    CLS token and position embeddings drawn at EMBED_STD (must be finite
    and the same bits; a leaf that is not is named and held to
    ARM_GRAD_RTOL); then per arm a fresh trainer from the drawn state,
    ENCODER_WARMUP untimed and ENCODER_STEPS timed updates on one batch
    (the config's own arm first through ``Trainer.train()``, one epoch):
    step ms, peak GiB, launches per step as the config reckons them (the
    forward kernels twice under remat, the masked windows among the short
    kernels' launches). Peak GiB must order full < dots < off. Then the
    encoder's taps and gradients at one page against float32 plain
    versions on the card; one profiled step per arm (wall, device busy
    and idle share, the backbone, rpn and backward stages)."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_paths
    from layoutdit_tpu_torch.tools.profile_train import profile_step
    from layoutdit_tpu_torch.tools.repeat_step import step_gradients
    from layoutdit_tpu_torch.train.trainer import Trainer

    base = load_run_config(str(LARGE_CONFIG))
    out = {"config": "configs/train_1024_large_window14.json: dit-large, 1024 px, batch 4, "
                     "window 14 (padded grid, key mask), global layers 6/12/18/24, bf16 over "
                     "fp32", "arms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        rc = _fixture_run(base, tmp, base.data.batch_size)
        cfg = DetectorConfig.from_model_config(rc.model, precision_dtype=rc.compute_dtype)
        vit = cfg.backbone.vit
        print(f"  dit-large Faster R-CNN, hidden {vit.hidden_size}, {vit.num_hidden_layers} "
              f"layers, {vit.num_attention_heads} heads, image {cfg.image_size} px, batch "
              f"{rc.data.batch_size}, window {vit.window_size}, global layers "
              f"{[i for i in range(1, vit.num_hidden_layers + 1) if vit.is_global_layer(i)]}")

        def fresh(remat, policy, embeddings=True):
            c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = init_detector(c, gen, device="cuda")
            if embeddings:
                egen = torch.Generator(device="cuda").manual_seed(1)
                with torch.no_grad():
                    for key in ("cls_token", "pos_embed"):
                        t = params["backbone"]["vit"][key]
                        t.copy_(EMBED_STD * torch.randn(t.shape, generator=egen, device="cuda"))
            return c, params

        c, params = fresh(False, "full", embeddings=False)
        probe = Trainer(rc, DetectorModel(params, c))
        it = iter(probe.dataloader)
        batch = next(it)
        it.close()
        probe.dataloader.close()
        del probe
        names = tree_paths(params)
        for state in ("jax_init", "drawn_embeddings"):
            if state == "drawn_embeddings":
                params = fresh(False, "full")[1]
            for t in tree_leaves(params):
                t.requires_grad_(True)
            ref, differing = None, {}
            for name, remat, policy in REMAT_ARMS:
                arm_cfg = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
                grads = step_gradients(params, batch, arm_cfg, seed=0)[1]
                if ref is None:
                    ref = grads
                    nonfinite = [n for n, g in zip(names, grads) if not g.isfinite().all()]
                    continue
                for leaf, a, b in zip(names, ref, grads):
                    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                        differing[f"{name}:{leaf}"] = _rel_err(b, a)
            print(f"  gradients from one state ({state}): {len(names)} leaves, non-finite in "
                  f"remat off: {nonfinite}; {len(differing)} (arm, leaf) pairs differ from "
                  f"remat off in their bits: {differing}")
            if any(not r <= ARM_GRAD_RTOL for r in differing.values()):
                raise RuntimeError(f"remat arms' gradients differ ({state}): {differing}")
            if state == "drawn_embeddings" and nonfinite:
                raise RuntimeError(f"non-finite gradients from the drawn state: {nonfinite}")
            out[state] = {"nonfinite_leaves": nonfinite, "arm_gradients_differing": differing}
            del grads, ref, params
            torch.cuda.empty_cache()

        for name, remat, policy in REMAT_ARMS:
            arm_cfg, params = fresh(remat, policy)
            arm_rc = dataclasses.replace(rc, model=dataclasses.replace(
                rc.model, remat=remat, remat_policy=policy))
            trainer = Trainer(arm_rc, DetectorModel(params, arm_cfg))
            per_step = _launches_per_step(arm_cfg)
            arm = {"launches_per_step": per_step}
            if remat == rc.model.remat and policy == rc.model.remat_policy:
                _reset_counts()
                trainer.train()
                torch.cuda.synchronize()
                counts = _counts()
                _check_launches(f"encoder train {name} epoch", counts, per_step,
                                trainer.updates)
                _add_launches(kernels, counts)
                arm["epoch_loss"] = trainer.loss_history
            _timed_steps(trainer, batch, ENCODER_WARMUP)
            base = _allocated_gib()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            times, losses = _timed_steps(trainer, batch, ENCODER_STEPS)
            peak = torch.cuda.max_memory_allocated() / 2**30
            counts = _counts()
            _check_launches(f"encoder train {name}", counts, per_step, ENCODER_STEPS)
            _add_launches(kernels, counts)
            arm.update({"step_ms": times, **_spread(times), "peak_gib": peak, "base_gib": base,
                        "losses": losses,
                        "images_per_s": rc.data.batch_size * 1e3 / float(np.median(times))})
            print(f"  remat {name}: step median {arm['median']:.3f} ms (min {arm['min']:.3f}, "
                  f"max {arm['max']:.3f}, {ENCODER_STEPS} steps), peak {peak:.4f} GiB ("
                  f"{base:.4f} allocated before the steps: parameters, AdamW state), launches a "
                  f"step {per_step}, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
            r = profile_step(trainer, 0, Path(tmp) / f"large_step_{name}.json")
            arm["profiled_step"] = {k: r[k] for k in ("wall_ms", "device_busy_ms",
                                                      "device_idle_share", "stages")}
            print(f"  remat {name}, one profiled step: wall {r['wall_ms']:.3f} ms, device busy "
                  f"{r['device_busy_ms']:.3f} ms, idle share {r['device_idle_share']:.4f}; "
                  + ", ".join(f"{st} host {r['stages'].get(st, {}).get('host_ms', 0.0):.3f} / "
                              f"device {r['stages'].get(st, {}).get('device_ms', 0.0):.3f} ms"
                              for st in ("backbone", "rpn", "backward")))
            if name == REMAT_ARMS[-1][0]:
                print("  taps and gradients at one page against float32 plain versions on the "
                      "card (kernel_swap's swap)")
                _encoder_reference(DetectorModel(trainer.params, arm_cfg),
                                   {cfg.image_size: batch.images[0]})
                arm["gradient_rel_err"] = _gradient_reference(
                    trainer.params["backbone"], arm_cfg, batch.images[:1])
            out["arms"][name] = arm
            trainer.dataloader.close()
            del trainer, params
            torch.cuda.empty_cache()
    peaks = {name: out["arms"][name]["peak_gib"] for name, _, _ in REMAT_ARMS}
    if not peaks["full"] < peaks["dots"] < peaks["off"]:
        raise RuntimeError(f"remat arms' peak GiB not ordered full < dots < off: {peaks}")
    return out


def _fsdp_large(kernels: list[dict]) -> dict:
    """(c) ``configs/fsdp_large.json`` as it is: dit-large at 224 px, batch
    16 in A = 2 micro-batches, remat "full", its mesh resolved to this one
    card; one epoch through ``Trainer.train()``, then FSDP_STEPS timed
    updates on one batch after one untimed: step ms, peak GiB, finite
    losses, launches per update."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.train.trainer import Trainer

    base = load_run_config(str(FSDP_LARGE_CONFIG))
    with tempfile.TemporaryDirectory() as tmp:
        rc = _fixture_run(base, tmp, base.data.batch_size)
        cfg = DetectorConfig.from_model_config(rc.model, precision_dtype=rc.compute_dtype)
        gen = torch.Generator(device="cuda").manual_seed(0)
        trainer = Trainer(rc, DetectorModel(init_detector(cfg, gen, device="cuda"), cfg))
        accum = rc.train.grad_accumulation_steps
        per_update = {k: v * accum for k, v in _launches_per_step(cfg).items()}
        _reset_counts()
        trainer.train()
        torch.cuda.synchronize()
        counts = _counts()
        _check_launches("encoder fsdp_large epoch", counts, per_update, trainer.updates)
        _add_launches(kernels, counts)
        it = iter(trainer.dataloader)
        batch = next(it)
        it.close()
        _timed_steps(trainer, batch, 1)
        base = _allocated_gib()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        times, losses = _timed_steps(trainer, batch, FSDP_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = _counts()
        _check_launches("encoder fsdp_large", counts, per_update, FSDP_STEPS)
        _add_launches(kernels, counts)
        trainer.dataloader.close()
    out = {"config": "configs/fsdp_large.json: dit-large, 224 px, batch 16 as A = 2 "
                     "micro-batches of 8, remat full, mesh on one card, bf16 over fp32",
           "epoch_loss": trainer.loss_history, "step_ms": times, **_spread(times),
           "peak_gib": peak, "base_gib": base, "losses": losses,
           "launches_per_update": per_update,
           "images_per_s": rc.data.batch_size * 1e3 / float(np.median(times))}
    print(f"  fsdp_large.json: update median {out['median']:.3f} ms (min {out['min']:.3f}, max "
          f"{out['max']:.3f}, {FSDP_STEPS} updates), peak {peak:.4f} GiB ({base:.4f} "
          f"allocated before), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches an update {per_update}")
    del trainer
    torch.cuda.empty_cache()
    return out


def _large_serving(kernels: list[dict]) -> dict:
    """(d) dit-large Faster R-CNN behind ``BatchInferenceEngine`` in the 224
    and 1024 px buckets of ``configs/serving_1024.json`` (backbone_type
    dit-large, random weights, seed 0): LARGE_SERVING_ROUNDS rounds of one
    request per bucket after a warm-up, each checked as ``_check_pages``
    checks them; latency and pages/s per bucket."""
    from layoutdit_tpu_torch.config import load_config
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )

    mc, dl = load_config(str(CONFIG))
    mc = dataclasses.replace(mc, backbone_type="dit-large")
    cfg = DetectorConfig.from_model_config(mc, precision_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    engine = BatchInferenceEngine(DetectorModel(init_detector(cfg, gen, device="cuda"), cfg),
                                  image_sizes=(224, 1024), batch_size=dl.batch_size)
    rng = np.random.default_rng(1)
    requests = {
        "224 px bucket": [rng.integers(0, 256, (200 + 3 * i, 160 + 2 * i, 3), dtype=np.uint8)
                          for i in range(8)],
        "1024 px bucket": [rng.integers(0, 256, (1000 - 5 * i, 770 + 4 * i, 3), dtype=np.uint8)
                           for i in range(4)],
    }
    engine.predict_pages(requests["224 px bucket"][:4] + requests["1024 px bucket"][:4])
    torch.cuda.synchronize()
    _reset_counts()
    latencies = {name: [] for name in requests}
    for _ in range(LARGE_SERVING_ROUNDS):
        for name, pages in requests.items():
            t0 = time.perf_counter()
            results = engine.predict_pages(pages)
            torch.cuda.synchronize()
            latencies[name].append((time.perf_counter() - t0) * 1e3)
            _check_pages(pages, results)
    counts = _counts()
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            raise RuntimeError(f"{name} was not launched serving dit-large")
    for name in ("short_attention_bwd", "short_attention_masked", *PROBE_KERNELS):
        if counts[name]:
            raise RuntimeError(f"{name} was launched serving dit-large")
    _add_launches(kernels, counts)
    out = {}
    for name, pages in requests.items():
        out[name] = {**_spread(latencies[name]), "latency_ms": latencies[name],
                     "pages_per_s": len(pages) * 1e3 / float(np.median(latencies[name]))}
        print(f"  dit-large request ({name}): {len(pages)} pages, latency median "
              f"{out[name]['median']:.2f} ms (min {out[name]['min']:.2f}, max "
              f"{out[name]['max']:.2f}), {out[name]['pages_per_s']:.2f} pages/s")
    del engine
    torch.cuda.empty_cache()
    return out


def phase_encoder(gen, kernels: list[dict], with_kernels: bool = True) -> dict:
    """Encoder coverage: (a) the masked short kernels and rows 1-5 at
    dit-large's shapes (without ``with_kernels``, run before by
    ``_encoder_kernels``), (b) the window-14 dit-large config's three
    remat arms, (c) ``fsdp_large.json``, (d) dit-large serving. The
    launches of (b)-(d) are the ``encoder`` path's."""
    t0 = time.perf_counter()
    for k in kernels:
        k["encoder_launches"] = k["encoder_masked_launches"] = 0
    if with_kernels:
        _encoder_kernels(gen, kernels)
    out = {"train_1024_large_window14": _large_window14_train(kernels),
           "fsdp_large": _fsdp_large(kernels), "serving": _large_serving(kernels)}
    for name in ("short_attention", "short_attention_bwd"):
        if _entry(kernels, name)["encoder_masked_launches"] <= 0:
            raise RuntimeError(f"{name}: no masked launch on the encoder path")
    out["phase_s"] = time.perf_counter() - t0
    print(f"  encoder phase: {out['phase_s']:.1f} s")
    return out


# main phase: the port's command line over make_fixture pages, a training
# split and a held-out eval split of these sizes and seeds
MAIN_TRAIN_PAGES = 32
MAIN_VAL_PAGES = 16
MAIN_KERNELS = ("short_attention", "short_attention_bwd", "roi_align", "roi_align_bwd")
# the main phase's throughput windows: a split of this many pages (seed
# 778) trained on for THROUGHPUT_EPOCHS epochs (the first not counted)
# and scored THROUGHPUT_SCORES times, then once more under the profiler
THROUGHPUT_PAGES = 128
THROUGHPUT_EPOCHS = 3
THROUGHPUT_SCORES = 2


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
    return {"card": card, **result, "launches": counts}


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
TRAIN_STATE_TIMED = 3
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


def _serving_pages() -> tuple[list, list]:
    """The serving phases' pages, from seed 0: eight small pages for the
    224 px bucket and four large ones for the 1024 px bucket."""
    rng = np.random.default_rng(0)
    small = [rng.integers(0, 256, (200 + 3 * i, 160 + 2 * i, 3), dtype=np.uint8)
             for i in range(8)]
    large = [rng.integers(0, 256, (1000 - 5 * i, 770 + 4 * i, 3), dtype=np.uint8)
             for i in range(4)]
    return small, large


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

    small, large = _serving_pages()
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


# the deploy phase: an exported artifact of serving_1024.json's buckets,
# loaded in a fresh process, served over HTTP and driven by the predict tool
DEPLOY_BUCKETS = (224, 1024)
# exported against live detections on the same pages (labels equal)
DEPLOY_BOX_TOL = 1e-2  # px, page coordinates
DEPLOY_SCORE_TOL = 1e-3
DEPLOY_ROUNDS = 2  # timed rounds of the three requests, live and exported (in round order)
HTTP_PAGES = 16  # concurrent POSTs, both buckets, plus one corrupt page
# per-call host cost of an operator against its direct launch: calls
# queued behind the spin kernel, alternating, median of the rounds
HOST_COST_CALLS = 200
HOST_COST_ROUNDS = 5
# the packages an exported artifact must load and run without
NOT_IMPORTED = ("layoutdit_tpu_torch.models", "layoutdit_tpu_torch.config",
                "layoutdit_tpu_torch.eval")


def _host_ms(fn, calls: int) -> float:
    """Host time per call of ``fn`` with the card busy: the calls are queued
    behind a spin kernel, so the host never waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e3


def _host_cost(gen) -> dict:
    """Rows 1, 3 and 7 at their serving shapes: the wrapper through its
    registered operator against the direct launch (what the wrapper did
    before the operators: allocate, check, launch), per call, host only."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, 4, 197, 12, 64)
    qf, kf, vf = _qkv(gen, 4, 4097, 12, 64)
    feats, rois, mask = _roi_inputs(gen, 224, b=4)
    scales = ROI_SCALES
    levels = ra.roi_levels(rois, 5, 224.0, roi_mask=mask)
    b, n, h, d = qf.shape

    def flash_direct():
        o = torch.empty((b, n, h, d), dtype=qf.dtype, device=qf.device)
        lse = torch.empty((b * h, n), dtype=torch.float32, device=qf.device)
        fa.flash_attention_fwd_launch(qf, kf, vf, None, 0.125, o, lse)

    pairs = {
        "short_attention": (lambda: sa.short_attention(q, k, v, 0.125),
                            lambda: sa.short_attention_launch(q, k, v, 0.125, None)),
        "flash_attention": (lambda: fa.flash_attention_fwd(qf, kf, vf, None, 0.125),
                            flash_direct),
        "roi_align": (lambda: ra.roi_align_fwd(feats, rois, levels, scales),
                      lambda: ra.roi_align_launch(feats, rois, levels, scales)),
    }
    out = {}
    for name, (op, direct) in pairs.items():
        ops, directs = [], []
        for _ in range(HOST_COST_ROUNDS):
            ops.append(_host_ms(op, HOST_COST_CALLS))
            directs.append(_host_ms(direct, HOST_COST_CALLS))
        out[name] = {"operator_ms": float(np.median(ops)), "direct_ms": float(np.median(directs)),
                     "operator_runs": ops, "direct_runs": directs}
        print(f"  host cost per call, {name}: operator {out[name]['operator_ms'] * 1e3:.2f} us, "
              f"direct launch {out[name]['direct_ms'] * 1e3:.2f} us (medians of "
              f"{HOST_COST_ROUNDS} x {HOST_COST_CALLS} calls)")
    return out


def _match(want, got) -> tuple[float, float]:
    """Detections of one page as matched sets: the same count, each of
    ``want`` matched to one of ``got`` with its label, boxes within
    DEPLOY_BOX_TOL and scores within DEPLOY_SCORE_TOL -> (largest box,
    largest score difference)."""
    wb, ws, wl = (np.asarray(x) for x in want)
    gb, gs, gl = (np.asarray(x) for x in got)
    if len(wb) != len(gb):
        raise RuntimeError(f"deploy: {len(gb)} detections against {len(wb)}")
    used = np.zeros(len(gb), bool)
    box_err = score_err = 0.0
    for box, score, label in zip(wb, ws, wl):
        db = np.abs(gb - box).max(axis=1) if len(gb) else np.zeros(0)
        ds = np.abs(gs - score)
        cand = np.nonzero((gl == label) & ~used & (db <= DEPLOY_BOX_TOL)
                          & (ds <= DEPLOY_SCORE_TOL))[0]
        if not len(cand):
            raise RuntimeError(f"deploy: no match for label {label} box {box} score {score}")
        j = cand[np.argmin(db[cand])]
        used[j] = True
        box_err, score_err = max(box_err, float(db[j])), max(score_err, float(ds[j]))
    return box_err, score_err


def _deploy_requests():
    rng = np.random.default_rng(0)
    small = [rng.integers(0, 256, (200 + 3 * i, 160 + 2 * i, 3), dtype=np.uint8)
             for i in range(8)]
    large = [rng.integers(0, 256, (1000 - 5 * i, 770 + 4 * i, 3), dtype=np.uint8)
             for i in range(4)]
    return [("224 px bucket", small), ("1024 px bucket", large),
            ("both buckets", small[:4] + large[:2])]


def exported_child(artifact: str, out_path: str) -> int:
    """The deploy phase's fresh process: load the artifact with
    ``ExportedDetector`` (torch, numpy and the port's ops only), serve the
    three requests through it (routing, device resize and padding as the
    engine does them) and write the detections, latencies, launch counts
    and imported modules to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    import bisect

    # the numerics of this script's own process (main), so that the two
    # runs choose the same algorithms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from layoutdit_tpu_torch.export import ExportedDetector
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.ops.interpolate import resize_bilinear

    t0 = time.perf_counter()
    det = ExportedDetector(artifact)
    load_s = time.perf_counter() - t0
    sizes, batch = sorted(det.image_sizes), int(det.manifest["batch_size"])

    chunk_ms = []  # per chunk of the timed rounds: size, prepare, call, fetch

    def serve(pages):
        buckets: dict[int, list[int]] = {}
        for i, p in enumerate(pages):
            j = bisect.bisect_left(sizes, max(p.shape[:2]))
            buckets.setdefault(sizes[min(j, len(sizes) - 1)], []).append(i)
        results = [None] * len(pages)
        for size, idx in buckets.items():
            for start in range(0, len(idx), batch):
                chunk = idx[start:start + batch]
                t0 = time.perf_counter()
                images = torch.zeros((batch, 3, size, size), device=det.device)
                orig = torch.ones((batch, 2), device=det.device)
                with torch.inference_mode():
                    for slot, i in enumerate(chunk):
                        x = torch.from_numpy(pages[i]).to(det.device).float().permute(2, 0, 1)
                        images[slot] = resize_bilinear(x / 255.0, size, size)
                        orig[slot] = torch.tensor(pages[i].shape[:2], dtype=torch.float32)
                    t1 = time.perf_counter()
                    out = det.predict_async(images, orig)
                    t2 = time.perf_counter()
                    out = {k: v.cpu().numpy() for k, v in out.items()}
                chunk_ms.append((size, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                 (time.perf_counter() - t2) * 1e3))
                for slot, i in enumerate(chunk):
                    keep = out["valid"][slot] & (out["scores"][slot] >= 0.05)
                    results[i] = [out[k][slot][keep].tolist() for k in ("boxes", "scores",
                                                                         "labels")]
        return results

    requests = _deploy_requests()
    serve(requests[0][1][:4] + requests[1][1][:4])  # warm-up, not counted
    torch.cuda.synchronize()
    _reset_counts()
    chunk_ms.clear()
    latencies = {name: [] for name, _ in requests}
    syncs = {name: [] for name, _ in requests}
    dets = {}
    for _ in range(DEPLOY_ROUNDS):
        for name, pages in requests:
            s0 = nms.nms_mask.host_syncs
            t0 = time.perf_counter()
            dets[name] = serve(pages)
            torch.cuda.synchronize()
            latencies[name].append(time.perf_counter() - t0)
            syncs[name].append(nms.nms_mask.host_syncs - s0)
    counts = _counts()
    imported = sorted(m for m in sys.modules if m.startswith(NOT_IMPORTED))
    with open(out_path, "w") as f:
        json.dump({"load_s": load_s, "latency_s": latencies, "detections": dets,
                   "counts": counts, "imported": imported, "nms_syncs": syncs,
                   "chunk_ms": chunk_ms, "gc_ms": _full_collection_ms()}, f)
    return 0


def _full_collection_ms() -> dict:
    """One full collection of Python's cyclic garbage collector, in ms,
    with the loaded programs frozen (as ``ExportedDetector`` leaves them)
    and tracked (the collector walks their graphs), and the objects
    frozen."""
    import gc

    out = {"frozen_objects": gc.get_freeze_count()}
    for label in ("frozen", "tracked"):
        if label == "tracked":
            gc.unfreeze()
        t0 = time.perf_counter()
        gc.collect()
        out[label] = (time.perf_counter() - t0) * 1e3
    gc.freeze()
    return out


def phase_deploy(kernels: list[dict], gen) -> dict:
    """Export ``configs/serving_1024.json``'s model (dit-base, random
    weights from seed 0) in its 224 and 1024 px buckets on the card, load
    the artifact in a fresh process that imports no model, config or eval
    code and hold its detections to the live engine's; serve 16
    concurrent JPEG POSTs and a corrupt page over HTTP from the artifact;
    run the predict tool over 16 fixture JPEGs with two planned buckets;
    time the native JPEG decode against PIL; and measure each serving
    operator's host cost against its direct launch."""
    import http.client
    import io
    import os
    import threading

    from PIL import Image

    from layoutdit_tpu_torch.config import load_config
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.export import export_detector
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )
    from layoutdit_tpu_torch.native import loader as native_loader
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.tools import predict as predict_tool
    from layoutdit_tpu_torch.tools.make_fixture import make_page
    from layoutdit_tpu_torch.tools.serve import detections_to_json, make_server
    from layoutdit_tpu_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    out = {"host_cost": _host_cost(gen)}
    mc, dl = load_config(str(CONFIG))
    cfg = DetectorConfig.from_model_config(mc, precision_dtype="bfloat16")
    model = DetectorModel(init_detector(cfg, torch.Generator(device="cuda").manual_seed(0),
                                        device="cuda"), cfg)
    engine = BatchInferenceEngine(model, image_sizes=DEPLOY_BUCKETS, batch_size=dl.batch_size)
    requests = _deploy_requests()
    engine.predict_pages(requests[0][1][:4] + requests[1][1][:4])  # warm-up
    live_ms = {name: [] for name, _ in requests}
    live_syncs = {name: [] for name, _ in requests}
    live_dets = {}
    for _ in range(DEPLOY_ROUNDS):  # the exported run's order
        for name, pages in requests:
            s0 = nms.nms_mask.host_syncs
            t0 = time.perf_counter()
            live_dets[name] = engine.predict_pages(pages)
            torch.cuda.synchronize()
            live_ms[name].append((time.perf_counter() - t0) * 1e3)
            live_syncs[name].append(nms.nms_mask.host_syncs - s0)

    if not native_loader.available():
        raise RuntimeError("deploy: the native JPEG loader did not build")
    _reset_counts()
    native_loader.decode_batch.pages = 0
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, "artifact")
        manifest = export_detector(model.params, cfg, artifact, image_sizes=DEPLOY_BUCKETS,
                                   batch_size=dl.batch_size, device="cuda")
        nbytes = sum(os.path.getsize(os.path.join(artifact, f)) for f in os.listdir(artifact))
        print(f"  export: {manifest['export_seconds']} s per bucket, artifact {nbytes} bytes "
              f"({sorted(os.listdir(artifact))})")

        # the artifact in a fresh process
        child_out = os.path.join(tmp, "child.json")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--exported-child",
                            artifact, child_out], capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"deploy: the exported run failed:\n{r.stderr[-4000:]}")
        with open(child_out) as f:
            child = json.load(f)
        if child["imported"]:
            raise RuntimeError(f"deploy: the exported run imported {child['imported']}")
        box_err = score_err = 0.0
        for name, pages in requests:
            for want, got in zip(live_dets[name], child["detections"][name]):
                b_err, s_err = _match((want.boxes, want.scores, want.labels), got)
                box_err, score_err = max(box_err, b_err), max(score_err, s_err)
        exported_ms = {k: [t * 1e3 for t in v] for k, v in child["latency_s"].items()}
        for name, _ in requests:
            print(f"  request ({name}): median latency live {np.median(live_ms[name]):.3f} ms, "
                  f"exported {np.median(exported_ms[name]):.3f} ms ({DEPLOY_ROUNDS} runs each; "
                  f"NMS host syncs live {live_syncs[name]}, exported "
                  f"{child['nms_syncs'][name]})")
        print(f"  exported against live: the same labels, largest box difference {box_err:.6g} "
              f"px, largest score difference {score_err:.6g}; the fresh process loaded the "
              f"artifact in {child['load_s']:.2f} s ({child_s:.1f} s with its start) and "
              f"imported none of {NOT_IMPORTED}")
        print("  exported run, each batch of the timed rounds (size: prepare / program call / "
              "fetch ms): " + "; ".join(f"{c[0]}: {c[1]:.1f} / {c[2]:.1f} / {c[3]:.1f}"
                                        for c in child["chunk_ms"]))
        gc_ms = child["gc_ms"]
        print(f"  a full garbage collection in the exported run: {gc_ms['frozen']:.3f} ms with "
              f"the {gc_ms['frozen_objects']} objects alive after the load frozen, "
              f"{gc_ms['tracked']:.3f} ms with them tracked")
        counts = child["counts"]
        print(f"  launches in the exported run: " + ", ".join(
            f"{n} {counts[n]}" for n in SERVING_KERNELS))
        for name in SERVING_KERNELS:
            if counts[name] <= 0:
                raise RuntimeError(f"deploy: {name} was not launched by the exported programs")

        # HTTP: concurrent JPEG POSTs of both buckets and one corrupt page
        rng = np.random.default_rng(1)
        jpegs = []
        for i in range(HTTP_PAGES):
            shape = (200 + 3 * i, 160 + 2 * i) if i % 2 else (1000 - 5 * i, 770 + 4 * i)
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).save(
                buf, "JPEG", quality=90)
            jpegs.append(buf.getvalue())
        httpd, batcher = make_server(None, "127.0.0.1", 0, export_dir=artifact, flush_ms=20.0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        port = httpd.server_address[1]

        def post(body: bytes):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body=body,
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            conn.close()
            return resp.status, payload, time.perf_counter() - t0

        try:
            post(jpegs[0]), post(jpegs[1])  # warm-up, not counted
            before = httpd.metrics.batches
            results: list = [None] * (HTTP_PAGES + 1)

            def run(i, body):
                results[i] = post(body)

            threads = [threading.Thread(target=run, args=(i, b))
                       for i, b in enumerate(jpegs + [b"\xff\xd8 not a page"])]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            batches = httpd.metrics.batches - before
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/metrics")
            metrics_text = conn.getresponse().read().decode()
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.stop()
        # the three requests through the server's exported engine, in this
        # process, beside the live engine's (same pipeline, same pages)
        here_ms = {name: [] for name, _ in requests}
        for _ in range(DEPLOY_ROUNDS):
            for name, pages in requests:
                t0 = time.perf_counter()
                batcher.engine.predict_pages(pages)
                torch.cuda.synchronize()
                here_ms[name].append((time.perf_counter() - t0) * 1e3)
        print("  the exported engine in this process, the three requests (ms, in round "
              "order): " + "; ".join(f"{k} {[round(t, 3) for t in v]}"
                                     for k, v in here_ms.items()))
        codes = [r[0] for r in results]
        if codes[:-1] != [200] * HTTP_PAGES or codes[-1] != 422:
            raise RuntimeError(f"deploy: HTTP codes {codes}")
        if any(not r[1]["boxes"] for r in results[:-1]):
            raise RuntimeError("deploy: a served page had no detections")
        if not batches < HTTP_PAGES + 1 or "layoutdit_batches_total" not in metrics_text:
            raise RuntimeError(f"deploy: {batches} batches for {HTTP_PAGES + 1} pages")
        lat = sorted(r[2] * 1e3 for r in results)
        http_ms = {"p50": float(np.percentile(lat, 50)), "p95": float(np.percentile(lat, 95))}
        print(f"  HTTP: {HTTP_PAGES} concurrent JPEG POSTs + 1 corrupt page: 200 x "
              f"{HTTP_PAGES}, 422 x 1, {batches} batches; latency p50 {http_ms['p50']:.3f} ms, "
              f"p95 {http_ms['p95']:.3f} ms; native decode took "
              f"{native_loader.decode_batch.pages} pages")
        if native_loader.decode_batch.pages < HTTP_PAGES:
            raise RuntimeError("deploy: the served pages did not go through the native loader")

        # the predict tool over fixture JPEGs, two planned buckets
        page_dir = os.path.join(tmp, "pages")
        os.makedirs(page_dir)
        for i in range(16):
            img, _ = make_page(rng, 224 if i % 2 else 896)
            Image.fromarray((img * 255).astype(np.uint8)).convert("RGB").save(
                os.path.join(page_dir, f"page_{i:02d}.jpg"), quality=92)
        ckpt = save_checkpoint(os.path.join(tmp, "model.pt"), model.params, None, 0, {})
        os.environ["LAYOUTDIT_CONFIG"] = str(CONFIG)
        try:
            records = predict_tool.main([
                "--checkpoint", ckpt, "--input", page_dir, "--auto-buckets", "2",
                "--batch-size", str(dl.batch_size), "--output", os.path.join(tmp, "d.json")])
        finally:
            del os.environ["LAYOUTDIT_CONFIG"]
        paths = predict_tool.collect_inputs(page_dir)
        pages = [Path(p).read_bytes() for p in paths]
        sizes = []
        for p in paths:
            with Image.open(p) as im:
                sizes.append(im.size[::-1])
        planned = BatchInferenceEngine.from_corpus(model, sizes, max_buckets=2,
                                                   batch_size=dl.batch_size)
        names = predict_tool._label_names(cfg.num_classes, None)
        want = [{"file": p, **detections_to_json(d, names)}
                for p, d in zip(paths, planned.predict_pages(pages))]
        if records != want:
            raise RuntimeError("deploy: the predict tool's records differ from the engine's")
        print(f"  predict: {len(records)} records over buckets {planned.image_sizes}, equal to "
              f"the engine's")
        counts = _counts()
    for k in kernels:
        k["deploy_launches"] = counts[k["name"]] + child["counts"][k["name"]]

    # native decode against PIL on pages of about 1000 x 770
    big = []
    for i in range(16):
        buf = io.BytesIO()
        img, _ = make_page(rng, 1000)
        Image.fromarray((img[:, :770] * 255).astype(np.uint8)).convert("RGB").save(
            buf, "JPEG", quality=92)
        big.append(buf.getvalue())
    dims = [native_loader.jpeg_dims(b) for b in big]
    decode = {}
    for label, fn in (
        ("native", lambda: native_loader.decode_batch(big, dims, n_threads=engine.decode_workers)),
        ("native_1_thread", lambda: native_loader.decode_batch(big, dims, n_threads=1)),
        ("pil", lambda: [np.array(Image.open(io.BytesIO(b)).convert("RGB")) for b in big]),
    ):
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            got = fn()
        decode[label] = 3 * len(big) / (time.perf_counter() - t0)
        decode[f"{label}_pages"] = got
    diff = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
               for a, b in zip(decode.pop("native_pages"), decode.pop("pil_pages")))
    decode.pop("native_1_thread_pages")
    print(f"  decode, 16 JPEGs of 1000 x 770: native {decode['native']:.1f} pages/s "
          f"({engine.decode_workers} threads), {decode['native_1_thread']:.1f} on one, PIL "
          f"{decode['pil']:.1f}; largest uint8 difference {diff}")
    out.update({
        "export_s": manifest["export_seconds"], "artifact_bytes": nbytes,
        "live_latency_ms": live_ms, "exported_latency_ms": exported_ms,
        "live_nms_syncs": live_syncs, "exported_nms_syncs": child["nms_syncs"],
        "exported_here_latency_ms": here_ms,
        "exported_gc_ms": gc_ms,
        "exported_load_s": child["load_s"], "max_box_err_px": box_err,
        "max_score_err": score_err, "exported_launches": child["counts"],
        "http_ms": http_ms, "http_batches": batches, "decode_pages_per_s": decode,
        "decode_max_diff": diff, "phase_s": time.perf_counter() - t_phase,
    })
    print(f"  phase deploy: {out['phase_s']:.1f} s")
    return out


# the families phase: Cascade R-CNN (configs/cascade_dp.json, dit-large)
# and Mask R-CNN (configs/mask_rcnn.json, dit-base), both at 224 px
CASCADE_CONFIG = ROOT / "configs" / "cascade_dp.json"
MASK_CONFIG = ROOT / "configs" / "mask_rcnn.json"
FAMILY_BATCH = 16  # train steps
FAMILY_SERVING_BATCH = 4  # serving requests, as the serving phase's
FAMILY_ROUNDS = 2  # timed rounds of the three requests
FAMILY_SCORE_PAGES = 64
# RoIAlign launches a batch (forward) and a step (backward): one per
# cascade stage; the box head's and the mask head's for a mask model; the
# box head's for the ResNet-50 Faster R-CNN
FAMILY_ROI = {"cascade": 3, "mask": 2, "resnet": 1, "moe": 1, "dense": 1}
MASK_P = 14


def _roi_given_case(label: str, feats, rois, mask, image: int, p: int) -> dict:
    """Rows 7 and 8 on given RoIs (``mask`` False = an invalid slot, level
    -1) against their plain versions, the backward to the same bits on a
    second run; each timed per call, with its bound (inputs read once,
    outputs written once; row 7's feature bytes those its RoIs touch)."""
    from layoutdit_tpu_torch.ops import roi_align as ra

    g = 2
    scales = ROI_SCALES
    b, k = rois.shape[:2]
    c = feats[0].shape[1]
    levels = ra.roi_levels(rois, 5, float(image), roi_mask=mask)
    n_valid = int((levels >= 0).sum())
    got = ra.roi_align_fwd(feats, rois, levels, scales, p, g)
    err, tol = _check_close(f"{label} roi_align", got,
                            ra.roi_align_plain(feats, rois, levels, scales, p, g))
    if bool(got[levels < 0].any()):
        raise RuntimeError(f"{label}: an invalid slot pooled non-zeros")
    nbytes = (_roi_touched_bytes(feats, rois, levels, scales, p, g) + rois.numel() * 4
              + b * k * p * p * c * 2)
    bound, by = _bound_ms(nbytes, n_valid * p * p * c * g * g * 4 * 2)
    ms = _time_ms(lambda: ra.roi_align_fwd(feats, rois, levels, scales, p, g), 20)
    _print_share(f"{label} roi_align", ms, bound, by)
    fwd = {"shape": f"B={b} K={k} ({n_valid} valid) C={c} P={p} G={g} pyramid {image} px",
           "max_abs_err": err, "tolerance": tol, "ms": ms, "bound_ms": bound, "bound_by": by,
           "plain_ms": _time_ms(lambda: ra.roi_align_plain(feats, rois, levels, scales, p, g),
                                2)}
    dout = torch.randn(b, k, p, p, c, generator=torch.Generator(device="cuda").manual_seed(k),
                       device="cuda").to(torch.bfloat16)
    got = ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g)
    want = ra.roi_align_bwd_plain(dout, rois, levels, feats, scales, p, g)
    errs, tols = zip(*(_check_close(f"{label} roi_align_bwd level {i}", x, y)
                       for i, (x, y) in enumerate(zip(got, want))))
    again = ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError(f"{label} roi_align_bwd: two runs gave different bits")
    nbytes = (n_valid * p * p * c * 2 + sum(f.numel() for f in feats) * 2 + rois.numel() * 4
              + levels.numel() * 4)
    bound, by = _bound_ms(nbytes, 0.0)
    t_ops = n_valid * p * p * c * g * g * 4 * 2 / PEAK_FP32_FLOPS * 1e3
    if t_ops > bound:
        bound, by = t_ops, "operations"
    ms = _time_ms(lambda: ra.roi_align_bwd(dout, rois, levels, feats, scales, p, g), 10)
    _print_share(f"{label} roi_align_bwd", ms, bound, by)
    bwd = {"shape": fwd["shape"], "max_abs_err": max(errs), "tolerance": tols[0],
           "same_bits_on_rerun": True, "ms": ms, "bound_ms": bound, "bound_by": by,
           "plain_ms": _time_ms(
               lambda: ra.roi_align_bwd_plain(dout, rois, levels, feats, scales, p, g), 2)}
    return {"fwd": fwd, "bwd": bwd}


def _families_kernels(gen, kernels: list[dict]) -> dict:
    """Rows 7-8 at the slice's shapes on a 224 px pyramid (C = 256, the
    detector's channels-last layout): P = 14 at the mask loss's B = 16,
    K = 128 positive slots (about a quarter valid, the rest level -1) and
    at predict's B = 4, D = 100 detections (about half valid); P = 7 on a
    later cascade stage's refined boxes, clipped to the page, a fifth of
    them pushed past an edge to zero width or height. Also times the
    copy that takes the P = 14 pool from the kernel's [B, K, Px, Py, C] to
    the mask head's [B*K, C, Py, Px]."""
    from layoutdit_tpu_torch.models.detection.cascade import refine_boxes

    out = {}
    for label, b, k, keep in (("mask_train", 16, 128, 0.25), ("mask_predict", 4, 100, 0.5)):
        feats, rois, _ = _roi_inputs(gen, 224, b=b, k=k)
        mask = torch.rand(b, k, generator=gen, device="cuda") < keep
        out[label] = _roi_given_case(f"{label} P={MASK_P}", feats, rois, mask, 224, MASK_P)
    feats, rois, mask = _roi_inputs(gen, 224, b=16, k=512)
    deltas = torch.randn(16, 512, 4, generator=gen, device="cuda") * 2
    deltas[:, :64, :2] = 40.0
    deltas[:, 64:102, :2] = -40.0
    refined = refine_boxes(rois, deltas, (20.0, 20.0, 10.0, 10.0), (224, 224))
    span = torch.minimum(refined[..., 2] - refined[..., 0], refined[..., 3] - refined[..., 1])
    n_flat = int(((span == 0) & mask).sum())
    if n_flat < 100:
        raise RuntimeError(f"cascade_degenerate: only {n_flat} valid zero-size boxes")
    print(f"  cascade_degenerate: {n_flat} valid boxes of zero width or height")
    out["cascade_degenerate"] = _roi_given_case("cascade_degenerate P=7", feats, refined, mask,
                                                224, 7)
    out["cascade_degenerate"]["zero_size_boxes"] = n_flat
    pooled = torch.randn(16, 128, MASK_P, MASK_P, 256, generator=gen,
                         device="cuda").to(torch.bfloat16)
    copy_ms = _time_ms(lambda: pooled.permute(0, 1, 4, 3, 2).reshape(
        16 * 128, 256, MASK_P, MASK_P).contiguous(), 20)
    bound, _ = _bound_ms(2 * pooled.numel() * 2, 0.0)
    print(f"  the mask pool's layout copy, [16, 128, 14, 14, 256] bf16: {copy_ms:.6g} ms "
          f"(bound {bound:.6g} ms, bytes)")
    out["mask_pool_copy"] = {"ms": copy_ms, "bound_ms": bound, "shape": "B=16 K=128 C=256 P=14"}
    for name, part in (("roi_align", "fwd"), ("roi_align_bwd", "bwd")):
        for entry in (k for k in kernels if k["name"] == name):  # none with --only
            for label in ("mask_train", "mask_predict", "cascade_degenerate"):
                entry.update({f"families_{label}_{k}": v for k, v in out[label][part].items()})
    torch.cuda.empty_cache()
    return out


def _family_cfg(path: Path, batch: int, model_overrides: dict | None = None):
    """A family's run config at ``batch`` (its model fields replaced by
    ``model_overrides``) and its ``DetectorConfig``."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig

    rc = load_run_config(str(path))
    rc = dataclasses.replace(rc, data=dataclasses.replace(rc.data, batch_size=batch),
                             model=dataclasses.replace(rc.model, **(model_overrides or {})),
                             compute_dtype="bfloat16")
    return rc, DetectorConfig.from_model_config(rc.model, precision_dtype="bfloat16")


def _family_launches(family: str, cfg, batches: int, train: bool) -> dict:
    """Launches of ``batches`` serving batches or train steps at 224 px: a
    short-attention kernel a layer (and its backward in training; none for
    ResNet-50), FAMILY_ROI RoIAligns (none for a single-stage family or
    DETR), and a DETR step's one matcher launch."""
    n = 0 if cfg.backbone_kind == "resnet50" else cfg.backbone.vit.num_hidden_layers
    roi = FAMILY_ROI.get(family, 0)
    out = {name: 0 for name in _counters()}
    out.update(short_attention=n * batches, roi_align=roi * batches)
    if train:
        out.update(short_attention_bwd=n * batches, roi_align_bwd=roi * batches,
                   linear_sum_assignment=batches if cfg.detector_kind == "detr" else 0)
    return out


def _family_serving(family: str, path: Path, kernels: list[dict]) -> dict:
    """The serving phase's three requests (8, 4 and 4 + 2 pages of its
    sizes) through ``BatchInferenceEngine`` with one 224 px bucket, batch
    4: a warm-up, then FAMILY_ROUNDS timed rounds; the pages checked as
    ``_check_pages`` checks them and a mask model's masks inside their
    pages; launches 12 (24) attention and FAMILY_ROI RoIAlign a batch; one
    profiled request of 4 pages, with its NMS stages' share of the device
    time."""
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel, init_detector
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.tools.profile_serving import profile_bucket

    rc, cfg = _family_cfg(path, FAMILY_SERVING_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = DetectorModel(init_detector(cfg, gen, device="cuda"), cfg)
    engine = BatchInferenceEngine(model, image_sizes=(224,), batch_size=FAMILY_SERVING_BATCH)
    requests = _deploy_requests()
    engine.predict_pages(requests[0][1][:4])  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    engine.paste_seconds = 0.0
    latencies = {name: [] for name, _ in requests}
    n_batches = n_masks = 0
    for _ in range(FAMILY_ROUNDS):
        for name, pages in requests:
            t0 = time.perf_counter()
            results = engine.predict_pages(pages)
            torch.cuda.synchronize()
            latencies[name].append((time.perf_counter() - t0) * 1e3)
            _check_pages(pages, results)
            n_batches += -(-len(pages) // FAMILY_SERVING_BATCH)
            for page, r in zip(pages, results):
                if cfg.with_mask:
                    if len(r.masks) != len(r.boxes):
                        raise RuntimeError(f"{family}: a mask per detection expected")
                    h, w = page.shape[:2]
                    for x0, y0, bm in r.masks:
                        if not (0 <= x0 and 0 <= y0 and x0 + bm.shape[1] <= w
                                and y0 + bm.shape[0] <= h):
                            raise RuntimeError(f"{family}: a mask window outside its page")
                    n_masks += len(r.masks)
                elif r.masks is not None:
                    raise RuntimeError(f"{family}: masks from a model without the branch")
    counts = _counts()
    syncs = nms.nms_mask.host_syncs
    want = _family_launches(family, cfg, n_batches, train=False)
    _check_launches(f"{family} serving", counts, want, 1)
    for k in kernels:
        k["families_launches"] = k.get("families_launches", 0) + counts[k["name"]]
    out = {"launches": counts, "nms_host_syncs": syncs, "batches": n_batches}
    for name, pages in requests:
        out[name] = {**_spread(latencies[name]),
                     "pages_per_s": len(pages) * 1e3 / float(np.median(latencies[name]))}
        print(f"  {family} request ({name}): {len(pages)} pages, latency median "
              f"{out[name]['median']:.2f} ms (min {out[name]['min']:.2f}, max "
              f"{out[name]['max']:.2f}), {out[name]['pages_per_s']:.2f} pages/s")
    if cfg.with_mask:
        out["masks"] = n_masks
        out["paste_s"] = engine.paste_seconds
        print(f"  {family}: {n_masks} masks pasted on the host in {engine.paste_seconds:.4f} s "
              f"({engine.paste_seconds / max(n_masks, 1) * 1e3:.4f} ms a mask)")
    with tempfile.TemporaryDirectory() as tmp:
        r = profile_bucket(engine, requests[0][1][:4], Path(tmp) / f"{family}.json")
    stages = r["stages"]
    nms_ms = sum(stages.get(s, {}).get("device_ms", 0.0) for s in ("rpn", "postprocess"))
    out["profile"] = {"wall_ms": r["wall_ms"], "device_busy_ms": r["device_busy_ms"],
                      "device_idle_share": r["device_idle_share"], "stages": stages,
                      "top_kernels": r["top_kernels"][:8]}
    print(f"  {family} profiled request, 4 pages: wall {r['wall_ms']:.3f} ms, device busy "
          f"{r['device_busy_ms']:.4f} ms, idle {r['device_idle_share']:.4f}; " + ", ".join(
              f"{s} {st.get('device_ms', 0.0):.4f} ms" for s, st in stages.items())
          + f"; rpn + postprocess (both NMS) {nms_ms / r['device_busy_ms']:.3f} of busy")
    del engine
    return out, model


def _family_train(family: str, path: Path, model, kernels: list[dict],
                  path_key: str = "families", model_overrides: dict | None = None,
                  profile: bool = False, after=None) -> dict:
    """One epoch of ``Trainer.train()`` over 4 x 16 fixture pages (the
    launches of the path), then TRAIN_REPEATS steps on one repeated batch:
    losses finite and falling, median of the last 18 step times with min
    and max, peak GiB; a mask model's loader rasterises ``gt_masks``. With
    ``profile``, one more step traced (``tools/profile_train.profile_step``:
    its stages' host and device ms). ``after(trainer, batch)``, while the
    fixture still exists, adds its dict to the result."""
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel
    from layoutdit_tpu_torch.tools.profile_train import profile_step
    from layoutdit_tpu_torch.train.trainer import Trainer

    base, cfg = _family_cfg(path, FAMILY_BATCH, model_overrides)
    with tempfile.TemporaryDirectory() as tmp:
        rc = _fixture_run(base, tmp, TRAIN_EPOCH_STEPS * FAMILY_BATCH)
        rc = dataclasses.replace(rc, train=dataclasses.replace(
            rc.train, tensorboard=False, checkpoint_interval=100))
        model = DetectorModel(model.params, cfg)
        trainer = Trainer(rc, model)
        _reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts, steps = _counts(), trainer.updates
        _check_launches(f"{family} train", counts,
                        _family_launches(family, cfg, steps, train=True), 1)
        for k in kernels:
            k[f"{path_key}_launches"] = k.get(f"{path_key}_launches", 0) + counts[k["name"]]
        it = iter(trainer.dataloader)
        batch = next(it)
        it.close()
        if cfg.with_mask and (batch.gt_masks is None or not bool(batch.gt_masks.any())):
            raise RuntimeError(f"{family}: the batch carries no gt masks")
        torch.cuda.reset_peak_memory_stats()
        history, times = [], []
        for _ in range(TRAIN_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, parts = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            history.append({"loss": float(loss), **{k: float(v) for k, v in parts.items()}})
        peak = torch.cuda.max_memory_allocated()
        traced = profile_step(trainer, 0, Path(tmp) / "step.json") if profile else None
        extra = after(trainer, batch) if after is not None else {}
    if not all(np.isfinite(list(h.values())).all() for h in history):
        raise RuntimeError(f"{family}: a non-finite loss: {history}")
    first, last = history[0]["loss"], float(np.mean([h["loss"] for h in history[-3:]]))
    if not last <= (1 - TRAIN_MIN_DROP) * first:
        raise RuntimeError(f"{family}: the loss did not fall on a repeated batch")
    timed = times[TRAIN_WARMUP:]
    out = {"epoch_steps": steps, "epoch_s": epoch_s, "epoch_loss": trainer.loss_history,
           **{f"step_{k}": v for k, v in _spread(timed).items()}, "step_ms": times,
           "images_per_s": FAMILY_BATCH * 1e3 / float(np.median(timed)),
           "peak_gib": peak / 2**30, "loss_first": first, "loss_last3_mean": last,
           "losses_last": history[-1], **extra}
    if traced is not None:
        out["profile"] = {k: traced[k] for k in ("wall_ms", "device_busy_ms",
                                                 "device_idle_share", "stages")}
        out["profile"]["top_kernels"] = traced["top_kernels"][:8]
    print(f"  {family} train: epoch {steps} steps in {epoch_s:.3f} s; {TRAIN_REPEATS} steps "
          f"at batch {FAMILY_BATCH}: median {out['step_median']:.3f} ms (min "
          f"{out['step_min']:.3f}, max {out['step_max']:.3f}), {out['images_per_s']:.2f} "
          f"images/s, peak {out['peak_gib']:.4f} GiB; loss {first:.4f} -> {last:.4f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in history[-1].items()))
    return out, trainer


def _family_score(model, kernels: list[dict]) -> dict:
    """``Evaluator.score()`` of the mask model (after its train steps)
    over FAMILY_SCORE_PAGES fixture pages at batch 16: bbox and segm
    metrics, finite; pages/s; the host paste time apart."""
    from layoutdit_tpu_torch.eval.evaluator import Evaluator

    base, cfg = _family_cfg(MASK_CONFIG, FAMILY_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        rc = _fixture_run(base, tmp, FAMILY_SCORE_PAGES)
        rc = dataclasses.replace(rc, eval_input="samples")
        evaluator = Evaluator(model, rc)
        evaluator.score()  # warm-up: the first batch's set-up
        _reset_counts()
        t0 = time.perf_counter()
        metrics = evaluator.score()
        score_s = time.perf_counter() - t0
        counts = _counts()
    batches = -(-FAMILY_SCORE_PAGES // FAMILY_BATCH)
    _check_launches("mask score", counts, _family_launches("mask", cfg, batches, train=False), 1)
    for k in kernels:
        k["families_launches"] = k.get("families_launches", 0) + counts[k["name"]]
    if metrics is None or not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"mask score: metrics {metrics}")
    if "segm_mAP" not in metrics:
        raise RuntimeError("mask score: no segm metrics")
    out = {"pages": FAMILY_SCORE_PAGES, "score_s": score_s,
           "pages_per_s": FAMILY_SCORE_PAGES / score_s, "paste_s": evaluator.paste_seconds,
           "metrics": {k: metrics[k] for k in ("mAP", "AP50", "segm_mAP", "segm_AP50")}}
    print(f"  mask score(): {FAMILY_SCORE_PAGES} pages in {score_s:.3f} s "
          f"({out['pages_per_s']:.2f} pages/s), of which mask pastes "
          f"{evaluator.paste_seconds:.4f} s; bbox mAP {metrics['mAP']:.4f}, segm mAP "
          f"{metrics['segm_mAP']:.4f}")
    return out


def _family_convergence(family: str, kernels: list[dict], path_key: str = "families",
                        launched: tuple[str, ...] = MAIN_KERNELS, **recipe) -> dict:
    """The flagship recipe with the family's overrides
    (``tools/convergence.py --family``; ``recipe`` its ``n_train`` and
    ``epochs``), bf16 on the card, held to the family's floors
    (``convergence.floor_failures``); the kernels in ``launched`` and no
    other must run."""
    from layoutdit_tpu_torch.tools import convergence

    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        result = convergence.run_recipe(tmp, "bfloat16", "cuda", eval_interval=16,
                                        family=family, **recipe)
        counts = _counts()
    for name, n in counts.items():
        if (n > 0) != (name in launched):
            raise RuntimeError(f"{family} convergence: {name} launched {n} times")
    for k in kernels:
        k[f"{path_key}_launches"] = k.get(f"{path_key}_launches", 0) + counts[k["name"]]
    m = result["metrics"]
    keys = ("mAP", "AP50", "AP75") + (("segm_mAP", "segm_AP50", "segm_AP75")
                                      if family == "mask" else ())
    losses = result["loss"]
    print(f"  {family} recipe: {result['steps']} steps in {result['train_s']:.3f} s, score "
          f"{result['score_s']:.3f} s; mAP at epochs {result['mAP_at_epoch']}; held-out "
          + ", ".join(f"{k} {m[k]:.4f}" for k in keys if m)
          + f"; loss first-4 {np.mean(losses[:4]):.4f}, last-4 {np.mean(losses[-4:]):.4f}")
    failures = convergence.floor_failures(result)
    if failures:
        raise RuntimeError(f"{family} convergence missed its floors: {failures}")
    return {k: result[k] for k in ("n_train", "epochs", "steps", "train_s", "score_s", "loss",
                                   "mAP_at_epoch", "steps_per_s")} | {"metrics": m,
                                                                       "launches": counts}


def phase_families(gen, kernels: list[dict], card: str,
                   kernel_cases: dict | None = None) -> dict:
    """Cascade R-CNN (``configs/cascade_dp.json``: dit-large, three stages
    at IoU 0.5 / 0.6 / 0.7) and Mask R-CNN (``configs/mask_rcnn.json``:
    dit-base with the mask branch), both at 224 px, random weights from
    seed 0, bf16: rows 7-8 at these models' shapes; each model serving the
    serving phase's requests and training; the mask model scoring bbox and
    segm. The launches of all but the kernel checks are the ``families``
    path's; both convergence recipes add theirs in phase ``recipes``.
    ``kernel_cases``: ``_families_kernels``' result when it ran before."""
    t0 = time.perf_counter()
    for k in kernels:
        k["families_launches"] = 0
    out = {"card": card, "kernels": (_families_kernels(gen, kernels) if kernel_cases is None
                                     else kernel_cases)}
    for family, path in (("cascade", CASCADE_CONFIG), ("mask", MASK_CONFIG)):
        serving, model = _family_serving(family, path, kernels)
        train, trainer = _family_train(family, path, model, kernels)
        out[family] = {"serving": serving, "train": train}
        if family == "mask":
            out[family]["score"] = _family_score(trainer.model, kernels)
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"  families phase: {out['phase_s']:.1f} s")
    return out


# phase one_stage: RetinaNet (configs/retinanet.json: 9 anchors a cell)
# and FCOS (configs/fcos.json), dit-base, levels 1-4 of the pyramid, random
# weights from seed 0, bf16
RETINANET_CONFIG = ROOT / "configs" / "retinanet.json"
FCOS_CONFIG = ROOT / "configs" / "fcos.json"
ONE_STAGE = (("retinanet", RETINANET_CONFIG), ("fcos", FCOS_CONFIG))
# the kernels of a single-stage recipe (the tiny detector at 224 px)
ONE_STAGE_RECIPE_KERNELS = ("short_attention", "short_attention_bwd")
ONE_STAGE_THRESHOLDS = ("config", "zero")


def _score_thresh_zero(cfg):
    """``cfg`` with its family's score threshold at 0: every candidate goes
    into the NMS, its worst case (random weights score under the config's
    threshold everywhere)."""
    budget = dataclasses.replace(cfg.budget, **{f"{cfg.detector_kind}_score_thresh": 0.0})
    return dataclasses.replace(cfg, budget=budget)


class _CandidateCount:
    """While active, records the candidates that enter a single-stage
    family's NMS (the finite scores handed to ``nms_and_top``), one count
    per image slot of a batch. Each batch reads the host once, so it wraps
    untimed passes only."""

    def __enter__(self):
        from layoutdit_tpu_torch.models.detection import fcos, retinanet

        self.per_image: list[int] = []
        self._mods, self._orig = (retinanet, fcos), retinanet.nms_and_top

        def counted(boxes, scores, labels, *args):
            self.per_image += torch.isfinite(scores).sum(-1).tolist()
            return self._orig(boxes, scores, labels, *args)

        for m in self._mods:
            m.nms_and_top = counted
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.nms_and_top = self._orig


def _one_stage_serving(family: str, model, kernels: list[dict]) -> dict:
    """PR 13's three requests (8, 4 and 4 + 2 pages) in one 224 px bucket
    and one request of its four large pages in one 1024 px bucket, batch 4,
    FAMILY_ROUNDS timed rounds each, at the config's score threshold and
    at 0: latency, detections, NMS host syncs; launches 12 of row 1 a 224
    px batch and 12 of row 3 a 1024 px batch, no other. Then, untimed, the
    candidates that enter the NMS, and one profiled request per bucket
    split into the stages ``backbone``, ``head`` and ``postprocess``."""
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel
    from layoutdit_tpu_torch.ops import nms
    from layoutdit_tpu_torch.tools.profile_serving import profile_bucket

    requests = _deploy_requests()
    large = requests[1][1]
    # PR 13's requests by their pages, all routed to the one 224 px bucket
    sizes = ("8 small pages", "4 large pages", "4 small + 2 large pages")
    reqs = [(224, f"224 px bucket, {d}", pages) for d, (_, pages) in zip(sizes, requests)]
    reqs.append((1024, "1024 px bucket, 4 large pages", large))
    n = model.cfg.backbone.vit.num_hidden_layers
    out = {}
    for label in ONE_STAGE_THRESHOLDS:
        cfg = model.cfg if label == "config" else _score_thresh_zero(model.cfg)
        thresh = getattr(cfg.budget, f"{family}_score_thresh")
        m = DetectorModel(model.params, cfg)
        engines = {size: BatchInferenceEngine(m, image_sizes=(size,), score_thresh=0.0,
                                              batch_size=FAMILY_SERVING_BATCH)
                   for size in (224, 1024)}
        engines[224].predict_pages(requests[0][1][:4])  # warm-up, both buckets
        engines[1024].predict_pages(large)
        torch.cuda.synchronize()
        _reset_counts()
        latencies = {name: [] for _, name, _ in reqs}
        dets = {}
        batches = {224: 0, 1024: 0}
        for _ in range(FAMILY_ROUNDS):
            for size, name, pages in reqs:
                t0 = time.perf_counter()
                results = engines[size].predict_pages(pages)
                torch.cuda.synchronize()
                latencies[name].append((time.perf_counter() - t0) * 1e3)
                dets[name] = _check_pages(pages, results, allow_empty=label == "config")
                batches[size] += -(-len(pages) // FAMILY_SERVING_BATCH)
        counts = _counts()
        syncs = nms.nms_mask.host_syncs
        want = {name: 0 for name in _counters()}
        want.update(short_attention=n * batches[224], flash_attention=n * batches[1024])
        _check_launches(f"{family} serving ({label} threshold)", counts, want, 1)
        for k in kernels:
            k["one_stage_launches"] = k.get("one_stage_launches", 0) + counts[k["name"]]
        cands = {}
        with _CandidateCount() as cc:
            for size, name, pages in reqs:
                cc.per_image = []
                engines[size].predict_pages(pages)
                cands[name] = {"per_image_slot_mean": float(np.mean(cc.per_image)),
                               "max": max(cc.per_image), "slots": len(cc.per_image)}
        r = {"score_thresh": thresh, "batches": batches, "launches": counts,
             "nms_host_syncs": syncs, "profile": {}}
        for size, name, pages in reqs:
            r[name] = {**_spread(latencies[name]), "detections": dets[name],
                       "candidates": cands[name]}
            print(f"  {family} ({label} threshold {thresh}) {name}: latency "
                  f"median {r[name]['median']:.2f} ms (min {r[name]['min']:.2f}, max "
                  f"{r[name]['max']:.2f}), {dets[name]} detections, candidates into the NMS "
                  f"{cands[name]['per_image_slot_mean']:.1f} an image slot (max "
                  f"{cands[name]['max']})")
        print(f"  {family} ({label} threshold): NMS host syncs {syncs} over {FAMILY_ROUNDS} "
              f"rounds, {batches[224]} + {batches[1024]} batches")
        with tempfile.TemporaryDirectory() as tmp:
            for size, pages in ((224, requests[0][1][:FAMILY_SERVING_BATCH]), (1024, large)):
                p = profile_bucket(engines[size], pages, Path(tmp) / f"{family}_{size}.json")
                st = p["stages"]
                post = st.get("postprocess", {}).get("device_ms", 0.0)
                r["profile"][size] = {
                    "wall_ms": p["wall_ms"], "device_busy_ms": p["device_busy_ms"],
                    "device_idle_share": p["device_idle_share"], "stages": st,
                    "nms_host_syncs": p["nms_host_syncs"], "top_kernels": p["top_kernels"][:6],
                    "postprocess_share_of_busy": post / max(p["device_busy_ms"], 1e-9)}
                print(f"  {family} ({label} threshold) profiled {size} px request, 4 pages: wall "
                      f"{p['wall_ms']:.3f} ms, device busy {p['device_busy_ms']:.4f} ms, idle "
                      f"{p['device_idle_share']:.4f}; " + ", ".join(
                          f"{s} {st.get(s, {}).get('device_ms', 0.0):.4f} ms (host "
                          f"{st.get(s, {}).get('host_ms', 0.0):.4f})"
                          for s in ("backbone", "head", "postprocess"))
                      + f"; postprocess {r['profile'][size]['postprocess_share_of_busy']:.3f} "
                      f"of busy, NMS host syncs {p['nms_host_syncs']}")
        out[label] = r
        del engines, m
    return out


def _one_stage_export(family: str, model, kernels: list[dict],
                      path_key: str = "one_stage", thresh_zero: bool = True) -> dict:
    """The 224 px bucket of the model at score threshold 0 (the config's
    without ``thresh_zero``) exported on the card, run by
    ``ExportedInferenceEngine`` over the deploy phase's three requests
    (``_deploy_requests``): the detections of each page held to the live
    engine's (labels equal, boxes within DEPLOY_BOX_TOL px, scores within
    DEPLOY_SCORE_TOL, and the pages whose three arrays are the same bits
    counted); the exported run's launches (``_family_launches``: 12 of
    row 1 a batch, FAMILY_ROI of row 7) are the path's."""
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine, ExportedInferenceEngine
    from layoutdit_tpu_torch.export import export_detector
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel

    cfg = _score_thresh_zero(model.cfg) if thresh_zero else model.cfg
    kw = {"score_thresh": 0.0} if thresh_zero else {}
    requests = _deploy_requests()
    live = BatchInferenceEngine(DetectorModel(model.params, cfg), image_sizes=(224,),
                                batch_size=FAMILY_SERVING_BATCH, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        export_detector(model.params, cfg, tmp, image_sizes=(224,),
                        batch_size=FAMILY_SERVING_BATCH, device="cuda")
        export_s = time.perf_counter() - t0
        engine = ExportedInferenceEngine(tmp, **kw)
        engine.predict_pages(requests[0][1][:4])  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        got = [engine.predict_pages(pages) for _, pages in requests]
        torch.cuda.synchronize()
        counts = _counts()
        gc.unfreeze()  # the loader froze every object alive then; these go with the engine
        del engine
    batches = sum(-(-len(pages) // FAMILY_SERVING_BATCH) for _, pages in requests)
    _check_launches(f"{family} exported", counts,
                    _family_launches(family, cfg, batches, train=False), 1)
    for k in kernels:
        k[f"{path_key}_launches"] = k.get(f"{path_key}_launches", 0) + counts[k["name"]]
    box_err = score_err = 0.0
    pages = same_bits = n_dets = 0
    for (_, req), results in zip(requests, got):
        for w, g in zip(live.predict_pages(req), results):
            b, sc = _match((w.boxes, w.scores, w.labels), (g.boxes, g.scores, g.labels))
            box_err, score_err = max(box_err, b), max(score_err, sc)
            same_bits += all(np.array_equal(getattr(w, a), getattr(g, a))
                             for a in ("boxes", "scores", "labels"))
            pages += 1
            n_dets += len(w.boxes)
    print(f"  {family} export of the 224 px bucket (threshold {'0' if thresh_zero else 'the '
          f'config\'s'}): {export_s:.2f} s; {pages} "
          f"pages, {n_dets} detections equal to the live engine's (largest box difference "
          f"{box_err:.6g} px, score {score_err:.6g}), {same_bits} of {pages} pages the same bits")
    return {"export_s": export_s, "pages": pages, "detections": n_dets,
            "max_box_err_px": box_err, "max_score_err": score_err,
            "pages_same_bits": same_bits, "launches": counts}


def _one_stage_score(family: str, path: Path, params, kernels: list[dict],
                     path_key: str = "one_stage", model_overrides: dict | None = None,
                     thresh_zero: bool = True) -> dict:
    """``Evaluator.score()`` of the trained model (the config at ``path``
    with ``model_overrides``) over FAMILY_SCORE_PAGES fixture pages at
    batch 16, a single-stage or DETR model's score threshold at 0 (at the
    config's, few trained steps leave no detection) with ``thresh_zero``:
    bbox metrics finite, pages/s; launches ``_family_launches``'s."""
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel

    base, cfg = _family_cfg(path, FAMILY_BATCH, model_overrides)
    model = DetectorModel(params, _score_thresh_zero(cfg) if thresh_zero else cfg)
    with tempfile.TemporaryDirectory() as tmp:
        rc = dataclasses.replace(_fixture_run(base, tmp, FAMILY_SCORE_PAGES),
                                 eval_input="samples")
        evaluator = Evaluator(model, rc)
        evaluator.score()  # warm-up: the first batch's set-up
        _reset_counts()
        t0 = time.perf_counter()
        metrics = evaluator.score()
        score_s = time.perf_counter() - t0
        counts = _counts()
    batches = -(-FAMILY_SCORE_PAGES // FAMILY_BATCH)
    _check_launches(f"{family} score", counts,
                    _family_launches(family, cfg, batches, train=False), 1)
    for k in kernels:
        k[f"{path_key}_launches"] = k.get(f"{path_key}_launches", 0) + counts[k["name"]]
    if metrics is None or not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"{family} score: metrics {metrics}")
    out = {"pages": FAMILY_SCORE_PAGES, "score_s": score_s,
           "pages_per_s": FAMILY_SCORE_PAGES / score_s,
           "metrics": {k: metrics[k] for k in ("mAP", "AP50")}}
    print(f"  {family} score(): {FAMILY_SCORE_PAGES} pages in {score_s:.3f} s "
          f"({out['pages_per_s']:.2f} pages/s), mAP {metrics['mAP']:.4f}")
    return out


def phase_one_stage(kernels: list[dict], card: str) -> dict:
    """RetinaNet and FCOS at full width (dit-base, FPN 256, four 256-wide
    convs a subnet or tower), 224 px, random weights from seed 0, bf16:
    each serving both buckets at two score thresholds, exported, trained
    and scored; its recipe runs to JAX's floors in phase ``recipes``. Rows
    7-8 launch nowhere on this path."""
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel, init_detector
    from layoutdit_tpu_torch.models.weights_io import tree_leaves

    t0 = time.perf_counter()
    for k in kernels:
        k["one_stage_launches"] = 0
    out = {"card": card}
    for family, path in ONE_STAGE:
        _, cfg = _family_cfg(path, FAMILY_SERVING_BATCH)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = DetectorModel(init_detector(cfg, gen, device="cuda"), cfg)
        print(f"  {family}: dit-base hidden {cfg.backbone.vit.hidden_size}, levels "
              f"{cfg.one_stage_levels}, {cfg.num_anchors_per_cell if family == 'retinanet' else 1}"
              f" anchors a cell, {sum(t.numel() for t in tree_leaves(model.params)):,} parameters")
        fam = {"serving": _one_stage_serving(family, model, kernels),
               "export": _one_stage_export(family, model, kernels)}
        fam["train"], trainer = _family_train(family, path, model, kernels, path_key="one_stage")
        fam["score"] = _one_stage_score(family, path, trainer.model.params, kernels)
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
        out[family] = fam
    for k in kernels:
        if k["name"].startswith("roi_") and k["one_stage_launches"]:
            raise RuntimeError(f"one_stage: {k['name']} launched {k['one_stage_launches']} times")
    out["phase_s"] = time.perf_counter() - t0
    print(f"  one_stage phase: {out['phase_s']:.1f} s")
    return out


# phase detr: DETR (configs/detr.json: dit-base, FPN 256, level 2 at stride
# 16, 100 queries, 6 decoder layers, d 256, 8 heads, FFN 2048, max_gt_boxes
# 32), 224 px, random weights from seed 0, bf16
DETR_CONFIG = ROOT / "configs" / "detr.json"
DETR_SHARED = {"detr_shared_matching": True}
# the matcher's problems [P, G, Q]: a train step at batch 16 paper-exact
# (6 layers x 16 images) and shared (the last layer's 16), G = 64, and
# integer costs with ties and constant padded rows at the first shape
MATCHER_CASES = (("paper_exact", 96, 32, False), ("shared", 16, 32, False),
                 ("g64", 96, 64, False), ("ties", 96, 32, True))
MATCHER_Q = 100
# fp32 operations a column costs a Dijkstra step: the relaxation's two
# subtractions and compare, the argmin's compare, the update's subtraction
MATCHER_OPS_PER_COLUMN = 5
# the recipe: JAX's DETR record in docs/convergence.md (1,024 train pages,
# 100 epochs), outside the default run (python3 chip_smoke.py --only
# detr_recipe); the kernels a DETR recipe launches
DETR_RECIPE = {"n_train": 1024, "epochs": 100}
DETR_RECIPE_KERNELS = ("short_attention", "short_attention_bwd", "linear_sum_assignment")


def _matcher_entry() -> dict:
    """The kernels line's entry of the matcher kernel (row M1), filled by
    phase detr; each path adds its launches to it as to the others'."""
    return {"name": "linear_sum_assignment", "route": "cuda",
            "source": "layoutdit_tpu_torch/csrc/matching.cu",
            "replaces": "layoutdit_tpu/ops/matching.py:28",
            "note": "no Pallas original: JAX solves with an XLA while_loop (row M1)"}


def _matcher_costs(gen, p: int, g: int, ties: bool) -> torch.Tensor:
    """[p, g, MATCHER_Q] costs as DETR's loss builds them (``match_cost``
    on random logits and boxes, gt cxcywh in the page, 1 to g valid slots a
    problem, the padded rows 0), or integer costs in 0..3 with ties and
    the padded rows (the second half) constant."""
    from layoutdit_tpu_torch.models.detection import detr

    q = MATCHER_Q
    if ties:
        cost = torch.randint(0, 4, (p, g, q), generator=gen, device="cuda").float()
        cost[:, g // 2:] = 0.0
        return cost
    logits = 2.0 * torch.randn((p, q, 6), generator=gen, device="cuda")
    boxes = torch.sigmoid(torch.randn((p, q, 4), generator=gen, device="cuda"))
    centre = 0.1 + 0.8 * torch.rand((p, g, 2), generator=gen, device="cuda")
    size = 0.02 + 0.28 * torch.rand((p, g, 2), generator=gen, device="cuda")
    labels = torch.randint(1, 6, (p, g), generator=gen, device="cuda")
    n_valid = torch.randint(1, g + 1, (p, 1), generator=gen, device="cuda")
    valid = torch.arange(g, device="cuda")[None] < n_valid
    return detr.match_cost(logits, boxes, torch.cat([centre, size], -1), labels, valid)


def _scipy_ms(cost: torch.Tensor, repeats: int = 3) -> tuple[float, np.ndarray]:
    """Host time of scipy's solver over every problem, the device-to-host
    copy included (median of ``repeats``), and its totals."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = cost.cpu().numpy()
        totals = np.array([c[scipy_lsa(c)].sum() for c in a])
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), totals


def _matcher_case(gen, label: str, p: int, g: int, ties: bool) -> dict:
    """Row M1 at one shape against its plain version on the card: the same
    indices and step counts (exactly), totals against scipy's; timed per
    call (``ms``) and on the card alone (``device_ms``), the plain version
    and scipy beside it; the bound: costs read once and indices written
    once over 3.35 TB/s, or this run's steps x (C + 1) x
    MATCHER_OPS_PER_COLUMN fp32 operations over 67 TFLOP/s."""
    from layoutdit_tpu_torch.ops import matching as lsa

    cost = _matcher_costs(gen, p, g, ties)
    got, steps = lsa.linear_sum_assignment(cost, return_steps=True)
    want, want_steps = lsa.linear_sum_assignment_plain(cost, return_steps=True)
    torch.cuda.synchronize()
    mismatched = int((got != want).sum())
    if mismatched or not torch.equal(steps, want_steps) or int(steps.min()) < 1:
        raise RuntimeError(f"matcher {label}: {mismatched} indices and steps "
                           f"{steps.tolist()} against {want_steps.tolist()} differ from the "
                           "plain version")
    ms = _time_ms(lambda: lsa.linear_sum_assignment(cost), 20)
    device_ms = _device_ms(lambda: lsa.linear_sum_assignment(cost), 20)
    plain_ms = _time_ms(lambda: lsa.linear_sum_assignment_plain(cost), 2)
    scipy_ms, totals = _scipy_ms(cost)
    mine = torch.gather(cost, 2, got[..., None])[..., 0].sum(1).double().cpu().numpy()
    gap = float(np.abs(mine - totals).max())
    if gap > 1e-3 * max(1.0, float(np.abs(totals).max())):
        raise RuntimeError(f"matcher {label}: totals {gap:.3g} from scipy's optimum")
    nbytes = cost.numel() * 4 + got.numel() * 8
    flops = int(steps.sum()) * (cost.shape[2] + 1) * MATCHER_OPS_PER_COLUMN
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    r = {"shape": f"P={p} G={g} Q={cost.shape[2]}" + (" integer ties" if ties else ""),
         "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "scipy_host_ms": scipy_ms,
         "bound_ms": bound, "bound_by": by, "max_abs_err": float(mismatched),
         "steps_max": int(steps.max()), "steps_mean": float(steps.float().mean()),
         "steps_total": int(steps.sum()), "scipy_total_gap": gap}
    print(f"  matcher {label} [{p}, {g}, {cost.shape[2]}]: indices equal to the plain "
          f"version's; {ms:.6g} ms a call, {device_ms:.6g} on the card; plain {plain_ms:.6g} ms;"
          f" scipy with the copy {scipy_ms:.6g} ms; bound {bound:.6g} ms ({by}); serial "
          f"steps max {r['steps_max']}, mean {r['steps_mean']:.1f}; totals within {gap:.3g} "
          "of scipy's")
    return r


def _detr_kernels(gen, kernels: list[dict]) -> dict:
    """Row M1 at MATCHER_CASES; the first case's numbers are its entry's
    in the kernels line, the others beside them under their labels."""
    out = {label: _matcher_case(gen, label, p, g, ties) for label, p, g, ties in MATCHER_CASES}
    for entry in (k for k in kernels if k["name"] == "linear_sum_assignment"):
        main = out["paper_exact"]
        entry.update({k: main[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                           "bound_by", "max_abs_err", "steps_max")})
        entry.update(library_ms=None, scipy_host_ms=main["scipy_host_ms"])
        for label in ("shared", "g64", "ties"):
            entry.update({f"{label}_{k}": v for k, v in out[label].items()})
    return out


def _bucket_serving(family: str, model, kernels: list[dict], path_key: str, roi: int = 0,
                    thresh_zero: bool = True, int8: bool = False,
                    per_page: int | None = None) -> tuple[dict, dict]:
    """The deploy phase's three requests in one 224 px bucket and its four
    large pages in one 1024 px bucket, batch 4, FAMILY_ROUNDS timed
    rounds: latency, detections (``per_page`` a page, when given); every
    detection kept (engine threshold 0, the family's at 0 with
    ``thresh_zero``) or the config's thresholds; an int8 W8A8 encoder with
    ``int8``. Launches 12 of row 1 a 224 px batch and 12 of row 3 a 1024
    px batch (none for ResNet-50), ``roi`` of row 7 a batch, no other.
    Then one profiled request of four pages a bucket by stage
    (``backbone``, ``head``, ``postprocess``). -> (results, the engine of
    each bucket)."""
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel
    from layoutdit_tpu_torch.tools.profile_serving import profile_bucket

    cfg = _score_thresh_zero(model.cfg) if thresh_zero else model.cfg
    model = DetectorModel(model.params, cfg)
    requests = _deploy_requests()
    large = requests[1][1]
    sizes = ("8 small pages", "4 large pages", "4 small + 2 large pages")
    reqs = [(224, f"224 px bucket, {d}", pages) for d, (_, pages) in zip(sizes, requests)]
    reqs.append((1024, "1024 px bucket, 4 large pages", large))
    kw = {"score_thresh": 0.0} if thresh_zero else {}
    engines = {size: BatchInferenceEngine(model, image_sizes=(size,), int8=int8,
                                          batch_size=FAMILY_SERVING_BATCH, **kw)
               for size in (224, 1024)}
    engines[224].predict_pages(requests[0][1][:4])  # warm-up, both buckets
    engines[1024].predict_pages(large)
    torch.cuda.synchronize()
    _reset_counts()
    latencies = {name: [] for _, name, _ in reqs}
    dets = {}
    batches = {224: 0, 1024: 0}
    for _ in range(FAMILY_ROUNDS):
        for size, name, pages in reqs:
            t0 = time.perf_counter()
            results = engines[size].predict_pages(pages)
            torch.cuda.synchronize()
            latencies[name].append((time.perf_counter() - t0) * 1e3)
            dets[name] = _check_pages(pages, results)
            if per_page is not None and dets[name] != per_page * len(pages):
                raise RuntimeError(f"{family} serving: not {per_page} detections a page")
            batches[size] += -(-len(pages) // FAMILY_SERVING_BATCH)
    counts = _counts()
    n = 0 if cfg.backbone_kind == "resnet50" else cfg.backbone.vit.num_hidden_layers
    want = {name: 0 for name in _counters()}
    want.update(short_attention=n * batches[224], flash_attention=n * batches[1024],
                roi_align=roi * (batches[224] + batches[1024]))
    _check_launches(f"{family} serving", counts, want, 1)
    for k in kernels:
        k[f"{path_key}_launches"] = k.get(f"{path_key}_launches", 0) + counts[k["name"]]
    out = {"batches": batches, "launches": counts, "profile": {}}
    for size, name, pages in reqs:
        out[name] = {**_spread(latencies[name]), "detections": dets[name],
                     "pages_per_s": len(pages) * 1e3 / float(np.median(latencies[name]))}
        print(f"  {family} {name}: latency median {out[name]['median']:.2f} ms (min "
              f"{out[name]['min']:.2f}, max {out[name]['max']:.2f}), "
              f"{out[name]['pages_per_s']:.2f} pages/s, {dets[name]} detections")
    with tempfile.TemporaryDirectory() as tmp:
        for size, pages in ((224, requests[0][1][:FAMILY_SERVING_BATCH]), (1024, large)):
            p = profile_bucket(engines[size], pages, Path(tmp) / f"{family}_{size}.json")
            st = p["stages"]
            post = st.get("postprocess", {}).get("device_ms", 0.0)
            out["profile"][size] = {
                "wall_ms": p["wall_ms"], "device_busy_ms": p["device_busy_ms"],
                "device_idle_share": p["device_idle_share"], "stages": st,
                "top_kernels": p["top_kernels"][:6],
                "postprocess_share_of_busy": post / max(p["device_busy_ms"], 1e-9)}
            print(f"  {family} profiled {size} px request, 4 pages: wall {p['wall_ms']:.3f} ms, "
                  f"device busy {p['device_busy_ms']:.4f} ms, idle "
                  f"{p['device_idle_share']:.4f}; " + ", ".join(
                      f"{s} {st.get(s, {}).get('device_ms', 0.0):.4f} ms (host "
                      f"{st.get(s, {}).get('host_ms', 0.0):.4f})"
                      for s in ("backbone", "head", "postprocess"))
                  + f"; postprocess {out['profile'][size]['postprocess_share_of_busy']:.3f} "
                  "of busy")
    return out, engines


def phase_detr(gen, kernels: list[dict], card: str, kernel_cases: dict | None = None) -> dict:
    """DETR at full width (``configs/detr.json``), 224 px, random weights
    from seed 0, bf16: row M1 against its plain version at a step's
    shapes; serving both buckets; the 224 px bucket exported and held to
    the live engine; one epoch and TRAIN_REPEATS steps at batch 16,
    paper-exact and with shared matching, each with a traced step (the
    ``matcher`` range); ``score()`` of 64 pages. Launches: row M1 one a
    train step and none in predict; rows 7-8 none. ``kernel_cases``:
    ``_detr_kernels``' result when it ran before."""
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel, init_detector
    from layoutdit_tpu_torch.models.weights_io import tree_leaves

    t0 = time.perf_counter()
    for k in kernels:
        k["detr_launches"] = 0
    out = {"card": card, "kernels": (_detr_kernels(gen, kernels) if kernel_cases is None
                                     else kernel_cases)}
    _, cfg = _family_cfg(DETR_CONFIG, FAMILY_SERVING_BATCH)
    model = DetectorModel(init_detector(cfg, torch.Generator(device="cuda").manual_seed(0),
                                        device="cuda"), cfg)
    print(f"  detr: dit-base hidden {cfg.backbone.vit.hidden_size}, level {cfg.detr_level}, "
          f"{cfg.detr_num_queries} queries, {cfg.detr_layers} decoder layers, d "
          f"{cfg.detr_dim}, {sum(t.numel() for t in tree_leaves(model.params)):,} parameters")
    out["serving"], _ = _bucket_serving("detr", model, kernels, "detr",
                                        per_page=model.cfg.detr_num_queries)
    out["export"] = _one_stage_export("detr", model, kernels, path_key="detr")
    del model
    for label, overrides in (("paper_exact", None), ("shared", DETR_SHARED)):
        model = DetectorModel(init_detector(  # each variant from the same weights
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"), cfg)
        train, trainer = _family_train(f"detr {label}", DETR_CONFIG, model, kernels,
                                       path_key="detr", model_overrides=overrides,
                                       profile=True)
        st = train["profile"]["stages"]
        matcher = st.get("matcher", {}).get("device_ms", 0.0)
        train["matcher_device_ms"] = matcher
        train["matcher_share_of_busy"] = matcher / max(train["profile"]["device_busy_ms"], 1e-9)
        print(f"  detr {label} traced step: wall {train['profile']['wall_ms']:.3f} ms, device "
              f"busy {train['profile']['device_busy_ms']:.4f} ms, idle "
              f"{train['profile']['device_idle_share']:.4f}; " + ", ".join(
                  f"{s} {st.get(s, {}).get('device_ms', 0.0):.4f} ms (host "
                  f"{st.get(s, {}).get('host_ms', 0.0):.4f})"
                  for s in ("forward", "loss", "matcher", "backward", "optimizer"))
              + f"; matcher {train['matcher_share_of_busy']:.4f} of busy")
        out[label] = train
        if label == "paper_exact":
            out["score"] = _one_stage_score("detr", DETR_CONFIG, trainer.model.params, kernels,
                                            path_key="detr")
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
    for k in kernels:
        if k["name"].startswith("roi_") and k["detr_launches"]:
            raise RuntimeError(f"detr: {k['name']} launched {k['detr_launches']} times")
    out["phase_s"] = time.perf_counter() - t0
    print(f"  detr phase: {out['phase_s']:.1f} s")
    return out


def phase_detr_recipe(kernels: list[dict]) -> dict:
    """``tools/convergence.py --family detr`` and ``detr_shared`` at
    DETR_RECIPE, bf16: the first held to the flagship's mAP and AP50
    floors, the second reported."""
    t0 = time.perf_counter()
    out = {family: _family_convergence(family, kernels, path_key="detr_recipe",
                                       launched=DETR_RECIPE_KERNELS, **DETR_RECIPE)
           for family in ("detr", "detr_shared")}
    out["phase_s"] = time.perf_counter() - t0
    print(f"  detr_recipe phase: {out['phase_s']:.1f} s")
    return out


# phase recipes: the families' recipes, each family's path and the kernels
# it launches; each runs in its own process, all at once (``--recipe-child``).
# "flagship" is phase convergence's recipe, "lora" phase lora_recipe's.
FAMILY_RECIPES = {"cascade": ("families", MAIN_KERNELS), "mask": ("families", MAIN_KERNELS),
                  "retinanet": ("one_stage", ONE_STAGE_RECIPE_KERNELS),
                  "fcos": ("one_stage", ONE_STAGE_RECIPE_KERNELS),
                  "lora": ("lora_recipe", MAIN_KERNELS),
                  "flagship": ("convergence", MAIN_KERNELS)}
RECIPE_TIMEOUT_S = 600


def recipe_child(family: str, out_path: str) -> int:
    """Phase ``recipes``' process of one family: its recipe held to its
    floors (``_family_convergence``), the result and the launches written
    to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one intra-op thread: six of these run beside two busy processes on
    # the host's cores, and their host work is Python, not CPU kernels
    torch.set_num_threads(1)
    path_key, launched = FAMILY_RECIPES[family]
    if family == "lora":
        result = phase_lora_recipe([])
    elif family == "flagship":
        result = phase_convergence([], "")
    else:
        result = _family_convergence(family, [], path_key, launched)
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def _start_recipes(families: tuple[str, ...]) -> tuple:
    """Starts the recipes of ``families`` (``tools/convergence.py
    --family``, bf16, each held to its floors; "lora" is
    ``tools/lora_quality.py``, ``phase_lora_recipe``; "flagship" is
    ``phase_convergence``), each in a fresh process, all at once on the
    card: they are small and host-bound, and one at a time they took most
    of the script's time. ``_join_recipes`` waits for them."""
    tmp = tempfile.mkdtemp(prefix="recipes")
    procs = {}
    try:
        for family in families:
            log = open(Path(tmp) / f"{family}.log", "w")
            procs[family] = (subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--recipe-child", family,
                 str(Path(tmp) / f"{family}.json")],
                stdout=log, stderr=subprocess.STDOUT), log)
    except BaseException:
        _stop_recipes((tmp, procs, 0.0))
        raise
    return tmp, procs, time.perf_counter()


def _stop_recipes(handle: tuple) -> None:
    """Kills the recipe processes still running and removes their folder."""
    tmp, procs, _ = handle
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    shutil.rmtree(tmp, ignore_errors=True)


def _join_recipes(handle: tuple, kernels: list[dict]) -> dict:
    """Waits for ``_start_recipes``' processes, prints their lines and adds
    each one's launches to its family's path. The recipes' wall times are
    measured with the others, and whatever else runs then, beside them."""
    tmp, procs, t0 = handle
    out = {}
    try:
        for family, (proc, log) in procs.items():
            rc = proc.wait(timeout=max(1.0, RECIPE_TIMEOUT_S - (time.perf_counter() - t0)))
            log.close()
            text = (Path(tmp) / f"{family}.log").read_text()
            print("\n".join(line for line in text.splitlines() if line.startswith("  ")))
            if rc != 0:
                raise RuntimeError(f"{family} recipe: exit code {rc}\n{text[-3000:]}")
            with open(Path(tmp) / f"{family}.json") as f:
                out[family] = json.load(f)
    finally:
        _stop_recipes(handle)
    for family, r in out.items():
        path_key = FAMILY_RECIPES[family][0]
        for k in kernels:
            k[f"{path_key}_launches"] = k.get(f"{path_key}_launches", 0) + r["launches"][k["name"]]
    out["phase_s"] = time.perf_counter() - t0
    print(f"  recipes ({', '.join(procs)} at once): {out['phase_s']:.1f} s from their start")
    return out


def phase_recipes(kernels: list[dict], families: tuple[str, ...]) -> dict:
    """The recipes of ``families`` at once (``_start_recipes``), waited for."""
    return _join_recipes(_start_recipes(families), kernels)


# phase finetune: a dit-base encoder warm-started from a converted
# checkpoint, LoRA training (configs/lora.json), the adapters merged by
# tools/merge_lora.py, the merged model served in bf16 and int8 in both
# buckets of configs/serving_1024.json and its 224 px bucket exported
# with --int8 (tools/export_model.py)
LORA_CONFIG = ROOT / "configs" / "lora.json"
FINETUNE_STEPS = 14  # steps on one repeated batch, LoRA and the full fine-tune alike
FINETUNE_WARMUP = 2  # of them not timed
# the full fine-tune's learning rate: the port's default recipe's
# (lora.json's 1e-3 suits adapters; on the whole encoder its loss diverges)
FULL_FT_LR = 1e-4
# the stages of a traced step compared between LoRA and the full fine-tune
STEP_STAGES = ("forward", "loss", "backward", "optimizer")
# the int8 encoder's taps against the bf16 one's, relative Frobenius (JAX's
# budget, tests/test_quant.py:45-62)
INT8_REL_TOL = 0.03
# the state_dict the warm start reads: the manifest's names and shapes,
# values from this seed
MANIFEST_SEED = 11


def _manifest_state_dict() -> dict:
    """A dit-base HF ``BeitModel`` state_dict from the package's copy of
    the manifest: every name and shape, random values from a seeded
    ``torch.Generator`` at a pretrained model's scales (weights N(0, 0.02),
    LayerNorm scales near 1, layer scales near 0.1)."""
    from layoutdit_tpu_torch.tools.convert_hf_checkpoint import manifest_path

    with open(manifest_path("dit-base")) as f:
        keys = json.load(f)["keys"]
    gen = torch.Generator().manual_seed(MANIFEST_SEED)
    sd = {}
    for name, shape in keys.items():
        t = torch.randn(shape, generator=gen)
        if "layernorm" in name and name.endswith("weight"):
            t = 1.0 + 0.02 * t
        elif name.endswith(("lambda_1", "lambda_2")):
            t = 0.1 + 0.01 * t
        else:
            t = 0.02 * t
        sd[name] = t
    return sd


def _same_encoder(label: str, vit: dict, want: dict) -> None:
    """The encoder's float32 leaves equal ``want``'s (the state_dict's
    tensors in the port's layout), bit for bit."""
    from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_paths

    got = dict(zip(tree_paths(vit), tree_leaves(vit)))
    for path, t in zip(tree_paths(want), tree_leaves(want)):
        if not torch.equal(got[path].cpu(), t):
            raise RuntimeError(f"finetune: {label}: encoder leaf {path} differs from the "
                               "checkpoint's")


def _opt_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for key in ("mu", "nu") for t in state[key])


def _trace_step(label: str, trainer, batch) -> dict:
    """One more step on ``batch`` under the profiler
    (``tools/profile_train.profile_step``): wall, device busy and idle,
    and the host and device ms of each of STEP_STAGES."""
    from layoutdit_tpu_torch.tools.profile_train import profile_step

    with tempfile.TemporaryDirectory() as tmp:
        p = profile_step(trainer, 0, Path(tmp) / "step.json", batch=batch)
    out = {k: p[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                             "nms_host_syncs")}
    out["stages"] = {s: p["stages"].get(s, {}) for s in STEP_STAGES}
    out["top_kernels"] = p["top_kernels"][:8]
    print(f"  {label} traced step: wall {p['wall_ms']:.3f} ms, device busy "
          f"{p['device_busy_ms']:.3f} ms, idle {p['device_idle_share']:.4f}, NMS host syncs "
          f"{p['nms_host_syncs']}; " + ", ".join(
              f"{s} device {st.get('device_ms', 0.0):.3f} ms (host {st.get('host_ms', 0.0):.3f})"
              for s, st in out["stages"].items()))
    return out


def _finetune_steps(label: str, rc, model, batch) -> dict:
    """A trainer of ``rc`` over ``model`` and FINETUNE_STEPS steps on
    ``batch``: median and minimum step time (the first FINETUNE_WARMUP
    not counted), the peak memory over the trainer's life above what was
    allocated before it, the optimizer state's bytes, the moments' count,
    the losses (finite), and one more step traced (``_trace_step``)."""
    from layoutdit_tpu_torch.train.trainer import Trainer

    base = _allocated_gib()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(rc, model)
    times, losses = _timed_steps(trainer, batch, FINETUNE_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = times[FINETUNE_WARMUP:]
    out = {**{f"step_{k}": v for k, v in _spread(timed).items()}, "step_ms": timed,
           "peak_gib_above_start": peak - base, "start_gib": base,
           "opt_state_bytes": _opt_bytes(trainer.opt_state),
           "moments": len(trainer.opt_state["mu"]), "losses": losses,
           "learning_rate": rc.train.learning_rate}
    print(f"  {label}: lr {rc.train.learning_rate:g}, {len(timed)} timed steps at batch "
          f"{rc.data.batch_size}, median {out['step_median']:.3f} ms (min "
          f"{out['step_min']:.3f}, max {out['step_max']:.3f}); "
          f"peak {out['peak_gib_above_start']:.3f} GiB above the {base:.3f} GiB allocated "
          f"before; optimizer state {out['opt_state_bytes'] / 2**30:.4f} GiB in "
          f"{out['moments']} x 2 moments; losses {[round(x, 4) for x in losses]}")
    out["trace"] = _trace_step(label, trainer, batch)
    return out, trainer


def _serve_merged(merged: str, kernels: list[dict]) -> dict:
    """The merged checkpoint in ``configs/serving_1024.json``'s model,
    served in bf16 and with an int8 W8A8 encoder by ``_bucket_serving``
    (both buckets, batch 4, the config's thresholds, rows 1 and 3 and one
    RoIAlign a batch); then the valid detections of every page the same
    in number in both, and the int8 encoder's taps within INT8_REL_TOL of
    the bf16 one's in each bucket."""
    from layoutdit_tpu_torch.config import load_config
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel, _normalize
    from layoutdit_tpu_torch.models.model import LayoutDetectionModel
    from layoutdit_tpu_torch.models.vit import vit_forward

    mc, _ = load_config(str(CONFIG))
    model = LayoutDetectionModel(mc, "bfloat16", device="cuda", warm_start=False)
    model.restore_checkpoint(merged)
    dm = DetectorModel(model.params, model.cfg)
    out, engines = {}, {}
    for name in ("bf16", "int8"):
        out[name], engines[name] = _bucket_serving(
            f"merged {name}", dm, kernels, "finetune", roi=FAMILY_ROI["resnet"],
            thresh_zero=False, int8=name == "int8")
    # the detections' counts, page for page, and the int8 encoder's error
    requests = _deploy_requests()
    for label, pages in requests:
        for size in (224, 1024):
            got = [len(r.boxes) for r in engines["int8"][size].predict_pages(pages)]
            want = [len(r.boxes) for r in engines["bf16"][size].predict_pages(pages)]
            if got != want:
                raise RuntimeError(f"finetune: int8 valid detections {got} against bf16 "
                                   f"{want} ({label}, {size} px bucket)")
    errs = {}
    for size, page in ((224, requests[0][1][0]), (1024, requests[1][1][0])):
        bf16 = engines["bf16"][size]
        x = bf16._upload_batch([bf16._decode_page(page)], size)[0][0]
        x = _normalize(x[None].float(), model.cfg).to(torch.bfloat16)
        taps = model.cfg.backbone.taps
        with torch.inference_mode():
            ref, q = (vit_forward(engines[e][size].params["backbone"]["vit"], x,
                                  model.cfg.backbone.vit, taps, torch.bfloat16)
                      for e in ("bf16", "int8"))
        errs[size] = [_rel_err(g, w) for g, w in zip(q, ref)]
        print(f"  int8 encoder {size} px: taps {list(taps)} relative error against bf16 "
              f"{[round(e, 5) for e in errs[size]]} (tolerance {INT8_REL_TOL})")
        if not max(errs[size]) < INT8_REL_TOL:
            raise RuntimeError("finetune: the int8 encoder is off the bf16 one")
    out["int8_tap_rel_err"] = errs
    out["int8_gemm"] = _int8_breakdown()
    return out, dm


# the 1024 px bucket's encoder linears at batch 4: rows (4 x 4097 tokens),
# K, and N of the fused qkv and of mlp_in (JAX's default int8 subset)
INT8_GEMMS = ((4 * 4097, 768, 2304), (4 * 4097, 768, 3072))
INT8_ITERS = 20


def _int8_breakdown() -> dict:
    """One W8A8 linear's parts against the bf16 linear at the 1024 px
    bucket's shapes, CUDA events: the activations' quantization, the
    s8 x s8 -> s32 ``torch._int_mm``, the dequantization with the bias,
    the whole ``int8_linear``, and ``F.linear`` in bf16. The GEMMs' bounds
    at the published peaks (int8 1979 TOP/s, bf16 989 TFLOP/s)."""
    import torch.nn.functional as F

    from layoutdit_tpu_torch.ops import quant

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for m, k, n in INT8_GEMMS:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = 0.02 * torch.randn(n, k, generator=gen, device="cuda")
        b = torch.zeros(n, device="cuda")
        p = quant.quantize_linear({"weight": w, "bias": b})
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        xq, xs = quant.quantize_activations(x)
        y = quant._int_mm(xq, p["weight_q"])
        with torch.inference_mode():
            r = {
                "quantize_ms": _time_ms(lambda: quant.quantize_activations(x), INT8_ITERS),
                "int_mm_ms": _time_ms(lambda: quant._int_mm(xq, p["weight_q"]), INT8_ITERS),
                "dequant_ms": _time_ms(lambda: (y.float() * xs * p["weight_scale"]
                                                + p["bias"]).to(torch.bfloat16), INT8_ITERS),
                "int8_linear_ms": _time_ms(lambda: quant.int8_linear(x, p), INT8_ITERS),
                "bf16_linear_ms": _time_ms(lambda: F.linear(x, wb, bb), INT8_ITERS),
            }
        ops = 2.0 * m * k * n
        r["int8_gemm_bound_ms"] = ops / 1979e12 * 1e3
        r["bf16_gemm_bound_ms"] = ops / PEAK_BF16_FLOPS * 1e3
        out[f"{m}x{k}x{n}"] = r
        print(f"  W8A8 linear [{m}, {k}] x [{k}, {n}]: quantize {r['quantize_ms']:.4f} ms, "
              f"_int_mm {r['int_mm_ms']:.4f} (bound {r['int8_gemm_bound_ms']:.4f}), dequant "
              f"{r['dequant_ms']:.4f}, int8_linear {r['int8_linear_ms']:.4f}; bf16 F.linear "
              f"{r['bf16_linear_ms']:.4f} (bound {r['bf16_gemm_bound_ms']:.4f})")
    return out


def _export_int8(merged: str, dm, kernels: list[dict], tmp: str) -> dict:
    """``tools/export_model.py --int8`` of the merged checkpoint's 224 px
    bucket (``configs/serving_1024.json``'s model), run by
    ``ExportedInferenceEngine`` over the deploy phase's requests: each
    page's detections the live int8 engine's, bit for bit; the exported
    run's launches (row 1 twelve times a batch, row 7 once) are the
    path's."""
    import os

    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine, ExportedInferenceEngine
    from layoutdit_tpu_torch.tools import export_model

    art = f"{tmp}/int8_artifact"
    old = os.environ.get("LAYOUTDIT_CONFIG")
    os.environ["LAYOUTDIT_CONFIG"] = str(CONFIG)
    try:
        t0 = time.perf_counter()
        manifest = export_model.main(["--out", art, "--checkpoint", merged, "--sizes", "224",
                                      "--batch-size", str(FAMILY_SERVING_BATCH), "--int8"])
        export_s = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("LAYOUTDIT_CONFIG")
        else:
            os.environ["LAYOUTDIT_CONFIG"] = old
    if "int8" not in manifest["leaf_dtypes"]:
        raise RuntimeError("finetune: the int8 artifact holds no int8 leaf")
    live = BatchInferenceEngine(dm, image_sizes=(224,), batch_size=FAMILY_SERVING_BATCH,
                                int8=True)
    engine = ExportedInferenceEngine(art)
    requests = _deploy_requests()
    engine.predict_pages(requests[0][1][:4])  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    got = [engine.predict_pages(pages) for _, pages in requests]
    torch.cuda.synchronize()
    counts = _counts()
    gc.unfreeze()
    del engine
    batches = sum(-(-len(pages) // FAMILY_SERVING_BATCH) for _, pages in requests)
    want = {k: 0 for k in _counters()}
    want.update(short_attention=dm.cfg.backbone.vit.num_hidden_layers * batches,
                roi_align=batches)
    _check_launches("finetune int8 export", counts, want, 1)
    for k in kernels:
        k["finetune_launches"] += counts[k["name"]]
    pages = n_dets = 0
    for (label, req), results in zip(requests, got):
        for w, g in zip(live.predict_pages(req), results):
            if not all(np.array_equal(getattr(w, a), getattr(g, a))
                       for a in ("boxes", "scores", "labels")):
                raise RuntimeError(f"finetune: the int8 artifact's detections differ from the "
                                   f"live int8 engine's ({label})")
            pages += 1
            n_dets += len(w.boxes)
    print(f"  int8 export of the 224 px bucket: {export_s:.2f} s; {pages} pages, {n_dets} "
          f"detections, the live int8 engine's bit for bit")
    return {"export_s": export_s, "pages": pages, "detections": n_dets, "launches": counts}


def phase_finetune(kernels: list[dict], card: str) -> dict:
    """Fine-tune then deploy, dit-base at full width (hidden 768, 12
    layers): a state_dict from the manifest converted by
    ``tools/convert_hf_checkpoint.py`` and warm-started twice
    (``previous_layout_dit_checkpoint`` and ``LAYOUTDIT_DIT_BASE_PTH``,
    the encoder the checkpoint's bits); ``configs/lora.json`` (r16, alpha
    16, q and v) trained at 224 px, batch 16, through ``Trainer``: the
    adapted model's first forward the adapter-free model's bits, the
    frozen encoder's bits kept, every adapter moved, moments for the
    trainable leaves only, rows 1, 2, 7 and 8 launched 12, 12, 1 and 1
    times a step; step time, peak memory and optimizer bytes beside the
    full fine-tune's; ``tools/merge_lora.py``; the merged model served in
    bf16 and int8 (``_serve_merged``) and exported with ``--int8``
    (``_export_int8``)."""
    import os

    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models import vit as vit_mod
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel
    from layoutdit_tpu_torch.models.lora import merge_lora, num_trainable, trainable_mask
    from layoutdit_tpu_torch.models.model import LayoutDetectionModel
    from layoutdit_tpu_torch.models.weights_io import (
        beit_state_dict_to_params,
        tree_leaves,
        tree_map,
        tree_paths,
    )
    from layoutdit_tpu_torch.tools import convert_hf_checkpoint
    from layoutdit_tpu_torch.tools import merge_lora as merge_cli
    from layoutdit_tpu_torch.train.checkpoint import load_checkpoint
    from layoutdit_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    for k in kernels:
        k["finetune_launches"] = 0
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the warm start, by the config's field and by the environment
        sd = _manifest_state_dict()
        pth, msgpack = f"{tmp}/dit-base.pth", f"{tmp}/dit-base.msgpack"
        torch.save(sd, pth)
        t0 = time.perf_counter()
        prov = convert_hf_checkpoint.convert(pth, "dit-base", msgpack)
        convert_s = time.perf_counter() - t0
        want = beit_state_dict_to_params(sd, vit_mod.DIT_BASE)
        del sd
        lora_rc = load_run_config(str(LORA_CONFIG))
        plain_mc = dataclasses.replace(lora_rc.model, lora_rank=0)
        t0 = time.perf_counter()
        full = LayoutDetectionModel(plain_mc, "bfloat16", seed=0, device="cuda",
                                    previous_layout_dit_checkpoint=msgpack)
        warm_s = time.perf_counter() - t0
        _same_encoder("previous_layout_dit_checkpoint", full.params["backbone"]["vit"], want)
        old = os.environ.get("LAYOUTDIT_DIT_BASE_PTH")
        os.environ["LAYOUTDIT_DIT_BASE_PTH"] = pth
        try:
            t0 = time.perf_counter()
            env = LayoutDetectionModel(plain_mc, "bfloat16", seed=0, device="cuda")
            env_s = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("LAYOUTDIT_DIT_BASE_PTH")
            else:
                os.environ["LAYOUTDIT_DIT_BASE_PTH"] = old
        _same_encoder("LAYOUTDIT_DIT_BASE_PTH", env.params["backbone"]["vit"], want)
        del env, want
        out["warm_start"] = {"convert_s": convert_s, "msgpack_warm_start_s": warm_s,
                             "pth_warm_start_s": env_s, "source_keys": prov["n_source_keys"]}
        print(f"  converted a {prov['n_source_keys']}-key dit-base state_dict in {convert_s:.2f} "
              f"s; warm-started from the .msgpack in {warm_s:.2f} s and from "
              f"LAYOUTDIT_DIT_BASE_PTH (.pth) in {env_s:.2f} s, the encoder the checkpoint's "
              "bits both ways")

        # 2. LoRA training from the warm start
        rc = _fixture_run(lora_rc, tmp, TRAIN_EPOCH_STEPS * lora_rc.data.batch_size)
        rc = dataclasses.replace(rc, compute_dtype="bfloat16", train=dataclasses.replace(
            rc.train, tensorboard=False, checkpoint_interval=1))
        lora = LayoutDetectionModel(rc.model, "bfloat16", seed=0, device="cuda",
                                    previous_layout_dit_checkpoint=msgpack)
        cfg = lora.cfg
        mask = trainable_mask(lora.params)
        n_train, n_total = num_trainable(lora.params)
        leaves = tree_leaves(lora.params)
        frozen = [t.detach().clone() for t, m in zip(leaves, mask) if not m]
        adapters = {p: t.detach().clone() for p, t in zip(tree_paths(lora.params), leaves)
                    if p.endswith(("lora_a", "lora_b"))}
        images = torch.rand(4, 3, 224, 224, generator=torch.Generator().manual_seed(3)).cuda()
        a, b = lora.predict(images), full.predict(images)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError("finetune: the adapted model's first forward is not the "
                               "adapter-free model's bits")
        base = _allocated_gib()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(rc, DetectorModel(lora.params, cfg))
        per_step = _launches_per_step(cfg)
        _reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts, steps = _counts(), trainer.updates
        _check_launches("finetune LoRA train", counts, per_step, steps)
        for k in kernels:
            k["finetune_launches"] += counts[k["name"]]
        it = iter(trainer.dataloader)
        batch = next(it)
        it.close()
        times, losses = _timed_steps(trainer, batch, FINETUNE_STEPS)
        lora_peak = torch.cuda.max_memory_allocated() / 2**30 - base
        leaves = tree_leaves(lora.params)
        kept = [t for t, m in zip(leaves, mask) if not m]
        if not all(torch.equal(x, y) for x, y in zip(kept, frozen)):
            raise RuntimeError("finetune: a frozen encoder leaf changed")
        moved = [p for p, t in zip(tree_paths(lora.params), leaves)
                 if p in adapters and not torch.equal(t, adapters[p])]
        if len(moved) != len(adapters):
            raise RuntimeError(f"finetune: {len(adapters) - len(moved)} adapters did not move")
        state = trainer.opt_state
        train_leaves = [t for t, m in zip(leaves, mask) if m]
        if len(state["mu"]) != len(train_leaves) or any(
                m.shape != t.shape for m, t in zip(state["mu"], train_leaves)):
            raise RuntimeError("finetune: the optimizer holds moments beyond the trainable "
                               "leaves")
        timed = times[FINETUNE_WARMUP:]
        lora_out = {**{f"step_{k}": v for k, v in _spread(timed).items()}, "step_ms": timed,
                    "learning_rate": rc.train.learning_rate,
                    "peak_gib_above_start": lora_peak, "start_gib": base,
                    "opt_state_bytes": _opt_bytes(state), "moments": len(state["mu"]),
                    "trainable_params": n_train, "total_params": n_total,
                    "adapters": len(adapters), "frozen_leaves": len(frozen),
                    "epoch_steps": steps, "epoch_s": epoch_s, "launches": counts,
                    "losses": losses}
        print(f"  LoRA r{cfg.backbone.vit.lora_rank} on {list(cfg.backbone.vit.lora_targets)}: "
              f"{n_train:,} of {n_total:,} parameters trainable; epoch of {steps} steps in "
              f"{epoch_s:.2f} s, launches {counts}; lr {rc.train.learning_rate:g}, "
              f"{len(timed)} timed steps median "
              f"{lora_out['step_median']:.3f} ms (min {lora_out['step_min']:.3f}, max "
              f"{lora_out['step_max']:.3f}); peak {lora_peak:.3f} GiB above the {base:.3f} "
              f"GiB allocated before; optimizer state {lora_out['opt_state_bytes'] / 2**30:.4f}"
              f" GiB in {len(state['mu'])} x 2 moments; {len(frozen)} frozen leaves the same "
              f"bits, {len(adapters)} adapters moved; losses {[round(x, 4) for x in losses]}")
        lora_out["trace"] = _trace_step("LoRA", trainer, batch)
        ckpt = trainer.save_checkpoint(1)
        del trainer
        out["lora"] = lora_out
        full_rc = dataclasses.replace(rc, model=plain_mc, train=dataclasses.replace(
            rc.train, learning_rate=FULL_FT_LR))
        out["full_finetune"], ftrainer = _finetune_steps("full fine-tune (no LoRA, same batch)",
                                                         full_rc, DetectorModel(full.params,
                                                                                full.cfg), batch)
        del ftrainer, full
        gc.collect()
        torch.cuda.empty_cache()

        # 3. merge, then bf16 and int8 serving and the int8 export
        merged = f"{tmp}/merged.msgpack"
        old = os.environ.get("LAYOUTDIT_CONFIG")
        os.environ["LAYOUTDIT_CONFIG"] = str(LORA_CONFIG)
        try:
            t0 = time.perf_counter()
            merge_cli.main(["--checkpoint", ckpt, "--out", merged])
            merge_s = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("LAYOUTDIT_CONFIG")
            else:
                os.environ["LAYOUTDIT_CONFIG"] = old
        mine = merge_lora(lora.params["backbone"]["vit"], cfg.backbone.vit)
        written = load_checkpoint(merged, map_location="cuda")["params"]["backbone"]["vit"]
        _same_encoder("merged", written, tree_map(lambda t: t.detach().cpu(), mine))
        print(f"  tools/merge_lora.py: {merge_s:.2f} s, the merged encoder merge_lora's bits")
        out["merge_s"] = merge_s
        del lora, mine, written
        gc.collect()
        torch.cuda.empty_cache()
        out["serving"], dm = _serve_merged(merged, kernels)
        out["export"] = _export_int8(merged, dm, kernels, tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  finetune phase: {out['phase_s']:.1f} s")
    return out


# phase resnet: ResNet-50 + FPN Faster R-CNN at full width (FPN 256),
# configs/serving_1024.json's model with backbone_type resnet50
RESNET = {"backbone_type": "resnet50"}


def phase_resnet(kernels: list[dict], card: str) -> dict:
    """ResNet-50 + FPN Faster R-CNN, random weights from seed 0, bf16, the
    config's thresholds: served in the 224 and 1024 px buckets
    (``_bucket_serving``: batch 4, the deploy phase's requests, a request
    a bucket profiled by stage); one epoch and TRAIN_REPEATS steps at 224
    px, batch 16 (``_family_train``); ``score()`` of 64 pages
    (``_one_stage_score``); the 224 px bucket exported and held to the
    live engine (``_one_stage_export``). Rows 7-8 launch once a batch; no
    attention kernel launches anywhere."""
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel, init_detector
    from layoutdit_tpu_torch.models.weights_io import tree_leaves

    t_phase = time.perf_counter()
    for k in kernels:
        k["resnet_launches"] = 0
    out = {"card": card}
    _, cfg = _family_cfg(CONFIG, FAMILY_SERVING_BATCH, RESNET)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = DetectorModel(init_detector(cfg, gen, device="cuda"), cfg)
    n_params = sum(t.numel() for t in tree_leaves(model.params))
    print(f"  ResNet-50 + FPN {cfg.backbone.fpn_out_channels} Faster R-CNN, {n_params:,} "
          f"parameters, buckets 224 / 1024, batch {FAMILY_SERVING_BATCH}, post-NMS "
          f"{cfg.budget.rpn_post_nms_top_n_test}")
    out["serving"], _ = _bucket_serving("resnet", model, kernels, "resnet",
                                        roi=FAMILY_ROI["resnet"], thresh_zero=False)
    at_224 = {**RESNET, "image_size": 224}
    out["train"], trainer = _family_train("resnet", CONFIG, model, kernels, path_key="resnet",
                                          model_overrides=at_224)
    params = trainer.model.params
    del trainer
    out["score"] = _one_stage_score("resnet", CONFIG, params, kernels, path_key="resnet",
                                    model_overrides=at_224, thresh_zero=False)
    _, ecfg = _family_cfg(CONFIG, FAMILY_SERVING_BATCH, at_224)
    out["export"] = _one_stage_export("resnet", DetectorModel(params, ecfg), kernels,
                                      path_key="resnet", thresh_zero=False)
    for k in kernels:
        if not k["name"].startswith("roi_align") and k["resnet_launches"]:
            raise RuntimeError(f"resnet: {k['name']} launched {k['resnet_launches']} times")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  resnet phase: {out['phase_s']:.1f} s")
    return out


def phase_lora_recipe(kernels: list[dict]) -> dict:
    """``tools/lora_quality.py`` in bf16 on the card: pretrain, then the
    full fine-tune and LoRA r8 from the same weights, held to JAX's floors
    (LoRA r8 >= 0.85 x the full fine-tune's held-out mAP); rows 1, 2, 7
    and 8 launched, no other."""
    from layoutdit_tpu_torch.tools import lora_quality

    t0 = time.perf_counter()
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        result = lora_quality.run(tmp, "cuda", "bfloat16")
    counts = _counts()
    for name, n in counts.items():
        if (n > 0) != (name in MAIN_KERNELS):
            raise RuntimeError(f"lora_recipe: {name} launched {n} times")
    for k in kernels:
        k["lora_recipe_launches"] = counts[k["name"]]
    result["launches"] = counts
    fails = lora_quality.floor_failures(result)
    result["phase_s"] = time.perf_counter() - t0
    for name in ("pretrain", "full_ft", "lora_r8"):
        r = result[name]
        print(f"  lora_recipe {name}: held-out mAP {r['mAP']:.4f}, AP50 {r['AP50']:.4f}, "
              f"{r['trainable_params']:,} trainable, optimizer {r['opt_state_bytes'] / 2**20:.2f}"
              f" MiB, {r['steps']} steps in {r['train_s']:.1f} s")
    print(f"  lora_recipe phase: {result['phase_s']:.1f} s")
    if fails:
        raise RuntimeError(f"lora_recipe: {fails}")
    return result


MOE_CONFIG = ROOT / "configs" / "moe.json"
MOE_STAGES = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine")
AT_224 = {"image_size": 224}
SCORE_B = 16  # the 224 px step's batch, for the bf16-score error


class _DropCounter:
    """Wraps the encoder's ``moe_mlp`` while installed: each MoE layer's
    share of tokens whose first choice found its expert full."""

    def __init__(self):
        from layoutdit_tpu_torch.models import vit as vit_mod

        self.vit_mod, self.orig, self.shares = vit_mod, vit_mod.moe_mlp, []

    def __enter__(self):
        from layoutdit_tpu_torch.ops import moe

        def counted(y, params, e, k, cf, **kw):
            c = moe.moe_capacity(y.shape[1], e, k, cf)
            with torch.no_grad():
                kept = moe.route(y, params["router"]["weight"], e, k, c)[3]
            self.shares.append((~kept[0]).float().mean())  # read after the run
            return self.orig(y, params, e, k, cf, **kw)

        self.vit_mod.moe_mlp = counted
        return self

    def __exit__(self, *exc):
        self.vit_mod.moe_mlp = self.orig
        self.shares = [float(x) for x in self.shares]
        return False


def _add_moe_launches(kernels: list[dict]) -> None:
    counts = _counts()
    for k in kernels:
        k["moe_launches"] = k.get("moe_launches", 0) + counts[k["name"]]


def _moe_trace(label: str, fn) -> dict:
    """One call of ``fn`` under the profiler: the device ms launched in
    each MoE range (the forward's; autograd launches the backward from
    its own thread, outside them), the backbone's, the wall and idle."""
    from torch.profiler import ProfilerActivity, profile

    from layoutdit_tpu_torch.tools.profile_serving import summarize_trace

    fn()  # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        path = Path(tmp) / "moe.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            r = summarize_trace(json.load(f), MOE_STAGES + ("backbone", "forward", "backward"))
    st = r["stages"]
    ms = {s: st.get(s, {}).get("device_ms", 0.0) for s in MOE_STAGES + ("backbone", "backward")}
    moe_ms = sum(ms[s] for s in MOE_STAGES)
    out = {"wall_ms": wall, "device_busy_ms": r["device_busy_ms"],
           "device_idle_share": r["device_idle_share"], "device_ms": ms,
           "calls": {s: st.get(s, {}).get("calls", 0) for s in MOE_STAGES},
           "moe_ms": moe_ms, "moe_share_of_backbone": moe_ms / max(ms["backbone"], 1e-9),
           "top_kernels": r["top_kernels"][:8]}
    print(f"  moe traced {label}: wall {wall:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
          f"idle {r['device_idle_share']:.4f}; backbone {ms['backbone']:.3f} ms, of it the MoE "
          f"layers' forward {moe_ms:.3f} ms (" + ", ".join(
              f"{s[4:]} {ms[s]:.3f}" for s in MOE_STAGES)
          + f"), {out['moe_share_of_backbone']:.3f} of the backbone; top kernels "
          + ", ".join(f"{k['name'][:48]} {k['device_ms']:.3f}" for k in out["top_kernels"][:5]))
    return out


def _score_dtype_error(kernels: list[dict]) -> dict:
    """``score_dtype="bfloat16"`` at the 224 px step's shape (B 16, N 197,
    H 12, D 64): the short kernel, which ignores it (as JAX's kernel
    routes do), against the bf16-score plain attention and against the
    fp32 plain attention, on the same inputs."""
    from layoutdit_tpu_torch.models import vit as vit_mod
    from layoutdit_tpu_torch.ops import short_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(19)
    qkv = torch.randn(SCORE_B, 197, 3 * 768, generator=gen, device="cuda").bfloat16()
    with torch.no_grad():
        got = vit_mod.attention_core(qkv, 12, score_dtype="bfloat16")
        bf16 = vit_mod.bf16_score_attention_plain(qkv, 12)
        q, k, v = sa.split_qkv(qkv, 12)
        fp32 = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / 8.0, -1)
        fp32 = torch.einsum("bhnm,bmhd->bnhd", fp32, v.float())
    out = {"shape": [SCORE_B, 197, 12, 64],
           "max_abs_err_vs_bf16_scores": float((got.float() - bf16.float()).abs().max()),
           "max_abs_err_vs_fp32_scores": float((got.float() - fp32).abs().max()),
           "bf16_scores_vs_fp32_scores": float((bf16.float() - fp32).abs().max())}
    print(f"  score_dtype bfloat16 at B={SCORE_B} N=197 H=12 D=64: the short kernel (which "
          f"ignores it) against the bf16-score plain attention max |err| "
          f"{out['max_abs_err_vs_bf16_scores']:.6g}, against fp32 scores "
          f"{out['max_abs_err_vs_fp32_scores']:.6g}; bf16 against fp32 scores "
          f"{out['bf16_scores_vs_fp32_scores']:.6g}")
    if out["max_abs_err_vs_bf16_scores"] > 0.05:
        raise RuntimeError(f"moe: bf16 scores: {out}")
    return out


def phase_moe(kernels: list[dict], card: str) -> dict:
    """``configs/moe.json`` at full width (dit-base, 8 experts in 6 of 12
    layers, top-1, capacity 1.25, bf16), random weights from seed 0:
    served in the 224 and 1024 px buckets beside the dense
    ``serving_1024.json`` model (``_bucket_serving``: latency, the
    backbone's device ms), the share of tokens dropped at capacity; one
    epoch and TRAIN_REPEATS steps at 224 px, batch 16, beside the dense
    flagship step (``_family_train``: step ms, images/s, peak GiB); two
    gradients of one state the same bits (``tools/repeat_step``); a traced
    step and a traced 1024 px request split into the MoE ranges; the 224
    px bucket exported and held to the live engine; the bf16-score error.
    Rows 1, 2, 3, 7 and 8 launch on this path."""
    from layoutdit_tpu_torch.models.detection.detector import DetectorModel, init_detector
    from layoutdit_tpu_torch.models.weights_io import tree_leaves
    from layoutdit_tpu_torch.tools.repeat_step import compare_runs

    t_phase = time.perf_counter()
    for k in kernels:
        k["moe_launches"] = 0
    out = {"card": card}
    _, cfg = _family_cfg(MOE_CONFIG, FAMILY_SERVING_BATCH)
    _, dense_cfg = _family_cfg(CONFIG, FAMILY_SERVING_BATCH)
    vit = cfg.backbone.vit
    moe_layers = [i for i in range(1, vit.num_hidden_layers + 1) if vit.is_moe_layer(i)]
    if (vit.num_experts, vit.moe_top_k, len(moe_layers)) != (8, 1, 6):
        raise RuntimeError(f"moe: configs/moe.json is not 8 experts, top-1, 6 layers: {vit}")
    models = {name: DetectorModel(init_detector(c, torch.Generator(device="cuda").manual_seed(0),
                                                device="cuda"), c)
              for name, c in (("moe", cfg), ("dense", dense_cfg))}
    for name, m in models.items():
        n = sum(t.numel() for t in tree_leaves(m.params))
        print(f"  {name}: dit-base Faster R-CNN, {n:,} parameters"
              + (f", MoE layers {moe_layers}, {vit.num_experts} experts, top-"
                 f"{vit.moe_top_k}, capacity factor {vit.moe_capacity_factor}"
                 if name == "moe" else ""))
    out["serving"] = {}
    requests = _deploy_requests()
    for name, m in models.items():
        out["serving"][name], engines = _bucket_serving(name, m, kernels, "moe",
                                                        roi=FAMILY_ROI[name], thresh_zero=False)
        if name == "moe":
            out["serving_dropped_share"] = {}
            for size, pages in ((224, requests[0][1][:FAMILY_SERVING_BATCH]),
                                (1024, requests[1][1])):
                _reset_counts()
                with _DropCounter() as drops:
                    engines[size].predict_pages(pages)
                _add_moe_launches(kernels)
                out["serving_dropped_share"][size] = drops.shares
                print(f"  moe {size} px request: tokens dropped at capacity a layer "
                      f"{[round(x, 4) for x in drops.shares]}")
            _reset_counts()
            out["serving_trace_1024"] = _moe_trace(
                "1024 px request (4 pages)", lambda: engines[1024].predict_pages(requests[1][1]))
            _add_moe_launches(kernels)
        del engines
    for size in (224, 1024):
        ms = {n: out["serving"][n]["profile"][size]["stages"]["backbone"]["device_ms"]
              for n in models}
        print(f"  {size} px bucket: backbone device {ms['moe']:.3f} ms MoE against "
              f"{ms['dense']:.3f} ms dense ({ms['moe'] / ms['dense']:.3f}x)")
    def after_moe(trainer, batch) -> dict:
        """Two gradients of one state (the same bits), the tokens dropped
        in them, and a traced step, on the trained state's batch."""
        _reset_counts()
        with _DropCounter() as drops:
            rep = compare_runs(trainer.model.params, batch, trainer.cfg, runs=2, seed=0)
        _add_moe_launches(kernels)
        if rep["differing_leaves"] or not rep["losses_equal"]:
            raise RuntimeError(f"moe: two gradients of one state differ: {rep['backward_order']}")
        print(f"  moe: two gradients of one state the same bits over {rep['leaves']} leaves; "
              f"losses {rep['losses'][0]}")
        shares = drops.shares[:len(moe_layers)]
        _reset_counts()
        trace = _moe_trace("224 px train step (batch 16)", lambda: trainer.train_step(batch))
        _add_moe_launches(kernels)
        return {"repeat": {"leaves": rep["leaves"], "differing_leaves": 0,
                           "losses": rep["losses"][0]},
                "dropped_share": {"median": float(np.median(shares)),
                                  "max": float(np.max(shares)), "layers": shares},
                "trace": trace, "params": trainer.model.params}

    out["train"] = {}
    for name, path in (("moe", MOE_CONFIG), ("dense", CONFIG)):
        out["train"][name], trainer = _family_train(
            name, path, models[name], kernels, path_key="moe", model_overrides=AT_224,
            after=after_moe if name == "moe" else None)
        del trainer
    params = out["train"]["moe"].pop("params")
    t_moe, t_dense = out["train"]["moe"], out["train"]["dense"]
    print(f"  224 px step at batch {FAMILY_BATCH}: MoE median {t_moe['step_median']:.3f} ms, "
          f"{t_moe['images_per_s']:.2f} images/s, peak {t_moe['peak_gib']:.3f} GiB; dense "
          f"{t_dense['step_median']:.3f} ms, {t_dense['images_per_s']:.2f} images/s, peak "
          f"{t_dense['peak_gib']:.3f} GiB; tokens dropped at capacity a layer: median "
          f"{t_moe['dropped_share']['median']:.4f}, max {t_moe['dropped_share']['max']:.4f}")
    _, cfg224 = _family_cfg(MOE_CONFIG, FAMILY_SERVING_BATCH, AT_224)
    out["export"] = _one_stage_export("moe", DetectorModel(params, cfg224), kernels,
                                      path_key="moe", thresh_zero=False)
    out["score_dtype"] = _score_dtype_error(kernels)
    for k in kernels:
        if k["name"] not in ("short_attention", "short_attention_bwd", "flash_attention",
                             "roi_align", "roi_align_bwd") and k["moe_launches"]:
            raise RuntimeError(f"moe: {k['name']} launched {k['moe_launches']} times")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  moe phase: {out['phase_s']:.1f} s")
    return out



# phase parallel: data parallelism (layoutdit_tpu_torch/parallel) at the
# default config (dit-base, 224 px, batch 16, bf16) over PARALLEL_PAGES
# pages: main under a one-card NCCL group against main alone, two ranks
# sharing the card over gloo (NCCL refuses two ranks on one GPU) for the
# DP and FSDP steps and the DP eval, and two serving replicas on the card
PARALLEL_PAGES = 32
PARALLEL_TIMEOUT_S = 300
# each gradient leaf of the two ranks' DP and FSDP steps against the
# one-process step from the same state: bf16 on the card, each rank's
# GEMMs at 8 rows where one process runs 16, so cuBLAS may pick other
# kernels and round otherwise: max |got - ref| <= max |ref| / 64
PARALLEL_GRAD_TOL = 1.0 / 64
# timed steps of the plain and the one-card NCCL trainer, in turns
PARALLEL_TIMED_STEPS = 3


def _parallel_fixture(tmp: str, **mesh) -> str:
    """A config file over ``tmp``'s pages (``write_fixture_config`` at the
    default model, batch 16, one epoch, local mode), its artifacts under
    ``tmp/<name>`` named by ``mesh``'s fields; -> its path."""
    from layoutdit_tpu_torch.tools.make_fixture import write_fixture_config

    with open(write_fixture_config(tmp, split="samples", epochs=1, batch_size=16)) as f:
        raw = json.load(f)
    name = "_".join(sorted(mesh)) or "plain"
    raw["eval_config"]["eval_base_path"] = f"{tmp}/{name}"
    raw["train_config"]["checkpoint_interval"] = 1
    if mesh:
        raw["mesh_config"] = mesh
    path = f"{tmp}/{name}.json"
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _step_grads(trainer, batch) -> tuple[float, list, float]:
    """One update on ``batch`` -> (its loss over the ranks, the gradients
    the optimizer met (this rank's shards under FSDP), peak GiB)."""
    seen = {}
    update = trainer.optimizer.update

    def spy(state, params, grads, **kw):
        seen["grads"] = [g.clone() for g in grads]
        return update(state, params, grads, **kw)

    trainer.optimizer.update = spy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.optimizer.update = update
    mesh = trainer.mesh
    if mesh.comm is not None and mesh.degree > 1:
        loss = mesh.comm.all_reduce_(loss.detach().clone()) / mesh.degree
    return float(loss), seen["grads"], peak


def parallel_child(rank: str, port: str, cfg_path: str, out_path: str) -> int:
    """Phase ``parallel``'s rank ``rank`` of two on the one card, over
    gloo: the DP step, the FSDP step (each from the seed's weights on the
    first global batch; rank 0 writes the gathered gradients), the DP
    eval of the seed's weights; results and launches to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from layoutdit_tpu_torch.config import MeshConfig, load_run_config
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.parallel.mesh import maybe_distributed_init
    from layoutdit_tpu_torch.train.trainer import Trainer

    rank = int(rank)
    if not maybe_distributed_init(MeshConfig(
            enable_distributed_init=True, coordinator_address=f"127.0.0.1:{port}",
            num_processes=2, process_id=rank), device="cuda:0", backend="gloo"):
        raise RuntimeError("parallel child: no process group started")
    rc = load_run_config(cfg_path)
    out = {}
    _reset_counts()
    for kind in ("dp", "fsdp"):
        run = dataclasses.replace(rc, mesh=dataclasses.replace(rc.mesh, fsdp=kind == "fsdp"))
        trainer = Trainer(run, build_model(run, seed=run.train.seed, device="cuda"))
        if trainer.mesh.degree != 2 or trainer.mesh.fsdp != (kind == "fsdp"):
            raise RuntimeError(f"parallel child: mesh {trainer.mesh}")
        with trainer.sharded():
            rest = trainer._rest or trainer._leaves
            state = [*rest, *trainer.opt_state["mu"], *trainer.opt_state["nu"]]
            out[f"{kind}_rest_gib"] = sum(t.numel() * t.element_size() for t in state) / 2**30
            batch = next(iter(trainer.dataloader))
            loss, grads, peak = _step_grads(trainer, batch)
            if kind == "fsdp":
                grads = trainer._train_layout.gather(grads)
            times, _ = _timed_steps(trainer, batch, 3)
        trainer.dataloader.close()
        out.update({f"{kind}_loss": loss, f"{kind}_peak_gib": peak,
                    f"{kind}_step_ms": float(np.median(times))})
        if rank == 0:
            torch.save([g.float().cpu() for g in grads], f"{out_path}.{kind}.pt")
        del trainer, grads, batch
        gc.collect()
        torch.cuda.empty_cache()
    metrics = Evaluator(build_model(rc, seed=rc.train.seed, device="cuda"), rc).score()
    out.update(metrics=metrics, launches=_counts())
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _run_main(cfg_path: str, logs: list | None = None) -> None:
    """The port's ``main`` in this process on ``cfg_path``; with ``logs``,
    the root logger's messages appended to it."""
    import logging
    import os

    from layoutdit_tpu_torch import main as port_main

    class Keep(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    log_root = logging.getLogger("layoutdit_tpu_torch")
    handler = Keep() if logs is not None else None
    saved = os.environ.get("LAYOUTDIT_CONFIG")
    os.environ["LAYOUTDIT_CONFIG"] = cfg_path
    if handler is not None:
        log_root.addHandler(handler)
    try:
        port_main.main([])
        torch.cuda.synchronize()
    finally:
        if handler is not None:
            log_root.removeHandler(handler)
        if saved is None:
            os.environ.pop("LAYOUTDIT_CONFIG")
        else:
            os.environ["LAYOUTDIT_CONFIG"] = saved


def _main_run_state(cfg_path: str) -> tuple[list, list, list]:
    """(epoch_1.pt's parameters and moments, metrics.jsonl, predictions.json)."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.weights_io import tree_leaves
    from layoutdit_tpu_torch.train.checkpoint import load_checkpoint

    run = Path(load_run_config(cfg_path).artifact_dir)
    state = load_checkpoint(run / "model_checkpoints" / "epoch_1.pt", map_location="cpu")
    with open(run / "metrics" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    with open(run / "predictions.json") as f:
        preds = json.load(f)
    tx = state["opt_state"]
    return [*tree_leaves(state["params"]), *tx["mu"], *tx["nu"]], records, preds


def _leaf_errors(label: str, got: list, want: list) -> float:
    """The worst leaf's max |got - want| / max |want|, raising above
    ``PARALLEL_GRAD_TOL``."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        ref = float(w.abs().max())
        err = float((g.float() - w.float()).abs().max())
        if err > PARALLEL_GRAD_TOL * ref:
            raise RuntimeError(f"parallel: {label} gradient leaf {i} {tuple(w.shape)}: max err "
                               f"{err:.3e} > max |ref| {ref:.3e} / 64")
        worst = max(worst, err / max(ref, 1e-30))
    return worst


def phase_parallel(kernels: list[dict], card: str) -> dict:
    """Data parallelism through the port's entry points, dit-base at 224 px:

      * ``main`` (one epoch of 2 steps, a checkpoint, the final eval) under
        a one-card NCCL group started by ``enable_distributed_init`` and
        the coordinator fields, against ``main`` with no group: the same
        bits (parameters, moments, loss, predictions); then
        ``PARALLEL_TIMED_STEPS`` steps of each trainer in turns;
      * two ranks sharing the card over gloo (``--parallel-child``), global
        batch 16: the DP and FSDP steps' gradients against one process's
        step from the same state (``PARALLEL_GRAD_TOL``), both peaks and
        the state each rank keeps at rest; the DP eval's metrics equal to
        one process's at the ranks' per-call batch of 8;
      * two serving replicas on the card (``BatchInferenceEngine(devices=
        ...)``, batch 8 split 4 + 4) against one engine at batch 4.

    The launches of the NCCL ``main``, the two ranks and the replicas are
    the phase's."""
    import os

    import torch.distributed as dist

    from layoutdit_tpu_torch.config import MeshConfig, load_run_config
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.parallel.mesh import DataMesh, free_port, maybe_distributed_init
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture
    from layoutdit_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    launched = dict.fromkeys(_counts(), 0)

    def add(counts):
        for name, n in counts.items():
            launched[name] += n

    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        make_fixture(tmp, n_images=PARALLEL_PAGES, split="samples", seed=0)
        plain_cfg = _parallel_fixture(tmp)
        port = free_port()
        nccl_mesh = dict(enable_distributed_init=True, coordinator_address=f"127.0.0.1:{port}",
                         num_processes=1, process_id=0)
        nccl_cfg = _parallel_fixture(tmp, **nccl_mesh)
        rc = load_run_config(plain_cfg)

        # main alone, then under a one-card NCCL group: the same bits
        t0 = time.perf_counter()
        _run_main(plain_cfg)
        plain_s = time.perf_counter() - t0
        logs = []
        _reset_counts()
        t0 = time.perf_counter()
        _run_main(nccl_cfg, logs)
        nccl_s = time.perf_counter() - t0
        add(_counts())
        if not any(m.startswith("torch.distributed up: rank 0 of 1, backend nccl") for m in logs):
            raise RuntimeError("parallel: main started no NCCL group")
        if dist.is_initialized():
            raise RuntimeError("parallel: main left its process group up")
        a, b = _main_run_state(plain_cfg), _main_run_state(nccl_cfg)
        same = (all(torch.equal(x, y) for x, y in zip(a[0], b[0], strict=True))
                and a[1][0]["loss"] == b[1][0]["loss"] and a[2] == b[2])
        if not same:
            raise RuntimeError("parallel: main under a one-card NCCL group differs from main")
        print(f"  main (2 steps, checkpoint, eval of {PARALLEL_PAGES} pages) alone "
              f"{plain_s:.3f} s, under a one-card NCCL group {nccl_s:.3f} s: the same bits "
              "(parameters, moments, "
              f"loss {a[1][0]['loss']:.6f}, {len(a[2])} predictions)")

        # the plain and the world-1 NCCL step, timed in turns
        if not maybe_distributed_init(MeshConfig(**nccl_mesh), device="cuda"):
            raise RuntimeError("parallel: no NCCL group started")
        try:
            trainers = {
                "plain": Trainer(rc, build_model(rc, seed=rc.train.seed, device="cuda"),
                                 mesh=DataMesh()),
                "nccl": Trainer(rc, build_model(rc, seed=rc.train.seed, device="cuda")),
            }
            if trainers["nccl"].mesh.comm is None:
                raise RuntimeError("parallel: the NCCL trainer has no group")
            batch = next(iter(trainers["plain"].dataloader))
            times = {"plain": [], "nccl": []}
            for kind in ("plain", "nccl", "nccl", "plain"):
                times[kind] += _timed_steps(trainers[kind], batch, PARALLEL_TIMED_STEPS)[0][1:]
            for t in trainers.values():
                t.dataloader.close()
            del trainers, batch
        finally:
            dist.destroy_process_group()
        step = {k: _spread(v) for k, v in times.items()}
        print(f"  step ms at batch 16, in turns: plain {step['plain']}, one-card NCCL group "
              f"{step['nccl']}")

        # the one-process reference: the step and the eval at batch 8
        ref_trainer = Trainer(rc, build_model(rc, seed=rc.train.seed, device="cuda"))
        ref_loss, ref_grads, ref_peak = _step_grads(ref_trainer,
                                                    next(iter(ref_trainer.dataloader)))
        ref_grads = [g.float().cpu() for g in ref_grads]
        ref_trainer.dataloader.close()
        del ref_trainer
        gc.collect()
        torch.cuda.empty_cache()
        rc8 = dataclasses.replace(rc, data=dataclasses.replace(rc.data, batch_size=8))
        ref_metrics = Evaluator(build_model(rc, seed=rc.train.seed, device="cuda"), rc8).score()

        # two ranks on the card over gloo
        port = free_port()
        procs = []
        try:
            for rank in range(2):
                log = open(Path(tmp) / f"rank{rank}.log", "w")
                procs.append((subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-child", str(rank),
                     str(port), plain_cfg, f"{tmp}/rank{rank}.json"],
                    stdout=log, stderr=subprocess.STDOUT), log))
            for rank, (proc, log) in enumerate(procs):
                code = proc.wait(timeout=PARALLEL_TIMEOUT_S)
                log.close()
                if code != 0:
                    text = (Path(tmp) / f"rank{rank}.log").read_text()
                    raise RuntimeError(f"parallel rank {rank}: exit code {code}\n{text[-3000:]}")
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        ranks = []
        for rank in range(2):
            with open(f"{tmp}/rank{rank}.json") as f:
                ranks.append(json.load(f))
            add(ranks[-1]["launches"])
        staged = [line for line in (Path(tmp) / "rank0.log").read_text().splitlines()
                  if "staged through host memory" in line]
        print(f"  two ranks on the card over gloo: {staged[0].split(' - ')[-1] if staged else ''}")
        errs = {}
        for kind in ("dp", "fsdp"):
            grads = torch.load(f"{tmp}/rank0.json.{kind}.pt")
            errs[kind] = _leaf_errors(kind, grads, ref_grads)
            loss = ranks[0][f"{kind}_loss"]
            if not abs(loss - ref_loss) <= 1e-2 * abs(ref_loss):
                raise RuntimeError(f"parallel: {kind} loss {loss} against one process's {ref_loss}")
            print(f"  {kind.upper()} step (2 ranks x 8): loss {loss:.6f} (one process "
                  f"{ref_loss:.6f}), worst gradient leaf max err / max |ref| {errs[kind]:.3e}; "
                  f"peak {ranks[0][f'{kind}_peak_gib']:.3f} / {ranks[1][f'{kind}_peak_gib']:.3f} "
                  f"GiB (ranks 0 / 1; one process {ref_peak:.3f}), at rest "
                  f"{ranks[0][f'{kind}_rest_gib']:.3f} GiB a rank, step "
                  f"{ranks[0][f'{kind}_step_ms']:.3f} ms (gloo through the host; no speed number)")
        for r in ranks:
            if r["metrics"] != ref_metrics:
                raise RuntimeError(f"parallel: DP eval metrics {r['metrics']} against one "
                                   f"process's {ref_metrics}")
        print(f"  DP eval ({PARALLEL_PAGES} pages, 2 ranks x 8): mAP {ref_metrics['mAP']:.6f}, "
              "every metric equal to one process's at batch 8 on both ranks")

        # two serving replicas on the card
        model = build_model(rc, seed=rc.train.seed, device="cuda")
        pages = [p.read_bytes() for p in sorted(Path(tmp, "samples").glob("*.jpg"))][:16]
        one = BatchInferenceEngine(model, image_sizes=(224,), batch_size=4, score_thresh=0.0)
        two = BatchInferenceEngine(model, image_sizes=(224,), batch_size=8, score_thresh=0.0,
                                   devices=["cuda:0", "cuda:0"])
        want = one.predict_pages(pages)
        _reset_counts()
        got = two.predict_pages(pages)
        torch.cuda.synchronize()
        add(_counts())
        box_err = score_err = 0.0
        for g, w in zip(got, want, strict=True):
            if not np.array_equal(g.labels, w.labels):
                raise RuntimeError("parallel: the replicas' labels differ from one engine's")
            box_err = max(box_err, float(np.abs(g.boxes - w.boxes).max(initial=0.0)))
            score_err = max(score_err, float(np.abs(g.scores - w.scores).max(initial=0.0)))
        if box_err > 1e-2 or score_err > 1e-3:
            raise RuntimeError(f"parallel: replicas' boxes {box_err} px, scores {score_err}")
        print(f"  two serving replicas on the card (batch 8 = 4 + 4): {len(pages)} pages, labels "
              f"equal to one engine's at batch 4, boxes {box_err:.2e} px, scores {score_err:.2e}")
    print(f"  parallel launches: {launched}")
    for name, n in launched.items():
        if (n > 0) != (name in MAIN_KERNELS):
            raise RuntimeError(f"parallel: {name} launched {n} times")
    for k in kernels:
        k["parallel_launches"] = launched[k["name"]]
    out.update(
        main_s={"plain": plain_s, "nccl_world_1": nccl_s}, step_ms=step,
        grad_err=errs, ref_loss=ref_loss, ref_peak_gib=ref_peak,
        ranks=[{k: v for k, v in r.items() if k not in ("metrics", "launches")} for r in ranks],
        eval_map=ref_metrics["mAP"], serving={"box_err": box_err, "score_err": score_err},
        phase_s=time.perf_counter() - t_phase)
    print(f"  parallel phase: {out['phase_s']:.1f} s")
    return out


# phase model_parallel: configs/train_tp_sp.json (dit-large, 1024 px,
# global attention, N = 4097, model_parallel 2 with sequence parallelism)
# over MP_PAGES make_fixture pages at batch MP_BATCH, on two gloo ranks
# that share the card (--model-parallel-child); the one-process steps of
# the same state are the reference, every gradient leaf within
# PARALLEL_GRAD_TOL of max |ref|; the checked step is the one timed, the
# first of its trainer (host-staged collectives: a record, not a speed)
MP_CONFIG = ROOT / "configs" / "train_tp_sp.json"
MP_BATCH = 2
MP_PAGES = 4
MP_TIMEOUT_S = 600
# serving: the 224 and 1024 px buckets of configs/serving_1024.json, the
# dit-large model, MP_SERVE_PAGES pages a bucket at batch MP_BATCH
MP_SERVE_PAGES = 2
# the rows 3-5 key-count cases: ring attention's block at dit-large 1024
# px over two ranks (4098 padded tokens, 2049 a rank, rank 1's block 2048
# valid keys), a smaller count, and the unmasked dit-large shape
NKEYS_BLOCK = (2, 2049, 8)
NKEYS_COUNTS = (2048, 1024)
NKEYS_FULL = (4, 4097, 16)


# the steps the phase holds: (config, image size, detector); the TP ranks
# run "tp" + name, one process "one" + name, the float32 control "f32" +
# name. Faster R-CNN (train_tp_sp as it is) is the main path, RetinaNet at
# 224 px runs rows 1-2 under TP. The ranks' partial sums are float32,
# rounded once after the group's sum, as one process's GEMM rounds its
# accumulator once (parallel/tensor.py). Against one process's bf16 step
# the gradients still miss max |ref| / 64 (PARALLEL_GRAD_TOL, reported):
# bf16 through 24 layers puts each side's leaves a few % from float32,
# each another way. So each leaf is held against the float32 control, as
# close as one process's (MP_CONTROL_K), and every loss to one process's
# (MP_LOSS_RTOL). Faster R-CNN's RoI losses pick proposals by near-tied
# scores of a random model, which the last bits reorder: the ranks' and
# the control's checked steps take one process's proposals
# (_FixedProposals); the RPN's own are held through its losses and leaves.
MP_STEPS = (("", 1024, "faster_rcnn"), ("224", 224, "retinanet"))
MP_LOSS_RTOL = 1e-2
# the control: one process in float32 on the card (_float32_plain). Each
# leaf's relative Frobenius distance from it, the ranks' within
# MP_CONTROL_K times one process's bf16 distance + MP_CONTROL_FLOOR (a
# quarter of a bf16 ulp): a missing or doubled model-group sum moves a
# leaf by 50-100%, bf16 by a few %
MP_CONTROL_K = 2.0
MP_CONTROL_FLOOR = 1e-3


def _mp_configs(tmp: str) -> dict:
    """The config files of the phase over ``tmp``'s pages: ``tp`` (the
    train_tp_sp mesh and model, batch MP_BATCH, one epoch), ``one`` (the
    same on one process), ``f32`` (one process in float32 with remat, the
    control), and the ``MP_STEPS`` variants."""
    from layoutdit_tpu_torch.tools.make_fixture import write_fixture_config

    with open(write_fixture_config(tmp, split="samples", epochs=1, batch_size=MP_BATCH)) as f:
        raw = json.load(f)
    with open(MP_CONFIG) as f:
        tp = json.load(f)
    with open(CONFIG) as f:
        budget = json.load(f)["detection_model_config"]["detection_budget"]
    raw["detection_model_config"] = {**tp["detection_model_config"],
                                     "detection_budget": budget}
    raw["train_config"]["checkpoint_interval"] = 1
    paths = {}
    for (key, size, detector), (prefix, mesh) in ((s, m) for s in MP_STEPS for m in (
            ("tp", tp["mesh_config"]), ("one", {}), ("f32", {}))):
        name = prefix + key
        cfg = json.loads(json.dumps(raw))
        cfg["run_name"] = name
        cfg["detection_model_config"].update(image_size=size, detector=detector)
        if mesh:
            cfg["mesh_config"] = mesh
        if prefix == "f32":
            cfg["precision"] = {"compute_dtype": "float32"}
            cfg["detection_model_config"]["remat"] = True
        paths[name] = f"{tmp}/{name}.json"
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    return paths


def _mp_pixels(seed: int = 11):
    """The ring check's pages [2, 3, 1024, 1024] (normalized) and the
    cotangents of dit-large's four taps, from a seeded CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    pixels = torch.rand((MP_BATCH, 3, 1024, 1024), generator=gen) * 2 - 1
    cots = [torch.randn((MP_BATCH, 4097, 1024), generator=gen) for _ in range(4)]
    return pixels.cuda(), [c.cuda() for c in cots]


def _encoder_taps_grads(vit_params: dict, cfg, tp=None, impl="auto",
                        dtype: torch.dtype = torch.bfloat16):
    """dit-large's taps on ``_mp_pixels`` (in ``dtype``; float32 with
    remat, under ``_float32_plain``) and the gradients of sum tap x
    cotangent w.r.t. every encoder leaf, in the one-card layout (``tp``:
    the leaves are this rank's shards, gathered back)."""
    from layoutdit_tpu_torch.models.vit import vit_forward
    from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map, tree_paths
    from layoutdit_tpu_torch.parallel.sharding import TpLayout

    # fresh leaves: a replicated leaf's shard is the leaf itself, whose
    # gradient would otherwise add up over calls
    tree = tree_map(lambda t: t.detach().clone(), {"backbone": {"vit": vit_params}})
    layout = None
    if tp is not None:
        layout = TpLayout(tree_paths(tree), tp)
        it = iter(layout.shard(tree_leaves(tree)))
        tree = tree_map(lambda _: next(it), tree)
    leaves = tree_leaves(tree)
    for t in leaves:
        t.requires_grad_(True)
    pixels, cots = _mp_pixels()
    taps = vit_forward(tree["backbone"]["vit"], pixels.to(dtype), cfg.backbone.vit,
                       taps=cfg.backbone.taps, compute_dtype=dtype, tp=tp,
                       attention_impl=impl, remat=dtype == torch.float32)
    sum((t.float() * c).sum() for t, c in zip(taps, cots)).backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    if layout is not None:
        layout.reduce_partial(grads)
        grads = layout.gather(grads)
    torch.cuda.synchronize()
    return [t.detach().float().cpu() for t in taps], [g.float().cpu() for g in grads]


def _mp_pages(tmp: str) -> list[bytes]:
    """MP_SERVE_PAGES pages a bucket: fixture JPEGs (routed to 1024) and
    the same pages shrunk to 200 px (routed to 224)."""
    import io

    from PIL import Image

    big = [p.read_bytes() for p in sorted(Path(tmp, "samples").glob("*.jpg"))][:MP_SERVE_PAGES]
    small = []
    for page in big:
        with Image.open(io.BytesIO(page)) as im:
            buf = io.BytesIO()
            im.convert("RGB").resize((150, 200)).save(buf, format="JPEG")
            small.append(buf.getvalue())
    return small + big


def _mp_engine(model, mesh=None):
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine

    return BatchInferenceEngine(model, image_sizes=DEPLOY_BUCKETS, batch_size=MP_BATCH,
                                score_thresh=0.0, mesh=mesh)


def _serve(engine, pages: list[bytes]) -> list:
    try:
        return _detections(engine.predict_pages(pages))
    finally:
        engine.close()


def _detections_err(got: list, want: list) -> tuple[float, float, int]:
    """Detections ``got`` against ``want``, page by page -> (the worst
    score, in score order, over max |want score|; the worst box against
    the nearest box of its label in ``want`` (a random model's near-tied
    boxes may swap places or lose their NMS tie), over max |want box|;
    the pages whose counts differ)."""
    score_err = box_err = 0.0
    counts = 0
    for g, w in zip(got, want, strict=True):
        if len(g["scores"]) != len(w["scores"]):
            counts += 1
        n = min(len(g["scores"]), len(w["scores"]))
        gs, ws = np.sort(g["scores"])[::-1][:n], np.sort(w["scores"])[::-1][:n]
        ref = max(float(np.abs(ws).max(initial=0.0)), 1e-30)
        score_err = max(score_err, float(np.abs(gs - ws).max(initial=0.0)) / ref)
        wb, gb = np.asarray(w["boxes"]).reshape(-1, 4), np.asarray(g["boxes"]).reshape(-1, 4)
        wl, gl = np.asarray(w["labels"]), np.asarray(g["labels"])
        scale = max(float(np.abs(wb).max(initial=0.0)), 1e-30)
        for box, label in zip(gb, gl):
            cand = wb[wl == label]
            box_err = max(box_err, float(np.abs(cand - box).max(1).min()) / scale
                          if len(cand) else 1.0)
    return score_err, box_err, counts


def _detections(results) -> list:
    return [{"boxes": r.boxes.tolist(), "scores": r.scores.tolist(), "labels": r.labels.tolist()}
            for r in results]


@contextlib.contextmanager
def _float32_plain():
    """One process's float32 control on the card: every attention and
    RoIAlign wrapper swapped for its plain version (``kernel_swap``), TF32
    off for matmuls and convolutions."""
    from layoutdit_tpu_torch.tools.kernel_swap import swapped

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with swapped("plain_attention"), swapped("plain_roi"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class _FixedProposals:
    """While installed, the detector's proposals are saved to ``path``
    (``replay=False``) or taken from it in place of its own: the TP ranks'
    checked step takes one process's. ``same`` says whether the ranks' own
    proposals were those bits."""

    def __init__(self, path: str, replay: bool):
        self.path, self.replay, self.same = path, replay, None

    def __enter__(self):
        from layoutdit_tpu_torch.models.detection import detector as det

        self.det, self.orig = det, det.filter_proposals

        def fixed(*args, **kw):
            props = self.orig(*args, **kw)
            if not self.replay:
                torch.save([t.cpu() for t in props], self.path)
                return props
            saved = [t.to(props.boxes.device) for t in torch.load(self.path)]
            self.same = all(torch.equal(a, b) for a, b in zip(props, saved, strict=True))
            return type(props)(*saved)

        det.filter_proposals = fixed
        return self

    def __exit__(self, *exc):
        self.det.filter_proposals = self.orig
        return False


def model_parallel_child(rank: str, port: str, cfg_dir: str, out_path: str) -> int:
    """Phase ``model_parallel``'s rank ``rank`` of a 1 x 2 mesh on the one
    card, over gloo: ring attention on dit-large's encoder, the TP + SP
    step at 1024 and at 224 px (rank 0 writes the gathered gradients),
    the TP checkpoint, then TP serving of both buckets (rank 0 serves,
    rank 1 follows); results and launches to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from layoutdit_tpu_torch.config import MeshConfig, load_run_config
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.models.weights_io import tree_leaves
    from layoutdit_tpu_torch.parallel.mesh import build_mesh_for_batch, maybe_distributed_init
    from layoutdit_tpu_torch.train.trainer import Trainer

    rank = int(rank)
    if not maybe_distributed_init(MeshConfig(
            enable_distributed_init=True, coordinator_address=f"127.0.0.1:{port}",
            num_processes=2, process_id=rank), device="cuda:0", backend="gloo"):
        raise RuntimeError("model_parallel child: no process group started")
    rc = load_run_config(f"{cfg_dir}/tp.json")
    out = {}
    _reset_counts()
    # ring attention over the two ranks, every encoder leaf's gradient
    model = build_model(rc, seed=rc.train.seed, device="cuda")
    mesh = build_mesh_for_batch(rc.mesh, MP_BATCH)
    if mesh.model is None or mesh.model.size != 2 or not mesh.model.sequence_parallel:
        raise RuntimeError(f"model_parallel child: mesh {mesh}")
    t0 = time.perf_counter()
    taps, grads = _encoder_taps_grads(model.params["backbone"]["vit"], model.cfg, mesh.model,
                                      "ring")
    out["ring_s"] = time.perf_counter() - t0
    if rank == 0:
        torch.save({"taps": taps, "grads": grads}, f"{out_path}.ring.pt")
    # the encoder under TP + SP (Megatron: 8 local heads on the gathered
    # sequence), the same pages and cotangents
    t0 = time.perf_counter()
    taps, grads = _encoder_taps_grads(model.params["backbone"]["vit"], model.cfg, mesh.model)
    out["encoder_s"] = time.perf_counter() - t0
    if rank == 0:
        torch.save({"taps": taps, "grads": grads}, f"{out_path}.encoder.pt")
    del model, taps, grads
    gc.collect()
    torch.cuda.empty_cache()
    # the TP + SP steps at 1024 and 224 px
    for key in (k for k, _, _ in MP_STEPS):
        cfg_name = "tp" + key
        key = f"{key}_" if key else ""
        run = load_run_config(f"{cfg_dir}/{cfg_name}.json")
        trainer = Trainer(run, build_model(run, seed=run.train.seed, device="cuda"))
        if trainer.tp is None:
            raise RuntimeError("model_parallel child: the trainer has no model group")
        state = [*trainer._leaves, *trainer.opt_state["mu"], *trainer.opt_state["nu"]]
        out[f"{key}rest_gib"] = sum(t.numel() * t.element_size() for t in state) / 2**30
        batch = next(iter(trainer.dataloader))
        with _FixedProposals(f"{cfg_dir}/props{key}.pt", replay=True) as fixed:
            loss, comps, grads, peak, ms = _mp_step(trainer, batch)
        out[f"{key}own_proposals_same"] = fixed.same
        grads = trainer._train_tp.gather(grads)
        out.update({f"{key}loss": loss, f"{key}losses": comps, f"{key}peak_gib": peak,
                    f"{key}step_ms": ms})
        if rank == 0:
            torch.save([g.float().cpu() for g in grads], f"{out_path}.{cfg_name}.pt")
        if not key:  # the TP checkpoint (one-card layout, rank 0 writes)
            path = trainer.save_checkpoint(1, stem="tp")
            full = trainer._opt_state_for_checkpoint()
            state = [t.detach().cpu() for t in [*tree_leaves(trainer._one_card(trainer.params)),
                                                *full["mu"], *full["nu"]]]
            if rank == 0:
                torch.save({"path": path, "state": state}, f"{out_path}.ckpt.pt")
            del full, state
        trainer.dataloader.close()
        del trainer, grads, batch
        gc.collect()
        torch.cuda.empty_cache()
    # TP serving: rank 0 runs the pipeline, rank 1 its shards' part
    model = build_model(rc, seed=rc.train.seed, device="cuda")
    engine = _mp_engine(model, mesh)
    del model
    if rank == 0:
        pages = _mp_pages(cfg_dir)
        t0 = time.perf_counter()
        results = engine.predict_pages(pages)
        out["serve_s"] = time.perf_counter() - t0
        engine.close()
        out["detections"] = _detections(results)
    else:
        engine.serve_follower()
    torch.cuda.synchronize()
    out["launches"] = _counts()
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _mp_leaves(label: str, got: list, want: list, f32: list, failed: list,
               paths: list | None = None) -> dict:
    """The ranks' leaves ``got`` against one process's ``want`` (both bf16
    on the card) and both against the float32 control ``f32``, leaf by
    leaf: max |got - want| / max |want| against the 1/64 rule
    (``PARALLEL_GRAD_TOL``), reported; and each leaf's relative Frobenius
    distance from the control, the ranks' within MP_CONTROL_K times one
    process's plus MP_CONTROL_FLOOR, held (a leaf that misses is added
    to ``failed``; ``paths`` name the leaves). -> the readings."""
    paths = paths or [str(i) for i in range(len(got))]
    worst = over = 0
    ratio, ratio_at, tp_all, one_all, ref_all = 0.0, -1, 0.0, 0.0, 0.0
    for i, (g, w, r) in enumerate(zip(got, want, f32, strict=True)):
        g, w, r = g.float(), w.float(), r.float()
        m = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst, over = max(worst, m), over + (m > PARALLEL_GRAD_TOL)
        ref = max(float(r.norm()), 1e-30)
        tp, one = float((g - r).norm()) / ref, float((w - r).norm()) / ref
        tp_all, one_all = tp_all + float((g - r).norm()) ** 2, one_all + float((w - r).norm()) ** 2
        ref_all += float(r.norm()) ** 2
        if tp / max(one, MP_CONTROL_FLOOR) > ratio:
            ratio, ratio_at = tp / max(one, MP_CONTROL_FLOOR), i
        if tp > MP_CONTROL_K * one + MP_CONTROL_FLOOR:
            failed.append(f"{label} leaf {paths[i]} {tuple(w.shape)}: {tp:.3e} from float32, "
                          f"one process {one:.3e}")
    tp_all, one_all = (tp_all / ref_all) ** 0.5, (one_all / ref_all) ** 0.5
    print(f"  {label}: against one process, worst leaf max err / max |ref| {worst:.3e}, "
          f"{over} of {len(got)} leaves over 1/64; against float32 (relative Frobenius) all "
          f"leaves {tp_all:.3e} (one process {one_all:.3e}), the worst leaf's ratio to one "
          f"process's {ratio:.3f} ({paths[ratio_at]}; held to {MP_CONTROL_K} x one process's "
          f"+ {MP_CONTROL_FLOOR})")
    return {"max_ratio": worst, "over_1_64": over, "leaves": len(got), "f32_all": tp_all,
            "one_f32_all": one_all, "worst_control_ratio": ratio,
            "worst_control_leaf": paths[ratio_at]}


def _mp_step(trainer, batch):
    """``_step_grads`` with the step's losses and time -> (loss, {name:
    loss}, gradients, peak GiB, ms: host clock around the step to a
    synchronize, its gradients' copy included)."""
    seen = {}
    update = trainer.optimizer.update

    def spy(state, params, grads, **kw):
        seen["grads"] = [g.clone() for g in grads]
        return update(state, params, grads, **kw)

    trainer.optimizer.update = spy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, losses = trainer.train_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.optimizer.update = update
    return float(loss), {k: float(v) for k, v in losses.items()}, seen["grads"], peak, ms


def _mp_worst(label, got, want, paths, k=5) -> None:
    """Print the ``k`` leaves farthest from ``want`` (max err / max |ref|,
    relative Frobenius beside)."""
    rows = []
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g, w = g.float(), w.float()
        fro = float((g - w).norm() / max(float(w.norm()), 1e-30))
        mx = float((g - w).abs().max() / max(float(w.abs().max()), 1e-30))
        rows.append((mx, fro, i))
    for mx, fro, i in sorted(rows, reverse=True)[:k]:
        print(f"  {label} leaf {paths[i]} {tuple(want[i].shape)}: max err / max |ref| "
              f"{mx:.3e}, relative Frobenius {fro:.3e}, max |ref| "
              f"{float(want[i].abs().max()):.3e}")


def _nkeys_case(gen, b: int, n: int, h: int, nk: int, d: int = 64) -> dict:
    """Rows 3-5 with a valid-key count ``nk`` at [B, N, H, D]: each against
    its plain version (masked keys' dk and dv exactly 0), timed beside
    SDPA with the equivalent boolean attn_mask (forward, and its backward
    for the pair); the bounds count the valid keys' work."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import short_attention as sa

    scale = 1.0 / math.sqrt(d)
    q, k, v = _qkv(gen, b, n, h, d)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    label = f"flash n_keys={nk} B={b} N={n} H={h}"
    o, lse = fa.flash_attention_fwd(q, k, v, None, scale, nk)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, None, scale, nk)
    err, tol = _check_close(label, o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= 1e-2:
        raise RuntimeError(f"{label}: lse {lse_err} from its plain version")
    dqkv = torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="cuda")
    dq, dk, dv = sa.split_qkv(dqkv, h)
    fa.flash_attention_bwd(q, k, v, o, lse, do, None, scale, out=(dq, dk, dv), n_keys=nk)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, None, scale, nk)
    errs = {name: _check_close(f"{label} {name}", g, w)
            for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    if bool(dk[:, nk:].any()) or bool(dv[:, nk:].any()):
        raise RuntimeError(f"{label}: masked keys with a nonzero dk or dv")
    del want, o_ref, lse_ref
    delta = torch.empty(b * h, n, dtype=torch.float32, device="cuda")
    row, kv_row, vec = b * n * h * d * 2, b * nk * h * d * 2, b * h * n * 4
    flops = 2 * b * h * n * nk * d
    bounds = {"fwd": _bound_ms(2 * row + 2 * kv_row + vec, 2 * flops),
              "dq": _bound_ms(4 * row + 2 * kv_row + 2 * vec, 3 * flops),
              "dkdv": _bound_ms(4 * row + 2 * kv_row + 2 * vec, 4 * flops)}
    ms = {"fwd": _time_ms(lambda: fa.flash_attention_fwd(q, k, v, None, scale, nk),
                          FLASH_FWD_ITERS),
          "dq": _time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, None, scale, dq,
                                                           delta, nk), FLASH_BWD_ITERS),
          "dkdv": _time_ms(lambda: fa.flash_attention_bwd_dkdv(q, k, v, lse, do, delta, None,
                                                               scale, dk, dv, nk),
                           FLASH_BWD_ITERS)}
    plain = {"fwd": _time_ms(lambda: fa.flash_attention_plain(q, k, v, None, scale, nk), 2),
             "bwd": _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, None,
                                                                  scale, nk), 2)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(n, device="cuda") < nk).expand(n, n)[None, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    library_fwd = _time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), FLASH_FWD_ITERS)
    ot = sdpa(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)
    library_bwd = _time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                           FLASH_BWD_ITERS)
    for part in ("fwd", "dq", "dkdv"):
        _print_share(f"{label} {part}", ms[part], *bounds[part])
    out = {"shape": f"B={b} N={n} H={h} D={d} bf16, n_keys={nk}",
           "max_abs_err": {"o": err, "dq": errs["dq"][0], "dkdv": max(errs["dk"][0],
                                                                      errs["dv"][0])},
           "tolerance": tol, "lse_max_abs_err": lse_err,
           "plain_ms": plain, "library_fwd_ms": library_fwd, "library_bwd_ms": library_bwd}
    for part in ("fwd", "dq", "dkdv"):
        out.update({f"{part}_ms": ms[part], f"{part}_bound_ms": bounds[part][0],
                    f"{part}_bound_by": bounds[part][1]})
    del qt, kt, vt, ot
    torch.cuda.empty_cache()
    return out


def _nkeys_full(gen) -> dict:
    """At dit-large's 1024 px shape, ``n_keys == N`` against the kernels
    called without it: the same bits (o, lse, dq, dk, dv), both timed."""
    from layoutdit_tpu_torch.ops import flash_attention as fa

    b, n, h = NKEYS_FULL
    scale = 1.0 / 8.0
    q, k, v = _qkv(gen, b, n, h, 64)
    do = torch.randn(b, n, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, None, scale)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, None, scale, n)
    g1 = fa.flash_attention_bwd(q, k, v, o, lse, do, None, scale)
    g2 = fa.flash_attention_bwd(q, k, v, o, lse, do, None, scale, n_keys=n)
    same = (torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(a, c) for a, c in zip(g1[:3], g2[:3])))
    if not same:
        raise RuntimeError("flash n_keys == N: not the bits of the call without it")
    delta = torch.empty(b * h, n, dtype=torch.float32, device="cuda")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    times = {}
    for key, nk in (("without", -1), ("with", n)):
        times[key] = {
            "fwd": _time_ms(lambda nk=nk: fa._fwd_cuda(q, k, v, None, scale, nk),
                            FLASH_FWD_ITERS),
            "dq": _time_ms(lambda nk=nk: fa.flash_attention_bwd_dq(
                q, k, v, o, lse, do, None, scale, dq, delta, nk), FLASH_BWD_ITERS),
            "dkdv": _time_ms(lambda nk=nk: fa.flash_attention_bwd_dkdv(
                q, k, v, lse, do, delta, None, scale, dk, dv, nk), FLASH_BWD_ITERS)}
    print(f"  flash n_keys == N at B={b} N={n} H={h}: the same bits as without it; ms "
          f"{times}")
    del q, k, v, o, lse, o2, lse2, g1, g2
    torch.cuda.empty_cache()
    return {"shape": f"B={b} N={n} H={h} D=64 bf16", "same_bits": True, "ms": times}


def phase_model_parallel(kernels: list[dict], card: str, gen) -> dict:
    """Tensor, sequence and expert parallelism and ring attention through
    the port's entry points, ``configs/train_tp_sp.json`` at full width
    (dit-large, 24 layers, 1024 px, N = 4097, 8 local heads a rank):

      * rows 3-5 with a valid-key count, alone: ring attention's block
        (B=2 N=2049 H=8 at 2048 valid keys) and a smaller count against
        their plain versions, timed beside SDPA with the boolean mask;
        ``n_keys == N`` at B=4 N=4097 H=16 the bits of the call without it;
      * two gloo ranks sharing the card (``--model-parallel-child``):
        dit-large's encoder with ``attention_impl="ring"`` forward and
        backward against one process's flash path; the TP + SP
        ``Trainer`` step at 1024 and at 224 px against one process's from
        the same state (the 1024 px Faster R-CNN step on one process's
        proposals), step ms and each rank's peak GiB beside one
        process's; the TP checkpoint restored in one process to the same
        bits; TP serving of the 224 and 1024 px buckets against one
        engine (the same detection counts). Taps, every gradient leaf,
        scores and boxes: against one process's, max |ref| / 64
        reported; against one process in float32 with the plain versions
        (the control, ``_float32_plain``), held as close as one
        process's bf16 (``MP_CONTROL_K``); every loss to one process's.

    Every comparison runs and prints before the phase raises on those
    that missed.

    The launches of the two ranks are the phase's; the comparisons'
    (the key-count cases, the one-process references) are not."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_paths
    from layoutdit_tpu_torch.parallel.mesh import DataMesh, free_port
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture
    from layoutdit_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    out = {"card": card}
    b, n, h = NKEYS_BLOCK
    nkeys = {nk: _nkeys_case(gen, b, n, h, nk) for nk in NKEYS_COUNTS}
    full = _nkeys_full(gen)
    for name, part in (("flash_attention", "fwd"), ("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkdv", "dkdv")):
        e = _entry(kernels, name) if kernels else {}
        for nk, r in nkeys.items():
            e.update({f"nkeys{nk}_shape": r["shape"], f"nkeys{nk}_ms": r[f"{part}_ms"],
                      f"nkeys{nk}_bound_ms": r[f"{part}_bound_ms"],
                      f"nkeys{nk}_bound_by": r[f"{part}_bound_by"],
                      f"nkeys{nk}_max_abs_err": r["max_abs_err"]["o" if part == "fwd" else part],
                      f"nkeys{nk}_plain_ms": r["plain_ms"]["fwd" if part == "fwd" else "bwd"],
                      f"nkeys{nk}_library_ms": r["library_fwd_ms" if part == "fwd"
                                                 else "library_bwd_ms"]})
        e.update({"nkeys_full_same_bits": True, "nkeys_full_ms": full["ms"]["with"][part],
                  "nkeys_full_without_ms": full["ms"]["without"][part]})
    out["nkeys"] = {str(k): v for k, v in nkeys.items()}
    out["nkeys_full"] = full

    with tempfile.TemporaryDirectory() as tmp:
        make_fixture(tmp, n_images=MP_PAGES, split="samples", seed=0)
        cfgs = _mp_configs(tmp)
        refs = {}
        # one process: the MP_STEPS steps from the seed's state
        for key, _, _ in MP_STEPS:
            name = "one" + key
            rc = load_run_config(cfgs[name])
            trainer = Trainer(rc, build_model(rc, seed=rc.train.seed, device="cuda"),
                              mesh=DataMesh())
            batch = next(iter(trainer.dataloader))
            rk = f"{key}_" if key else ""
            with _FixedProposals(f"{tmp}/props{rk}.pt", replay=False):
                loss, comps, grads, peak, ms = _mp_step(trainer, batch)
            refs[name] = {"loss": loss, "losses": comps, "grads": [g.float().cpu() for g in grads],
                          "paths": [p for p, t in zip(tree_paths(trainer.params), trainer._leaves)
                                    if t.requires_grad],
                          "peak_gib": peak, "step_ms": ms}
            trainer.dataloader.close()
            del trainer, batch, grads
            gc.collect()
            torch.cuda.empty_cache()
        # the control: the same steps on one process in float32, every
        # kernel swapped for its plain version, on the same proposals
        t0 = time.perf_counter()
        with _float32_plain():
            for key, _, _ in MP_STEPS:
                rc = load_run_config(cfgs["f32" + key])
                trainer = Trainer(rc, build_model(rc, seed=rc.train.seed, device="cuda"),
                                  mesh=DataMesh())
                batch = next(iter(trainer.dataloader))
                rk = f"{key}_" if key else ""
                with _FixedProposals(f"{tmp}/props{rk}.pt", replay=True):
                    _, comps, grads, _, _ = _mp_step(trainer, batch)
                refs["one" + key].update(f32_losses=comps,
                                         f32_grads=[g.float().cpu() for g in grads])
                trainer.dataloader.close()
                del trainer, batch, grads
                gc.collect()
                torch.cuda.empty_cache()
        # one process: the encoder's flash path on the ring check's pages,
        # and its float32 control
        rc = load_run_config(cfgs["one"])
        model = build_model(rc, seed=rc.train.seed, device="cuda")
        vit = model.params["backbone"]["vit"]
        vit_paths = tree_paths({"backbone": {"vit": vit}})
        ring_taps, ring_grads = _encoder_taps_grads(vit, model.cfg)
        with _float32_plain():
            f32_taps, f32_grads = _encoder_taps_grads(vit, model.cfg, dtype=torch.float32)
        # one engine on the serving pages, and its float32 control
        pages = _mp_pages(tmp)
        want = _serve(_mp_engine(model), pages)
        del model
        with _float32_plain():
            rc = load_run_config(cfgs["f32"])
            want32 = _serve(_mp_engine(build_model(rc, seed=rc.train.seed, device="cuda")), pages)
        out["control_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

        # the two ranks
        _reset_counts()
        port = free_port()
        procs = []
        t0 = time.perf_counter()
        try:
            for rank in range(2):
                log = open(Path(tmp) / f"mp{rank}.log", "w")
                procs.append((subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--model-parallel-child",
                     str(rank), str(port), tmp, f"{tmp}/mp{rank}.json"],
                    stdout=log, stderr=subprocess.STDOUT), log))
            for rank, (proc, log) in enumerate(procs):
                code = proc.wait(timeout=MP_TIMEOUT_S)
                log.close()
                if code != 0:
                    text = (Path(tmp) / f"mp{rank}.log").read_text()
                    raise RuntimeError(f"model_parallel rank {rank}: exit code {code}\n"
                                       f"{text[-4000:]}")
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        out["ranks_s"] = time.perf_counter() - t0
        ranks = []
        launched = dict.fromkeys(_counts(), 0)
        for rank in range(2):
            with open(f"{tmp}/mp{rank}.json") as f:
                ranks.append(json.load(f))
            for name, c in ranks[-1]["launches"].items():
                launched[name] += c

        # every comparison below runs and prints before the phase raises
        # on the ones that missed
        failed = []

        # the encoder against one process's flash path and the float32
        # control (_mp_leaves): ring attention rounds each block's output
        # to bf16 before the merge, TP + SP sums float32 partials
        for kind, label in (("ring", "ring attention"), ("encoder", "TP + SP encoder")):
            res = torch.load(f"{tmp}/mp0.json.{kind}.pt")
            out[f"{kind}_taps"] = _mp_leaves(f"{label} taps", res["taps"], ring_taps, f32_taps,
                                             failed)
            out[f"{kind}_grads"] = _mp_leaves(f"{label} gradient", res["grads"], ring_grads,
                                              f32_grads, failed, vit_paths)
            print(f"  {label} (2 ranks, 4097 tokens as 2049 + 2048, dit-large) against one "
                  f"process's flash path ({ranks[0][kind + '_s']:.3f} s a rank, host-staged)")
        del res, ring_taps, ring_grads, f32_taps, f32_grads
        for key, size, detector in MP_STEPS:
            name, r = "tp" + key, refs["one" + key]
            rk = f"{key}_" if key else ""
            grads = torch.load(f"{tmp}/mp0.json.{name}.pt")
            loss, comps = ranks[0][f"{rk}loss"], ranks[0][f"{rk}losses"]
            _mp_worst(f"TP + SP {name}", grads, r["grads"], r["paths"])
            err = _mp_leaves(f"TP + SP {name} gradient ({len(grads)} leaves)", grads,
                             r["grads"], r["f32_grads"], failed, r["paths"])
            for k, v in comps.items():
                if not abs(v - r["losses"][k]) <= MP_LOSS_RTOL * abs(r["losses"][k]) + 1e-6:
                    failed.append(f"{name} {k} {v} against one process's {r['losses'][k]}")
            own = ranks[0].get(f"{rk}own_proposals_same")
            props = ("" if own is None else "the ranks' own proposals "
                     + ("the same bits as" if own else "differ from")
                     + " one process's (its taken); ")
            out[f"{name}_step"] = {
                "size": size, "detector": detector, "loss": loss, "ref_loss": r["loss"],
                "losses": comps, "ref_losses": r["losses"], "grad_err": err,
                "own_proposals_same": own,
                "step_ms": [x[f"{rk}step_ms"] for x in ranks], "ref_step_ms": r["step_ms"],
                "peak_gib": [x[f"{rk}peak_gib"] for x in ranks], "ref_peak_gib": r["peak_gib"],
                "rest_gib": [x[f"{rk}rest_gib"] for x in ranks]}
            print(f"  TP + SP step {name} ({detector}, {size} px, 1 x 2, batch {MP_BATCH}): "
                  f"losses {comps} (one process {r['losses']}); {props}peak "
                  f"{ranks[0][f'{rk}peak_gib']:.3f} / {ranks[1][f'{rk}peak_gib']:.3f} "
                  f"GiB (ranks 0 / 1; one process {r['peak_gib']:.3f}), state at rest "
                  f"{ranks[0][f'{rk}rest_gib']:.3f} GiB a rank, the checked (first) step "
                  f"{ranks[0][f'{rk}step_ms']:.3f} ms (one process {r['step_ms']:.3f}; gloo "
                  "through the host, no speed number)")
        del refs

        # the TP checkpoint, restored in one process
        ckpt = torch.load(f"{tmp}/mp0.json.ckpt.pt")
        rc = load_run_config(cfgs["one"])
        one = Trainer(rc, build_model(rc, seed=rc.train.seed + 1, device="cuda"),
                      mesh=DataMesh())
        one.resume(ckpt["path"])
        state = [*tree_leaves(one.params), *one.opt_state["mu"], *one.opt_state["nu"]]
        same = all(torch.equal(a.cpu(), b_) for a, b_ in zip(state, ckpt["state"], strict=True))
        if not same:
            failed.append("the TP checkpoint restored in one process differs from the ranks' "
                          "gathered state")
        one.dataloader.close()
        del one, state, ckpt
        gc.collect()
        torch.cuda.empty_cache()
        print("  TP checkpoint (one-card layout, rank 0 wrote) restored in one process: "
              + ("the same bits as the ranks' gathered parameters and moments" if same
                 else "differs"))

        # TP serving against one engine: the same detection counts; every
        # detection's score and box against the float32 control as close
        # as one engine's (MP_CONTROL_K, MP_CONTROL_FLOOR), and against one
        # engine, reported beside the 1/64 rule
        got = ranks[0]["detections"]
        tp_one = _detections_err(got, want)
        tp_f32, one_f32 = _detections_err(got, want32), _detections_err(want, want32)
        if tp_one[2]:
            failed.append(f"TP serving: {tp_one[2]} pages whose detection count differs from "
                          "one engine's")
        for i, what in enumerate(("scores", "boxes")):
            if tp_f32[i] > MP_CONTROL_K * one_f32[i] + MP_CONTROL_FLOOR:
                failed.append(f"TP serving {what} {tp_f32[i]:.3e} of max |ref| from float32, "
                              f"one engine {one_f32[i]:.3e}")
        print(f"  TP serving (224 and 1024 px buckets, {len(got)} pages, batch {MP_BATCH}): "
              f"detection counts {'equal to' if not tp_one[2] else 'not'} one engine's; every "
              f"detection against one engine: scores {tp_one[0]:.3e}, boxes (to their label's "
              f"nearest) {tp_one[1]:.3e} of max |ref| (the 1/64 rule "
              f"{'met' if max(tp_one[:2]) <= BF16_REL_TOL else 'missed'}); against float32: "
              f"scores {tp_f32[0]:.3e} and boxes {tp_f32[1]:.3e}, one engine's {one_f32[0]:.3e} "
              f"and {one_f32[1]:.3e} ({ranks[0]['serve_s']:.3f} s)")
        out["serving"] = {"tp_one": tp_one, "tp_f32": tp_f32, "one_f32": one_f32}
        if failed:
            raise RuntimeError("model_parallel:\n  " + "\n  ".join(failed))
        out.update(ranks=[{k: v for k, v in r.items() if k not in ("detections", "launches")}
                          for r in ranks])
    print(f"  model_parallel launches: {launched}")
    for name in ("short_attention", "short_attention_bwd", "flash_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkdv", "roi_align",
                 "roi_align_bwd"):
        if launched[name] <= 0:
            raise RuntimeError(f"model_parallel: {name} was not launched")
    for name in ("flash_attention_bwd_dbias", *PROBE_KERNELS, "linear_sum_assignment"):
        if launched[name]:
            raise RuntimeError(f"model_parallel: {name} launched {launched[name]} times")
    for k in kernels:
        k["model_parallel_launches"] = launched[k["name"]]
    out["launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  model_parallel phase: {out['phase_s']:.1f} s")
    return out


# phase pipeline: configs/train_pipeline.json (dit-large, 1024 px, global
# attention, N = 4097; two GPipe stages of 12 layers, 2 microbatches) on
# two gloo ranks sharing the card (--pipeline-child pp), batch PIPE_BATCH,
# one checked step (one process's proposals, _FixedProposals) and one
# timed; FSDP over a model axis on a 2 x 2 mesh of four gloo ranks
# (--pipeline-child ft: the default dit-base as RetinaNet at 224 px, batch
# FT_BATCH); both groups start together. Each against one process's bf16
# step (losses MP_LOSS_RTOL, the pipelined taps BF16_REL_TOL of max |ref|)
# and each gradient leaf against one process's float32 control as close
# as one process's bf16 (MP_CONTROL_K, MP_CONTROL_FLOOR). Then JAX's
# committed .orbax fixture loads onto the card with the port's reader
# (its zstd is the system libzstd.so.1), leaf hashes equal to the file's.
PIPE_CONFIG = ROOT / "configs" / "train_pipeline.json"
PIPE_BATCH = 2
PIPE_PAGES = 4
PIPE_TIMEOUT_S = 600
FT_BATCH = 4
FT_MESH = {"data_parallel": 2, "model_parallel": 2, "fsdp": True}
ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "retinanet_tp.orbax"
ORBAX_HASHES = ROOT / "tests" / "fixtures" / "retinanet_tp.sha256.json"
# the pipelined path's kernels, launched on every stage rank
PIPE_KERNELS = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv",
                "roi_align", "roi_align_bwd")


def _pipeline_kernels(gen, kernels: list[dict]) -> None:
    """Rows 3-5 at a pipeline stage's microbatch (B = 1, N = 4097, H = 16,
    dit-large at 1024 px without windows) and rows 7-8 at the pipelined
    Faster R-CNN step's (1024 px pyramid, B = 2, K = 512), against their
    plain versions and timed (phase ``kernels_large``); the entries gain
    ``pipeline_*`` keys."""
    h = 16
    q, k, v = _qkv(gen, 1, 4097, h, 64)
    _entry(kernels, "flash_attention").update(
        {f"pipeline_{k}": v for k, v in _flash_fwd_case(gen, q, k, v, False).items()})
    del q, k, v
    res = _flash_bwd_case(gen, 1, 4097, False, h=h)
    for part in ("dq", "dkdv"):
        _flash_bwd_entry(_entry(kernels, f"flash_attention_bwd_{part}"), part, "pipeline_", res,
                         1, 4097, h, with_bias=False)
    _entry(kernels, "roi_align").update(
        {f"pipeline_{k}": v for k, v in _roi_fwd_case(gen, 1024, PIPE_BATCH).items()})
    _entry(kernels, "roi_align_bwd").update(
        {f"pipeline_{k}": v for k, v in _roi_bwd_case(gen, 1024, PIPE_BATCH).items()})
    torch.cuda.empty_cache()


def _pipe_configs(tmp: str) -> dict:
    """The phase's config files over ``tmp``'s pages: ``pp`` (the
    train_pipeline mesh and model, batch PIPE_BATCH), ``onepp`` (one
    process), ``f32pp`` (one process in float32 with remat, the control);
    ``ft`` (RetinaNet at 224 px on the FT_MESH, batch FT_BATCH), ``oneft``,
    ``f32ft``."""
    from layoutdit_tpu_torch.tools.make_fixture import write_fixture_config

    with open(write_fixture_config(tmp, split="samples", epochs=1, batch_size=PIPE_BATCH)) as f:
        raw = json.load(f)
    with open(PIPE_CONFIG) as f:
        pipe = json.load(f)
    with open(CONFIG) as f:
        budget = json.load(f)["detection_model_config"]["detection_budget"]
    models = {"pp": ({**pipe["detection_model_config"], "detection_budget": budget},
                     pipe["mesh_config"], PIPE_BATCH),
              "ft": ({"detector": "retinanet", "image_size": 224, "detection_budget": budget},
                     FT_MESH, FT_BATCH)}
    paths = {}
    for key, (model, mesh, batch) in models.items():
        for prefix in ("", "one", "f32"):
            cfg = json.loads(json.dumps(raw))
            cfg["run_name"] = prefix + key
            cfg["detection_model_config"] = json.loads(json.dumps(model))
            cfg["data_loader_config"]["batch_size"] = batch
            if not prefix:
                cfg["mesh_config"] = mesh
            if prefix == "f32":
                cfg["precision"] = {"compute_dtype": "float32"}
                cfg["detection_model_config"]["remat"] = True
            paths[prefix + key] = f"{tmp}/{prefix + key}.json"
            with open(paths[prefix + key], "w") as f:
                json.dump(cfg, f)
    return paths


class _TapSpy:
    """While installed, the encoder's first call's taps are kept (float32,
    on the host) in ``taps``."""

    def __enter__(self):
        from layoutdit_tpu_torch.models import backbone

        self.mod, self.orig, self.taps = backbone, backbone.vit_forward, None

        def spy(*args, **kw):
            out = self.orig(*args, **kw)
            if self.taps is None:
                self.taps = [t.detach().float().cpu() for t in out]
            return out

        backbone.vit_forward = spy
        return self

    def __exit__(self, *exc):
        self.mod.vit_forward = self.orig
        return False


def _state_gib(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 2**30


def pipeline_child(mode: str, rank: str, world: str, port: str, cfg_dir: str,
                   out_path: str) -> int:
    """Phase ``pipeline``'s rank ``rank`` of ``world`` on the one card, over
    gloo: ``mode`` "pp", a stage of the pipelined dit-large step (the
    checked step on one process's proposals, then a timed one); "ft", a
    rank of the FSDP x TP RetinaNet step (the checked step, then a timed
    one). Rank 0 writes the one-card gradients (and the taps); every rank
    its readings and launches to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from layoutdit_tpu_torch.config import MeshConfig, load_run_config
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.parallel.mesh import maybe_distributed_init
    from layoutdit_tpu_torch.train.trainer import Trainer

    rank, world = int(rank), int(world)
    if not maybe_distributed_init(MeshConfig(
            enable_distributed_init=True, coordinator_address=f"127.0.0.1:{port}",
            num_processes=world, process_id=rank), device="cuda:0", backend="gloo"):
        raise RuntimeError("pipeline child: no process group started")
    rc = load_run_config(f"{cfg_dir}/{mode}.json")
    trainer = Trainer(rc, build_model(rc, seed=rc.train.seed, device="cuda"))
    mesh = trainer.mesh
    if mode == "pp" and (trainer.pipe is None or trainer.pipe.n_stages != world):
        raise RuntimeError(f"pipeline child: mesh {mesh}")
    if mode == "ft" and not (mesh.fsdp and trainer.tp is not None):
        raise RuntimeError(f"pipeline child: mesh {mesh}")
    out = {"tp_rest_gib": _state_gib([*trainer._leaves, *trainer.opt_state["mu"],
                                      *trainer.opt_state["nu"]])}
    batch = next(iter(trainer.dataloader))
    _reset_counts()
    with trainer.sharded():
        if trainer._rest is not None:
            out["rest_gib"] = _state_gib([*trainer._rest, *trainer.opt_state["mu"],
                                          *trainer.opt_state["nu"]])
        else:
            out["rest_gib"] = out["tp_rest_gib"]
        with contextlib.ExitStack() as stack:
            spy = stack.enter_context(_TapSpy())
            fixed = (stack.enter_context(_FixedProposals(f"{cfg_dir}/props_pp.pt", replay=True))
                     if mode == "pp" else None)
            loss, comps, grads, peak, ms = _mp_step(trainer, batch)
        out["own_proposals_same"] = None if fixed is None else fixed.same
        if trainer._rest is not None:
            grads = trainer._train_layout.gather(grads)
        if trainer._train_tp is not None:
            grads = trainer._train_tp.gather(grads)
        _, _, _, peak2, ms2 = _mp_step(trainer, batch)
    out.update(loss=loss, losses=comps, peak_gib=max(peak, peak2), step_ms=ms,
               timed_step_ms=ms2, launches=_counts())
    if rank == 0:
        torch.save({"grads": [g.float().cpu() for g in grads], "taps": spy.taps},
                   f"{out_path}.pt")
    if mode == "pp":  # every stage holds the same reduced gradients
        dist.barrier()
        if rank:
            ref = torch.load(f"{cfg_dir}/pp0.json.pt")["grads"]
            out["same_grads_as_rank0"] = all(torch.equal(a, g.float().cpu())
                                             for a, g in zip(ref, grads, strict=True))
    trainer.dataloader.close()
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _orbax_on_card() -> dict:
    """JAX's committed ``.orbax`` fixture (a TP-sharded RetinaNet state
    with its AdamW chain and EMA, ``tests/fixtures/orbax_fixture.py``)
    loaded onto the card by the port's reader: every tensor on the card,
    each leaf's SHA-256 the committed one."""
    import hashlib

    from layoutdit_tpu_torch.train.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    state = load_checkpoint(str(ORBAX_FIXTURE), map_location="cuda")
    load_s = time.perf_counter() - t0
    got = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            if not x.is_cuda:
                raise RuntimeError(f"orbax fixture: {prefix} not on the card")
            t = x.detach().cpu().contiguous()
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            got[prefix] = hashlib.sha256(raw.numpy().tobytes()).hexdigest() + f":{t.dtype}"
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)

    walk("", {"params": state["params"], "opt_state": state["opt_state"]})
    want = json.loads(ORBAX_HASHES.read_text())
    if got != want:
        bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise RuntimeError(f"orbax fixture: {len(bad)} leaves differ from the committed "
                           f"hashes, e.g. {bad[:3]}")
    print(f"  .orbax fixture ({ORBAX_FIXTURE.name}): {len(got)} leaves on the card, every "
          f"hash the committed one, epoch {state['epoch']} ({load_s:.3f} s, zstd from the "
          "system libzstd.so.1)")
    return {"leaves": len(got), "epoch": state["epoch"], "load_s": load_s}


def _pipe_ref(cfgs: dict, name: str, tmp: str, fixed: bool, f32: bool) -> dict:
    """One process's checked step of config ``name`` (float32 control with
    ``f32``) -> its losses, gradients (host), taps, peak, time and state."""
    from layoutdit_tpu_torch.config import load_run_config
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.models.weights_io import tree_paths
    from layoutdit_tpu_torch.parallel.mesh import DataMesh
    from layoutdit_tpu_torch.train.trainer import Trainer

    rc = load_run_config(cfgs[name])
    trainer = Trainer(rc, build_model(rc, seed=rc.train.seed, device="cuda"), mesh=DataMesh())
    rest = _state_gib([*trainer._leaves, *trainer.opt_state["mu"], *trainer.opt_state["nu"]])
    batch = next(iter(trainer.dataloader))
    with contextlib.ExitStack() as stack:
        spy = stack.enter_context(_TapSpy())
        if fixed:
            stack.enter_context(_FixedProposals(f"{tmp}/props_pp.pt", replay=f32))
        loss, comps, grads, peak, ms = _mp_step(trainer, batch)
    out = {"loss": loss, "losses": comps, "grads": [g.float().cpu() for g in grads],
           "taps": spy.taps, "peak_gib": peak, "step_ms": ms, "rest_gib": rest,
           "paths": [p for p, t in zip(tree_paths(trainer.params), trainer._leaves)
                     if t.requires_grad]}
    trainer.dataloader.close()
    del trainer, batch, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pipeline(kernels: list[dict], card: str) -> dict:
    """GPipe stages, FSDP over a model axis and JAX's ``.orbax`` reader
    through the port's entry points:

      * ``configs/train_pipeline.json`` at full width (dit-large, 24
        layers as two stages of 12, 1024 px, N = 4097, 2 microbatches) on
        two gloo ranks sharing the card (``--pipeline-child pp``): the
        checked step against one process's (losses, the four taps, each
        gradient leaf) and against one process's float32 control (each
        leaf as close as one process's bf16); peak and at-rest GiB a rank
        beside one process's; the timed step; rows 3-5, 7 and 8 launched
        on each stage (held to their plain versions at these shapes in
        ``kernels_large``);
      * FSDP x TP (2 x 2, four gloo ranks, ``--pipeline-child ft``) on
        RetinaNet at 224 px, by the same rules, its at-rest GiB a rank
        against TP alone's;
      * the committed ``.orbax`` fixture onto the card (``_orbax_on_card``).

    Every comparison runs and prints before the phase raises on those
    that missed. The launches of the six ranks are the phase's."""
    from layoutdit_tpu_torch.parallel.mesh import free_port
    from layoutdit_tpu_torch.parallel.pipeline import bubble
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture

    t_phase = time.perf_counter()
    out = {"card": card}
    groups = {"pp": 2, "ft": 4}
    procs = []

    def start(mode: str) -> None:
        port = free_port()
        for rank in range(groups[mode]):
            log = open(Path(tmp) / f"{mode}{rank}.log", "w")
            procs.append((mode, rank, subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--pipeline-child", mode,
                 str(rank), str(groups[mode]), str(port), tmp, f"{tmp}/{mode}{rank}.json"],
                stdout=log, stderr=subprocess.STDOUT), log))

    with tempfile.TemporaryDirectory() as tmp:
        make_fixture(tmp, n_images=PIPE_PAGES, split="samples", seed=0)
        cfgs = _pipe_configs(tmp)
        refs = {}
        try:
            # the FSDP x TP ranks need nothing of this process: they start
            # first; the stages once one process's step wrote its proposals
            start("ft")
            t0 = time.perf_counter()
            for key in ("pp", "ft"):
                refs[key] = _pipe_ref(cfgs, "one" + key, tmp, fixed=key == "pp", f32=False)
                if key == "pp":  # its proposals are written: the stages start
                    start("pp")
                with _float32_plain():
                    f32 = _pipe_ref(cfgs, "f32" + key, tmp, fixed=key == "pp", f32=True)
                refs[key].update(f32_grads=f32["grads"], f32_losses=f32["losses"])
                del f32
            out["references_s"] = time.perf_counter() - t0
            for mode, rank, proc, log in procs:
                code = proc.wait(timeout=PIPE_TIMEOUT_S)
                log.close()
                if code != 0:
                    text = (Path(tmp) / f"{mode}{rank}.log").read_text()
                    raise RuntimeError(f"pipeline {mode} rank {rank}: exit code {code}\n"
                                       f"{text[-4000:]}")
        finally:
            for _, _, proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        out["ranks_s"] = time.perf_counter() - t_phase
        print(f"  references {out['references_s']:.1f} s (beside the ranks), the ranks done "
              f"{out['ranks_s']:.1f} s into the phase")
        ranks = {mode: [json.loads(Path(f"{tmp}/{mode}{r}.json").read_text())
                        for r in range(world)] for mode, world in groups.items()}

        failed = []
        for mode, label in (("pp", "pipelined dit-large 1024 px (2 stages x 12 layers)"),
                            ("ft", "FSDP x TP RetinaNet 224 px (2 x 2)")):
            r, got = refs[mode], torch.load(f"{tmp}/{mode}0.json.pt")
            first = dict(ranks[mode][0])
            # a rank's losses are its data index's rows': their mean over
            # the ranks is the global batch's (every data index has as
            # many model and pipe ranks)
            first["losses"] = {k: float(np.mean([x["losses"][k] for x in ranks[mode]]))
                               for k in first["losses"]}
            first["loss"] = float(np.mean([x["loss"] for x in ranks[mode]]))
            _mp_worst(label, got["grads"], r["grads"], r["paths"])
            err = _mp_leaves(f"{label} gradient ({len(got['grads'])} leaves)", got["grads"],
                             r["grads"], r["f32_grads"], failed, r["paths"])
            for k, v in first["losses"].items():
                if not abs(v - r["losses"][k]) <= MP_LOSS_RTOL * abs(r["losses"][k]) + 1e-6:
                    failed.append(f"{mode} {k} {v} against one process's {r['losses'][k]}")
            res = {"loss": first["loss"], "ref_loss": r["loss"], "losses": first["losses"],
                   "ref_losses": r["losses"], "grad_err": err,
                   "step_ms": [x["step_ms"] for x in ranks[mode]],
                   "timed_step_ms": [x["timed_step_ms"] for x in ranks[mode]],
                   "ref_step_ms": r["step_ms"], "peak_gib": [x["peak_gib"] for x in ranks[mode]],
                   "ref_peak_gib": r["peak_gib"], "rest_gib": [x["rest_gib"] for x in ranks[mode]],
                   "ref_rest_gib": r["rest_gib"],
                   "tp_rest_gib": [x["tp_rest_gib"] for x in ranks[mode]]}
            if mode == "pp":
                taps = [_check_tap(i, g, w, failed) for i, (g, w) in
                        enumerate(zip(got["taps"], r["taps"], strict=True))]
                res.update(taps_max_ratio=taps, bubble=bubble(2, 2),
                           own_proposals_same=first["own_proposals_same"],
                           same_grads_on_ranks=all(x.get("same_grads_as_rank0", True)
                                                   for x in ranks[mode]))
                if not res["same_grads_on_ranks"]:
                    failed.append("pipeline: the stages' reduced gradients differ")
            out[mode] = res
            print(f"  {label}: losses {first['losses']} (one process {r['losses']}); peak "
                  f"{res['peak_gib']} GiB a rank (one process {r['peak_gib']:.3f}), at rest "
                  f"{res['rest_gib']} GiB a rank (one process {r['rest_gib']:.3f}"
                  + (f", TP alone {res['tp_rest_gib']}" if mode == "ft" else "")
                  + f"); checked step {res['step_ms']} ms, timed step {res['timed_step_ms']} ms "
                  f"a rank (one process's checked step {r['step_ms']:.3f}; gloo through the "
                  "host, the six ranks and the references together: a record, not a speed)")
        del refs
        out["orbax"] = _orbax_on_card()
        if failed:
            raise RuntimeError("pipeline:\n  " + "\n  ".join(failed))
    launched = {mode: [x["launches"] for x in ranks[mode]] for mode in ranks}
    print(f"  pipeline launches: stages {launched['pp']}; FSDP x TP ranks {launched['ft']}")
    for rank, counts in enumerate(launched["pp"]):
        for name in PIPE_KERNELS:
            if counts[name] <= 0:
                raise RuntimeError(f"pipeline: stage {rank} did not launch {name}")
        for name in ("short_attention", "short_attention_bwd", "flash_attention_bwd_dbias",
                     *PROBE_KERNELS, "linear_sum_assignment"):
            if counts[name]:
                raise RuntimeError(f"pipeline: stage {rank} launched {name} {counts[name]} "
                                   "times")
    total = {name: sum(c[name] for m in launched.values() for c in m) for name in _counts()}
    for k in kernels:
        k["pipeline_launches"] = total[k["name"]]
    out["launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  pipeline phase: {out['phase_s']:.1f} s")
    return out


def _check_tap(i: int, got: torch.Tensor, want: torch.Tensor, failed: list) -> float:
    """A pipelined tap against one process's: max |got - want| within
    BF16_REL_TOL of max |want| (else added to ``failed``)."""
    ratio = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    print(f"  pipelined tap {i}: max err / max |ref| {ratio:.3e} (held to {BF16_REL_TOL:.4g})")
    if not ratio <= BF16_REL_TOL:
        failed.append(f"pipelined tap {i}: {ratio:.3e} of max |ref|")
    return ratio


# float32 serving (phase serve_f32): the float32 forms of rows 1, 3 and 7
# against their plain versions on the same fp32 inputs (the plain versions
# compute in fp32 too, with cuBLAS in full fp32: TF32 is off in this
# script): o within F32_O_TOL of max |plain| (the same fp32 math summed in
# another order, IEEE expf), the lse within F32_LSE_TOL absolute,
# RoIAlign within F32_ROI_TOL of max |plain| (fp32 sums of the same taps)
F32_O_TOL = 2e-5
F32_LSE_TOL = 1e-5
F32_ROI_TOL = 1e-5
# the float32 engine's detections against the float32 control
# (``_float32_plain``) on the same weights and pages: every page the same
# count, scores and boxes within F32_DET_TOL of max |ref| (``_detections_err``)
F32_DET_TOL = 1e-4
F32_ROUNDS = 2  # timed rounds of each bucket's request, float32 and bf16 engines in turn
F32_SCORE_PAGES = 8
F32_ITERS = 10  # timed launches of a float32 kernel case


def _sdpa_backend(q, k, v, mask) -> str:
    """The backend SDPA picks for these inputs (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    names = {int(m): name for name, m in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q, k, v, mask, 0.0, False)), "unknown")


def _f32_attention_case(label: str, kernel, plain, sdpa_mask, q, k, v, kept: int,
                        extra_bytes: int, lse_form=None) -> dict:
    """One float32 attention case: the kernel's o (and lse) against the
    plain version's, a second launch the same bits, times on the card alone
    beside the plain version and SDPA with fp32 inputs (its backend
    printed). The bound: q and o rows once, k and v rows of the kept keys,
    ``extra_bytes`` (lse, bias, mask), and 4 D flops a kept (query, key)
    pair, at the fp32 rate."""
    b, n, h, d = q.shape
    got = kernel()
    want = plain()
    o, lse = got if isinstance(got, tuple) else (got, None)
    o_ref, lse_ref = want
    err, tol = _check_close(label, o, o_ref, rel=F32_O_TOL)
    res = {"max_abs_err": err, "tolerance": tol}
    if lse_form is not None:  # the training form: o's bits, and the lse
        o_lse, lse = lse_form()
        if not torch.equal(o_lse, o):
            raise RuntimeError(f"{label}: the lse form gave other bits")
    lse_err = (lse - lse_ref.reshape(lse.shape)).abs().max().item()
    print(f"  {label} lse: max_abs_err {lse_err:.6g} (tolerance {F32_LSE_TOL})")
    if not lse_err <= F32_LSE_TOL:
        raise RuntimeError(f"{label}: lse disagrees with its plain version")
    res["lse_max_abs_err"] = lse_err
    again = kernel()
    if not torch.equal(o, again[0] if isinstance(again, tuple) else again):
        raise RuntimeError(f"{label}: two launches gave different bits")
    del got, want, o, o_ref, lse, lse_ref, again
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    backend = _sdpa_backend(qt, kt, vt, sdpa_mask)
    bound, by = _bound_ms(2 * b * n * h * d * 4 + 2 * kept * h * d * 4 + extra_bytes,
                          4 * h * n * kept * d, PEAK_FP32_FLOPS)
    ms = _device_ms(kernel, F32_ITERS)
    _print_share(f"{label} on the card", ms, bound, by)
    res.update(ms=ms, call_ms=_time_ms(kernel, F32_ITERS), plain_ms=_time_ms(plain, 2),
               bound_ms=bound, bound_by=by, bound_share=bound / ms,
               library_ms=_device_ms(lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask), F32_ITERS),
               library_backend=backend)
    if lse_form is not None:
        res["lse_form_ms"] = _device_ms(lse_form, F32_ITERS)
    print(f"  {label}: plain {res['plain_ms']:.6g} ms, SDPA ({backend}) "
          f"{res['library_ms']:.6g} ms on the card")
    return res


def _short_f32_case(gen, b, n, h=12, d=64, key_mask=None) -> dict:
    """Row 1's float32 form at one shape (``_f32_attention_case``), the
    inference form and the training form (o and lse)."""
    from layoutdit_tpu_torch.ops import short_attention as sa

    q, k, v = _qkv(gen, b, n, h, d, torch.float32)
    mask_bytes, cols = _mask_work(b, n, key_mask)
    masked = f", key mask [{key_mask.shape[0]}, {n}]" if key_mask is not None else ""
    res = _f32_attention_case(
        f"short_attention fp32 B={b} N={n} H={h} D={d}{masked}",
        lambda: sa.short_attention(q, k, v, key_mask=key_mask),
        lambda: sa.short_attention_plain(q, k, v, key_mask=key_mask, return_lse=True),
        _sdpa_mask(b, key_mask), q, k, v, cols, mask_bytes,
        lse_form=lambda: sa.short_attention(q, k, v, key_mask=key_mask, return_lse=True))
    res["shape"] = f"B={b} N={n} H={h} D={d} fp32, q/k/v strided in fused [B, N, 3HD]{masked}"
    torch.cuda.empty_cache()
    return res


def _flash_f32_case(gen, b, n, h=12, with_bias=False, key_mask=None, n_keys=None) -> dict:
    """Row 3's float32 form at one shape (``_f32_attention_case``): o and
    lse; SDPA gets the bias as a float mask (the dropped keys at -inf) or
    the kept keys as a boolean one."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import short_attention as sa

    d = 64
    q, k, v = _qkv(gen, b, n, h, d, torch.float32)
    bias = 0.5 * torch.randn(h, n, n, generator=gen, device="cuda") if with_bias else None
    keep = (sa.key_mask_rows(key_mask, b) if key_mask is not None else
            (torch.arange(n, device="cuda") < (n_keys or n))[None].expand(b, n))
    extra = b * h * n * 4 + (0 if key_mask is None else key_mask.numel())
    mask = None
    if with_bias:
        extra += h * n * int(keep.any(0).sum()) * 4
        mask = torch.where(keep[:, None, None, :], bias[None], float("-inf"))
    elif key_mask is not None or n_keys is not None:
        mask = keep[:, None, None, :]
    what = ((f", fp32 bias [{h}, {n}, {n}]" if with_bias else ", no bias")
            + (f", key mask [{key_mask.shape[0]}, {n}]" if key_mask is not None else "")
            + (f", n_keys {n_keys}" if n_keys else ""))
    res = _f32_attention_case(
        f"flash_attention fp32 B={b} N={n} H={h}{what}",
        lambda: fa.flash_attention_fwd(q, k, v, bias, None, n_keys, key_mask),
        lambda: fa.flash_attention_plain(q, k, v, bias, None, n_keys, key_mask),
        mask, q, k, v, int(keep.sum()), extra)
    res["shape"] = f"B={b} N={n} H={h} D={d} fp32, q/k/v strided in fused [B, N, 3HD]{what}"
    del q, k, v, bias, mask
    torch.cuda.empty_cache()
    return res


def _roi_f32_case(gen, image: int, b: int, k: int, p: int = 7, c: int = 256) -> dict:
    """Row 7's float32 form on an fp32 pyramid in the detector's layout,
    against its plain version, timed on the card alone beside it."""
    from layoutdit_tpu_torch.ops import roi_align as ra

    feats, rois, mask = _roi_inputs(gen, image, b=b, k=k, c=c, dtype=torch.float32)
    levels = ra.roi_levels(rois, 5, float(image), roi_mask=mask)
    label = f"roi_align fp32 {image} px B={b} K={k} C={c} P={p}"
    kernel = lambda: ra.roi_align_fwd(feats, rois, levels, ROI_SCALES, p, 2)  # noqa: E731
    plain = lambda: ra.roi_align_plain(feats, rois, levels, ROI_SCALES, p, 2)  # noqa: E731
    got = kernel()
    err, tol = _check_close(label, got, plain(), rel=F32_ROI_TOL)
    if not torch.equal(got, kernel()):
        raise RuntimeError(f"{label}: two launches gave different bits")
    nbytes = (_roi_touched_bytes(feats, rois, levels, ROI_SCALES, p, 2) + rois.numel() * 4
              + b * k * p * p * c * 4)
    bound, by = _bound_ms(nbytes, b * k * p * p * c * 2 * 2 * 4 * 2, PEAK_FP32_FLOPS)
    ms = _device_ms(kernel, F32_ITERS)
    _print_share(f"{label} on the card", ms, bound, by)
    return {"shape": f"B={b} K={k} C={c} P={p} G=2 pyramid {image} px fp32, channels-last, "
                     "fifth level a strided view",
            "max_abs_err": err, "tolerance": tol, "ms": ms, "call_ms": _time_ms(kernel, F32_ITERS),
            "plain_ms": _time_ms(plain, 2), "bound_ms": bound, "bound_by": by,
            "bound_share": bound / ms}


def _serve_f32_kernels(gen, kernels: list[dict]) -> list[dict]:
    """The kernel half of phase serve_f32, timed alone on the card (after
    phase ``flash_masked``): the float32 forms of rows 1, 3 and 7 at the
    float32 serving path's shapes and the main paths' others, each against
    its plain version; their entries are added to ``kernels``."""
    from layoutdit_tpu_torch.models.vit import _window_key_mask

    print("  float32 forms of rows 1, 3 and 7 (TF32 off) against their plain versions")
    w14 = _window_key_mask(64, 64, 14).cuda()  # [25, 196]: dit-base's 14 x 14 windows
    short = {"name": "short_attention_f32", "route": "cuda",
             "source": "layoutdit_tpu_torch/csrc/attention_f32.cuh",
             "replaces": "layoutdit_tpu/ops/short_attention.py:79",
             **_short_f32_case(gen, 4, 197)}
    for key, case in (("d32", dict(b=8, n=197, h=2, d=32)),
                      ("d128", dict(b=4, n=197, h=6, d=128)),
                      ("masked", dict(b=100, n=196, h=16, key_mask=w14))):
        short.update({f"{key}_{k}": v for k, v in _short_f32_case(gen, **case).items()})
    flash = {"name": "flash_attention_f32", "route": "cuda",
             "source": "layoutdit_tpu_torch/csrc/attention_f32.cuh",
             "replaces": "layoutdit_tpu/ops/flash_attention.py:180",
             "bias_replaces": "layoutdit_tpu/ops/flash_attention.py:64",
             **_flash_f32_case(gen, 4, 4097)}
    for key, case in (("w256_bias", dict(b=64, n=256, with_bias=True)),
                      ("w14", dict(b=100, n=196, with_bias=True, key_mask=w14)),
                      ("nkeys", dict(b=2, n=2049, h=8, n_keys=1024))):
        flash.update({f"{key}_{k}": v for k, v in _flash_f32_case(gen, **case).items()})
    roi = {"name": "roi_align_f32", "route": "cuda",
           "source": "layoutdit_tpu_torch/csrc/roi_align.cu",
           "replaces": "layoutdit_tpu/ops/roi_align_pallas.py:49", "library_ms": None,
           **_roi_f32_case(gen, 1024, 4, 512)}
    roi.update({f"b224_{k}": v for k, v in _roi_f32_case(gen, 224, 4, 512).items()})
    roi.update({f"p14_{k}": v for k, v in _roi_f32_case(gen, 224, 4, 100, p=14).items()})
    kernels += [short, flash, roi]
    torch.cuda.empty_cache()
    return [short, flash, roi]


@contextlib.contextmanager
def _plain_spy():
    """Within the block, calls of the plain versions of rows 1, 3 and 7
    (which the wrappers make only for CPU tensors) are counted by name."""
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    calls = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (sa, "short_attention_plain"), (fa, "flash_attention_plain"), (ra, "roi_align_plain"))]

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    try:
        for mod, name, fn in saved:
            setattr(mod, name, spy(name, fn))
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _bucket_requests(engine, requests: dict, rounds: int) -> dict:
    """Each bucket's request ``rounds`` times -> its latencies (host clock
    to a synchronize), peak GiB allocated and the last round's results."""
    out = {}
    for name, pages in requests.items():
        lat, peak = [], 0.0
        for _ in range(rounds):
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results = engine.predict_pages(pages)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
            _check_pages(pages, results, allow_empty=True)
        out[name] = {"latency_ms": sorted(t * 1e3 for t in lat),
                     "pages_per_s": len(pages) / float(np.median(lat)), "peak_gib": peak,
                     "results": results}
    return out


def phase_serve_f32(kernels: list[dict]) -> dict:
    """Float32 serving on the card: ``configs/serving_1024.json`` with
    ``precision.compute_dtype`` "float32" in its raw dict (dit-base Faster
    R-CNN at full width, random weights from seed 0), served in its 224
    and 1024 px buckets through ``BatchInferenceEngine``, each bucket's
    request in rounds, beside the bf16 engine of the same weights on the
    same pages (latency, pages/s, peak GiB); the float32 engine's
    detections against the float32 control (``_float32_plain``: every
    wrapper's plain version, TF32 off) on the same weights and pages; one
    float32 ``Evaluator.score()`` over F32_SCORE_PAGES fixture pages. The
    float32 forms of rows 1, 3 and 7 must run (launches > 0) and no plain
    version may (a spy counts their calls) outside the control."""
    from layoutdit_tpu_torch.config import run_config_from_dict
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        DetectorModel,
        init_detector,
    )

    raw = json.loads(CONFIG.read_text())
    raw["precision"] = {"compute_dtype": "float32"}
    rc = run_config_from_dict(raw)
    cfg = DetectorConfig.from_model_config(rc.model, precision_dtype=rc.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_detector(cfg, gen, device="cuda")
    models = {"float32": DetectorModel(params, cfg),
              "bfloat16": DetectorModel(params,
                                        dataclasses.replace(cfg, compute_dtype="bfloat16"))}
    b = rc.data.batch_size
    engines = {dt: BatchInferenceEngine(m, image_sizes=(224, 1024), batch_size=b)
               for dt, m in models.items()}
    small, large = _serving_pages()
    requests = {"224 px bucket": small, "1024 px bucket": large}
    print(f"  dit-base Faster R-CNN in {rc.compute_dtype}, hidden {cfg.backbone.vit.hidden_size}, "
          f"{cfg.backbone.vit.num_hidden_layers} layers, buckets (224, 1024), batch {b}; the "
          "bf16 engine of the same weights beside it")
    for engine in engines.values():  # warm-up, not counted
        engine.predict_pages(small[:b] + large)
    torch.cuda.synchronize()

    _reset_counts()
    served = {}
    with _plain_spy() as plain_calls:
        for dt in ("float32", "bfloat16"):
            served[dt] = _bucket_requests(engines[dt], requests, F32_ROUNDS)
        f32_counts = {name: _counts()[name] for name in F32}
        with tempfile.TemporaryDirectory() as tmp:
            score_rc = dataclasses.replace(_fixture_run(rc, tmp, F32_SCORE_PAGES),
                                           eval_input="samples")
            t0 = time.perf_counter()
            metrics = Evaluator(models["float32"], score_rc).score()
            score_s = time.perf_counter() - t0
    counts = _counts()
    print(f"  launches (float32 and bf16 requests, float32 score()): {counts}")
    if plain_calls:
        raise RuntimeError(f"serve_f32: a plain version ran on the card: {plain_calls}")
    for name in F32:
        if f32_counts[name] <= 0:
            raise RuntimeError(f"serve_f32: {name} was not launched by the float32 engine")
    if metrics is None or not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"serve_f32: score() metrics {metrics}")
    for k in kernels:
        k["serve_f32_launches"] = counts[k["name"]]

    t0 = time.perf_counter()
    with _float32_plain():
        control = BatchInferenceEngine(models["float32"], image_sizes=(224, 1024), batch_size=b)
        want = {name: _detections(control.predict_pages(pages))
                for name, pages in requests.items()}
    control_s = time.perf_counter() - t0
    out = {"config": str(CONFIG.relative_to(ROOT)), "compute_dtype": rc.compute_dtype,
           "rounds": F32_ROUNDS, "control_s": control_s, "buckets": {}}
    failed = []
    for name, pages in requests.items():
        got = _detections(served["float32"][name]["results"])
        score_err, box_err, differ = _detections_err(got, want[name])
        dets = sum(len(r["scores"]) for r in got)
        row = {"pages": len(pages), "detections": dets, "score_err": score_err,
               "box_err": box_err, "pages_count_differs": differ}
        for dt in ("float32", "bfloat16"):
            r = served[dt][name]
            row[dt] = {key: r[key] for key in ("latency_ms", "pages_per_s", "peak_gib")}
            print(f"  {name}, {dt}: {len(pages)} pages, latency "
                  f"{', '.join(f'{t:.2f}' for t in r['latency_ms'])} ms, "
                  f"{r['pages_per_s']:.2f} pages/s, peak {r['peak_gib']:.3f} GiB")
        print(f"  {name}: float32 against the float32 control: {dets} detections, scores "
              f"{score_err:.3e} and boxes {box_err:.3e} of max |ref| (tolerance "
              f"{F32_DET_TOL}), {differ} pages with another count")
        if differ or not (score_err <= F32_DET_TOL and box_err <= F32_DET_TOL):
            failed.append(name)
        out["buckets"][name] = row
    if failed:
        raise RuntimeError(f"serve_f32: the float32 engine disagrees with the float32 control "
                           f"in {failed}")
    out.update(score={"pages": F32_SCORE_PAGES, "score_s": score_s,
                      "metrics": {k: metrics[k] for k in ("mAP", "AP50")}},
               launches={name: counts[name] for name in (*F32, *SERVING_KERNELS)},
               f32_request_launches=f32_counts)
    print(f"  float32 score(): {F32_SCORE_PAGES} pages at {cfg.image_size} px in {score_s:.3f} "
          f"s, mAP {metrics['mAP']:.4f}; float32 launches (requests) {f32_counts}; the "
          f"control {control_s:.1f} s")
    for engine in engines.values():
        engine.close()
    del engines, control, models, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the phases that run in a second process (``--lane-child``), one after
# another, beside the main process's serving to parallel and the recipes,
# once the kernels' timed cases are done: each builds its own models and
# checks from a seed, and one after another in the main process they took a
# third of the script's time. Their host and device times are measured with
# the other processes running beside them.
LANE_PHASES = ("io", "families", "one_stage", "detr", "finetune", "resnet", "moe")
LANE_TIMEOUT_S = 900


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def lane_child(names_path: str, out_path: str) -> int:
    """The second process: LANE_PHASES over kernel entries named as in
    ``names_path``; their results and the entries' launches to
    ``out_path``."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # it shares the host's cores, as recipe_child does
    with open(names_path) as f:
        kernels = [{"name": name} for name in json.load(f)]
    card = _card()
    runners = {"io": lambda: phase_io(kernels, card),
               "families": lambda: phase_families(None, kernels, card, kernel_cases={}),
               "one_stage": lambda: phase_one_stage(kernels, card),
               "detr": lambda: phase_detr(None, kernels, card, kernel_cases={}),
               "finetune": lambda: phase_finetune(kernels, card),
               "resnet": lambda: phase_resnet(kernels, card),
               "moe": lambda: phase_moe(kernels, card)}
    results = {}
    for name in LANE_PHASES:
        print(f"phase {name} (second process)", flush=True)
        t0 = time.perf_counter()
        results[name] = runners[name]()
        torch.cuda.empty_cache()
        print(f"  [{name}: {time.perf_counter() - t0:.1f} s]", flush=True)
    with open(out_path, "w") as f:
        json.dump({"results": results, "kernels": kernels}, f)
    return 0


def _start_lane(kernels: list[dict]) -> tuple:
    """Starts ``lane_child``; ``_join_lane`` waits for it."""
    tmp = tempfile.mkdtemp(prefix="lane")
    with open(f"{tmp}/names.json", "w") as f:
        json.dump([k["name"] for k in kernels], f)
    out, err = open(f"{tmp}/lane.log", "w"), open(f"{tmp}/lane.err", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--lane-child",
                             f"{tmp}/names.json", f"{tmp}/lane.json"], stdout=out, stderr=err)
    return tmp, proc, (out, err), time.perf_counter()


def _stop_lane(handle: tuple) -> None:
    """Kills the second process if it still runs and removes its folder."""
    tmp, proc, logs, _ = handle
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for log in logs:
        log.close()
    shutil.rmtree(tmp, ignore_errors=True)


def _join_lane(handle: tuple, kernels: list[dict]) -> dict:
    """Waits for the second process, prints its lines (its log lines to
    stderr), adds its launches to ``kernels``' entries and returns its
    phases' results by name."""
    tmp, proc, logs, t0 = handle
    try:
        rc = proc.wait(timeout=max(1.0, LANE_TIMEOUT_S - (time.perf_counter() - t0)))
        for log in logs:
            log.close()
        text, err = Path(f"{tmp}/lane.log").read_text(), Path(f"{tmp}/lane.err").read_text()
        print(text, end="", flush=True)
        sys.stderr.write(err)
        if rc != 0:
            raise RuntimeError(f"the second process: exit code {rc}\n{text[-3000:]}\n"
                               f"{err[-3000:]}")
        with open(f"{tmp}/lane.json") as f:
            data = json.load(f)
    finally:
        _stop_lane(handle)
    lane = {k["name"]: k for k in data["kernels"]}
    for k in kernels:
        for key, v in lane[k["name"]].items():
            if key.endswith("_launches"):
                k[key] = k.get(key, 0) + v
            elif key != "name":
                k[key] = v
    print(f"  second process ({', '.join(LANE_PHASES)}): {time.perf_counter() - t0:.1f} s "
          "from its start")
    return data["results"]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    if not ((ROOT / "layoutdit_tpu_torch").is_dir() and all(
            p.is_file() for p in (CONFIG, TRAIN_1024_CONFIG, RELPOS_CONFIG, LARGE_CONFIG,
                                  FSDP_LARGE_CONFIG, CASCADE_CONFIG, MASK_CONFIG,
                                  RETINANET_CONFIG, FCOS_CONFIG, DETR_CONFIG, LORA_CONFIG,
                                  MOE_CONFIG, MP_CONFIG, PIPE_CONFIG, ORBAX_HASHES))):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from layoutdit_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
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
    from layoutdit_tpu_torch.ops import short_attention as sa

    smem = fa._lib().flash_attention_smem_bytes
    for masked in (0, 1):
        print(f"  flash_attention{' masked' if masked else ''}: dynamic shared memory: forward "
              f"{smem(0, 0, masked)} / {smem(0, 1, masked)} bytes, dq {smem(1, 0, masked)} / "
              f"{smem(1, 1, masked)}, dkdv {smem(2, 0, masked)} / {smem(2, 1, masked)} (without "
              f"/ with a bias), dbias {smem(3, 4, masked)} (B = 4, rows resident) / "
              f"{smem(4, 0, masked)} (streamed)")
    smem = sa._lib().short_attention_smem_bytes
    print(f"  short_attention: dynamic shared memory at D = 64: forward {smem(0)} bytes, dq and "
          f"dkdv {smem(1)} each")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--only" in sys.argv:
        # a check of some phases alone (no kernels line, no last line)
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        runners = {"serving": lambda: phase_serving([]),
                   "deploy": lambda: phase_deploy([], gen),
                   "families": lambda: {**phase_families(gen, [], card),
                                        "recipes": phase_recipes([], ("cascade", "mask"))},
                   "one_stage": lambda: {**phase_one_stage([], card),
                                         "recipes": phase_recipes([], ("retinanet", "fcos"))},
                   "detr": lambda: phase_detr(gen, [], card),
                   "recipes": lambda: phase_recipes([], tuple(FAMILY_RECIPES)),
                   "detr_recipe": lambda: phase_detr_recipe([]),
                   "finetune": lambda: phase_finetune([], card),
                   "resnet": lambda: phase_resnet([], card),
                   "lora_recipe": lambda: phase_lora_recipe([]),
                   "moe": lambda: phase_moe([], card),
                   "parallel": lambda: phase_parallel([], card),
                   "model_parallel": lambda: phase_model_parallel([], card, gen),
                   "pipeline": lambda: phase_pipeline([], card),
                   "probes": lambda: phase_probes(gen, [phase_roi(gen), phase_roi_bwd(gen)]),
                   "flash_masked": lambda: phase_flash_masked(gen),
                   "serve_f32": lambda: {"kernels": _serve_f32_kernels(gen, []),
                                         **phase_serve_f32([])},
                   "train_1024_w14": lambda: phase_train_1024_w14([])}
        for name in only:
            print(f"phase {name}")
            print(json.dumps({name: runners[name]()}))
        return 0
    t_start = time.perf_counter()

    def mark(name: str, t0: float) -> None:
        now = time.perf_counter()
        print(f"  [{name}: {now - t0:.1f} s, {now - t_start:.1f} s since the kernels]",
              flush=True)

    t0 = time.perf_counter()
    print("phase kernels")
    kernels = [phase_short(gen), phase_flash(gen), phase_roi(gen)]
    torch.cuda.empty_cache()
    print("phase kernels_bwd")
    kernels += [phase_short_bwd(gen), *phase_flash_bwd(gen), phase_roi_bwd(gen),
                _matcher_entry()]
    torch.cuda.empty_cache()
    print("phase flash_masked")
    t1 = time.perf_counter()
    kernels += phase_flash_masked(gen)
    torch.cuda.empty_cache()
    mark("flash_masked", t1)
    # the float32 forms' cases (phase serve_f32's), before the probe path
    # counts every entry's launches
    _serve_f32_kernels(gen, kernels)
    print("phase probes")
    kernels += phase_probes(gen, kernels)
    torch.cuda.empty_cache()
    # the timed kernel cases of phases encoder, families and detr, here,
    # before any other process shares the card
    print("phase kernels_large")
    _encoder_kernels(gen, kernels)
    _pipeline_kernels(gen, kernels)
    families_cases = _families_kernels(gen, kernels)
    detr_cases = _detr_kernels(gen, kernels)
    torch.cuda.empty_cache()
    mark("kernels", t0)

    # beside the main process from here to phase parallel: the recipes
    # (phases recipes and convergence) and the second process's phases
    recipes_run = _start_recipes(tuple(FAMILY_RECIPES))
    lane_run = None
    try:
        lane_run = _start_lane(kernels)
        main_phases = (
            ("serving", lambda: phase_serving(kernels)),
            ("deploy", lambda: phase_deploy(kernels, gen)),
            ("serve_f32", lambda: phase_serve_f32(kernels)),
            ("train", lambda: phase_train(kernels)),
            ("train_state", lambda: phase_train_state(kernels, card)),
            ("train_1024", lambda: phase_train_1024(kernels)),
            ("train_1024_relpos", lambda: phase_train_1024_relpos(kernels)),
            ("train_1024_w14", lambda: phase_train_1024_w14(kernels)),
            ("encoder", lambda: phase_encoder(gen, kernels, with_kernels=False)),
            ("main", lambda: phase_main(kernels, card)),
            ("parallel", lambda: phase_parallel(kernels, card)),
            ("pipeline", lambda: phase_pipeline(kernels, card)))
        res = {}
        for name, run in main_phases:
            print(f"phase {name}")
            t0 = time.perf_counter()
            res[name] = run()
            torch.cuda.empty_cache()
            mark(name, t0)
        t0 = time.perf_counter()
        lane = _join_lane(lane_run, kernels)
        lane_run = None
        print("phase recipes")
        recipes = _join_recipes(recipes_run, kernels)
        recipes_run = None
        mark("waiting for the other processes", t0)
    finally:
        if lane_run is not None:
            _stop_lane(lane_run)
        if recipes_run is not None:
            _stop_recipes(recipes_run)
    serving, deploy, serve_f32, train, train_state = (
        res[k] for k in ("serving", "deploy", "serve_f32", "train", "train_state"))
    train_1024, train_1024_relpos, train_1024_w14, encoder, main_run, parallel, pipeline = (
        res[k] for k in ("train_1024", "train_1024_relpos", "train_1024_w14", "encoder", "main",
                         "parallel", "pipeline"))
    io, families, one_stage, detr, finetune, resnet, moe = (lane[k] for k in LANE_PHASES)
    families["kernels"], detr["kernels"] = families_cases, detr_cases
    conv = {**recipes.pop("flagship"), "card": card}
    for family in ("cascade", "mask", "retinanet", "fcos"):
        (families if family in ("cascade", "mask") else one_stage)[family]["convergence"] = (
            recipes[family])
    torch.cuda.empty_cache()

    print("phase model_parallel")
    t0 = time.perf_counter()
    model_parallel = phase_model_parallel(kernels, card, gen)
    mark("model_parallel", t0)
    paths = ("probe", "serving", "deploy", "serve_f32", "train", "train_state", "io",
             "train_1024", "train_1024_relpos", "train_1024_w14", "encoder", "main",
             "convergence", "families", "one_stage", "detr", "finetune", "resnet", "lora_recipe",
             "moe", "parallel", "model_parallel", "pipeline")
    for k in kernels:
        k["launches"] = sum(k[f"{path}_launches"] for path in paths)
        if k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} was launched on no path")

    print(json.dumps({"serving": serving}))
    print(json.dumps({"deploy": deploy}))
    print(json.dumps({"serve_f32": serve_f32}))
    print(json.dumps({"train": train}))
    print(json.dumps({"train_state": train_state}))
    print(json.dumps({"io": io}))
    print(json.dumps({"train_1024": train_1024}))
    print(json.dumps({"train_1024_relpos": train_1024_relpos}))
    print(json.dumps({"train_1024_w14": train_1024_w14}))
    print(json.dumps({"encoder": encoder}))
    print(json.dumps({"main": main_run}))
    print(json.dumps({"convergence": conv}))
    print(json.dumps({"families": families}))
    print(json.dumps({"one_stage": one_stage}))
    print(json.dumps({"detr": detr}))
    print(json.dumps({"lora_recipe": recipes["lora"]}))
    print(json.dumps({"finetune": finetune}))
    print(json.dumps({"resnet": resnet}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"model_parallel": model_parallel}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--exported-child"]:
        sys.exit(exported_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--recipe-child"]:
        sys.exit(recipe_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--model-parallel-child"]:
        sys.exit(model_parallel_child(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--lane-child"]:
        sys.exit(lane_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--pipeline-child"]:
        sys.exit(pipeline_child(*sys.argv[2:8]))
    sys.exit(main())
