"""Time the attention kernels of a checkout, so that two versions are
timed in turns in one chip call.

``--root DIR`` names the checkout (default: this file's). The process
builds and times that tree's kernels through its own ``chip_smoke.py``
cases, so two versions run in turns (parent, change, change, parent),
each process building and timing its own tree. ``--phases`` picks what
runs (default: all):

- ``short``: rows 1-2 (``_short_fwd_case``, ``_short_bwd_case``: each
  kernel against its plain version, its time on the card alone and per
  call, SDPA's and the bound) at the seven shapes the main paths give
  them: 224 px, the windowed 1024 px step's 16 x 16 windows and its CLS
  token, the micro-batch, dit-large at 224 px and in its 14 x 14
  windows with the key mask, and the convergence recipe's D = 32.
  Beside them the host's cost of a call alone (``host_*``: calls queued
  behind a spin kernel, so that the card's time is hidden; the median
  of a few loops), through the public functions every version has: the
  forward's direct launch (``short_attention_launch``, no dispatcher),
  the inference operator (``short_attention``), and a training call,
  the forward and backward of ``short_attention_qkv`` with
  ``torch.autograd.grad``.
- ``flash``, ``flash_bwd``: rows 3-6 without a key mask
  (``phase_flash``: the forward at the ragged N = 65 and at the main
  paths' shapes; ``phase_flash_bwd``: the dq, dkdv and dbias kernels).
- ``flash_bits``: one sha256 over the outputs of rows 3-6's unmasked
  and ``n_keys`` calls on fixed inputs (numpy's generator, seed 0), the
  forward's o and lse and the backward's dq, dk, dv and dbias, through
  the public functions every version has: two trees whose digests agree
  give those calls the same bits.
- ``short_bits``, ``roi_bits``: the same for the bf16 forwards of rows 1
  and 7 (``short_attention`` at head dims 32, 64 and 128 with and
  without the lse and a key mask, the shapes of ``SHORT_BITS_CASES``;
  ``roi_align_fwd`` at P = 7 and 14 on a channels-last pyramid with a
  strided fifth level, ``ROI_BITS_CASES``).

Run it by path:

    python3 layoutdit_tpu_torch/tools/kernel_turns.py [--root DIR] [--phases PHASE ...]

One line a short shape, then one JSON object with every number and the
card's name and power limit. Needs a CUDA device; exits without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

# the host timing: calls a loop, loops a shape, and a spin kernel (about
# 0.2 s) that outlasts each loop's issuing
HOST_ITERS = 100
HOST_REPEATS = 5
HOST_SPIN_CYCLES = 400_000_000

# the calls flash_bits fingerprints: (B, N, H, a bias, n_keys); the
# ragged edge with and without a bias, the windows' N = 256 with one, and
# ring attention's valid-key counts
BITS_CASES = ((2, 65, 12, False, None), (2, 65, 12, True, None), (8, 256, 12, True, None),
              (2, 2049, 8, False, 1024), (2, 2049, 8, False, 2048), (2, 300, 4, False, 257))

# the calls short_bits fingerprints: (B, N, H, D, a window key mask); the
# 224 px shape, the recipe's D = 32, D = 128, the CLS token and dit-large's
# 14 x 14 windows at 1024 px with their mask
SHORT_BITS_CASES = ((4, 197, 12, 64, False), (8, 197, 2, 32, False), (4, 197, 6, 128, False),
                    (4, 1, 12, 64, False), (100, 196, 16, 64, True))
# the calls roi_bits fingerprints: (image px, B, K, P)
ROI_BITS_CASES = ((224, 16, 512, 7), (1024, 4, 512, 7), (224, 4, 100, 14))

PHASES = ("short", "flash", "flash_bwd", "flash_bits", "short_bits", "roi_bits")


def _host_ms(torch, fn) -> float:
    """The host's time to issue one call of ``fn``: the median over
    HOST_REPEATS loops of HOST_ITERS calls queued behind a spin kernel.
    Raises if the spin ended before a loop had issued its calls."""
    fn()
    torch.cuda.synchronize()
    loops = []
    for _ in range(HOST_REPEATS):
        spun = torch.cuda.Event()
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        spun.record()
        t0 = time.perf_counter()
        for _ in range(HOST_ITERS):
            fn()
        loops.append((time.perf_counter() - t0) * 1e3 / HOST_ITERS)
        if spun.query():
            raise RuntimeError("kernel_turns: the spin ended before the calls were issued")
        torch.cuda.synchronize()
    return statistics.median(loops)


def host_times(torch, sa, gen, b, n, h=12, d=64, key_mask=None) -> dict:
    """The host's cost of a call at one shape (see the module's notes)."""
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = sa.split_qkv(qkv, h)
    do = torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    qkv.requires_grad_()

    def train():
        o = sa.short_attention_qkv(qkv, h, key_mask=key_mask)
        torch.autograd.grad(o, qkv, do)

    return {
        "host_launch_ms": _host_ms(torch, lambda: sa.short_attention_launch(
            q, k, v, d ** -0.5, key_mask)),
        "host_fwd_ms": _host_ms(torch, lambda: sa.short_attention(q, k, v, key_mask=key_mask)),
        "host_train_ms": _host_ms(torch, train),
    }


def short_rows(torch, cs, sa) -> dict:
    """Rows 1-2 at the main paths' seven shapes, the host's cost of a call
    beside each (the ``short`` phase)."""
    from layoutdit_tpu_torch.models.vit import _window_key_mask

    mask = _window_key_mask(64, 64, 14).cuda()
    shapes = {
        "224px": dict(b=16, n=197),
        "windows": dict(zip("bn", cs.WINDOW_SHAPES["w256"])),
        "cls": dict(zip("bn", cs.WINDOW_SHAPES["n1"])),
        "micro": dict(b=cs.MICRO_BATCH, n=197),
        "large224": dict(b=16, n=197, h=16),
        "large_w14_masked": dict(b=4 * mask.shape[0], n=196, h=16, key_mask=mask),
        "recipe": dict(b=cs.RECIPE["batch"], n=197, h=cs.RECIPE["heads"],
                       d=cs.RECIPE["head_dim"]),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, shape in shapes.items():
        fwd, bwd = cs._short_fwd_case(gen, **shape), cs._short_bwd_case(gen, **shape)
        host = host_times(torch, sa, gen, **shape)
        rows[name] = {"fwd": fwd, "bwd": bwd, **host}
        print(f"{name} {fwd['shape']}: fwd {fwd['ms']:.6g} ms on the card, {fwd['call_ms']:.6g} "
              f"a call (SDPA {fwd['library_ms']:.6g}); bwd {bwd['ms']:.6g}, "
              f"{bwd['call_ms']:.6g} a call (SDPA {bwd['library_ms']:.6g}); host: launch "
              f"{host['host_launch_ms']:.6g}, operator {host['host_fwd_ms']:.6g}, training "
              f"call {host['host_train_ms']:.6g}", flush=True)
        torch.cuda.empty_cache()
    return rows


def flash_bits(torch, fa, sa) -> str:
    """sha256 (hex) of the flash kernels' outputs over BITS_CASES, on the
    card: o and lse, then dq, dk, dv (and dbias with a bias), from inputs
    drawn by numpy (seed 0) and rounded to bf16 on the host."""
    rng = np.random.default_rng(0)
    digest = hashlib.sha256()

    def card(x, dtype=torch.float32):
        return torch.from_numpy(x.astype(np.float32)).to(dtype).cuda()

    for b, n, h, with_bias, nk in BITS_CASES:
        q, k, v = sa.split_qkv(card(rng.standard_normal((b, n, 3 * h * 64)), torch.bfloat16), h)
        do = card(rng.standard_normal((b, n, h, 64)), torch.bfloat16)
        bias = card(0.5 * rng.standard_normal((h, n, n))) if with_bias else None
        o, lse = fa.flash_attention_fwd(q, k, v, bias, None, nk)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, None,
                                       bias_grad=with_bias, n_keys=nk)
        for t in (o, lse, *grads):
            if t is not None:
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def short_bits(torch, sa) -> str:
    """sha256 (hex) of row 1's bf16 outputs over SHORT_BITS_CASES, on the
    card: o, then the training form's o and lse, from inputs drawn by
    numpy (seed 0) and rounded to bf16 on the host."""
    from layoutdit_tpu_torch.models.vit import _window_key_mask

    rng = np.random.default_rng(0)
    digest = hashlib.sha256()
    for b, n, h, d, masked in SHORT_BITS_CASES:
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
        q, k, v = sa.split_qkv(qkv.to(torch.bfloat16).cuda(), h)
        mask = _window_key_mask(64, 64, 14).cuda() if masked else None
        outs = (sa.short_attention(q, k, v, key_mask=mask),
                *sa.short_attention(q, k, v, key_mask=mask, return_lse=True))
        for t in outs:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def roi_bits(torch, ra) -> str:
    """sha256 (hex) of row 7's bf16 outputs over ROI_BITS_CASES, on the
    card, from a pyramid (p2..p5 channels-last, the fifth level the
    strided view p5[..., ::2, ::2]) and RoIs drawn by numpy (seed 0)."""
    rng = np.random.default_rng(0)
    digest = hashlib.sha256()
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
    for image, b, k, p in ROI_BITS_CASES:
        g = image // 16
        feats = [torch.from_numpy(rng.standard_normal((b, 256, s, s)).astype(np.float32))
                 .to(torch.bfloat16).cuda().contiguous(memory_format=torch.channels_last)
                 for s in (4 * g, 2 * g, g, g // 2)]
        feats.append(feats[-1][..., ::2, ::2])
        boxes = rng.uniform(-10, image, (b, k, 4)).astype(np.float32)
        boxes[..., 2:] = boxes[..., :2] + rng.uniform(1.0, image / 2, (b, k, 2))
        rois = torch.from_numpy(boxes).cuda()
        mask = torch.from_numpy(rng.uniform(size=(b, k)) < 0.8).cuda()
        levels = ra.roi_levels(rois, 5, float(image), roi_mask=mask)
        out = ra.roi_align_fwd(feats, rois, levels, scales, p, 2)
        digest.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose kernels and chip_smoke.py cases are run")
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: needs an NVIDIA GPU")
    import chip_smoke as cs
    from layoutdit_tpu_torch.ops import _build
    from layoutdit_tpu_torch.ops import flash_attention as fa
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(tuple(dict.fromkeys(
        {"short": "short_attention", "short_bits": "short_attention",
         "roi_bits": "roi_align"}.get(p, "flash_attention") for p in args.phases)))
    card = cs._card()
    print(f"root {root}: built in {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    out = {"root": str(root), "card": card}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for phase in args.phases:
        if phase == "short":
            out["shapes"] = short_rows(torch, cs, sa)
        elif phase == "flash":
            out["flash"] = cs.phase_flash(gen)
        elif phase == "flash_bwd":
            out["flash_bwd"] = cs.phase_flash_bwd(gen)
        else:
            digest = {"flash_bits": lambda: flash_bits(torch, fa, sa),
                      "short_bits": lambda: short_bits(torch, sa),
                      "roi_bits": lambda: roi_bits(torch, ra)}[phase]()
            out[f"{phase}_sha256"] = digest
            print(f"root {root}: {phase} sha256 {digest}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
