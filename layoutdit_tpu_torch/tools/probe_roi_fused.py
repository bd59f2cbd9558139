"""Run the fused RoIAlign probes (``ops/roi_fused.py``) and time them.

Port of ``main`` of ``scripts/probe_roi_fused.py``: the same inputs
from ``numpy.random.default_rng(0)`` (an atlas f [256, 109, 56] standard
normal in bf16, 0/1 weights wy [K, 7, 109] at rate 0.02 and wx
[K, 7, 56] at 0.04) through the same list: the two-GEMM yardstick, A at
kb 8 and 16, A0 at kb 16 without and with the relayout, E at kb 8. It
prints each one's max |err| against the yardstick (A0, which stops at
t, against its plain version) and, on the card only, its time from CUDA
events over ``--iters`` launches after a warm-up, beside the card's name.

    python -m layoutdit_tpu_torch.tools.probe_roi_fused [--iters 50] [--k 8192]
    python -m layoutdit_tpu_torch.tools.probe_roi_fused --device cpu --k 16 --iters 1

``--device cuda`` (the default) exits non-zero without a GPU; on the CPU
it checks and prints no time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from layoutdit_tpu_torch.ops import roi_fused as rf

C, H, W = 256, 109, 56


def probe_inputs(k: int, device: str = "cuda"):
    """(f [C, H, W] bf16, wy [K, 7, H], wx [K, 7, W] fp32 0/1) as the probe
    makes them."""
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal((C, H, W))).to(device, torch.bfloat16)
    wy = torch.from_numpy(rng.random((k, rf.P, H)) < 0.02).to(device, torch.float32)
    wx = torch.from_numpy(rng.random((k, rf.P, W)) < 0.04).to(device, torch.float32)
    return f, wy, wx


def time_ms(fn, iters: int) -> float:
    """CUDA-event time of one call, over ``iters`` calls after a warm-up."""
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("probe_roi_fused: no CUDA device (--device cpu checks on the CPU)")

    f, wy, wx = probe_inputs(args.k, args.device)
    where = torch.cuda.get_device_name(0) if on_card else "cpu (no times)"
    print(f"device: {where}  K={args.k}")

    def run(name, fn):
        out = fn()
        if on_card:
            print(f"{name:38s} {time_ms(fn, args.iters):9.4f} ms")
        else:
            print(name)
        return out

    def compare(name, out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        print(f"    {name} max|err| = {err:.5f}")

    ref = run("two-GEMM yardstick (two_gemm)", lambda: rf.two_gemm(f, wy, wx))
    for kb in (8, 16):
        out = run(f"A: fused kb={kb}", lambda kb=kb: rf.variant_a(f, wy, wx, kb=kb))
        compare(f"A kb={kb} vs two_gemm", out, ref)
    for relayout, label in ((False, "no relayout"), (True, "relayout")):
        out = run(f"A0: first product only, {label}",
                  lambda r=relayout: rf.variant_a0(f, wy, kb=16, relayout=r))
        compare(f"A0 kb=16 {label} vs its plain version", out,
                rf.variant_a0_plain(f, wy, relayout))
        del out
    out = run("E: fused, channel-major kb=8", lambda: rf.variant_e(f, wy, wx, kb=8))
    compare("E kb=8 vs two_gemm", out, ref)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
