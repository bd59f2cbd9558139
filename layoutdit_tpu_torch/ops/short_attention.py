"""Short-sequence fused attention: CUDA kernel and its plain version.

Port of ``layoutdit_tpu/ops/short_attention.py`` (forward only). The
kernel (``csrc/short_attention.cu``) replaces the Pallas
``_fwd_kernel``/``_short_fwd``: one head's whole sequence (N <= 256)
in one tile, fp32 scores and a single-pass softmax, bf16 out. It is
bound by bytes on the H100 (microseconds of data, a trivial FLOP count)
and reads Q/K/V in place from the fused QKV projection's
[B, N, H, D] strides; see the source for the design.

``short_attention`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from layoutdit_tpu_torch.ops import _build

MAX_N = 256
MAX_D = 128

_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_void_p]
)


def short_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, N, H, D], fp32 math, out in
    q.dtype (the function of the Pallas kernel, without its padding)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("short_attention")
    fn = lib.short_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def short_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Fused short-sequence attention; [B, N, H, D] in and out (bf16 on
    the card, any float type on the CPU)."""
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention: unsupported device {q.device}")
    b, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(
                f"short_attention: {name} must be bf16 {tuple(q.shape)} on "
                f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.stride(3) != 1:
            raise ValueError(f"short_attention: {name} needs a contiguous last dim")
    if n > MAX_N or d > MAX_D or d % 2:
        raise ValueError(
            f"short_attention: N={n} D={d} outside the kernel's range "
            f"(N <= {MAX_N}, even D <= {MAX_D})"
        )
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    code = lib.short_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, code, "short_attention")
    short_attention.launches += 1
    return o


short_attention.launches = 0
