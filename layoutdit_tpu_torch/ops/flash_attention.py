"""Blockwise flash attention forward: CUDA kernel and its plain version.

Port of ``layoutdit_tpu/ops/flash_attention.py`` (forward only). The
kernel (``csrc/flash_attention.cu``) replaces the Pallas ``_fwd_kernel``
and ``_fwd_kernel_nobias`` (via ``_flash_fwd``): online softmax over
64-key tiles with an optional additive bias [H, N, N], the ragged edge
masked in the kernel, o and a per-row lse [B*H, N] out. It is bound by
operations on the H100 (4*B*H*N^2*D FLOPs against O(N*D) bytes), so
both products run on the tensor cores (mma.sync, bf16 in, fp32
accumulate) with the online softmax in registers; see the source for
the design.

``flash_attention`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from layoutdit_tpu_torch.ops import _build

HEAD_DIM = 64  # dit-base; the kernel is compiled for this width only

_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_void_p]
)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale + bias) v over [B, N, H, D] with fp32 math
    -> (o [B, N, H, D] in q.dtype, lse [B*H, N] fp32)."""
    b, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[None]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)
    return o, lse.reshape(b * h, n)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (o [B, N, H, D], lse [B*H, N] fp32). bf16 q/k/v on the card
    (rows 16-byte aligned, as the fused QKV projection's slices are);
    any float type on the CPU. Forward only: the flash backward is not
    ported, so inputs that require a gradient raise on every device."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    ):
        raise NotImplementedError(
            "flash_attention: the backward kernel is not ported yet; it runs "
            "forward only (under torch.no_grad or inference_mode)"
        )
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d}, the kernel takes {HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} must be bf16 {tuple(q.shape)} on "
                f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention: {name} rows must be contiguous and 16-byte aligned"
            )
    if bias is not None:
        if bias.shape != (h, n, n) or bias.device != q.device:
            raise ValueError(
                f"flash_attention: bias must be [{h}, {n}, {n}] on {q.device}"
            )
        bias = bias.float().contiguous()
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    lib = _lib()
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, n, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused attention; [B, N, H, D] in and out, optional additive bias
    [H, N, N]."""
    return flash_attention_fwd(q, k, v, bias, scale)[0]
