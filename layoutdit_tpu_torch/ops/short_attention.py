"""Short-sequence fused attention: CUDA kernels and their plain versions.

Port of ``layoutdit_tpu/ops/short_attention.py``. The kernels
(``csrc/short_attention.cu``) replace the Pallas ``_fwd_kernel``
(``_short_fwd``) and ``_bwd_kernel`` (``_short_bwd``): one head's whole
sequence (N <= 256) in one block, fp32 scores and a single-pass softmax,
bf16 out; the backward recomputes P from q and k and emits dq, dk and dv
with no N x N tensor in device memory. Both are bound by bytes on the
H100 and read Q/K/V in place from the fused QKV projection's [B, N, H, D]
strides; see the source for the design.

``short_attention`` and ``short_attention_bwd`` launch the kernels for
CUDA tensors and take the plain versions only for CPU tensors.
``short_attention_qkv`` is the differentiable entry point: a
``torch.autograd.Function`` from the fused projection [B, N, 3*H*D] to
the context [B, N, H, D], whose backward writes dq, dk and dv straight
into one [B, N, 3*H*D] gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from layoutdit_tpu_torch.ops import _build

MAX_N = 256
MAX_D = 128
# shared memory a block may use on Hopper (dynamic, after opt-in)
MAX_SMEM = 232448

_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)


def short_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, N, H, D], fp32 math, out in
    q.dtype (the function of the Pallas kernel, without its padding).
    ``key_mask`` [B, N] bool drops the False keys from every row, as the
    JAX encoder's XLA path does for padded window slots (-inf scores)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def short_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) over [B, N, H, D] in fp32 math, out in q.dtype: the
    Pallas ``_bwd_kernel`` algebra, dV = P^T dO,
    dS = P o (dO V^T - rowsum(dO o O)), dQ = dS K s, dK = dS^T Q s."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, N, 1]
    ds = p * (dp - delta)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("short_attention")
    if lib.short_attention_fwd.argtypes is None:
        lib.short_attention_fwd.argtypes = _ARGTYPES
        lib.short_attention_fwd.restype = ctypes.c_int
        lib.short_attention_bwd.argtypes = _BWD_ARGTYPES
        lib.short_attention_bwd.restype = ctypes.c_int
        lib.short_attention_bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.short_attention_bwd_smem.restype = ctypes.c_longlong
    return lib


def _check_heads(what: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.shape != ref.shape or t.dtype != torch.bfloat16 or t.device != ref.device:
            raise ValueError(
                f"{what}: {name} must be bf16 {tuple(ref.shape)} on "
                f"{ref.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.stride(3) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    _, n, _, d = ref.shape
    if n > MAX_N or d > MAX_D or d % 2:
        raise ValueError(
            f"{what}: N={n} D={d} outside the kernel's range "
            f"(N <= {MAX_N}, even D <= {MAX_D})"
        )


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
    _check_heads("short_attention", q, q=q, k=k, v=v)
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


def short_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
    out: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of short attention; [B, N, H, D] each. On the card
    ``out`` may name three bf16 [B, N, H, D] views to write into (the
    slices of a fused QKV gradient); they are returned."""
    if q.device.type == "cpu":
        grads = short_attention_bwd_plain(q, k, v, o, do, scale)
        if out is None:
            return grads
        for dst, src in zip(out, grads):
            dst.copy_(src)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"short_attention_bwd: unsupported device {q.device}")
    b, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if out is None:
        out = tuple(torch.empty((b, n, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    dq, dk, dv = out
    _check_heads("short_attention_bwd", q, q=q, k=k, v=v, o=o, do=do, dq=dq, dk=dk, dv=dv)
    lib = _lib()
    smem = lib.short_attention_bwd_smem(n, d)
    if smem > MAX_SMEM:
        raise ValueError(
            f"short_attention_bwd: N={n} D={d} needs {smem} bytes of shared "
            f"memory, more than a block may use ({MAX_SMEM})"
        )
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    )
    code = lib.short_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h, d, strides,
        float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, code, "short_attention_bwd")
    short_attention_bwd.launches += 1
    return out


short_attention_bwd.launches = 0


def split_qkv(qkv: torch.Tensor, heads: int) -> list[torch.Tensor]:
    """[B, N, 3*H*D] fused projection -> q, k, v as [B, N, H, D] views."""
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    return [qkv[..., i * hd:(i + 1) * hd].view(b, n, heads, hd // heads) for i in range(3)]


class _ShortAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale):
        q, k, v = split_qkv(qkv, heads)
        o = short_attention(q, k, v, scale)
        ctx.save_for_backward(qkv, o)
        ctx.heads, ctx.scale = heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        short_attention_bwd(
            *split_qkv(qkv, ctx.heads), o, do.contiguous(), ctx.scale,
            out=tuple(split_qkv(dqkv, ctx.heads)),
        )
        return dqkv, None, None


def short_attention_qkv(qkv: torch.Tensor, heads: int, scale: float | None = None) -> torch.Tensor:
    """Differentiable short attention from the fused projection
    [B, N, 3*H*D] (rows [q | k | v]) to the context [B, N, H, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * heads))
    return _ShortAttentionQKV.apply(qkv, heads, scale)
