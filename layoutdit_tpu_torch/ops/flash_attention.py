"""Blockwise flash attention, forward and backward: CUDA kernels and their
plain versions.

Port of ``layoutdit_tpu/ops/flash_attention.py``. The kernels
(``csrc/flash_attention.cu``) replace the Pallas ``_fwd_kernel`` (:64)
and ``_fwd_kernel_nobias`` (:180, via ``_flash_fwd`` :112): online
softmax over 64-key tiles with an optional additive bias [H, N, N], the
ragged edge masked in the kernel, o and a per-row lse [B*H, N] out;
``_bwd_dq_kernel`` / ``_bwd_dq_nobias`` (:253, :286) and
``_bwd_dkdv_kernel`` / ``_bwd_dkdv_nobias`` (:217, :280, via
``_flash_bwd`` :317): dQ sweeping the key tiles, dK and dV sweeping the
query tiles, P recomputed from lse, no atomics; and ``_dbias_kernel``
(:292): dbias = sum over the batch of dS, a block of 128 query rows
sweeping its key tiles and, inside each, the batch in order, no atomics.
The plain backward has the algebra of the oracle ``_bwd_reference``
(:460). All four kernels have one Hopper shape: two consumer
warpgroups run every product on the tensor cores as ``wgmma`` (bf16 in,
fp32 accumulate), fed by a producer warpgroup that streams the tiles by
TMA, and the fp32 bias, lse and delta rows by bulk copy, through a ring
of three or four stages of shared memory guarded by mbarriers
(``csrc/hopper_mma.cuh``). The forward, dq and dkdv kernels are bound by
operations on the H100, the dbias kernel by the bytes of the bias and
its gradient. See the source for the design.

``flash_attention_fwd`` and ``flash_attention_bwd`` launch the kernels
for CUDA tensors (through ``flash_attention_fwd_launch`` and the three
backward launchers, which check what the kernels read) and take the
plain versions only for CPU tensors.
``flash_attention_qkv`` is the differentiable entry point: a
``torch.autograd.Function`` from the fused projection [B, N, 3*H*D] and
the bias to the context [B, N, H, D], whose backward writes dq, dk and
dv straight into one [B, N, 3*H*D] gradient and, when the bias requires
a gradient, launches the dbias kernel; ``flash_attention`` is the same
over separate q, k, v.
"""

from __future__ import annotations

import ctypes
import math

import torch

from layoutdit_tpu_torch.ops import _build
from layoutdit_tpu_torch.ops.short_attention import split_qkv

HEAD_DIM = 64  # dit-base; the kernels are compiled for this width only

_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)
_DBIAS_ARGTYPES = _BWD_ARGTYPES[1:]  # one pointer fewer


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, bias, scale) -> torch.Tensor:
    """[B, H, N, N] fp32 scores q k^T * scale (+ bias)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    return s if bias is None else s + bias.float()[None]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale + bias) v over [B, N, H, D] with fp32 math
    -> (o [B, N, H, D] in q.dtype, lse [B*H, N] fp32)."""
    b, n, h, _ = q.shape
    s = _scores(q, k, bias, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)
    return o, lse.reshape(b * h, n)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(dq, dk, dv, dbias): dq, dk, dv over [B, N, H, D] in fp32 math, out
    in q.dtype, and dbias = sum_b dS, fp32 [H, N, N] (None without a
    bias): the algebra of the Pallas backward (and of its oracle
    ``_bwd_reference``), P = exp(q k^T * scale + bias - lse),
    D = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - D),
    dQ = dS K s, dK = dS^T Q s."""
    b, n, h, _ = q.shape
    scale = _scale(q, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(_scores(q, k, bias, scale) - lse.float().reshape(b, h, n, 1))
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, N, 1]
    ds = p * (dp - delta)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    dbias = None if bias is None else ds.sum(0)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
        for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkdv):
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
        lib.flash_attention_bwd_dbias.argtypes = _DBIAS_ARGTYPES
        lib.flash_attention_bwd_dbias.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check_rows(what: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """bf16 [B, N, H, D] like ``ref`` on its device, rows contiguous and
    16-byte aligned (as the fused QKV projection's slices are)."""
    d = ref.shape[-1]
    if d != HEAD_DIM:
        raise ValueError(f"{what}: head dim {d}, the kernels take {HEAD_DIM}")
    for name, t in tensors.items():
        if t.shape != ref.shape or t.dtype != torch.bfloat16 or t.device != ref.device:
            raise ValueError(
                f"{what}: {name} must be bf16 {tuple(ref.shape)} on "
                f"{ref.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{what}: {name} rows must be contiguous and 16-byte aligned")


def _check_bias(what: str, bias: torch.Tensor | None, ref: torch.Tensor):
    """The bias as the kernels read it: fp32 [H, N, N] contiguous, or None."""
    if bias is None:
        return None
    _, n, h, _ = ref.shape
    if bias.shape != (h, n, n) or bias.device != ref.device:
        raise ValueError(f"{what}: bias must be [{h}, {n}, {n}] on {ref.device}")
    return bias.float().contiguous()


def _check_square(what: str, ref: torch.Tensor, **tensors: torch.Tensor | None) -> None:
    """fp32 [H, N, N] contiguous on ``ref``'s device, as the kernels read
    a bias and write its gradient (None passes: no bias)."""
    _, n, h, _ = ref.shape
    for name, t in tensors.items():
        if t is not None and (t.shape != (h, n, n) or t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != ref.device):
            raise ValueError(f"{what}: {name} must be contiguous fp32 [{h}, {n}, {n}] "
                             f"on {ref.device}")


def _check_lse(what: str, t: torch.Tensor, ref: torch.Tensor, name: str) -> None:
    b, n, h, _ = ref.shape
    if t.shape != (b * h, n) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous fp32 [{b * h}, {n}]")


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(tensors)))(*[s for t in tensors for s in t.stride()[:3]])


def flash_attention_fwd_launch(q, k, v, bias, scale, o, lse) -> None:
    """Launch the forward kernel of ``flash_attention_fwd``: writes o
    (bf16 [B, N, H, D]) and lse (fp32 [B*H, N]). q, k, v and o bf16 rows
    that TMA can read (as ``flash_attention_bwd`` checks them); bias fp32
    [H, N, N] contiguous or None. Counts on ``flash_attention_fwd``."""
    b, n, h, d = q.shape
    _check_rows("flash_attention", q, q=q, k=k, v=v, o=o)
    _check_lse("flash_attention", lse, q, "lse")
    _check_square("flash_attention", q, bias=bias)
    lib = _lib()
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, n, h, d, _strides(q, k, v, o), float(scale),
        _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention")
    flash_attention_fwd.launches += 1


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (o [B, N, H, D], lse [B*H, N] fp32). bf16 q/k/v on the card
    (rows 16-byte aligned, as the fused QKV projection's slices are);
    any float type on the CPU. Not differentiable by itself on the card:
    ``flash_attention`` and ``flash_attention_qkv`` are."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    flash_attention_fwd_launch(q, k, v, _check_bias("flash_attention", bias, q), _scale(q, scale),
                               o, lse)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, o, lse, do, bias, scale, dq, delta) -> None:
    """Launch the dq kernel of ``flash_attention_bwd``: writes dq (bf16
    [B, N, H, D], any row strides) and delta = rowsum(dO o O) (fp32
    [B*H, N], read by ``flash_attention_bwd_dkdv``). CUDA tensors as
    ``flash_attention_bwd`` checks them; bias fp32 [H, N, N] or None."""
    b, n, h, d = q.shape
    _check_rows("flash_attention_bwd", q, q=q, k=k, v=v, o=o, do=do, dq=dq)
    _check_lse("flash_attention_bwd", lse, q, "lse")
    _check_lse("flash_attention_bwd", delta, q, "delta")
    _check_square("flash_attention_bwd", q, bias=bias)
    lib = _lib()
    code = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if bias is None else bias.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, n, h, d, _strides(q, k, v, o, do, dq), float(scale),
        _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkdv(q, k, v, lse, do, delta, bias, scale, dk, dv) -> None:
    """Launch the dkdv kernel of ``flash_attention_bwd`` after the dq
    kernel (it reads that kernel's delta): writes dk and dv."""
    b, n, h, d = q.shape
    _check_rows("flash_attention_bwd", q, q=q, k=k, v=v, do=do, dk=dk, dv=dv)
    _check_lse("flash_attention_bwd", lse, q, "lse")
    _check_lse("flash_attention_bwd", delta, q, "delta")
    _check_square("flash_attention_bwd", q, bias=bias)
    lib = _lib()
    code = lib.flash_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if bias is None else bias.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, n, h, d, _strides(q, k, v, do, dk, dv), float(scale),
        _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1


flash_attention_bwd_dkdv.launches = 0


def flash_attention_bwd_dbias(q, k, v, lse, do, delta, bias, scale, dbias) -> None:
    """Launch the dbias kernel of ``flash_attention_bwd`` after the dq
    kernel (it reads that kernel's delta): writes dbias = sum_b dS into
    ``dbias``, contiguous fp32 [H, N, N]; bias fp32 [H, N, N]."""
    b, n, h, d = q.shape
    _check_rows("flash_attention_bwd", q, q=q, k=k, v=v, do=do)
    _check_lse("flash_attention_bwd", lse, q, "lse")
    _check_lse("flash_attention_bwd", delta, q, "delta")
    if bias is None:
        raise ValueError("flash_attention_bwd: the dbias kernel needs a bias")
    _check_square("flash_attention_bwd", q, bias=bias, dbias=dbias)
    lib = _lib()
    code = lib.flash_attention_bwd_dbias(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias.data_ptr(), dbias.data_ptr(), b, n, h, d,
        _strides(q, k, v, do), float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention_bwd_dbias")
    flash_attention_bwd_dbias.launches += 1


flash_attention_bwd_dbias.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
    out: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    bias_grad: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(dq, dk, dv, dbias) of flash attention: [B, N, H, D] each, from
    the forward's o and lse [B*H, N], and, with ``bias_grad``, the bias's
    gradient sum_b dS as fp32 [H, N, N] (else None). On the card ``out``
    may name three bf16 [B, N, H, D] views to write into (the slices of a
    fused QKV gradient); they are returned."""
    if bias_grad and bias is None:
        raise ValueError("flash_attention_bwd: bias_grad needs a bias")
    if q.device.type == "cpu":
        *grads, dbias = flash_attention_bwd_plain(q, k, v, o, lse, do, bias, scale)
        if out is not None:
            for dst, src in zip(out, grads):
                dst.copy_(src)
            grads = out
        return (*grads, dbias if bias_grad else None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    b, n, h, d = q.shape
    scale = _scale(q, scale)
    bias = _check_bias("flash_attention_bwd", bias, q)
    if out is None:
        out = tuple(torch.empty((b, n, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    dq, dk, dv = out
    delta = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    flash_attention_bwd_dq(q, k, v, o, lse, do, bias, scale, dq, delta)
    flash_attention_bwd_dkdv(q, k, v, lse, do, delta, bias, scale, dk, dv)
    dbias = None
    if bias_grad:
        dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
        flash_attention_bwd_dbias(q, k, v, lse, do, delta, bias, scale, dbias)
    return (*out, dbias)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        o, lse = flash_attention_fwd(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do.contiguous(), bias, ctx.scale,
                                     bias_grad=ctx.needs_input_grad[3]), None)


class _FlashAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale, bias):
        o, lse = flash_attention_fwd(*split_qkv(qkv, heads), bias, scale)
        ctx.save_for_backward(qkv, o, lse, bias)
        ctx.heads, ctx.scale = heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, bias = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        *_, dbias = flash_attention_bwd(
            *split_qkv(qkv, ctx.heads), o, lse, do.contiguous(), bias, ctx.scale,
            out=tuple(split_qkv(dqkv, ctx.heads)), bias_grad=ctx.needs_input_grad[3],
        )
        return dqkv, None, None, dbias


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused attention; [B, N, H, D] in and out, optional additive bias
    [H, N, N] shared by the batch. Differentiable in q, k, v and the
    bias."""
    return _FlashAttention.apply(q, k, v, bias, _scale(q, scale))


def flash_attention_qkv(
    qkv: torch.Tensor,
    heads: int,
    scale: float | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Differentiable flash attention from the fused projection
    [B, N, 3*H*D] (rows [q | k | v]) to the context [B, N, H, D];
    optional additive bias [H, N, N] shared by the batch, differentiable
    too."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * heads))
    return _FlashAttentionQKV.apply(qkv, heads, scale, bias)
