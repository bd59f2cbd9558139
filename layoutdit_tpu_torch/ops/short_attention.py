"""Short-sequence fused attention: CUDA kernels and their plain versions.

Port of ``layoutdit_tpu/ops/short_attention.py``. The kernels
(``csrc/short_attention.cu``) replace the Pallas ``_fwd_kernel``
(``_short_fwd``) and ``_bwd_kernel`` (``_short_bwd``) on the tensor cores
(bf16 in, fp32 accumulate), with no N x N tensor in device memory and no
atomics. At head dim 64, every preset's, they are warp-specialised Hopper
kernels: a persistent grid whose producer loads each head's resident
tensors (N <= 256) and each 128-row unit's tiles by TMA, and whose two
consumer warpgroups run every product as ``wgmma``: the forward (o, and
on request the row's log-sum-exp lse [B, H, N], natural log), then for
the backward a dq kernel (which also writes delta = rowsum(dO o O)) and a
dkdv kernel, both reading the forward's lse. At head dims 32 and 128 the
``mma.sync`` kernels of the first port run instead, chosen by the head
dim (the Hopper kernels' tiles are one 128-byte swizzle row). All are
bound by bytes on the H100 and read Q/K/V in place from the fused QKV
projection's [B, N, H, D] strides; see the source for the design. Both
directions take an optional key mask [rows, N] (bool or uint8, row
b % rows for batch b, as the JAX encoder tiles its window mask over the
pages): the keys it holds False drop out of every softmax row (padded
window slots, ``pad_tokens_to``'s padding), in the kernels and in the
plain versions alike.

``short_attention`` and ``short_attention_bwd`` launch the kernels for
CUDA tensors, through the registered operators
``layoutdit_torch::short_attention`` (inference: o only, the schema the
exported programs hold), ``::short_attention_lse`` (training: o and lse)
and ``::short_attention_bwd`` (``ops/_library.py``; a traced program
names them, and their CUDA implementations count the launches: one for
a forward, one for a backward, whose D = 64 form is two kernels), and
take the plain versions only for CPU tensors. Float32 tensors (a float32
compute dtype) take the forward's float32 form, an FFMA kernel shared with
the flash forward (``csrc/attention_f32.cuh``, N <= 256, D 32, 64 or 128,
the key mask and the lse as in bf16), counted apart too
(``short_attention.f32_launches``, a part of its launches); the backward
takes bf16 only and refuses a float32 tensor with a message (float32
training on the card waits for its fp32 kernels). ``short_attention_launch``
and ``short_attention_bwd_launch`` are the direct launches, without the
dispatcher (the first for timing the operator's host cost).
``short_attention_qkv`` is the differentiable entry point: a
``torch.autograd.Function`` from the fused projection [B, N, 3*H*D] to
the context [B, N, H, D], whose forward keeps the lse and whose backward
writes dq, dk and dv straight into one [B, N, 3*H*D] gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from layoutdit_tpu_torch.ops import _build, _library

MAX_N = 256
HEAD_DIMS = (32, 64, 128)  # the kernels are compiled for these widths

# q, k, v, o, lse, mask; mask_rows, B, N, H, D; the strides; scale, stream
_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)
# q, k, v, o, dout, lse, delta, dq, dk, dv, mask; then as the forward
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)


def key_mask_rows(key_mask: torch.Tensor, batch: int) -> torch.Tensor:
    """A key mask [rows, N] as one bool row per batch element [B, N]: row
    b % rows for element b (the JAX encoder tiles its window mask over the
    pages)."""
    return key_mask.bool()[torch.arange(batch, device=key_mask.device) % key_mask.shape[0]]


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            key_mask: torch.Tensor | None) -> torch.Tensor:
    """q k^T * scale [B, H, N, N] in fp32, the keys ``key_mask`` holds
    False for at -inf, as the JAX encoder's XLA path masks them
    (``vit.py:552``)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask_rows(key_mask, q.shape[0])[:, None, None, :], float("-inf"))
    return s


def short_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    key_mask: torch.Tensor | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v over [B, N, H, D], fp32 math, out in
    q.dtype (the function of the Pallas kernel, without its padding),
    the keys ``key_mask`` [rows, N] holds False for dropped from every
    row. With ``return_lse`` also the rows' log-sum-exp of the scaled
    scores, fp32 [B, H, N] (natural log), as the kernels write it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale, key_mask)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def short_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
    key_mask: torch.Tensor | None = None,
    lse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) over [B, N, H, D] in fp32 math, out in q.dtype: the
    Pallas ``_bwd_kernel`` algebra, dV = P^T dO,
    dS = P o (dO V^T - rowsum(dO o O)), dQ = dS K s, dK = dS^T Q s, with
    P as ``short_attention_plain`` masks it (a dropped key's dk and dv
    rows are 0). Given the forward's ``lse`` [B, H, N], P = exp(S - lse),
    as the kernels form it; else the softmax of S."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = _scores(q, k, scale, key_mask)
    p = torch.softmax(s, dim=-1) if lse is None else torch.exp(s - lse.float()[..., None])
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
        for fn in (lib.short_attention_fwd, lib.short_attention_fwd_f32):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.short_attention_bwd.argtypes = _BWD_ARGTYPES
        lib.short_attention_bwd.restype = ctypes.c_int
        lib.short_attention_smem_bytes.argtypes = [ctypes.c_int]
        lib.short_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check_heads(what: str, ref: torch.Tensor, **tensors: torch.Tensor) -> tuple[list, list]:
    """Check that each tensor is [B, N, H, D] in ``ref``'s dtype, bf16 or
    fp32, like ``ref`` on its device with contiguous rows, a
    16-byte-aligned base and B, N, H strides that are multiples of 16
    bytes, 8 bf16 or 4 fp32 elements (as the fused QKV projection's slices
    are: TMA's tensor maps need them at D = 64, cp.async's 16-byte copies
    at D = 32 and 128, the float32 kernel's float4 loads at any D) and
    that N and D are in the kernels' range -> the tensors' data pointers
    and their B, N, H element strides, in order."""
    shape, dev = ref.shape, ref.device
    _, n, _, d = shape
    if n > MAX_N or d not in HEAD_DIMS:
        raise ValueError(
            f"{what}: N={n} D={d} outside the kernels' range "
            f"(N <= {MAX_N}, head dim one of {HEAD_DIMS})"
        )
    dtype = _library.kernel_dtype(ref)
    type_name, vec = _library.KERNEL_DTYPES[dtype]
    ptrs, strides = [], []
    for name, t in tensors.items():
        if t.shape != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(
                f"{what}: {name} must be {type_name} {tuple(shape)} on "
                f"{dev} (the kernels take bf16 or fp32, all alike), got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
        sb, sn, sh, sd = t.stride()
        ptr = t.data_ptr()
        if sd != 1 or ptr % 16 or sb % vec or sn % vec or sh % vec:
            raise ValueError(f"{what}: {name} rows must be contiguous and 16-byte aligned")
        ptrs.append(ptr)
        strides += (sb, sn, sh)
    return ptrs, strides


def _check_lse(what: str, ref: torch.Tensor, name: str, t: torch.Tensor) -> int:
    """-> the data pointer of ``t``, which must be fp32 [B, H, N]
    contiguous on ``ref``'s device (the forward's lse)."""
    b, n, h, _ = ref.shape
    if (t is None or t.shape != (b, h, n) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != ref.device):
        got = "None" if t is None else f"{t.dtype} {tuple(t.shape)} on {t.device}"
        raise ValueError(f"{what}: {name} must be contiguous fp32 [{b}, {h}, {n}] on "
                         f"{ref.device}, got {got}")
    return t.data_ptr()


def _check_mask(what: str, ref: torch.Tensor, key_mask: torch.Tensor | None) -> tuple[int, int]:
    """-> (data pointer, rows) of a key mask for the kernels, (0, 0)
    without one: bool or uint8 [rows, N], contiguous, on ``ref``'s device."""
    if key_mask is None:
        return 0, 0
    n = ref.shape[1]
    if (key_mask.dtype not in (torch.bool, torch.uint8) or key_mask.dim() != 2
            or key_mask.shape[0] < 1 or key_mask.shape[1] != n
            or key_mask.device != ref.device or not key_mask.is_contiguous()):
        raise ValueError(
            f"{what}: key_mask must be a contiguous bool or uint8 [rows, {n}] tensor on "
            f"{ref.device}, got {key_mask.dtype} {tuple(key_mask.shape)} on {key_mask.device}"
        )
    return key_mask.data_ptr(), key_mask.shape[0]


def short_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           key_mask: torch.Tensor | None, with_lse: bool = False):
    """The direct launch of the forward kernel on CUDA tensors (bf16, or
    fp32: the float32 form): checks, allocates o (and with ``with_lse`` the
    lse, fp32 [B, H, N]), launches -> o, or (o, lse); counts nothing (the
    operators count)."""
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    ptrs, strides = _check_heads("short_attention", q, q=q, k=k, v=v, o=o)
    mask = _check_mask("short_attention", q, key_mask)
    lib = _lib()
    fwd = lib.short_attention_fwd_f32 if q.dtype == torch.float32 else lib.short_attention_fwd
    code = fwd(
        *ptrs, None if lse is None else lse.data_ptr(), *mask, b, n, h, d,
        (ctypes.c_longlong * 12)(*strides), float(scale), _build.stream_ptr(q)
    )
    _build.check(lib, code, "short_attention")
    return (o, lse) if with_lse else o


def _count_fwd(q, key_mask) -> None:
    short_attention.launches += 1
    short_attention.masked_launches += key_mask is not None
    short_attention.f32_launches += q.dtype == torch.float32


def _fwd_cuda(q, k, v, scale, key_mask):
    o = short_attention_launch(q, k, v, scale, key_mask)
    _count_fwd(q, key_mask)
    return o


def _fwd_lse_cuda(q, k, v, scale, key_mask):
    o, lse = short_attention_launch(q, k, v, scale, key_mask, with_lse=True)
    _count_fwd(q, key_mask)
    return o, lse


_fwd_op = _library.define(
    "short_attention(Tensor q, Tensor k, Tensor v, float scale, Tensor? key_mask) -> Tensor",
    fake=lambda q, k, v, scale, key_mask: q.new_empty(q.shape),
    cuda=_fwd_cuda,
)
_fwd_lse_op = _library.define(
    "short_attention_lse(Tensor q, Tensor k, Tensor v, float scale, Tensor? key_mask) "
    "-> (Tensor, Tensor)",
    fake=lambda q, k, v, scale, key_mask: (
        q.new_empty(q.shape),
        q.new_empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)),
    cuda=_fwd_lse_cuda,
)


def short_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
    key_mask: torch.Tensor | None = None, return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Fused short-sequence attention; [B, N, H, D] in and out (bf16 or
    fp32 on the card, any float type on the CPU); ``key_mask`` [rows, N] drops
    the keys it holds False for (row b % rows for batch b). With
    ``return_lse`` -> (o, lse [B, H, N] fp32), the lse the backward reads.
    On the card through the operator ``layoutdit_torch::short_attention``
    (``::short_attention_lse`` with the lse)."""
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, scale, key_mask, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention: unsupported device {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if return_lse:
        return _fwd_lse_op(q, k, v, float(scale), key_mask)
    return _fwd_op(q, k, v, float(scale), key_mask)


# launches of the kernel, and of them those with a key mask and those of
# the float32 form
short_attention.launches = 0
short_attention.masked_launches = 0
short_attention.f32_launches = 0


def short_attention_bwd_launch(q, k, v, o, dout, lse, scale, key_mask, dq, dk, dv) -> None:
    """The direct launch of the backward on CUDA tensors (at D = 64 the dq
    kernel, then the dkdv kernel, with a delta buffer allocated here):
    checks (bf16 only: a float32 tensor is refused with
    ``_library.FLOAT32_TRAINING``), launches; counts nothing (the operator
    counts)."""
    b, n, h, d = q.shape
    _library.refuse_float32_backward("short_attention_bwd", q)
    ptrs, strides = _check_heads(
        "short_attention_bwd", q, q=q, k=k, v=v, o=o, do=dout, dq=dq, dk=dk, dv=dv
    )
    lse_ptr = _check_lse("short_attention_bwd", q, "lse", lse)
    mask = _check_mask("short_attention_bwd", q, key_mask)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = _lib()
    code = lib.short_attention_bwd(
        *ptrs[:5], lse_ptr, delta.data_ptr(), *ptrs[5:], *mask, b, n, h, d,
        (ctypes.c_longlong * 24)(*strides), float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, code, "short_attention_bwd")


def _bwd_cuda(q, k, v, o, dout, lse, scale, key_mask, dq, dk, dv):
    short_attention_bwd_launch(q, k, v, o, dout, lse, scale, key_mask, dq, dk, dv)
    short_attention_bwd.launches += 1
    short_attention_bwd.masked_launches += key_mask is not None


_bwd_op = _library.define(
    "short_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor dout, Tensor lse, "
    "float scale, Tensor? key_mask, Tensor(a!) dq, Tensor(b!) dk, Tensor(c!) dv) -> ()",
    fake=lambda *args: None,
    cuda=_bwd_cuda,
)


def short_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
    out: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    key_mask: torch.Tensor | None = None,
    lse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of short attention; [B, N, H, D] each. On the card
    (bf16 only: a float32 tensor raises ``_library.FLOAT32_TRAINING``)
    ``out`` may name three bf16 [B, N, H, D] views to write into (the
    slices of a fused QKV gradient); they are returned. ``key_mask``: as
    for ``short_attention``. ``lse``: the forward's, fp32 [B, H, N]
    (``short_attention(..., return_lse=True)``); the kernels read it, so
    on the card it is required. On the card through the operator
    ``layoutdit_torch::short_attention_bwd``, which writes ``out``."""
    if q.device.type == "cpu":
        grads = short_attention_bwd_plain(q, k, v, o, do, scale, key_mask, lse)
        if out is None:
            return grads
        for dst, src in zip(out, grads):
            dst.copy_(src)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"short_attention_bwd: unsupported device {q.device}")
    if lse is None:
        raise ValueError("short_attention_bwd: the kernels read the forward's lse; pass "
                         "lse from short_attention(..., return_lse=True)")
    b, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if out is None:
        out = tuple(torch.empty((b, n, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    _bwd_op(q, k, v, o, do, lse, float(scale), key_mask, *out)
    return out


short_attention_bwd.launches = 0
short_attention_bwd.masked_launches = 0


def split_qkv(qkv: torch.Tensor, heads: int) -> list[torch.Tensor]:
    """[B, N, 3*H*D] fused projection -> q, k, v as [B, N, H, D] views."""
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    return [qkv[..., i * hd:(i + 1) * hd].view(b, n, heads, hd // heads) for i in range(3)]


class _ShortAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale, key_mask):
        q, k, v = split_qkv(qkv, heads)
        o, lse = short_attention(q, k, v, scale, key_mask, return_lse=True)
        ctx.save_for_backward(qkv, o, lse, key_mask)
        ctx.heads, ctx.scale = heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, key_mask = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        short_attention_bwd(
            *split_qkv(qkv, ctx.heads), o, do.contiguous(), ctx.scale,
            out=tuple(split_qkv(dqkv, ctx.heads)), key_mask=key_mask, lse=lse,
        )
        return dqkv, None, None, None


def short_attention_qkv(qkv: torch.Tensor, heads: int, scale: float | None = None,
                        key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable short attention from the fused projection
    [B, N, 3*H*D] (rows [q | k | v]) to the context [B, N, H, D];
    ``key_mask`` [rows, N] as for ``short_attention``. Only where a
    gradient can follow does the forward write the lse the backward
    reads."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * heads))
    if not (torch.is_grad_enabled() and qkv.requires_grad):
        # no gradient to come: the inference operator, which writes no lse
        # (and is the one an exported program holds)
        return short_attention(*split_qkv(qkv, heads), scale, key_mask)
    return _ShortAttentionQKV.apply(qkv, heads, scale, key_mask)
