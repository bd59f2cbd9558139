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
for CUDA tensors through the registered operators
``layoutdit_torch::flash_attention_fwd``, ``::flash_attention_bwd_dq``,
``::flash_attention_bwd_dkdv`` and ``::flash_attention_bwd_dbias``
(``ops/_library.py``), whose CUDA implementations run the direct
launchers (``flash_attention_fwd_launch`` and the three backward ones,
which check what the kernels read) and count the launches; they take the
plain versions only for CPU tensors.
``flash_attention_qkv`` is the differentiable entry point: a
``torch.autograd.Function`` from the fused projection [B, N, 3*H*D] and
the bias to the context [B, N, H, D], whose backward writes dq, dk and
dv straight into one [B, N, 3*H*D] gradient and, when the bias requires
a gradient, launches the dbias kernel; ``flash_attention`` is the same
over separate q, k, v.

The forward, dq and dkdv kernels take a valid-key count ``n_keys <= N``
(ring attention's blocks, whose last one holds the sequence's padding):
keys at index >= ``n_keys`` join the ragged edge's mask, out of every
softmax row, and their dK and dV are 0. ``n_keys == N`` (the default) is
the unmasked path, the same bits.

All four kernels, and the plain versions, take a key mask as the short
kernels do (``ops/short_attention.py``): ``key_mask`` [rows, N], bool or
uint8, contiguous, row b % rows for batch element b (a window mask has
one row a window, as ``models/vit.py`` builds it; ``pad_tokens_to``'s
padding one row). A key its row holds False for drops out of every
softmax row (score -inf, after the bias is added, as the JAX encoder's
masked XLA attention does): its P is exactly 0 in the forward and every
backward kernel, its dK and dV rows are exactly 0, and its dbias column
gets nothing from the batch elements whose row drops it. Every row must
keep at least one key (a window's padding band is narrower than the
window); it is not checked. ``n_keys`` and a mask exclude each other:
a call with a mask and ``n_keys`` < N raises (ring attention's blocks
take no mask, the encoder's masks no ``n_keys``). A mask that keeps every key
gives the unmasked kernels' bits. The masked kernels' launches are also
counted apart (``masked_launches``, a part of ``launches``).

Float32 tensors (a float32 compute dtype) take the forward's float32
form: an FFMA kernel shared with the short forward
(``csrc/attention_f32.cuh``; D = 64, the bias, key mask, ``n_keys`` and
lse as in bf16, full fp32 arithmetic), counted apart too
(``flash_attention_fwd.f32_launches``, a part of its launches). The
backward kernels take bf16 only: ``flash_attention_bwd`` and its
launchers refuse a float32 tensor with a message (float32 training on the
card waits for their fp32 forms).
"""

from __future__ import annotations

import ctypes
import math

import torch

from layoutdit_tpu_torch.ops import _build, _library
from layoutdit_tpu_torch.ops.short_attention import (
    _check_mask,
    key_mask_rows,
    split_qkv,
)

HEAD_DIM = 64  # dit-base; the kernels are compiled for this width only

# the tensors (the key mask's among them), then B, N, H, D, n_keys and the
# mask's rows; the strides, scale and stream
_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)
_DBIAS_ARGTYPES = (  # one pointer and n_keys fewer
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    + [ctypes.c_float, ctypes.c_void_p]
)


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, bias, scale, n_keys: int | None = None,
            key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, H, N, N] fp32 scores q k^T * scale (+ bias), keys at index >=
    ``n_keys`` and the keys ``key_mask`` [rows, N] holds False for (row
    b % rows for batch b) at -inf."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[None]
    if n_keys is not None and n_keys < k.shape[1]:
        s = s.masked_fill(torch.arange(k.shape[1], device=s.device) >= n_keys, float("-inf"))
    if key_mask is not None:
        s = s.masked_fill(~key_mask_rows(key_mask, q.shape[0])[:, None, None, :], float("-inf"))
    return s


def _n_keys(what: str, n_keys: int | None, n: int, key_mask: torch.Tensor | None) -> int:
    """The valid-key count the kernels take (N for None); 1..N, and N
    with a key mask."""
    if n_keys is None:
        return n
    if not 1 <= n_keys <= n:
        raise ValueError(f"{what}: n_keys={n_keys} outside 1..{n}")
    if key_mask is not None and n_keys < n:
        raise ValueError(f"{what}: n_keys={n_keys} < N={n} with a key mask; mask those keys "
                         "in the mask instead")
    return int(n_keys)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
    n_keys: int | None = None,
    key_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale + bias) v over [B, N, H, D] with fp32 math
    -> (o [B, N, H, D] in q.dtype, lse [B*H, N] fp32); keys at index >=
    ``n_keys`` (default N) and the keys ``key_mask`` drops masked."""
    b, n, h, _ = q.shape
    s = _scores(q, k, bias, _scale(q, scale), _n_keys("flash_attention", n_keys, n, key_mask),
                key_mask)
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
    n_keys: int | None = None,
    key_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(dq, dk, dv, dbias): dq, dk, dv over [B, N, H, D] in fp32 math, out
    in q.dtype, and dbias = sum_b dS, fp32 [H, N, N] (None without a
    bias): the algebra of the Pallas backward (and of its oracle
    ``_bwd_reference``), P = exp(q k^T * scale + bias - lse),
    D = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - D),
    dQ = dS K s, dK = dS^T Q s; keys at index >= ``n_keys`` and those
    ``key_mask`` drops masked (P 0, so their dK and dV 0, and nothing of
    theirs in dbias)."""
    b, n, h, _ = q.shape
    scale = _scale(q, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = _scores(q, k, bias, scale, _n_keys("flash_attention_bwd", n_keys, n, key_mask), key_mask)
    p = torch.exp(s - lse.float().reshape(b, h, n, 1))
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
        for fn in (lib.flash_attention_fwd, lib.flash_attention_fwd_f32):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkdv):
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
        lib.flash_attention_bwd_dbias.argtypes = _DBIAS_ARGTYPES
        lib.flash_attention_bwd_dbias.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check_rows(what: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """[B, N, H, D] in ``ref``'s dtype, bf16 or fp32, like ``ref`` on its
    device, rows contiguous and 16-byte aligned: base and B, N, H strides
    multiples of 16 bytes, 8 bf16 or 4 fp32 elements (as the fused QKV
    projection's slices are)."""
    d = ref.shape[-1]
    if d != HEAD_DIM:
        raise ValueError(f"{what}: head dim {d}, the kernels take {HEAD_DIM}")
    dtype = _library.kernel_dtype(ref)
    type_name, vec = _library.KERNEL_DTYPES[dtype]
    for name, t in tensors.items():
        if t.shape != ref.shape or t.dtype != dtype or t.device != ref.device:
            raise ValueError(
                f"{what}: {name} must be {type_name} {tuple(ref.shape)} on "
                f"{ref.device} (the kernels take bf16 or fp32, all alike), got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
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


def flash_attention_fwd_launch(q, k, v, bias, scale, o, lse, n_keys: int = -1,
                               key_mask: torch.Tensor | None = None) -> None:
    """Launch the forward kernel of ``flash_attention_fwd``: writes o
    ([B, N, H, D] in q's dtype) and lse (fp32 [B*H, N]). q, k, v and o
    bf16 rows that TMA can read (as ``flash_attention_bwd`` checks them),
    or fp32 rows as aligned (the float32 form); bias fp32
    [H, N, N] contiguous or None; ``n_keys`` the valid keys (-1: N);
    ``key_mask`` a contiguous bool or uint8 [rows, N] on q's device, or
    None. The direct launch: it counts nothing (the operator
    ``layoutdit_torch::flash_attention_fwd`` counts on
    ``flash_attention_fwd``)."""
    b, n, h, d = q.shape
    n_keys = _n_keys("flash_attention", None if n_keys < 0 else n_keys, n, key_mask)
    _check_rows("flash_attention", q, q=q, k=k, v=v, o=o)
    _check_lse("flash_attention", lse, q, "lse")
    _check_square("flash_attention", q, bias=bias)
    mask, rows = _check_mask("flash_attention", q, key_mask)
    lib = _lib()
    fwd = lib.flash_attention_fwd_f32 if q.dtype == torch.float32 else lib.flash_attention_fwd
    code = fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        mask, o.data_ptr(), lse.data_ptr(), b, n, h, d, n_keys, rows, _strides(q, k, v, o),
        float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention")


def _count(fn, key_mask) -> None:
    """One launch of ``fn``'s kernel: its count, and the masked form's."""
    fn.launches += 1
    fn.masked_launches += key_mask is not None


def _fwd_cuda(q, k, v, bias, scale, n_keys=-1, key_mask=None):
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    flash_attention_fwd_launch(q, k, v, bias, scale, o, lse, n_keys, key_mask)
    _count(flash_attention_fwd, key_mask)
    flash_attention_fwd.f32_launches += q.dtype == torch.float32
    return o, lse


def _fwd_fake(q, k, v, bias, scale, n_keys=-1, key_mask=None):
    b, n, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b * h, n), dtype=torch.float32)


_fwd_op = _library.define(
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor? bias, float scale, "
    "int n_keys=-1, Tensor? key_mask=None) -> (Tensor, Tensor)",
    fake=_fwd_fake, cuda=_fwd_cuda,
)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
    n_keys: int | None = None,
    key_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (o [B, N, H, D], lse [B*H, N] fp32). bf16 or fp32 q/k/v on the
    card (rows 16-byte aligned, as the fused QKV projection's slices are),
    through the operator ``layoutdit_torch::flash_attention_fwd``; any
    float type on the CPU. Keys at index >= ``n_keys`` (default N) and
    those ``key_mask`` [rows, N] holds False for are masked. Not
    differentiable by itself on the card: ``flash_attention`` and
    ``flash_attention_qkv`` are."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale, n_keys, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _fwd_op(q, k, v, _check_bias("flash_attention", bias, q), _scale(q, scale),
                   _n_keys("flash_attention", n_keys, q.shape[1], key_mask), key_mask)


# launches of the kernel, and of them those of its masked form and those
# of its float32 form
flash_attention_fwd.launches = 0
flash_attention_fwd.masked_launches = 0
flash_attention_fwd.f32_launches = 0


def flash_attention_bwd_dq(q, k, v, o, lse, do, bias, scale, dq, delta, n_keys=-1,
                           key_mask=None) -> None:
    """Launch the dq kernel of ``flash_attention_bwd``: writes dq (bf16
    [B, N, H, D], any row strides) and delta = rowsum(dO o O) (fp32
    [B*H, N], read by ``flash_attention_bwd_dkdv``). CUDA tensors as
    ``flash_attention_bwd`` checks them; bias fp32 [H, N, N] or None;
    ``n_keys`` the valid keys (-1: N); ``key_mask`` as the forward's."""
    b, n, h, d = q.shape
    _library.refuse_float32_backward("flash_attention_bwd", q)
    n_keys = _n_keys("flash_attention_bwd", None if n_keys < 0 else n_keys, n, key_mask)
    _check_rows("flash_attention_bwd", q, q=q, k=k, v=v, o=o, do=do, dq=dq)
    _check_lse("flash_attention_bwd", lse, q, "lse")
    _check_lse("flash_attention_bwd", delta, q, "delta")
    _check_square("flash_attention_bwd", q, bias=bias)
    mask, rows = _check_mask("flash_attention_bwd", q, key_mask)
    lib = _lib()
    code = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if bias is None else bias.data_ptr(), mask, delta.data_ptr(),
        dq.data_ptr(), b, n, h, d, n_keys, rows, _strides(q, k, v, o, do, dq), float(scale),
        _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention_bwd_dq")


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.masked_launches = 0


def flash_attention_bwd_dkdv(q, k, v, lse, do, delta, bias, scale, dk, dv,
                             n_keys=-1, key_mask=None) -> None:
    """Launch the dkdv kernel of ``flash_attention_bwd`` after the dq
    kernel (it reads that kernel's delta): writes dk and dv (0 for keys
    at index >= ``n_keys`` and those ``key_mask`` drops)."""
    b, n, h, d = q.shape
    _library.refuse_float32_backward("flash_attention_bwd", q)
    n_keys = _n_keys("flash_attention_bwd", None if n_keys < 0 else n_keys, n, key_mask)
    _check_rows("flash_attention_bwd", q, q=q, k=k, v=v, do=do, dk=dk, dv=dv)
    _check_lse("flash_attention_bwd", lse, q, "lse")
    _check_lse("flash_attention_bwd", delta, q, "delta")
    _check_square("flash_attention_bwd", q, bias=bias)
    mask, rows = _check_mask("flash_attention_bwd", q, key_mask)
    lib = _lib()
    code = lib.flash_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if bias is None else bias.data_ptr(), mask, dk.data_ptr(),
        dv.data_ptr(), b, n, h, d, n_keys, rows, _strides(q, k, v, do, dk, dv), float(scale),
        _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention_bwd_dkdv")


flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dkdv.masked_launches = 0


def flash_attention_bwd_dbias(q, k, v, lse, do, delta, bias, scale, dbias,
                              key_mask=None) -> None:
    """Launch the dbias kernel of ``flash_attention_bwd`` after the dq
    kernel (it reads that kernel's delta): writes dbias = sum_b dS into
    ``dbias``, contiguous fp32 [H, N, N]; bias fp32 [H, N, N];
    ``key_mask`` as the forward's."""
    b, n, h, d = q.shape
    _library.refuse_float32_backward("flash_attention_bwd", q)
    _check_rows("flash_attention_bwd", q, q=q, k=k, v=v, do=do)
    _check_lse("flash_attention_bwd", lse, q, "lse")
    _check_lse("flash_attention_bwd", delta, q, "delta")
    if bias is None:
        raise ValueError("flash_attention_bwd: the dbias kernel needs a bias")
    _check_square("flash_attention_bwd", q, bias=bias, dbias=dbias)
    mask, rows = _check_mask("flash_attention_bwd", q, key_mask)
    lib = _lib()
    code = lib.flash_attention_bwd_dbias(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias.data_ptr(), mask, dbias.data_ptr(), b, n, h, d, rows,
        _strides(q, k, v, do), float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, code, "flash_attention_bwd_dbias")


flash_attention_bwd_dbias.launches = 0
flash_attention_bwd_dbias.masked_launches = 0


def _dq_cuda(q, k, v, o, lse, dout, bias, scale, dq, delta, n_keys=-1, key_mask=None):
    flash_attention_bwd_dq(q, k, v, o, lse, dout, bias, scale, dq, delta, n_keys, key_mask)
    _count(flash_attention_bwd_dq, key_mask)


def _dkdv_cuda(q, k, v, lse, dout, delta, bias, scale, dk, dv, n_keys=-1, key_mask=None):
    flash_attention_bwd_dkdv(q, k, v, lse, dout, delta, bias, scale, dk, dv, n_keys, key_mask)
    _count(flash_attention_bwd_dkdv, key_mask)


def _dbias_cuda(q, k, v, lse, dout, delta, bias, scale, dbias, key_mask=None):
    flash_attention_bwd_dbias(q, k, v, lse, dout, delta, bias, scale, dbias, key_mask)
    _count(flash_attention_bwd_dbias, key_mask)


def _no_outputs(*args):
    return None


_dq_op = _library.define(
    "flash_attention_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor dout, "
    "Tensor? bias, float scale, Tensor(a!) dq, Tensor(b!) delta, int n_keys=-1, "
    "Tensor? key_mask=None) -> ()",
    fake=_no_outputs, cuda=_dq_cuda,
)
_dkdv_op = _library.define(
    "flash_attention_bwd_dkdv(Tensor q, Tensor k, Tensor v, Tensor lse, Tensor dout, "
    "Tensor delta, Tensor? bias, float scale, Tensor(a!) dk, Tensor(b!) dv, "
    "int n_keys=-1, Tensor? key_mask=None) -> ()",
    fake=_no_outputs, cuda=_dkdv_cuda,
)
_dbias_op = _library.define(
    "flash_attention_bwd_dbias(Tensor q, Tensor k, Tensor v, Tensor lse, Tensor dout, "
    "Tensor delta, Tensor bias, float scale, Tensor(a!) dbias, Tensor? key_mask=None) -> ()",
    fake=_no_outputs, cuda=_dbias_cuda,
)


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
    n_keys: int | None = None,
    key_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(dq, dk, dv, dbias) of flash attention: [B, N, H, D] each, from
    the forward's o and lse [B*H, N], and, with ``bias_grad``, the bias's
    gradient sum_b dS as fp32 [H, N, N] (else None). On the card ``out``
    may name three bf16 [B, N, H, D] views to write into (the slices of a
    fused QKV gradient); they are returned. ``n_keys`` and ``key_mask``:
    as the forward's (``n_keys`` not with ``bias_grad``: the dbias kernel
    takes no key count). The kernels take bf16 only: a float32 CUDA
    tensor raises ``_library.FLOAT32_TRAINING``."""
    if bias_grad and bias is None:
        raise ValueError("flash_attention_bwd: bias_grad needs a bias")
    if bias_grad and n_keys is not None:
        raise ValueError("flash_attention_bwd: the dbias kernel takes no n_keys")
    if q.device.type == "cpu":
        *grads, dbias = flash_attention_bwd_plain(q, k, v, o, lse, do, bias, scale, n_keys,
                                                  key_mask)
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
    n_keys = _n_keys("flash_attention_bwd", n_keys, n, key_mask)
    _dq_op(q, k, v, o, lse, do, bias, scale, dq, delta, n_keys, key_mask)
    _dkdv_op(q, k, v, lse, do, delta, bias, scale, dk, dv, n_keys, key_mask)
    dbias = None
    if bias_grad:
        dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
        _dbias_op(q, k, v, lse, do, delta, bias, scale, dbias, key_mask)
    return (*out, dbias)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, key_mask):
        o, lse = flash_attention_fwd(q, k, v, bias, scale, key_mask=key_mask)
        ctx.save_for_backward(q, k, v, o, lse, bias, key_mask)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias, key_mask = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do.contiguous(), bias, ctx.scale,
                                     bias_grad=ctx.needs_input_grad[3], key_mask=key_mask),
                None, None)


class _FlashAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale, bias, key_mask):
        o, lse = flash_attention_fwd(*split_qkv(qkv, heads), bias, scale, key_mask=key_mask)
        ctx.save_for_backward(qkv, o, lse, bias, key_mask)
        ctx.heads, ctx.scale = heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, bias, key_mask = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        *_, dbias = flash_attention_bwd(
            *split_qkv(qkv, ctx.heads), o, lse, do.contiguous(), bias, ctx.scale,
            out=tuple(split_qkv(dqkv, ctx.heads)), bias_grad=ctx.needs_input_grad[3],
            key_mask=key_mask,
        )
        return dqkv, None, None, dbias, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    scale: float | None = None,
    key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused attention; [B, N, H, D] in and out, optional additive bias
    [H, N, N] shared by the batch, optional ``key_mask`` [rows, N] (row
    b % rows for batch b) dropping the keys it holds False for.
    Differentiable in q, k, v and the bias."""
    return _FlashAttention.apply(q, k, v, bias, _scale(q, scale), key_mask)


def flash_attention_qkv(
    qkv: torch.Tensor,
    heads: int,
    scale: float | None = None,
    bias: torch.Tensor | None = None,
    key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Differentiable flash attention from the fused projection
    [B, N, 3*H*D] (rows [q | k | v]) to the context [B, N, H, D];
    optional additive bias [H, N, N] shared by the batch, differentiable
    too; optional ``key_mask`` [rows, N] as ``flash_attention``'s."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * heads))
    return _FlashAttentionQKV.apply(qkv, heads, scale, bias, key_mask)
