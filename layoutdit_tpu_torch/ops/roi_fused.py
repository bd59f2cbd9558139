"""Fused RoIAlign probes: RoIAlign as two dense products over the level
atlas with the [K, P, C, W] intermediate kept on chip. CUDA kernels and
their plain versions.

Port of ``scripts/probe_roi_fused.py``. Every function computes, from an
atlas f [C, H, W] and separable weights wy [K, P, H], wx [K, P, W],

    t[k, py, c, w]    = bf16(sum_h wy[k, py, h] f[c, h, w])    (fp32 sums)
    out[k, px, py, c] = bf16(sum_w wx[k, px, w] t[k, py, c, w])  (fp32 sums)

with f, wy and wx cast to bf16 first, as the probe does:

- ``two_gemm``: the yardstick (the probe's ``xla_two_gemm``), the JAX
  package's production form ``pooled_from_weights_native``: two matrix
  products with ``t`` in device memory. No kernel of its own.
- ``variant_a`` (row 9 of the kernel table): both products in one
  kernel -> [K, Px, Py, C].
- ``variant_a0`` (row 10): the first product alone, ``t`` stored as
  [K * P * W, C] with rows (k, py, w), or (k, w, py) with
  ``relayout=True``.
- ``variant_e`` (row 11): row 9's function, the kernel writing
  [K / kb, C, kb * P, P] (channel-major), relaid out to [K, Px, Py, C]
  outside the kernel.

The kernels (``csrc/roi_fused.cu``) of rows 9 and 11 take the real wx,
its rows padded to a multiple of 8 w (``wx_rows``): the probe's block-diagonal ``wxb``
and selector ``r`` were workarounds for the TPU compiler and are not
carried over. ``kb`` is 8 or 16 and ``K % kb != 0`` raises, as the
probe's reshapes do. All three rows run one Hopper kernel (a persistent
grid, TMA loads through an mbarrier ring, wgmma, TMA stores) that groups
RoIs whatever kb is: 18 a block for rows 9 and 10, the last group
ragged; 16 for row 11, 8 a warpgroup, so that none straddles a kb block
of its channel-major out.
The plain versions run the same arithmetic in fp32 with ``t`` rounded to
bf16; a wrapper takes them for CPU tensors only, and for CUDA tensors
launches its kernel, through the registered operators
``layoutdit_torch::roi_fused_a``, ``::roi_fused_a0`` and
``::roi_fused_e`` (``ops/_library.py``), or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.ops import _build, _library
from layoutdit_tpu_torch.ops.roi_align import pooled_from_weights_native

P = 7
BF16 = torch.bfloat16
# what the kernels take: the contraction H zero-padded to H_PAD (the 224 px
# atlas has 109 rows), W up to W_MAX, C a multiple of the channel tile
H_PAD = 112
W_MAX = 128
KBS = (8, 16)
CHANNEL_TILE = {"a": 16, "e": 16, "a0": 64}

# rows 9 and 11: f, wy, wx, out, K, kb, C, W, wx pitch, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_A0_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(name: str, f_chw: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor | None,
           kb: int) -> None:
    if f_chw.dim() != 3 or wy.dim() != 3 or wy.shape[1:] != (P, f_chw.shape[1]):
        raise ValueError(f"{name}: f must be [C, H, W] and wy [K, {P}, H], got "
                         f"{tuple(f_chw.shape)} and {tuple(wy.shape)}")
    k = wy.shape[0]
    if wx is not None and wx.shape != (k, P, f_chw.shape[2]):
        raise ValueError(f"{name}: wx must be [{k}, {P}, {f_chw.shape[2]}], got "
                         f"{tuple(wx.shape)}")
    if kb < 1 or k % kb:
        raise ValueError(f"{name}: K={k} is not a multiple of kb={kb}")


# ----------------------------------------------------------- plain versions


def t_plain(f_chw: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """t [K, Py, C, W] bf16: the first product, fp32 sums."""
    return torch.einsum("kph,chw->kpcw", wy.to(BF16).float(),
                        f_chw.to(BF16).float()).to(BF16)


def variant_a_plain(f_chw: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """-> [K, Px, Py, C] bf16, both products in fp32, t rounded to bf16."""
    t = t_plain(f_chw, wy)
    return torch.einsum("kqw,kpcw->kqpc", wx.to(BF16).float(), t.float()).to(BF16)


def variant_a0_plain(f_chw: torch.Tensor, wy: torch.Tensor, relayout: bool = True) -> torch.Tensor:
    """t as [K * P * W, C] bf16, rows (k, w, py) or, without relayout,
    (k, py, w)."""
    t = t_plain(f_chw, wy)
    order = (0, 3, 1, 2) if relayout else (0, 1, 3, 2)
    return t.permute(*order).reshape(-1, t.shape[2])


def variant_e_plain(f_chw: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                    kb: int = 8) -> torch.Tensor:
    """Row 9's function in row 11's kernel layout [K / kb, C, kb * Px, Py]."""
    s = variant_a_plain(f_chw, wy, wx)
    k, c = s.shape[0], s.shape[-1]
    return s.reshape(k // kb, kb, P, P, c).permute(0, 4, 1, 2, 3).reshape(k // kb, c, kb * P, P)


# ----------------------------------------------------------------- wrappers


def two_gemm(f_chw: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The yardstick: ``pooled_from_weights_native`` on the bf16 atlas,
    two matrix products with t in device memory -> [K, Px, Py, C]."""
    _check("two_gemm", f_chw, wy, wx, 1)
    return pooled_from_weights_native(f_chw.to(BF16), wy, wx)


def kernel_operands(f_chw: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor | None):
    """The kernels' operands: the atlas as bf16 [C, W, H_PAD] (h fastest,
    zero past H), wy as bf16 [K * P, H_PAD] (zero past H), wx as bf16
    [K, P, W], each contiguous."""
    pad = H_PAD - f_chw.shape[1]
    f = F.pad(f_chw.to(BF16).transpose(1, 2), (0, pad)).contiguous()
    wy2 = F.pad(wy.to(BF16), (0, pad)).reshape(-1, H_PAD).contiguous()
    wx2 = None if wx is None else wx.to(BF16).contiguous()
    return f, wy2, wx2


def wx_rows(wx2: torch.Tensor) -> torch.Tensor:
    """Rows 9 and 11's wx operand: bf16 [K * P, W rounded up to 8], zero
    past W, so that its row pitch is a multiple of 16 bytes, as TMA
    needs."""
    w = wx2.shape[-1]
    return F.pad(wx2.reshape(-1, w), (0, -w % 8)).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("roi_fused")
    if lib.roi_fused_a.argtypes is None:
        for fn in (lib.roi_fused_a, lib.roi_fused_e):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.roi_fused_a0.argtypes = _A0_ARGTYPES
        lib.roi_fused_a0.restype = ctypes.c_int
    return lib


def _cuda_operands(name: str, mode: str, f_chw, wy, wx, kb):
    """Refuse what the kernels do not take; -> (operands, K, C, W)."""
    tensors = [t for t in (f_chw, wy, wx) if t is not None]
    if any(t.device != wy.device for t in tensors):
        raise ValueError(f"{name}: f, wy and wx must lie on one device")
    if wy.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {wy.device}")
    c, h, w = f_chw.shape
    ct = CHANNEL_TILE[mode]
    if kb not in KBS or h > H_PAD or w > W_MAX or c % ct:
        raise ValueError(f"{name}: the kernel takes kb in {KBS}, H <= {H_PAD}, W <= {W_MAX} "
                         f"and C a multiple of {ct}; got kb={kb}, C={c}, H={h}, W={w}")
    f, wy2, wx2 = kernel_operands(f_chw, wy, wx)
    if mode in ("a", "e"):
        wx2 = wx_rows(wx2)
    return (f, wy2, wx2), wy.shape[0], c, w


def _a_cuda(f, wy2, wx2, k, kb, c, w):
    # wx2: [K * P, pitch] from wx_rows
    out = torch.empty((k, P, P, c), dtype=BF16, device=wy2.device)
    lib = _lib()
    code = lib.roi_fused_a(f.data_ptr(), wy2.data_ptr(), wx2.data_ptr(), out.data_ptr(), k, kb,
                           c, w, wx2.shape[-1], _build.stream_ptr(wy2))
    _build.check(lib, code, "variant_a")
    variant_a.launches += 1
    return out


def _a0_cuda(f, wy2, k, kb, c, w, relayout):
    out = torch.empty((k * P * w, c), dtype=BF16, device=wy2.device)
    lib = _lib()
    code = lib.roi_fused_a0(f.data_ptr(), wy2.data_ptr(), out.data_ptr(), k, kb, c, w,
                            int(relayout), _build.stream_ptr(wy2))
    _build.check(lib, code, "variant_a0")
    variant_a0.launches += 1
    return out


def _e_cuda(f, wy2, wx2, k, kb, c, w):
    # wx2: [K * P, pitch] from wx_rows
    out = torch.empty((k // kb, c, kb * P, P), dtype=BF16, device=wy2.device)
    lib = _lib()
    code = lib.roi_fused_e(f.data_ptr(), wy2.data_ptr(), wx2.data_ptr(), out.data_ptr(), k,
                           kb, c, w, wx2.shape[-1], _build.stream_ptr(wy2))
    _build.check(lib, code, "variant_e")
    variant_e.launches += 1
    return out


_a_op = _library.define(
    "roi_fused_a(Tensor f, Tensor wy, Tensor wx, int k, int kb, int c, int w) -> Tensor",
    fake=lambda f, wy2, wx2, k, kb, c, w: wy2.new_empty((k, P, P, c), dtype=BF16),
    cuda=_a_cuda,
)
_a0_op = _library.define(
    "roi_fused_a0(Tensor f, Tensor wy, int k, int kb, int c, int w, bool relayout) -> Tensor",
    fake=lambda f, wy2, k, kb, c, w, relayout: wy2.new_empty((k * P * w, c), dtype=BF16),
    cuda=_a0_cuda,
)
_e_op = _library.define(
    "roi_fused_e(Tensor f, Tensor wy, Tensor wx, int k, int kb, int c, int w) -> Tensor",
    fake=lambda f, wy2, wx2, k, kb, c, w: wy2.new_empty((k // kb, c, kb * P, P), dtype=BF16),
    cuda=_e_cuda,
)


def variant_a(f_chw: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, kb: int = 8) -> torch.Tensor:
    """Row 9: out [K, Px, Py, C] bf16 in one kernel for CUDA tensors (t
    never leaves the chip), the plain version for CPU tensors."""
    _check("variant_a", f_chw, wy, wx, kb)
    if wy.device.type == "cpu":
        return variant_a_plain(f_chw, wy, wx)
    (f, wy2, wx2), k, c, w = _cuda_operands("variant_a", "a", f_chw, wy, wx, kb)
    return _a_op(f, wy2, wx2, k, kb, c, w)


variant_a.launches = 0


def variant_a0(f_chw: torch.Tensor, wy: torch.Tensor, kb: int = 8,
               relayout: bool = True) -> torch.Tensor:
    """Row 10: t [K * P * W, C] bf16, rows (k, w, py) with ``relayout``,
    else (k, py, w): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check("variant_a0", f_chw, wy, None, kb)
    if wy.device.type == "cpu":
        return variant_a0_plain(f_chw, wy, relayout)
    (f, wy2, _), k, c, w = _cuda_operands("variant_a0", "a0", f_chw, wy, None, kb)
    return _a0_op(f, wy2, k, kb, c, w, relayout)


variant_a0.launches = 0


def variant_e(f_chw: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, kb: int = 8,
              kernel_layout: bool = False) -> torch.Tensor:
    """Row 11: row 9's function, the kernel (CUDA tensors) or the plain
    version (CPU tensors) writing [K / kb, C, kb * Px, Py]; returned as
    that with ``kernel_layout``, else relaid out to [K, Px, Py, C]."""
    _check("variant_e", f_chw, wy, wx, kb)
    k, c = wy.shape[0], f_chw.shape[0]
    if wy.device.type == "cpu":
        out = variant_e_plain(f_chw, wy, wx, kb)
    else:
        (f, wy2, wx2), k, c, w = _cuda_operands("variant_e", "e", f_chw, wy, wx, kb)
        out = _e_op(f, wy2, wx2, k, kb, c, w)
    if kernel_layout:
        return out
    return out.reshape(k // kb, c, kb, P, P).permute(0, 2, 3, 4, 1).reshape(k, P, P, c)


variant_e.launches = 0
