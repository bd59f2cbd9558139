"""Multiscale RoIAlign, forward and backward: CUDA kernels and their plain
versions.

Port of ``layoutdit_tpu/ops/roi_align.py`` (``multiscale_roi_align``
with its FPN level mapper) and of the Pallas forward in
``roi_align_pallas.py``. torchvision ``MultiScaleRoIAlign`` semantics,
``aligned=False``: each RoI is assigned one pyramid level by
``floor(canonical_level + log2(sqrt(area) / canonical_scale + 1e-6))``,
clipped to the levels given; its P x P bins each average
``sampling_ratio^2`` bilinear samples.

The kernels (``csrc/roi_align.cu``) replace the Pallas ``_fwd_kernel``
and ``_bwd_kernel``.
The TPU kernel multiplies a level atlas by separable, level-masked weight
matrices; the CUDA kernel samples the assigned level directly (one block
per RoI, fp32 accumulation), the same function without the atlas, which
at 1024 px would be 65 MB against 227 KB of shared memory. It is bound
by bytes on the H100 (the feature pixels the RoIs touch plus the pooled
output). The plain version keeps the JAX package's separable weight
formulation (``build_roi_weights``) in fp32.

Tolerance between the two on bf16 features: both accumulate in fp32 and
round once to bf16, so they differ by at most one bf16 rounding of the
output; the JAX Pallas path also rounds its weights and its intermediate
to bf16 and so sits a few bf16 roundings away from either.

The vmap of the JAX version over images is written out: features are
[B, C, H, W] and RoIs [B, K, 4].

``multiscale_roi_align`` is differentiable with respect to the features
only (``_RoIAlign``): the backward kernel scatters dout through the same
taps with fp32 atomics, so its sum order, and the last bits of dF, change
from run to run; its plain version is dF = sum_k Wy^T . dout . Wx over
``build_roi_weights``. The RoIs get no gradient, as in the JAX package
(stop-gradient proposals, zero cotangents for the weights).

The JAX package's own XLA formulation is here too, for the fused-RoIAlign
probes (``ops/roi_fused.py``) that are measured against it: ``roi_atlas``
stacks the levels into one atlas along H (W zero-padded to the widest
level) with level-masked weights, and ``pooled_from_weights_native``
contracts it in two dense products (fp32 sums, the [K, P, C, W]
intermediate rounded to the feature dtype; dF only in its backward).
Those products are plain matrix products (``torch.matmul``), and
``multiscale_roi_align`` does not route through them: CUDA tensors go to
the kernels above.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.ops import _build
from layoutdit_tpu_torch.ops.boxes import box_area

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_BWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def roi_levels(
    rois: torch.Tensor,
    num_levels: int,
    canonical_scale: float,
    canonical_level: int = 4,
    roi_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """FPN level mapper -> int32 level index in [0, num_levels), or -1
    where ``roi_mask`` is False."""
    lvl_min = canonical_level - 2
    area = box_area(rois.float()).clamp(min=0.0)
    lvl = torch.floor(
        canonical_level + torch.log2(torch.sqrt(area) / canonical_scale + 1e-6)
    )
    lvl = lvl.clamp(lvl_min, lvl_min + num_levels - 1).to(torch.int32) - lvl_min
    if roi_mask is not None:
        lvl = torch.where(roi_mask, lvl, torch.full_like(lvl, -1))
    return lvl


def _bilinear_weight_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """[..., S] sample coords -> [..., S, size] bilinear row weights
    (torchvision bilinear_interpolate: samples outside [-1, size] give 0,
    coords clamp at 0, the top edge collapses to the last cell)."""
    in_range = (coords >= -1.0) & (coords <= float(size))
    c = coords.clamp(min=0.0)
    low = torch.floor(c)
    top = low >= (size - 1)
    low = low.clamp(max=size - 1.0)
    frac = torch.where(top, torch.zeros_like(c), c - low)
    high = torch.where(top, low, low + 1.0)

    cells = torch.arange(size, dtype=coords.dtype, device=coords.device)
    onehot_low = (low[..., None] == cells).to(coords.dtype)
    onehot_high = (high[..., None] == cells).to(coords.dtype)
    w = onehot_low * (1.0 - frac)[..., None] + onehot_high * frac[..., None]
    return w * in_range[..., None].to(coords.dtype)


def build_roi_weights(
    rois: torch.Tensor,  # [R, 4]
    spatial_scale: float,
    size_hw: tuple[int, int],
    output_size: int = 7,
    sampling_ratio: int = 2,
    roi_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-roi separable bilinear weights (Wy [R, P, H], Wx [R, P, W]) with
    the g x g within-bin sample average folded in. Wy rows of RoIs where
    ``roi_mask`` [R] is False are zero."""
    h, w = size_hw
    p, g = output_size, sampling_ratio
    r = rois.float()
    start_w = r[:, 0] * spatial_scale
    start_h = r[:, 1] * spatial_scale
    roi_w = (r[:, 2] * spatial_scale - start_w).clamp(min=1.0)
    roi_h = (r[:, 3] * spatial_scale - start_h).clamp(min=1.0)

    idx = torch.arange(p * g, dtype=torch.float32, device=r.device)
    grid = torch.div(idx, g, rounding_mode="floor") + (idx % g + 0.5) / g
    ys = start_h[:, None] + grid[None, :] * (roi_h / p)[:, None]
    xs = start_w[:, None] + grid[None, :] * (roi_w / p)[:, None]
    n = r.shape[0]
    wy = _bilinear_weight_matrix(ys, h).reshape(n, p, g, h).mean(dim=2)
    wx = _bilinear_weight_matrix(xs, w).reshape(n, p, g, w).mean(dim=2)
    if roi_mask is not None:
        wy = wy * roi_mask[:, None, None].to(wy.dtype)
    return wy, wx


def roi_align_plain(
    features: list[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Separable-weight RoIAlign over assigned levels, fp32 math ->
    [B, K, Px, Py, C] in the features' dtype."""
    b, k = rois.shape[:2]
    c = features[0].shape[1]
    p = output_size
    out = torch.zeros(b, k, p, p, c, dtype=torch.float32, device=rois.device)
    for li, (f, scale) in enumerate(zip(features, spatial_scales)):
        wy, wx = build_roi_weights(
            rois.reshape(-1, 4), scale, tuple(f.shape[-2:]), p, sampling_ratio
        )
        m = (levels.reshape(-1) == li).float()[:, None, None]
        wy = (wy * m).reshape(b, k, p, -1)
        wx = (wx * m).reshape(b, k, p, -1)
        for i in range(b):
            t = torch.einsum("kph,chw->kpcw", wy[i], f[i].float())
            out[i] += torch.einsum("kqw,kpcw->kqpc", wx[i], t)
    return out.to(features[0].dtype)


def roi_align_bwd_plain(
    dout: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    features: list[torch.Tensor],
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> list[torch.Tensor]:
    """dF per level [B, C, H_l, W_l] in the features' dtype from dout
    [B, K, Px, Py, C]: dF = sum_k Wy^T . dout . Wx over
    ``build_roi_weights``, level-masked, fp32 math. ``features`` give
    only shapes and dtypes."""
    b, k = rois.shape[:2]
    p = output_size
    g = dout.float()
    grads = []
    for li, (f, scale) in enumerate(zip(features, spatial_scales)):
        wy, wx = build_roi_weights(
            rois.reshape(-1, 4), scale, tuple(f.shape[-2:]), p, sampling_ratio
        )
        m = (levels.reshape(-1) == li).float()[:, None, None]
        wy = (wy * m).reshape(b, k, p, -1)
        wx = (wx * m).reshape(b, k, p, -1)
        # dF[c, h, w] = sum_{k, px, py} wy[k, py, h] wx[k, px, w] dout[k, px, py, c]
        t = torch.einsum("bkqw,bkqpc->bkpcw", wx, g)
        grads.append(torch.einsum("bkph,bkpcw->bchw", wy, t).to(f.dtype))
    return grads


def _lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    if lib.roi_align_fwd.argtypes is None:
        lib.roi_align_fwd.argtypes = _ARGTYPES
        lib.roi_align_fwd.restype = ctypes.c_int
        lib.roi_align_bwd.argtypes = _BWD_ARGTYPES
        lib.roi_align_bwd.restype = ctypes.c_int
    return lib


def roi_align_fwd(
    features: list[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """-> pooled [B, K, Px, Py, C]: the kernel for CUDA tensors, the plain
    version for CPU tensors. The kernel takes bf16 features and reads
    them channels-last (converted here; a no-op when they already are)."""
    if rois.device.type == "cpu":
        return roi_align_plain(
            features, rois, levels, spatial_scales, output_size, sampling_ratio
        )
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {rois.device}")
    b, k = rois.shape[:2]
    c = features[0].shape[1]
    p = output_size
    feats = []
    for f in features:
        if f.dtype != torch.bfloat16 or f.device != rois.device or f.shape[:2] != (b, c):
            raise ValueError(
                f"roi_align: features must be bf16 [{b}, {c}, H, W] on {rois.device}"
            )
        feats.append(f.contiguous(memory_format=torch.channels_last))
    n = len(feats)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])
    strides = (ctypes.c_longlong * (4 * n))(*[s for f in feats for s in f.stride()])
    hw = (ctypes.c_int * (2 * n))(*[s for f in feats for s in f.shape[-2:]])
    scales = (ctypes.c_float * n)(*spatial_scales)
    rois_c = rois.float().contiguous()
    levels_c = levels.to(torch.int32).contiguous()
    out = torch.empty((b, k, p, p, c), dtype=torch.bfloat16, device=rois.device)
    lib = _lib()
    code = lib.roi_align_fwd(
        ptrs, strides, hw, scales, n, rois_c.data_ptr(), levels_c.data_ptr(),
        out.data_ptr(), b * k, k, c, p, sampling_ratio, _build.stream_ptr(rois),
    )
    _build.check(lib, code, "roi_align")
    roi_align_fwd.launches += 1
    return out


roi_align_fwd.launches = 0


def roi_align_bwd(
    dout: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    features: list[torch.Tensor],
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> list[torch.Tensor]:
    """dF per level [B, C, H_l, W_l], each in its feature's dtype and
    memory format: the kernel for CUDA tensors, the plain version for
    CPU tensors. The kernel adds into one zeroed fp32 channels-last
    scratch with atomics (see the source on determinism) and the result
    is cast once."""
    if rois.device.type == "cpu":
        return roi_align_bwd_plain(
            dout, rois, levels, features, spatial_scales, output_size, sampling_ratio
        )
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align_bwd: unsupported device {rois.device}")
    b, k = rois.shape[:2]
    c = features[0].shape[1]
    p = output_size
    if (dout.shape != (b, k, p, p, c) or dout.dtype != torch.bfloat16
            or dout.device != rois.device):
        raise ValueError(
            f"roi_align_bwd: dout must be bf16 [{b}, {k}, {p}, {p}, {c}] on {rois.device}, "
            f"got {dout.dtype} {tuple(dout.shape)} on {dout.device}"
        )
    for f in features:
        if f.device != rois.device or f.shape[:2] != (b, c):
            raise ValueError(f"roi_align_bwd: features must be [{b}, {c}, H, W] on {rois.device}")
    sizes = [f.shape[-2] * f.shape[-1] for f in features]
    scratch = torch.zeros(b * c * sum(sizes), dtype=torch.float32, device=rois.device)
    parts, start = [], 0
    for f, hw in zip(features, sizes):
        parts.append(scratch[start:start + b * hw * c].view(b, f.shape[-2], f.shape[-1], c))
        start += b * hw * c
    n = len(features)
    ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in parts])
    hw = (ctypes.c_int * (2 * n))(*[s for f in features for s in f.shape[-2:]])
    scales = (ctypes.c_float * n)(*spatial_scales)
    rois_c = rois.float().contiguous()
    levels_c = levels.to(torch.int32).contiguous()
    dout_c = dout.contiguous()
    lib = _lib()
    code = lib.roi_align_bwd(
        ptrs, hw, scales, n, rois_c.data_ptr(), levels_c.data_ptr(), dout_c.data_ptr(),
        b * k, k, c, p, sampling_ratio, _build.stream_ptr(rois),
    )
    _build.check(lib, code, "roi_align_bwd")
    roi_align_bwd.launches += 1
    grads = []
    for f, part in zip(features, parts):
        df = torch.empty_like(f)
        df.copy_(part.permute(0, 3, 1, 2))
        grads.append(df)
    return grads


roi_align_bwd.launches = 0


class _RoIAlign(torch.autograd.Function):
    """Pooled = RoIAlign(features); the gradient flows to the features
    only. RoIs and levels get none: the JAX package stop-gradients the
    proposals and returns zero cotangents for the weights."""

    @staticmethod
    def forward(ctx, rois, levels, spatial_scales, output_size, sampling_ratio, *features):
        # the features are saved for their shapes, dtypes and layouts only
        # (the backward never reads them; the RPN convs keep them alive)
        ctx.save_for_backward(rois, levels, *features)
        ctx.args = (list(spatial_scales), output_size, sampling_ratio)
        return roi_align_fwd(list(features), rois, levels, *ctx.args)

    @staticmethod
    def backward(ctx, dout):
        rois, levels, *features = ctx.saved_tensors
        grads = roi_align_bwd(dout, rois, levels, features, *ctx.args)
        return (None, None, None, None, None, *grads)


def multiscale_roi_align(
    features: list[torch.Tensor],
    rois: torch.Tensor,
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
    canonical_scale: float = 224.0,
    canonical_level: int = 4,
    roi_mask: torch.Tensor | None = None,
    native_layout: bool = False,
) -> torch.Tensor:
    """torchvision MultiScaleRoIAlign over FPN levels.

    Args:
      features: per level [B, C, H_l, W_l].
      rois: [B, K, 4] xyxy in image coordinates.
      roi_mask: optional [B, K] bool; False rows give zeros.

    Returns: [B, K, C, P, P], or [B, K, P(x), P(y), C] when
    ``native_layout=True`` (the layout the box head consumes).
    """
    rois = rois.detach()
    levels = roi_levels(
        rois, len(features), canonical_scale, canonical_level, roi_mask
    )
    out = _RoIAlign.apply(
        rois, levels, tuple(spatial_scales), output_size, sampling_ratio, *features
    )
    if native_layout:
        return out
    return out.permute(0, 1, 4, 3, 2)


# --------------------------------------------------------------- level atlas


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with fp32 sums, rounded once to ``dtype``: in ``dtype`` on the
    card (cuBLAS sums bf16 products in fp32), through fp32 on the CPU."""
    if a.is_cuda:
        return torch.matmul(a.to(dtype), b.to(dtype))
    return torch.matmul(a.float(), b.float()).to(dtype)


def _pooled_native_fwd(feature: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    dtype = feature.dtype
    *lead, c, h, w = feature.shape
    k, p = wy.shape[-3:-1]
    # step 1: t[k, py, c, w] = sum_h wy[k, py, h] f[c, h, w], rounded to dtype
    f_hcw = feature.transpose(-3, -2).reshape(*lead, h, c * w)
    t = _matmul(wy.to(dtype).reshape(*lead, k * p, h), f_hcw, dtype)
    t = t.reshape(*lead, k, p * c, w)
    # step 2: s[k, px, (py, c)] = sum_w wx[k, px, w] t[k, (py, c), w]
    s = _matmul(wx.to(dtype), t.transpose(-1, -2), dtype)
    return s.reshape(*lead, k, p, p, c)


def _pooled_native_bwd(ds: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                       shape: torch.Size, dtype: torch.dtype) -> torch.Tensor:
    *lead, c, h, w = shape
    k, p = wy.shape[-3:-1]
    ds = ds.to(dtype).reshape(*lead, k, p, p * c)  # [.., K, Px, (py, c)]
    # dt[k, (py, c), w] = sum_px ds[k, px, (py, c)] wx[k, px, w], rounded to dtype
    dt = _matmul(ds.transpose(-1, -2), wx.to(dtype), dtype)
    # df[h, (c, w)] = sum_{k, p} wy[(k, p), h] dt[(k, p), (c, w)], fp32 sums
    wy_t = wy.to(dtype).reshape(*lead, k * p, h).transpose(-1, -2)
    df = _matmul(wy_t, dt.reshape(*lead, k * p, c * w), dtype)
    return df.reshape(*lead, h, c, w).transpose(-3, -2).contiguous()


class _PooledNative(torch.autograd.Function):
    """``pooled_from_weights_native`` with the JAX package's custom VJP:
    dF only, its [K, P, C, W] intermediate in the feature dtype; the
    weights (from stop-gradient proposals) get none."""

    @staticmethod
    def forward(ctx, feature, wy, wx):
        ctx.save_for_backward(wy, wx)
        ctx.meta = (feature.shape, feature.dtype)
        return _pooled_native_fwd(feature, wy, wx)

    @staticmethod
    def backward(ctx, ds):
        wy, wx = ctx.saved_tensors
        return _pooled_native_bwd(ds, wy, wx, *ctx.meta), None, None


def pooled_from_weights_native(feature: torch.Tensor, wy: torch.Tensor,
                               wx: torch.Tensor) -> torch.Tensor:
    """pooled[k, px, py, c] = (Wy[k] F Wx[k]^T) as two dense products.

    Args:
      feature: [C, H, W], or [B, C, H, W] (a batch of images).
      wy: [K, P, H] (or [B, K, P, H]); wx: [K, P, W] (or [B, K, P, W]),
        both cast to the feature dtype.

    Returns: [K, Px, Py, C] (or [B, K, Px, Py, C]) in the feature dtype;
    each product sums in fp32 and the intermediate [K, Py, C, W] is
    rounded to the feature dtype. Differentiable in ``feature`` only.
    """
    return _PooledNative.apply(feature, wy, wx)


def pooled_from_weights(feature: torch.Tensor, wy: torch.Tensor,
                        wx: torch.Tensor) -> torch.Tensor:
    """torchvision layout: [..., K, C, Py, Px]."""
    return pooled_from_weights_native(feature, wy, wx).transpose(-1, -3)


def roi_align(
    feature: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float,
    output_size: int = 7,
    sampling_ratio: int = 2,
    roi_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """RoIAlign of one level by separable weights: feature [C, H, W] and
    rois [K, 4] (or [B, C, H, W] and [B, K, 4]) -> [..., K, C, P, P];
    rows where ``roi_mask`` is False give zeros."""
    lead = rois.shape[:-2]
    k = rois.shape[-2]
    mask = None if roi_mask is None else roi_mask.reshape(-1)
    wy, wx = build_roi_weights(rois.reshape(-1, 4), spatial_scale, tuple(feature.shape[-2:]),
                               output_size, sampling_ratio, roi_mask=mask)
    p = output_size
    return pooled_from_weights(feature, wy.reshape(*lead, k, p, -1), wx.reshape(*lead, k, p, -1))


def roi_atlas(
    features: list[torch.Tensor],
    rois: torch.Tensor,
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
    canonical_scale: float = 224.0,
    canonical_level: int = 4,
    roi_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The level atlas of the JAX package's ``multiscale_roi_align``.

    Args:
      features: per level [B, C, H_l, W_l].
      rois: [B, K, 4] xyxy in image coordinates; roi_mask: optional [B, K].

    Returns (f_cat [B, C, sum H_l, W_max], wy_cat [B, K, P, sum H_l],
    wx_cat [B, K, P, W_max]): the levels stacked along H with W zero-padded
    to the widest level; each RoI's rows of wy at its assigned level's
    offset (zero elsewhere), and its wx masked to that level too, since
    the padded columns of other levels overlap its [0, W_l). So
    ``pooled_from_weights_native(f_cat, wy_cat, wx_cat)`` is the
    multiscale RoIAlign.
    """
    rois = rois.detach()
    b, k = rois.shape[:2]
    p = output_size
    levels = roi_levels(rois, len(features), canonical_scale, canonical_level,
                        roi_mask).reshape(-1)
    w_max = max(f.shape[-1] for f in features)
    f_cat = torch.cat([F.pad(f, (0, w_max - f.shape[-1])) for f in features], dim=-2)
    wy_parts, wx_cat = [], None
    for li, (f, scale) in enumerate(zip(features, spatial_scales)):
        mask = levels == li
        wy, wx = build_roi_weights(rois.reshape(-1, 4), scale, tuple(f.shape[-2:]), p,
                                   sampling_ratio, roi_mask=mask)
        wx = F.pad(wx * mask[:, None, None].to(wx.dtype), (0, w_max - wx.shape[-1]))
        wy_parts.append(wy)
        wx_cat = wx if wx_cat is None else wx_cat + wx
    wy_cat = torch.cat(wy_parts, dim=-1)
    return f_cat, wy_cat.reshape(b, k, p, -1), wx_cat.reshape(b, k, p, -1)
