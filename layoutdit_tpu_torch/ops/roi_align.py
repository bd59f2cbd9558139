"""Multiscale RoIAlign forward: CUDA kernel and its plain version.

Port of ``layoutdit_tpu/ops/roi_align.py`` (``multiscale_roi_align``
with its FPN level mapper) and of the Pallas forward in
``roi_align_pallas.py``. torchvision ``MultiScaleRoIAlign`` semantics,
``aligned=False``: each RoI is assigned one pyramid level by
``floor(canonical_level + log2(sqrt(area) / canonical_scale + 1e-6))``,
clipped to the levels given; its P x P bins each average
``sampling_ratio^2`` bilinear samples.

The kernel (``csrc/roi_align.cu``) replaces the Pallas ``_fwd_kernel``.
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
"""

from __future__ import annotations

import ctypes

import torch

from layoutdit_tpu_torch.ops import _build
from layoutdit_tpu_torch.ops.boxes import box_area

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-roi separable bilinear weights (Wy [R, P, H], Wx [R, P, W]) with
    the g x g within-bin sample average folded in."""
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    fn = lib.roi_align_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
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
    levels = roi_levels(
        rois, len(features), canonical_scale, canonical_level, roi_mask
    )
    out = roi_align_fwd(
        features, rois, levels, spatial_scales, output_size, sampling_ratio
    )
    if native_layout:
        return out
    return out.permute(0, 1, 4, 3, 2)
