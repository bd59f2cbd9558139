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
matrices; the CUDA forward samples the assigned level directly (a block
per RoI, a warp per bin column, 16-byte loads of 8 channels a lane, each
pixel once per bin, fp32 accumulation), the same
function without the atlas, which at 1024 px would be 65 MB against
227 KB of shared memory. It is bound by bytes on the H100 (the feature
pixels the RoIs touch plus the pooled output). The plain version keeps
the JAX package's separable weight formulation (``build_roi_weights``)
in fp32.

On a CUDA device both kernels take the pyramid as the detector makes it:
channels-last (channel stride 1, as the FPN's convolutions write it) with
any batch, row and column strides that keep 16-byte alignment, so the
fifth level's strided view ``x[..., ::2, ::2]`` needs no copy either. A
CUDA feature with another channel stride raises. They are built for
(output_size, sampling_ratio) (7, 2), the box head, and (14, 2), a mask
head; another pair raises. The forward also takes fp32 levels (a float32
compute dtype), the same kernel instantiated over fp32 (4 channels in a
lane's 16-byte load, C and the strides multiples of 4), counted apart
too (``roi_align_fwd.f32_launches``, a part of its launches); the
backward takes bf16 only and refuses fp32 with a message (float32
training on the card waits for its fp32 kernels).

Tolerance between the two on bf16 features: both accumulate in fp32 and
round once to bf16, so they differ by at most one bf16 rounding of the
output; the JAX Pallas path also rounds its weights and its intermediate
to bf16 and so sits a few bf16 roundings away from either.

The vmap of the JAX version over images is written out: features are
[B, C, H, W] and RoIs [B, K, 4].

``multiscale_roi_align`` is differentiable with respect to the features
only (``_RoIAlign``). The backward kernel gathers: each dF element is
summed by one thread in fp32, in a fixed order (RoI index, then bin),
over the RoIs whose footprint (``roi_footprints``) reaches its pixel, and
written once in bf16, so two runs give the same bits, as the JAX
kernel's sequential accumulator does; its plain version is
dF = sum_k Wy^T . dout . Wx over ``build_roi_weights``. The RoIs get no
gradient, as in the JAX package (stop-gradient proposals, zero
cotangents for the weights).

On the card the wrappers ``roi_align_fwd``, ``roi_align_bwd`` and
``roi_footprints_kernel`` call the registered operators
``layoutdit_torch::roi_align_fwd``, ``::roi_align_bwd`` and
``::roi_align_footprints`` (``ops/_library.py``), whose CUDA
implementations launch the kernels and count the launches;
``roi_align_launch`` is the forward's direct launch, without the
dispatcher, for timing the operator's host cost.

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

from layoutdit_tpu_torch.ops import _build, _library
from layoutdit_tpu_torch.ops.boxes import box_area

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_FOOTPRINT_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# (output_size, sampling_ratio) pairs the kernels are instantiated for
KERNEL_SIZES = ((7, 2), (14, 2))
_EMPTY_SPAN = (0, -1, 0, -1)


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


def _bin_size(extent: torch.Tensor, p: int) -> torch.Tensor:
    """extent / p, the true quotient on every device. A CUDA tensor
    divided by a Python number is multiplied by its reciprocal, often one
    rounding away from the quotient, which moves a bilinear weight
    by an ulp of the sample's coordinate (3e-5 at a 1024 px page's
    256-pixel level); the CPU, the JAX package and the kernels divide."""
    return extent / torch.full_like(extent, float(p))


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
    ys = start_h[:, None] + grid[None, :] * _bin_size(roi_h, p)[:, None]
    xs = start_w[:, None] + grid[None, :] * _bin_size(roi_w, p)[:, None]
    n = r.shape[0]
    wy = _bilinear_weight_matrix(ys, h).reshape(n, p, g, h).mean(dim=2)
    wx = _bilinear_weight_matrix(xs, w).reshape(n, p, g, w).mean(dim=2)
    if roi_mask is not None:
        wy = wy * roi_mask[:, None, None].to(wy.dtype)
    return wy, wx


def roi_footprints(
    rois: torch.Tensor,  # [..., 4]
    levels: torch.Tensor,  # [...]
    level_hw: list[tuple[int, int]],
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """int32 [..., 4] (y0, y1, x0, x1): each RoI's footprint on its
    assigned level, the inclusive row and column span of the pixels its
    bilinear taps give a non-zero weight (the support of its
    ``build_roi_weights`` rows and columns); ``(0, -1, 0, -1)``, an empty
    span, for level -1 or a RoI none of whose samples falls inside the
    level. The spec of the backward kernel's footprint pass."""
    shape = rois.shape[:-1]
    r = rois.reshape(-1, 4).float()
    lv = levels.reshape(-1).long()
    li = lv.clamp(min=0)
    hw = torch.tensor(level_hw, dtype=torch.float32, device=r.device)[li]  # [R, 2]
    scale = torch.tensor(spatial_scales, dtype=torch.float32, device=r.device)[li]
    p, g = output_size, sampling_ratio
    idx = torch.arange(p * g, dtype=torch.float32, device=r.device)
    grid = torch.div(idx, g, rounding_mode="floor") + (idx % g + 0.5) / g
    spans, inside = [], lv >= 0
    for axis, (a0, a1) in enumerate(((1, 3), (0, 2))):  # rows, then columns
        size = hw[:, axis, None]
        start = r[:, a0] * scale
        extent = (r[:, a1] * scale - start).clamp(min=1.0)
        c = start[:, None] + grid[None, :] * _bin_size(extent, p)[:, None]
        in_range = (c >= -1.0) & (c <= size)
        c = c.clamp(min=0.0)
        low = torch.floor(c)
        top = low >= size - 1
        low = torch.minimum(low, size - 1)
        last = torch.where(~top & (c - low > 0), low + 1, low)  # the high tap, where weighted
        spans += [torch.where(in_range, low, size).amin(dim=1),
                  torch.where(in_range, last, -1.0).amax(dim=1)]
        inside &= in_range.any(dim=1)
    out = torch.stack(spans, dim=-1).to(torch.int32)
    empty = torch.tensor(_EMPTY_SPAN, dtype=torch.int32, device=r.device)
    return torch.where(inside[:, None], out, empty).reshape(*shape, 4)


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
        for fn, args in ((lib.roi_align_fwd, _ARGTYPES), (lib.roi_align_fwd_f32, _ARGTYPES),
                         (lib.roi_align_footprints, _FOOTPRINT_ARGTYPES),
                         (lib.roi_align_bwd, _BWD_ARGTYPES)):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _check_sizes(what: str, output_size: int, sampling_ratio: int) -> None:
    if (output_size, sampling_ratio) not in KERNEL_SIZES:
        raise ValueError(
            f"{what}: the CUDA kernels are instantiated for (output_size, sampling_ratio) "
            f"in {KERNEL_SIZES}, got ({output_size}, {sampling_ratio}); add the pair to "
            "csrc/roi_align.cu"
        )


def _check_level(what: str, t: torch.Tensor, b: int, c: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> None:
    """A CUDA level as the kernels read or write it: [B, C, H, W] in
    ``dtype`` (bf16, or fp32 for the forward) on ``device``, channel
    stride 1, 16-byte aligned (C and the strides of the other dimensions
    longer than 1 multiples of 8 bf16 or 4 fp32 elements)."""
    name, vec = _library.KERNEL_DTYPES[dtype]
    if t.dtype != dtype or t.device != device or t.shape[:2] != (b, c):
        raise ValueError(f"{what}: levels must be {name} [{b}, {c}, H, W] on {device} (all "
                         f"alike; the forward takes bf16 or fp32, the backward bf16), got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(1) != 1:
        raise ValueError(
            f"{what}: a CUDA level must be channels-last (channel stride 1), got strides "
            f"{t.stride()}; the detector's FPN writes its levels so, and the kernels do not copy"
        )
    if c % vec or t.data_ptr() % 16 or any(
        t.shape[d] > 1 and t.stride(d) % vec for d in (0, 2, 3)
    ):
        raise ValueError(f"{what}: a CUDA level must be 16-byte aligned (C and its strides "
                         f"multiples of {vec}), got C={c}, strides {t.stride()}")


def _geometry(features: list[torch.Tensor], spatial_scales: list[float]):
    n = len(features)
    hw = (ctypes.c_int * (2 * n))(*[s for f in features for s in f.shape[-2:]])
    return hw, (ctypes.c_float * n)(*spatial_scales), n


def roi_align_launch(
    features: list[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """The direct launch of the forward kernel on CUDA tensors (bf16
    levels, or fp32: the float32 form): checks, allocates the pooled
    [B, K, Px, Py, C] in the levels' dtype, launches; counts nothing (the
    operator ``layoutdit_torch::roi_align_fwd`` counts on
    ``roi_align_fwd``)."""
    _check_sizes("roi_align", output_size, sampling_ratio)
    b, k = rois.shape[:2]
    c = features[0].shape[1]
    p = output_size
    dtype = _library.kernel_dtype(features[0])
    for f in features:
        _check_level("roi_align", f, b, c, rois.device, dtype)
    hw, scales, n = _geometry(features, spatial_scales)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in features])
    strides = (ctypes.c_longlong * (4 * n))(*[s for f in features for s in f.stride()])
    rois_c = rois.float().contiguous()
    levels_c = levels.to(torch.int32).contiguous()
    out = torch.empty((b, k, p, p, c), dtype=dtype, device=rois.device)
    lib = _lib()
    fwd = lib.roi_align_fwd_f32 if dtype == torch.float32 else lib.roi_align_fwd
    code = fwd(
        ptrs, strides, hw, scales, n, rois_c.data_ptr(), levels_c.data_ptr(),
        out.data_ptr(), b * k, k, c, p, sampling_ratio, _build.stream_ptr(rois),
    )
    _build.check(lib, code, "roi_align")
    return out


def _fwd_cuda(features, rois, levels, spatial_scales, output_size, sampling_ratio):
    out = roi_align_launch(features, rois, levels, spatial_scales, output_size, sampling_ratio)
    roi_align_fwd.launches += 1
    roi_align_fwd.f32_launches += out.dtype == torch.float32
    return out


def _fwd_fake(features, rois, levels, spatial_scales, output_size, sampling_ratio):
    b, k = rois.shape[:2]
    p, c = output_size, features[0].shape[1]
    return rois.new_empty((b, k, p, p, c), dtype=features[0].dtype)


_fwd_op = _library.define(
    "roi_align_fwd(Tensor[] features, Tensor rois, Tensor levels, float[] spatial_scales, "
    "int output_size, int sampling_ratio) -> Tensor",
    fake=_fwd_fake, cuda=_fwd_cuda,
)


def roi_align_fwd(
    features: list[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """-> pooled [B, K, Px, Py, C]: the kernel for CUDA tensors (through
    the operator ``layoutdit_torch::roi_align_fwd``), the plain version
    for CPU tensors. The kernel reads bf16 or fp32 channels-last levels
    through their strides, as they are; it raises on any other."""
    if rois.device.type == "cpu":
        return roi_align_plain(
            features, rois, levels, spatial_scales, output_size, sampling_ratio
        )
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {rois.device}")
    return _fwd_op(list(features), rois, levels, [float(x) for x in spatial_scales],
                   output_size, sampling_ratio)


# launches of the kernel, and of them those of its float32 form
roi_align_fwd.launches = 0
roi_align_fwd.f32_launches = 0


def _taps_scratch(r: int, p: int, g: int, device: torch.device) -> torch.Tensor:
    """The backward's per-RoI table of bin taps (pixel, weight bits), 448
    bytes a RoI at P = 7: its first pass writes it, the gather reads it."""
    return torch.empty((r, 2, p, 2 * g, 2), dtype=torch.int32, device=device)


def _footprints_cuda(rois, levels, level_hw, spatial_scales, output_size, sampling_ratio):
    _check_sizes("roi_footprints_kernel", output_size, sampling_ratio)
    n = len(spatial_scales)
    hw = (ctypes.c_int * (2 * n))(*level_hw)
    scales = (ctypes.c_float * n)(*spatial_scales)
    rois_c = rois.float().contiguous()
    levels_c = levels.to(torch.int32).contiguous()
    out = torch.empty((*rois.shape[:-1], 4), dtype=torch.int32, device=rois.device)
    taps = _taps_scratch(levels_c.numel(), output_size, sampling_ratio, rois.device)
    lib = _lib()
    code = lib.roi_align_footprints(
        hw, scales, n, rois_c.data_ptr(), levels_c.data_ptr(), taps.data_ptr(), out.data_ptr(),
        levels_c.numel(), output_size, sampling_ratio, _build.stream_ptr(rois),
    )
    _build.check(lib, code, "roi_footprints_kernel")
    return out


_footprints_op = _library.define(
    "roi_align_footprints(Tensor rois, Tensor levels, int[] level_hw, float[] spatial_scales, "
    "int output_size, int sampling_ratio) -> Tensor",
    fake=lambda rois, levels, *args: rois.new_empty((*rois.shape[:-1], 4), dtype=torch.int32),
    cuda=_footprints_cuda,
)


def roi_footprints_kernel(
    rois: torch.Tensor,
    levels: torch.Tensor,
    level_hw: list[tuple[int, int]],
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """The backward kernel's first pass alone, ``roi_footprints`` of [B, K]
    RoIs on the card -> int32 [B, K, 4]: for checking it against its spec
    (``roi_align_bwd`` launches the pass itself). Through the operator
    ``layoutdit_torch::roi_align_footprints``."""
    if rois.device.type != "cuda":
        raise ValueError(f"roi_footprints_kernel: needs CUDA tensors, got {rois.device}")
    return _footprints_op(rois, levels, [int(s) for h_w in level_hw for s in h_w],
                          [float(x) for x in spatial_scales], output_size, sampling_ratio)


def _bwd_cuda(dout, rois, levels, features, spatial_scales, output_size, sampling_ratio):
    _library.refuse_float32_backward("roi_align_bwd", dout, *features)
    _check_sizes("roi_align_bwd", output_size, sampling_ratio)
    b, k = rois.shape[:2]
    c = features[0].shape[1]
    p = output_size
    if (dout.shape != (b, k, p, p, c) or dout.dtype != torch.bfloat16
            or dout.device != rois.device):
        raise ValueError(
            f"roi_align_bwd: dout must be bf16 [{b}, {k}, {p}, {p}, {c}] on {rois.device}, "
            f"got {dout.dtype} {tuple(dout.shape)} on {dout.device}"
        )
    dout_c = dout.contiguous()
    if dout_c.data_ptr() % 16:
        raise ValueError("roi_align_bwd: dout must be 16-byte aligned")
    grads = []
    for f in features:
        _check_level("roi_align_bwd", f, b, c, rois.device)
        grads.append(torch.empty_like(f))
        _check_level("roi_align_bwd", grads[-1], b, c, rois.device)
    hw, scales, n = _geometry(features, spatial_scales)
    ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in grads])
    strides = (ctypes.c_longlong * (4 * n))(*[s for t in grads for s in t.stride()])
    rois_c = rois.float().contiguous()
    levels_c = levels.to(torch.int32).contiguous()
    footprints = torch.empty((b * k, 4), dtype=torch.int32, device=rois.device)
    taps = _taps_scratch(b * k, p, sampling_ratio, rois.device)
    lib = _lib()
    code = lib.roi_align_bwd(
        ptrs, strides, hw, scales, n, rois_c.data_ptr(), levels_c.data_ptr(),
        dout_c.data_ptr(), taps.data_ptr(), footprints.data_ptr(), b * k, k, c, p,
        sampling_ratio, _build.stream_ptr(rois),
    )
    _build.check(lib, code, "roi_align_bwd")
    roi_align_bwd.launches += 1
    return grads


_bwd_op = _library.define(
    "roi_align_bwd(Tensor dout, Tensor rois, Tensor levels, Tensor[] features, "
    "float[] spatial_scales, int output_size, int sampling_ratio) -> Tensor[]",
    fake=lambda dout, rois, levels, features, *args: [torch.empty_like(f) for f in features],
    cuda=_bwd_cuda,
)


def roi_align_bwd(
    dout: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    features: list[torch.Tensor],
    spatial_scales: list[float],
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> list[torch.Tensor]:
    """dF per level [B, C, H_l, W_l] in the features' dtype: the kernel for
    CUDA tensors, the plain version for CPU tensors. The kernel writes
    every element once, in bf16, into a tensor laid out as its feature
    (``empty_like``: channels-last; dense for the strided fifth level), the
    same bits on every run; it takes bf16 only (a float32 level or dout
    raises ``_library.FLOAT32_TRAINING``). ``features`` give only shapes,
    dtypes and layouts."""
    if rois.device.type == "cpu":
        return roi_align_bwd_plain(
            dout, rois, levels, features, spatial_scales, output_size, sampling_ratio
        )
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align_bwd: unsupported device {rois.device}")
    return _bwd_op(dout, rois, levels, list(features), [float(x) for x in spatial_scales],
                   output_size, sampling_ratio)


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
