"""Resizes with PyTorch ``align_corners=False`` semantics.

Port of ``layoutdit_tpu/ops/interpolate.py``. The JAX package builds
interpolation matrices to reproduce ``F.interpolate`` exactly; here
``F.interpolate`` is the function itself. The JAX package's numpy
``resize_bilinear_np`` (host-side page decode) has no counterpart: the
port's serving engine resizes pages on the device with
``resize_bilinear``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _resize(x: torch.Tensor, out_h: int, out_w: int, mode: str) -> torch.Tensor:
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(
        x.reshape(-1, 1, in_h, in_w) if x.dim() != 4 else x,
        size=(out_h, out_w), mode=mode, align_corners=False,
    )
    return y.reshape(*lead, out_h, out_w)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W] -> [..., out_h, out_w], torch bilinear."""
    return _resize(x, out_h, out_w, "bilinear")


@functools.lru_cache(maxsize=None)
def _cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bicubic interpolation matrix (A = -0.75), torch
    UpSampleBicubic2d align_corners=False: 4 taps per output, indices
    clamped at the edges."""
    a = -0.75

    def w(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t**3 - (a + 3) * t**2 + 1
        if t < 2:
            return a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a
        return 0.0

    scale = in_size / out_size
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for d in range(out_size):
        src = (d + 0.5) * scale - 0.5
        fl = np.floor(src)
        t = src - fl
        for k in range(-1, 3):
            m[d, int(np.clip(fl + k, 0, in_size - 1))] += w(k - t)
    return m.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W] with torch bicubic semantics in float32 (BEiT
    position-embedding interpolation), as two small matmuls: torch's own
    bicubic kernel loops over channels per output pixel, milliseconds for
    768 channels on an H100."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    a_h = torch.from_numpy(_cubic_matrix(in_h, out_h)).to(x.device)
    a_w = torch.from_numpy(_cubic_matrix(in_w, out_w)).to(x.device)
    return (a_h @ x.float() @ a_w.T).to(x.dtype)


def max_pool_stride2(x: torch.Tensor) -> torch.Tensor:
    """torchvision LastLevelMaxPool (kernel 1, stride 2) = x[..., ::2, ::2]."""
    return x[..., ::2, ::2]
