"""Anchor generation (torchvision AnchorGenerator parity; a numpy copy of
``layoutdit_tpu/models/detection/anchors.py``). Anchors depend only on
static shapes, so they are built once per bucket on the host."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def cell_anchors(sizes: tuple[float, ...], ratios: tuple[float, ...]) -> np.ndarray:
    """[A, 4] zero-centered anchors, torchvision generate_anchors: rounded
    half-sizes with h = size*sqrt(ratio), w = size/sqrt(ratio)."""
    scales = np.asarray(sizes, dtype=np.float32)
    aspect = np.asarray(ratios, dtype=np.float32)
    h_ratios = np.sqrt(aspect)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base)


@functools.lru_cache(maxsize=None)
def grid_anchors(
    image_size: tuple[int, int],
    grid_sizes: tuple[tuple[int, int], ...],
    sizes: tuple[tuple[float, ...], ...],
    ratios: tuple[tuple[float, ...], ...],
) -> tuple[np.ndarray, tuple[int, ...]]:
    """All anchors for an image, concatenated over FPN levels.

    Returns ([N, 4] float32 xyxy, per-level counts); per level row-major
    over (y, x) grid cells, A anchors per cell, integer strides
    ``image_size // grid_size``.
    """
    all_anchors = []
    counts = []
    for (gh, gw), s, r in zip(grid_sizes, sizes, ratios):
        base = cell_anchors(tuple(s), tuple(r))
        stride_h = image_size[0] // gh
        stride_w = image_size[1] // gw
        shifts_x = np.arange(gw, dtype=np.float32) * stride_w
        shifts_y = np.arange(gh, dtype=np.float32) * stride_h
        sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
        shifts = np.stack(
            [sx.reshape(-1), sy.reshape(-1), sx.reshape(-1), sy.reshape(-1)], axis=1
        )
        anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
        all_anchors.append(anchors.astype(np.float32))
        counts.append(len(anchors))
    return np.concatenate(all_anchors, axis=0), tuple(counts)
