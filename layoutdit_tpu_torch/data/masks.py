"""COCO segmentation decode and gt mask rasterisation, host side (a copy
of ``layoutdit_tpu/data/masks.py`` for the port, which imports nothing of
the JAX package).

Feeds the Mask R-CNN branch (``models/detection/mask_head.py``) and the
segm evaluator. The full COCO spec:

  * polygon lists ``[[x1, y1, x2, y2, ...], ...]``, filled with PIL's
    ``ImageDraw`` directly at the target grid (coordinates scaled by
    ``out / orig``), so no full-resolution bitmap is made; PIL is
    imported only when a polygon is rasterised;
  * uncompressed RLE ``{"counts": [ints], "size": [h, w]}``, expanded
    column-major;
  * compressed RLE ``{"counts": "<str>", "size": [h, w]}``, pycocotools'
    character varint coding (5 data bits a byte offset by 48, 0x20 the
    continuation bit, sign-extended on 0x10, runs delta-coded against
    counts[i - 2]).

PIL's integer polygon fill and pycocotools' ``frPyObjects`` differ by
sub-pixel amounts along edges. Training targets are binarised after a
further RoIAlign crop, and the segm evaluator rasterises predictions
and gt with the same routine, so the protocol stays consistent.
"""

from __future__ import annotations

import numpy as np


def decode_compressed_rle(counts: str) -> list[int]:
    """pycocotools ``rleFrString``: char varint, delta-coded runs."""
    out: list[int] = []
    p = 0
    while p < len(counts):
        x = 0
        k = 0
        while True:
            c = ord(counts[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            p += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return out


def rle_to_mask(counts, size) -> np.ndarray:
    """RLE runs (starting with a 0-run) -> [h, w] uint8, COLUMN-major
    (COCO stores masks Fortran-ordered)."""
    h, w = int(size[0]), int(size[1])
    if isinstance(counts, (str, bytes)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        counts = decode_compressed_rle(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        run = int(run)
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def rasterize_instance(
    segmentation,
    orig_h: float,
    orig_w: float,
    out_size: int,
) -> np.ndarray:
    """One COCO ``segmentation`` entry -> [out_size, out_size] uint8 on
    the model-space grid (the whole image mapped onto out x out)."""
    if isinstance(segmentation, dict):
        m = rle_to_mask(segmentation["counts"], segmentation["size"])
        # nearest-neighbor resample onto the out grid (pixel centers)
        ys = np.clip(
            ((np.arange(out_size) + 0.5) * m.shape[0] / out_size).astype(int),
            0, m.shape[0] - 1,
        )
        xs = np.clip(
            ((np.arange(out_size) + 0.5) * m.shape[1] / out_size).astype(int),
            0, m.shape[1] - 1,
        )
        return m[np.ix_(ys, xs)]

    from PIL import Image, ImageDraw

    img = Image.new("L", (out_size, out_size), 0)
    draw = ImageDraw.Draw(img)
    sx = out_size / float(orig_w)
    sy = out_size / float(orig_h)
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        draw.polygon(
            [(float(x * sx), float(y * sy)) for x, y in pts], fill=1
        )
    return np.asarray(img, np.uint8)


def rasterize_fullsize(segmentation, h: int, w: int) -> np.ndarray:
    """One COCO segmentation entry at NATIVE [h, w] resolution (the segm
    evaluator's exact grid; the model-space ``rasterize_instance`` above
    is the training-target path)."""
    h, w = int(h), int(w)
    if isinstance(segmentation, dict):
        m = rle_to_mask(segmentation["counts"], segmentation["size"])
        if m.shape != (h, w):  # RLE at a different size: nearest resample
            ys = np.clip(((np.arange(h) + 0.5) * m.shape[0] / h).astype(int),
                         0, m.shape[0] - 1)
            xs = np.clip(((np.arange(w) + 0.5) * m.shape[1] / w).astype(int),
                         0, m.shape[1] - 1)
            m = m[np.ix_(ys, xs)]
        return m

    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        draw.polygon([(float(x), float(y)) for x, y in pts], fill=1)
    return np.asarray(img, np.uint8)


def rasterize_target_masks(
    segmentations: list,
    orig_h: float,
    orig_w: float,
    out_size: int,
    max_gt: int,
) -> np.ndarray:
    """Padded [max_gt, out, out] uint8 block for one image (rows past
    ``len(segmentations)`` stay zero; entries that are None stay zero)."""
    out = np.zeros((max_gt, out_size, out_size), np.uint8)
    for i, seg in enumerate(segmentations[:max_gt]):
        if seg:
            out[i] = rasterize_instance(seg, orig_h, orig_w, out_size)
    return out
