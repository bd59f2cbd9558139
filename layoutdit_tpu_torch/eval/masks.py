"""Host-side mask post-processing: paste, RLE export, segm IoU (a copy of
``layoutdit_tpu/eval/masks.py`` for the port).

Completes the Mask R-CNN branch on the evaluation side, with the
semantics of the pycocotools / torchvision pair:

  * ``paste_mask_in_box``: torchvision ``paste_masks_in_image`` for one
    detection. The 2P x 2P sigmoid map gets 1 px of padding (and the box
    the matching (2P + 2) / 2P factor, so the bilinear resize does not
    clip the mask's border), is resized to the box's integer pixel span
    and thresholded at 0.5. It returns the box-local window and its
    offset; a full-page canvas is made only on request
    (``window_to_full``).
  * ``mask_iou``: pycocotools ``maskUtils.iou`` over box-cropped bitmaps
    (a crowd gt: intersection / the detection's area).
  * ``encode_rle``: COCO's uncompressed RLE dict (column-major runs), so
    ``predictions.json`` stays interchangeable.
"""

from __future__ import annotations

import numpy as np

from layoutdit_tpu_torch.ops.interpolate import resize_bilinear_np

Window = tuple[int, int, np.ndarray]  # (x0, y0, bitmap uint8 [h, w])


def paste_mask_in_box(
    prob: np.ndarray,  # [P, P] float sigmoid map (box-relative)
    box: np.ndarray,  # [4] xyxy in image space
    im_h: int,
    im_w: int,
    thresh: float = 0.5,
) -> Window:
    """One detection's thresholded bitmap in its image-space window."""
    p = prob.shape[-1]
    scale = (p + 2.0) / p
    padded = np.zeros((p + 2, p + 2), np.float32)
    padded[1:-1, 1:-1] = prob

    cx, cy = (box[0] + box[2]) * 0.5, (box[1] + box[3]) * 0.5
    half_w = (box[2] - box[0]) * 0.5 * scale
    half_h = (box[3] - box[1]) * 0.5 * scale
    x0, x1 = int(np.floor(cx - half_w)), int(np.ceil(cx + half_w))
    y0, y1 = int(np.floor(cy - half_h)), int(np.ceil(cy + half_h))
    w = max(x1 - x0 + 1, 1)
    h = max(y1 - y0 + 1, 1)

    resized = resize_bilinear_np(padded, h, w)
    bitmap = (resized > thresh).astype(np.uint8)

    # clamp the window to the image, slicing the bitmap to match
    cx0, cy0 = max(x0, 0), max(y0, 0)
    cx1, cy1 = min(x1 + 1, im_w), min(y1 + 1, im_h)
    if cx1 <= cx0 or cy1 <= cy0:
        return 0, 0, np.zeros((0, 0), np.uint8)
    return cx0, cy0, bitmap[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]


def window_to_full(win: Window, im_h: int, im_w: int) -> np.ndarray:
    x0, y0, bm = win
    out = np.zeros((im_h, im_w), np.uint8)
    if bm.size:
        out[y0:y0 + bm.shape[0], x0:x0 + bm.shape[1]] = bm
    return out


def full_to_window(mask: np.ndarray) -> Window:
    """Crop a full-image bitmap to its tight bounding window."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return 0, 0, np.zeros((0, 0), np.uint8)
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    return x0, y0, np.ascontiguousarray(mask[y0:y1, x0:x1], dtype=np.uint8)


def encode_rle(win: Window, im_h: int, im_w: int) -> dict:
    """COCO uncompressed RLE (column-major runs over the full image)."""
    full = window_to_full(win, im_h, im_w)
    flat = full.T.ravel()  # column-major
    # run-length encode starting with a 0-run
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return {"size": [im_h, im_w], "counts": [int(r) for r in runs]}


def _pair_intersection(a: Window, b: Window) -> int:
    ax0, ay0, am = a
    bx0, by0, bm = b
    if am.size == 0 or bm.size == 0:
        return 0
    x0 = max(ax0, bx0)
    y0 = max(ay0, by0)
    x1 = min(ax0 + am.shape[1], bx0 + bm.shape[1])
    y1 = min(ay0 + am.shape[0], by0 + bm.shape[0])
    if x1 <= x0 or y1 <= y0:
        return 0
    asl = am[y0 - ay0:y1 - ay0, x0 - ax0:x1 - ax0]
    bsl = bm[y0 - by0:y1 - by0, x0 - bx0:x1 - bx0]
    return int(np.sum(asl.astype(np.int32) & bsl))


def mask_iou(
    dt: list[Window],
    gt: list[Window],
    iscrowd: np.ndarray,  # [G] bool
) -> np.ndarray:
    """pycocotools maskUtils.iou over cropped bitmaps: [D, G]."""
    d_area = np.array([int(w[2].sum()) for w in dt], float)
    g_area = np.array([int(w[2].sum()) for w in gt], float)
    out = np.zeros((len(dt), len(gt)))
    for di, dwin in enumerate(dt):
        for gi, gwin in enumerate(gt):
            inter = _pair_intersection(dwin, gwin)
            union = d_area[di] if iscrowd[gi] else (
                d_area[di] + g_area[gi] - inter
            )
            out[di, gi] = inter / union if union > 0 else 0.0
    return out
