"""COCO-style bbox mAP evaluation in pure numpy, vectorized (a copy of
``layoutdit_tpu/eval/coco_eval.py`` for the port, which imports nothing
of the JAX package).

A reimplementation of pycocotools' COCOeval bbox protocol: greedy
per-image matching over 10 IoU thresholds (0.50:0.05:0.95), ignore
handling for crowd / area-range, 101-point interpolated precision, and
the standard 12-metric summary, plus the per-class ``AP-{name}`` /
``AP50-{name}``. Host-side numpy, off the device path.

The hot loops are vectorized as in the JAX package:

  * the IoU matrix per (image, category) is computed ONCE and reused across
    all four area ranges (only the ignore flags depend on the range),
  * the greedy match runs one short python loop over detection rank; for
    each rank all pairs, all 10 IoU thresholds and all gt boxes are
    resolved in a handful of numpy ops (exact pycocotools semantics incl.
    the last-max tie rule and the non-ignored-before-ignored break),
  * (image, category) pairs with no gt and no detections are skipped
    outright (pycocotools' evaluateImg returns None for those),
  * accumulate's precision envelope is a reversed cummax and the 101-point
    sampling a searchsorted, both over all thresholds at once.

The scalar transcription of COCOeval.evaluateImg is kept as
``_match_img_ref`` as a differential-test oracle (tests/test_torch_eval.py).

``iou_type="segm"`` scores instance masks (pycocotools' mask IoU over
box-cropped bitmaps, ``eval/masks.py``): a detection's ``segmentation``
is a pasted ``(x0, y0, bitmap)`` window (the evaluator's fast path), an
RLE dict or a polygon list; gt segmentations are rasterised at their
page's size, and a detection's area is its mask's.
"""

from __future__ import annotations

import numpy as np

from layoutdit_tpu_torch.data.masks import rasterize_fullsize
from layoutdit_tpu_torch.eval import masks as emasks

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)

COCO_KEYS = [
    "mAP", "AP50", "AP75", "AP_s", "AP_m", "AP_l",
    "AR1", "AR10", "AR100", "AR_s", "AR_m", "AR_l",
]


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools maskUtils.iou for bbox: [D, G]; crowd gt use
    intersection / det-area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.maximum(
        0.0,
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dt[:, 0][:, None], gt[:, 0][None]),
    )
    iy = np.maximum(
        0.0,
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dt[:, 1][:, None], gt[:, 1][None]),
    )
    inter = ix * iy
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / union, 0.0)


def _to_window(seg, h: int, w: int):
    """A detection's or gt's ``segmentation`` in any supported form ->
    its cropped bitmap window: a pasted ``(x0, y0, bitmap)`` tuple as it
    is, an RLE dict or a polygon list rasterised at [h, w]."""
    if isinstance(seg, tuple):
        return seg
    return emasks.full_to_window(rasterize_fullsize(seg, h, w))


class _Pair:
    """Sorted detections + gt metadata + IoU matrix for one (image, cat),
    shared across the four area ranges."""

    __slots__ = ("ious", "scores", "d_areas", "g_areas", "iscrowd")

    def __init__(self, gt: list, dt: list, max_det: int,
                 iou_type: str = "bbox", img_size=None):
        d_order = np.argsort([-d["score"] for d in dt], kind="stable")[:max_det]
        d_boxes = np.array([dt[i]["bbox"] for i in d_order], float).reshape(-1, 4)
        self.scores = np.array([dt[i]["score"] for i in d_order], float)
        self.iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gt], bool)
        if iou_type == "segm":
            # mask IoU; the areas are the masks' (a gt keeps its
            # annotation's "area" when it has one)
            h, w = img_size
            d_wins = [_to_window(dt[i]["segmentation"], h, w) for i in d_order]
            g_wins = [_to_window(g["segmentation"], h, w) for g in gt]
            self.d_areas = np.array([int(x[2].sum()) for x in d_wins], float)
            self.g_areas = np.array(
                [g.get("area", int(x[2].sum())) for g, x in zip(gt, g_wins)], float
            )
            self.ious = emasks.mask_iou(d_wins, g_wins, self.iscrowd)
        else:
            self.d_areas = d_boxes[:, 2] * d_boxes[:, 3]
            g_boxes = np.array([g["bbox"] for g in gt], float).reshape(-1, 4)
            self.g_areas = np.array(
                [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gt], float
            )
            self.ious = _iou_xywh(d_boxes, g_boxes, self.iscrowd.astype(int))


class CocoEvaluator:
    """Evaluate COCO-format predictions against COCO-format ground truth.

    gt: the raw ``coco_data`` dict (images/annotations/categories) that the
    dataset caches (reference publay_dataset.py:25, evaluator.py:51-62).
    """

    def __init__(self, coco_gt: dict, iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type must be bbox or segm, got {iou_type}")
        self.iou_type = iou_type
        self.cat_ids = [c["id"] for c in coco_gt["categories"]]
        self.cat_names = {
            c["id"]: str(c.get("name", c["id"])) for c in coco_gt["categories"]
        }
        self.img_ids = [im["id"] for im in coco_gt["images"]]
        self._img_sizes = {
            im["id"]: (int(im.get("height", 0)), int(im.get("width", 0)))
            for im in coco_gt["images"]
        }
        self._gt: dict[tuple, list] = {
            (i, c): [] for i in self.img_ids for c in self.cat_ids
        }
        for ann in coco_gt["annotations"]:
            key = (ann["image_id"], ann["category_id"])
            if key in self._gt:
                self._gt[key].append(ann)

    # ------------------------------------------------------------ matching

    @staticmethod
    def _match_pairs(pairs: list[_Pair], area_rng) -> list[dict]:
        """COCOeval.evaluateImg for many prepared (image, cat) pairs at one
        area range. Pairs are bucketed by padded (D, G) size and the greedy
        match runs ONE python loop over detection rank, with all pairs, all
        10 IoU thresholds and all gt resolved in vectorized [P, T, G] ops —
        exact pycocotools semantics incl. the last-max tie rule and the
        non-ignored-before-ignored break."""
        lo, hi = area_rng
        t_n = len(IOU_THRS)
        thr = np.minimum(IOU_THRS, 1 - 1e-10)  # [T]
        results: list[dict | None] = [None] * len(pairs)

        def n_gt_of(pair):
            ig = pair.iscrowd | (pair.g_areas < lo) | (pair.g_areas > hi)
            return int((~ig).sum())

        def pow2(n):
            return 1 << (n - 1).bit_length()

        buckets: dict[tuple[int, int], list[int]] = {}
        for i, pair in enumerate(pairs):
            d_n, g_n = pair.ious.shape
            if d_n == 0 or g_n == 0:
                d_out = (pair.d_areas < lo) | (pair.d_areas > hi)
                results[i] = {
                    "dtm": np.zeros((t_n, d_n), np.int64),
                    "dt_ig": np.broadcast_to(d_out[None, :], (t_n, d_n)),
                    "scores": pair.scores,
                    "n_gt": n_gt_of(pair),
                }
                continue
            buckets.setdefault((pow2(d_n), pow2(g_n)), []).append(i)

        for idxs in buckets.values():
            p_n = len(idxs)
            d_max = max(pairs[i].ious.shape[0] for i in idxs)
            g_max = max(pairs[i].ious.shape[1] for i in idxs)
            # padding: iou -1 never reaches a threshold; padded gt marked
            # ignored so they can't be preferred, padded det rows are
            # sliced away per pair below
            ious = np.full((p_n, d_max, g_max), -1.0)
            gt_ignore = np.ones((p_n, g_max), bool)
            iscrowd = np.zeros((p_n, g_max), bool)
            for j, i in enumerate(idxs):
                pair = pairs[i]
                g_n = pair.ious.shape[1]
                ig_orig = (
                    pair.iscrowd | (pair.g_areas < lo) | (pair.g_areas > hi)
                )
                # non-ignored gt first (stable), as COCOeval sorts by _ignore
                g_order = np.argsort(ig_orig, kind="stable")
                gt_ignore[j, :g_n] = ig_orig[g_order]
                iscrowd[j, :g_n] = pair.iscrowd[g_order]
                ious[j, : pair.ious.shape[0], :g_n] = pair.ious[:, g_order]

            non_ig = ~gt_ignore  # [P, G]
            gtm = np.zeros((p_n, t_n, g_max), np.int64)
            dtm = np.zeros((p_n, t_n, d_max), np.int64)
            dt_ig = np.zeros((p_n, t_n, d_max), bool)
            for di in range(d_max):
                row = ious[:, None, di, :]  # [P, 1, G]
                # crowd gt may match many dets; others only while unmatched
                cand = np.where((gtm == 0) | iscrowd[:, None, :], row, -1.0)
                # Greedy scan semantics (COCOeval.evaluateImg): running max
                # starting at the threshold, later gt wins ties, and the
                # scan breaks at the first ignored gt once a non-ignored
                # match exists — i.e. prefer the best qualifying
                # non-ignored gt; only if none qualifies, the best ignored.
                c_ni = np.where(non_ig[:, None, :], cand, -1.0)
                c_ig = np.where(non_ig[:, None, :], -1.0, cand)
                # index of the LAST maximum (ties go to the later gt)
                m_ni = g_max - 1 - np.argmax(c_ni[:, :, ::-1], axis=2)
                m_ig = g_max - 1 - np.argmax(c_ig[:, :, ::-1], axis=2)
                ok_ni = c_ni.max(axis=2) >= thr[None, :]
                ok_ig = c_ig.max(axis=2) >= thr[None, :]
                matched = ok_ni | ok_ig  # [P, T]
                m_safe = np.where(matched, np.where(ok_ni, m_ni, m_ig), 0)
                dtm[:, :, di] = np.where(matched, m_safe + 1, 0)
                dt_ig[:, :, di] = matched & np.take_along_axis(
                    gt_ignore, m_safe, axis=1
                )
                pi, ti = np.nonzero(matched)
                gtm[pi, ti, m_safe[pi, ti]] = di + 1

            for j, i in enumerate(idxs):
                pair = pairs[i]
                d_n = pair.ious.shape[0]
                # unmatched dets outside the area range are ignored
                d_out = (pair.d_areas < lo) | (pair.d_areas > hi)
                dtm_p = dtm[j, :, :d_n]
                results[i] = {
                    "dtm": dtm_p,
                    "dt_ig": dt_ig[j, :, :d_n] | ((dtm_p == 0) & d_out[None, :]),
                    "scores": pair.scores,
                    "n_gt": n_gt_of(pair),
                }
        return results

    @staticmethod
    def _match_img_ref(gt: list, dt: list, area_rng, max_det: int) -> dict:
        """Scalar transcription of COCOeval.evaluateImg — the
        differential-test oracle for ``_match_pair`` (not used in
        production scoring)."""
        gt_ignore = np.array(
            [
                bool(g.get("iscrowd", 0))
                or not (
                    # pycocotools gates with INCLUSIVE bounds (ignore only
                    # when area < lo or area > hi)
                    area_rng[0]
                    <= g.get("area", g["bbox"][2] * g["bbox"][3])
                    <= area_rng[1]
                )
                for g in gt
            ],
            bool,
        )
        # non-ignored gt first (stable), as COCOeval sorts by _ignore
        g_order = np.argsort(gt_ignore, kind="stable")
        gt = [gt[i] for i in g_order]
        gt_ignore = gt_ignore[g_order]
        iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gt])

        d_order = np.argsort([-d["score"] for d in dt], kind="stable")[:max_det]
        dt = [dt[i] for i in d_order]

        g_boxes = np.array([g["bbox"] for g in gt], float).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dt], float).reshape(-1, 4)
        ious = _iou_xywh(d_boxes, g_boxes, iscrowd)

        t_n = len(IOU_THRS)
        dtm = np.zeros((t_n, len(dt)), dtype=np.int64)
        gtm = np.zeros((t_n, len(gt)), dtype=np.int64)
        dt_ig = np.zeros((t_n, len(dt)), bool)
        for ti, t in enumerate(IOU_THRS):
            for di in range(len(dt)):
                best_iou = min(t, 1 - 1e-10)
                m = -1
                for gi in range(len(gt)):
                    # gt already matched (crowd may match many)
                    if gtm[ti, gi] > 0 and not iscrowd[gi]:
                        continue
                    # past non-ignored gt and into ignored ones: stop
                    if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ignore[m]
                dtm[ti, di] = m + 1
                gtm[ti, m] = di + 1
        # unmatched dets outside the area range are ignored
        d_out = np.array(
            [
                not (area_rng[0] <= d["bbox"][2] * d["bbox"][3] <= area_rng[1])
                for d in dt
            ],
            bool,
        ).reshape(1, -1)
        dt_ig = dt_ig | ((dtm == 0) & d_out)
        return {
            "dtm": dtm,
            "dt_ig": dt_ig,
            "scores": np.array([d["score"] for d in dt], float),
            "n_gt": int((~gt_ignore).sum()),
        }

    @staticmethod
    def _accumulate(per_img: list[dict], max_det: int):
        """COCOeval.accumulate for one (cat, area, maxDet):
        -> (precision [T, R], recall [T]) or None if no gt."""
        npig = sum(e["n_gt"] for e in per_img)
        if npig == 0:
            return None
        t_n, r_n = len(IOU_THRS), len(REC_THRS)
        dtm = np.concatenate(
            [e["dtm"][:, :max_det] for e in per_img], axis=1
        )
        dt_ig = np.concatenate(
            [e["dt_ig"][:, :max_det] for e in per_img], axis=1
        )
        scores = np.concatenate([e["scores"][:max_det] for e in per_img])
        order = np.argsort(-scores, kind="mergesort")
        dtm, dt_ig = dtm[:, order], dt_ig[:, order]

        tps = (dtm > 0) & ~dt_ig
        fps = (dtm == 0) & ~dt_ig
        tp_sum = np.cumsum(tps, axis=1).astype(float)
        fp_sum = np.cumsum(fps, axis=1).astype(float)

        if tp_sum.shape[1] == 0:
            return np.zeros((t_n, r_n)), np.zeros((t_n,))

        rc = tp_sum / npig
        pr = tp_sum / np.maximum(tp_sum + fp_sum, np.spacing(1))
        rec_out = rc[:, -1]
        # precision envelope (monotone non-increasing from the right)
        pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
        prec_out = np.zeros((t_n, r_n))
        for ti in range(t_n):
            inds = np.searchsorted(rc[ti], REC_THRS, side="left")
            ok = inds < pr.shape[1]
            prec_out[ti, ok] = pr[ti, inds[ok]]
        return prec_out, rec_out

    # ----------------------------------------------------------- interface

    def evaluate(
        self, predictions: list[dict], per_category: bool = False
    ) -> dict[str, float]:
        """predictions: [{image_id, category_id, bbox [x,y,w,h], score}]
        -> the 12 standard COCO metrics.

        per_category additionally reports ``AP-{name}`` / ``AP50-{name}``
        per class (area=all, maxDet=100) — the breakdown PubLayNet-style
        layout papers publish (text/title/list/table/figure). pycocotools
        exposes the same numbers only by indexing ``eval['precision']``
        by hand; the reference never surfaces them (evaluator.py:71-77
        keeps the 12 summary stats only)."""
        dt: dict[tuple, list] = {k: [] for k in self._gt}
        for p in predictions:
            key = (p["image_id"], p["category_id"])
            if key in dt:
                dt[key].append(p)

        t_n, r_n = len(IOU_THRS), len(REC_THRS)
        a_names = list(AREA_RNGS)
        precision = -np.ones(
            (t_n, r_n, len(self.cat_ids), len(a_names), len(MAX_DETS))
        )
        recall = -np.ones((t_n, len(self.cat_ids), len(a_names), len(MAX_DETS)))

        for ci, cat in enumerate(self.cat_ids):
            # prepare each (image, cat) once — IoU is area-independent;
            # empty pairs contribute nothing to any accumulation
            pairs = []
            for img in self.img_ids:
                gt_l, dt_l = self._gt[(img, cat)], dt[(img, cat)]
                if gt_l or dt_l:
                    pairs.append(_Pair(gt_l, dt_l, max(MAX_DETS), iou_type=self.iou_type,
                                       img_size=self._img_sizes[img]))
            for ai, a_name in enumerate(a_names):
                rng = AREA_RNGS[a_name]
                per_img = self._match_pairs(pairs, rng)
                for di, max_det in enumerate(MAX_DETS):
                    stats = self._accumulate(per_img, max_det)
                    if stats is None:
                        continue
                    prec, rec = stats
                    precision[:, :, ci, ai, di] = prec
                    recall[:, ci, ai, di] = rec

        def _ap(t=None, area="all", max_det=100):
            ai, di = a_names.index(area), MAX_DETS.index(max_det)
            if t is None:
                p = precision[:, :, :, ai, di]
            else:
                ti = int(np.argmin(np.abs(IOU_THRS - t)))
                p = precision[ti : ti + 1, :, :, ai, di]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(area="all", max_det=100):
            ai, di = a_names.index(area), MAX_DETS.index(max_det)
            r = recall[:, :, ai, di]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        values = [
            _ap(), _ap(t=0.5), _ap(t=0.75),
            _ap(area="small"), _ap(area="medium"), _ap(area="large"),
            _ar(max_det=1), _ar(max_det=10), _ar(max_det=100),
            _ar(area="small"), _ar(area="medium"), _ar(area="large"),
        ]
        metrics = dict(zip(COCO_KEYS, values))
        if per_category:
            ai, di = a_names.index("all"), MAX_DETS.index(100)
            for ci, cat in enumerate(self.cat_ids):
                name = self.cat_names[cat]
                p_all = precision[:, :, ci, ai, di]
                p50 = precision[0:1, :, ci, ai, di]
                metrics[f"AP-{name}"] = (
                    float(p_all[p_all > -1].mean()) if (p_all > -1).any() else -1.0
                )
                metrics[f"AP50-{name}"] = (
                    float(p50[p50 > -1].mean()) if (p50 > -1).any() else -1.0
                )
        return metrics
