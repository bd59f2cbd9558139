"""Evaluator: batch inference over the eval split, COCO metrics, and box
overlays (port of ``layoutdit_tpu/eval/evaluator.py``, single card).
Predictions, page reads and overlays go through ``utils/paths.py``, so
the data and the run's directory may be ``scheme://`` URLs.

  * The eval loader reads the configured eval split in file order
    (``shuffle=False``), keeps the last partial batch (``drop_last=False``)
    and masks its padded slots by ``image_valid``.
  * ``score()``: ``detector_predict`` under ``torch.no_grad()`` on the
    parameters cast to the compute dtype once per call
    (``params_for_inference``), boxes mapped back to page coordinates
    (``rescale_detections``), the configured ``score_thresh`` applied as
    in the JAX evaluator, then one numpy pass per batch to COCO xywh
    predictions, written to ``{base}/{run}/predictions.json`` and scored
    by ``CocoEvaluator`` (the 12 COCO metrics, and the per-class AP when
    ``per_category_metrics``).
  * ``visualize_preds()`` / ``visualize_gt()``: the top ``max_per_image``
    predictions (red) or the ground truth (green) drawn on up to
    ``num_images`` pages, saved as JPEGs. PIL is imported inside them.

Not ported yet: the data-parallel and multi-host eval, and the mask
branch (pasted instance masks and the segm metrics).
"""

from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np
import torch

from layoutdit_tpu_torch.config import RunConfig
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset, read_bytes
from layoutdit_tpu_torch.data.pipeline import DetectionLoader
from layoutdit_tpu_torch.eval.coco_eval import CocoEvaluator
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.detection.detector import (
    detector_predict,
    params_for_inference,
    rescale_detections,
)
from layoutdit_tpu_torch.models.weights_io import tree_map
from layoutdit_tpu_torch.utils.paths import fs_for, join_path, open_path

logger = get_logger(__name__)


class Evaluator:
    """COCO evaluation of a model on the run's eval split.

    Args:
      model: anything with ``.params`` and ``.cfg`` (``LayoutDetectionModel``
        or ``DetectorModel``); ``score()`` reads ``model.params`` at each
        call, so it scores the weights the model holds then.
      config: the run's ``RunConfig``.
      device: where inference runs; "cuda" unless the caller asks for the
        CPU. A CUDA device with no GPU present raises.
    """

    def __init__(self, model, config: RunConfig, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = model
        self.config = config
        self.eval_config = config.eval
        images_root, ann_json = config.eval_split()
        self.dataloader = DetectionLoader(
            PubLayNetDataset(images_root, ann_json),
            batch_size=config.data.batch_size,
            shuffle=False,  # deterministic eval order
            num_workers=config.data.num_workers,
            image_size=model.cfg.image_size,
            max_gt=config.data.max_gt_boxes,
            drop_last=False,
            prefetch_depth=config.data.prefetch_depth,
            device=self.device,
        )
        self.coco_data = self.dataloader.dataset.coco_data
        self.coco_eval = CocoEvaluator(self.coco_data)
        self.id2cat_map = {
            cat["id"]: cat.get("name", str(cat["id"])) for cat in self.coco_data["categories"]
        }
        self.score_thresh = self.eval_config.score_thresh
        run_dir = config.artifact_dir
        prefix = self.eval_config.visualize_dirpath_prefix
        self.predictions_path = f"{run_dir}/predictions.json"
        self.visualization_preds_path = f"{run_dir}/{prefix}_preds/"
        self.visualization_gt_path = f"{run_dir}/{prefix}_gt/"

    # ------------------------------------------------------------- score

    def predictions(self) -> list[dict]:
        """Inference over the eval split -> COCO predictions
        ``{image_id, category_id, bbox [x, y, w, h], score}`` in page
        coordinates; ``category_id`` is the model's label, as in the JAX
        evaluator."""
        cfg = self.model.cfg
        out: list[dict] = []
        try:
            with torch.no_grad():
                params = params_for_inference(
                    tree_map(lambda t: t.to(self.device), self.model.params), cfg.dtype
                )
                for batch in self.dataloader:
                    sizes = torch.from_numpy(batch.orig_sizes).to(self.device)
                    dets = rescale_detections(
                        detector_predict(params, batch.images, cfg), sizes, cfg.image_size
                    )
                    boxes = dets.boxes.float().cpu().numpy()
                    scores = dets.scores.float().cpu().numpy()
                    labels = dets.labels.cpu().numpy()
                    valid = dets.valid.cpu().numpy() & (scores >= self.score_thresh)
                    if self.score_thresh > 0:
                        valid &= scores > 0
                    # one numpy pass per batch; python only over kept detections
                    img_idx, det_idx = np.nonzero(valid & batch.image_valid[:, None])
                    kb = boxes[img_idx, det_idx].astype(np.float64)
                    xywh = np.stack(
                        [kb[:, 0], kb[:, 1], kb[:, 2] - kb[:, 0], kb[:, 3] - kb[:, 1]], axis=1
                    )
                    kids = batch.image_ids[img_idx]
                    ks = scores[img_idx, det_idx]
                    kc = labels[img_idx, det_idx]
                    out += [
                        {"image_id": int(kids[j]), "category_id": int(kc[j]),
                         "bbox": xywh[j].tolist(), "score": float(ks[j])}
                        for j in range(len(img_idx))
                    ]
        finally:
            self.dataloader.close()
        return out

    def score(self) -> Optional[dict]:
        """Predictions over the eval split -> the COCO metrics (None, with
        a warning, when there is no prediction at all)."""
        all_predictions = self.predictions()
        if not all_predictions:
            logger.warning("No predictions were generated.")
            return None
        self._save_predictions_json(all_predictions)
        metrics = self.coco_eval.evaluate(
            all_predictions, per_category=self.eval_config.per_category_metrics
        )
        logger.info("COCO metrics: %s", " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        return metrics

    def _save_predictions_json(self, all_predictions: list[dict]) -> None:
        with open_path(self.predictions_path, "w") as f:
            json.dump(all_predictions, f)
        logger.info("Saved %d predictions to %s", len(all_predictions), self.predictions_path)

    # ---------------------------------------------------------- visualize

    def _load_pil(self, file_name: str):
        from PIL import Image

        raw = read_bytes(join_path(self.dataloader.dataset.images_root_dir, file_name))
        with Image.open(io.BytesIO(raw)) as im:
            return im.convert("RGB")

    @staticmethod
    def _draw_boxes(img, entries, color: str) -> None:
        """entries: [(bbox xywh, label text)]; a box and a label banner each."""
        from PIL import ImageDraw, ImageFont

        draw = ImageDraw.Draw(img)
        try:
            font = ImageFont.truetype("arial.ttf", size=16)
        except OSError:
            font = ImageFont.load_default()
        w_img, h_img = img.size
        for (x, y, w, h), label in entries:
            x0, y0 = max(0, min(x, w_img)), max(0, min(y, h_img))
            x1, y1 = max(0, min(x + w, w_img)), max(0, min(y + h, h_img))
            draw.rectangle([x0, y0, x1, y1], outline=color, width=2)
            left, top, right, bottom = draw.textbbox((x0, y0), label, font=font)
            tw, th = right - left, bottom - top
            draw.rectangle([x0, y0 - th, x0 + tw, y0], fill=color)
            draw.text((x0, y0 - th), label, fill="white", font=font)

    def _overlay(self, by_image: dict[int, list], out_dir: str, color: str, what: str) -> None:
        """Draw ``by_image[id]``'s (bbox, label) entries on up to
        ``num_images`` pages, in file order, and save each as a JPEG."""
        num_images = self.eval_config.num_images
        count = 0
        for img_rec in self.coco_data["images"]:
            img_id = img_rec["id"]
            if img_id not in by_image:
                continue
            if num_images is not None and count >= num_images:
                break
            count += 1
            img = self._load_pil(img_rec["file_name"])
            self._draw_boxes(img, by_image[img_id], color)
            out = join_path(out_dir, f"{img_id}.jpg")
            with open_path(out, "wb") as f:
                img.save(f, format="JPEG")
            logger.info("Saved %s visualization for image %s to %s", what, img_id, out)

    def _label(self, cat_id: int) -> str:
        return self.id2cat_map.get(cat_id, str(cat_id))

    def visualize_preds(self) -> None:
        """The top ``max_per_image`` predictions (red), read back from
        ``predictions.json`` as the JAX evaluator does; nothing when
        ``score()`` wrote no file."""
        if not fs_for(self.predictions_path).exists(self.predictions_path):
            logger.warning("No %s; no prediction overlays drawn", self.predictions_path)
            return
        with open_path(self.predictions_path, "r") as f:
            all_preds = json.load(f)
        by_image: dict[int, list] = {}
        for p in all_preds:
            by_image.setdefault(p["image_id"], []).append(p)
        top = self.eval_config.max_per_image
        self._overlay({
            img_id: [(p["bbox"], self._label(p["category_id"]))
                     for p in sorted(preds, key=lambda x: x["score"], reverse=True)[:top]]
            for img_id, preds in by_image.items()
        }, self.visualization_preds_path, "red", "prediction")

    def visualize_gt(self) -> None:
        """The ground-truth boxes (green)."""
        by_image: dict[int, list] = {}
        for ann in self.coco_data["annotations"]:
            by_image.setdefault(ann["image_id"], []).append(
                (ann["bbox"], self._label(ann["category_id"])))
        self._overlay(by_image, self.visualization_gt_path, "green", "GT")
