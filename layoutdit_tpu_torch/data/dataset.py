"""PubLayNet (COCO-format) dataset on local paths (port of
``layoutdit_tpu/data/dataset.py``).

Parses the COCO annotations JSON once into ``image_info`` /
``annotations`` / ``cat_id_to_label`` (category ids remapped to 1..N in
file order), keeps the parsed dict as ``coco_data`` (the evaluator's
ground truth and class names), converts COCO ``[x, y, w, h]`` boxes to
``[x1, y1, x2, y2]`` and drops degenerate ones, as the JAX package
does. Two differences: images decode to uint8 ``[H, W, 3]`` (the loader
scales and resizes them on the device), and paths are local files only:
gs:// paths, fsspec and tar shards wait for a later slice. PIL is
imported when the first image is decoded, never at import.
"""

from __future__ import annotations

import json
import os

import numpy as np


class PubLayNetDataset:
    def __init__(self, images_root_dir: str, annotations_json_path: str):
        for path in (images_root_dir, annotations_json_path):
            if "://" in path:
                raise ValueError(
                    f"{path}: the port reads local paths only (remote storage "
                    "waits for a later slice)"
                )
        with open(annotations_json_path) as f:
            coco = json.load(f)
        self.images_root_dir = images_root_dir
        self.coco_data = coco
        self.image_info = {img["id"]: img for img in coco["images"]}
        self.annotations: dict[int, list] = {}
        for ann in coco["annotations"]:
            self.annotations.setdefault(ann["image_id"], []).append(ann)
        self.cat_id_to_label = {
            cat["id"]: i for i, cat in enumerate(coco["categories"], start=1)
        }
        self.ids = list(self.image_info.keys())

    def __len__(self) -> int:
        return len(self.ids)

    def load_image(self, img_id) -> np.ndarray:
        """Decode one image -> uint8 [H, W, 3] (RGB)."""
        from PIL import Image

        path = os.path.join(self.images_root_dir, self.image_info[img_id]["file_name"])
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)

    def load_target(self, img_id) -> dict:
        """Boxes [n, 4] xyxy float32 and labels [n] int64 of one image,
        degenerate boxes dropped."""
        boxes, labels = [], []
        for ann in self.annotations.get(img_id, []):
            x, y, w, h = ann["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat_id_to_label.get(ann["category_id"], 0))
        boxes_np = np.asarray(boxes, dtype=np.float32).reshape(-1, 4)
        labels_np = np.asarray(labels, dtype=np.int64)
        keep = (boxes_np[:, 2] > boxes_np[:, 0]) & (boxes_np[:, 3] > boxes_np[:, 1])
        return {
            "boxes": boxes_np[keep],
            "labels": labels_np[keep],
            "image_id": np.asarray([img_id]),
        }
