"""PubLayNet (COCO-format) dataset (port of ``layoutdit_tpu/data/dataset.py``).

Parses the COCO annotations JSON once into ``image_info`` and
``cat_id_to_label`` (category ids remapped to 1..N in file order),
converts COCO ``[x, y, w, h]`` boxes to ``[x1, y1, x2, y2]`` and drops
degenerate ones, as the JAX package does. Paths may be local or
``scheme://`` URLs (``utils/paths.py``); the annotations and every page
are read with ``retry_io``. The native parser (``native/cocojson.py``)
takes the annotations when it is available, into packed arrays that the
targets are cut from; ``coco_data`` (the evaluator's ground truth) and
``annotations`` (image id -> its annotation dicts) are then built only
when asked for. Without it, ``json.loads``.

One difference from the JAX package: images decode to uint8
``[H, W, 3]`` (the loader scales and resizes them on the device). PIL is
imported when the first image is decoded, never at import.
"""

from __future__ import annotations

import io
import json

import numpy as np

from layoutdit_tpu_torch.native import cocojson
from layoutdit_tpu_torch.utils.paths import join_path, open_path
from layoutdit_tpu_torch.utils.retry import retry_io


@retry_io
def read_bytes(path: str) -> bytes:
    """The whole object at ``path``, retried on transient I/O errors."""
    with open_path(path, "rb") as f:
        return f.read()


class PubLayNetDataset:
    def __init__(self, images_root_dir: str, annotations_json_path: str):
        raw = read_bytes(annotations_json_path)
        self.images_root_dir = images_root_dir
        arr = cocojson.parse_coco_bytes(raw) if cocojson.available() else None
        self._arr = arr
        self._coco_data = None
        self._annotations = None
        if arr is not None:
            del raw
            self.image_info = {
                int(i): {"id": int(i), "width": int(w), "height": int(h), "file_name": f}
                for i, w, h, f in zip(arr.img_id, arr.img_w, arr.img_h, arr.file_names)
            }
            categories = arr.categories
            # a stable sort keeps file order within an image, as the
            # json.loads path's grouping does
            self._ann_order = np.argsort(arr.ann_img, kind="stable")
            self._ann_img_sorted = arr.ann_img[self._ann_order]
        else:
            coco = json.loads(raw)
            del raw
            self._coco_data = coco
            self.image_info = {img["id"]: img for img in coco["images"]}
            categories = coco["categories"]
        self.cat_id_to_label = {cat["id"]: i for i, cat in enumerate(categories, start=1)}
        self.ids = list(self.image_info.keys())

    @property
    def native(self) -> bool:
        """Whether the native parser read the annotations."""
        return self._arr is not None

    @property
    def coco_data(self) -> dict:
        """The annotations as a COCO dict (built from the arrays on first
        use on the native path)."""
        if self._coco_data is None:
            self._coco_data = self._arr.to_coco_data()
        return self._coco_data

    @property
    def annotations(self) -> dict[int, list]:
        """image id -> its annotation dicts, in file order."""
        if self._annotations is None:
            anns: dict[int, list] = {}
            for ann in self.coco_data["annotations"]:
                anns.setdefault(ann["image_id"], []).append(ann)
            self._annotations = anns
        return self._annotations

    def __len__(self) -> int:
        return len(self.ids)

    def load_image_bytes(self, img_id) -> bytes:
        """The encoded page, as stored."""
        return read_bytes(join_path(self.images_root_dir, self.image_info[img_id]["file_name"]))

    def load_image(self, img_id) -> np.ndarray:
        """Decode one image -> uint8 [H, W, 3] (RGB)."""
        from PIL import Image

        with Image.open(io.BytesIO(self.load_image_bytes(img_id))) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)

    def load_target(self, img_id) -> dict:
        """Boxes [n, 4] xyxy float32 and labels [n] int64 of one image,
        degenerate boxes dropped."""
        if self._arr is not None:
            lo = np.searchsorted(self._ann_img_sorted, img_id, "left")
            hi = np.searchsorted(self._ann_img_sorted, img_id, "right")
            sel = self._ann_order[lo:hi]
            xywh = self._arr.ann_bbox[sel]
            boxes_np = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]],
                                      axis=1).astype(np.float32).reshape(-1, 4)
            labels_np = np.asarray([self.cat_id_to_label.get(int(c), 0)
                                    for c in self._arr.ann_cat[sel]], dtype=np.int64)
        else:
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
