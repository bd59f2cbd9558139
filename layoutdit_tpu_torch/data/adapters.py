"""Dataset adapters: PubLayNet, DocLayNet, DocBank (port of
``layoutdit_tpu/data/adapters.py``).

All three run through the same COCO-indexed ``PubLayNetDataset`` +
``DetectionLoader`` pipeline; an adapter supplies the class inventory
(which the prediction and serving tools also print beside each class id)
and, for DocBank, a one-time conversion of its token-level txt
annotations into a COCO JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import posixpath

from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.utils.paths import fs_for, join_path, open_path

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    class_names: tuple[str, ...]


PUBLAYNET = DatasetSpec(
    "publaynet", 5, ("text", "title", "list", "table", "figure")
)

DOCLAYNET = DatasetSpec(
    "doclaynet", 11,
    ("Caption", "Footnote", "Formula", "List-item", "Page-footer",
     "Page-header", "Picture", "Section-header", "Table", "Text", "Title"),
)

DOCBANK = DatasetSpec(
    "docbank", 13,
    ("abstract", "author", "caption", "date", "equation", "figure",
     "footer", "list", "paragraph", "reference", "section", "table",
     "title"),
)

SPECS = {s.name: s for s in (PUBLAYNET, DOCLAYNET, DOCBANK)}


def apply_dataset_spec(config, spec_name: str):
    """A copy of a ``RunConfig`` pointed at another dataset family: its
    ``num_classes`` set (the JAX package sets it in place; the port's
    configs are frozen); the data paths stay config-driven."""
    spec = SPECS[spec_name]
    return dataclasses.replace(
        config, model=dataclasses.replace(config.model, num_classes=spec.num_classes))


def load_coco_dataset(images_root_dir: str, annotations_json_path: str) -> PubLayNetDataset:
    """DocLayNet ships COCO JSONs, as PubLayNet does: the same loader."""
    return PubLayNetDataset(images_root_dir, annotations_json_path)


def convert_docbank_to_coco(
    txt_dir: str,
    images_dir: str,
    out_json_path: str,
    image_size: tuple[int, int] = (1000, 1000),
) -> str:
    """Convert DocBank token-level annotations to a COCO detection JSON.

    DocBank's txt schema (one token a line, tab-separated):
      token x0 y0 x1 y1 R G B fontname label
    with coordinates on a 1000 x 1000 page. Each token's box becomes one
    annotation of its label's category; tokens of an unknown label and
    zero-area tokens are dropped. The ``.txt`` files of ``txt_dir`` (local
    or a ``scheme://`` URL) are taken in name order, each page named
    ``<stem>_ori.jpg``; the JSON has the JAX converter's keys, order and
    formatting, so both write the same bytes."""
    cat_to_id = {name: i + 1 for i, name in enumerate(DOCBANK.class_names)}
    images, annotations = [], []
    ann_id = 1
    names = sorted(n for n in fs_for(txt_dir).listdir(txt_dir) if n.endswith(".txt"))
    for img_id, name in enumerate(names, start=1):
        images.append({
            "id": img_id, "file_name": os.path.splitext(posixpath.basename(name))[0] + "_ori.jpg",
            "width": image_size[1], "height": image_size[0],
        })
        with open_path(join_path(txt_dir, name), "r") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 10:
                    continue
                _, x0, y0, x1, y1 = parts[:5]
                label = parts[9]
                if label not in cat_to_id:
                    continue
                x0, y0, x1, y1 = float(x0), float(y0), float(x1), float(y1)
                w, h = x1 - x0, y1 - y0
                if w <= 0 or h <= 0:
                    continue
                annotations.append({
                    "id": ann_id, "image_id": img_id,
                    "category_id": cat_to_id[label],
                    "bbox": [x0, y0, w, h], "area": w * h, "iscrowd": 0,
                })
                ann_id += 1
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": n} for i, n in enumerate(DOCBANK.class_names)],
    }
    with open_path(out_json_path, "w") as f:
        json.dump(coco, f)
    logger.info("DocBank -> COCO: %d images, %d annotations -> %s",
                len(images), len(annotations), out_json_path)
    return out_json_path
