"""Generate a tiny synthetic PubLayNet-style dataset for tests and smoke runs.

A copy of ``layoutdit_tpu/tools/make_fixture.py`` for the port, which
imports nothing of the JAX package: document-looking pages (white
background, dark "text" line blocks, framed "tables", gray "figures")
with COCO-format annotations over the same five classes as PubLayNet.
The visual structure is simple enough that a detector overfits it
quickly — which is exactly what end-to-end checks need.

The drawing is numpy; the JPEG writing imports PIL when it runs.

Usage: python -m layoutdit_tpu_torch.tools.make_fixture OUT_DIR [--n 16] [--split samples]
           [--image-size 224]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

CATEGORIES = [
    {"id": 1, "name": "text"},
    {"id": 2, "name": "title"},
    {"id": 3, "name": "list"},
    {"id": 4, "name": "table"},
    {"id": 5, "name": "figure"},
]


def _draw_text_block(img, x, y, w, h, rng, line_h=6):
    for ly in range(y, y + h - line_h, line_h + 3):
        lw = int(w * rng.uniform(0.7, 1.0))
        img[ly:ly + line_h, x:x + lw] = rng.uniform(0.1, 0.3)


def _draw_title(img, x, y, w, h, rng):
    img[y:y + h, x:x + int(w * rng.uniform(0.6, 0.95))] = rng.uniform(0.0, 0.15)


def _draw_list(img, x, y, w, h, rng, line_h=5):
    for ly in range(y, y + h - line_h, line_h + 4):
        img[ly:ly + line_h, x:x + 3] = 0.0  # bullet
        lw = int((w - 8) * rng.uniform(0.5, 0.9))
        img[ly:ly + line_h, x + 8:x + 8 + lw] = rng.uniform(0.15, 0.35)


def _draw_table(img, x, y, w, h, rng):
    img[y:y + 2, x:x + w] = 0.0
    img[y + h - 2:y + h, x:x + w] = 0.0
    img[y:y + h, x:x + 2] = 0.0
    img[y:y + h, x + w - 2:x + w] = 0.0
    n_rows = rng.integers(3, 6)
    for r in range(1, n_rows):
        ry = y + int(h * r / n_rows)
        img[ry:ry + 1, x:x + w] = 0.2
    n_cols = rng.integers(2, 4)
    for c in range(1, n_cols):
        cx = x + int(w * c / n_cols)
        img[y:y + h, cx:cx + 1] = 0.2


def _draw_figure(img, x, y, w, h, rng):
    yy, xx = np.mgrid[0:h, 0:w]
    img[y:y + h, x:x + w] = 0.4 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 9.0)


_DRAWERS = {1: _draw_text_block, 2: _draw_title, 3: _draw_list,
            4: _draw_table, 5: _draw_figure}


def make_page(rng: np.random.Generator, size: int = 224, num_classes: int = 5):
    """One synthetic page -> (float image [H, W], list of (cat, bbox xywh))."""
    img = np.full((size, size), 1.0, np.float32)
    anns = []
    y = rng.integers(8, 20)
    while y < size - 40:
        h = int(rng.integers(20, 60))
        if y + h > size - 8:
            break
        # one or two columns
        if rng.uniform() < 0.35:
            widths = [(8, size // 2 - 12), (size // 2 + 4, size - 12)]
        else:
            widths = [(8, size - 16)]
        for x0, x1 in widths:
            w = x1 - x0
            if num_classes <= 5:
                cat = int(rng.choice([1, 1, 1, 2, 3, 4, 5]))
            else:
                cat = int(rng.integers(1, num_classes + 1))
            # visual styles repeat cyclically for transfer-shaped fixtures
            _DRAWERS[(cat - 1) % 5 + 1](img, x0, y, w, h, rng)
            anns.append((cat, [float(x0), float(y), float(w), float(h)]))
        y += h + int(rng.integers(6, 16))
    return img, anns


def make_fixture(
    out_dir: str, n_images: int = 16, split: str = "samples",
    image_size: int = 224, seed: int = 0, num_classes: int = 5,
) -> str:
    """Write {out_dir}/{split}/*.jpg + {out_dir}/{split}.json (COCO).

    ``num_classes`` > 5 makes a transfer-dataset-shaped fixture (11 for
    DocLayNet, 13 for DocBank, ``data/adapters.py``): category ids 1..N,
    the five visual styles reused cyclically, as the JAX package's."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(out_dir, split)
    os.makedirs(img_dir, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        img, anns = make_page(rng, image_size, num_classes=num_classes)
        fname = f"page_{i:04d}.jpg"
        Image.fromarray((img * 255).astype(np.uint8)).convert("RGB").save(
            os.path.join(img_dir, fname), quality=92
        )
        images.append({
            "id": i + 1, "file_name": fname,
            "width": image_size, "height": image_size,
        })
        for cat, bbox in anns:
            x, y, w, h = bbox
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": cat,
                "bbox": bbox, "area": bbox[2] * bbox[3], "iscrowd": 0,
                # rectangle polygon over the block, as PubLayNet ships
                # polygon segmentations
                "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]],
            })
            ann_id += 1

    coco = {"images": images, "annotations": annotations,
            "categories": CATEGORIES if num_classes <= 5 else [
                {"id": i + 1, "name": f"class_{i + 1}"} for i in range(num_classes)]}
    json_path = os.path.join(out_dir, f"{split}.json")
    with open(json_path, "w") as f:
        json.dump(coco, f)
    return json_path


def write_fixture_config(out_dir: str, split: str = "samples",
                         epochs: int = 2, batch_size: int = 4,
                         tiny_model: bool = False) -> str:
    """A LAYOUTDIT_CONFIG json pointing train+eval at the fixture.

    tiny_model=True scales the ViT/budgets down for fast CPU e2e drives.
    """
    cfg = {
        "run_name": "fixture",
        "local_mode": True,
        "train_config": {
            "train_base_path": out_dir, "train_input": split,
            "num_epochs": epochs, "checkpoint_interval": epochs,
        },
        "eval_config": {"eval_input": split, "eval_base_path": out_dir},
        "data_loader_config": {"batch_size": batch_size, "num_workers": 2},
    }
    if tiny_model:
        cfg["data_loader_config"]["max_gt_boxes"] = 32
        cfg["detection_model_config"] = {
            "vit_overrides": {
                "hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 2, "intermediate_size": 128,
            },
            "fpn_out_channels": 64,
            "detection_budget": {
                "rpn_pre_nms_top_n_train": 500, "rpn_pre_nms_top_n_test": 300,
                "rpn_post_nms_top_n_train": 500, "rpn_post_nms_top_n_test": 300,
                "box_batch_size_per_image": 128, "box_detections_per_img": 50,
            },
        }
        cfg["precision"] = {"compute_dtype": "float32"}
    path = os.path.join(out_dir, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--split", default="samples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=224,
                    help="page side in pixels (e.g. 1024 for the high-res train config)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--tiny-model", action="store_true")
    args = ap.parse_args()
    json_path = make_fixture(args.out_dir, args.n, args.split, image_size=args.image_size,
                             seed=args.seed)
    cfg_path = write_fixture_config(
        args.out_dir, args.split, args.epochs, args.batch_size,
        tiny_model=args.tiny_model,
    )
    print(f"fixture: {json_path}\nconfig:  {cfg_path}")


if __name__ == "__main__":
    main()
