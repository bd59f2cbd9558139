"""Pack a page-image corpus into tar shards (``data/shards.py``; port of
``layoutdit_tpu/tools/make_shards.py``, the same files).

    python -m layoutdit_tpu_torch.tools.make_shards \
        --images DIR_OR_URL --annotations ANNOTATIONS.json --out OUT_DIR_OR_URL \
        [--shard-mb 256]

The file list, and so the shard order, is the annotations' image order.
Train on the result by setting ``data_loader_config.image_shards_dir``
to ``OUT``; the annotations stay where they are.
"""

from __future__ import annotations

import argparse
import json

from layoutdit_tpu_torch.data.dataset import read_bytes
from layoutdit_tpu_torch.data.shards import build_shards
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.utils.paths import join_path, open_path

logger = get_logger(__name__)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Pack images into tar shards")
    parser.add_argument("--images", required=True, help="images root (local or scheme://)")
    parser.add_argument("--annotations", required=True,
                        help="COCO annotations JSON (defines the file list)")
    parser.add_argument("--out", required=True, help="shard output dir")
    parser.add_argument("--shard-mb", type=int, default=256)
    args = parser.parse_args(argv)

    with open_path(args.annotations, "r") as f:
        coco = json.load(f)
    file_names = [img["file_name"] for img in coco["images"]]
    logger.info("Packing %d images from %s", len(file_names), args.images)
    index = build_shards(file_names, lambda name: read_bytes(join_path(args.images, name)),
                         args.out, shard_size_bytes=args.shard_mb * 1024 * 1024)
    logger.info("Done: %d shards -> %s", len(index["shards"]), args.out)


if __name__ == "__main__":
    main()
