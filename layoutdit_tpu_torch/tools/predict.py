"""Offline prediction: checkpoint + page images -> detections JSON (port of
``layoutdit_tpu/tools/predict.py``, its flags and record schema).

Loads a checkpoint into the config's model (``LAYOUTDIT_CONFIG``, as
``main``), routes the pages through the bucketed ``BatchInferenceEngine``
(``eval/serving.py``: native JPEG decode, padded static batches per
bucket) and writes one JSON record per page, the HTTP server's
``/predict`` payload with the page's file name (a mask model's with its
``masks``), plus optional overlay JPEGs (boxes, and a mask model's masks
in red at 40%).

    LAYOUTDIT_CONFIG=cfg.json python -m layoutdit_tpu_torch.tools.predict \\
        --checkpoint runs/x/model_checkpoints/best.pt --input 'pages/*.jpg' \\
        --output detections.json [--sizes 224 512 1024 | --auto-buckets 3] \\
        [--batch-size 8] [--score-thresh 0.3] [--visualize viz_dir/] \\
        [--shards shard_dir/] [--dataset publaynet] [--device cuda|cpu]

``--checkpoint`` takes the port's ``.pt`` or the JAX trainer's
``.msgpack``. ``--device`` is "cuda" (the default) or "cpu". ``--int8``
serves the encoder in W8A8 int8 (``ops/quant.py``; LoRA adapters are
merged first).
"""

from __future__ import annotations

import argparse
import fnmatch
import glob
import io
import json
import os

import numpy as np

from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)

def _label_names(n_classes: int, dataset: str | None) -> dict:
    """Class id -> name from the dataset inventories (``data/adapters.py``):
    ``dataset`` when given, else the inventory with the model's class count
    (labels are 1-based, background is 0); {} when none matches."""
    from layoutdit_tpu_torch.data.adapters import SPECS

    if dataset:
        spec = SPECS[dataset]
    else:
        spec = next((s for s in SPECS.values() if s.num_classes == n_classes), None)
    if spec is None or spec.num_classes != n_classes:
        return {}
    return {i + 1: n for i, n in enumerate(spec.class_names)}


def collect_inputs(pattern: str) -> list[str]:
    """A directory, a glob or a single file -> sorted image paths."""
    if os.path.isdir(pattern):
        paths = [os.path.join(pattern, f) for f in os.listdir(pattern)
                 if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    else:
        paths = glob.glob(pattern)
    if not paths:
        raise FileNotFoundError(f"no input images match {pattern!r}")
    return sorted(paths)


def _page_sizes(paths: list[str], read_head) -> list[tuple[int, int]]:
    """(h, w) of each page from its header, no pixel decode
    (``eval.serving.header_size``). ``read_head(path, n)``: the first n
    bytes (None: the whole page)."""
    from layoutdit_tpu_torch.eval.serving import header_size

    sizes = []
    for p in paths:
        hw = header_size(read_head(p, 1 << 16))
        if hw is None:  # a late size marker: read the whole page
            hw = header_size(read_head(p, None))
        if hw is None:
            raise ValueError(f"{p}: not a readable image")
        sizes.append(hw)
    return sizes


def _visualize(src, dets, out_path: str, names: dict) -> None:
    """src: an image path or its bytes (shard mode)."""
    from PIL import Image, ImageDraw

    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(src)
    with Image.open(src) as im:
        im = im.convert("RGB")
        if dets.masks is not None:
            # instance masks: red at 40% over each detection's window
            arr = np.asarray(im).copy()
            for x0, y0, bm in dets.masks:
                h, w = bm.shape
                y1, x1 = min(y0 + h, arr.shape[0]), min(x0 + w, arr.shape[1])
                if y1 <= y0 or x1 <= x0:
                    continue
                win = arr[y0:y1, x0:x1]
                sel = bm[: y1 - y0, : x1 - x0].astype(bool)
                win[sel] = (0.6 * win[sel] + 0.4 * np.array([255.0, 0.0, 0.0])).astype(np.uint8)
            im = Image.fromarray(arr)
        draw = ImageDraw.Draw(im)
        for box, score, label in zip(dets.boxes, dets.scores, dets.labels):
            x1, y1, x2, y2 = [float(v) for v in box]
            draw.rectangle([x1, y1, x2, y2], outline="red", width=2)
            draw.text((x1, max(0.0, y1 - 12)),
                      f"{names.get(int(label), int(label))}:{float(score):.2f}", fill="red")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        im.save(out_path, "JPEG")


def load_model(checkpoint: str, device: str):
    """The config's model (``LAYOUTDIT_CONFIG``) with ``checkpoint``'s
    weights (``.pt`` or JAX ``.msgpack``) on ``device``."""
    from layoutdit_tpu_torch.config import get_run_config
    from layoutdit_tpu_torch.models.model import build_model

    config = get_run_config()
    model = build_model(config, seed=config.train.seed, device=device, warm_start=False)
    model.restore_checkpoint(checkpoint)
    logger.info("Loaded checkpoint %s", checkpoint)
    return config, model


def run(args) -> list[dict]:
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.tools.serve import detections_to_json
    from layoutdit_tpu_torch.utils.paths import open_path

    config, model = load_model(args.checkpoint, args.device)

    shard_index = None
    if args.shards:
        from layoutdit_tpu_torch.data.shards import ShardIndex

        shard_index = ShardIndex(args.shards)
        paths = sorted(shard_index.entries)
        if args.input:
            paths = [p for p in paths if fnmatch.fnmatch(p, args.input)]
        if not paths:
            raise FileNotFoundError(f"no shard members match {args.input!r} in {args.shards}")

        def read(name):
            return shard_index.read(name)

        def read_head(name, n):
            return shard_index.read(name) if n is None else shard_index.read_prefix(name, n)
    else:
        paths = collect_inputs(args.input)

        def read(path):
            with open(path, "rb") as f:
                return f.read()

        def read_head(path, n):
            with open(path, "rb") as f:
                return f.read() if n is None else f.read(n)
    logger.info("Predicting %d pages", len(paths))

    kwargs = dict(batch_size=args.batch_size, score_thresh=args.score_thresh,
                  device=args.device, int8=args.int8)
    if args.auto_buckets:
        engine = BatchInferenceEngine.from_corpus(
            model, _page_sizes(paths, read_head), max_buckets=args.auto_buckets, **kwargs)
    else:
        engine = BatchInferenceEngine(model, image_sizes=tuple(args.sizes), **kwargs)
    logger.info("Serving buckets: %s", engine.image_sizes)

    names = _label_names(config.model.num_classes, args.dataset)
    records = []
    # chunked, so that a corpus never sits in memory at once: one chunk of
    # page bytes and detections at a time (the engine pipelines within it)
    chunk_pages = max(args.batch_size * 32, args.batch_size)
    for start in range(0, len(paths), chunk_pages):
        chunk = paths[start:start + chunk_pages]
        pages = [read(p) for p in chunk]
        for path, page, dets in zip(chunk, pages, engine.predict_pages(pages)):
            records.append({"file": path, **detections_to_json(dets, names)})
            if args.visualize:
                out = os.path.join(args.visualize, os.path.basename(path) + ".pred.jpg")
                _visualize(page if shard_index is not None else path, dets, out, names)
        del pages
        if len(paths) > chunk_pages:
            logger.info("Predicted %d/%d pages", min(start + chunk_pages, len(paths)),
                        len(paths))

    if args.output:
        with open_path(args.output, "w") as f:
            f.write(json.dumps(records, indent=1))
        logger.info("Wrote %d page records to %s", len(records), args.output)
    return records


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description="Run layout detection on page images")
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint: the port's .pt or a JAX .msgpack")
    parser.add_argument("--input", default=None,
                        help="image file, directory, or glob (with --shards: optional "
                             "member-name filter)")
    parser.add_argument("--shards", default=None,
                        help="read pages from a tar-shard dir built by tools/make_shards.py")
    parser.add_argument("--output", default=None, help="detections JSON path (local or a URL)")
    parser.add_argument("--sizes", type=int, nargs="+", default=[224],
                        help="serving bucket resolutions")
    parser.add_argument("--auto-buckets", type=int, default=0,
                        help="plan N cost-optimal buckets from the input pages' sizes "
                             "instead of --sizes")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--score-thresh", type=float, default=0.05)
    parser.add_argument("--int8", action="store_true",
                        help="int8 W8A8 encoder (ops/quant.py)")
    parser.add_argument("--dataset", default=None,
                        choices=["publaynet", "doclaynet", "docbank"],
                        help="label-name inventory (default: from the model's class count)")
    parser.add_argument("--visualize", default=None, help="directory for box-overlay JPEGs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if not args.input and not args.shards:
        parser.error("one of --input / --shards is required")
    return run(args)


if __name__ == "__main__":
    main()
