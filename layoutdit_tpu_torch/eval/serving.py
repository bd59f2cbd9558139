"""Batch inference serving with padded size buckets (port of
``layoutdit_tpu/eval/serving.py::BatchInferenceEngine``, single device).

Pages (uint8 or float arrays, [H, W, 3] or [3, H, W]; JPEG bytes when
PIL is installed) are routed to the smallest bucket >= max(h, w),
decoded on host threads, resized on the device, padded to the engine's
static batch, and run through ``detector_predict`` +
``rescale_detections`` for that bucket; boxes come back in page
coordinates. Every bucket shares the model's weights and detection
budget: the ViT resamples its position embeddings to the bucket's grid
and the anchors follow the bucket's size.

The host pipeline is the JAX engine's: decode workers prepare batches
ahead, the main thread dispatches, and results are fetched
``max_in_flight`` batches behind. One difference: the JAX engine resizes
pages on the host (numpy), this one uploads each page in its own dtype
(uint8 for images) and resizes it with ``F.interpolate`` on the device,
the same bilinear formula (align_corners=False) after the same /255
scaling; on an H100 host the numpy resize of a 1000 px page took tens
of milliseconds and serialized on the interpreter lock (PERF.md).
"""

from __future__ import annotations

import bisect
import dataclasses
import io
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorModel,
    detector_predict,
    params_for_inference,
    rescale_detections,
)
from layoutdit_tpu_torch.models.weights_io import tree_map
from layoutdit_tpu_torch.ops.interpolate import resize_bilinear

logger = get_logger(__name__)


@dataclasses.dataclass
class PageDetections:
    boxes: np.ndarray  # [K, 4] xyxy, original page coordinates
    scores: np.ndarray  # [K]
    labels: np.ndarray  # [K] int (1..NC)


def _open_jpeg(data: bytes):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "JPEG pages need PIL; pass decoded uint8/float arrays instead"
        ) from e
    return Image.open(io.BytesIO(data))


class BatchInferenceEngine:
    """Bucketed batch inference over a detector.

    Args:
      model: ``DetectorModel`` (anything with ``.params`` and ``.cfg``).
      image_sizes: ascending bucket resolutions (multiples of the patch
        size); pages route to the smallest bucket >= max(h, w), the last
        bucket catches everything larger.
      batch_size: static batch per device call (padded).
      score_thresh: drop detections below this score.
      decode_workers: host threads decoding pages ahead of the device
        (default cpu_count - 1, at most 4, at least 1).
      max_in_flight: dispatched batches whose results are fetched later.
      device: where the model runs; "cuda" unless the caller asks for
        the CPU. A CUDA device with no GPU present raises.
    """

    def __init__(
        self,
        model: DetectorModel,
        image_sizes: Sequence[int] = (224,),
        batch_size: int = 8,
        score_thresh: float = 0.05,
        decode_workers: int | None = None,
        max_in_flight: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchInferenceEngine: no CUDA device is available")
        if decode_workers is None:
            decode_workers = max(1, min(4, (os.cpu_count() or 2) - 1))
        self.model = model
        self.image_sizes = sorted(image_sizes)
        self.batch_size = batch_size
        self.score_thresh = score_thresh
        self.decode_workers = decode_workers
        self.max_in_flight = max(1, max_in_flight)
        self.params = params_for_inference(
            tree_map(lambda t: t.to(self.device), model.params), model.cfg.dtype
        )
        self._cfgs: dict[int, object] = {}

    def _cfg_for(self, size: int):
        if size not in self._cfgs:
            self._cfgs[size] = dataclasses.replace(self.model.cfg, image_size=size)
            logger.info("serving bucket size=%d batch=%d", size, self.batch_size)
        return self._cfgs[size]

    def _bucket_for(self, h: int, w: int) -> int:
        i = bisect.bisect_left(self.image_sizes, max(h, w))
        return self.image_sizes[min(i, len(self.image_sizes) - 1)]

    def _decode_page(self, page):
        """One page -> (pixels, divide, (h, w)) on a decode worker: JPEG
        bytes become uint8 [H, W, 3], arrays pass through ([H, W, 3],
        [3, H, W] or [H, W]); ``divide`` says the values exceed 1.5 and
        are scaled by 1/255 (the JAX engine's test). A page that fails to
        decode gives (None, False, (0, 0)), which marks its slot invalid;
        the rest of the batch proceeds."""
        if isinstance(page, (bytes, bytearray)):
            try:
                with _open_jpeg(bytes(page)) as im:
                    arr = np.array(im.convert("RGB"))
            except (OSError, ValueError):
                logger.warning("a page failed to decode; zeroed")
                return None, False, (0.0, 0.0)
        else:
            arr = np.ascontiguousarray(page)
            if not arr.flags.writeable:  # torch.from_numpy wants writable memory
                arr = arr.copy()
        hw = arr.shape[:2] if arr.ndim == 3 and arr.shape[-1] == 3 else arr.shape[-2:]
        return arr, float(arr.max()) > 1.5, hw

    def _upload_batch(self, decoded, size: int):
        """Decoded pages -> (images [batch, 3, S, S] float32 in [0, 1] on
        the device, orig [batch, 2] on the host), padded to the static
        batch with zero images of size (1, 1)."""
        images = torch.zeros((self.batch_size, 3, size, size), device=self.device)
        orig = np.ones((self.batch_size, 2), np.float32)
        for i, (arr, divide, hw) in enumerate(decoded):
            orig[i] = hw
            if arr is None:
                continue
            x = torch.from_numpy(arr).to(self.device).float()
            if x.dim() == 3 and x.shape[-1] == 3:  # HWC -> CHW
                x = x.permute(2, 0, 1)
            if divide:
                x = x / 255.0
            images[i] = resize_bilinear(x, size, size)
        return images, orig

    def _run(self, size: int, images: torch.Tensor, orig: np.ndarray):
        cfg = self._cfg_for(size)
        o = torch.from_numpy(orig).to(self.device)
        return rescale_detections(detector_predict(self.params, images, cfg), o, size)

    def predict_pages(self, pages: Sequence) -> list[PageDetections]:
        """Run detection on a list of pages (one document or many)."""
        sizes = []
        for p in pages:
            if isinstance(p, (bytes, bytearray)):
                # the header gives the size; pixels decode after bucketing
                try:
                    with _open_jpeg(bytes(p)) as im:
                        w, h = im.size
                except (OSError, ValueError):
                    w = h = 1  # corrupt page: smallest bucket, zeroed slot
            else:
                arr = np.asarray(p)
                h, w = arr.shape[-2:] if arr.shape[0] in (1, 3) else arr.shape[:2]
            sizes.append((h, w))

        buckets: dict[int, list[int]] = {}
        for i, (h, w) in enumerate(sizes):
            buckets.setdefault(self._bucket_for(h, w), []).append(i)

        results: list[PageDetections | None] = [None] * len(pages)

        def fetch(chunk, decoded_ok, dets):
            boxes = dets.boxes.float().cpu().numpy()
            scores = dets.scores.float().cpu().numpy()
            labels = dets.labels.cpu().numpy()
            valid = dets.valid.cpu().numpy() & (scores >= self.score_thresh)
            for slot, page_idx in enumerate(chunk):
                keep = valid[slot] & decoded_ok[slot]
                results[page_idx] = PageDetections(
                    boxes=boxes[slot][keep], scores=scores[slot][keep],
                    labels=labels[slot][keep],
                )

        chunks = [
            (size, indices[start:start + self.batch_size])
            for size, indices in buckets.items()
            for start in range(0, len(indices), self.batch_size)
        ]
        in_flight: list = []
        with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
            # bounded decode-ahead, counted in batches: enough to keep the
            # workers busy plus the dispatch window; each page is its own
            # task, so one batch's pages decode in parallel
            pending: deque = deque()
            chunk_iter = iter(chunks)
            ahead = self.decode_workers + self.max_in_flight + 1

            def submit_next() -> None:
                nxt = next(chunk_iter, None)
                if nxt is not None:
                    size_, chunk_ = nxt
                    pending.append((nxt, [
                        pool.submit(self._decode_page, pages[i]) for i in chunk_
                    ]))

            for _ in range(ahead):
                submit_next()
            while pending:
                (size, chunk), futs = pending.popleft()
                decoded = [f.result() for f in futs]
                submit_next()
                with torch.inference_mode():
                    images, orig = self._upload_batch(decoded, size)
                    dets = self._run(size, images, orig)
                decoded_ok = (orig > 0).all(axis=1)  # (0, 0) = failed slot
                in_flight.append((chunk, decoded_ok, dets))
                if len(in_flight) >= self.max_in_flight:
                    fetch(*in_flight.pop(0))
        for entry in in_flight:
            fetch(*entry)
        return results  # type: ignore[return-value]
