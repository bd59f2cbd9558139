"""Batch inference serving with padded size buckets (port of
``layoutdit_tpu/eval/serving.py::BatchInferenceEngine``).

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
pages on the host (numpy, or its native loader's decode + resize), this
one uploads each page in its own dtype (uint8 for images) and resizes it
with ``F.interpolate`` on the device, the same bilinear formula
(align_corners=False) after the same /255 scaling; on an H100 host the
numpy resize of a 1000 px page took tens of milliseconds and serialized
on the interpreter lock (PERF.md). A chunk of JPEG pages is decoded by
the native loader's decode-only entry (``native/loader.py``: header
sizes for routing, then one threaded batch decode into uint8 arrays);
without the loader (no g++ or libjpeg) PIL decodes, and the engine logs
once that it does. Other encoded pages (PNG) always go through PIL.

A mask model's pages also get ``masks``: each kept detection's mask
pasted on the host into its page (``eval/masks.py``), a cropped
``(x0, y0, bitmap)`` window each; ``paste_seconds`` sums the host time
the pastes take.

Data-parallel serving (``devices``, the JAX engine's ``mesh``): one
replica of the weights on each of N devices, the static batch split into
N replica batches of ``batch_size / N`` pages, each chunk of pages sent
to the next replica in turn, each replica dispatched from a thread of
its own, so that the cards run side by side.

Tensor-parallel serving (``mesh``, a ``parallel.mesh.DataMesh`` with a
model group, JAX ``serving.py:118-190``): every rank of the mesh holds an
engine over its shards of the weights (``parallel/sharding.py``). Rank 0
runs the host pipeline; for each padded bucket batch it broadcasts the
images to every rank (``Comm.broadcast_``), each model group predicts
its data index's rows of the batch together (``detector_predict(tp=)``),
and rank 0 gathers the detections of each group's first rank back into
batch order. The other ranks wait in ``serve_follower`` until rank 0's
``close()``. int8 with tensor parallelism raises, as JAX's engine does.

``ExportedInferenceEngine`` runs the same pipeline over an exported
artifact (``export.py``) instead of the model: its buckets and batch
size come from the artifact's manifest, and it serves boxes only, as the
JAX package's exported engine does.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import io
import os
import threading
import time
import types
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from layoutdit_tpu_torch.eval.masks import paste_mask_in_box
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.detection.detector import (
    DetectorModel,
    detector_predict,
    params_for_inference,
    rescale_detections,
)
from layoutdit_tpu_torch.models.lora import merge_lora_detector
from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map, tree_paths
from layoutdit_tpu_torch.native import loader as native_loader
from layoutdit_tpu_torch.ops.quant import quantize_detector_params
from layoutdit_tpu_torch.ops.interpolate import resize_bilinear

logger = get_logger(__name__)


@dataclasses.dataclass
class PageDetections:
    boxes: np.ndarray  # [K, 4] xyxy, original page coordinates
    scores: np.ndarray  # [K]
    labels: np.ndarray  # [K] int (1..NC)
    # a mask model's: per detection an (x0, y0, bitmap uint8 [h, w]) window
    # in page coordinates (eval/masks.py); None without a mask head
    masks: list | None = None


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
      batch_size: static batch per device call (padded); with ``devices``,
        per call over all of them, split evenly.
      score_thresh: drop detections below this score.
      decode_workers: host threads decoding pages ahead of the device
        (default cpu_count - 1, at most 4, at least 1).
      max_in_flight: dispatched batches whose results are fetched later.
      device: where the model runs; "cuda" unless the caller asks for
        the CPU. A CUDA device with no GPU present raises.
      int8: serve the encoder's linears in W8A8 int8 (``ops/quant.py``,
        ``VIT_INT8_DEFAULT_KEYS``), LoRA adapters merged first
        (``models/lora.py``), as the JAX engine does; off by default.
      devices: data-parallel serving over these devices, one replica
        each (``device`` is ignored); ``batch_size`` must divide over them.
      mesh: tensor-parallel serving over a data x model mesh (the module
        docstring); ``model`` holds the full weights, and the engine keeps
        this rank's shards. Every rank of the mesh builds its engine;
        rank 0 serves, the others run ``serve_follower``.
    """

    def _init_pipeline_fields(
        self,
        score_thresh: float,
        decode_workers: int | None,
        max_in_flight: int,
        device: str | torch.device,
    ) -> None:
        """Host-pipeline fields shared by the live and exported engines."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: no CUDA device is available")
        if decode_workers is None:
            decode_workers = max(1, min(4, (os.cpu_count() or 2) - 1))
        self.score_thresh = score_thresh
        self.decode_workers = decode_workers
        self.max_in_flight = max(1, max_in_flight)
        self._replicas = [(self.device, None)]  # (device, its weights)
        self._with_masks = False  # the live engine's, for a mask model
        self.paste_seconds = 0.0  # host time spent pasting masks, summed over requests

    def __init__(
        self,
        model: DetectorModel,
        image_sizes: Sequence[int] = (224,),
        batch_size: int = 8,
        score_thresh: float = 0.05,
        decode_workers: int | None = None,
        max_in_flight: int = 2,
        device: str | torch.device = "cuda",
        int8: bool = False,
        devices: Sequence[str | torch.device] | None = None,
        mesh=None,
    ):
        if mesh is not None and (mesh.model is None or mesh.model.size == 1):
            mesh = None
        if mesh is not None and (int8 or devices):
            raise ValueError("tensor-parallel serving: int8 (quantized kernels are not "
                             "model-sharded; JAX's engine refuses it too) and devices (the "
                             "mesh places the replicas) do not apply")
        if mesh is not None and batch_size % mesh.degree:
            raise ValueError(f"batch_size {batch_size} does not divide over the "
                             f"{mesh.degree} data-parallel model groups")
        self._mesh = mesh
        devices = [torch.device(d) for d in (devices or [device])]
        self._init_pipeline_fields(score_thresh, decode_workers, max_in_flight, devices[0])
        if batch_size % len(devices):
            raise ValueError(f"batch_size {batch_size} does not divide over the "
                             f"{len(devices)} serving devices")
        self.model = model
        self.image_sizes = sorted(image_sizes)
        self.batch_size = batch_size
        if int8:
            # adapters folded first: quantization refuses unmerged ones
            base = quantize_detector_params(merge_lora_detector(
                tree_map(lambda t: t.to(devices[0]), model.params), model.cfg.backbone.vit))
        else:
            base = model.params
        if mesh is not None:  # this rank's shards of the weights
            from layoutdit_tpu_torch.parallel.sharding import TpLayout

            shards = TpLayout(tree_paths(base), mesh.model).shard(tree_leaves(base))
            it = iter(shards)
            base = tree_map(lambda _: next(it), base)
        weights = {}  # one copy a device, whatever its replicas
        for dev in devices:
            if dev not in weights:
                weights[dev] = params_for_inference(
                    tree_map(lambda t, dev=dev: t.to(dev), base), model.cfg.dtype)
        self._replicas = [(dev, weights[dev]) for dev in devices]
        self.params = weights[devices[0]]
        self._cfgs: dict[int, object] = {}
        self._cfgs_lock = threading.Lock()  # the replica threads make them
        self._with_masks = bool(model.cfg.with_mask)

    @classmethod
    def from_corpus(
        cls,
        model: DetectorModel,
        page_sizes,
        max_buckets: int = 3,
        **kwargs,
    ) -> "BatchInferenceEngine":
        """An engine with the cost-optimal buckets for a corpus of
        (height, width) page sizes (``eval/buckets.py``)."""
        from layoutdit_tpu_torch.eval.buckets import plan_buckets

        patch = model.cfg.backbone.vit.patch_size
        sizes = plan_buckets(page_sizes, k=max_buckets, patch=patch)
        return cls(model, image_sizes=sizes, **kwargs)

    def _cfg_for(self, size: int):
        with self._cfgs_lock:
            if size not in self._cfgs:
                self._cfgs[size] = dataclasses.replace(self.model.cfg, image_size=size)
                logger.info("serving bucket size=%d batch=%d", size, self.batch_size)
            return self._cfgs[size]

    def _bucket_for(self, h: int, w: int) -> int:
        i = bisect.bisect_left(self.image_sizes, max(h, w))
        return self.image_sizes[min(i, len(self.image_sizes) - 1)]

    def _decode_page(self, page):
        """One page -> (pixels, divide, (h, w)) on a decode worker: JPEG
        bytes become uint8 [H, W, 3] (PIL), arrays pass through ([H, W, 3],
        [3, H, W] or [H, W]); ``divide`` says the values are scaled by
        1/255: always for a JPEG, else when they exceed 1.5 (the JAX
        engine's test). A page that fails to decode gives (None, False,
        (0, 0)), which marks its slot invalid; the rest of the batch
        proceeds."""
        if isinstance(page, (bytes, bytearray)):
            try:
                with _open_jpeg(bytes(page)) as im:
                    arr = np.array(im.convert("RGB"))
            except (OSError, ValueError):
                logger.warning("a page failed to decode; zeroed")
                return None, False, (0.0, 0.0)
            return arr, True, arr.shape[:2]
        arr = np.ascontiguousarray(page)
        if not arr.flags.writeable:  # torch.from_numpy wants writable memory
            arr = arr.copy()
        hw = arr.shape[:2] if arr.ndim == 3 and arr.shape[-1] == 3 else arr.shape[-2:]
        return arr, float(arr.max()) > 1.5, hw

    def _decode_native(self, jpegs: list[bytes], dims: list[tuple[int, int]]) -> list:
        """A chunk of JPEG pages through the native loader's decode-only
        entry (its own threads) -> ``_decode_page``'s triples."""
        arrays = native_loader.decode_batch(jpegs, dims, n_threads=self.decode_workers)
        if any(a is None for a in arrays):
            logger.warning("%d pages failed to decode; zeroed",
                           sum(a is None for a in arrays))
        return [(None, False, (0.0, 0.0)) if a is None else (a, True, a.shape[:2])
                for a in arrays]

    @staticmethod
    def _page_size(page) -> tuple[int, int]:
        """(h, w) for routing: an array's shape, an encoded page's header
        (``header_size``); a page that does not read routes as (1, 1),
        the smallest bucket, and its slot is zeroed."""
        if isinstance(page, (bytes, bytearray)):
            return header_size(page) or (1, 1)
        arr = np.asarray(page)
        return arr.shape[-2:] if arr.shape[0] in (1, 3) else arr.shape[:2]

    @property
    def replica_batch(self) -> int:
        """Pages per device call: the static batch over the replicas."""
        return self.batch_size // len(self._replicas)

    def _upload_batch(self, decoded, size: int, device: torch.device | None = None):
        """Decoded pages -> (images [batch, 3, S, S] float32 in [0, 1] on
        ``device`` (the engine's), orig [batch, 2] on the host), padded to
        the replica batch with zero images of size (1, 1)."""
        device = device or self.device
        images = torch.zeros((self.replica_batch, 3, size, size), device=device)
        orig = np.ones((self.replica_batch, 2), np.float32)
        for i, (arr, divide, hw) in enumerate(decoded):
            orig[i] = hw
            if arr is None:
                continue
            x = torch.from_numpy(arr).to(device).float()
            if x.dim() == 3 and x.shape[-1] == 3:  # HWC -> CHW
                x = x.permute(2, 0, 1)
            if divide:
                x = x / 255.0
            images[i] = resize_bilinear(x, size, size)
        return images, orig

    def _run(self, size: int, images: torch.Tensor, orig: np.ndarray, params=None):
        """-> the rescaled detections, and a mask model's mask
        probabilities [B, D, 2P, 2P] beside them (``params``: a
        replica's weights, the engine's by default). Under a mesh, rank
        0's call runs the batch on every rank (``_run_mesh``)."""
        if self._mesh is not None:
            return self._run_mesh(size, images, orig)
        return self._predict(size, images, orig, self.params if params is None else params)

    def _predict(self, size: int, images: torch.Tensor, orig: np.ndarray, params,
                 tp=None):
        cfg = self._cfg_for(size)
        o = torch.from_numpy(orig).to(images.device)
        if self._with_masks:
            dets, probs = detector_predict(params, images, cfg, with_masks=True, tp=tp)
            return rescale_detections(dets, o, size), probs
        return rescale_detections(detector_predict(params, images, cfg, tp=tp), o, size)

    def _run_rows(self, size: int, images: torch.Tensor, orig: np.ndarray):
        """This rank's model group's rows of a broadcast batch, predicted
        on its shards -> the detections on the host."""
        k = images.shape[0] // self._mesh.degree
        rows = slice(self._mesh.rank * k, (self._mesh.rank + 1) * k)
        out = self._predict(size, images[rows], orig[rows], self.params, self._mesh.model)
        return _to_host(out)

    def _run_mesh(self, size: int, images: torch.Tensor, orig: np.ndarray):
        """Rank 0: the batch to every rank, each group's rows predicted
        there, the groups' first ranks' detections gathered in order."""
        world = self._mesh.everyone
        world.broadcast_object(("run", size, tuple(images.shape), orig))
        world.broadcast_(images.contiguous())
        parts = world.all_gather_object(self._run_rows(size, images, orig))
        mp = self._mesh.model.size
        return _cat_host([parts[d * mp] for d in range(self._mesh.degree)])

    def serve_follower(self) -> None:
        """A rank other than 0 of a serving mesh: run rank 0's batches on
        this rank's shards until rank 0's ``close()``."""
        world = self._mesh.everyone
        with torch.inference_mode():
            while True:
                msg = world.broadcast_object(None)
                if msg is None or msg[0] != "run":
                    return
                _, size, shape, orig = msg
                images = world.broadcast_(torch.empty(shape, device=self.device))
                world.all_gather_object(self._run_rows(size, images, orig))

    def close(self) -> None:
        """Rank 0 of a serving mesh: release the followers (each returns
        from ``serve_follower``). Nothing without a mesh."""
        if self._mesh is not None and self._mesh.lead:
            self._mesh.everyone.broadcast_object(("stop",))

    def _dispatch(self, size: int, decoded, replica) -> tuple[np.ndarray, object]:
        """Upload and run one chunk on ``replica`` -> (orig, detections)."""
        device, params = replica
        guard = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with guard, torch.inference_mode():
            images, orig = self._upload_batch(decoded, size, device)
            return orig, self._run(size, images, orig, params)

    def predict_pages(self, pages: Sequence) -> list[PageDetections]:
        """Run detection on a list of pages (one document or many)."""
        # the headers give the sizes; pixels decode after bucketing
        sizes = [self._page_size(p) for p in pages]

        buckets: dict[int, list[int]] = {}
        for i, (h, w) in enumerate(sizes):
            buckets.setdefault(self._bucket_for(h, w), []).append(i)

        results: list[PageDetections | None] = [None] * len(pages)

        def fetch(chunk, done):
            orig, out = done.result() if isinstance(done, Future) else done
            decoded_ok = (orig > 0).all(axis=1)  # (0, 0) = failed slot
            dets, probs = out if self._with_masks else (out, None)
            boxes = dets.boxes.float().cpu().numpy()
            scores = dets.scores.float().cpu().numpy()
            labels = dets.labels.cpu().numpy()
            valid = dets.valid.cpu().numpy() & (scores >= self.score_thresh)
            if probs is not None:
                probs = probs.cpu().numpy()
            for slot, page_idx in enumerate(chunk):
                keep = valid[slot] & decoded_ok[slot]
                masks = None
                if probs is not None:
                    t0 = time.perf_counter()
                    im_h, im_w = max(int(orig[slot, 0]), 1), max(int(orig[slot, 1]), 1)
                    masks = [paste_mask_in_box(probs[slot, di], boxes[slot, di], im_h, im_w)
                             for di in np.nonzero(keep)[0]]
                    self.paste_seconds += time.perf_counter() - t0
                results[page_idx] = PageDetections(
                    boxes=boxes[slot][keep], scores=scores[slot][keep],
                    labels=labels[slot][keep], masks=masks,
                )

        chunks = [
            (size, indices[start:start + self.replica_batch])
            for size, indices in buckets.items()
            for start in range(0, len(indices), self.replica_batch)
        ]
        in_flight: list = []
        n = len(self._replicas)
        with ThreadPoolExecutor(max_workers=self.decode_workers) as pool, \
                contextlib.ExitStack() as stack:
            # one dispatch thread per replica, so that the devices overlap
            replica_threads = [stack.enter_context(ThreadPoolExecutor(1)) for _ in range(n)
                               ] if n > 1 else None
            # bounded decode-ahead, counted in batches: enough to keep the
            # workers busy plus the dispatch window; each page is its own
            # task, so one batch's pages decode in parallel
            pending: deque = deque()
            chunk_iter = iter(chunks)
            ahead = self.decode_workers + self.max_in_flight + 1

            def submit_next() -> None:
                nxt = next(chunk_iter, None)
                if nxt is None:
                    return
                _, chunk_ = nxt
                if native_loader.available() and all(is_jpeg(pages[i]) for i in chunk_):
                    # all JPEG: one native batch decode, on its own threads
                    fut = pool.submit(self._decode_native, [bytes(pages[i]) for i in chunk_],
                                      [sizes[i] for i in chunk_])
                    pending.append((nxt, fut.result))
                else:
                    futs = [pool.submit(self._decode_page, pages[i]) for i in chunk_]
                    pending.append((nxt, lambda futs=futs: [f.result() for f in futs]))

            for _ in range(ahead * n):
                submit_next()
            dispatched = 0
            while pending:
                (size, chunk), decoded = pending.popleft()
                decoded = decoded()
                submit_next()
                r = dispatched % n
                dispatched += 1
                if replica_threads is None:
                    done = self._dispatch(size, decoded, self._replicas[r])
                else:
                    done = replica_threads[r].submit(self._dispatch, size, decoded,
                                                     self._replicas[r])
                in_flight.append((chunk, done))
                if len(in_flight) >= self.max_in_flight * n:
                    fetch(*in_flight.pop(0))
        for entry in in_flight:
            fetch(*entry)
        return results  # type: ignore[return-value]

    def predict_document(self, pages: Sequence) -> list[PageDetections]:
        """Alias: a document is a list of pages."""
        return self.predict_pages(pages)


def _to_host(out):
    """Detections (and a mask model's probabilities) on the host."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(_to_host(o) for o in out)
    if hasattr(out, "_fields"):
        return type(out)(*[t.cpu() for t in out])
    return out.cpu()


def _cat_host(parts: list):
    """The model groups' host detections, concatenated on the batch dim."""
    first = parts[0]
    if isinstance(first, tuple) and not hasattr(first, "_fields"):
        return tuple(_cat_host([p[i] for p in parts]) for i in range(len(first)))
    if hasattr(first, "_fields"):
        return type(first)(*[torch.cat(ts) for ts in zip(*parts)])
    return torch.cat(parts)


def is_jpeg(page) -> bool:
    """Whether a page is JPEG bytes (by its SOI marker): those go through
    the native loader; other encodings (PNG) through PIL."""
    return isinstance(page, (bytes, bytearray)) and page[:2] == b"\xff\xd8"


def header_size(page: bytes) -> tuple[int, int] | None:
    """(h, w) of an encoded page from its header alone, no pixel decode:
    the native loader's header read for a JPEG, else PIL's; None when it
    does not read."""
    page = bytes(page)
    if is_jpeg(page) and native_loader.available():
        return native_loader.jpeg_dims(page)
    if is_jpeg(page):
        _warn_pil_once()
    try:
        with _open_jpeg(page) as im:
            w, h = im.size
    except (OSError, ValueError):
        return None
    return h, w


def _warn_pil_once() -> None:
    if not _warn_pil_once.done:
        _warn_pil_once.done = True
        logger.warning("native JPEG loader unavailable (g++ or libjpeg missing): "
                       "decoding JPEG pages with PIL")


_warn_pil_once.done = False


class ExportedInferenceEngine(BatchInferenceEngine):
    """The same pipelined serving engine over an exported artifact
    (``export.py``) instead of the model: bucketing, padded static
    batches, decode-ahead and the in-flight window are the live engine's,
    and each bucket runs its exported program. ``batch_size`` and
    ``image_sizes`` come from the artifact's manifest; ``device`` defaults
    to the artifact's, and another raises."""

    def __init__(
        self,
        exported,
        score_thresh: float = 0.05,
        decode_workers: int | None = None,
        max_in_flight: int = 2,
        device: str | torch.device | None = None,
    ):
        from layoutdit_tpu_torch.export import ExportedDetector

        if isinstance(exported, (str, os.PathLike)):
            exported = ExportedDetector(os.fspath(exported), device=device)
        elif device is not None and torch.device(device).type != exported.device.type:
            raise ValueError(f"the artifact runs on {exported.device.type}, not {device}")
        self._init_pipeline_fields(score_thresh, decode_workers, max_in_flight,
                                   exported.device)
        self.exported = exported
        self.model = None
        self.params = None  # the weights are the artifact's
        self.image_sizes = sorted(exported.image_sizes)
        self.batch_size = int(exported.manifest["batch_size"])

    def _run(self, size: int, images: torch.Tensor, orig: np.ndarray, params=None):
        # attribute view of the outputs, as predict_pages' fetch reads them
        return types.SimpleNamespace(**self.exported.predict_async(images, orig))
