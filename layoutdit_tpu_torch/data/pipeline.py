"""Training input pipeline (port of ``layoutdit_tpu/data/pipeline.py``).

``DetectionLoader`` yields ``DetectionBatch``es with the JAX loader's
epoch order (``np.random.default_rng(seed + epoch)``), target scaling and
padding (``prepare_targets``) and horizontal-flip decisions (hashed from
seed, epoch and dataset index). Pages decode on host threads in a
producer thread that stays ``prefetch_depth`` batches ahead; their uint8
pixels and the padded targets go to pinned memory and reach the device
with ``non_blocking`` copies. One difference from the JAX loader: pages
are uploaded as uint8 and resized on the device (``F.interpolate``, the
same bilinear formula after the same /255 scaling) instead of resized
on the host in numpy; the flip is applied to the resized image, as in
the JAX loader. With ``load_masks`` (the Mask R-CNN branch) each batch
also carries ``gt_masks`` [B, G, M, M] uint8: each kept box's
segmentation rasterised on the host onto an M x M grid over the whole
page (``data/masks.py``, from the page's original size, M =
``mask_size`` or image_size // 2), flipped with the page, and uploaded
with the batch.

Under data parallelism each rank decodes only its rows of every global
batch (``rows``; ``parallel/mesh.py::DataMesh.rows``), as the JAX
loader's ``_process_local_rows``: every rank walks the same epoch order
and takes the same ``skip_batches`` offset, and the ranks' batches,
concatenated in rank order, are the global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from layoutdit_tpu_torch.data.masks import rasterize_target_masks
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.ops.interpolate import resize_bilinear

logger = get_logger(__name__)


@dataclass
class DetectionBatch:
    images: torch.Tensor  # [B, 3, S, S] float32 in [0, 1], on the device
    gt_boxes: torch.Tensor  # [B, G, 4] float32, model (S x S) space, on the device
    gt_labels: torch.Tensor  # [B, G] int32, on the device
    gt_valid: torch.Tensor  # [B, G] bool, on the device
    image_ids: np.ndarray  # [B] int64
    orig_sizes: np.ndarray  # [B, 2] float32 (height, width)
    image_valid: np.ndarray  # [B] bool (False = batch padding)
    gt_masks: torch.Tensor | None = None  # [B, G, M, M] uint8, on the device (load_masks)


def prepare_targets(
    target: dict, h: int, w: int, image_size: int, max_gt: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scale one image's boxes into model space and pad them to
    ``max_gt`` -> (boxes [G, 4], labels [G] int32, valid [G])."""
    boxes = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
    labels = np.asarray(target["labels"], np.int64)
    n = min(len(boxes), max_gt)
    if len(boxes) > max_gt:
        logger.warning("Clipping %d gt boxes to max_gt=%d", len(boxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_valid = np.zeros((max_gt,), bool)
    if n:
        scale = np.array(
            [image_size / w, image_size / h, image_size / w, image_size / h], np.float32
        )
        out_boxes[:n] = boxes[:n] * scale
        out_labels[:n] = labels[:n]
        out_valid[:n] = True
    return out_boxes, out_labels, out_valid


@dataclass
class _HostBatch:
    pages: list[np.ndarray]  # uint8 [H, W, 3] per filled slot
    flip: np.ndarray  # [B] bool
    gt_boxes: torch.Tensor
    gt_labels: torch.Tensor
    gt_valid: torch.Tensor
    image_ids: np.ndarray
    orig_sizes: np.ndarray
    image_valid: np.ndarray
    pixels: torch.Tensor | None  # [n, H, W, 3] uint8 when every page shares a shape
    gt_masks: torch.Tensor | None = None  # [B, G, M, M] uint8


def _stack(batches: list[DetectionBatch]) -> DetectionBatch:
    """S batches as one: device tensors [S, B, ...], host metadata [S*B]."""
    masks = batches[0].gt_masks
    return DetectionBatch(
        images=torch.stack([b.images for b in batches]),
        gt_boxes=torch.stack([b.gt_boxes for b in batches]),
        gt_labels=torch.stack([b.gt_labels for b in batches]),
        gt_valid=torch.stack([b.gt_valid for b in batches]),
        image_ids=np.concatenate([b.image_ids for b in batches]),
        orig_sizes=np.concatenate([b.orig_sizes for b in batches]),
        image_valid=np.concatenate([b.image_valid for b in batches]),
        gt_masks=None if masks is None else torch.stack([b.gt_masks for b in batches]),
    )


class DetectionLoader:
    """Iterable over ``DetectionBatch`` with threaded decode, pinned
    host buffers and device-side resize.

    Args:
      dataset: ``PubLayNetDataset`` (anything with ``ids``,
        ``load_image`` and ``load_target``).
      stack_batches: S > 1 yields S consecutive batches as one (tensors
        [S, B, ...]) for ``steps_per_dispatch``.
      load_masks: also rasterise the gt masks (``gt_masks``); the dataset
        must keep the segmentations (``with_segmentation``).
      mask_size: M of the [B, G, M, M] block (0: image_size // 2).
      device: where batches land; "cuda" unless the caller asks for the
        CPU. A CUDA device with no GPU present raises.
      rows: the slots of each global batch of ``batch_size`` that this
        loader assembles (a data-parallel rank's); each batch then has
        ``len(rows)`` rows, row j holding global slot ``rows[j]``, and
        slots past an epoch's remainder stay padding. None: every slot.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 16,
        shuffle: bool = True,
        num_workers: int = 2,
        image_size: int = 224,
        max_gt: int = 128,
        seed: int = 0,
        drop_last: bool = False,
        prefetch_depth: int = 2,
        augment_hflip: float = 0.0,
        stack_batches: int = 1,
        device: str | torch.device = "cuda",
        load_masks: bool = False,
        mask_size: int = 0,
        rows: Sequence[int] | None = None,
    ):
        if load_masks and not getattr(dataset, "with_segmentation", False):
            raise ValueError("load_masks=True needs a dataset constructed with "
                             "with_segmentation=True (the segmentation field is dropped "
                             "otherwise)")
        self.load_masks = load_masks
        self.mask_size = mask_size or image_size // 2
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DetectionLoader: no CUDA device is available")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.image_size = image_size
        self.max_gt = max_gt
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch_depth = max(1, prefetch_depth)
        self.augment_hflip = augment_hflip
        self.stack_batches = max(1, stack_batches)
        self.rows = np.arange(batch_size) if rows is None else np.asarray(rows, np.int64)
        self._epoch = 0
        self._start_batch = 0
        self._pool: ThreadPoolExecutor | None = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle/augmentation epoch, so data order is a
        function of (seed, epoch) alone."""
        self._epoch = int(epoch)

    def skip_batches(self, n: int) -> None:
        """One-shot: the next epoch's iteration starts ``n`` batches into
        the epoch order (a mid-epoch resume)."""
        self._start_batch = int(n)

    def close(self) -> None:
        """Release the decode threads (recreated on the next epoch)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return order

    def _batches_of_indices(self) -> Iterator[np.ndarray]:
        order = self._epoch_order()
        start, self._start_batch = self._start_batch, 0
        n_full = len(order) // self.batch_size
        for i in range(start, n_full):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]
        if len(order) % self.batch_size and not self.drop_last and start <= n_full:
            yield order[n_full * self.batch_size:]

    def _load(self, idx: int):
        img_id = self.dataset.ids[idx]
        return self.dataset.load_image(img_id), self.dataset.load_target(img_id)

    def _assemble(self, idxs: Sequence[int]) -> _HostBatch:
        """Decode and pad this loader's rows of one global batch on the
        host (in the producer thread)."""
        b, s, g = len(self.rows), self.image_size, self.max_gt
        gt_boxes = np.zeros((b, g, 4), np.float32)
        gt_labels = np.zeros((b, g), np.int32)
        gt_valid = np.zeros((b, g), bool)
        image_ids = np.zeros((b,), np.int64)
        orig_sizes = np.ones((b, 2), np.float32)
        image_valid = np.zeros((b,), bool)
        flip = np.zeros((b,), bool)
        m = self.mask_size
        gt_masks = np.zeros((b, g, m, m), np.uint8) if self.load_masks else None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="ld-decode")
        idxs = [int(idxs[r]) for r in self.rows if r < len(idxs)]
        loaded = list(self._pool.map(self._load, idxs))
        pages = []
        for slot, (idx, (page, target)) in enumerate(zip(idxs, loaded)):
            h, w = page.shape[:2]
            gt_boxes[slot], gt_labels[slot], gt_valid[slot] = prepare_targets(target, h, w, s, g)
            image_ids[slot] = int(np.asarray(target["image_id"]).ravel()[0])
            orig_sizes[slot] = (h, w)
            image_valid[slot] = True
            pages.append(page)
            if gt_masks is not None:
                gt_masks[slot] = rasterize_target_masks(target.get("segmentation", []), h, w,
                                                        m, g)
            if self.augment_hflip > 0:
                # the JAX loader's decision: hashed from (seed, epoch,
                # dataset index), whatever the worker or slot
                r = np.random.default_rng((self.seed, self._epoch, int(idx), 0xF11B)).random()
                if r < self.augment_hflip:
                    flip[slot] = True
                    v = gt_valid[slot]
                    x1 = gt_boxes[slot][v, 0].copy()
                    x2 = gt_boxes[slot][v, 2].copy()
                    gt_boxes[slot][v, 0] = s - x2
                    gt_boxes[slot][v, 2] = s - x1
                    if gt_masks is not None:
                        gt_masks[slot] = gt_masks[slot][:, :, ::-1]
        pin = self.device.type == "cuda"

        def host(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(a)
            return t.pin_memory() if pin else t

        same_shape = len({p.shape for p in pages}) == 1
        return _HostBatch(
            pages=pages, flip=flip, gt_boxes=host(gt_boxes), gt_labels=host(gt_labels),
            gt_valid=host(gt_valid), image_ids=image_ids, orig_sizes=orig_sizes,
            image_valid=image_valid,
            pixels=host(np.stack(pages)) if same_shape else None,
            gt_masks=None if gt_masks is None else host(gt_masks),
        )

    def _to_device(self, hb: _HostBatch) -> DetectionBatch:
        """Upload a host batch and resize its pages on the device."""
        s, dev = self.image_size, self.device
        images = torch.zeros((len(self.rows), 3, s, s), device=dev)
        n = len(hb.pages)
        if hb.pixels is not None:
            x = hb.pixels.to(dev, non_blocking=True).permute(0, 3, 1, 2).float() / 255.0
            images[:n] = resize_bilinear(x, s, s)
        else:
            for i, page in enumerate(hb.pages):
                x = torch.from_numpy(page).to(dev).permute(2, 0, 1).float() / 255.0
                images[i] = resize_bilinear(x, s, s)
        if hb.flip.any():
            sel = torch.from_numpy(np.nonzero(hb.flip)[0]).to(dev)
            images[sel] = images[sel].flip(-1)
        return DetectionBatch(
            images=images,
            gt_boxes=hb.gt_boxes.to(dev, non_blocking=True),
            gt_labels=hb.gt_labels.to(dev, non_blocking=True),
            gt_valid=hb.gt_valid.to(dev, non_blocking=True),
            image_ids=hb.image_ids, orig_sizes=hb.orig_sizes, image_valid=hb.image_valid,
            gt_masks=None if hb.gt_masks is None else hb.gt_masks.to(dev, non_blocking=True),
        )

    def __iter__(self) -> Iterator[DetectionBatch]:
        """A producer thread decodes and pads host batches ahead (a bounded
        queue); this generator uploads each and yields it."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                group = []
                for idxs in self._batches_of_indices():
                    group.append(self._assemble(idxs))
                    if len(group) == self.stack_batches:
                        if not put(group):
                            return
                        group = []
                for hb in group:  # an epoch's remainder: plain batches
                    if not put([hb]):
                        return
            except Exception as e:  # surfaced to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                batches = [self._to_device(hb) for hb in item]
                yield batches[0] if len(batches) == 1 else _stack(batches)
        finally:
            stop.set()
            t.join(timeout=60)
        self._epoch += 1
