"""ctypes bindings for the native COCO annotations parser
(``coco_parse.cc``, a copy of the JAX package's; port of
``layoutdit_tpu/native/cocojson.py``).

A GB-scale annotations JSON parses at memchr speed into packed numpy
arrays, skipping segmentation polygons, which detection never reads.
The parser is strict: it rejects anything unusual and the caller falls
back to ``json.loads``.

The source is compiled with g++ on first use into ``build/native/`` at
the repository root, under a file name keyed on a hash of the source
and the flags (as ``ops/_build.py`` builds the kernels); nothing is
built beside the source and nothing at import. ``available()`` is False
when g++ fails or ``LAYOUTDIT_NO_NATIVE_COCO=1`` opts out.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)

SRC = Path(__file__).resolve().parent / "coco_parse.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_build_failed = False
_lock = threading.Lock()

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I8 = ctypes.POINTER(ctypes.c_int8)
_F64 = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the built parser lives: keyed on the source and the flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"coco_parse-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native COCO parser build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning("native COCO parser load failed: %s", e)
            _build_failed = True
            return None
        lib.ld_coco_parse.restype = ctypes.c_void_p
        lib.ld_coco_parse.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.ld_coco_free.argtypes = [ctypes.c_void_p]
        lib.ld_coco_free.restype = None
        for fn in ("ld_coco_n_images", "ld_coco_n_anns",
                   "ld_coco_names_bytes", "ld_coco_categories_bytes"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.ld_coco_fill.restype = None
        lib.ld_coco_fill.argtypes = [
            ctypes.c_void_p, _I64, _I32, _I32, _I64, ctypes.c_char_p,
            _I64, _I64, _I32, _I8, _F64, _F64, ctypes.c_char_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native parser can be used (built on the first call).
    The opt-out is read first: it must also skip the build."""
    if os.getenv("LAYOUTDIT_NO_NATIVE_COCO") == "1":
        return False
    return _load() is not None


@dataclasses.dataclass
class CocoArrays:
    """Packed COCO index; ``file_names[i]`` belongs to ``img_id[i]``."""

    img_id: np.ndarray      # [N] int64
    img_w: np.ndarray       # [N] int32
    img_h: np.ndarray       # [N] int32
    file_names: list[str]   # [N]
    ann_id: np.ndarray      # [M] int64
    ann_img: np.ndarray     # [M] int64
    ann_cat: np.ndarray     # [M] int32
    ann_crowd: np.ndarray   # [M] int8
    ann_bbox: np.ndarray    # [M, 4] float64
    ann_area: np.ndarray    # [M] float64
    categories: list[dict]

    def to_coco_data(self) -> dict:
        """The ``coco_data`` dict of the fields the port reads (segmentation
        and unknown keys were skipped by the parse)."""
        images = [
            {"id": int(i), "width": int(w), "height": int(h), "file_name": f}
            for i, w, h, f in zip(self.img_id, self.img_w, self.img_h, self.file_names)
        ]
        annotations = [
            {"id": int(a), "image_id": int(im), "category_id": int(c),
             "bbox": [float(x) for x in bb], "area": float(ar), "iscrowd": int(cr)}
            for a, im, c, cr, bb, ar in zip(self.ann_id, self.ann_img, self.ann_cat,
                                            self.ann_crowd, self.ann_bbox, self.ann_area)
        ]
        return {"images": images, "annotations": annotations, "categories": self.categories}


def parse_coco_bytes(raw: bytes) -> CocoArrays | None:
    """Parse COCO annotation bytes natively; None tells the caller to fall
    back to ``json.loads``. ``raw`` must be a ``bytes`` object (CPython
    ends it with a NUL, which the C number scanner relies on)."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.ld_coco_parse(raw, len(raw))
    if not handle:
        return None
    try:
        n = lib.ld_coco_n_images(handle)
        m = lib.ld_coco_n_anns(handle)
        nb = lib.ld_coco_names_bytes(handle)
        cb = lib.ld_coco_categories_bytes(handle)
        img_id = np.empty(n, np.int64)
        img_w = np.empty(n, np.int32)
        img_h = np.empty(n, np.int32)
        name_off = np.empty(n + 1, np.int64)
        names = ctypes.create_string_buffer(max(1, nb))
        ann_id = np.empty(m, np.int64)
        ann_img = np.empty(m, np.int64)
        ann_cat = np.empty(m, np.int32)
        ann_crowd = np.empty(m, np.int8)
        ann_bbox = np.empty((m, 4), np.float64)
        ann_area = np.empty(m, np.float64)
        cats = ctypes.create_string_buffer(max(1, cb))
        lib.ld_coco_fill(
            handle,
            img_id.ctypes.data_as(_I64), img_w.ctypes.data_as(_I32), img_h.ctypes.data_as(_I32),
            name_off.ctypes.data_as(_I64), names,
            ann_id.ctypes.data_as(_I64), ann_img.ctypes.data_as(_I64),
            ann_cat.ctypes.data_as(_I32), ann_crowd.ctypes.data_as(_I8),
            ann_bbox.ctypes.data_as(_F64), ann_area.ctypes.data_as(_F64), cats,
        )
    finally:
        lib.ld_coco_free(handle)
    try:
        categories = json.loads(cats.raw[:cb].decode()) if cb else []
        blob = names.raw[:nb]
        file_names = [blob[name_off[i]:name_off[i + 1]].decode() for i in range(n)]
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None  # an unusual encoding: json.loads takes it
    if not isinstance(categories, list):
        return None
    return CocoArrays(
        img_id=img_id, img_w=img_w, img_h=img_h, file_names=file_names,
        ann_id=ann_id, ann_img=ann_img, ann_cat=ann_cat, ann_crowd=ann_crowd,
        ann_bbox=ann_bbox, ann_area=ann_area, categories=categories,
    )
