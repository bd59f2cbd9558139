"""ctypes bindings for the native JPEG page loader (``loader.cc``; port of
``layoutdit_tpu/native/__init__.py``'s loader half).

  * ``decode_resize_batch(jpegs, size)``: the JAX loader's entry, the same
    bits: decode, bilinear resize to ``size`` x ``size`` and /255 on host
    threads -> float32 [N, 3, S, S] and (h, w) [N, 2];
  * ``jpeg_dims(jpeg)``: the page's (h, w) from its header alone;
  * ``decode_batch(jpegs, dims)``: decode only, into uint8 [H, W, 3]
    arrays the caller sizes from ``jpeg_dims``; the serving engine
    uploads these and resizes on the device.

A page that does not decode gets (h, w) = (0, 0), and in
``decode_resize_batch`` a zero image, as in the JAX loader.

The source is compiled with g++ (``-pthread``) on first use into
``build/native/`` at the repository root, under a file name keyed on a
hash of the source, the headers, the flags and the host, as
``native/cocojson.py`` builds the COCO parser; nothing is built at
import. It includes the libjpeg API headers of ``native/libjpeg/`` (ABI
62) and links the system's libjpeg (``-ljpeg``) or, where the linker
finds none (a machine without libjpeg's development files), the libjpeg
that the Pillow wheel bundles, by its path. ``available()`` is False
when neither builds; callers then decode with PIL and say so.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)

SRC = Path(__file__).resolve().parent / "loader.cc"
HEADERS = Path(__file__).resolve().parent / "libjpeg"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# -march=native as the JAX loader builds it: the same instructions (FMA
# contraction included) give decode_resize_batch the JAX loader's bits
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", f"-I{HEADERS}")
LIBS = ("-pthread",)

_lib = None
_build_failed = False
_lock = threading.Lock()

_BUFS = ctypes.POINTER(ctypes.c_char_p)
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_LONGS = ctypes.POINTER(ctypes.c_long)
_INTS = ctypes.POINTER(ctypes.c_int)
_FLOATS = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the built loader lives: keyed on the source, the flags and
    the host (``-march=native`` and the host's libjpeg make a library that
    another machine sharing the directory may not load or run)."""
    h = hashlib.sha256(SRC.read_bytes())
    for header in sorted(HEADERS.glob("*.h")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    return BUILD_DIR / f"loader-{h.hexdigest()[:16]}.so"


def bundled_libjpeg() -> Path | None:
    """The libjpeg (ABI 62) that the Pillow wheel bundles, found by path
    without importing PIL; None without one."""
    try:
        spec = importlib.util.find_spec("PIL")
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.origin:
        return None
    site = Path(spec.origin).parent.parent
    found = sorted(site.glob("pillow.libs/libjpeg*.so.62*")) + sorted(
        site.glob("PIL/.libs/libjpeg*.so.62*"))
    return found[0] if found else None


def _link_choices() -> list[tuple[str, ...]]:
    """libjpeg link arguments to try in order: the system's, then Pillow's
    bundled copy (by path, found again at run time through the rpath)."""
    choices = [("-ljpeg",)]
    bundled = bundled_libjpeg()
    if bundled is not None:
        choices.append((str(bundled), f"-Wl,-rpath,{bundled.parent}"))
    return choices


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    for link in _link_choices():
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), *link, *LIBS],
                           check=True, capture_output=True, text=True, timeout=120)
            os.replace(tmp, out)
            if link[0] != "-ljpeg":
                logger.info("native loader linked against %s", link[0])
            return True
        except subprocess.CalledProcessError as e:
            errors.append(f"{' '.join(link)}: {e.stderr[-1000:]}")
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{' '.join(link)}: {e}")
    logger.warning("native loader build failed:\n%s", "\n".join(errors))
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
            logger.warning("native loader load failed: %s", e)
            _build_failed = True
            return None
        lib.ld_decode_resize_batch.restype = ctypes.c_int
        lib.ld_decode_resize_batch.argtypes = [_BUFS, _LONGS, ctypes.c_int, ctypes.c_int,
                                               _FLOATS, _FLOATS, ctypes.c_int]
        lib.ld_jpeg_dims.restype = ctypes.c_int
        lib.ld_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_long, _INTS, _INTS]
        lib.ld_decode_batch.restype = ctypes.c_int
        lib.ld_decode_batch.argtypes = [_BUFS, _LONGS, ctypes.c_int, _PTRS, _LONGS, _INTS,
                                        ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native loader can be used (built on the first call)."""
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable (g++ or libjpeg missing)")
    return lib


def _buffers(jpegs: list[bytes]):
    n = len(jpegs)
    return (ctypes.c_char_p * n)(*jpegs), (ctypes.c_long * n)(*[len(b) for b in jpegs])


def decode_resize_batch(
    jpegs: list[bytes], out_size: int, n_threads: int = 4
) -> tuple[np.ndarray, np.ndarray, int]:
    """-> (images [N, 3, S, S] float32 in [0, 1], orig [N, 2] (h, w)
    float32, failures); a failed page is zero with orig (0, 0)."""
    lib = _lib_or_raise()
    n = len(jpegs)
    images = np.zeros((n, 3, out_size, out_size), np.float32)
    orig = np.ones((n, 2), np.float32)
    ptrs, lens = _buffers(jpegs)
    failures = lib.ld_decode_resize_batch(
        ptrs, lens, n, out_size, images.ctypes.data_as(_FLOATS), orig.ctypes.data_as(_FLOATS),
        n_threads,
    )
    return images, orig, failures


def jpeg_dims(jpeg: bytes) -> tuple[int, int] | None:
    """(h, w) from the JPEG's header, or None when it is not a readable
    JPEG header."""
    lib = _lib_or_raise()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.ld_jpeg_dims(jpeg, len(jpeg), ctypes.byref(h), ctypes.byref(w)):
        return None
    return h.value, w.value


def decode_batch(
    jpegs: list[bytes], dims: list[tuple[int, int]], n_threads: int = 4
) -> list[np.ndarray | None]:
    """Decode each JPEG into a uint8 [h, w, 3] array of its ``dims``
    (from ``jpeg_dims``); None for a page that fails to decode or is not
    of its ``dims``."""
    lib = _lib_or_raise()
    n = len(jpegs)
    outs = [np.empty((max(h, 0), max(w, 0), 3), np.uint8) for h, w in dims]
    out_ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    caps = (ctypes.c_long * n)(*[o.nbytes for o in outs])
    hw = np.zeros((n, 2), np.int32)
    ptrs, lens = _buffers(jpegs)
    lib.ld_decode_batch(ptrs, lens, n, out_ptrs, caps, hw.ctypes.data_as(_INTS), n_threads)
    decode_batch.pages += n
    return [o if tuple(got) == tuple(want) and got[0] > 0 else None
            for o, got, want in zip(outs, hw.tolist(), dims)]


decode_batch.pages = 0  # pages given to the decode-only entry
