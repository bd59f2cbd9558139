"""The msgpack format that flax writes, in pure Python on ``struct``.

The JAX package saves checkpoints with ``flax.serialization.to_bytes``
(``layoutdit_tpu/train/checkpoint.py``): msgpack of the tree's state
dict, in which a list or tuple is a map keyed "0", "1", ... Its leaves
are msgpack extension types:

  * ext 1, an array: the payload is itself msgpack of ``(shape, dtype
    name, C-order bytes)``;
  * ext 3, a numpy scalar: the same payload, unpacked to a scalar.
(flax's ext 2, a Python complex, is in no checkpoint and raises.)

An array of more than ``MAX_CHUNK_SIZE`` bytes is written as a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
of flat pieces, which ``loads`` puts back together.

``loads`` decodes the subset that flax writes (nil, bool, int, float,
str, bin, array, map and those ext types) into numpy arrays that are
views of the one buffer it is given, copying no leaf; a ``bfloat16``
array (optax's ``mu_dtype=bfloat16`` moments), which numpy cannot hold,
becomes a ``torch.bfloat16`` tensor through a ``uint16`` view. Hand it a
writable buffer (``utils/paths.read_bytearray``), so that the views are
writable too. ``dump_parts`` writes the same bytes as msgpack-python's
packer with flax's settings, as a list of pieces in which every array's
data is a view (a file gets them one by one: no second copy of a
checkpoint in memory). Neither needs msgpack or flax.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ----------------------------------------------------------------- decode


class _Reader:
    def __init__(self, view: memoryview):
        self.view = view
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.view):
            raise ValueError("msgpack: data ends inside an object")
        self.pos = start + n
        return self.view[start:start + n]

    def _unpack(self, fmt: str):
        start = self.pos
        self._take(struct.calcsize(fmt))
        return struct.unpack_from(fmt, self.view, start)[0]

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        data = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is not one flax writes")
        shape, name, raw = _Reader(data).read()
        arr = _array_from(raw, name.decode() if isinstance(name, bytes) else name, shape)
        return arr[()] if code == _EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        handler = _HANDLERS.get(b)
        if handler is None:
            raise ValueError(f"msgpack: type byte 0x{b:02x} is not one flax writes")
        return handler(self)


_HANDLERS = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r._take(r._unpack(">B")),
    0xC5: lambda r: r._take(r._unpack(">H")),
    0xC6: lambda r: r._take(r._unpack(">I")),
    0xC7: lambda r: r._ext(r._unpack(">B")),
    0xC8: lambda r: r._ext(r._unpack(">H")),
    0xC9: lambda r: r._ext(r._unpack(">I")),
    0xCA: lambda r: r._unpack(">f"),
    0xCB: lambda r: r._unpack(">d"),
    0xCC: lambda r: r._unpack(">B"),
    0xCD: lambda r: r._unpack(">H"),
    0xCE: lambda r: r._unpack(">I"),
    0xCF: lambda r: r._unpack(">Q"),
    0xD0: lambda r: r._unpack(">b"),
    0xD1: lambda r: r._unpack(">h"),
    0xD2: lambda r: r._unpack(">i"),
    0xD3: lambda r: r._unpack(">q"),
    0xD4: lambda r: r._ext(1),
    0xD5: lambda r: r._ext(2),
    0xD6: lambda r: r._ext(4),
    0xD7: lambda r: r._ext(8),
    0xD8: lambda r: r._ext(16),
    0xD9: lambda r: r._str(r._unpack(">B")),
    0xDA: lambda r: r._str(r._unpack(">H")),
    0xDB: lambda r: r._str(r._unpack(">I")),
    0xDC: lambda r: r._array(r._unpack(">H")),
    0xDD: lambda r: r._array(r._unpack(">I")),
    0xDE: lambda r: r._map(r._unpack(">H")),
    0xDF: lambda r: r._map(r._unpack(">I")),
}


def _array_from(raw: memoryview, name: str, shape: list):
    """A view of ``raw`` as an array of dtype ``name`` and ``shape``: numpy,
    or a ``torch.bfloat16`` tensor for ``bfloat16``."""
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _indexed(d: dict) -> list:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(d: dict):
    shape = tuple(_indexed(d["shape"]))
    chunks = _indexed(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def loads(data) -> object:
    """The tree that ``data`` (bytes-like, one msgpack object) encodes."""
    view = memoryview(data).cast("B")
    reader = _Reader(view)
    out = reader.read()
    if reader.pos != len(view):
        raise ValueError(f"msgpack: {len(view) - reader.pos} bytes after the object")
    return out


def lists_from_state_dict(tree):
    """Maps keyed exactly "0" .. "n-1" (flax's form of a list or tuple) back
    to lists, all the way down; arrays and other leaves pass through."""
    if isinstance(tree, dict):
        out = {k: lists_from_state_dict(v) for k, v in tree.items()}
        if out and list(out) == [str(i) for i in range(len(out))]:
            return list(out.values())
        return out
    return tree


# ----------------------------------------------------------------- encode


def state_dict(tree):
    """flax's ``to_state_dict`` of a tree of dicts, lists and tuples: every
    list or tuple becomes a map keyed "0", "1", ..."""
    if isinstance(tree, dict):
        return {k: state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    return tree


def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes((v,))
        for tag, fmt, bound in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < bound:
                return bytes((tag,)) + struct.pack(fmt, v)
    else:
        if v >= -32:
            return struct.pack(">b", v)
        for tag, fmt, bound in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -bound:
                return bytes((tag,)) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: int {v} does not fit in 64 bits")


def _header(n: int, fix: int | None, fix_max: int, sized: tuple) -> bytes:
    """The header of a str / bin / array / map of ``n`` bytes or items:
    the fix form when it fits, else the smallest sized one."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for tag, fmt in sized:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes((tag,)) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: {n} is too long")


def _str_header(n):
    return _header(n, 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))


def _bin_header(n):
    return _header(n, None, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))


def _array_header(n):
    return _header(n, 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))


def _map_header(n):
    return _header(n, 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes((fixed[n],))
    elif n < 1 << 8:
        head = bytes((0xC7,)) + struct.pack(">B", n)
    elif n < 1 << 16:
        head = bytes((0xC8,)) + struct.pack(">H", n)
    else:
        head = bytes((0xC9,)) + struct.pack(">I", n)
    return head + struct.pack(">b", code)


def _host_array(x) -> tuple[np.ndarray, str]:
    """(C-contiguous numpy array of the bits, dtype name) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        x = t.numpy()
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not supported")
    return arr, arr.dtype.name


def _array_ext(code: int, arr: np.ndarray, name: str, out: list) -> None:
    inner = [_array_header(3), _array_header(arr.ndim), *(_int(int(s)) for s in arr.shape)]
    enc = name.encode()
    inner += [_str_header(len(enc)), enc, _bin_header(arr.nbytes)]
    head = b"".join(inner)
    out.append(_ext_header(code, len(head) + arr.nbytes))
    out.append(head)
    if arr.nbytes:
        out.append(memoryview(arr.reshape(-1).view(np.uint8)))


def _chunked(arr: np.ndarray, name: str) -> dict | None:
    if arr.nbytes <= MAX_CHUNK_SIZE:
        return None
    per = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): (flat[j:j + per], name)
                       for i, j in enumerate(range(0, flat.size, per))}}


def _dump(x, out: list, in_map: bool) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        enc = x.encode("utf-8")
        out += [_str_header(len(enc)), enc]
    elif type(x) in (bytes, bytearray, memoryview):
        out += [_bin_header(len(x)), bytes(x)]
    elif type(x) is dict:
        out.append(_map_header(len(x)))
        for k, v in x.items():
            _dump(k, out, False)
            _dump(v, out, True)
    elif type(x) in (list, tuple):
        out.append(_array_header(len(x)))
        for v in x:
            _dump(v, out, False)
    elif isinstance(x, np.generic):
        arr, name = _host_array(np.asarray(x))
        _array_ext(_EXT_NPSCALAR, arr, name, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        arr, name = _host_array(x)
        # flax chunks an oversized array that is a map's value (or the root)
        chunks = _chunked(arr, name) if in_map else None
        if chunks is None:
            _array_ext(_EXT_NDARRAY, arr, name, out)
        else:
            out.append(_map_header(3))
            for key in (CHUNKED, "shape"):
                _dump(key, out, False)
                _dump(chunks[key], out, True)
            _dump("chunks", out, False)
            out.append(_map_header(len(chunks["chunks"])))
            for k, (piece, piece_name) in chunks["chunks"].items():
                _dump(k, out, False)
                _array_ext(_EXT_NDARRAY, piece, piece_name, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(x).__name__}")


def dump_parts(tree) -> list:
    """The msgpack encoding of ``tree`` (a state dict: maps, arrays as
    leaves) as a list of bytes-like pieces, the arrays' data as views."""
    out: list = []
    _dump(tree, out, True)
    return out
