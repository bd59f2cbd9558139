"""Reading the JAX package's sharded ``.orbax`` checkpoints without orbax,
tensorstore or JAX.

JAX's ``save_checkpoint_sharded`` (``layoutdit_tpu/train/checkpoint.py``)
writes ``{"params", "opt_state"}`` through orbax's
``StandardCheckpointer``: a directory holding

  * ``_METADATA``, JSON: every leaf's key path (``tree_metadata``, each
    key a dict key (type 2) or a sequence index (type 1)) and its value
    type (``jax.Array``, ``np.ndarray``, or ``None`` for optax's empty
    states);
  * an OCDBT key-value store (tensorstore's "Optionally-Cooperative
    Distributed B+Tree"): ``manifest.ocdbt`` at the root, B-tree nodes
    and values in content-addressed files under ``d/``, and, written by
    each process, ``ocdbt.process_<i>/`` with its own manifest and
    ``d/``. The root manifest's tree references the process
    directories' files, so it alone lists every key; without it the
    process stores are read one by one;
  * in that store, each leaf as a zarr v2 array under its dotted path
    (``params.backbone.vit...``): ``<path>/.zarray`` (JSON) and the
    chunks ``<path>/0.0`` ..., each a zstd frame;
  * beside the directory, ``<path>.meta.json``: ``epoch``, ``extra``,
    ``has_opt_state``.

The OCDBT format (tensorstore's "OCDBT on-disk format") as read here:
every file section starts with a 4-byte big-endian magic, a little-endian
uint64 length, a varint version (0) and a varint compression (0 none, 1
zstd: the rest but the 4-byte CRC-32C footer is one zstd frame). The
manifest holds the config (uuid, manifest kind, the inline-value and
node-size limits, the version tree's arity, the compression) and the
newest versions inline, each with its root node's location; older
versions live in version-tree nodes, which a read of the newest never
needs. A B-tree node holds its height, a table of data files (paths
prefix-compressed against the previous one, each split into a base path
and a relative one), and its entries in columns: keys prefix-compressed
against the previous key; a leaf's values inline or as (file, offset)
references, an interior node's children as (file, offset, length) and
the key prefix its subtree shares. Integers are LEB128 varints.

zstd: the system's ``libzstd.so.1``, bound with ``ctypes``
(``ZSTD_decompress``). A machine without it raises naming the library;
there is no second decoder.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import math
import os
import struct

import numpy as np
import torch

from layoutdit_tpu_torch.utils.paths import fs_for, open_path

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_COMPRESSIONS = (0, 1)  # none, zstd

# --------------------------------------------------------------- zstd

_ZSTD = None


def _zstd():
    """The system's zstd library (``libzstd.so.1``), loaded once."""
    global _ZSTD
    if _ZSTD is None:
        names = ["libzstd.so.1", ctypes.util.find_library("zstd")]
        errors = []
        for name in [n for n in names if n]:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(str(e))
        else:
            raise RuntimeError("reading an .orbax checkpoint needs the system's zstd library "
                               f"(libzstd.so.1), which did not load: {'; '.join(errors)}")
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        _ZSTD = lib
    return _ZSTD


# ZSTD_CONTENTSIZE_UNKNOWN / _ERROR
_UNKNOWN = (2 ** 64 - 1, 2 ** 64 - 2)


def zstd_decompress(frame: bytes, size: int | None = None) -> bytes:
    """One zstd frame decoded. ``size``: the decoded length when the
    caller knows it (a zarr chunk's); otherwise the frame's own content
    size, or a buffer that doubles until the frame fits."""
    lib = _zstd()
    src = ctypes.create_string_buffer(bytes(frame), len(frame))
    if size is None:
        n = lib.ZSTD_getFrameContentSize(src, len(frame))
        size = None if n in _UNKNOWN else int(n)
    cap = size if size is not None else max(1 << 16, 4 * len(frame))
    while True:
        dst = ctypes.create_string_buffer(max(cap, 1))
        got = lib.ZSTD_decompress(dst, cap, src, len(frame))
        if not lib.ZSTD_isError(got):
            if size is not None and got != size:
                raise ValueError(f"zstd: frame decoded to {got} bytes, expected {size}")
            return dst.raw[:got]
        err = lib.ZSTD_getErrorName(got).decode()
        if size is None and "too small" in err:
            cap *= 2
            continue
        raise ValueError(f"zstd: {err}")


# --------------------------------------------------------------- OCDBT


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def varint(self) -> int:
        out = shift = 0
        while True:
            c = self.buf[self.pos]
            self.pos += 1
            out |= (c & 0x7F) << shift
            if c < 0x80:
                return out
            shift += 7

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self.pos += 1
        return self.buf[self.pos - 1]

    def take(self, n: int) -> bytes:
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("OCDBT: a section ends early")
        return self.buf[self.pos - n:self.pos]

    def prefixed(self, n: int, suffix_lengths: list[int], prefix_lengths: list[int]
                 ) -> list[bytes]:
        """``n`` strings, each the previous one's first ``prefix_lengths``
        bytes and then its own suffix."""
        out, prev = [], b""
        for i in range(n):
            s = prev[:prefix_lengths[i]] + self.take(suffix_lengths[i])
            out.append(s)
            prev = s
        return out


def _unframe(buf: bytes, magic: int, what: str) -> _Reader:
    """A file section's body: header checked, zstd undone, footer dropped."""
    if len(buf) < 18 or struct.unpack(">I", buf[:4])[0] != magic:
        raise ValueError(f"OCDBT: {what} has not the magic {magic:#010x}")
    if struct.unpack("<Q", buf[4:12])[0] != len(buf):
        raise ValueError(f"OCDBT: {what}'s length field disagrees with its {len(buf)} bytes")
    head = _Reader(buf)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0 or compression not in _COMPRESSIONS:
        raise ValueError(f"OCDBT: {what} has version {version}, compression {compression}")
    body = buf[head.pos:-4]
    return _Reader(zstd_decompress(body) if compression == 1 else body)


def _data_files(r: _Reader) -> list[str]:
    """A data file table -> each file's path under the store's directory."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths = r.prefixed(n, suffix, prefix)
    for p, b in zip(paths, base):
        if b > len(p):
            raise ValueError("OCDBT: a data file's base path is longer than its path")
    return [p.decode() for p in paths]


class OcdbtStore:
    """The newest version of an OCDBT store at ``root`` (a directory, local
    or a ``scheme://`` URL): ``keys()`` sorted, ``read(key)`` its bytes.
    The whole B-tree is walked once; values are read on demand."""

    def __init__(self, root: str):
        self.root = os.fspath(root).rstrip("/")
        self._index: dict[bytes, object] = {}
        manifest = f"{self.root}/manifest.ocdbt"
        fs = fs_for(self.root)
        if fs.exists(manifest):
            self._load(self.root)
        else:  # no root manifest: each process's store in turn
            subs = sorted(n for n in fs.listdir(self.root) if n.startswith("ocdbt.process_"))
            if not subs:
                raise FileNotFoundError(f"{self.root}: no manifest.ocdbt and no "
                                        "ocdbt.process_<i>/ store")
            for sub in subs:
                self._load(f"{self.root}/{sub}")
        self._keys = sorted(self._index)

    def _read_file(self, path: str, offset: int = 0, length: int | None = None) -> bytes:
        with open_path(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"OCDBT: {path} ends before byte {offset + length}")
        return data

    def _load(self, store: str) -> None:
        r = _unframe(self._read_file(f"{store}/manifest.ocdbt"), MANIFEST_MAGIC,
                     f"{store}/manifest.ocdbt")
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"OCDBT: {store} has a numbered manifest (kind {kind}); only "
                             "the single-file manifest that orbax writes is read")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # zstd: its level
            r.take(4)
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            return  # an empty store
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self._node(store, files[file_id[newest]], offset[newest], length[newest],
                   height[newest], b"")

    def _node(self, store: str, file: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        where = f"{store}/{file}@{offset}"
        r = _unframe(self._read_file(f"{store}/{file}", offset, length), BTREE_MAGIC, where)
        if r.byte() != height:
            raise ValueError(f"OCDBT: node {where} is not at height {height}")
        files = _data_files(r)
        n = r.varint()
        key_prefix = [0] + r.varints(max(n - 1, 0))
        key_suffix = r.varints(n)
        if height == 0:
            keys = r.prefixed(n, key_suffix, key_prefix)
            sizes = r.varints(n)
            kinds = r.varints(n)
            out_of_line = [i for i in range(n) if kinds[i] == 1]
            ids, offsets = r.varints(len(out_of_line)), r.varints(len(out_of_line))
            for i, f, o in zip(out_of_line, ids, offsets):
                self._index[prefix + keys[i]] = (f"{store}/{files[f]}", o, sizes[i])
            for i in range(n):
                if kinds[i] == 0:
                    self._index[prefix + keys[i]] = r.take(sizes[i])
                elif kinds[i] != 1:
                    raise ValueError(f"OCDBT: node {where} has value kind {kinds[i]}")
            return
        common = r.varints(n)
        keys = r.prefixed(n, key_suffix, key_prefix)
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        for i in range(n):
            self._node(store, files[ids[i]], offsets[i], lengths[i], height - 1,
                       prefix + keys[i][:common[i]])

    def keys(self) -> list[bytes]:
        return list(self._keys)

    def read(self, key: bytes | str) -> bytes:
        key = key.encode() if isinstance(key, str) else key
        try:
            value = self._index[key]
        except KeyError:
            raise KeyError(f"OCDBT: {self.root} has no key {key!r}") from None
        if isinstance(value, bytes):
            return value
        return self._read_file(*value)

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._index


# ---------------------------------------------------------------- zarr

_DTYPES = {"<f4", "<f8", "<f2", "<i4", "<i8", "<i2", "|i1", "<u4", "<u8", "<u2", "|u1", "|b1"}


def read_zarr(store: OcdbtStore, path: str):
    """The zarr v2 array at ``path`` of ``store``: numpy, or a
    ``torch.bfloat16`` tensor for ``bfloat16`` (numpy has none), as the
    msgpack reader gives them. A missing chunk is ``fill_value`` (0 for
    null)."""
    meta = json.loads(store.read(f"{path}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"zarr {path}: only zarr v2, C order, no filters are read ({meta})")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr {path}: compressor {comp.get('id')!r} (zstd or none are read)")
    name = meta["dtype"]
    bf16 = name == "bfloat16"
    if not bf16 and name not in _DTYPES:
        raise ValueError(f"zarr {path}: dtype {name!r} is not read")
    dtype = np.dtype(np.uint16 if bf16 else name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None or bf16 else fill, dtype)
    grid = [math.ceil(s / c) if c else 1 for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{path}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = store.read(key)
        data = zstd_decompress(raw, chunk_bytes) if comp is not None else raw
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------- tree


def read_tree(path: str) -> dict:
    """The tree orbax saved at ``path``, in flax's state-dict form, as the
    msgpack reader gives it: dicts with string keys (a sequence's keyed
    "0", "1", ...), array leaves, ``{}`` for optax's empty states."""
    path = os.fspath(path).rstrip("/")
    with open_path(f"{path}/_METADATA", "rb") as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only orbax's OCDBT + zarr v2 layout is read (use_ocdbt "
                         f"{meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')})")
    store = OcdbtStore(path)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if value.get("skip_deserialize") or value.get("value_type") == "None":
            node[keys[-1]] = {}
        elif value.get("value_type") in ("jax.Array", "np.ndarray"):
            node[keys[-1]] = read_zarr(store, ".".join(keys))
        else:
            raise ValueError(f"{path}: leaf {'/'.join(keys)} has value type "
                             f"{value.get('value_type')!r}, which is not read")
    return tree


def read_meta(path: str) -> dict:
    """``<path>.meta.json`` (epoch, extra, has_opt_state), or JAX's default
    when it is missing."""
    try:
        with open_path(os.fspath(path).rstrip("/") + ".meta.json", "rb") as f:
            return json.load(f)
    except FileNotFoundError:
        return {"epoch": 0, "extra": {}}
