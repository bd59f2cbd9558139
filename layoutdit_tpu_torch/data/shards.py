"""Tar-sharded page storage (port of ``layoutdit_tpu/data/shards.py``).

Reading each page as its own object costs one lookup and one request a
page: at PubLayNet's 335k training pages that is 335k requests an epoch.
Packing the pages into large uncompressed tar shards with a byte-offset
index makes a page read one ranged read into a sequential object, while
the dataset's API stays the same (``make_sharded_dataset`` gives a
``PubLayNetDataset`` whose pages come from the shards).

The layout and the bytes are the JAX package's, so each package reads
the other's shards:
  {out_dir}/shard-00000.tar, shard-00001.tar, ...
  {out_dir}/index.json   {"shards": [...], "entries":
                          {file_name: [shard_idx, offset, size]}}
Paths may be local or ``scheme://`` URLs (``utils/paths.py``).
"""

from __future__ import annotations

import io
import json
import tarfile
import threading

from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.utils.paths import join_path, open_path
from layoutdit_tpu_torch.utils.retry import retry_io

logger = get_logger(__name__)

INDEX_NAME = "index.json"


def build_shards(file_names: list[str], read_bytes, out_dir: str,
                 shard_size_bytes: int = 256 * 1024 * 1024) -> dict:
    """Pack ``file_names`` (in order) into tar shards under ``out_dir``; a
    shard closes once it holds ``shard_size_bytes``. ``read_bytes``:
    file name -> its bytes. Returns the index (also written to
    ``{out_dir}/index.json``)."""
    shards: list[str] = []
    entries: dict[str, list] = {}
    tar = buf = None

    def flush():
        nonlocal tar, buf
        if tar is None:
            return
        tar.close()
        name = f"shard-{len(shards):05d}.tar"
        with open_path(join_path(out_dir, name), "wb") as f:
            f.write(buf.getvalue())
        shards.append(name)
        tar = buf = None

    for name in file_names:
        data = read_bytes(name)
        if tar is None:
            buf = io.BytesIO()
            tar = tarfile.open(fileobj=buf, mode="w")
        info = tarfile.TarInfo(name=name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
        # tarfile records no offset on write: the payload starts where the
        # stream now ends, less the payload and its padding to 512 bytes
        # (right even after extra pax or long-name header blocks)
        offset = buf.tell() - (len(data) + (-len(data)) % 512)
        entries[name] = [len(shards), offset, len(data)]
        if buf.tell() >= shard_size_bytes:
            flush()
    flush()

    index = {"shards": shards, "entries": entries}
    with open_path(join_path(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    logger.info("Wrote %d images into %d shard(s) under %s", len(entries), len(shards), out_dir)
    return index


class ShardIndex:
    """Ranged reads out of a shard set: one open handle per shard, behind
    a lock (the loader's decode threads read concurrently)."""

    def __init__(self, shard_dir: str):
        self.shard_dir = shard_dir
        with open_path(join_path(shard_dir, INDEX_NAME), "r") as f:
            index = json.load(f)
        self.shards: list[str] = index["shards"]
        self.entries: dict[str, list] = index["entries"]
        self._handles: dict[int, object] = {}
        self._lock = threading.Lock()

    def __contains__(self, file_name: str) -> bool:
        return file_name in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def _handle(self, shard_idx: int):
        h = self._handles.get(shard_idx)
        if h is None:
            h = open_path(join_path(self.shard_dir, self.shards[shard_idx]), "rb")
            self._handles[shard_idx] = h
        return h

    @retry_io
    def read(self, file_name: str) -> bytes:
        """A member's bytes."""
        shard_idx, offset, size = self.entries[file_name]
        with self._lock:
            h = self._handle(shard_idx)
            h.seek(offset)
            return h.read(size)

    def close(self) -> None:
        with self._lock:
            handles, self._handles = list(self._handles.values()), {}
        for h in handles:
            h.close()


class ShardedPubLayNetDataset(PubLayNetDataset):
    """``PubLayNetDataset`` whose pages are read out of tar shards; the
    annotations (native parser included) are read as before."""

    def __init__(self, shard_dir: str, annotations_json_path: str):
        super().__init__(shard_dir, annotations_json_path)
        self.shard_index = ShardIndex(shard_dir)

    def load_image_bytes(self, img_id) -> bytes:
        return self.shard_index.read(self.image_info[img_id]["file_name"])


def make_sharded_dataset(shard_dir: str, annotations_json_path: str) -> ShardedPubLayNetDataset:
    """The dataset of ``annotations_json_path`` over the shards in ``shard_dir``."""
    return ShardedPubLayNetDataset(shard_dir, annotations_json_path)
