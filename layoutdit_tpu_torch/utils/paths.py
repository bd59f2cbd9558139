"""Storage paths, local or remote (port of ``layoutdit_tpu/utils/paths.py``,
with the opener the JAX package takes from fsspec).

A path with a ``scheme://`` prefix (``gs://``, ``memory://``, ...) is a
remote path: it goes through fsspec, imported at its first use, with one
filesystem object per thread (fsspec's instances are not meant to be
shared between threads, and the asynchronous checkpoint writer runs on
its own). Any other path is local and goes through builtin ``open`` and
``os``, so local paths need no fsspec (the machine with the card has
none).

  * ``join_path(root, *parts)``: ``/``-joined for a URL root,
    ``os.path.join`` otherwise;
  * ``open_path(path, mode)``: a file object; a write mode makes the
    parent directory first, as fsspec's ``auto_mkdir`` does (a local
    path may be a ``pathlib.Path``);
  * ``read_bytearray(path)``: the whole file in one writable buffer;
  * ``fs_for(path)``: listing, making directories, renaming, deleting.
"""

from __future__ import annotations

import os
import posixpath
import re
import threading

_URL_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")
_tls = threading.local()


def is_url(path: str | os.PathLike) -> bool:
    return _URL_RE.match(os.fspath(path)) is not None


def join_path(root: str, *parts: str) -> str:
    if is_url(root):
        segs = [root.rstrip("/")] + [p.strip("/") for p in parts]
        return "/".join(segs)
    return os.path.join(root, *parts)


def _parent(path: str) -> str:
    return posixpath.dirname(path.rstrip("/")) if is_url(path) else os.path.dirname(path)


class LocalFS:
    """The local filesystem, through ``os``."""

    def listdir(self, path: str) -> list[str]:
        """Names under ``path``; FileNotFoundError when it is absent."""
        return os.listdir(path)

    def makedirs(self, path: str) -> None:
        if path:
            os.makedirs(path, exist_ok=True)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def remove(self, path: str) -> None:
        os.remove(path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)


class RemoteFS:
    """An fsspec filesystem behind the same methods, over full URLs."""

    def __init__(self, fs):
        self.fs = fs

    def listdir(self, path: str) -> list[str]:
        if not self.fs.isdir(path):
            raise FileNotFoundError(path)
        return [posixpath.basename(p.rstrip("/")) for p in self.fs.ls(path, detail=False)]

    def makedirs(self, path: str) -> None:
        self.fs.makedirs(path, exist_ok=True)

    def replace(self, src: str, dst: str) -> None:
        self.fs.mv(src, dst)

    def remove(self, path: str) -> None:
        self.fs.rm(path)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)


def _remote(path: str) -> RemoteFS:
    scheme = _URL_RE.match(path).group(1)
    cache = getattr(_tls, "filesystems", None)
    if cache is None:
        cache = _tls.filesystems = {}
    if scheme not in cache:
        try:
            import fsspec
        except ImportError as exc:
            raise ImportError(
                f"{path}: a {scheme}:// path needs fsspec, which is not installed"
            ) from exc
        cache[scheme] = RemoteFS(fsspec.filesystem(scheme, skip_instance_cache=True))
    return cache[scheme]


_LOCAL = LocalFS()


def fs_for(path: str | os.PathLike) -> LocalFS | RemoteFS:
    """The filesystem that holds ``path`` (this thread's, for a URL)."""
    return _remote(path) if is_url(path) else _LOCAL


def open_path(path: str | os.PathLike, mode: str = "rb"):
    """``path`` opened in ``mode``; a write mode makes its parent first."""
    path = os.fspath(path)
    fs = fs_for(path)
    if any(c in mode for c in "wax"):
        fs.makedirs(_parent(path))
    if isinstance(fs, LocalFS):
        return open(path, mode)
    return fs.fs.open(path, mode)


def read_bytearray(path: str | os.PathLike) -> bytearray:
    """The whole file at ``path`` in one writable buffer (numpy and torch
    views of it are writable, and nothing is copied twice)."""
    with open_path(path, "rb") as f:
        size = f.seek(0, os.SEEK_END)
        f.seek(0)
        buf = bytearray(size)
        view, done = memoryview(buf), 0
        while done < size:
            n = f.readinto(view[done:])
            if not n:
                raise OSError(f"{path}: file ended after {done} of {size} bytes")
            done += n
    return buf
