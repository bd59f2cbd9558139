"""Per-process caches of device tensors that a traced program must not
fill."""

from __future__ import annotations

import functools

import torch


def cached_unless_traced(maxsize: int = 16):
    """``functools.lru_cache`` for functions that build a device tensor
    once (anchors, index tables, masks), bypassed while ``torch.export``
    or ``torch.compile`` traces: a traced call builds its tensor anew, so
    the program holds it as a constant and no fake tensor is left in the
    cache for a later eager call."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            return cached(*args)

        return call

    return wrap
