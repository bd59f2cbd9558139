"""Structured logging for layoutdit_tpu_torch.

Same surface as the JAX package's ``log.py``: ``get_logger`` returns a
per-module child of one configured root, with a ``LAYOUT_LOG_LEVEL``
environment override.
"""

from __future__ import annotations

import logging
import os

_ROOT_NAME = "layoutdit_tpu_torch"


def _configure_root() -> logging.Logger:
    root = logging.getLogger(_ROOT_NAME)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(name)s - %(levelname)s - %(message)s")
        )
        root.addHandler(handler)
        level_str = os.getenv("LAYOUT_LOG_LEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level_str, logging.INFO))
        root.propagate = False
    return root


def get_logger(name: str) -> logging.Logger:
    """Return a per-module logger under the layoutdit_tpu_torch root."""
    _configure_root()
    if name.startswith(_ROOT_NAME):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
