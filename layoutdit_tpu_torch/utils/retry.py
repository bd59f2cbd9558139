"""Retry with backoff for flaky storage I/O (port of
``layoutdit_tpu/utils/retry.py``): the same attempts and delays.

Streaming pages from object storage meets transient 5xx and connection
errors as a matter of course, so every storage read on the input path
goes through ``retry_io``: up to ``ATTEMPTS`` tries on an ``OSError``,
sleeping ``BASE_DELAY``, then twice that, and so on between them. Other
exceptions propagate at once.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, TypeVar

from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)

T = TypeVar("T")

ATTEMPTS = 4
BASE_DELAY = 0.5


def retry_io(f: Callable[..., T]) -> Callable[..., T]:
    """Decorator retrying ``OSError`` with exponential backoff."""

    @functools.wraps(f)
    def wrapped(*args, **kwargs) -> T:
        delay = BASE_DELAY
        for attempt in range(ATTEMPTS):
            try:
                return f(*args, **kwargs)
            except OSError as e:
                if attempt == ATTEMPTS - 1:
                    raise
                logger.warning("IO error in %s (attempt %d/%d): %s; retrying in %.1fs",
                               getattr(f, "__name__", "fn"), attempt + 1, ATTEMPTS, e, delay)
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")

    return wrapped
