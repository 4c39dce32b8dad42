"""Bounded retry with backoff for transient I/O (the port's copy of the JAX
package's ``resilience/retry.py``). Corruption errors are not transient
and are never retried: they are not OSErrors."""

from __future__ import annotations

import time
from typing import Callable

TRANSIENT_IO_ERRORS: tuple[type, ...] = (OSError,)  # incl. Timeout/Connection


def retry_io(fn: Callable, *, attempts: int = 3, base_delay_s: float = 0.01,
             sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` up to ``attempts`` times with exponential backoff
    (``base_delay_s * 2**i`` between tries) on a transient I/O error; the
    last failure propagates unchanged."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    for i in range(attempts):
        try:
            return fn()
        except TRANSIENT_IO_ERRORS:
            if i == attempts - 1:
                raise
            sleep(base_delay_s * (2 ** i))
