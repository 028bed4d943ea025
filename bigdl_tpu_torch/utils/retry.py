"""Transient-fault retry (≙ ``bigdl_tpu/utils/retry.py``), cut to what
the port calls: bounded attempts with deterministic exponential backoff,
retrying only errors that clear on their own.

The reference's jitter, wall-clock deadline, injectable classifier, hooks
and retry counters come back when a port caller that does I/O needs them.
"""
from __future__ import annotations

import errno
import time
from typing import Callable

#: errnos worth retrying: the storage/net blips that clear on their own.
#: EROFS/EACCES/EPERM/ENOENT are deliberately absent — a read-only or
#: missing filesystem does not heal within a retry budget.
TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name) for name in
    ("EIO", "ENOSPC", "EAGAIN", "EINTR", "ETIMEDOUT", "EBUSY", "ESTALE",
     "ECONNRESET", "ECONNABORTED", "ECONNREFUSED", "EPIPE")
    if hasattr(errno, name))


def default_classify(exc: BaseException) -> bool:
    """True when ``exc`` is worth retrying."""
    if isinstance(exc, (TimeoutError, InterruptedError, ConnectionError)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return False


class RetryPolicy:
    """Call ``fn`` up to ``MAX_ATTEMPTS`` times, sleeping
    ``min(BASE * 2**(n-1), MAX_DELAY)`` before retry ``n``.  A fatal
    error (``default_classify`` is False) raises at once."""

    MAX_ATTEMPTS = 3
    BASE = 0.01
    MAX_DELAY = 0.2

    def run(self, fn: Callable, *args, **kwargs):
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:      # noqa: BLE001 — classified below
                attempt += 1
                if not default_classify(e) or attempt >= self.MAX_ATTEMPTS:
                    raise
                time.sleep(min(self.BASE * 2 ** (attempt - 1),
                               self.MAX_DELAY))


__all__ = ["RetryPolicy", "TRANSIENT_ERRNOS", "default_classify"]
