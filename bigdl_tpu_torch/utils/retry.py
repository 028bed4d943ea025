"""Transient-fault retry (≙ ``bigdl_tpu/utils/retry.py``), cut to what
the port calls: bounded attempts, exponential backoff with full jitter,
retrying only errors that clear on their own, and the ``retry/*``
counters.

The delay before retry ``n`` is ``uniform(0, min(BASE * 2**(n-1),
MAX_DELAY))``.  Each retry increments ``retry/attempts`` (and
``retry/attempts.<name>``), each exhaustion ``retry/giveups``, on the
recorder that ``recorder_fn`` returns; without one the counters go
nowhere, as they do on the reference's default (disabled) process
recorder.  Every caller of the port (the registry's swap, the canary's
staging) uses the same budget, so it is a constant here.

The reference's wall-clock deadline, injectable classifier, RNG and
hooks come back when a port caller needs them.
"""
from __future__ import annotations

import errno
import random
import time
from typing import Callable, Optional

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
    :meth:`delay_for` before each retry.  A fatal error
    (``default_classify`` is False) raises at once, with no sleep and no
    counter.

    ``name``          labels the per-call counters
                      (``retry/attempts.<name>``)
    ``recorder_fn``   zero-arg recorder supplier; ``None`` (or a supplier
                      returning ``None``) drops the counters
    """

    MAX_ATTEMPTS = 3
    BASE = 0.01
    MAX_DELAY = 0.2

    def __init__(self, name: str = "",
                 recorder_fn: Optional[Callable] = None):
        self.name = name
        self._rec_fn = recorder_fn

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), drawn from the
        ``random`` module."""
        cap = min(self.BASE * (2 ** (max(attempt, 1) - 1)), self.MAX_DELAY)
        return random.uniform(0.0, cap)

    def run(self, fn: Callable, *args, **kwargs):
        """Call ``fn`` until it returns, a fatal error raises, or the
        attempts are exhausted (the last error re-raises after a
        ``retry/giveups`` count)."""
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:      # noqa: BLE001 — classified below
                attempt += 1
                if not default_classify(e):
                    raise               # fatal: no sleep, no counter
                if attempt >= self.MAX_ATTEMPTS:
                    self._count("retry/giveups")
                    raise
                delay = self.delay_for(attempt)
                self._count("retry/attempts")
                time.sleep(delay)

    def _count(self, counter: str):
        try:
            rec = self._rec_fn() if self._rec_fn is not None else None
            if rec is None:
                return
            rec.inc(counter)
            if self.name:
                rec.inc(f"{counter}.{self.name}")
        except Exception:
            pass                # telemetry must never change the retry


__all__ = ["RetryPolicy", "TRANSIENT_ERRNOS", "default_classify"]
