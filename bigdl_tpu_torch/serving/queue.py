"""Bounded request queue with deadline-driven micro-batching.

One :class:`BatchingQueue` feeds one model's batcher thread.  The
contract is built around two SLO rules:

  * **Shed at the door, not at the tail.**  A full queue rejects the
    incoming request immediately (:class:`LoadShedError`) instead of
    letting every queued request's latency collapse together — explicit
    backpressure the client can retry against, the reject-over-collapse
    policy of every production serving stack.
  * **A batch waits at most ``max_delay`` for company.**  The batcher
    flushes when it has ``max_rows`` rows *or* when the oldest queued
    request has waited ``max_delay`` seconds, whichever comes first, so
    a lone request's latency is bounded by ``max_delay`` + one model
    execution rather than "until the queue happens to fill".

Per-request deadlines ride on the :class:`Request` and are enforced by
the engine when the batch is popped (a request that is already dead is
completed exceptionally without wasting device time on it).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional


class LoadShedError(RuntimeError):
    """Request rejected for SLO protection.  ``reason`` is
    ``"queue_full"`` (shed at admission) or ``"deadline"`` (expired
    before execution)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"request shed ({reason}){': ' if detail else ''}"
                         f"{detail}")
        self.reason = reason


class EngineClosedError(RuntimeError):
    """Submit after shutdown began."""


class Request:
    """One in-flight prediction: ``x`` is ``(n, *feature_shape)``.

    ``trace`` optionally carries a
    :class:`~bigdl_tpu_torch.observability.profile.RequestTrace` — the
    per-request span timeline (admit → queue → batch_gather → compute →
    reply) the engine exports as Chrome-trace JSON via ``/trace``."""

    __slots__ = ("x", "n", "future", "arrival", "deadline", "trace")

    def __init__(self, x, n: int, deadline: Optional[float] = None,
                 trace=None):
        self.x = x
        self.n = int(n)
        self.future: Future = Future()
        self.arrival = time.monotonic()
        self.deadline = deadline        # absolute monotonic seconds, or None
        self.trace = trace

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)


class BatchingQueue:
    """Thread-safe bounded FIFO of :class:`Request` with batch gather.

    ``max_pending_rows`` bounds the queue in *rows* (single-sample
    requests and size-17 requests cost what they cost), the unit the
    SLO math actually works in.
    """

    def __init__(self, max_pending_rows: int = 256,
                 max_delay: float = 0.005):
        if max_pending_rows < 1:
            raise ValueError("max_pending_rows must be >= 1")
        self.max_pending_rows = int(max_pending_rows)
        self.max_delay = float(max_delay)
        self._items: deque = deque()
        self._rows = 0
        self._cond = threading.Condition()
        self._closed = False

    # -- producer side --------------------------------------------------- #
    def put(self, req: Request):
        """Admit ``req`` or shed it.  Raises :class:`LoadShedError` when
        the queue is at capacity and :class:`EngineClosedError` after
        :meth:`close`."""
        with self._cond:
            if self._closed:
                raise EngineClosedError("serving queue is closed")
            if self._rows + req.n > self.max_pending_rows:
                raise LoadShedError(
                    "queue_full",
                    f"{self._rows} rows pending, cap "
                    f"{self.max_pending_rows}")
            self._items.append(req)
            self._rows += req.n
            self._cond.notify()

    def depth(self) -> int:
        """Pending rows (the queue-depth gauge)."""
        with self._cond:
            return self._rows

    def close(self):
        """Stop admissions; queued requests still drain via
        :meth:`get_batch` until it returns ``None``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def dump(self) -> List[Request]:
        """Remove and return everything still queued (fast-shutdown
        path: the caller fails the dumped requests explicitly)."""
        with self._cond:
            items = list(self._items)
            self._items.clear()
            self._rows = 0
            self._cond.notify_all()
            return items

    # -- consumer side ---------------------------------------------------- #
    def get_batch(self, max_rows: int) -> Optional[List[Request]]:
        """Block for the next micro-batch.

        Returns up to ``max_rows`` rows of FIFO-ordered requests, never
        splitting a request.  Flushes when full, when the oldest request
        has waited ``max_delay``, or immediately on :meth:`close`.
        Returns ``None`` once closed *and* empty (drain complete).
        """
        with self._cond:
            while not self._items:
                if self._closed:
                    return None
                self._cond.wait()
            flush_at = self._items[0].arrival + self.max_delay
            batch: List[Request] = []
            rows = 0
            while True:
                head_blocked = False
                while self._items:
                    nxt = self._items[0]
                    if batch and rows + nxt.n > max_rows:
                        # head doesn't fit: nothing behind it may jump
                        # the FIFO, so this batch is as full as it gets
                        head_blocked = True
                        break
                    self._items.popleft()
                    self._rows -= nxt.n
                    rows += nxt.n
                    batch.append(nxt)
                if rows >= max_rows or head_blocked or self._closed:
                    break
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            if self._items:
                self._cond.notify()   # more work for the next get_batch
            return batch
