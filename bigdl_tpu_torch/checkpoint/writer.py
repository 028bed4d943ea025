"""Background checkpoint writer, the async half of the snapshot pipeline
(≙ ``bigdl_tpu/checkpoint/writer.py``).

The training loop's only blocking work is the device→host copy; the
serialize + CRC + write + commit runs here, on one daemon thread, in
submission order (commit order is training order, so the newest intact
manifest is the newest submitted state that finished).  ``max_pending``
bounds the host memory held in snapshots: a submit while that many are
queued or in flight blocks the caller, and the wait is booked as
``checkpoint.blocking`` span time.  The thread never sees a CUDA tensor:
everything it gets is host-owned before :meth:`submit`.

A failed write never kills training: the error is kept on
``last_error``, counted (``checkpoint/failed``) and printed;
:meth:`wait` returns whether everything flushed.

Tracing: a job carrying a ``trace_ctx`` attribute (a
:class:`~bigdl_tpu_torch.observability.context.TraceContext`, attached by
``CheckpointManager.save``) gets two spans on the writer thread —
``ckpt.queue`` (submit → dequeue) and ``ckpt.write`` — under the
submitter's trace id.
"""
from __future__ import annotations

import collections
import threading
import traceback
from typing import Callable, Optional

from ..observability import context as _trace_clock
from ..observability import tracing as trace_spine
from ..observability.recorder import Recorder


class AsyncCheckpointWriter:
    def __init__(self, max_pending: int = 2, recorder_fn=None,
                 name: str = "bigdl-ckpt-writer"):
        self._jobs = collections.deque()
        self._cv = threading.Condition()
        self._pending = 0           # queued + running
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._name = name
        self.max_pending = max(1, int(max_pending))
        self.last_error: Optional[BaseException] = None
        self._rec_fn = recorder_fn
        self._own_rec = None        # counters without a caller's recorder

    def _rec(self):
        rec = None if self._rec_fn is None else self._rec_fn()
        if rec is None:
            if self._own_rec is None:
                self._own_rec = Recorder()
            rec = self._own_rec
        return rec

    def submit(self, job: Callable[[], None]):
        """Enqueue one checkpoint job; blocks when ``max_pending``
        snapshots are already in flight (backpressure, not data loss)."""
        try:
            # stamp BEFORE the enqueue: the writer thread may pop the
            # job the instant it lands, and the cv handoff is the only
            # ordering between submitter and writer
            job._trace_t_submit = _trace_clock.trace_now()
        except AttributeError:
            pass                      # e.g. a bound method; no stamp
        waited = 0.0
        with self._cv:
            if self._closed:
                raise RuntimeError("checkpoint writer is closed")
            while self._pending >= self.max_pending:
                t0 = _trace_clock.trace_now()
                self._cv.wait()
                waited += _trace_clock.trace_now() - t0
            self._jobs.append(job)
            self._pending += 1
            self._rec().gauge("checkpoint/in_flight", self._pending)
            if self._thread is None:
                # daemon: a hung filesystem must not block process exit
                self._thread = threading.Thread(target=self._run,
                                                name=self._name, daemon=True)
                self._thread.start()
            self._cv.notify_all()
        if waited > 0.0:
            # backpressure stalled the TRAINING thread: surface it as
            # checkpoint.blocking span time so the goodput ledger books
            # it as checkpoint_blocking, not silent goodput (outside
            # the cv — recorder locking must not nest under it)
            self._rec().add_span("checkpoint.blocking", waited)

    def _run(self):
        while True:
            with self._cv:
                while not self._jobs and not self._closed:
                    self._cv.wait()
                if not self._jobs:
                    return          # closed and drained
                job = self._jobs.popleft()
            ctx = getattr(job, "trace_ctx", None)
            t_start = _trace_clock.trace_now()
            if ctx is not None:
                t_sub = getattr(job, "_trace_t_submit", t_start)
                trace_spine.get_tracer().record(trace_spine.Span(
                    "ckpt.queue", ctx.child(), t_sub, t_start,
                    subsystem="checkpoint"))
            try:
                job()
                if ctx is not None:
                    trace_spine.get_tracer().record(trace_spine.Span(
                        "ckpt.write", ctx.child(), t_start,
                        _trace_clock.trace_now(),
                        subsystem="checkpoint"))
            except BaseException as e:       # noqa: BLE001 — must survive
                self.last_error = e
                self._rec().inc("checkpoint/failed")
                if ctx is not None:
                    trace_spine.get_tracer().record(trace_spine.Span(
                        "ckpt.write", ctx.child(), t_start,
                        _trace_clock.trace_now(),
                        subsystem="checkpoint",
                        args={"error": repr(e)}))
                print(f"[checkpoint] async write failed: {e!r}")
                traceback.print_exc()
            finally:
                with self._cv:
                    self._pending -= 1
                    self._rec().gauge("checkpoint/in_flight", self._pending)
                    self._cv.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job finished; True when drained."""
        with self._cv:
            self._cv.wait_for(lambda: self._pending == 0, timeout)
            return self._pending == 0

    def close(self, timeout: Optional[float] = None):
        """Drain in-flight writes, then stop the thread (preemption path:
        finish the write, never abandon it)."""
        self.wait(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
