"""Dynamic-batching inference engine (≙ ``bigdl_tpu/serving/engine.py``).

The serving pipeline, end to end::

    submit(name, x)                       client threads
       └─ BatchingQueue.put              admission control: full -> shed
            └─ batcher thread            one per model
                 gather <= max_batch rows, flush on deadline
                 drop requests whose SLO already expired
                 pad rows -> power-of-two bucket
                 run the model on the bucket (a shape warmup already ran)
                 one copy of the outputs to the host
                 scatter results back to per-request futures

Where the reference compiles one XLA executable per bucket, the port
runs each bucket once at :meth:`ServingEngine.warmup` (the first run of a
shape pays for cuBLAS heuristics and allocator growth).  The
``serving.recompiles`` counter keeps its meaning: a bucket first seen
after warmup, counted, never silent.  CUDA graphs per bucket are later
work (ROADMAP queue A).

Each batch runs under ``torch.inference_mode()`` with the entry's CUDA
device made current, entered by the thread that runs it: both are
thread-local, and the batcher is its own thread.  Work goes on that
thread's current stream, the device's default stream.

Telemetry goes through the port's
:class:`~bigdl_tpu_torch.observability.Recorder`:

  counters    ``serving.requests`` / ``serving.rows`` /
              ``serving.batches`` / ``serving.shed_queue_full`` /
              ``serving.shed_deadline`` / ``serving.recompiles`` /
              ``serving.warmup_compiles`` / ``serving.errors``
  gauges      ``serving.queue_depth.<model>``
  histograms  ``serving.latency_ms``, ``serving.batch_fill``

and every admitted request carries a trace (admit → queue →
batch_gather → compute → reply) collected in a bounded ring, exported by
:meth:`ServingEngine.dump_chrome_trace` as Chrome-trace/Perfetto JSON.

The engine owns a goodput ledger on its recorder (one device): warmup and
post-warmup runs of a bucket land in ``compile_warmup``, and each batch's
interval splits by fill (real rows are goodput, padding rows idle).  The
``serving.compute`` fault site fires once per batch, before the model
runs: ``err`` fails the batch (a ReplicaSet fails its requests over),
``delay`` wedges this batcher the way a stuck device call would.

The engine speaks the replica protocol (``submit`` / ``predict`` /
``warmup`` / ``shutdown`` / ``pending_rows`` / ``max_queue_fill`` /
``stats`` / ``registry`` / ``recorder``) that
:class:`~bigdl_tpu_torch.serving.ReplicaSet` calls.

``serve_metrics`` starts the live introspection server of the engine's
recorder (``/metrics``, ``/healthz``, ``/records``, and ``/trace`` from
its trace ring); ``shutdown`` stops it.  The reference's per-bucket XLA
cost capture has no counterpart.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import faults as faultplane
from ..observability import Recorder
from ..observability.goodput import GoodputLedger, ledger_phase
from ..observability.profile import TraceRing, dump_chrome_trace
from .buckets import BucketLadder
from .queue import (BatchingQueue, EngineClosedError, LoadShedError,
                    Request)
from .registry import ModelEntry, ModelRegistry


def _execute(model, snap, x: np.ndarray, device: torch.device):
    """Run ``model`` on the host batch ``x`` with ``snap``'s weights and
    bring the outputs back as numpy: the one host sync of a batch."""
    on_device = torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()
    with torch.inference_mode(), on_device:
        xt = torch.from_numpy(x).to(device)
        y, _ = model.run(snap.params, xt, state=snap.state, training=False)
        return y.cpu().numpy()


class ServingEngine:
    """Batches concurrent requests across a :class:`ModelRegistry`.

    ``max_batch``      largest bucket (rounded up to a power of two)
    ``max_delay_ms``   longest a request waits for batch company
    ``max_queue_rows`` admission cap per model, in rows; beyond it
                       requests shed with :class:`LoadShedError`
    ``recorder``       a Recorder; defaults to a fresh one
                       (metrics are part of the serving contract)

    Every request is traced into a ring of the last ``TRACE_CAPACITY``
    completed traces.
    """

    TRACE_CAPACITY = 512

    def __init__(self, registry: ModelRegistry, *, max_batch: int = 32,
                 max_delay_ms: float = 5.0, max_queue_rows: int = 256,
                 recorder: Optional[Recorder] = None):
        self.registry = registry
        self.ladder = BucketLadder(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_queue_rows = int(max_queue_rows)
        self.recorder = recorder if recorder is not None else Recorder()
        if self.recorder.get_ledger() is None:
            self.recorder.set_ledger(GoodputLedger(name="serving",
                                                   devices=1))
        self.trace_ring = TraceRing(self.TRACE_CAPACITY)
        self._queues: Dict[str, BatchingQueue] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._http_server = None
        # if the engine is dropped without shutdown(), closing its
        # queues unparks the (weakly-bound) worker threads so they exit
        self._finalizer = weakref.finalize(self, _close_queues,
                                           self._queues)

    # -- lifecycle -------------------------------------------------------- #
    def warmup(self, name: Optional[str] = None):
        """Run every bucket once for ``name`` (or all models).  Runs here
        are ``serving.warmup_compiles``; a bucket first run after this
        is a counted ``serving.recompiles``."""
        entries = [self.registry.get(name)] if name is not None \
            else self.registry.entries()
        for entry in entries:
            if entry.input_shape is None:
                raise ValueError(
                    f"warmup({entry.name!r}): register with input_shape= "
                    "so dummy batches can be built")
            with self.recorder.span("serving.warmup"), \
                    ledger_phase(self.recorder, "compile_warmup"):
                for bucket in self.ladder:
                    if bucket not in entry.compiled:
                        self._compile(entry, bucket, entry.input_shape,
                                      warm=True)
            entry.warmed = True
        return self

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop admissions, then either finish queued work (``drain=True``,
        graceful) or fail it fast with :class:`EngineClosedError`."""
        with self._lock:
            self._closed = True
            queues = dict(self._queues)
            threads = dict(self._threads)
            server, self._http_server = self._http_server, None
        if server is not None:
            server.stop()
        for q in queues.values():
            q.close()
        if not drain:
            for q in queues.values():
                _fail_batch(q.dump(),
                            EngineClosedError("engine shut down before "
                                              "this request ran"),
                            ring=self.trace_ring, span="closed")
        for t in threads.values():
            t.join(timeout)
        return self

    def telemetry_sources(self):
        """``[("serving", recorder)]``: the aggregator's attachment hook
        (``aggregator.add(engine, name=...)`` scrapes the ``serving.*``
        request, shed and latency families)."""
        return [("serving", self.recorder)]

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the live introspection server of this engine's recorder:
        ``/metrics`` (request, shed and recompile counters, per-model
        queue depths, latency and batch-fill summaries), ``/healthz``
        (with the shed rate), ``/records`` and ``/trace`` (Chrome-trace
        JSON of recent per-request timelines).  ``port=0`` binds an
        ephemeral port (the returned server's ``.port``); a second call
        replaces the server; ``shutdown()`` stops it."""
        from ..observability.http import IntrospectionServer
        return IntrospectionServer(
            self.recorder, port=port, host=host,
            trace_source=self.dump_chrome_trace).swap_into(
                self, self._lock, EngineClosedError(
                    "engine shut down while serve_metrics was binding"))

    # -- request path ----------------------------------------------------- #
    def submit(self, name: str, x, deadline_ms: Optional[float] = None,
               trace_ctx=None) -> Future:
        """Enqueue one request; returns its Future.

        ``x`` is one sample ``input_shape`` or a batch
        ``(n, *input_shape)`` with ``n <= max_batch``.  ``deadline_ms``
        propagates an SLO: requests still queued past it are shed
        instead of executed.  Raises :class:`LoadShedError` immediately
        when the queue is full.  ``trace_ctx`` (a
        :class:`~bigdl_tpu_torch.observability.TraceContext`) lets an
        upstream hop thread its trace id into this request's timeline.
        """
        t_admit = time.monotonic()
        entry = self.registry.get(name)
        x, n, single = self._normalize(entry, x)
        if n > self.ladder.max_batch:
            raise ValueError(
                f"submit: {n} rows > max_batch {self.ladder.max_batch}; "
                "use predict() which splits")
        deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1e3
        ring = self.trace_ring
        tr = ring.new_trace(entry.name, ctx=trace_ctx)
        req = Request(x, n, deadline=deadline, trace=tr)
        tr.meta["rows"] = n
        # the worker always completes req.future (batched); a single-
        # sample caller gets a view that strips the batch dim back off
        fut = _UnbatchingFuture(req.future) if single else req.future
        rec = self.recorder
        rec.inc("serving.requests")
        q = self._ensure_worker(entry)
        # every trace write BEFORE the put: the batcher may pop the
        # request the instant it lands
        now = time.monotonic()
        tr.add_span("admit", t_admit, now)
        tr.open("queue", now)   # closed by the batcher at pop
        try:
            q.put(req)
        except LoadShedError:
            rec.inc("serving.shed_queue_full")
            tr.discard("queue")   # never entered the queue
            tr.terminal("queue_full", time.monotonic())
            ring.finish(tr)
            raise
        except EngineClosedError:
            tr.discard("queue")
            tr.terminal("engine_closed", time.monotonic(), name="closed")
            ring.finish(tr)
            raise
        rec.gauge(f"serving.queue_depth.{entry.name}", q.depth())
        return fut

    def predict(self, name: str, x, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None):
        """Synchronous convenience: splits oversized inputs into
        ``max_batch`` chunks, submits them all (they batch and execute
        concurrently), and reassembles the outputs in order."""
        entry = self.registry.get(name)
        x, n, single = self._normalize(entry, x)
        if single:
            return self.submit(name, x[0], deadline_ms=deadline_ms) \
                       .result(timeout)
        futs = [self.submit(name, x[i:i + self.ladder.max_batch],
                            deadline_ms=deadline_ms)
                for i in range(0, n, self.ladder.max_batch)]
        parts = [f.result(timeout) for f in futs]
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts, axis=0)

    def pending_rows(self) -> int:
        """Rows queued across this engine's models: the queue-depth input
        to replica health scoring and saturation."""
        with self._lock:
            queues = list(self._queues.values())
        return sum(q.depth() for q in queues)

    def max_queue_fill(self) -> float:
        """Fill fraction of this engine's MOST saturated model queue, in
        [0, 1]: the admission-pressure signal of replica saturation."""
        with self._lock:
            queues = list(self._queues.values())
        if not queues:
            return 0.0
        return max(q.depth() for q in queues) / self.max_queue_rows

    def stats(self) -> Dict[str, Any]:
        """One flat dict of the serving counters plus latency
        percentiles and mean batch fill."""
        rec = self.recorder
        out = {k: rec.counter_value(f"serving.{k}")
               for k in ("requests", "rows", "batches", "shed_queue_full",
                         "shed_deadline", "recompiles", "warmup_compiles",
                         "errors")}
        lat = rec.hist_summary("serving.latency_ms")
        if lat:
            out.update({"p50_ms": lat.get("p50"), "p95_ms": lat.get("p95"),
                        "p99_ms": lat.get("p99"),
                        "mean_latency_ms": lat.get("mean")})
        fill = rec.hist_summary("serving.batch_fill")
        if fill:
            out["batch_fill"] = fill.get("mean")
        return out

    # -- internals -------------------------------------------------------- #
    def _normalize(self, entry: ModelEntry, x):
        """-> (batched ndarray, n_rows, was_single_sample)."""
        x = np.asarray(x, entry.dtype)
        if entry.input_shape is not None:
            if x.shape == tuple(entry.input_shape):
                return x[None], 1, True
            if x.shape[1:] != tuple(entry.input_shape):
                raise ValueError(
                    f"{entry.name}: expected {entry.input_shape} or "
                    f"(n, *{entry.input_shape}), got {x.shape}")
            return x, x.shape[0], False
        if x.ndim == 0:
            raise ValueError("scalar input needs input_shape= at register")
        return x, x.shape[0], False

    def _ensure_worker(self, entry: ModelEntry) -> BatchingQueue:
        with self._lock:
            if self._closed:
                raise EngineClosedError("engine is shut down")
            q = self._queues.get(entry.name)
            if q is None:
                q = BatchingQueue(max_pending_rows=self.max_queue_rows,
                                  max_delay=self.max_delay)
                # the thread holds the engine only weakly: a dropped,
                # never-shut-down engine must be collectable
                t = threading.Thread(
                    target=_worker_loop,
                    args=(weakref.ref(self), entry.name, q,
                          self.ladder.max_batch),
                    daemon=True, name=f"serving-{entry.name}")
                self._queues[entry.name] = q
                self._threads[entry.name] = t
                t.start()
            return q

    def _run_batch(self, entry: ModelEntry, q: BatchingQueue,
                   batch: List[Request]):
        rec = self.recorder
        ring = self.trace_ring
        now = time.monotonic()
        live = []
        for r in batch:
            tr = r.trace
            tr.close("queue", now)
            if r.expired(now):
                rec.inc("serving.shed_deadline")
                tr.terminal("deadline", now)
                ring.finish(tr)
                r.future.set_exception(LoadShedError(
                    "deadline", "expired before execution"))
            else:
                tr.open("batch_gather", now)
                live.append(r)
        if not live:
            return
        rows = sum(r.n for r in live)
        bucket = self.ladder.bucket_for(rows)
        x = np.concatenate([r.x for r in live], axis=0)
        if bucket > rows:
            x = np.concatenate(
                [x, np.zeros((bucket - rows,) + x.shape[1:], x.dtype)],
                axis=0)
        ex = entry.compiled.get(bucket)
        if ex is None:
            # a bucket first seen after warmup: counted, never silent
            rec.inc("serving.recompiles")
            with ledger_phase(rec, "compile_warmup"):
                ex = self._compile(entry, bucket, x.shape[1:])
        led = rec.get_ledger()
        if led is not None:
            # the inter-batch gap goes to the background phase, so that the
            # fold below attributes only this batch's interval
            led.note_step_begin()
        t_exec = time.monotonic()
        for r in live:
            tr = r.trace
            tr.meta.update(bucket=bucket, batch_rows=rows,
                           batch_requests=len(live))
            tr.close("batch_gather", t_exec)
            tr.open("compute", t_exec)
        faultplane.inject("serving.compute", rec)
        snap = entry.snapshot          # one atomic read per batch
        with rec.span("serving.execute"):
            y = ex(snap, x)
        done = time.monotonic()
        off = 0
        for r in live:
            tr = r.trace
            tr.close("compute", done)
            tr.open("reply", done)
            sl = y[off:off + r.n]
            off += r.n
            # finish the trace BEFORE completing the future: a client
            # unblocked by .result() must see its own request
            tr.close("reply", time.monotonic())
            ring.finish(tr)
            r.future.set_result(sl)
            rec.observe("serving.latency_ms", (done - r.arrival) * 1e3)
        rec.inc("serving.batches")
        rec.inc("serving.rows", rows)
        rec.observe("serving.batch_fill", rows / bucket)
        if led is not None:
            led.fold_split({"goodput": rows, "idle": bucket - rows})
        rec.gauge(f"serving.queue_depth.{entry.name}", q.depth())

    def _compile(self, entry: ModelEntry, bucket: int, feature_shape,
                 warm: bool = False):
        """Run ``entry``'s model once at ``(bucket, *feature_shape)`` and
        cache the bucket's runner."""
        model, device = entry.model, entry.device

        def runner(snap, x):
            return _execute(model, snap, x, device)

        dummy = np.zeros((bucket,) + tuple(feature_shape), entry.dtype)
        with self.recorder.span("serving.compile"):
            runner(entry.snapshot, dummy)
        entry.compiled[bucket] = runner
        if entry.input_shape is None:
            entry.input_shape = tuple(feature_shape)
        if warm:
            self.recorder.inc("serving.warmup_compiles")
        return runner

    # -- per-request trace export ------------------------------------------ #
    def dump_chrome_trace(self) -> str:
        """Chrome-trace/Perfetto JSON of the recent completed request
        traces (one track per request, B/E span pairs, trace IDs and
        batch/bucket attribution in args)."""
        meta = {"dropped_traces": self.trace_ring.dropped}
        return dump_chrome_trace(self.trace_ring.traces(), extra_meta=meta)


def _close_queues(queues: Dict[str, BatchingQueue]):
    for q in queues.values():
        q.close()


def _worker_loop(engine_ref, name: str, q: BatchingQueue, max_rows: int):
    """One model's batcher.  Holds the engine weakly (see
    ``_ensure_worker``) and re-resolves the registry entry per batch so
    an ``unregister`` + ``register`` under the same name serves the NEW
    model instead of a stale closure capture."""
    while True:
        batch = q.get_batch(max_rows)
        if batch is None:
            return
        if not batch:
            continue
        eng = engine_ref()
        if eng is None:
            q.close()
            _fail_batch(batch, EngineClosedError(
                "engine was garbage-collected before this request ran"))
            return
        try:
            try:
                entry = eng.registry.get(name)
            except KeyError as e:
                _fail_batch(batch, e, ring=eng.trace_ring)
                continue
            try:
                eng._run_batch(entry, q, batch)
            except Exception as e:   # the batcher thread must survive
                eng.recorder.inc("serving.errors")
                _fail_batch(batch, e, ring=eng.trace_ring)
        finally:
            del eng       # never hold the engine across a blocking wait


def _fail_batch(batch: List[Request], exc: BaseException, ring=None,
                span: str = "error"):
    """Complete every still-pending request exceptionally AND finish its
    trace with a terminal cause span.  Requests already completed are
    skipped via future.done()."""
    for r in batch:
        if r.future.done():
            continue
        tr = r.trace
        if ring is not None and tr is not None:
            tr.terminal(type(exc).__name__, time.monotonic(), name=span)
            ring.finish(tr)
        r.future.set_exception(exc)


class _UnbatchingFuture(Future):
    """Future view that strips the batch dim the engine added for a
    single-sample submit, so clients get back the shape they sent."""

    def __init__(self, inner: Future):
        super().__init__()
        inner.add_done_callback(self._propagate)

    def _propagate(self, inner: Future):
        e = inner.exception()
        if e is not None:
            self.set_exception(e)
        else:
            self.set_result(inner.result()[0])
