"""Serving resilience (≙ ``bigdl_tpu/serving/replicas.py``): replica set,
canary publication, brownout.

One :class:`~bigdl_tpu_torch.serving.ServingEngine` or
:class:`~bigdl_tpu_torch.serving.DecodeEngine` is one failure domain: a
wedged batcher or one bad weight publication takes the model offline.
This module is the fleet-of-replicas layer on top:

:class:`ReplicaSet`
    Fronts N engines (each with its own registry and Recorder) behind one
    ``submit``/``predict`` API.  A health loop scores every replica from
    its own telemetry — windowed error rate, queue depth, latency p99 —
    and **ejects outliers**; ejected replicas are **probed** with a golden
    request and re-admitted when they answer finitely again.  A replica
    whose oldest in-flight request exceeds the wedge budget while it
    serves nothing is **wedged**: it is ejected and its in-flight requests
    **fail over** to healthy peers under a token-bucket budget, so a mass
    failover never turns an overload into a retry storm.  Responses are
    delivered exactly once: a wedged replica's late result is dropped
    (``replica/stale_results``), never a second completion.

:class:`OverloadController`
    Admission with priority classes (interactive / normal / batch shed at
    increasing saturation), a predictive shed for requests whose deadline
    cannot be met at the measured service rate, and a **brownout ladder**:
    sustained saturation routes requests to the set's ``degrade=`` entries
    before anything is shed.  A pure state machine with an injectable
    clock, so the ladder is testable by counts without load.

:class:`CanaryPublisher`
    Stages every weight publication through ONE quiesced canary replica
    (out of rotation, in-flight drained), re-runs a **golden batch** —
    outputs must be finite and, for float outputs, within drift bounds of
    the pre-publication outputs; a decode canary's token ids skip the
    drift gate and a poisoned snapshot fails through the engine's
    non-finite sentinel — then promotes the same tensors fleet-wide, or
    rolls the canary back to the old snapshot (bitwise: the same tensors
    republished) and raises :class:`CanaryRejectedError`.  Client traffic
    serves the old snapshot throughout validation.

Every tensor a published snapshot holds is never written in place (see
``registry.py``): promotion hands the same tensors to every replica, and a
rollback republishes the old ones, so the gate and the bitwise rollback
rest on that invariant.

Fault sites: ``serving.compute`` / ``serving.decode_step`` fire in every
engine batch or step (how a chaos test wedges or errors one replica);
``serving.publish`` fires in the canary staging step (transient blips
retried through ``RetryPolicy(name="serving.publish")``; a failed
validation is fatal and rolls back).

``build_replica_set(int8_degrade=True)`` registers the int8
``<name>.int8`` entry in every replica as the brownout target; a canary
promotion quantizes it anew from the promoted snapshot on every replica
(``serving/degrade_refreshed``, ``serving/degrade_refresh_failures``).

``serve_metrics`` starts one aggregated introspection server for the
set: its own recorder as the base source, each replica's under a
``job="replica<i>"`` label (``render_prometheus_multi``), and a 503 on
total outage; ``shutdown`` stops it.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import faults as faultplane
from ..observability import Recorder
from ..observability import tracing as trace_spine
from ..observability.context import TraceContext
from ..observability.goodput import GoodputLedger, ledger_phase
from ..utils.retry import RetryPolicy
from .engine import ServingEngine
from .queue import EngineClosedError, LoadShedError
from .registry import ModelRegistry, Snapshot, owning_copy

#: priority classes, most to least latency-sensitive.  The admission
#: thresholds below are the saturation level at which each class sheds.
PRIORITY_CLASSES = ("interactive", "normal", "batch")

#: terminal ejection reasons — the probe loop never resurrects these.
#: "killed" is the chaos/operator hard-kill; "scaled_down" is the
#: autoscaler's graceful decommission (the engine drained first).
TERMINAL_REASONS = ("killed", "scaled_down")


class NoHealthyReplicaError(RuntimeError):
    """Every replica is ejected/killed — a total outage, distinct from
    backpressure (:class:`~bigdl_tpu_torch.serving.LoadShedError`)."""


class CanaryRejectedError(RuntimeError):
    """A staged weight publication failed canary validation and was
    rolled back; the fleet never saw the rejected snapshot."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"canary rejected ({reason})"
                         f"{': ' if detail else ''}{detail}")
        self.reason = reason


class _Flight:
    """One client request tracked across failover attempts.  The client
    future completes exactly once; late results from abandoned
    dispatches are dropped via the Future's own set-once contract."""

    __slots__ = ("name", "serve_name", "x", "rows", "deadline",
                 "priority", "future", "attempts", "browned", "tried",
                 "ctx")

    def __init__(self, name: str, serve_name: str, x, rows: int,
                 deadline: Optional[float], priority: str,
                 browned: bool, ctx: Optional[TraceContext] = None):
        self.name = name
        self.serve_name = serve_name
        self.x = x
        self.rows = rows
        self.deadline = deadline      # absolute monotonic seconds or None
        self.priority = priority
        self.future: Future = Future()
        self.attempts = 0             # failover re-dispatches so far
        self.browned = browned
        self.tried: set = set()       # replica indices already tried —
        # a failover must not bounce back to the replica that failed it
        self.ctx = ctx                # root TraceContext for this
        # request — every dispatch (and failover re-dispatch) derives a
        # child, so ONE trace id names the request across hops

    def remaining_ms(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline is None:
            return None
        now = time.monotonic() if now is None else now
        return max((self.deadline - now) * 1e3, 0.0)


class _Replica:
    """One engine's slot in the set: rotation state + the health-window
    bookkeeping the scoring loop keeps between ticks.  All mutable
    fields are guarded by the owning ReplicaSet's lock."""

    __slots__ = ("index", "engine", "state", "reason", "ejected_at",
                 "inflight", "ok_total", "fail_total", "last_ok",
                 "last_fail", "last_rows", "last_progress_at",
                 "window_requests", "error_rate", "p99_ms",
                 "queue_rows", "probe", "last_probe_at")

    HEALTHY = "healthy"
    CANARY = "canary"           # quiesced for a canary validation
    EJECTED = "ejected"

    def __init__(self, index: int, engine: ServingEngine):
        self.index = index
        self.engine = engine
        self.state = self.HEALTHY
        self.reason: Optional[str] = None
        self.ejected_at: Optional[float] = None
        self.inflight: Dict[int, tuple] = {}    # token -> (flight, t0)
        # dispatch OUTCOMES observed by the set (per request, not per
        # engine batch — a failed batch of k coalesced requests is k
        # failures here, so the ejection rate is request-weighted)
        self.ok_total = 0
        self.fail_total = 0
        self.last_ok = 0
        self.last_fail = 0
        self.last_rows = 0.0
        self.last_progress_at = time.monotonic()
        self.window_requests = 0.0
        self.error_rate = 0.0
        self.p99_ms: Optional[float] = None
        self.queue_rows = 0
        self.probe: Optional[Future] = None
        self.last_probe_at = 0.0


class OverloadController:
    """Admission + brownout state machine over a saturation signal.

    ``saturation`` is pending rows across healthy replicas divided by
    their combined queue capacity (0 = idle, 1 = every queue full).
    Not thread-safe by itself: every method is called under the owning
    ReplicaSet's lock, and ``time_fn`` is injectable so the hold timers
    are unit-testable without wall-clock sleeps.

    The ladder, in order of escalation:

      1. **priority shed** — each class has a saturation threshold
         beyond which its new requests shed at admission
         (``LoadShedError("overload")``): batch first, interactive
         last.
      2. **predictive shed** — a request whose deadline cannot be met
         at the measured service rate sheds immediately
         (``LoadShedError("predicted")``) instead of wasting queue
         space to die at the pop.
      3. **brownout** — saturation above ``brownout_enter`` sustained
         for ``hold_s`` flips the set to serving the ``degrade=``
         entries (any registered name: a cheaper model); it exits after
         ``hold_s`` below ``brownout_exit``.  Brownout
         precedes shedding in spirit: it raises the service rate so the
         thresholds above stop triggering.
    """

    def __init__(self, *, shed_thresholds: Optional[Dict[str, float]] = None,
                 brownout_enter: float = 0.75, brownout_exit: float = 0.35,
                 hold_s: float = 1.0,
                 time_fn: Callable[[], float] = time.monotonic):
        self.shed_thresholds = dict(shed_thresholds or {
            "batch": 0.50, "normal": 0.85, "interactive": 1.01})
        for cls in PRIORITY_CLASSES:
            if cls not in self.shed_thresholds:
                raise ValueError(f"shed_thresholds missing {cls!r}")
        self.brownout_enter = float(brownout_enter)
        self.brownout_exit = float(brownout_exit)
        self.hold_s = float(hold_s)
        self._time = time_fn
        self.browned = False
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None

    def admits(self, priority: str, saturation: float) -> bool:
        """Whether a request of ``priority`` is admitted at
        ``saturation`` (threshold check only; the caller counts)."""
        return saturation < self.shed_thresholds[priority]

    def update(self, saturation: float) -> Optional[str]:
        """Advance the brownout timers; returns ``"enter"``/``"exit"``
        on a transition, else None."""
        now = self._time()
        if not self.browned:
            self._below_since = None
            if saturation >= self.brownout_enter:
                if self._above_since is None:
                    self._above_since = now
                elif now - self._above_since >= self.hold_s:
                    self.browned = True
                    self._above_since = None
                    return "enter"
            else:
                self._above_since = None
        else:
            self._above_since = None
            if saturation <= self.brownout_exit:
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.hold_s:
                    self.browned = False
                    self._below_since = None
                    return "exit"
            else:
                self._below_since = None
        return None


class ReplicaSet:
    """N serving engines behind one submit API with health-gated
    routing, wedge failover, and overload control.

    ``engines``          the replicas; each wraps its OWN registry and
                         Recorder (per-replica health needs per-replica
                         telemetry).  Register the same model names in
                         all of them — :func:`build_replica_set` does.
    ``recorder``         the set's own Recorder (``replica/*`` and
                         ``serving/*`` counters, ``replica_event``
                         records); defaults to a fresh enabled one
    ``wedge_after``      oldest-in-flight age (s) past which a replica
                         is declared wedged, ejected, and failed over
    ``max_failovers``    re-dispatch budget per request
    ``failover_rate``    token-bucket refill (failovers/s) across the
                         whole set — the retry-storm cap
    ``failover_burst``   bucket capacity
    ``degrade``          ``{model: cheaper_model}`` brownout mapping (any
                         name registered in every replica's registry)
    ``controller``       an :class:`OverloadController` (default-built)
    ``health_interval``  scoring-loop period (s); the loop starts with
                         the first submit and stops on shutdown
    ``eject_error_rate`` windowed error-rate ejection threshold
    ``eject_min_requests``  window floor below which the rate is noise
    ``p99_outlier_factor``/``p99_floor_ms``  eject a replica whose p99
                         exceeds ``factor`` × the median p99 of the
                         OTHER healthy replicas AND the floor (needs
                         >= 2 healthy peers besides the suspect, i.e.
                         a 3-replica set at full strength)
    """

    def __init__(self, engines: Sequence[ServingEngine], *,
                 recorder: Optional[Recorder] = None,
                 wedge_after: float = 5.0,
                 max_failovers: int = 2,
                 failover_rate: float = 64.0, failover_burst: int = 32,
                 degrade: Optional[Dict[str, str]] = None,
                 controller: Optional[OverloadController] = None,
                 health_interval: float = 0.1,
                 probe_interval: float = 0.25,
                 probe_deadline_ms: float = 1000.0,
                 eject_error_rate: float = 0.5,
                 eject_min_requests: int = 4,
                 p99_outlier_factor: float = 8.0,
                 p99_floor_ms: float = 250.0,
                 tracer: Optional["trace_spine.Tracer"] = None):
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        self.replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self.recorder = recorder if recorder is not None else Recorder()
        if self.recorder.get_ledger() is None:
            # control-plane ledger (one host "device"): failover
            # re-dispatch, golden-probe readmission, and brownout windows
            # land here; per-device serving time lives on each engine's
            # OWN recorder ledger, so the two never double-book
            self.recorder.set_ledger(GoodputLedger(name="serve",
                                                   devices=1))
        self.tracer = tracer          # None -> process default at use
        self.wedge_after = float(wedge_after)
        self.max_failovers = int(max_failovers)
        self.failover_rate = float(failover_rate)
        self.failover_burst = float(failover_burst)
        self.degrade = dict(degrade or {})
        self.controller = controller or OverloadController()
        self.health_interval = float(health_interval)
        self.probe_interval = float(probe_interval)
        self.probe_deadline_ms = float(probe_deadline_ms)
        self.eject_error_rate = float(eject_error_rate)
        self.eject_min_requests = int(eject_min_requests)
        self.p99_outlier_factor = float(p99_outlier_factor)
        self.p99_floor_ms = float(p99_floor_ms)
        self._lock = threading.Lock()
        self._tokens = itertools.count()
        self._failover_tokens = self.failover_burst
        self._refilled_at = time.monotonic()
        self._service_rate: Optional[float] = None  # rows/s EWMA, set-wide
        self._probe_inputs: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._http_server = None

    # -- lifecycle --------------------------------------------------------- #
    def warmup(self) -> "ReplicaSet":
        for rep in self.replicas:
            rep.engine.warmup()
        return self

    def start(self) -> "ReplicaSet":
        """Start the health/scoring loop (idempotent; submit() calls
        this lazily)."""
        with self._lock:
            if self._closed:
                raise EngineClosedError("replica set is shut down")
            if self._thread is None or not self._thread.is_alive():
                self._stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._health_loop, args=(self._stop,),
                    daemon=True, name="replica-health")
                self._thread.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 5.0) -> "ReplicaSet":
        with self._lock:
            self._closed = True
            stop = self._stop
            t, self._thread = self._thread, None
            server, self._http_server = self._http_server, None
        stop.set()
        if t is not None:
            t.join(timeout)
        if server is not None:
            server.stop()
        for rep in self.replicas:
            rep.engine.shutdown(drain=drain, timeout=timeout)
        return self

    def telemetry_sources(self):
        """``[(name, recorder), ...]``: the set's own recorder
        (``replica/*`` rotation gauges) plus one per replica.  Terminally
        removed replicas (killed / scaled down) are excluded."""
        with self._lock:
            live = [rep for rep in self.replicas
                    if not (rep.state == _Replica.EJECTED
                            and rep.reason in TERMINAL_REASONS)]
        return [("set", self.recorder)] + \
            [(f"replica{rep.index}", rep.engine.recorder)
             for rep in live]

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """One aggregated introspection server for the whole set: the
        set's own recorder is the base source (``replica/*`` health
        gauges land in ``/healthz``), each replica's recorder is a
        ``job="replica<i>"``-labeled source on ``/metrics``, and the
        worst-of verdict is 503 on total outage (no healthy replica —
        the set registers itself as the health monitor)."""
        from ..observability.http import IntrospectionServer
        server = IntrospectionServer(self.recorder, port=port, host=host,
                                     monitor=self)
        for rep in self.replicas:
            server.add_job(f"replica{rep.index}", rep.engine.recorder)
        return server.swap_into(self, self._lock, EngineClosedError(
            "replica set shut down while serve_metrics was binding"))

    @property
    def healthy(self) -> bool:
        """True while at least one replica is in rotation — the
        monitor verdict ``/healthz`` folds into the aggregate ``ok``."""
        with self._lock:
            return bool(self._routable_locked())

    # -- request path ------------------------------------------------------ #
    @property
    def _tracer(self) -> "trace_spine.Tracer":
        return self.tracer if self.tracer is not None \
            else trace_spine.get_tracer()

    def submit(self, name: str, x, deadline_ms: Optional[float] = None,
               priority: str = "normal",
               trace_ctx: Optional[TraceContext] = None) -> Future:
        """Admit one request and dispatch it to the healthiest replica.

        Sheds with :class:`LoadShedError` reason ``"overload"`` when
        ``priority``'s saturation threshold is crossed, ``"predicted"``
        when ``deadline_ms`` cannot be met at the measured service
        rate, or ``"queue_full"`` when every healthy replica's queue is
        full; raises :class:`NoHealthyReplicaError` on total outage.

        The front door is where a request's trace begins: a root
        :class:`TraceContext` is minted here (or adopted from
        ``trace_ctx``), every dispatch and failover hop derives a child
        of it, and the engine-side request timeline records under the
        SAME trace id.
        """
        if priority not in PRIORITY_CLASSES:
            raise ValueError(f"priority {priority!r} not in "
                             f"{PRIORITY_CLASSES}")
        self.start()
        rec = self.recorder
        rec.inc("serving/requests")
        ctx = trace_ctx if trace_ctx is not None \
            else TraceContext.new_root()
        admit = self._tracer.begin("rs.admit", ctx, child=False,
                                   subsystem="replicaset")
        now = time.monotonic()
        deadline = None if deadline_ms is None \
            else now + float(deadline_ms) / 1e3
        try:
            rows = self._rows_of(name, x)
            with self._lock:
                routable = self._routable_locked()
                if not routable:
                    raise NoHealthyReplicaError(
                        "no healthy replica in rotation "
                        f"({[(r.index, r.state, r.reason) for r in self.replicas]})")
                sat = self._saturation_locked(routable)
                rec.gauge("serving/saturation", sat)
                if not self.controller.admits(priority, sat):
                    rec.inc("serving/shed_overload")
                    raise LoadShedError(
                        "overload", f"saturation {sat:.2f} sheds priority "
                                    f"class {priority!r}")
                if deadline_ms is not None and self._service_rate:
                    # _service_rate is the FLEET rows/s; the request will
                    # be served by one replica at ~rate/N, against the
                    # least-loaded replica's backlog
                    per_rate = self._service_rate / len(routable)
                    pending = min(r.engine.pending_rows() for r in routable)
                    wait_ms = (pending + rows) / per_rate * 1e3
                    if wait_ms > float(deadline_ms):
                        rec.inc("serving/shed_predicted")
                        raise LoadShedError(
                            "predicted",
                            f"predicted wait {wait_ms:.0f}ms exceeds the "
                            f"{deadline_ms:.0f}ms deadline at "
                            f"{per_rate:.0f} rows/s/replica")
                browned = self.controller.browned and name in self.degrade
                serve_name = self.degrade[name] if browned else name
        except BaseException as e:
            admit.end(shed=repr(e))
            raise
        if browned:
            rec.inc("serving/brownout_requests")
        flight = _Flight(name, serve_name, x, rows, deadline, priority,
                         browned, ctx=ctx)
        admit.end(model=name, priority=priority, rows=rows)
        self._dispatch(flight)
        return flight.future

    def predict(self, name: str, x, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None,
                priority: str = "normal"):
        """Synchronous convenience; splits inputs larger than the
        bucket ladder across submits like ``ServingEngine.predict``."""
        eng0 = self.replicas[0].engine
        max_batch = eng0.ladder.max_batch
        rows = self._rows_of(name, x)
        if rows <= max_batch or not getattr(eng0, "row_splittable", True):
            # engines whose "rows" are a SEQUENCE (the decode engine: a
            # prompt's tokens) must never be sliced into independent
            # requests — a concatenation of three unrelated decodes is
            # not a decode of the prompt.  Submit whole; the engine
            # rejects over-long prompts loudly.
            return self.submit(name, x, deadline_ms=deadline_ms,
                               priority=priority).result(timeout)
        x = np.asarray(x)
        futs = [self.submit(name, x[i:i + max_batch],
                            deadline_ms=deadline_ms, priority=priority)
                for i in range(0, rows, max_batch)]
        parts = [f.result(timeout) for f in futs]
        return np.concatenate(parts, axis=0)

    # -- introspection ----------------------------------------------------- #
    def health(self) -> Dict[int, Dict[str, Any]]:
        """Per-replica health snapshot (what the scoring loop saw at
        its last tick)."""
        with self._lock:
            return {r.index: {
                "state": r.state, "reason": r.reason,
                "error_rate": r.error_rate, "p99_ms": r.p99_ms,
                "queue_rows": r.queue_rows,
                "inflight": len(r.inflight)} for r in self.replicas}

    def stats(self) -> Dict[str, Any]:
        """Set-level counters plus each replica's engine stats."""
        rec = self.recorder
        out: Dict[str, Any] = {
            k.rsplit("/", 1)[1]: rec.counter_value(k)
            for k in ("serving/requests", "serving/shed_overload",
                      "serving/shed_predicted",
                      "serving/brownout_requests",
                      "replica/dispatches", "replica/failovers",
                      "replica/failover_exhausted", "replica/ejected",
                      "replica/readmitted", "replica/wedged",
                      "replica/stale_results", "replica/scaled_up",
                      "replica/scaled_down")}
        out["brownout"] = bool(self.controller.browned)
        out["replicas"] = {r.index: r.engine.stats()
                           for r in self.replicas}
        return out

    def set_probe(self, name: str, x) -> "ReplicaSet":
        """Install the golden probe input for ``name`` (defaults to a
        zeros batch derived from the registered ``input_shape``)."""
        with self._lock:
            self._probe_inputs[name] = np.asarray(x)
        return self

    # -- chaos / operator actions ------------------------------------------ #
    def kill(self, index: int) -> "ReplicaSet":
        """Hard-kill one replica (chaos seam / operator drain): its
        engine shuts down without draining, it leaves rotation for
        good (never probed back), and its in-flight requests fail over
        through the normal budgeted path."""
        rep = self.replicas[index]
        with self._lock:
            already = rep.state == _Replica.EJECTED \
                and rep.reason == "killed"
            if not already:
                if rep.state == _Replica.EJECTED:
                    # already out (wedged/errors): escalate the reason
                    # so the probe loop stops resurrecting a dead engine
                    rep.reason = "killed"
                    rep.probe = None
                else:
                    self._eject_locked(rep, "killed")
                self.recorder.inc("replica/killed")
        if not already:
            rep.engine.shutdown(drain=False, timeout=1.0)
        return self

    # -- scaling seams ------------------------------------------------------ #
    def add_replica(self, engine: ServingEngine, *,
                    warm: bool = False) -> int:
        """Admit a new engine into the set (the autoscaler's scale-up
        seam).  The replica joins EJECTED with reason ``"joining"`` and
        enters rotation only after the health loop's golden probe
        passes — the same readmission path an ejected replica takes, so
        a half-warmed engine never takes live traffic.  Returns the new
        replica's index."""
        if warm:
            engine.warmup()     # compile outside the set lock
        with self._lock:
            if self._closed:
                raise EngineClosedError("replica set is shut down")
            index = len(self.replicas)
            rep = _Replica(index, engine)
            rep.state = _Replica.EJECTED
            rep.reason = "joining"
            rep.ejected_at = time.monotonic()
            self.replicas.append(rep)
        self.recorder.inc("replica/scaled_up")
        self.recorder.emit_record("replica_event", kind="join",
                                  replica=index)
        print(f"[serving] replica {index} joining (probe-gated)",
              flush=True)
        return index

    def decommission(self, index: int, *, drain: bool = True,
                     timeout: Optional[float] = 5.0) -> "ReplicaSet":
        """Gracefully remove one replica (the autoscaler's scale-down
        seam): it leaves rotation for good — reason ``"scaled_down"``
        is terminal, never probed back — and its engine drains before
        shutdown so accepted work completes.  In-flight requests the
        set already dispatched fail over through the normal budgeted
        path.  Refuses to remove the last routable replica."""
        rep = self.replicas[index]
        with self._lock:
            if rep.state == _Replica.EJECTED \
                    and rep.reason in TERMINAL_REASONS:
                return self                 # idempotent
            if rep.state == _Replica.HEALTHY \
                    and len(self._routable_locked()) <= 1:
                raise ValueError(
                    f"refusing to decommission replica {index}: it is "
                    "the last replica in rotation")
            if rep.state == _Replica.EJECTED:
                # already out (probing back in): escalate to terminal
                rep.reason = "scaled_down"
                rep.probe = None
                self.recorder.emit_record(
                    "replica_event", kind="eject", replica=index,
                    reason="scaled_down")
            else:
                self._eject_locked(rep, "scaled_down")
            self.recorder.inc("replica/scaled_down")
        rep.engine.shutdown(drain=drain, timeout=timeout)
        return self

    # -- internals: routing ------------------------------------------------ #
    def _rows_of(self, name: str, x) -> int:
        """Row count for queue math, via any live registry's entry."""
        shape = np.shape(x)
        for rep in self.replicas:
            try:
                entry = rep.engine.registry.get(name)
            except KeyError:
                continue
            if entry.input_shape is not None \
                    and shape == tuple(entry.input_shape):
                return 1
            break
        return int(shape[0]) if shape else 1

    def _routable_locked(self) -> List[_Replica]:
        return [r for r in self.replicas if r.state == _Replica.HEALTHY]

    def _saturation_locked(self, routable: List[_Replica]) -> float:
        """Mean over routable replicas of each engine's most-saturated
        queue fill — 1.0 means every replica's hottest admission point
        is full."""
        if not routable:
            return 1.0
        return sum(r.engine.max_queue_fill()
                   for r in routable) / len(routable)

    def _dispatch(self, flight: _Flight):
        """Send ``flight`` to the least-loaded healthy replica; on a
        full queue try the next one, on a closed engine eject it and
        keep going.  Raises the last shed error when every healthy
        replica refused."""
        last_shed: Optional[LoadShedError] = None
        retried_all = False
        while True:
            with self._lock:
                healthy = self._routable_locked()
                candidates = [r for r in healthy
                              if r.index not in flight.tried]
                if not candidates and healthy and not retried_all \
                        and last_shed is None:
                    # every healthy replica already failed this flight
                    # once; allow ONE more pass (a single-replica set
                    # must still be able to retry a transient)
                    retried_all = True
                    flight.tried.clear()
                    candidates = healthy
                candidates.sort(key=lambda r: r.engine.pending_rows())
            if not candidates:
                if last_shed is not None:
                    raise last_shed
                raise NoHealthyReplicaError(
                    "no healthy replica accepted the request")
            rep = candidates[0]
            flight.tried.add(rep.index)
            try:
                inner = rep.engine.submit(
                    flight.serve_name, flight.x,
                    deadline_ms=flight.remaining_ms(),
                    trace_ctx=flight.ctx.child()
                    if flight.ctx is not None else None)
            except LoadShedError as e:
                last_shed = e
                continue
            except EngineClosedError:
                with self._lock:
                    self._eject_locked(rep, "closed")
                continue
            token = next(self._tokens)
            with self._lock:
                rep.inflight[token] = (flight, time.monotonic())
            self.recorder.inc("replica/dispatches")
            inner.add_done_callback(
                lambda f, rep=rep, token=token, flight=flight:
                self._on_inner_done(rep, token, flight, f))
            return

    def _on_inner_done(self, rep: _Replica, token: int, flight: _Flight,
                       inner: Future):
        exc = inner.exception()
        with self._lock:
            rep.inflight.pop(token, None)
            if exc is None:
                rep.ok_total += 1
            elif not isinstance(exc, LoadShedError):
                # deadline sheds are the request's SLO failing, not
                # evidence against the replica; real errors are
                rep.fail_total += 1
        if exc is None:
            if not self._complete(flight, result=inner.result()):
                self.recorder.inc("replica/stale_results")
            return
        if isinstance(exc, LoadShedError) and exc.reason == "deadline":
            # the SLO already failed; a retry would only waste compute
            self._complete(flight, exc=exc)
            return
        if flight.future.done():
            self.recorder.inc("replica/stale_results")
            return
        self._failover(flight, exc)

    def _failover(self, flight: _Flight, cause: BaseException):
        """Re-dispatch a failed/abandoned flight under the budget; the
        cause propagates to the client when the budget says no."""
        rec = self.recorder
        eligible = flight.attempts < self.max_failovers \
            and not flight.future.done() \
            and (flight.deadline is None
                 or time.monotonic() < flight.deadline)
        if eligible and not self._take_failover_token():
            rec.inc("replica/failover_exhausted")
            eligible = False
        if not eligible:
            self._complete(flight, exc=cause)
            return
        flight.attempts += 1
        rec.inc("replica/failovers")
        if flight.ctx is not None:
            # zero-length hop marker in the request's own trace: the
            # merged timeline shows WHERE the retry happened between
            # the failed replica's terminal span and the re-dispatch
            self._tracer.event("rs.failover", flight.ctx,
                               subsystem="replicaset",
                               attempt=flight.attempts,
                               cause=repr(cause))
        try:
            with ledger_phase(rec, "failover"):
                self._dispatch(flight)
        except Exception as e:
            self._complete(flight, exc=e)

    def _take_failover_token(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._failover_tokens = min(
                self.failover_burst,
                self._failover_tokens
                + (now - self._refilled_at) * self.failover_rate)
            self._refilled_at = now
            if self._failover_tokens >= 1.0:
                self._failover_tokens -= 1.0
                return True
            return False

    @staticmethod
    def _complete(flight: _Flight, result=None,
                  exc: Optional[BaseException] = None) -> bool:
        """Deliver exactly once; False when the flight already
        completed (a late result from an abandoned dispatch)."""
        try:
            if exc is not None:
                flight.future.set_exception(exc)
            else:
                flight.future.set_result(result)
            return True
        except InvalidStateError:
            return False

    # -- internals: health loop -------------------------------------------- #
    def _health_loop(self, stop: threading.Event):
        while not stop.wait(self.health_interval):
            try:
                self.check_health()
            except Exception as e:  # the scorer must never die silently
                print(f"[serving] replica health check failed: {e!r}",
                      flush=True)

    def check_health(self):
        """One scoring tick.  Public so tests (and operators in a
        debugger) can drive the verdict synchronously."""
        now = time.monotonic()
        to_failover: List[_Flight] = []
        probes: List[_Replica] = []
        with self._lock:
            rate = 0.0
            busy = False
            for rep in self.replicas:
                erec = rep.engine.recorder
                rows = erec.counter_value("serving.rows")
                d_ok = rep.ok_total - rep.last_ok
                d_fail = rep.fail_total - rep.last_fail
                d_rows = max(rows - rep.last_rows, 0.0)
                rate += d_rows
                rep.last_ok, rep.last_fail = rep.ok_total, rep.fail_total
                rep.last_rows = rows
                if d_rows > 0 or not rep.inflight:
                    # serving rows (or idle) is progress: only a
                    # replica that is BOTH old-in-flight and serving
                    # nothing reads as wedged — a deep backlog alone
                    # must not
                    rep.last_progress_at = now
                rep.window_requests = d_ok + d_fail
                if rep.window_requests > 0:
                    rep.error_rate = d_fail / rep.window_requests
                q = erec.hist_quantiles("serving.latency_ms")
                rep.p99_ms = q.get("p99") if q else None
                rep.queue_rows = rep.engine.pending_rows()
                busy = busy or rep.window_requests > 0 \
                    or rep.queue_rows > 0 or bool(rep.inflight)
            # only fold windows with actual traffic into the rate EWMA:
            # an idle gap is not evidence of slow service, and decaying
            # toward zero would make the predictive shed reject every
            # deadline-bearing request after the gap
            if busy:
                self._update_rate_locked(rate)
            healthy = self._routable_locked()
            peers_p99 = [(r.index, r.p99_ms) for r in healthy
                         if r.p99_ms is not None]
            remaining = len(healthy)
            for rep in healthy:
                verdict = self._eject_verdict_locked(rep, now, peers_p99,
                                                     len(healthy))
                if verdict is None:
                    continue
                if remaining <= 1:
                    # NEVER health-eject the last replica in rotation:
                    # a degraded sole survivor (requests shed by
                    # deadline) beats a self-inflicted total outage on
                    # a noisy verdict.  kill() still removes it.
                    self.recorder.inc("replica/eject_deferred")
                    continue
                remaining -= 1
                self._eject_locked(rep, verdict)
                if verdict == "wedged":
                    self.recorder.inc("replica/wedged")
                    # abandon the wedge's in-flight work: pop it here,
                    # fail it over outside the lock
                    for token in list(rep.inflight):
                        flight, _ = rep.inflight.pop(token)
                        if not flight.future.done():
                            to_failover.append(flight)
            for rep in self.replicas:
                if rep.state == _Replica.EJECTED \
                        and rep.reason not in TERMINAL_REASONS:
                    probes.append(rep)
            routable = self._routable_locked()
            sat = self._saturation_locked(routable) if routable else 1.0
            self.recorder.gauge("serving/saturation", sat)
            transition = self.controller.update(sat)
            self._publish_gauges_locked()
        rec = self.recorder
        if transition == "enter":
            rec.inc("serving/brownout_enter")
            rec.gauge("serving/brownout", 1)
            rec.emit_record("replica_event", kind="brownout_enter",
                            saturation=sat)
            led = rec.get_ledger()
            if led is not None:
                # browned wall time is badput on the set's control-plane
                # ledger until the exit flips the background back
                led.declare("brownout")
        elif transition == "exit":
            rec.inc("serving/brownout_exit")
            rec.gauge("serving/brownout", 0)
            rec.emit_record("replica_event", kind="brownout_exit",
                            saturation=sat)
            led = rec.get_ledger()
            if led is not None:
                led.declare("idle")
        for flight in to_failover:
            self._failover(flight, LoadShedError(
                "wedged", "replica ejected as wedged mid-request"))
        for rep in probes:
            self._probe(rep, now)

    def _update_rate_locked(self, window_rows: float):
        rate = window_rows / max(self.health_interval, 1e-3)
        if self._service_rate is None:
            self._service_rate = rate if rate > 0 else None
        else:
            self._service_rate = 0.8 * self._service_rate + 0.2 * rate

    def _eject_verdict_locked(self, rep: _Replica, now: float,
                              peers_p99: List[float],
                              n_healthy: int) -> Optional[str]:
        oldest = min((t0 for _, t0 in rep.inflight.values()),
                     default=None)
        if oldest is not None and now - oldest > self.wedge_after \
                and now - rep.last_progress_at > self.wedge_after:
            return "wedged"
        if rep.window_requests >= self.eject_min_requests \
                and rep.error_rate >= self.eject_error_rate:
            return "errors"
        peers = sorted(p for i, p in peers_p99 if i != rep.index)
        if (rep.p99_ms is not None and n_healthy >= 3
                and len(peers) >= 2
                and rep.p99_ms > self.p99_floor_ms
                and rep.p99_ms > self.p99_outlier_factor
                * peers[len(peers) // 2]):
            return "p99_outlier"
        return None

    def _eject_locked(self, rep: _Replica, reason: str):
        if rep.state == _Replica.EJECTED:
            return
        rep.state = _Replica.EJECTED
        rep.reason = reason
        rep.ejected_at = time.monotonic()
        rep.probe = None
        self.recorder.inc("replica/ejected")
        self.recorder.emit_record("replica_event", kind="eject",
                                  replica=rep.index, reason=reason)
        print(f"[serving] replica {rep.index} ejected ({reason})",
              flush=True)

    def _publish_gauges_locked(self):
        rec = self.recorder
        rec.gauge("replica/healthy_count",
                  len(self._routable_locked()))
        for rep in self.replicas:
            rec.gauge(f"replica/healthy.{rep.index}",
                      1 if rep.state == _Replica.HEALTHY else 0)
            rec.gauge(f"replica/queue_rows.{rep.index}", rep.queue_rows)
            rec.gauge(f"replica/error_rate.{rep.index}", rep.error_rate)
            if rep.p99_ms is not None:
                rec.gauge(f"replica/p99_ms.{rep.index}", rep.p99_ms)

    # -- internals: probe-based re-admission ------------------------------- #
    def _probe_input_for(self, rep: _Replica):
        """(name, x) golden probe for ``rep``, from ``set_probe`` or a
        zeros batch off any registered entry's input_shape."""
        with self._lock:
            if self._probe_inputs:
                name = next(iter(self._probe_inputs))
                return name, self._probe_inputs[name]
        for entry in rep.engine.registry.entries():
            if entry.input_shape is not None:
                return entry.name, np.zeros((1,) + tuple(entry.input_shape),
                                            entry.dtype)
        return None, None

    def _probe(self, rep: _Replica, now: float):
        with self._lock:
            if rep.state != _Replica.EJECTED \
                    or rep.reason in TERMINAL_REASONS:
                return
            probe = rep.probe
            if probe is None:
                if now - rep.last_probe_at < self.probe_interval \
                        or rep.inflight:
                    return              # wedge not yet released
                launch = True
            else:
                launch = False
        if launch:
            name, x = self._probe_input_for(rep)
            if name is None:
                return
            self.recorder.inc("replica/probes")
            try:
                with ledger_phase(self.recorder, "probe_readmission"):
                    fut = rep.engine.submit(
                        name, x, deadline_ms=self.probe_deadline_ms)
            except (LoadShedError, EngineClosedError):
                self.recorder.inc("replica/probe_failures")
                with self._lock:
                    rep.last_probe_at = now
                return
            with self._lock:
                rep.probe = fut
                rep.last_probe_at = now
            return
        if not probe.done():
            return
        ok = probe.exception() is None
        if ok:
            try:
                ok = bool(np.isfinite(np.asarray(probe.result())).all())
            except Exception:
                ok = False
        with self._lock:
            rep.probe = None
            if rep.state != _Replica.EJECTED \
                    or rep.reason in TERMINAL_REASONS:
                return      # kill()/decommission raced: stay out
            was = rep.reason
            if not ok:
                rep.last_probe_at = now
            else:
                rep.state = _Replica.HEALTHY
                rep.reason = None
                rep.ejected_at = None
                rep.last_progress_at = time.monotonic()
        if ok:
            self.recorder.inc("replica/readmitted")
            self.recorder.emit_record("replica_event", kind="readmit",
                                      replica=rep.index, was=was)
            print(f"[serving] replica {rep.index} re-admitted after a "
                  "healthy probe", flush=True)
        else:
            self.recorder.inc("replica/probe_failures")

    # -- internals: canary staging seam ------------------------------------ #
    def _stage_canary(self, index: int, timeout: float) -> bool:
        """Take replica ``index`` out of rotation for a canary
        validation and wait for its in-flight work to drain.  Returns
        False — with the replica back in rotation — when it is not
        currently routable or fails to drain within ``timeout`` (the
        publisher then picks another): a staged-but-undrained canary
        would serve queued client requests against the UNVALIDATED
        snapshot, the exact exposure the canary exists to prevent."""
        rep = self.replicas[index]
        with self._lock:
            if rep.state != _Replica.HEALTHY:
                return False
            rep.state = _Replica.CANARY
            rep.reason = "canary"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not rep.inflight and rep.engine.pending_rows() == 0:
                    return True
            # the set's stop event doubles as the interruptible sleep:
            # a shutdown mid-drain ends the wait immediately
            if self._stop.wait(0.01):
                break
        self._unstage_canary(index)     # undrained: NOT a safe canary
        return False

    def _unstage_canary(self, index: int):
        rep = self.replicas[index]
        with self._lock:
            if rep.state == _Replica.CANARY:
                rep.state = _Replica.HEALTHY
                rep.reason = None


class CanaryPublisher:
    """Stages weight rollouts through one quiesced canary replica with
    golden-batch validation, fleet-wide promotion, and automatic
    rollback.  See the module docstring for the protocol; the
    ``serving.publish`` fault site fires inside the (retried) staging
    step, and a rejected publication leaves every replica serving a
    snapshot whose golden outputs are bit-identical to before the
    publish call."""

    def __init__(self, replica_set: ReplicaSet,
                 golden: Dict[str, Any], *,
                 canary: int = 0, drift_rtol: float = 0.5,
                 drift_atol: float = 1e-3,
                 quiesce_timeout: float = 5.0,
                 validate_timeout: float = 30.0,
                 recorder: Optional[Recorder] = None):
        self.rs = replica_set
        self.golden = {k: np.asarray(v) for k, v in golden.items()}
        self.canary = int(canary)
        self.drift_rtol = float(drift_rtol)
        self.drift_atol = float(drift_atol)
        self.quiesce_timeout = float(quiesce_timeout)
        self.validate_timeout = float(validate_timeout)
        self.recorder = recorder if recorder is not None \
            else replica_set.recorder
        self._publish_lock = threading.Lock()
        self._retry = RetryPolicy(name="serving.publish",
                                  recorder_fn=lambda: self.recorder)

    def publish(self, name: str, params=None, state=None,
                version: Optional[str] = None) -> Snapshot:
        """Validate ``params``/``state`` on the canary, then promote
        fleet-wide; raises :class:`CanaryRejectedError` (after rolling
        the canary back) when the golden outputs are non-finite or
        drift past bounds."""
        if name not in self.golden:
            raise ValueError(f"no golden batch registered for {name!r}; "
                             "CanaryPublisher(golden={...}) needs one "
                             "per published model")
        rec = self.recorder
        with self._publish_lock:
            rec.inc("serving/canary_publishes")
            tried: set = set()
            for _ in range(len(self.rs.replicas)):
                idx = self._pick_canary(exclude=tried)
                tried.add(idx)
                rep = self.rs.replicas[idx]
                if not self.rs._stage_canary(idx, self.quiesce_timeout):
                    continue        # raced out of rotation; pick again
                try:
                    return self._publish_on(rep, name, params, state,
                                            version)
                finally:
                    self.rs._unstage_canary(idx)
            raise NoHealthyReplicaError(
                "could not stage any replica as the canary")

    def publish_from_model(self, name: str, model=None,
                           version: Optional[str] = None) -> Snapshot:
        """The ``sync_from_model`` bridge: republish owning copies of a
        module's parameters (default: the canary entry's module, for
        in-place ``set_weights``-style updates) through the full canary
        gate."""
        if model is None:
            model = self.rs.replicas[self._pick_canary()] \
                .engine.registry.get(name).model
        return self.publish(name, owning_copy(model.param_dict()),
                            version=version)

    # -- internals --------------------------------------------------------- #
    def _pick_canary(self, exclude=()) -> int:
        with self.rs._lock:
            rep = self.rs.replicas[self.canary]
            if rep.state == _Replica.HEALTHY \
                    and self.canary not in exclude:
                return self.canary
            for r in self.rs.replicas:
                if r.state == _Replica.HEALTHY \
                        and r.index not in exclude:
                    return r.index
        raise NoHealthyReplicaError(
            "no healthy replica available to act as canary")

    def _publish_on(self, rep: _Replica, name: str, params, state,
                    version: Optional[str]) -> Snapshot:
        rec = self.recorder
        registry = rep.engine.registry
        entry = registry.get(name)
        old = entry.snapshot
        x = self.golden[name]
        ref = np.asarray(rep.engine.predict(
            name, x, timeout=self.validate_timeout))

        def stage():
            faultplane.inject("serving.publish", rec)
            return registry.swap_weights(name, params, state,
                                         version=version)
        snap = self._retry.run(stage)   # transient blips retried; a
        # ValueError (aval drift) is fatal and nothing was published
        rec.emit_record("replica_event", kind="canary_stage",
                        replica=rep.index, model=name,
                        version=snap.version)
        reason = detail = None
        try:
            got = np.asarray(rep.engine.predict(
                name, x, timeout=self.validate_timeout))
            if not np.isfinite(got).all():
                reason, detail = "non_finite", \
                    f"{int((~np.isfinite(got)).sum())} non-finite " \
                    "golden outputs"
            elif np.issubdtype(got.dtype, np.integer):
                # integer golden outputs are TOKEN IDS (a decode
                # canary): magnitude drift over ids is meaningless and
                # a legitimate weight update may change every token —
                # the poison gate is the golden decode itself, which
                # FAILS (engine non-finite-logits sentinel -> "error"
                # reason) on a poisoned snapshot.  A changed output
                # shape still rejects.
                if got.shape != ref.shape:
                    reason, detail = "drift", \
                        f"golden decode shape {got.shape} != {ref.shape}"
            else:
                drift = float(np.max(np.abs(got - ref)))
                bound = self.drift_atol + self.drift_rtol \
                    * float(np.max(np.abs(ref)))
                if drift > bound:
                    reason, detail = "drift", \
                        f"golden drift {drift:.4g} > bound {bound:.4g}"
        except Exception as e:
            reason, detail = "error", f"{type(e).__name__}: {e}"
        if reason is not None:
            self._rollback(registry, name, old)
            rec.inc("serving/canary_rejected")
            rec.inc("serving/canary_rollbacks")
            rec.emit_record("replica_event", kind="canary_reject",
                            replica=rep.index, model=name,
                            reason=reason, version=snap.version)
            print(f"[serving] canary REJECTED {name} {snap.version} "
                  f"({reason}: {detail}); old snapshot "
                  f"{old.version} restored", flush=True)
            raise CanaryRejectedError(reason, detail)
        promoted: List[_Replica] = []
        try:
            for other in self.rs.replicas:
                if other is rep:
                    continue
                other.engine.registry.swap_weights(
                    name, params, state, version=snap.version)
                promoted.append(other)
        except Exception:
            for other in promoted:
                self._rollback(other.engine.registry, name, old)
            self._rollback(registry, name, old)
            rec.inc("serving/canary_rollbacks")
            rec.emit_record("replica_event", kind="canary_reject",
                            replica=rep.index, model=name,
                            reason="promotion_failed",
                            version=snap.version)
            raise
        rec.inc("serving/canary_promoted")
        rec.emit_record("replica_event", kind="canary_promote",
                        model=name, version=snap.version,
                        replicas=len(promoted) + 1)
        degrade_name = self.rs.degrade.get(name)
        if degrade_name is not None:
            self._refresh_degrade(name, degrade_name, snap)
        return snap

    def _refresh_degrade(self, name: str, degrade_name: str,
                         snap: Snapshot):
        """Quantize every replica's int8 degrade entry anew from the
        promoted snapshot's tensors (with the entry's own calibration
        batches), so that a brownout after a publish serves the NEW
        weights.  Best-effort per replica: the primary entries already
        agree fleet-wide, so a failed refresh is counted and logged, not
        unwound."""
        from ..quantized import quantize_for_serving
        rec = self.recorder
        for rep in self.rs.replicas:
            registry = rep.engine.registry
            try:
                entry8 = registry.get(degrade_name)
            except KeyError:
                continue
            try:
                primary = registry.get(name)
                live = primary.snapshot
                q = quantize_for_serving(
                    primary.model, calibration_data=entry8.calibration_data,
                    params=live.params, state=live.state)
                registry.swap_model(degrade_name, q, version=snap.version)
                rep.engine.warmup(degrade_name)
                rec.inc("serving/degrade_refreshed")
            except Exception as e:
                rec.inc("serving/degrade_refresh_failures")
                print(f"[serving] degrade entry {degrade_name!r} on "
                      f"replica {rep.index} could not be refreshed to "
                      f"{snap.version}: {e!r} — browned-out requests "
                      "there serve the previous weights", flush=True)

    @staticmethod
    def _rollback(registry: ModelRegistry, name: str, old: Snapshot):
        """Republish the OLD snapshot's arrays — outputs after rollback
        are bit-identical to before the publication."""
        registry.swap_weights(name, old.params, old.state,
                              version=old.version)


def build_replica_set(model, n: int, *, name: str = "main",
                      input_shape, dtype=np.float32,
                      int8_degrade: bool = False,
                      calibration_data=None,
                      engine_kw: Optional[Dict[str, Any]] = None,
                      **rs_kw) -> ReplicaSet:
    """Build an N-replica set over ``model``: one registry + engine +
    recorder per replica, all serving ``name`` (each registry holds its own
    owning copy of the weights, on the model's device).  With
    ``int8_degrade=True`` each registry also gets the quantized
    ``<name>.int8`` entry (calibrated with ``calibration_data`` when given)
    and the set's brownout ``degrade`` map routes to it under sustained
    saturation."""
    engine_kw = dict(engine_kw or {})
    # per-replica health scoring needs per-replica telemetry: each
    # engine always gets its own Recorder, never a shared one
    engine_kw.pop("recorder", None)
    engines = []
    for _ in range(int(n)):
        reg = ModelRegistry()
        reg.register(name, model, input_shape=input_shape, dtype=dtype)
        if int8_degrade:
            reg.register(f"{name}.int8", model, input_shape=input_shape,
                         dtype=dtype, quantize_int8=True,
                         calibration_data=calibration_data)
        engines.append(ServingEngine(reg, recorder=Recorder(), **engine_kw))
    if int8_degrade:
        rs_kw.setdefault("degrade", {name: f"{name}.int8"})
    return ReplicaSet(engines, **rs_kw)


__all__ = ["ReplicaSet", "CanaryPublisher", "OverloadController",
           "CanaryRejectedError", "NoHealthyReplicaError",
           "PRIORITY_CLASSES", "build_replica_set"]
