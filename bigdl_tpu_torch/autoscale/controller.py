"""The actuator (≙ ``bigdl_tpu/autoscale/controller.py``): policy
decisions become replica-set and pool changes.

One :meth:`AutoscaleController.tick` is the whole closed loop:

  read signals → policy.decide → actuate → record.

Actuation composes existing seams:

  * **scale-up** claims one slot per new replica from the shared
    :class:`~bigdl_tpu_torch.fleet.DevicePool`, then admits the engine
    that ``engine_factory`` built through :meth:`ReplicaSet.add_replica`,
    so the newcomer is golden-probed into rotation, never trusted cold.
    When the pool has no free slot and a ``donor`` (a co-scheduled
    training job's pool owner) is configured, the controller *borrows*:
    ``pool.transfer(donor → claimant)`` shrinks the trainer's capacity,
    which its ElasticSupervisor observes through ``capacity_fn`` at its
    next planning poll; a transfer below the donor's holding raises
    :class:`~bigdl_tpu_torch.fleet.PoolExhaustedError`, counted as
    ``autoscale/blocked``.
  * **scale-down** retires the highest-index live replica through
    :meth:`ReplicaSet.decommission` (drain first, terminal), deregisters
    it from the
    :class:`~bigdl_tpu_torch.observability.aggregate.MetricsAggregator`
    (``remove_member``: scaled away is not crashed), and returns its
    slot: borrowed capacity goes back to the donor first, owned capacity
    frees into the pool.

Every decision lands in the replica set's recorder: ``autoscale/*``
counters and gauges and one ``autoscale_event`` record per actuation
(kind ``scale_up`` / ``scale_down`` / ``blocked``).  :meth:`start` ticks
on a daemon thread that :meth:`stop` joins with a time-out.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from .policy import AutoscalePolicy, ScaleDecision
from .signals import Signals, read_signals
from ..observability import tracing as trace_spine
from ..observability.context import TraceContext


class AutoscaleController:
    """Close the loop between telemetry and the decode replica set."""

    def __init__(self, replica_set, engine_factory: Callable[[], Any],
                 policy: Optional[AutoscalePolicy] = None, *,
                 pool=None, claimant: str = "serve",
                 donor: Optional[str] = None, donor_take: str = "head",
                 slo_engine=None, store=None, aggregator=None,
                 member_name: str = "serve", warm: bool = True,
                 clock=time.monotonic):
        self.replica_set = replica_set
        self.engine_factory = engine_factory
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.pool = pool
        self.claimant = str(claimant)
        self.donor = donor
        self.donor_take = donor_take
        self.slo_engine = slo_engine
        self.store = store if store is not None else (
            aggregator.store if aggregator is not None
            else slo_engine.store if slo_engine is not None else None)
        self.aggregator = aggregator
        self.member_name = str(member_name)
        self.warm = bool(warm)
        self.clock = clock
        self.recorder = replica_set.recorder
        self._lock = threading.Lock()
        #: devices this controller claimed, newest last; the subset in
        #: ``_borrowed`` came from the donor and goes back there first
        self._devices: List[Any] = []
        self._borrowed: List[Any] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- observation -------------------------------------------------------- #
    def live_replicas(self) -> int:
        """Capacity the policy reasons over: every non-terminal
        replica, INCLUDING probe-pending joiners — a half-joined
        replica is capacity in flight, and counting it prevents the
        loop from double-scaling while a probe is outstanding."""
        from ..serving.replicas import TERMINAL_REASONS
        return sum(
            1 for h in self.replica_set.health().values()
            if not (h["state"] == "ejected"
                    and h["reason"] in TERMINAL_REASONS))

    def signals(self) -> Signals:
        if self.slo_engine is not None \
                and self.slo_engine._thread is None:
            # nobody else is evaluating (no background SLO loop):
            # refresh the cached verdicts so the policy reads live burn
            self.slo_engine.evaluate()
        return read_signals(self.slo_engine, self.store,
                            self.replica_set)

    # -- the loop ----------------------------------------------------------- #
    def tick(self, now: Optional[float] = None) -> ScaleDecision:
        """One control-loop pass; serialized so a background loop and
        a manual tick can never actuate concurrently."""
        with self._lock:
            if now is None:
                now = float(self.clock())
            sig = self.signals()
            n = self.live_replicas()
            decision = self.policy.decide(sig, n, now)
            rec = self.recorder
            rec.gauge("autoscale/replicas", n)
            if sig.occupancy is not None:
                rec.gauge("autoscale/occupancy", sig.occupancy)
            if sig.queue_depth is not None:
                rec.gauge("autoscale/queue_depth", sig.queue_depth)
            if sig.burn_fast is not None:
                rec.gauge("autoscale/burn_fast", sig.burn_fast)
            ctx = span = None
            if decision.direction in ("up", "down"):
                # one trace per actuating decision.  Its children are
                # the slo.sample evidence events (backward edge: the
                # exact samples that triggered it) and the pool
                # claim/transfer spans (forward edge: the capacity it
                # moved); the displaced trainer's replan links back to
                # this ctx through the pool's actuation note.
                tracer = trace_spine.get_tracer()
                ctx = TraceContext.new_root()
                span = tracer.begin(
                    f"autoscale.{decision.direction}", ctx, child=False,
                    subsystem="autoscale")
                for ev in decision.evidence:
                    tracer.event("slo.sample", ctx,
                                 subsystem="autoscale",
                                 kind=ev.get("kind"),
                                 series=ev.get("series"),
                                 sample_t=ev.get("t"),
                                 value=ev.get("value"))
            if decision.direction == "up":
                from ..observability.goodput import ledger_phase
                with ledger_phase(rec, "autoscale_transfer"):
                    applied = self._scale_up_locked(decision, n, ctx)
                if applied:
                    self.policy.mark_scaled("up", now)
            elif decision.direction == "down":
                from ..observability.goodput import ledger_phase
                with ledger_phase(rec, "autoscale_transfer"):
                    applied = self._scale_down_locked(decision, n, ctx)
                if applied:
                    self.policy.mark_scaled("down", now)
            else:
                rec.inc("autoscale/holds")
            if span is not None:
                span.end(reason=decision.reason, delta=decision.delta,
                         applied=applied)
            return decision

    def _emit(self, kind: str, decision: ScaleDecision, n_before: int,
              n_after: int, **extra):
        self.recorder.emit_record(
            "autoscale_event", kind=kind, reason=decision.reason,
            replicas_before=n_before, replicas_after=n_after,
            signals=decision.signals.as_dict(), **extra)

    # -- actuation ---------------------------------------------------------- #
    def _acquire_device_locked(self, ctx=None):
        """One device for a new replica: free pool first, then borrow
        from the donor (shrinking the trainer).  Raises
        :class:`~bigdl_tpu.fleet.PoolExhaustedError` when neither can
        give."""
        from ..fleet.pool import PoolExhaustedError
        if self.pool is None:
            return None
        try:
            dev = self.pool.claim(self.claimant, 1, trace_ctx=ctx)[0]
        except PoolExhaustedError:
            if self.donor is None:
                raise
            dev = self.pool.transfer(self.donor, self.claimant, 1,
                                     take=self.donor_take,
                                     trace_ctx=ctx)[0]
            self._borrowed.append(dev)
        self._devices.append(dev)
        return dev

    def _release_device_locked(self, ctx=None):
        """Return one device after a scale-down: borrowed capacity
        transfers back to the donor (the trainer regrows at its next
        capacity poll), owned capacity frees into the pool."""
        if self.pool is None or not self._devices:
            return None
        dev = self._devices.pop()
        if self._borrowed:
            self._borrowed.pop()
            moved = self.pool.transfer(self.claimant, self.donor, 1,
                                       take="tail", trace_ctx=ctx)
            return moved[0] if moved else dev
        freed = self.pool.release(self.claimant, [dev], trace_ctx=ctx)
        return freed[0] if freed else dev

    def _scale_up_locked(self, decision: ScaleDecision,
                         n_before: int, ctx=None) -> int:
        from ..fleet.pool import PoolExhaustedError
        rec = self.recorder
        applied = 0
        for _ in range(decision.delta):
            try:
                dev = self._acquire_device_locked(ctx)
            except PoolExhaustedError as e:
                rec.inc("autoscale/blocked")
                self._emit("blocked", decision, n_before + applied,
                           n_before + applied, error=str(e))
                break
            engine = self.engine_factory()
            idx = self.replica_set.add_replica(engine, warm=self.warm)
            if self.aggregator is not None:
                self.aggregator.add_recorder(
                    f"{self.member_name}.replica{idx}", engine.recorder)
            applied += 1
            rec.inc("autoscale/scale_ups")
            self._emit("scale_up", decision, n_before + applied - 1,
                       n_before + applied, replica=idx,
                       device=repr(dev), borrowed=bool(
                           self._borrowed and
                           self._borrowed[-1] is dev),
                       trace_id=None if ctx is None else ctx.trace_id)
        return applied

    def _scale_down_locked(self, decision: ScaleDecision,
                           n_before: int, ctx=None) -> int:
        from ..serving.replicas import TERMINAL_REASONS
        rec = self.recorder
        applied = 0
        for _ in range(decision.delta):
            victim = None
            for idx in sorted(self.replica_set.health(), reverse=True):
                h = self.replica_set.health()[idx]
                if not (h["state"] == "ejected"
                        and h["reason"] in TERMINAL_REASONS):
                    victim = idx
                    break
            if victim is None:
                break
            try:
                self.replica_set.decommission(victim, drain=True)
            except ValueError:
                break               # last routable replica: keep it
            if self.aggregator is not None:
                self.aggregator.remove_member(
                    f"{self.member_name}.replica{victim}")
            dev = self._release_device_locked(ctx)
            applied += 1
            rec.inc("autoscale/scale_downs")
            self._emit("scale_down", decision, n_before - applied + 1,
                       n_before - applied, replica=victim,
                       device=repr(dev),
                       trace_id=None if ctx is None else ctx.trace_id)
        return applied

    # -- background loop ---------------------------------------------------- #
    def start(self, interval: float = 2.0) -> "AutoscaleController":
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:
                    pass    # the control loop must never kill serving

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscale")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
