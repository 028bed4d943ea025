"""Multi-job scheduling on one shared device pool (≙
``bigdl_tpu/fleet/pool.py``).

Production clusters run *many* jobs on shared capacity, where the
dominant failure mode is contention, not hardware loss: a job loses
devices to a higher-priority arrival, gets moved, gets them back.  The
pool-level control plane over the existing seams:

  :class:`DevicePool`       per-slot ownership ledger: which job holds
                            which slot, what is free
  :func:`plan_fleet`        fair-share gang planner: disjoint
                            :func:`~bigdl_tpu_torch.elastic.plan.plan_mesh`
                            plans for N jobs, priority tiers, every job's
                            ``min_axes`` floor reserved up front
  :class:`FleetScheduler`   admits jobs, places them, and keeps every one
                            alive through contention

Each job is a normal :class:`~bigdl_tpu_torch.elastic.ElasticSupervisor`
whose ``capacity_fn`` reads its pool assignment.  A re-plan just updates
the assignment; the supervisor notices at its next capacity poll and
takes the drain → commit → replan → resume path it already knows: a
shrink when it lost slots, a displacement when it was moved, a regrow
when capacity returned.  **A job whose ``min_axes`` floor fits surviving
capacity is never killed by a fleet decision**: admission reserves every
job's floor, so planning can always shrink instead of evict (an arrival
whose own floor does not fit is *rejected*; the running jobs are
untouched).

What the port does its own way:

  * **A pool's devices are slots.**  A slot is an int or a
    ``"cuda:<i>"`` string; a job's capacity is the list of slots it
    holds, and its supervisor starts one rank process a slot of its
    plan (gloo ranks on the CPU, NCCL ranks on ``cuda:<slot %
    device_count>`` on the card).  One card is a pool of one slot: the
    same card is never listed twice, since NCCL refuses two ranks on
    one GPU.  ``DevicePool()`` with no devices lists the card's slots
    (``range(torch.cuda.device_count())``).
  * **A gang job's floor guards its slots.**  The scheduler sets each
    job's ``min_axes`` floor on the pool (:meth:`DevicePool.set_floor`),
    a :meth:`DevicePool.transfer` that would take a job below it raises
    :class:`PoolExhaustedError`, and a job's capacity leaves out the
    slots a transfer moved away, so a borrowing autoscaler shrinks the
    job at its next capacity poll (the reference's transfer knows no
    floor and leaves the job's assignment as it was).
  * **A slot changes hands only once its holder has left it.**  A job
    placed on a slot that another job's ranks still run on (a shrink or
    a displacement not drained yet) waits in its capacity read until
    that job's segment is gone
    (:attr:`~bigdl_tpu_torch.elastic.ElasticSupervisor.slots_in_use`),
    at most :data:`HANDOFF_TIMEOUT_S` seconds.
  * **A fleet job is the port's ElasticSupervisor**, whose segments are
    forkserver rank processes, so ``trainer_factory`` must be a
    module-level function; a job's ``kernel_launches`` are its
    supervisor's.
  * **The shared compile cache** (:func:`enable_shared_compile_cache`,
    ``FleetScheduler(compile_cache_dir=)``) is the hand kernels' build
    directory (``ops/_build.BUILD_DIR``), which every rank of every
    segment loads its built libraries from: a re-placed job's ranks load
    the ``.so`` files instead of running ``nvcc`` again.  The port has no
    XLA programs to cache.

SIGTERM fans out: the scheduler (main thread) owns the process-level
hook through :class:`~bigdl_tpu_torch.checkpoint.PreemptionHandler`'s
shared dispatcher, so every job supervisor, running on a worker thread
that could never install its own OS handler, still drains and commits
on one real signal, and the scheduler then stops the pool.  Every wait
(``wait``, ``shutdown``) has a time-out.

Faults: ``fleet.place`` fires on every placement computation and
``fleet.preempt`` on every preemption delivery (both retried through
:class:`~bigdl_tpu_torch.utils.retry.RetryPolicy`, name ``fleet``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import faults as faultplane
from ..elastic.plan import _axis_candidates, _prod, plan_mesh
from ..observability import tracing as trace_spine
from ..observability.recorder import Recorder
from ..utils.retry import RetryPolicy


#: the longest a job waits for a slot's previous holder to leave it (a
#: drain that commits a checkpoint first)
HANDOFF_TIMEOUT_S = 300.0


class FleetAdmissionError(RuntimeError):
    """The pool cannot reserve the new job's ``min_axes`` floor without
    breaking a running job's — the arrival is rejected; nothing already
    admitted is disturbed."""


def min_plan(template: Dict[str, int],
             min_axes: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The smallest legal mesh for a job: per axis, the smallest
    divisor of the template size that meets the ``min_axes`` floor.
    Its device count is what admission must reserve."""
    floors = {str(k): int(v) for k, v in (min_axes or {}).items()}
    axes = {str(k): int(v) for k, v in template.items()}
    return {k: min(c) for k, c in _axis_candidates(axes, floors).items()}


def plan_fleet(n_devices: int,
               jobs: Sequence[Tuple[str, Dict[str, int],
                                    Optional[Dict[str, int]], int]]
               ) -> Dict[str, Dict[str, int]]:
    """Disjoint mesh plans for every job on an ``n_devices`` pool.

    ``jobs`` is the admit-ordered sequence of
    ``(name, template, min_axes, priority)``.  The contract:

      * every job's ``min_axes`` floor is reserved before anything
        grows — raises ``ValueError`` when the floors themselves don't
        fit (the admission gate);
      * higher priority plans first; within a priority tier the
        available devices split evenly (each job still floored), so
        two equal jobs that both fit only at reduced size shrink the
        same way — and each shrink follows ``plan_mesh``'s own
        tie-break (``dp`` first, model-entangled axes last);
      * a final growth pass hands divisor-rounding leftovers to jobs
        in priority order, so the plan wastes as little of the pool as
        the divisor lattice allows.
    """
    specs = [(str(name), {str(k): int(v) for k, v in template.items()},
              dict(min_axes or {}), int(priority))
             for name, template, min_axes, priority in jobs]
    if not specs:
        return {}
    names = [s[0] for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate job names in {names}")
    order = sorted(range(len(specs)),
                   key=lambda i: (-specs[i][3], i))
    floors = {name: _prod(min_plan(t, m)) for name, t, m, _ in specs}
    total_floor = sum(floors.values())
    if total_floor > n_devices:
        raise ValueError(
            f"floors need {total_floor} devices, pool has {n_devices}: "
            + ", ".join(f"{n}≥{floors[n]}" for n in names))

    plans: Dict[str, Dict[str, int]] = {}
    remaining = n_devices
    i = 0
    while i < len(order):
        prio = specs[order[i]][3]
        tier = []
        while i < len(order) and specs[order[i]][3] == prio:
            tier.append(order[i])
            i += 1
        later_floor = sum(floors[specs[j][0]] for j in order[i:])
        tier_avail = remaining - later_floor
        avail = tier_avail
        share0 = tier_avail // len(tier)
        for idx, j in enumerate(tier):
            name, t, m, _ = specs[j]
            rest_floor = sum(floors[specs[k][0]] for k in tier[idx + 1:])
            # even split of the tier's budget (FIXED share: a later job
            # must not absorb earlier jobs' divisor-rounding slack —
            # the growth pass hands that out in priority order), never
            # below this job's own floor, never eating a floor
            share = max(floors[name], share0)
            budget = min(share, avail - rest_floor)
            axes = plan_mesh(budget, t, m)
            plans[name] = axes
            avail -= _prod(axes)
        # the tier consumed its WHOLE entitlement, not just what the
        # divisor lattice let it use: rounding slack must reach the
        # growth pass (priority order), never a lower tier's budget —
        # what remains for later tiers is exactly their floor reserve
        remaining -= tier_avail

    # growth pass: divisor plans round down, so devices can be left
    # over even when a higher-priority job could legally use them
    leftover = n_devices - sum(_prod(p) for p in plans.values())
    for j in order:
        if leftover <= 0:
            break
        name, t, m, _ = specs[j]
        bigger = plan_mesh(_prod(plans[name]) + leftover, t, m)
        if _prod(bigger) > _prod(plans[name]):
            leftover -= _prod(bigger) - _prod(plans[name])
            plans[name] = bigger
    return plans


def enable_shared_compile_cache(path: str) -> str:
    """Point the hand kernels' build directory (``ops/_build.BUILD_DIR``)
    at ``path`` (created if missing): the fleet's warm-start seam.  The
    elastic supervisor hands its build directory to every rank it starts,
    so a re-placed job's ranks (or any job's on the same card type) load
    the libraries already built there instead of running ``nvcc`` again;
    a library's name carries the hash of its sources and flags, so a
    changed kernel is still rebuilt."""
    import os
    from pathlib import Path

    from ..ops import _build
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path).resolve()
    return str(_build.BUILD_DIR)


class PoolExhaustedError(RuntimeError):
    """A claim asked for more devices than the pool can give — the
    loud rejection in an autoscaler/gang-planner race: exactly one
    contender gets the last free device, the loser gets this (and no
    partial gang)."""


class DevicePool:
    """Per-device ownership ledger for one shared pool.

    Bookkeeping only: it never touches a device.  Two writer
    disciplines share the ledger under one internal lock:

      * the **gang planner** (:class:`FleetScheduler`) swaps whole
        assignments with :meth:`reassign` over the *schedulable*
        devices, so disjointness stays an invariant, not a hope;
      * **incremental claimants** (the autoscale controller) take and
        return devices one claim at a time with :meth:`claim` /
        :meth:`release` / :meth:`transfer`.  Claimed devices leave the
        schedulable set, so a fleet replan can never hand a decode
        replica's device to a training job.

    A race for the last free device has exactly one winner; the loser
    gets :class:`PoolExhaustedError`, never a double-owned device.
    ``release`` is idempotent — a retried drain path is safe."""

    def __init__(self, devices=None):
        if devices is None:
            import torch
            devices = list(range(torch.cuda.device_count()))
            if not devices:
                raise RuntimeError(
                    "DevicePool() lists the card's slots and found no "
                    "CUDA device; pass devices= (gloo ranks on the CPU)")
        self.devices = list(devices)
        if len(set(self.devices)) != len(self.devices):
            raise ValueError(f"a slot is listed twice in {self.devices}")
        self._lock = threading.RLock()
        self._owner: Dict[Any, Optional[str]] = {d: None
                                                 for d in self.devices}
        self._claims: set = set()       # owners registered via claim()
        # owner -> slots a transfer may never take it below (the fleet
        # scheduler's gang jobs: their min_axes floor)
        self._floors: Dict[str, int] = {}
        # device-second ownership accounting: a device claimed by
        # NOBODY is pool idle — a capacity question for the fleet
        # roll-up, never any job's badput (observability.goodput)
        from ..observability.goodput import OwnershipLedger
        self.goodput = OwnershipLedger(len(self.devices))

    def _note_occupancy_locked(self):
        # caller holds self._lock; the ownership ledger has its own
        # lock (pool-lock -> ledger-lock, never the reverse)
        claimed = sum(1 for o in self._owner.values() if o is not None)
        self.goodput.note(claimed, len(self.devices))

    def set_floor(self, name: str, n: Optional[int]) -> None:
        """Keep at least ``n`` slots with ``name`` through
        :meth:`transfer` (``None`` or 0 removes the floor).  The
        scheduler sets each gang job's ``min_axes`` floor, so a borrowing
        autoscaler can never take a training job below it."""
        with self._lock:
            if n:
                self._floors[str(name)] = int(n)
            else:
                self._floors.pop(str(name), None)

    @property
    def size(self) -> int:
        return len(self.devices)

    def owner_of(self, device) -> Optional[str]:
        with self._lock:
            return self._owner.get(device)

    def owned_by(self, name: str) -> list:
        with self._lock:
            return [d for d in self.devices if self._owner[d] == name]

    def free(self) -> list:
        with self._lock:
            return [d for d in self.devices if self._owner[d] is None]

    def schedulable(self) -> list:
        """Devices the gang planner may assign: everything not held by
        an incremental claimant (:meth:`claim`/:meth:`transfer`)."""
        with self._lock:
            return [d for d in self.devices
                    if self._owner[d] is None
                    or self._owner[d] not in self._claims]

    def claim(self, name: str, n: int = 1, trace_ctx=None) -> list:
        """Atomically take ``n`` free devices for ``name`` (pool
        order).  Raises :class:`PoolExhaustedError` — taking nothing —
        when fewer than ``n`` are free: the loser of a last-device
        race is told loudly instead of getting a partial gang.

        ``trace_ctx`` records the ledger move as a ``pool.claim`` span
        under the caller's trace (an autoscale decision, a placement)
        and notes the claimant's actuation context so its supervisor
        can link the resulting transition back to the cause."""
        n = int(n)
        if n <= 0:
            raise ValueError("claim needs n >= 1")
        with self._lock:
            free = [d for d in self.devices if self._owner[d] is None]
            if len(free) < n:
                raise PoolExhaustedError(
                    f"{name!r} asked for {n} device(s), only "
                    f"{len(free)} free in a pool of {self.size}")
            took = free[:n]
            for d in took:
                self._owner[d] = name
            self._claims.add(str(name))
            self._note_occupancy_locked()
        # span + actuation note OUTSIDE the ledger lock: tracing must
        # never extend the pool's critical section
        self._trace_move("pool.claim", trace_ctx, owners=(name,),
                         n=n, devices=took)
        return took

    def _trace_move(self, op: str, ctx, owners: Tuple[str, ...],
                    n: int, devices: Sequence):
        if ctx is None:
            return
        trace_spine.get_tracer().event(
            op, ctx, subsystem="fleet", owners=list(owners), n=int(n),
            devices=[repr(d) for d in devices])
        for owner in owners:
            trace_spine.note_actuation(owner, ctx)

    def transfer(self, src: str, dst: str, n: int = 1,
                 take: str = "tail", trace_ctx=None) -> list:
        """Atomically move ``n`` of ``src``'s devices to ``dst`` — the
        elastic-yield move (a training job shedding capacity to the
        serving tier at a traffic peak, and taking it back at the
        trough).  ``take`` picks which end of ``src``'s holding moves:
        ``"tail"`` (default) sheds spare/highest devices first;
        ``"head"`` forces the victim's in-use prefix out, displacing
        its mesh — the adversarial arrangement a rescale smoke uses to
        prove the drain/relayout path.  Raises
        :class:`PoolExhaustedError` when ``src`` holds fewer than
        ``n``, or when the move would take it below its floor
        (:meth:`set_floor`; the port's own: a fleet job's slots read
        through :meth:`FleetJob.capacity`, so a borrow shrinks that job
        at its next capacity poll and must respect its floor)."""
        n = int(n)
        if n <= 0:
            raise ValueError("transfer needs n >= 1")
        with self._lock:
            held = [d for d in self.devices if self._owner[d] == src]
            if len(held) < n:
                raise PoolExhaustedError(
                    f"{src!r} holds {len(held)} device(s), cannot "
                    f"yield {n}")
            floor = self._floors.get(str(src), 0)
            if len(held) - n < floor:
                raise PoolExhaustedError(
                    f"{src!r} holds {len(held)} device(s) with a floor "
                    f"of {floor}, cannot yield {n}")
            moved = held[:n] if take == "head" else held[-n:]
            for d in moved:
                self._owner[d] = dst
            self._claims.add(str(dst))
            if not any(o == src for o in self._owner.values()):
                self._claims.discard(str(src))
            self._note_occupancy_locked()
        self._trace_move("pool.transfer", trace_ctx, owners=(src, dst),
                         n=n, devices=moved)
        return moved

    def reassign(self, assignment: Dict[str, Sequence]) -> None:
        """Replace the gang-planned share of the ownership map with
        ``assignment`` (job → devices).  Rejects devices outside the
        pool and any device assigned to two jobs — the gang-placement
        invariant.  Devices held by incremental claimants are
        preserved as-is and may NOT appear in the assignment (the
        planner must plan over :meth:`schedulable`)."""
        with self._lock:
            kept = {d: o for d, o in self._owner.items()
                    if o in self._claims}
            owner: Dict[Any, Optional[str]] = {d: kept.get(d)
                                               for d in self.devices}
            for name, devs in assignment.items():
                if name in self._claims:
                    raise ValueError(
                        f"{name!r} is an incremental claimant; the "
                        "gang planner may not reassign it")
                for d in devs:
                    if d not in owner:
                        raise ValueError(f"{name!r} assigned a device "
                                         "outside the pool")
                    if owner[d] is not None:
                        raise ValueError(
                            f"device {d} assigned to both "
                            f"{owner[d]!r} and {name!r}")
                    owner[d] = name
            self._owner = owner
            self._note_occupancy_locked()

    def release(self, name: str, devices: Optional[Sequence] = None,
                trace_ctx=None) -> list:
        """Return ``devices`` (default: everything ``name`` holds) to
        the free pool; returns what was actually freed.  Idempotent:
        releasing devices the owner no longer holds — or holding
        nothing at all — is a no-op, so drain paths can retry safely."""
        with self._lock:
            if devices is None:
                victims = [d for d in self.devices
                           if self._owner[d] == name]
            else:
                victims = [d for d in devices
                           if self._owner.get(d) == name]
            for d in victims:
                self._owner[d] = None
            if not any(o == name for o in self._owner.values()):
                self._claims.discard(str(name))
            self._note_occupancy_locked()
        if victims:
            self._trace_move("pool.release", trace_ctx, owners=(name,),
                             n=len(victims), devices=victims)
        return victims


class FleetJob:
    """One admitted job: its spec, its supervisor, and its live pool
    assignment (read through :meth:`capacity` — the supervisor's
    ``capacity_fn`` seam)."""

    def __init__(self, scheduler: "FleetScheduler", name: str,
                 template: Dict[str, int],
                 min_axes: Optional[Dict[str, int]], priority: int,
                 steps: int, batch_fn: Callable, seq: int, recorder):
        self._scheduler = scheduler
        self.name = name
        self.template = {str(k): int(v) for k, v in template.items()}
        self.min_axes = dict(min_axes or {})
        self.priority = int(priority)
        self.steps = int(steps)
        self.batch_fn = batch_fn
        self.seq = int(seq)
        self.recorder = recorder
        self.supervisor = None
        self.thread: Optional[threading.Thread] = None
        self.state = "admitted"
        self.devices: list = []
        self.result = None
        self.error: Optional[BaseException] = None

    def capacity(self) -> list:
        """The job's current device assignment (the supervisor polls
        this every ``replan_every`` steps and at segment boundaries —
        preemption/regrow/displacement delivery is this read).  Slots
        of the assignment that the pool moved to another owner
        (:meth:`DevicePool.transfer`: a borrowing autoscaler) are left
        out until they come back.  A slot whose previous holder's
        ranks still run on it (that job has not drained yet) is waited
        for, up to :data:`HANDOFF_TIMEOUT_S`: two ranks never
        share a slot (NCCL refuses two ranks on one GPU)."""
        sched = self._scheduler
        deadline = time.monotonic() + HANDOFF_TIMEOUT_S
        while True:
            with sched._lock:
                devices = list(self.devices)
                others = [j.supervisor for j in sched._jobs.values()
                          if j is not self and j.supervisor is not None]
            mine = [d for d in devices
                    if sched.pool.owner_of(d) == self.name]
            busy = {d for sup in others for d in sup.slots_in_use}
            held = sorted(set(mine) & busy, key=mine.index)
            if not held:
                return mine
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"job {self.name!r}: slot(s) {held} still run another "
                    f"job's ranks after {HANDOFF_TIMEOUT_S:g}s")
            time.sleep(0.02)

    def alive(self) -> bool:
        t = self.thread
        return t is not None and t.is_alive()


class FleetScheduler:
    """Gang-place N :class:`ElasticSupervisor` jobs onto disjoint
    sub-meshes of one :class:`DevicePool` and keep every one alive
    through contention.

    Quickstart::

        fleet = FleetScheduler([0, 1, 2, 3], recorder=rec)
        fleet.admit("prod", factory, {"dp": 2}, priority=1,
                    steps=10_000, batch_fn=batches,
                    ckpt_dir="/ckpt/prod")
        fleet.admit("batch", factory, {"dp": 4}, min_axes={"dp": 1},
                    steps=50_000, batch_fn=batches2,
                    ckpt_dir="/ckpt/batch")
        fleet.serve_metrics(9100)          # aggregated /metrics+/healthz
        results = fleet.run()              # start + wait
    """

    def __init__(self, devices=None, *, recorder=None,
                 compile_cache_dir: Optional[str] = None,
                 replan_every: int = 2, handle_sigterm: bool = True):
        self.pool = DevicePool(devices)
        # no recorder given: a disabled one, as the reference's
        # null_recorder()
        self._recorder = recorder if recorder is not None \
            else Recorder(enabled=False)
        self.replan_every = int(replan_every)
        self.handle_sigterm = bool(handle_sigterm)
        self.compile_cache_dir = None
        if compile_cache_dir is not None:
            self.compile_cache_dir = \
                enable_shared_compile_cache(compile_cache_dir)
        # guards _jobs / assignments / job state / lifecycle flags —
        # nothing slow (planning is arithmetic) ever runs under it
        self._lock = threading.Lock()
        self._jobs: Dict[str, FleetJob] = {}
        self._seq = 0
        self._started = False
        self._sigterm_seen = False
        self._preemption = None
        self._http = None
        # the control-plane fault/retry seam: placement computation and
        # preemption delivery both go through the plane and the unified
        # retry policy, so "the scheduler survives a flaky control
        # plane" is assertable like every other transient claim
        self._place_retry = RetryPolicy(max_attempts=4, base=0.01,
                                        max_delay=0.5, name="fleet",
                                        recorder_fn=self._rec)

    # ------------------------------------------------------------------ #
    def _rec(self):
        return self._recorder

    def _fleet_event(self, kind: str, job: Optional[FleetJob] = None,
                     **fields):
        """One fleet transition.  The ``fleet_event`` RECORD lands on
        the scheduler's recorder only (one stream = one timeline — the
        ``trace_summary fleet`` view merges job streams, so mirroring
        records would double every row); the COUNTER is mirrored onto
        the job's recorder so the aggregated /metrics shows
        per-job-labeled ``fleet/*`` series."""
        if job is not None:
            fields.setdefault("job", job.name)
            if job.recorder is not None:
                job.recorder.inc(f"fleet/{kind}")
        rec = self._rec()
        rec.inc(f"fleet/{kind}")
        rec.emit_record("fleet_event", kind=kind, **fields)

    # -- admission ------------------------------------------------------ #
    def admit(self, name: str, trainer_factory, template: Dict[str, int],
              *, steps: int, batch_fn: Callable, ckpt_dir: str,
              min_axes: Optional[Dict[str, int]] = None,
              priority: int = 0, recorder=None, ckpt_every: int = 50,
              replan_every: Optional[int] = None,
              **supervisor_kwargs) -> FleetJob:
        """Admit a job: reserve its ``min_axes`` floor, build its
        supervisor, re-plan the pool (which may shrink or displace
        lower-priority jobs — never kill them), and start it if the
        scheduler is running.

        Raises :class:`FleetAdmissionError` when the new job's floor
        cannot fit without breaking a running job's — the pool's
        standing jobs always win over an arrival."""
        if recorder is None:
            from ..observability import Recorder
            recorder = Recorder()
        with self._lock:
            if name in self._jobs:
                raise ValueError(f"job {name!r} already admitted")
            job = FleetJob(self, str(name), template, min_axes,
                           priority, steps, batch_fn, self._seq, recorder)
            self._seq += 1
            specs = self._specs_locked() + [
                (job.name, job.template, job.min_axes, job.priority)]
            try:
                plan_fleet(len(self.pool.schedulable()), specs)
            except ValueError as e:
                reject_reason = str(e)
            else:
                reject_reason = None
                self._jobs[name] = job
                self.pool.set_floor(job.name, _prod(min_plan(
                    job.template, job.min_axes)))
        if reject_reason is not None:
            # a full fleet_event, not a bare counter: rejections must
            # show up in the trace_summary fleet timeline too
            self._fleet_event("rejected", job, reason=reject_reason)
            raise FleetAdmissionError(
                f"cannot admit {name!r}: {reject_reason}") from None
        from ..elastic import ElasticSupervisor
        job.supervisor = ElasticSupervisor(
            trainer_factory, ckpt_dir, job.template,
            capacity_fn=job.capacity, recorder=recorder,
            ckpt_every=ckpt_every, min_axes=job.min_axes,
            replan_every=self.replan_every if replan_every is None
            else int(replan_every),
            name=job.name, **supervisor_kwargs)
        self._fleet_event("admitted", job, priority=job.priority,
                          template=job.template, min_axes=job.min_axes)
        self._replan("admit")
        if self._http is not None:
            self._register_job_http(job)
        started = False
        with self._lock:
            if self._started:
                started = True
        if started:
            self._start_job(job)
        return job

    def _specs_locked(self) -> List[Tuple]:
        """Planning specs for jobs still holding capacity, admit order.
        (``*_locked``: caller holds ``self._lock``.)"""
        live = [j for j in self._jobs.values()
                if j.state in ("admitted", "running")]
        live.sort(key=lambda j: j.seq)
        return [(j.name, j.template, j.min_axes, j.priority)
                for j in live]

    # -- planning / placement ------------------------------------------- #
    def _replan(self, reason: str):
        """Re-plan the whole pool and apply the new assignment; emits
        preempt/displace/regrow events for every job whose assignment
        changed.  ``fleet.place`` fires (and is retried) here — the
        control-plane placement call."""
        try:
            self._place_retry.run(faultplane.inject, "fleet.place",
                                  self._rec())
        except Exception as e:
            # the plan itself is pure arithmetic and delivery is a pull:
            # a control plane that keeps failing past the retry budget
            # is counted and logged, never a reason to strand the pool
            # on a stale assignment — an admit would otherwise leave a
            # half-admitted zero-device job, and a job_done replan
            # would die in its worker thread and survivors never regrow
            self._rec().inc("fleet/place_giveups")
            print(f"[fleet] placement injection kept failing ({e!r}); "
                  f"applying the plan anyway ({reason})", flush=True)
        with self._lock:
            changes = self._apply_plan_locked()
        for job, kind, detail in changes:
            if kind == "preempted":
                # delivering the shrink to the job's capacity seam is
                # the fleet.preempt site; in-process delivery is a
                # pull (the supervisor polls capacity()), so a
                # persistently failing inject is counted and logged,
                # never a reason to evict the job instead
                try:
                    self._place_retry.run(faultplane.inject,
                                          "fleet.preempt", job.recorder)
                except Exception as e:
                    self._rec().inc("fleet/preempt_giveups")
                    print(f"[fleet] preempt delivery to {job.name!r} "
                          f"kept failing ({e!r}); assignment stands — "
                          "the job reads it at its next capacity poll",
                          flush=True)
            self._fleet_event(kind, job, reason=reason, **detail)
            print(f"[fleet] {kind}: job={job.name} {detail} "
                  f"({reason})", flush=True)

    def _apply_plan_locked(self) -> List[Tuple[FleetJob, str, dict]]:
        """Compute the fair-share plan over live jobs, swap the pool's
        ownership map, update every job's assignment, and return the
        (job, transition, detail) changes for event emission OUTSIDE
        the lock."""
        specs = self._specs_locked()
        if not specs:
            self.pool.reassign({})
            return []
        order = sorted(specs, key=lambda s: (-s[3],
                                             self._jobs[s[0]].seq))
        # plan over the SCHEDULABLE share only: devices an incremental
        # claimant (the autoscale controller) holds are not the gang
        # planner's to hand out, and reassign() enforces that loudly.
        # A claim can land BETWEEN the schedulable() snapshot and the
        # reassign — the planner loses that race gracefully by
        # replanning over the shrunken share (bounded: each retry is
        # caused by a real concurrent claim)
        for attempt in range(8):
            schedulable = self.pool.schedulable()
            plans = plan_fleet(len(schedulable), specs)
            # placement, canonical (priority, admit) order: a job KEEPS
            # its current devices when its size is unchanged and no
            # higher-priority job claimed them this round (no churn on
            # a neighbor's completion); otherwise it takes the first
            # unclaimed devices in pool order — so a high-priority
            # arrival claims the pool prefix and displaces whoever
            # held it
            assignment: Dict[str, list] = {}
            claimed: set = set()
            for name, _t, _m, _p in order:
                n = _prod(plans[name])
                cur = self._jobs[name].devices
                if len(cur) == n and not (set(cur) & claimed) \
                        and all(d in schedulable for d in cur):
                    assignment[name] = list(cur)
                else:
                    free = [d for d in schedulable if d not in claimed]
                    assignment[name] = free[:n]
                claimed.update(assignment[name])
            try:
                self.pool.reassign(assignment)
                break
            except ValueError:
                if attempt == 7:
                    raise
                self._rec().inc("fleet/plan_races")
        changes: List[Tuple[FleetJob, str, dict]] = []
        for name, devs in assignment.items():
            job = self._jobs[name]
            old = job.devices
            job.devices = list(devs)
            detail = {"devices": len(devs), "axes": plans[name]}
            if not old:
                changes.append((job, "placed", detail))
            elif len(devs) < len(old):
                changes.append((job, "preempted",
                                {**detail, "from_devices": len(old)}))
            elif len(devs) > len(old):
                changes.append((job, "regrown",
                                {**detail, "from_devices": len(old)}))
            elif list(devs) != list(old):
                changes.append((job, "displaced", detail))
        return changes

    # -- lifecycle ------------------------------------------------------ #
    def _start_job(self, job: FleetJob):
        with self._lock:
            if job.thread is not None or job.supervisor is None:
                # admit() publishes the job before building its
                # supervisor (construction runs outside the lock); a
                # concurrent start() must not launch a supervisor-less
                # job — the admitting thread starts it itself once the
                # supervisor exists (it re-checks _started after)
                return
            job.state = "running"
            job.thread = threading.Thread(
                target=self._run_job, args=(job,), daemon=True,
                name=f"fleet:{job.name}")
        job.thread.start()

    def _run_job(self, job: FleetJob):
        try:
            result = job.supervisor.run(job.batch_fn, steps=job.steps)
            with self._lock:
                job.result = result
                job.state = "stopped" if job.supervisor._stop \
                    else "completed"
                state = job.state
            self._fleet_event(state, job, steps=len(result or []))
        except BaseException as e:   # noqa: BLE001 — recorded, re-raised to nobody
            with self._lock:
                job.error = e
                job.state = "failed"
            self._fleet_event("failed", job, error=repr(e))
            print(f"[fleet] job {job.name!r} failed: {e!r}", flush=True)
        finally:
            # survivors take over the freed capacity (regrow) — the
            # fair-share re-plan on completion/failure
            self.pool.set_floor(job.name, None)
            self._replan("job_done")

    def start(self) -> "FleetScheduler":
        """Install the process-level SIGTERM hook (main thread — the
        fan-out owner every worker-thread supervisor registers under)
        and start every admitted job."""
        with self._lock:
            if self.handle_sigterm and self._preemption is None:
                from ..checkpoint import PreemptionHandler
                self._preemption = PreemptionHandler().install()
            self._started = True
            pending = [j for j in self._jobs.values()
                       if j.state == "admitted"]
        for job in pending:
            self._start_job(job)
        return self

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until every job finished (or ``timeout`` elapsed);
        returns ``{name: per-step losses}``.  A SIGTERM during the wait
        fans out to every supervisor (each drains + commits a preempt
        checkpoint) and then stops the pool cleanly — the fleet-level
        preemption semantic."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                running = [j for j in self._jobs.values() if j.alive()]
                preemption = self._preemption
            if not running:
                break
            if preemption is not None and preemption.requested:
                announce = False
                with self._lock:
                    if not self._sigterm_seen:
                        self._sigterm_seen = True
                        announce = True
                if announce:
                    self._fleet_event("sigterm",
                                      jobs=[j.name for j in running])
                    print("[fleet] SIGTERM: every supervisor drains and "
                          "commits; stopping the pool", flush=True)
                    for j in running:
                        j.supervisor.stop()
            for j in running:
                j.thread.join(timeout=0.2)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    "fleet wait timed out with jobs still running: "
                    + ", ".join(j.name for j in running))
        with self._lock:
            return {name: j.result for name, j in self._jobs.items()}

    def run(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        self.start()
        return self.wait(timeout)

    def stop(self):
        """Ask every running job to commit a checkpoint and stop at its
        next step boundary."""
        with self._lock:
            jobs = [j for j in self._jobs.values() if j.alive()]
        for j in jobs:
            j.supervisor.stop()

    def job(self, name: str) -> FleetJob:
        with self._lock:
            return self._jobs[name]

    def jobs(self) -> Dict[str, FleetJob]:
        with self._lock:
            return dict(self._jobs)

    def shutdown(self):
        """Stop jobs, join their threads, stop the metrics server,
        release the SIGTERM hook."""
        self.stop()
        with self._lock:
            threads = [j.thread for j in self._jobs.values()
                       if j.thread is not None]
        for t in threads:
            t.join(timeout=30.0)
        http, self._http = self._http, None
        if http is not None:
            http.stop()
        with self._lock:
            preemption, self._preemption = self._preemption, None
        if preemption is not None:
            preemption.uninstall()

    # -- aggregated observability --------------------------------------- #
    def telemetry_sources(self):
        """``[(name, recorder), ...]``: the scheduler's ``fleet/*``
        recorder plus every admitted job's — the one-call aggregator
        attachment hook (``aggregator.add(scheduler, name="fleet")``)."""
        with self._lock:
            jobs = list(self._jobs.values())
        return [("scheduler", self._rec())] + \
            [(job.name, job.recorder) for job in jobs
             if job.recorder is not None]

    def goodput_doc(self) -> Dict[str, Any]:
        """Fleet-level device-second attribution: every job recorder's
        attached :class:`~bigdl_tpu.observability.goodput.GoodputLedger`
        snapshot rolled up with the pool's ownership ledger, so
        unclaimed device-seconds surface as POOL idle, not any job's
        badput.  Served at ``/goodput`` by :meth:`serve_metrics`."""
        from ..observability.goodput import rollup
        with self._lock:
            jobs = list(self._jobs.values())
        snaps = {}
        for job in jobs:
            rec = job.recorder
            led = rec.get_ledger() if rec is not None else None
            if led is not None:
                snaps[job.name] = led.snapshot()
        return rollup(snaps, self.pool.goodput.snapshot())

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """One aggregated introspection server over the whole pool:
        ``/metrics`` renders the scheduler's ``fleet/*`` counters
        unlabeled plus every job's recorder under a ``job=<name>``
        label, ``/healthz`` returns 503 iff ANY job's verdict is
        stalled or diverged (worst-of liveness), and ``/goodput`` the
        fleet attribution roll-up (:meth:`goodput_doc`)."""
        from ..observability.http import IntrospectionServer
        if self._http is not None:
            self._http.stop()
        srv = IntrospectionServer(self._rec(), port=port, host=host,
                                  goodput_source=self.goodput_doc)
        self._http = srv
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            self._register_job_http(job)
        srv.start()
        return srv

    def _register_job_http(self, job: FleetJob):
        # late-bound watchdog: the supervisor builds its stall watchdog
        # when (and if) its hang-abort arms — resolve per scrape
        self._http.add_job(
            job.name, job.recorder,
            watchdog=lambda j=job: getattr(j.supervisor, "watchdog",
                                           None))
