"""Elastic supervisor: shrink on preemption, regrow on capacity (≙
``bigdl_tpu/elastic/supervisor.py``).

A retry/backoff state machine that, instead of letting a preempted or
degraded job die,

  1. **drains** — finishes the in-flight async write and commits a final
     elastic (v2, mesh-recorded) checkpoint;
  2. **re-plans** — asks :func:`.plan.plan_mesh` for the largest mesh the
     *surviving* capacity supports (shrinking ``dp`` first);
  3. **resumes** — rebuilds the trainer on the new mesh and restores
     through the reshard path (``checkpoint/reshard.py``: global arrays
     are mesh-invariant, so a shrink is a re-layout, not a loss of
     progress);
  4. **regrows** — keeps polling capacity and, at a checkpoint boundary,
     scales back up the same way when ranks can be started again.

The reference rebuilds its trainer on a subset of one process's devices.
The port's mesh is a set of processes (``parallel/mesh.py``), so here a
*segment* — one mesh, from its build to its drain — runs as
``prod(axes)`` rank processes started for it (``multiprocessing``'s
forkserver): gloo on the CPU, NCCL on the card (rank ``r`` on ``cuda:<slot>``
of the planned slots).  This process keeps the reference's loop: it
reads capacity, calls ``batch_fn(step)`` and hands every rank the global
batch over a pipe, tells the ranks when to checkpoint, and collects the
losses at each checkpoint (whose copy syncs the host anyway) and when the
segment drains: no host sync of its own a step.  So
``trainer_factory(mesh)`` must be a module-level, picklable function
(each rank imports it), and ``capacity_fn()`` returns the number of
ranks that can be started (or a list of slots).

SIGTERM reaches this process (the ranks ignore it) and is forwarded as a
final checkpoint: the ranks commit ``preempt_step_<n>`` and exit, and the
loop re-plans.  A wedged segment (``hang_abort_grace=``: the
:class:`~bigdl_tpu_torch.observability.health.StallWatchdog` over this
process's step records, a step being the round trip to every rank) is
killed and replanned, where the reference raises into its training
thread: the escalation raises :class:`HangAbortError` asynchronously in
the loop thread, whose failure path kills the rank processes.

Every transition lands in the Recorder as ``elastic/*`` counters and
``elastic_event`` + ``health_event`` records; the ranks' own
``elastic/*`` counters and events (a reshard at restore) are forwarded
into it.  The hand-written kernels' launches of every drained segment,
summed over its ranks, add up in ``kernel_launches``.  Backoff runs
through :class:`~bigdl_tpu_torch.utils.retry.RetryPolicy`
(``jitter=False``: the reference's ``min(base * 2**(n-1), max)``
schedule).
"""
from __future__ import annotations

import multiprocessing
import os
import signal
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from .plan import _prod, plan_devices, plan_mesh
from .. import faults as faultplane
from ..utils.retry import RetryPolicy


class HangAbortError(RuntimeError):
    """Raised asynchronously in the supervisor's loop when the watchdog's
    hang-abort escalation fires; handled as a segment failure (kill,
    replan, resume), never propagated to the caller unless restarts are
    exhausted."""


class SegmentError(RuntimeError):
    """A rank of a segment failed (its traceback in the message) or
    exited."""


def _async_raise(thread_ident: int, exc_type) -> bool:
    """Raise ``exc_type`` in the thread ``thread_ident`` at its next
    bytecode boundary; False when the thread is gone (or the interpreter
    refused)."""
    import ctypes
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
    if res > 1:         # more than one thread state touched: undo
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), None)
        return False
    return res == 1


# --------------------------------------------------------------------- #
# one rank of a segment (runs in its own process)                       #
# --------------------------------------------------------------------- #
def _rank_main(conn, rank, world, store, axes, device, factory, ckpt):
    """Build the trainer of one rank on the planned mesh, restore the
    newest checkpoint, then serve the supervisor's commands until it says
    ``finish`` (or the pipe closes)."""
    # the supervisor forwards SIGTERM as a final checkpoint
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    import torch
    import torch.distributed as dist
    from ..ops import _build
    from ..parallel import mesh as mesh_lib
    trainer = None
    try:
        dev = device
        if device.startswith("cuda") and ":" not in device:
            dev = f"cuda:{axes['_slots'][rank] % torch.cuda.device_count()}"
        mesh_lib.init_distributed(store, rank, world, device=dev)
        shape = {k: v for k, v in axes.items() if k != "_slots"}
        mesh = mesh_lib.create_mesh(shape, device=dev)
        trainer = factory(mesh)
        trainer.set_checkpoint(ckpt["dir"], every_steps=ckpt["every"],
                               keep=ckpt["keep"], layout="manifest",
                               shard_arrays=ckpt["shard_arrays"])
        trainer.init()
        try:
            trainer.load_checkpoint(ckpt["dir"])
            resumed = True
        except FileNotFoundError:
            resumed = False     # a fresh run: nothing to restore yet
        rec = trainer.recorder
        forwarded = {
            "counters": {k: v for k, v in rec.snapshot()["counters"].items()
                         if k.startswith("elastic/")},
            "events": [r for r in rec.recent_records()
                       if r.get("type") == "elastic_event"]}
        _build.reset_launch_counts()    # count the segment's steps only
        conn.send(("ready", trainer._step_count, resumed, forwarded))
        losses = {}
        while True:
            msg = conn.recv()
            if msg[0] == "step":
                _, s, tokens, targets, save = msg
                losses[s] = trainer.step(tokens, targets)
                drained = None
                if save:
                    # the checkpoint's copy syncs the host anyway: hand
                    # over the losses it covers, so that a later failure
                    # (whose resume starts here) loses none of them
                    trainer.save_checkpoint(ckpt["dir"])
                    drained = {k: float(v) for k, v in losses.items()}
                    losses.clear()
                conn.send(("ok", s, drained))
            elif msg[0] == "finish":
                _, commit, tag = msg
                if commit:
                    trainer.save_checkpoint(ckpt["dir"], sync=True, tag=tag)
                if trainer._ckpt_mgr is not None:
                    trainer._ckpt_mgr.wait()
                host = {s: float(v) for s, v in losses.items()}
                conn.send(("done", host, trainer._step_count,
                           _build.launch_counts()))
                break
    except EOFError:
        pass                    # the supervisor went away: just exit
    except BaseException:       # noqa: BLE001 — reported to the supervisor
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:
            pass
    finally:
        if trainer is not None:
            trainer.detach()
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


class _Segment:
    """The rank processes of one mesh and the pipes to them."""

    def __init__(self, axes, used, device, factory, ckpt, store_dir):
        # forkserver: a clean server process (no CUDA context, no threads
        # of the caller's) started once, with torch and the factory's
        # module imported, forks each rank in milliseconds
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(["torch", __name__,
                                    "bigdl_tpu_torch.parallel.spmd",
                                    factory.__module__])
        world = _prod(axes)
        fd, path = tempfile.mkstemp(prefix=".elastic_store_",
                                    dir=store_dir)
        os.close(fd)
        os.remove(path)         # the file store creates it
        self.store_path = path
        shape = dict(axes, _slots=[u if isinstance(u, int) else i
                                   for i, u in enumerate(used)])
        self.conns, self.procs = [], []
        for r in range(world):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(theirs, r, world, f"file://{path}",
                                  shape, device, factory, ckpt),
                            name=f"bigdl-elastic-rank{r}")
            p.start()
            theirs.close()
            self.conns.append(mine)
            self.procs.append(p)

    def send(self, msg):
        for c in self.conns:
            c.send(msg)

    def gather(self, want: str) -> list:
        """Every rank's reply; raises :class:`SegmentError` for a rank
        that reports an error or exits."""
        out = [None] * len(self.conns)
        pending = set(range(len(self.conns)))
        while pending:
            for r in sorted(pending):
                c = self.conns[r]
                if c.poll(0.05):
                    try:
                        msg = c.recv()
                    except EOFError:
                        raise SegmentError(
                            f"rank {r} closed its pipe (exit code "
                            f"{self.procs[r].exitcode})") from None
                    if msg[0] == "error":
                        raise SegmentError(f"rank {r} failed:\n{msg[1]}")
                    if msg[0] != want:
                        raise SegmentError(f"rank {r} replied {msg[0]!r}, "
                                           f"expected {want!r}")
                    out[r] = msg
                    pending.discard(r)
                elif not self.procs[r].is_alive():
                    raise SegmentError(f"rank {r} exited with code "
                                       f"{self.procs[r].exitcode}")
        return out

    def close(self, kill: bool = False):
        for c in self.conns:
            c.close()
        for p in self.procs:
            if kill and p.is_alive():
                p.kill()
            # a rank that has not exited after its reply is wedged in its
            # teardown: kill it rather than the supervisor's loop
            p.join(timeout=30 if kill else 120)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(self.store_path):
            os.remove(self.store_path)


class ElasticSupervisor:
    """Drive an :class:`~bigdl_tpu_torch.parallel.spmd.SpmdTrainer`
    factory through preemptions and capacity changes.

    ``trainer_factory(mesh)`` must be a module-level function returning a
    fresh, un-``init()``-ed trainer for that mesh (on ``mesh.device``);
    the supervisor owns the checkpoint wiring.  ``device`` is ``"cpu"``
    (gloo ranks) or ``"cuda"`` (NCCL ranks, the default)."""

    def __init__(self, trainer_factory, ckpt_dir: str,
                 template: Dict[str, int], *,
                 capacity_fn: Optional[Callable] = None,
                 batch_fn: Optional[Callable] = None,
                 recorder=None, ckpt_every: int = 50, keep: int = 3,
                 shard_arrays: bool = True,
                 min_axes: Optional[Dict[str, int]] = None,
                 axis_costs: Optional[Dict[str, float]] = None,
                 replan_every: int = 10, max_restarts: int = 5,
                 backoff_base: float = 0.5, backoff_max: float = 30.0,
                 handle_sigterm: bool = True,
                 hang_abort_grace: Optional[float] = None,
                 watchdog=None, flight_dir: Optional[str] = None,
                 name: Optional[str] = None, device: str = "cuda"):
        self.trainer_factory = trainer_factory
        self.ckpt_dir = str(ckpt_dir)
        self.template = {str(k): int(v) for k, v in template.items()}
        self.capacity_fn = capacity_fn
        self.batch_fn = batch_fn
        if recorder is None:
            from ..observability import Recorder
            recorder = Recorder()
        self.recorder = recorder
        self.ckpt_every = int(ckpt_every)
        self.keep = int(keep)
        self.shard_arrays = bool(shard_arrays)
        self.min_axes = dict(min_axes or {})
        self.axis_costs = None if axis_costs is None else dict(axis_costs)
        self.replan_every = int(replan_every)
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.handle_sigterm = bool(handle_sigterm)
        self.name = None if name is None else str(name)
        self.device = str(device)
        # jitter=False: the reference's min(base * 2**(n-1), max) schedule;
        # a named (fleet) supervisor splits the retry counters per job
        self.retry = RetryPolicy(max_attempts=self.max_restarts + 1,
                                 base=self.backoff_base,
                                 max_delay=self.backoff_max, jitter=False,
                                 name="elastic" if self.name is None
                                 else f"elastic.{self.name}",
                                 recorder_fn=lambda: self.recorder)
        self.hang_abort_grace = None if hang_abort_grace is None \
            else float(hang_abort_grace)
        self.watchdog = watchdog
        self.flight_dir = flight_dir
        self.state = "idle"
        self.restarts = 0
        self._segment: Optional[_Segment] = None
        self._stop = False
        self._preemption = None
        self._loop_ident: Optional[int] = None
        self._in_segment = False
        self.kernel_launches: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    def _capacity(self) -> list:
        """The slots ranks can be started on: ``capacity_fn()``'s list, or
        ``range(n)`` for a count (default: one slot)."""
        cap = self.capacity_fn() if self.capacity_fn is not None else 1
        return list(range(cap)) if isinstance(cap, int) else list(cap)

    def _event(self, kind: str, **fields):
        rec = self.recorder
        rec.inc(f"elastic/{kind}s" if not kind.endswith("s")
                else f"elastic/{kind}")
        rec.inc(f"health/elastic_{kind}")
        rec.emit_record("elastic_event", kind=kind, state=self.state,
                        job=self.name, **fields)
        rec.emit_record("health_event", condition=f"elastic_{kind}",
                        step=fields.get("step"), metric="elastic/devices",
                        value=fields.get("devices"), threshold=None,
                        action="elastic")

    def _set_state(self, state: str):
        self.state = state
        self.recorder.gauge("elastic/state_" + state, time.time())

    def stop(self):
        """Ask :meth:`run` to commit a checkpoint and return at the next
        step boundary (callable from any thread)."""
        self._stop = True

    # -- hang-abort ----------------------------------------------------- #
    def _setup_watchdog(self):
        if self.hang_abort_grace is None:
            return None
        wd = self.watchdog
        if wd is None:
            from ..observability.health import StallWatchdog
            wd = StallWatchdog(self.recorder, poll_interval=0.1)
            self.watchdog = wd
        flight = None
        if self.flight_dir is not None:
            from ..observability.health import FlightRecorder
            flight = FlightRecorder(self.recorder, self.flight_dir)
        wd.set_escalation(self.hang_abort_grace, self._abort_wedged_step,
                          flight=flight)
        return wd

    def _abort_wedged_step(self):
        """The watchdog's escalation (on its poll thread): raise
        :class:`HangAbortError` in the loop thread, whose failure path
        kills the segment's ranks.  Outside a running segment it only
        logs."""
        ident = self._loop_ident
        if not self._in_segment or ident is None:
            print("[elastic] hang-abort requested outside a running "
                  "segment; ignored", flush=True)
            return
        self.recorder.inc("elastic/hang_aborts")
        print("[elastic] hang-abort: raising HangAbortError in the "
              "supervisor loop — the wedged segment is killed and "
              "replanned", flush=True)
        if not _async_raise(ident, HangAbortError):
            print("[elastic] hang-abort: could not signal the loop "
                  "thread (already gone?)", flush=True)

    # ------------------------------------------------------------------ #
    def _build(self, axes, used):
        """Start the segment's ranks; ``(step count, resumed)`` once every
        rank has built its trainer and restored the newest checkpoint."""
        ckpt = {"dir": self.ckpt_dir, "every": max(self.ckpt_every, 1),
                "keep": self.keep, "shard_arrays": self.shard_arrays}
        os.makedirs(self.ckpt_dir, exist_ok=True)
        seg = _Segment(axes, used, self.device, self.trainer_factory, ckpt,
                       self.ckpt_dir)
        self._segment = seg
        ready = seg.gather("ready")
        _, step_count, resumed, forwarded = ready[0]
        rec = self.recorder
        for k, v in sorted(forwarded["counters"].items()):
            rec.inc(k, v)
        for ev in forwarded["events"]:
            ev = {k: v for k, v in ev.items() if k not in ("type", "ts")}
            rec.emit_record("elastic_event", **ev)
        return int(step_count), bool(resumed)

    def _teardown(self, kill: bool = False):
        seg, self._segment = self._segment, None
        if seg is not None:
            seg.close(kill=kill)

    def _round_trip(self, msg, want):
        self._segment.send(msg)
        return self._segment.gather(want)

    def run(self, batch_fn: Optional[Callable] = None,
            steps: int = 100) -> list:
        """Train to ``steps`` total steps across however many meshes it
        takes; returns the per-step losses (recomputed steps — the tail a
        failure rolled back — keep their latest value).

        Capacity is read only at planning points — the loop top and the
        ``replan_every`` polls: a change landing between them (a regrow
        arriving while a shrink's drain is in flight) waits for the next
        planning cycle, never interleaved with the transition."""
        batch_fn = batch_fn or self.batch_fn
        if batch_fn is None:
            raise ValueError("no batch_fn: pass one here or at init")
        self._stop = False
        rec = self.recorder
        if self.handle_sigterm:
            from ..checkpoint import PreemptionHandler
            if self._preemption is None:
                self._preemption = PreemptionHandler()
            self._preemption.install()
        handler = self._preemption if self.handle_sigterm else None
        self._loop_ident = threading.get_ident()
        wd = self._setup_watchdog()
        losses: Dict[int, Any] = {}
        prev_axes = prev_used = first_step = None
        try:
            while True:
                try:
                    self._set_state("planning")
                    slots = self._capacity()
                    axes = plan_mesh(len(slots), self.template,
                                     self.min_axes, self.axis_costs)
                    used = plan_devices(axes, slots)
                    rec.gauge("elastic/devices", _prod(axes))
                    for name, size in axes.items():
                        rec.gauge(f"elastic/axis_{name}", size)
                    self._set_state("resuming")
                    try:
                        start, resumed = self._build(axes, used)
                    except Exception as e:      # noqa: BLE001 — retried
                        self._teardown(kill=True)
                        if not self._backoff("build", e):
                            raise
                        continue
                    if prev_axes is not None and axes != prev_axes:
                        kind = "shrink" if _prod(axes) < _prod(prev_axes) \
                            else "regrow"
                        self._event(kind, from_axes=prev_axes, to_axes=axes,
                                    devices=_prod(axes))
                        print(f"[elastic] {kind}: {prev_axes} -> {axes}",
                              flush=True)
                    elif prev_used is not None and used != prev_used:
                        self._event("displace", axes=axes,
                                    devices=_prod(axes))
                        print(f"[elastic] displace: {axes} moved to new "
                              "slots", flush=True)
                    prev_axes, prev_used = axes, used
                    if resumed:
                        self._event("resume", step=start,
                                    devices=_prod(axes), axes=axes)
                    if first_step is None:
                        first_step = start
                    step_count = start
                    outcome, fail = "completed", None
                    self._set_state("running")
                    if wd is not None:
                        wd.start()
                    self._in_segment = True
                    try:
                        for s in range(start, steps):
                            if self._stop:
                                outcome = "stopped"
                                break
                            if handler is not None and handler.requested:
                                outcome = "preempted"
                                break
                            if (self.replan_every and s > start
                                    and (s - start) % self.replan_every == 0):
                                new_slots = self._capacity()
                                new_axes = plan_mesh(len(new_slots),
                                                     self.template,
                                                     self.min_axes,
                                                     self.axis_costs)
                                if (new_axes != axes
                                        or plan_devices(new_axes, new_slots)
                                        != used):
                                    outcome = "replan"
                                    break
                            rec.start_step(s + 1)
                            tokens, targets = batch_fn(s)
                            # the step.dispatch fault site: a delay here is
                            # the wedge the hang-abort exists for
                            faultplane.inject("step.dispatch", rec)
                            save = (self.ckpt_every
                                    and (s + 1) % self.ckpt_every == 0
                                    and s + 1 < steps)
                            msg = ("step", s, tokens, targets, save)
                            if wd is not None and s == start:
                                # a segment's first step builds its
                                # kernels and caches: not a wedge
                                with wd.suspended():
                                    ok = self._round_trip(msg, "ok")
                            else:
                                ok = self._round_trip(msg, "ok")
                            if ok[0][2] is not None:
                                losses.update(ok[0][2])
                            step_count = s + 1
                            rec.end_step(s + 1)
                            rec.gauge("elastic/steps_done", s + 1)
                    except Exception as e:      # noqa: BLE001 — retried
                        # HangAbortError lands here too: a wedged step is
                        # a failed segment — kill, backoff, replan
                        outcome, fail = "failed", e
                    finally:
                        self._in_segment = False
                        if wd is not None:
                            wd.stop()
                    self._set_state("draining")
                    if outcome == "failed":
                        rec.abort_step()
                        self._teardown(kill=True)
                        if not self._backoff("segment", fail):
                            raise fail
                        continue
                    # a clean outcome commits a final synchronous
                    # checkpoint (skipped by a resumed segment that ran no
                    # step: its state is the checkpoint just restored)
                    tag = f"preempt_step_{step_count}" \
                        if outcome == "preempted" else None
                    commit = step_count > start or not resumed
                    done = self._round_trip(("finish", commit, tag), "done")
                    losses.update(done[0][1])
                    for reply in done:
                        for name, n in reply[3].items():
                            self.kernel_launches[name] = \
                                self.kernel_launches.get(name, 0) + n
                    self._teardown()
                    self.restarts = 0
                    if outcome == "preempted":
                        self._event("preemption", step=step_count,
                                    devices=_prod(axes))
                        print(f"[elastic] preempted at step {step_count}; "
                              "final checkpoint committed, re-planning "
                              "from surviving capacity", flush=True)
                        handler.reset()
                        continue
                    if outcome == "replan":
                        continue
                    self._set_state("idle")
                    return [losses[s]
                            for s in range(first_step, max(losses) + 1)
                            if s in losses] if losses else []
                except HangAbortError as e:
                    # landed outside the step loop's try (the wedge
                    # released between the verdict and the raise): still
                    # one segment failure
                    if self.restarts > self.max_restarts:
                        raise
                    self._in_segment = False
                    self._teardown(kill=True)
                    if not self._backoff("hang_abort", e):
                        raise
                    continue
        finally:
            self._teardown(kill=True)
            if handler is not None:
                handler.uninstall()

    def _backoff(self, what: str, exc: Exception = None) -> bool:
        """Count a failure and sleep by the retry schedule; False when the
        restarts are exhausted (the caller re-raises)."""
        self.restarts += 1
        self._event("failure", attempt=self.restarts, what=what,
                    error=None if exc is None else repr(exc)[:2000])
        if self.restarts > self.max_restarts:
            self.retry.count_giveup()
            return False
        delay = self.retry.delay_for(self.restarts)
        self.retry.count_attempt()
        print(f"[elastic] {what} failed ({repr(exc)[:500]}); retry "
              f"{self.restarts}/{self.max_restarts} in {delay:.1f}s",
              flush=True)
        time.sleep(delay)
        return True


__all__ = ["ElasticSupervisor", "HangAbortError", "SegmentError"]
