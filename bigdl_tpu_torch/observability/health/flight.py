"""Crash flight recorder: dump the telemetry ring when the job dies (≙
``bigdl_tpu/observability/health/flight.py``).

:class:`FlightRecorder` turns the Recorder's ring of recent records into
one ``flight_<ts>.json`` written atomically (tmp + fsync + ``os.replace``
+ directory fsync), with the counters, gauges, last step and the reason.

``install()`` chains — never replaces — the crash paths:

  * ``sys.excepthook``: an unhandled exception dumps, then the previous
    hook runs;
  * SIGTERM: the dump happens, then the previous handler runs, so a
    :class:`~bigdl_tpu_torch.checkpoint.preemption.PreemptionHandler`
    installed before still gets its flag and commits its final
    checkpoint; with no previous handler the default disposition still
    terminates the process.  A dump re-entered by a signal mid-write
    takes its own path.

Divergence dumps come from :class:`~.sentinels.HealthMonitor`, which
calls :meth:`FlightRecorder.dump` before raising.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..sinks import _json_default


class FlightRecorder:
    """Dumps ``recorder``'s ring to ``out_dir/flight_<ts>.json``."""

    def __init__(self, recorder, out_dir: str, max_records: Optional[int] = None):
        self.recorder = recorder
        self.out_dir = out_dir
        self.max_records = max_records
        self.dumps: List[str] = []          # paths written, oldest first
        self._dumped_keys = set()           # dedupe one failure's dumps
        self._pending: set = set()          # paths claimed mid-write
        # RLock, not Lock: a signal delivered while dump() holds the
        # lock runs the chained handler on the SAME thread, which dumps
        # again — a plain Lock would self-deadlock through the scheduler
        # grace window
        self._lock = threading.RLock()
        self._installed = False
        self._prev_excepthook = None
        self._hook_fn = None                # our excepthook, for identity
        self._prev_signals: Dict[int, Any] = {}
        self._sig_hooks: Dict[int, Any] = {}    # our handlers, for identity

    # -- the dump --------------------------------------------------------- #
    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None,
             key=None) -> Optional[str]:
        """Write one atomic flight dump; returns its path.  ``key`` (e.g.
        ``id(exc)``) dedupes: the training loop dumps a propagating
        exception at the loop, and the chained excepthook would dump the
        SAME failure again at process exit — the second call no-ops and
        returns None."""
        if key is not None:
            with self._lock:
                if key in self._dumped_keys:
                    return None
                self._dumped_keys.add(key)
        rec = self.recorder
        snap = rec.snapshot()
        payload: Dict[str, Any] = {
            "type": "flight",
            "reason": str(reason),
            "time": time.time(),
            "last_step": rec.last_step(),
            "step_age_s": rec.step_age(),
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "records": rec.recent_records(self.max_records),
        }
        if extra:
            payload.update(extra)
        with self._lock:
            os.makedirs(self.out_dir, exist_ok=True)
            base = f"flight_{int(time.time() * 1e3)}"
            path = os.path.join(self.out_dir, base + ".json")
            n = 0
            # two dumps in the same ms — including a re-entrant dump
            # (signal mid-write) whose outer path has no file yet, only
            # a _pending claim; a shared path would mean a shared tmp,
            # and the inner os.replace would consume the outer's tmp
            while os.path.exists(path) or path in self._pending:
                n += 1
                path = os.path.join(self.out_dir, f"{base}_{n}.json")
            self._pending.add(path)
            try:
                tmp = f"{path}.tmp-{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(payload, f, default=_json_default)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                self._pending.discard(path)
            try:        # directory entry durable too (same as manifest)
                dfd = os.open(self.out_dir, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
            self.dumps.append(path)
        return path

    def _dump_quietly(self, reason: str, extra=None, key=None):
        try:
            self.dump(reason, extra, key=key)
        except Exception as e:      # noqa: BLE001 — crash path
            print(f"[flight] dump failed: {e!r}", file=sys.stderr)

    # -- crash-path hooks -------------------------------------------------- #
    def install(self, signals=(signal.SIGTERM,)) -> "FlightRecorder":
        """Chain onto ``sys.excepthook`` and the given signals."""
        with self._lock:
            if self._installed:
                return self
            prev_hook = sys.excepthook
            self._prev_excepthook = prev_hook

            def hook(exc_type, exc, tb):
                self._dump_quietly(f"unhandled:{exc_type.__name__}",
                                   {"error": repr(exc)}, key=id(exc))
                prev_hook(exc_type, exc, tb)

            sys.excepthook = hook
            self._hook_fn = hook
            try:
                for s in signals:
                    prev = signal.getsignal(s)

                    def handler(signum, frame, _prev=prev):
                        self._dump_quietly(f"signal:{signum}")
                        if callable(_prev):
                            _prev(signum, frame)
                        elif (_prev == signal.SIG_DFL
                              and signal.getsignal(signum) is handler):
                            # the default disposition (terminate) must
                            # still apply: restore it and re-deliver —
                            # dump-and-ignore would eat the scheduler's
                            # grace window.  Only while we are the
                            # ACTIVE handler though: if something
                            # installed over us and chained in (the
                            # preemption handler), THAT owner decides
                            # the disposition — terminating here would
                            # kill its graceful final checkpoint
                            signal.signal(signum, signal.SIG_DFL)
                            signal.raise_signal(signum)
                        # SIG_IGN: stay ignored

                    signal.signal(s, handler)
                    self._prev_signals[s] = prev
                    self._sig_hooks[s] = handler
            except ValueError:
                # signal.signal only works on the main thread; excepthook
                # chaining above still covers unhandled exceptions
                print("[flight] not on main thread; signal hooks skipped")
            self._installed = True
            return self

    def _relink_displaced(self, s, prev):
        try:    # lazy: observability must not hard-depend on checkpoint
            from ...checkpoint.preemption import dispatcher
        except ImportError:
            return
        dispatcher().relink_prev(s, self._sig_hooks.get(s), prev)

    def uninstall(self):
        """Restore the dispositions we displaced — but ONLY where we are
        still the active hook.  A later installer (e.g. the preemption
        dispatcher hooking SIGTERM over us) owns the registration now;
        blindly restoring our saved prev would silently unhook it —
        every PreemptionHandler in the process would miss the
        scheduler's kill grace window (same guard as the dispatcher's
        own unregister)."""
        with self._lock:
            if not self._installed:
                return
            if self._prev_excepthook is not None:
                if sys.excepthook is self._hook_fn:
                    sys.excepthook = self._prev_excepthook
                self._prev_excepthook = None
                self._hook_fn = None
            for s, prev in self._prev_signals.items():
                try:
                    if signal.getsignal(s) is self._sig_hooks.get(s):
                        signal.signal(s, prev)
                    else:
                        # displaced: the preemption dispatcher may have
                        # saved OUR handler as its chained prev — swap
                        # in what we displaced, so the dead closure of
                        # an uninstalled recorder is never called (or
                        # restored to the OS) after teardown
                        self._relink_displaced(s, prev)
                except ValueError:
                    pass
            self._prev_signals.clear()
            self._sig_hooks.clear()
            self._installed = False


def read_flight(path: str) -> Dict[str, Any]:
    """Parse one flight dump back (plain json.load, named for symmetry
    with ``sinks.read_jsonl``)."""
    with open(path) as f:
        return json.load(f)
