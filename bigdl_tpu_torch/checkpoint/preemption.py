"""Preemption handling: SIGTERM → final checkpoint → clean exit (≙
``bigdl_tpu/checkpoint/preemption.py``).

Schedulers deliver SIGTERM with a short grace window before the hard
kill.  The handler only sets a flag: the training loop polls
:attr:`PreemptionHandler.requested` at iteration boundaries, commits a
final checkpoint (finishing any in-flight async write first) and stops
cleanly, so the run loses no completed step.  Under NCCL the loop then
returns before anything tears the process group down mid-collective.

All handlers register with one process-wide dispatcher that owns the
single OS-level hook per signal and fans each delivery out to every
registered handler, then chains whatever handler the hook displaced (the
flight recorder, installed before or after: both orders work).  The hook
is installed by the first handler that registers from the main thread
and released only when the last handler for that signal unregisters and
it is still the active disposition.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Dict, Iterable, List


class _SignalDispatcher:
    """Process-wide fan-out owner of the OS-level signal hooks.

    RLock, not Lock: the handler body runs on the main thread between
    bytecodes, so a signal landing while the main thread is inside
    register()/unregister() re-enters the lock on the same thread.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._handlers: List["PreemptionHandler"] = []   # delivery order
        self._os_prev: Dict[int, object] = {}   # signum -> displaced handler
        # ONE bound-method object for the OS hook: attribute access mints
        # a fresh bound method each time, so identity checks against
        # signal.getsignal() would never match a re-accessed method
        self._hook = self._on_signal

    def register(self, handler: "PreemptionHandler") -> bool:
        """Add ``handler`` to the fan-out set and make sure the OS hook
        exists for each of its signals.  Returns False when a needed OS
        hook could not be installed (worker thread) AND no main-thread
        owner holds it yet — delivery is pending a main-thread install."""
        with self._lock:
            if handler not in self._handlers:
                self._handlers.append(handler)
            missing = [s for s in handler._signals
                       if s not in self._os_prev]
        ok = True
        for s in missing:
            try:
                prev = signal.signal(s, self._hook)
            except ValueError:
                # signal.signal only works on the main thread; the
                # registration above still counts — a main-thread owner
                # (fleet scheduler / earlier handler) delivers to us
                ok = False
                continue
            with self._lock:
                self._os_prev[s] = prev
        return ok

    def unregister(self, handler: "PreemptionHandler"):
        with self._lock:
            if handler in self._handlers:
                self._handlers.remove(handler)
            # release a signal's OS hook only when NO remaining handler
            # wants it — this is the fan-out fix: one supervisor leaving
            # must not unhook the others
            dead = {s: self._os_prev[s] for s in handler._signals
                    if s in self._os_prev
                    and not any(s in h._signals for h in self._handlers)}
        for s, prev in dead.items():
            try:
                if signal.getsignal(s) is not self._hook:
                    # someone hooked in above us and chains our hook:
                    # leave the hook AND its saved prev — with an empty
                    # registry we are a pure pass-through, and a later
                    # register() must see the hook as already owned
                    # (re-hooking would save the chainer as prev and
                    # chain the dispatcher into itself)
                    continue
                signal.signal(s, prev)
            except ValueError:
                continue        # worker thread: leave the hook in place
            with self._lock:
                self._os_prev.pop(s, None)

    def has_hook(self, signum: int) -> bool:
        with self._lock:
            return signum in self._os_prev

    def relink_prev(self, signum: int, old, new) -> bool:
        """Unlink a handler we displaced that is being uninstalled: swap
        the saved prev for ``signum`` from ``old`` (its handler) to
        ``new`` (what IT had displaced).  Without this, the dispatcher
        would keep chaining — or on its own release, restore to the
        OS — a torn-down component's dead closure.  Returns False when
        ``old`` is not the saved prev (nothing to unlink)."""
        with self._lock:
            if self._os_prev.get(signum) is old:
                self._os_prev[signum] = new
                return True
        return False

    def _on_signal(self, signum, frame):
        with self._lock:
            handlers = [h for h in self._handlers
                        if signum in h._signals]
            prev = self._os_prev.get(signum)
        for h in handlers:
            h._on_signal(signum, frame)
        # chain the handler the OS hook displaced (e.g. the flight
        # recorder installed before us) — it must still see the signal;
        # default/ignore dispositions are deliberately NOT re-applied
        # while a handler consumed the signal, intercepting them is the
        # preemption handler's whole point
        if callable(prev):
            prev(signum, frame)
        elif not handlers:
            # an empty-registry dispatcher whose hook outlived its
            # handlers (worker-thread unregister cannot drop the OS
            # hook) must be a PASS-THROUGH, not a signal sink: restore
            # the displaced default/ignore disposition and re-raise, so
            # a plain `kill <pid>` still kills the process instead of
            # silently disappearing into a handler-less hook
            if signal.getsignal(signum) is not self._hook:
                # invoked as a chained callee — a later hook displaced
                # us and owns the OS registration now; restoring `prev`
                # here would clobber the CHAINER, and re-raising would
                # loop chainer→us forever.  Stay inert and keep the
                # saved prev so a later register() sees the hook as
                # still owned (same guard as unregister()).
                return
            with self._lock:
                self._os_prev.pop(signum, None)
            signal.signal(signum,
                          prev if prev is not None else signal.SIG_DFL)
            os.kill(os.getpid(), signum)


_dispatcher = _SignalDispatcher()


def dispatcher() -> _SignalDispatcher:
    """The process-wide signal dispatcher (fleet scheduler introspection
    and tests; handlers go through :meth:`PreemptionHandler.install`)."""
    return _dispatcher


class PreemptionHandler:
    """Install with :meth:`install`; poll :attr:`requested` in the loop."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._installed = False

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        self._installed = True
        if not _dispatcher.register(self):
            # registration succeeded but the OS hook needs a main-thread
            # owner — the fleet scheduler (or any main-thread handler)
            # provides it; say so instead of silently not firing
            print("[preemption] not on main thread; registered for "
                  "fan-out but the OS signal hook needs a main-thread "
                  "install (e.g. the fleet scheduler's)")
        return self

    def uninstall(self):
        if not self._installed:
            return
        _dispatcher.unregister(self)
        self._installed = False

    def _on_signal(self, signum, frame):
        if not self._event.is_set():
            print(f"[preemption] signal {signum} received; will write a "
                  "final checkpoint and stop", flush=True)
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def reset(self):
        self._event.clear()
