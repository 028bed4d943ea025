"""Live train→serve weight streaming (≙ ``bigdl_tpu/serving/stream.py``).

    SpmdTrainer / Optimizer
        └─ set_weight_stream(WeightStreamPublisher(...))
             trigger fires (several_iteration / every_seconds / ...)
                └─ owning snapshot of the params, taken synchronously in
                   the step loop: a detached ``clone()`` per leaf on the
                   parameters' own device (the next step updates the live
                   tensors in place, so the publish thread must never hold
                   them).  Not a copy to the host: a pageable D2H of
                   ``base``'s 650 MB would block the step loop, and the
                   registry refuses a swap that changes a leaf's device.
                └─ publish worker (one in flight; a trigger that fires
                   while a publish runs is counted ``stream/skipped_busy``
                   and the NEXT firing ships fresher weights)
                     └─ CanaryPublisher.publish(...)  golden validation on
                        a quiesced canary, fleet-wide promotion, bitwise
                        rollback on rejection
                     └─ (or a bare ModelRegistry.swap_weights for a
                        single-engine target)

Counters: ``stream/snapshots``, ``stream/published``, ``stream/rejected``
(the canary said no: training continues, the fleet serves the previous
snapshot), ``stream/skipped_busy``, ``stream/errors``.  Spans:
``stream.snapshot`` (what the step loop pays) and ``stream.publish`` (the
worker's side).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..observability import Recorder
from .registry import owning_copy


class WeightStreamPublisher:
    """Trigger-gated params streaming from a live trainer to a serving
    target.

    ``target``   a :class:`~bigdl_tpu_torch.serving.CanaryPublisher` (the
                 production path: golden-decode gate + rollback), a
                 :class:`~bigdl_tpu_torch.serving.ModelRegistry` (direct
                 ``swap_weights`` — no gate, single engine), or any
                 callable ``(name, params, version) -> None``
    ``name``     the registry entry to publish under
    ``trigger``  an :class:`~bigdl_tpu_torch.optim.Trigger` evaluated
                 against the trainer's state each step; or pass
                 ``every_steps=N``
    ``sync``     publish inline instead of on the worker thread
                 (tests / final-flush determinism)
    """

    def __init__(self, target: Any, name: str, *, trigger=None,
                 every_steps: Optional[int] = None,
                 recorder: Optional[Recorder] = None, sync: bool = False,
                 version_prefix: str = "stream"):
        if (trigger is None) == (every_steps is None):
            raise ValueError(
                "pass exactly one of trigger= / every_steps=")
        if every_steps is not None:
            from ..optim.trigger import Trigger
            trigger = Trigger.several_iteration(int(every_steps))
        self.target = target
        self.name = name
        self.trigger = trigger
        self.recorder = recorder if recorder is not None else Recorder()
        self.sync = bool(sync)
        self.version_prefix = version_prefix
        self._lock = threading.Lock()
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        #: (version, params) of the newest snapshot that actually
        #: published — what a smoke test compares decode output against
        self.last_published: Optional[tuple] = None
        #: version of the newest snapshot the canary REJECTED
        self.last_rejected: Optional[str] = None

    # -- trainer-side hook -------------------------------------------------- #
    def maybe_publish(self, params, state=None, step: Optional[int] = None,
                      loss=None) -> bool:
        """Called from the trainer's step loop.  Evaluates the trigger
        against ``state`` (an Optimizer ``TrainingState``) or a shim
        built from ``step``/``loss`` (the SpmdTrainer path); on fire,
        snapshots ``params`` synchronously (owning copies) and hands
        the publish to the worker.  Returns True when a snapshot was
        taken."""
        if state is None:
            state = _StreamState(int(step or 0), loss)
        if not self.trigger(state):
            return False
        rec = self.recorder
        with self._lock:
            if self._busy:
                # one publish in flight: skip — the next firing ships a
                # FRESHER snapshot, which is the point of streaming
                rec.inc("stream/skipped_busy")
                return False
            self._busy = True
        # anything failing between the busy-latch and the worker's own
        # finally must RELEASE the latch, or one transient snapshot/
        # thread-start failure silently kills streaming for the rest of
        # the training run (every later firing reads as skipped_busy)
        try:
            with rec.span("stream.snapshot"):
                # owning copies ON THE PARAMETERS' DEVICE, queued on the
                # device's default stream ahead of the next step's in-place
                # update (K4 on the card): the stream runs them in order,
                # so the copy reads this step's weights.  Every thread of
                # the port (trainer, decode loops, batchers, this worker)
                # issues on that one default stream, so no event is needed
                # before another thread reads the copy; a side stream
                # would need one.
                snap = owning_copy(params)
            rec.inc("stream/snapshots")
            version = f"{self.version_prefix}_iter{state.iteration}"
            if self.sync:
                self._publish(snap, version)
            else:
                t = threading.Thread(target=self._publish,
                                     args=(snap, version), daemon=True,
                                     name="weight-stream-publish")
                with self._lock:
                    self._thread = t
                t.start()
        except Exception as e:
            with self._lock:
                self._busy = False
            rec.inc("stream/errors")
            rec.emit_record("stream_event", kind="error",
                            model=self.name,
                            error=f"{type(e).__name__}: {e}")
            print(f"[stream] snapshot/dispatch failed: {e!r}",
                  flush=True)
        return True

    def wait(self, timeout: Optional[float] = None):
        """Block until the in-flight publish (if any) finishes."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
        return self

    # -- worker side --------------------------------------------------------- #
    def _publish(self, params, version: str):
        from .replicas import CanaryRejectedError
        rec = self.recorder
        try:
            with rec.span("stream.publish"):
                target = self.target
                if hasattr(target, "publish"):          # CanaryPublisher
                    target.publish(self.name, params, version=version)
                elif hasattr(target, "swap_weights"):   # bare registry
                    target.swap_weights(self.name, params,
                                        version=version)
                else:
                    target(self.name, params, version)
            rec.inc("stream/published")
            self.last_published = (version, params)
            rec.emit_record("stream_event", kind="published",
                            model=self.name, version=version)
        except CanaryRejectedError as e:
            # the gate worked: the fleet still serves the previous
            # snapshot, training is not interrupted
            rec.inc("stream/rejected")
            self.last_rejected = version
            rec.emit_record("stream_event", kind="rejected",
                            model=self.name, version=version,
                            reason=e.reason)
            print(f"[stream] canary rejected {self.name} {version} "
                  f"({e.reason}); fleet keeps the previous snapshot",
                  flush=True)
        except Exception as e:
            rec.inc("stream/errors")
            rec.emit_record("stream_event", kind="error",
                            model=self.name, version=version,
                            error=f"{type(e).__name__}: {e}")
            print(f"[stream] publish {version} failed: {e!r}",
                  flush=True)
        finally:
            with self._lock:
                self._busy = False


class _StreamState:
    """Trigger-state shim for trainers without a TrainingState (the
    SpmdTrainer path): exposes the fields the stock triggers read."""

    def __init__(self, iteration: int, loss=None):
        self.iteration = iteration
        self.epoch = 0
        # kept as given: a device loss is not brought to the host here
        # (that would sync every step); a trigger that reads it syncs
        self.loss = loss
        self.score = None
        self.epoch_finished = False


__all__ = ["WeightStreamPublisher"]
