"""Background host→device staging (≙ ``bigdl_tpu/data/device_loader.py``).

:class:`DeviceLoader` runs a producer iterator on a background thread,
``depth`` items ahead, behind a bounded queue: exceptions re-raise at the
consumer's next pull, and a consumer that stops early (break, close, GC)
stops the producer instead of leaving it blocked on a full queue.  Its
counters keep the reference's names: ``dataloader/stall_seconds`` (the
consumer blocked on an empty queue), ``dataloader/queue_depth`` (a gauge
after each pull), ``dataloader/producer_wait_seconds`` (the producer
blocked on a full queue) and ``dataloader/batches``.

:class:`HostToDevice` is what the producer runs to place a batch.  On a
CUDA device it copies each host array into one of ``depth + 1`` pinned
buffers (a ring; a buffer is refilled only after the event of its last
copy has completed), then to the device with ``non_blocking=True`` on a
side stream, and records an event after the copies.  The consumer calls
:meth:`Staged.take` on its own stream: the stream waits on that event
before the batch is used, and each device tensor is marked with
``record_stream`` for the consumer's stream, so that the caching
allocator does not hand its memory out again while the consumer may
still read it.  On the CPU a batch is placed inline, without streams.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..observability.recorder import Recorder


class _End:
    pass


class _Raise:
    def __init__(self, exc):
        self.exc = exc


class DeviceLoader:
    """Iterate ``source`` on a background thread, ``depth`` items ahead.
    ``recorder`` takes the ``dataloader/*`` counters (a new
    :class:`Recorder` of the loader's own by default)."""

    def __init__(self, source, depth: int = 2,
                 recorder: Optional[Recorder] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.source = source
        self.depth = depth
        self.recorder = recorder if recorder is not None else Recorder()

    def __iter__(self):
        rec = self.recorder
        q: queue.Queue = queue.Queue(self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            """Put unless the consumer has stopped; False if it has."""
            blocked = None
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    if blocked is None:
                        blocked = time.perf_counter()
            if blocked is not None:
                rec.inc("dataloader/producer_wait_seconds",
                        time.perf_counter() - blocked)
            return not stop.is_set()

        def fill():
            try:
                for item in self.source:
                    if not put(item):
                        return
                put(_End())
            except BaseException as e:  # re-raised on the consumer side
                put(_Raise(e))

        t = threading.Thread(target=fill, daemon=True,
                             name="bigdl-torch-device-loader")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                rec.inc("dataloader/stall_seconds", time.perf_counter() - t0)
                rec.gauge("dataloader/queue_depth", q.qsize())
                if isinstance(item, _End):
                    return
                if isinstance(item, _Raise):
                    raise item.exc
                rec.inc("dataloader/batches")
                yield item
        finally:
            stop.set()


def _flatten(arrays):
    """``(spec, leaves)`` of a tuple whose items may be tuples or lists
    of arrays (one level)."""
    spec, leaves = [], []
    for a in arrays:
        if isinstance(a, (tuple, list)):
            spec.append((type(a), len(a)))
            leaves.extend(a)
        else:
            spec.append(None)
            leaves.append(a)
    return spec, leaves


def _unflatten(spec, leaves) -> tuple:
    out, i = [], 0
    for s in spec:
        if s is None:
            out.append(leaves[i])
            i += 1
        else:
            kind, n = s
            out.append(kind(leaves[i:i + n]))
            i += n
    return tuple(out)


class Staged:
    """A batch placed by :class:`HostToDevice`: its tensors and, on a
    CUDA device, the event recorded after their copies."""

    __slots__ = ("tensors", "event", "_audit", "_spec")

    def __init__(self, tensors, event=None, audit=None, spec=None):
        self.tensors = tensors
        self.event = event
        self._audit = audit
        self._spec = spec

    def take(self) -> tuple:
        """The batch, ready for the current stream (see
        :meth:`_take_flat`), in the nesting it was placed with."""
        flat = self._take_flat()
        return _unflatten(self._spec, flat) if self._spec is not None \
            else flat

    def _take_flat(self) -> tuple:
        """The tensors, ready for the current stream: it waits on the
        copies' event, and each tensor is recorded on it.  With an audit
        list, an event recorded on the current stream right after the
        wait goes beside the copies' event, so that a caller can check
        that no batch was read before its copy completed."""
        if self.event is not None:
            placed = [t for t in self.tensors if t is not None]
            cur = torch.cuda.current_stream(placed[0].device)
            cur.wait_event(self.event)
            for t in placed:
                t.record_stream(cur)
            if self._audit is not None:
                used = torch.cuda.Event(enable_timing=True)
                used.record(cur)
                self._audit.append((self.event, used))
        return tuple(self.tensors)


class HostToDevice:
    """Places host batches (tuples of numpy arrays, ``None`` kept as it
    is) on ``device``; see the module's docstring.  ``audit=True`` keeps
    ``(copy event, use event)`` pairs in :attr:`audit` for every batch
    taken."""

    def __init__(self, device, depth: int = 2, audit: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.audit: Optional[List] = [] if audit else None
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._bufs: List[Optional[list]] = [None] * (depth + 1)
            self._events: List[Optional[torch.cuda.Event]] = \
                [None] * (depth + 1)
            self._next = 0

    def __call__(self, arrays: Sequence) -> Staged:
        spec = None
        if any(isinstance(a, (tuple, list)) for a in arrays):
            # a nested input (a two-tower's (uids, mids)): placed flat,
            # handed back in its nesting
            spec, arrays = _flatten(arrays)
        hosts = [None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)) for a in arrays]
        if not self.cuda:
            return Staged([None if h is None else h.to(self.device)
                           for h in hosts], spec=spec)
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        if self._events[slot] is not None:
            # the pinned buffers of this slot are refilled only after
            # their last copy has completed
            self._events[slot].synchronize()
        old = self._bufs[slot] or [None] * len(hosts)
        bufs, out = [], []
        with torch.cuda.stream(self.stream):
            for h, b in zip(hosts, old + [None] * (len(hosts) - len(old))):
                if h is None:
                    bufs.append(None)
                    out.append(None)
                    continue
                if b is None or b.shape != h.shape or b.dtype != h.dtype:
                    b = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                b.copy_(h)
                d = torch.empty(h.shape, dtype=h.dtype, device=self.device)
                d.copy_(b, non_blocking=True)
                bufs.append(b)
                out.append(d)
            ev = torch.cuda.Event(enable_timing=self.audit is not None)
            ev.record(self.stream)
        self._bufs[slot] = bufs
        self._events[slot] = ev
        return Staged(out, ev, self.audit, spec)
