"""Sharded streaming input pipeline — the production data plane (≙
``bigdl_tpu/data/sharded.py``: the same plans, batches and cursors, so
that a cursor written by either package restores the other's stream).

BigDL feeds ImageNet from Hadoop SequenceFile shards through a thread
pool that overlaps IO/augmentation with compute
(``MTLabeledBGRImgToBatch`` + the Engine's prefetching iterators).  This
module is that design, built to keep ``data/input_stall_seconds`` ≈ 0:

  1. **Deterministic shard planning** — every epoch, the file list is
     permuted by a seeded shuffle (:func:`epoch_order`, a pure function
     of ``(seed, epoch)``) and split at FILE level across
     ``process_count × n_workers`` global readers
     (:func:`plan_epoch`); the uneven tail (file count not divisible by
     worker count) just gives some workers one more file.  The union of
     all workers' assignments is every file exactly once per epoch.

  2. **Parallel host decode** — each local worker runs a thread that
     streams records out of its files (TFRecord / SequenceFile /
     fixed-length framing, CRC-resync salvage over corrupt regions —
     the ``read_events(salvage=True)`` pattern) and decodes them
     off the consumer's critical path.  The batcher drains the worker
     queues in deterministic round-robin, so the emitted sample order
     depends only on the plan — never on thread scheduling.

  3. **Owned-buffer staging** — batches are collated with copying
     ``np.stack`` (never views into a read buffer) and handed to a
     staging thread that runs ``place_fn`` ``staging_depth`` batches
     ahead: double-buffered h2d that overlaps the device step.  On a
     CUDA device ``place_fn`` is a
     :class:`~bigdl_tpu_torch.data.device_loader.HostToDevice`: pinned
     buffers copied on a side stream, one event a batch; the consumer
     takes the :class:`~bigdl_tpu_torch.data.device_loader.Staged`
     batch on its own thread, so its stream waits on that event.

  4. **Deterministic data cursor** — every emitted batch carries the
     exact read position (per-worker remaining ``[file, offset]``
     lists + round-robin pointer); :meth:`ShardedRecordDataSet.state`
     returns the cursor of the last batch the CONSUMER pulled, so a
     checkpoint taken between steps resumes with no sample re-seen or
     skipped.  :func:`replan_cursors` redistributes the remaining work
     of an epoch across a different worker/host count (the elastic
     path's data-plane half).

Determinism contract (what the tests assert):

  * same config + same cursor  → bit-identical sample sequence;
  * any worker/host replan     → exactly-once (set-identical remainder,
    no duplicates), order may differ;
  * the global batch stream never depends on the device mesh, so a
    dp4→dp2 elastic resume replays the identical sequence.

Telemetry (``data/*`` family, on the dataset's ``recorder``):
``data/input_stall_seconds`` (consumer blocked on an empty staging
queue — THE number this module exists to zero), ``data/queue_depth``,
``data/h2d_bytes``, ``data/decode_seconds``, ``data/records_read``,
``data/resync_skipped_bytes``, ``data/batches``,
``data/files_skipped`` (shards abandoned after retries — degradation,
never silence: each one also lands as a ``health_event``).

Transient-fault posture: shard opens and record reads run under a
:class:`~bigdl_tpu.utils.retry.RetryPolicy` — a transient EIO re-reads
the file from the current record index (yielded-record indices are
stable, so nothing is re-seen or skipped); on giveup (or a fatal errno
like EACCES) the worker SKIPS that file with a loud
``data/files_skipped`` count + health event instead of killing the
epoch.  The ``data.shard_open`` / ``data.record_read`` sites of
:mod:`bigdl_tpu_torch.faults` make both paths testable.

Fixed-length shards are read by the native runtime's ring
(:class:`~bigdl_tpu_torch.native.NativePrefetcher`, a resume seeking
through its header offset); there is no Python fallback, so a missing
``g++`` raises.
"""
from __future__ import annotations

import os
import queue
import random
import struct
import threading
import time
import weakref
from typing import Callable, List, Optional, Sequence

import numpy as np

from .dataset import DataSet
from .device_loader import Staged
from .. import faults as faultplane
from ..utils.crc32c import masked_crc32c
from ..utils.retry import RetryPolicy

CURSOR_VERSION = 1

_END = object()      # one per worker stream, then the stream is done
_STOPPED = object()  # _get() observed the stop event
_WEND = ("end",)     # batcher consumed a worker's terminal sentinel


class _RaiseItem:
    def __init__(self, exc):
        self.exc = exc


class _DecodeFailure(Exception):
    """Wrapper that carries a user decode() exception PAST the worker's
    I/O-error handling: a decode bug must surface at the consumer even
    when it happens to raise OSError (a missing side file, say) — the
    retry-then-skip degradation is for shard I/O only."""

    def __init__(self, error):
        super().__init__(repr(error))
        self.error = error


def _put(q: "queue.Queue", item, stop: threading.Event,
         timeout: float = 0.1) -> bool:
    """Stop-aware bounded put: never blocks forever on an abandoned
    consumer (the PrefetchedDataSet leak class, closed by design)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=timeout)
            return True
        except queue.Full:
            continue
    return False


def _get(q: "queue.Queue", stop: threading.Event, timeout: float = 0.1):
    while not stop.is_set():
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            continue
    return _STOPPED


# --------------------------------------------------------------------- #
# shard planning: pure functions of (files, seed, epoch, world)         #
# --------------------------------------------------------------------- #
def epoch_order(n_files: int, seed: int, epoch: int) -> List[int]:
    """Seeded per-epoch permutation of file indices — a pure function of
    ``(seed, epoch)``, so every host (and every resumed run) derives the
    identical order without coordination."""
    rng = np.random.RandomState(
        (int(seed) * 1000003 + int(epoch) * 7919 + 17) % (2 ** 31 - 1))
    idx = np.arange(n_files)
    rng.shuffle(idx)
    return [int(i) for i in idx]


def plan_epoch(n_files: int, seed: int, epoch: int, process_index: int,
               process_count: int, n_workers: int,
               shuffle: bool = True) -> List[List[List[int]]]:
    """This host's per-worker file plans for one epoch.

    Returns ``[worker][k] = [file_index, start_record]`` — global worker
    ``g = process_index * n_workers + worker`` takes files
    ``order[g::world]``.  Disjoint across the world by construction and
    exhaustive (every file lands on exactly one worker), including the
    uneven tail where ``world`` does not divide the file count.
    """
    if not (0 <= process_index < process_count):
        raise ValueError(f"process_index {process_index} outside "
                         f"process_count {process_count}")
    order = epoch_order(n_files, seed, epoch) if shuffle \
        else list(range(n_files))
    world = process_count * n_workers
    plans = []
    for w in range(n_workers):
        g = process_index * n_workers + w
        plans.append([[fi, 0] for fi in order[g::world]])
    return plans


def _deal_round_robin(worker_lists: Sequence[Sequence[Sequence[int]]],
                      n_slots: int) -> List[List[List[int]]]:
    """Flatten remaining ``[file, offset]`` entries in round-robin order
    across the old workers (entry k of every worker before entry k+1 —
    approximately preserving the original interleave) and deal them
    round-robin onto ``n_slots`` new workers.  The union of entries is
    untouched, so exactly-once survives any regrouping.  Shared by
    :func:`replan_cursors` and the local replan in
    :meth:`ShardedRecordDataSet.restore` — the two MUST stay in
    lockstep or a resumed stream diverges from a replanned one."""
    remaining: List[List[int]] = []
    depth = max((len(w) for w in worker_lists), default=0)
    for k in range(depth):
        for w in worker_lists:
            if k < len(w):
                remaining.append([int(w[k][0]), int(w[k][1])])
    dealt: List[List[List[int]]] = [[] for _ in range(n_slots)]
    for i, entry in enumerate(remaining):
        dealt[i % n_slots].append(entry)
    return dealt


def replan_cursors(states: Sequence[dict], process_count: int,
                   n_workers: int,
                   n_files: Optional[int] = None) -> List[dict]:
    """Redistribute the remaining work of one epoch's cursors onto a
    NEW ``process_count × n_workers`` world (the elastic-resume path: a
    job that shrank from 2 hosts to 1 hands both hosts' cursors in and
    gets one host's cursor out).

    Every host's cursor covers only its own workers, so a host-count
    change needs EVERY old host's state — a missing host's files would
    silently be skipped, so incompleteness raises.  A fresh cursor
    (``workers: None`` — that host had not started the epoch) stands
    for its FULL epoch plan; expanding it needs the shard-file count,
    so pass ``n_files=len(paths)`` when any state may be fresh.
    Exactly-once is preserved: the union of remaining entries is
    regrouped, never changed.  Subsequent epochs are planned fresh for
    the new world.
    """
    if not states:
        raise ValueError("replan_cursors needs at least one cursor")
    base = states[0]
    old_pc = int(base.get("process_count", 1))
    for s in states[1:]:
        if (s.get("seed"), s.get("epoch")) != (base.get("seed"),
                                               base.get("epoch")):
            raise ValueError("cursors disagree on (seed, epoch): "
                             "they are not from one run")
        if int(s.get("process_count", 1)) != old_pc:
            raise ValueError("cursors disagree on process_count: "
                             "they are not from one run")
    covered = {}
    for s in states:
        pi = int(s.get("process_index", 0))
        if pi in covered:
            raise ValueError(f"duplicate cursor for process {pi}")
        covered[pi] = s
    missing = sorted(set(range(old_pc)) - set(covered))
    if missing:
        raise ValueError(
            f"replan_cursors needs every old host's cursor; missing "
            f"process(es) {missing} of {old_pc} — their remaining "
            "files would silently be skipped")
    old_workers = []
    for pi in sorted(covered):
        s = covered[pi]
        if s.get("workers") is not None:
            old_workers.extend(s["workers"])
            continue
        # fresh cursor: this host had not started the epoch, so its
        # remaining work is its ENTIRE epoch plan
        if n_files is None:
            raise ValueError(
                f"process {pi}'s cursor is a fresh epoch start "
                "(workers: None); expanding it needs "
                "n_files=len(paths)")
        old_workers.extend(plan_epoch(
            int(n_files), int(base.get("seed", 0)),
            int(base.get("epoch", 0)), pi, old_pc,
            int(s.get("n_workers", 1))))
    dealt = _deal_round_robin(old_workers, process_count * n_workers)
    out = []
    for p in range(process_count):
        out.append({
            "version": CURSOR_VERSION,
            "seed": base.get("seed"), "epoch": base.get("epoch"),
            "process_index": p, "process_count": process_count,
            "n_workers": n_workers, "rr": 0,
            "workers": dealt[p * n_workers:(p + 1) * n_workers],
        })
    return out


# --------------------------------------------------------------------- #
# record streams: framing + CRC-resync salvage per format               #
# --------------------------------------------------------------------- #
def _frame_tfrecord(data: bytes, i: int):
    """Frame one TFRecord at offset ``i``; ``(payload, next)`` when both
    masked CRCs verify, else None (the salvage reader's check — the
    frame check IS the resync condition)."""
    if i + 12 > len(data):
        return None
    header = data[i:i + 8]
    (length,) = struct.unpack("<Q", header)
    (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
    if masked_crc32c(header) != hcrc:
        return None
    if i + 12 + length + 4 > len(data):
        return None
    payload = data[i + 12:i + 12 + length]
    (pcrc,) = struct.unpack("<I", data[i + 12 + length:i + 16 + length])
    if masked_crc32c(payload) != pcrc:
        return None
    return payload, i + 12 + length + 4


def iter_tfrecord_salvage(path: str, start: int = 0, salvage: bool = True,
                          on_skip: Optional[Callable[[int], None]] = None):
    """Yield TFRecord payloads from record index ``start``.

    ``salvage=True`` scans past corrupt regions to the next offset that
    frames (both CRCs verify) instead of failing the file; each skipped
    byte range is reported through ``on_skip(n_bytes)``.  Record indices
    count YIELDED records, so they are stable across re-reads — a
    resumed cursor skips the same corrupt region the original pass did.
    """
    with open(path, "rb") as f:
        data = f.read()
    i, n = 0, 0
    while i + 12 <= len(data):
        framed = _frame_tfrecord(data, i)
        if framed is None:
            if not salvage:
                raise IOError(f"{path}: corrupt TFRecord at byte {i}")
            j = i + 1
            while j + 12 <= len(data) and _frame_tfrecord(data, j) is None:
                j += 1
            if j + 12 > len(data):
                j = len(data)           # trailing garbage: skip the tail
            if on_skip is not None:
                on_skip(j - i)
            i = j
            continue
        payload, i = framed
        if n >= start:
            yield payload
        n += 1
    if salvage and 0 < len(data) - i and on_skip is not None:
        on_skip(len(data) - i)          # torn tail shorter than a header


def iter_seqfile_salvage(path: str, start: int = 0, salvage: bool = True,
                         on_skip: Optional[Callable[[int], None]] = None):
    """Yield SequenceFile ``(key, value)`` pairs from record ``start``,
    resyncing on the 16-byte sync marker (``-1`` escape + sync) when a
    record's framing is implausible — the format has no per-record CRC,
    so plausibility (non-negative lengths that fit the file) is the
    corruption signal and the sync marker is the recovery point."""
    from ..utils.seqfile import SequenceFileReader
    r = SequenceFileReader(path)
    data, sync = r.data, r.sync
    escape = struct.pack(">i", -1) + sync
    pos, n = r._start, 0
    while pos + 4 <= len(data):
        (rec_len,) = struct.unpack_from(">i", data, pos)
        if rec_len == -1:
            if data[pos + 4:pos + 20] == sync:
                pos += 20
                continue
            rec_len = -2                # -1 without the sync: corrupt
        # layout: rec_len(4) | key_len(4) | key | value, where
        # rec_len = len(key bytes) + len(value bytes)
        ok = rec_len >= 0 and pos + 8 + rec_len <= len(data)
        if ok:
            (key_len,) = struct.unpack_from(">i", data, pos + 4)
            ok = 0 <= key_len <= rec_len
        if not ok:
            if not salvage:
                raise IOError(f"{path}: corrupt SequenceFile record at "
                              f"byte {pos}")
            j = data.find(escape, pos + 1)
            j = len(data) if j < 0 else j
            if on_skip is not None:
                on_skip(j - pos)
            pos = j
            continue
        body = data[pos + 8:pos + 8 + rec_len]
        key = r._deserialize(body[:key_len], r.key_class)
        value = r._deserialize(body[key_len:], r.value_class)
        pos += 8 + rec_len
        if n >= start:
            yield key, value
        n += 1


def iter_fixed_records(path: str, record_bytes: int, header_bytes: int = 0,
                       start: int = 0):
    """Yield fixed-length records from record index ``start``, read by
    the native runtime's ring; a mid-file start is a header offset of
    ``header_bytes + start * record_bytes`` (its mmap readers have no
    seek)."""
    from .. import native
    pf = native.NativePrefetcher(
        [path], record_bytes, header_bytes + int(start) * record_bytes,
        capacity=64, n_workers=1, loop=False)
    try:
        yield from pf
    finally:
        pf.close()


def count_records(path: str, fmt: str, record_bytes: Optional[int] = None,
                  header_bytes: int = 0, salvage: bool = True) -> int:
    """Number of (salvageable) records in one shard file."""
    if fmt == "fixed":
        return max(0, (os.path.getsize(path) - header_bytes)
                   // int(record_bytes))
    if fmt == "tfrecord":
        return sum(1 for _ in iter_tfrecord_salvage(path, salvage=salvage))
    if fmt == "seqfile":
        return sum(1 for _ in iter_seqfile_salvage(path, salvage=salvage))
    raise ValueError(f"unknown shard format {fmt!r}")


def _default_collate(samples):
    """(x, y) batches from (x, y) samples — copying np.stack, so the
    staged batch OWNS its memory whatever buffers decode returned."""
    first = samples[0]
    if isinstance(first, tuple) and len(first) == 2:
        xs, ys = zip(*samples)
        y0 = ys[0]
        y = None if y0 is None else np.stack([np.asarray(v) for v in ys])
        return np.stack([np.asarray(v) for v in xs]), y
    return (np.stack([np.asarray(v) for v in samples]), None)


def _host_nbytes(tree) -> int:
    total = 0
    stack = [tree]
    while stack:
        v = stack.pop()
        if isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (np.ndarray, np.generic)):
            total += v.nbytes
    return total


class _StreamIterator:
    """One epoch's batch stream: iterable, explicitly closable, and
    GC-safe — a finalizer trips the stop event so abandoned iteration
    (break / exception / dropped reference) never strands the worker or
    stager threads on a bounded queue."""

    def __init__(self, pipeline: "ShardedRecordDataSet", epoch: int,
                 cursor: Optional[dict], train: bool):
        self._pipe = pipeline
        self._epoch = int(epoch)
        self._track = train     # eval streams never move the train cursor
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._plans = None      # set by _start_stream
        self._out: "queue.Queue" = queue.Queue(pipeline.staging_depth)
        self._finalizer = weakref.finalize(self, _finalize_stream,
                                           self._stop)
        pipeline._start_stream(self, epoch, cursor, train)

    def __iter__(self):
        return self

    def __next__(self):
        rec = self._pipe._rec()
        t0 = time.perf_counter()
        while True:
            try:
                item = self._out.get(timeout=0.5)
                break
            except queue.Empty:
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError(
                        "sharded input stream died without a terminal "
                        "item (worker/stager thread crashed hard)")
        if rec.enabled:
            rec.inc("data/input_stall_seconds",
                    time.perf_counter() - t0)
            rec.gauge("data/queue_depth", self._out.qsize())
        if item is _END:
            if self._track:
                self._pipe._mark_epoch_done(self._epoch)
            self.close()
            raise StopIteration
        if isinstance(item, _RaiseItem):
            self.close()
            raise item.exc
        batch, snap = item
        if self._track:
            self._pipe._commit_cursor(self._epoch, snap, self._plans)
        if rec.enabled:
            rec.inc("data/batches")
        # a batch the stager copied to the card: the consumer's stream
        # waits on its copies' event here, on the consumer's thread
        return batch.take() if isinstance(batch, Staged) else batch

    def close(self, timeout: float = 5.0):
        """Stop the worker and stager threads and wait (up to
        ``timeout`` s each) for them to leave: a process that exits with
        the stager inside ``place_fn`` (a torch op) can abort in torch's
        static destructors."""
        self._stop.set()
        me = threading.current_thread()
        for t in self._threads:
            if t is not me and t.is_alive():
                t.join(timeout)


def _finalize_stream(stop: threading.Event):
    stop.set()


class ShardedRecordDataSet(DataSet):
    """Multi-host auto-sharded streaming record dataset.

    ``paths``          shard files (every host passes the SAME list in
                       the SAME order; the planner derives this host's
                       split)
    ``fmt``            "tfrecord" | "seqfile" | "fixed"
    ``decode``         ``decode(record) -> sample`` run on the worker
                       pool (record is payload bytes; ``(key, value)``
                       for seqfile).  With ``decode_rng=True`` it is
                       called ``decode(record, rng)`` with a
                       per-record ``np.random.RandomState`` derived
                       statelessly from ``(seed, epoch, file, index)``
                       — host augmentation that resumes exactly without
                       serializing RNG streams into the cursor.
    ``batch_size``     rows per emitted batch (per HOST; the global
                       batch is ``batch_size × process_count``)
    ``n_workers``      local decode threads (file-level split)
    ``queue_depth``    per-worker decoded-sample buffer
    ``staging_depth``  placed-batch buffer (2 = classic double buffer)
    ``place_fn``       ``place_fn((x, y))`` run on the staging thread,
                       so that h2d overlaps the step: ``(x, y)``, or a
                       :class:`~bigdl_tpu_torch.data.device_loader
                       .Staged` that the consumer takes (a
                       ``HostToDevice(device)``); the optimizers install
                       theirs via :meth:`set_place_fn`
    ``salvage``        resync past corrupt regions instead of failing
                       the file (counted in
                       ``data/resync_skipped_bytes``)
    ``recorder``       the ``data/*`` counters' Recorder (a private one
                       when None)

    ``self_staging = True`` tells the optimizers this dataset already
    prefetches + stages: wrapping it in another DeviceLoader would read
    ahead of training and break the exactly-once cursor.
    """

    self_staging = True

    def __init__(self, paths: Sequence[str], fmt: str = "tfrecord",
                 decode: Optional[Callable] = None, batch_size: int = 32,
                 *, record_bytes: Optional[int] = None,
                 header_bytes: int = 0, n_workers: int = 2,
                 queue_depth: int = 16, staging_depth: int = 2,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, salvage: bool = True,
                 drop_last: bool = True, shuffle: bool = True,
                 collate: Optional[Callable] = None,
                 place_fn: Optional[Callable] = None,
                 decode_rng: bool = False, recorder=None,
                 read_retries: int = 3, retry_base: float = 0.05):
        if fmt not in ("tfrecord", "seqfile", "fixed"):
            raise ValueError(f"unknown shard format {fmt!r}")
        if fmt == "fixed" and not record_bytes:
            raise ValueError("fmt='fixed' needs record_bytes=")
        if not paths:
            raise ValueError("no shard files")
        if n_workers < 1 or queue_depth < 1 or staging_depth < 1:
            raise ValueError("n_workers/queue_depth/staging_depth >= 1")
        self.paths = [os.fspath(p) for p in paths]
        self.fmt = fmt
        self.decode = decode
        self.batch_size = int(batch_size)
        self.record_bytes = record_bytes
        self.header_bytes = header_bytes
        self.n_workers = int(n_workers)
        self.queue_depth = int(queue_depth)
        self.staging_depth = int(staging_depth)
        self.seed = int(seed)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.salvage = bool(salvage)
        self.drop_last = bool(drop_last)
        self._shuffle = bool(shuffle)
        self.collate = collate or _default_collate
        self.place_fn = place_fn
        self.decode_rng = bool(decode_rng)
        if recorder is None:
            from ..observability import Recorder
            recorder = Recorder()
        self.recorder = recorder
        self.read_retries = max(1, int(read_retries))
        self.retry_base = float(retry_base)
        self._cursor: Optional[dict] = None
        self._size: Optional[int] = None

    # -- DataSet surface ------------------------------------------------ #
    def _rec(self):
        return self.recorder

    def size(self) -> int:
        """Total records across ALL shard files (scanned once, cached)."""
        if self._size is None:
            self._size = sum(
                count_records(p, self.fmt, self.record_bytes,
                              self.header_bytes, self.salvage)
                for p in self.paths)
        return self._size

    def batches_per_epoch(self):
        # per-host batch count is data-dependent under salvage/uneven
        # splits; None tells the trainers to just iterate
        return None

    def set_place_fn(self, fn):
        """Install the device-placement hook run on the staging thread
        (h2d overlap); the optimizers call this with theirs."""
        self.place_fn = fn
        return self

    # -- cursor --------------------------------------------------------- #
    def _cursor_dict(self) -> Optional[dict]:
        """Materialize the committed cursor into its JSON dict form.

        Per-batch commits are LAZY — ``(epoch, per-worker (pos, off),
        rr, shared plans ref)``, O(n_workers) per batch — because a
        full ``workers`` snapshot is O(remaining shard files) and only
        a checkpoint actually needs it.  Materialization caches back,
        so repeated state() calls between batches are free."""
        cur = self._cursor
        if cur is None or isinstance(cur, dict):
            return cur
        epoch, pos, rr, plans = cur
        workers = []
        for w, p in enumerate(pos):
            if p is _WEND:
                workers.append([])
            elif p is None:     # nothing consumed yet: full plan
                workers.append([list(e) for e in plans[w]])
            else:
                li, off = p
                tail = plans[w][li:]
                workers.append([[tail[0][0], int(off)]]
                               + [list(e) for e in tail[1:]])
        out = {"version": CURSOR_VERSION, "seed": self.seed,
               "epoch": int(epoch),
               "process_index": self.process_index,
               "process_count": self.process_count,
               "n_workers": self.n_workers, "rr": int(rr),
               "workers": workers}
        self._cursor = out
        return out

    def state(self) -> dict:
        """Cursor of the last batch the consumer PULLED — exactly the
        samples training has consumed, whatever the worker/staging
        threads have read ahead.  JSON-safe; goes into checkpoint
        metadata.  After an epoch completes it carries ``done: True``
        (nothing remaining in that epoch; the next ``data()`` plans
        the following epoch fresh)."""
        cur = self._cursor_dict()
        if cur is None:
            return self._fresh_cursor(0)
        return dict(cur)

    def restore(self, state: dict):
        """Resume from a :meth:`state` cursor.  Same reader config →
        bit-identical continuation.  A different LOCAL worker count
        replans this host's remaining files (exactly-once preserved;
        interleave order changes).  A different host world needs every
        host's cursor — see :func:`replan_cursors`."""
        if not isinstance(state, dict) or "epoch" not in state:
            raise ValueError(f"not a data cursor: {state!r}")
        if int(state.get("version", 0)) > CURSOR_VERSION:
            raise ValueError(
                f"data cursor version {state.get('version')} is newer "
                f"than this library ({CURSOR_VERSION})")
        if state.get("seed") != self.seed:
            raise ValueError(
                f"cursor seed {state.get('seed')} != dataset seed "
                f"{self.seed}: the shard order would silently diverge")
        if state.get("workers") is None:
            self._cursor = self._fresh_cursor(int(state["epoch"]))
            return self
        same_world = (int(state.get("process_count", 1))
                      == self.process_count
                      and int(state.get("process_index", 0))
                      == self.process_index)
        if not same_world:
            raise ValueError(
                "cursor was written by process "
                f"{state.get('process_index')}/"
                f"{state.get('process_count')} but this dataset is "
                f"{self.process_index}/{self.process_count}; a host-"
                "world change must be re-planned from ALL hosts' "
                "cursors first — replan_cursors(states, process_count, "
                "n_workers)")
        workers = [[[int(f), int(o)] for f, o in w]
                   for w in state["workers"]]
        bad = sorted({f for w in workers for f, _ in w
                      if not 0 <= f < len(self.paths)})
        if bad:
            raise ValueError(
                f"cursor references shard file indices {bad} but this "
                f"dataset has {len(self.paths)} paths — the cursor was "
                "written against a different shard list (positions "
                "would mean different records; pass the same paths in "
                "the same order)")
        rr = int(state.get("rr", 0))
        if len(workers) != self.n_workers:
            # local replan: deal this host's remaining entries across
            # the new local worker count (host-local, so safe without
            # the other hosts' cursors)
            workers = _deal_round_robin(workers, self.n_workers)
            rr = 0
        self._cursor = {
            "version": CURSOR_VERSION, "seed": self.seed,
            "epoch": int(state["epoch"]),
            "process_index": self.process_index,
            "process_count": self.process_count,
            "n_workers": self.n_workers, "rr": rr, "workers": workers,
        }
        if state.get("done"):
            self._cursor["done"] = True
        return self

    def _fresh_cursor(self, epoch: int) -> dict:
        return {"version": CURSOR_VERSION, "seed": self.seed,
                "epoch": int(epoch),
                "process_index": self.process_index,
                "process_count": self.process_count,
                "n_workers": self.n_workers, "rr": 0, "workers": None}

    def _commit_cursor(self, epoch: int, snap, plans):
        # lazy commit: (epoch, per-worker positions, rr, shared plans)
        # — materialized into the dict form only when state() (a
        # checkpoint) or the next data() call asks
        pos, rr = snap
        self._cursor = (epoch, pos, rr, plans)

    def _mark_epoch_done(self, epoch: int):
        """The consumer drained this epoch's stream: record completion
        so ``data(epoch=None)`` rolls to the next epoch instead of
        resuming an empty remainder forever.  Any drop_last tail the
        batcher discarded is discarded by EVERY run of this epoch, so
        'nothing remaining' is the exactly-once-consistent record."""
        done = self._fresh_cursor(epoch)
        done["workers"] = [[] for _ in range(self.n_workers)]
        done["done"] = True
        self._cursor = done

    # -- iteration ------------------------------------------------------ #
    def data(self, train=True, epoch: Optional[int] = None):
        """One epoch's batch stream.  An EXPLICIT ``epoch`` selects the
        shard order (resuming the cursor when it matches the cursor's
        epoch — a fully-consumed epoch then yields nothing, which is
        how the optimizers detect a boundary resume); ``epoch=None``
        continues from the cursor and rolls past a completed epoch, so
        the generic ``for e: for b in ds.data(train=True)`` loop sees
        a fresh epoch each pass.  ``train=False`` streams in file
        order with no shuffle and no cursor tracking."""
        if not train:
            return _StreamIterator(self, 0, None, train=False)
        cur = self._cursor_dict()
        if epoch is None:
            if cur is None:
                epoch = 0
            elif cur.get("done"):
                epoch = cur["epoch"] + 1    # previous epoch consumed
            else:
                epoch = cur["epoch"]
        cursor = None
        if (cur is not None and cur.get("epoch") == int(epoch)
                and cur.get("workers") is not None):
            cursor = cur
        return _StreamIterator(self, int(epoch), cursor, train=True)

    def stream(self, max_epochs: Optional[int] = None):
        """Continuous batch stream across epochs (the step-driven
        SpmdTrainer feed): epochs roll over automatically, the cursor
        tracks both epoch and position."""
        done = 0
        while max_epochs is None or done < max_epochs:
            it = self.data(train=True, epoch=None)
            try:
                yield from it
            finally:
                it.close()      # a consumer that stops early stops it too
            done += 1

    # -- the three pipeline stages -------------------------------------- #
    def _start_stream(self, it: _StreamIterator, epoch: int,
                      cursor: Optional[dict], train: bool):
        if cursor is not None:
            plans = [[[int(f), int(o)] for f, o in w]
                     for w in cursor["workers"]]
            rr = int(cursor.get("rr", 0))
        else:
            plans = plan_epoch(len(self.paths), self.seed, epoch,
                               self.process_index, self.process_count,
                               self.n_workers,
                               shuffle=self._shuffle and train)
            rr = 0
        it._plans = plans   # shared, IMMUTABLE: lazy cursors index it
        stop = it._stop
        worker_qs = [queue.Queue(self.queue_depth)
                     for _ in range(self.n_workers)]
        for w in range(self.n_workers):
            t = threading.Thread(
                target=self._worker_loop,
                args=(w, plans[w], worker_qs[w], stop, epoch),
                daemon=True, name=f"bigdl-shard-worker-{w}")
            it._threads.append(t)
        stager = threading.Thread(
            target=self._stage_loop,
            args=(worker_qs, plans, rr, epoch, it._out, stop, train),
            daemon=True, name="bigdl-shard-stager")
        it._threads.append(stager)
        for t in it._threads:
            t.start()

    def _records(self, file_index: int, start: int, on_skip):
        path = self.paths[file_index]
        if self.fmt == "tfrecord":
            return iter_tfrecord_salvage(path, start, self.salvage,
                                         on_skip)
        if self.fmt == "seqfile":
            return iter_seqfile_salvage(path, start, self.salvage,
                                        on_skip)
        return iter_fixed_records(path, self.record_bytes,
                                  self.header_bytes, start)

    def _worker_loop(self, w: int, plan, q, stop, epoch: int):
        """Stream + decode this worker's files; emit
        ``(sample, plan_pos, next_offset)`` so the batcher can cut an
        exact cursor after any sample."""
        rec = self._rec()
        stats = {"read": 0, "decode": 0.0, "skipped": 0}

        def flush(force=False):
            if not rec.enabled:
                stats.update(read=0, decode=0.0, skipped=0)
                return
            if force or stats["read"] >= 256:
                if stats["read"]:
                    rec.inc("data/records_read", stats["read"])
                if stats["decode"]:
                    rec.inc("data/decode_seconds", stats["decode"])
                if stats["skipped"]:
                    rec.inc("data/resync_skipped_bytes", stats["skipped"])
                stats.update(read=0, decode=0.0, skipped=0)

        def on_skip(n):
            stats["skipped"] += n

        # transient read errors retry per FILE from the current record
        # index (yielded-record indices are stable across re-reads, so
        # a retried file resumes exactly where it stopped — exactly-once
        # survives the retry); the jitter RNG is seeded per worker so a
        # resumed run schedules identically
        policy = RetryPolicy(
            max_attempts=self.read_retries, base=self.retry_base,
            max_delay=0.5, rng=random.Random(self.seed * 31 + w),
            recorder_fn=lambda: rec, name="data")

        try:
            for li, (fi, start) in enumerate(plan):
                off = int(start)
                # a retried attempt re-SCANS bytes the failed attempt
                # already salvaged past: replay the first `counted`
                # skip bytes silently (they were accounted) and count
                # only the excess.  Corrupt regions re-read in the same
                # order with the same sizes, so a byte-level high-water
                # mark is exact — no double count when the failure came
                # late, no undercount when it came before the first
                # yield
                counted = [0]       # skip bytes accounted for this file
                replayed = [0]      # skip bytes re-seen this attempt

                def skip_gate(n, _on_skip=on_skip, _c=counted,
                              _r=replayed):
                    fresh = max(0, _r[0] + n - _c[0])
                    _r[0] += n
                    if fresh:
                        _c[0] += fresh
                        _on_skip(fresh)

                def read_file(li=li, fi=int(fi), _r=replayed):
                    nonlocal off
                    _r[0] = 0
                    faultplane.inject("data.shard_open", rec)
                    for payload in self._records(fi, off, skip_gate):
                        faultplane.inject("data.record_read", rec)
                        t0 = time.perf_counter()
                        try:
                            if self.decode is None:
                                sample = payload
                            elif self.decode_rng:
                                sample = self.decode(
                                    payload,
                                    self._record_rng(epoch, fi, off))
                            else:
                                sample = self.decode(payload)
                        except BaseException as e:
                            raise _DecodeFailure(e) from e
                        stats["decode"] += time.perf_counter() - t0
                        stats["read"] += 1
                        off += 1
                        flush()
                        if not _put(q, (sample, li, off), stop):
                            return False
                        if stop.is_set():
                            return False
                    return True

                try:
                    alive = policy.run(read_file)
                except _DecodeFailure as e:
                    raise e.error       # code bug: surface, never skip
                except OSError as e:
                    # retries exhausted (or a fatal errno like EACCES):
                    # degrade, never die — skip THIS file loudly and
                    # keep streaming the rest of the plan
                    rec.inc("data/files_skipped")
                    rec.emit_record(
                        "health_event", condition="data_file_skipped",
                        step=None, metric="data/files_skipped",
                        value=float(fi), threshold=None, action="skip")
                    print(f"[data] worker {w}: skipping shard "
                          f"{self.paths[int(fi)]} after retries "
                          f"({e!r}); this epoch is degraded by that "
                          "file's remaining records", flush=True)
                    continue
                if not alive:
                    return
            _put(q, _END, stop)
        except BaseException as e:      # surfaced at the consumer
            _put(q, _RaiseItem(e), stop)
        finally:
            flush(force=True)

    def _record_rng(self, epoch: int, file_index: int,
                    record_index: int) -> np.random.RandomState:
        """Stateless per-record RNG: nothing to checkpoint, and a resumed
        record sees the SAME stream the uninterrupted run gave it."""
        return np.random.RandomState(
            (self.seed * 1000003 + epoch * 8191 + file_index * 131071
             + record_index * 7 + 5) % (2 ** 31 - 1))

    def _stage_loop(self, worker_qs, plans, rr0: int, epoch: int, outq,
                    stop, train: bool):
        """Deterministic round-robin batcher + device stager: drains the
        worker queues in plan order (sample order is a function of the
        plan alone), collates owned batches, runs ``place_fn`` ahead of
        the consumer, and attaches an O(n_workers) cursor snapshot —
        per-worker ``(plan_pos, next_offset)`` against the shared,
        never-mutated plan; the full ``workers`` lists materialize only
        when a checkpoint asks (:meth:`_cursor_dict`)."""
        rec = self._rec()
        n = len(worker_qs)
        # pos[w]: None = nothing consumed (full plan remains),
        # (li, off) = last consumed sample's plan entry + next record,
        # _WEND = stream drained
        pos: List = [None] * n
        active = [True] * n
        rr = rr0 % max(n, 1)
        buf = []

        def emit(batch_samples):
            host = self.collate(batch_samples)
            if rec.enabled:
                rec.inc("data/h2d_bytes", _host_nbytes(host))
            placed = host if self.place_fn is None else self.place_fn(host)
            return _put(outq, (placed, (tuple(pos), rr)), stop)

        try:
            while any(active):
                if not active[rr]:
                    rr = (rr + 1) % n
                    continue
                item = _get(worker_qs[rr], stop)
                if item is _STOPPED:
                    return
                if item is _END:
                    active[rr] = False
                    pos[rr] = _WEND
                    rr = (rr + 1) % n
                    continue
                if isinstance(item, _RaiseItem):
                    _put(outq, item, stop)
                    return
                sample, li, off = item
                pos[rr] = (li, off)
                buf.append(sample)
                rr = (rr + 1) % n
                if len(buf) == self.batch_size:
                    if not emit(buf):
                        return
                    buf = []
            if buf and not self.drop_last:
                if not emit(buf):
                    return
            _put(outq, _END, stop)
        except BaseException as e:
            _put(outq, _RaiseItem(e), stop)
