"""CheckpointManager: async snapshot pipeline, atomic commit and resume
(≙ ``bigdl_tpu/checkpoint/manager.py``).

One manager owns one checkpoint root directory:

  save()            hand a host snapshot (:func:`host_snapshot`: owning
                    copies, taken by the caller under its
                    ``checkpoint.blocking`` span) to the background
                    writer; serialize, CRC, write, commit and GC run off
                    the step loop
  restore_latest()  the newest intact checkpoint: manifests are scanned
                    and every shard CRC-verified, falling back past torn
                    or corrupt checkpoints; the ``latest`` pointer is only
                    a hint, and a dangling or corrupt one is tolerated
  retention         keep-last-N plus keep-every-M-epochs GC after each
                    commit, and torn directories removed

Two layouts: ``"manifest"`` (sharded files + atomic ``MANIFEST.json``,
with part-manifests from several writers through ``process_index`` /
``process_count``) and ``"file"`` (one ``checkpoint_<tag>.bin`` a
checkpoint and a ``latest`` pointer holding its path).

The writer's time by part lands on counters: ``checkpoint/encode_seconds``
(serialize), ``checkpoint/crc_seconds``,
``checkpoint/io_seconds`` (write and fsync), ``checkpoint/commit_seconds``
(manifest, pointer and GC); a restore's on ``checkpoint/restore_scan_seconds``,
``checkpoint/restore_verify_seconds`` and
``checkpoint/restore_decode_seconds``.
"""
from __future__ import annotations

import glob
import os
import pickle
import re
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from . import faults, manifest as mlib, reshard
from .manifest import DIR_PREFIX, Manifest, Shard, data_crc32c, safe_tag
from .writer import AsyncCheckpointWriter
from ..utils.retry import RetryPolicy


def host_snapshot(tree):
    """Device→host copy that OWNS its memory: a nested dict (lists and
    tuples too) of numpy arrays.

    The port updates parameters and optimizer state in place (K5 writes
    its leaves), and the async writer serializes the snapshot while later
    steps run.  ``t.cpu()`` of a CPU tensor is the tensor itself and
    ``.numpy()`` shares its memory, so CPU leaves are cloned; CUDA leaves
    are copied into pinned host tensors on the current stream, and one
    synchronization waits for every copy.  This is the blocking half of
    the pipeline: call it under the ``checkpoint.blocking`` span, then
    hand the result to :meth:`CheckpointManager.save`.
    """
    import torch
    streams = set()

    def leaf(v):
        if isinstance(v, torch.Tensor):
            t = v.detach()
            if t.device.type == "cpu":
                return t.clone().numpy()
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
            streams.add(torch.cuda.current_stream(t.device))
            return dst
        if isinstance(v, (np.ndarray, np.generic)):
            return np.array(v)
        return v

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return leaf(t)

    out = walk(tree)
    for s in streams:
        s.synchronize()

    def to_numpy(t):
        if isinstance(t, dict):
            return {k: to_numpy(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(to_numpy(v) for v in t)
        return t.numpy() if isinstance(t, torch.Tensor) else t
    return to_numpy(out) if streams else out


def _serialize_tree(tree) -> bytes:
    """Serializer-format bytes, falling back to pickle for exotic leaves
    (a checkpoint trigger must never kill the run)."""
    from ..utils.serializer import SerializationError, state_file_bytes
    try:
        return state_file_bytes(tree)
    except SerializationError:
        return pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL)


def _load_payload_file(path: str):
    """Magic-byte routed load: the zip state file, else a pickle shard."""
    from ..utils.serializer import load_state_file
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        return load_state_file(path)
    with open(path, "rb") as f:
        return pickle.load(f)


class CheckpointManager:
    def __init__(self, root: str, layout: str = "manifest",
                 async_write: bool = True, keep_last: Optional[int] = None,
                 keep_every_epochs: Optional[int] = None,
                 recorder_fn: Optional[Callable] = None,
                 max_pending: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 part_timeout: float = 120.0, write_retries: int = 3):
        if layout not in ("manifest", "file"):
            raise ValueError(f"unknown checkpoint layout {layout!r}")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        if keep_every_epochs is not None and keep_every_epochs < 1:
            raise ValueError("keep_every_epochs must be >= 1")
        self.root = root
        self.layout = layout
        self.async_write = bool(async_write)
        self.keep_last = keep_last
        self.keep_every_epochs = keep_every_epochs
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.part_timeout = part_timeout
        self._rec_fn = recorder_fn
        os.makedirs(root, exist_ok=True)
        # one writer even for sync saves: every write runs on the same
        # thread, so writes+GC are serialized and FIFO-ordered
        self.writer = AsyncCheckpointWriter(max_pending=max_pending,
                                            recorder_fn=recorder_fn)
        # transient write errors (EIO/ENOSPC blips) retry before the
        # checkpoint counts as failed; EROFS/EACCES stay fatal — a
        # read-only filesystem does not heal within a backoff budget
        self._retry = RetryPolicy(name="ckpt", recorder_fn=self._rec,
                                  max_attempts=max(1, int(write_retries)),
                                  base=0.05, max_delay=1.0)

    def _rec(self):
        return self.writer._rec()

    # -- save ------------------------------------------------------------ #
    def save(self, payload, meta: Dict[str, Any], tag: str,
             sync: bool = False, mesh: Optional[Dict] = None,
             owned=None, trace_ctx=None):
        """Queue one checkpoint.  ``payload`` must already be HOST data
        (numpy leaves): for the "manifest" layout a ``{shard_name: tree}``
        dict, for "file" an arbitrary state tree.  ``sync=True`` (or a
        manager built with ``async_write=False``) blocks until the
        checkpoint is committed.

        ``mesh`` (a :func:`..reshard.mesh_info` dict) is recorded in the
        v2 manifest so restore can tell resume from reshard.  ``owned``
        optionally names the shards THIS process writes (elastic sliced
        saves, where each host owns its own fragment entries); the
        default keeps the round-robin-by-sorted-name assignment.

        ``trace_ctx`` (a
        :class:`~bigdl_tpu_torch.observability.context.TraceContext`) rides
        on the job object to the writer thread, which records the
        queue-wait and write there under the submitting step's trace
        id — the step → async-writer half of the causal spine."""
        if self.layout == "manifest":
            if not isinstance(payload, dict):
                raise TypeError("manifest layout expects {shard_name: tree}")
            trees = dict(payload)
            owned = None if owned is None else frozenset(owned)
            job = lambda: self._write_manifest_ckpt(trees, dict(meta), tag,
                                                    mesh=mesh, owned=owned)
        else:
            job = lambda: self._write_file_ckpt(payload, dict(meta), tag)
        if trace_ctx is not None:
            job.trace_ctx = trace_ctx
        if sync or not self.async_write:
            # raise THIS job's failure only — an earlier async write may
            # have failed (by design without killing training) and its
            # stale last_error must not poison an unrelated sync commit
            box = {}

            def tracked(job=job):
                try:
                    job()
                except BaseException as e:
                    box["err"] = e
                    raise
            if trace_ctx is not None:
                tracked.trace_ctx = trace_ctx
            self.writer.submit(tracked)
            self.writer.wait()
            if "err" in box:
                raise box["err"]
        else:
            self.writer.submit(job)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain in-flight writes (the preemption handler's 'finish the
        write' step and the pre-restore barrier)."""
        return self.writer.wait(timeout)

    def close(self, timeout: Optional[float] = None):
        self.writer.close(timeout)

    def _write_shard_retrying(self, fpath: str, data: bytes):
        """One shard write with transient-error retry.  Each attempt
        starts clean: a failed earlier attempt (or a stale same-tag
        leftover) may have left a partial O_EXCL file behind."""
        def attempt():
            if os.path.exists(fpath):
                os.remove(fpath)
            faults.guarded_write(fpath, data, kind="shard",
                                 recorder=self._rec())
        self._retry.run(attempt)

    def _write_manifest_ckpt(self, trees, meta, tag, mesh=None, owned=None):
        rec = self._rec()
        t0 = time.perf_counter()
        faults.begin_save()
        d = os.path.join(self.root, DIR_PREFIX + safe_tag(tag))
        if self.process_count == 1 and os.path.isdir(d):
            shutil.rmtree(d)        # stale torn leftover with the same tag
        os.makedirs(d, exist_ok=True)
        if self.process_count > 1:
            # same-tag retry after a multi-host crash: remove THIS host's
            # stale part FIRST, so host 0's merge cannot see a part until
            # its owner has rewritten every shard it names (the part is
            # re-written only after the shard loop below)
            stale = os.path.join(d, f"{mlib.PART_PREFIX}"
                                    f"{self.process_index}.json")
            if os.path.exists(stale):
                os.remove(stale)
        names = sorted(trees)
        shards, total = [], 0
        for i, name in enumerate(names):
            if owned is not None:
                if name not in owned:
                    continue    # caller-decided ownership (elastic saves)
            elif i % self.process_count != self.process_index:
                continue        # per-host shard ownership
            payload = trees[name]
            t1 = time.perf_counter()
            data = _serialize_tree(payload)
            t2 = time.perf_counter()
            crc = data_crc32c(data)
            t3 = time.perf_counter()
            fname = f"shard{i:04d}.bin"
            fpath = os.path.join(d, fname)
            self._write_shard_retrying(fpath, data)
            rec.inc("checkpoint/encode_seconds", t2 - t1)
            rec.inc("checkpoint/crc_seconds", t3 - t2)
            rec.inc("checkpoint/io_seconds", time.perf_counter() - t3)
            if reshard.is_fragment_payload(payload):
                shards.append(Shard(name, fname, len(data), crc,
                                    kind="slices",
                                    of=payload.get("of", name)))
            else:
                shards.append(Shard(name, fname, len(data), crc))
            total += len(data)
        if total:
            rec.inc("checkpoint/bytes_written", total)
        faults.on_pre_manifest()
        t_commit = time.perf_counter()
        mf = Manifest(tag=str(tag), meta=meta, shards=shards,
                      created=time.time(), mesh=mesh)
        # manifest commits retry transient errors too: _write_json_atomic
        # cleans up its tmp on failure, so every attempt starts fresh
        if self.process_count > 1:
            self._retry.run(mlib.write_manifest_part, d,
                            self.process_index, mf, recorder=rec)
            if self.process_index != 0:
                return      # host 0 owns the commit + pointer + GC
            mf = mlib.merge_manifest_parts(d, self.process_count,
                                           timeout=self.part_timeout)
            self._retry.run(mlib.write_manifest, d, mf, recorder=rec)
        else:
            self._retry.run(mlib.write_manifest, d, mf, recorder=rec)
        self._write_pointer_safely(os.path.basename(d))
        self._gc_safely(self._gc_manifest, current=os.path.basename(d))
        t_end = time.perf_counter()
        rec.inc("checkpoint/commit_seconds", t_end - t_commit)
        rec.inc("checkpoint/committed")
        rec.inc("checkpoint/write_seconds", t_end - t0)

    def _write_file_ckpt(self, state, meta, tag):
        rec = self._rec()
        t0 = time.perf_counter()
        faults.begin_save()
        path = os.path.join(self.root, f"checkpoint_{safe_tag(tag)}.bin")
        data = _serialize_tree({"state": state, "meta": meta})
        tmp = f"{path}.tmp-{os.getpid()}"

        def attempt():
            if os.path.exists(tmp):
                os.remove(tmp)
            faults.guarded_write(tmp, data, kind="shard",
                                 recorder=self._rec())
            os.replace(tmp, path)
        try:
            self._retry.run(attempt)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        mlib.fsync_dir(self.root)
        # legacy pointer: the checkpoint FILE path (old tools read this)
        self._write_pointer_safely(path)
        rec.inc("checkpoint/bytes_written", len(data))
        self._gc_safely(self._gc_file, current=path)
        rec.inc("checkpoint/committed")
        rec.inc("checkpoint/write_seconds", time.perf_counter() - t0)

    def _write_pointer_safely(self, value: str):
        """The ``latest`` pointer is an optimization only — resume
        falls back to scanning when it is missing or stale.  It is
        written AFTER the manifest (the commit point) is durable, so a
        pointer failure must not mark a complete, restorable checkpoint
        failed: transient errors retry through the unified policy, and
        an exhausted or fatal failure is logged + counted
        (``checkpoint/pointer_skipped``) — the next commit rewrites the
        pointer and resume scans in the meantime."""
        try:
            self._retry.run(mlib.write_latest_pointer, self.root, value)
        except OSError as e:
            self._rec().inc("checkpoint/pointer_skipped")
            # best effort: drop the now-STALE pointer so resume scans
            # newest-first instead of preferring the older checkpoint
            # the un-updated pointer still names
            try:
                os.remove(os.path.join(self.root, mlib.LATEST_NAME))
                stale = "stale pointer dropped"
            except OSError:
                stale = "stale pointer not removable either"
            print(f"[checkpoint] latest-pointer update failed ({e!r}); "
                  f"{stale}; the commit stands — resume scans "
                  "manifests, the next commit rewrites the pointer",
                  flush=True)

    # -- retention ------------------------------------------------------- #
    def _gc_enabled(self) -> bool:
        return (self.keep_last is not None
                or self.keep_every_epochs is not None)

    def _gc_remove(self, path: str, rmdir: bool = True):
        """Remove one retention candidate; an un-deletable entry
        (permission, ENOENT race with a concurrent cleaner) is logged
        and counted — never silently ignored, never aborts the sweep.
        The next sweep retries it."""
        try:
            if rmdir:
                shutil.rmtree(path)
            else:
                os.remove(path)
        except OSError as e:
            self._rec().inc("checkpoint/gc_skipped")
            print(f"[checkpoint] gc: could not remove {path} ({e!r}); "
                  "skipped — the next sweep retries it", flush=True)

    def _gc_safely(self, fn, current: str):
        """The sweep runs after a successful commit: a GC failure must
        not mark the checkpoint failed (or kill the writer job), only
        announce itself."""
        try:
            fn(current=current)
        except OSError as e:
            self._rec().inc("checkpoint/gc_skipped")
            print(f"[checkpoint] gc sweep failed ({e!r}); the commit "
                  "stands, the next sweep retries", flush=True)

    def _gc_manifest(self, current: str):
        if not self._gc_enabled():
            return
        cands = mlib.scan(self.root, deep=False)
        names = [os.path.basename(d) for d, _ in cands]
        protect = {current}
        ptr = mlib.read_latest_pointer(self.root)
        if ptr:
            protect.add(os.path.basename(ptr.rstrip("/")))
        if self.keep_last:
            protect.update(names[-self.keep_last:])
        if self.keep_every_epochs:
            for d, mf in cands:
                ep = mf.meta.get("epoch")
                if (mf.meta.get("epoch_boundary") and isinstance(ep, int)
                        and ep % self.keep_every_epochs == 0):
                    protect.add(os.path.basename(d))
        for d, _ in cands:
            if os.path.basename(d) not in protect:
                self._gc_remove(d)
        # torn leftovers (no valid manifest) from crashed writers.  Only
        # single-writer roots: with multiple hosts, a manifest-less dir
        # may be another host's save IN PROGRESS, not garbage
        if self.process_count == 1:
            intact = set(names)
            for d in os.listdir(self.root):
                full = os.path.join(self.root, d)
                if (d.startswith(DIR_PREFIX) and os.path.isdir(full)
                        and d not in intact and d not in protect):
                    self._gc_remove(full)

    def _gc_file(self, current: str):
        if not self._gc_enabled() or not self.keep_last:
            return
        files = sorted(glob.glob(os.path.join(self.root,
                                              "checkpoint_*.bin")),
                       key=os.path.getmtime)
        protect = {os.path.abspath(current)}
        ptr = mlib.read_latest_pointer(self.root)
        if ptr:
            protect.add(os.path.abspath(ptr))
        if self.keep_every_epochs:
            for p in files:
                m = re.search(r"checkpoint_epoch_(\d+)\.bin$", p)
                if m and int(m.group(1)) % self.keep_every_epochs == 0:
                    protect.add(os.path.abspath(p))
        for p in files[:-self.keep_last]:
            if os.path.abspath(p) not in protect:
                self._gc_remove(p, rmdir=False)

    # -- restore --------------------------------------------------------- #
    @staticmethod
    def _assemble_entries(trees, mf: Manifest):
        """Collapse v2 sliced shards into their logical entries: group
        every ``kind="slices"`` shard by its ``of`` name and reassemble
        the global arrays; whole-tree shards pass through untouched."""
        merged, groups = {}, {}
        for s in mf.shards:
            payload = trees[s.name]
            if s.kind == "slices" or reshard.is_fragment_payload(payload):
                logical = s.of or (payload.get("of")
                                   if isinstance(payload, dict) else None)
                groups.setdefault(logical or s.name, []).append(payload)
            else:
                merged[s.name] = payload
        for logical, parts in groups.items():
            merged[logical] = reshard.assemble(parts)
        return merged

    def restore_latest(self, with_manifest: bool = False
                       ) -> Optional[Tuple]:
        """``("manifest", {shard: tree}, meta)`` or ``("file", state,
        meta)`` for the newest intact checkpoint, else None.  Waits for
        in-flight writes first, prefers the ``latest`` pointer's target
        when it verifies, and otherwise scans — a torn newest checkpoint
        falls back to the next intact one.  Sliced (elastic) shards are
        reassembled into global arrays, whatever mesh wrote them.

        ``with_manifest=True`` appends the restored checkpoint's
        :class:`Manifest` (None for the legacy file layout) — the
        save-time mesh restorers reshard against."""
        self.wait()
        rec = self._rec()
        # shallow scan for ordering; the expensive full-CRC pass runs
        # per candidate below, so resume cost is O(restored checkpoint),
        # not O(every checkpoint ever retained)
        t0 = time.perf_counter()
        cands = mlib.scan(self.root, deep=False)
        by_name = {os.path.basename(d): (d, mf) for d, mf in cands}
        order = []
        ptr = mlib.read_latest_pointer(self.root)
        if ptr:
            hit = by_name.get(os.path.basename(ptr.rstrip("/")))
            if hit is not None:
                order.append(hit)
        order.extend(c for c in reversed(cands)
                     if not order or c[0] != order[0][0])
        rec.inc("checkpoint/restore_scan_seconds", time.perf_counter() - t0)
        for d, mf in order:
            t0 = time.perf_counter()
            problems = mlib.verify(d, mf, deep=True)
            if problems:
                # one re-read before falling back a whole checkpoint:
                # a deep-CRC mismatch can be a transient read blip
                # (NFS/page-cache), and the next-older checkpoint costs
                # real training progress.  A genuinely torn file fails
                # the second pass identically.
                rec.inc("retry/attempts")
                rec.inc("checkpoint/verify_retries")
                problems = mlib.verify(d, mf, deep=True)
            rec.inc("checkpoint/restore_verify_seconds",
                    time.perf_counter() - t0)
            if problems:
                print(f"[checkpoint] {d}: {problems[0]}; trying older "
                      "checkpoints")
                continue
            t0 = time.perf_counter()
            try:
                trees = {s.name: _load_payload_file(os.path.join(d, s.file))
                         for s in mf.shards}
                trees = self._assemble_entries(trees, mf)
            except Exception as e:      # CRC passed but decode failed
                print(f"[checkpoint] {d}: unreadable despite manifest "
                      f"({e!r}); trying older checkpoints")
                continue
            finally:
                rec.inc("checkpoint/restore_decode_seconds",
                        time.perf_counter() - t0)
            out = ("manifest", trees, dict(mf.meta))
            return out + (mf,) if with_manifest else out
        legacy = self._restore_legacy_file()
        if legacy is not None and with_manifest:
            return legacy + (None,)
        return legacy

    def _restore_legacy_file(self):
        paths = []
        ptr = mlib.read_latest_pointer(self.root)
        if ptr and not ptr.startswith(DIR_PREFIX):
            for cand in (ptr, os.path.join(self.root,
                                           os.path.basename(ptr))):
                if os.path.isfile(cand):
                    paths.append(os.path.abspath(cand))
                    break
        # dangling/corrupt pointer (or none): newest intact file wins
        scanned = sorted(glob.glob(os.path.join(self.root,
                                                "checkpoint_*.bin")),
                         key=os.path.getmtime, reverse=True)
        paths.extend(p for p in (os.path.abspath(s) for s in scanned)
                     if p not in paths)
        for p in paths:
            try:
                blob = _load_payload_file(p)
                state, meta = blob["state"], blob["meta"]
            except Exception as e:
                print(f"[checkpoint] {p}: torn or corrupt ({e!r}); "
                      "trying older checkpoints")
                continue
            return ("file", state, dict(meta))
        return None
