"""Atomic checkpoint manifests, the commit protocol's source of truth
(≙ ``bigdl_tpu/checkpoint/manifest.py``; the same schema, so that each
package reads the other's checkpoints).

A checkpoint is a directory ``ckpt_<tag>/`` holding shard files and one
``MANIFEST.json`` listing every shard with its byte size and masked
CRC32C.  The manifest is written last, through tmp + ``os.replace`` +
directory fsync: a checkpoint either has a valid manifest naming shards
whose checksums verify, or it does not exist.

Several writers (``DistriOptimizer`` ranks) each write a
``MANIFEST.partK.json`` covering the shards they own; writer 0 merges the
parts into the one ``MANIFEST.json`` that commits the checkpoint.

Format v2 adds ``mesh`` (the save-time mesh, :func:`..reshard.mesh_info`)
and per-shard ``kind``/``of`` (``kind="slices"``: one writer's fragments
of the logical entry ``of``, reassembled at restore).  A manifest that
needs neither is written as v1.  CRC32C runs in the port's native runtime
(``bigdl_tpu_torch.native``), which has no Python fallback.
"""
from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..native import crc32c as _crc
from ..utils.crc32c import mask

FORMAT = "bigdl_tpu.checkpoint"
VERSION = 2        # v2: mesh metadata + sliced-shard entries (elastic)
MANIFEST_NAME = "MANIFEST.json"
PART_PREFIX = "MANIFEST.part"
DIR_PREFIX = "ckpt_"
LATEST_NAME = "latest"


class CheckpointError(RuntimeError):
    """A checkpoint directory is missing, torn, or fails verification."""


def data_crc32c(data: bytes) -> int:
    """Masked CRC32C of a byte string."""
    return mask(_crc(data))


def file_crc32c(path: str, chunk: int = 1 << 20) -> int:
    """Masked CRC32C of a file's contents, streamed in chunks."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = _crc(block, crc)
    return mask(crc)


def safe_tag(tag: str) -> str:
    """Filesystem-safe checkpoint tag."""
    return re.sub(r"[^A-Za-z0-9_.+-]", "_", str(tag)) or "untagged"


@dataclass
class Shard:
    name: str          # logical shard name ("params/fc1", "opt_state", ...)
    file: str          # file name inside the checkpoint directory
    bytes: int
    crc32c: int        # masked CRC32C of the file contents
    # v2 sliced shards: kind="slices" marks per-device array fragments
    # (with index maps) of the logical entry named by ``of``; restore
    # groups every slice shard with the same ``of`` and reassembles the
    # global arrays.  kind="tree" (default) is the v1 whole-tree payload.
    kind: str = "tree"
    of: Optional[str] = None

    def to_json(self):
        out = {"name": self.name, "file": self.file,
               "bytes": int(self.bytes), "crc32c": int(self.crc32c)}
        if self.kind != "tree":
            out["kind"] = self.kind
        if self.of is not None:
            out["of"] = self.of
        return out

    @staticmethod
    def from_json(d):
        try:
            return Shard(str(d["name"]), str(d["file"]), int(d["bytes"]),
                         int(d["crc32c"]), str(d.get("kind", "tree")),
                         None if d.get("of") is None else str(d["of"]))
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointError(f"malformed shard entry {d!r}") from e


@dataclass
class Manifest:
    tag: str
    meta: Dict = field(default_factory=dict)
    shards: List[Shard] = field(default_factory=list)
    created: float = 0.0
    # v2: the SAVE-TIME mesh ({"axes": [[name, size], ...], "devices": n,
    # "processes": k}); None on v1 manifests and non-mesh writers
    mesh: Optional[Dict] = None
    # version as READ from disk (None for freshly built manifests);
    # to_json stamps the LOWEST version that can express the content,
    # so plain tree-shard saves without mesh metadata stay readable by
    # pre-v2 libraries in a mixed-version fleet
    version: Optional[int] = None

    def to_json(self):
        v2 = self.mesh is not None or any(s.kind != "tree" or s.of
                                          for s in self.shards)
        out = {"format": FORMAT, "version": VERSION if v2 else 1,
               "tag": self.tag, "created": self.created,
               "meta": self.meta,
               "shards": [s.to_json() for s in self.shards]}
        if self.mesh is not None:
            out["mesh"] = self.mesh
        return out

    @staticmethod
    def from_json(d, where=""):
        if not isinstance(d, dict) or d.get("format") != FORMAT:
            raise CheckpointError(f"{where}: not a checkpoint manifest")
        if d.get("version", 0) > VERSION:
            raise CheckpointError(
                f"{where}: unsupported manifest version {d.get('version')}")
        mesh = d.get("mesh")
        return Manifest(str(d.get("tag", "")), dict(d.get("meta", {})),
                        [Shard.from_json(s) for s in d.get("shards", [])],
                        float(d.get("created", 0.0)),
                        dict(mesh) if isinstance(mesh, dict) else None,
                        int(d.get("version", 0)) or None)

    def sort_key(self) -> Tuple:
        """Newest-checkpoint ordering: training position, then wall time."""
        it = self.meta.get("iteration", self.meta.get("step", -1))
        try:
            it = int(it)
        except (TypeError, ValueError):
            it = -1
        return (it, self.created)


def fsync_dir(path: str):
    """Flush a directory entry (the rename itself) to stable storage."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return      # e.g. platforms without O_RDONLY dirs; best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_json_atomic(path: str, obj, kind: str, recorder=None):
    """tmp (fault-injectable, fsync'ed) + os.replace + dir fsync."""
    from . import faults
    data = json.dumps(obj, sort_keys=True).encode()
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        os.remove(tmp)
    try:
        faults.guarded_write(tmp, data, kind=kind, recorder=recorder)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    fsync_dir(os.path.dirname(path) or ".")


def write_manifest(ckpt_dir: str, manifest: Manifest, recorder=None):
    """Commit a checkpoint: the manifest write IS the commit point.
    ``recorder`` routes ckpt.manifest fault-injection counters to the
    caller's telemetry (same contract as the shard writes)."""
    _write_json_atomic(os.path.join(ckpt_dir, MANIFEST_NAME),
                       manifest.to_json(), kind="manifest",
                       recorder=recorder)


def write_manifest_part(ckpt_dir: str, part_index: int,
                        manifest: Manifest, recorder=None):
    """One host's contribution (its owned shards); NOT a commit."""
    _write_json_atomic(
        os.path.join(ckpt_dir, f"{PART_PREFIX}{part_index}.json"),
        manifest.to_json(), kind="manifest_part", recorder=recorder)


def merge_manifest_parts(ckpt_dir: str, n_parts: int,
                         timeout: float = 120.0,
                         poll: float = 0.05) -> Manifest:
    """Host 0: wait for every part (shared filesystem), merge shard lists,
    and return the merged manifest (caller commits it via write_manifest).
    """
    paths = [os.path.join(ckpt_dir, f"{PART_PREFIX}{i}.json")
             for i in range(n_parts)]
    deadline = time.monotonic() + timeout
    while any(not os.path.exists(p) for p in paths):
        if time.monotonic() >= deadline:
            missing = [p for p in paths if not os.path.exists(p)]
            raise CheckpointError(
                f"{ckpt_dir}: timed out waiting for manifest parts "
                f"{[os.path.basename(m) for m in missing]}")
        time.sleep(poll)
    merged: Optional[Manifest] = None
    for p in paths:
        with open(p) as f:
            part = Manifest.from_json(json.load(f), where=p)
        if merged is None:
            merged = part
        else:
            merged.shards.extend(part.shards)
    merged.shards.sort(key=lambda s: s.name)
    return merged


def read_manifest(ckpt_dir: str) -> Manifest:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        raise CheckpointError(f"{ckpt_dir}: no manifest (uncommitted or "
                              "torn checkpoint)")
    try:
        with open(path) as f:
            return Manifest.from_json(json.load(f), where=path)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"{ckpt_dir}: unreadable manifest ({e})") from e


def verify(ckpt_dir: str, manifest: Manifest, deep: bool = True) -> List[str]:
    """Return the list of problems (empty == intact).  ``deep`` re-hashes
    every shard file; shallow checks existence + byte size only."""
    problems = []
    for s in manifest.shards:
        p = os.path.join(ckpt_dir, s.file)
        if not os.path.exists(p):
            problems.append(f"missing shard {s.file}")
            continue
        size = os.path.getsize(p)
        if size != s.bytes:
            problems.append(f"shard {s.file}: {size} bytes, manifest says "
                            f"{s.bytes}")
            continue
        if deep and file_crc32c(p) != s.crc32c:
            problems.append(f"shard {s.file}: CRC32C mismatch")
    return problems


def scan(root: str, deep: bool = True) -> List[Tuple[str, Manifest]]:
    """All INTACT checkpoints under ``root``, sorted oldest → newest.

    A directory without a valid manifest, or whose shards fail
    verification, is skipped — it does not exist as a checkpoint.
    """
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        full = os.path.join(root, d)
        if not (d.startswith(DIR_PREFIX) and os.path.isdir(full)):
            continue
        try:
            mf = read_manifest(full)
        except CheckpointError:
            continue
        if verify(full, mf, deep=deep):
            continue
        out.append((full, mf))
    out.sort(key=lambda e: e[1].sort_key())
    return out


def read_latest_pointer(root: str) -> Optional[str]:
    """Contents of the ``latest`` pointer file, or None.  The pointer is
    an optimization only — resume falls back to scanning when it is
    dangling or corrupt."""
    path = os.path.join(root, LATEST_NAME)
    try:
        with open(path) as f:
            return f.read().strip() or None
    except (OSError, UnicodeDecodeError):
        return None      # missing or corrupt pointer: caller scans


def write_latest_pointer(root: str, value: str):
    """Atomically update the ``latest`` pointer (tmp + os.replace)."""
    path = os.path.join(root, LATEST_NAME)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # no tmp litter on any failure path — a stale latest.tmp-<pid>
        # would otherwise survive until the next save from the same pid
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    fsync_dir(root)
