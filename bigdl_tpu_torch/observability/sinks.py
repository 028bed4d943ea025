"""Sinks for Recorder step records (≙ ``bigdl_tpu/observability/sinks.py``,
in part): anything with ``emit(record: dict)`` (and optionally ``flush`` /
``close``).

  :class:`JsonlSink`     one JSON object per line (the reference's
                         ``scripts/trace_summary.py steps`` reads it)
  :class:`InMemorySink`  keeps records in a list (tests, notebooks)

``TensorBoardSink`` and the Prometheus rendering are not ported yet
(ROADMAP queue A, item 8).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List


class Sink:
    """Interface marker; subclasses implement emit/close."""

    def emit(self, record: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass


class InMemorySink(Sink):
    """Append records to ``self.records`` (thread-safe)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, record):
        with self._lock:
            self.records.append(record)

    def steps(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for r in self.records if r.get("type") == "step"]


class JsonlSink(Sink):
    """One JSON object per line, flushed every ``flush_every`` records
    (and on close) so that a crashed run keeps its telemetry tail."""

    def __init__(self, path: str, flush_every: int = 20):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._since_flush = 0
        self.flush_every = max(int(flush_every), 1)

    def emit(self, record):
        line = json.dumps(record, default=_json_default)
        with self._lock:
            self._f.write(line + "\n")
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._f.flush()
                self._since_flush = 0

    def flush(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._since_flush = 0

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def _json_default(v):
    """Last-resort leaf encoder: tensors and numpy scalars float()
    cleanly; anything else degrades to repr instead of killing the run."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JsonlSink file back into records (bad lines skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


__all__ = ["InMemorySink", "JsonlSink", "Sink", "read_jsonl"]
