"""TensorBoard event-file writer and reader (≙
``bigdl_tpu/visualization/event_writer.py``: FileWriter.scala,
EventWriter.scala; the record framing of TFRecordWriter).

Record layout (TFRecord): u64 length | masked-crc32c(length) | payload |
masked-crc32c(payload).  The first record carries file_version
"brain.Event:2".  The bytes are the reference's, so that each package's
:func:`read_scalar` reads the other's files.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import List, Tuple

import numpy as np

from ..utils import proto
from ..utils.crc32c import masked_crc32c


class EventWriter:
    """Append-only tfevents file in `log_dir`
    (≙ tensorboard/EventWriter.scala; the async queue becomes a lock —
    writes are host-side and tiny next to a device step)."""

    def __init__(self, log_dir: str, flush_secs: float = 10.0):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}"
                 f".{socket.gethostname()}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        self._last_flush = time.time()
        self.flush_secs = flush_secs
        self._write(proto.event(time.time(), 0,
                                file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        rec = (header + struct.pack("<I", masked_crc32c(header))
               + payload + struct.pack("<I", masked_crc32c(payload)))
        with self._lock:
            self._f.write(rec)
            if time.time() - self._last_flush > self.flush_secs:
                self._f.flush()
                self._last_flush = time.time()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(proto.event(
            time.time(), step,
            summary_values=[proto.summary_value_scalar(tag, float(value))]))
        return self

    def add_histogram(self, tag: str, values, step: int, bins: int = 30):
        arr = np.asarray(values, np.float64).reshape(-1)
        if arr.size == 0:
            return self
        counts, edges = np.histogram(arr, bins=bins)
        histo = proto.histogram_proto(
            float(arr.min()), float(arr.max()), float(arr.size),
            float(arr.sum()), float((arr ** 2).sum()),
            edges[1:], counts)
        self._write(proto.event(
            time.time(), step,
            summary_values=[proto.summary_value_histo(tag, histo)]))
        return self

    def flush(self):
        with self._lock:
            self._f.flush()
        return self

    def close(self):
        with self._lock:
            self._f.flush()
            self._f.close()


def _frame_at(data: bytes, i: int):
    """Try to frame one TFRecord at offset ``i``: returns
    ``(payload, next_offset)`` when both masked CRCs verify, else None."""
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


def read_events(log_dir: str, salvage: bool = False):
    """All event payloads from every tfevents file in a dir, in file order.

    Both masked CRCs (header and payload) are verified per record, and
    by default reading a file STOPS at the first corrupt record — a
    flipped length would otherwise misframe the rest of the file into
    garbage payloads (the TFRecord framing's whole point; ≙ tensorflow's
    RecordReader::ReadRecord checksum handling).

    ``salvage=True`` keeps going instead: each corrupt region is counted
    and skipped by scanning forward for the next offset whose header CRC
    (and payload CRC) verify — the frame check IS the resync condition,
    so a random 12-byte window almost never false-positives.  Returns
    ``(payloads, n_corrupt)`` in this mode.  Post-mortem readers (e.g.
    inspecting the telemetry of a hard-killed run) need the tail records
    *after* a torn write, which strict mode by design never yields."""
    payloads = []
    n_corrupt = 0
    for fname in sorted(os.listdir(log_dir)):
        if "tfevents" not in fname:
            continue
        with open(os.path.join(log_dir, fname), "rb") as f:
            data = f.read()
        i = 0
        while i + 12 <= len(data):
            framed = _frame_at(data, i)
            if framed is not None:
                payloads.append(framed[0])
                i = framed[1]
                continue
            if not salvage:
                break
            n_corrupt += 1
            j = i + 1
            while j + 12 <= len(data):
                if _frame_at(data, j) is not None:
                    break
                j += 1
            i = j           # loop re-frames at j, or falls off the end
    return (payloads, n_corrupt) if salvage else payloads


def read_scalar(log_dir: str, tag: str) -> List[Tuple[int, float, float]]:
    """[(step, value, wall_time)] for one tag
    (≙ Summary.readScalar's triple)."""
    out = []
    for payload in read_events(log_dir):
        wall, step, scalars = proto.decode_scalar_event(payload)
        for t, v in scalars:
            if t == tag:
                out.append((step, v, wall))
    return out
