"""Minimal protobuf wire-format encoder and decoder for TensorBoard Event
records (≙ ``bigdl_tpu/utils/proto.py``: the TF ``event.proto`` /
``summary.proto`` subset BigDL serializes).

The port's own copy: the varint encoding of the four message shapes that
scalars and histograms need, with no protobuf dependency, byte for byte
the reference's, so that each package reads the other's event files.
"""
from __future__ import annotations

import struct
from typing import Iterator, List, Tuple


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def enc_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def enc_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def enc_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def enc_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def enc_string(field: int, v: str) -> bytes:
    return enc_bytes(field, v.encode("utf-8"))


def enc_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return enc_bytes(field, payload)


# ---- message builders (field numbers from TF event.proto/summary.proto) --- #
def summary_value_scalar(tag: str, value: float) -> bytes:
    return enc_string(1, tag) + enc_float(2, value)


def histogram_proto(vmin, vmax, num, vsum, sum_sq, limits, counts) -> bytes:
    return (enc_double(1, vmin) + enc_double(2, vmax) + enc_double(3, num)
            + enc_double(4, vsum) + enc_double(5, sum_sq)
            + enc_packed_doubles(6, limits) + enc_packed_doubles(7, counts))


def summary_value_histo(tag: str, histo: bytes) -> bytes:
    return enc_string(1, tag) + enc_bytes(5, histo)


def event(wall_time: float, step: int, *, file_version: str = None,
          summary_values: List[bytes] = None) -> bytes:
    out = enc_double(1, wall_time) + enc_int64(2, step)
    if file_version is not None:
        out += enc_string(3, file_version)
    if summary_values:
        summary = b"".join(enc_bytes(1, v) for v in summary_values)
        out += enc_bytes(5, summary)
    return out


# ---- decoding (for readScalar) ------------------------------------------- #
def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def decode_scalar_event(buf: bytes):
    """Returns (wall_time, step, [(tag, value)]) or None if not a scalar."""
    wall = 0.0
    step = 0
    scalars = []
    for field, wire, v in iter_fields(buf):
        if field == 1 and wire == 1:
            wall = v
        elif field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:  # summary
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag = None
                    val = None
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            val = v3
                    if tag is not None and val is not None:
                        scalars.append((tag, val))
    return wall, step, scalars
