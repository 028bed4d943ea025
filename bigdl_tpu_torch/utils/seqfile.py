"""Hadoop SequenceFile IO (≙ ``bigdl_tpu/utils/seqfile.py``, the
reference's ImageNet storage format:
dataset/image/BGRImgToLocalSeqFile.scala writes Text->Text sequence files,
LocalSeqFileToBytes.scala reads them back; utils/File SequenceFile
helpers).

Pure-Python implementation of the uncompressed SequenceFile v6 layout.
The writer's sync marker hashes ``sync_seed`` and the path with the
reference's string, so that for the same path and seed the port writes
the reference's bytes:

    "SEQ" 0x06 | keyClass (Text) | valueClass (Text) | compressed=0 |
    blockCompressed=0 | metadata count=0 (int32 BE) | sync (16 bytes)
    then records: recordLen (int32 BE) | keyLen (int32 BE) | key | value
    with `-1 | sync` escapes every ~SYNC_INTERVAL bytes.

Keys/values are Hadoop Writables; Text serializes as vint length + bytes
(Hadoop WritableUtils VInt encoding).
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, List, Tuple

SEQ_MAGIC = b"SEQ"
VERSION = 6
SYNC_INTERVAL = 2000
TEXT_CLASS = "org.apache.hadoop.io.Text"
BYTES_CLASS = "org.apache.hadoop.io.BytesWritable"


# ---- Hadoop WritableUtils VInt ---------------------------------------- #
def write_vint(value: int) -> bytes:
    if -112 <= value <= 127:
        return struct.pack("b", value)
    length = -112
    if value < 0:
        value ^= -1  # ~value
        length = -120
    tmp = value
    size = 0
    while tmp:
        tmp >>= 8
        size += 1
    out = struct.pack("b", length - size)
    return out + value.to_bytes(size, "big")


def read_vint(buf: bytes, pos: int) -> Tuple[int, int]:
    (first,) = struct.unpack_from("b", buf, pos)
    pos += 1
    if first >= -112:
        return first, pos
    negative = first < -120
    size = (-120 - first) if negative else (-112 - first)
    value = int.from_bytes(buf[pos:pos + size], "big")
    pos += size
    return (value ^ -1) if negative else value, pos


def _text(data: bytes) -> bytes:
    """Serialize as org.apache.hadoop.io.Text (vint length + raw bytes)."""
    return write_vint(len(data)) + data


def _read_text(buf: bytes, pos: int = 0) -> bytes:
    n, pos = read_vint(buf, pos)
    return buf[pos:pos + n]


def _bytes_writable(data: bytes) -> bytes:
    """BytesWritable: 4-byte BE length + raw bytes."""
    return struct.pack(">i", len(data)) + data


def _read_bytes_writable(buf: bytes) -> bytes:
    (n,) = struct.unpack_from(">i", buf, 0)
    return buf[4:4 + n]


class SequenceFileWriter:
    def __init__(self, path: str, key_class: str = TEXT_CLASS,
                 value_class: str = TEXT_CLASS, sync_seed: int = 0):
        import hashlib
        self._f = open(path, "wb")
        self.key_class = key_class
        self.value_class = value_class
        self.sync = hashlib.md5(
            f"bigdl_tpu-seq-{sync_seed}-{path}".encode()).digest()
        self._since_sync = 0
        self._write_header()

    def _write_string(self, s: str):
        b = s.encode("utf-8")
        self._f.write(write_vint(len(b)) + b)

    def _write_header(self):
        self._f.write(SEQ_MAGIC + bytes([VERSION]))
        self._write_string(self.key_class)
        self._write_string(self.value_class)
        self._f.write(b"\x00\x00")               # compressed, blockCompressed
        self._f.write(struct.pack(">i", 0))      # metadata entries
        self._f.write(self.sync)

    def _serialize(self, data: bytes, cls: str) -> bytes:
        if cls == BYTES_CLASS:
            return _bytes_writable(data)
        return _text(data)

    def append(self, key: bytes, value: bytes):
        if self._since_sync >= SYNC_INTERVAL:
            self._f.write(struct.pack(">i", -1))
            self._f.write(self.sync)
            self._since_sync = 0
        k = self._serialize(key, self.key_class)
        v = self._serialize(value, self.value_class)
        rec = (struct.pack(">i", len(k) + len(v))
               + struct.pack(">i", len(k)) + k + v)
        self._f.write(rec)
        self._since_sync += len(rec)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SequenceFileReader:
    """Iterates (key_bytes, value_bytes)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        if self.data[:3] != SEQ_MAGIC:
            raise ValueError(f"{path}: not a SequenceFile")
        if self.data[3] != VERSION:
            raise ValueError(f"{path}: unsupported SequenceFile version "
                             f"{self.data[3]}")
        pos = 4
        n, pos = read_vint(self.data, pos)
        self.key_class = self.data[pos:pos + n].decode()
        pos += n
        n, pos = read_vint(self.data, pos)
        self.value_class = self.data[pos:pos + n].decode()
        pos += n
        compressed, block = self.data[pos], self.data[pos + 1]
        if compressed or block:
            raise ValueError("compressed SequenceFiles unsupported")
        pos += 2
        (meta_count,) = struct.unpack_from(">i", self.data, pos)
        pos += 4
        for _ in range(meta_count):
            for _kv in range(2):
                n, pos = read_vint(self.data, pos)
                pos += n
        self.sync = self.data[pos:pos + 16]
        self._start = pos + 16

    def _deserialize(self, buf: bytes, cls: str) -> bytes:
        if cls == BYTES_CLASS:
            return _read_bytes_writable(buf)
        return _read_text(buf)

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        pos = self._start
        data = self.data
        while pos + 4 <= len(data):
            (rec_len,) = struct.unpack_from(">i", data, pos)
            pos += 4
            if rec_len == -1:          # sync escape
                pos += 16
                continue
            (key_len,) = struct.unpack_from(">i", data, pos)
            pos += 4
            key = self._deserialize(data[pos:pos + key_len], self.key_class)
            value = self._deserialize(data[pos + key_len:pos + rec_len],
                                      self.value_class)
            pos += rec_len
            yield key, value


def read_seq_pairs(path: str) -> List[Tuple[bytes, bytes]]:
    return list(SequenceFileReader(path))
