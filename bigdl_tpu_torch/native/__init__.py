"""The port's native host runtime (≙ ``bigdl_tpu/native``): crc32c, a
prefetching ring of fixed-length records read from shard files by worker
threads, and the batched image prep (crop, flip, normalize, HWC → CHW in
one pass).

The library is the port's own copy of the C++ sources
(``bigdl_tpu_torch/native/src``), built with ``g++`` at first use into
``build/native/`` by ``ops._build.build_native`` and bound with ctypes.
Unlike the reference, it has no silent Python fallback: a build or load
that fails raises.  The Python record reader and the numpy image prep are
kept as plain versions under their own names
(:func:`read_records_plain`, :func:`prepare_image_batch_plain`); tests
and ``chip_smoke.py`` hold the native calls against them, and nothing on
the training path calls them.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ..ops import _build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The loaded runtime, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.build_native()))
        lib.bigdl_crc32c.restype = ctypes.c_uint32
        lib.bigdl_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_uint32]
        lib.bigdl_crc32c_masked.restype = ctypes.c_uint32
        lib.bigdl_crc32c_masked.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.pf_create.restype = ctypes.c_void_p
        lib.pf_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int, ctypes.c_uint64,
                                  ctypes.c_uint64, ctypes.c_uint64,
                                  ctypes.c_int, ctypes.c_int]
        lib.pf_next.restype = ctypes.c_uint64
        lib.pf_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.pf_buffered.restype = ctypes.c_uint64
        lib.pf_buffered.argtypes = [ctypes.c_void_p]
        lib.pf_destroy.restype = None
        lib.pf_destroy.argtypes = [ctypes.c_void_p]
        lib.ip_prepare_batch.restype = ctypes.c_int
        lib.ip_prepare_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing from ``crc``."""
    return load().bigdl_crc32c(data, len(data), crc)


def masked_crc32c(data: bytes) -> int:
    """The TFRecord 'masked' CRC32C of ``data``."""
    return load().bigdl_crc32c_masked(data, len(data))


class NativePrefetcher:
    """Fixed-length records from shard files, read by ``n_workers``
    threads (each claims whole files, in order) into a ring of
    ``capacity`` records.  With one worker the records come in file
    order; with more, files interleave in an order that varies from run
    to run.  ``loop=True`` rewinds at the end (an endless stream)."""

    def __init__(self, paths: Sequence[str], record_bytes: int,
                 header_bytes: int = 0, capacity: int = 64,
                 n_workers: int = 2, loop: bool = False):
        self._handle = None
        if record_bytes <= 0 or capacity <= 0 or n_workers <= 0:
            raise ValueError("record_bytes, capacity and n_workers must be "
                             "positive")
        self.paths = [os.fspath(p) for p in paths]
        for p in self.paths:
            if not os.path.isfile(p):
                raise FileNotFoundError(p)
        self.record_bytes = record_bytes
        self._lib = load()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self._lib.pf_create(
            arr, len(self.paths), record_bytes, header_bytes, capacity,
            n_workers, int(loop))
        if not self._handle:
            raise RuntimeError("native prefetcher creation failed")

    def next(self) -> Optional[bytes]:
        """The next record, or None at the end of the stream."""
        if self._handle is None:
            raise RuntimeError("NativePrefetcher is closed")
        buf = np.empty(self.record_bytes, np.uint8)
        n = self._lib.pf_next(self._handle, buf.ctypes.data)
        return buf[:n].tobytes() if n else None

    def buffered(self) -> int:
        return self._lib.pf_buffered(self._handle) if self._handle else 0

    def __iter__(self) -> Iterator[bytes]:
        while True:
            r = self.next()
            if r is None:
                return
            yield r

    def close(self):
        if self._handle is not None:
            self._lib.pf_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def read_records_plain(paths: Sequence[str], record_bytes: int,
                       header_bytes: int = 0) -> Iterator[bytes]:
    """The plain version of the ring: every whole record of each file, in
    file order."""
    for p in paths:
        size = os.path.getsize(p)
        with open(p, "rb") as f:
            f.seek(header_bytes)
            while f.tell() + record_bytes <= size:
                yield f.read(record_bytes)


def _image_args(images, crop_h, crop_w, offsets, flips, mean, std):
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim != 4:
        raise ValueError("images must be (N, H, W, C) uint8")
    n, in_h, in_w, c = images.shape
    if not (0 < crop_h <= in_h and 0 < crop_w <= in_w):
        raise ValueError(f"crop {crop_h}x{crop_w} does not fit {in_h}x{in_w}")
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    if mean_a.size != c or std_a.size != c:
        raise ValueError(f"mean/std must have {c} entries")
    offs_a = None
    if offsets is not None:
        offs_a = np.ascontiguousarray(offsets, np.int32).reshape(n, 2)
        if (offs_a < 0).any() or (offs_a[:, 0] > in_h - crop_h).any() \
                or (offs_a[:, 1] > in_w - crop_w).any():
            raise ValueError("crop offsets out of range")
    flips_a = None if flips is None else \
        np.ascontiguousarray(flips, np.uint8).reshape(n)
    return images, offs_a, flips_a, mean_a, std_a


def prepare_image_batch(images, crop_h, crop_w, offsets=None, flips=None,
                        mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                        n_threads=4) -> np.ndarray:
    """One pass of crop + flip + normalize + HWC → CHW over a batch
    (≙ the chained ``BGRImgCropper`` / ``HFlip`` / ``BGRImgNormalizer`` /
    ``BGRImgToBatch``, without their intermediates), on ``n_threads``
    host threads.

    ``images``: (N, H, W, C) uint8; ``offsets``: (N, 2) crop (y, x), or
    None for the top-left corner; ``flips``: (N,) 0/1, or None.  Returns
    (N, C, crop_h, crop_w) float32, ``(px - mean) * (1 / std)`` (1 where
    std is 0)."""
    images, offs_a, flips_a, mean_a, std_a = _image_args(
        images, crop_h, crop_w, offsets, flips, mean, std)
    n, in_h, in_w, c = images.shape
    out = np.empty((n, c, crop_h, crop_w), np.float32)
    rc = load().ip_prepare_batch(
        images.ctypes.data, n, in_h, in_w, c,
        None if offs_a is None else offs_a.ctypes.data,
        None if flips_a is None else flips_a.ctypes.data,
        mean_a.ctypes.data, std_a.ctypes.data, crop_h, crop_w,
        out.ctypes.data, n_threads)
    if rc != 0:
        raise ValueError("ip_prepare_batch: bad arguments")
    return out


def prepare_image_batch_plain(images, crop_h, crop_w, offsets=None,
                              flips=None, mean=(0.0, 0.0, 0.0),
                              std=(1.0, 1.0, 1.0)) -> np.ndarray:
    """The plain numpy version of :func:`prepare_image_batch`: the same
    operations in the same order, image by image."""
    images, offs_a, flips_a, mean_a, std_a = _image_args(
        images, crop_h, crop_w, offsets, flips, mean, std)
    n, c = images.shape[0], images.shape[3]
    out = np.empty((n, c, crop_h, crop_w), np.float32)
    safe = np.where(std_a != 0, std_a, np.float32(1.0))
    inv = (np.float32(1.0) / safe).astype(np.float32)
    for i in range(n):
        oy, ox = offs_a[i] if offs_a is not None else (0, 0)
        patch = images[i, oy:oy + crop_h, ox:ox + crop_w].astype(np.float32)
        if flips_a is not None and flips_a[i]:
            patch = patch[:, ::-1]
        out[i] = np.transpose((patch - mean_a) * inv, (2, 0, 1))
    return out
