"""Pipeline prefetch (≙ ``bigdl_tpu/data/prefetch.py``, its
``PrefetchedDataSet``): a DataSet whose batches a background thread
materializes up to ``depth`` ahead, so that host-side batch assembly
overlaps the step.  The thread, its bounded queue and its early stop are
:class:`~bigdl_tpu_torch.data.device_loader.DeviceLoader`'s: a consumer
that stops early (break, exception, a dropped iterator) stops the
thread, and an exception of the base dataset re-raises at the consumer.
``FileRecordDataSet`` streams fixed-length records from shard files
through the port's native prefetching ring
(:class:`~bigdl_tpu_torch.native.NativePrefetcher`).
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

from .dataset import DataSet
from .device_loader import DeviceLoader


class PrefetchedDataSet(DataSet):
    """``base``'s batches, ``depth`` ahead on a background thread."""

    def __init__(self, base: DataSet, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.base = base
        self.depth = depth

    def size(self):
        return self.base.size()

    def data(self, train=True, epoch=None):
        try:
            source = self.base.data(train, epoch=epoch)
        except TypeError:       # dataset without epoch-seeded shuffling
            source = self.base.data(train)
        # closing this generator closes the loader's, which stops its thread
        yield from DeviceLoader(source, self.depth)


class FileRecordDataSet(DataSet):
    """Fixed-length records from shard files via the native ring;
    ``decode(record_bytes) -> Sample | MiniBatch | array`` runs on the
    consumer's thread (≙ the LocalSeqFileToBytes + BytesToBGRImg head of
    the reference's ImageNet pipeline).  Each ``data`` call streams every
    record of every file once, through a ring of ``capacity`` records
    filled by ``n_workers`` threads: with one worker in file order, with
    more in an order that varies from run to run (there is no shuffle;
    ``epoch`` is taken, as by every dataset, and does not change the
    order)."""

    def __init__(self, paths: Sequence[str], record_bytes: int,
                 decode: Callable[[bytes], object],
                 header_bytes: int = 0, capacity: int = 64,
                 n_workers: int = 2):
        self.paths = list(paths)
        self.record_bytes = record_bytes
        self.decode = decode
        self.header_bytes = header_bytes
        self.capacity = capacity
        self.n_workers = n_workers
        self._n = sum(
            max(0, (os.path.getsize(p) - header_bytes) // record_bytes)
            for p in self.paths)

    def size(self):
        return self._n

    def data(self, train=True, epoch=None):
        from ..native import NativePrefetcher
        pf = NativePrefetcher(self.paths, self.record_bytes,
                              self.header_bytes, self.capacity,
                              self.n_workers, loop=False)
        try:
            for rec in pf:
                yield self.decode(rec)
        finally:
            pf.close()
