"""Pipeline prefetch (≙ ``bigdl_tpu/data/prefetch.py``, its
``PrefetchedDataSet``): a DataSet whose batches a background thread
materializes up to ``depth`` ahead, so that host-side batch assembly
overlaps the step.  The thread, its bounded queue and its early stop are
:class:`~bigdl_tpu_torch.data.device_loader.DeviceLoader`'s: a consumer
that stops early (break, exception, a dropped iterator) stops the
thread, and an exception of the base dataset re-raises at the consumer.
``FileRecordDataSet`` waits for the port's native record loader (ROADMAP
queue A, item 10).
"""
from __future__ import annotations

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
