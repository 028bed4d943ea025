"""DataSet (≙ ``bigdl_tpu/data/dataset.py``): the in-memory array path,
``DataSet.minibatch_arrays`` and ``ArrayMiniBatchDataSet``.

Batches are numpy arrays on the host; the optimizer copies each to the
device.  The shuffle is the reference's epoch-seeded numpy permutation,
so the port and the reference see the batches in the same order.  The
``Sample`` path, transformers and the distributed dataset are not ported
yet (ROADMAP queue A, item 10).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .minibatch import MiniBatch


class DataSet:
    """Base dataset."""

    def size(self) -> int:
        raise NotImplementedError

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    @staticmethod
    def minibatch_arrays(x, y, batch_size, shuffle=True, drop_last=True,
                         seed=0):
        return ArrayMiniBatchDataSet(x, y, batch_size, shuffle=shuffle,
                                     drop_last=drop_last, seed=seed)


class ArrayMiniBatchDataSet(DataSet):
    """Dense (x, y) arrays cut into batches without per-sample Python
    work."""

    def __init__(self, x, y, batch_size, shuffle=True, drop_last=True, seed=0):
        self.x = np.asarray(x)
        self.y = None if y is None else np.asarray(y)
        self.batch_size = batch_size
        self._shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.RandomState(seed)

    def size(self):
        return self.x.shape[0]

    def data(self, train=True, epoch=None):
        n = self.x.shape[0]
        idx = np.arange(n)
        if train and self._shuffle:
            # epoch-seeded permutation (stateless): the same (seed, epoch)
            # always gives the same order
            rng = self._rng if epoch is None else \
                np.random.RandomState((self._seed * 1000003 + epoch)
                                      % (2 ** 31 - 1))
            rng.shuffle(idx)
        end = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, end, self.batch_size):
            sel = idx[start:start + self.batch_size]
            xb = self.x[sel]
            yb = None if self.y is None else self.y[sel]
            yield MiniBatch(xb, yb)
