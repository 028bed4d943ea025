"""DataSet and Transformer (≙ ``bigdl_tpu/data/dataset.py``,
dataset/DataSet.scala and Transformer.scala).

A DataSet yields batches (``MiniBatch``) or, before a batching
transformer, records or ``Sample`` s.  Transformers compose with ``>>``
(the reference's ``dataset -> transformer``).  Batches are numpy arrays
on the host; the optimizer copies each to the device.  Every dataset's
``data(train, epoch=None)`` takes the epoch: the shuffles are the
reference's epoch-seeded numpy permutations, so that the port and the
reference see the samples in the same order, and a given (seed, epoch)
always gives the same order.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

from .minibatch import MiniBatch, PaddingParam, Sample, samples_to_minibatch


class Transformer:
    """Composable iterator transform (≙ dataset/Transformer.scala)."""

    def apply_iter(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply_iter(iter(it))

    def __gt__(self, other):
        raise TypeError("use `a -> b` spelled as a.then(b) or a >> b")

    def __rshift__(self, other: "Transformer") -> "Transformer":
        return ChainedTransformer(self, other)

    def then(self, other: "Transformer") -> "Transformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    def __init__(self, first, second):
        self.first = first
        self.second = second

    def apply_iter(self, it):
        return self.second.apply_iter(self.first.apply_iter(it))


class SampleToMiniBatch(Transformer):
    """≙ dataset/SampleToMiniBatch.scala; drops no samples — last partial
    batch is emitted unless drop_last."""

    def __init__(self, batch_size, feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None, drop_last=False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.drop_last = drop_last

    def apply_iter(self, it):
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield samples_to_minibatch(buf, self.feature_padding,
                                           self.label_padding)
                buf = []
        if buf and not self.drop_last:
            yield samples_to_minibatch(buf, self.feature_padding,
                                       self.label_padding)


class FunctionTransformer(Transformer):
    def __init__(self, fn: Callable):
        self.fn = fn

    def apply_iter(self, it):
        for x in it:
            yield self.fn(x)


class DataSet:
    """Base dataset (≙ dataset/DataSet.scala AbstractDataSet)."""

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        return self

    def data(self, train: bool = True, epoch=None) -> Iterator:
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    # reference spelling: dataset -> transformer
    def __rshift__(self, transformer):
        return self.transform(transformer)

    @staticmethod
    def array(samples, batch_size=None, shuffle=True):
        ds = LocalArrayDataSet(samples, shuffle=shuffle)
        if batch_size is not None:
            return ds.transform(SampleToMiniBatch(batch_size))
        return ds

    @staticmethod
    def minibatch_arrays(x, y, batch_size, shuffle=True, drop_last=True,
                         seed=0):
        return ArrayMiniBatchDataSet(x, y, batch_size, shuffle=shuffle,
                                     drop_last=drop_last, seed=seed)


class LocalArrayDataSet(DataSet):
    """In-memory list of Samples (≙ LocalArrayDataSet in DataSet.scala)."""

    def __init__(self, samples, shuffle=True, seed=0):
        self.samples = list(samples)
        self._shuffle = shuffle
        self._seed = seed
        self._rng = np.random.RandomState(seed)

    def size(self):
        return len(self.samples)

    def shuffle(self):
        self._rng.shuffle(self.samples)
        return self

    def data(self, train=True, epoch=None):
        idx = np.arange(len(self.samples))
        if train and self._shuffle:
            # epoch-seeded permutation (stateless) enables exact mid-epoch
            # resume: the same (seed, epoch) always yields the same order
            rng = self._rng if epoch is None else \
                np.random.RandomState((self._seed * 1000003 + epoch)
                                      % (2 ** 31 - 1))
            rng.shuffle(idx)
        for i in idx:
            yield self.samples[i]


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


class TransformedDataSet(DataSet):
    def __init__(self, base: DataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train=True, epoch=None):
        return self.transformer.apply_iter(self.base.data(train,
                                                          epoch=epoch))


class DistributedDataSet(DataSet):
    """Mesh-sharded dataset (≙ DistributedDataSet over Spark RDDs).

    Wraps a global dataset; ``data()`` yields global batches whose
    leading dim is divisible by the dp shard count (a batch is cut to
    the largest such size; one smaller than ``num_shards`` is dropped),
    so that every rank's block has the same static shape.
    ``DistriOptimizer`` then gives rank r its block of rows.
    """

    def __init__(self, base: DataSet, num_shards: int, shard_index: int = 0):
        self.base = base
        self.num_shards = num_shards
        self.shard_index = shard_index

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train=True, epoch=None):
        for mb in self.base.data(train, epoch=epoch):
            if mb.size() % self.num_shards:
                # truncate so every shard receives an equal, static shape
                keep = mb.size() - (mb.size() % self.num_shards)
                if keep == 0:
                    continue
                mb = mb.slice(1, keep)
            yield mb
