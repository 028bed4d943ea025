"""Shape layers (≙ ``bigdl_tpu/nn/shape_ops.py``): ``Reshape`` and
``View``, which keep the batch dim."""
from __future__ import annotations

import numpy as np

from .module import Module


class Reshape(Module):
    """Reshape the non-batch dims to ``size``.  ``batch_mode=None``
    decides as the reference does: batched when the per-sample elements
    match ``size`` (or the total is a multiple of it)."""

    def __init__(self, size, batch_mode=None, name=None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def apply(self, params, x, ctx):
        n = int(np.prod(self.size))
        batch = self.batch_mode
        if batch is None:
            batch = ((x.ndim > 1 and int(np.prod(x.shape[1:])) == n)
                     or (x.numel() != n and x.numel() % n == 0))
        if batch:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class View(Module):
    """Reshape keeping the batch dim; -1 is a wildcard."""

    def __init__(self, *sizes, name=None):
        super().__init__(name=name)
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)

    def apply(self, params, x, ctx):
        total = int(np.prod([s for s in self.sizes if s != -1]))
        if (x.numel() % total == 0 and x.numel() != total
                and -1 not in self.sizes):
            return x.reshape((x.shape[0],) + self.sizes)
        return x.reshape(self.sizes if -1 in self.sizes
                         else (x.shape[0],) + self.sizes)
