"""Shape layers (≙ ``bigdl_tpu/nn/shape_ops.py``): ``Reshape`` and
``View``, which keep the batch dim, ``Squeeze``, ``Transpose``,
``Padding`` and ``SpatialZeroPadding``.  Dimension arguments are 1-based,
as the reference's (Torch's) are."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
        self.num_input_dims = 0

    def set_num_input_dims(self, n):
        """Kept as the reference keeps it (its ``apply`` reads the batch
        dim from the element count, not from this)."""
        self.num_input_dims = n
        return self

    def apply(self, params, x, ctx):
        total = int(np.prod([s for s in self.sizes if s != -1]))
        if (x.numel() % total == 0 and x.numel() != total
                and -1 not in self.sizes):
            return x.reshape((x.shape[0],) + self.sizes)
        return x.reshape(self.sizes if -1 in self.sizes
                         else (x.shape[0],) + self.sizes)


def _axis(dim, ndim, batch_offset=0):
    """1-based (possibly negative) reference dim -> 0-based axis."""
    if dim < 0:
        return ndim + dim
    return dim - 1 + batch_offset


class Squeeze(Module):
    """Drop singleton dims: ``dim`` (1-based, possibly negative, or a
    tuple of them; counted after the batch dim with ``batch_mode``), or
    every singleton dim when ``dim`` is None."""

    def __init__(self, dim=None, num_input_dims=0, batch_mode=False,
                 name=None):
        super().__init__(name=name)
        self.dim = dim
        self.batch_mode = batch_mode

    def apply(self, params, x, ctx):
        if self.dim is None:
            return torch.squeeze(x)
        dims = self.dim if isinstance(self.dim, (tuple, list)) \
            else (self.dim,)
        axes = tuple(_axis(d, x.ndim, 1 if self.batch_mode else 0)
                     for d in dims)
        for a in axes:
            if x.shape[a] != 1:
                raise ValueError(f"{self.name}: cannot squeeze dim {a} of "
                                 f"size {x.shape[a]}")
        return torch.squeeze(x, dim=axes)


class Transpose(Module):
    """Swap the listed (1-based) dim pairs in order; the dims count after
    the batch dim."""

    def __init__(self, permutations, name=None):
        super().__init__(name=name)
        self.permutations = [tuple(p) for p in permutations]

    def apply(self, params, x, ctx):
        perm = list(range(x.ndim))
        for d1, d2 in self.permutations:
            a1, a2 = _axis(d1, x.ndim, 1), _axis(d2, x.ndim, 1)
            perm[a1], perm[a2] = perm[a2], perm[a1]
        return x.permute(perm)


class Padding(Module):
    """Pad ``pad`` entries of ``value`` along ``dim`` (1-based; before
    when ``pad`` < 0, after when > 0).  ``dim`` counts after the batch dim
    only when the input has more dims than ``n_input_dim``; an input of
    exactly ``n_input_dim`` dims pads its own dim ``dim`` (the batch dim
    for ``dim = 1``), as the reference does — see ROADMAP C6."""

    def __init__(self, dim, pad, n_input_dim, value=0.0, n_index=1,
                 name=None):
        super().__init__(name=name)
        self.dim = dim
        self.pad = pad
        self.n_input_dim = n_input_dim
        self.value = value

    def apply(self, params, x, ctx):
        ax = self.dim - 1 + (1 if x.ndim > self.n_input_dim else 0)
        lo, hi = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        pads = [0, 0] * (x.ndim - 1 - ax) + [lo, hi]
        return F.pad(x, pads, value=self.value)


class SpatialZeroPadding(Module):
    """Zero-pad H and W of NCHW (or NHWC) input; a negative pad crops."""

    def __init__(self, pad_left, pad_right=None, pad_top=None,
                 pad_bottom=None, format="NCHW", name=None):
        super().__init__(name=name)
        if pad_right is None:
            pad_right = pad_top = pad_bottom = pad_left
        self.pads = (pad_left, pad_right, pad_top, pad_bottom)
        self.format = format

    def apply(self, params, x, ctx):
        left, right, top, bottom = self.pads
        hax = 2 if self.format == "NCHW" else 1
        if min(self.pads) < 0:
            h, w = x.shape[hax], x.shape[hax + 1]
            sl = [slice(None)] * x.ndim
            sl[hax] = slice(max(0, -top), h - max(0, -bottom))
            sl[hax + 1] = slice(max(0, -left), w - max(0, -right))
            x = x[tuple(sl)]
            left, right, top, bottom = [max(0, v) for v in self.pads]
        pads = [0, 0] * (x.ndim - 2 - hax) + [left, right, top, bottom]
        return F.pad(x, pads)
