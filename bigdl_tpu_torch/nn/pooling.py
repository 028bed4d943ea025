"""Pooling (≙ ``bigdl_tpu/nn/pooling.py``): ``SpatialMaxPooling``,
``SpatialAveragePooling`` and ``TemporalMaxPooling``.

The reference's geometry pads each spatial dim by ``(lo, hi)`` from
:func:`_pool_pads`, possibly asymmetrically (ResNet's stem max-pool on
112 gives ``(1, 0)``; ``ceil_mode`` can add a ``hi`` pad), then pools
with no padding.  The port does the same: ``F.pad`` with −inf for the
max and 0 for the average, then a pool with padding 0.  The average
divides the window sum by ``k·k`` (``count_include_pad``) or by the
number of input elements in each window.
"""
from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from .conv import from_nchw, pad_hw, to_nchw
from .module import Module


def _pool_pads(in_size, k, s, pad, ceil_mode):
    """Reference pooling geometry: out = floor_or_ceil((in + 2p - k)/s) + 1;
    returns the (lo, hi) padding that gives it."""
    if pad == -1:  # SAME, reference keras-style
        out = -(-in_size // s)
        total = max(0, (out - 1) * s + k - in_size)
        return total // 2, total - total // 2
    if ceil_mode:
        out = int(np.ceil((in_size + 2 * pad - k) / s)) + 1
        # torch rule: last window must start inside the (padded) input
        if (out - 1) * s >= in_size + pad:
            out -= 1
    else:
        out = int(np.floor((in_size + 2 * pad - k) / s)) + 1
    hi = max(0, (out - 1) * s + k - in_size - pad)
    return pad, hi


class SpatialMaxPooling(Module):
    """Max pooling; pad -1 means SAME."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 format="NCHW", ceil_mode=False, name=None):
        super().__init__(name=name)
        self.kernel = (kh, kw)
        self.stride = (dh or kh, dw or kw)
        self.pad = (pad_h, pad_w)
        self.format = format
        self.ceil_mode = ceil_mode

    _serde_extra_attrs = ("ceil_mode",)

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def apply(self, params, x, ctx):
        xc = to_nchw(x, self.format)
        pads = [_pool_pads(xc.shape[2 + i], self.kernel[i], self.stride[i],
                           self.pad[i], self.ceil_mode) for i in range(2)]
        y = F.max_pool2d(pad_hw(xc, pads, -float("inf")), self.kernel,
                         self.stride)
        return from_nchw(y, self.format)


class SpatialAveragePooling(Module):
    """Average pooling; ``global_pooling`` pools the whole plane,
    ``divide=False`` returns the window sums."""

    def __init__(self, kw, kh, dw=1, dh=1, pad_w=0, pad_h=0,
                 global_pooling=False, ceil_mode=False,
                 count_include_pad=True, divide=True, format="NCHW",
                 name=None):
        super().__init__(name=name)
        self.kernel = (kh, kw)
        self.stride = (dh, dw)
        self.pad = (pad_h, pad_w)
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide
        self.format = format

    _serde_extra_attrs = ("ceil_mode",)

    def ceil(self):
        self.ceil_mode = True
        return self

    def apply(self, params, x, ctx):
        xc = to_nchw(x, self.format)
        hs = tuple(xc.shape[2:4])
        kernel = hs if self.global_pooling else self.kernel
        stride = (1, 1) if self.global_pooling else self.stride
        pads = [(0, 0), (0, 0)] if self.global_pooling else \
            [_pool_pads(hs[i], kernel[i], stride[i], self.pad[i],
                        self.ceil_mode) for i in range(2)]
        s = F.avg_pool2d(pad_hw(xc, pads), kernel, stride,
                         divisor_override=1)
        if self.divide:
            if self.count_include_pad:
                s = s / float(np.prod(kernel))
            else:
                ones = xc.new_ones((1, 1) + hs)
                s = s / F.avg_pool2d(pad_hw(ones, pads), kernel, stride,
                                     divisor_override=1)
        return from_nchw(s, self.format)


class TemporalMaxPooling(Module):
    """Max over windows of ``k_w`` time steps, ``d_w`` apart (default
    ``k_w``), of a ``(B, T, C)`` input; no padding, a partial last window
    is dropped."""

    def __init__(self, k_w, d_w=None, name=None):
        super().__init__(name=name)
        self.k_w = k_w
        self.d_w = d_w or k_w

    def apply(self, params, x, ctx):
        y = F.max_pool1d(x.transpose(1, 2), self.k_w, self.d_w)
        return y.transpose(1, 2)
