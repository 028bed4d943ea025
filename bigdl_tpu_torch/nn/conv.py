"""Convolution (≙ ``bigdl_tpu/nn/conv.py``): ``SpatialConvolution``.

Every conv is one ``F.conv2d`` (cuDNN on the card).  The weight is OIHW
in both formats.  With ``format="NHWC"`` the input ``(B, H, W, C)`` is
seen as NCHW through ``permute(0, 3, 1, 2)``: a channels-last view that
cuDNN takes without a copy; the output is permuted back to NHWC.

The reference rewrites a 1x1 strided conv without padding as a slice
followed by a dense 1x1 conv (``conv.py:93``), so that the TPU's input
gradient does not multiply inserted zeros.  That is a TPU matter and is
not kept: ``F.conv2d`` with the stride computes the same function.

``SpaceToDepthConvolution`` is not ported yet (ROADMAP queue A, item 10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .init import Xavier, Zeros, init_tensor
from .module import Module, check_regularizers


def _same_pad(in_size, stride, ksize, dilation=1):
    """TF/Keras SAME padding split (lo, hi) for one spatial dim."""
    eff_k = (ksize - 1) * dilation + 1
    out = -(-in_size // stride)
    pad = max(0, (out - 1) * stride + eff_k - in_size)
    return pad // 2, pad - pad // 2


def pad_hw(x, pads, value=0.0):
    """``x`` (NCHW) padded by ``pads = [(top, bottom), (left, right)]``
    with ``value``; returned as it is when every pad is 0."""
    (top, bottom), (left, right) = pads
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def to_nchw(x, fmt):
    return x.permute(0, 3, 1, 2) if fmt == "NHWC" else x


def from_nchw(y, fmt):
    return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


class SpatialConvolution(Module):
    """2D convolution.  ``pad_w``/``pad_h`` = -1 selects SAME padding (the
    reference's convention, possibly asymmetric); ``n_group`` is
    ``groups``; ``format`` is ``"NCHW"`` (default) or ``"NHWC"``.  Xavier
    weight, zero bias, drawn from ``gen``."""

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0, n_group=1,
                 propagate_back=True, w_regularizer=None, b_regularizer=None,
                 with_bias=True, format="NCHW", name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError("channels must be multiples of n_group")
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown format {format!r}")
        check_regularizers(self, w_regularizer, b_regularizer)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.n_group = n_group
        self.with_bias = with_bias
        self.format = format
        fan_in = n_input_plane // n_group * kernel_h * kernel_w
        fan_out = n_output_plane // n_group * kernel_h * kernel_w
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, (n_output_plane, n_input_plane // n_group, kernel_h,
                        kernel_w), fan_in, fan_out, Xavier()))
        if with_bias:
            self.bias = torch.nn.Parameter(init_tensor(
                self, gen, (n_output_plane,), fan_in, fan_out, Zeros(),
                kind="bias"))

    def _padding(self, spatial):
        return [_same_pad(spatial[i], s, k) if p == -1 else (p, p)
                for i, (p, k, s) in enumerate(zip(self.pad, self.kernel,
                                                  self.stride))]

    def apply(self, params, x, ctx):
        p = self.own(params)
        xc = to_nchw(x, self.format)
        pads = self._padding(xc.shape[2:4])
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            xc, padding = pad_hw(xc, pads), 0
        y = F.conv2d(xc, p["weight"].to(x.dtype),
                     p["bias"].to(x.dtype) if self.with_bias else None,
                     stride=self.stride, padding=padding,
                     groups=self.n_group)
        return from_nchw(y, self.format)
