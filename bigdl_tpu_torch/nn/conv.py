"""Convolution (≙ ``bigdl_tpu/nn/conv.py``): ``SpatialConvolution``,
``SpaceToDepthConvolution``, ``SpatialDilatedConvolution`` and
``TemporalConvolution``.

Every conv is one ``F.conv2d`` (cuDNN on the card).  The weight is OIHW
in both formats.  With ``format="NHWC"`` the input ``(B, H, W, C)`` is
seen as NCHW through ``permute(0, 3, 1, 2)``: a channels-last view that
cuDNN takes without a copy; the output is permuted back to NHWC.

The reference rewrites a 1x1 strided conv without padding as a slice
followed by a dense 1x1 conv (``conv.py:93``), so that the TPU's input
gradient does not multiply inserted zeros.  That is a TPU matter and is
not kept: ``F.conv2d`` with the stride computes the same function.

``SpaceToDepthConvolution`` computes a stride-2 conv (ResNet's 7x7/2
stem) as a stride-1 conv over the 2x2 space-to-depth input, on the same
parameter tensor: the reference's reparameterization, copied step for
step.
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


class SpaceToDepthConvolution(SpatialConvolution):
    """A stride-2 conv computed on the 2x2 space-to-depth input: the
    kernel is zero-padded to even size and its taps ``k = 2a + d``
    regrouped into a ``(k/2, k/2)`` kernel over ``(dh, dw, c)`` channels
    (``transpose(0, 3, 5, 1, 2, 4)``), the input padded (or trimmed) to
    the even extent that covers every tap and regrouped the same way, and
    the conv runs with stride 1.  The same parameter tensor and the same
    function as the parent conv.  NHWC, stride 2, one group and explicit
    padding only, as the reference's."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.format != "NHWC":
            raise ValueError("SpaceToDepthConvolution requires NHWC")
        if self.stride != (2, 2):
            raise ValueError("SpaceToDepthConvolution requires stride 2")
        if self.n_group != 1:
            raise ValueError("SpaceToDepthConvolution requires n_group=1")
        if -1 in self.pad:
            raise ValueError("SpaceToDepthConvolution does not support "
                             "SAME (-1) padding; pass explicit pads")

    def apply(self, params, x, ctx):
        p = self.own(params)
        w = p["weight"].to(x.dtype)                 # OIHW (O, C, kh, kw)
        o, c, kh, kw = w.shape
        ph, pw = self.pad
        b, h, wd, _ = x.shape
        out_h = (h + 2 * ph - kh) // 2 + 1
        out_w = (wd + 2 * pw - kw) // 2 + 1
        k2h, k2w = -(-kh // 2) * 2, -(-kw // 2) * 2
        wp = F.pad(w, (0, k2w - kw, 0, k2h - kh))
        wp = wp.reshape(o, c, k2h // 2, 2, k2w // 2, 2) \
            .permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, k2h // 2, k2w // 2)
        need_h = 2 * (out_h + k2h // 2 - 1)
        need_w = 2 * (out_w + k2w // 2 - 1)
        xp = F.pad(x, (0, 0, pw, max(0, need_w - wd - pw),
                       ph, max(0, need_h - h - ph)))
        xp = xp[:, :need_h, :need_w, :]
        hp, wpd = xp.shape[1], xp.shape[2]
        xs = xp.reshape(b, hp // 2, 2, wpd // 2, 2, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, hp // 2, wpd // 2, 4 * c)
        y = F.conv2d(to_nchw(xs, "NHWC"), wp, None)
        y = from_nchw(y, "NHWC")[:, :out_h, :out_w, :]
        if self.with_bias:
            y = y + p["bias"].to(x.dtype)
        return y


class SpatialDilatedConvolution(Module):
    """2D convolution with a dilated kernel over NCHW input (the weight
    OIHW).  ``pad_w``/``pad_h`` = -1 selects SAME padding for the dilated
    kernel.  Xavier weight, zero bias, drawn from ``gen``."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, dilation_w=1, dilation_h=1,
                 w_regularizer=None, b_regularizer=None, with_bias=True,
                 name=None, *, gen: torch.Generator = None):
        super().__init__(name=name)
        check_regularizers(self, w_regularizer, b_regularizer)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kh, kw)
        self.stride = (dh, dw)
        self.pad = (pad_h, pad_w)
        self.dilation = (dilation_h, dilation_w)
        self.with_bias = with_bias
        fan_in = n_input_plane * kh * kw
        fan_out = n_output_plane * kh * kw
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, (n_output_plane, n_input_plane, kh, kw), fan_in,
            fan_out, Xavier()))
        if with_bias:
            self.bias = torch.nn.Parameter(init_tensor(
                self, gen, (n_output_plane,), fan_in, fan_out, Zeros(),
                kind="bias"))

    def apply(self, params, x, ctx):
        p = self.own(params)
        pads = [_same_pad(x.shape[2 + i], s, k, d) if pd == -1 else (pd, pd)
                for i, (pd, k, s, d) in enumerate(zip(
                    self.pad, self.kernel, self.stride, self.dilation))]
        return F.conv2d(pad_hw(x, pads), p["weight"].to(x.dtype),
                        p["bias"].to(x.dtype) if self.with_bias else None,
                        stride=self.stride, dilation=self.dilation)


class TemporalConvolution(Module):
    """1D convolution over ``(B, T, input_frame_size)`` input, giving
    ``(B, T', output_frame_size)``; no padding.  The weight is OIW
    ``(output_frame_size, input_frame_size, kernel_w)``: Xavier weight
    and zero bias, drawn from ``gen``."""

    def __init__(self, input_frame_size, output_frame_size, kernel_w,
                 stride_w=1, propagate_back=True, w_regularizer=None,
                 b_regularizer=None, name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        check_regularizers(self, w_regularizer, b_regularizer)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        fan_in = input_frame_size * kernel_w
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, (output_frame_size, input_frame_size, kernel_w),
            fan_in, output_frame_size, Xavier()))
        self.bias = torch.nn.Parameter(init_tensor(
            self, gen, (output_frame_size,), fan_in, output_frame_size,
            Zeros(), kind="bias"))

    def apply(self, params, x, ctx):
        p = self.own(params)
        y = F.conv1d(x.transpose(1, 2), p["weight"].to(x.dtype),
                     p["bias"].to(x.dtype), stride=self.stride_w)
        return y.transpose(1, 2)
