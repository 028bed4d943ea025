"""Normalization layers (≙ ``bigdl_tpu/nn/normalization.py``):
:class:`RMSNorm` for the transformer, batch norm for the image
classifiers."""
from __future__ import annotations

import torch

from .init import Ones, Zeros, init_tensor
from .module import Module


class RMSNorm(Module):
    """RMS norm (the transformer flagship's norm), computed in fp32."""

    def __init__(self, hidden_size, eps=1e-6, name=None):
        super().__init__(name=name)
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = torch.nn.Parameter(
            torch.ones((hidden_size,), dtype=torch.float32))

    def apply(self, params, x, ctx):
        p = self.own(params)
        xf = x.float()
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                             + self.eps)
        return (y * p["weight"]).to(x.dtype)


class BatchNormalization(Module):
    """Batch norm over (B, C) or (B, C, ...), statistics over every dim but
    the channel dim (axis 1; axis 3 for ``SpatialBatchNormalization`` in
    NHWC).

    In training it computes the reference's statistics in fp32: the mean,
    and the variance as ``max(E[x²] − mean², 0)`` (not Welford's form); it
    normalizes with them and writes the running statistics to
    ``ctx.new_state``: ``(1 − m)·running + m·batch``, the variance
    unbiased with ``n`` = the elements per channel.  The gradient is
    autograd's through the same formula, which is the exact gradient that
    the reference's hand-written backward computes (``F.batch_norm`` is a
    later performance change, to be measured against this).  In inference
    it normalizes with the running statistics from ``ctx.state``.

    The running statistics are buffers of the module (see
    ``Module.initial_state``).  ``sync_axis`` (cross-replica statistics)
    is not ported yet (ROADMAP queue A, item 10).
    """

    channel_axis = 1

    def __init__(self, n_output, eps=1e-5, momentum=0.1, affine=True,
                 sync_axis=None, name=None):
        super().__init__(name=name)
        if sync_axis is not None:
            raise NotImplementedError(
                f"{type(self).__name__}: sync_axis={sync_axis!r} (sync BN) "
                f"needs data parallelism, which is not ported yet (ROADMAP "
                f"queue A, item 10)")
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = torch.nn.Parameter(init_tensor(
                self, None, (n_output,), n_output, n_output, Ones()))
            self.bias = torch.nn.Parameter(init_tensor(
                self, None, (n_output,), n_output, n_output, Zeros(),
                kind="bias"))
        self.register_buffer("running_mean",
                             torch.zeros((n_output,), dtype=torch.float32))
        self.register_buffer("running_var",
                             torch.ones((n_output,), dtype=torch.float32))

    def _bshape(self, x):
        shape = [1] * x.ndim
        shape[self.channel_axis] = x.shape[self.channel_axis]
        return shape

    def apply(self, params, x, ctx):
        st = ctx.get_state(self)
        shape = self._bshape(x)
        if ctx.training:
            axes = tuple(i for i in range(x.ndim) if i != self.channel_axis)
            xf = x.float()
            mean = xf.mean(dim=axes)
            m2 = (xf * xf).mean(dim=axes)
            var = torch.clamp_min(m2 - mean * mean, 0.0)
            inv = torch.rsqrt(var + self.eps)
            if self.affine:
                p = self.own(params)
                gamma, beta = p["weight"].float(), p["bias"].float()
                scale = gamma * inv
                shift = beta - gamma * mean * inv
            else:
                scale, shift = inv, -mean * inv
            self._update_running(ctx, st, mean.detach(), var.detach(), x)
        else:
            inv = torch.rsqrt(st["running_var"] + self.eps)
            scale, shift = inv, -st["running_mean"] * inv
            if self.affine:
                p = self.own(params)
                scale = scale * p["weight"]
                shift = shift * p["weight"] + p["bias"]
        return (x * scale.reshape(shape).to(x.dtype)
                + shift.reshape(shape).to(x.dtype))

    def _update_running(self, ctx, st, mean, var, x):
        m = self.momentum
        n = x.numel() // x.shape[self.channel_axis]
        unbiased = var * n / max(n - 1, 1)
        ctx.put_state(self, {
            "running_mean": (1 - m) * st["running_mean"] + m * mean,
            "running_var": (1 - m) * st["running_var"] + m * unbiased})


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm per channel over NCHW, or NHWC with ``format="NHWC"``."""

    def __init__(self, n_output, eps=1e-5, momentum=0.1, affine=True,
                 sync_axis=None, format="NCHW", name=None):
        super().__init__(n_output, eps=eps, momentum=momentum, affine=affine,
                         sync_axis=sync_axis, name=name)
        if format == "NHWC":
            self.channel_axis = 3
