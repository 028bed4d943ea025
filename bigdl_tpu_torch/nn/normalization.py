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


def _moments(x, axes):
    """fp32 batch mean, ``max(E[x²] − mean², 0)`` and ``rsqrt(var + eps)``
    inputs (the reference's ``_bn_train_fwd_impl`` statistics)."""
    xf = x.float()
    mean = xf.mean(dim=axes)
    m2 = (xf * xf).mean(dim=axes)
    return mean, torch.clamp_min(m2 - mean * mean, 0.0)


class _BNTrain(torch.autograd.Function):
    """Training-mode batch norm with the reference's closed-form backward
    (≙ ``bigdl_tpu/nn/normalization.py`` ``_bn_train``, a custom VJP).

    Forward: fp32 mean and E[x²], ``scale = gamma·inv`` and ``shift =
    beta − gamma·mean·inv`` cast to x's dtype, ``y = x·scale + shift``.
    Returns ``(y, mean, var)``; mean and var feed the running statistics
    only and get no gradient.  Saved for the backward: x, gamma, mean and
    inv (no fp32 copy of x).  Backward, in fp32 from ``dy``: ``dbeta =
    Σdy``, ``dgamma = Σdy·x̂``, ``dx = gamma·inv·(dy − (dbeta + x̂·dgamma)
    / n)`` cast once to x's dtype: two passes over the activations."""

    @staticmethod
    def forward(ctx, x, gamma, beta, channel_axis, eps):
        axes = tuple(i for i in range(x.ndim) if i != channel_axis)
        shape = [1] * x.ndim
        shape[channel_axis] = x.shape[channel_axis]
        mean, var = _moments(x, axes)
        inv = torch.rsqrt(var + eps)
        scale = (gamma * inv).reshape(shape).to(x.dtype)
        shift = (beta - gamma * mean * inv).reshape(shape).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.channel_axis = channel_axis
        ctx.mark_non_differentiable(mean, var)
        return x * scale + shift, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        axis = ctx.channel_axis
        axes = tuple(i for i in range(x.ndim) if i != axis)
        n = x.numel() // x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        dy32 = dy.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dbeta = dy32.sum(dim=axes)
        dgamma = (dy32 * xhat).sum(dim=axes)
        coef = (gamma * inv).reshape(shape)
        dx = coef * (dy32 - (dbeta.reshape(shape)
                             + xhat * dgamma.reshape(shape)) / n)
        return dx.to(x.dtype), dgamma, dbeta, None, None


class BatchNormalization(Module):
    """Batch norm over (B, C) or (B, C, ...), statistics over every dim but
    the channel dim (axis 1; axis 3 for ``SpatialBatchNormalization`` in
    NHWC).

    In training (``sync_axis`` None) it runs :class:`_BNTrain`, the
    reference's ``_bn_train``: fp32 statistics, the mean and the variance
    as ``max(E[x²] − mean², 0)`` (not Welford's form), and the closed-form
    backward in fp32; it writes the running statistics to
    ``ctx.new_state``: ``(1 − m)·running + m·batch``, the variance
    unbiased with ``n`` = the elements per channel.  In inference it
    normalizes with the running statistics from ``ctx.state``.

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
        if ctx.training:
            if self.affine:
                p = self.own(params)
                gamma, beta = p["weight"].float(), p["bias"].float()
            else:
                c = x.shape[self.channel_axis]
                gamma = torch.ones((c,), dtype=torch.float32,
                                   device=x.device)
                beta = torch.zeros((c,), dtype=torch.float32,
                                   device=x.device)
            y, mean, var = _BNTrain.apply(x, gamma, beta, self.channel_axis,
                                          self.eps)
            self._update_running(ctx, st, mean, var, x)
            return y
        inv = torch.rsqrt(st["running_var"] + self.eps)
        scale, shift = inv, -st["running_mean"] * inv
        if self.affine:
            p = self.own(params)
            scale = scale * p["weight"]
            shift = shift * p["weight"] + p["bias"]
        shape = self._bshape(x)
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
