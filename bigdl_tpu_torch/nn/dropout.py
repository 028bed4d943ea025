"""Stochastic regularization layers (≙ ``bigdl_tpu/nn/dropout.py``):
``Dropout``, ``GaussianDropout``, ``GaussianNoise``, ``GaussianSampler``
and ``SpatialDropout1D/2D/3D``.

Each layer draws through :meth:`Ctx.draw`: from the ``torch.Generator``
the ``Ctx`` carries (a training loop's, which its ``seed`` seeds), or the
draw ``Ctx.draws`` gives under the layer's name.  The draw is the raw
sample (a keep mask, standard normal noise), so a test can feed the
reference's own ``jax.random`` draws and compare the rest bit for bit.

The arithmetic is the reference's: ``where(mask, x, 0)`` first, then the
division by ``keep`` in ``x``'s dtype (``keep`` rounded to that dtype, as
JAX rounds a weakly typed scalar), which decides the bits under bf16.
"""
from __future__ import annotations

import torch

from .module import Module


def _keep_mask(ctx, module, x, keep, shape):
    """A boolean mask of ``shape``, true with probability ``keep``
    (``uniform < keep``, as ``jax.random.bernoulli`` draws it)."""
    return ctx.draw(module, x.device, lambda g: torch.rand(
        shape, generator=g, device=x.device) < keep)


def _normal(ctx, module, like):
    """Standard normal noise of ``like``'s shape and dtype."""
    return ctx.draw(module, like.device, lambda g: torch.randn(
        like.shape, generator=g, device=like.device, dtype=like.dtype))


def _drop(x, mask):
    return torch.where(mask, x, x.new_zeros(()))


class Dropout(Module):
    """Inverted dropout: zero with probability ``p`` and, with ``scale``,
    divide the kept values by ``1 - p``, in training mode only."""

    def __init__(self, init_p=0.5, inplace=False, scale=True, name=None):
        super().__init__(name=name)
        self.p = init_p
        self.scale = scale

    _serde_extra_attrs = ("p",)

    def set_p(self, p):
        self.p = p
        return self

    def apply(self, params, x, ctx):
        if not ctx.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        y = _drop(x, _keep_mask(ctx, self, x, keep, x.shape))
        return y / torch.tensor(keep, dtype=x.dtype) if self.scale else y


class GaussianDropout(Module):
    """Multiplicative N(1, rate / (1 - rate)) noise in training mode."""

    def __init__(self, rate, name=None):
        super().__init__(name=name)
        self.rate = rate

    def apply(self, params, x, ctx):
        if not ctx.training:
            return x
        stddev = torch.sqrt(torch.tensor(self.rate / (1.0 - self.rate),
                                         dtype=torch.float32))
        noise = 1.0 + stddev.to(x.dtype) * _normal(ctx, self, x)
        return x * noise


class GaussianNoise(Module):
    """Additive N(0, stddev) noise in training mode."""

    def __init__(self, stddev, name=None):
        super().__init__(name=name)
        self.stddev = stddev

    def apply(self, params, x, ctx):
        if not ctx.training:
            return x
        return x + torch.tensor(self.stddev, dtype=x.dtype) \
            * _normal(ctx, self, x)


class GaussianSampler(Module):
    """A sample of N(mean, exp(log_var)) from the list ``[mean,
    log_var]`` (the VAE's reparameterization), in either mode."""

    def apply(self, params, x, ctx):
        mean, log_var = x
        return mean + torch.exp(0.5 * log_var) * _normal(ctx, self, mean)


class SpatialDropout1D(Module):
    """Drop whole channels of (B, T, C), unscaled."""

    def __init__(self, init_p=0.5, name=None):
        super().__init__(name=name)
        self.p = init_p

    def apply(self, params, x, ctx):
        if not ctx.training or self.p <= 0.0:
            return x
        return _drop(x, _keep_mask(ctx, self, x, 1.0 - self.p,
                                   (x.shape[0], 1, x.shape[2])))


class SpatialDropout2D(Module):
    """Drop whole feature maps of NCHW (or NHWC) input, unscaled."""

    def __init__(self, init_p=0.5, format="NCHW", name=None):
        super().__init__(name=name)
        self.p = init_p
        self.format = format

    def apply(self, params, x, ctx):
        if not ctx.training or self.p <= 0.0:
            return x
        shape = ((x.shape[0], x.shape[1], 1, 1) if self.format == "NCHW"
                 else (x.shape[0], 1, 1, x.shape[3]))
        return _drop(x, _keep_mask(ctx, self, x, 1.0 - self.p, shape))


class SpatialDropout3D(Module):
    """Drop whole volumes of NCDHW (or NDHWC) input, unscaled."""

    def __init__(self, init_p=0.5, format="NCDHW", name=None):
        super().__init__(name=name)
        self.p = init_p
        self.format = format

    def apply(self, params, x, ctx):
        if not ctx.training or self.p <= 0.0:
            return x
        shape = ((x.shape[0], x.shape[1], 1, 1, 1) if self.format == "NCDHW"
                 else (x.shape[0], 1, 1, 1, x.shape[4]))
        return _drop(x, _keep_mask(ctx, self, x, 1.0 - self.p, shape))
