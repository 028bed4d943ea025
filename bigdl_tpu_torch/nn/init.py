"""Weight initialization methods (≙ ``bigdl_tpu/nn/init.py``).

Each method is a callable ``(gen, shape, fan_in, fan_out) -> tensor``
that draws an fp32 CPU tensor from the ``torch.Generator`` ``gen`` (None:
torch's default generator).  The distributions are the reference's; the
streams are torch's, so one seed does not give the reference's numbers
(tests load the reference's weights instead, ``models.convert``).
"""
from __future__ import annotations

import numpy as np
import torch


class InitializationMethod:
    """Base of weight/bias initializers."""

    def __call__(self, gen, shape, fan_in, fan_out):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def __call__(self, gen, shape, fan_in, fan_out):
        return torch.zeros(shape, dtype=torch.float32)


class Ones(InitializationMethod):
    def __call__(self, gen, shape, fan_in, fan_out):
        return torch.ones(shape, dtype=torch.float32)


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (hi - lo) + lo


class RandomUniform(InitializationMethod):
    """U(lower, upper); without bounds U(±1/sqrt(fan_in))."""

    def __init__(self, lower=None, upper=None):
        self.lower, self.upper = lower, upper

    def __call__(self, gen, shape, fan_in, fan_out):
        if self.lower is None:
            bound = 1.0 / np.sqrt(max(fan_in, 1))
            return _uniform(gen, shape, -bound, bound)
        return _uniform(gen, shape, self.lower, self.upper)


class RandomNormal(InitializationMethod):
    """N(mean, stdv)."""

    def __init__(self, mean=0.0, stdv=1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, gen, shape, fan_in, fan_out):
        return self.mean + self.stdv * torch.randn(
            shape, generator=gen, dtype=torch.float32)


class Xavier(InitializationMethod):
    """Glorot uniform, U(±sqrt(6 / (fan_in + fan_out))): the default of
    Linear and SpatialConvolution."""

    def __call__(self, gen, shape, fan_in, fan_out):
        bound = float(np.sqrt(6.0 / max(fan_in + fan_out, 1)))
        return _uniform(gen, shape, -bound, bound)


class MsraFiller(InitializationMethod):
    """Kaiming/He normal, std sqrt(2 / n), n = fan_in (or fan_out)."""

    def __init__(self, var_in_count=True):
        self.var_in_count = var_in_count

    def __call__(self, gen, shape, fan_in, fan_out):
        n = fan_in if self.var_in_count else fan_out
        std = float(np.sqrt(2.0 / max(n, 1)))
        return std * torch.randn(shape, generator=gen, dtype=torch.float32)


def init_tensor(module, gen, shape, fan_in, fan_out, default, kind="weight"):
    """The module's override (``weight_init`` / ``bias_init``) or the
    layer's ``default``, drawn from ``gen``.  The draw's plan is kept on
    the module (``_init_plan[kind]``) for :func:`redraw`."""
    plan = module.__dict__.setdefault("_init_plan", {})
    plan[kind] = (tuple(shape), fan_in, fan_out, default)
    override = module.weight_init if kind.startswith("weight") \
        else module.bias_init
    method = override if override is not None else default
    return method(gen, shape, fan_in, fan_out)


@torch.no_grad()
def redraw(module) -> None:
    """Draw ``module``'s own ``weight`` and ``bias`` again from torch's
    default generator with its current overrides
    (``Module.set_init_method``)."""
    for kind, (shape, fan_in, fan_out, default) in getattr(
            module, "_init_plan", {}).items():
        param = getattr(module, kind, None)
        if isinstance(param, torch.nn.Parameter):
            param.copy_(init_tensor(module, None, shape, fan_in, fan_out,
                                    default, kind))
