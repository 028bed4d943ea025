"""Elementwise math and small utility layers (≙
``bigdl_tpu/nn/elementwise.py``): ``Abs``, ``AddConstant``,
``MulConstant``, ``Exp``, ``Log``, ``Log1p``, ``Sqrt``, ``Square``,
``Power``, ``Highway``, ``Scale``, and the penalties ``L1Penalty``,
``ActivityRegularization`` and ``NegativeEntropyPenalty``, which pass
their input on and add a side loss through ``Ctx.add_loss`` (the
training loops add the side losses to the loss).

``|x|`` has gradient 1 at 0 here, as ``jnp.abs`` has (``torch.abs``
gives 0): :func:`abs_`.
"""
from __future__ import annotations

import torch

from .activation import Tanh
from .linear import CAdd, CMul, Linear
from .module import Module


class _Abs(torch.autograd.Function):
    """``|x|`` with the gradient ``where(x >= 0, g, -g)``: 1 at ±0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x):
    """``|x|`` with JAX's gradient at 0."""
    return _Abs.apply(x)


class Abs(Module):
    def apply(self, params, x, ctx):
        return abs_(x)


class AddConstant(Module):
    def __init__(self, constant_scalar, inplace=False, name=None):
        super().__init__(name=name)
        self.constant = constant_scalar

    def apply(self, params, x, ctx):
        return x + self.constant


class MulConstant(Module):
    def __init__(self, scalar, inplace=False, name=None):
        super().__init__(name=name)
        self.scalar = scalar

    def apply(self, params, x, ctx):
        return x * self.scalar


class Exp(Module):
    def apply(self, params, x, ctx):
        return torch.exp(x)


class Log(Module):
    def apply(self, params, x, ctx):
        return torch.log(x)


class Log1p(Module):
    def apply(self, params, x, ctx):
        return torch.log1p(x)


class Sqrt(Module):
    def apply(self, params, x, ctx):
        return torch.sqrt(x)


class Square(Module):
    def apply(self, params, x, ctx):
        return x * x


class Power(Module):
    """``(shift + scale·x) ** power``."""

    def __init__(self, power, scale=1.0, shift=0.0, name=None):
        super().__init__(name=name)
        self.power = power
        self.scale = scale
        self.shift = shift

    def apply(self, params, x, ctx):
        return (self.shift + self.scale * x) ** self.power


class Highway(Module):
    """``t·g(W_h x) + (1 − t)·x`` with the gate ``t = sigmoid(W_t x)``;
    children gate, transform, activation (Tanh by default), in that
    order."""

    def __init__(self, size, with_bias=True, activation=None,
                 w_regularizer=None, b_regularizer=None, name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        self.size = size
        self.gate = Linear(size, size, with_bias=with_bias,
                           w_regularizer=w_regularizer,
                           b_regularizer=b_regularizer,
                           name=f"{self.name}_gate", gen=gen)
        self.transform = Linear(size, size, with_bias=with_bias,
                                w_regularizer=w_regularizer,
                                b_regularizer=b_regularizer,
                                name=f"{self.name}_transform", gen=gen)
        self.activation = activation or Tanh(name=f"{self.name}_act")

    def apply(self, params, x, ctx):
        t = torch.sigmoid(self.gate.apply(params, x, ctx))
        h = self.activation.apply(params,
                                  self.transform.apply(params, x, ctx), ctx)
        return t * h + (1.0 - t) * x


class Scale(Module):
    """``CMul`` then ``CAdd`` of ``size``."""

    def __init__(self, size, name=None, *, gen: torch.Generator = None):
        super().__init__(name=name)
        self.cmul = CMul(size, name=f"{self.name}_mul", gen=gen)
        self.cadd = CAdd(size, name=f"{self.name}_add", gen=gen)

    def apply(self, params, x, ctx):
        return self.cadd.apply(params, self.cmul.apply(params, x, ctx), ctx)


class L1Penalty(Module):
    """Identity; adds ``l1weight · Σ|x|`` (÷ the element count with
    ``size_average``) to the loss as a side loss."""

    def __init__(self, l1weight, size_average=False, provide_output=True,
                 name=None):
        super().__init__(name=name)
        self.l1weight = l1weight
        self.size_average = size_average

    def apply(self, params, x, ctx):
        pen = torch.sum(abs_(x))
        if self.size_average:
            pen = pen / x.numel()
        ctx.add_loss(self.l1weight * pen)
        return x


class ActivityRegularization(Module):
    """Identity; adds ``l1·Σ|x| + l2·Σx²`` to the loss as a side loss."""

    def __init__(self, l1=0.0, l2=0.0, name=None):
        super().__init__(name=name)
        self.l1 = l1
        self.l2 = l2

    def apply(self, params, x, ctx):
        ctx.add_loss(self.l1 * torch.sum(abs_(x))
                     + self.l2 * torch.sum(x * x))
        return x


class NegativeEntropyPenalty(Module):
    """Identity on probabilities ``x``; adds ``−beta · H(x)`` to the loss
    as a side loss."""

    def __init__(self, beta=0.01, name=None):
        super().__init__(name=name)
        self.beta = beta

    def apply(self, params, x, ctx):
        ent = -torch.sum(x * torch.log(torch.clamp_min(x, 1e-8)))
        ctx.add_loss(-self.beta * ent)
        return x
