"""Activation layers (≙ ``bigdl_tpu/nn/activation.py``): the ones the
image classifiers use."""
from __future__ import annotations

import torch

from .module import Module


class ReLU(Module):
    """max(x, 0), as ``torch.maximum``: its gradient at exactly 0 is ½, as
    that of the reference's ``jnp.maximum(x, 0)`` is (``torch.relu`` gives
    0 there, ``clamp_min`` 1)."""

    def __init__(self, ip=False, name=None):
        super().__init__(name=name)

    def apply(self, params, x, ctx):
        return torch.maximum(x, x.new_zeros(()))


class Tanh(Module):
    def apply(self, params, x, ctx):
        return torch.tanh(x)


class LogSoftMax(Module):
    """log softmax over the last dim; feeds ClassNLLCriterion."""

    def apply(self, params, x, ctx):
        return torch.log_softmax(x, dim=-1)
