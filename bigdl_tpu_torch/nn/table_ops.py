"""Table (multi-activity) layers (≙ ``bigdl_tpu/nn/table_ops.py``): the
residual sum of the image classifiers."""
from __future__ import annotations

from functools import reduce

import torch

from .module import Module


class CAddTable(Module):
    """Elementwise sum of a list of tensors, left to right."""

    def __init__(self, inplace=False, name=None):
        super().__init__(name=name)

    def apply(self, params, x, ctx):
        return reduce(torch.add, x)
