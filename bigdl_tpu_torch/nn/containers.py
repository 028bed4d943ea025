"""Containers (≙ ``bigdl_tpu/nn/containers.py``): the ones the image
classifiers use.

A container registers its children in the reference's order (``"0"``,
``"1"``, ... as ``torch.nn.Sequential`` does), so that the depth-first
walk of ``modules()`` — which ``get_weights`` and ``models.convert``
follow — is the reference's.  A table activity is a Python list.
"""
from __future__ import annotations

from .module import Module


class Container(Module):
    """Base of the multi-child modules: owns the children, in order."""

    def __init__(self, *mods, name=None):
        super().__init__(name=name)
        for m in mods:
            self.add(m)

    def add(self, module):
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(Container):
    """Feed each child the previous child's output."""

    def apply(self, params, x, ctx):
        for m in self:
            x = m.apply(params, x, ctx)
        return x


class ConcatTable(Container):
    """Apply each child to the same input; the outputs as a list."""

    def apply(self, params, x, ctx):
        return [m.apply(params, x, ctx) for m in self]


class Identity(Module):
    def apply(self, params, x, ctx):
        return x
