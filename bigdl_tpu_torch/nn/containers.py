"""Containers (≙ ``bigdl_tpu/nn/containers.py``): ``Sequential``,
``Concat``, ``ConcatTable``, ``ParallelTable``, ``MapTable``, ``Bottle``,
``Identity``, ``Echo`` and ``Remat``.

A container registers its children in the reference's order (``"0"``,
``"1"``, ... as ``torch.nn.Sequential`` does), so that the depth-first
walk of ``modules()`` — which ``get_weights`` and ``models.convert``
follow — is the reference's.  A table activity is a Python list.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .module import Ctx, Module


class Container(Module):
    """Base of the multi-child modules: owns the children, in order."""

    def __init__(self, *mods, name=None):
        super().__init__(name=name)
        for m in mods:
            self.add(m)

    def add(self, module):
        self.add_module(str(len(self._modules)), module)
        return self

    def _serde_restore_children(self, children):
        self._modules.clear()
        for c in children:
            if c is not None:
                self.add(c)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)


class Sequential(Container):
    """Feed each child the previous child's output."""

    def apply(self, params, x, ctx):
        for m in self:
            x = m.apply(params, x, ctx)
        return x


class Concat(Container):
    """Apply each child to the same input and concatenate the outputs
    along ``dimension`` (1-based, as the reference counts it)."""

    def __init__(self, dimension, *mods, name=None):
        super().__init__(*mods, name=name)
        self.dimension = dimension

    def apply(self, params, x, ctx):
        return torch.cat([m.apply(params, x, ctx) for m in self],
                         dim=self.dimension - 1)


class ConcatTable(Container):
    """Apply each child to the same input; the outputs as a list."""

    def apply(self, params, x, ctx):
        return [m.apply(params, x, ctx) for m in self]


class ParallelTable(Container):
    """The i-th child takes the i-th element of the input list."""

    def apply(self, params, x, ctx):
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self):
            raise ValueError(f"{self.name}: input table size {len(xs)} != "
                             f"children {len(self)}")
        return [m.apply(params, e, ctx) for m, e in zip(self, xs)]


class MapTable(Container):
    """One shared child applied to every element of the input list."""

    def __init__(self, module=None, name=None):
        super().__init__(*([module] if module is not None else []),
                         name=name)

    def apply(self, params, x, ctx):
        m = self[0]
        return [m.apply(params, e, ctx) for e in x]


class Bottle(Container):
    """Fold the leading dims of a high-rank input into one batch dim,
    apply the child, unfold them again; ``n_input_dim`` counts the dims
    the child takes, the batch included."""

    def __init__(self, module, n_input_dim=2, n_output_dim=None, name=None):
        super().__init__(module, name=name)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim or n_input_dim

    def apply(self, params, x, ctx):
        shape = tuple(x.shape)
        cut = len(shape) - self.n_input_dim + 1
        y = self[0].apply(params, x.reshape((-1,) + shape[cut:]), ctx)
        return y.reshape(shape[:cut] + tuple(y.shape[1:]))


class Identity(Module):
    def apply(self, params, x, ctx):
        return x


class Echo(Module):
    """Print the shape and dtype of each tensor of the activity (a
    debugging aid); the activity passes unchanged."""

    def apply(self, params, x, ctx):
        for t in (x if isinstance(x, (list, tuple)) else [x]):
            print(f"[{self.name}] shape={tuple(getattr(t, 'shape', ()))} "
                  f"dtype={getattr(t, 'dtype', None)}")
        return x


class Remat(Container):
    """Recompute the child's activations in the backward instead of
    keeping them (``torch.utils.checkpoint``, non-reentrant; ≙ the
    reference's ``jax.checkpoint`` wrapper).  It adds no weights or state,
    so a wrapped model has the unwrapped one's ``get_weights``; wrap after
    the model is built (``resnet.build(remat=True)``) so that no auto name
    shifts.

    Two things cross the checkpoint boundary by hand, so that the wrapped
    model computes bitwise what the unwrapped one does:

      * the draws: the recompute draws from a copy of the generator set
        to its state before the forward (``preserve_rng_state`` restores
        only torch's default generators, not the loop's), so a
        ``Dropout`` inside redraws the same mask, and the loop's
        generator advances once, as without the wrapper;
      * the state: the forward's new batch-norm state and side losses
        are what the block returns; the recompute writes into a Ctx
        that is dropped.
    """

    def __init__(self, child=None, name=None):
        super().__init__(*([child] if child is not None else []), name=name)

    def apply(self, params, x, ctx):
        child = self[0]
        gen = ctx.generator
        gen_state = None if gen is None else gen.get_state()
        passes = []

        def block(xx):
            g = gen
            if passes and gen is not None:     # the backward's recompute
                g = torch.Generator(device=gen.device)
                g.set_state(gen_state)
            sub = Ctx(state=ctx.state, training=ctx.training, generator=g,
                      draws=ctx.draws, shard=ctx.shard)
            passes.append(sub)
            return child.apply(params, xx, sub)

        y = checkpoint(block, x, use_reentrant=False,
                       preserve_rng_state=False)
        ctx.new_state.update(passes[0].new_state)
        ctx.side_losses.extend(passes[0].side_losses)
        return y
