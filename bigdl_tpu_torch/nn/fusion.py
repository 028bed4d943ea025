"""Fold batch norm into the conv or linear layer before it, for
inference (≙ ``bigdl_tpu/nn/fusion.py``).

In inference a BN is an affine map of its running statistics, so after
a conv or linear layer it folds into that layer's weights:

    s  = gamma / sqrt(var + eps)      (per output channel)
    w' = w · s                        (output channel is dim 0)
    b' = (b − mu) · s + beta  =  b · s + (beta − mu · s)

:func:`fold_batchnorm` returns a new model (a deep copy) in inference
mode with every foldable pair folded and the BN removed, in
``Sequential`` s and in ``Graph`` s; training is untouched.
"""
from __future__ import annotations

import copy

import torch

from .containers import Container, Sequential
from .conv import SpatialConvolution
from .graph import Graph
from .linear import Linear
from .normalization import BatchNormalization

__all__ = ["fold_batchnorm"]


def _bn_affine(bn):
    """(scale, shift) of the inference-mode BN, fp32."""
    inv = 1.0 / torch.sqrt(bn.running_var.float() + bn.eps)
    if bn.affine:
        gamma, beta = bn.weight.float(), bn.bias.float()
    else:
        gamma = torch.ones_like(inv)
        beta = torch.zeros_like(inv)
    return gamma * inv, beta - bn.running_mean.float() * gamma * inv


def _foldable(mod, bn):
    """A conv or linear layer with a weight, feeding a BN of as many
    channels."""
    if not isinstance(bn, BatchNormalization):
        return False
    if isinstance(mod, SpatialConvolution):
        return mod.n_output_plane == bn.n_output
    if isinstance(mod, Linear):
        return mod.output_size == bn.n_output
    return False


@torch.no_grad()
def _fold_pair(mod, bn):
    scale, shift = _bn_affine(bn)
    w = mod.weight
    w.copy_(w * scale.reshape((-1,) + (1,) * (w.ndim - 1)))
    b = mod.bias if mod.with_bias else torch.zeros_like(scale)
    new_b = b * scale + shift
    if mod.with_bias:
        mod.bias.copy_(new_b)
    else:
        mod.bias = torch.nn.Parameter(new_b)
        mod.with_bias = True


def fold_batchnorm(model):
    """A new model (deep copy, inference mode) with every adjacent
    conv→BN and linear→BN pair folded and the BN removed: in each
    ``Sequential``, recursively, and in each ``Graph`` where the BN is the
    layer's only consumer and the layer is no graph output.  A layer or
    BN used at more than one site (shared weights) is never folded:
    folding it once would change every other use."""
    new_model = copy.deepcopy(model)
    occurrences = {}

    def count(m):
        occurrences[id(m)] = occurrences.get(id(m), 0) + 1
        if isinstance(m, Graph):
            for n in m._topo:
                if n.module is not None:
                    count(n.module)
        elif isinstance(m, Container):
            for c in m:
                count(c)

    count(new_model)

    def single(*mods):
        return all(occurrences.get(id(m), 0) == 1 for m in mods)

    def fold_graph(g):
        consumers = {}
        for n in g._topo:
            for prev in n.prev_nodes:
                consumers.setdefault(id(prev), []).append(n)
        for b in list(g._topo):
            if (b.module is None or not isinstance(b.module,
                                                   BatchNormalization)
                    or len(b.prev_nodes) != 1):
                continue
            a = b.prev_nodes[0]
            if (a.module is None or not _foldable(a.module, b.module)
                    or len(consumers.get(id(a), [])) != 1
                    or any(n is a for n in g.output_nodes)
                    or not single(a.module, b.module)):
                continue
            _fold_pair(a.module, b.module)
            for c in consumers.get(id(b), []):
                c.prev_nodes = [a if prev is b else prev
                                for prev in c.prev_nodes]
            g.output_nodes = [a if n is b else n for n in g.output_nodes]
            consumers[id(a)] = consumers.pop(id(b), [])
        g.sort()

    def walk(container):
        if isinstance(container, Graph):
            for child in list(container.children()):
                walk(child)
            fold_graph(container)
            return
        if not isinstance(container, Container):
            return
        for child in list(container):
            walk(child)
        if not isinstance(container, Sequential):
            return
        kids, keep, i = list(container), [], 0
        while i < len(kids):
            mod = kids[i]
            nxt = kids[i + 1] if i + 1 < len(kids) else None
            if nxt is not None and _foldable(mod, nxt) and single(mod, nxt):
                _fold_pair(mod, nxt)
                i += 2
            else:
                i += 1
            keep.append(mod)
        container._modules.clear()
        for m in keep:
            container.add(m)

    walk(new_model)
    return new_model.evaluate()
