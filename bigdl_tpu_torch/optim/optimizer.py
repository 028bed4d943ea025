"""Gradient accumulation (≙ ``make_accum_grads`` of
``bigdl_tpu/optim/optimizer.py``).

The reference's step is functional: ``jax.value_and_grad`` of a loss of
the params.  Here the gradients come from ``torch.autograd.grad`` over
the leaves of the param dict, so nothing is left in ``.grad`` and the
returned gradients have the param dict's structure.  The ``Optimizer`` /
``LocalOptimizer`` host loop of that module is ROADMAP queue A, item 3.
"""
from __future__ import annotations

import torch

from ..kernels.fused_optim import zip_leaves


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return next(it)
    return build(like)


def _value_and_grad(loss_fn, params, model_state, x, y):
    """((loss, new_state), grads as a flat list in leaf order)"""
    loss, new_state = loss_fn(params, model_state, x, y)
    leaves = [p for (p,) in zip_leaves(params)]
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), new_state), list(grads)


def make_accum_grads(loss_fn, n_accum: int, weight_fn=None):
    """Microbatch gradient accumulation.

    ``loss_fn(params, model_state, x, y) -> (loss, new_state)``.  Returns
    ``grads_fn(params, model_state, x, y) -> ((mean_loss, merged_state),
    mean_grads)`` that runs ``n_accum`` microbatches in order (model state
    threaded from one to the next); ``n_accum < 2`` is one value-and-grad.

    Microbatch ``i`` takes rows ``{j * n_accum + i}`` of ``x`` and ``y``,
    the reference's strided split.  ``weight_fn(x, y) -> scalar`` weights
    each microbatch's loss and gradients (the result is divided by the
    total weight): needed when ``loss_fn`` is a masked mean, as a token
    cross-entropy with padding is.  Default: equal weights.  The
    accumulators are fp32.
    """
    if n_accum < 2:
        def direct(params, model_state, x, y):
            aux, grads = _value_and_grad(loss_fn, params, model_state, x, y)
            return aux, _unflatten(params, grads)
        return direct

    def split(a):
        b = a.shape[0]
        if b % n_accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_accum={n_accum}")
        return a.reshape((b // n_accum, n_accum) + tuple(a.shape[1:])) \
            .movedim(1, 0)

    def grads_fn(params, model_state, x, y):
        xs, ys = split(x), split(y)
        leaves = [p for (p,) in zip_leaves(params)]
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        dev = leaves[0].device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        w_acc = torch.zeros((), dtype=torch.float32, device=dev)
        state = dict(model_state)
        for xi, yi in zip(xs, ys):
            w = (torch.ones((), dtype=torch.float32, device=dev)
                 if weight_fn is None
                 else weight_fn(xi, yi).to(torch.float32))
            (loss, upd), grads = _value_and_grad(loss_fn, params, state,
                                                 xi, yi)
            state = {**state, **upd}
            g_acc = [a + w * g for a, g in zip(g_acc, grads)]
            loss_acc = loss_acc + w * loss
            w_acc = w_acc + w
        w_acc = torch.clamp(w_acc, min=1e-8)
        grads = _unflatten(params, [g / w_acc for g in g_acc])
        return (loss_acc / w_acc, state), grads

    return grads_fn
