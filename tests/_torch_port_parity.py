"""Helpers the nn-shell parity tests share (``tests/test_torch_port_
{nn_shell,dropout,vgg,resnet_variants}.py``): one module or model run
through the reference (``jax.vjp``) and through the port (autograd) on
the same weights, inputs, output gradients and random draws.

The reference's draws are ``jax.random`` streams, which torch cannot
reproduce, so they cross as data: :func:`ref_dropout_draws` computes each
reference ``Dropout``'s keep mask as the reference draws it
(``bernoulli(fold_in(key, uid % 2**31), keep, shape)``) and keys it by the
name of the port's module at the same position; the port takes them
through ``Ctx.draws``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import Module as JModule
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.kernels.fused_optim import zip_leaves
from bigdl_tpu_torch.models.convert import from_jax_weights


def rand(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def ref_weight_order(tree, jm):
    """``tree`` ({module: {key: leaf}}) in the reference's get_weights
    order."""
    return [np.asarray(tree[m.name][k]) for m in jm.modules()
            if tree.get(m.name) for k in JModule._weights_order(tree[m.name])]


def ref_state_list(jm, state):
    return [np.asarray(state[m.name][k]) for m in jm.modules()
            if m.name in state for k in sorted(state[m.name])]


def cross(jm, tm, seed=0):
    """Initialize the reference from ``seed`` and load its weights and
    state into the port; returns the reference's (params, state)."""
    params, state = jm.init_params(seed)
    jm.set_params(params, state)
    from_jax_weights(jm.get_weights(), tm, ref_state_list(jm, state))
    return params, state


def ref_run(jm, params, x, dy, state=None, training=False, rng=None):
    """(y, grads in get_weights order, dx, new_state) of the reference."""
    def f(p, xx):
        ctx = jnn.Ctx(state=state, training=training, rng_key=rng)
        return jm.apply(p, xx, ctx), ctx.new_state
    y, vjp, new_state = jax.vjp(f, params, jnp.asarray(x), has_aux=True)
    gp, gx = vjp(jnp.asarray(dy))
    return (np.asarray(y), ref_weight_order(gp, jm), np.asarray(gx),
            new_state)


def port_run(tm, x, dy, state=None, training=False, draws=None,
             generator=None):
    """(y, grads in get_weights order, dx, new_state) of the port."""
    params = tm.param_dict()
    leaves = [p for (p,) in zip_leaves(params)]
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
    ctx = tnn.Ctx(state=state, training=training, draws=draws,
                  generator=generator)
    y = tm.apply(params, xt, ctx)
    # an input read as indices (LookupTable) has a zero gradient, as the
    # reference's cast to int32 gives
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        [xt] + leaves, torch.autograd.grad(y, [xt] + leaves,
                                           torch.from_numpy(dy),
                                           allow_unused=True))]
    order = {id(p): i for i, p in enumerate(leaves)}
    by_leaf = grads[1:]
    ordered = [by_leaf[order[id(w)]].numpy() for w in _own_weights(tm)]
    return y.detach().numpy(), ordered, grads[0].numpy(), ctx.new_state


def _own_weights(tm):
    """The port's parameters in get_weights order (not detached)."""
    return [t for _, t in _named_own_weights(tm)]


def _named_own_weights(tm):
    from bigdl_tpu_torch.nn.module import _weights_order
    out = []
    for m in tm._ref_modules():
        own = dict(m.named_parameters(recurse=False))
        out.extend((f"{m.name}/{k}", own[k]) for k in _weights_order(own))
    return out


def assert_grads(got, want, rel, names=None):
    """Per leaf: max |Δg| ≤ rel · max |g|.  ``names`` (one per leaf) go
    into the failure message."""
    assert [g.shape for g in got] == [g.shape for g in want]
    for i, (a, b) in enumerate(zip(got, want)):
        err = float(np.abs(a - b).max()) if a.size else 0.0
        scale = float(np.abs(b).max()) if b.size else 0.0
        what = names[i] if names is not None else i
        assert err <= rel * scale or err == 0.0, (
            f"{what}: max |dg| {err:.3e} > band {rel * scale:.3e} "
            f"({rel} x max |g| {scale:.3e})")


def assert_close(got, want, where, rtol, atol):
    """``np.testing.assert_allclose`` whose message names ``where`` and
    the worst element: its error against its band ``atol + rtol·|want|``."""
    got, want = np.asarray(got), np.asarray(want)
    msg = where
    if got.shape == want.shape and got.size:
        err = np.abs(got.astype(np.float64) - want)
        band = atol + rtol * np.abs(want.astype(np.float64))
        k = int(np.nanargmax(np.where(np.isnan(err), np.inf, err - band)))
        msg = (f"{where}: worst |d| {err.flat[k]:.3e} against its band "
               f"{band.flat[k]:.3e} (rtol {rtol}, atol {atol}) at "
               f"{tuple(int(i) for i in np.unravel_index(k, got.shape))}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def _dropout_inputs(jm, params, state, x):
    """``[(reference Dropout, its input shape)]`` in forward order, from
    an inference walk of nested ``Sequential`` s."""
    found = []

    def walk(m, a):
        if isinstance(m, jnn.Sequential):
            for c in m.children():
                a = walk(c, a)
            return a
        if isinstance(m, jnn.Dropout):
            found.append((m, tuple(a.shape)))
        return m.apply(params, a, jnn.Ctx(state=state, training=False))

    walk(jm, jnp.asarray(x))
    return found


def ref_dropout_draws(jm, tm, params, state, x, key):
    """The reference's keep masks for its ``Dropout`` s on input ``x``
    under ``key``, keyed by the names of the port's ``Dropout`` s at the
    same positions."""
    ref = _dropout_inputs(jm, params, state, x)
    ours = [m for m in tm.modules() if isinstance(m, tnn.Dropout)]
    assert len(ours) == len(ref)
    return {t.name: np.array(jax.random.bernoulli(
        jax.random.fold_in(key, m._uid % (2 ** 31)), 1.0 - m.p, shape))
        for t, (m, shape) in zip(ours, ref)}


def flat_layers(jm, tm):
    """Pairs of (reference, port) leaf modules in forward order, through
    nested ``Sequential`` s."""
    out = []
    for jc, tc in zip(jm.children(), tm.children()):
        if isinstance(jc, jnn.Sequential):
            out.extend(flat_layers(jc, tc))
        else:
            out.append((jc, tc))
    return out


def layer_walk(jm, tm, params, state, x, training, key=None, draws=None,
               tol=None, grad_rel=1e-4):
    """Teacher-forced walk of a ``Sequential`` model: each layer of both
    packages takes the reference's activation (and the same draws), and
    its output, input gradient, weight gradients (for a random output
    gradient) and new state are compared.  Returns the number of layers
    that drew a mask."""
    tol = tol or dict(rtol=2e-5, atol=2e-5)
    tparams, tstate = tm.param_dict(), tm.initial_state()
    a = np.asarray(x)
    drew = 0
    for i, (jc, tc) in enumerate(flat_layers(jm, tm)):
        shape = jax.eval_shape(lambda xx: jc.run(
            params, xx, state=state, training=training, rng=key)[0],
            jnp.asarray(a)).shape
        dy = rand(100 + i, shape)
        yjj, gj, gxj, sj = ref_run(jc, params, a, dy, state, training, key)
        yt, gt, gxt, st = port_run(tc, a, dy, tstate, training, draws=draws)
        where = f"layer {i} ({type(tc).__name__} {tc.name})"
        assert_close(yt, yjj, f"{where} output", **tol)
        assert_grads([gxt] + gt, [gxj] + gj, grad_rel,
                     names=[f"{where} input gradient"]
                     + [f"{where} weight gradient {n}"
                        for n, _ in _named_own_weights(tc)])
        assert len(st) == len(sj) == (tc.name in tstate and training)
        for (tn, tsub), (jn, jsub) in zip(st.items(), sj.items()):
            for k in tsub:
                assert_close(tsub[k].numpy(), np.asarray(jsub[k]),
                             f"{where} state {k}", **tol)
        drew += bool(training and isinstance(tc, tnn.Dropout))
        a = np.array(yjj)
    return drew
