"""The rest of the port's ``nn`` shell held against the reference on the
CPU: the Torch shell of ``Module``/``Criterion``, ``Ctx``'s draws and side
losses, the containers (``Remat`` included), ``Graph``, the shape ops, the elementwise layers,
``CrossEntropyCriterion`` and ``fold_batchnorm``.

Each case builds the module in ``bigdl_tpu`` and in ``bigdl_tpu_torch``,
loads the reference's weights into the port by position, and compares on
the same numpy inputs.  Tolerances: fp32 outputs and losses within 2e-5;
gradients per leaf within max |Δg| ≤ 1e-4 · max |g|; what involves no
reduction (shape ops, masks, ``Remat`` against the unwrapped model) is
compared bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import lenet as JL
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.optim import Top1Accuracy

from _torch_port_parity import (assert_grads, cross, port_run, rand,
                                ref_run, ref_state_list, ref_weight_order)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 1e-4


def _pair(jm, tm, x, training=False, seed=0):
    """Forward, input gradient and weight gradients of both."""
    params, state = cross(jm, tm, seed)
    y = jm.run(params, jnp.asarray(x) if not isinstance(x, list)
               else [jnp.asarray(a) for a in x], state=state,
               training=training)[0]
    dy = rand(seed + 1, np.shape(y))
    yj, gj, gxj, _ = ref_run(jm, params, x, dy, state, training)
    yt, gt, gxt, _ = port_run(tm, x, dy, tm.initial_state(), training)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(gxt, gxj, **TOL)
    assert_grads(gt, gj, GRAD_REL)
    return yt


# --------------------------------------------------------------------- #
# the Torch shell                                                       #
# --------------------------------------------------------------------- #
def _shell_models():
    def build(nn):
        # no bias before the BN: its gradient is 0 up to rounding
        return nn.Sequential(nn.Linear(5, 8, with_bias=False),
                             nn.BatchNormalization(8), nn.Tanh(),
                             nn.Linear(8, 3), nn.LogSoftMax())
    jm, tm = build(jnn), build(tnn)
    params, state = jm.init_params(0)
    jm.set_params(params, state)
    from_jax_weights(jm.get_weights(), tm, ref_state_list(jm, state))
    return jm, tm


def test_torch_shell_loop_matches_the_reference_over_three_steps():
    """forward / Criterion.backward / backward / update_parameters /
    zero_grad_parameters, in training mode; step 2 accumulates two
    backwards before its update."""
    jm, tm = _shell_models()
    jc, tc = jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion()
    jm.training()
    tm.train()
    assert jm.is_training() and tm.is_training()
    rng = np.random.RandomState(3)
    batches = [(rng.randn(6, 5).astype(np.float32),
                (rng.randint(0, 3, 6) + 1).astype(np.float32))
               for _ in range(4)]
    plan = [[0], [1, 2], [3]]
    for step in plan:
        for i in step:
            x, y = batches[i]
            oj, ot = jm.forward(jnp.asarray(x)), tm(torch.from_numpy(x))
            np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                                       **TOL)
            lj = jc.forward(oj, jnp.asarray(y))
            lt = tc(ot, torch.from_numpy(y))
            np.testing.assert_allclose(float(lt.detach()), float(lj), **TOL)
            gj = jc.backward(oj, jnp.asarray(y))
            gt = tc.backward(ot, torch.from_numpy(y))
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
            dxj = jm.backward(jnp.asarray(x), gj)
            dxt = tm.backward(torch.from_numpy(x), gt)
            np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), **TOL)
        pj, gpj = jm.get_parameters()
        pt, gpt = tm.get_parameters()
        assert_grads([g.numpy() for g in _flat(gpt, tm)],
                     ref_weight_order(gpj, jm), GRAD_REL)
        jm.update_parameters(0.1)
        tm.update_parameters(0.1)
        jm.zero_grad_parameters()
        tm.zero_grad_parameters()
        assert tm.grad_params is None
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for a, b in zip(tm.state_list(), ref_state_list(jm, jm._state)):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    # eval mode: the running statistics, no state written
    jm.evaluate()
    tm.evaluate()
    assert not tm.is_training()
    before = [s.clone() for s in tm.state_list()]
    x = batches[0][0]
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.forward(jnp.asarray(x))), **TOL)
    assert all(torch.equal(a, b) for a, b in zip(before, tm.state_list()))


def _flat(tree, tm):
    from bigdl_tpu_torch.nn.module import _weights_order
    return [tree[m.name][k] for m in tm._ref_modules()
            if m.name in tree for k in _weights_order(tree[m.name])]


def test_frozen_modules_are_skipped_by_update_parameters():
    _, tm = _shell_models()
    first = tm[0]
    tm.freeze([first.name])
    before = [w.clone() for w in tm.get_weights()]
    tm.train()
    x = torch.from_numpy(rand(0, (4, 5)))
    out = tm(x)
    tm.backward(x, torch.ones_like(out))
    tm.update_parameters(0.5)
    after = tm.get_weights()
    assert torch.equal(after[0], before[0])
    assert all(not torch.equal(a, b) for a, b in zip(after[1:], before[1:]))


def test_torch_module_api_after_train_and_evaluate():
    """train()/evaluate() leave torch's own machinery working: the bool
    ``training`` on every submodule, .to(), state_dict(), parameters() and
    a torch optimizer; evaluate(dataset, batch, methods) is Evaluator's."""
    _, tm = _shell_models()
    assert not tm.training                  # the reference's default
    tm.train()
    assert all(m.training is True for m in tm.modules())
    tm.evaluate()
    assert all(m.training is False for m in tm.modules())
    tm.to("cpu")
    sd = tm.state_dict()
    assert {k.split(".")[-1] for k in sd} == {"weight", "bias",
                                             "running_mean", "running_var"}
    opt = torch.optim.SGD(tm.parameters(), lr=0.1)
    tm.train()
    x = torch.from_numpy(rand(1, (4, 5)))
    before = [p.detach().clone() for p in tm.parameters()]
    tm(x).sum().backward()
    opt.step()
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                      tm.parameters()))
    tm.load_state_dict(sd)
    tm.evaluate()
    rng = np.random.RandomState(2)
    xs = rng.randn(10, 5).astype(np.float32)
    ys = (rng.randint(0, 3, 10) + 1).astype(np.float32)
    (method, res), = tm.evaluate((xs, ys), 4, [Top1Accuracy()])
    want = (np.argmax(tm(torch.from_numpy(xs)).detach().numpy(), 1) + 1
            == ys).sum()
    assert res.correct == want and res.count == 10


def test_backward_replays_the_forward_draws_and_accumulates():
    tm = tnn.Sequential(tnn.Linear(4, 6), tnn.Dropout(0.5), tnn.Linear(6, 2))
    tm.train()
    x = torch.from_numpy(rand(0, (3, 4)))
    g = torch.Generator().manual_seed(5)
    y1 = tm(x, generator=g)
    tm.backward(x, torch.ones_like(y1))
    assert torch.equal(tm.output, y1.detach())   # the same mask
    g1 = {k: v.clone() for k, v in tm.grad_params[tm[0].name].items()}
    tm.backward(x, torch.ones_like(y1))
    for k, v in tm.grad_params[tm[0].name].items():
        torch.testing.assert_close(v, 2 * g1[k], rtol=0, atol=0)
    y2 = tm(x)                                   # the module's own draws
    y3 = tm(x)
    assert not torch.equal(y2, y3)
    tm.zero_grad_parameters()
    params, grads = tm.get_parameters()
    assert all(torch.count_nonzero(t) == 0 for sub in grads.values()
               for t in sub.values())


def test_ctx_side_losses_reach_the_training_loss():
    from bigdl_tpu_torch.optim.optimizer import make_loss_fn
    tm = tnn.Sequential(tnn.Linear(3, 4), tnn.ActivityRegularization(l1=0.5),
                        tnn.LogSoftMax())
    x = torch.from_numpy(rand(0, (2, 3)))
    y = torch.tensor([1.0, 2.0])
    loss, _ = make_loss_fn(tm, tnn.ClassNLLCriterion())(tm.param_dict(), {},
                                                         x, y)
    h = tm[0].apply(tm.param_dict(), x, tnn.Ctx())
    plain = tnn.ClassNLLCriterion().loss(torch.log_softmax(h, -1), y)
    torch.testing.assert_close(loss, plain + 0.5 * h.abs().sum())


# --------------------------------------------------------------------- #
# containers                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["Concat", "ParallelTable", "MapTable",
                                  "Bottle", "Echo"])
def test_containers(case, capsys):
    if case == "Concat":
        def build(nn):
            return nn.Concat(2, nn.Linear(4, 3), nn.Linear(4, 5))
        x = rand(0, (2, 4))
    elif case == "Bottle":
        def build(nn):
            return nn.Bottle(nn.Linear(4, 3), 2)
        x = rand(0, (2, 5, 4))
    elif case == "Echo":
        def build(nn):
            return nn.Sequential(nn.Linear(4, 3), nn.Echo())
        x = rand(0, (2, 4))
    else:
        jm = (jnn.ParallelTable(jnn.Linear(4, 3), jnn.Linear(2, 3))
              if case == "ParallelTable" else jnn.MapTable(jnn.Linear(4, 3)))
        tm = (tnn.ParallelTable(tnn.Linear(4, 3), tnn.Linear(2, 3))
              if case == "ParallelTable" else tnn.MapTable(tnn.Linear(4, 3)))
        xs = [rand(0, (2, 4)), rand(1, (2, 2 if case == "ParallelTable"
                                        else 4))]
        params, state = cross(jm, tm)
        yj = jm.run(params, [jnp.asarray(a) for a in xs])[0]
        yt = tm.run(tm.param_dict(), [torch.from_numpy(a) for a in xs])[0]
        assert len(yt) == 2
        for a, b in zip(yt, yj.to_list()):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TOL)
        return
    _pair(build(jnn), build(tnn), x)
    if case == "Echo":
        assert "shape=(2, 3)" in capsys.readouterr().out


def _remat_block(wrap, sync=False):
    torch.manual_seed(0)
    inner = tnn.Sequential(tnn.Linear(6, 8), tnn.Dropout(0.5),
                           tnn.BatchNormalization(8), tnn.ReLU(),
                           tnn.Linear(8, 8))
    m = tnn.Sequential(tnn.Linear(5, 6), tnn.Remat(inner) if wrap
                       else inner, tnn.Linear(8, 3), tnn.LogSoftMax())
    return m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_is_bitwise_the_unwrapped_block(dtype):
    """Loss, gradients, running statistics and the generator's advance:
    the recompute must draw the forward's mask again (an explicit
    generator, which preserve_rng_state does not restore) and write no
    state."""
    x = torch.from_numpy(rand(0, (16, 5))).to(getattr(torch, dtype))
    y = torch.from_numpy((np.arange(16) % 3 + 1).astype(np.float32))
    outs = []
    for wrap in (False, True):
        m = _remat_block(wrap)
        g = torch.Generator().manual_seed(3)
        params = m.param_dict()
        leaves = [p for sub in params.values() for p in sub.values()]
        ctx = tnn.Ctx(state=m.initial_state(), training=True, generator=g)
        out = m.apply(params, x, ctx)
        loss = tnn.ClassNLLCriterion().loss(out.float(), y)
        grads = torch.autograd.grad(loss, leaves)
        state = [t for sub in ctx.new_state.values() for t in sub.values()]
        outs.append((loss, grads, state, torch.rand(3, generator=g)))
    (l0, g0, s0, r0), (l1, g1, s1, r1) = outs
    assert torch.equal(l0, l1)
    assert len(s0) == len(s1) == 2
    assert all(torch.equal(a, b) for a, b in zip(g0 + tuple(s0),
                                                 g1 + tuple(s1)))
    assert torch.equal(r0, r1)
    assert any(torch.count_nonzero(g) for g in g1)


def test_remat_with_the_default_generator_would_redraw():
    """The trap the wrapper guards: a checkpoint whose recompute draws
    anew from the explicit generator gives other gradients."""
    from torch.utils.checkpoint import checkpoint
    lin = tnn.Linear(6, 6)
    drop = tnn.Dropout(0.5)
    x = torch.from_numpy(rand(1, (8, 6))).requires_grad_()

    def run(naive):
        g = torch.Generator().manual_seed(1)
        params = lin.param_dict()

        def block(a):
            ctx = tnn.Ctx(training=True, generator=g)
            return drop.apply(params, lin.apply(params, a, ctx), ctx)
        if naive:
            y = checkpoint(block, x, use_reentrant=False)
        else:
            y = tnn.Remat(tnn.Sequential(lin, drop)).apply(
                params, x, tnn.Ctx(training=True, generator=g))
        return torch.autograd.grad(y.sum(), x)[0]

    ref = torch.autograd.grad(
        drop.apply(lin.param_dict(), lin.apply(lin.param_dict(), x, None),
                   tnn.Ctx(training=True, generator=torch.Generator()
                           .manual_seed(1))).sum(), x)[0]
    assert torch.equal(run(False), ref)
    assert not torch.equal(run(True), ref)


# --------------------------------------------------------------------- #
# Graph                                                                 #
# --------------------------------------------------------------------- #
def _two_in_two_out(nn):
    a, b = nn.Input(), nn.Input()
    h1 = nn.Linear(4, 6).inputs(a)
    h2 = nn.Linear(3, 6).inputs(b)
    s = nn.CAddTable().inputs(h1, h2)
    t = nn.Tanh().inputs(s)
    o1 = nn.Linear(6, 2).inputs(t)
    o2 = nn.Linear(6, 5).inputs([t, ])
    return nn.Graph([a, b], [o1, o2])


def test_graph_multi_input_output_and_child_order():
    jm, tm = _two_in_two_out(jnn), _two_in_two_out(tnn)
    assert [type(m).__name__ for m in tm.children()] == \
        [type(m).__name__ for m in jm.children()]
    params, _ = cross(jm, tm)
    xs = [rand(0, (2, 4)), rand(1, (2, 3))]
    yj = jm.run(params, [jnp.asarray(a) for a in xs])[0].to_list()
    xt = [torch.from_numpy(a).requires_grad_() for a in xs]
    yt = tm.run(tm.param_dict(), xt)[0]
    for a, b in zip(yt, yj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    assert tnn.StaticGraph is tnn.Graph and tnn.Model is tnn.Graph
    assert tnn.DynamicGraph is tnn.Graph
    first = next(tm.children())
    assert tm.node(first.name).module is first


def test_graph_rejects_a_cycle():
    a = tnn.Input()
    n = tnn.Linear(2, 2).inputs(a)
    n.prev_nodes.append(n)
    with pytest.raises(ValueError, match="cycle"):
        tnn.Graph(a, n)


def test_lenet_build_graph_against_the_reference():
    jm, tm = JL.build_graph(10), TL.build_graph(10, device="cpu")
    _pair(jm, tm, rand(0, (3, 784)))
    seq = TL.build(10, device="cpu", seed=4)
    graph = TL.build_graph(10, device="cpu", seed=4)
    assert all(torch.equal(a, b) for a, b in zip(seq.get_weights(),
                                                 graph.get_weights()))


def _diamond(nn):
    """Two branches off one input, joined, then a skip from the input: the
    depth-first order from the output visits the left branch first."""
    a = nn.Input()
    left = nn.Tanh().inputs(nn.Linear(4, 5).inputs(a))
    right = nn.Linear(4, 5).inputs(a)
    s = nn.CAddTable().inputs(left, right)
    skip = nn.Linear(4, 5).inputs(a)
    return nn.Graph(a, nn.Tanh().inputs(nn.CAddTable().inputs(s, skip)))


def _fan_in(nn):
    """Three inputs whose branches meet in the reverse of their order."""
    xs = [nn.Input() for _ in range(3)]
    hs = [nn.Linear(3, 4).inputs(x) for x in xs]
    return nn.Graph(xs, nn.Linear(4, 2).inputs(
        nn.CAddTable().inputs(*hs[::-1])))


@pytest.mark.parametrize("build,n_in", [(_diamond, 1), (_fan_in, 3)])
def test_graph_children_follow_the_reference_order(build, n_in):
    """The port registers the nodes' modules in the reference's
    topological order, so weights cross by position: same child types in
    the same order, then outputs and gradients against the reference."""
    jm, tm = build(jnn), build(tnn)
    assert [type(m).__name__ for m in tm.children()] == \
        [type(m).__name__ for m in jm.children()]
    if n_in == 1:
        _pair(jm, tm, rand(0, (2, 4)))
        return
    params, _ = cross(jm, tm)
    xs = [rand(i, (2, 3)) for i in range(n_in)]
    yj = jm.run(params, [jnp.asarray(a) for a in xs])[0]
    yt = tm.run(tm.param_dict(), [torch.from_numpy(a) for a in xs])[0]
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)


# --------------------------------------------------------------------- #
# shape ops and chained setters                                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", [
    # (dim, pad, n_input_dim, shape): below the rank pads after the batch
    # dim; equal to the rank pads the dim itself (ROADMAP C6's semantics)
    (1, 2, 3, (2, 3, 4, 5)), (2, -1, 3, (2, 3, 4, 5)), (1, 2, 4, (2, 3, 4, 5)),
    (3, 1, 4, (2, 3, 4, 5)), (2, -2, 2, (3, 4))])
def test_padding_keeps_the_reference_semantics(case):
    dim, pad, nid, shape = case
    jm, tm = jnn.Padding(dim, pad, nid, value=0.5), \
        tnn.Padding(dim, pad, nid, value=0.5)
    x = rand(0, shape)
    yj = np.asarray(jm.run({}, jnp.asarray(x))[0])
    yt = tm.run({}, torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(yt, yj)
    assert yt.shape != x.shape


@pytest.mark.parametrize("pads,fmt", [((1, 2, 0, 3), "NCHW"),
                                      ((2,), "NHWC"),
                                      ((-1, 2, 1, -2), "NCHW"),
                                      ((1, -1, -1, 0), "NHWC")])
def test_spatial_zero_padding(pads, fmt):
    jm = jnn.SpatialZeroPadding(*pads, format=fmt)
    tm = tnn.SpatialZeroPadding(*pads, format=fmt)
    x = rand(0, (2, 3, 5, 6))
    np.testing.assert_array_equal(tm.run({}, torch.from_numpy(x))[0].numpy(),
                                  np.asarray(jm.run({}, jnp.asarray(x))[0]))


@pytest.mark.parametrize("perms", [[(1, 3)], [(1, 3), (2, 3)], [(-1, 1)]])
def test_transpose(perms):
    x = rand(0, (2, 3, 4, 5))
    _pair(jnn.Transpose(perms), tnn.Transpose(perms), x)


def test_chained_setters():
    pool = tnn.SpatialMaxPooling(2, 2, 2, 2)
    assert pool.ceil() is pool and pool.ceil_mode
    assert pool.floor() is pool and not pool.ceil_mode
    avg = tnn.SpatialAveragePooling(3, 3, 2, 2)
    assert avg.ceil() is avg and avg.ceil_mode
    v = tnn.View(12)
    assert v.set_num_input_dims(3) is v and v.num_input_dims == 3
    lin = tnn.Linear(4, 3)
    assert lin.set_init_method(tnn.Ones(), tnn.Zeros()) is lin
    assert torch.equal(lin.weight, torch.ones(3, 4))
    assert torch.equal(lin.bias, torch.zeros(3))
    conv = tnn.SpatialConvolution(2, 3, 3, 3)
    torch.manual_seed(0)
    conv.set_init_method(tnn.RandomNormal(0.0, 2.0))
    again = torch.randn((3, 2, 3, 3),
                        generator=torch.Generator().manual_seed(0)) * 2.0
    torch.testing.assert_close(conv.weight.detach(), again)


# --------------------------------------------------------------------- #
# elementwise                                                           #
# --------------------------------------------------------------------- #
ELEMENTWISE = {
    "Abs": lambda nn: nn.Abs(), "AddConstant": lambda nn: nn.AddConstant(1.5),
    "MulConstant": lambda nn: nn.MulConstant(-0.5),
    "Exp": lambda nn: nn.Exp(), "Log": lambda nn: nn.Log(),
    "Log1p": lambda nn: nn.Log1p(), "Sqrt": lambda nn: nn.Sqrt(),
    "Square": lambda nn: nn.Square(),
    "Power": lambda nn: nn.Power(2.5, 0.5, 3.0),
    "Highway": lambda nn: nn.Highway(5), "Scale": lambda nn: nn.Scale((5,)),
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise(name):
    x = rand(0, (3, 5))
    if name in ("Log", "Sqrt", "Log1p"):
        x = np.abs(x) + 0.1
    _pair(ELEMENTWISE[name](jnn), ELEMENTWISE[name](tnn), x)


def test_abs_and_l1_gradient_at_zero_is_the_references():
    x = np.array([[-1.0, 0.0, 2.0, -0.0]], np.float32)
    dy = np.ones_like(x)
    _, _, gj, _ = ref_run(jnn.Abs(), {}, x, dy)
    _, _, gt, _ = port_run(tnn.Abs(), x, dy)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(gt, [[-1.0, 1.0, 1.0, 1.0]])
    xt = torch.from_numpy(x).requires_grad_()
    ctx = tnn.Ctx()
    tnn.L1Penalty(0.3).apply({}, xt, ctx)
    g, = torch.autograd.grad(ctx.side_losses[0], xt)
    jg = jax.grad(lambda a: _ref_side(jnn.L1Penalty(0.3), a))(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def _ref_side(jm, x):
    ctx = jnn.Ctx()
    jm.apply({}, x, ctx)
    return sum(ctx.side_losses)


@pytest.mark.parametrize("name", ["L1Penalty", "L1Penalty avg",
                                  "ActivityRegularization",
                                  "NegativeEntropyPenalty"])
def test_side_loss_layers(name):
    build = {"L1Penalty": lambda nn: nn.L1Penalty(0.2),
             "L1Penalty avg": lambda nn: nn.L1Penalty(0.2, size_average=True),
             "ActivityRegularization":
                 lambda nn: nn.ActivityRegularization(0.1, 0.3),
             "NegativeEntropyPenalty":
                 lambda nn: nn.NegativeEntropyPenalty(0.05)}[name]
    x = np.abs(rand(0, (3, 4))) / 4
    xt = torch.from_numpy(x).requires_grad_()
    ctx = tnn.Ctx()
    y = build(tnn).apply({}, xt, ctx)
    assert y is xt and len(ctx.side_losses) == 1
    jval, jg = jax.value_and_grad(lambda a: _ref_side(build(jnn), a))(
        jnp.asarray(x))
    g, = torch.autograd.grad(ctx.side_losses[0], xt)
    np.testing.assert_allclose(float(ctx.side_losses[0]), float(jval), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


# --------------------------------------------------------------------- #
# CrossEntropyCriterion                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [{}, dict(size_average=False),
                                dict(weights=[0.5, 2.0, 1.0, 0.25]),
                                dict(zero_based_label=True)])
def test_cross_entropy_criterion(kw):
    x = rand(0, (6, 4), 2.0)
    y = np.array([1, 2, 3, 4, 2, 1], np.float32)
    if kw.get("zero_based_label"):
        y = y - 1
    jc, tc = jnn.CrossEntropyCriterion(**kw), tnn.CrossEntropyCriterion(**kw)
    lj = jc.forward(jnp.asarray(x), jnp.asarray(y))
    gj = jc.backward(jnp.asarray(x), jnp.asarray(y))
    lt = tc.forward(torch.from_numpy(x), torch.from_numpy(y))
    gt = tc.backward(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
    assert tc.output is lt and tc.grad_input is gt


# --------------------------------------------------------------------- #
# fold_batchnorm                                                        #
# --------------------------------------------------------------------- #
def _trained_state(jm, tm, x):
    """One training forward in both, so the running statistics are not
    the initial ones."""
    params, state = cross(jm, tm)
    _, st = jm.run(params, jnp.asarray(x), state=state, training=True)
    jm.set_params(params, st)
    tm.set_state(tm.run(tm.param_dict(), torch.from_numpy(x),
                        state=tm.initial_state(), training=True)[1])
    return params, st


@pytest.mark.parametrize("kind", ["sequential", "graph"])
def test_fold_batchnorm_against_the_reference(kind):
    def build(nn):
        if kind == "graph":
            i = nn.Input()
            c = nn.SpatialConvolution(3, 4, 3, 3, with_bias=False).inputs(i)
            b = nn.SpatialBatchNormalization(4).inputs(c)
            r = nn.ReLU().inputs(b)
            v = nn.View(4 * 4 * 4).inputs(r)
            ln = nn.Linear(64, 5).inputs(v)
            bn = nn.BatchNormalization(5).inputs(ln)
            return nn.Graph(i, bn)
        return nn.Sequential(
            nn.SpatialConvolution(3, 4, 3, 3, with_bias=False),
            nn.SpatialBatchNormalization(4), nn.ReLU(), nn.View(4 * 4 * 4),
            nn.Sequential(nn.Linear(64, 5), nn.BatchNormalization(5)))
    jm, tm = build(jnn), build(tnn)
    x = rand(0, (4, 3, 6, 6))
    _trained_state(jm, tm, x)
    jf, tf = jnn.fold_batchnorm(jm), tnn.fold_batchnorm(tm)
    assert _n_bn(tf) == 0 and _n_bn(tm) == 2 and not tf.training
    yj = jf.run(jf._params, jnp.asarray(x), state=jf._state)[0]
    yt = tf(torch.from_numpy(x))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(yt.detach().numpy(),
                               tm.evaluate()(torch.from_numpy(x)).detach()
                               .numpy(), **TOL)


def _n_bn(m):
    return sum(isinstance(c, tnn.BatchNormalization) for c in m.modules())


def test_fold_batchnorm_leaves_shared_layers_alone():
    """A conv and BN used at two sites share their weights: folding them
    once would change the other site, so neither is folded (the
    reference's guard, ``fusion.py:99-110``)."""
    conv = tnn.SpatialConvolution(3, 3, 1, 1, with_bias=False)
    bn = tnn.SpatialBatchNormalization(3)
    tm = tnn.Sequential(conv, bn, tnn.ReLU(), conv, bn,
                        tnn.SpatialConvolution(3, 2, 1, 1),
                        tnn.SpatialBatchNormalization(2))
    x = torch.from_numpy(rand(0, (4, 3, 5, 5)))
    tm.set_state(tm.run(tm.param_dict(), x, state=tm.initial_state(),
                        training=True)[1])
    tf = tnn.fold_batchnorm(tm)
    assert _n_bn(tf) == 1 and len(tf) == 6
    torch.testing.assert_close(tf(x), tm.evaluate()(x), rtol=2e-5,
                               atol=2e-5)
