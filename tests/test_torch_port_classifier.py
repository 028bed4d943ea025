"""The port's image-classifier slice held against the reference on the CPU.

Each layer of the slice is built in ``bigdl_tpu`` and in
``bigdl_tpu_torch``; the reference's weights go to the port by position
(``set_weights`` / ``models.convert.from_jax_weights``), the inputs and
output gradients come from a numpy seed, and the forward, the input
gradient and every weight gradient are compared (the reference through
``jax.vjp``, the port through autograd).  Then a ResNet-50's structure, a
bottleneck stage, a CIFAR ResNet-8 end to end, and three
``LocalOptimizer`` steps on LeNet-5 and ResNet-8 against the reference's
``LocalOptimizer``.

Tolerances: both sides compute in fp32, XLA-CPU and ATen-CPU sum convs,
matmuls and reductions in other orders.  Outputs and gradients of unit
scale agree to ~1e-6; the limits below are ~10x the readings.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import lenet as JL
from bigdl_tpu.models import resnet as JR
from bigdl_tpu.nn.module import Module as JModule
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.kernels.fused_optim import zip_leaves
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# a whole model: each gradient within 1e-4 of its leaf's largest entry
MODEL_GRAD_REL = 1e-4


def _rand(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ref_weight_order(tree):
    """The reference's get_weights order over a {module: {key: leaf}} tree."""
    return lambda jm: [tree[m.name][k] for m in jm.modules()
                       if tree.get(m.name)
                       for k in JModule._weights_order(tree[m.name])]


def _ref_state_list(jm, state):
    return [np.asarray(state[m.name][k]) for m in jm.modules()
            if m.name in state for k in sorted(state[m.name])]


def _ref_run(jm, params, x, dy, state=None, training=False):
    """(y, {module: {key: grad}}, dx, new_state) of the reference."""
    def f(p, xx):
        ctx = jnn.Ctx(state=state, training=training)
        return jm.apply(p, xx, ctx), ctx.new_state
    y, vjp, new_state = jax.vjp(f, params, jnp.asarray(x), has_aux=True)
    gp, gx = vjp(jnp.asarray(dy))
    return np.asarray(y), gp, np.asarray(gx), new_state


def _port_run(tm, x, dy, state=None, training=False):
    """(y, grads in get_weights order, dx, new_state) of the port."""
    params = tm.param_dict()
    leaves = [p for (p,) in zip_leaves(params)]
    xt = torch.from_numpy(x).requires_grad_()
    ctx = tnn.Ctx(state=state, training=training)
    y = tm.apply(params, xt, ctx)
    grads = torch.autograd.grad(y, [xt] + leaves, torch.from_numpy(dy))
    return (y.detach().numpy(), [g.numpy() for g in grads[1:]],
            grads[0].numpy(), ctx.new_state)


def _pair(jm, tm, x, seed=0, training=False, grad_rel=None):
    """Load the reference's weights (and state) into the port, run both
    forward and backward on ``x``, compare; returns the new states."""
    params, state = jm.init_params(seed)
    jm.set_params(params, state)
    from_jax_weights(jm.get_weights(), tm, _ref_state_list(jm, state))
    y_ref = jm.run(params, jnp.asarray(x), state=state,
                   training=training)[0]
    dy = _rand(seed + 1, np.shape(y_ref))
    yj, gpj, gxj, sj = _ref_run(jm, params, x, dy, state, training)
    yt, gpt, gxt, st = _port_run(tm, x, dy, tm.initial_state(), training)
    np.testing.assert_allclose(yt, yj, **FWD_TOL)
    ref_grads = [np.asarray(g) for g in _ref_weight_order(gpj)(jm)]
    assert [g.shape for g in gpt] == [g.shape for g in ref_grads]
    for i, (a, b) in enumerate(zip([gxt] + gpt, [gxj] + ref_grads)):
        if grad_rel is None:
            np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"grad {i}")
        else:
            err = np.abs(a - b).max()
            assert err <= grad_rel * np.abs(b).max(), (i, err)
    return sj, st


# --------------------------------------------------------------------- #
# layers                                                                #
# --------------------------------------------------------------------- #
def _image(fmt, b, c, h, w, seed=0):
    x = _rand(seed, (b, c, h, w))
    return x if fmt == "NCHW" else np.ascontiguousarray(
        x.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n_group", [1, 2])
@pytest.mark.parametrize("pad", [-1, 0, 2])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_spatial_convolution(fmt, pad, n_group, stride):
    args = (4, 6, 3, 2, stride, stride, pad, pad, n_group)
    jm = jnn.SpatialConvolution(*args, format=fmt)
    tm = tnn.SpatialConvolution(*args, format=fmt)
    # 9 x 8: SAME pads differ between the dims, and at stride 2 are
    # asymmetric
    _pair(jm, tm, _image(fmt, 2, 4, 9, 8))


def test_convolution_without_bias_and_same_pad_split():
    from bigdl_tpu.nn.conv import _same_pad as ref_same_pad
    from bigdl_tpu_torch.nn.conv import _same_pad
    for size, s, k in [(112, 2, 7), (9, 2, 3), (8, 2, 2), (7, 1, 4)]:
        assert _same_pad(size, s, k) == ref_same_pad(size, s, k)
    jm = jnn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3, with_bias=False,
                                format="NHWC")
    tm = tnn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3, with_bias=False,
                                format="NHWC")
    assert [tuple(w.shape) for w in tm.get_weights()] == [(8, 3, 7, 7)]
    _pair(jm, tm, _image("NHWC", 2, 3, 16, 16))


@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("pad", [0, 1, -1])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_spatial_max_pooling(fmt, pad, ceil_mode):
    args = (3, 3, 2, 2, pad, pad)
    jm = jnn.SpatialMaxPooling(*args, format=fmt, ceil_mode=ceil_mode)
    tm = tnn.SpatialMaxPooling(*args, format=fmt, ceil_mode=ceil_mode)
    _pair(jm, tm, _image(fmt, 2, 3, 8, 7))


def test_max_pooling_the_resnet_stem_pads_asymmetrically():
    from bigdl_tpu_torch.nn.pooling import _pool_pads
    assert _pool_pads(112, 3, 2, 1, False) == (1, 0)
    jm = jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format="NHWC")
    tm = tnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format="NHWC")
    # after a ReLU: many exact zeros, ties in the windows
    x = np.maximum(_image("NHWC", 2, 4, 12, 12), 0)
    _pair(jm, tm, x)


@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("ceil_mode,pad", [(False, 0), (False, 1),
                                           (True, 0), (True, 1)])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_spatial_average_pooling(fmt, ceil_mode, pad, count_include_pad,
                                 divide):
    args = (3, 3, 2, 2, pad, pad)
    kw = dict(ceil_mode=ceil_mode, count_include_pad=count_include_pad,
              divide=divide, format=fmt)
    _pair(jnn.SpatialAveragePooling(*args, **kw),
          tnn.SpatialAveragePooling(*args, **kw), _image(fmt, 2, 3, 8, 7))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_global_average_pooling(fmt):
    kw = dict(global_pooling=True, format=fmt)
    _pair(jnn.SpatialAveragePooling(2, 2, **kw),
          tnn.SpatialAveragePooling(2, 2, **kw), _image(fmt, 2, 5, 4, 6))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("layer", ["spatial NCHW", "spatial NHWC",
                                   "spatial NCHW no affine", "2d"])
def test_batch_normalization(layer, training):
    """Forward, gradients and the running statistics, in training (batch
    statistics, unbiased running variance) and in inference (the running
    statistics the training pass left)."""
    fmt = "NHWC" if "NHWC" in layer else "NCHW"
    affine = "no affine" not in layer
    if layer == "2d":
        jm, tm = jnn.BatchNormalization(5), tnn.BatchNormalization(5)
        x = _rand(0, (6, 5), 2.0) + 3.0
    else:
        jm = jnn.SpatialBatchNormalization(5, format=fmt, affine=affine)
        tm = tnn.SpatialBatchNormalization(5, format=fmt, affine=affine)
        x = _image(fmt, 3, 5, 4, 3) * 2.0 + 3.0
    params, state = jm.init_params(0)
    if affine:
        params = {jm.name: {"weight": jnp.asarray(_rand(4, (5,)) + 1.0),
                            "bias": jnp.asarray(_rand(5, (5,)))}}
    # a state that is not the initial one, so inference reads it
    state = {jm.name: {"running_mean": jnp.asarray(_rand(6, (5,))),
                       "running_var": jnp.asarray(
                           np.abs(_rand(7, (5,))) + 0.5)}}
    jm.set_params(params, state)
    from_jax_weights(jm.get_weights(), tm, _ref_state_list(jm, state))
    dy = _rand(8, x.shape)
    yj, gpj, gxj, sj = _ref_run(jm, params, x, dy, state, training)
    yt, gpt, gxt, st = _port_run(tm, x, dy, tm.initial_state(), training)
    np.testing.assert_allclose(yt, yj, **FWD_TOL)
    np.testing.assert_allclose(gxt, gxj, **GRAD_TOL)
    ref_grads = [np.asarray(g) for g in _ref_weight_order(gpj)(jm)]
    assert len(gpt) == len(ref_grads) == (2 if affine else 0)
    for a, b in zip(gpt, ref_grads):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    if training:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(st[tm.name][key].numpy(),
                                       np.asarray(sj[jm.name][key]),
                                       rtol=1e-6, atol=1e-6)
    else:
        assert st == {} and sj == {}


def test_batch_norm_state_roundtrip_and_sync_axis_raises():
    tm = tnn.SpatialBatchNormalization(3)
    st = tm.initial_state()[tm.name]
    assert torch.equal(st["running_mean"], torch.zeros(3))
    assert torch.equal(st["running_var"], torch.ones(3))
    tm.set_state({tm.name: {"running_mean": torch.full((3,), 2.0),
                            "running_var": torch.full((3,), 4.0)}})
    assert torch.equal(tm.running_var, torch.full((3,), 4.0))
    with pytest.raises(ValueError, match="set_state"):
        tm.set_state({"other": st})
    # sync BN: built anywhere, runs inference anywhere, and its training
    # forward resolves the axis on the current mesh (none here: raises)
    sync = tnn.SpatialBatchNormalization(3, sync_axis="dp")
    x = torch.ones(2, 3, 2, 2)
    assert torch.equal(sync.run(sync.param_dict(), x,
                                state=sync.initial_state())[0],
                       x / np.sqrt(np.float32(1.0 + 1e-5)))
    with pytest.raises(RuntimeError, match="no mesh is current"):
        sync.run(sync.param_dict(), x, state=sync.initial_state(),
                 training=True)


def test_relu_gradient_at_exact_zero_is_half():
    x = np.array([[-1.0, 0.0, 2.0, 0.0, -0.0]], np.float32)
    dy = np.ones_like(x)
    yj, _, gxj, _ = _ref_run(jnn.ReLU(), {}, x, dy)
    yt, _, gxt, _ = _port_run(tnn.ReLU(), x, dy)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(gxt, gxj)
    np.testing.assert_array_equal(gxt, [[0.0, 0.5, 1.0, 0.5, 0.5]])


@pytest.mark.parametrize("name", ["Tanh", "LogSoftMax", "ReLU"])
def test_activations(name):
    x = _rand(0, (3, 7), 2.0)
    _pair(getattr(jnn, name)(), getattr(tnn, name)(), x)


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear(with_bias):
    jm = jnn.Linear(7, 5, with_bias=with_bias)
    tm = tnn.Linear(7, 5, with_bias=with_bias)
    assert tuple(tm.weight.shape) == (5, 7)          # (out, in)
    _pair(jm, tm, _rand(0, (4, 7)))


@pytest.mark.parametrize("shortcut", ["identity", "projection"])
def test_concat_table_and_cadd_table(shortcut):
    """main path and shortcut in a ConcatTable, summed by CAddTable: the
    children's order is the reference's (main first)."""
    def build(nn, fmt="NCHW"):
        main = nn.Sequential(nn.SpatialConvolution(3, 3, 3, 3, 1, 1, 1, 1),
                             nn.ReLU())
        sc = (nn.Identity() if shortcut == "identity"
              else nn.SpatialConvolution(3, 3, 1, 1))
        return nn.Sequential(nn.ConcatTable(main, sc), nn.CAddTable())
    tm = build(tnn)
    assert [type(m).__name__ for m in tm._ref_modules()] == [
        "Sequential", "ConcatTable", "Sequential", "SpatialConvolution",
        "ReLU", "SpatialConvolution" if shortcut == "projection"
        else "Identity", "CAddTable"]
    _pair(build(jnn), tm, _image("NCHW", 2, 3, 5, 5))


@pytest.mark.parametrize("layer,shape", [
    (("Reshape", (12,)), (2, 3, 4)),
    (("Reshape", (3, 4)), (12,)),
    (("Reshape", (6, 2), False), (3, 4)),
    (("View", 12), (2, 1, 1, 12)),
    (("View", -1, 6), (2, 3, 4)),
    (("View", (4, 3)), (5, 12)),
])
def test_reshape_and_view(layer, shape):
    cls, *args = layer
    x = _rand(0, shape)
    yj = np.asarray(getattr(jnn, cls)(*args).apply({}, jnp.asarray(x),
                                                   jnn.Ctx()))
    yt = getattr(tnn, cls)(*args).apply({}, torch.from_numpy(x), tnn.Ctx())
    np.testing.assert_array_equal(yt.numpy(), yj)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(size_average=False),
    dict(weights=[0.5, 1.0, 2.0, 1.5]),
    dict(weights=[0.5, 1.0, 2.0, 1.5], size_average=False),
    dict(padding_value=3),
    dict(log_prob_as_input=False),
])
def test_class_nll_criterion(kw):
    """1-based float labels (truncated to int32, 3.7 -> class 3),
    padding rows weigh 0, class weights, size_average."""
    rs = np.random.RandomState(0)
    logits = rs.randn(6, 4).astype(np.float32)
    out = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
           if kw.get("log_prob_as_input") is False
           else logits - np.log(np.exp(logits).sum(-1, keepdims=True)))
    out = out.astype(np.float32)
    target = np.array([1.0, 4.0, 3.7, 2.0, 3.0, 1.2], np.float32)
    jc, tc = jnn.ClassNLLCriterion(**kw), tnn.ClassNLLCriterion(**kw)
    lj, gj = jax.value_and_grad(lambda o: jc.loss(o, jnp.asarray(target)))(
        jnp.asarray(out))
    ot = torch.from_numpy(out).requires_grad_()
    lt = tc.loss(ot, torch.from_numpy(target))
    (gt,) = torch.autograd.grad(lt, ot)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-7)


def test_get_and_set_weights_order_and_checks():
    tm = tnn.Sequential(tnn.Linear(3, 2), tnn.SpatialBatchNormalization(2),
                        tnn.Linear(2, 2, with_bias=False))
    assert [tuple(w.shape) for w in tm.get_weights()] == [
        (2, 3), (2,), (2,), (2,), (2, 2)]
    new = [np.full(w.shape, i, np.float32)
           for i, w in enumerate(tm.get_weights())]
    tm.set_weights(new)
    assert tm[2].weight[0, 0].item() == 4.0 and tm[0].bias[0].item() == 1.0
    with pytest.raises(ValueError, match="3 arrays given, the model has 5"):
        tm.set_weights(new[:3])
    with pytest.raises(ValueError, match="entry 4 has shape"):
        tm.set_weights(new[:4] + [np.zeros((3, 3), np.float32)])
    assert tm[2].weight[0, 0].item() == 4.0       # nothing copied


@pytest.mark.parametrize("name,args", [
    ("Zeros", ()), ("Ones", ()), ("RandomUniform", ()),
    ("RandomUniform", (-0.2, 0.7)), ("RandomNormal", (0.5, 2.0)),
    ("Xavier", ()), ("MsraFiller", ()), ("MsraFiller", (False,)),
])
def test_init_methods_draw_the_reference_distributions(name, args):
    """Same bounds, mean and spread as the reference's method on 60,000
    draws (the streams differ); one seed gives one tensor."""
    shape, fan_in, fan_out = (200, 300), 300, 50
    ref = np.asarray(getattr(jnn, name)(*args)(jax.random.PRNGKey(0), shape,
                                                fan_in, fan_out))
    draw = getattr(tnn, name)(*args)
    got = draw(torch.Generator().manual_seed(3), shape, fan_in, fan_out)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    got = got.numpy()
    assert np.array_equal(got, draw(torch.Generator().manual_seed(3), shape,
                                    fan_in, fan_out).numpy())
    spread = max(float(ref.std()), 1e-3)
    assert abs(got.mean() - ref.mean()) <= 0.02 * spread + 1e-7
    assert abs(got.std() - ref.std()) <= 0.02 * spread + 1e-7
    if name in ("Zeros", "Ones", "RandomUniform", "Xavier"):
        assert abs(got.min() - ref.min()) <= 0.01 * spread + 1e-7
        assert abs(got.max() - ref.max()) <= 0.01 * spread + 1e-7


def test_init_tensor_reads_a_layers_override():
    class OnesLinear(tnn.Linear):
        weight_init = tnn.Ones()
    assert torch.equal(OnesLinear(3, 2).weight, torch.ones(2, 3))
    assert not torch.equal(tnn.Linear(3, 2).weight, torch.ones(2, 3))


def test_regularizers_raise():
    """Per-layer regularizers are ported: a layer keeps a callable one,
    and only something that is not a penalty function raises."""
    from bigdl_tpu_torch.optim import L2Regularizer
    for kw in (dict(w_regularizer=object()), dict(b_regularizer=object())):
        with pytest.raises(TypeError, match="callable"):
            tnn.Linear(2, 2, **kw)
        with pytest.raises(TypeError, match="callable"):
            tnn.SpatialConvolution(2, 2, 1, 1, **kw)
    assert tnn.Linear(2, 2).regularization_loss({}) == 0.0
    lin = tnn.Linear(2, 2, w_regularizer=L2Regularizer(0.5))
    conv = tnn.SpatialConvolution(2, 2, 1, 1, b_regularizer=L2Regularizer(2.0))
    assert lin.w_regularizer is not None and conv.b_regularizer is not None


# --------------------------------------------------------------------- #
# models                                                                #
# --------------------------------------------------------------------- #
def test_resnet50_imagenet_structure_matches_the_reference():
    """Weight and state shapes, in get_weights order, without drawing the
    reference's 25.6M parameters (jax.eval_shape of its init)."""
    jm = JR.build(class_num=1000, depth=50, dataset="imagenet",
                  format="NHWC")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = [tuple(s.shape) for s in _ref_weight_order(shapes)(jm)]
    tm = TR.build(class_num=1000, depth=50, dataset="imagenet",
                  format="NHWC", device="cpu")
    got = [tuple(w.shape) for w in tm.get_weights()]
    assert got == want
    assert len(got) == 161
    assert sum(int(np.prod(s)) for s in got) == 25_557_032
    state = jm.initial_state()
    assert [tuple(t.shape) for t in tm.state_list()] == [
        tuple(np.shape(a)) for a in _ref_state_list(jm, state)]
    assert len(tm.state_list()) == 106
    assert all(p.dtype == torch.float32 for p in tm.get_weights())


def test_lenet5_matches_the_reference():
    jm, tm = JL.build(10), TL.build(10, device="cpu")
    assert sum(w.numel() for w in tm.get_weights()) == 22_278
    _pair(jm, tm, _rand(0, (3, 784)))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("shortcut_type", ["B", "C"])
def test_bottleneck_stage_with_projection_shortcut(fmt, shortcut_type):
    """Two bottleneck blocks at small widths, the first strided with a
    projection shortcut, in training mode (batch statistics)."""
    def stage(mod, builder_kw):
        b = mod._Builder(shortcut_type, format=fmt, **builder_kw)
        b.i_channels = 8
        return b.layer(b.bottleneck, 4, 2, 2)
    jm = stage(JR, {})
    tm = stage(TR, dict(gen=torch.Generator().manual_seed(0)))
    assert len(tm.get_weights()) == len(jm.get_weights())
    sj, st = _pair(jm, tm, _image(fmt, 2, 8, 6, 6), training=True,
                   grad_rel=MODEL_GRAD_REL)
    for a, b in zip([st[k][n] for k in st for n in sorted(st[k])],
                    [sj[m.name][n] for m in jm.modules() if m.name in sj
                     for n in sorted(sj[m.name])]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_cifar_resnet8_end_to_end(fmt, training):
    """Logits, and every gradient within 1e-4 of its leaf's largest
    entry, after from_jax_weights; then the loss of ClassNLLCriterion."""
    jm = JR.build(class_num=10, depth=8, dataset="cifar10", format=fmt)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", format=fmt,
                  device="cpu")
    x = _image(fmt, 4, 3, 32, 32)
    _pair(jm, tm, x, seed=3, training=training, grad_rel=MODEL_GRAD_REL)
    y = np.array([1.0, 10.0, 5.0, 3.0], np.float32)
    params, state = jm._params, jm._state
    out, _ = jm.run(params, jnp.asarray(x), state=state, training=training)
    lj = float(jnn.ClassNLLCriterion().loss(out, jnp.asarray(y)))
    outt, _ = tm.run(tm.param_dict(), torch.from_numpy(x),
                     state=tm.initial_state(), training=training)
    lt = tnn.ClassNLLCriterion().loss(outt, torch.from_numpy(y)).item()
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


def test_from_jax_weights_checks_counts_and_shapes_first():
    jm = JR.build(class_num=10, depth=8, dataset="cifar10")
    params, state = jm.init_params(0)
    jm.set_params(params, state)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", device="cpu")
    before = [w.clone() for w in tm.get_weights()]
    w = jm.get_weights()
    s = _ref_state_list(jm, state)
    with pytest.raises(ValueError, match=f"from_jax_weights.*{len(w) - 1} "
                       f"arrays given, the model has {len(w)}"):
        from_jax_weights(w[:-1], tm, s)
    with pytest.raises(ValueError, match="state.*entry 0 has shape"):
        from_jax_weights(w, tm, [np.zeros(3, np.float32)] + s[1:])
    assert all(torch.equal(a, b) for a, b in zip(before, tm.get_weights()))
    from_jax_weights(w, tm, s)
    assert all(np.array_equal(a, b.numpy())
               for a, b in zip(w, tm.get_weights()))


def test_unported_model_options_raise():
    """The options the reference itself refuses, and shortcut type A in
    NHWC, which the reference builds but cannot run (ROADMAP C6)."""
    with pytest.raises(ValueError, match="C6"):
        TR.build(depth=18, shortcut_type="A", format="NHWC", device="cpu")
    for kw, what in ((dict(stem="s2d"), "requires format='NHWC'"),
                     (dict(stem="s2d", format="NHWC", dataset="cifar10",
                           depth=8), "requires format='NHWC'"),
                     (dict(stem="patchify"), "unknown stem")):
        with pytest.raises(ValueError, match=what):
            TR.build(**{"depth": 18, **kw}, device="cpu")
    with pytest.raises(ValueError, match="6n\\+2"):
        TR.build(depth=9, dataset="cifar10", device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        return
    for build in (lambda: TR.build(depth=18), lambda: TL.build(10),
                  lambda: LocalOptimizer(None, (np.zeros((2, 1)),
                                                np.ones(2)),
                                         tnn.ClassNLLCriterion(),
                                         batch_size=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# --------------------------------------------------------------------- #
# LocalOptimizer                                                        #
# --------------------------------------------------------------------- #
def _train_pair(jm, tm, x, y, batch_size, sgd_kw, end):
    """The reference's and the port's LocalOptimizer from the same
    weights; returns their per-step losses."""
    losses = {"ref": [], "port": []}
    jo = (JLocalOptimizer(jm, (x, y), jnn.ClassNLLCriterion(),
                          batch_size=batch_size)
          .set_optim_method(JSGD(**sgd_kw)).set_end_when(end[0]))
    fire = jo._fire_mid_epoch

    def ref_hook(*a):
        losses["ref"].append(float(jo.state.loss))
        return fire(*a)
    jo._fire_mid_epoch = ref_hook
    jo.optimize()
    to = (LocalOptimizer(tm, (x, y), tnn.ClassNLLCriterion(),
                         batch_size=batch_size, device="cpu")
          .set_optim_method(SGD(**sgd_kw)).set_end_when(end[1]))
    fire_t = to._fire_mid_epoch

    def port_hook():
        losses["port"].append(float(to.state.loss))
        return fire_t()
    to._fire_mid_epoch = port_hook
    assert to.optimize() is tm
    assert (to.state.epoch, to.state.iteration) == (jo.state.epoch,
                                                    jo.state.iteration)
    return losses["ref"], losses["port"]


def test_local_optimizer_lenet5_matches_the_reference():
    """Three steps of SGD(lr 0.05) without momentum (K6's plain version),
    batch 8 from an epoch-shuffled 24-row set: the batch order, each
    step's loss and the final parameters agree."""
    jm = JL.build(10)
    params, state = jm.init_params(1)
    jm.set_params(params, state)
    tm = TL.build(10, device="cpu")
    from_jax_weights(jm.get_weights(), tm)
    rs = np.random.RandomState(0)
    x = rs.randn(24, 784).astype(np.float32)
    y = (rs.randint(0, 10, 24) + 1).astype(np.float32)
    lj, lt = _train_pair(jm, tm, x, y, 8, dict(learning_rate=0.05),
                         (JTrigger.max_epoch(1), Trigger.max_epoch(1)))
    assert len(lt) == 3
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_local_optimizer_cifar_resnet8_matches_the_reference():
    """Three steps of SGD(lr 0.1, momentum 0.9, wd 1e-4) (K5's plain
    version) with batch statistics, NHWC: losses, parameters and the BN
    running statistics agree."""
    jm = JR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC")
    params, state = jm.init_params(3)
    jm.set_params(params, state)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC",
                  device="cpu")
    from_jax_weights(jm.get_weights(), tm, _ref_state_list(jm, state))
    rs = np.random.RandomState(1)
    x = rs.randn(12, 32, 32, 3).astype(np.float32)
    y = (rs.randint(0, 10, 12) + 1).astype(np.float32)
    lj, lt = _train_pair(
        jm, tm, x, y, 4, dict(learning_rate=0.1, momentum=0.9,
                              weight_decay=1e-4),
        (JTrigger.max_iteration(3), Trigger.max_iteration(3)))
    assert len(lt) == 3
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(np.abs(b).max(),
                                                         1e-3)
    for a, b in zip(tm.state_list(), _ref_state_list(jm, jm._state)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_local_optimizer_unported_setters_raise(tmp_path):
    """The reference's setters on ``LocalOptimizer``, each ported now:
    ``set_trace_every`` and ``serve_metrics`` (driven below) among them."""
    import threading
    import urllib.request
    before = set(threading.enumerate())
    tm = TL.build(10, device="cpu")
    opt = LocalOptimizer(tm, (np.zeros((2, 784), np.float32),
                              np.ones(2, np.float32)),
                         tnn.ClassNLLCriterion(), batch_size=1,
                         device="cpu")
    assert opt.set_trace_every(1, str(tmp_path)) is opt
    srv = opt.serve_metrics()
    try:
        opt.optimize()
        with urllib.request.urlopen(srv.url("/metrics"), timeout=30) as r:
            assert r.status == 200
            assert "bigdl_records_total" not in r.read().decode()
    finally:
        opt.stop_metrics()
    # trace-only telemetry: a trace a step, no scalars read
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "trace_step1.json", "trace_step2.json"]
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith(("introspection:", "health-watchdog"))]
    # each returns the optimizer
    assert opt.set_train_summary(None) is opt
    assert opt.set_val_summary(None) is opt
    assert opt.set_gradient_accumulation(2) is opt and opt._grad_accum == 2
    assert opt.set_gradient_clipping_by_l2_norm(1.0) is opt
    assert opt.set_constant_gradient_clipping(-1.0, 1.0) is opt
    assert opt.set_device_augment(None) is opt
    assert opt.set_mixed_precision() is opt and opt.mixed_precision
    assert opt.set_prefetch(2) is opt and opt.prefetch_depth == 2
    assert opt.set_validation(Trigger.every_epoch(), (
        np.zeros((2, 784), np.float32), np.ones(2, np.float32)), []) is opt
    # seed seeds the loop's device generator (seed + 13)
    seeded = LocalOptimizer(tm, (np.zeros((2, 784)), np.ones(2)),
                            tnn.ClassNLLCriterion(), batch_size=1, seed=1,
                            device="cpu")
    assert seeded._generator().initial_seed() == 14
    with pytest.raises(ValueError, match="batch_size required"):
        LocalOptimizer(tm, (np.zeros((2, 784)), np.ones(2)),
                       tnn.ClassNLLCriterion(), device="cpu")
    assert isinstance(opt.optim_method, SGD)
    # the default SGD() has no momentum: K6's path
    assert opt.optim_method.momentum == 0.0
