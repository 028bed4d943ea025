"""The port's post-training int8 held against the reference on the CPU
(``bigdl_tpu.quantized`` → ``bigdl_tpu_torch.quantized``).

Weights come from numpy seeds (or the reference's initialised models,
loaded into the port by position); inputs from numpy seeds.  What is
integer is compared bit for bit: the int8 weight codes, the activation
codes, and the int32 accumulators against the reference's
``dot_general`` / ``conv_general_dilated`` with
``preferred_element_type=int32``.  The fp32 outputs (one rescale of the
same accumulator) agree within 1e-6 of their largest magnitude, the
calibrated maxima within 1e-6 relative, and a quantized model within the
reference's own bands against its float model (0.05 for ResNet-20).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from bigdl_tpu import nn as jnn
from bigdl_tpu import quantized as jq
from bigdl_tpu.models import transformer as JT
from bigdl_tpu.nn.conv import _same_pad as ref_same_pad
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import quantized as tq
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

from _torch_port_parity import cross, rand, ref_state_list

OUT_REL = 1e-6


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1e-12))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,axis", [((8, 16), 0), ((16, 8), 1),
                                        ((6, 3, 3, 3), 0), ((5,), 0)])
def test_weight_codes_bitwise(shape, axis):
    w = rand(0, shape)
    w.flat[0] = 0.0
    q, s = tq.quantize_weights_symmetric(w, axis=axis)
    qj, sj = jq.quantize_weights_symmetric(w, axis=axis)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    # an all-zero channel keeps the 1e-8 floor
    q0, s0 = tq.quantize_weights_symmetric(np.zeros((2, 3), np.float32))
    assert not q0.any() and (s0 > 0).all()


@pytest.mark.parametrize("m,k,n", [(1, 147, 3), (16, 32, 8), (17, 8, 8),
                                   (40, 13, 21)])
def test_int8_matmul_pads_exactly(m, k, n):
    rs = np.random.RandomState(m + k + n)
    a = rs.randint(-127, 128, (m, k)).astype(np.int8)
    w = rs.randint(-127, 128, (n, k)).astype(np.int8)
    got = tq.int8_matmul(_t(a), tq._pad_weight(_t(w)), n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)
    with pytest.raises(ValueError):
        tq.int8_matmul(_t(a).float(), tq._pad_weight(_t(w)), n)


@pytest.mark.parametrize("absmax", [None, 2.345678])
@pytest.mark.parametrize("xshape", [(5, 37), (2, 3, 37)])
def test_quantized_linear_codes_and_accumulator_bitwise(absmax, xshape):
    w, b = rand(1, (13, 37)), rand(2, (13,))
    x = rand(3, xshape)
    jl = jq.QuantizedLinear(w, b, act_absmax=absmax)
    tl = tq.QuantizedLinear(_t(w), _t(b), act_absmax=absmax)
    np.testing.assert_array_equal(tl.qweight.numpy(), np.asarray(jl.qweight))
    np.testing.assert_array_equal(tl.wscale.numpy(), np.asarray(jl.wscale))
    qj, _ = jq._quantize_activations(jnp.asarray(x), jl.act_absmax)
    qt, _ = tl.quantize_input(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    accj = lax.dot_general(qj, jl.qweight,
                           (((qj.ndim - 1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)
    acct = tl.accumulate(qt)
    assert acct.dtype == torch.int32
    np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
    yj = jl.apply({}, jnp.asarray(x), None)
    yt = tl.apply({}, _t(x), None)
    assert _rel(yt.numpy(), yj) <= OUT_REL


CONV_CASES = [
    # format, groups, dilation, padding, stride
    ("NCHW", 1, (1, 1), (1, 1), (1, 1)),
    ("NHWC", 1, (1, 1), (1, 1), (2, 2)),
    ("NCHW", 1, (1, 1), (-1, 0), (2, 2)),
    ("NHWC", 1, (1, 1), (0, -1), (1, 2)),
    ("NCHW", 2, (1, 1), (-1, -1), (2, 1)),
    ("NHWC", 3, (1, 1), (1, 0), (1, 1)),
    ("NCHW", 1, (2, 2), (2, 2), (1, 1)),
    ("NHWC", 3, (2, 1), (-1, 1), (1, 2)),
]


def _ref_conv_acc(jc, qj, x, fmt, groups, dil, pad, stride):
    spatial = x.shape[2:4] if fmt == "NCHW" else x.shape[1:3]
    pads = tuple(ref_same_pad(spatial[i], stride[i], 3, dil[i]) if p == -1
                 else (p, p) for i, p in enumerate(pad))
    dn = ("NCHW", "OIHW", "NCHW") if fmt == "NCHW" \
        else ("NHWC", "OIHW", "NHWC")
    return lax.conv_general_dilated(
        qj, jc.qweight, window_strides=stride, padding=pads,
        rhs_dilation=dil, dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32)


@pytest.mark.parametrize("absmax", [None, 3.1])
@pytest.mark.parametrize("case", CONV_CASES)
def test_quantized_conv_codes_and_accumulator_bitwise(case, absmax):
    fmt, groups, dil, pad, stride = case
    cin, cout = 6, 12
    w, b = rand(4, (cout, cin // groups, 3, 3)), rand(5, (cout,))
    x = rand(6, (2, cin, 11, 10))
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = dict(stride=stride, padding=pad, dilation=dil, n_group=groups,
              format=fmt, act_absmax=absmax)
    jc = jq.QuantizedSpatialConvolution(w, b, **kw)
    tc = tq.QuantizedSpatialConvolution(_t(w), _t(b), **kw)
    np.testing.assert_array_equal(tc.qweight.numpy(), np.asarray(jc.qweight))
    qj, _ = jq._quantize_activations(jnp.asarray(x), jc.act_absmax)
    qt, _ = tc.quantize_input(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    accj = _ref_conv_acc(jc, qj, x, fmt, groups, dil, pad, stride)
    acct = tc.accumulate(qt)
    assert acct.dtype == torch.int32
    np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
    yj = jc.apply({}, jnp.asarray(x), None)
    yt = tc.apply({}, _t(x), None)
    assert yt.shape == yj.shape
    assert _rel(yt.numpy(), yj) <= OUT_REL


@pytest.mark.parametrize("kw", [dict(pad_w=2, pad_h=2, dilation_w=2,
                                     dilation_h=2),
                                dict(dw=2, pad_w=-1, pad_h=-1,
                                     dilation_w=2, dilation_h=3)])
def test_quantized_dilated_conv_from_float(kw):
    jm = jnn.SpatialDilatedConvolution(3, 8, 3, 3, **kw)
    tm = tnn.SpatialDilatedConvolution(3, 8, 3, 3, **kw)
    params, _ = cross(jm, tm)
    x = rand(7, (2, 3, 12, 12))
    jc = jq.QuantizedSpatialDilatedConvolution.from_float(jm, params[jm.name])
    tc = tq.QuantizedSpatialDilatedConvolution.from_float(tm)
    assert type(tc).__name__ == "QuantizedSpatialDilatedConvolution"
    assert tc.dilation == jc.dilation and tc.name == tm.name + "_q"
    qt, _ = tc.quantize_input(_t(x))
    qj, _ = jq._quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    yj = jc.apply({}, jnp.asarray(x), None)
    yt = tc.apply({}, _t(x), None)
    assert _rel(yt.numpy(), yj) <= OUT_REL
    yf = tm.forward(_t(x)).detach().numpy()
    assert _rel(yt.numpy(), yf) < 0.05


def test_quantized_modules_refuse_backward():
    lin = tnn.Linear(4, 2)
    for q in (tq.QuantizedLinear.from_float(lin),
              tq.QuantizedSpatialDilatedConvolution.from_float(
                  tnn.SpatialDilatedConvolution(1, 2, 3, 3, dilation_w=2))):
        x = torch.ones((1, 4)) if isinstance(q, tq.QuantizedLinear) \
            else torch.ones((1, 1, 6, 6))
        y = q.forward(x)
        with pytest.raises(RuntimeError, match="inference-only"):
            q.backward(x, torch.ones_like(y))


def _bn_model(nn, graph=False):
    if not graph:
        return nn.Sequential(
            nn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1),
            nn.SpatialBatchNormalization(4), nn.ReLU(),
            nn.Reshape((4 * 8 * 8,)), nn.Linear(256, 10), nn.LogSoftMax())
    inp = nn.Input()
    c = nn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1).inputs(inp)
    bn = nn.SpatialBatchNormalization(4).inputs(c)
    a = nn.ReLU().inputs(bn)
    r = nn.Reshape((4 * 8 * 8,)).inputs(a)
    l1 = nn.Linear(256, 10).inputs(r)
    l2 = nn.Linear(256, 10).inputs(r)
    out = nn.CAddTable().inputs(l1, l2)
    return nn.Graph(inp, out)


def _trained_bn(jm, tm, rs):
    """Non-default BN affine parameters and running statistics in both."""
    params, state = jm.init_params(0)
    bn = [m for m in jm.modules() if isinstance(m, jnn.BatchNormalization)][0]
    params = dict(params)
    params[bn.name] = {"weight": rs.rand(4).astype(np.float32) + 0.5,
                      "bias": rs.randn(4).astype(np.float32)}
    state = dict(state)
    state[bn.name] = {"running_mean": rs.randn(4).astype(np.float32),
                      "running_var": rs.rand(4).astype(np.float32) + 0.5}
    jm.set_params(params, state)
    jm.evaluate()
    from bigdl_tpu_torch.models.convert import from_jax_weights
    from_jax_weights(jm.get_weights(), tm, ref_state_list(jm, state))
    return params, state


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_rewrites_sequential_and_graph_keeping_bn(graph, calibrated):
    rs = np.random.RandomState(1)
    jm, tm = _bn_model(jnn, graph), _bn_model(tnn, graph)
    params, state = _trained_bn(jm, tm, rs)
    x = rs.randn(4, 1, 8, 8).astype(np.float32)
    calib = [rs.randn(4, 1, 8, 8).astype(np.float32) for _ in range(2)] \
        if calibrated else None
    jqm = jq.quantize(jm, calibration_data=calib).evaluate()
    tqm = tq.quantize(tm, calibration_data=calib).evaluate()
    kinds = sorted(type(m).__name__ for m in tqm.modules())
    assert kinds == sorted(type(m).__name__ for m in jqm.modules())
    assert kinds.count("QuantizedLinear") == (2 if graph else 1)
    # the float model is untouched, and the BN entries carried over
    assert any(type(m) is tnn.SpatialConvolution for m in tm.modules())
    bn_t = [m for m in tqm.modules()
            if isinstance(m, tnn.SpatialBatchNormalization)][0]
    bn_j = [m for m in jm.modules()
            if isinstance(m, jnn.SpatialBatchNormalization)][0]
    np.testing.assert_array_equal(bn_t.weight.detach().numpy(),
                                  params[bn_j.name]["weight"])
    np.testing.assert_array_equal(bn_t.running_mean.numpy(),
                                  state[bn_j.name]["running_mean"])
    yj = np.asarray(jqm.forward(x))
    yt = tqm.forward(_t(x)).detach().numpy()
    assert _rel(yt, yj) <= 1e-5
    yf = tm.forward(_t(x)).detach().numpy()
    assert _rel(yt, yf) < 0.1


def test_int8_model_owns_its_tensors_while_the_float_model_trains():
    rs = np.random.RandomState(2)
    jm, tm = _bn_model(jnn), _bn_model(tnn)
    _trained_bn(jm, tm, rs)
    q = tq.quantize(tm)
    x = rs.randn(16, 1, 8, 8).astype(np.float32)
    before = q.forward(_t(x)).detach().clone()
    own = {id(t) for t in tm.parameters()} | {id(t) for t in tm.buffers()}
    assert not own & ({id(t) for t in q.parameters()}
                      | {id(t) for t in q.buffers()})
    y = (rs.randint(0, 10, 16) + 1).astype(np.float32)
    tm.train()
    LocalOptimizer(tm, (x, y), tnn.ClassNLLCriterion(), batch_size=8,
                   device="cpu").set_optim_method(SGD(learning_rate=0.5)) \
        .set_end_when(Trigger.max_iteration(2)).optimize()
    assert not torch.equal(tm.forward(_t(x)), before)
    assert torch.equal(q.forward(_t(x)), before)


def _calib_model(nn):
    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1), nn.ReLU(),
        nn.SpatialConvolution(8, 4, 1, 1), nn.Reshape((4 * 8 * 8,)),
        nn.Linear(4 * 8 * 8, 10))


def test_calibrated_maxima_match_the_reference():
    jm, tm = _calib_model(jnn), _calib_model(tnn)
    cross(jm, tm, seed=3)
    rng = np.random.RandomState(3)
    calib = [rng.rand(2, 3, 8, 8).astype(np.float32) for _ in range(3)]
    aj = jq.calibrate_activation_absmax(jm, calib)
    at = tq.calibrate_activation_absmax(tm, calib)
    names = {t.name: j.name for t, j in zip(tm.modules(), jm.modules())}
    assert len(at) == len(aj) == 3
    for n, v in at.items():
        assert abs(v - aj[names[n]]) <= 1e-6 * aj[names[n]]
    # no shadow is left on the float model
    assert all("apply" not in m.__dict__ for m in tm.modules())
    q = tq.quantize(tm, calibration_data=calib)
    qlayers = [m for m in q.modules() if isinstance(m, tq.QuantizedModule)]
    assert len(qlayers) == 3
    assert all(m.act_absmax == at[m.name[:-2]] for m in qlayers)
    x = rng.rand(2, 3, 8, 8).astype(np.float32)
    jqm = jq.quantize(jm, calibration_data=calib)
    assert _rel(q.forward(_t(x)).detach().numpy(),
                np.asarray(jqm.forward(x))) <= 1e-5
    # static scales clip where runtime scales adapt
    big = 4.0 * x
    assert float((q.forward(_t(big))
                  - tq.quantize(tm).forward(_t(big))).abs().max()) > 1e-3


def _reductions(model, x):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            model.run(model.param_dict(), x, state=model.initial_state())
    names = [e.key for e in prof.key_averages()]
    return sum(n in ("aten::amax", "aten::max", "aten::abs") for n in names)


def test_calibrated_int8_has_no_runtime_activation_reduction():
    rng = np.random.RandomState(0)
    m = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    calib = [rng.rand(4, 8).astype(np.float32) for _ in range(3)]
    x = _t(rng.rand(4, 8).astype(np.float32))
    assert _reductions(tq.quantize(m, calibration_data=calib), x) == 0
    assert _reductions(tq.quantize(m), x) > 0


def test_quantize_resnet20_nhwc_close_to_float():
    m = TR.build(class_num=10, depth=20, dataset="cifar10", format="NHWC",
                 device="cpu", seed=0)
    x = _t(np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32))
    y0 = m.forward(x).detach().numpy()
    q = tq.quantize(m)
    assert sum(isinstance(c, tq.QuantizedSpatialConvolution)
               for c in q.modules()) == 21
    y1 = q.forward(x).detach().numpy()
    assert _rel(y1, y0) < 0.05


def test_quantize_for_serving_is_inference_mode_and_owns_no_params():
    m = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    m.train()
    q = tq.quantize_for_serving(m)
    assert not any(mod.training for mod in q.modules())
    assert q.param_dict() == {} and q.get_weights() == []
    assert q.initial_state() == {}


# --------------------------------------------------------------------- #
# weight-only int8                                                      #
# --------------------------------------------------------------------- #
CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_len=64, dropout=0.0)


@pytest.fixture(scope="module")
def small_lm():
    jm = JT.TransformerLM(JT.TransformerConfig(**CFG))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = TT.TransformerLM(TT.TransformerConfig(**CFG))
    from_jax_params({k: {kk: np.asarray(vv) for kk, vv in sub.items()}
                     for k, sub in jparams.items()}, tm)
    return jm, jparams, tm


def _by_suffix(tree):
    return {k[k.find("."):]: v for k, v in tree.items()}


def test_weight_only_int8_matches_the_reference(small_lm):
    jm, jparams, tm = small_lm
    jqp = jq.quantize_weights_only(jparams, min_size=1024)
    tqp = tq.quantize_weights_only(tm.param_dict(), min_size=1024)
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(tqp) < 0.5 * tq.quantized_bytes(
        tm.param_dict())
    assert tq.quantize_weights_only(tqp, min_size=1024) == tqp  # idempotent
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jd, td = _by_suffix(jq.dequantize_weights(jqp, jdt)), \
            _by_suffix(tq.dequantize_weights(tqp, dt))
        assert sorted(jd) == sorted(td)
        for mod in jd:
            for k, v in jd[mod].items():
                got = td[mod][k].detach().float().numpy()
                want = np.asarray(v).astype(np.float32)
                np.testing.assert_array_equal(got, want, err_msg=mod + k)
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, 128, (2, 8)).astype(np.int32)
    want = np.asarray(jm.generate(jq.dequantize_weights(jqp, jnp.float32),
                                  jnp.asarray(prompt), max_new_tokens=8,
                                  temperature=0.0))
    got = tm.generate(tqp, torch.from_numpy(prompt), 8,
                      params_transform=lambda p: tq.dequantize_weights(
                          p, torch.float32)).numpy()
    np.testing.assert_array_equal(got, want)
    fp = tm.generate(tm.param_dict(), torch.from_numpy(prompt), 8).numpy()
    assert (fp == got).mean() >= 0.8


def test_weight_only_int8_leaves_small_leaves_alone():
    params = {"m": {"w": torch.from_numpy(rand(0, (64, 64))),
                    "b": torch.arange(4, dtype=torch.float32)}}
    q = tq.quantize_weights_only(params, min_size=1024)
    assert set(q["m"]["w"]) == {"q8", "q8_scale"}
    assert q["m"]["b"] is params["m"]["b"]
    d = tq.dequantize_weights(q, dtype=torch.float32)
    err = (d["m"]["w"] - params["m"]["w"]).abs().max().item()
    scale = params["m"]["w"].abs().amax(0).max().item() / 127.0
    assert err <= scale * 0.51 + 1e-6
