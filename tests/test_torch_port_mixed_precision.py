"""Mixed precision in the port against the reference on the CPU.

``_BNTrain`` (the port's training-mode batch norm, an autograd Function)
against the reference's ``_bn_train`` custom VJP: forward, batch
statistics and the three gradients, fp32 and bf16, NHWC and NCHW, on the
same numpy inputs.  Then CIFAR ResNet-8 through three steps of
``make_train_step(mixed_precision=True)`` on both packages from the same
weights.

Tolerances (each the variant it rejects is checked beside it):
  * fp32: both compute the same formula in fp32, in other reduction
    orders: every output within ``F32_TOL`` of its largest entry.
  * bf16: y and dx are bf16 roundings of the same math on both sides;
    an fp32 ulp of difference in the statistics can move them by one
    bf16 ulp (at most 2^-7 of the value): within ``BF16_OUT_REL`` of the
    largest entry (both read 0 here).  The
    statistics and dgamma, dbeta are fp32 sums over the same bf16 values:
    within ``F32_TOL``.  The old autograd BN (the forward formula
    differentiated by autograd) rounds dgamma and dbeta to bf16 and must
    fail that limit.
  * ResNet-8 bf16: XLA's and oneDNN's bf16 convolutions round in other
    places, so bf16-level noise separates the two packages (three steps
    read losses 1.4e-3 apart, relative, and weights 9.7e-4): losses
    within ``MP_LOSS_REL``, weights within ``MP_W_ABS``.  An fp32 run
    reads about as far (1.6e-3, 1.8e-3), so what tells the bf16 step
    from an fp32 one is the forward: the training-mode log-probs on bf16
    inputs agree bitwise with the reference's in 77.5 % of the elements
    and every other within one bf16 ulp; an fp32 forward agrees in none.
    The limit is half of them bitwise, the rest within one bf16 ulp.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.models import resnet as JR
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JNLL
from bigdl_tpu.nn.normalization import _bn_train
from bigdl_tpu.optim.optim_method import SGD as JSGD
from bigdl_tpu.optim.optimizer import make_train_step as j_make_train_step
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.nn.normalization import _BNTrain
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.optim.optimizer import make_train_step

F32_TOL = 2e-5          # relative to each output's largest entry
BF16_OUT_REL = 2 ** -7  # one bf16 ulp of the largest entry
MP_LOSS_REL = 3e-3
MP_W_ABS = 3e-3
MP_BITWISE_SHARE = 0.5
EPS = 1e-5


def _inputs(fmt, dtype, seed=0):
    rs = np.random.RandomState(seed)
    shape = (4, 6, 5, 3) if fmt == "NHWC" else (4, 3, 6, 5)
    axis = 3 if fmt == "NHWC" else 1
    x = (rs.randn(*shape) * 2.0 + 1.5).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    gamma = (rs.randn(3) * 0.5 + 1.0).astype(np.float32)
    beta = rs.randn(3).astype(np.float32)
    if dtype == "bf16":
        # the inputs as bf16 holds them, on both sides
        x = torch.from_numpy(x).bfloat16().float().numpy()
        dy = torch.from_numpy(dy).bfloat16().float().numpy()
    return x, dy, gamma, beta, axis


def _ref(x, dy, gamma, beta, axis, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def f(xx, g, b):
        return _bn_train(xx, g, b, axis, EPS)

    (y, mean, var), vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(gamma),
                                  jnp.asarray(beta))
    zeros = jnp.zeros_like(mean)
    dx, dg, db = vjp((jnp.asarray(dy, jdt), zeros, zeros))
    return [np.asarray(jnp.asarray(a, jnp.float32))
            for a in (y, mean, var, dx, dg, db)]


def _port(x, dy, gamma, beta, axis, dtype, bn=None):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    g = torch.from_numpy(gamma).requires_grad_()
    b = torch.from_numpy(beta).requires_grad_()
    y, mean, var = (bn or _BNTrain.apply)(xt, g, b, axis, EPS)
    dx, dg, db = torch.autograd.grad(y, (xt, g, b),
                                     torch.from_numpy(dy).to(tdt))
    return [a.detach().float().numpy() for a in (y, mean, var, dx, dg, db)]


def _old_autograd_bn(x, gamma, beta, axis, eps):
    """The port's training BN before ``_BNTrain``: the forward formula,
    differentiated by autograd."""
    axes = tuple(i for i in range(x.ndim) if i != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    xf = x.float()
    mean = xf.mean(dim=axes)
    m2 = (xf * xf).mean(dim=axes)
    var = torch.clamp_min(m2 - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    shift = beta - gamma * mean * inv
    y = (x * scale.reshape(shape).to(x.dtype)
         + shift.reshape(shape).to(x.dtype))
    return y, mean.detach(), var.detach()


def _rel_errs(got, want):
    return [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
            for a, b in zip(got, want)]


NAMES = ("y", "mean", "var", "dx", "dgamma", "dbeta")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_bn_train_matches_the_reference_custom_vjp(fmt, dtype):
    args = _inputs(fmt, dtype)
    want = _ref(*args, dtype)
    got = _port(*args, dtype)
    errs = dict(zip(NAMES, _rel_errs(got, want)))
    for name, err in errs.items():
        limit = BF16_OUT_REL if dtype == "bf16" and name in ("y", "dx") \
            else F32_TOL
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_bf16_bn_gradients_reject_the_old_autograd_bn(fmt):
    """dgamma and dbeta of the old autograd BN come back rounded to bf16:
    they fail the limit that ``_BNTrain`` meets."""
    args = _inputs(fmt, "bf16")
    want = _ref(*args, "bf16")
    old = dict(zip(NAMES, _rel_errs(_port(*args, "bf16",
                                          bn=_old_autograd_bn), want)))
    assert old["dgamma"] > 10 * F32_TOL and old["dbeta"] > 10 * F32_TOL, old


def test_bn_saves_no_fp32_copy_of_its_input():
    x = torch.randn(8, 4, 4, 16, dtype=torch.bfloat16, requires_grad=True)
    g = torch.ones(16, requires_grad=True)
    b = torch.zeros(16, requires_grad=True)
    y, _, _ = _BNTrain.apply(x, g, b, 3, EPS)
    saved = y.grad_fn.saved_tensors
    assert saved[0] is x or saved[0].data_ptr() == x.data_ptr()
    assert sum(t.numel() for t in saved) == x.numel() + 3 * 16


# --------------------------------------------------------------------- #
# ResNet-8 through make_train_step(mixed_precision=True)                 #
# --------------------------------------------------------------------- #
def _ref_state_list(jm, state):
    return [np.asarray(state[m.name][k]) for m in jm.modules()
            if m.name in state for k in sorted(state[m.name])]


def _resnet8_steps(mixed_port=True):
    """Three SGD(0.1, momentum 0.9, wd 1e-4) steps of the reference's
    and the port's step, bf16 in the reference: (ref losses, port
    losses, ref weights, port weights)."""
    jm = JR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC")
    params, state = jm.init_params(3)
    jm.set_params(params, state)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC",
                  device="cpu")
    from_jax_weights(jm.get_weights(), tm, _ref_state_list(jm, state))
    sgd = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    rs = np.random.RandomState(1)
    xs = rs.randn(3, 4, 32, 32, 3).astype(np.float32)
    ys = (rs.randint(0, 10, (3, 4)) + 1).astype(np.float32)

    jopt = JSGD(**sgd)
    jstep = jax.jit(j_make_train_step(jm, JNLL(), jopt,
                                      mixed_precision=True))
    jp, js, jo = params, state, jopt.init_state(params)
    lj = []
    for x, y in zip(xs, ys):
        jp, jo, js, loss = jstep(jp, jo, js, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.PRNGKey(0))
        lj.append(float(loss))
    jm.set_params(jp, js)

    topt = SGD(**sgd)
    tstep = make_train_step(tm, tnn.ClassNLLCriterion(), topt,
                            mixed_precision=mixed_port)
    tp, ts = tm.param_dict(), tm.initial_state()
    to = topt.init_state(tp)
    lt = []
    for x, y in zip(xs, ys):
        tp, to, ts, loss = tstep(tp, to, ts, torch.from_numpy(x),
                                 torch.from_numpy(y))
        lt.append(float(loss))
    assert all(p.dtype == torch.float32 for p in tm.get_weights())
    return (lj, lt, [np.asarray(w) for w in jm.get_weights()],
            [w.detach().numpy() for w in tm.get_weights()])


def test_resnet8_mixed_precision_steps_match_the_reference():
    lj, lt, wj, wt = _resnet8_steps()
    np.testing.assert_allclose(lt, lj, rtol=MP_LOSS_REL)
    assert max(float(np.abs(a - b).max()) for a, b in zip(wt, wj)) \
        <= MP_W_ABS
    assert np.all(np.isfinite(lt))


@pytest.mark.parametrize("port_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32-must-fail"])
def test_bf16_forward_is_the_references(port_dtype):
    """ResNet-8's training-mode log-probs on bf16 inputs against the
    reference's: at least ``MP_BITWISE_SHARE`` bitwise, the rest within
    one bf16 ulp of the reference's value; the same forward in fp32 must
    fail."""
    jm = JR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC")
    params, state = jm.init_params(3)
    jm.set_params(params, state)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC",
                  device="cpu")
    from_jax_weights(jm.get_weights(), tm, _ref_state_list(jm, state))
    x = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)
    yj = np.asarray(jm.run(params, jnp.asarray(x, jnp.bfloat16), state=state,
                           training=True)[0].astype(jnp.float32))
    yt = tm.run(tm.param_dict(), torch.from_numpy(x).to(port_dtype),
                state=tm.initial_state(), training=True)[0]
    yt = yt.detach().float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(yj))) - 7)
    share = float((yt == yj).mean())
    ok = share >= MP_BITWISE_SHARE and bool(np.all(np.abs(yt - yj) <= ulp))
    assert ok == (port_dtype == torch.bfloat16), (share,
                                                  np.abs(yt - yj).max())


def test_mixed_precision_gradients_come_back_fp32():
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC",
                  device="cpu")
    params = tm.param_dict()
    x = torch.randn(2, 32, 32, 3)
    ctx = tnn.Ctx(state=tm.initial_state(), training=True)
    out = tm.apply(params, x.bfloat16(), ctx)
    assert out.dtype == torch.bfloat16
    loss = tnn.ClassNLLCriterion().loss(out.float(), torch.tensor([1., 2.]))
    leaves = [p for sub in params.values() for p in sub.values()]
    grads = torch.autograd.grad(loss, leaves)
    assert {g.dtype for g in grads} == {torch.float32}
    assert all(v.dtype == torch.float32 for sub in ctx.new_state.values()
               for v in sub.values())
