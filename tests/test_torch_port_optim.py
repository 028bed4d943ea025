"""The port's SGD, Adam and AdamW (bigdl_tpu_torch.optim) and the plain
versions of its fused kernels (bigdl_tpu_torch.kernels.fused_optim) held
against the reference's tree-map update on the CPU.

Both sides start from the same numpy leaves and gradients and run five
steps.  The reference runs ``Adam.update`` / ``AdamW.update`` with
``fused=False``: its Pallas-vs-tree-map parity does not hold under the
installed jax, so the port is held to the tree-map math.  On the CPU the
port's ``fused=True`` takes the plain version for every leaf; the kernel
is held against it, bitwise, on the card by chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.optim import optim_method as JO
from bigdl_tpu_torch.kernels import fused_optim as fo
from bigdl_tpu_torch.optim import (SGD, Adam, AdamW, Default,
                                   make_accum_grads)

# the reference's own bound for its fused update against the tree-map
# one (tests/test_fused_optim.py): one-op-at-a-time fp32 on both sides
TOL = dict(rtol=1e-6, atol=1e-7)
SIZES = (1, 127, 3 * 256, 0)


def _tree(seed, scale):
    rs = np.random.RandomState(seed)
    return {"a": {"w": (rs.randn(SIZES[0]) * scale).astype(np.float32),
                  "b": (rs.randn(SIZES[1]) * scale).astype(np.float32)},
            "c": {"w": (rs.randn(8, 96) * scale).astype(np.float32),
                  "e": np.zeros((0,), np.float32)}}


def _to_torch(tree):
    return {k: {kk: torch.from_numpy(v.copy()) for kk, v in sub.items()}
            for k, sub in tree.items()}


def _to_jax(tree):
    return {k: {kk: jnp.asarray(v) for kk, v in sub.items()}
            for k, sub in tree.items()}


def _methods(kind, fused, lr_decay):
    kw = dict(learning_rate=1e-2, learning_rate_decay=lr_decay)
    if kind == "adam":
        return JO.Adam(**kw), Adam(fused=fused, **kw)
    return (JO.AdamW(weight_decay=0.05, **kw),
            AdamW(weight_decay=0.05, fused=fused, **kw))


@pytest.mark.parametrize("lr_decay", [0.0, 0.1])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_matches_reference_tree_map_update(kind, fused, lr_decay):
    jm, tm = _methods(kind, fused, lr_decay)
    params = _tree(0, 0.5)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for step in range(5):
        g = _tree(10 + step, 0.1)
        jp, js = jm.update(_to_jax(g), jp, js)
        tp_out, ts = tm.update(_to_torch(g), tp, ts)
        assert tp_out is tp                       # updated in place
        np.testing.assert_allclose(
            float(tm.get_learning_rate(ts)),
            float(jm.get_learning_rate(js)), rtol=1e-7)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 5
    for name in ("a", "c"):
        for leaf in params[name]:
            for a, b in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
                np.testing.assert_allclose(
                    a[name][leaf].numpy(), np.asarray(b[name][leaf]), **TOL,
                    err_msg=f"{kind} fused={fused} {name}.{leaf}")


def test_update_scalars_are_device_scalars_in_fp32():
    m = AdamW(learning_rate=3e-4)
    st = m.init_state({"x": torch.zeros(3)})
    kw = m.update_scalars(st)
    for key in ("clr", "bc1", "bc2"):
        assert kw[key].dtype == torch.float32 and kw[key].numel() == 1
    # 1 - beta^1 with beta rounded to fp32 first, as the reference does
    assert float(kw["bc1"]) == np.float32(1) - np.float32(0.9)
    assert float(kw["bc2"]) == np.float32(1) - np.float32(0.999)
    assert kw["weight_decay"] == 0.01 and float(kw["clr"]) == np.float32(3e-4)
    assert isinstance(m.schedule, Default)


def test_fused_on_cpu_is_the_plain_version_bitwise():
    params = _tree(1, 0.3)
    grads = _to_torch(_tree(2, 0.1))
    out = []
    for fused in (True, False):
        m = AdamW(learning_rate=1e-2, fused=fused)
        p = _to_torch(params)
        st = m.init_state(p)
        for _ in range(3):
            p, st = m.update(grads, p, st)
        out.append(p)
    for name in ("a", "c"):
        for leaf in out[0][name]:
            assert torch.equal(out[0][name][leaf], out[1][name][leaf])


def test_non_f32_leaves_take_the_reference_math():
    p = {"x": torch.ones(5, dtype=torch.bfloat16)}
    g = {"x": torch.full((5,), 0.5, dtype=torch.bfloat16)}
    m = Adam(learning_rate=0.1, fused=True)
    st = m.init_state(p)
    m.update(g, p, st)
    assert p["x"].dtype == torch.bfloat16
    np.testing.assert_allclose(p["x"].float().numpy(), 0.9, rtol=1e-2)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the routing of
    fused_adam_update without a card (the kernel itself is replaced)."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case,expect", [
    ("f32", "kernel"),
    ("empty", "skipped"),
    ("bf16", "kernel"),
    ("bf16 grad", "raises"),
    ("f32 then bf16", "a kernel a dtype"),
    ("fp16", "raises"),
])
def test_cuda_leaves_go_to_the_kernel_or_raise(monkeypatch, case, expect):
    """On the card a leaf goes to the kernel (f32, or bf16 throughout: its
    bf16 instantiation; one launch a dtype), is skipped when empty, or
    raises (fp16, or mixed dtypes in one leaf): it never takes the plain
    version unasked (fused=False asks)."""
    launched = []
    monkeypatch.setattr(fo, "_adam_cuda", lambda leaves, dtype, **kw:
                        launched.append((dtype, len(leaves))))

    def leaf(n, dtype=torch.float32, g_dtype=None):
        p = torch.ones(n, dtype=dtype).as_subclass(_OnCard)
        g = torch.ones(n, dtype=g_dtype or dtype).as_subclass(_OnCard)
        return p, g, torch.zeros_like(p), torch.zeros_like(p)

    leaves = {"f32": [leaf(4)], "empty": [leaf(0)],
              "bf16": [leaf(4, torch.bfloat16)],
              "bf16 grad": [leaf(4, g_dtype=torch.bfloat16)],
              "f32 then bf16": [leaf(4), leaf(4, torch.bfloat16)],
              "fp16": [leaf(4, torch.float16)]}[case]
    trees = [{f"x{i}": lf[j] for i, lf in enumerate(leaves)}
             for j in range(4)]
    kw = dict(clr=None, bc1=None, bc2=None, beta1=0.9, beta2=0.999, eps=1e-8)
    if expect == "raises":
        with pytest.raises(NotImplementedError,
                           match="takes float32 leaves.*fused=False"):
            fo.fused_adam_update(*trees, **kw)
        assert launched == []           # checked before any launch
    else:
        fo.fused_adam_update(*trees, **kw)
        want = {"kernel": [(leaves[0][0].dtype, 1)], "skipped": [],
                "a kernel a dtype": [(torch.float32, 1),
                                     (torch.bfloat16, 1)]}[expect]
        assert launched == want
        p = trees[0]["x0"]
        assert torch.equal(p, torch.ones(len(p), dtype=p.dtype))


def test_no_silent_fallback_on_other_devices():
    t = torch.empty(4, device="meta")
    kw = dict(clr=t, bc1=t, bc2=t, beta1=0.9, beta2=0.999, eps=1e-8)
    with pytest.raises(RuntimeError, match="no implementation"):
        fo.fused_adam_update({"x": t}, {"x": t}, {"x": t}, {"x": t}, **kw)


@pytest.mark.parametrize("bad,match", [
    ("shape", "does not match"),
    ("strided", "contiguous"),
    ("scalar", "clr must be one float32"),
])
def test_kernel_input_checks_raise(bad, match):
    p = torch.zeros(8, 4)
    if bad == "strided":
        p = p.t()
    g = torch.zeros(3) if bad == "shape" else torch.zeros_like(p)
    clr = torch.zeros((), dtype=torch.float64 if bad == "scalar"
                      else torch.float32)
    one = torch.ones(())
    with pytest.raises(ValueError, match=match):
        fo._adam_cuda([(p, g, torch.zeros_like(p), torch.zeros_like(p))],
                      clr=clr, bc1=one, bc2=one, beta1=0.9, beta2=0.999,
                      eps=1e-8, weight_decay=0.0)


def test_make_accum_grads_weights_microbatches():
    """Two microbatches weighted by their valid count give the gradient of
    the masked mean over the whole batch."""
    w = torch.tensor([1.5, -2.0], requires_grad=True)
    params = {"lin": {"w": w}}
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    y = torch.tensor([1, -1, 1, 1])

    def loss_fn(p, st, xb, yb):
        mask = (yb != -1).float()
        per = (xb @ p["lin"]["w"]) ** 2
        return (per * mask).sum() / mask.sum().clamp(min=1.0), st

    (l1, _), g1 = make_accum_grads(loss_fn, 1)(params, {}, x, y)
    (l2, _), g2 = make_accum_grads(
        loss_fn, 2, weight_fn=lambda xb, yb: (yb != -1).sum())(
            params, {}, x, y)
    torch.testing.assert_close(l2, l1)
    torch.testing.assert_close(g2["lin"]["w"], g1["lin"]["w"])
    assert w.grad is None                       # no .grad side effect
    with pytest.raises(ValueError, match="not divisible"):
        make_accum_grads(loss_fn, 3)(params, {}, x, y)


# --------------------------------------------------------------------- #
# SGD (K5 / K6's plain versions)                                        #
# --------------------------------------------------------------------- #
# every static choice of the reference's SGD.update: momentum (K5) or not
# (K6), dampening = momentum (the default) or 0, nesterov, weight decay,
# and a per-step learning-rate decay
SGD_CASES = {
    "plain": dict(),
    "plain wd": dict(weight_decay=1e-4),
    "momentum": dict(momentum=0.9),
    "momentum wd": dict(momentum=0.9, weight_decay=1e-4),
    "momentum dampening 0": dict(momentum=0.9, dampening=0.0),
    "momentum dampening 0 wd": dict(momentum=0.9, dampening=0.0,
                                    weight_decay=1e-4),
    "nesterov": dict(momentum=0.9, dampening=0.0, nesterov=True),
    "nesterov wd": dict(momentum=0.9, dampening=0.0, nesterov=True,
                        weight_decay=1e-4),
}


@pytest.mark.parametrize("lr_decay", [0.0, 0.1])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_sgd_matches_reference_tree_map_update_bitwise(case, fused,
                                                       lr_decay):
    """Three steps of every combination against the reference's
    ``SGD.update`` (fused=False, its tree-map math), bitwise: both sides
    round the scalars to fp32 and run one fp32 op at a time in the same
    order (the reference eagerly, op by op)."""
    kw = dict(learning_rate=0.1, learning_rate_decay=lr_decay,
              **SGD_CASES[case])
    jm, tm = JO.SGD(**kw), SGD(fused=fused, **kw)
    params = _tree(0, 0.5)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jm.init_state(jp), tm.init_state(tp)
    assert set(ts) == set(js)           # velocity only with momentum
    for step in range(3):
        g = _tree(10 + step, 0.1)
        jp, js = jm.update(_to_jax(g), jp, js)
        tp_out, ts = tm.update(_to_torch(g), tp, ts)
        assert tp_out is tp                       # updated in place
        assert float(tm.get_learning_rate(ts)) == float(
            jm.get_learning_rate(js))
    assert int(ts["step"]) == 3
    trees = [(tp, jp)]
    if "velocity" in ts:
        trees.append((ts["velocity"], js["velocity"]))
    for name in ("a", "c"):
        for leaf in params[name]:
            for a, b in trees:
                np.testing.assert_array_equal(
                    a[name][leaf].numpy(), np.asarray(b[name][leaf]),
                    err_msg=f"{case} fused={fused} {name}.{leaf}")


def test_sgd_reference_defaults_and_checks():
    m = SGD(momentum=0.9)
    assert m.dampening == 0.9            # dampening defaults to momentum
    assert SGD().lr == 1e-3 and SGD().momentum == 0.0
    st = m.init_state({"x": torch.ones(3)})
    assert torch.equal(st["velocity"]["x"], torch.zeros(3))   # starts at 0
    assert "velocity" not in SGD().init_state({"x": torch.ones(3)})
    for bad in (dict(nesterov=True), dict(momentum=0.9, nesterov=True)):
        with pytest.raises(ValueError, match="Nesterov"):
            SGD(**bad)
    # accepted and unused, as the reference's SGD takes them
    for kw in (dict(learning_rates=[0.1]), dict(weight_decays=[0.1])):
        assert SGD(**kw).lr == 1e-3
    clr = m.get_learning_rate(st)
    assert clr.dtype == torch.float32 and clr.numel() == 1
    assert float(clr) == np.float32(1e-3)


@pytest.mark.parametrize("case,expect", [
    ("momentum f32", "kernel"),
    ("plain f32", "kernel"),
    ("momentum empty", "skipped"),
    ("momentum bf16", "kernel"),
    ("plain bf16", "kernel"),
    ("momentum bf16 velocity", "raises"),
    ("momentum fp16", "raises"),
    ("plain fp16", "raises"),
])
def test_sgd_cuda_leaves_go_to_the_kernel_or_raise(monkeypatch, case,
                                                   expect):
    """On the card an SGD leaf goes to K5 (momentum) or K6 (f32, or bf16
    throughout: the kernels' bf16 instantiations), is skipped when empty,
    or raises before any launch (fp16, or mixed dtypes): never the plain
    version unasked."""
    launched = []
    monkeypatch.setattr(fo, "_sgd_cuda",
                        lambda leaves, **kw: launched.extend(leaves))
    n = 0 if "empty" in case else 4
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}.get(
        case.split()[-1], torch.float32)
    p = torch.ones(n, dtype=dtype).as_subclass(_OnCard)
    g = torch.ones(n, dtype=dtype).as_subclass(_OnCard)
    v = torch.zeros(n, dtype=torch.bfloat16 if "velocity" in case
                    else dtype).as_subclass(_OnCard)
    mom = case.startswith("momentum")
    kw = dict(clr=None, momentum=0.9 if mom else 0.0, dampening=0.9)
    vel = {"x": v} if mom else None
    if expect == "raises":
        with pytest.raises(NotImplementedError,
                           match=f"fused_sgd_{'mom' if mom else 'plain'}: "
                                 f"the kernel takes float32 leaves or "
                                 f"bfloat16 leaves.*fused=False"):
            fo.fused_sgd_update({"x": p}, {"x": g}, vel, **kw)
        assert launched == []
        return
    _, v_out = fo.fused_sgd_update({"x": p}, {"x": g}, vel, **kw)
    assert len(launched) == (1 if expect == "kernel" else 0)
    if expect == "kernel":
        assert len(launched[0]) == (3 if mom else 2)     # (p, g[, v])
    assert (v_out is vel) if mom else v_out is None
    assert torch.equal(p, torch.ones(n, dtype=dtype))


@pytest.mark.parametrize("bad,match", [
    ("shape", "does not match"),
    ("strided", "contiguous"),
    ("scalar", "clr must be one float32"),
])
@pytest.mark.parametrize("mom", [True, False])
def test_sgd_kernel_input_checks_raise(bad, match, mom):
    p = torch.zeros(8, 4)
    if bad == "strided":
        p = p.t()
    g = torch.zeros(3) if bad == "shape" else torch.zeros_like(p)
    clr = torch.zeros((), dtype=torch.float64 if bad == "scalar"
                      else torch.float32)
    leaf = (p, g, torch.zeros_like(p)) if mom else (p, g)
    with pytest.raises(ValueError, match=match):
        fo._sgd_cuda([leaf], clr=clr, momentum=0.9 if mom else 0.0,
                     dampening=0.0, nesterov=False, weight_decay=0.0)


# --------------------------------------------------------------------- #
# no device scalar made from a host value (a copy that syncs the host)   #
# --------------------------------------------------------------------- #
class _TorchWithoutHostCopies:
    """``torch`` as ``optim_method`` sees it, with the two calls that copy
    a host value to the device refused."""

    def __getattr__(self, name):
        if name in ("as_tensor", "tensor"):
            def refuse(*args, **kwargs):
                raise AssertionError(f"optim_method called torch.{name}: a "
                                     f"host value copied to the device")
            return refuse
        return getattr(torch, name)


def _host_copy_scalars(method, step):
    """clr, and Adam's bc1 and bc2, built from host floats with
    torch.as_tensor / torch.tensor: the values the update must keep."""
    rate = torch.as_tensor(method.schedule.rate(method, step),
                           dtype=torch.float32)
    clr = rate / (1.0 + step * method.lr_decay)
    if isinstance(method, SGD):
        return dict(clr=clr)
    tf = (step + 1).to(torch.float32)
    b1 = torch.tensor(method.beta1, dtype=torch.float32)
    b2 = torch.tensor(method.beta2, dtype=torch.float32)
    return dict(clr=clr, bc1=1.0 - torch.pow(b1, tf),
                bc2=1.0 - torch.pow(b2, tf))


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_update_makes_no_device_scalar_from_a_host_value(monkeypatch, kind):
    from bigdl_tpu_torch.optim import optim_method as om
    kw = dict(learning_rate=3e-2, learning_rate_decay=0.1)
    if kind == "sgd":
        method = SGD(momentum=0.9, weight_decay=1e-4, fused=True, **kw)
    else:
        method = AdamW(weight_decay=0.05, fused=True, **kw)
    params = _to_torch(_tree(1, 0.3))
    want_p = _to_torch(_tree(1, 0.3))
    state = method.init_state(params)
    want_st = method.init_state(want_p)
    monkeypatch.setattr(om, "torch", _TorchWithoutHostCopies())
    for i in range(3):
        grads = _to_torch(_tree(20 + i, 0.1))
        step = torch.tensor(i, dtype=torch.int32)
        sc = _host_copy_scalars(method, step)
        if kind == "sgd":
            fo.fused_sgd_update_plain(
                want_p, grads, want_st["velocity"], momentum=0.9,
                dampening=0.9, weight_decay=1e-4, **sc)
        else:
            fo.fused_adam_update_plain(
                want_p, grads, want_st["m"], want_st["v"], beta1=0.9,
                beta2=0.999, eps=1e-8, weight_decay=0.05, **sc)
        params, state = method.update(grads, params, state)
    assert int(state["step"]) == 3
    moments = ("velocity",) if kind == "sgd" else ("m", "v")
    for (got, want) in ([(params, want_p)]
                        + [(state[k], want_st[k]) for k in moments]):
        for (a, b) in fo.zip_leaves(got, want):
            assert torch.equal(a, b)
