"""The optimization methods after ``AdamW`` (Adagrad, Adadelta, Adamax,
RMSprop, Ftrl, LARS, LAMB, LBFGS) and ``OptimMethod``'s stateful
interface, held against ``bigdl_tpu.optim`` on the CPU.

Each method takes five updates of the same fp32 gradients (drawn from a
numpy seed) on both packages; parameters and every state leaf agree
within 1e-6 relative (an absolute floor of 1e-7 where a value is near 0):
the same op order, with XLA-CPU's and ATen-CPU's elementwise kernels and
LARS/LAMB's norm sums between them.  LBFGS runs the reference's own
quadratic (``tests/test_optim.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import optim as J
from bigdl_tpu_torch import optim as T

TOL = dict(rtol=1e-6, atol=1e-7)

CASES = {
    "adagrad": (dict(learning_rate=0.1, learning_rate_decay=0.05,
                     weight_decay=0.01), "Adagrad"),
    "adadelta": (dict(decay_rate=0.9, epsilon=1e-6), "Adadelta"),
    "adamax": (dict(learning_rate=0.02, beta1=0.8, beta2=0.99), "Adamax"),
    "rmsprop": (dict(learning_rate=0.01, learning_rate_decay=0.1,
                     decay_rate=0.9, epsilon=1e-6), "RMSprop"),
    "ftrl": (dict(learning_rate=0.5, learning_rate_power=-0.5,
                  initial_accumulator_value=0.1,
                  l1_regularization_strength=0.01,
                  l2_regularization_strength=0.02,
                  l2_shrinkage_regularization_strength=0.03), "Ftrl"),
    "lars": (dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-3,
                  trust_coefficient=1e-2), "LARS"),
    "lars_schedule": (dict(learning_rate=0.1, momentum=0.9,
                           learning_rate_schedule="step"), "LARS"),
    "lamb": (dict(learning_rate=0.01, beta1=0.9, beta2=0.99,
                  weight_decay=0.01), "LAMB"),
}
SHAPES = {"a": {"w": (7, 5), "b": (5,)}, "c": {"weight": (3, 4, 2)}}


def _tree(rs, scale=1.0):
    return {m: {k: (rs.randn(*s) * scale).astype(np.float32)
                for k, s in sub.items()} for m, sub in SHAPES.items()}


def _methods(name):
    kw, cls = CASES[name]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("learning_rate_schedule") == "step":
        jkw["learning_rate_schedule"] = J.Step(2, 0.5)
        tkw["learning_rate_schedule"] = T.Step(2, 0.5)
    return getattr(J, cls)(**jkw), getattr(T, cls)(**tkw)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def _run(name, steps=5, seed=0):
    rs = np.random.RandomState(seed)
    p0 = _tree(rs)
    grads = [_tree(rs, 0.1) for _ in range(steps)]
    jm, tm = _methods(name)
    jp = {m: {k: jnp.asarray(v) for k, v in sub.items()}
          for m, sub in p0.items()}
    tp = {m: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
          for m, sub in p0.items()}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for g in grads:
        jp, js = jm.update({m: {k: jnp.asarray(v) for k, v in sub.items()}
                            for m, sub in g.items()}, jp, js)
        tp_out, ts = tm.update({m: {k: torch.from_numpy(v) for k, v
                                    in sub.items()} for m, sub in g.items()},
                               tp, ts)
        assert tp_out is tp            # the update writes in place
    return (jp, js), (tp, ts), tm


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_matches_the_reference_over_five_updates(name):
    (jp, js), (tp, ts), _ = _run(name)
    _assert_trees({m: {k: v.numpy() for k, v in sub.items()}
                   for m, sub in tp.items()}, jp)
    _assert_trees(_host(ts), js)
    assert int(ts["step"]) == 5 and ts["step"].dtype == torch.int32


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_saves_and_loads_and_goes_on(name, tmp_path):
    """``OptimMethod.save``/``load`` keep the hyperparameters (and the
    schedule): the loaded method's next update equals the original's."""
    _, (tp, ts), tm = _run(name, steps=2)
    path = str(tmp_path / "m.bin")
    tm.save(path)
    loaded = T.OptimMethod.load(path)
    assert type(loaded) is type(tm) and vars(loaded).keys() == \
        vars(tm).keys()
    g = _tree(np.random.RandomState(9), 0.1)
    g = {m: {k: torch.from_numpy(v) for k, v in sub.items()}
         for m, sub in g.items()}
    clone = lambda t: {m: {k: v.clone() for k, v in sub.items()} if
                       isinstance(sub, dict) else sub.clone()
                       for m, sub in t.items()}
    a_p, a_s = tm.update(g, clone(tp), {k: (clone(v) if isinstance(v, dict)
                                           else v.clone())
                                        for k, v in ts.items()})
    b_p, b_s = loaded.update(g, clone(tp), {k: (clone(v) if isinstance(
        v, dict) else v.clone()) for k, v in ts.items()})
    _assert_trees(_host(a_p), _host(b_p))
    _assert_trees(_host(a_s), _host(b_s))


def _quadratic_j(x):
    target = jnp.asarray([1.0, 2.0])
    loss = jnp.sum((x["w"] - target) ** 2)
    return loss, {"w": 2 * (x["w"] - target)}


def _quadratic_t(x):
    target = torch.tensor([1.0, 2.0])
    loss = torch.sum((x["w"] - target) ** 2)
    return loss, {"w": 2 * (x["w"] - target)}


def test_lbfgs_on_the_reference_quadratic():
    jx, jl = J.LBFGS(max_iter=30).optimize(_quadratic_j,
                                           {"w": jnp.zeros(2)})
    tm = T.LBFGS(max_iter=30)
    tx, tl = tm.optimize(_quadratic_t, {"w": torch.zeros(2)})
    assert float(torch.max(torch.abs(tx["w"] - torch.tensor([1.0, 2.0])))) \
        < 1e-4
    assert tl[-1] < tl[0]
    assert len(tl) == len(jl) and tm.nevals == len(tl) - 1
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tx["w"].numpy(), np.asarray(jx["w"]),
                               rtol=1e-6)


def test_lbfgs_on_a_tensor_and_an_ill_conditioned_quadratic():
    scale = torch.tensor([1.0, 30.0, 0.2])

    def f(x):
        d = x - torch.tensor([0.5, -1.0, 2.0])
        return torch.sum(scale * d * d), 2 * scale * d

    x, losses = T.LBFGS(max_iter=50, tolerance_fun=1e-10).optimize(
        f, torch.zeros(3))
    torch.testing.assert_close(x, torch.tensor([0.5, -1.0, 2.0]),
                               rtol=1e-4, atol=1e-4)
    assert all(b <= a for a, b in zip(losses, losses[1:]))   # Armijo


@pytest.mark.parametrize("name", ["adagrad", "rmsprop", "lamb"])
def test_the_stateful_interface_matches_the_reference(name):
    jm, tm = _methods(name)
    jx = {"w": jnp.asarray([0.3, -0.7])}
    tx = {"w": torch.tensor([0.3, -0.7])}
    for _ in range(4):
        jx, jl = jm.optimize(_quadratic_j, jx)
        tx, tl = tm.optimize(_quadratic_t, tx)
        np.testing.assert_allclose(float(tl[0]), float(jl[0]), rtol=1e-6)
    np.testing.assert_allclose(tx["w"].numpy(), np.asarray(jx["w"]),
                               rtol=1e-6)
    assert tm.nevals == 4 and int(tm.state_dict()["step"]) == 4
    assert tm.clear_history() is tm and tm.state_dict() is None
    tm.optimize(_quadratic_t, tx)
    assert int(tm.state_dict()["step"]) == 1


def test_a_loaded_method_goes_on_from_its_saved_state(tmp_path):
    """The state ``optimize`` keeps is saved with the method; it comes
    back as host arrays and the next call moves it to the device."""
    tm = T.Adagrad(learning_rate=0.1)
    x = {"w": torch.tensor([0.3, -0.7])}
    x, _ = tm.optimize(_quadratic_t, x)
    tm.save(str(tmp_path / "a.bin"))
    loaded = T.OptimMethod.load(str(tmp_path / "a.bin"))
    a, _ = tm.optimize(_quadratic_t, {"w": x["w"].clone()})
    b, _ = loaded.optimize(_quadratic_t, {"w": x["w"].clone()})
    torch.testing.assert_close(a["w"], b["w"], rtol=0, atol=0)
    assert int(loaded.state_dict()["step"]) == 2
