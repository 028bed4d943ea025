"""The port's validation against the reference's on the CPU: every ported
``ValidationMethod`` on the same outputs, ``Evaluator.test`` and
``Predictor`` on LeNet-5 with the reference's weights, and
``set_validation``'s scores while ``LocalOptimizer`` trains LeNet-5.

Tolerances: accuracies and counts are integers and must be equal;
``Loss``, ``MAE`` and ``NDCG`` sum fp32 values in another order (and the
models' logits differ by ~1e-6, ``tests/test_torch_port_classifier.py``):
within ``REL`` relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import lenet as JL
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import predictor as jpred
from bigdl_tpu.optim import validation as jval
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.optim import (MAE, NDCG, SGD, Evaluator, HitRatio,
                                   LocalOptimizer, Loss, Predictor,
                                   Top1Accuracy, Top5Accuracy, Trigger)
from bigdl_tpu_torch.optim import validation as tval

REL = 1e-5


def _same(a, b, exact=False):
    va, na = a.result()
    vb, nb = b.result()
    assert na == nb
    if exact:
        assert va == vb
    else:
        np.testing.assert_allclose(va, vb, rtol=REL)


def _outputs(seed=0, b=37, c=12):
    rs = np.random.RandomState(seed)
    out = rs.randn(b, c).astype(np.float32)
    # ties within a row: a stable sort ranks the lower index first
    out[:5, 3] = out[:5, 7] = out[:5].max(axis=1) + 1.0
    y = (rs.randint(0, c, b) + 1).astype(np.float32)
    return out, y


@pytest.mark.parametrize("method", ["top1", "top5", "top1_binary",
                                    "top1_onehot", "top5_onehot"])
def test_accuracies_equal_the_references(method):
    out, y = _outputs()
    if method == "top1_binary":
        out = np.random.RandomState(1).rand(37, 1).astype(np.float32)
        y = (np.random.RandomState(2).randint(0, 2, 37) + 1).astype(
            np.float32)
    if method.endswith("onehot"):
        y = np.eye(12, dtype=np.float32)[y.astype(int) - 1]
    kind = "Top5Accuracy" if method.startswith("top5") else "Top1Accuracy"
    ref = getattr(jval, kind)()(jnp.asarray(out), jnp.asarray(y))
    for t in (torch.from_numpy(out), out):
        got = getattr(tval, kind)()(t, y)
        assert got == ref and got.count == 37
    # merged over batches as the reference merges them
    halves = [getattr(tval, kind)()(out[s], y[s])
              for s in (slice(0, 20), slice(20, None))]
    assert halves[0] + halves[1] == ref


def test_loss_and_mae_equal_the_references():
    out, y = _outputs()
    logp = torch.log_softmax(torch.from_numpy(out), -1).numpy()
    _same(tval.Loss()(torch.from_numpy(logp), y),
          jval.Loss()(jnp.asarray(logp), jnp.asarray(y)))
    reg = np.random.RandomState(4).randn(37, 3).astype(np.float32)
    tgt = np.random.RandomState(5).randn(37, 3).astype(np.float32)
    _same(tval.MAE()(reg, tgt), jval.MAE()(jnp.asarray(reg),
                                           jnp.asarray(tgt)))
    _same(tval.Loss(tnn.MSECriterion())(reg, tgt),
          jval.Loss(jnn.MSECriterion())(jnp.asarray(reg), jnp.asarray(tgt)))


@pytest.mark.parametrize("k", [1, 3, 10])
def test_ranking_metrics_equal_the_references(k):
    rs = np.random.RandomState(k)
    out = rs.randn(16 * 21).astype(np.float32)
    out[::21][:4] += 3.0        # a few positives ranked first
    for name in ("HitRatio", "NDCG"):
        _same(getattr(tval, name)(k=k, neg_num=20)(out, None),
              getattr(jval, name)(k=k, neg_num=20)(jnp.asarray(out), None),
              exact=name == "HitRatio")


def _lenet_pair():
    jm = JL.build(10)
    params, state = jm.init_params(1)
    jm.set_params(params, state)
    tm = TL.build(10, device="cpu")
    from_jax_weights(jm.get_weights(), tm)
    return jm, tm


def _mnist(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 784).astype(np.float32)
    proj = np.random.RandomState(9).randn(784, 10).astype(np.float32)
    y = (np.argmax(x @ proj, 1) + 1).astype(np.float32)
    return x, y


def test_evaluator_and_predictor_match_the_references():
    jm, tm = _lenet_pair()
    x, y = _mnist(50, 0)
    jres = jpred.Evaluator(jm, batch_size=16).test(
        (x, y), [jval.Top1Accuracy(), jval.Top5Accuracy(), jval.Loss()])
    tres = Evaluator(tm, batch_size=16).test(
        (x, y), [Top1Accuracy(), Top5Accuracy(), Loss()])
    for (_, a), (_, b), exact in zip(tres, jres, (True, True, False)):
        _same(a, b, exact=exact)
    pt = Predictor(tm, batch_size=16).predict(x)
    pj = jpred.Predictor(jm, batch_size=16).predict(x)
    assert pt.shape == pj.shape == (50, 10)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        Predictor(tm).predict_class(x),
        jpred.Predictor(jm).predict_class(x))
    # the port's Evaluator from numpy on Predictor's outputs
    top1 = int((np.argmax(pt, 1) + 1 == y).sum())
    assert tres[0][1].correct == top1


def _capture(opt):
    """Record every validation the optimizer runs: [(value, count), ...]
    per method."""
    seen = []
    inner = opt._validate

    def wrapped(*a):
        named = inner(*a)
        seen.append([r.result() for _, r in named])
        return named
    opt._validate = wrapped
    return seen


@pytest.mark.parametrize("every", ["epoch", "2 iterations"])
def test_set_validation_scores_match_the_reference(every):
    jm, tm = _lenet_pair()
    x, y = _mnist(48, 1)
    xv, yv = _mnist(40, 2)
    if every == "epoch":
        jt, tt = JTrigger.every_epoch(), Trigger.every_epoch()
    else:
        jt, tt = JTrigger.several_iteration(2), Trigger.several_iteration(2)
    jo = (JLocalOptimizer(jm, (x, y), jnn.ClassNLLCriterion(), batch_size=16)
          .set_optim_method(JSGD(learning_rate=0.05))
          .set_end_when(JTrigger.max_epoch(2))
          .set_validation(jt, (xv, yv), [jval.Top1Accuracy(),
                                         jval.Top5Accuracy(), jval.Loss()],
                          batch_size=16))
    to = (LocalOptimizer(tm, (x, y), tnn.ClassNLLCriterion(), batch_size=16,
                         device="cpu")
          .set_optim_method(SGD(learning_rate=0.05))
          .set_end_when(Trigger.max_epoch(2))
          .set_validation(tt, (xv, yv), [Top1Accuracy(), Top5Accuracy(),
                                         Loss()], batch_size=16))
    seen_j, seen_t = _capture(jo), _capture(to)
    jo.optimize()
    to.optimize()
    # every 2 iterations of 6: at 2, 4 and 6 mid-epoch, and 6 again at the
    # epoch's end, as the reference does
    assert len(seen_t) == len(seen_j) == (2 if every == "epoch" else 4)
    for a, b in zip(seen_t, seen_j):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(a[2][0], b[2][0], rtol=REL)
    np.testing.assert_allclose(to.state.score, jo.state.score, rtol=REL)
    assert to.state.score == seen_t[-1][0][0]


def test_validation_methods_without_a_reference_counterpart_are_absent():
    assert not hasattr(tval, "TreeNNAccuracy")
    assert MAE.name == "MAE" and NDCG.name == "NDCG"
    assert HitRatio(k=5).k == 5
