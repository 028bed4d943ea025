"""The port's inference facade held against the reference on the CPU:
``Predictor`` / ``Module.predict`` over arrays, ``Sample`` lists and
DataSets, and ``PredictionService`` (arrays through the batching engine,
anything else through one locked ``Predictor``) with concurrent callers
and ``sync_weights``; then ``examples/serving_predictor.py``'s whole flow
on the port, with the example's own assertions, float and int8.

Both packages hold the same weights (the reference's, loaded into the
port by position) and take the same seeded numpy inputs.  Outputs agree
within rtol = atol = 2e-5 (fp32; the engine's buckets batch rows
differently from one direct call); class predictions exactly.
"""
import concurrent.futures as cf
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.data.minibatch import Sample as JSample
from bigdl_tpu.optim import predictor as jpred
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import quantized as tq
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.data.minibatch import Sample as TSample
from bigdl_tpu_torch.data.text import Dictionary, SentenceTokenizer
from bigdl_tpu_torch.optim import (Adam, LocalOptimizer, PredictionService,
                                   Predictor, Trigger)
from bigdl_tpu_torch.optim import predictor as tpred

from _torch_port_parity import cross

TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB, SEQ = 40, 12


def _model(nn):
    return nn.Sequential(
        nn.LookupTable(VOCAB + 1, 16), nn.TemporalConvolution(16, 32, 3),
        nn.ReLU(), nn.TemporalMaxPooling(SEQ - 2, 1), nn.Squeeze(2),
        nn.Linear(32, 3), nn.LogSoftMax())


@pytest.fixture
def pair():
    jm, tm = _model(jnn), _model(tnn)
    cross(jm, tm, seed=1)
    jm.evaluate()
    return jm, tm


def _ids(seed, n):
    return np.random.RandomState(seed).randint(
        1, VOCAB + 1, (n, SEQ)).astype(np.float32)


def _samples(sample_cls, x, lengths=None):
    out = []
    for i, row in enumerate(x):
        n = SEQ if lengths is None else lengths[i]
        out.append(sample_cls(row[:n], np.float32(i % 3 + 1)))
    return out


@pytest.mark.parametrize("batch_size", [4, 128])
def test_predictor_over_arrays_samples_and_datasets(pair, batch_size):
    jm, tm = pair
    x = _ids(0, 10)
    want = jpred.Predictor(jm, batch_size).predict(x)
    tp = Predictor(tm, batch_size)
    np.testing.assert_allclose(tp.predict(x), want, **TOL)
    np.testing.assert_allclose(tp.predict(torch.from_numpy(x)), want, **TOL)
    # Samples of unequal lengths pad as the reference's minibatch does
    lengths = [SEQ, SEQ - 3, SEQ, 5, SEQ, SEQ, 7, SEQ, SEQ, SEQ]
    want_s = jpred.Predictor(jm, batch_size).predict(
        _samples(JSample, x, lengths))
    got_s = tp.predict(_samples(TSample, x, lengths))
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s, want_s, **TOL)
    np.testing.assert_array_equal(
        tp.predict_class(_samples(TSample, x)),
        jpred.Predictor(jm, batch_size).predict_class(_samples(JSample, x)))
    ds = DataSet.minibatch_arrays(x, np.ones(10, np.float32), 4,
                                  shuffle=False, drop_last=False)
    np.testing.assert_allclose(tp.predict(ds), want, **TOL)


def test_module_predict_entry_points(pair):
    jm, tm = pair
    x = _ids(1, 9)
    for name in ("predict", "predict_local"):
        np.testing.assert_allclose(getattr(tm, name)(x, batch_size=4),
                                   np.asarray(getattr(jm, name)(x, 4)),
                                   **TOL)
    for name in ("predict_class", "predict_class_local"):
        np.testing.assert_array_equal(
            getattr(tm, name)(_samples(TSample, x), batch_size=4),
            getattr(jm, name)(_samples(JSample, x), 4))
    # one Predictor per batch size, reused
    assert tm._predictor(4) is tm._predictor(4)
    assert tm._predictor(4) is not tm._predictor(8)


def test_predict_inputs_it_cannot_take_raise():
    class ImageFrame:
        pass
    with pytest.raises(TypeError, match="queue A, item 9"):
        list(tpred._iter_inputs(ImageFrame(), 4))
    with pytest.raises(TypeError, match="unsupported"):
        list(tpred._iter_inputs([1, 2], 4))


def test_prediction_service_arrays_samples_and_concurrency(pair):
    jm, tm = pair
    x = _ids(2, 12)
    js = jpred.PredictionService(jm, input_shape=(SEQ,), max_batch=8)
    ts = PredictionService(tm, input_shape=(SEQ,), max_batch=8)
    try:
        want = np.asarray(js.predict(x[:5]))
        np.testing.assert_allclose(ts.predict(x[:5]), want, **TOL)
        np.testing.assert_allclose(ts.predict(torch.from_numpy(x[:5])),
                                   want, **TOL)
        np.testing.assert_allclose(ts.predict(x[0]), np.asarray(
            js.predict(x[0])), **TOL)
        np.testing.assert_allclose(ts.submit(x[:3]).result(timeout=30),
                                   np.asarray(js.submit(x[:3]).result(
                                       timeout=30)), **TOL)
        # Samples go through the locked Predictor
        np.testing.assert_allclose(ts.predict(_samples(TSample, x)),
                                   js.predict(_samples(JSample, x)), **TOL)
        # eight concurrent callers, one row each
        want_rows = np.asarray(js.predict(x[:8]))
        with cf.ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda i: ts.predict(x[i]), range(8)))
        np.testing.assert_allclose(np.stack(got), want_rows, **TOL)
        with cf.ThreadPoolExecutor(4) as ex:
            got = list(ex.map(lambda i: ts.predict(_samples(TSample, x)),
                              range(4)))
        for g in got:
            np.testing.assert_allclose(g, js.predict(_samples(JSample, x)),
                                       **TOL)
        st = ts.engine.stats()
        assert st["recompiles"] == 0
    finally:
        js.shutdown()
        ts.shutdown()


def test_prediction_service_sync_weights(pair):
    jm, tm = pair
    x = _ids(3, 4)
    js = jpred.PredictionService(jm, input_shape=(SEQ,))
    ts = PredictionService(tm, input_shape=(SEQ,))
    try:
        old = ts.predict(x)
        scaled = [np.asarray(w) * np.float32(1.5) for w in jm.get_weights()]
        jm.set_weights(scaled)
        tm.set_weights(scaled)
        # the registry holds its own copy: stale until synced
        np.testing.assert_array_equal(ts.predict(x), old)
        jv, tv = js.sync_weights(), ts.sync_weights()
        assert tv.version == jv.version == "v2"
        np.testing.assert_allclose(ts.predict(x), np.asarray(js.predict(x)),
                                   **TOL)
        assert not np.allclose(ts.predict(x), old)
    finally:
        js.shutdown()
        ts.shutdown()


# --------------------------------------------------------------------- #
# examples/serving_predictor.py on the port                             #
# --------------------------------------------------------------------- #
def _example():
    """The example module itself: its corpus, labels and demo rows."""
    here = os.path.dirname(__file__)
    ex_dir = os.path.join(here, "..", "examples")
    sys.path.insert(0, ex_dir)
    try:
        spec = importlib.util.spec_from_file_location(
            "serving_predictor_example",
            os.path.join(ex_dir, "serving_predictor.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(ex_dir)
    return mod


def test_serving_predictor_example_flow_on_the_port():
    ex = _example()
    rng = np.random.RandomState(0)
    docs, labels = ex.synthesize_corpus(512, rng)
    tok = SentenceTokenizer()
    vocab = Dictionary([tok.tokenize(d) for d in docs])

    def vectorize(texts):
        out = np.zeros((len(texts), ex.SEQ), np.float32)
        for i, d in enumerate(texts):
            ids = [vocab.get_index(w) + 1 for w in tok.tokenize(d)][:ex.SEQ]
            out[i, :len(ids)] = ids
        return out

    x = vectorize(docs)
    np.testing.assert_array_equal(x, ex.vectorize(docs, vocab))
    torch.manual_seed(0)
    model = tnn.Sequential(
        tnn.LookupTable(vocab.get_vocab_size() + 1, ex.EMB),
        tnn.TemporalConvolution(ex.EMB, 32, 3), tnn.ReLU(),
        tnn.TemporalMaxPooling(ex.SEQ - 2, 1), tnn.Squeeze(2),
        tnn.Linear(32, len(ex.CLASSES)), tnn.LogSoftMax())
    (LocalOptimizer(model, (x, labels), tnn.ClassNLLCriterion(),
                    batch_size=32, device="cpu")
     .set_optim_method(Adam(learning_rate=2e-3))
     .set_end_when(Trigger.max_epoch(4))).optimize()

    rows = ["the church doctrine and secular belief",
            "render the texture with a new shader driver",
            "the brake and the gearbox of the sedan",
            "image pixel polygon graphics"]
    service = PredictionService(model)
    qmodel = model.quantize(calibration_data=[x[:64]])
    qservice = PredictionService(qmodel)
    try:
        def classify(text, svc=service):
            scores = np.asarray(svc.predict(vectorize([text])))[0]
            return ex.CLASSES[int(scores.argmax())]

        predicted = [classify(r) for r in rows]
        with cf.ThreadPoolExecutor(4) as pool:
            results = list(pool.map(classify, rows))
        assert results == predicted
        expected = ["alt.atheism", "comp.graphics", "rec.autos",
                    "comp.graphics"]
        assert sum(a == b for a, b in zip(results, expected)) >= 3, results
        # the int8 half: calibrated, so no per-request |x| reduction
        qlin = [m for m in qmodel.modules()
                if isinstance(m, tq.QuantizedLinear)]
        assert len(qlin) == 1 and qlin[0].act_absmax is not None
        assert [classify(r, qservice) for r in rows] == results
    finally:
        service.shutdown()
        qservice.shutdown()
