"""Inference entry points (≙ ``bigdl_tpu/optim/predictor.py``): ``Predictor``
(``predict``, ``predict_class``) and ``Evaluator.test``.

One batched forward in inference mode (``make_eval_step``) on the
model's device; class prediction adds argmax + 1 (1-based labels, as the
reference's).  ``Evaluator`` streams ``ValidationMethod`` s over a
dataset and merges their results.  ``PredictionService`` (the reference
rebases it on ``serving``) waits for the rest of the serving facade and
the Sample path (ROADMAP queue A, items 8 and 9).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.dataset import DataSet
from ..kernels.fused_optim import zip_leaves
from .optimizer import evaluate, make_eval_step, to_device
from .validation import ValidationMethod


def _device(model):
    for (p,) in zip_leaves(model.param_dict()):
        return p.device
    raise ValueError(f"{type(model).__name__} has no parameters")


class Predictor:
    def __init__(self, model, batch_size: int = 128):
        self.model = model
        self.batch_size = batch_size
        self._step = make_eval_step(model)

    def predict(self, data):
        """``data``: an array or a DataSet -> the stacked outputs (numpy)."""
        dev = _device(self.model)
        params, state = self.model.param_dict(), self.model.initial_state()
        outs = [self._step(params, state, to_device(x, dev)).float().cpu()
                .numpy() for x in _iter_inputs(data, self.batch_size)]
        return np.concatenate(outs, axis=0)

    def predict_class(self, data):
        scores = self.predict(data)
        if scores.ndim == 1 or scores.shape[-1] == 1:
            return (scores.reshape(-1) > 0.5).astype(np.int32) + 1
        return np.argmax(scores, axis=-1) + 1


LocalPredictor = Predictor


class Evaluator:
    """``Evaluator(model).test(dataset, methods)``: ``[(method, result)]``
    over ``dataset`` (a DataSet, or an ``(x, y)`` pair cut into batches of
    ``batch_size`` in order)."""

    def __init__(self, model, batch_size: int = 128):
        self.model = model
        self.batch_size = batch_size
        self._step = make_eval_step(model)

    def test(self, dataset, methods: Sequence[ValidationMethod]):
        dev = _device(self.model)
        params, state = self.model.param_dict(), self.model.initial_state()
        if isinstance(dataset, tuple):
            x, y = dataset
            dataset = DataSet.minibatch_arrays(x, y, self.batch_size,
                                               shuffle=False, drop_last=False)
        return evaluate(self._step, params, state, dataset, methods, dev)


def _iter_inputs(data, batch_size):
    if isinstance(data, DataSet):
        for mb in data.data(train=False):
            yield mb.get_input()
    elif isinstance(data, np.ndarray) or hasattr(data, "shape"):
        for i in range(0, data.shape[0], batch_size):
            yield data[i:i + batch_size]
    else:
        raise TypeError(f"unsupported predict input {type(data)} (Samples "
                        f"are ROADMAP queue A, item 10)")
