"""Inference entry points (≙ ``bigdl_tpu/optim/predictor.py``): ``Predictor``
(``predict``, ``predict_class``), ``Evaluator.test`` and the serving
facade ``PredictionService``.

One batched forward in inference mode (``make_eval_step``) on the
model's device, over an array, a list of ``Sample`` s (stacked by
``samples_to_minibatch``) or a DataSet; class prediction adds argmax + 1
(1-based labels, as the reference's).  ``Evaluator`` streams
``ValidationMethod`` s over a dataset and merges their results.
``PredictionService`` serves arrays through a ``ModelRegistry`` and a
batching ``ServingEngine``, and any other input through one shared
``Predictor`` behind a lock.  An ``ImageFrame`` input raises: the image
frame is ROADMAP queue A, item 9.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .._device import model_device
from ..data.dataset import DataSet
from ..data.minibatch import Sample, samples_to_minibatch
from .optimizer import evaluate, make_eval_step, to_device
from .validation import ValidationMethod


class Predictor:
    def __init__(self, model, batch_size: int = 128):
        self.model = model
        self.batch_size = batch_size
        self._step = make_eval_step(model)

    def predict(self, data):
        """``data``: an array, a list of ``Sample`` s or a DataSet -> the
        stacked outputs (numpy)."""
        dev = model_device(self.model)
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
        dev = model_device(self.model)
        params, state = self.model.param_dict(), self.model.initial_state()
        if isinstance(dataset, tuple):
            x, y = dataset
            dataset = DataSet.minibatch_arrays(x, y, self.batch_size,
                                               shuffle=False, drop_last=False)
        return evaluate(self._step, params, state, dataset, methods, dev)


class PredictionService:
    """The serving facade (≙ optim/PredictionService.scala, rebased as the
    reference's on ``serving``): concurrent ``predict`` calls on arrays
    coalesce into power-of-two micro-batches of a ``ServingEngine`` over a
    ``ModelRegistry`` snapshot, so ``sync_weights`` in the middle of
    traffic is atomic.  ``input_shape`` (one sample's feature shape)
    warms every bucket up front.  Any other input (a list of ``Sample`` s,
    a DataSet) goes to one lazily built ``Predictor`` behind a lock.
    ``num_threads`` is kept for the reference's signature."""

    def __init__(self, model, num_threads: int = 1, *, input_shape=None,
                 max_batch: int = 32, max_delay_ms: float = 2.0,
                 max_queue_rows: int = 256, recorder=None):
        from ..serving import ModelRegistry, ServingEngine
        self.model = model
        self.registry = ModelRegistry()
        self.registry.register("default", model, input_shape=input_shape)
        self.engine = ServingEngine(
            self.registry, max_batch=max_batch, max_delay_ms=max_delay_ms,
            max_queue_rows=max_queue_rows, recorder=recorder)
        if input_shape is not None:
            self.engine.warmup()
        self._fallback = None
        self._fallback_lock = threading.Lock()

    def predict(self, x, timeout=None, deadline_ms=None):
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            # one shared Predictor, its host-side state never raced
            with self._fallback_lock:
                if self._fallback is None:
                    self._fallback = Predictor(self.model)
                return self._fallback.predict(x)
        return self.engine.predict("default", _host_array(x),
                                   timeout=timeout, deadline_ms=deadline_ms)

    def submit(self, x, deadline_ms=None):
        """An asynchronous request (one sample or a batch) -> Future."""
        return self.engine.submit("default", _host_array(x),
                                  deadline_ms=deadline_ms)

    def sync_weights(self, version=None):
        """Republish after the module's weights changed in place
        (``set_weights``, training): an atomic hot swap."""
        return self.registry.sync_from_model("default", version=version)

    def shutdown(self, drain: bool = True):
        self.engine.shutdown(drain=drain)


def _host_array(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _iter_inputs(data, batch_size):
    if type(data).__name__ == "ImageFrame":
        raise TypeError("predict over an ImageFrame: the image frame is not "
                        "ported yet (ROADMAP queue A, item 9)")
    if isinstance(data, DataSet):
        for mb in data.data(train=False):
            yield mb.get_input()
    elif isinstance(data, np.ndarray) or hasattr(data, "shape"):
        for i in range(0, data.shape[0], batch_size):
            yield data[i:i + batch_size]
    elif isinstance(data, (list, tuple)) and data \
            and isinstance(data[0], Sample):
        for i in range(0, len(data), batch_size):
            yield samples_to_minibatch(list(data[i:i + batch_size])) \
                .get_input()
    else:
        raise TypeError(f"unsupported predict input {type(data)}")
