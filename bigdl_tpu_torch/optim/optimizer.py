"""The training loop (≙ ``bigdl_tpu/optim/optimizer.py``): the train
step, gradient accumulation and the ``Optimizer`` / ``LocalOptimizer``
host loop.

The reference's step is functional: ``jax.value_and_grad`` of a loss of
the params, jitted with its buffers donated.  Here the step runs eagerly
and the gradients come from ``torch.autograd.grad`` over the leaves of
the param dict, so nothing is left in ``.grad`` and the returned
gradients have the param dict's structure; the optimizer then updates the
parameters in place (the counterpart of donation).

``LocalOptimizer`` trains on one device (``cuda`` unless the caller
passes ``device="cpu"``): per batch, the copy of the host arrays to the
device, one step, the iteration and epoch counters and the end trigger.
The loss stays on the device until the epoch ends.  A live train→serve
weight stream attaches with ``set_weight_stream``.  Not ported yet
(ROADMAP queue A, item 10): validation, checkpoints, telemetry and
health, retries, the trace context, prefetch and the device loader,
device augment, gradient accumulation, clipping, mixed precision,
regularizers and ``freeze``; each ``set_*`` of those raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..data.dataset import DataSet
from ..kernels.fused_optim import zip_leaves
from ..nn.module import Ctx
from .optim_method import SGD, OptimMethod
from .trigger import Trigger, _MaxEpoch


@dataclass
class TrainingState:
    epoch: int = 1
    iteration: int = 0
    loss: Optional[float] = None
    score: Optional[float] = None
    epoch_finished: bool = False
    batch_in_epoch: int = 0      # completed batches within current epoch


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return next(it)
    return build(like)


def _value_and_grad(loss_fn, params, model_state, x, y):
    """((loss, new_state), grads as a flat list in leaf order)"""
    loss, new_state = loss_fn(params, model_state, x, y)
    leaves = [p for (p,) in zip_leaves(params)]
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), new_state), list(grads)


def make_accum_grads(loss_fn, n_accum: int, weight_fn=None):
    """Microbatch gradient accumulation.

    ``loss_fn(params, model_state, x, y) -> (loss, new_state)``.  Returns
    ``grads_fn(params, model_state, x, y) -> ((mean_loss, merged_state),
    mean_grads)`` that runs ``n_accum`` microbatches in order (model state
    threaded from one to the next); ``n_accum < 2`` is one value-and-grad.

    Microbatch ``i`` takes rows ``{j * n_accum + i}`` of ``x`` and ``y``,
    the reference's strided split.  ``weight_fn(x, y) -> scalar`` weights
    each microbatch's loss and gradients (the result is divided by the
    total weight): needed when ``loss_fn`` is a masked mean, as a token
    cross-entropy with padding is.  Default: equal weights.  The
    accumulators are fp32.
    """
    if n_accum < 2:
        def direct(params, model_state, x, y):
            aux, grads = _value_and_grad(loss_fn, params, model_state, x, y)
            return aux, _unflatten(params, grads)
        return direct

    def split(a):
        b = a.shape[0]
        if b % n_accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_accum={n_accum}")
        return a.reshape((b // n_accum, n_accum) + tuple(a.shape[1:])) \
            .movedim(1, 0)

    def grads_fn(params, model_state, x, y):
        xs, ys = split(x), split(y)
        leaves = [p for (p,) in zip_leaves(params)]
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        dev = leaves[0].device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        w_acc = torch.zeros((), dtype=torch.float32, device=dev)
        state = dict(model_state)
        for xi, yi in zip(xs, ys):
            w = (torch.ones((), dtype=torch.float32, device=dev)
                 if weight_fn is None
                 else weight_fn(xi, yi).to(torch.float32))
            (loss, upd), grads = _value_and_grad(loss_fn, params, state,
                                                 xi, yi)
            state = {**state, **upd}
            g_acc = [a + w * g for a, g in zip(g_acc, grads)]
            loss_acc = loss_acc + w * loss
            w_acc = w_acc + w
        w_acc = torch.clamp(w_acc, min=1e-8)
        grads = _unflatten(params, [g / w_acc for g in g_acc])
        return (loss_acc / w_acc, state), grads

    return grads_fn


def make_train_step(model, criterion, optim_method: OptimMethod):
    """The train step ``step(params, opt_state, model_state, x, y) ->
    (params, opt_state, model_state, loss)``: the forward in training mode,
    ``criterion.loss`` on the fp32 output plus the side losses and
    ``model.regularization_loss``, the gradients over the param dict's
    leaves, and ``optim_method.update`` (in place).  The returned model
    state is ``model_state`` with the forward's new state merged in; the
    loss is a device tensor."""

    def loss_fn(params, model_state, x, y):
        ctx = Ctx(state=model_state, training=True)
        out = model.apply(params, x, ctx)
        if torch.is_floating_point(out):
            out = out.float()
        loss = criterion.loss(out, y)
        for sl in ctx.side_losses:
            loss = loss + sl
        loss = loss + model.regularization_loss(params)
        return loss, ctx.new_state

    def step(params, opt_state, model_state, x, y):
        (loss, updates), grads = _value_and_grad(loss_fn, params,
                                                 model_state, x, y)
        params, opt_state = optim_method.update(_unflatten(params, grads),
                                                params, opt_state)
        merged = dict(model_state)
        merged.update(updates)
        return params, opt_state, merged, loss

    return step


# set_* of the reference that are not ported: name -> what it sets
_UNPORTED_SETTERS = {
    "set_validation": "validation (validation.py, Evaluator)",
    "set_checkpoint": "checkpointing",
    "set_train_summary": "training summaries",
    "set_val_summary": "validation summaries",
    "set_gradient_accumulation": "gradient accumulation in LocalOptimizer",
    "set_mixed_precision": "mixed precision (bf16 autocast, fp32 master "
                           "weights)",
    "set_prefetch": "prefetch (DeviceLoader, pinned non_blocking H2D)",
    "set_device_augment": "device-side augmentation",
    "set_telemetry": "telemetry",
    "set_trace_context": "the trace context",
    "set_trace_every": "profiler traces",
    "set_health": "training health",
    "set_auto_retry": "retries",
    "set_gradient_clipping_by_l2_norm": "gradient clipping",
    "set_constant_gradient_clipping": "gradient clipping",
}


class Optimizer:
    """The host training loop on one device (≙ the reference's
    ``Optimizer``): ``training_set`` is a :class:`DataSet` whose ``data``
    yields ``MiniBatch`` es, or an ``(x, y)`` pair of arrays (then
    ``batch_size`` is required; labels 1-based as
    ``ClassNLLCriterion`` takes them).  The default method is ``SGD()``,
    the default end one epoch.

    :meth:`optimize` trains the model's current parameters (in place) and
    its current batch-norm state (written back at the end); it does not
    redraw them.  ``seed`` other than 0 raises: the reference's seed draws
    the initial parameters (here the model's own are taken) and the steps'
    random keys (no ported layer draws any)."""

    def __init__(self, model, training_set, criterion,
                 batch_size: Optional[int] = None, seed: int = 0, *,
                 device: DeviceLike = None):
        if isinstance(training_set, tuple):
            x, y = training_set
            if batch_size is None:
                raise ValueError("batch_size required for array data")
            training_set = DataSet.minibatch_arrays(x, y, batch_size)
        if seed != 0:
            raise NotImplementedError(
                f"{type(self).__name__}: seed={seed!r} seeds nothing yet: "
                f"the parameters are the model's own (build(seed=)) and no "
                f"ported layer draws random numbers in a step (ROADMAP "
                f"queue A, item 10)")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.model = model
        self.dataset: DataSet = training_set
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.state = TrainingState()
        self._weight_stream = None

    # -- fluent config, reference API ----------------------------------- #
    def set_optim_method(self, method):
        self.optim_method = method
        return self

    def set_end_when(self, trigger):
        self.end_when = trigger
        return self

    def set_weight_stream(self, publisher):
        """Attach a live train→serve weight stream
        (:class:`~bigdl_tpu_torch.serving.WeightStreamPublisher`): its
        trigger is evaluated against the training state after every
        iteration and, on fire, the current parameters are snapshotted
        (owning copies on their device: the next step updates them in
        place) and published through the canary gate off the step loop.
        ``None`` detaches."""
        self._weight_stream = publisher
        return self

    # -- main loop ------------------------------------------------------- #
    def _place_batch(self, x, y):
        """The host batch copied to the optimizer's device."""
        return tuple(None if a is None else torch.as_tensor(
            np.asarray(a)).to(self.device) for a in (x, y))

    def optimize(self):
        params = self.model.param_dict()
        bad = sorted({str(p.device) for (p,) in zip_leaves(params)
                      if p.device != self.device})
        if bad:
            raise ValueError(f"{type(self).__name__}: the model's parameters"
                             f" are on {bad}, the optimizer's device is "
                             f"{self.device}; move the model first")
        model_state = self.model.initial_state()
        opt_state = self.optim_method.init_state(params)
        step_fn = make_train_step(self.model, self.criterion,
                                  self.optim_method)
        stop = False
        while not stop:
            params, opt_state, model_state, stop = self._run_epoch(
                params, opt_state, model_state, step_fn)
        self.model.set_state(model_state)
        return self.model

    def _run_epoch(self, params, opt_state, model_state, step_fn):
        """One epoch; returns the updated carry and whether to stop."""
        stop = False
        st = self.state
        st.epoch_finished = False
        st.batch_in_epoch = 0
        epoch_start = time.time()
        n_seen = 0
        for mb in self.dataset.data(train=True, epoch=st.epoch):
            size = mb.size()
            x, y = self._place_batch(mb.get_input(), mb.get_target())
            params, opt_state, model_state, loss = step_fn(
                params, opt_state, model_state, x, y)
            st.iteration += 1
            st.batch_in_epoch += 1
            # kept on the device: a float() here would sync the host with
            # the device every step
            st.loss = loss
            n_seen += size
            if self._weight_stream is not None:
                # the snapshot is taken inside, synchronously (owning
                # copies); the publish rides the stream's worker thread
                self._weight_stream.maybe_publish(params, state=st)
            if self._fire_mid_epoch():
                stop = True
                break
        else:
            st.epoch_finished = True
            if n_seen == 0:
                raise ValueError(
                    "dataset produced no batches (batch_size larger "
                    "than the dataset with drop_last, or empty data)")
            st.loss = float(st.loss)
            dur = time.time() - epoch_start
            print(f"[epoch {st.epoch}] loss={st.loss:.4f} ({n_seen} samples "
                  f"in {dur:.1f}s, {n_seen / max(dur, 1e-9):.1f}/s)")
            st.epoch += 1
            st.batch_in_epoch = 0
            if self.end_when(st):
                stop = True
        return params, opt_state, model_state, stop

    def _fire_mid_epoch(self) -> bool:
        """Iteration-level triggers, after each step; True ends training
        (an epoch-count end trigger is read at the epoch's end)."""
        return (not isinstance(self.end_when, _MaxEpoch)
                and self.end_when(self.state))


def _unported_setter(name, what):
    def setter(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}.{name}: {what} is not ported yet "
            f"(ROADMAP queue A, item 10)")
    setter.__name__ = name
    return setter


for _name, _what in _UNPORTED_SETTERS.items():
    setattr(Optimizer, _name, _unported_setter(_name, _what))


class LocalOptimizer(Optimizer):
    """Training on one device (≙ the reference's ``LocalOptimizer``: its
    multi-threaded subbatching is one step on the device here)."""
