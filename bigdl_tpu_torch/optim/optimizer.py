"""The training loop (≙ ``bigdl_tpu/optim/optimizer.py``): the train
and eval steps, gradient accumulation, clipping, frozen gradients and the
``Optimizer`` / ``LocalOptimizer`` host loop.

The reference's step is functional: ``jax.value_and_grad`` of a loss of
the params, jitted with its buffers donated.  Here the step runs eagerly
and the gradients come from ``torch.autograd.grad`` over the leaves of
the param dict, so nothing is left in ``.grad`` and the returned
gradients have the param dict's structure; the optimizer then updates the
parameters in place (the counterpart of donation).

``LocalOptimizer`` trains on one device (``cuda`` unless the caller
passes ``device="cpu"``): per batch, the copy of the host arrays to the
device, one step, the iteration and epoch counters and the end trigger.
The loss stays on the device until the epoch ends.  ``set_mixed_precision``
runs the step on bf16 inputs over fp32 parameters; ``set_prefetch`` stages
batches ahead on a background thread (``data.device_loader``: pinned
buffers, a side stream, an event the step waits on); ``set_validation``
evaluates ``ValidationMethod`` s when its trigger fires;
``set_device_augment`` runs a crop / flip / normalize on the device in
the step (uint8 on the wire), drawing from the loop's generator, which
``seed`` seeds; ``set_gradient_accumulation`` splits each batch into
microbatches for one update; ``set_gradient_clipping_by_l2_norm`` and
``set_constant_gradient_clipping`` clip the gradients before the update;
``Module.freeze`` zeroes the frozen modules' gradients; a ``Plateau``
schedule reads the epoch's score at each epoch's end.  A live train→serve
weight stream attaches with ``set_weight_stream``.

The loop features (≙ the reference's ``optimizer.py:433–1035``):
``set_checkpoint`` (``bigdl_tpu_torch.checkpoint``: an owning host
snapshot on the loop, the write on a background thread; an exact resume
in the middle of an epoch, the skip taken at the dataset before anything
is staged; a final checkpoint on SIGTERM), ``set_telemetry`` (a step
record a step, with :func:`health_scalars` computed in the step, read in
one host sync; the first step's cost captured for ``perf/mfu`` and live
device-memory gauges), ``set_health`` (the sentinels, a ``rollback``
policy restoring the last committed checkpoint, the flight recorder, the
stall watchdog), ``set_trace_every`` (a ``torch.profiler`` Chrome trace
of every n-th step), ``serve_metrics`` (the live ``/metrics``,
``/healthz`` and ``/records`` server), ``set_auto_retry`` and
``set_trace_context``.
``set_train_summary`` writes Loss and LearningRate an iteration (under
each tag's trigger), Throughput an epoch and, behind their trigger,
Parameters histograms; ``set_val_summary`` each validation method's
result (``bigdl_tpu_torch.visualization``, real tfevents files).
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..data.dataset import DataSet
from ..data.device_loader import DeviceLoader, HostToDevice
from ..kernels.fused_optim import zip_leaves
from ..nn.module import Ctx
from ..observability.recorder import Recorder
from ..parallel.allreduce import tree_leaves, tree_map, tree_paths
from .optim_method import SGD, OptimMethod
from .trigger import Trigger, _EveryEpoch, _MaxEpoch


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


def mask_frozen_grads(model, grads):
    """``grads`` with the gradients of the modules frozen by
    ``Module.freeze`` replaced by zeros."""
    frozen = model.frozen_param_names()
    if not frozen:
        return grads
    return {name: ({k: torch.zeros_like(g) for k, g in sub.items()}
                   if name in frozen else sub)
            for name, sub in grads.items()}


def _add_regularization(model, params, loss, grads):
    """``(loss + reg, grads + d reg / d params)`` for the model's per-layer
    regularizers: the accumulated step adds them once, outside the
    microbatch loop, as the reference does."""
    reg = model.regularization_loss(params)
    if not isinstance(reg, torch.Tensor):
        return loss, grads
    leaves = [p for (p,) in zip_leaves(params)]
    reg_grads = torch.autograd.grad(reg, leaves, allow_unused=True)
    flat = [g if r is None else g + r
            for (g,), r in zip(zip_leaves(grads), reg_grads)]
    return loss + reg.detach(), _unflatten(params, flat)


def to_bf16(x):
    """``x`` (a tensor, or a tuple or list of them) with every floating
    tensor cast to bf16: the mixed-precision step's input cast."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_bf16(a) for a in x)
    if isinstance(x, torch.Tensor) and torch.is_floating_point(x):
        return x.to(torch.bfloat16)
    return x


def _identity(tree):
    return tree


def _flat_f32(leaves):
    """The leaves as one flat fp32 tensor (an owning copy: ``cat`` always
    copies, so a snapshot taken before an in-place update keeps the old
    values)."""
    if not leaves:
        return None
    return torch.cat([t.detach().reshape(-1).float() for t in leaves])


def health_scalars(grads, old_params, new_params, group=None,
                   sharded_mask=None):
    """Training-health scalars, fp32 device tensors computed in the step
    (≙ the reference's ``health_scalars``): the gradients' global L2 norm
    ``grad_norm``, the updated parameters' ``param_norm``, the update's
    ``update_norm``, ``update_ratio = update_norm / max(param_norm,
    1e-12)`` and ``nonfinite_grads``, the count of NaN/Inf gradient
    elements.

    Each sum runs over one flat copy of its leaves (a few launches
    whatever the leaf count).  With ``group``, the leaves ``sharded_mask``
    marks (every leaf when it is None) are shards of global tensors:
    their sums are all-reduced in one collective and the replicated
    leaves counted once, so every rank sees the global values (fsdp,
    zero1)."""
    mask = _mask_of(grads, sharded_mask)
    return _health(tree_leaves(grads), _split_flat(tree_leaves(old_params),
                                                   mask),
                   tree_leaves(new_params), mask, group)


def _mask_of(tree, sharded_mask):
    if sharded_mask is None:
        return [True] * len(tree_leaves(tree))
    return [bool(m) for m in tree_leaves(sharded_mask)]


def _split_flat(leaves, mask):
    """Flat fp32 copies of the sharded and of the replicated leaves."""
    return [_flat_f32([t for t, m in zip(leaves, mask) if m == want])
            for want in (True, False)]


def _health(g_l, old, n_l, mask, group):
    dev = g_l[0].device
    sums = []
    for k, want in enumerate((True, False)):
        sel = [i for i, m in enumerate(mask) if m == want]
        if not sel:
            sums.append(torch.zeros(4, dtype=torch.float32, device=dev))
            continue
        g = _flat_f32([g_l[i] for i in sel])
        p = _flat_f32([n_l[i] for i in sel])
        sums.append(torch.stack([
            torch.sum(g * g), torch.sum(p * p),
            torch.sum(torch.square(p - old[k])),
            torch.sum(~torch.isfinite(g)).to(torch.float32)]))
    sharded, replicated = sums
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(sharded, group=group)
    tot = sharded + replicated
    gn, pn, un = torch.sqrt(tot[:3]).unbind()
    return {"grad_norm": gn, "param_norm": pn, "update_norm": un,
            "update_ratio": un / torch.clamp(pn, min=1e-12),
            "nonfinite_grads": tot[3]}


class _HealthProbe:
    """What a telemetry step needs for the health scalars: the tensors
    the update writes (``update_params(params)``: the parameters, or
    zero1's shard masters), their mask of shards and the group.
    :meth:`before` copies them flat ahead of the in-place update."""

    def __init__(self, update_params=_identity, group=None,
                 sharded_mask=None):
        self.update_params = update_params
        self.group = group
        self.sharded_mask = sharded_mask

    def before(self, params):
        upd = self.update_params(params)
        return _split_flat(tree_leaves(upd),
                           _mask_of(upd, self.sharded_mask))

    def after(self, grads, params, before):
        return _health(tree_leaves(grads), before,
                       tree_leaves(self.update_params(params)),
                       _mask_of(grads, self.sharded_mask), self.group)


def make_train_step(model, criterion, optim_method: OptimMethod,
                    mixed_precision: bool = False, *, n_accum: int = 1,
                    device_augment=None, generator=None, gather=_identity,
                    exchange=_identity, pmean=_identity, health=None):
    """The train step ``step(params, opt_state, model_state, x, y) ->
    (params, opt_state, model_state, loss)``: the forward in training mode,
    ``criterion.loss`` on the fp32 output plus the side losses and
    ``model.regularization_loss``, the gradients over the param dict's
    leaves (the frozen modules' zeroed, :func:`mask_frozen_grads`), and
    ``optim_method.update`` (in place).  The returned model state is
    ``model_state`` with the forward's new state merged in; the loss is a
    device tensor.

    ``mixed_precision``: the floating inputs are cast to bf16 and every
    layer casts its fp32 weights to the input's dtype, so the forward and
    backward run in bf16; the output is cast to fp32 before the
    criterion.  The parameters, their gradients and the optimizer state
    stay fp32 (the reference's ``make_train_step(mixed_precision=True)``).

    ``device_augment(x, generator)`` (a
    :class:`~bigdl_tpu_torch.data.device_augment.DeviceAugment`) runs on
    the batch first, drawing from ``generator``; the model's random
    layers (dropout) draw from it after, through the step's ``Ctx``.  ``n_accum`` > 1 splits
    the batch into that many microbatches (:func:`make_accum_grads`) for
    one update on their mean gradient; the regularizers' loss and
    gradient are then added once, outside the loop
    (:func:`make_accum_train_step`).

    The data-parallel hooks (``DistriOptimizer``'s; the identity by
    default): ``gather(params)`` gives the parameters the forward runs
    on (fsdp's all-gather of its shards), ``exchange(grads)`` the
    gradients ``optim_method.update`` takes (their mean over the ranks,
    or this rank's shards of it), and ``pmean`` averages the loss and the
    forward's new state over the ranks.  Accumulation runs before the
    exchange: one exchange a step, whatever ``n_accum`` is.

    ``health`` (a :class:`_HealthProbe`, the telemetry step's) appends
    :func:`health_scalars` of the exchanged gradients and the update to
    the returned tuple.
    """
    grads_fn = make_accum_grads(
        make_loss_fn(model, criterion, regularize=n_accum < 2,
                     generator=generator), n_accum)

    def step(params, opt_state, model_state, x, y):
        if device_augment is not None:
            x = device_augment(x, generator)
        if mixed_precision:
            x = to_bf16(x)
        full = gather(params)
        (loss, updates), grads = grads_fn(full, model_state, x, y)
        if n_accum >= 2:
            loss, grads = _add_regularization(model, full, loss, grads)
        grads = exchange(mask_frozen_grads(model, grads))
        before = None if health is None else health.before(params)
        params, opt_state = optim_method.update(grads, params, opt_state)
        merged = dict(model_state)
        merged.update(pmean(updates))
        if health is None:
            return params, opt_state, merged, pmean(loss)
        return (params, opt_state, merged, pmean(loss),
                health.after(grads, params, before))

    return step


def make_accum_train_step(model, criterion, optim_method: OptimMethod,
                          n_accum: int, mixed_precision: bool = False,
                          device_augment=None, generator=None):
    """The gradient-accumulation step (≙ the reference's
    ``make_accum_train_step``): :func:`make_train_step` with ``n_accum``
    microbatches a batch and one update on their mean gradient."""
    return make_train_step(model, criterion, optim_method, mixed_precision,
                           n_accum=n_accum, device_augment=device_augment,
                           generator=generator)


def make_loss_fn(model, criterion, regularize: bool = True,
                 generator=None):
    """``loss_fn(params, model_state, x, y) -> (loss, new_state)``: the
    training-mode forward (its random layers drawing from ``generator``),
    the criterion on the fp32 output, the side losses and (with
    ``regularize``) the regularization loss."""

    def loss_fn(params, model_state, x, y):
        ctx = Ctx(state=model_state, training=True, generator=generator)
        out = model.apply(params, x, ctx)
        if torch.is_floating_point(out):
            out = out.float()
        loss = criterion.loss(out, y)
        for sl in ctx.side_losses:
            loss = loss + sl
        if regularize:
            loss = loss + model.regularization_loss(params)
        return loss, ctx.new_state

    return loss_fn


def make_eval_step(model, device_augment=None):
    """``step(params, model_state, x) -> output``: the forward in
    inference mode (running statistics), without autograd, on the inputs
    as given (validation does not cast to bf16, as in the reference), or
    as ``device_augment`` gives them in eval mode (its center crop and
    normalization)."""

    @torch.no_grad()
    def step(params, model_state, x):
        if device_augment is not None:
            x = device_augment(x, None, training=False)
        return model.apply(params, x, Ctx(state=model_state,
                                          training=False))
    return step


class _ClippedOptim(OptimMethod):
    """Gradient clipping around an optimization method (≙ the
    reference's ``_ClippedOptim``, Optimizer.setGradientClipping*):
    ``clip_const = (lo, hi)`` clamps every element, then ``clip_norm``
    scales the gradients by ``min(1, clip_norm / max(‖g‖₂, 1e-12))``.  The
    norm and the scale are fp32 device scalars (no host sync), and the
    scaled gradients are what the inner update (K5/K6/K4 when fused)
    reads.

    Under data parallelism the norm is the global one: with ``group``,
    the squares of the leaves that ``sharded_mask`` marks (every leaf
    when it is None: zero1's shard space) are summed over the ranks and
    the replicated leaves counted once (fsdp).  :attr:`last_norm` is the
    last update's norm before clipping."""

    def __init__(self, inner, clip_norm=None, clip_const=None, group=None,
                 sharded_mask=None):
        self.inner = inner
        self.clip_norm = clip_norm
        self.clip_const = clip_const
        self.group = group
        self.sharded_mask = sharded_mask
        self.last_norm = None

    def init_state(self, params):
        return self.inner.init_state(params)

    def get_learning_rate(self, state):
        return self.inner.get_learning_rate(state)

    def _sum_sq(self, grads):
        """Σ g² over the leaves in fp32, over the ranks as the class
        docstring says."""
        leaves = tree_leaves(grads)
        mask = [True] * len(leaves) if self.sharded_mask is None \
            else tree_leaves(self.sharded_mask)
        zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        sharded, replicated = (
            sum((torch.sum(g.float() ** 2) for g, m in zip(leaves, mask)
                 if m == want), zero) for want in (True, False))
        if self.group is not None:
            import torch.distributed as dist
            sharded = sharded.reshape(1)
            dist.all_reduce(sharded, group=self.group)
            sharded = sharded.reshape(())
        return sharded + replicated

    def update(self, grads, params, state):
        if self.clip_const is not None:
            lo, hi = self.clip_const
            grads = tree_map(lambda g: torch.clamp(g, lo, hi), grads)
        if self.clip_norm is not None:
            total = torch.sqrt(self._sum_sq(grads))
            self.last_norm = total
            scale = torch.clamp(self.clip_norm / torch.clamp(total,
                                                             min=1e-12),
                                max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        return self.inner.update(grads, params, state)


def evaluate(step, params, model_state, dataset: DataSet, methods, device):
    """``[(method, result)]``: each of ``methods`` over the eval ``step``'s
    outputs on ``dataset``'s batches (inputs placed on ``device``), the
    batches' results merged."""
    results = [None] * len(methods)
    for mb in dataset.data(train=False):
        out = step(params, model_state, to_device(mb.get_input(), device))
        for i, method in enumerate(methods):
            r = method(out, mb.get_target())
            results[i] = r if results[i] is None else results[i] + r
    return list(zip(methods, results))


def to_device(a, device):
    """A host array (or a tensor) as a tensor on ``device``; a tuple or
    list of them (a two-tower's ``(uids, mids)``) element by element."""
    if isinstance(a, (tuple, list)):
        return type(a)(to_device(e, device) for e in a)
    return a.to(device) if isinstance(a, torch.Tensor) else \
        torch.as_tensor(np.asarray(a)).to(device)


def batch_rows(x) -> int:
    """The leading size of a batch input (its first array's, for a tuple
    or list of them)."""
    while isinstance(x, (tuple, list)):
        x = x[0]
    return int(x.shape[0])


def _host_tree(tree, device):
    """Host arrays (numpy) of a restored tree as new tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _host_tree(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree)).to(device)


def _like(cur, host):
    """New tensors of ``cur``'s devices and dtypes from the host arrays
    of ``host`` (the same structure)."""
    return tree_map(lambda c, h: torch.as_tensor(np.array(h)).to(
        c.device, c.dtype), cur, host)


def _shapes(tree):
    """``{path: shape}`` of a tree's leaves (tensors or arrays)."""
    return {p: tuple(np.shape(v)) for p, v in
            zip(tree_paths(tree), tree_leaves(tree))}


class TelemetryHealth:
    """The telemetry, tracing and health wiring that :class:`Optimizer`
    and :class:`~bigdl_tpu_torch.parallel.SpmdTrainer` share: the
    recorder and its goodput ledger, the step cost capture and the memory
    poller, profiler traces, the introspection server, the trace context,
    the health monitor with its flight recorder and stall watchdog, and
    the rollback policy.  Each trainer emits its own step records,
    captures its own step's cost and restores its own checkpoints."""

    def _init_telemetry(self):
        # spans and counters; step records under set_telemetry
        self.recorder = Recorder()
        self._telemetry = False
        self._telemetry_health = True
        self._trace_ctx = None
        self._tracer = None
        self._health_monitor = None
        self._flight = None
        self._watchdog = None
        self._max_rollbacks = 2
        self._capture_cost = True
        self._cost_pending = False      # set_telemetry arms the capture
        self._trace_only = False        # telemetry on for set_trace_every
        self._http_server = None

    def set_telemetry(self, recorder: Recorder, health: bool = True,
                      capture_cost: bool = True):
        """Attach ``recorder``: every step emits one step record (spans
        such as ``h2d`` and ``train_step``; scalars ``loss``,
        ``records``, and with ``health`` the device-side
        :func:`health_scalars`), read with one host sync a step.  The
        recorder also takes the trainer's counters (``checkpoint/*``,
        and the optimizer's ``dataloader/*`` and ``collective/*``), and
        a goodput ledger is attached when it has none.

        ``capture_cost`` counts the first step's work (one forward and
        backward under the FLOP counter, the attention kernels' work by
        formula: ``observability.profile.capture_step``; no update, no
        draw from the trainer's generators, no hand-kernel launch) so
        that every step record carries ``perf/mfu``,
        ``perf/hbm_bw_util`` and ``mem/peak_hbm_bytes``, and installs the
        live ``mem/device.*`` gauge poller.  ``capture_cost=False`` and
        ``BIGDL_PROFILE_CAPTURE=0`` turn both off."""
        from ..observability.profile import (capture_enabled,
                                             install_device_memory_poller)
        self.recorder = recorder
        self._telemetry = True
        self._telemetry_health = bool(health)
        self._trace_only = False
        self._capture_cost = bool(capture_cost) and capture_enabled()
        self._cost_pending = self._capture_cost
        if self._capture_cost:
            install_device_memory_poller(recorder)
        if recorder.get_ledger() is None:
            from ..observability.goodput import GoodputLedger
            recorder.set_ledger(GoodputLedger(name="train", devices=1))
        return self

    def set_trace_every(self, n_steps: int, log_dir: str):
        """Capture a ``torch.profiler`` trace of every ``n_steps``-th step
        (the first step is 0) into ``log_dir`` as ``trace_step<k>.json``
        Chrome traces (Perfetto): host ops, the recorder's spans as
        ranges and, on a CUDA device, every kernel and copy.  Without
        :meth:`set_telemetry` first, telemetry comes on trace-only: no
        health scalars, no scalars read to the host, no cost capture and
        no memory poller."""
        if not self._telemetry:
            self.set_telemetry(self.recorder, health=False,
                               capture_cost=False)
            self._trace_only = True
        self.recorder.trace_every(n_steps, log_dir)
        return self

    def telemetry_sources(self):
        """``[("trainer", recorder)]``: the fleet aggregator's attachment
        hook (``aggregator.add(opt, name="train")``); telemetry comes on
        as :meth:`serve_metrics` turns it on."""
        if not self._telemetry:
            self.set_telemetry(self.recorder)
        return [("trainer", self.recorder)]

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1",
                      watchdog: bool = True):
        """Start the live introspection server of this trainer's recorder
        (``/metrics`` Prometheus, ``/healthz``, ``/records``,
        ``/goodput``) on a daemon thread.  ``port=0`` binds an ephemeral
        port (the returned server's ``.port``).  ``watchdog`` starts a
        stall watchdog (when none runs) so that ``/healthz`` reads 503
        when the step loop wedges.  A second call replaces the server;
        :meth:`stop_metrics` stops it and the watchdog.  Returns the
        :class:`~bigdl_tpu_torch.observability.http.IntrospectionServer`."""
        from ..observability.health import StallWatchdog
        from ..observability.http import IntrospectionServer
        if not self._telemetry:
            self.set_telemetry(self.recorder)
        if watchdog and self._watchdog is None:
            self._watchdog = StallWatchdog(self.recorder).start()
        return IntrospectionServer(
            self.recorder, port=port, host=host, watchdog=self._watchdog,
            monitor=self._health_monitor).swap_into(self)

    def stop_metrics(self):
        """Stop the introspection server and the stall watchdog, and join
        their threads."""
        server, self._http_server = self._http_server, None
        if server is not None:
            server.stop()
        if self._watchdog is not None:
            self._watchdog.stop()
        return self

    def _attach_step_cost(self, run, sharded: bool = False):
        """Capture the first step's cost with ``run()`` (a forward and
        backward that updates nothing) and attach it to the recorder;
        a sharded step records that it was not captured."""
        from ..observability import profile as _profile
        self._cost_pending = False
        rec = self.recorder
        if not (self._capture_cost and rec.enabled):
            return
        if sharded:
            _profile.attach_cost(rec, {"unavailable": ["capture_sharded"]},
                                 spec=_profile.device_spec(self.device))
            return
        _profile.capture_and_attach(rec, run, self.model, self.device)

    def set_trace_context(self, ctx, tracer=None):
        """Adopt a causal :class:`~bigdl_tpu_torch.observability.context
        .TraceContext`: checkpoint saves carry a child of it to the async
        writer thread (its queue-wait and write spans land under the
        run's trace id), and ``SpmdTrainer.step`` records a
        ``train.step`` span under it.  ``ctx=None`` detaches; ``tracer``
        overrides the process default span store."""
        self._trace_ctx = ctx
        if tracer is not None:
            self._tracer = tracer
        return self

    def set_health(self, policy: str = "warn", flight_dir=None,
                   max_rollbacks: int = 2, stall_factor=None,
                   install_crash_hooks: bool = True, **monitor_kw):
        """Numeric-health sentinels over every step record
        (:class:`~bigdl_tpu_torch.observability.health.HealthMonitor`):
        NaN/Inf in the loss or gradients, loss spikes and gradient
        explosions, read from the step's :func:`health_scalars` (no host
        sync beyond telemetry's one).  ``policy``: ``"warn"`` /
        ``"record"`` / ``"raise"`` (``DivergenceError``) / ``"rollback"``
        (restore the last committed checkpoint — needs
        ``set_checkpoint`` — at most ``max_rollbacks`` times).
        ``flight_dir`` arms the flight recorder (a dump on divergence,
        unhandled exception or SIGTERM; ``install_crash_hooks`` chains
        the excepthook and SIGTERM).  ``stall_factor`` starts a
        :class:`~bigdl_tpu_torch.observability.health.StallWatchdog` with
        that p99 multiplier."""
        from ..observability.health import (FlightRecorder, HealthMonitor,
                                            StallWatchdog)
        if not self._telemetry:
            self.set_telemetry(self.recorder)
        rec = self.recorder
        if flight_dir is not None:
            if self._flight is not None:     # reconfigure: one hook chain
                self._flight.uninstall()
            self._flight = FlightRecorder(rec, flight_dir)
            if install_crash_hooks:
                self._flight.install()
        self._health_monitor = HealthMonitor(
            policy=policy, recorder=rec, flight=self._flight, **monitor_kw)
        self._max_rollbacks = int(max_rollbacks)
        if stall_factor:
            if self._watchdog is not None:   # re-budget: one thread only
                self._watchdog.stop()
            self._watchdog = StallWatchdog(rec,
                                           factor=float(stall_factor)).start()
        if self._http_server is not None:   # set_health after serve_metrics
            self._http_server.monitor = self._health_monitor
            self._http_server.watchdog = self._watchdog \
                or self._http_server.watchdog
        return self

    def _rec(self) -> Recorder:
        return self.recorder

    def _may_roll_back(self) -> bool:
        """Whether a divergence may roll back (the policy is rollback, a
        checkpoint manager is set and rollbacks are left); when it may,
        the writer is drained first: an in-flight write may be the
        newest intact checkpoint."""
        mon = self._health_monitor
        if (mon is None or mon.policy != "rollback" or self._ckpt_mgr is None
                or mon.rollbacks >= self._max_rollbacks):
            return False
        self._ckpt_mgr.wait()
        return True

    def _rolled_back(self, err, where: str):
        """Count a restored rollback and restart the monitor's
        statistics."""
        mon = self._health_monitor
        mon.rollbacks += 1
        mon.reset_statistics()
        mon.mark_recovered()
        print(f"[health] rollback {mon.rollbacks}/{self._max_rollbacks}: "
              f"{err}; resumed from {where}", flush=True)


class Optimizer(TelemetryHealth):
    """The host training loop on one device (≙ the reference's
    ``Optimizer``): ``training_set`` is a :class:`DataSet` whose ``data``
    yields ``MiniBatch`` es, or an ``(x, y)`` pair of arrays (then
    ``batch_size`` is required; labels 1-based as
    ``ClassNLLCriterion`` takes them).  The default method is ``SGD()``,
    the default end one epoch.

    :meth:`optimize` trains the model's current parameters (in place) and
    its current batch-norm state (written back at the end); it does not
    redraw them.  ``seed`` seeds the loop's device generator, a new
    ``torch.Generator`` on the device at each :meth:`optimize` seeded with
    ``seed + 13`` (≙ the reference's ``PRNGKey(seed + 13)``), which the
    device augmentation and then the model's dropout draw from; the reference's seed also draws the
    initial parameters, where the port takes the model's own
    (``build(seed=)``).  :attr:`recorder` takes the ``dataloader/*`` and
    ``checkpoint/*`` counters, and the step records under
    :meth:`set_telemetry`."""

    def __init__(self, model, training_set, criterion,
                 batch_size: Optional[int] = None, seed: int = 0, *,
                 device: DeviceLike = None):
        if isinstance(training_set, tuple):
            x, y = training_set
            if batch_size is None:
                raise ValueError("batch_size required for array data")
            training_set = DataSet.minibatch_arrays(x, y, batch_size)
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
        self.seed = int(seed)
        self.mixed_precision = False
        self.prefetch_depth = 0
        self._grad_accum = 1
        self._grad_clip_norm = None
        self._grad_clip_const = None
        self._device_augment = None
        self.val_trigger: Optional[Trigger] = None
        self.val_dataset: Optional[DataSet] = None
        self.val_methods = None
        self._eval_step = None
        self._weight_stream = None
        self._carry = None            # (params, model_state) of the loop
        self._opt_carry = None        # and its optimizer state
        self._h2d = None              # prefetch's HostToDevice
        self.last_validation = None
        self.train_summary = None
        self.val_summary = None
        self.opt_state = None         # the method's state after optimize()
        self._init_telemetry()
        # checkpoints, preemption and retries (checkpoint/*)
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self._ckpt_mgr = None
        self._preemption = None
        self.max_retries = 0
        self._resume_skip = 0
        # a restored data cursor positions the dataset itself; an empty
        # first epoch then means "resumed at the boundary", not "no data"
        self._cursor_resumed = False
        self._loop_gen: Optional[torch.Generator] = None
        self._with_health = False
        self._restored_mesh = (None, None)   # (saved, target) of a restore

    # -- fluent config, reference API ----------------------------------- #
    def set_optim_method(self, method):
        self.optim_method = method
        return self

    def set_end_when(self, trigger):
        self.end_when = trigger
        return self

    def set_mixed_precision(self, enabled=True):
        """bf16 forward and backward over fp32 parameters and optimizer
        state (:func:`make_train_step`)."""
        self.mixed_precision = bool(enabled)
        return self

    def set_prefetch(self, depth=2):
        """Stage batches ``depth`` ahead on a background thread
        (:class:`~bigdl_tpu_torch.data.device_loader.DeviceLoader`): on a
        CUDA device through pinned buffers and a side stream, the step's
        stream waiting on each batch's copy event.  0 places each batch
        inline, as without this setter.  A self-staging dataset
        (:class:`~bigdl_tpu_torch.data.sharded.ShardedRecordDataSet`)
        already reads ahead and places on its own staging thread and is
        never wrapped: a loader reading ahead of training would move its
        exactly-once cursor past what training consumed."""
        if depth < 0:
            raise ValueError("depth must be >= 0")
        self.prefetch_depth = int(depth)
        return self

    def set_gradient_accumulation(self, n_accum: int):
        """Split each batch into ``n_accum`` microbatches and apply one
        update on their mean gradient (:func:`make_accum_train_step`); the
        batch (under ``DistriOptimizer`` each rank's block) must divide by
        ``n_accum``."""
        if n_accum < 1:
            raise ValueError("n_accum must be >= 1")
        self._grad_accum = int(n_accum)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        """Scale the gradients to a global L2 norm of at most
        ``clip_norm`` before each update (:class:`_ClippedOptim`)."""
        self._grad_clip_norm = clip_norm
        return self

    def set_constant_gradient_clipping(self, min_v, max_v):
        """Clamp every gradient element to ``[min_v, max_v]`` before each
        update (:class:`_ClippedOptim`)."""
        self._grad_clip_const = (min_v, max_v)
        return self

    def set_device_augment(self, augment):
        """Run ``augment`` (a
        :class:`~bigdl_tpu_torch.data.device_augment.DeviceAugment`, or
        any ``(x, generator, training) -> x`` callable) on each batch on
        the device: in the train step with the loop's generator, and in
        validation in eval mode (its center crop).  The host then ships
        raw uint8 batches.  Takes effect at the next :meth:`optimize`."""
        self._device_augment = augment
        self._eval_step = None        # the cached one ran the old augment
        return self

    def set_validation(self, trigger, dataset, methods, batch_size=None):
        """Evaluate ``methods`` over ``dataset`` (a DataSet, or an
        ``(x, y)`` pair cut into batches of ``batch_size``, 128 by
        default, in order) whenever ``trigger`` fires: an every-epoch
        trigger at each epoch's end, any other after each iteration and
        again at each epoch's end, as the reference reads them.
        ``state.score`` is the first method's result."""
        self.val_trigger = trigger
        if isinstance(dataset, tuple):
            x, y = dataset
            dataset = DataSet.minibatch_arrays(x, y, batch_size or 128,
                                               shuffle=False, drop_last=False)
        self.val_dataset = dataset
        self.val_methods = list(methods)
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

    def set_train_summary(self, summary):
        """A :class:`~bigdl_tpu_torch.visualization.TrainSummary`: Loss and
        LearningRate each iteration (under the summary's trigger of each
        tag; one host sync an iteration), Throughput at each epoch's end,
        and Parameters histograms when their trigger fires (a host copy
        of every parameter)."""
        self.train_summary = summary
        return self

    def set_val_summary(self, summary):
        """A :class:`~bigdl_tpu_torch.visualization.ValidationSummary`:
        each validation method's result at the iteration."""
        self.val_summary = summary
        return self

    def set_checkpoint(self, path, trigger=None, layout="manifest",
                       async_write=True, keep_last=None,
                       keep_every_epochs=None, handle_preemption=False):
        """Checkpoint into ``path`` whenever ``trigger`` fires (every
        epoch by default) through :mod:`bigdl_tpu_torch.checkpoint`:
        sharded, CRC32C-verified files committed by an atomic manifest,
        written by a background thread (``async_write``), so that only
        the device→host copy blocks the loop.  ``keep_last`` /
        ``keep_every_epochs`` set the retention (default: keep all);
        ``layout="file"`` is the single-file layout.  :meth:`optimize`
        resumes from the newest intact checkpoint there, exactly, in the
        middle of an epoch too.  ``handle_preemption`` installs a SIGTERM
        handler: a preempted run finishes the in-flight write, commits a
        final checkpoint ``preempt_iter_<n>``, and :meth:`optimize`
        returns."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger or Trigger.every_epoch()
        os.makedirs(path, exist_ok=True)
        self._ckpt_mgr = self._make_ckpt_manager(path, layout, async_write,
                                                 keep_last, keep_every_epochs)
        if handle_preemption:
            from ..checkpoint import PreemptionHandler
            self._preemption = PreemptionHandler().install()
        return self

    def set_auto_retry(self, max_retries):
        """Retry a failed epoch (≙ DistriOptimizer's retryNum): from the
        newest checkpoint when it is newer than the epoch's start, else
        from a host snapshot taken at the epoch's start."""
        self.max_retries = int(max_retries)
        return self

    def _wd_suspended(self):
        """Suspend the stall watchdog around legitimate between-step work
        (validation, a checkpoint's blocking copy or commit)."""
        if self._watchdog is None:
            return contextlib.nullcontext()
        return self._watchdog.suspended()

    # -- hooks overridden by DistriOptimizer ----------------------------- #
    def _clip(self, optim, group=None, sharded_mask=None):
        """``optim`` behind the clipping wrapper, when clipping is set."""
        if self._grad_clip_norm is None and self._grad_clip_const is None:
            return optim
        return _ClippedOptim(optim, self._grad_clip_norm,
                             self._grad_clip_const, group, sharded_mask)

    def _wrap_optim(self, params):
        return self._clip(self.optim_method)

    def _generator(self):
        """The loop's device generator, seeded with ``seed + 13``."""
        return torch.Generator(device=self.device).manual_seed(
            self.seed + 13)

    def _build_step(self, optim):
        return make_train_step(self.model, self.criterion, optim,
                               self.mixed_precision,
                               **self._step_options())

    def _step_options(self) -> dict:
        """The step's accumulation and augmentation, a new loop generator
        (the augmentation's and the model's draws) and, under telemetry,
        the health probe."""
        self._loop_gen = self._generator()
        self._with_health = self._telemetry and self._telemetry_health
        return dict(n_accum=self._grad_accum,
                    device_augment=self._device_augment,
                    generator=self._loop_gen,
                    health=self._health_probe() if self._with_health
                    else None)

    def _health_probe(self):
        return _HealthProbe()

    def _layout_params(self, params):
        return params

    def _host_batch(self, x, y):
        """The part of a host batch this process trains on."""
        return x, y

    def _staged_batch(self, x, y):
        """The part of a batch a self-staging dataset placed that this
        process trains on."""
        return x, y

    def _place_batch(self, x, y):
        """The host batch copied to the optimizer's device."""
        return tuple(None if a is None else to_device(a, self.device)
                     for a in (x, y))

    def _params_for_eval(self, params):
        return params

    def _banner_suffix(self):
        return ""

    # -- checkpoint hooks (DistriOptimizer: layouts and ranks) ----------- #
    def _make_ckpt_manager(self, path, layout, async_write, keep_last,
                           keep_every_epochs):
        from ..checkpoint import CheckpointManager
        return CheckpointManager(path, layout=layout,
                                 async_write=async_write,
                                 keep_last=keep_last,
                                 keep_every_epochs=keep_every_epochs,
                                 recorder_fn=self._rec)

    def _layout_meta(self):
        """``(layout name, mesh info)`` written into each checkpoint."""
        return "local", None

    def _rank(self) -> int:
        return 0

    def _ckpt_payload(self, params, opt_state, model_state):
        """``({shard name: host tree}, owned names or None)`` for this
        process: the parameters a shard per module, the optimizer and
        model state, and the loop generator's state (``loop_rng/<rank>``,
        a uint8 array)."""
        from ..checkpoint import host_snapshot
        params, opt_state, model_state = host_snapshot(
            (params, opt_state, model_state))
        shards = {f"params/{mod}": sub for mod, sub in params.items()}
        shards["opt_state"] = opt_state
        shards["model_state"] = model_state
        shards[f"loop_rng/{self._rank()}"] = self._gen_state()
        return shards, None

    def _gen_state(self) -> np.ndarray:
        return self._loop_gen.get_state().numpy().copy()

    def _load_params(self, params, params_g):
        """Write global host parameters into the loop's parameters, in
        place (the model's own tensors)."""
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), tree_leaves(params_g)):
                dst.copy_(torch.as_tensor(np.asarray(src)))

    def _after_params_restored(self, params):
        """Hook: the parameters were overwritten in place."""

    def _opt_from_global(self, opt_g, opt_state):
        """The optimizer state from its global host tree (the structure
        of ``opt_state``, which :meth:`load_checkpoint` checked)."""
        return _like(opt_state, opt_g)

    def _opt_global_shapes(self, opt_state):
        """``{path: global shape}`` of the optimizer state: a dict entry
        (velocity, moments) is parameter-shaped, a tensor (the step) as
        it is."""
        pshapes = _shapes(self.model.param_dict())
        out = {}
        for k, v in opt_state.items():
            if isinstance(v, dict):
                out.update({f"{k}/{p}": s for p, s in pshapes.items()})
            else:
                out[k] = tuple(v.shape)
        return out

    def _adopt(self, trees, params, opt_state, model_state):
        """Global host trees ``(params, opt_state, model_state)`` into the
        loop's carry."""
        params_g, opt_g, state_g = trees
        self._load_params(params, params_g)
        self._after_params_restored(params)
        return (params, self._restore_opt(opt_g, opt_state),
                _host_tree(state_g, self.device))

    def _restore_opt(self, opt_g, opt_state):
        """The restored optimizer state, checked against the structure
        and global shapes of ``opt_state``."""
        self._check_tree("checkpoint optimizer state", opt_g,
                         self._opt_global_shapes(opt_state),
                         *self._restored_mesh)
        return self._opt_from_global(opt_g, opt_state)

    # -- checkpointing (≙ Optimizer.saveCheckpoint / resume) ------------- #
    def save_checkpoint(self, params, opt_state, model_state, tag=None,
                        sync=False, epoch_boundary=False):
        """Queue one checkpoint of the loop's state.  The loop blocks only
        for the owning device→host copy (``checkpoint.blocking``, and on
        writer backpressure); serialize, CRC, write and commit run on the
        writer thread unless ``sync``."""
        if self._ckpt_mgr is None:
            return
        rec = self.recorder
        tag = tag or f"iter_{self.state.iteration}"
        layout, mesh = self._layout_meta()
        with self._wd_suspended(), rec.span("checkpoint.blocking"):
            t0 = time.perf_counter()
            payload, owned = self._ckpt_payload(params, opt_state,
                                                model_state)
            rec.inc("checkpoint/d2h_seconds", time.perf_counter() - t0)
        # the epoch-seeded shuffle reproduces the order, batch_in_epoch
        # says where to skip to, the generator's state the draws
        meta = {"epoch": self.state.epoch, "iteration": self.state.iteration,
                "batch_in_epoch": self.state.batch_in_epoch,
                "epoch_boundary": bool(epoch_boundary), "layout": layout}
        # a cursor-capable dataset (data/sharded.py): the read position of
        # the last batch consumed, so that a resume re-positions the
        # stream instead of replaying the epoch's head
        if callable(getattr(self.dataset, "state", None)):
            meta["data_cursor"] = self.dataset.state()
        blocked = rec.span_value("checkpoint.blocking")
        with self._wd_suspended():
            self._ckpt_mgr.save(
                payload, meta, tag, sync=sync, mesh=mesh, owned=owned,
                trace_ctx=None if self._trace_ctx is None
                else self._trace_ctx.child())
        rec.inc("checkpoint/backpressure_seconds",
                rec.span_value("checkpoint.blocking") - blocked)

    def load_checkpoint(self):
        """The newest intact checkpoint as global host trees ``(params,
        opt_state, model_state)``, with the training counters, the skip
        into the epoch and the loop generator's state taken from it; None
        when there is none.  A checkpoint whose trees do not match the
        model raises :class:`~bigdl_tpu_torch.checkpoint.CheckpointError`
        with the mesh delta; another layout or world size is reassembled
        and said so."""
        from ..checkpoint import reshard
        rec = self.recorder
        restored = self._ckpt_mgr.restore_latest(with_manifest=True)
        if restored is None:
            return None
        _, trees, meta, mf = restored
        layout, mesh = self._layout_meta()
        saved_mesh = None if mf is None else mf.mesh
        # the file layout holds the same {shard name: tree} dict whole
        params_g = trees["params"] if "params" in trees else {
            k[len("params/"):]: v for k, v in trees.items()
            if k.startswith("params/")}
        opt_g, state_g = trees.get("opt_state"), trees.get("model_state")
        where = "?" if mf is None else mf.tag
        self._restored_mesh = (saved_mesh, mesh)
        self._check_tree(f"checkpoint {where} params", params_g,
                         _shapes(self.model.param_dict()), saved_mesh, mesh)
        self._check_tree(f"checkpoint {where} model_state", state_g,
                         _shapes(self.model.initial_state()), saved_mesh,
                         mesh)
        same = (meta.get("layout") == layout
                and reshard.same_mesh(saved_mesh, mesh))
        if not same:
            print(f"[checkpoint] resharding {meta.get('layout')} → "
                  f"{layout}: {reshard.describe_delta(saved_mesh, mesh)}",
                  flush=True)
        st = self.state
        st.epoch = int(meta["epoch"])
        st.iteration = int(meta["iteration"])
        st.batch_in_epoch = int(meta.get("batch_in_epoch", 0))
        self._resume_skip = st.batch_in_epoch
        cursor = meta.get("data_cursor")
        if cursor is not None and callable(getattr(self.dataset, "restore",
                                                   None)):
            # the dataset re-positions itself: skipping batches on top of
            # the restored cursor would skip them twice
            self.dataset.restore(cursor)
            self._resume_skip = 0
            self._cursor_resumed = True
        gen = trees.get(f"loop_rng/{self._rank()}")
        if same and gen is not None:
            self._loop_gen.set_state(torch.as_tensor(np.asarray(
                gen, np.uint8)))
        else:
            # another world or layout: each rank reseeds by its formula
            self._loop_gen.manual_seed(self._loop_gen.initial_seed())
        rec.inc("checkpoint/restored")
        return params_g, opt_g, state_g

    @staticmethod
    def _check_tree(what, got, want_shapes, saved_mesh, target_mesh):
        """Raise :class:`~bigdl_tpu_torch.checkpoint.CheckpointError` when
        a restored tree's leaves or shapes differ from the model's."""
        from ..checkpoint import CheckpointError, reshard
        got_shapes = _shapes(got if got is not None else {})
        missing = sorted(set(want_shapes) - set(got_shapes))
        extra = sorted(set(got_shapes) - set(want_shapes))
        bad = [(p, got_shapes[p], want_shapes[p]) for p in want_shapes
               if p in got_shapes and got_shapes[p] != want_shapes[p]]
        if not (missing or extra or bad):
            return
        lines = []
        if missing:
            lines.append(f"{len(missing)} leaves of the model missing "
                         f"(e.g. {missing[:3]})")
        if extra:
            lines.append(f"{len(extra)} leaves the model does not have "
                         f"(e.g. {extra[:3]})")
        for p, g, w in bad[:3]:
            why = reshard.explain_shape_delta(g, w, saved_mesh, target_mesh)
            lines.append(f"{p}: saved {g}, model {w}"
                         + (f" ({why})" if why else ""))
        raise CheckpointError(f"{what} do not match the model: "
                              + "; ".join(lines)
                  + "; " + reshard.describe_delta(saved_mesh, target_mesh))

    # -- validation ------------------------------------------------------ #
    def _validate(self, params, model_state):
        """Run the validation methods over the validation set; returns
        ``[(method, result)]`` and sets ``state.score``."""
        if self.val_dataset is None or not self.val_methods:
            return None
        if self._eval_step is None:      # built once per optimizer
            self._eval_step = make_eval_step(self.model,
                                             self._device_augment)
        with self._wd_suspended(), self.recorder.span("validation"):
            named = evaluate(self._eval_step, params, model_state,
                             self.val_dataset, self.val_methods,
                             self.device)
        for method, res in named:
            print(f"  [validation] {method}: {res}")
            if self.val_summary is not None and res is not None:
                self.val_summary.add_scalar(method.name, res.result()[0],
                                            self.state.iteration)
        if named and named[0][1] is not None:
            self.state.score = named[0][1].result()[0]
        self.last_validation = named
        return named

    def _write_train_summary(self, params, opt_state):
        """The iteration's scalars and, behind their trigger, the
        Parameters histograms (≙ the reference's ``_write_train_summary``;
        a histogram copies its parameter to the host)."""
        ts = self.train_summary
        it = self.state.iteration

        def trigger(tag):
            return getattr(ts, "get_summary_trigger", lambda _t: None)(tag)

        def fires(tag):
            trig = trigger(tag)
            return trig is None or trig(self.state)

        tags, vals = [], []
        if fires("Loss"):
            tags.append("Loss")
            vals.append(self.state.loss)
        if fires("LearningRate"):
            tags.append("LearningRate")
            vals.append(self.optim_method.get_learning_rate(opt_state))
        if tags:
            host = torch.stack([torch.as_tensor(v, device=self.device)
                                .detach().reshape(()).float()
                                for v in vals]).tolist()
            for tag, v in zip(tags, host):
                ts.add_scalar(tag, v, it)
        ptrig = trigger("Parameters")
        if ptrig is not None and ptrig(self.state):
            params = self._params_for_eval(params)    # fsdp: gathered
            for path, leaf in zip(tree_paths(params), tree_leaves(params)):
                ts.add_histogram(path, leaf.detach().float().cpu().numpy(),
                                 it)

    # -- main loop ------------------------------------------------------- #
    def optimize(self):
        params = self.model.param_dict()
        bad = sorted({str(p.device) for (p,) in zip_leaves(params)
                      if p.device != self.device})
        if bad:
            raise ValueError(f"{type(self).__name__}: the model's parameters"
                             f" are on {bad}, the optimizer's device is "
                             f"{self.device}; move the model first")
        model_state = self.model.initial_state()
        optim = self._wrap_optim(params)
        step_fn = self._build_step(optim)
        params = self._layout_params(params)
        opt_state = optim.init_state(params)
        if self._ckpt_mgr is not None:
            # the one restore path (a rollback's too): _load_params cuts
            # fsdp's row blocks from the global leaves
            restored = self._restore_from_checkpoint(params, opt_state,
                                                     model_state)
            if restored is not None:
                params, opt_state, model_state = restored
        if self._watchdog is not None:
            self._watchdog.start()      # no-op when already polling
        try:
            params, opt_state, model_state = self._optimize_loop(
                params, opt_state, model_state, step_fn)
        finally:
            self._carry = self._opt_carry = None
            if self._watchdog is not None:
                # a dead loop is not a stalled one
                self._watchdog.stop()
        self.opt_state = opt_state
        with torch.no_grad():
            # the model's own parameters, unless the loop trained copies
            # (fsdp's shards)
            for dst, src in zip_leaves(self.model.param_dict(),
                                       self._params_for_eval(params)):
                if dst is not src:
                    dst.copy_(src)
        self.model.set_state(model_state)
        rec = self.recorder
        if self._ckpt_mgr is not None:
            # every triggered checkpoint is committed when optimize returns
            self._ckpt_mgr.wait()
            ck = {k: v for k, v in rec.snapshot()["counters"].items()
                  if k.startswith("checkpoint/")}
            if ck and self._telemetry:
                rec.emit_record("checkpoint_summary", counters=ck)
        rec.flush()
        return self.model

    def _retry_snapshot(self, params, opt_state, model_state):
        from ..checkpoint import host_snapshot
        st = self.state
        return (host_snapshot((params, opt_state, model_state)), st.epoch,
                st.iteration, self._loop_gen.get_state())

    def _retry_restore(self, cache, params, opt_state, model_state):
        (p_h, o_h, s_h), epoch, iteration, gen = cache
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), tree_leaves(p_h)):
                dst.copy_(torch.as_tensor(src))
        self._after_params_restored(params)
        st = self.state
        st.epoch, st.iteration, st.batch_in_epoch = epoch, iteration, 0
        self._resume_skip = 0
        self._loop_gen.set_state(gen)
        return (params, _like(opt_state, o_h), _host_tree(s_h, self.device))

    def _restore_from_checkpoint(self, params, opt_state, model_state):
        restored = self.load_checkpoint()
        if restored is None:
            return None
        t0 = time.perf_counter()
        out = self._adopt(restored, params, opt_state, model_state)
        self.recorder.inc("checkpoint/restore_h2d_seconds",
                          time.perf_counter() - t0)
        return out

    def _optimize_loop(self, params, opt_state, model_state, step_fn):
        """Epochs until the end trigger, with the retry and rollback
        loop (≙ the reference's ``_optimize_loop``)."""
        from ..observability.health import DivergenceError
        stop = False
        retries = 0
        cache = None
        while not stop:
            if self.max_retries:
                cache = self._retry_snapshot(params, opt_state, model_state)
            try:
                params, opt_state, model_state, stop = self._run_epoch(
                    params, opt_state, model_state, step_fn)
            except DivergenceError as e:
                # rollback restores the last COMMITTED checkpoint (the
                # flight dump happened at raise time)
                if not self._may_roll_back():
                    raise
                out = self._restore_from_checkpoint(params, opt_state,
                                                    model_state)
                if out is None:
                    raise
                params, opt_state, model_state = out
                self._rolled_back(e, f"iteration {self.state.iteration}")
            except Exception as e:
                if retries >= self.max_retries or cache is None:
                    if self._flight is not None:
                        # a post-mortem before propagating (keyed: the
                        # chained excepthook won't dump it twice)
                        self._flight._dump_quietly(
                            f"exception:{type(e).__name__}",
                            {"error": repr(e)}, key=id(e))
                    raise
                retries += 1
                out = None
                if self._ckpt_mgr is not None:
                    self._ckpt_mgr.wait()
                    try:
                        out = self._restore_from_checkpoint(
                            params, opt_state, model_state)
                    except Exception:
                        out = None
                if out is not None and self.state.iteration >= cache[2]:
                    print(f"[retry {retries}/{self.max_retries}] iteration "
                          f"{self.state.iteration} failed ({e!r}); "
                          "resuming from the last checkpoint", flush=True)
                    params, opt_state, model_state = out
                else:
                    print(f"[retry {retries}/{self.max_retries}] epoch "
                          f"{cache[1]} failed ({e!r}); restoring the "
                          "epoch's start", flush=True)
                    params, opt_state, model_state = self._retry_restore(
                        cache, params, opt_state, model_state)
        return params, opt_state, model_state

    def _batches(self, epoch, skip=0):
        """``(global size, x, y)`` on the device, in the dataset's order
        after the first ``skip`` batches (a resume's, skipped before
        anything is staged): placed inline, or under ``set_prefetch``
        staged ahead by a :class:`DeviceLoader` and taken on the step's
        stream."""
        rec = self.recorder
        if getattr(self.dataset, "self_staging", False):
            yield from self._pipeline_batches(epoch, skip)
            return

        def host():
            it = self.dataset.data(train=True, epoch=epoch)
            for _ in range(skip):
                if next(it, None) is None:
                    return
            for mb in it:
                yield (mb.size(),) + tuple(
                    self._host_batch(mb.get_input(), mb.get_target()))

        if not self.prefetch_depth:
            for size, x, y in host():
                with rec.span("h2d"):
                    placed = self._place_batch(x, y)
                yield (size,) + placed
            return
        stage = self._stager()
        loader = DeviceLoader(((size, stage((x, y))) for size, x, y in
                               host()), self.prefetch_depth,
                              recorder=self.recorder)
        for size, staged in loader:
            yield (size,) + staged.take()

    def _pipeline_batches(self, epoch, skip):
        """``(size, x, y)`` of a self-staging dataset: its staging thread
        places each batch (``HostToDevice``) ``staging_depth`` ahead, and
        its stream hands the batch over taken on this thread."""
        self.dataset.set_place_fn(self._stager(self.dataset.staging_depth))
        it = self.dataset.data(train=True, epoch=epoch)
        try:
            for _ in range(skip):       # a resume without a cursor
                if next(it, None) is None:
                    return
            for x, y in it:
                yield (batch_rows(x),) + tuple(self._staged_batch(x, y))
        finally:
            it.close()

    def _stager(self, depth=None):
        """The prefetch placement: one :class:`HostToDevice` (and so one
        ring of pinned buffers) per optimizer."""
        if self._h2d is None:
            self._h2d = HostToDevice(self.device, depth or
                                     self.prefetch_depth)
        return self._h2d

    def _fetch(self, batches, capture=None):
        """The next batch, with the step record opened before the fetch
        under telemetry (the fetch's wait is the ``data_fetch`` span);
        None at the epoch's end.  While the first step's cost is pending,
        ``capture(x, y)`` counts it on the fetched batch before the
        record (and the step's trace) opens: that record starts after
        the fetch, whose wait is still its ``data_fetch`` span."""
        if not self._telemetry:
            return next(batches, None)
        rec = self.recorder
        pending = capture is not None and self._cost_pending
        if not pending:
            rec.start_step(self.state.iteration + 1)
        h2d0 = rec.span_value("h2d")
        t0 = time.perf_counter()
        item = next(batches, None)
        if item is None:
            if not pending:
                rec.abort_step()
            return None
        # inline placement ran inside the fetch: keep the spans disjoint
        fetch = max(0.0, time.perf_counter() - t0
                    - (rec.span_value("h2d") - h2d0))
        if pending:
            capture(item[1], item[2])
            rec.start_step(self.state.iteration + 1)
        rec.add_span("data_fetch", fetch)
        return item

    def _run_epoch(self, params, opt_state, model_state, step_fn):
        """One epoch; returns the updated carry and whether to stop."""
        stop = False
        st = self.state
        st.epoch_finished = False
        skip, self._resume_skip = self._resume_skip, 0
        cursor_resumed, self._cursor_resumed = self._cursor_resumed, False
        st.batch_in_epoch = skip
        epoch_start = time.time()
        n_seen = 0
        rec = self.recorder
        batches = self._batches(st.epoch, skip)
        try:
            while True:
                item = self._fetch(batches, functools.partial(
                    self._capture_cost_of, params, model_state)
                    if self._cost_pending else None)
                if item is None:
                    st.epoch_finished = True
                    break
                size, x, y = item
                try:
                    with rec.span("train_step"):
                        out = step_fn(params, opt_state, model_state, x, y)
                except BaseException:
                    if self._telemetry:
                        rec.abort_step()    # and a trace it opened
                    raise
                params, opt_state, model_state, loss = out[:4]
                st.iteration += 1
                st.batch_in_epoch += 1
                # kept on the device: a float() here would sync the host
                # with the device every step (telemetry pays one a step)
                st.loss = loss
                n_seen += size
                self._carry = (params, model_state)
                self._opt_carry = opt_state
                if self.train_summary is not None:
                    self._write_train_summary(params, opt_state)
                if self._telemetry:
                    # before the triggers: a diverged step raises before
                    # the checkpoint trigger can commit its poisoned state
                    self._emit_step_record(size, loss, opt_state,
                                           out[4] if self._with_health
                                           else None)
                if self._fire_mid_epoch():
                    stop = True
                    break
        finally:
            batches.close()
        if not st.epoch_finished:
            return params, opt_state, model_state, stop
        if n_seen == 0:
            if skip == 0 and not cursor_resumed:
                raise ValueError(
                    "dataset produced no batches (batch_size larger "
                    "than the dataset with drop_last, or empty data)")
            # resumed exactly at the epoch's end: its validation and
            # checkpoint happened before the stop; just advance
            st.epoch += 1
            st.batch_in_epoch = 0
            return params, opt_state, model_state, self.end_when(st)
        st.loss = float(st.loss)
        dur = time.time() - epoch_start
        thru = n_seen / max(dur, 1e-9)
        if self.train_summary is not None:
            self.train_summary.add_scalar("Throughput", thru, st.iteration)
        print(f"[epoch {st.epoch}] loss={st.loss:.4f} ({n_seen} samples "
              f"in {dur:.1f}s, {thru:.1f}/s{self._banner_suffix()})")
        if self.val_trigger is not None and self.val_trigger(st):
            self._validate(self._params_for_eval(params), model_state)
        if (self.checkpoint_trigger is not None
                and isinstance(self.checkpoint_trigger, _EveryEpoch)
                and self.checkpoint_trigger(st)):
            self.save_checkpoint(params, opt_state, model_state,
                                 tag=f"epoch_{st.epoch}",
                                 epoch_boundary=True)
        # a metric-driven schedule (Plateau) reads the epoch's score, or
        # its loss without one; the step reads its factor at every step
        sched = getattr(self.optim_method, "schedule", None)
        if hasattr(sched, "on_epoch_end"):
            metric = st.score if st.score is not None else st.loss
            if metric is not None:
                sched.on_epoch_end(float(metric))
        st.epoch += 1
        st.batch_in_epoch = 0
        if self.end_when(st):
            stop = True
        return params, opt_state, model_state, stop

    def _capture_cost_of(self, params, model_state, x, y):
        """The first step's cost: its loss's forward and backward on this
        batch, with a generator of its own, updating nothing."""
        mesh = getattr(self, "mesh", None)
        sharded = mesh is not None and getattr(mesh, "size", 1) > 1
        model, criterion = self.model, self.criterion

        def run():
            gen = torch.Generator(device=self.device).manual_seed(0)
            xx = x
            if self._device_augment is not None:
                xx = self._device_augment(xx, gen)
            if self.mixed_precision:
                xx = to_bf16(xx)
            loss, _ = make_loss_fn(model, criterion, generator=gen)(
                params, model_state, xx, y)
            torch.autograd.grad(loss, [p for (p,) in zip_leaves(params)])
        self._attach_step_cost(run, sharded)

    def _emit_step_record(self, size, loss, opt_state, health):
        """Fold the iteration into one step record: the loss, the rate
        and the health scalars come to the host in one copy (the step's
        one sync), then the health monitor checks the record.  A
        trace-only recorder (``set_trace_every`` alone) keeps the step
        cadence without reading anything to the host."""
        rec = self.recorder
        if self._trace_only:
            rec.end_step(self.state.iteration)
            return
        # the step's collective volume, accumulated over the run (the
        # per-step gauges were reset at the step's start)
        for gauge, counter in (("collective/bytes_per_step",
                                "collective/bytes_total"),
                               ("collective/wire_bytes_per_step",
                                "collective/wire_bytes_total")):
            v = rec.gauge_value(gauge)
            if v:
                rec.inc(counter, v)
        names, vals = ["loss"], [loss]
        lr = self.optim_method.get_learning_rate(opt_state)
        if isinstance(lr, torch.Tensor):
            names.append("learning_rate")
            vals.append(lr)
        else:
            rec.scalar("learning_rate", float(lr))
        for k, v in (health or {}).items():
            names.append(k)
            vals.append(v)
        host = torch.stack([v.detach().reshape(()).float()
                            for v in vals]).tolist()
        for k, v in zip(names, host):
            rec.scalar(k, v)
        rec.inc("records_total", size)
        rec.scalar("records", size)
        record = rec.end_step(self.state.iteration)
        if self._health_monitor is not None:
            self._health_monitor.check_record(record)

    def _preempt_requested(self) -> bool:
        return self._preemption is not None and self._preemption.requested

    def _fire_mid_epoch(self) -> bool:
        """Iteration-level triggers, after each step: preemption (a final
        checkpoint, then stop), validation (a trigger other than
        every-epoch), the checkpoint trigger (other than every-epoch), the
        weight stream, then the end trigger (an epoch-count end trigger
        is read at the epoch's end); True ends training."""
        st = self.state
        params, model_state = self._carry
        opt_state = self._opt_carry
        if self._ckpt_mgr is not None and self._preempt_requested():
            self.save_checkpoint(params, opt_state, model_state,
                                 tag=f"preempt_iter_{st.iteration}",
                                 sync=True)
            if self._flight is not None:
                # beside the final checkpoint: its counters show the commit
                self._flight._dump_quietly("preemption")
            print(f"[preemption] final checkpoint at iteration "
                  f"{st.iteration} committed; stopping cleanly", flush=True)
            return True
        if (self.val_trigger is not None
                and not isinstance(self.val_trigger, _EveryEpoch)
                and self.val_trigger(st)):
            self._validate(self._params_for_eval(params), model_state)
        if (self.checkpoint_trigger is not None
                and not isinstance(self.checkpoint_trigger, _EveryEpoch)
                and self.checkpoint_trigger(st)):
            self.save_checkpoint(params, opt_state, model_state)
        if self._weight_stream is not None:
            # the snapshot is taken inside, synchronously (owning
            # copies); the publish rides the stream's worker thread
            self._weight_stream.maybe_publish(params, state=st)
        return (not isinstance(self.end_when, _MaxEpoch)
                and self.end_when(st))


class LocalOptimizer(Optimizer):
    """Training on one device (≙ the reference's ``LocalOptimizer``: its
    multi-threaded subbatching is one step on the device here)."""
