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
weight stream attaches with ``set_weight_stream``.  Not ported yet
(ROADMAP queue A): checkpoints, summaries, telemetry and health, retries
and the trace context; each ``set_*`` of those raises.
"""
from __future__ import annotations

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
from ..parallel.allreduce import tree_leaves, tree_map
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


def make_train_step(model, criterion, optim_method: OptimMethod,
                    mixed_precision: bool = False, *, n_accum: int = 1,
                    device_augment=None, generator=None, gather=_identity,
                    exchange=_identity, pmean=_identity):
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
        grads = mask_frozen_grads(model, grads)
        params, opt_state = optim_method.update(exchange(grads), params,
                                                opt_state)
        merged = dict(model_state)
        merged.update(pmean(updates))
        return params, opt_state, merged, pmean(loss)

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
    """A host array (or a tensor) as a tensor on ``device``."""
    return a.to(device) if isinstance(a, torch.Tensor) else \
        torch.as_tensor(np.asarray(a)).to(device)


# set_* of the reference that are not ported: name -> what it sets
_UNPORTED_SETTERS = {
    "set_checkpoint": "checkpointing",
    "set_train_summary": "training summaries",
    "set_val_summary": "validation summaries",
    "set_telemetry": "telemetry",
    "set_trace_context": "the trace context",
    "set_trace_every": "profiler traces",
    "set_health": "training health",
    "set_auto_retry": "retries",
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
    redraw them.  ``seed`` seeds the loop's device generator, a new
    ``torch.Generator`` on the device at each :meth:`optimize` seeded with
    ``seed + 13`` (≙ the reference's ``PRNGKey(seed + 13)``), which the
    device augmentation and then the model's dropout draw from; the reference's seed also draws the
    initial parameters, where the port takes the model's own
    (``build(seed=)``).  :attr:`recorder` takes the ``dataloader/*``
    counters under prefetch."""

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
        self._h2d = None              # prefetch's HostToDevice
        self.last_validation = None
        self.opt_state = None         # the method's state after optimize()
        self.recorder = Recorder()

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
        inline, as without this setter."""
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
        """The step's accumulation and augmentation, and a new loop
        generator (the augmentation's and the model's draws)."""
        return dict(n_accum=self._grad_accum,
                    device_augment=self._device_augment,
                    generator=self._generator())

    def _layout_params(self, params):
        return params

    def _host_batch(self, x, y):
        """The part of a host batch this process trains on."""
        return x, y

    def _place_batch(self, x, y):
        """The host batch copied to the optimizer's device."""
        return tuple(None if a is None else to_device(a, self.device)
                     for a in (x, y))

    def _params_for_eval(self, params):
        return params

    def _banner_suffix(self):
        return ""

    # -- validation ------------------------------------------------------ #
    def _validate(self, params, model_state):
        """Run the validation methods over the validation set; returns
        ``[(method, result)]`` and sets ``state.score``."""
        if self.val_dataset is None or not self.val_methods:
            return None
        if self._eval_step is None:      # built once per optimizer
            self._eval_step = make_eval_step(self.model,
                                             self._device_augment)
        named = evaluate(self._eval_step, params, model_state,
                         self.val_dataset, self.val_methods, self.device)
        for method, res in named:
            print(f"  [validation] {method}: {res}")
        if named and named[0][1] is not None:
            self.state.score = named[0][1].result()[0]
        self.last_validation = named
        return named

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
        stop = False
        try:
            while not stop:
                params, opt_state, model_state, stop = self._run_epoch(
                    params, opt_state, model_state, step_fn)
        finally:
            self._carry = None
        self.opt_state = opt_state
        with torch.no_grad():
            # the model's own parameters, unless the loop trained copies
            # (fsdp's shards)
            for dst, src in zip_leaves(self.model.param_dict(),
                                       self._params_for_eval(params)):
                if dst is not src:
                    dst.copy_(src)
        self.model.set_state(model_state)
        return self.model

    def _batches(self, epoch):
        """``(global size, x, y)`` on the device, in the dataset's order:
        placed inline, or under ``set_prefetch`` staged ahead by a
        :class:`DeviceLoader` and taken on the step's stream."""
        def host():
            for mb in self.dataset.data(train=True, epoch=epoch):
                yield (mb.size(),) + tuple(
                    self._host_batch(mb.get_input(), mb.get_target()))

        if not self.prefetch_depth:
            for size, x, y in host():
                yield (size,) + self._place_batch(x, y)
            return
        stage = self._stager()
        loader = DeviceLoader(((size, stage((x, y))) for size, x, y in
                               host()), self.prefetch_depth,
                              recorder=self.recorder)
        for size, staged in loader:
            yield (size,) + staged.take()

    def _stager(self):
        """The prefetch placement: one :class:`HostToDevice` (and so one
        ring of pinned buffers) per optimizer."""
        if self._h2d is None:
            self._h2d = HostToDevice(self.device, self.prefetch_depth)
        return self._h2d

    def _run_epoch(self, params, opt_state, model_state, step_fn):
        """One epoch; returns the updated carry and whether to stop."""
        stop = False
        st = self.state
        st.epoch_finished = False
        st.batch_in_epoch = 0
        epoch_start = time.time()
        n_seen = 0
        batches = self._batches(st.epoch)
        try:
            for size, x, y in batches:
                params, opt_state, model_state, loss = step_fn(
                    params, opt_state, model_state, x, y)
                st.iteration += 1
                st.batch_in_epoch += 1
                # kept on the device: a float() here would sync the host
                # with the device every step
                st.loss = loss
                n_seen += size
                self._carry = (params, model_state)
                if self._fire_mid_epoch():
                    stop = True
                    break
            else:
                st.epoch_finished = True
        finally:
            batches.close()
        if not st.epoch_finished:
            return params, opt_state, model_state, stop
        if n_seen == 0:
            raise ValueError(
                "dataset produced no batches (batch_size larger "
                "than the dataset with drop_last, or empty data)")
        st.loss = float(st.loss)
        dur = time.time() - epoch_start
        print(f"[epoch {st.epoch}] loss={st.loss:.4f} ({n_seen} samples "
              f"in {dur:.1f}s, {n_seen / max(dur, 1e-9):.1f}/s"
              f"{self._banner_suffix()})")
        if self.val_trigger is not None and self.val_trigger(st):
            self._validate(self._params_for_eval(params), model_state)
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

    def _fire_mid_epoch(self) -> bool:
        """Iteration-level triggers, after each step: validation (a
        trigger other than every-epoch), the weight stream, then the end
        trigger (an epoch-count end trigger is read at the epoch's end);
        True ends training."""
        st = self.state
        params, model_state = self._carry
        if (self.val_trigger is not None
                and not isinstance(self.val_trigger, _EveryEpoch)
                and self.val_trigger(st)):
            self._validate(self._params_for_eval(params), model_state)
        if self._weight_stream is not None:
            # the snapshot is taken inside, synchronously (owning
            # copies); the publish rides the stream's worker thread
            self._weight_stream.maybe_publish(params, state=st)
        return (not isinstance(self.end_when, _MaxEpoch)
                and self.end_when(st))


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
