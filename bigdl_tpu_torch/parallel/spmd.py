"""SpmdTrainer on one device (≙ ``bigdl_tpu/parallel/spmd.py``).

The reference compiles one (forward + backward + update) XLA program over
a device mesh.  The port runs the same step eagerly on one device:

    loss = model.loss(params, tokens, targets)        (+ ctx.side_losses)
    grads = autograd.grad(loss, params)               (make_accum_grads)
    params, opt_state = optim.update(grads, params, opt_state)

On the card the step runs the flash-attention kernels (K1 forward, K2/K3
backward) and, with ``fused=True``, the fused Adam kernel (K4).  The
update writes parameters and moments in place, the counterpart of the
reference's ``donate_argnums=(0, 1)``.  ``step`` returns the loss as a
device tensor and makes no host sync; ``fit`` syncs when it logs and
once at its end, to hand back the losses as floats.

Parameters are not drawn at :meth:`init`: the reference draws them from
``jax.random``, which torch cannot reproduce, so the trainer takes the
model's current parameters (a ``build(seed=)`` draw, or the reference's
weights loaded with ``models.convert.from_jax_params``).

A live weight stream (:meth:`SpmdTrainer.set_weight_stream`, a
:class:`~bigdl_tpu_torch.serving.WeightStreamPublisher`) is evaluated
once per ``fit`` step against the step count; on fire it takes owning
device copies of the parameters and publishes them off the step loop.
The loss stays on the device there.

Not ported yet (ROADMAP queue A, item 5): the mesh and its axes (dp,
fsdp, tp, sp), zero1 and ring attention; each raises here.  Also left
out: telemetry and health, checkpoints, ``evaluate`` and the device-side
input transform.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..nn.module import Ctx
from ..optim.optimizer import make_accum_grads

# keyword -> the value that asks for nothing (single-device training)
_UNPORTED = {"mesh": None, "fsdp": False, "ring_attention": None,
             "zero1": False}


class SpmdTrainer:
    """One-device trainer of a TransformerLM with the reference's step."""

    def __init__(self, model, optim, *, device: DeviceLike = None,
                 seed: int = 0, grad_accum: int = 1,
                 loss_chunk: Optional[int] = None, **unported):
        for key, value in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"SpmdTrainer: unexpected argument {key!r}")
            if value != _UNPORTED[key]:
                raise NotImplementedError(
                    f"SpmdTrainer: {key}={value!r} needs the device mesh, "
                    f"which is not ported yet (ROADMAP queue A, item 5: "
                    f"SPMD parallelism); the port trains on one device")
        if seed != 0:
            # the reference's seed draws the initial parameters (here the
            # model's own are taken) and dropout's keys (dropout raises)
            raise NotImplementedError(
                f"SpmdTrainer: seed={seed!r} seeds nothing yet: no step "
                f"draws random numbers until dropout in training is "
                f"ported (ROADMAP queue A, item 2); the parameters are "
                f"the model's own (build(seed=))")
        self.model = model
        self.optim = optim
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.grad_accum = int(grad_accum)
        self.loss_chunk = loss_chunk
        self.params = None
        self.opt_state = None
        self._grads_fn = None
        self._step_count = 0
        self._weight_stream = None

    def set_weight_stream(self, publisher):
        """Attach a live train→serve weight stream
        (:class:`~bigdl_tpu_torch.serving.WeightStreamPublisher`):
        evaluated once per :meth:`fit` step against the step count; on
        fire the parameters are snapshotted (owning copies on their
        device) and published through the canary gate off the step loop.
        ``None`` detaches."""
        self._weight_stream = publisher
        return self

    def init(self):
        """Take the model's parameters and build the optimizer state."""
        params = self.model.param_dict()
        bad = sorted({str(p.device) for sub in params.values()
                      for p in sub.values() if p.device != self.device})
        if bad:
            raise ValueError(f"SpmdTrainer: the model's parameters are on "
                             f"{bad}, the trainer's device is "
                             f"{self.device}; move the model first")
        self.params = params
        self.opt_state = self.optim.init_state(params)
        model, loss_chunk = self.model, self.loss_chunk

        def loss_fn(p, state, tokens, targets):
            ctx = Ctx(state={}, training=True)
            loss = model.loss(p, tokens, targets, loss_chunk=loss_chunk,
                              ctx=ctx)
            for sl in ctx.side_losses:
                loss = loss + sl
            return loss, state

        # model.loss is a MASKED token mean, so microbatches are weighted
        # by their valid-token count
        self._grads_fn = make_accum_grads(
            loss_fn, self.grad_accum,
            weight_fn=lambda t, y: (y != -1).sum())
        return self

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def step(self, tokens, targets):
        """One training step on a batch; returns the loss as a device
        tensor (no host sync)."""
        if self._grads_fn is None:
            self.init()
        tokens, targets = self._to_device(tokens), self._to_device(targets)
        (loss, _), grads = self._grads_fn(self.params, {}, tokens, targets)
        self.params, self.opt_state = self.optim.update(
            grads, self.params, self.opt_state)
        self._step_count += 1
        return loss

    def fit(self, batches, steps: Optional[int] = None, log_every: int = 0):
        """Step over ``(tokens, targets)`` batches; returns the losses as
        floats."""
        losses = []
        for i, (tokens, targets) in enumerate(batches):
            if steps is not None and i >= steps:
                break
            loss = self.step(tokens, targets)
            if self._weight_stream is not None:
                # the snapshot is taken here, before the next step's
                # in-place update; the loss stays on the device (the
                # trigger state carries only the step count)
                self._weight_stream.maybe_publish(self.params,
                                                  step=self._step_count)
            if log_every and (i + 1) % log_every == 0:
                print(f"step {i + 1}: loss={float(loss):.4f}")
            losses.append(loss)
        return torch.stack(losses).tolist() if losses else []
