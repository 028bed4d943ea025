"""Optimization methods (≙ ``bigdl_tpu/optim/optim_method.py``): the
:class:`OptimMethod` contract, :class:`SGD`, :class:`Adam` and
:class:`AdamW`.

The reference's contract, on nested dicts of tensors::

    state = method.init_state(params)
    params, state = method.update(grads, params, state)

with two differences that PyTorch allows and the training step wants:

  * ``update`` writes the new parameters and moments into the tensors it
    was given and returns them: the counterpart of the reference trainer
    donating its parameter and optimizer buffers (``donate_argnums``).
  * ``state["step"]`` is a device ``int32`` tensor, and the step's
    learning rate ``clr = rate(step) / (1 + step * lr_decay)`` (and Adam's
    bias corrections ``bc1 = 1 - beta1^t`` and ``bc2``) are fp32 device
    scalars, computed in the reference's order.  An update makes no host
    sync.

``fused=True`` sends every f32 leaf on a CUDA tensor to the hand-written
kernel (``kernels.fused_optim``: K4 for Adam, K5 for SGD with momentum,
K6 for SGD without) and every CPU leaf to its plain version; a CUDA leaf
that is not f32 raises.  ``fused=False`` is the reference's tree-map math
in plain PyTorch ops, which is the same plain version, on any device.

The reference's other methods are listed under ROADMAP queue A, item 2.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..kernels.fused_optim import (fused_adam_update,
                                   fused_adam_update_plain, fused_sgd_update,
                                   fused_sgd_update_plain, zip_leaves)
from .lr_schedule import Default, _fill


def _tmap(f, tree):
    if isinstance(tree, dict):
        return {k: _tmap(f, v) for k, v in tree.items()}
    return f(tree)


def _device_of(params) -> torch.device:
    for (leaf,) in zip_leaves(params):
        return leaf.device
    raise ValueError("init_state: params has no leaves")


class OptimMethod:
    """Base class. Subclasses define init_state / update."""

    def init_state(self, params) -> Dict[str, Any]:
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device_of(params))}

    def update(self, grads, params, state):
        raise NotImplementedError

    def get_learning_rate(self, state):
        return 0.0


def _current_lr(method, state):
    """``rate(step) / (1 + step * lr_decay)``: an fp32 device scalar."""
    step = state["step"]
    # a device tensor as the schedule computed it, or a host float filled
    # on the device (not copied from the host): no host sync
    rate = _fill(method.schedule.rate(method, step), step)
    return rate / (1.0 + step * method.lr_decay)


class SGD(OptimMethod):
    """optim/SGD.scala: learning-rate schedule and per-step decay, weight
    decay, momentum with dampening (which defaults to ``momentum``, not to
    0 as in ``torch.optim.SGD``) and Nesterov.  The velocity starts at 0
    and exists only when ``momentum > 0``.

    ``learning_rates`` and ``weight_decays`` (the reference's per-parameter
    tensors) are accepted as the reference accepts them: it stores
    neither and does not use them, and so the port does the same."""

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 weight_decay=0.0, momentum=0.0, dampening=None,
                 nesterov=False, learning_rate_schedule=None,
                 learning_rates=None, weight_decays=None, fused=False):
        self.lr = learning_rate
        self.lr_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default()
        self.fused = bool(fused)
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0")

    def init_state(self, params):
        st = super().init_state(params)
        if self.momentum > 0:
            st["velocity"] = _tmap(torch.zeros_like, params)
        return st

    def get_learning_rate(self, state):
        return _current_lr(self, state)

    def update(self, grads, params, state):
        fn = fused_sgd_update if self.fused else fused_sgd_update_plain
        _, vel = fn(params, grads, state.get("velocity"),
                    clr=self.get_learning_rate(state), momentum=self.momentum,
                    dampening=self.dampening, nesterov=self.nesterov,
                    weight_decay=self.weight_decay)
        new_state = {"step": state["step"] + 1}
        if vel is not None:
            new_state["velocity"] = vel
        return params, new_state


class Adam(OptimMethod):
    """optim/Adam.scala, in the reference's op order."""

    weight_decay = 0.0      # AdamW's decoupled decay; none for Adam

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8,
                 learning_rate_schedule=None, fused=False):
        self.lr = learning_rate
        self.lr_decay = learning_rate_decay
        self.beta1, self.beta2, self.eps = beta1, beta2, epsilon
        self.schedule = learning_rate_schedule or Default()
        self.fused = bool(fused)

    def init_state(self, params):
        return {**super().init_state(params),
                "m": _tmap(torch.zeros_like, params),
                "v": _tmap(torch.zeros_like, params)}

    def get_learning_rate(self, state):
        return _current_lr(self, state)

    def update_scalars(self, state):
        """The keyword arguments of one leaf's update at ``state["step"]``:
        the device scalars ``clr``, ``bc1 = 1 - beta1^t`` and
        ``bc2 = 1 - beta2^t`` (t = step + 1, in fp32 as the reference
        computes them) and the host constants."""
        t = state["step"] + 1
        tf = t.to(torch.float32)
        b1 = torch.full((), self.beta1, dtype=torch.float32, device=t.device)
        b2 = torch.full((), self.beta2, dtype=torch.float32, device=t.device)
        return dict(clr=self.get_learning_rate(state),
                    bc1=1.0 - torch.pow(b1, tf), bc2=1.0 - torch.pow(b2, tf),
                    beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                    weight_decay=self.weight_decay)

    def update(self, grads, params, state):
        kw = self.update_scalars(state)
        m, v = state["m"], state["v"]
        fn = fused_adam_update if self.fused else fused_adam_update_plain
        fn(params, grads, m, v, **kw)
        return params, {"step": state["step"] + 1, "m": m, "v": v}


class AdamW(Adam):
    """Adam with decoupled weight decay: after the Adam step,
    ``p -= clr * weight_decay * p_old`` (in the fused case, in the same
    kernel pass)."""

    def __init__(self, learning_rate=1e-3, weight_decay=0.01, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.weight_decay = weight_decay
