"""Optimization methods (≙ ``bigdl_tpu/optim/optim_method.py``): the
:class:`OptimMethod` contract, :class:`Adam` and :class:`AdamW`.

The reference's contract, on nested dicts of tensors::

    state = method.init_state(params)
    params, state = method.update(grads, params, state)

with two differences that PyTorch allows and the training step wants:

  * ``update`` writes the new parameters and moments into the tensors it
    was given and returns them: the counterpart of the reference trainer
    donating its parameter and optimizer buffers (``donate_argnums``).
  * ``state["step"]`` is a device ``int32`` tensor, and the step's
    learning rate ``clr`` and bias corrections ``bc1 = 1 - beta1^t`` and
    ``bc2`` are fp32 device scalars, computed in the reference's order.
    An update makes no host sync.

``fused=True`` sends every f32 leaf on a CUDA tensor to the hand-written
kernel (``kernels.fused_optim``, K4) and every CPU leaf to its plain
version; a CUDA leaf that is not f32 raises.  ``fused=False`` is the
reference's tree-map math in plain PyTorch ops, which is the same plain
version, on any device.

``SGD`` comes with the image-classifier slice (ROADMAP queue A, item 3);
the reference's other methods are listed under item 2.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..kernels.fused_optim import (fused_adam_update,
                                   fused_adam_update_plain, zip_leaves)
from .lr_schedule import Default


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
        """``rate(step) / (1 + step * lr_decay)``: an fp32 device scalar."""
        step = state["step"]
        rate = torch.as_tensor(self.schedule.rate(self, step),
                               dtype=torch.float32, device=step.device)
        return rate / (1.0 + step * self.lr_decay)

    def update_scalars(self, state):
        """The keyword arguments of one leaf's update at ``state["step"]``:
        the device scalars ``clr``, ``bc1 = 1 - beta1^t`` and
        ``bc2 = 1 - beta2^t`` (t = step + 1, in fp32 as the reference
        computes them) and the host constants."""
        t = state["step"] + 1
        tf = t.to(torch.float32)
        b1 = torch.tensor(self.beta1, dtype=torch.float32, device=t.device)
        b2 = torch.tensor(self.beta2, dtype=torch.float32, device=t.device)
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
