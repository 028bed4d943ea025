"""Core module abstraction — the functional core of the port.

Port of ``bigdl_tpu/nn/module.py``, the part the serving, training and
image-classifier slices need (the Torch shell — ``forward``/``backward``/
``update_parameters`` on cached activity — is not ported yet, ROADMAP
queue A, item 10).
A module is a ``torch.nn.Module`` that also keeps the reference's
functional core:

  - ``apply(params, x, ctx) -> y``: a forward that reads its weights from
    the flat dict ``params`` (``{module_name: {"weight": tensor, ...}}``)
    through :meth:`Module.own`, never from ``self``.  A serving snapshot
    is such a dict, so one batch runs against exactly the weights it was
    handed.  (``apply`` shadows ``torch.nn.Module.apply(fn)``; the port
    walks modules with ``modules()`` instead.)
  - ``run(params, x[, state, training]) -> (y, new_state)``: the
    functional entry point.

Weights live as ``nn.Parameter`` s on the module, so ``.to(device)``,
``state_dict`` and ``parameters()`` work as in any PyTorch model, and
:meth:`Module.param_dict` hands them out in the reference's flat layout.
Module names follow the reference's scheme: ``f"{Type}_{uid:08d}"`` for
an unnamed module, and children named after their parent
(``f"{root}.block{i}.attn"``).

Persistent non-trainable state (batch norm's running statistics) lives in
buffers on the module; :meth:`Module.initial_state` hands them out in the
reference's flat layout, ``apply`` reads them from ``ctx.state`` and
writes new values to ``ctx.new_state`` (:meth:`Ctx.get_state` /
:meth:`Ctx.put_state`), and :meth:`Module.set_state` copies a trained
state back into the buffers.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

_uid_counter = itertools.count()

Params = Dict[str, Dict[str, torch.Tensor]]


class Ctx:
    """Per-call context threaded through ``apply``: the training flag,
    persistent state in/out dicts, and the side losses a layer adds to
    the training loss (which ``SpmdTrainer`` sums; none of the ported
    layers adds one yet)."""

    __slots__ = ("training", "state", "new_state", "side_losses")

    def __init__(self, state=None, training: bool = False):
        self.training = training
        self.state = state or {}
        self.new_state: Dict[str, Any] = {}
        self.side_losses: List[torch.Tensor] = []

    def get_state(self, module):
        return self.state.get(module.name)

    def put_state(self, module, value):
        self.new_state[module.name] = value


def _weights_order(sub) -> List[str]:
    """Per-module key order of get/set_weights: weight* first, bias*
    second, the rest alphabetically (the reference's
    ``Module._weights_order``)."""
    def rank(k):
        if k.startswith("weight"):
            return (0, k)
        if k.startswith("bias"):
            return (1, k)
        return (2, k)
    return sorted(sub, key=rank)


def check_regularizers(module, w_regularizer, b_regularizer) -> None:
    """Keep a layer's per-layer regularizers (``optim.regularizer``, or
    any callable ``param -> penalty``); raise for anything else."""
    for what, reg in (("w_regularizer", w_regularizer),
                      ("b_regularizer", b_regularizer)):
        if reg is not None and not callable(reg):
            raise TypeError(f"{type(module).__name__}: {what} must be a "
                            f"callable param -> penalty, got {reg!r}")
    module.w_regularizer = w_regularizer
    module.b_regularizer = b_regularizer


class Module(torch.nn.Module):
    """Base class of the port's layers and models.

    Children are walked in registration order, depth first, which is the
    reference's ``modules()`` order when a container registers its
    children in the reference's order."""

    # init-method overrides read by ``nn.init.init_tensor`` (the
    # reference's ``set_init_method``): None takes the layer's default
    weight_init = None
    bias_init = None
    # per-layer penalties summed by ``regularization_loss`` (set by the
    # layers that take ``w_regularizer`` / ``b_regularizer``)
    w_regularizer = None
    b_regularizer = None
    _frozen = False

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self._uid = next(_uid_counter)
        self.name = name or f"{type(self).__name__}_{self._uid:08d}"

    # -- functional core ------------------------------------------------ #
    def apply(self, params: Params, x, ctx: Ctx):   # noqa: D401
        """Pure forward from ``params``. Subclasses implement it."""
        raise NotImplementedError(type(self).__name__)

    def own(self, params: Params) -> Dict[str, torch.Tensor]:
        return params.get(self.name, {})

    def run(self, params: Params, x, state=None, training: bool = False):
        """(params, x[, state]) -> (y, new_state)."""
        ctx = Ctx(state=state, training=training)
        y = self.apply(params, x, ctx)
        out_state = dict(state or {})
        out_state.update(ctx.new_state)
        return y, out_state

    def _ref_modules(self) -> List["Module"]:
        """This module and its descendants, depth first (the reference's
        ``Module.modules()``)."""
        return [m for m in self.modules() if isinstance(m, Module)]

    # -- parameters in the reference's flat layout ---------------------- #
    def param_dict(self) -> Params:
        """``{module_name: {param_name: tensor}}`` over this module and
        every descendant that owns parameters.  The tensors are the
        module's own ``nn.Parameter`` s (no copy)."""
        out: Params = {}
        for m in self.modules():
            if isinstance(m, Module):
                own = dict(m.named_parameters(recurse=False))
                if own:
                    out[m.name] = own
        return out

    def load_param_dict(self, params: Params) -> None:
        """Rebind the module's parameters to the tensors in ``params``
        (same names, shapes and dtypes as :meth:`param_dict`).  The old
        tensors are left untouched, so whoever still holds them — a
        serving snapshot in flight — keeps reading the old values."""
        by_name = {m.name: m for m in self.modules()
                   if isinstance(m, Module)}
        for mod_name, sub in params.items():
            mod = by_name[mod_name]
            for pname, t in sub.items():
                old = getattr(mod, pname)
                mod._parameters[pname] = torch.nn.Parameter(
                    t, requires_grad=old.requires_grad)

    def regularization_loss(self, params):
        """The sum of the per-layer regularizers' penalties on ``params``
        (``w_regularizer`` on a module's ``weight``, ``b_regularizer`` on
        its ``bias``); 0.0 when no module has one."""
        loss = 0.0
        for m in self._ref_modules():
            p = params.get(m.name)
            if not p:
                continue
            if m.w_regularizer is not None and "weight" in p:
                loss = loss + m.w_regularizer(p["weight"])
            if m.b_regularizer is not None and "bias" in p:
                loss = loss + m.b_regularizer(p["bias"])
        return loss

    # -- freezing (Layer.freeze) ---------------------------------------- #
    def freeze(self, names=None) -> "Module":
        """Mark this module, or the named submodules and everything under
        them, non-trainable: the training steps zero their gradients
        (``optim.optimizer.mask_frozen_grads``), per-layer regularizers'
        included.  An optimization method's ``weight_decay`` still applies
        to every parameter, so prefer layer regularizers when freezing."""
        if names is None:
            for m in self._ref_modules():
                m._frozen = True
            return self
        wanted, hit = set(names), set()
        for m in self._ref_modules():
            if m.name in wanted:
                hit.add(m.name)
                for sub in m._ref_modules():
                    sub._frozen = True
        missing = wanted - hit
        if missing:
            raise ValueError(f"freeze: no submodule named {missing}")
        return self

    def unfreeze(self, names=None) -> "Module":
        """Undo :meth:`freeze` for this module or the named submodules."""
        wanted = None if names is None else set(names)
        for m in self._ref_modules():
            if wanted is None or m.name in wanted:
                for sub in m._ref_modules():
                    sub._frozen = False
        return self

    def frozen_param_names(self) -> set:
        """Names of the modules whose parameters must not update."""
        return {m.name for m in self._ref_modules() if m._frozen}

    # -- weights as a flat list (pyspark Layer.get_weights) -------------- #
    def get_weights(self) -> List[torch.Tensor]:
        """This model's weights as a flat list: modules depth first, each
        module's keys weight first, then bias, then the rest alphabetically
        (≙ the reference's ``get_weights``; tensors, detached, no copy)."""
        out = []
        for m in self._ref_modules():
            own = dict(m.named_parameters(recurse=False))
            out.extend(own[k].detach() for k in _weights_order(own))
        return out

    def set_weights(self, weights: Sequence) -> "Module":
        """Inverse of :meth:`get_weights` (arrays or tensors).  The count
        and every shape are checked before anything is copied."""
        _copy_into(self.get_weights(), weights, "set_weights")
        return self

    # -- persistent state (batch-norm running statistics) ---------------- #
    def initial_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{module_name: {buffer_name: tensor}}`` over this module and its
        descendants: the module's own buffers (no copy), which hold the
        reference's ``initial_state()`` values until :meth:`set_state`
        writes a trained state into them."""
        out = {}
        for m in self._ref_modules():
            own = dict(m.named_buffers(recurse=False))
            if own:
                out[m.name] = own
        return out

    def state_list(self) -> List[torch.Tensor]:
        """:meth:`initial_state` as a flat list, modules depth first, each
        module's keys in alphabetical order."""
        return [sub[k] for sub in self.initial_state().values()
                for k in sorted(sub)]

    def set_state(self, state) -> "Module":
        """Copy ``state`` (the layout of :meth:`initial_state`, as a train
        step returns it) into the module's buffers."""
        mine = self.initial_state()
        if set(state) != set(mine) or any(set(state[k]) != set(mine[k])
                                          for k in mine):
            raise ValueError(f"set_state: state has modules {sorted(state)},"
                             f" the model {sorted(mine)}")
        _copy_into([mine[n][k] for n in mine for k in sorted(mine[n])],
                   [state[n][k] for n in mine for k in sorted(mine[n])],
                   "set_state")
        return self

    def forward(self, x):
        y, _ = self.run(self.param_dict(), x, state=self.initial_state())
        return y


def _check_shapes(dst: List[torch.Tensor], src: Sequence, what: str) -> list:
    """``src`` as a list, after checking that it has ``dst``'s count and
    every entry ``dst``'s shape."""
    src = list(src)
    if len(src) != len(dst):
        raise ValueError(f"{what}: {len(src)} arrays given, the model has "
                         f"{len(dst)}")
    for i, (d, s) in enumerate(zip(dst, src)):
        if tuple(np.shape(s)) != tuple(d.shape):
            raise ValueError(f"{what}: entry {i} has shape "
                             f"{tuple(np.shape(s))}, the model's "
                             f"{tuple(d.shape)}")
    return src


@torch.no_grad()
def _copy_into(dst: List[torch.Tensor], src: Sequence, what: str) -> None:
    """Copy ``src[i]`` into ``dst[i]`` for every i (casting to its dtype and
    moving to its device), after checking the count and every shape."""
    for d, s in zip(dst, _check_shapes(dst, src, what)):
        d.copy_(s if isinstance(s, torch.Tensor)
                else torch.from_numpy(np.array(s, copy=True)))


class Criterion:
    """Base of the losses (≙ the reference's ``Criterion``):
    ``loss(output, target) -> scalar``.  The gradient comes from autograd
    through ``loss``; the Torch shell (``forward``/``backward``) is not
    ported yet (ROADMAP queue A, item 10)."""

    def __init__(self, name: Optional[str] = None):
        self._uid = next(_uid_counter)
        self.name = name or f"{type(self).__name__}_{self._uid:08d}"

    def loss(self, output, target):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"
