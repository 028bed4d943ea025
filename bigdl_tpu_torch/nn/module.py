"""Core module abstraction — the functional core of the port.

Port of ``bigdl_tpu/nn/module.py``, the part the serving and training
slices need.
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
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

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


class Module(torch.nn.Module):
    """Base class of the port's layers and models."""

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

    def forward(self, x):
        y, _ = self.run(self.param_dict(), x)
        return y
