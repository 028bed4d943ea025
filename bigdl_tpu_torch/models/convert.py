"""Load the reference's weights into the port's models.

Two ways, for two kinds of model:

  * :func:`from_jax_params` matches the reference's flat param dict by
    module name, for models whose modules are named after their root
    (the TransformerLM);
  * :func:`from_jax_weights` matches by position, for models whose
    modules are named after a global uid (the image classifiers).

``bigdl_tpu`` keeps a model's weights as a flat dict
``{module_name: {"weight": array, ...}}`` (``Module.init_params``).  The
port's modules carry the same names after the root, and the same
orientation: ``x @ w`` with ``w`` of shape ``(d_in, d_out)``, the
embedding ``(V, D)``, the head ``(D, V)`` — nothing is transposed here.

The reference's root name comes from a global uid counter
(``TransformerLM_000000NN``), so keys are matched by the part after the
root name (``.block0.attn``).  A key missing on either side, a parameter
name that differs, or a shape that differs raises before anything is
copied.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..nn.module import Module, _check_shapes, _copy_into


def _suffix(name: str) -> str:
    i = name.find(".")
    return name[i:] if i >= 0 else ""


def _by_suffix(tree: Mapping[str, Mapping], side: str) -> Dict[str, tuple]:
    out: Dict[str, tuple] = {}
    for name, sub in tree.items():
        key = _suffix(name)
        if key in out:
            raise ValueError(f"from_jax_params: {side} names {out[key][0]!r} "
                             f"and {name!r} share the suffix {key!r}")
        out[key] = (name, sub)
    return out


def from_jax_params(params: Mapping[str, Mapping[str, np.ndarray]],
                    model: Module) -> None:
    """Copy the reference's flat param dict into ``model`` in place (each
    array is cast to the parameter's dtype and moved to its device).

    Keys are matched by the part after the root name.  That cannot serve a
    model whose modules are named after the global uid counter
    (``SpatialConvolution_00000006``, as every unnamed layer of the
    reference's ResNet is): such a key has no ``.``, every one gives the
    same empty suffix, and this raises "share the suffix".  Use
    :func:`from_jax_weights` for those."""
    theirs = _by_suffix(params, "reference")
    ours = _by_suffix(model.param_dict(), "port")
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise ValueError(f"from_jax_params: modules missing from the "
                         f"reference params {missing}, left over {extra}")
    plan = []
    for key, (name, our_sub) in ours.items():
        their_name, their_sub = theirs[key]
        if set(our_sub) != set(their_sub):
            raise ValueError(f"from_jax_params: {their_name} has params "
                             f"{sorted(their_sub)}, {name} has "
                             f"{sorted(our_sub)}")
        for pname, p in our_sub.items():
            arr = np.asarray(their_sub[pname])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"from_jax_params: {their_name}.{pname} has "
                                 f"shape {arr.shape}, {name}.{pname} "
                                 f"{tuple(p.shape)}")
            plan.append((p, arr))
    with torch.no_grad():
        for p, arr in plan:
            p.copy_(torch.from_numpy(np.array(arr, copy=True)))


def from_jax_weights(weights: Sequence[np.ndarray], model: Module,
                     state: Optional[Sequence[np.ndarray]] = None) -> None:
    """Copy the reference's ``get_weights()`` list into ``model`` in place,
    by position: modules depth first, each module's keys weight first,
    then bias, then the rest (the order of :meth:`Module.get_weights`).
    ``state`` is the reference's batch-norm state as a list in the same
    module order, each module's keys alphabetically (``running_mean``,
    ``running_var``; :meth:`Module.state_list`).  A ``Graph`` registers
    its modules in the reference's topological order and a ``Remat``
    wrapper owns no weights, so graph models and the remat ResNet cross
    the same way.  The counts at both ends and every shape are checked
    before anything is copied."""
    ours = model.get_weights()
    weights = _check_shapes(ours, weights, "from_jax_weights (weights)")
    if state is not None:
        mine = model.state_list()
        state = _check_shapes(mine, state, "from_jax_weights (state)")
        _copy_into(mine, state, "from_jax_weights (state)")
    _copy_into(ours, weights, "from_jax_weights (weights)")
