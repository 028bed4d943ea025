"""Load the reference's weights into the port's models.

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

from typing import Dict, Mapping

import numpy as np
import torch

from ..nn.module import Module


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
    array is cast to the parameter's dtype and moved to its device)."""
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
