"""Multi-model registry with immutable weight snapshots and atomic
hot-swap (≙ ``bigdl_tpu/serving/registry.py``).

The unit of truth is an immutable :class:`Snapshot` (params, state,
version): readers grab ``entry.snapshot`` once per micro-batch (a single
attribute read — atomic under the GIL) and a swap publishes a *new*
Snapshot only after the replacement tree has been validated
leaf-by-leaf against the old one.  A batch therefore runs against exactly
one weight version, never a half-swapped mix, and a failed swap changes
nothing.  ``params`` is the model's flat dict
``{module_name: {param_name: tensor}}`` (``Module.param_dict``).

Shape/dtype/device validation on swap keeps every warmed bucket valid:
a tensor of another shape would crash mid-batch, one of another dtype
or device would silently change what the warmed buckets run.

Not ported yet (ROADMAP queue A): the ``quantize_int8`` path,
``swap_model`` and ``sync_from_model``, and the ``serving.swap`` fault
seam.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..nn.module import Module
from ..utils.retry import RetryPolicy


class Snapshot:
    """Immutable (params, state, version) triple; swaps replace the
    whole object, never mutate one."""

    __slots__ = ("params", "state", "version")

    def __init__(self, params, state, version: str):
        object.__setattr__(self, "params", params)
        object.__setattr__(self, "state", state)
        object.__setattr__(self, "version", version)

    def __setattr__(self, *a):
        raise AttributeError("Snapshot is immutable; publish a new one")

    def __repr__(self):
        return f"Snapshot(version={self.version!r})"


class ModelEntry:
    """One served model: the module, its live Snapshot, input spec, the
    device it runs on, and the per-bucket runners the engine fills."""

    def __init__(self, name: str, model: Module, snapshot: Snapshot,
                 input_shape: Optional[Tuple[int, ...]], dtype,
                 device: torch.device):
        self.name = name
        self.model = model
        self.snapshot = snapshot
        self.input_shape = input_shape
        self.dtype = dtype
        self.device = device
        self.compiled: Dict[int, Callable] = {}     # bucket -> runner
        self.warmed = False
        self.swap_lock = threading.Lock()
        # auto versions start at v2: v1 is the registration snapshot
        self._version_counter = itertools.count(2)

    def next_version(self) -> str:
        return f"v{next(self._version_counter)}"


def _model_device(model: Module) -> torch.device:
    p = next(iter(model.parameters()), None)
    return p.device if p is not None else resolve_device(None)


class ModelRegistry:
    """Named, versioned models behind one serving engine."""

    def __init__(self):
        self._entries: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        # a hot-swap that hits a transient blip retries briefly before
        # the publisher sees a failure; the old snapshot keeps serving
        # throughout, so retrying here is free of risk
        self._swap_retry = RetryPolicy()

    # -- registration ----------------------------------------------------- #
    def register(self, name: str, model: Module, *,
                 input_shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.float32, version: Optional[str] = None
                 ) -> ModelEntry:
        """Add ``model`` under ``name``.  It is served on the device its
        parameters live on.

        ``input_shape`` is one sample's feature shape (no batch dim); it
        is required for :meth:`~bigdl_tpu_torch.serving.ServingEngine.warmup`
        to run the bucket ladder (without it the first request of each
        bucket pays — and counts — a recompile).
        """
        entry = ModelEntry(
            name, model, Snapshot(model.param_dict(), {}, version or "v1"),
            None if input_shape is None else tuple(input_shape),
            np.dtype(dtype), _model_device(model))
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered; "
                                 "use swap_weights to update")
            self._entries[name] = entry
        return entry

    def unregister(self, name: str) -> ModelEntry:
        with self._lock:
            return self._entries.pop(name)

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"no model {name!r}; registered: "
                    f"{sorted(self._entries)}") from None

    def entries(self):
        with self._lock:
            return list(self._entries.values())

    # -- hot swap --------------------------------------------------------- #
    def swap_weights(self, name: str, params=None, state=None,
                     version: Optional[str] = None) -> Snapshot:
        """Atomically publish new weights for ``name``.

        The replacement tree must match the live snapshot leaf-for-leaf
        in structure, shape, dtype and device (validated *before*
        publishing, so a bad swap leaves the old snapshot serving).
        In-flight micro-batches finish on whichever snapshot they
        grabbed; new batches see the new one.
        """
        entry = self.get(name)
        with entry.swap_lock:
            old = entry.snapshot
            new_params = old.params if params is None else params
            new_state = old.state if state is None else state

            def validate():
                _check_same_avals(f"{name}.params", old.params, new_params)
                _check_same_avals(f"{name}.state", old.state, new_state)
                return Snapshot(new_params, new_state,
                                version or entry.next_version())
            # transient-only retries; a ValueError (shape/dtype drift)
            # is fatal and raises with the old snapshot still serving
            snap = self._swap_retry.run(validate)
            entry.snapshot = snap          # the atomic publish
            # keep the module coherent for direct callers: rebinding
            # leaves the old snapshot's tensors as they were
            entry.model.load_param_dict(new_params)
            return snap


def _leaves(tree, path="") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _check_same_avals(label: str, old, new):
    ol, nl = list(_leaves(old)), list(_leaves(new))
    if [p for p, _ in ol] != [p for p, _ in nl]:
        raise ValueError(f"swap {label}: tree structure changed "
                         f"({[p for p, _ in ol]} != {[p for p, _ in nl]})")
    for (path, a), (_, b) in zip(ol, nl):
        if _aval(a) != _aval(b):
            raise ValueError(
                f"swap {label}: leaf {path} changed from {_aval(a)} to "
                f"{_aval(b)}; the warmed buckets assume fixed "
                "shapes, dtypes and devices")


def _aval(x):
    """(shape, dtype, device) of a leaf, from metadata only."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype), str(x.device)
    a = np.asarray(x)
    return tuple(a.shape), str(a.dtype), "host"
