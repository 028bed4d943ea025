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

**A tensor a Snapshot holds is never written in place.**  The reference's
snapshots hold immutable JAX arrays; the port's hold tensors, and every
optimizer path of the port (K4–K6 and their plain versions) writes a
model's parameters in place.  So the registry never lets a snapshot share
storage with a module a trainer may adopt:

  * :meth:`ModelRegistry.register`, :meth:`~ModelRegistry.swap_model` and
    :meth:`~ModelRegistry.sync_from_model` take **owning copies** of the
    module's parameters (a detached ``clone()`` per leaf, on the model's
    device), so training the registered module later leaves the snapshot
    as it was;
  * :meth:`~ModelRegistry.swap_weights` publishes the caller's tensors
    as they are (promotion hands the SAME tensors to every replica, and a
    weight stream's snapshots are owning copies already) and keeps the
    module coherent by **cloning on rebind**: the module's parameters
    become copies of the published tensors, never the tensors themselves,
    so a trainer built from that module afterwards cannot write into a
    live snapshot, nor into one a rollback may republish.  The replicas
    of a set share one module and promotion hands each replica's registry
    the same tree, so the copy is taken once per tree: a module still
    bound to the copies of that very tree is not copied again.

The caller of ``swap_weights`` hands its tensors over: it must not write
them afterwards.

The ``serving.swap`` fault site fires inside the (retried) validation.

``state`` is the model's persistent state (batch norm's running
statistics, ``Module.initial_state``), held as owning copies the same way.

``register(quantize_int8=True)`` serves an int8 copy of the model
(``quantized.quantize_for_serving``, calibrated with ``calibration_data``
when given).  Its int8 weights are constants of the modules, not leaves
of the snapshot, so the entry is inference-only: ``swap_weights`` on it
raises, and new weights mean a new quantization through ``swap_model``.
The entry keeps its calibration batches, so that a canary promotion can
quantize the new weights with the same activation scales.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import faults as faultplane
from .._device import model_device, resolve_device
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
                 device: torch.device, inference_only: bool = False,
                 calibration_data=None):
        self.name = name
        self.model = model
        self.snapshot = snapshot
        self.input_shape = input_shape
        self.dtype = dtype
        self.device = device
        # an int8 entry: its weights are module constants, not swappable
        self.inference_only = inference_only
        # the batches an int8 entry was calibrated with
        self.calibration_data = calibration_data
        self.compiled: Dict[int, Callable] = {}     # bucket -> runner
        self.warmed = False
        self.swap_lock = threading.Lock()
        # auto versions start at v2: v1 is the registration snapshot
        self._version_counter = itertools.count(2)

    def next_version(self) -> str:
        return f"v{next(self._version_counter)}"


def _model_device(model: Module) -> torch.device:
    try:
        return model_device(model)
    except ValueError:
        return resolve_device(None)


def _snapshot(model: Module, version: str) -> Snapshot:
    """Owning copies of ``model``'s parameters and state."""
    return Snapshot(owning_copy(model.param_dict()),
                    owning_copy(model.initial_state()), version)


def owning_copy(params):
    """``params`` with every tensor leaf replaced by a detached clone on
    its own device: storage no module, trainer or other snapshot shares."""
    if isinstance(params, dict):
        return {k: owning_copy(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().clone()
    return params


def _bound_ids(model: Module) -> Tuple[int, ...]:
    return tuple(id(t) for sub in model.param_dict().values()
                 for t in sub.values())


def _rebind(model: Module, params):
    """Bind ``model`` to owning copies of ``params``, unless it is still
    bound to the copies it took of this same tree (every replica of a set
    swapping in one promotion).  The mark holds ``params`` itself, so its
    identity cannot be reused while the mark stands, and the tensors' ids,
    so a module rebound by anyone else is copied again."""
    mark = getattr(model, "_rebound_from", None)
    if mark is not None and mark[0] is params \
            and mark[1] == _bound_ids(model):
        return
    model.load_param_dict(owning_copy(params))
    model._rebound_from = (params, _bound_ids(model))


class ModelRegistry:
    """Named, versioned models behind one serving engine."""

    def __init__(self):
        self._entries: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        # a hot-swap that hits a transient blip (an injected serving.swap
        # fault) retries briefly before the publisher sees a failure; the
        # old snapshot keeps serving throughout, so retrying is free of risk
        self._swap_retry = RetryPolicy(name="serving.swap")

    # -- registration ----------------------------------------------------- #
    def register(self, name: str, model: Module, *,
                 input_shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.float32, version: Optional[str] = None,
                 quantize_int8: bool = False,
                 calibration_data=None) -> ModelEntry:
        """Add ``model`` under ``name``.  It is served on the device its
        parameters live on.

        ``input_shape`` is one sample's feature shape (no batch dim); it
        is required for :meth:`~bigdl_tpu_torch.serving.ServingEngine.warmup`
        to run the bucket ladder (without it the first request of each
        bucket pays — and counts — a recompile).  The snapshot holds
        owning copies of the module's parameters and state (see the
        module docstring).

        ``quantize_int8=True`` serves
        :func:`bigdl_tpu_torch.quantized.quantize_for_serving` of
        ``model`` instead, with static activation scales from
        ``calibration_data`` (input batches) when given.  Such an entry is
        inference-only.
        """
        if quantize_int8:
            from ..quantized import quantize_for_serving
            model = quantize_for_serving(model,
                                         calibration_data=calibration_data)
        entry = ModelEntry(
            name, model, _snapshot(model, version or "v1"),
            None if input_shape is None else tuple(input_shape),
            np.dtype(dtype), _model_device(model),
            inference_only=quantize_int8,
            calibration_data=calibration_data if quantize_int8 else None)
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
        if entry.inference_only:
            raise ValueError(
                f"model {name!r} is int8/inference-only: its weights are "
                "constants of its modules; use swap_model() and re-warm")
        with entry.swap_lock:
            old = entry.snapshot
            new_params = old.params if params is None else params
            new_state = old.state if state is None else state

            def validate():
                faultplane.inject("serving.swap")
                _check_same_avals(f"{name}.params", old.params, new_params)
                _check_same_avals(f"{name}.state", old.state, new_state)
                return Snapshot(new_params, new_state,
                                version or entry.next_version())
            # transient-only retries; a ValueError (shape/dtype drift)
            # is fatal and raises with the old snapshot still serving
            snap = self._swap_retry.run(validate)
            entry.snapshot = snap          # the atomic publish
            # keep the module coherent for direct callers, on copies: a
            # trainer that adopts the module must never write into a
            # published snapshot
            _rebind(entry.model, new_params)
            if state is not None:
                entry.model.set_state(new_state)
            return snap

    def sync_from_model(self, name: str,
                        version: Optional[str] = None) -> Snapshot:
        """Republish from the module's own parameters (owning copies) —
        the bridge for code that updated the weights in place
        (``set_weights``, an in-process trainer)."""
        entry = self.get(name)
        return self.swap_weights(name, owning_copy(entry.model.param_dict()),
                                 owning_copy(entry.model.initial_state()),
                                 version=version)

    def swap_model(self, name: str, model: Module,
                   version: Optional[str] = None) -> ModelEntry:
        """Replace the module itself (a new architecture, or a new int8
        quantization).  Clears the engine's warmed runners — call
        ``engine.warmup(name)`` before taking traffic, or the next
        request per bucket pays a counted recompile.  The snapshot holds
        owning copies of ``model``'s parameters and state."""
        entry = self.get(name)
        with entry.swap_lock:
            entry.model = model
            entry.device = _model_device(model)
            entry.snapshot = _snapshot(model,
                                       version or entry.next_version())
            entry.compiled = {}
            entry.warmed = False
        return entry


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
