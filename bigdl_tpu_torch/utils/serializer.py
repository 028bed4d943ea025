"""Training-state files (≙ the state-file half of
``bigdl_tpu/utils/serializer.py``): a tree of dicts, tuples, lists,
arrays, scalars and registered helper objects as a zip of tagged JSON
plus one ``.npy`` entry an array, with no pickle.

The container, its byte format and its version are the reference's, so
that each package reads the other's files:

- ``manifest.json`` — ``{"format": "bigdl_tpu.module.state", "version": 2}``;
- ``state.json``    — the tree in the tagged encoding (``{"$a": key}`` an
  array, ``{"$t": [...]}`` a tuple, ``{"$dict": {...}}`` a dict,
  ``{"$dtype": name}`` a dtype, ``{"$obj": {...}}`` a helper object by
  class and attributes);
- ``arrays/aN.npy`` — each array, ``ZIP_DEFLATED``.

Tensors are encoded through owning numpy copies (the caller may update
them in place after the call returns); arrays decode to numpy, and the
caller places them on its device.  A helper object decodes only when its
class lives in ``bigdl_tpu_torch`` or was passed to
:func:`register_class`.  The module half (``save_module``,
``topology_dict``, orbax) is not ported yet (ROADMAP queue A, item 7).
"""
from __future__ import annotations

import importlib
import io
import json
import os
import types
import zipfile

import numpy as np
import torch

VERSION = 2
_FORMAT = "bigdl_tpu.module"
_STATE_FORMAT = _FORMAT + ".state"
_PACKAGE = "bigdl_tpu_torch"

# classes outside bigdl_tpu_torch that load_state_file may instantiate
_CLASS_REGISTRY = {}


def register_class(cls):
    """Allow a user-defined helper class to be (de)serialized."""
    _CLASS_REGISTRY[f"{cls.__module__}:{cls.__qualname__}"] = cls
    return cls


class SerializationError(ValueError):
    pass


def _loadable(modname: str, key: str) -> bool:
    return (key in _CLASS_REGISTRY or modname == _PACKAGE
            or modname.startswith(_PACKAGE + "."))


def _host_array(v) -> np.ndarray:
    """An owning numpy copy of a tensor or array (``.numpy()`` of a CPU
    tensor shares its memory, and a CUDA ``.cpu()`` is the only copy)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            raise SerializationError(
                "bf16 tensors have no numpy dtype; cast to float32 first")
        return t.cpu().numpy().copy()
    return np.array(v)


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray, np.generic))


def _is_dtype(v) -> bool:
    if isinstance(v, np.dtype):
        return True
    try:
        return isinstance(v, type) and issubclass(v, np.generic)
    except TypeError:
        return False


class _Encoder:
    def __init__(self):
        self.arrays = {}           # "arrays/aN.npy" -> np.ndarray

    def array_ref(self, v, where=""):
        arr = _host_array(v)
        if arr.dtype.kind not in "biufc":
            raise SerializationError(
                f"{where}: array dtype {arr.dtype} is not serializable "
                "(numeric/bool arrays only)")
        key = f"arrays/a{len(self.arrays)}.npy"
        self.arrays[key] = arr
        return {"$a": key}

    def value(self, v, where=""):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, (bytes, bytearray, set, frozenset, complex)):
            raise SerializationError(
                f"{where}: {type(v).__name__} values are not serializable")
        if isinstance(v, torch.nn.Module):
            raise SerializationError(
                f"{where}: state tree contains a Module; module files are "
                "not ported yet")
        if _is_dtype(v):
            return {"$dtype": np.dtype(v).name}
        if _is_array(v):
            return self.array_ref(v, where)
        if isinstance(v, tuple):
            return {"$t": [self.value(e, where) for e in v]}
        if isinstance(v, list):
            return [self.value(e, where) for e in v]
        if isinstance(v, dict):
            bad = [k for k in v if not isinstance(k, str)]
            if bad:
                raise SerializationError(
                    f"{where}: dict key {bad[0]!r} is not a string")
            return {"$dict": {k: self.value(e, where) for k, e in v.items()}}
        if isinstance(v, (types.FunctionType, types.BuiltinFunctionType,
                          types.MethodType)):
            raise SerializationError(
                f"{where}: cannot serialize function {v!r}; use a registered "
                "class instead")
        return {"$obj": self.object(v, where)}

    def object(self, v, where):
        cls = type(v)
        key = f"{cls.__module__}:{cls.__qualname__}"
        # a file that cannot be loaded back must not be writable
        if not _loadable(cls.__module__, key):
            raise SerializationError(
                f"{where}: cannot serialize {key!r}; only {_PACKAGE} classes "
                "and serializer.register_class'd classes are loadable")
        try:
            attrs = vars(v)
        except TypeError:
            raise SerializationError(
                f"{where}: {cls.__name__} has no inspectable state") from None
        state = {k: x for k, x in attrs.items() if not callable(x)}
        return {"module": cls.__module__, "class": cls.__qualname__,
                "state": {k: self.value(x, f"{where}.{k}")
                          for k, x in state.items()}}


class _Decoder:
    def __init__(self, read_array):
        self.read_array = read_array

    @staticmethod
    def resolve_class(modname, qualname):
        key = f"{modname}:{qualname}"
        if key in _CLASS_REGISTRY:
            return _CLASS_REGISTRY[key]
        if not _loadable(modname, key):
            raise SerializationError(
                f"refusing to import {key!r}: only {_PACKAGE} classes and "
                "serializer.register_class'd classes are loadable")
        obj = importlib.import_module(modname)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        return obj

    def value(self, v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, list):
            return [self.value(e) for e in v]
        if isinstance(v, dict):
            if "$a" in v:
                return self.read_array(v["$a"])
            if "$t" in v:
                return tuple(self.value(e) for e in v["$t"])
            if "$dtype" in v:
                try:
                    return np.dtype(v["$dtype"]).type
                except TypeError as e:
                    raise SerializationError(
                        f"bad $dtype tag {v['$dtype']!r}") from e
            if "$dict" in v:
                return {k: self.value(e) for k, e in v["$dict"].items()}
            if "$obj" in v:
                return self.object(v["$obj"])
        raise SerializationError(f"undecodable value {v!r}")

    def object(self, entry):
        cls = self.resolve_class(entry["module"], entry["class"])
        obj = cls.__new__(cls)
        for k, x in entry.get("state", {}).items():
            setattr(obj, k, self.value(x))
        return obj


def _payload_zip_bytes(fmt, payload_name, payload, arrays) -> bytes:
    """The zip container as bytes (the checkpoint writer streams these
    through its CRC and fault-injection path)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json",
                   json.dumps({"format": fmt, "version": VERSION}))
        z.writestr(payload_name, json.dumps(payload))
        for key, arr in arrays.items():
            abuf = io.BytesIO()
            np.save(abuf, arr, allow_pickle=False)
            z.writestr(key, abuf.getvalue())
    return buf.getvalue()


def state_file_bytes(tree) -> bytes:
    """:func:`save_state_file`'s container as bytes.  Raises
    :class:`SerializationError` for a value the format cannot hold."""
    enc = _Encoder()
    payload = enc.value(tree, "state")
    return _payload_zip_bytes(_STATE_FORMAT, "state.json", payload,
                              enc.arrays)


def save_state_file(tree, path):
    """Write a training-state tree (tmp + fsync + ``os.replace``); raises
    :class:`SerializationError` before any byte is written when the tree
    holds a value the format cannot hold."""
    data = state_file_bytes(tree)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_state_file(path):
    """Inverse of :func:`save_state_file` (arrays as numpy); raises
    :class:`SerializationError` on a corrupt, truncated or foreign file
    instead of unpickling anything."""
    if not zipfile.is_zipfile(path):
        raise SerializationError(f"{path}: not a bigdl_tpu state file")
    try:
        z = zipfile.ZipFile(path)
    except zipfile.BadZipFile as e:
        raise SerializationError(
            f"{path}: corrupt or truncated state file ({e})") from e
    with z:
        try:
            manifest = json.loads(z.read("manifest.json"))
            if manifest.get("format") != _STATE_FORMAT:
                raise SerializationError(
                    f"{path}: manifest says {manifest.get('format')!r}, "
                    "expected a state file")
            if manifest.get("version", 0) > VERSION:
                raise SerializationError(
                    f"{path}: unsupported version {manifest['version']}")
            payload = json.loads(z.read("state.json"))
        except (zipfile.BadZipFile, json.JSONDecodeError, KeyError) as e:
            raise SerializationError(
                f"{path}: corrupt or truncated state file ({e})") from e

        def read_array(key):
            try:    # zip CRC and npy header are both checked here
                return np.load(io.BytesIO(z.read(key)), allow_pickle=False)
            except Exception as e:
                raise SerializationError(
                    f"{path}: broken array {key!r} ({e})") from e

        try:
            return _Decoder(read_array).value(payload)
        except SerializationError:
            raise
        except Exception as e:
            raise SerializationError(
                f"{path}: corrupt state payload "
                f"({type(e).__name__}: {e})") from e


__all__ = ["SerializationError", "load_state_file", "register_class",
           "save_state_file", "state_file_bytes"]
