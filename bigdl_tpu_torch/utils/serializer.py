"""Module files, weights files and training-state files (≙
``bigdl_tpu/utils/serializer.py``): a zip of tagged JSON plus one
``.npy`` entry an array, with no pickle.

The container, its byte format and its version are the reference's, so
that each package reads the other's files:

- ``manifest.json`` — ``{"format": "bigdl_tpu.module", "version": 2}``
  (``.weights`` / ``.state`` appended for the other two kinds);
- ``topology.json`` (module files) — a flat table of every distinct
  module, ``{module, class, name, config, varargs?, children?, graph?,
  extra?, attrs?}``, shared submodules appearing once; ``weights.json``
  (weights files) — ``{params, state}``; ``state.json`` (state files) —
  the tree;
- values in the tagged encoding (``{"$a": key}`` an array, ``{"$t":
  [...]}`` a tuple, ``{"$dict": {...}}`` a dict, ``{"$dtype": name}`` a
  dtype, ``{"$m": index}`` a module of the table, ``{"$obj": {...}}`` a
  helper object by class and constructor config or attributes);
- ``arrays/aN.npy`` — each array.  The reference deflates its entries;
  the port stores them (``ZIP_STORED``: deflate ran at ~18 MB/s on one
  core, on floats that barely compress), and each reads either.

A module is rebuilt by calling its constructor with the decoded config
(captured at construction, ``nn.module._capture_config``); its
parameters come from the file's ``params`` (the flat layout of
``param_dict()``) and its state from ``state`` (``initial_state()``),
placed on the caller's device.  Module files name classes as the
reference does, ``bigdl_tpu.<module>:<qualname>``: the port writes its
own classes under those names and resolves each one to
``bigdl_tpu_torch.<module>:<qualname>`` by name, without importing
``bigdl_tpu``.  A class with no counterpart in the port raises
:class:`SerializationError` (ROADMAP queue A, item 9).  Tensors are
encoded through owning numpy copies; arrays decode to numpy.  A helper
object decodes only when its class lives in the port (or the reference's
namespace) or was passed to :func:`register_class`.

Not ported: the orbax layout (``save_pytree``, ``save_module_orbax``),
which needs ``orbax.checkpoint`` and so JAX (ROADMAP queue A, item 7),
and the legacy v1 pickle containers, whose payload holds JAX objects.
"""
from __future__ import annotations

import importlib
import inspect
import io
import json
import os
import types
import zipfile

import numpy as np
import torch

MAGIC = b"BIGDLTPU"          # the reference's legacy v1 pickle container
VERSION = 2
_FORMAT = "bigdl_tpu.module"
_STATE_FORMAT = _FORMAT + ".state"
_WEIGHTS_FORMAT = _FORMAT + ".weights"
_PACKAGE = "bigdl_tpu_torch"
_REF_PACKAGE = "bigdl_tpu"
_UNPORTED = "ROADMAP queue A, item 9"

# classes outside bigdl_tpu_torch that the loaders may instantiate
_CLASS_REGISTRY = {}


def register_class(cls):
    """Allow a user-defined Module or helper class to be (de)serialized."""
    _CLASS_REGISTRY[f"{cls.__module__}:{cls.__qualname__}"] = cls
    return cls


class SerializationError(ValueError):
    pass


def _in_package(modname: str, package: str) -> bool:
    return modname == package or modname.startswith(package + ".")


def _loadable(modname: str, key: str) -> bool:
    return (key in _CLASS_REGISTRY or _in_package(modname, _PACKAGE)
            or _in_package(modname, _REF_PACKAGE))


def _file_module_name(modname: str) -> str:
    """The module name a module file records for a port class: the
    reference's (``bigdl_tpu_torch.nn.linear`` -> ``bigdl_tpu.nn.linear``)."""
    if _in_package(modname, _PACKAGE):
        return _REF_PACKAGE + modname[len(_PACKAGE):]
    return modname


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
    """``ref_names`` writes the port's classes under the reference's
    names (module and weights files); state files keep the port's."""

    def __init__(self, ref_names: bool = False):
        self.ref_names = ref_names
        self.nodes = []            # module table entries (JSON dicts)
        self.index = {}            # id(module) -> table index
        self.arrays = {}           # "arrays/aN.npy" -> np.ndarray

    def class_ref(self, cls) -> dict:
        mod = _file_module_name(cls.__module__) if self.ref_names \
            else cls.__module__
        return {"module": mod, "class": cls.__qualname__}

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
            from ..nn.module import Module
            if not isinstance(v, Module):
                raise SerializationError(
                    f"{where}: {type(v).__name__} is not a bigdl_tpu_torch "
                    "Module")
            return {"$m": self.module(v)}
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
                          types.MethodType, torch.Generator)):
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
        entry = self.class_ref(cls)
        serde = getattr(v, "_serde", None)
        if serde is not None and serde.get("config") is not None:
            cfg = dict(serde["config"])
            if "name" in cfg and getattr(v, "name", None) is not None:
                cfg["name"] = v.name
            entry["config"] = {k: self.value(x, f"{where}.{k}")
                               for k, x in cfg.items()}
            if serde.get("varargs"):
                entry["varargs"] = serde["varargs"]
            return entry
        try:
            attrs = vars(v)
        except TypeError:
            raise SerializationError(
                f"{where}: {cls.__name__} has no inspectable state") from None
        state = {k: x for k, x in attrs.items()
                 if k not in ("output", "grad_input", "_serde")
                 and not callable(x)}
        entry["state"] = {k: self.value(x, f"{where}.{k}")
                          for k, x in state.items()}
        return entry

    def module(self, m) -> int:
        from ..nn.graph import Graph
        from ..nn.module import Module
        if id(m) in self.index:
            return self.index[id(m)]
        idx = len(self.nodes)
        self.index[id(m)] = idx
        entry = self.class_ref(type(m))
        entry["name"] = m.name
        self.nodes.append(entry)   # reserve the slot before the children
        cls = type(m)
        key = f"{cls.__module__}:{cls.__qualname__}"
        if not _loadable(cls.__module__, key):
            raise SerializationError(
                f"{m.name}: cannot serialize {key!r}; only {_PACKAGE} "
                "classes and serializer.register_class'd classes are "
                "loadable")
        custom_build = (cls._serde_build.__func__
                        is not Module._serde_build.__func__)
        cfg = m._serde_config()
        if cfg is None and not (isinstance(m, Graph) or custom_build):
            raise SerializationError(
                f"{m.name} ({cls.__qualname__}): constructor args were not "
                "captured; give the class an inspectable __init__ or a "
                "_serde_build classmethod")
        if isinstance(m, Graph):
            entry["graph"] = self.graph(m)
        else:
            if cfg is not None:
                if "name" in cfg:
                    cfg["name"] = m.name
                entry["config"] = {k: self.value(v, f"{m.name}.{k}")
                                   for k, v in cfg.items()}
                serde = m.__dict__.get("_serde")
                if serde and serde.get("varargs"):
                    entry["varargs"] = serde["varargs"]
            # children only where the class re-attaches them on load (the
            # default restore does nothing: the constructor rebuilds them)
            restores = (cls._serde_restore_children
                        is not Module._serde_restore_children)
            if restores or custom_build:
                kids = m._serde_children()
                if any(c is not None for c in kids):
                    entry["children"] = [None if c is None else self.module(c)
                                         for c in kids]
            extra = {k: self.value(getattr(m, k, None), f"{m.name}.{k}")
                     for k in cls._serde_extra_attrs}
            if extra:
                entry["extra"] = extra
        attrs = {}
        for k in ("weight_init", "bias_init", "w_regularizer",
                  "b_regularizer"):
            if getattr(m, k, None) is not None:
                attrs[k] = self.value(getattr(m, k), f"{m.name}.{k}")
        for k in ("scale_w", "scale_b"):
            if getattr(m, k, 1.0) != 1.0:
                attrs[k] = getattr(m, k)
        if attrs:
            entry["attrs"] = attrs
        return idx

    def graph(self, g) -> dict:
        """The node DAG of a Graph: modules by table index, and edges."""
        gnodes = list(g._topo)
        gidx = {id(n): i for i, n in enumerate(gnodes)}
        return {
            "nodes": [{"m": None if n.module is None else self.module(n.module),
                       "prev": [gidx[id(p)] for p in n.prev_nodes]}
                      for n in gnodes],
            "inputs": [gidx[id(n)] for n in g.input_nodes],
            "outputs": [gidx[id(n)] for n in g.output_nodes],
        }


class _Decoder:
    def __init__(self, read_array, nodes=()):
        self.read_array = read_array
        self.nodes = list(nodes)
        self.built = {}

    @staticmethod
    def resolve_class(modname, qualname):
        """The port's class for a recorded ``module:qualname``: a
        registered class, or the same name under ``bigdl_tpu_torch`` (a
        reference name ``bigdl_tpu.<module>`` is mapped by name)."""
        key = f"{modname}:{qualname}"
        if key in _CLASS_REGISTRY:
            return _CLASS_REGISTRY[key]
        if _in_package(modname, _REF_PACKAGE):
            target = _PACKAGE + modname[len(_REF_PACKAGE):]
        elif _in_package(modname, _PACKAGE):
            target = modname
        else:
            raise SerializationError(
                f"refusing to import {key!r}: only {_PACKAGE} classes, the "
                f"reference's {_REF_PACKAGE} classes by name, and "
                "serializer.register_class'd classes are loadable")
        try:
            obj = importlib.import_module(target)
            for part in qualname.split("."):
                obj = getattr(obj, part)
        except (ImportError, AttributeError):
            raise SerializationError(
                f"class {key!r} has no counterpart in {_PACKAGE} "
                f"({target}:{qualname} is not ported; {_UNPORTED})") from None
        return obj

    def value(self, v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, list):
            return [self.value(e) for e in v]
        if isinstance(v, dict):
            if "$m" in v:
                return self.module(v["$m"])
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

    @staticmethod
    def _user_code(fn, *a, **kw):
        """Run a rebuilt class's code (constructor, setattr); mark its
        errors so that the loaders re-raise them as they are, not as a
        corrupt file."""
        try:
            return fn(*a, **kw)
        except Exception as e:
            try:
                e._bigdl_user_error = True
            except Exception:
                pass
            raise

    def construct(self, cls, entry):
        cfg = {k: self.value(v) for k, v in entry.get("config", {}).items()}
        params = inspect.signature(cls.__init__).parameters
        gen = params.get("gen")
        if gen is not None and gen.default is inspect.Parameter.empty:
            # the port's constructors draw their weights from a generator;
            # the file's weights replace them
            cfg["gen"] = torch.Generator().manual_seed(0)
        varargs = entry.get("varargs")
        if varargs and varargs in cfg:
            pos, va = [], cfg.pop(varargs)
            for p in params.values():
                if p.name == "self":
                    continue
                if p.kind is p.VAR_POSITIONAL:
                    break
                if p.name in cfg:
                    pos.append(cfg.pop(p.name))
            return self._user_code(cls, *pos, *va, **cfg)
        return self._user_code(cls, **cfg)

    def object(self, entry):
        cls = self.resolve_class(entry["module"], entry["class"])
        if "config" in entry:
            return self.construct(cls, entry)
        obj = cls.__new__(cls)
        for k, x in entry.get("state", {}).items():
            self._user_code(setattr, obj, k, self.value(x))
        return obj

    def module(self, idx):
        from ..nn.module import Module
        if not isinstance(idx, int) or not 0 <= idx < len(self.nodes):
            raise SerializationError(f"dangling module reference {idx!r} "
                                     f"(file has {len(self.nodes)} nodes)")
        if idx in self.built:
            return self.built[idx]
        entry = self.nodes[idx]
        cls = self.resolve_class(entry["module"], entry["class"])
        if not (isinstance(cls, type) and issubclass(cls, Module)):
            raise SerializationError(
                f"{entry['module']}:{entry['class']} is not a Module")
        custom_build = (cls._serde_build.__func__
                        is not Module._serde_build.__func__)
        if "graph" in entry:
            m = self.graph(cls, entry["graph"])
        elif custom_build:
            cfg = {k: self.value(v)
                   for k, v in entry.get("config", {}).items()}
            m = cls._serde_build(cfg, self._children_of(entry))
            if m is None:           # the documented fallback: replay
                m = self.construct(cls, entry)
        else:
            m = self.construct(cls, entry)
        if m.name != entry["name"]:
            m.name = entry["name"]
        self.built[idx] = m
        if not custom_build and "children" in entry:
            m._serde_restore_children(self._children_of(entry))
        for k, v in entry.get("extra", {}).items():
            self._user_code(setattr, m, k, self.value(v))
        for k, v in entry.get("attrs", {}).items():
            self._user_code(setattr, m, k, self.value(v)
                            if isinstance(v, (dict, list)) else v)
        return m

    def _children_of(self, entry):
        return [None if i is None else self.module(i)
                for i in entry.get("children", [])]

    def graph(self, cls, g):
        from ..nn.graph import Node
        nodes = []
        for spec in g["nodes"]:
            mod = None if spec["m"] is None else self.module(spec["m"])
            nodes.append(Node(mod, [nodes[i] for i in spec["prev"]]))
        return self._user_code(cls, [nodes[i] for i in g["inputs"]],
                               [nodes[i] for i in g["outputs"]])


def _payload_zip_bytes(fmt, payload_name, payload, arrays) -> bytes:
    """The zip container as bytes, its entries stored (the checkpoint
    writer streams these through its CRC and fault-injection path)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json",
                   json.dumps({"format": fmt, "version": VERSION}))
        z.writestr(payload_name, json.dumps(payload))
        for key, arr in arrays.items():
            abuf = io.BytesIO()
            np.save(abuf, arr, allow_pickle=False)
            z.writestr(key, abuf.getvalue())
    return buf.getvalue()


def _write_file(path, data: bytes):
    """tmp + fsync + ``os.replace``: a crash mid-write never leaves a
    short file under ``path``, nor corrupts the file it replaces."""
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


def _read_payload_zip(path, fmt, payload_name, desc, build):
    """The manifest-checked zip read shared by the loaders:
    ``build(payload, read_array)`` runs with the zip open, so that arrays
    are read one at a time.  A corrupt or foreign file raises
    :class:`SerializationError`; an error raised by a rebuilt class's own
    code propagates as it is."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
    if head == MAGIC:
        raise SerializationError(
            f"{path}: a legacy v1 bigdl_tpu container (a pickle of JAX "
            "objects); the port reads only the v2 zip format — load and "
            "save it again with bigdl_tpu first")
    if not zipfile.is_zipfile(path):
        raise SerializationError(f"{path}: not a bigdl_tpu {desc} file")
    try:
        z = zipfile.ZipFile(path)
    except zipfile.BadZipFile as e:
        raise SerializationError(
            f"{path}: corrupt or truncated {desc} file ({e})") from e
    with z:
        try:
            manifest = json.loads(z.read("manifest.json"))
            if manifest.get("format") != fmt:
                raise SerializationError(
                    f"{path}: manifest says {manifest.get('format')!r}, "
                    f"expected a {desc} file")
            if manifest.get("version", 0) > VERSION:
                raise SerializationError(
                    f"{path}: unsupported version {manifest['version']}")
            payload = json.loads(z.read(payload_name))
        except (zipfile.BadZipFile, json.JSONDecodeError, KeyError,
                UnicodeDecodeError, EOFError, OSError) as e:
            raise SerializationError(
                f"{path}: corrupt or truncated {desc} file ({e})") from e

        def read_array(key):
            try:    # zip CRC and npy header are both checked here
                return np.load(io.BytesIO(z.read(key)), allow_pickle=False)
            except Exception as e:
                raise SerializationError(
                    f"{path}: broken array {key!r} ({e})") from e

        try:
            return build(payload, read_array)
        except SerializationError:
            raise
        except Exception as e:
            if getattr(e, "_bigdl_user_error", False):
                raise
            raise SerializationError(
                f"{path}: corrupt {desc} payload "
                f"({type(e).__name__}: {e})") from e


def state_file_bytes(tree) -> bytes:
    """:func:`save_state_file`'s container as bytes.  Raises
    :class:`SerializationError` for a value the format cannot hold."""
    enc = _Encoder()
    payload = enc.value(tree, "state")
    if enc.nodes:
        raise SerializationError(
            "state tree contains Module instances; save them with "
            "save_module / Module.save instead")
    return _payload_zip_bytes(_STATE_FORMAT, "state.json", payload,
                              enc.arrays)


def save_state_file(tree, path):
    """Write a training-state tree; raises :class:`SerializationError`
    before any byte is written when the tree holds a value the format
    cannot hold."""
    _write_file(path, state_file_bytes(tree))


def load_state_file(path):
    """Inverse of :func:`save_state_file` (arrays as numpy); raises
    :class:`SerializationError` on a corrupt, truncated or foreign file
    instead of unpickling anything."""
    return _read_payload_zip(
        path, _STATE_FORMAT, "state.json", "state",
        lambda payload, read_array: _Decoder(read_array).value(payload))


# --------------------------------------------------------------------- #
# module and weights files                                              #
# --------------------------------------------------------------------- #
def _weights_payload(enc, module) -> dict:
    return {"params": enc.value(module.param_dict(), "params"),
            "state": enc.value(module.initial_state(), "state")}


def save_module(module, path, overwrite=True):
    """Write ``module`` as a module file: its topology (classes,
    constructor configs, shared submodules once), parameters and state."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    enc = _Encoder(ref_names=True)
    root = enc.module(module)
    topo = {"root": root, "nodes": enc.nodes,
            **_weights_payload(enc, module)}
    _write_file(path, _payload_zip_bytes(_FORMAT, "topology.json", topo,
                                         enc.arrays))


@torch.no_grad()
def place_weights(module, params, state) -> None:
    """Give ``module`` the host ``params`` (the flat layout of
    ``param_dict()``) and ``state`` (``initial_state()``) on its device:
    every parameter and buffer of the module must be in the file with its
    shape, else :class:`SerializationError` names the first that is not."""
    from .._device import model_device
    mine = module.param_dict()
    names = sorted((m, k) for m, sub in mine.items() for k in sub)
    given = sorted((m, k) for m, sub in (params or {}).items() for k in sub)
    if names != given:
        missing = sorted(set(names) - set(given))[:3]
        extra = sorted(set(given) - set(names))[:3]
        raise SerializationError(
            f"the file's params do not match the model: missing {missing}, "
            f"unexpected {extra}")
    dev = model_device(module) if names else None
    new = {}
    for m, k in names:
        arr = np.asarray(params[m][k])
        old = mine[m][k]
        if tuple(arr.shape) != tuple(old.shape):
            raise SerializationError(
                f"param {m}/{k} is {arr.shape} in the file, "
                f"{tuple(old.shape)} in the model")
        new.setdefault(m, {})[k] = torch.from_numpy(
            np.array(arr, copy=True)).to(device=dev, dtype=old.dtype)
    module.load_param_dict(new)
    st = state or {}
    if st or module.initial_state():
        try:
            module.set_state({m: {k: torch.from_numpy(np.array(v, copy=True))
                                  for k, v in sub.items()}
                              for m, sub in st.items()})
        except ValueError as e:
            raise SerializationError(f"the file's state: {e}") from e


def load_module(path, device=None):
    """The module a module file describes, rebuilt by constructor replay
    with the file's parameters and state, on ``device`` (``cuda`` unless
    the caller asks for ``"cpu"``).  Reads the reference's module files
    too (class names mapped by name onto the port)."""
    from .._device import resolve_device
    dev = resolve_device(device)

    def build(topo, read_array):
        dec = _Decoder(read_array, topo["nodes"])
        module = dec.module(topo["root"])
        params = None if topo.get("params") is None \
            else dec.value(topo["params"])
        state = dec.value(topo.get("state") or {"$dict": {}})
        module.to(dev)
        if params is not None:
            place_weights(module, params, state)
        return module

    return _read_payload_zip(path, _FORMAT, "topology.json", "module",
                             build)


def save_weights_file(module, path):
    """Parameters and state only (no topology), in the same format."""
    enc = _Encoder(ref_names=True)
    _write_file(path, _payload_zip_bytes(
        _WEIGHTS_FORMAT, "weights.json", _weights_payload(enc, module),
        enc.arrays))


def load_weights_file(path):
    """``(params, state)`` of a weights file as numpy trees (the
    reference's legacy pickle pair is refused: it holds JAX arrays)."""
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            head = f.read(2)
        if len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5:
            raise SerializationError(
                f"{path}: a legacy pickled weights file (JAX arrays); the "
                "port reads only the v2 zip format")

    def build(payload, read_array):
        if "params" not in payload or "state" not in payload:
            raise SerializationError(
                f"{path}: weights payload is missing params/state")
        dec = _Decoder(read_array)
        return dec.value(payload["params"]), dec.value(payload["state"])

    return _read_payload_zip(path, _WEIGHTS_FORMAT, "weights.json",
                             "weights", build)


def topology_dict(module, params=None):
    """A JSON-able summary of the structure: class, name, parameter shapes
    and children (the reference's ``children()`` order)."""
    if params is None:
        params = module.param_dict()
    entry = {"class": type(module).__name__, "name": module.name}
    if params and module.name in params:
        entry["params"] = {k: list(np.shape(v))
                           for k, v in params[module.name].items()}
    children = module._ref_children()
    if children:
        entry["children"] = [topology_dict(c, params) for c in children]
    return entry


__all__ = ["MAGIC", "SerializationError", "load_module", "load_state_file",
           "load_weights_file", "place_weights", "register_class",
           "save_module", "save_state_file", "save_weights_file",
           "state_file_bytes", "topology_dict"]
