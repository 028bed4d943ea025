"""Core module abstraction: the functional core and the Torch shell.

Port of ``bigdl_tpu/nn/module.py``.  A module is a ``torch.nn.Module``
that also keeps the reference's two faces.

The functional core:

  - ``apply(params, x, ctx) -> y``: a forward that reads its weights from
    the flat dict ``params`` (``{module_name: {"weight": tensor, ...}}``)
    through :meth:`Module.own`, never from ``self``.  A serving snapshot
    is such a dict, so one batch runs against exactly the weights it was
    handed.
  - ``run(params, x[, state, training, generator, draws]) -> (y,
    new_state)``: the functional entry point.

The Torch shell (the reference's ``forward``/``backward`` on cached
activity): :meth:`Module.forward` runs the module in its mode on its own
weights and state, keeps ``self.output`` and, in training mode, writes the
batch-norm state back; :meth:`Module.backward` replays the same stochastic
pass and *accumulates* into ``self.grad_params`` (the flat layout);
``update_output``, ``update_grad_input``, ``zero_grad_parameters``,
``update_parameters(lr)`` (frozen modules skipped) and
``get_parameters()`` as in the reference.

Names shared with ``torch.nn.Module`` keep torch's meaning, one rule per
name, so that ``.to(device)``, ``state_dict()`` and the optimizers keep
working:

  - ``forward`` and ``__call__`` are the reference's: torch's
    ``__call__`` calls ``forward`` (the mode is the module's, not the
    caller's; ``generator=`` stands in for ``rng=``);
  - ``training`` is torch's bool attribute; :meth:`train` stands in for
    the reference's ``training()``, :meth:`evaluate` (no arguments) and
    torch's ``eval()`` switch to inference, :meth:`is_training` reads
    the flag.  A new module starts in inference mode, as the reference's
    does (torch's default is training);
  - ``parameters()``, ``children()`` and ``modules()`` are torch's
    iterators; :meth:`param_dict` stands in for the reference's
    ``parameters()`` (the flat dict), ``list(m.children())`` and
    ``list(m.modules())`` for its lists;
  - ``apply`` is the reference's functional forward (it shadows torch's
    ``apply(fn)``; the port walks modules with ``modules()`` instead).

``evaluate(dataset, batch_size, methods)`` runs
:class:`~bigdl_tpu_torch.optim.predictor.Evaluator`.

Weights live as ``nn.Parameter`` s on the module and
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

Random draws (dropout's masks, Gaussian noise) come from the
``torch.Generator`` the ``Ctx`` carries (the training loop's, which its
``seed`` seeds), through :meth:`Ctx.draw`; ``Ctx.draws`` can hand a module
its draws by name instead (the seam the parity tests feed the reference's
``jax.random`` draws through).
"""
from __future__ import annotations

import functools
import inspect
import itertools
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

_uid_counter = itertools.count()

Params = Dict[str, Dict[str, torch.Tensor]]


def _capture_config(cls):
    """Wrap ``cls.__init__`` so that constructing an instance records the
    bound constructor arguments on ``self._serde`` (the outermost class
    wins): a saved model is "class + config + children", rebuilt by
    calling the constructor (``utils/serializer.py``), never a pickle.

    The port's ``gen`` argument (the ``torch.Generator`` a constructor
    draws its weights from; the reference's constructors have no such
    argument), or any other generator, is left out of the config: a
    loaded module takes its weights from the file."""
    orig = cls.__init__
    if getattr(orig, "_captures_config", False):
        return
    try:
        sig = inspect.signature(orig)
    except (ValueError, TypeError):     # C-level or exotic signature
        return
    varargs = next((p.name for p in sig.parameters.values()
                    if p.kind is p.VAR_POSITIONAL), None)

    @functools.wraps(orig)
    def __init__(self, *args, **kwargs):
        if "_serde" not in self.__dict__:
            rec = {"class": type(self), "varargs": varargs, "config": None}
            object.__setattr__(self, "_serde", rec)
            try:
                bound = sig.bind(self, *args, **kwargs)
                bound.apply_defaults()
                cfg = {}
                for pname, p in sig.parameters.items():
                    if pname == "self" or pname not in bound.arguments:
                        continue
                    v = bound.arguments[pname]
                    if p.kind is p.VAR_POSITIONAL:
                        cfg[pname] = list(v)
                    elif p.kind is p.VAR_KEYWORD:
                        cfg.update(v)
                    elif pname != "gen" and not isinstance(
                            v, torch.Generator):
                        cfg[pname] = v
                rec["config"] = cfg
            except TypeError:
                pass
        orig(self, *args, **kwargs)

    __init__._captures_config = True
    cls.__init__ = __init__


def migrate_legacy_names(tree, module):
    """Rename dict keys written before auto names were zero-padded
    (``Linear_12`` -> ``Linear_00000012``) wherever the padded form is
    one of ``module``'s parameter or state names; the tree as it is when
    every key is already in the current format."""
    def has_legacy(t):
        if isinstance(t, dict):
            return any(re.fullmatch(r".*_\d{1,7}", k) or has_legacy(v)
                       for k, v in t.items())
        if isinstance(t, (list, tuple)):
            return any(has_legacy(v) for v in t)
        return False

    if not has_legacy(tree):
        return tree
    expected = set()
    for flat in (module.param_dict(), module.initial_state()):
        expected.update(flat)
        for sub in flat.values():
            expected.update(sub)

    def pad(k):
        m = re.fullmatch(r"(.*_)(\d{1,7})", k)
        return f"{m.group(1)}{int(m.group(2)):08d}" if m else k

    def migrate(t):
        if isinstance(t, dict):
            return {k if k in expected or pad(k) not in expected
                    else pad(k): migrate(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(migrate(v) for v in t)
        return t

    return migrate(tree)


class Ctx:
    """Per-call context threaded through ``apply``: the training flag,
    persistent state in/out dicts, the side losses a layer adds to the
    training loss (which the training loops sum), the ``torch.Generator``
    the step's random draws come from, ``draws``: draws given by module
    name, which a module takes instead of drawing (:meth:`draw`), and
    ``shard``: this rank's share of a step sharded over a mesh
    (:class:`~bigdl_tpu_torch.parallel.spmd.Shard`), None on one
    device."""

    __slots__ = ("training", "state", "new_state", "side_losses",
                 "generator", "draws", "shard")

    def __init__(self, state=None, training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, Any]] = None, shard=None):
        self.training = training
        self.state = state or {}
        self.new_state: Dict[str, Any] = {}
        self.side_losses: List[torch.Tensor] = []
        self.generator = generator
        self.draws = draws or {}
        # this rank's share of a sharded step (parallel.spmd.Shard), or
        # None on one device
        self.shard = shard

    def rng(self, module) -> torch.Generator:
        if self.generator is None:
            raise ValueError(
                f"{module.name}: this module needs a generator in training "
                f"mode; pass generator= to run()/forward()")
        return self.generator

    def draw(self, module, device, sample):
        """``module``'s random draw: the one ``draws`` carries under its
        name (moved to ``device``), else ``sample(generator)``."""
        given = self.draws.get(module.name)
        if given is not None:
            return torch.as_tensor(given, device=device)
        return sample(self.rng(module))

    def get_state(self, module):
        return self.state.get(module.name)

    def put_state(self, module, value):
        self.new_state[module.name] = value

    def add_loss(self, value):
        self.side_losses.append(value)


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

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "__init__" in cls.__dict__:
            _capture_config(cls)

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self._uid = next(_uid_counter)
        self.name = name or f"{type(self).__name__}_{self._uid:08d}"
        # the reference's modules start in inference mode
        self.training = False
        # Torch-shell state: the last activity, the accumulated gradients
        # (flat layout) and what backward needs to replay forward's draws
        self.output = None
        self.grad_input = None
        self.grad_params: Optional[Params] = None
        self._forward_seed = int(np.random.randint(0, 2 ** 31))
        self._shell_gen: Optional[torch.Generator] = None
        self._last_pass = None

    # -- functional core ------------------------------------------------ #
    def apply(self, params: Params, x, ctx: Ctx):   # noqa: D401
        """Pure forward from ``params``. Subclasses implement it."""
        raise NotImplementedError(type(self).__name__)

    def own(self, params: Params) -> Dict[str, torch.Tensor]:
        return params.get(self.name, {})

    def run(self, params: Params, x, state=None, training: bool = False,
            generator: Optional[torch.Generator] = None, draws=None):
        """(params, x[, state, training, generator, draws]) ->
        (y, new_state)."""
        ctx = Ctx(state=state, training=training, generator=generator,
                  draws=draws)
        y = self.apply(params, x, ctx)
        out_state = dict(state or {})
        out_state.update(ctx.new_state)
        return y, out_state

    def _ref_modules(self) -> List["Module"]:
        """This module and its descendants, depth first (the reference's
        ``Module.modules()``)."""
        return [m for m in self.modules() if isinstance(m, Module)]

    def _device_tensors(self):
        """The tensors this module holds itself (not its children's),
        which place it on a device: its parameters and buffers."""
        return itertools.chain(self.parameters(recurse=False),
                               self.buffers(recurse=False))

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

    # -- serde hooks (utils/serializer.py) -------------------------------- #
    # extra instance attributes to persist beside the constructor config
    _serde_extra_attrs = ()

    def _ref_children(self) -> List["Module"]:
        """The reference's ``children()``: the direct child modules of the
        port, with a torch container that is not a port module (the
        ``ModuleList`` of a model's blocks) replaced by its children."""
        out = []
        # _modules, not children(): a child registered twice (a shared
        # submodule) is listed twice, as the reference lists it
        for c in self._modules.values():
            if c is not None:
                out.extend([c] if isinstance(c, Module) else
                           Module._ref_children(c))
        return out

    def _serde_children(self):
        """Children to persist (None entries allowed as placeholders)."""
        return self._ref_children()

    def _serde_restore_children(self, children):
        """Re-attach decoded children after the constructor replay.  The
        default does nothing: right for leaves and for modules whose
        constructor rebuilds their children from the config.  A class
        that takes children after construction overrides it."""

    def _serde_config(self):
        """The constructor config to persist; None when the module cannot
        be rebuilt from it (the class then overrides ``_serde_build``)."""
        serde = self.__dict__.get("_serde")
        return dict(serde["config"]) if serde and serde.get("config") \
            is not None else None

    @classmethod
    def _serde_build(cls, config, children):
        """Build from a decoded config and children where a constructor
        replay cannot; None replays the constructor (the default)."""
        return None

    # -- persistence (≙ AbstractModule.save / Module.load) -------------- #
    def save(self, path, overwrite=True):
        from ..utils import serializer
        serializer.save_module(self, path, overwrite=overwrite)
        return self

    @staticmethod
    def load(path, device=None):
        from ..utils import serializer
        return serializer.load_module(path, device=device)

    def save_weights(self, path, overwrite=True):
        import os
        from ..utils import serializer
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        serializer.save_weights_file(self, path)
        return self

    def load_weights(self, path):
        """Copy the parameters and state of a weights file into this
        module's tensors (names as :meth:`param_dict` gives them, after
        :func:`migrate_legacy_names`)."""
        from ..utils import serializer
        params, state = serializer.load_weights_file(path)
        params, state = migrate_legacy_names((params, state or {}), self)
        serializer.place_weights(self, params, state)
        return self

    # -- graph API (nn/graph.py) ----------------------------------------- #
    def inputs(self, *nodes):
        """This module as a graph node fed by ``nodes`` (the reference's
        ``Module.inputs``; lists of nodes are flattened)."""
        from .graph import Node
        flat = []
        for n in nodes:
            flat.extend(n if isinstance(n, (list, tuple)) else [n])
        return Node(self, flat)

    # -- chained setters the reference's models call ---------------------- #
    def set_init_method(self, weight_init=None, bias_init=None):
        """Set the init-method overrides (``None`` keeps the layer's
        default) and redraw this module's own weights with them from
        torch's default generator: the port draws weights when a layer is
        built, where the reference draws them at its lazy init."""
        self.weight_init = weight_init
        self.bias_init = bias_init
        from .init import redraw
        redraw(self)
        return self

    # -- the Torch shell ------------------------------------------------- #
    def _generator_for(self, x) -> torch.Generator:
        """This module's own generator on ``x``'s device (seeded once from
        numpy's global stream, as the reference seeds its forward keys)."""
        dev = _first_tensor(x).device
        if self._shell_gen is None or self._shell_gen.device != dev:
            self._shell_gen = torch.Generator(device=dev).manual_seed(
                self._forward_seed)
        return self._shell_gen

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """The module in its mode (:meth:`train` / :meth:`evaluate`) on
        its own weights and state: keeps ``self.output`` and, in training
        mode, writes the new batch-norm state into the buffers.  Draws
        come from ``generator``, else from the module's own (a new pass
        each call); :meth:`backward` replays them."""
        gen = generator if generator is not None else self._generator_for(x)
        self._last_pass = (gen.device, gen.get_state())
        y, new_state = self.run(self.param_dict(), x,
                                state=self.initial_state(),
                                training=self.training, generator=gen)
        if self.training:
            self.set_state(new_state)
        self.output = y
        return y

    def backward(self, x, grad_output):
        """``grad_input`` by autograd through a replay of the last
        :meth:`forward` (the same draws), accumulating the parameter
        gradients into ``self.grad_params`` (the flat layout of
        :meth:`param_dict`).  The replay writes no state."""
        if self._last_pass is None:
            g = self._generator_for(x)
            self._last_pass = (g.device, g.get_state())
        dev, gen_state = self._last_pass
        gen = torch.Generator(device=dev)
        gen.set_state(gen_state)
        params = self.param_dict()
        names = [(m, k) for m, sub in params.items() for k in sub]
        leaves = [params[m][k] for m, k in names]
        xs = _as_tensors(x)
        xin = [t.detach().requires_grad_() if torch.is_floating_point(t)
               else t for t in xs]
        wanted = [t for t in xin if t.requires_grad]
        with torch.enable_grad():
            y, _ = self.run(params, xin if isinstance(x, (list, tuple))
                            else xin[0], state=self.initial_state(),
                            training=self.training, generator=gen)
            grads = torch.autograd.grad(
                _as_tensors(y), leaves + wanted, _as_tensors(grad_output),
                allow_unused=True)
        gp: Params = {}
        for (m, k), p, g in zip(names, leaves, grads):
            g = torch.zeros_like(p) if g is None else g
            if self.grad_params is not None:
                g = self.grad_params[m][k] + g
            gp.setdefault(m, {})[k] = g
        self.grad_params = gp
        gin = iter(grads[len(leaves):])
        ginput = [next(gin) if t.requires_grad else None for t in xin]
        self.grad_input = ginput if isinstance(x, (list, tuple)) \
            else ginput[0]
        self.output = _detach(y)
        return self.grad_input

    def update_output(self, x):
        return self.forward(x)

    def update_grad_input(self, x, grad_output):
        return self.backward(x, grad_output)

    def zero_grad_parameters(self):
        self.grad_params = None

    @torch.no_grad()
    def update_parameters(self, learning_rate):
        """One SGD step ``p - lr·g`` in place from the accumulated
        ``grad_params``; frozen modules stay untouched (≙ the reference's
        ``update_parameters``)."""
        if self.grad_params is None:
            raise ValueError("no accumulated gradients; call backward first")
        frozen = self.frozen_param_names()
        for name, sub in self.param_dict().items():
            if name in frozen:
                continue
            for k, p in sub.items():
                p.copy_(p - learning_rate * self.grad_params[name][k])
        return self

    def get_parameters(self):
        """``(params, grad_params)`` in the flat layout (zeros before the
        first backward)."""
        params = self.param_dict()
        if self.grad_params is None:
            self.grad_params = {m: {k: torch.zeros_like(p)
                                    for k, p in sub.items()}
                                for m, sub in params.items()}
        return params, self.grad_params

    def evaluate(self, *args):
        """No arguments: switch to inference mode (torch's ``eval()``).
        ``evaluate(dataset, batch_size, methods)``: ``[(method, result)]``
        of :class:`~bigdl_tpu_torch.optim.predictor.Evaluator`."""
        if args:
            if len(args) != 3:
                raise TypeError("evaluate() takes either no arguments (set "
                                "inference mode) or (dataset, batch_size, "
                                "val_methods)")
            dataset, batch_size, methods = args
            from ..optim.predictor import Evaluator
            return Evaluator(self, batch_size=batch_size).test(dataset,
                                                               methods)
        return self.eval()

    def is_training(self) -> bool:
        return self.training

    # -- inference and int8 (Layer.predict, Layer.quantize) -------------- #
    def _predictor(self, batch_size):
        # one long-lived Predictor per batch size, reused across calls
        cache = self.__dict__.setdefault("_predictors", {})
        if batch_size not in cache:
            from ..optim.predictor import Predictor
            cache[batch_size] = Predictor(self, batch_size=batch_size)
        return cache[batch_size]

    def predict(self, x, batch_size=128):
        """Batched inference on the model's device (an array, a list of
        ``Sample`` s or a DataSet) -> numpy outputs (≙ Layer.predict)."""
        return self._predictor(batch_size).predict(x)

    def predict_class(self, x, batch_size=128):
        """1-based class predictions (≙ Layer.predict_class)."""
        return self._predictor(batch_size).predict_class(x)

    # the pyspark layer.py spellings
    predict_local = predict
    predict_class_local = predict_class

    def quantize(self, calibration_data=None):
        """An int8 copy of this model (≙ Layer.quantize, see
        :func:`bigdl_tpu_torch.quantized.quantize`); ``calibration_data``
        bakes static activation scales."""
        from ..quantized import quantize
        return quantize(self, calibration_data=calibration_data)


def _as_tensors(x) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _first_tensor(x) -> torch.Tensor:
    return _as_tensors(x)[0]


def _detach(y):
    if isinstance(y, (list, tuple)):
        return [t.detach() for t in y]
    return y.detach()


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


# classes that define no __init__ of their own fall through to the base
# constructor: wrap it too, so that every instance has its config
_capture_config(Module)


class Criterion:
    """Base of the losses (≙ the reference's ``Criterion``):
    ``loss(output, target) -> scalar``.  The Torch shell: ``forward``
    (and ``__call__``) keeps the value in ``self.output``, ``backward``
    returns d loss / d output by autograd and keeps it in
    ``self.grad_input``."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "__init__" in cls.__dict__:
            _capture_config(cls)

    def __init__(self, name: Optional[str] = None):
        self._uid = next(_uid_counter)
        self.name = name or f"{type(self).__name__}_{self._uid:08d}"
        self.output = None
        self.grad_input = None

    def loss(self, output, target):
        raise NotImplementedError

    def forward(self, output, target):
        self.output = self.loss(output, target)
        return self.output

    def __call__(self, output, target):
        return self.forward(output, target)

    def backward(self, output, target):
        outs = [o.detach().requires_grad_() for o in _as_tensors(output)]
        with torch.enable_grad():
            value = self.loss(outs if isinstance(output, (list, tuple))
                              else outs[0], target)
            grads = torch.autograd.grad(value, outs)
        self.grad_input = list(grads) if isinstance(output, (list, tuple)) \
            else grads[0]
        return self.grad_input

    def __repr__(self):
        return f"{type(self).__name__}()"


_capture_config(Criterion)
