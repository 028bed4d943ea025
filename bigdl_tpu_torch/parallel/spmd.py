"""SpmdTrainer: TransformerLM over a dp × fsdp × tp × sp mesh (≙
``bigdl_tpu/parallel/spmd.py``).

The reference compiles one (forward + backward + update) XLA program over
a device mesh and lets the GSPMD partitioner insert the collectives.  The
port runs the same step eagerly, each rank on its share, with the
collectives placed by hand over one process group a set of mesh axes
(:meth:`~bigdl_tpu_torch.parallel.mesh.Mesh.group_of`):

  * layout: each parameter's tensor- and expert-parallel spec is the
    model's (``param_pspecs``), filtered to the mesh's axes (:func:`_filter_spec`);
    with ``fsdp`` an ``fsdp`` axis is layered onto the first free,
    divisible dim of every parameter of at least ``min_fsdp_size``
    elements (:func:`_add_fsdp`), except a module's marked
    ``fsdp_exempt`` (the embedding).  :meth:`init` slices the model's
    parameters into contiguous local shards (:meth:`_param_shardings`).
  * the batch splits as ``P(("dp", "fsdp"), "sp")``: rows over the data
    axes, the sequence over ``sp`` (:meth:`_batch_sharding`).  Each rank
    runs the model on its block (``Ctx.shard``): Megatron's tp
    collectives inside the model (:mod:`.tp_ops`), global RoPE positions,
    and over sp the ring (``ring_attention``, bound to the attention's
    ``attention_fn`` by :meth:`attach`) or, without it, attention over
    the gathered sequence.
  * fsdp parameters are all-gathered a module at a time as the forward
    reaches them and gathered again in the backward (the saved tensor is
    dropped after the forward), and their gradients reduce-scattered
    over ``fsdp``.
  * each rank's loss is its masked token sum over the global valid-token
    count, so the gradients summed over ``dp × fsdp × sp`` are those of
    the reference's global mean; the loss is that sum.
  * the update runs on the local shards (K4 on the card with
    ``fused=True``).  ``zero1`` layers ``dp`` onto the first free,
    divisible dim of each moment of at least ``zero1_min_size`` elements:
    a rank updates its 1/dp block and the parameters are all-gathered
    over ``dp`` (:meth:`_zero1_opt_shardings`).
  * dropout masks are drawn at the global shape from the step's generator
    and sliced, so a trajectory does not depend on the mesh.

On the card the step runs the flash-attention kernels (K1 forward, K2/K3
backward) on the rank's ``H/tp`` heads and, with ``fused=True``, the
fused Adam kernel (K4).  The update writes parameters and moments in
place, the counterpart of the reference's ``donate_argnums=(0, 1)``.
``step`` takes the global batch (every rank the same), returns the loss
as a device tensor and makes no host sync unless telemetry is on (one a
step: the loss and the health scalars in one copy); ``fit`` syncs when it
logs, when it flushes summaries and once at its end.

Without a mesh (``mesh=None``, or a dict whose every axis is 1 and no
process group) the trainer runs on one device with no collectives; so
does a mesh of one rank, since a collective over an axis of size 1 has
nothing to communicate.

Each step's random draws (dropout, and the input transform's) come from a
``torch.Generator`` on the device seeded from ``(seed + 1, step)``, as the
reference folds the step into ``PRNGKey(seed + 1)``: a run resumed from a
checkpoint redraws the same masks from the step and seed in its meta.

Parameters are not drawn at :meth:`init`: the reference draws them from
``jax.random``, which torch cannot reproduce, so the trainer takes the
model's current parameters (a ``build(seed=)`` draw, or the reference's
weights loaded with ``models.convert.from_jax_params``), the same on every
rank.

The loop features are the reference's: ``evaluate`` (token-weighted loss
and perplexity, reduced over the mesh), ``set_input_transform``,
``set_telemetry`` (a step record a step; the health norms reduced over
the mesh), ``set_health`` (the sentinels; ``policy="rollback"`` restores
the newest committed checkpoint in ``fit``), ``set_trace_context``,
``straggler_report``, manifest checkpoints through
:mod:`bigdl_tpu_torch.checkpoint` (``save_checkpoint``,
``load_checkpoint``, ``set_checkpoint`` with ``shard_arrays`` and
``handle_preemption``; on a mesh of several ranks each rank writes its
fragments, and a restore reassembles them onto any mesh or one device;
the files are the reference's, so each package restores the other's),
``set_train_summary`` / ``set_val_summary`` and, on one rank, a live
weight stream (``set_weight_stream``).

Experts (a TransformerLM with ``moe_experts``) shard over an ``ep`` axis
by their pspec, with their moments and checkpoint fragments; the MoE
layer sees the global batch through ``Shard.tokens`` (the ranks of the
data axes and sp), as the reference's GSPMD step does.  A ``pp`` axis
needs the pipeline engine (:class:`~bigdl_tpu_torch.parallel.pipeline.
PipelineLMTrainer`) and raises here, as the reference's trainer has no
pipeline.

Telemetry (shared with ``Optimizer``): step records, the first step's
cost capture (``perf/mfu``), ``set_trace_every``, ``serve_metrics`` and
the health layer.  :meth:`SpmdTrainer.account_collectives` measures the
collectives one step issues.

Not ported: the orbax layout (ROADMAP queue A, item 7) and a weight
stream from a mesh of several ranks; each raises.
"""
from __future__ import annotations

import functools
import itertools
import math
import time
import weakref
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..observability import collectives as comm
from ..nn.module import Ctx
from ..optim.optimizer import (TelemetryHealth, _HealthProbe, _flat_f32,
                               make_accum_grads, mask_frozen_grads)
from . import mesh as mesh_lib
from . import tp_ops
from .allreduce import tree_leaves, tree_paths
from .ring_attention import ring_attention

# the mesh of one device, as the reference's create_mesh({"dp": 1}) records
# it in a manifest (checkpoint.reshard.mesh_info)
_ONE_DEVICE_MESH = {"axes": [["dp", 1]], "devices": 1, "processes": 1}
_DATA = ("dp", "fsdp", "sp")        # the axes a gradient is summed over


def _mesh_axes(mesh) -> dict:
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def _step_generator(device, seed: int, step: int) -> torch.Generator:
    """The step's generator: seeded from ``(seed + 1, step)`` (≙
    ``fold_in(PRNGKey(seed + 1), step)``) through splitmix64, whose low
    32 bits (all a CPU generator keeps of its seed) depend on both."""
    m = (1 << 64) - 1
    z = ((((int(seed) + 1) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return torch.Generator(device=device).manual_seed(z ^ (z >> 31))


def _clone_tree(tree):
    """A copy of a state tree: its tensors cloned, the rest as is."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _unported(what: str, item: str):
    raise NotImplementedError(f"SpmdTrainer: {what} is not ported yet "
                              f"(ROADMAP queue A, {item})")


# --------------------------------------------------------------------- #
# layout: a spec is a tuple with an entry a dim (an axis name, a tuple  #
# of them, or None), the reference's PartitionSpec                      #
# --------------------------------------------------------------------- #
def _entry_axes(e):
    return () if e is None else tuple(e) if isinstance(e, (tuple, list)) \
        else (e,)


def _filter_spec(spec, axes) -> tuple:
    """Drop axis names the mesh (``axes``: its ``{axis: size}``) does not
    have."""
    def keep(e):
        kept = tuple(a for a in _entry_axes(e) if a in axes)
        if not kept:
            return None
        return kept if isinstance(e, (tuple, list)) else kept[0]
    return tuple(keep(e) for e in spec)


def _add_axis(spec, shape, axes, axis: str, min_size: int = 2 ** 16
              ) -> tuple:
    """Layer ``axis`` onto the first free, divisible dim of a parameter of
    at least ``min_size`` elements: the one layering rule (``fsdp`` onto
    parameters, ``dp`` onto zero1's moments)."""
    if axis not in axes or int(np.prod(shape, dtype=np.int64)) < min_size:
        return tuple(spec)
    n = axes[axis]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % n == 0:
            entries[i] = axis
            break
    return tuple(entries)


def _add_fsdp(spec, shape, axes, min_size: int = 2 ** 16) -> tuple:
    """Layer ``fsdp`` onto the first free, divisible dim of a large
    parameter."""
    return _add_axis(spec, shape, axes, "fsdp", min_size)


def block(spec, shape, axes, coords):
    """The slices of the block of a leaf of global ``shape`` that the rank
    at ``coords`` holds under ``spec`` (an entry of several axes splits
    its dim row-major over them)."""
    out = []
    for d, size in enumerate(shape):
        names = _entry_axes(spec[d] if d < len(spec) else None)
        n = int(np.prod([axes[a] for a in names], dtype=np.int64))
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {names} ({n})")
        i = int(np.ravel_multi_index([coords[a] for a in names],
                                     [axes[a] for a in names])) \
            if names else 0
        k = size // n
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def _leaf_paths(tree, prefix=()):
    """``(path tuple, leaf)`` of a nested dict, in :func:`tree_leaves`
    order."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def param_shardings(model, params, axes, fsdp: bool,
                    min_fsdp_size: int = 2 ** 16):
    """``{module: {key: spec}}``: the model's tp layout
    (``param_pspecs``) filtered to the mesh ``axes`` (``{axis: size}``),
    with fsdp layered onto the parameters of at least ``min_fsdp_size``
    elements of the modules that are not ``fsdp_exempt`` when ``fsdp``
    (the reference's ``SpmdTrainer._param_shardings``)."""
    specs = model.param_pspecs(params)
    by_name = {mod.name: mod for mod in model.modules()
               if hasattr(mod, "own")}
    out = {}
    for mod, sub in params.items():
        exempt = getattr(by_name.get(mod), "fsdp_exempt", False)
        out[mod] = {}
        for k, p in sub.items():
            spec = _filter_spec(specs[mod][k], axes)
            spec = spec + (None,) * (len(p.shape) - len(spec))
            if fsdp and not exempt:
                spec = _add_fsdp(spec, tuple(p.shape), axes, min_fsdp_size)
            out[mod][k] = spec
    return out


def zero1_opt_shardings(params, shardings, opt_state, axes,
                        min_size: int = 2 ** 16):
    """``{leaf path: spec}`` for the optimizer-state leaves zero1 touches
    (the reference's ``_zero1_opt_shardings``): a leaf whose path ends in
    a parameter's ``(module, key)`` and has its shape (``params`` and the
    moments of ``opt_state`` in global shapes) takes that parameter's spec
    with ``dp`` layered onto its first free, divisible dim.  Scalars and
    other leaves are absent (replicated)."""
    by_path = {(mod, k): (tuple(p.shape), shardings[mod][k])
               for mod, sub in params.items() for k, p in sub.items()}
    out = {}
    for path, leaf in _leaf_paths(opt_state):
        shape = tuple(getattr(leaf, "shape", ()))
        hit = by_path.get(tuple(path[-2:]))
        if hit is not None and hit[0] == shape:
            out[path] = _add_axis(hit[1], shape, axes, "dp", min_size)
    return out


class Shard:
    """This rank's share of a step (``Ctx.shard``): ``tp``, ``sp`` and
    ``ep`` its groups ``(group, size, index)`` where those axes are larger
    than 1 (else None), ``experts`` its group over ``tp × ep`` (the sum of
    an MoE layer's experts); ``rows`` and ``seq`` ``(start, stop, total)``
    of its block of the batch rows and of the sequence; ``tokens`` the
    :class:`~bigdl_tpu_torch.nn.moe.TokenGroup` of the ranks whose blocks
    make up the batch an MoE layer routes (None: the local block is all
    of it)."""

    __slots__ = ("tp", "sp", "rows", "seq", "ep", "experts", "tokens")

    def __init__(self, tp, sp, rows, seq, ep=None, experts=None,
                 tokens=None):
        self.tp, self.sp, self.rows, self.seq = tp, sp, rows, seq
        self.ep, self.experts, self.tokens = ep, experts, tokens


def big(group):
    """``group`` (``(group, size, index)``) when its size is above 1, else
    None."""
    return group if group[1] > 1 else None


def token_group(mesh, row_axes, seq_axis: Optional[str] = "sp"):
    """The :class:`~bigdl_tpu_torch.nn.moe.TokenGroup` of the ranks that
    split a batch's rows over ``row_axes`` and its sequence over
    ``seq_axis`` (None when that is this rank alone): each member's row
    block is its index over ``row_axes``, its sequence block its
    coordinate on ``seq_axis``."""
    from ..nn.moe import TokenGroup
    axes = tuple(row_axes) + ((seq_axis,) if seq_axis else ())
    group, size, index = mesh.group_of(axes)
    if size == 1:
        return None
    names = [a for a in mesh.axis_names
             if a in axes and mesh.shape[a] > 1]
    rows = [a for a in names if a in row_axes]
    members = []
    for combo in itertools.product(*(range(mesh.shape[a]) for a in names)):
        c = dict(zip(names, combo))
        r = int(np.ravel_multi_index([c[a] for a in rows],
                                     [mesh.shape[a] for a in rows])) \
            if rows else 0
        members.append((r, c.get(seq_axis, 0)))
    return TokenGroup(group, size, index, members)


class _Gathering(Mapping):
    """The parameters as the model reads them in a sharded step: a module's
    fsdp-sharded leaves are all-gathered (:func:`tp_ops.gather_from_group`)
    each time the module reads them.  Each gathered tensor is noted, and
    its autograd node, so that the saved-tensor hooks of :meth:`hooks` keep
    the shard instead of the gathered tensor, or of its cast to the compute
    dtype (``p[w].to(x.dtype)`` in bf16), and gather (and cast) again in
    the backward."""

    _MARK = object()

    def __init__(self, params, dims, group):
        self._params, self._dims = params, dims
        self._group = group                 # (group, size, index)
        self._made = {}
        self._nodes = {}                    # id(grad_fn) -> (fn, shard, d)

    def __getitem__(self, mod):
        sub = self._params[mod]
        dims = self._dims.get(mod)
        if not dims:
            return sub
        group, size, _ = self._group
        out = dict(sub)
        for k, d in dims.items():
            full = tp_ops.gather_from_group(sub[k], group, size, d)
            self._made[id(full)] = (weakref.ref(full), sub[k], d)
            if full.grad_fn is not None:
                self._nodes[id(full.grad_fn)] = (full.grad_fn, sub[k], d)
            out[k] = full
        return out

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def hooks(self):
        """``saved_tensors_hooks`` that drop a gathered parameter after the
        forward and gather it again when the backward needs it."""
        made, nodes = self._made, self._nodes
        group, size, _ = self._group

        def pack(t):
            hit = made.get(id(t))
            if hit is not None and hit[0]() is t:
                return (self._MARK, hit[1], hit[2], None)
            fn = t.grad_fn
            if fn is not None and fn.name() == "ToCopyBackward0":
                # a cast of a gathered tensor: its node feeds the cast
                src = fn.next_functions[0][0]
                hit = nodes.get(id(src))
                if hit is not None and hit[0] is src:
                    return (self._MARK, hit[1], hit[2], t.dtype)
            return t

        def unpack(x):
            if isinstance(x, tuple) and x[0] is self._MARK:
                with torch.no_grad():
                    full = tp_ops.all_gather_dim(x[1], group, size, x[2])
                    return full if x[3] is None else full.to(x[3])
            return x
        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


class SpmdTrainer(TelemetryHealth):
    """Trainer of a TransformerLM over a mesh (or one device) with the
    reference's step and loop."""

    def __init__(self, model, optim, mesh=None, fsdp: bool = True,
                 seed: int = 0, ring_attention: Optional[bool] = None,
                 min_fsdp_size: int = 2 ** 16, grad_accum: int = 1,
                 loss_chunk: Optional[int] = None, zero1: bool = False,
                 zero1_min_size: Optional[int] = None, *,
                 device: DeviceLike = None):
        axes = {} if mesh is None else _mesh_axes(mesh)
        if axes.get("pp", 1) > 1:
            raise ValueError(
                "SpmdTrainer has no pipeline stages: a 'pp' axis > 1 needs "
                "parallel.pipeline.PipelineLMTrainer (compose.build_trainer "
                "picks it for a template with pp > 1)")
        # ZeRO-1 by sharding (arXiv:2004.13336): the moments take dp on
        # their first free, divisible dim (_zero1_opt_shardings)
        if zero1 and axes.get("dp", 1) < 2:
            raise ValueError("zero1 shards the update over the dp axis: "
                             "the mesh needs dp > 1")
        m = None
        if isinstance(mesh, mesh_lib.Mesh):
            m = mesh
        elif mesh is not None and dist.is_initialized():
            m = mesh_lib.create_mesh(axes, device=device)
        elif any(n > 1 for n in axes.values()):
            raise RuntimeError(
                f"SpmdTrainer: the mesh {axes} needs a started process "
                "group (parallel.mesh.init_distributed); without one every "
                "axis must be 1")
        self._m = m
        if m is not None:
            device = m.device
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.model = model
        self.optim = optim
        self.mesh = mesh
        self._axes = axes
        if m is not None:
            from ..checkpoint import reshard
            self._mesh_info = reshard.mesh_info(m)
        else:
            self._mesh_info = ({"axes": [[a, n] for a, n in axes.items()],
                                "devices": 1, "processes": 1}
                               if axes else dict(_ONE_DEVICE_MESH))
        self.seed = int(seed)
        self.min_fsdp_size = int(min_fsdp_size)
        self.zero1 = bool(zero1)
        self.zero1_min_size = (self.min_fsdp_size if zero1_min_size is None
                               else int(zero1_min_size))
        cfg = getattr(model, "cfg", None)
        if ring_attention is None:
            ring_attention = getattr(cfg, "use_ring_attention", False)
        # without an fsdp axis (or an sp axis for the ring) fsdp,
        # min_fsdp_size and ring_attention ask for nothing, as in the
        # reference
        self.ring = bool(ring_attention and m is not None
                         and axes.get("sp", 1) > 1)
        self.fsdp = bool(fsdp and m is not None and "fsdp" in axes)
        self._batch_axes = tuple(a for a in ("dp", "fsdp") if a in axes)
        self._seq_axis = "sp" if "sp" in axes else None
        self._tokens = False            # token_group, made at first use
        self.grad_accum = int(grad_accum)
        # chunked head + loss: at most (B, chunk, V) logits at once (see
        # TransformerLM.token_nll); None is one full-sequence projection
        self.loss_chunk = loss_chunk
        self.params = None
        self.opt_state = None
        self._grads_fn = None
        self._step_gen = None           # the current step's generator
        self._step_count = 0
        self._weight_stream = None
        self._input_transform = None
        self._data_pipeline = None
        self._init_telemetry()
        self._ckpt = None               # (path, every_steps, keep)
        self._ckpt_mgr = None
        self._shard_arrays = False
        self._preemption = None
        self._train_summary = None
        self._val_summary = None

    # -- layout ---------------------------------------------------------- #
    def _param_shardings(self, params):
        return param_shardings(self.model, params, self._axes, self.fsdp,
                               self.min_fsdp_size)

    def _zero1_opt_shardings(self, params, shardings, opt_state):
        return zero1_opt_shardings(params, shardings, opt_state,
                                   self._axes, self.zero1_min_size)

    def _batch_sharding(self):
        """The batch's spec: rows over the data axes, the sequence over
        sp (``P(("dp", "fsdp"), "sp")``)."""
        ba = self._batch_axes
        return (ba if len(ba) > 1 else (ba[0] if ba else None),
                self._seq_axis)

    def _group(self, axes):
        return self._m.group_of(axes)

    def _local(self, t, spec):
        """This rank's block of the global leaf ``t`` under ``spec``: ``t``
        itself when the block is all of it, else a contiguous copy."""
        b = block(spec, tuple(t.shape), self._m.shape, self._m.coords)
        if all(sl.start == 0 and sl.stop == n for sl, n in zip(b, t.shape)):
            return t
        return t.detach()[b].clone().requires_grad_(
            t.requires_grad)

    # -- set-up ---------------------------------------------------------- #
    def attach(self):
        """Bind the sp ring to the model's attention modules (over a
        previous trainer's), keeping the model's own hook on the module,
        so that :meth:`detach` restores it."""
        if not self.ring:
            return self
        fn = functools.partial(ring_attention, sp=self._group(("sp",)),
                               causal=True)
        for blk in self.model.blocks:
            cur = blk.attn.attention_fn
            if not (isinstance(cur, functools.partial)
                    and cur.func is ring_attention):
                blk.attn._pre_ring_attention_fn = cur
            blk.attn.attention_fn = fn
        self._attached = True
        return self

    def detach(self):
        """Restore the model's attention hooks from before any ring."""
        if getattr(self, "_attached", False):
            for blk in self.model.blocks:
                if hasattr(blk.attn, "_pre_ring_attention_fn"):
                    blk.attn.attention_fn = blk.attn._pre_ring_attention_fn
            self._attached = False
        return self

    def init(self):
        """Take the model's parameters (this rank's shards of them on a
        mesh) and build the optimizer state."""
        params = self.model.param_dict()
        bad = sorted({str(p.device) for p in tree_leaves(params)
                      if p.device != self.device})
        if bad:
            raise ValueError(f"SpmdTrainer: the model's parameters are on "
                             f"{bad}, the trainer's device is "
                             f"{self.device}; move the model first")
        if self._m is not None:
            return self._init_sharded(params)
        self.params = params
        self.opt_state = self.optim.init_state(params)
        model, loss_chunk = self.model, self.loss_chunk

        def loss_fn(p, state, tokens, targets):
            ctx = Ctx(state={}, training=True, generator=self._step_gen)
            loss = model.loss(p, tokens, targets, loss_chunk=loss_chunk,
                              ctx=ctx)
            for sl in ctx.side_losses:   # e.g. MoE load-balancing aux
                loss = loss + sl
            return loss, state

        # model.loss is a MASKED token mean, so microbatches are weighted
        # by their valid-token count
        self._grads_fn = make_accum_grads(
            loss_fn, self.grad_accum, weight_fn=lambda t, y: (y != -1).sum())
        return self

    def _init_sharded(self, params):
        self.attach()
        specs = self._param_shardings(params)
        self._specs = specs
        self._global_shapes = {mod: {k: tuple(p.shape)
                                     for k, p in sub.items()}
                               for mod, sub in params.items()}
        self.params = {mod: {k: self._local(p, specs[mod][k])
                             for k, p in sub.items()}
                       for mod, sub in params.items()}
        fsdp = self._group(("fsdp",)) if self.fsdp else (None, 1, 0)
        self._fsdp = fsdp
        self._fsdp_dims = {}
        if fsdp[0] is not None:
            for mod, sub in specs.items():
                dims = {k: spec.index("fsdp") for k, spec in sub.items()
                        if "fsdp" in spec}
                if dims:
                    self._fsdp_dims[mod] = dims
        # zero1: the blocks each rank updates, and its state over them
        self._z1_dims = {}
        if self.zero1:
            template = {mod: {k: torch.empty(self._global_shapes[mod][k],
                                             device="meta")
                              for k in sub} for mod, sub in params.items()}
            z1 = self._zero1_opt_shardings(template, specs, template)
            for (mod, k), spec in z1.items():
                if "dp" in spec:
                    self._z1_dims.setdefault(mod, {})[k] = spec.index("dp")
        self._dp = self._group(("dp",))
        self.opt_state = self.optim.init_state(self._update_view(
            self.params)[0])
        return self

    def _update_view(self, tree):
        """``tree`` (local shards) as the update sees it under zero1: each
        zero1 leaf its ``dp`` block (a view when it is contiguous, else a
        copy); returns ``(tree, copies)``, the copies as ``(block, local
        leaf, dim)``."""
        if not self._z1_dims:
            return tree, []
        _, n, i = self._dp
        out, copies = {}, []
        for mod, sub in tree.items():
            dims = self._z1_dims.get(mod, {})
            out[mod] = dict(sub)
            for k, d in dims.items():
                t = sub[k]
                size = t.shape[d] // n
                blk = t.narrow(d, i * size, size)
                if not blk.is_contiguous():
                    blk = blk.contiguous()
                    copies.append((blk, t, d))
                out[mod][k] = blk
        return out, copies

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def set_weight_stream(self, publisher):
        """Attach a live train→serve weight stream
        (:class:`~bigdl_tpu_torch.serving.WeightStreamPublisher`):
        evaluated once per :meth:`fit` step against the step count; on
        fire the parameters are snapshotted (owning copies on their
        device) and published through the canary gate off the step loop.
        ``None`` detaches.  A mesh of several ranks holds no whole
        parameter on any rank: not ported there."""
        if publisher is not None and self._m is not None \
                and self._m.size > 1:
            raise NotImplementedError(
                "SpmdTrainer: a weight stream from a mesh of several ranks "
                "(each holds shards) is not ported; stream from one rank")
        self._weight_stream = publisher
        return self

    def set_input_transform(self, fn):
        """Run ``fn(tokens, generator) -> tokens`` on the device at the
        start of each step (≙ the reference's transform compiled into the
        step): the host ships the raw wire format and ``generator`` is
        the step's, so a resumed run redraws the same.  ``None``
        detaches."""
        self._input_transform = fn
        return self

    def set_data_pipeline(self, dataset):
        """Attach a cursor-capable streaming dataset
        (:class:`~bigdl_tpu_torch.data.sharded.ShardedRecordDataSet`):
        every manifest checkpoint then records ``dataset.state()`` — the
        read position of the last batch consumed — and a restore
        re-positions the stream, so that a preempted run neither re-sees
        nor skips a sample.  Feed :meth:`fit` from ``dataset.stream()``."""
        self._data_pipeline = dataset
        return self

    def account_collectives(self, tokens, targets):
        """The collectives one step on this batch issues, measured: the
        step runs under a :class:`~bigdl_tpu_torch.observability
        .collectives.CollectiveTap` (op, bytes on the wire, mesh axes of
        the group; a backward's collectives too, on whatever thread the
        autograd engine runs it) and its effects are undone after:
        parameters, optimizer state and the step count are restored, no
        step record is cut.  Sets the ``collective/*`` and ``comm/group.<axes>.*``
        gauges (reset first) and returns ``{"ops": {op: wire bytes},
        "groups": {axes: {op: wire bytes, "wire_bytes": total}},
        "wire_bytes_per_step": total, "bytes_per_step": result bytes}``.

        Where the reference reads the ops GSPMD chose out of the compiled
        HLO, these are the port's own: Megatron's f/g all-reduces in each
        block's forward and backward, fsdp's all-gathers (forward and the
        backward's re-gather) and reduce-scatters, one flat all-reduce of
        the gradients a group of axes and dtype, the ring's P2P sends."""
        from ..observability.collectives import CollectiveTap
        if self.params is None:
            self.init()
        labels = self._m.group_labels() if self._m is not None else {}
        saved = [t.detach().clone() for t in tree_leaves(self.params)]
        saved_opt = _clone_tree(self.opt_state)
        count, telemetry = self._step_count, self._telemetry
        self._telemetry = False         # no step record, no cost capture
        try:
            with CollectiveTap(labels) as tap:
                self.step(tokens, targets)
        finally:
            self._telemetry = telemetry
            self._step_count = count
            with torch.no_grad():
                for t, v in zip(tree_leaves(self.params), saved):
                    t.copy_(v)
            self.opt_state = saved_opt
        return tap.publish(self.recorder)

    # -- telemetry and health -------------------------------------------- #
    def _trace_spine(self):
        from ..observability import tracing
        return self._tracer if self._tracer is not None \
            else tracing.get_tracer()

    def straggler_report(self):
        """Per-host step-time attribution over the recorder's records: on
        one process there is one host, so None unless the records carry a
        ``host`` scalar."""
        from ..observability.health import attribute_stragglers
        return attribute_stragglers(self.recorder.recent_records())

    # -- the step -------------------------------------------------------- #
    def step(self, tokens, targets):
        """One training step on a batch; returns the loss as a device
        tensor (no host sync without telemetry)."""
        if self.params is None:
            self.init()
        telemetry = self._telemetry
        rec = self.recorder
        if telemetry and self._cost_pending:
            # the first step's cost, counted before its record and trace
            # open: neither its time nor its trace holds the pass
            tokens, targets = self._to_device(tokens), \
                self._to_device(targets)
            self._capture_cost_of(tokens, targets)
        step_span = None
        if self._trace_ctx is not None:
            step_span = self._trace_spine().begin(
                "train.step", self._trace_ctx, subsystem="train")
        if telemetry:
            rec.start_step(self._step_count)
        try:
            return self._step(tokens, targets, telemetry, step_span)
        except BaseException:
            if telemetry and rec.step_in_flight():
                rec.abort_step()        # and the trace it opened
            raise

    def _step(self, tokens, targets, telemetry, step_span):
        rec = self.recorder
        with rec.span("h2d"):
            tokens, targets = self._to_device(tokens), \
                self._to_device(targets)
        gen = self._step_gen = _step_generator(self.device, self.seed,
                                               self._step_count)
        probe = _HealthProbe() if telemetry and self._telemetry_health \
            else None
        with rec.span("train_step"):
            if self._input_transform is not None:
                tokens = self._input_transform(tokens, gen)
            if self._m is not None:
                loss, health = self._sharded_step(tokens, targets, gen,
                                                  probe is not None)
            else:
                (loss, _), grads = self._grads_fn(self.params, {}, tokens,
                                                  targets)
                grads = mask_frozen_grads(self.model, grads)
                before = None if probe is None else probe.before(
                    self.params)
                self.params, self.opt_state = self.optim.update(
                    grads, self.params, self.opt_state)
                health = None if probe is None else probe.after(
                    grads, self.params, before)
        self._step_count += 1
        if telemetry:
            self._emit_step_record(int(tokens.numel()), loss, health)
        if step_span is not None:
            step_span.end(step=self._step_count - 1)
        return loss

    # -- the sharded step ------------------------------------------------ #
    def _blocks(self, tokens, targets):
        """This rank's block of a (micro)batch and its :class:`Shard`."""
        b, s = tokens.shape[0], tokens.shape[1]
        index, n = mesh_lib.data_sharding(self._m, ("dp", "fsdp"))
        tp, sp = self._group(("tp",)), self._group(("sp",))
        if b % n or s % sp[1]:
            raise ValueError(f"batch {tuple(tokens.shape)} does not split "
                             f"over {self._m.shape} (rows over dp×fsdp "
                             f"= {n}, sequence over sp = {sp[1]})")
        k, sl = b // n, s // sp[1]
        rows = (index * k, (index + 1) * k, b)
        seq = (sp[2] * sl, (sp[2] + 1) * sl, s)
        if self._tokens is False:
            self._tokens = token_group(self._m, ("dp", "fsdp"))
        shard = Shard(big(tp), big(sp), rows, seq,
                      ep=big(self._group(("ep",))),
                      experts=big(self._group(("tp", "ep"))),
                      tokens=self._tokens)
        return (tokens[rows[0]:rows[1], seq[0]:seq[1]],
                targets[rows[0]:rows[1], seq[0]:seq[1]], shard)

    def _sharded_step(self, tokens, targets, gen, with_health: bool):
        """Gradients of this rank's share, summed over the mesh, and the
        update of its shards; returns ``(global mean loss, health)``."""
        red = self._group(_DATA)
        keys = [(mod, k) for mod, sub in self.params.items() for k in sub]
        leaves = [self.params[mod][k] for mod, k in keys]
        gathering = _Gathering(self.params, self._fsdp_dims, self._fsdp)
        n_acc = self.grad_accum
        acc = loss_acc = w_acc = None
        for i in range(max(n_acc, 1)):
            tok_i, tgt_i = ((tokens, targets) if n_acc < 2 else
                            (tokens[i::n_acc], targets[i::n_acc]))
            tok_l, tgt_l, shard = self._blocks(tok_i, tgt_i)
            ctx = Ctx(state={}, training=True, generator=gen, shard=shard)
            with gathering.hooks():
                tot, cnt = self.model.token_nll(
                    gathering, tok_l, tgt_l, loss_chunk=self.loss_chunk,
                    ctx=ctx)
            # the microbatch's global valid-token count: each rank's loss
            # is its share of the global masked mean
            count = tp_ops._all_reduce(cnt.detach(), red[0])
            loss = tot / torch.clamp(count, min=1.0)
            for sl in ctx.side_losses:
                loss = loss + sl / red[1]
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            if n_acc < 2:
                acc, loss_acc = list(grads), loss
                break
            if acc is None:
                acc = [torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves]
                loss_acc = torch.zeros((), dtype=torch.float32,
                                       device=self.device)
                w_acc = torch.zeros_like(loss_acc)
            acc = [a + count * g for a, g in zip(acc, grads)]
            loss_acc = loss_acc + count * loss
            w_acc = w_acc + count
        if n_acc >= 2:
            w_acc = torch.clamp(w_acc, min=1e-8)
            acc = [g / w_acc for g in acc]
            loss_acc = loss_acc / w_acc
        acc = self._sum_grads(keys, acc)
        loss = tp_ops._all_reduce(loss_acc, red[0])
        grads = {}
        for (mod, k), g in zip(keys, acc):
            grads.setdefault(mod, {})[k] = g
        grads = mask_frozen_grads(self.model, grads)
        old = [p.detach().float().clone() for p in leaves] \
            if with_health else None
        self._update(grads)
        health = None if old is None else self._mesh_health(
            keys, [grads[mod][k] for mod, k in keys], old, leaves)
        return loss, health

    def _sum_grads(self, keys, grads):
        """Each gradient summed over the data axes (an fsdp shard's over
        dp × sp: the backward reduce-scattered it over fsdp), one
        all-reduce of the flattened leaves a group and dtype."""
        out = list(grads)
        buckets = {}
        for i, (mod, k) in enumerate(keys):
            axes = ("dp", "sp") if k in self._fsdp_dims.get(mod, {}) \
                else _DATA
            group = self._group(axes)[0]
            if group is not None:
                buckets.setdefault((axes, out[i].dtype), []).append(i)
        for (axes, _), idx in buckets.items():
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            comm.all_reduce(flat, group=self._group(axes)[0])
            for i, part in zip(idx, flat.split([out[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(out[i])
        return out

    @torch.no_grad()
    def _update(self, grads):
        """The optimizer's update of this rank's shards (zero1: of its dp
        blocks, then the parameters all-gathered over dp)."""
        p_view, copies = self._update_view(self.params)
        g_view, _ = self._update_view(grads)
        new_p, self.opt_state = self.optim.update(g_view, p_view,
                                                  self.opt_state)
        for mod, sub in p_view.items():
            for k, t in sub.items():
                if new_p[mod][k] is not t:
                    t.copy_(new_p[mod][k])
        if self._z1_dims:
            group, n, _ = self._dp
            for mod, dims in self._z1_dims.items():
                for k, d in dims.items():
                    self.params[mod][k].copy_(tp_ops.all_gather_dim(
                        p_view[mod][k], group, n, d))

    def _replicas(self, mod, k) -> int:
        """How many ranks hold the same block of a parameter."""
        axes = {a for e in self._specs[mod][k] for a in _entry_axes(e)}
        return self._m.size // int(np.prod(
            [self._m.shape[a] for a in axes], dtype=np.int64))

    def _mesh_health(self, keys, grads, old, new):
        """The health scalars of the global gradient and update: each
        leaf's sums over its block, divided by its replicas, summed over
        the mesh."""
        rows = []
        for (mod, k), g, o, n in zip(keys, grads, old, new):
            g32, n32 = _flat_f32([g]), _flat_f32([n])
            rows.append(torch.stack([
                torch.sum(g32 * g32), torch.sum(n32 * n32),
                torch.sum(torch.square(n32 - o.reshape(-1))),
                torch.sum(~torch.isfinite(g32)).to(torch.float32)])
                / self._replicas(mod, k))
        tot = torch.stack(rows).sum(dim=0)
        if self._m.size > 1:
            comm.all_reduce(tot, group=self._m.group)
        gn, pn, un = torch.sqrt(tot[:3]).unbind()
        return {"grad_norm": gn, "param_norm": pn, "update_norm": un,
                "update_ratio": un / torch.clamp(pn, min=1e-12),
                "nonfinite_grads": tot[3]}

    def full_params(self):
        """The global parameters (``{module: {key: tensor}}``): every
        shard all-gathered over the axes that split it.  A collective:
        every rank of the mesh calls it."""
        if self._m is None:
            return self.params
        out = {}
        with torch.no_grad():
            for mod, sub in self.params.items():
                out[mod] = {}
                for k, t in sub.items():
                    for d, e in enumerate(self._specs[mod][k]):
                        names = _entry_axes(e)
                        if names:
                            group, n, _ = self._group(names)
                            t = tp_ops.all_gather_dim(t, group, n, d)
                    out[mod][k] = t
        return out

    def _capture_cost_of(self, tokens, targets):
        """The first step's cost: the loss's forward and backward on this
        batch with a generator of its own, updating nothing (a sharded
        step records that it was not captured)."""
        model, loss_chunk = self.model, self.loss_chunk
        params = self.params

        def run():
            gen = torch.Generator(device=self.device).manual_seed(0)
            tok = tokens if self._input_transform is None \
                else self._input_transform(tokens, gen)
            ctx = Ctx(state={}, training=True, generator=gen)
            loss = model.loss(params, tok, targets, loss_chunk=loss_chunk,
                              ctx=ctx)
            for sl in ctx.side_losses:
                loss = loss + sl
            torch.autograd.grad(loss, [p for p in tree_leaves(params)
                                       if p.requires_grad])
        self._attach_step_cost(run, sharded=self._m is not None)

    def _emit_step_record(self, n_tok, loss, health):
        """The step record: the loss and the health scalars come to the
        host in one copy (the step's one sync), then the monitor checks
        the record (a diverged step raises here, before ``fit``'s
        checkpoint trigger can commit it).  A trace-only recorder keeps
        the cadence without reading anything to the host."""
        rec = self.recorder
        if self._trace_only:
            rec.end_step(self._step_count - 1)
            return
        names = ["loss"] + list(health or {})
        vals = [loss] + list((health or {}).values())
        host = torch.stack([v.detach().reshape(()).float()
                            for v in vals]).tolist()
        for k, v in zip(names, host):
            rec.scalar(k, v)
        rec.inc("tokens_total", n_tok)
        rec.scalar("records", n_tok)     # records/sec == tokens/sec
        record = rec.end_step(self._step_count - 1)
        if self._health_monitor is not None:
            self._health_monitor.check_record(record)

    def evaluate(self, batches, steps: Optional[int] = None):
        """Token-weighted mean cross-entropy and perplexity over
        ``batches`` of (tokens, targets), with the training step's chunked
        loss and dropout off; the sums stay on the device until the end
        (one host sync; on a mesh, one all-reduce of every rank's sums).  With :meth:`set_val_summary`, writes Loss and
        Perplexity at the current step."""
        if self.params is None:
            self.init()
        if steps is not None:   # islice: never pull an extra batch from a
            batches = itertools.islice(batches, steps)  # shared iterator
        sums, counts = [], []
        with torch.no_grad():
            for tokens, targets in batches:
                tokens = self._to_device(tokens).int()
                targets = self._to_device(targets).int()
                if self._m is None:
                    s, c = self.model.token_nll(
                        self.params, tokens, targets,
                        loss_chunk=self.loss_chunk, training=False)
                else:
                    tokens, targets, shard = self._blocks(tokens, targets)
                    s, c = self.model.token_nll(
                        _Gathering(self.params, self._fsdp_dims,
                                   self._fsdp), tokens, targets,
                        loss_chunk=self.loss_chunk,
                        ctx=Ctx(state={}, training=False, shard=shard))
                sums.append(s)
                counts.append(c)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        both = torch.stack([sum(sums, zero), sum(counts, zero)])
        if self._m is not None:     # the sums of every rank's block
            both = tp_ops._all_reduce(both, self._group(_DATA)[0])
        total, count = both.tolist()
        if count == 0:
            raise ValueError(
                "evaluate: no valid tokens (empty batches, or every "
                "target is ignore_index)")
        loss = total / count
        res = {"loss": loss, "perplexity": math.exp(min(loss, 50.0)),
               "tokens": int(count)}
        if self._val_summary is not None:
            self._val_summary.add_scalar("Loss", res["loss"],
                                         self._step_count)
            self._val_summary.add_scalar("Perplexity", res["perplexity"],
                                         self._step_count)
        return res

    # -- checkpoints ----------------------------------------------------- #
    def _manifest_manager(self, path, keep=None, async_write=True):
        from ..checkpoint import CheckpointManager
        mgr = self._ckpt_mgr
        if mgr is None or mgr.root != path:
            ranks = (0, 1) if self._m is None else (self._m.rank,
                                                    self._m.size)
            mgr = CheckpointManager(path, layout="manifest",
                                    async_write=async_write, keep_last=keep,
                                    recorder_fn=self._rec,
                                    process_index=ranks[0],
                                    process_count=ranks[1])
            self._ckpt_mgr = mgr
        return mgr

    def _leaf_layouts(self):
        """``{path: (spec, global shape)}`` of every leaf of ``{"params",
        "opt_state"}`` (paths as tuples): a parameter's spec, a moment's
        its parameter's (with zero1's dp), the rest replicated."""
        out = {}
        for path, t in _leaf_paths({"params": self.params,
                                    "opt_state": self.opt_state}):
            shape = tuple(getattr(t, "shape", ()))
            spec, gshape = (None,) * len(shape), shape
            mod_k = tuple(path[-2:])
            if self._m is not None and len(path) >= 3 \
                    and mod_k[0] in self._specs \
                    and mod_k[1] in self._specs[mod_k[0]]:
                mod, k = mod_k
                cand = self._specs[mod][k]
                d = self._z1_dims.get(mod, {}).get(k) \
                    if path[0] == "opt_state" else None
                if d is not None:
                    cand = cand[:d] + ("dp",) + cand[d + 1:]
                g = self._global_shapes[mod][k]
                b = block(cand, g, self._m.shape, self._m.coords)
                if tuple(sl.stop - sl.start for sl in b) == shape:
                    spec, gshape = cand, g
            out[path] = (spec, gshape)
        return out

    def _fragments(self, host, name, layouts):
        """This rank's fragments of the entry ``name`` (a host tree): the
        block of each sharded leaf when this rank is the first holder of
        that block (coordinate 0 on every axis that does not split it);
        replicated leaves are written whole by rank 0."""
        from ..checkpoint import reshard
        m = self._m
        root = tuple(name.split("/"))

        def pieces(path, a):
            spec, gshape = layouts[root + path]
            used = {x for e in spec for x in _entry_axes(e)}
            if not used:
                return a
            first = all(c == 0 for ax, c in m.coords.items()
                        if ax not in used)
            b = reshard._bounds(block(spec, gshape, m.shape, m.coords),
                                gshape)
            return reshard.Pieces(gshape, a.dtype, [(b, a)] if first else [])

        def walk(t, path=()):
            if isinstance(t, dict):
                return {k: walk(v, path + (k,)) for k, v in t.items()}
            return pieces(path, np.asarray(t))
        frag = reshard.split_fragments(walk(host), m.rank)
        frag["of"] = name
        return frag

    def save_checkpoint(self, path: str, layout: Optional[str] = None,
                        sync: bool = False, tag: Optional[str] = None):
        """Queue one manifest checkpoint of the parameters (a shard a
        top-level module), the optimizer state and the step counter
        (``meta``: step, seed, root name) through
        :mod:`bigdl_tpu_torch.checkpoint`: only the owning device→host
        copy blocks (``checkpoint.blocking``); serialize, CRC and the
        atomic commit run on the writer thread unless ``sync``.  With
        ``shard_arrays`` (:meth:`set_checkpoint`), and always on a mesh of
        several ranks, each entry is written as elastic v2 slice
        fragments: each rank its blocks with their global index ranges.
        With ``sync`` on a mesh, every rank returns once the checkpoint
        is committed."""
        from ..checkpoint import host_snapshot, reshard
        if layout not in (None, "manifest"):
            _unported(f"layout={layout!r} (the port writes the manifest "
                      "layout; there is no orbax)", "item 7")
        if self.params is None:
            raise ValueError("trainer not initialized; call init() first")
        mgr = self._manifest_manager(path)
        logical = {f"params/{mod}": sub for mod, sub in self.params.items()}
        logical["opt_state"] = self.opt_state
        shards, owned = {}, None
        ranks = 1 if self._m is None else self._m.size
        with self.recorder.span("checkpoint.blocking"):
            host = host_snapshot(logical)
            if ranks > 1:
                # no rank holds a whole leaf: each writes its blocks, and
                # names every rank's shard so that file names agree
                layouts = self._leaf_layouts()
                me = self._m.rank
                owned = set()
                for name in sorted(host):
                    for r in range(ranks):
                        shards[f"{name}@p{r:03d}"] = None
                    shards[f"{name}@p{me:03d}"] = self._fragments(
                        host[name], name, layouts)
                    owned.add(f"{name}@p{me:03d}")
            else:
                for name in sorted(host):
                    if self._shard_arrays:
                        frag = reshard.split_fragments(host[name])
                        frag["of"] = name
                        shards[f"{name}@p000"] = frag
                    else:
                        shards[name] = host[name]
        meta = {"step": self._step_count, "seed": self.seed,
                "root": self.model.name}
        if self._data_pipeline is not None:
            # the cursor does not depend on the mesh (the pipeline feeds
            # the global batch), so it survives a reshard unchanged
            meta["data_cursor"] = self._data_pipeline.state()
        mgr.save(shards, meta, tag=tag or f"step_{self._step_count}",
                 sync=sync, mesh=dict(self._mesh_info), owned=owned,
                 trace_ctx=None if self._trace_ctx is None
                 else self._trace_ctx.child())
        if sync and ranks > 1:
            # rank 0 commits once every part is written: wait for it, so
            # that any rank may restore the checkpoint next
            dist.barrier(group=self._m.group)

    @staticmethod
    def _rekey_root(tree, old_root, new_root):
        """Auto-named modules draw from a process-global uid counter, so a
        fresh trainer's keys differ from the saved ones only in the
        model's root prefix: rewrite it key by key (never by flatten
        order)."""
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k == old_root:
                    k = new_root
                elif k.startswith(old_root + "."):
                    k = new_root + k[len(old_root):]
                out[k] = SpmdTrainer._rekey_root(v, old_root, new_root)
            return out
        return tree

    def load_checkpoint(self, path: str):
        """Restore the newest intact manifest checkpoint under ``path``
        (CRC-verified, a torn newest one falls back) into this trainer, in
        place: the parameters (the model's own tensors), the optimizer
        state, and the step counter and seed, so that the draws continue
        as in the uninterrupted run."""
        if self.params is None:
            self.init()
        restored = self._manifest_manager(path).restore_latest(
            with_manifest=True)
        if restored is None:
            raise FileNotFoundError(f"{path}: no intact checkpoint found")
        _, trees, meta, mf = restored
        raw = {"params": {k[len("params/"):]: v for k, v in trees.items()
                          if k.startswith("params/")},
               "opt_state": trees["opt_state"]}
        return self._finish_restore(raw, meta, path,
                                    saved_mesh=mf.mesh if mf else None)

    def _finish_restore(self, raw, meta, path, saved_mesh=None):
        """Check a restored ``{params, opt_state}`` host tree of global
        arrays against this trainer (after the root rename) and copy it
        into the live tensors (on a mesh, each rank its blocks: a
        checkpoint of any mesh restores onto any other, or one device); a
        mismatch raises ``ValueError`` naming the leaf."""
        from ..checkpoint import reshard
        raw = self._rekey_root(raw, meta.get("root", self.model.name),
                               self.model.name)
        template = {"params": self.params, "opt_state": self.opt_state}
        want, got = tree_paths(template), tree_paths(raw)
        if sorted(want) != sorted(got):
            missing = sorted(set(want) - set(got))[:3]
            extra = sorted(set(got) - set(want))[:3]
            raise ValueError(
                f"{path}: checkpoint tree does not match this trainer's "
                f"model (after root-name normalisation): missing "
                f"{missing}, unexpected {extra}")
        host = dict(zip(got, tree_leaves(raw)))
        layouts = self._leaf_layouts()
        blocks = []
        for (tpath, t), where in zip(_leaf_paths(template), want):
            spec, gshape = layouts[tpath]
            v = np.asarray(host[where])
            if tuple(v.shape) != tuple(gshape) or \
                    torch.as_tensor(v).dtype != t.dtype:
                raise ValueError(
                    f"{path}: leaf {where} is {v.shape}/{v.dtype}, the "
                    f"model expects {tuple(gshape)}/{t.dtype}")
            if self._m is not None:
                v = v[block(spec, gshape, self._m.shape, self._m.coords)]
            blocks.append((t, v))
        rec = self.recorder
        resharding = (saved_mesh is not None
                      and not reshard.same_mesh(saved_mesh, self._mesh_info))
        with rec.span("elastic.reshard" if resharding
                      else "checkpoint.restore"), torch.no_grad():
            for t, v in blocks:
                t.copy_(torch.as_tensor(np.array(v)))
        if resharding:
            n_leaves = len(blocks)
            rec.inc("elastic/reshards")
            rec.inc("elastic/resharded_leaves", n_leaves)
            rec.emit_record("elastic_event", kind="reshard",
                            step=meta.get("step"), saved_mesh=saved_mesh,
                            target_mesh=dict(self._mesh_info),
                            leaves=n_leaves)
            onto = "one device" if self._m is None else \
                f"rank {self._m.rank} of the mesh"
            print(f"[elastic] restored onto {onto}: "
                  f"{reshard.describe_delta(saved_mesh, self._mesh_info)}",
                  flush=True)
        self._step_count = int(meta["step"])
        self.seed = int(meta.get("seed", self.seed))
        cursor = meta.get("data_cursor")
        if cursor is not None and self._data_pipeline is not None:
            self._data_pipeline.restore(cursor)
        return self

    def set_checkpoint(self, path: str, every_steps: int = 1000,
                       keep: int = 3, layout: str = "manifest",
                       async_write: bool = True,
                       shard_arrays: bool = False,
                       handle_preemption: bool = False):
        """Checkpoint every ``every_steps`` steps during :meth:`fit`,
        keeping the newest ``keep`` (0 keeps all; retention runs in the
        manager's GC on the writer thread).  ``layout`` is ``"manifest"``
        (the reference's default ``"orbax"`` is not ported and raises).
        ``shard_arrays`` writes elastic v2 slice fragments.
        ``handle_preemption`` installs a SIGTERM handler: ``fit`` finishes
        the in-flight write, commits a final ``preempt_step_<n>``
        checkpoint synchronously and returns."""
        if every_steps < 1:
            raise ValueError("every_steps must be >= 1")
        if keep < 0:
            raise ValueError("keep must be >= 0")
        if layout != "manifest":
            _unported(f"layout={layout!r} (the port writes the manifest "
                      "layout; there is no orbax)", "item 7")
        self._ckpt = (path, int(every_steps), int(keep))
        self._shard_arrays = bool(shard_arrays)
        self._ckpt_mgr = None           # rebuild with this retention
        self._manifest_manager(path, keep=int(keep) or None,
                               async_write=async_write)
        if handle_preemption:
            from ..checkpoint import PreemptionHandler
            if self._preemption is None:
                self._preemption = PreemptionHandler()
            self._preemption.install()
        return self

    # -- summaries ------------------------------------------------------- #
    def set_val_summary(self, summary):
        """``ValidationSummary`` for :meth:`evaluate`: Loss and
        Perplexity at the current step."""
        self._val_summary = summary
        return self

    def set_train_summary(self, summary):
        """``TrainSummary`` for :meth:`fit`: Loss a step (under the
        summary's Loss trigger) and Throughput (tokens/s) at each flush.
        Losses stay on the device and are written every
        ``summary_flush_every`` steps and when ``fit`` ends (an exception
        too), one host sync a flush."""
        self._train_summary = summary
        return self

    def _flush_summary(self, buffered, tokens_seen, t0):
        """Write the buffered ``(step, device loss)`` pairs; returns []."""
        summary = self._train_summary
        trig = getattr(summary, "get_summary_trigger",
                       lambda _t: None)("Loss")
        host = torch.stack([loss.detach().float()
                            for _, loss in buffered]).tolist()
        for (s, _), v in zip(buffered, host):
            if trig is None or trig(SimpleNamespace(iteration=s)):
                summary.add_scalar("Loss", v, s)
        wall = max(time.time() - t0, 1e-9)
        summary.add_scalar("Throughput", tokens_seen / wall, buffered[-1][0])
        return []

    # -- the loop -------------------------------------------------------- #
    def _rollback(self, err, ckpt) -> bool:
        """Restore the newest committed checkpoint after a divergence,
        when the policy allows another rollback; False to re-raise."""
        if ckpt is None or not self._may_roll_back():
            return False
        try:
            self.load_checkpoint(ckpt[0])
        except (FileNotFoundError, ValueError):
            return False        # no restorable checkpoint: diverge
        self._rolled_back(err, f"step {self._step_count}")
        return True

    def fit(self, batches, steps: Optional[int] = None, log_every: int = 0,
            summary_flush_every: int = 100):
        """Step over ``(tokens, targets)`` batches (at most ``steps``);
        returns the losses as floats.  A divergence under
        ``policy="rollback"`` restores the newest checkpoint and goes on
        with the next batch; SIGTERM (``handle_preemption``) commits a
        final checkpoint and stops; every triggered checkpoint is
        committed when ``fit`` returns."""
        from ..observability.health import DivergenceError
        losses, buffered = [], []
        tokens_seen = 0
        ckpt = self._ckpt
        summary = self._train_summary
        t0 = time.time()
        if self._watchdog is not None:
            self._watchdog.start()      # re-arms after a previous fit()
        if steps is not None:
            # never pull a batch past the last step: a data pipeline's
            # cursor counts every batch taken
            batches = itertools.islice(batches, steps)
        try:
            for i, (tokens, targets) in enumerate(batches):
                try:
                    loss = self.step(tokens, targets)
                except DivergenceError as e:
                    if not self._rollback(e, ckpt):
                        raise
                    continue
                if log_every and (i + 1) % log_every == 0:
                    print(f"step {i + 1}: loss={float(loss):.4f} "
                          f"({(i + 1) / (time.time() - t0):.2f} it/s)")
                losses.append(loss)
                if (ckpt is not None and self._preemption is not None
                        and self._preemption.requested):
                    self.save_checkpoint(
                        ckpt[0], sync=True,
                        tag=f"preempt_step_{self._step_count}")
                    print(f"[preemption] final checkpoint at step "
                          f"{self._step_count} committed; stopping "
                          "cleanly", flush=True)
                    break
                if ckpt is not None and self._step_count % ckpt[1] == 0:
                    self.save_checkpoint(ckpt[0])
                if self._weight_stream is not None:
                    # the snapshot is taken here, before the next step's
                    # in-place update; the loss stays on the device
                    self._weight_stream.maybe_publish(self.params,
                                                      step=self._step_count)
                if summary is not None:
                    tokens_seen += int(np.prod(np.shape(tokens)))
                    buffered.append((self._step_count, loss))
                    if len(buffered) >= summary_flush_every:
                        buffered = self._flush_summary(buffered,
                                                       tokens_seen, t0)
        finally:
            if summary is not None and buffered:
                self._flush_summary(buffered, tokens_seen, t0)
            if self._ckpt_mgr is not None:
                # drain the writer: every triggered checkpoint is
                # committed and durable when fit() returns
                self._ckpt_mgr.wait()
            if self._watchdog is not None:
                self._watchdog.stop()
        return torch.stack(losses).tolist() if losses else []
