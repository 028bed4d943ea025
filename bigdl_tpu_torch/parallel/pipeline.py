"""Pipeline parallelism over the ``pp`` mesh axis (≙
``bigdl_tpu/parallel/pipeline.py``).

The reference runs the GPipe schedule as one ``shard_map`` program: a
``lax.scan`` over ticks moves microbatches stage to stage with
``ppermute``, and ``jax.grad`` transposes it into the backward pipeline.
Here each pp rank is a process holding one stage, and the schedule is
point-to-point sends between neighbours on ``pp``
(:meth:`~bigdl_tpu_torch.parallel.mesh.Mesh.pp_neighbours`):

  * forward: stage 0 feeds the microbatches; each stage runs its blocks
    on microbatch 0, 1, ... in turn and sends each output (the
    activation dtype, ``(mb, S/sp, D)``) to the next stage, which
    receives it; the last stage keeps the outputs;
  * backward: in reverse microbatch order each stage receives the
    gradient of its output from the next stage (the last stage takes it
    from the loss), back-propagates through its blocks and sends the
    gradient of its input to the previous stage.

:func:`pipeline_run` is that schedule as one autograd function, so that
the trainer differentiates through it as the reference differentiates
through the scan.  Every rank makes its sends and receives in the same
order (forward 0..M-1, backward M-1..0), which NCCL needs.

:class:`PipelineLMTrainer` trains a TransformerLM over ``pp`` (× ``dp``,
``tp``, ``sp``, ``ep``): each pp rank owns ``n_layers/pp`` blocks, stage 0
embeds the local batch, the last stage runs the final norm, the head and
the loss; the rest parameters (embedding, final norm, head) are kept
whole on every rank and their gradients summed over pp.  Inside a stage,
tp and sp are the port's sharded step (``Ctx.shard``: Megatron's
collectives, attention over the sequence gathered over sp), and an MoE
block routes the local microbatch (over its whole sequence), as the
reference's manual dp axis makes it do.  As in the reference, each block
runs with a fresh ``Ctx``, so an MoE block's load-balancing loss is not
part of the pipeline's loss.

On the card each block's attention runs K1 (forward) and K2/K3
(backward) once per microbatch; ``fused_optim`` routes the update through
K4 (Adam/AdamW) or K5/K6 (SGD).
"""
from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..nn.module import Ctx
from ..observability import collectives as _acct
from ..optim.optimizer import TelemetryHealth
from . import mesh as mesh_lib
from . import tp_ops
from .allreduce import _CAST, tree_leaves, tree_unflatten
from .bucketer import GradBucketer
from .spmd import (Shard, _entry_axes, _mesh_axes, big, block, param_shardings,
                   token_group)
from .zero import Zero1Layout

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# --------------------------------------------------------------------- #
# the schedule                                                            #
# --------------------------------------------------------------------- #
def _stage_of(mesh):
    """``(index, n_stages, previous rank, next rank)`` on ``pp``."""
    if mesh is None or "pp" not in getattr(mesh, "shape", {}):
        return 0, 1, None, None
    prev, nxt = mesh.pp_neighbours()
    return mesh.coords["pp"], mesh.shape["pp"], prev, nxt


class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one rank: forward over the microbatches with
    sends to the next stage, backward in reverse order with sends to the
    previous one.  The stage's graphs are built in the forward (on
    detached copies of the parameters) and differentiated in the
    backward, a microbatch at a time."""

    @staticmethod
    def forward(ctx, stage_fn, like, stage, microbatches, *leaves):
        index, n, prev, nxt = stage
        first, last = index == 0, index == n - 1
        m = microbatches.shape[0]
        shape, dtype = microbatches.shape[1:], microbatches.dtype
        ps = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        params = tree_unflatten(like, ps)
        ins, outs = [], []
        with torch.enable_grad():
            for i in range(m):
                if first:
                    x = microbatches[i].detach().requires_grad_(
                        ctx.needs_input_grad[3])
                else:
                    x = torch.empty(shape, dtype=dtype,
                                    device=microbatches.device)
                    dist.recv(x, prev)
                    x.requires_grad_(True)
                y = stage_fn(params, x)
                if not last:
                    dist.send(y.detach().contiguous(), nxt)
                ins.append(x)
                outs.append(y)
        ctx.stage, ctx.graph = stage, (ins, outs, ps)
        if last:
            return torch.stack([y.detach() for y in outs])
        return torch.zeros_like(microbatches)

    @staticmethod
    def backward(ctx, grad):
        index, n, prev, nxt = ctx.stage
        first, last = index == 0, index == n - 1
        ins, outs, ps = ctx.graph
        ctx.graph = None
        want = [i for i, p in enumerate(ps) if p.requires_grad]
        acc = [None] * len(ps)
        d_in = [None] * len(ins)
        for i in reversed(range(len(outs))):
            if last:
                dy = grad[i]
            else:
                dy = torch.empty_like(outs[i])
                dist.recv(dy, nxt)
            xs = [ins[i]] if ins[i].requires_grad else []
            gs = torch.autograd.grad(outs[i], [ps[j] for j in want] + xs,
                                     dy, allow_unused=True)
            for j, g in zip(want, gs):
                if g is not None:
                    acc[j] = g if acc[j] is None else acc[j] + g
            if xs:
                if first:
                    d_in[i] = gs[-1]
                else:
                    dist.send(gs[-1].contiguous(), prev)
        acc = [None if j not in want else
               (torch.zeros_like(ps[j]) if a is None else a)
               for j, a in enumerate(acc)]
        d_mb = torch.stack(d_in) if first and ctx.needs_input_grad[3] \
            else None
        return (None, None, None, d_mb, *acc)


def pipeline_run(stage_fn: Callable, stage_params, microbatches, mesh=None):
    """Run the GPipe schedule on this rank (differentiable).

    ``stage_fn(params_of_my_stage, x) -> y`` (x and y of one shape);
    ``stage_params`` this rank's stage parameters (a nested dict);
    ``microbatches`` ``(M, mb, ...)``, read by stage 0 only (the other
    stages pass a tensor of that shape and dtype, whose values are not
    read).  Returns the ``(M, mb, ...)`` outputs on the last stage, zeros
    elsewhere (weight per-stage reductions with :func:`last_stage_mask`).
    ``mesh`` without a ``pp`` axis (or None) is one stage."""
    leaves = tree_leaves(stage_params)
    return _GPipe.apply(stage_fn, stage_params, _stage_of(mesh),
                        microbatches, *leaves)


def last_stage_mask(mesh=None) -> float:
    """1.0 on the last pp rank, 0.0 elsewhere."""
    index, n, _, _ = _stage_of(mesh)
    return float(index == n - 1)


def pipelined(stage_fn: Callable, mesh, n_microbatches: int):
    """The rank-local form of the reference's ``pipelined``: ``f(params,
    x)`` with ``params`` this rank's stage parameters and ``x`` (batch,
    ...) the same input on every rank; the result (batch, ...) is the
    whole model's output on the last stage (zeros elsewhere).  The
    gradient of ``x`` lands on stage 0."""
    def f(params, x):
        mbs = x.reshape((n_microbatches, -1) + tuple(x.shape[1:]))
        return pipeline_run(stage_fn, params, mbs, mesh).reshape(x.shape)
    return f


# --------------------------------------------------------------------- #
# the trainer                                                             #
# --------------------------------------------------------------------- #
class _Exchange:
    """One gradient chunk's dp-group exchange, started asynchronously;
    :meth:`wait` returns the exchanged leaves."""

    def __init__(self, works, finish):
        self._works, self._finish = works, finish

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish()


class PipelineLMTrainer(TelemetryHealth):
    """GPipe training of a TransformerLM over a mesh with a ``pp`` axis
    (and optionally ``dp``, ``tp``, ``sp``, ``ep``), with the reference's
    knobs (same semantics as ``DistriOptimizer``'s):

    ``zero1``        ZeRO-1 over ``dp``: gradients reduce-scatter into
                     two shard spaces (the rest, and this stage's blocks;
                     :class:`~bigdl_tpu_torch.parallel.zero.Zero1Layout`),
                     each rank updates its 1/dp with its 1/dp of the
                     moments (1/(pp·dp) of the model's), and the
                     parameters are all-gathered back.  Elementwise
                     optimizers only.
    ``bucket_bytes`` the dp exchange in flat single-dtype buckets, two
                     streams (rest, blocks).
    ``compress``     ``"fp16"``/``"bf16"`` on the dp wire (the mean
                     travels, pre-scaled in fp32).
    ``fused_optim``  the update through the fused kernels (K4 for
                     Adam/AdamW, K5/K6 for SGD) on a copy of the method.
    ``overlap_grad_chunks``
                     the microbatches split into this many chunks, each
                     its own schedule, whose dp exchange is started
                     (``async_op``) before the next chunk starts; chunks
                     are summed after their exchange.
    ``clip_norm``    global L2 clipping with the reference's axis-group
                     scoping (the rest summed over dp on the zero1 path,
                     the blocks over dp × pp, or pp alone without zero1).

    ``mesh`` is a :class:`~bigdl_tpu_torch.parallel.mesh.Mesh` or an
    ``{axis: size}`` dict (over the started process group; with every
    axis 1 and no group, one device).  :meth:`init` takes the model's own
    parameters, as ``SpmdTrainer`` does (the reference draws them from
    ``seed``); ``seed`` is kept for the reference's signature.
    :meth:`step` takes the global batch (every rank the same) and returns
    the loss as a device tensor; :meth:`merge` gathers the model's flat
    parameters (a collective).

    Not ported: LARS and LAMB, whose trust ratios the reference takes over
    the layer-stacked block tensors (a norm across every stage), raise.
    """

    def __init__(self, model, optim, mesh, n_microbatches=4, seed=0,
                 loss_chunk=None, zero1=False, bucket_bytes=None,
                 compress=None, fused_optim=False, overlap_grad_chunks=1,
                 clip_norm=None, *, device: DeviceLike = None):
        from ..optim.optim_method import LAMB, LARS
        if model.frozen_param_names():
            raise NotImplementedError(
                "Module.freeze is not supported by PipelineLMTrainer "
                "(block params are stacked per stage, losing per-module "
                "identity); unfreeze or use SpmdTrainer")
        cfg = model.cfg
        if cfg.dropout:
            raise ValueError("PipelineLMTrainer requires dropout=0.0")
        axes = _mesh_axes(mesh)
        if "pp" not in axes:
            raise ValueError("mesh needs a 'pp' axis")
        self.n_stages = axes["pp"]
        if cfg.n_layers % self.n_stages:
            raise ValueError(
                f"n_layers={cfg.n_layers} must divide by pp={self.n_stages}")
        n_dp = axes.get("dp", 1)
        if (zero1 or bucket_bytes or compress) and n_dp < 2:
            raise ValueError(
                "zero1/bucket_bytes/compress drive the dp-group gradient "
                f"exchange: the mesh needs a dp axis > 1 (got dp={n_dp})")
        if compress not in (None, "fp16", "float16", "bf16", "bfloat16"):
            raise ValueError(
                f"unknown compress mode {compress!r} "
                "(fp16/float16/bf16/bfloat16)")
        if zero1 and isinstance(optim, (LARS, LAMB)):
            raise ValueError(
                f"zero1 cannot shard {type(optim).__name__}: its "
                "per-TENSOR trust ratios need whole-tensor norms, "
                "and a dim-0 shard's norm is not the tensor's norm")
        if fused_optim:
            if not hasattr(optim, "fused"):
                raise ValueError(
                    f"fused_optim=True: {type(optim).__name__} has no "
                    "fused kernel (supported: SGD, Adam, AdamW)")
            optim = copy.copy(optim)    # never mutate the caller's method
            optim.fused = True
        if isinstance(optim, (LARS, LAMB)):
            raise NotImplementedError(
                f"PipelineLMTrainer: {type(optim).__name__}'s trust ratios "
                "are taken over the reference's layer-stacked block tensors "
                "(one norm across every stage); not ported")
        self.overlap_chunks = int(overlap_grad_chunks)
        if self.overlap_chunks < 1 or n_microbatches % self.overlap_chunks:
            raise ValueError(
                f"overlap_grad_chunks={overlap_grad_chunks} must be >= 1 "
                f"and divide n_microbatches={n_microbatches}")
        if axes.get("fsdp", 1) > 1:
            raise ValueError(
                "fsdp does not compose with the pipeline engine (stage "
                "params are layer-stacked; use zero1 for the sharded "
                "update, or drop pp and let SpmdTrainer layer fsdp)")
        m = None
        if isinstance(mesh, mesh_lib.Mesh):
            m = mesh
        elif dist.is_initialized():
            m = mesh_lib.create_mesh(axes, device=device)
        elif any(n > 1 for n in axes.values()):
            raise RuntimeError(
                f"PipelineLMTrainer: the mesh {axes} needs a started process "
                "group (parallel.mesh.init_distributed); without one every "
                "axis must be 1")
        if m is not None:
            device = m.device
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.model, self.optim, self.mesh, self._m = model, optim, mesh, m
        self._axes = axes
        self.n_micro = int(n_microbatches)
        self.seed = int(seed)
        self.loss_chunk = loss_chunk
        self.zero1 = bool(zero1)
        self.bucket_bytes = bucket_bytes
        self.compress = compress
        self.clip_norm = clip_norm
        self.fused_optim = bool(fused_optim)
        self._block_names = [b.name for b in model.blocks]
        self.params = None
        self.opt_state = None
        self._step_count = 0
        self._seen_sigs = set()
        self._init_telemetry()

    # -- set-up ---------------------------------------------------------- #
    def _group(self, axes):
        if self._m is None:
            return None, 1, 0
        return self._m.group_of(axes)

    def init(self):
        """Take this stage's share of the model's parameters (the rest
        whole, the stage's blocks sliced over tp/ep by their pspec) and
        build the optimizer state."""
        model = self.model
        params = model.param_dict()
        bad = sorted({str(p.device) for p in tree_leaves(params)
                      if p.device != self.device})
        if bad:
            raise ValueError(f"PipelineLMTrainer: the model's parameters are "
                             f"on {bad}, the trainer's device is "
                             f"{self.device}; move the model first")
        index, n, _, _ = _stage_of(self._m)
        self._first, self._last = index == 0, index == n - 1
        per = len(self._block_names) // n
        self._my_blocks = list(model.blocks)[index * per:(index + 1) * per]
        prefixes = tuple(b + "." for b in self._block_names)
        mine = tuple(b.name + "." for b in self._my_blocks)
        rest_mods = sorted(k for k in params if not k.startswith(prefixes))
        blk_mods = sorted(k for k in params if k.startswith(mine))
        specs = param_shardings(model, params, self._axes, fsdp=False)
        self._specs = {mod: specs[mod] for mod in blk_mods}
        mesh_shape = self._m.shape if self._m else {}
        coords = self._m.coords if self._m else {}

        def local(t, spec):
            b = block(spec, tuple(t.shape), mesh_shape, coords)
            if all(sl.start == 0 and sl.stop == s
                   for sl, s in zip(b, t.shape)):
                return t
            return t.detach()[b].clone().requires_grad_(t.requires_grad)
        self._rest = {mod: dict(params[mod]) for mod in rest_mods}
        self._blocks = {mod: {k: local(p, self._specs[mod][k])
                              for k, p in params[mod].items()}
                        for mod in blk_mods}
        self.params = {**self._rest, **self._blocks}
        self._keys = ([(mod, k) for mod in rest_mods
                       for k in sorted(params[mod])]
                      + [(mod, k) for mod in blk_mods
                         for k in sorted(params[mod])])
        self._n_rest = sum(len(params[mod]) for mod in rest_mods)
        # groups: (group, size, index), group None for a size of 1
        g = self._group
        self._dp = g(("dp",)) if "dp" in self._axes else (None, 1, 0)
        self._sp = g(("sp",))
        self._rest_sum = g(("pp", "sp"))
        self._loss_group = g(("dp", "pp", "sp"))
        self._model_group = g(("pp", "tp", "ep"))
        self._tokens = token_group(self._m, ()) if self._m else None
        self._dp_view = SimpleNamespace(group=self._dp[0],
                                        shape={"dp": self._dp[1]})
        # each block leaf's copies over tp × ep (the health and clip sums
        # count a replicated leaf once)
        self._reps = [1.0] * self._n_rest + [
            float(self._replicas(self._specs[mod][k]))
            for mod, k in self._keys[self._n_rest:]]
        self._bucketers = None
        if self.bucket_bytes and not self.zero1:
            self._bucketers = (
                GradBucketer(self._rest, bucket_bytes=self.bucket_bytes),
                GradBucketer(self._blocks, bucket_bytes=self.bucket_bytes))
        if self.zero1:
            n_dp, i_dp = self._dp[1], self._dp[2]
            self._z1 = (Zero1Layout(self._rest, n_dp, self.bucket_bytes),
                        Zero1Layout(self._blocks, n_dp, self.bucket_bytes))
            self._masters = (self._z1[0].local_shard(self._rest, i_dp),
                             self._z1[1].local_shard(self._blocks, i_dp))
            self._space_like = tuple(
                {k: {kk: None for kk in v} for k, v in s.items()}
                for s in self._masters)
            self._z1_weights = self._space_weights(self._z1[1])
            self.opt_state = {"rest": self.optim.init_state(self._masters[0]),
                              "blocks": self.optim.init_state(
                                  self._masters[1])}
        else:
            self.opt_state = self.optim.init_state(self.params)
        return self

    def _replicas(self, spec) -> int:
        """How many ranks of a stage's ``tp × ep`` hold the same block of
        a leaf of ``spec``."""
        used = {a for e in spec for a in _entry_axes(e)}
        return int(np.prod([self._axes.get(a, 1) for a in ("tp", "ep")
                            if a not in used], dtype=np.int64))

    def _space_weights(self, layout):
        """The weights of the blocks' zero1 shard space, in its
        ``tree_leaves`` order (flat buckets, then dim-0 shards): 1 / the
        copies over the stage's tp × ep of each leaf, per element of this
        rank's chunk of a flat bucket; None where every weight is 1."""
        reps = self._reps[self._n_rest:]
        n, i = layout.n, self._dp[2]
        flat = []
        for dt, idxs, sizes, pad in layout.buckets:
            w = torch.cat([torch.full((sz,), 1.0 / reps[j])
                           for j, sz in zip(idxs, sizes)]
                          + [torch.zeros(pad)])
            chunk = w.shape[0] // n
            w = w[i * chunk:(i + 1) * chunk]
            flat.append(None if bool((w == 1.0).all())
                        else w.to(self.device))
        return flat + [None if reps[j] == 1.0 else 1.0 / reps[j]
                       for j in layout.sharded_idx]

    # -- the step -------------------------------------------------------- #
    def _shards(self, mb, sl, s):
        """The ``Ctx.shard`` of the rest modules and of the blocks for
        microbatches of ``mb`` rows and ``sl`` of ``s`` positions."""
        sp = big(self._sp)
        i = self._sp[2]
        rows, seq = (0, mb, mb), (i * sl, (i + 1) * sl, s)
        rest = Shard(None, sp, rows, seq)
        blocks = Shard(big(self._group(("tp",))), sp, rows, seq,
                       ep=big(self._group(("ep",))),
                       experts=big(self._group(("tp", "ep"))),
                       tokens=self._tokens)
        return rest, blocks

    def _chunk(self, tok, tgt, m, s_total):
        """(this rank's masked NLL total, the gradients of its leaves in
        :attr:`_keys` order) of one chunk of ``m`` microbatches."""
        from ..models.transformer import chunked_token_nll, lm_token_nll
        model, cfg, params = self.model, self.model.cfg, self.params
        rows, sl = tok.shape
        d = cfg.d_model
        dt = getattr(torch, cfg.dtype)
        rest_shard, blk_shard = self._shards(rows // m, sl, s_total)
        ctx = Ctx(state={}, training=True, shard=rest_shard)
        if self._first:
            h = model.embed.apply(params, tok, ctx).to(dt)
            mbs = h.reshape(m, rows // m, sl, d)
        else:
            mbs = torch.empty((m, rows // m, sl, d), dtype=dt,
                              device=self.device)
        blocks = self._my_blocks

        def stage_fn(p, x):
            c = Ctx(state={}, training=True, shard=blk_shard)
            for blk in blocks:
                x = blk.apply(p, x, c)
            return x

        outs = pipeline_run(stage_fn, self._blocks, mbs, self._m)
        leaves = [params[mod][k] for mod, k in self._keys]
        if self._last:
            h_out = model.final_norm.apply(params, outs.reshape(rows, sl, d),
                                           ctx)
            lc = self.loss_chunk

            def head_fn(h_c):
                return model.head_logits(params, h_c, ctx)
            # as TransformerLM.token_nll: a chunk covering the whole
            # sequence means no chunking
            if lc and lc < s_total:
                tot, _ = chunked_token_nll(head_fn, h_out, tgt, lc)
            else:
                tot, _ = lm_token_nll(head_fn(h_out).float(), tgt)
            grads = torch.autograd.grad(tot, leaves, allow_unused=True)
        else:
            tot = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = torch.autograd.grad(outs, leaves, torch.zeros_like(outs),
                                        allow_unused=True)
        return tot.detach(), [torch.zeros_like(p) if g is None else g
                              for p, g in zip(leaves, grads)]

    def _sum_model_axes(self, grads):
        """The rest gradients summed over pp × sp (each stage holds its
        part, zeros elsewhere; each sp rank its sequence block's), the
        block gradients over sp: one all-reduce a dtype and group."""
        rec = self._rec_or_none()
        nr = self._n_rest
        for (lo, hi), grp, name in (((0, nr), self._rest_sum, "pp"),
                                    ((nr, len(grads)), self._sp, "sp")):
            if grp[0] is None or hi == lo:
                continue
            by_dt = {}
            for i in range(lo, hi):
                by_dt.setdefault(grads[i].dtype, []).append(i)
            for idx in by_dt.values():
                flat = torch.cat([grads[i].reshape(-1) for i in idx])
                dist.all_reduce(flat, group=grp[0])
                raw = _acct.leaf_bytes(flat)
                v = _acct.ring_allreduce_bytes(raw, grp[1])
                _acct.account_collective("allreduce", v, v, rec, name)
                for i, part in zip(idx, flat.split(
                        [grads[i].numel() for i in idx])):
                    grads[i] = part.view_as(grads[i])
        return grads

    def _rec_or_none(self):
        return self.recorder if self._telemetry else None

    def _exchange(self, grads) -> _Exchange:
        """One chunk's dp exchange, started now: the mean over dp (per
        leaf, per bucket, or reduce-scattered into zero1's shard spaces);
        its :meth:`_Exchange.wait` gives the leaves (in :attr:`_keys`
        order, or the two shard spaces' leaves under zero1)."""
        group, n, _ = self._dp
        rec = self._rec_or_none()
        cast = _CAST.get(self.compress)
        wire_item = _acct.compressed_itemsize(self.compress)
        if group is None:
            return _Exchange([], lambda: grads)
        nr = self._n_rest
        fams = (grads[:nr], grads[nr:])
        templates = (self._rest, self._blocks)
        works, sends = [], []

        def start(t, scatter):
            """Start one collective of ``t``; returns its finisher."""
            src = (t.float() / n).to(cast) if cast is not None \
                else t.contiguous()
            if scatter:
                out = src.new_empty((src.shape[0] // n,)
                                    + tuple(src.shape[1:]))
                works.append(_reduce_scatter(out, src, group=group,
                                             async_op=True))
            else:
                out = src
                works.append(dist.all_reduce(out, group=group,
                                             async_op=True))
            return lambda: (out / n if cast is None else out.to(t.dtype))

        if self.zero1:
            for fam, layout in zip(fams, self._z1):
                leaves = list(fam)
                raw = wire = 0
                fin_l = []
                for i in layout.sharded_idx:
                    raw += _acct.leaf_bytes(leaves[i])
                    wire += _acct.leaf_bytes(leaves[i], wire_item)
                    fin_l.append(start(leaves[i], True))
                fin_f = []
                for bi in range(len(layout.buckets)):
                    vec = layout._pack_bucket(leaves, bi)
                    raw += _acct.leaf_bytes(vec)
                    wire += _acct.leaf_bytes(vec, wire_item)
                    fin_f.append(start(vec, True))
                _acct.account_collective(
                    "reduce_scatter", _acct.ring_gather_bytes(raw, n),
                    _acct.ring_gather_bytes(wire, n), rec, "dp")
                sends.append((layout, fin_f, fin_l))

            def finish():
                out = []
                for layout, fin_f, fin_l in sends:
                    out.extend(tree_leaves(layout._space(
                        [f() for f in fin_f], [f() for f in fin_l])))
                return out
            return _Exchange(works, finish)

        if self._bucketers is not None:
            for fam, like, bk in zip(fams, templates, self._bucketers):
                vecs = bk.pack(tree_unflatten(like, list(fam)))
                raw = sum(_acct.leaf_bytes(v) for v in vecs)
                wire = raw if wire_item is None else sum(
                    v.shape[0] * wire_item for v in vecs)
                _acct.account_collective(
                    "allreduce", _acct.ring_allreduce_bytes(raw, n),
                    _acct.ring_allreduce_bytes(wire, n), rec, "dp")
                if rec is not None:
                    for name in ("collective/buckets",
                                 "comm/group.dp.buckets"):
                        rec.gauge(name, rec.gauge_value(name) + len(vecs))
                sends.append((bk, [start(v, False) for v in vecs]))

            def finish():
                out = []
                for bk, fins in sends:
                    out.extend(tree_leaves(bk.unpack([f() for f in fins])))
                return out
            return _Exchange(works, finish)

        for fam in fams:
            raw = _acct.tree_bytes(fam)
            wire = _acct.tree_bytes(fam, wire_item) if wire_item else raw
            _acct.account_collective(
                "allreduce", _acct.ring_allreduce_bytes(raw, n),
                _acct.ring_allreduce_bytes(wire, n), rec, "dp")
        fins = [start(g, False) for g in grads]
        return _Exchange(works, lambda: [f() for f in fins])

    # -- scoped reductions ----------------------------------------------- #
    def _group_sq(self, fn, rest, blocks, sharded: bool):
        """The reference's ``group_sq``: ``fn(tensor, weight)`` (a sum)
        over the rest family and the block family, each reduced over its
        axis group: on zero1's shard spaces the rest over dp and the
        blocks over dp × pp, otherwise the blocks over pp.  A block leaf
        held whole by several ranks of the stage's tp × ep is counted
        once (its weight)."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        sr = sum((fn(t, None) for t in rest), zero)
        weights = self._z1_weights if sharded else \
            [1.0 / r for r in self._reps[self._n_rest:]]
        sb = sum((fn(t, w) for t, w in zip(blocks, weights)), zero)
        if sharded:
            sr = tp_ops._all_reduce(sr, self._dp[0])
            sb = tp_ops._all_reduce(sb, self._group(("dp", "pp", "tp",
                                                     "ep"))[0])
        else:
            sb = tp_ops._all_reduce(sb, self._model_group[0])
        return sr + sb

    def _norms(self, g_r, g_b, sharded: bool):
        """``(sqrt of the scoped sum of squares, scoped nonfinite
        count)``."""
        def sq(t, w):
            t = t.float()
            return torch.sum(t * t if w is None else t * t * w)

        def nonfinite(t, w):
            bad = (~torch.isfinite(t)).float()
            return torch.sum(bad if w is None else bad * w)
        return (torch.sqrt(self._group_sq(sq, g_r, g_b, sharded)),
                self._group_sq(nonfinite, g_r, g_b, sharded))

    # -- API ------------------------------------------------------------- #
    def step(self, tokens, targets):
        """One training step on the global batch; returns the loss as a
        device tensor."""
        if self.params is None:
            self.init()
        n_dp = self._axes.get("dp", 1)
        batch, seq = int(np.shape(tokens)[0]), int(np.shape(tokens)[1])
        if batch % n_dp:
            raise ValueError(f"batch {batch} must divide by dp={n_dp}")
        if (batch // n_dp) % self.n_micro:
            raise ValueError(
                f"per-dp-shard batch {batch // n_dp} must divide by "
                f"n_microbatches={self.n_micro}")
        n_sp = self._axes.get("sp", 1)
        if seq % n_sp:
            raise ValueError(
                f"sequence length {seq} must divide by sp={n_sp}")
        rec = self.recorder
        telemetry = self._telemetry
        if telemetry:
            rec.start_step(self._step_count)
            _acct.reset_step(rec)
        with rec.span("h2d"):
            tokens, targets = self._to_device(tokens), \
                self._to_device(targets)
        span = "train_step"
        if telemetry:
            sig = (tuple(tokens.shape), str(tokens.dtype),
                   tuple(targets.shape), str(targets.dtype))
            if sig not in self._seen_sigs:
                self._seen_sigs.add(sig)
                span = "train_step_compile"
                rec.scalar("recompile", 1.0)
        with rec.span(span):
            loss, health = self._train(tokens, targets,
                                       telemetry and self._telemetry_health)
        self._step_count += 1
        if telemetry:
            self._emit(int(tokens.numel()), loss, health)
        return loss

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _train(self, tokens, targets, with_health: bool):
        b, s = tokens.shape
        n_dp, i_dp = self._dp[1], self._dp[2]
        sl = s // self._sp[1]
        k = b // n_dp
        i_sp = self._sp[2]
        tok = tokens[i_dp * k:(i_dp + 1) * k, i_sp * sl:(i_sp + 1) * sl]
        tgt = targets[i_dp * k:(i_dp + 1) * k, i_sp * sl:(i_sp + 1) * sl]
        n_chunks = self.overlap_chunks
        m_chunk = self.n_micro // n_chunks
        if k % n_chunks:
            raise ValueError(f"local batch {k} must divide by "
                             f"overlap_grad_chunks={n_chunks}")
        rows_c = k // n_chunks
        # the valid-token count of this dp rank's rows (all of their
        # sequence): the mean's denominator, applied to each chunk's
        # gradients before its exchange
        cnt = tp_ops._all_reduce((tgt != -1).float().sum(), self._sp[0])
        cnt = torch.clamp(cnt, min=1.0)
        tot_acc, acc, pending = None, None, []
        for c in range(n_chunks):
            tot, grads = self._chunk(tok[c * rows_c:(c + 1) * rows_c],
                                     tgt[c * rows_c:(c + 1) * rows_c],
                                     m_chunk, s)
            grads = self._sum_model_axes([g / cnt for g in grads])
            pending.append(self._exchange(grads))
            tot_acc = tot if tot_acc is None else tot_acc + tot
        for p in pending:
            got = p.wait()
            acc = got if acc is None else [a + g for a, g in zip(acc, got)]
        loss = tp_ops._all_reduce(tot_acc / cnt, self._loss_group[0])
        if n_dp > 1:
            loss = loss / n_dp
        with torch.no_grad():
            health = self._update(acc, with_health)
        return loss, health

    def _split_space(self, leaves):
        """Zero1's exchanged leaves as the two shard-space trees."""
        nr = len(tree_leaves(self._space_like[0]))
        return (tree_unflatten(self._space_like[0], leaves[:nr]),
                tree_unflatten(self._space_like[1], leaves[nr:]))

    def _update(self, acc, with_health: bool):
        """Clip, update (in place) and the health scalars."""
        optim = self.optim
        clip = self.clip_norm
        if self.zero1:
            g_r, g_b = self._split_space(acc)
            lr, lb = tree_leaves(g_r), tree_leaves(g_b)
            if clip is not None:
                total, _ = self._norms(lr, lb, True)
                scale = torch.clamp(clip / torch.clamp(total, min=1e-12),
                                    max=1.0)
                g_r = {a: {b: t * scale for b, t in v.items()}
                       for a, v in g_r.items()}
                g_b = {a: {b: t * scale for b, t in v.items()}
                       for a, v in g_b.items()}
                lr, lb = tree_leaves(g_r), tree_leaves(g_b)
            pr, pb = self._masters
            old = None
            if with_health:
                old = [t.float().clone() for t in
                       tree_leaves(pr) + tree_leaves(pb)]
            _, self.opt_state["rest"] = optim.update(
                g_r, pr, self.opt_state["rest"])
            _, self.opt_state["blocks"] = optim.update(
                g_b, pb, self.opt_state["blocks"])
            rec = self._rec_or_none()
            self._z1[0].gather_params(pr, self._dp_view, out=self._rest,
                                      recorder=rec)
            self._z1[1].gather_params(pb, self._dp_view, out=self._blocks,
                                      recorder=rec)
            if not with_health:
                return None
            return self._health(lr, lb, tree_leaves(pr), tree_leaves(pb),
                                old, True)
        nr = self._n_rest
        if clip is not None:
            total, _ = self._norms(acc[:nr], acc[nr:], False)
            scale = torch.clamp(clip / torch.clamp(total, min=1e-12),
                                max=1.0)
            acc = [g * scale for g in acc]
        leaves = [self.params[mod][k] for mod, k in self._keys]
        old = [t.float().clone() for t in leaves] if with_health else None
        grads = {}
        for (mod, k), g in zip(self._keys, acc):
            grads.setdefault(mod, {})[k] = g
        _, self.opt_state = optim.update(grads, self.params, self.opt_state)
        if not with_health:
            return None
        return self._health(acc[:nr], acc[nr:], leaves[:nr], leaves[nr:],
                            old, False)

    def _health(self, g_r, g_b, new_r, new_b, old, sharded):
        """The reference's ``scoped_health``."""
        gn, nf = self._norms(g_r, g_b, sharded)
        pn, _ = self._norms(new_r, new_b, sharded)
        nr = len(new_r)
        d = [n.float() - o for n, o in zip(new_r + new_b, old)]
        un, _ = self._norms(d[:nr], d[nr:], sharded)
        return {"grad_norm": gn, "param_norm": pn, "update_norm": un,
                "update_ratio": un / torch.clamp(pn, min=1e-12),
                "nonfinite_grads": nf}

    def _emit(self, n_tok, loss, health):
        """The step record (one host copy of the loss and the health
        scalars)."""
        rec = self.recorder
        names = ["loss"] + list(health or {})
        vals = [loss] + list((health or {}).values())
        host = torch.stack([v.detach().reshape(()).float()
                            for v in vals]).tolist()
        for k, v in zip(names, host):
            rec.scalar(k, v)
        wire = rec.gauge_value("collective/wire_bytes_per_step")
        if wire:
            rec.inc("collective/wire_bytes_total", wire)
        rec.inc("tokens_total", n_tok)
        rec.scalar("records", n_tok)
        record = rec.end_step(self._step_count - 1)
        if self._health_monitor is not None:
            self._health_monitor.check_record(record)

    def merge(self):
        """The model's flat parameters (``{module: {key: tensor}}``, the
        reference's names): every stage's blocks gathered over pp (and
        their tp/ep shards over those axes).  A collective: every rank of
        the mesh calls it."""
        out = {mod: dict(sub) for mod, sub in self._rest.items()}
        pp = self._group(("pp",))
        per = len(self._my_blocks)
        with torch.no_grad():
            for j, blk in enumerate(self._my_blocks):
                for mod in sorted(self._blocks):
                    if not (mod == blk.name or mod.startswith(blk.name + ".")):
                        continue
                    suffix = mod[len(blk.name):]
                    for k, t in self._blocks[mod].items():
                        for d, e in enumerate(self._specs[mod][k]):
                            names = _entry_axes(e)
                            if names:
                                g, n, _ = self._group(names)
                                t = tp_ops.all_gather_dim(t, g, n, d)
                        parts = [t]
                        if pp[0] is not None:
                            parts = [torch.empty_like(t)
                                     for _ in range(pp[1])]
                            dist.all_gather(parts, t.contiguous(),
                                            group=pp[0])
                        for s, part in enumerate(parts):
                            name = self._block_names[s * per + j] + suffix
                            out.setdefault(name, {})[k] = part
        return out
