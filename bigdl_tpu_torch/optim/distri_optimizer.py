"""Synchronous data-parallel SGD (≙ ``bigdl_tpu/optim/distri_optimizer.py``,
BigDL's ``DistriOptimizer`` over ``AllReduceParameter``).

Each rank of the mesh's process group holds a replica, takes its block
of every global batch (rank r the rows ``[r·b/n, (r+1)·b/n)``; every rank
draws the same shuffled order), runs the forward and backward on it, and
the ranks exchange explicit ``torch.distributed`` collectives
(``parallel.allreduce``):

  * dp (default): the gradients are all-reduced to their mean (one
    collective a leaf, or one a flat bucket with ``bucket_bytes``,
    ``parallel.bucketer``), and every rank applies the same update;
  * fsdp: parameters and optimizer state are sharded on dim 0 where it
    divides n; the step all-gathers the parameters, reduce-scatters the
    gradients and updates the shards;
  * zero1: parameters stay replicated; the gradients are
    reduce-scattered into the shard space of ``parallel.zero``, each rank
    updates its 1/n with its 1/n of the optimizer state, and the updated
    parameters are all-gathered in place.

``compress="fp16"|"bf16"`` sends the 1/n-scaled gradients in 16 bits.
The loss and the batch-norm running statistics are averaged over dp
(the reference's ``lax.pmean``).  ``fused_optim=True`` runs the update
on a shallow copy of the method with ``fused=True``: K5/K6 for SGD, K4
for Adam(W), on the shard buffers under zero1 and fsdp.  The host loop
(triggers, validation, prefetch, mixed precision) is ``Optimizer``'s.

Gradient accumulation runs on each rank over its own block before the
exchange (one exchange a step, whatever ``n_accum`` is).  Clipping by
norm takes the global norm: the replicated gradients' under dp, the
shards' squares summed over the ranks plus the replicated leaves' once
under fsdp, every shard-space leaf's summed over the ranks under zero1.
A device augmentation runs on each rank's own rows, drawing from a
generator of the rank's own (``seed + 13 + 1000003 · rank``).

Checkpoints (``set_checkpoint``) under every layout: each rank is one
writer of the checkpoint (``CheckpointManager(process_index=rank,
process_count=n)``), writes the shards it owns and a part-manifest, and
rank 0 merges the parts into the one commit.  Under dp rank 0 writes the
whole leaves; under fsdp each rank writes its fragments of the parameters
and the optimizer state (dim-0 row blocks of the sharded leaves, rank 0
the replicated ones), and under zero1 of the optimizer state, its flat
shard space mapped back to each leaf's global index ranges
(``checkpoint.reshard``).  Each rank writes its generator's state
(``loop_rng/<rank>``).  A restore assembles the global trees whatever
layout and world size wrote them and cuts this rank's part out of them;
on the same layout and world each generator resumes from its state, on
another each reseeds by the formula above.  With ``handle_preemption``
at world > 1 the ranks agree on the stop (an all-reduce of the flag each
step), so that every rank commits at the same iteration.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

import numpy as np

from ..observability.collectives import reset_step
from ..parallel import mesh as mesh_lib
from ..parallel.allreduce import (allgather_params, allreduce_gradients,
                                  mean_leaf, reduce_scatter_gradients,
                                  shardable_mask_dim0, tree_leaves, tree_map,
                                  tree_unflatten)
from ..parallel.bucketer import GradBucketer
from ..parallel.zero import Zero1Layout, Zero1Optim
from .optimizer import (Optimizer, _HealthProbe, _host_tree, _identity,
                        make_train_step)

# per-tensor-norm methods: a dim-0 shard's norm is not the tensor's
_PER_TENSOR_NORM = ("LARS", "LAMB")


class DistriOptimizer(Optimizer):
    """``DistriOptimizer(model, training_set, criterion, batch_size,
    mesh=None, compress=None, fsdp=False, seed=0, zero1=False,
    bucket_bytes=None, fused_optim=False)``: ``batch_size`` is the global
    batch; ``mesh`` defaults to ``parallel.mesh.get_mesh()`` (a process
    group must be started, :func:`~bigdl_tpu_torch.parallel.mesh
    .init_distributed`), and the optimizer's device is the mesh's."""

    def __init__(self, model, training_set, criterion, batch_size=None,
                 mesh: Optional[mesh_lib.Mesh] = None,
                 compress: Optional[str] = None, fsdp: bool = False,
                 seed: int = 0, zero1: bool = False,
                 bucket_bytes: Optional[int] = None,
                 fused_optim: bool = False):
        mesh = mesh or mesh_lib.get_mesh()
        if "dp" not in mesh.axis_names:
            raise ValueError("DistriOptimizer mesh needs a 'dp' axis")
        if zero1 and fsdp:
            raise ValueError(
                "zero1 and fsdp are mutually exclusive: fsdp already "
                "shards params AND optimizer state (ZeRO-3); zero1 "
                "shards only the update/optimizer state")
        if compress not in (None, "fp16", "float16", "bf16", "bfloat16"):
            raise ValueError(f"unknown compress {compress!r}")
        super().__init__(model, training_set, criterion,
                         batch_size=batch_size, seed=seed,
                         device=mesh.device)
        self.mesh = mesh
        self.n_dp = mesh.shape["dp"]
        self.compress = compress
        self.fsdp = bool(fsdp)
        self.zero1 = bool(zero1)
        self.bucket_bytes = bucket_bytes
        self.fused_optim = bool(fused_optim)
        self._z1: Optional[Zero1Layout] = None
        self._z1_optim: Optional[Zero1Optim] = None
        self._shardable = None
        self._bucketer: Optional[GradBucketer] = None

    # -- the update ------------------------------------------------------ #
    def _wrap_optim(self, params):
        optim = self.optim_method
        if self.fused_optim:
            if not hasattr(optim, "fused"):
                raise ValueError(
                    f"fused_optim=True: {type(optim).__name__} has no "
                    "fused kernel (supported: SGD, Adam, AdamW)")
            # a shallow copy: the user's instance keeps its own setting
            optim = copy.copy(optim)
            optim.fused = True
        if self.zero1 and type(optim).__name__ in _PER_TENSOR_NORM:
            raise ValueError(
                f"zero1 cannot shard {type(optim).__name__}: its "
                "per-TENSOR trust ratios need whole-tensor norms, and a "
                "dim-0 shard's norm is not the tensor's norm.  Use fsdp "
                "(whole tensors stay visible to the update) or an "
                "elementwise optimizer (SGD/Adam/AdamW)")
        if self.zero1:
            self._z1 = Zero1Layout(params, self.n_dp,
                                   bucket_bytes=self.bucket_bytes)
            # every shard-space leaf is 1/n of a global tensor
            optim = self._z1_optim = Zero1Optim(
                self._clip(optim, self.mesh.group), self._z1, self.mesh,
                self.recorder)
        elif self.fsdp:
            self._shardable = shardable_mask_dim0(params, self.n_dp)
            optim = self._clip(optim, self.mesh.group, self._shardable)
        else:
            if self.bucket_bytes:
                self._bucketer = GradBucketer(params, self.bucket_bytes)
            optim = self._clip(optim)      # replicated after the exchange
        return optim

    def _generator(self):
        return torch.Generator(device=self.device).manual_seed(
            self.seed + 13 + 1000003 * self.mesh.rank)

    def _health_probe(self):
        if self.zero1:
            # the update writes zero1's shard masters: every shard-space
            # leaf is 1/n of a global tensor
            return _HealthProbe(lambda params: self._z1_optim.params,
                                group=self.mesh.group)
        if self.fsdp:
            return _HealthProbe(group=self.mesh.group,
                                sharded_mask=self._shardable)
        return _HealthProbe()       # replicated after the all-reduce

    def _layout_params(self, params):
        if not self.fsdp:
            return params
        r, n = self.mesh.rank, self.n_dp
        return tree_map(
            lambda p, s: p.detach()[r * (p.shape[0] // n):
                                    (r + 1) * (p.shape[0] // n)].clone()
            if s else p, params, self._shardable)

    def _pmean(self, tree):
        """Mean over dp of every floating leaf (fresh tensors: the
        all-reduce writes them in place)."""
        pg = self.mesh.group
        return tree_map(lambda t: mean_leaf(t, self.n_dp, pg)
                        if torch.is_floating_point(t) else t, tree)

    def _build_step(self, optim):
        """``make_train_step`` with this optimizer's exchange: the step
        zeroes the per-step collective gauges first."""
        mesh, rec, compress = self.mesh, self.recorder, self.compress
        gather = _identity
        if self.zero1:
            # Zero1Optim.update all-gathers the updated shards in place
            def exchange(grads):
                return self._z1.scatter_grads(grads, mesh, compress=compress,
                                              recorder=rec)
        elif self.fsdp:
            mask = self._shardable

            def gather(params_sh):
                full = allgather_params(params_sh, mesh, mask=mask,
                                        recorder=rec)
                return tree_map(lambda t: t if t.requires_grad
                                else t.requires_grad_(), full)

            def exchange(grads):
                return reduce_scatter_gradients(grads, mesh, mask=mask,
                                                recorder=rec)
        elif self._bucketer is not None:
            def exchange(grads):
                return self._bucketer.allreduce(grads, mesh,
                                                compress=compress,
                                                recorder=rec)
        else:
            def exchange(grads):
                return allreduce_gradients(grads, mesh, compress=compress,
                                           recorder=rec)
        core = make_train_step(self.model, self.criterion, optim,
                               self.mixed_precision, gather=gather,
                               exchange=exchange, pmean=self._pmean,
                               **self._step_options())

        def step(params, opt_state, model_state, x, y):
            reset_step(rec)
            return core(params, opt_state, model_state, x, y)
        return step

    # -- the loop's hooks ------------------------------------------------ #
    def _host_batch(self, x, y):
        return (mesh_lib.shard_batch(self.mesh, x),
                mesh_lib.shard_batch(self.mesh, y))

    def _params_for_eval(self, params):
        if not self.fsdp:
            return params
        with torch.no_grad():
            return allgather_params(params, self.mesh, mask=self._shardable)

    # -- checkpoints under every layout ---------------------------------- #
    def _make_ckpt_manager(self, path, layout, async_write, keep_last,
                           keep_every_epochs):
        from ..checkpoint import CheckpointManager
        return CheckpointManager(path, layout=layout,
                                 async_write=async_write,
                                 keep_last=keep_last,
                                 keep_every_epochs=keep_every_epochs,
                                 recorder_fn=self._rec,
                                 process_index=self.mesh.rank,
                                 process_count=self.n_dp)

    def _layout_meta(self):
        from ..checkpoint import reshard
        return ("fsdp" if self.fsdp else "zero1" if self.zero1 else "dp",
                reshard.mesh_info(self.mesh))

    def _rank(self) -> int:
        return self.mesh.rank

    def _rows(self, full_shape):
        """This rank's dim-0 bounds of a leaf of ``full_shape``."""
        rows = full_shape[0] // self.n_dp
        r = self.mesh.rank
        return [[r * rows, (r + 1) * rows]] + [[0, d]
                                               for d in full_shape[1:]]

    def _fsdp_pieces(self, host, full):
        """Host shards (fsdp's layout) as fragments of the global leaves:
        row blocks of the sharded leaves, the replicated ones whole."""
        from ..checkpoint.reshard import Pieces
        return tree_map(
            lambda h, f, m: Pieces(f.shape, h.dtype,
                                   [(self._rows(tuple(f.shape)), h)])
            if m else h, host, full, self._shardable)

    def _z1_pieces(self, space):
        """A host shard space (zero1's) as fragments of the global,
        parameter-shaped leaves: dim-0 row blocks, and for a leaf packed
        into a flat bucket the range of its flattened elements that falls
        in this rank's chunk."""
        from ..checkpoint.reshard import Pieces
        z, r = self._z1, self.mesh.rank
        out = [None] * z.n_leaves
        for k, i in enumerate(z.sharded_idx):
            blk = space["leaves"][f"{k:05d}"]
            out[i] = Pieces(z.shapes[i], blk.dtype,
                            [(self._rows(z.shapes[i]), blk)])
        for bi, (_, idxs, sizes, _) in enumerate(z.buckets):
            chunk = space["flat"][f"{bi:05d}"]
            lo, hi = r * len(chunk), (r + 1) * len(chunk)
            off = 0
            for i, sz in zip(idxs, sizes):
                s, e = max(lo, off), min(hi, off + sz)
                pieces = [([[s - off, e - off]], chunk[s - lo:e - lo])] \
                    if s < e else []
                out[i] = Pieces([sz], chunk.dtype, pieces,
                                reshape=z.shapes[i])
                off += sz
        return tree_unflatten(z.template, out)

    def _ckpt_payload(self, params, opt_state, model_state):
        """Every rank names every shard of the checkpoint (so that file
        names agree) and fills the ones it owns: dp rank 0 the whole
        trees; fsdp each rank ``params@<r>`` and ``opt_state@<r>``, zero1
        ``opt_state@<r>`` (fragments); rank 0 ``model_state`` and the
        replicated parameters; each rank ``loop_rng/<r>``."""
        from ..checkpoint import host_snapshot, reshard
        n, r = self.n_dp, self.mesh.rank
        full = self.model.param_dict()
        sharded = self.fsdp or self.zero1
        names = [f"loop_rng/{k}" for k in range(n)] + ["model_state"]
        if self.fsdp:
            names += [f"params@{k}" for k in range(n)]
        else:
            names += [f"params/{mod}" for mod in full]
        names += [f"opt_state@{k}" for k in range(n)] if sharded \
            else ["opt_state"]
        payload = dict.fromkeys(names)
        payload[f"loop_rng/{r}"] = self._gen_state()
        if sharded:
            opt_h = host_snapshot(opt_state)
            frag = {k: (self._z1_pieces(v) if self.zero1 else
                        self._fsdp_pieces(v, full)) if isinstance(v, dict)
                    else v for k, v in opt_h.items()}
            payload[f"opt_state@{r}"] = dict(
                reshard.split_fragments(frag, r), of="opt_state")
        if self.fsdp:
            payload[f"params@{r}"] = dict(reshard.split_fragments(
                self._fsdp_pieces(host_snapshot(params), full), r),
                of="params")
        if r == 0:
            payload["model_state"] = host_snapshot(model_state)
            if not self.fsdp:
                for mod, sub in host_snapshot(params).items():
                    payload[f"params/{mod}"] = sub
            if not sharded:
                payload["opt_state"] = host_snapshot(opt_state)
        return payload, {k for k, v in payload.items() if v is not None}

    def _load_params(self, params, params_g):
        """The global parameters into this rank's: whole leaves in place,
        fsdp's shards their row blocks."""
        r = self.mesh.rank
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), tree_leaves(params_g)):
                src = np.asarray(src)
                if tuple(dst.shape) != src.shape:
                    rows = dst.shape[0]
                    src = src[r * rows:(r + 1) * rows]
                dst.copy_(torch.as_tensor(src))

    def _after_params_restored(self, params):
        if self.zero1:
            self._z1_optim.params = self._z1.local_shard(params,
                                                         self.mesh.rank)

    def _opt_from_global(self, opt_g, opt_state):
        r, dev = self.mesh.rank, self.device
        if self.zero1:
            return {k: self._z1.local_shard(_host_tree(opt_g[k], dev), r)
                    if isinstance(v, dict) else
                    torch.as_tensor(np.array(opt_g[k])).to(dev, v.dtype)
                    for k, v in opt_state.items()}

        def cut(cur, src):
            src = np.array(src)
            if tuple(cur.shape) != src.shape:       # fsdp's row block
                rows = cur.shape[0]
                src = src[r * rows:(r + 1) * rows]
            return torch.as_tensor(src).to(cur.device, cur.dtype)
        return tree_map(cut, opt_state, opt_g)

    def load_checkpoint(self):
        if self.n_dp > 1 and self._ckpt_mgr is not None:
            # every rank's part is written and rank 0 has committed (its
            # writer waits for the parts) before any rank scans
            import torch.distributed as dist
            self._ckpt_mgr.wait()
            dist.barrier(group=self.mesh.group)
        return super().load_checkpoint()

    def _preempt_requested(self) -> bool:
        if self._preemption is None or self.n_dp == 1:
            return super()._preempt_requested()
        import torch.distributed as dist
        flag = torch.tensor([float(self._preemption.requested)],
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(flag.item())

    def _banner_suffix(self):
        return (f", dp={self.n_dp}"
                + (", fsdp" if self.fsdp else "")
                + (", zero1" if self.zero1 else "")
                + (f", buckets={self.bucket_bytes}" if self.bucket_bytes
                   else "")
                + (f", compress={self.compress}" if self.compress else "")
                + (", fused" if self.fused_optim else ""))
