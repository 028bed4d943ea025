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
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from ..observability.collectives import reset_step
from ..parallel import mesh as mesh_lib
from ..parallel.allreduce import (allgather_params, allreduce_gradients,
                                  mean_leaf, reduce_scatter_gradients,
                                  shardable_mask_dim0, tree_map)
from ..parallel.bucketer import GradBucketer
from ..parallel.zero import Zero1Layout, Zero1Optim
from .optimizer import Optimizer, _identity, make_train_step

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
            optim = Zero1Optim(self._clip(optim, self.mesh.group), self._z1,
                               self.mesh, self.recorder)
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

    def _banner_suffix(self):
        return (f", dp={self.n_dp}"
                + (", fsdp" if self.fsdp else "")
                + (", zero1" if self.zero1 else "")
                + (f", buckets={self.bucket_bytes}" if self.bucket_bytes
                   else "")
                + (f", compress={self.compress}" if self.compress else "")
                + (", fused" if self.fused_optim else ""))
