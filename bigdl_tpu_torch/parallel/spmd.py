"""SpmdTrainer on one device (≙ ``bigdl_tpu/parallel/spmd.py``).

The reference compiles one (forward + backward + update) XLA program over
a device mesh.  The port runs the same step eagerly on one device:

    loss = model.loss(params, tokens, targets, loss_chunk=, ctx=)
    grads = autograd.grad(loss, params)               (make_accum_grads)
    grads = mask_frozen_grads(model, grads)
    params, opt_state = optim.update(grads, params, opt_state)

On the card the step runs the flash-attention kernels (K1 forward, K2/K3
backward) and, with ``fused=True``, the fused Adam kernel (K4).  The
update writes parameters and moments in place, the counterpart of the
reference's ``donate_argnums=(0, 1)``.  ``step`` returns the loss as a
device tensor and makes no host sync unless telemetry is on (one a step:
the loss and the health scalars in one copy); ``fit`` syncs when it logs,
when it flushes summaries and once at its end.

Each step's random draws (dropout, and the input transform's) come from a
``torch.Generator`` on the device seeded from ``(seed + 1, step)``, as the
reference folds the step into ``PRNGKey(seed + 1)``: a run resumed from a
checkpoint redraws the same masks from the step and seed in its meta.

Parameters are not drawn at :meth:`init`: the reference draws them from
``jax.random``, which torch cannot reproduce, so the trainer takes the
model's current parameters (a ``build(seed=)`` draw, or the reference's
weights loaded with ``models.convert.from_jax_params``).

The loop features are the reference's: ``evaluate`` (token-weighted loss
and perplexity), ``set_input_transform``, ``set_telemetry`` (a step record
a step), ``set_health`` (the sentinels; ``policy="rollback"`` restores the
newest committed checkpoint in ``fit``), ``set_trace_context``,
``straggler_report``, manifest checkpoints through
:mod:`bigdl_tpu_torch.checkpoint` (``save_checkpoint``,
``load_checkpoint``, ``set_checkpoint`` with ``shard_arrays`` and
``handle_preemption``; the files are the reference's, so each package
restores the other's), ``set_train_summary`` / ``set_val_summary`` and a
live weight stream (``set_weight_stream``).

One device only (ROADMAP queue A, item 5): ``mesh`` may be given when
every axis is 1, and then ``fsdp``, ``min_fsdp_size`` and
``ring_attention`` ask for nothing, as in the reference without those
axes; a larger axis raises.  Also not ported: the orbax layout and
``set_data_pipeline`` (item 7), ``serve_metrics`` (item 8) and
``account_collectives`` (items 5 and 8); each raises.
"""
from __future__ import annotations

import itertools
import math
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..nn.module import Ctx
from ..optim.optimizer import (TelemetryHealth, _HealthProbe,
                               make_accum_grads, mask_frozen_grads)
from .allreduce import tree_leaves, tree_paths

# the mesh of one device, as the reference's create_mesh({"dp": 1}) records
# it in a manifest (checkpoint.reshard.mesh_info)
_ONE_DEVICE_MESH = {"axes": [["dp", 1]], "devices": 1, "processes": 1}


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


def _unported(what: str, item: str):
    raise NotImplementedError(f"SpmdTrainer: {what} is not ported yet "
                              f"(ROADMAP queue A, {item})")


class SpmdTrainer(TelemetryHealth):
    """One-device trainer of a TransformerLM with the reference's step and
    loop."""

    def __init__(self, model, optim, mesh=None, fsdp: bool = True,
                 seed: int = 0, ring_attention: Optional[bool] = None,
                 min_fsdp_size: int = 2 ** 16, grad_accum: int = 1,
                 loss_chunk: Optional[int] = None, zero1: bool = False,
                 *, device: DeviceLike = None):
        axes = {} if mesh is None else _mesh_axes(mesh)
        big = {a: n for a, n in axes.items() if n > 1}
        if big:
            raise NotImplementedError(
                f"SpmdTrainer: mesh axes {big} need the device mesh, which "
                f"is not ported yet (ROADMAP queue A, item 5: SPMD "
                f"parallelism); the port trains on one device, so every "
                f"axis must be 1")
        if zero1:
            raise ValueError("zero1 shards the update over the dp axis: "
                             "the mesh needs dp > 1")
        if device is None and getattr(mesh, "device", None) is not None:
            device = mesh.device
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.model = model
        self.optim = optim
        self.mesh = mesh
        self._mesh_info = ({"axes": [[a, n] for a, n in axes.items()],
                            "devices": 1, "processes": 1}
                           if axes else dict(_ONE_DEVICE_MESH))
        self.seed = int(seed)
        # without an fsdp axis (or an sp axis for the ring) fsdp,
        # min_fsdp_size and ring_attention ask for nothing, as in the
        # reference
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
        self._init_telemetry()
        self._ckpt = None               # (path, every_steps, keep)
        self._ckpt_mgr = None
        self._shard_arrays = False
        self._preemption = None
        self._train_summary = None
        self._val_summary = None

    # -- set-up ---------------------------------------------------------- #
    def init(self):
        """Take the model's parameters and build the optimizer state."""
        params = self.model.param_dict()
        bad = sorted({str(p.device) for p in tree_leaves(params)
                      if p.device != self.device})
        if bad:
            raise ValueError(f"SpmdTrainer: the model's parameters are on "
                             f"{bad}, the trainer's device is "
                             f"{self.device}; move the model first")
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
        ``None`` detaches."""
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
        _unported("set_data_pipeline (data/sharded.py's cursor in the "
                  "checkpoint)", "item 7")

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1",
                      watchdog: bool = True):
        _unported("serve_metrics (the live metrics server)", "item 8")

    def account_collectives(self, tokens, targets):
        _unported("account_collectives (the mesh's collectives)",
                  "items 5 and 8")

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
        step_span = None
        if self._trace_ctx is not None:
            step_span = self._trace_spine().begin(
                "train.step", self._trace_ctx, subsystem="train")
        if telemetry:
            rec.start_step(self._step_count)
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
            (loss, _), grads = self._grads_fn(self.params, {}, tokens,
                                              targets)
            grads = mask_frozen_grads(self.model, grads)
            before = None if probe is None else probe.before(self.params)
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

    def _emit_step_record(self, n_tok, loss, health):
        """The step record: the loss and the health scalars come to the
        host in one copy (the step's one sync), then the monitor checks
        the record (a diverged step raises here, before ``fit``'s
        checkpoint trigger can commit it)."""
        rec = self.recorder
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
        (one host sync).  With :meth:`set_val_summary`, writes Loss and
        Perplexity at the current step."""
        if self.params is None:
            self.init()
        if steps is not None:   # islice: never pull an extra batch from a
            batches = itertools.islice(batches, steps)  # shared iterator
        sums, counts = [], []
        with torch.no_grad():
            for tokens, targets in batches:
                s, c = self.model.token_nll(
                    self.params, self._to_device(tokens).int(),
                    self._to_device(targets).int(),
                    loss_chunk=self.loss_chunk, training=False)
                sums.append(s)
                counts.append(c)
        if sums:
            total, count = torch.stack([sum(sums), sum(counts)]).tolist()
        else:
            total = count = 0.0
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
            mgr = CheckpointManager(path, layout="manifest",
                                    async_write=async_write, keep_last=keep,
                                    recorder_fn=self._rec)
            self._ckpt_mgr = mgr
        return mgr

    def save_checkpoint(self, path: str, layout: Optional[str] = None,
                        sync: bool = False, tag: Optional[str] = None):
        """Queue one manifest checkpoint of the parameters (a shard a
        top-level module), the optimizer state and the step counter
        (``meta``: step, seed, root name) through
        :mod:`bigdl_tpu_torch.checkpoint`: only the owning device→host
        copy blocks (``checkpoint.blocking``); serialize, CRC and the
        atomic commit run on the writer thread unless ``sync``.  With
        ``shard_arrays`` (:meth:`set_checkpoint`) each entry is written
        as elastic v2 slice fragments."""
        from ..checkpoint import host_snapshot, reshard
        if layout not in (None, "manifest"):
            _unported(f"layout={layout!r} (the port writes the manifest "
                      "layout; there is no orbax)", "item 7")
        if self.params is None:
            raise ValueError("trainer not initialized; call init() first")
        mgr = self._manifest_manager(path)
        logical = {f"params/{mod}": sub for mod, sub in self.params.items()}
        logical["opt_state"] = self.opt_state
        shards = {}
        with self.recorder.span("checkpoint.blocking"):
            host = host_snapshot(logical)
            for name in sorted(host):
                if self._shard_arrays:
                    frag = reshard.split_fragments(host[name])
                    frag["of"] = name
                    shards[f"{name}@p000"] = frag
                else:
                    shards[name] = host[name]
        meta = {"step": self._step_count, "seed": self.seed,
                "root": self.model.name}
        mgr.save(shards, meta, tag=tag or f"step_{self._step_count}",
                 sync=sync, mesh=dict(self._mesh_info),
                 trace_ctx=None if self._trace_ctx is None
                 else self._trace_ctx.child())

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
        """Check a restored ``{params, opt_state}`` host tree against this
        trainer (after the root rename) and copy it into the live tensors;
        a mismatch raises ``ValueError`` naming the leaf."""
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
        for where, t in zip(want, tree_leaves(template)):
            v = np.asarray(host[where])
            if tuple(v.shape) != tuple(t.shape) or \
                    torch.as_tensor(v).dtype != t.dtype:
                raise ValueError(
                    f"{path}: leaf {where} is {v.shape}/{v.dtype}, the "
                    f"model expects {tuple(t.shape)}/{t.dtype}")
        rec = self.recorder
        resharding = (saved_mesh is not None
                      and not reshard.same_mesh(saved_mesh, self._mesh_info))
        with rec.span("elastic.reshard" if resharding
                      else "checkpoint.restore"), torch.no_grad():
            for where, t in zip(want, tree_leaves(template)):
                t.copy_(torch.as_tensor(np.array(host[where])))
        if resharding:
            print(f"[elastic] restored onto one device: "
                  f"{reshard.describe_delta(saved_mesh, self._mesh_info)}",
                  flush=True)
        self._step_count = int(meta["step"])
        self.seed = int(meta.get("seed", self.seed))
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
        try:
            for i, (tokens, targets) in enumerate(batches):
                if steps is not None and i >= steps:
                    break
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
