"""One declarative template for composed dp×fsdp×tp×sp training (≙
``bigdl_tpu/parallel/compose.py``).

A :class:`ComposedConfig` names the mesh template (``"dp2,fsdp2,tp2"``)
and the knobs, and :func:`build_trainer` builds the engine:

  * a ``pp`` axis larger than 1 -> :class:`~bigdl_tpu_torch.parallel.
    pipeline.PipelineLMTrainer` (the GPipe schedule over point-to-point
    sends; dp, tp, sp and ep inside a stage), where zero1, the dp bucket
    streams, the 16-bit wire, the fused update, the overlapped gradient
    chunks and clipping are its own; ``fsdp`` and ``grad_accum`` are
    refused, as the reference refuses them;
  * otherwise :class:`~bigdl_tpu_torch.parallel.spmd.SpmdTrainer`
    (dp/fsdp/tp/sp/ep), where zero1 is a layout of the optimizer state.  The
    pipeline engine's manual-collective and update knobs (``bucket_bytes``,
    ``compress``, ``fused_optim``, ``clip_norm``, ``overlap_grad_chunks``,
    ``n_microbatches``) are rejected, as the reference rejects them,
    rather than ignored.  The optimizer's own ``fused=True`` picks the
    fused kernel of the update (K4 for Adam/AdamW, K5/K6 for SGD), which
    runs on each rank's local shards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import torch.distributed as dist

from .._device import DeviceLike
from . import mesh as mesh_lib


@dataclass
class ComposedConfig:
    """Declarative composed-parallelism configuration; ``template`` is the
    mesh (``{axis: size}`` or a template string)."""
    template: Union[str, Dict[str, int]]
    zero1: bool = False
    bucket_bytes: Optional[int] = None
    compress: Optional[str] = None
    fused_optim: bool = False
    overlap_grad_chunks: int = 1
    n_microbatches: int = 4
    loss_chunk: Optional[int] = None
    grad_accum: int = 1
    min_fsdp_size: int = 2 ** 16
    zero1_min_size: Optional[int] = None
    clip_norm: Optional[float] = None
    seed: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    def axes(self) -> Dict[str, int]:
        return mesh_lib.parse_template(self.template)


def build_trainer(model, optim, config: ComposedConfig, devices=None, *,
                  device: DeviceLike = None):
    """The (un-``init()``-ed) trainer of a composed config, over the
    started process group (:func:`~bigdl_tpu_torch.parallel.mesh.
    init_distributed`; a template whose every axis is 1 needs none and
    trains on one device).  Raises on a knob the engine would not
    honour."""
    axes = config.axes()
    mesh = axes         # one device when every axis is 1, else raises
    if dist.is_initialized():
        mesh = mesh_lib.create_mesh(axes, devices, device=device)
    if axes.get("pp", 1) > 1:
        from .pipeline import PipelineLMTrainer
        if axes.get("fsdp", 1) > 1:
            raise ValueError(
                "fsdp does not compose with the pipeline engine (stage "
                "params are layer-stacked; use zero1 for the sharded "
                "update, or drop pp and let SpmdTrainer layer fsdp)")
        if config.grad_accum > 1:
            raise ValueError(
                "grad_accum is the GSPMD engine's microbatching; the "
                "pipeline engine accumulates via n_microbatches (and "
                "overlap_grad_chunks) — silently dropping it would "
                "shrink the effective batch")
        return PipelineLMTrainer(
            model, optim, mesh, n_microbatches=config.n_microbatches,
            seed=config.seed, loss_chunk=config.loss_chunk,
            zero1=config.zero1, bucket_bytes=config.bucket_bytes,
            compress=config.compress, fused_optim=config.fused_optim,
            overlap_grad_chunks=config.overlap_grad_chunks,
            clip_norm=config.clip_norm, device=device, **config.extra)
    for knob in ("bucket_bytes", "compress", "fused_optim", "clip_norm"):
        if getattr(config, knob):
            raise ValueError(
                f"{knob} is a manual-collective/update knob of the pipeline "
                "engine: SpmdTrainer's collectives and update are its own, "
                "as the reference's GSPMD engine's are compiler-owned (set "
                "pp>1 for the pipeline engine, or drop the knob; the "
                "optimizer's fused=True picks the fused update)")
    if config.overlap_grad_chunks > 1:
        raise ValueError(
            "overlap_grad_chunks schedules the GPipe bubble; it needs a pp "
            "axis > 1")
    if config.n_microbatches != ComposedConfig.n_microbatches:
        raise ValueError(
            "n_microbatches is the pipeline engine's schedule knob; the "
            "SPMD engine microbatches via grad_accum — silently dropping "
            "it would change the schedule you asked for")
    from .spmd import SpmdTrainer
    return SpmdTrainer(
        model, optim, mesh=mesh, fsdp=axes.get("fsdp", 1) > 1,
        seed=config.seed, min_fsdp_size=config.min_fsdp_size,
        grad_accum=config.grad_accum, loss_chunk=config.loss_chunk,
        zero1=config.zero1, zero1_min_size=config.zero1_min_size,
        device=device, **config.extra)
