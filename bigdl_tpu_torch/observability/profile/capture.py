"""Step cost capture (≙ ``bigdl_tpu/observability/profile/capture.py``).

The reference harvests XLA's compile-time ``cost_analysis()`` and
``memory_analysis()`` from a compiled step.  The port has no compiled
program to ask, so it counts one step's work as it runs:

  * :func:`capture_step` — one forward and backward of the step's loss
    under ``torch.utils.flop_counter.FlopCounterMode`` (FLOPs of every
    matmul, convolution and attention op), a dispatch mode summing the
    bytes each op reads and writes, and the device's peak memory over the
    pass.  The hand attention kernels (K1 forward, K2 and K3 backward)
    launch through ctypes inside an autograd function, where the counter
    cannot see them: during the capture every attention module's
    ``attention_fn`` seam is bound to a stand-in that adds their work by
    formula (:func:`attention_work`) and computes nothing, so the pass
    launches no hand kernel.  Missing pieces land in an ``unavailable``
    list instead of raising.
  * :class:`StepCostModel` — the captured cost + a
    :class:`~bigdl_tpu_torch.observability.profile.specs.DeviceSpec`;
    ``scalars(dur)`` derives the per-step ratios (``perf/mfu``,
    ``perf/hbm_bw_util``, ``mem/peak_hbm_bytes``) that the Recorder folds
    into every step record.
  * :func:`attach_cost` — wires a cost dict into a recorder: the cost
    model, the gauges, one out-of-band ``profile`` record.
  * :func:`install_device_memory_poller` — live ``mem/device.*`` gauges
    from ``torch.cuda.memory_stats`` / ``mem_get_info``, refreshed on
    every Recorder snapshot (every /metrics scrape) and step record.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..goodput import ledger_phase
from .specs import DeviceSpec, device_spec


def capture_enabled() -> bool:
    """``BIGDL_PROFILE_CAPTURE=0`` turns the step cost capture (and the
    memory poller the trainers install with it) off."""
    return os.environ.get("BIGDL_PROFILE_CAPTURE", "1").lower() \
        not in ("0", "false", "off")


def _finite(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


# -- the attention kernels' work, by formula ------------------------------ #
def attention_work(q, k, v, backward: bool = False) -> Dict[str, float]:
    """FLOPs and bytes of one attention call on ``(B, H, S, D)`` operands,
    as its plain version's matmuls count them: forward ``q kᵀ`` and
    ``p v`` (4·B·H·Sq·Sk·D), backward ``dv``, ``dp``, ``dq`` and ``dk``
    (8·B·H·Sq·Sk·D).  A causal mask is counted in full, as PaLM's MFU
    counts attention.  Bytes: each operand read once and each result
    written once (forward q, k, v → out and the fp32 log-sum-exp;
    backward q, k, v, out, dout and the log-sum-exp → dq, dk, dv)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mm = 2.0 * b * h * sq * sk * d
    lse = 4.0 * b * h * sq
    qb, kb, vb = (t.numel() * t.element_size() for t in (q, k, v))
    if backward:
        return {"flops": 4 * mm, "bytes": 2 * (qb + kb + vb) + 2 * qb + lse}
    return {"flops": 2 * mm, "bytes": qb + kb + vb + qb + lse}


class _Work:
    """Accumulates the attention stand-in's formula work."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.calls = 0

    def add(self, w):
        self.flops += w["flops"]
        self.bytes += w["bytes"]


class _CountedAttention(torch.autograd.Function):
    """Attention's shape and graph without its arithmetic: the output is
    zeros of ``q``'s shape, its gradients zeros; forward and backward
    each add the work of the call they stand for."""

    @staticmethod
    def forward(ctx, q, k, v, work):
        ctx.work = work
        ctx.save_for_backward(q, k, v)
        work.add(attention_work(q, k, v))
        work.calls += 1
        return torch.zeros_like(q)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        ctx.work.add(attention_work(q, k, v, backward=True))
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v), None)


@contextlib.contextmanager
def counting_attention(model, work: _Work):
    """Bind the counting stand-in to every module of ``model`` with an
    ``attention_fn`` seam (a TransformerLM's attention), restoring each
    module's own hook after."""
    mods = [] if model is None else [
        m for m in model.modules() if hasattr(m, "attention_fn")]
    saved = [m.attention_fn for m in mods]

    def standin(q, k, v):
        return _CountedAttention.apply(q, k, v, work)
    try:
        for m in mods:
            m.attention_fn = standin
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.attention_fn = fn


class _BytesMode(TorchDispatchMode):
    """Sums the bytes each op reads and writes (its tensor arguments and
    results; views move nothing): the counterpart of XLA's "bytes
    accessed".  On a CUDA ``device`` it also keeps the most memory
    allocated after any op (its inputs and results live at once), read
    without touching the device's peak statistic."""

    def __init__(self, device=None):
        super().__init__()
        self.bytes = 0.0
        self.device = device
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        if self.device is not None:
            # the nested statistics: torch.cuda.memory_allocated flattens
            # them into a new dict every call (~0.4 ms an op on an H100
            # host, against ~25 us)
            stats = torch.cuda.memory_stats_as_nested_dict(self.device)
            self.peak = max(self.peak,
                            stats["allocated_bytes"]["all"]["current"])
        return out


def capture_step(run, model=None, device=None) -> Dict[str, Any]:
    """Count the work of ``run()`` (one forward and backward of a step's
    loss; it must not update anything): ``flops`` (the FLOP counter's
    total plus the attention stand-in's), ``bytes_accessed``,
    ``attention_flops`` and ``attention_calls``, and on a CUDA device
    ``peak_hbm_bytes``, the pass's peak of allocated memory: the
    device's peak statistic where the pass raised it, else the most
    allocated after any of its ops (the statistic is read, never reset,
    so that a caller's own peak tracking stands).  What cannot be had
    lands in ``unavailable``."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"
    work = _Work()
    out: Dict[str, Any] = {}
    unavailable = []
    if cuda:
        torch.cuda.synchronize(dev)
        peak0 = torch.cuda.max_memory_allocated(dev)
    with counting_attention(model, work), \
            FlopCounterMode(display=False) as fc, \
            _BytesMode(dev if cuda else None) as bm:
        run()
    flops = _finite(fc.get_total_flops())
    if flops is None:
        unavailable.append("cost_analysis")
    else:
        out["flops"] = flops + work.flops
        out["bytes_accessed"] = bm.bytes + work.bytes
        out["attention_flops"] = work.flops
        out["attention_calls"] = work.calls
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        out["peak_hbm_bytes"] = float(peak if peak > peak0 else bm.peak)
    else:
        unavailable.append("memory_analysis")
    if unavailable:
        out["unavailable"] = unavailable
    return out


class StepCostModel:
    """Captured per-step cost + device peaks -> derived per-step ratios.

    ``scalars(dur)`` is called by ``Recorder.end_step`` with the step's
    wall duration and stays pure arithmetic (it runs under the recorder's
    lock).  Every ratio whose numerator or denominator is unknown is
    replaced by an explicit ``*_unavailable`` marker scalar."""

    __slots__ = ("cost", "spec")

    def __init__(self, cost: Dict[str, Any], spec: Optional[DeviceSpec]
                 = None):
        self.cost = dict(cost or {})
        self.spec = spec if spec is not None else DeviceSpec("unknown")

    def scalars(self, dur: Optional[float]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        flops = self.cost.get("flops")
        if flops is not None and dur and self.spec.peak_flops:
            out["perf/mfu"] = flops / dur / self.spec.peak_flops
        elif flops is not None and dur:
            # the FLOPs are known but not this device's peak: the achieved
            # rate keeps the number actionable
            out["perf/flops_per_sec"] = flops / dur
            out["perf/mfu_unavailable"] = 1.0
        else:
            out["perf/mfu_unavailable"] = 1.0
        ba = self.cost.get("bytes_accessed")
        if ba is not None and dur and self.spec.peak_hbm_bw:
            out["perf/hbm_bw_util"] = ba / dur / self.spec.peak_hbm_bw
        else:
            out["perf/hbm_bw_util_unavailable"] = 1.0
        peak = self.cost.get("peak_hbm_bytes")
        if peak is not None:
            out["mem/peak_hbm_bytes"] = peak
            if self.spec.hbm_capacity:
                out["mem/peak_hbm_frac"] = peak / self.spec.hbm_capacity
        else:
            out["mem/peak_hbm_bytes_unavailable"] = 1.0
        return out


def attach_cost(recorder, cost: Dict[str, Any],
                kind: str = "train_step", spec: Optional[DeviceSpec]
                = None, **fields) -> StepCostModel:
    """Wire a captured cost dict into ``recorder``: attach a
    :class:`StepCostModel` (per-step ``perf/mfu`` and the rest), set the
    ``mem/peak_hbm_bytes`` and ``profile/flops_per_step`` gauges /metrics
    renders, and emit one out-of-band ``profile`` record."""
    if spec is None:
        spec = device_spec()
    model = StepCostModel(cost, spec)
    recorder.set_cost_model(model)
    peak = cost.get("peak_hbm_bytes")
    if isinstance(peak, (int, float)):
        recorder.gauge("mem/peak_hbm_bytes", peak)
    flops = cost.get("flops")
    if isinstance(flops, (int, float)):
        recorder.gauge("profile/flops_per_step", flops)
    recorder.emit_record("profile", kind=kind, device=spec.name,
                         peak_flops=spec.peak_flops,
                         peak_hbm_bw=spec.peak_hbm_bw,
                         hbm_capacity=spec.hbm_capacity, cost=cost,
                         **fields)
    return model


def capture_and_attach(recorder, run, model=None, device=None,
                       kind: str = "train_step", **fields) -> StepCostModel:
    """:func:`capture_step`, then :func:`attach_cost`, with the pass's
    seconds as the record's ``capture_s`` and the
    ``profile/capture_seconds`` gauge.  The trainers run it before the
    step's record opens, so no step's ``dur`` holds it; the goodput
    ledger books its time as ``compile_warmup``.  Never raises: a failed
    capture yields a record whose cost says so."""
    t0 = time.perf_counter()
    try:
        with ledger_phase(recorder, "compile_warmup"):
            cost = capture_step(run, model, device)
    except Exception as e:
        cost = {"unavailable": ["capture_failed"], "error": repr(e)}
    secs = time.perf_counter() - t0
    recorder.gauge("profile/capture_seconds", secs)
    spec = device_spec(device) if device is not None else None
    return attach_cost(recorder, cost, kind=kind, spec=spec,
                       capture_s=secs, **fields)


# -- live device-memory gauges --------------------------------------------- #
def poll_device_memory(recorder):
    """One poll: ``mem/device.<i>.{bytes_in_use,peak_bytes_in_use,
    bytes_limit}`` gauges per visible CUDA device, or a single
    ``mem/device.stats_unavailable`` marker without one."""
    got_any = False
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:
        n = 0
    for i in range(n):
        try:
            if not torch.cuda.is_initialized():
                break               # polling must not start a CUDA context
            stats = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
        except Exception:
            continue
        got_any = True
        vals = {"bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": total}
        for key, v in vals.items():
            v = _finite(v)
            if v is not None:
                recorder.gauge(f"mem/device.{i}.{key}", v)
    if not got_any:
        recorder.gauge("mem/device.stats_unavailable", 1.0)


def install_device_memory_poller(recorder):
    """Attach :func:`poll_device_memory` as a recorder gauge poller
    (idempotent: repeated ``set_telemetry`` calls install it once)."""
    if poll_device_memory not in getattr(recorder, "_gauge_pollers", ()):
        recorder.add_gauge_poller(poll_device_memory)
    return recorder
