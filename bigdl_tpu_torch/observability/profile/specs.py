"""Device peak-spec table (≙ ``bigdl_tpu/observability/profile/specs.py``):
the denominators of every efficiency number.

MFU, HBM-bandwidth utilization and "how close to the memory wall" all
divide a measured quantity by a hardware peak.  The table is resolved from
``torch.cuda.get_device_name`` and overridable per run through
environment variables:

  ``BIGDL_PEAK_FLOPS``            peak dense FLOP/s (the MFU denominator)
  ``BIGDL_PEAK_HBM_BW``           peak HBM bytes/s
  ``BIGDL_HBM_CAPACITY_BYTES``    HBM capacity in bytes

Peaks are per device in the dtype the matrix units run (bf16/fp16 tensor
cores for GPUs).  Unknown devices (the CPU among them) resolve to a spec
with ``None`` peaks: derived ratios are then reported as explicitly
unavailable rather than silently wrong.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class DeviceSpec:
    """Hardware peaks for one device.  ``None`` = unknown: callers must
    degrade to an explicit unavailable marker, never guess."""
    name: str
    peak_flops: Optional[float] = None      # dense FLOP/s (matrix dtype)
    peak_hbm_bw: Optional[float] = None     # bytes/s
    hbm_capacity: Optional[float] = None    # bytes

    def complete(self) -> bool:
        return None not in (self.peak_flops, self.peak_hbm_bw,
                            self.hbm_capacity)


_GIB = 1024.0 ** 3

# substring-matched against a lowercased device name, FIRST match wins
# (order matters: "tpu v5p" must match before "tpu v5").  Sources:
# published TPU/GPU data sheets; per-core numbers for v2/v3.
_TABLE = (
    ("tpu v5p",    DeviceSpec("TPU v5p", 459e12, 2765e9, 95 * _GIB)),
    ("tpu v5 lite", DeviceSpec("TPU v5e", 197e12, 819e9, 16 * _GIB)),
    ("tpu v5e",    DeviceSpec("TPU v5e", 197e12, 819e9, 16 * _GIB)),
    ("tpu v5",     DeviceSpec("TPU v5p", 459e12, 2765e9, 95 * _GIB)),
    ("tpu v4",     DeviceSpec("TPU v4", 275e12, 1228e9, 32 * _GIB)),
    ("tpu v3",     DeviceSpec("TPU v3 core", 61.5e12, 450e9, 16 * _GIB)),
    ("tpu v2",     DeviceSpec("TPU v2 core", 22.5e12, 350e9, 8 * _GIB)),
    ("h100",       DeviceSpec("H100", 989e12, 3352e9, 80 * _GIB)),
    ("a100",       DeviceSpec("A100", 312e12, 2039e9, 80 * _GIB)),
    ("v100",       DeviceSpec("V100", 125e12, 900e9, 16 * _GIB)),
)

_ENV_FIELDS = (("BIGDL_PEAK_FLOPS", "peak_flops"),
               ("BIGDL_PEAK_HBM_BW", "peak_hbm_bw"),
               ("BIGDL_HBM_CAPACITY_BYTES", "hbm_capacity"))


def lookup(device_kind: str) -> DeviceSpec:
    """Table lookup by device name; unknown names get a no-peaks spec
    named after themselves (so reports still say WHAT was measured)."""
    kind = str(device_kind).lower()
    for needle, spec in _TABLE:
        if needle in kind:
            return spec
    return DeviceSpec(str(device_kind))


def _apply_env(spec: DeviceSpec) -> DeviceSpec:
    for var, field_name in _ENV_FIELDS:
        raw = os.environ.get(var)
        if not raw:
            continue
        try:
            spec = replace(spec, **{field_name: float(raw)})
        except ValueError:
            pass        # a malformed override must not kill training
    return spec


def device_kind(device=None) -> str:
    """The name the table is matched against: ``torch.cuda.
    get_device_name`` for a CUDA device (the current one by default),
    ``"cpu"`` for the CPU, ``"unknown"`` when neither answers."""
    import torch
    try:
        dev = torch.device(device) if device is not None else (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))
        if dev.type == "cuda":
            return torch.cuda.get_device_name(dev)
        return dev.type
    except Exception:
        return "unknown"


def device_spec(device=None) -> DeviceSpec:
    """The spec for ``device`` (default: the current CUDA device, else the
    CPU) with env overrides applied.  Never raises: a device that cannot
    be asked yields an ``unknown`` spec, and env overrides still apply
    (the CPU-CI escape hatch for exercising real MFU numbers)."""
    return _apply_env(lookup(device_kind(device)))


def peak_flops(default: Optional[float] = None) -> Optional[float]:
    """Resolved peak FLOP/s: env override > device table > ``default``."""
    spec = device_spec()
    return spec.peak_flops if spec.peak_flops is not None else default
