"""Cost and memory attribution, per-request tracing (≙
``bigdl_tpu/observability/profile``):

  * :mod:`specs` — the device peak table (TPU v2–v5p, A100/H100/V100;
    env-overridable);
  * :mod:`capture` — one step's FLOPs and bytes counted as it runs (the
    hand attention kernels' work by formula), the :class:`StepCostModel`
    deriving per-step ``perf/mfu`` / ``perf/hbm_bw_util`` /
    ``mem/peak_hbm_bytes``, and live ``mem/device.*`` gauges;
  * :mod:`trace` — per-request trace IDs, span timelines and the
    Chrome-trace exporter behind the engines' ``dump_chrome_trace()`` and
    the ``/trace`` endpoint.
"""
from .specs import DeviceSpec, device_kind, device_spec, lookup, peak_flops
from .capture import (StepCostModel, attach_cost, attention_work,
                      capture_and_attach, capture_enabled, capture_step,
                      counting_attention, install_device_memory_poller,
                      poll_device_memory)
from .trace import (RequestTrace, TraceRing, chrome_trace_events,
                    dump_chrome_trace)

__all__ = ["DeviceSpec", "device_kind", "device_spec", "lookup",
           "peak_flops", "StepCostModel", "attach_cost", "attention_work",
           "capture_and_attach", "capture_enabled", "capture_step",
           "counting_attention", "install_device_memory_poller",
           "poll_device_memory", "RequestTrace", "TraceRing",
           "chrome_trace_events", "dump_chrome_trace"]
