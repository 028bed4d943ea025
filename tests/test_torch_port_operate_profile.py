"""The port's cost attribution and profiler traces, against the reference
where the two compute the same thing:

  * the device ``specs`` table and its env overrides are the reference's;
  * ``StepCostModel.scalars`` equal the reference's on equal cost dicts;
  * a ``tiny`` step's captured FLOPs are within 2 % of the analytic count
    (attention included, by formula);
  * the capture changes nothing: the losses with it on and off are
    bitwise, dropout draws included, and every attention hook is back;
  * ``trace_every(n)`` writes traces at steps 0, n and 2n and nowhere
    else, and a traced step that raises leaves no profiler session open.

Inputs come from a numpy seed, at ``tiny`` size."""
import math
import os

import numpy as np
import pytest
import torch

from bigdl_tpu.observability.profile import capture as j_capture
from bigdl_tpu.observability.profile import specs as j_specs
from bigdl_tpu_torch.models import transformer as T
from bigdl_tpu_torch.observability import InMemorySink, Recorder
from bigdl_tpu_torch.observability.profile import capture as t_capture
from bigdl_tpu_torch.observability.profile import specs as t_specs
from bigdl_tpu_torch.optim import AdamW
from bigdl_tpu_torch.parallel import SpmdTrainer

FLOP_REL = 0.02


# --------------------------------------------------------------------- #
# specs                                                                 #
# --------------------------------------------------------------------- #
def test_specs_table_is_the_references():
    assert t_specs._TABLE == tuple(
        (needle, t_specs.DeviceSpec(s.name, s.peak_flops, s.peak_hbm_bw,
                                    s.hbm_capacity))
        for needle, s in j_specs._TABLE)
    assert t_specs._ENV_FIELDS == j_specs._ENV_FIELDS
    h100 = t_specs.lookup("NVIDIA H100 80GB HBM3")
    assert (h100.peak_flops, h100.peak_hbm_bw, h100.hbm_capacity) == (
        989e12, 3352e9, 80 * 1024.0 ** 3)


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB", "Tesla V100",
    "TPU v5 lite", "TPU v5p", "TPU v4", "cpu", "something else"])
@pytest.mark.parametrize("env", [{}, {"BIGDL_PEAK_FLOPS": "1e15"},
                                 {"BIGDL_PEAK_HBM_BW": "2e12",
                                  "BIGDL_HBM_CAPACITY_BYTES": "64e9"},
                                 {"BIGDL_PEAK_FLOPS": "not a number"}])
def test_lookup_and_env_overrides_are_the_references(monkeypatch, kind, env):
    for var, _ in t_specs._ENV_FIELDS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = t_specs._apply_env(t_specs.lookup(kind))
    want = j_specs._apply_env(j_specs.lookup(kind))
    assert (got.name, got.peak_flops, got.peak_hbm_bw, got.hbm_capacity,
            got.complete()) == (want.name, want.peak_flops, want.peak_hbm_bw,
                                want.hbm_capacity, want.complete())


def test_device_spec_of_the_cpu_is_unknown_peaks(monkeypatch):
    for var, _ in t_specs._ENV_FIELDS:
        monkeypatch.delenv(var, raising=False)
    spec = t_specs.device_spec("cpu")
    assert spec.name == "cpu" and spec.peak_flops is None
    monkeypatch.setenv("BIGDL_PEAK_FLOPS", "2e12")
    assert t_specs.device_spec("cpu").peak_flops == 2e12


# --------------------------------------------------------------------- #
# StepCostModel                                                         #
# --------------------------------------------------------------------- #
COSTS = [{"flops": 3.2e12, "bytes_accessed": 4.0e11,
          "peak_hbm_bytes": 2.5e10},
         {"flops": 1.0e9}, {"bytes_accessed": 5.0e8}, {},
         {"flops": 7.0e10, "peak_hbm_bytes": 1.0e9,
          "unavailable": ["memory_analysis"]}]
SPECS = [("H100", 989e12, 3352e9, 80 * 1024.0 ** 3), ("cpu", None, None,
                                                        None),
         ("half", 1e12, None, 1e10)]


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("dur", [0.1, None, 0.0, 2.5])
def test_step_cost_model_scalars_are_the_references(cost, spec, dur):
    got = t_capture.StepCostModel(cost, t_specs.DeviceSpec(*spec)) \
        .scalars(dur)
    want = j_capture.StepCostModel(cost, j_specs.DeviceSpec(*spec)) \
        .scalars(dur)
    assert got == want


# --------------------------------------------------------------------- #
# the capture on a tiny step                                            #
# --------------------------------------------------------------------- #
def _batches(n=4, b=2, s=32, vocab=256):
    ids = np.random.RandomState(11).randint(0, vocab, (n, b, s + 1)) \
        .astype(np.int32)
    return [(x[:, :-1], x[:, 1:]) for x in ids]


def _analytic(cfg, b, s):
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    matmul = cfg.n_layers * (4 * d * d + 3 * d * f) + d * v
    return 6.0 * b * s * matmul \
        + cfg.n_layers * 12 * b * cfg.n_heads * s * s * cfg.head_dim


def _trainer(capture, dropout=0.1, **kw):
    model = T.build("tiny", device="cpu", seed=0, dropout=dropout)
    tr = SpmdTrainer(model, AdamW(1e-3), device="cpu", seed=3, **kw)
    rec = Recorder(sinks=[InMemorySink()])
    tr.set_telemetry(rec, capture_cost=capture)
    return tr, rec


@pytest.mark.parametrize("loss_chunk", [None, 16])
def test_tiny_step_flops_within_2pct_of_the_analytic_count(loss_chunk):
    tr, rec = _trainer(True, dropout=0.0, loss_chunk=loss_chunk)
    tr.fit(_batches(1))
    cost = rec.recent_records(rec_type="profile")[-1]["cost"]
    want = _analytic(tr.model.cfg, 2, 32)
    if loss_chunk:
        # the chunked head recomputes its forward in the backward
        # (torch.utils.checkpoint): 2 more FLOPs a token a head parameter
        cfg = tr.model.cfg
        want += 2.0 * 2 * 32 * cfg.d_model * cfg.vocab_size
    assert abs(cost["flops"] - want) <= FLOP_REL * want, (cost, want)
    cfg = tr.model.cfg
    assert cost["attention_calls"] == cfg.n_layers
    assert cost["attention_flops"] == cfg.n_layers * 12 * 2 * cfg.n_heads \
        * 32 * 32 * cfg.head_dim
    assert cost["bytes_accessed"] > 0
    assert cost["unavailable"] == ["memory_analysis"]      # the CPU
    last = rec.recent_records(rec_type="step")[-1]["scalars"]
    assert last["perf/flops_per_sec"] > 0 and last["perf/mfu_unavailable"]
    assert rec.gauge_value("profile/flops_per_step") == cost["flops"]


def test_capture_changes_nothing():
    """Losses with the capture on and off are bitwise (dropout on: the
    capture draws from a generator of its own), the step count and the
    attention hooks are the model's own after."""
    on, rec = _trainer(True)
    off, _ = _trainer(False)
    got, want = on.fit(_batches()), off.fit(_batches())
    assert got == want
    assert len(rec.recent_records(rec_type="profile")) == 1
    assert on._step_count == off._step_count == 4
    assert all(b.attn.attention_fn is None for b in on.model.blocks)
    for a, b in zip(on.model.get_weights(), off.model.get_weights()):
        assert torch.equal(a, b)


def _local_optimizer(rec):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger
    rs = np.random.RandomState(4)
    x = rs.standard_normal((8, 12)).astype(np.float32)
    y = (rs.randint(0, 3, 8) + 1).astype(np.float32)
    model = nn.Sequential(nn.Linear(12, 16), nn.ReLU(), nn.Linear(16, 3),
                          nn.LogSoftMax())
    opt = LocalOptimizer(model, (x, y), nn.ClassNLLCriterion(),
                         batch_size=4, device="cpu")
    opt.set_end_when(Trigger.max_epoch(1))
    opt.set_telemetry(rec)
    return opt


@pytest.mark.parametrize("trainer", ["spmd", "local"])
def test_the_capture_runs_before_the_first_step_opens(trainer, tmp_path,
                                                      monkeypatch):
    """The first step's cost pass runs before its record and its trace
    open: no step's ``dur`` or trace holds it.  Its seconds are the
    profile record's ``capture_s`` and a gauge, not a step's span."""
    seen = []
    real = t_capture.capture_step

    def spy(run, model=None, device=None):
        seen.append((rec.step_in_flight(), _profiler_on()))
        return real(run, model, device)
    monkeypatch.setattr(t_capture, "capture_step", spy)
    if trainer == "spmd":
        tr, rec = _trainer(True)
        tr.set_trace_every(1, str(tmp_path))
        tr.fit(_batches(2))
    else:
        rec = Recorder(sinks=[InMemorySink()])
        tr = _local_optimizer(rec)
        tr.set_trace_every(1, str(tmp_path))
        tr.optimize()
    assert seen == [(False, False)]
    prof = rec.recent_records(rec_type="profile")[-1]
    assert prof["capture_s"] > 0
    assert rec.gauge_value("profile/capture_seconds") == prof["capture_s"]
    steps = rec.recent_records(rec_type="step")
    assert len(steps) == 2
    assert not any("profile.capture" in r["spans"] for r in steps)
    assert len(os.listdir(tmp_path)) == 2
    if trainer == "local":
        # the fetch before the capture stays the first step's span
        assert "data_fetch" in steps[0]["spans"]


def test_the_capture_leaves_the_peak_memory_statistic_alone(monkeypatch):
    """On CUDA the pass reads the device's peak statistic and never
    resets it (a caller's own peak tracking stands); where the pass did
    not raise it, the most allocated after any of its ops stands in."""
    calls = []
    allocated = iter([100, 700, 300] + [300] * 10_000)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda d=None: calls.append("reset"))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d=None: 5000)
    monkeypatch.setattr(
        torch.cuda, "memory_stats_as_nested_dict",
        lambda d=None: {"allocated_bytes": {"all": {
            "current": next(allocated)}}})
    x = torch.ones(4, 4, requires_grad=True)

    def run():
        torch.autograd.grad((x * 2).sum(), [x])
    cost = t_capture.capture_step(run, device="cuda")
    assert calls == []
    assert cost["peak_hbm_bytes"] == 700.0
    assert "memory_analysis" not in cost.get("unavailable", [])


def test_memory_poller_marks_the_cpu_unavailable():
    rec = Recorder()
    t_capture.install_device_memory_poller(rec)
    t_capture.install_device_memory_poller(rec)         # idempotent
    assert rec._gauge_pollers == [t_capture.poll_device_memory]
    assert rec.snapshot()["gauges"]["mem/device.stats_unavailable"] == 1.0


# --------------------------------------------------------------------- #
# profiler traces                                                       #
# --------------------------------------------------------------------- #
def _profiler_on() -> bool:
    return bool(torch.autograd.profiler._is_profiler_enabled)


def test_trace_every_writes_steps_0_n_and_2n_only(tmp_path):
    tr, rec = _trainer(False)
    tr.set_trace_every(2, str(tmp_path))
    tr.fit(_batches(6))
    names = sorted(os.listdir(tmp_path))
    assert names == ["trace_step0.json", "trace_step2.json",
                     "trace_step4.json"]
    assert [os.path.basename(p) for p in rec.trace_files] == names
    import json
    with open(tmp_path / "trace_step2.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)
    assert not _profiler_on()


def test_trace_only_telemetry_reads_nothing_to_the_host(tmp_path):
    model = T.build("tiny", device="cpu", seed=0)
    tr = SpmdTrainer(model, AdamW(1e-3), device="cpu")
    tr.set_trace_every(3, str(tmp_path))
    tr.fit(_batches(4))
    steps = tr.recorder.recent_records(rec_type="step")
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert all(not r["scalars"] or set(r["scalars"]) <= {
        k for k in r["scalars"] if k.startswith(("perf/", "mem/"))}
        for r in steps)
    assert sorted(os.listdir(tmp_path)) == ["trace_step0.json",
                                            "trace_step3.json"]
    # trace-only: no cost pass and no memory poller either
    assert not tr.recorder.recent_records(rec_type="profile")
    assert not tr.recorder._gauge_pollers


def test_a_traced_step_that_raises_leaves_no_profiler_open(tmp_path):
    tr, rec = _trainer(False)
    tr.set_trace_every(1, str(tmp_path))
    (x, y), = _batches(1)
    with pytest.raises(Exception):
        tr.step(x, y[:, :5])            # targets of the wrong shape
    assert not _profiler_on()
    assert not rec.step_in_flight()
    assert tr.step(x, y) is not None    # the next step traces again
    assert not _profiler_on()
    assert "trace_step0.json" in os.listdir(tmp_path)


def test_a_stale_session_is_closed_at_the_next_step(tmp_path):
    """The reference's guard: a trace left open (its step never closed)
    is stopped when the next step starts."""
    rec = Recorder()
    rec.trace_every(1, str(tmp_path))
    rec.start_step(0)
    assert _profiler_on()
    rec.start_step(1)                   # step 0 never ended
    rec.end_step(1)
    assert not _profiler_on()
    assert sorted(os.listdir(tmp_path)) == ["trace_step0.json",
                                            "trace_step1.json"]


def test_disabled_recorder_drops_everything(tmp_path):
    rec = Recorder(sinks=[InMemorySink()], enabled=False)
    rec.trace_every(1, str(tmp_path))
    rec.start_step(0)
    with rec.span("x"):
        rec.inc("c")
        rec.gauge("g", 1)
        rec.observe("h", 1)
    assert rec.end_step(0) is None
    assert rec.snapshot() == {"counters": {}, "gauges": {}}
    assert not os.listdir(tmp_path) and not _profiler_on()
    assert rec.enable().enabled and math.isclose(rec.inc("c", 2), 2.0)
