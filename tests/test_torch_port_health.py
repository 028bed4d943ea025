"""The port's training-health layer (``bigdl_tpu_torch.observability``:
the Recorder's step records and ring, ``HealthMonitor``,
``StallWatchdog``, ``FlightRecorder`` and the SIGTERM chain with the
preemption dispatcher) against the reference's
(``tests/test_health.py``), and its wiring through ``LocalOptimizer``:
a NaN at step k trips at step k, ``raise`` propagates, ``warn`` trains
on, ``rollback`` restores the last committed checkpoint once.

Identical record streams through both packages' monitors must give
identical events (the policy logic is a copy; this holds it so).
"""
import math
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.checkpoint import PreemptionHandler
from bigdl_tpu_torch.checkpoint.preemption import dispatcher
from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.data.minibatch import MiniBatch
from bigdl_tpu_torch.observability import (DivergenceError, FlightRecorder,
                                           HealthMonitor, InMemorySink,
                                           JsonlSink, Recorder,
                                           StallWatchdog,
                                           attribute_stragglers,
                                           read_flight, read_jsonl)
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------- #
# Recorder: step records, ring, liveness, sinks                          #
# --------------------------------------------------------------------- #
def test_step_records_fold_spans_scalars_and_counters(tmp_path):
    sink = InMemorySink()
    jsonl = JsonlSink(str(tmp_path / "steps.jsonl"), flush_every=1)
    rec = Recorder(sinks=[sink, jsonl])
    rec.inc("records_total", 8)
    rec.start_step(1)
    with rec.span("train_step"):
        time.sleep(0.01)
    rec.add_span("data_fetch", 0.002)
    rec.scalar("loss", 2.5)
    rec.scalar("records", 8)
    rec.observe("lat", 1.0)
    r = rec.end_step()
    assert r["type"] == "step" and r["step"] == 1
    assert r["spans"]["train_step"] >= 0.01
    assert r["spans"]["data_fetch"] == 0.002
    assert r["scalars"]["loss"] == 2.5
    assert r["scalars"]["records_per_sec"] == pytest.approx(8 / r["dur"])
    assert r["counters"]["records_total"] == 8
    assert r["hist"]["lat"]["count"] == 1
    rec.start_step(2)
    r2 = rec.end_step()                       # per-step state was reset
    assert r2["spans"] == {} and r2["scalars"] == {}
    rec.emit_record("checkpoint_summary", counters={"x": 1.0})
    rec.close()
    assert [x["type"] for x in sink.records] == ["step", "step",
                                                 "checkpoint_summary"]
    assert [x["type"] for x in read_jsonl(str(tmp_path / "steps.jsonl"))] \
        == ["step", "step", "checkpoint_summary"]


def test_end_step_folds_into_the_goodput_ledger():
    from bigdl_tpu_torch.observability import GoodputLedger
    rec = Recorder()
    rec.set_ledger(GoodputLedger(name="train", devices=1))
    rec.start_step(1)
    rec.add_span("checkpoint.blocking", 0.003)
    time.sleep(0.01)
    r = rec.end_step()
    assert r["goodput"]["buckets"]["checkpoint_blocking"] == \
        pytest.approx(0.003)
    assert r["goodput"]["buckets"]["goodput"] > 0
    assert rec.gauge_value("goodput/checkpoint_blocking_s") == \
        pytest.approx(0.003)


def test_recent_records_ring_is_bounded_and_ordered():
    rec = Recorder(keep_records=4)
    for i in range(7):
        rec.start_step(i)
        rec.scalar("loss", float(i))
        rec.end_step(i)
    assert [r["step"] for r in rec.recent_records()] == [3, 4, 5, 6]
    assert rec.recent_records(2)[0]["step"] == 5
    rec.emit_record("health_event", condition="stall", step=6)
    assert [r["type"] for r in rec.recent_records(rec_type="health_event")] \
        == ["health_event"]
    assert rec.last_step() == 6
    assert rec.recent_records(0) == [] and rec.recent_records(-5) == []
    assert len(rec.recent_records(99)) == 4


def test_step_age_tracks_pending_and_completed_steps():
    rec = Recorder()
    assert rec.step_age() is None
    rec.start_step(0)
    time.sleep(0.02)
    assert rec.step_age() >= 0.02 and rec.step_in_flight()
    rec.end_step(0)
    assert rec.step_age() < 1.0 and not rec.step_in_flight()
    rec.start_step(1)
    rec.abort_step()
    assert not rec.step_in_flight() and rec.last_step() == 0


# --------------------------------------------------------------------- #
# HealthMonitor, against the reference's                                 #
# --------------------------------------------------------------------- #
def _stream(seed=0, n=120):
    """Step records with a warmup, noise, a NaN loss, an Inf gradient
    norm, non-finite gradient counts, a loss spike and a gradient
    explosion."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        s = {"loss": 2.0 + 0.05 * rng.randn(),
             "grad_norm": 1.0 + 0.1 * rng.rand(), "nonfinite_grads": 0.0}
        if i == 30:
            s["loss"] = float("nan")
        if i == 41:
            s["grad_norm"] = float("inf")
        if i == 50:
            s["nonfinite_grads"] = 3.0
        if i == 70:
            s["loss"] = 60.0
        if i == 90:
            s["grad_norm"] = 500.0
        if i == 100:
            s["grad_norm"] = 20.0
        out.append({"type": "step", "step": i + 1, "scalars": s})
    return out


@pytest.mark.parametrize("kw", [
    {}, dict(warmup_steps=5, spike_zscore=4.0),
    dict(grad_norm_limit=10.0, grad_explosion_factor=None),
    dict(fatal_conditions=("loss_spike",), ewma_alpha=0.2)])
def test_monitor_events_equal_the_reference_on_one_stream(kw):
    from bigdl_tpu.observability import HealthMonitor as JMonitor
    from bigdl_tpu.observability import Recorder as JRecorder
    mine = HealthMonitor(policy="record", recorder=Recorder(), **kw)
    ref = JMonitor(policy="record", recorder=JRecorder(annotate=False),
                   **kw)
    for r in _stream():
        a, b = mine.check_record(r), ref.check_record(r)
        strip = lambda evs: [{k: v for k, v in e.items() if k != "time"}
                             for e in evs]
        assert repr(strip(a)) == repr(strip(b))
    assert len(mine.events) == len(ref.events) >= 4
    assert mine.healthy == ref.healthy
    assert mine.recorder.counter_value("health/events") == len(mine.events)


def test_monitor_policies():
    mon = HealthMonitor(policy="raise")
    with pytest.raises(DivergenceError) as ei:
        mon.check_record({"type": "step", "step": 7,
                          "scalars": {"loss": float("inf")}})
    assert ei.value.events[0]["step"] == 7 and not mon.healthy
    mon.mark_recovered()
    assert mon.healthy
    assert mon.check_record({"type": "health_event"}) == []
    with pytest.raises(ValueError):
        HealthMonitor(policy="explode")


# --------------------------------------------------------------------- #
# StallWatchdog                                                          #
# --------------------------------------------------------------------- #
def _seed_steps(rec, n=10, dur=0.01):
    for i in range(n):
        rec._ring.append({"type": "step", "step": i, "dur": dur,
                          "scalars": {}})


def test_watchdog_budget_and_stall_flip():
    rec = Recorder()
    wd = StallWatchdog(rec, factor=2.0, min_history=5, floor_seconds=0.05)
    assert wd.budget() is None
    _seed_steps(rec)
    assert wd.budget() == pytest.approx(0.05)
    rec.start_step(10)
    assert not wd.check_once()
    time.sleep(0.08)
    assert wd.check_once()
    assert rec.gauge_value("health/stalled") == 1
    assert rec.recent_records(rec_type="health_event")[-1]["condition"] \
        == "stall"
    rec.end_step(10)
    assert not wd.check_once()
    assert rec.counter_value("health/stall_seconds") > 0
    assert wd.stall_episodes == 1


def test_watchdog_thread_suspension_and_stop():
    rec = Recorder()
    _seed_steps(rec, dur=0.005)
    rec.start_step(10)
    rec.end_step(10)
    wd = StallWatchdog(rec, factor=2.0, min_history=5, floor_seconds=0.03,
                       poll_interval=0.01)
    with wd.suspended():                 # a long checkpoint commit
        time.sleep(0.06)
        assert not wd.check_once()
    assert not wd.check_once()           # re-baselined at resume
    wd.start()
    try:
        rec.start_step(11)               # a wedged step
        deadline = time.time() + 5.0
        while not wd.stalled and time.time() < deadline:
            time.sleep(0.01)
        assert wd.stalled
    finally:
        wd.stop()
    assert not wd.check_once()           # a stopped loop is not stalled


def test_straggler_attribution_equals_the_reference():
    from bigdl_tpu.observability.health.watchdog import \
        attribute_stragglers as jattr
    recs = [{"type": "step", "step": s, "dur": dur,
             "scalars": {"host": h}}
            for s in range(20)
            for h, dur in ((0, 0.010), (1, 0.011), (2, 0.031))]
    assert attribute_stragglers(recs) == jattr(recs)
    assert attribute_stragglers(recs)["straggler"] == 2
    assert attribute_stragglers([]) is None


# --------------------------------------------------------------------- #
# FlightRecorder and the SIGTERM chain                                   #
# --------------------------------------------------------------------- #
def test_flight_dump_roundtrip_and_dedupe(tmp_path):
    rec = Recorder(keep_records=8)
    for i in range(12):
        rec.start_step(i)
        rec.scalar("loss", float(i))
        rec.end_step(i)
    rec.inc("records_total", 12)
    fr = FlightRecorder(rec, str(tmp_path))
    d = read_flight(fr.dump("unit_test", {"note": "hello"}))
    assert d["type"] == "flight" and d["reason"] == "unit_test"
    assert d["note"] == "hello" and d["last_step"] == 11
    assert [r["step"] for r in d["records"]] == list(range(4, 12))
    assert d["counters"]["records_total"] == 12
    assert not list(tmp_path.glob("*.tmp-*"))
    assert fr.dump("again", key="k1") is not None
    assert fr.dump("again", key="k1") is None
    assert fr.dump("again") != fr.dump("again")
    assert len(fr.dumps) == 4


def test_flight_excepthook_chain_dumps_and_restores(tmp_path):
    rec = Recorder()
    fr = FlightRecorder(rec, str(tmp_path))
    calls = []
    prev = sys.excepthook
    sys.excepthook = lambda *a: calls.append(a)
    try:
        fr.install(signals=())
        err = RuntimeError("boom")
        sys.excepthook(RuntimeError, err, None)
        assert len(calls) == 1
        dumps = list(tmp_path.glob("flight_*.json"))
        assert read_flight(str(dumps[0]))["reason"] == \
            "unhandled:RuntimeError"
        fr.uninstall()
        sys.excepthook(RuntimeError, err, None)
        assert len(calls) == 2
        assert len(list(tmp_path.glob("flight_*.json"))) == 1
    finally:
        sys.excepthook = prev


def test_flight_sigterm_default_disposition_still_terminates(tmp_path):
    code = f"""
import os, signal, time
from bigdl_tpu_torch.observability import FlightRecorder, Recorder
rec = Recorder()
rec.start_step(0); rec.end_step(0)
FlightRecorder(rec, {str(tmp_path)!r}).install()
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(5)
print("SURVIVED")
"""
    env = dict(os.environ, PYTHONPATH=_REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, env=env)
    assert "SURVIVED" not in p.stdout
    assert p.returncode == -signal.SIGTERM
    assert len(list(tmp_path.glob("flight_*.json"))) == 1


@pytest.mark.parametrize("flight_first", [True, False])
def test_flight_and_preemption_sigterm_chain_both_orders(tmp_path,
                                                         flight_first):
    """Whichever installs second, one SIGTERM sets the preemption flag
    and writes one flight dump, and the process lives on to commit."""
    rec = Recorder()
    rec.start_step(0)
    rec.end_step(0)
    fr = FlightRecorder(rec, str(tmp_path))
    ph = PreemptionHandler()
    try:
        for x in ((fr, ph) if flight_first else (ph, fr)):
            x.install()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert ph.requested
        assert len(list(tmp_path.glob("flight_*.json"))) == 1
    finally:
        fr.uninstall()
        ph.uninstall()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_flight_uninstall_while_displaced_leaves_owner_hooked(tmp_path):
    rec = Recorder()
    fr = FlightRecorder(rec, str(tmp_path))
    ph = PreemptionHandler()
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        fr.install()
        ph.install()
        flight_hook = fr._sig_hooks[signal.SIGTERM]
        fr.uninstall()
        assert signal.getsignal(signal.SIGTERM) is dispatcher()._hook
        assert dispatcher()._os_prev[signal.SIGTERM] is not flight_hook
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert ph.requested
        ph.uninstall()
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    finally:
        ph.uninstall()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_flight_dump_is_signal_reentrant(tmp_path):
    fr = FlightRecorder(Recorder(), str(tmp_path))

    class EvilRepr:
        fired = False

        def __repr__(self):
            if not EvilRepr.fired:
                EvilRepr.fired = True
                fr.dump("nested")
            return "evil"

    done = []
    t = threading.Thread(target=lambda: (fr.dump("outer",
                                                 {"evil": EvilRepr()}),
                                         done.append(True)), daemon=True)
    t.start()
    t.join(timeout=10)
    assert done, "dump() self-deadlocked on re-entry"
    assert len(list(tmp_path.glob("flight_*.json"))) == 2


# --------------------------------------------------------------------- #
# the optimizer's sentinels                                              #
# --------------------------------------------------------------------- #
def _toy_problem(n=64, d=8, classes=3, poison_at=None):
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    if poison_at is not None:
        x[poison_at] = np.nan
    y = (rng.randint(0, classes, n) + 1).astype(np.float32)
    model = nn.Sequential(nn.Linear(d, classes, name="fc"), nn.LogSoftMax())
    return x, y, model


def _make_opt(x, y, model, sink, epochs=1, **health_kw):
    opt = (LocalOptimizer(model, DataSet.minibatch_arrays(x, y, 16,
                                                          shuffle=False),
                          nn.ClassNLLCriterion(), batch_size=16,
                          device="cpu")
           .set_optim_method(SGD(learning_rate=0.1))
           .set_end_when(Trigger.max_epoch(epochs))
           .set_telemetry(Recorder(sinks=[sink])))
    if health_kw:
        opt.set_health(install_crash_hooks=False, **health_kw)
    return opt


def test_set_health_twice_does_not_double_dump(tmp_path):
    x, y, model = _toy_problem()
    opt = _make_opt(x, y, model, InMemorySink())
    prev = sys.excepthook
    try:
        opt.set_health(policy="warn", flight_dir=str(tmp_path))
        opt.set_health(policy="raise", flight_dir=str(tmp_path))
        sys.excepthook(RuntimeError, RuntimeError("boom"), None)
        assert len(list(tmp_path.glob("flight_*.json"))) == 1
    finally:
        opt._flight.uninstall()
        sys.excepthook = prev


def test_nan_injected_at_step_k_trips_event_at_step_k(tmp_path):
    """A NaN in one row of batch 2 (0-based): the sentinel fires at step
    3 exactly, the in-step count saw the gradients, and one flight dump
    holds the records before it."""
    x, y, model = _toy_problem(poison_at=33)
    sink = InMemorySink()
    opt = _make_opt(x, y, model, sink, policy="raise",
                    flight_dir=str(tmp_path), stall_factor=50.0)
    with pytest.raises(DivergenceError) as ei:
        opt.optimize()
    conds = {e["condition"]: e["step"] for e in ei.value.events}
    assert conds == {"non_finite_loss": 3, "non_finite_grads": 3}
    bad = [r for r in sink.steps() if r["step"] == 3][0]
    assert bad["scalars"]["nonfinite_grads"] > 0
    dumps = list(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1
    d = read_flight(str(dumps[0]))
    assert d["reason"] == "divergence"
    assert [r["step"] for r in d["records"] if r["type"] == "step"][-3:] \
        == [1, 2, 3]
    # the watchdog was stopped on the raise path: a dead loop is not a
    # stalled one
    assert not opt._watchdog._active and not opt._watchdog.check_once()


def test_warn_policy_keeps_training(capsys):
    x, y, model = _toy_problem(poison_at=33)
    sink = InMemorySink()
    _make_opt(x, y, model, sink, policy="warn").optimize()
    assert "non_finite_loss" in capsys.readouterr().out
    assert [r["step"] for r in sink.steps()][-1] == 4


def test_divergence_without_rollback_budget_propagates(tmp_path):
    x, y, model = _toy_problem(poison_at=33)
    opt = _make_opt(x, y, model, InMemorySink(), policy="rollback",
                    max_rollbacks=0)
    opt.set_checkpoint(str(tmp_path / "ck"), Trigger.several_iteration(1))
    with pytest.raises(DivergenceError):
        opt.optimize()


class _PoisonOnce:
    """A NaN into one batch, once (``tests/test_health.py``'s)."""

    def __init__(self, inner, inject_at):
        self.inner, self.inject_at, self.armed = inner, inject_at, True

    def data(self, train=True, epoch=None):
        for i, mb in enumerate(self.inner.data(train=train, epoch=epoch)):
            if self.armed and i == self.inject_at:
                self.armed = False
                xx = np.array(mb.get_input())
                xx[0, 0] = np.nan
                mb = MiniBatch(xx, mb.get_target())
            yield mb


def test_rollback_policy_resumes_from_last_committed_checkpoint(tmp_path):
    x, y, model = _toy_problem()
    inner = DataSet.minibatch_arrays(x, y, 16, shuffle=False)
    sink = InMemorySink()
    opt = (LocalOptimizer(model, _PoisonOnce(inner, inject_at=2),
                          nn.ClassNLLCriterion(), batch_size=16,
                          device="cpu")
           .set_optim_method(SGD(learning_rate=0.1))
           .set_end_when(Trigger.max_epoch(2))
           .set_telemetry(Recorder(sinks=[sink]))
           .set_checkpoint(str(tmp_path / "ck"),
                           Trigger.several_iteration(1))
           .set_health(policy="rollback", flight_dir=str(tmp_path),
                       install_crash_hooks=False))
    opt.optimize()
    mon = opt._health_monitor
    assert mon.rollbacks == 1 and mon.healthy
    assert {e["condition"] for e in mon.events} >= {"non_finite_loss"}
    assert len(list(tmp_path.glob("flight_*.json"))) == 1
    seen = [r["step"] for r in sink.steps()]
    assert seen.count(3) == 2
    assert seen[-1] == 8
    after = [r["scalars"]["loss"] for r in sink.steps()[seen.index(3) + 1:]]
    assert all(math.isfinite(v) for v in after)
