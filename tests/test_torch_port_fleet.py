"""The port's fleet (``bigdl_tpu_torch/fleet``) against the reference's
``bigdl_tpu/fleet``.

The planner (``plan_fleet``, ``min_plan``) is host arithmetic: over
seeded specs (tiers, floors, leftovers, rejections) both packages return
the same plans or raise the same messages.  The pool's ledger, the
admission gate, the fault sites, the SIGTERM fan-out and the shared
compile cache are held as the reference's tests state them.  Jobs run
as the port's ``ElasticSupervisor`` over gloo ranks
(``tests/_torch_port_elastic_rank.py``'s factory); the contention case
never starts more than two ranks at a time.
"""
import os
import signal
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import bigdl_tpu.fleet as ref_fleet
import bigdl_tpu_torch.faults as faults
import _torch_port_elastic_rank as R
from bigdl_tpu_torch.checkpoint import PreemptionHandler, scan
from bigdl_tpu_torch.elastic import ElasticSupervisor
from bigdl_tpu_torch.fleet import (DevicePool, FleetAdmissionError,
                                   FleetJob, FleetScheduler,
                                   PoolExhaustedError,
                                   enable_shared_compile_cache, min_plan,
                                   plan_fleet)
from bigdl_tpu_torch.observability import (GoodputLedger, InMemorySink,
                                           Recorder)
from bigdl_tpu_torch.ops import _build

AXES = ("dp", "fsdp", "tp", "sp", "pp")


# --------------------------------------------------------------------- #
# the planner against the reference's                                    #
# --------------------------------------------------------------------- #
def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _spec(rs):
    """One seeded planning problem: a pool size and 0–5 jobs with
    templates, floors (some unfittable), priorities and, now and then, a
    duplicate name."""
    n = int(rs.randint(0, 17))
    jobs = []
    for k in range(int(rs.randint(0, 6))):
        axes = rs.choice(AXES, size=int(rs.randint(1, 4)), replace=False)
        template = {str(a): int(rs.choice([1, 2, 3, 4, 6, 8]))
                    for a in axes}
        floors = None
        if rs.rand() < 0.6:
            floors = {a: int(rs.choice([1, 2, 3, 4, 5]))
                      for a in template if rs.rand() < 0.6}
        name = f"j{k}" if rs.rand() > 0.03 else "j0"
        jobs.append((name, template, floors, int(rs.randint(0, 3))))
    return n, jobs


def test_plan_fleet_and_min_plan_equal_reference_on_seeded_specs():
    """240 seeded problems: equal plans, or the same error and message
    (the admission gate's rejection text included)."""
    rs = np.random.RandomState(2026)
    kinds = {"ok": 0, "ValueError": 0}
    for _ in range(240):
        n, jobs = _spec(rs)
        mine = _outcome(plan_fleet, n, jobs)
        assert mine == _outcome(ref_fleet.plan_fleet, n, jobs), (n, jobs)
        kinds[mine[0]] += 1
        for _, template, floors, _ in jobs:
            assert _outcome(min_plan, template, floors) == \
                _outcome(ref_fleet.min_plan, template, floors)
    assert kinds["ok"] >= 60 and kinds["ValueError"] >= 30, kinds


def test_plan_fleet_fair_split_priority_and_growth():
    assert plan_fleet(8, [("a", {"dp": 8}, None, 0),
                          ("b", {"dp": 8}, None, 0)]) == \
        {"a": {"dp": 4}, "b": {"dp": 4}}
    assert plan_fleet(8, [("a", {"dp": 4}, None, 0),
                          ("b", {"dp": 4}, None, 0),
                          ("c", {"dp": 4}, None, 0)]) == \
        {"a": {"dp": 4}, "b": {"dp": 2}, "c": {"dp": 2}}
    plans = plan_fleet(8, [("old", {"dp": 8}, {"dp": 2}, 0),
                           ("vip", {"dp": 8}, None, 1)])
    assert plans["vip"]["dp"] >= plans["old"]["dp"] >= 2
    assert plan_fleet(4, [("a", {"dp": 2, "tp": 2}, None, 0),
                          ("b", {"dp": 2, "tp": 2}, None, 0)]) == \
        {"a": {"dp": 1, "tp": 2}, "b": {"dp": 1, "tp": 2}}
    assert plan_fleet(8, [("vip", {"dp": 6}, None, 1),
                          ("bg", {"dp": 2}, None, 0)]) == \
        {"vip": {"dp": 6}, "bg": {"dp": 2}}
    assert plan_fleet(8, [("a", {"dp": 8}, None, 1),
                          ("b", {"dp": 8}, None, 1),
                          ("c", {"dp": 8}, None, 0)]) == \
        {"a": {"dp": 4}, "b": {"dp": 2}, "c": {"dp": 2}}


def test_plan_fleet_floors_reserved_or_rejected_and_min_plan():
    with pytest.raises(ValueError, match="floors need"):
        plan_fleet(4, [("a", {"dp": 4}, {"dp": 4}, 0),
                       ("b", {"dp": 2}, {"dp": 2}, 0)])
    with pytest.raises(ValueError, match="duplicate"):
        plan_fleet(4, [("a", {"dp": 2}, None, 0),
                       ("a", {"dp": 2}, None, 0)])
    assert plan_fleet(4, []) == {}
    assert min_plan({"dp": 8, "tp": 4}) == {"dp": 1, "tp": 1}
    assert min_plan({"dp": 8, "tp": 4}, {"tp": 2}) == {"dp": 1, "tp": 2}
    assert min_plan({"tp": 4}, {"tp": 3}) == {"tp": 4}
    with pytest.raises(ValueError, match="floor"):
        min_plan({"tp": 4}, {"tp": 5})


# --------------------------------------------------------------------- #
# the slot pool                                                          #
# --------------------------------------------------------------------- #
def test_device_pool_ownership_ledger():
    devs = [0, 1, "cuda:2", "cuda:3"]
    pool = DevicePool(devs)
    assert pool.size == 4 and pool.free() == devs
    pool.reassign({"a": [0, 1], "b": ["cuda:2"]})
    assert pool.owned_by("a") == [0, 1]
    assert pool.owner_of("cuda:2") == "b" and pool.owner_of("cuda:3") is None
    pool.release("a")
    assert pool.free() == [0, 1, "cuda:3"]
    with pytest.raises(ValueError, match="both"):
        pool.reassign({"a": [0], "b": [0]})
    with pytest.raises(ValueError, match="outside"):
        pool.reassign({"a": [99]})


def test_pool_claim_race_last_device_one_winner():
    pool = DevicePool([0])
    results, errors = [], []
    barrier = threading.Barrier(8)

    def claimant(i):
        barrier.wait()
        try:
            results.append((i, pool.claim(f"c{i}", 1)))
        except PoolExhaustedError as e:
            errors.append((i, e))

    threads = [threading.Thread(target=claimant, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 1 and len(errors) == 7
    winner, took = results[0]
    assert took == [0] and pool.owner_of(0) == f"c{winner}"
    assert pool.free() == []


def test_pool_claims_carved_out_of_planner_view():
    pool = DevicePool([0, 1, 2, 3])
    pool.claim("serve", 1)
    assert pool.schedulable() == [1, 2, 3]
    pool.reassign({"job": [1, 2]})
    assert pool.owned_by("serve") == [0]
    with pytest.raises(ValueError, match="incremental claimant"):
        pool.reassign({"serve": [3]})
    with pytest.raises(ValueError, match="both"):
        pool.reassign({"job": [0]})
    with pytest.raises(PoolExhaustedError):
        pool.claim("serve2", 4)
    assert pool.free() == [3]


def test_pool_concurrent_claims_against_gang_replans():
    pool = DevicePool(list(range(6)))
    stop = threading.Event()
    bad = []

    def autoscaler():
        while not stop.is_set():
            try:
                pool.claim("serve", 1)
            except PoolExhaustedError:
                pass
            pool.release("serve")

    def planner():
        while not stop.is_set():
            sched = pool.schedulable()
            half = len(sched) // 2
            try:
                pool.reassign({"a": sched[:half], "b": sched[half:]})
            except ValueError:
                pass
            owners = [pool.owner_of(d) for d in pool.devices]
            if len([o for o in owners if o == "serve"]) > 1:
                bad.append(owners)

    threads = [threading.Thread(target=autoscaler),
               threading.Thread(target=planner)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not bad
    pool.release("serve")
    assert sorted(pool.free() + pool.owned_by("a")
                  + pool.owned_by("b")) == list(range(6))


def test_pool_release_idempotent_and_subset():
    pool = DevicePool([0, 1, 2])
    pool.claim("serve", 2)
    assert pool.release("serve", [0]) == [0]
    assert pool.release("serve", [0]) == []
    assert pool.release("serve") == [1]
    assert pool.release("serve") == []
    assert pool.release("ghost") == []
    assert pool.free() == [0, 1, 2] and pool.schedulable() == [0, 1, 2]


def test_pool_transfer_head_tail_and_floor():
    pool = DevicePool([0, 1, 2, 3])
    pool.claim("train", 3)
    assert pool.transfer("train", "serve", 1, take="tail") == [2]
    assert pool.transfer("train", "serve", 1, take="head") == [0]
    assert pool.owned_by("train") == [1]
    with pytest.raises(PoolExhaustedError, match="yield"):
        pool.transfer("train", "serve", 2)
    assert pool.owned_by("train") == [1]
    # the port's floor: a transfer never takes an owner below it
    pool.set_floor("train", 1)
    with pytest.raises(PoolExhaustedError, match="floor of 1"):
        pool.transfer("train", "serve", 1)
    assert pool.owned_by("train") == [1]
    pool.set_floor("train", None)
    pool.transfer("train", "serve", 1)
    assert pool.owned_by("train") == []
    assert sorted(pool.owned_by("serve")) == [0, 1, 2]


# --------------------------------------------------------------------- #
# admission, fault sites, the compile cache                              #
# --------------------------------------------------------------------- #
def _dummy_factory(mesh):
    raise AssertionError("never built in these tests")


def _dummy_batch(s):
    raise AssertionError("never pulled in these tests")


def _mini_fleet(rec, n=2):
    return FleetScheduler(list(range(n)), recorder=rec,
                          handle_sigterm=False)


def _admit(fl, name, template, tmp_path, **kw):
    return fl.admit(name, _dummy_factory, template, steps=1,
                    batch_fn=_dummy_batch, ckpt_dir=str(tmp_path / name),
                    handle_sigterm=False, device="cpu", **kw)


def test_admission_rejects_unfittable_floor_and_keeps_standing_jobs(
        tmp_path):
    rec = Recorder(sinks=[InMemorySink()])
    fl = _mini_fleet(rec)
    j1 = _admit(fl, "j1", {"dp": 2}, tmp_path, min_axes={"dp": 2})
    before = list(j1.devices)
    assert len(before) == 2 and fl.pool.owned_by("j1") == before
    with pytest.raises(FleetAdmissionError, match="floors need"):
        _admit(fl, "j2", {"dp": 1}, tmp_path)
    assert j1.devices == before and j1.state == "admitted"
    assert rec.counter_value("fleet/rejected") == 1
    assert rec.counter_value("fleet/admitted") == 1
    rej = [r for r in rec.recent_records(rec_type="fleet_event")
           if r.get("kind") == "rejected"]
    assert len(rej) == 1 and rej[0]["job"] == "j2"
    assert "floors need" in rej[0]["reason"]
    with pytest.raises(ValueError, match="already admitted"):
        _admit(fl, "j1", {"dp": 1}, tmp_path)
    # the standing job's floor guards its slots against a borrower
    with pytest.raises(PoolExhaustedError, match="floor"):
        fl.pool.transfer("j1", "serve", 1)


def test_start_skips_job_whose_supervisor_is_not_built_yet():
    fl = FleetScheduler([0, 1], handle_sigterm=False)
    job = FleetJob(fl, "x", {"dp": 2}, None, 0, 1, _dummy_batch, 0, None)
    with fl._lock:
        fl._jobs["x"] = job
    fl.start()
    assert job.state == "admitted" and job.thread is None


def test_fleet_place_and_preempt_faults_are_retried(tmp_path):
    rec = Recorder(sinks=[InMemorySink()])
    fl = _mini_fleet(rec)
    faults.reset()
    faults.arm("fleet.place:err:EIO@0")
    try:
        low = _admit(fl, "low", {"dp": 2}, tmp_path)
        assert faults.injected_total("fleet.place") == 1
    finally:
        faults.reset()
    assert rec.counter_value("fault/injected.fleet.place") == 1
    assert rec.counter_value("retry/attempts.fleet") >= 1
    assert len(low.devices) == 2
    faults.arm("fleet.preempt:err:EIO@0")
    try:
        _admit(fl, "vip", {"dp": 1}, tmp_path, priority=1)
        assert faults.injected_total("fleet.preempt") == 1
    finally:
        faults.reset()
    assert len(low.devices) == 1 and len(fl.job("vip").devices) == 1
    assert rec.counter_value("fleet/preempted") == 1
    assert low.recorder.counter_value("fleet/preempted") == 1
    assert low.recorder.counter_value("fault/injected.fleet.preempt") == 1
    events = [r for r in rec.recent_records()
              if r.get("type") == "fleet_event"]
    assert [e["kind"] for e in events] == ["admitted", "placed",
                                           "admitted", "placed",
                                           "preempted"]
    assert events[4]["job"] == "low" and events[3]["job"] == "vip"


def test_fleet_place_giveup_applies_plan_anyway(tmp_path):
    rec = Recorder(sinks=[InMemorySink()])
    fl = _mini_fleet(rec)
    faults.reset()
    faults.arm("fleet.place:err:EIO")
    try:
        j = _admit(fl, "j", {"dp": 2}, tmp_path)
    finally:
        faults.reset()
    assert len(j.devices) == 2 and j.state == "admitted"
    assert rec.counter_value("fleet/place_giveups") == 1
    assert rec.counter_value("retry/giveups.fleet") == 1


def test_shared_compile_cache_is_the_kernel_build_directory(tmp_path):
    prev = _build.BUILD_DIR
    try:
        path = enable_shared_compile_cache(str(tmp_path / "cache"))
        assert os.path.isdir(path)
        assert _build.BUILD_DIR == Path(path)
        assert _build._target("fused_sgd").parent == Path(path)
        fl = FleetScheduler([0], handle_sigterm=False,
                            compile_cache_dir=str(tmp_path / "cache2"))
        assert fl.compile_cache_dir == str(_build.BUILD_DIR)
        assert _build.BUILD_DIR == (tmp_path / "cache2").resolve()
    finally:
        _build.BUILD_DIR = prev


def test_named_supervisors_split_retry_counters(tmp_path):
    rec = Recorder(sinks=[InMemorySink()])
    kw = dict(recorder=rec, backoff_base=0.0, handle_sigterm=False,
              device="cpu")
    sup_a = ElasticSupervisor(None, str(tmp_path), {"dp": 1}, name="a", **kw)
    sup_b = ElasticSupervisor(None, str(tmp_path), {"dp": 1}, name="b", **kw)
    anon = ElasticSupervisor(None, str(tmp_path), {"dp": 1}, **kw)
    sup_a._backoff("seg", RuntimeError("x"))
    sup_a._backoff("seg", RuntimeError("x"))
    sup_b._backoff("seg", RuntimeError("y"))
    anon._backoff("seg", RuntimeError("z"))
    assert rec.counter_value("retry/attempts.elastic.a") == 2
    assert rec.counter_value("retry/attempts.elastic.b") == 1
    assert rec.counter_value("retry/attempts.elastic") == 1
    assert rec.counter_value("retry/attempts") == 4


def test_fleet_read_side_sources_goodput_and_metrics(tmp_path):
    rec = Recorder()
    fl = _mini_fleet(rec, n=3)
    j = _admit(fl, "j", {"dp": 2}, tmp_path, min_axes={"dp": 1})
    j.recorder.set_ledger(GoodputLedger(name="j", devices=2))
    names = [n for n, _ in fl.telemetry_sources()]
    assert names == ["scheduler", "j"]
    doc = fl.goodput_doc()
    assert doc["pool"]["devices"] == 3 and doc["pool"]["claimed"] == 2
    assert doc["conservation_error"] <= 1e-9 and "j" in doc["jobs"]
    srv = fl.serve_metrics(0)
    try:
        with urllib.request.urlopen(srv.url("/metrics"), timeout=10) as r:
            body = r.read().decode()
        assert 'bigdl_fleet_admitted_total{job="j"} 1.0' in body
        with urllib.request.urlopen(srv.url("/goodput"), timeout=10) as r:
            assert b"pool_idle_s" in r.read()
    finally:
        fl.shutdown()
    assert fl._http is None


# --------------------------------------------------------------------- #
# SIGTERM fan-out                                                        #
# --------------------------------------------------------------------- #
def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_one_sigterm_fans_out_to_every_handler():
    h1 = PreemptionHandler().install()
    h2 = PreemptionHandler().install()
    worker = {}
    t = threading.Thread(
        target=lambda: worker.setdefault("h", PreemptionHandler().install()))
    t.start()
    t.join(timeout=10)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait_for(lambda: h1.requested and h2.requested
                         and worker["h"].requested)
        h1.uninstall()
        h1.reset()
        h2.reset()
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait_for(lambda: h2.requested)
        assert not h1.requested
    finally:
        worker["h"].uninstall()
        h1.uninstall()
        h2.uninstall()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


@pytest.mark.slow
def test_one_sigterm_stops_two_world1_supervisors(tmp_path):
    """Two jobs of one gloo rank each on a two-slot pool; one real
    SIGTERM reaches both supervisors (their worker-thread handlers hear
    the scheduler's main-thread hook), and each commits a checkpoint
    before it stops.  Marked slow, as the reference marks its case."""
    rec = Recorder(sinks=[InMemorySink()])
    fl = FleetScheduler([0, 1], recorder=rec, handle_sigterm=True)
    jobs = {name: fl.admit(name, R.factory, {"dp": 1}, steps=200,
                           batch_fn=R.batch, ckpt_dir=str(tmp_path / name),
                           ckpt_every=3, handle_sigterm=True,
                           backoff_base=0.05, device="cpu")
            for name in ("j1", "j2")}
    try:
        fl.start()
        assert _wait_for(lambda: all(
            j.recorder.gauge_value("elastic/steps_done") >= 2
            for j in jobs.values()), timeout=60), "jobs made no progress"
        os.kill(os.getpid(), signal.SIGTERM)
        res = fl.wait(timeout=60)
        assert rec.counter_value("fleet/sigterm") == 1
        for name, j in jobs.items():
            assert j.state in ("stopped", "completed")
            assert 0 < len(res[name]) < 200
            assert scan(str(tmp_path / name)), name
            heard = (j.supervisor._preemption is not None
                     and j.supervisor._preemption.requested) \
                or j.recorder.counter_value("elastic/preemptions") >= 1
            assert heard or j.state == "stopped", name
    finally:
        fl.shutdown()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert not any(j.alive() for j in jobs.values())


# --------------------------------------------------------------------- #
# contention: a priority arrival shrinks a job, which regrows after      #
# --------------------------------------------------------------------- #
def test_contention_shrinks_low_priority_never_kills(tmp_path):
    """B ``{"dp": 2}`` with the floor ``{"dp": 1}`` owns the two-slot
    pool; A ``{"dp": 1}`` arrives with priority 1 and B SHRINKS (drain,
    replan, resume on one rank; A's rank starts only once B's has left
    its slot), then REGROWS when A completes.  B's losses stay within
    the reference's band of its solo run (here the same trainer
    uninterrupted on one device, which a dp2 mesh equals within that
    band), and the fleet killed nobody."""
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.parallel.spmd import SpmdTrainer
    threads = torch.get_num_threads()
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        torch.set_num_threads(1)        # as R.factory's ranks run
        torch.use_deterministic_algorithms(True, warn_only=True)
        solo = SpmdTrainer(T.build("tiny", device="cpu", seed=0, dropout=0.0,
                                   **R.CFG), Adam(learning_rate=1e-3),
                           fsdp=False, seed=0, device="cpu")
        base = solo.fit(R.batch(s) for s in range(10))
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(deterministic)
    rec = Recorder(sinks=[InMemorySink()])
    fl = FleetScheduler([0, 1], recorder=rec, handle_sigterm=False,
                        replan_every=1)
    admitted = threading.Event()

    def b_batch(s):
        if s == 3 and not admitted.is_set():
            admitted.set()
            fl.admit("a", R.factory, {"dp": 1}, priority=1, steps=3,
                     batch_fn=R.batch, ckpt_dir=str(tmp_path / "a"),
                     ckpt_every=2, handle_sigterm=False,
                     backoff_base=0.05, device="cpu")
        if s == 6:
            # B is still mid-run when A completes: its regrow lands at
            # the next capacity poll
            assert _wait_for(lambda: len(fl.job("b").devices) == 2, 40)
        return R.batch(s)

    b = fl.admit("b", R.factory, {"dp": 2}, min_axes={"dp": 1}, steps=10,
                 batch_fn=b_batch, ckpt_dir=str(tmp_path / "b"),
                 ckpt_every=2, handle_sigterm=False, backoff_base=0.05,
                 device="cpu")
    try:
        res = fl.run(timeout=50)
    finally:
        fl.shutdown()
    a = fl.job("a")
    assert a.state == "completed" and b.state == "completed"
    assert len(res["b"]) == 10 and np.all(np.isfinite(res["b"]))
    assert rec.counter_value("fleet/failed") == 0
    assert rec.counter_value("fleet/preempted") == 1
    assert rec.counter_value("fleet/regrown") == 1
    assert b.recorder.counter_value("elastic/shrinks") == 1
    assert b.recorder.counter_value("elastic/regrows") == 1
    np.testing.assert_allclose(res["b"], base, rtol=1e-4)
    assert fl.pool.free() == [0, 1]


# --------------------------------------------------------------------- #
# chip_smoke.py's phase_fleet, rehearsed on the CPU                      #
# --------------------------------------------------------------------- #
def test_phase_fleet_rehearses_on_the_cpu():
    """``phase_fleet`` at its small size (``tiny``, a gloo rank): every
    gate it holds on the card but the launch counts, and nothing it
    started left running."""
    import importlib
    import sys
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    cs = importlib.import_module("chip_smoke")
    before = set(threading.enumerate())
    out = cs.phase_fleet("cpu", device="cpu", small=True)
    checks = out["checks"]
    assert checks.pop("teardown") == "nothing"
    assert checks and all(v is True for v in checks.values()), checks
    assert out["readings"]["events"][0] == "blocked"
    assert out["readings"]["goodput"]["conservation_error"] <= 1e-9
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith(cs._FLEET_THREADS)]
