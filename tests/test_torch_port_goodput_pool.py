"""The goodput ledger's pool side (``OwnershipLedger``, ``rollup``,
``STATE_BUCKETS``) and the regression gate (``observability/regress.py``)
of the port, against the reference's.

``rollup``, ``ledger_row`` and ``regress.check`` are host arithmetic: on
the same snapshots, rows and baseline both packages return equal
documents and findings.
"""
import os
import time
import types

import numpy as np
import pytest

import bigdl_tpu.observability.goodput as ref_goodput
import bigdl_tpu.observability.regress as ref_regress
import bigdl_tpu_torch.observability.goodput as port_goodput
import bigdl_tpu_torch.observability.regress as port_regress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "artifacts", "goodput_baseline.json")

REF = types.SimpleNamespace(g=ref_goodput, r=ref_regress)
PORT = types.SimpleNamespace(g=port_goodput, r=port_regress)


@pytest.fixture(params=["reference", "port"])
def P(request):
    return REF if request.param == "reference" else PORT


class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += float(dt)
        return self.t


def _job_snapshot(pkg, seed, name):
    """A seeded job ledger driven through steps, phases, splits and a
    device-count edge on a fake clock."""
    rs = np.random.RandomState(seed)
    clk = FakeClock(50.0 + seed)
    led = pkg.g.GoodputLedger(name=name, devices=int(rs.randint(1, 5)),
                              clock=clk)
    for _ in range(int(rs.randint(3, 12))):
        kind = rs.randint(0, 4)
        if kind == 0:
            led.note_step_begin()
            dur = float(rs.uniform(0.1, 2.0))
            clk.tick(dur)
            led.fold_step(dur, {"data_fetch": dur * rs.uniform(0, 0.5),
                                "checkpoint.blocking":
                                dur * rs.uniform(0, 0.3)})
        elif kind == 1:
            with led.phase(str(rs.choice(["failover", "queue_wait",
                                          "autoscale_transfer"]))):
                clk.tick(float(rs.uniform(0.0, 1.5)))
        elif kind == 2:
            clk.tick(float(rs.uniform(0.0, 1.0)))
            led.fold_split({"goodput": float(rs.uniform(0, 3)),
                            "brownout": float(rs.uniform(0, 1))})
        else:
            clk.tick(float(rs.uniform(0.0, 1.0)))
            led.set_devices(int(rs.randint(1, 5)))
        led.declare(str(rs.choice(list(pkg.g.STATE_BUCKETS.values()))))
    clk.tick(float(rs.uniform(0.0, 1.0)))
    return led.snapshot()


def _pool_snapshot(pkg, seed):
    rs = np.random.RandomState(100 + seed)
    clk = FakeClock(7.0)
    own = pkg.g.OwnershipLedger(int(rs.randint(1, 9)), clock=clk)
    for _ in range(int(rs.randint(2, 10))):
        clk.tick(float(rs.uniform(0.0, 3.0)))
        total = int(rs.randint(1, 9)) if rs.rand() < 0.3 else None
        own.note(int(rs.randint(0, 10)), total)
    clk.tick(float(rs.uniform(0.0, 3.0)))
    return own.snapshot()


@pytest.mark.parametrize("seed", range(12))
def test_rollup_and_ownership_equal_reference(seed):
    docs = []
    for pkg in (REF, PORT):
        jobs = {f"j{k}": _job_snapshot(pkg, seed * 7 + k, f"j{k}")
                for k in range(1 + seed % 3)}
        pool = _pool_snapshot(pkg, seed) if seed % 4 else None
        docs.append(pkg.g.rollup(jobs, pool))
    assert docs[0] == docs[1]
    assert docs[1]["conservation_error"] <= 1e-9
    assert abs(sum(docs[1]["buckets"].values()) + docs[1]["pool_idle_s"]
               - docs[1]["owned_s"]) <= 1e-9 * docs[1]["owned_s"]


def test_state_buckets_equal_reference():
    assert port_goodput.STATE_BUCKETS == ref_goodput.STATE_BUCKETS
    assert port_goodput.BUCKETS == ref_goodput.BUCKETS
    assert set(port_goodput.STATE_BUCKETS.values()) <= \
        set(port_goodput.BUCKETS)


def test_ownership_ledger_splits_claimed_vs_pool_idle(P):
    clk = FakeClock()
    own = P.g.OwnershipLedger(4, clock=clk)
    clk.tick(2.0)
    own.note(3)
    clk.tick(3.0)
    own.note(0)
    snap = own.snapshot()
    assert snap["claimed_s"] == pytest.approx(9.0)
    assert snap["pool_idle_s"] == pytest.approx(8.0 + 3.0)
    assert snap["owned_s"] == pytest.approx(20.0)


def test_rollup_keeps_pool_idle_disjoint_from_job_badput(P):
    clk_a, clk_b = FakeClock(), FakeClock()
    a = P.g.GoodputLedger(name="a", devices=2, clock=clk_a)
    clk_a.tick(4.0)
    a.fold_split({"goodput": 1.0})
    b = P.g.GoodputLedger(name="b", devices=1, clock=clk_b)
    clk_b.tick(2.0)
    with b.phase("failover"):
        clk_b.tick(1.0)
    roll = P.g.rollup({"a": a.snapshot(), "b": b.snapshot()},
                      {"devices": 4, "pool_idle_s": 5.0,
                       "claimed_s": 11.0, "owned_s": 16.0})
    assert roll["buckets"]["goodput"] == pytest.approx(8.0)
    assert roll["buckets"]["failover"] == pytest.approx(1.0)
    assert roll["pool_idle_s"] == pytest.approx(5.0)
    assert roll["owned_s"] == pytest.approx(16.0)
    assert roll["conservation_error"] <= 1e-9
    assert roll["goodput_fraction"] == pytest.approx(8.0 / 16.0)
    assert "pool" in roll and roll["jobs"]["a"]["devices"] == 2


def test_device_pool_notes_occupancy_into_its_ownership_ledger():
    from bigdl_tpu_torch.fleet import DevicePool
    pool = DevicePool(devices=["cuda:0", "cuda:1", 2])
    pool.claim("train", 2)
    time.sleep(0.02)
    snap = pool.goodput.snapshot()
    assert snap["devices"] == 3 and snap["claimed"] == 2
    assert snap["claimed_s"] > 0.0 and snap["pool_idle_s"] > 0.0
    pool.release("train")
    assert pool.goodput.snapshot()["claimed"] == 0
    with pytest.raises(ValueError, match="twice"):
        DevicePool(devices=[0, 0])


def test_supervisor_states_declare_the_ledger_background(tmp_path):
    """``ElasticSupervisor._set_state`` moves the attached ledger's
    background bucket as the reference's does (draining → preemption
    drain, planning/resuming → replan, running/idle → idle); a ledger
    that raises never blocks a transition."""
    from bigdl_tpu_torch.elastic import ElasticSupervisor
    from bigdl_tpu_torch.observability import Recorder
    clk = FakeClock()
    rec = Recorder()
    rec.set_ledger(port_goodput.GoodputLedger(name="job", devices=1,
                                              clock=clk))
    sup = ElasticSupervisor(_never, str(tmp_path), {"dp": 1},
                            recorder=rec, device="cpu")
    for state, dt in (("planning", 1.0), ("resuming", 2.0),
                      ("running", 4.0), ("draining", 3.0), ("idle", 0.5)):
        sup._set_state(state)
        assert sup.state == state
        clk.tick(dt)
    b = rec.get_ledger().snapshot()["buckets"]
    assert b["preemption_replan"] == 3.0
    assert b["preemption_drain"] == 3.0
    assert b["idle"] == 4.5

    class Broken:
        def declare(self, bucket):
            raise RuntimeError("attribution failed")
    rec.set_ledger(Broken())
    sup._set_state("draining")
    assert sup.state == "draining"


def _never(mesh):
    raise AssertionError("no segment is started here")


# --------------------------------------------------------------------- #
# the regression gate                                                    #
# --------------------------------------------------------------------- #
def _rows(pkg, seed):
    rs = np.random.RandomState(seed)
    rows = [{"source": f"bench:r{k:02d}", "mode": "x",
             "metrics": {"tps": float(rs.uniform(50, 150)),
                         "x": float(rs.normal(10, 1 + 20 * (k == 4)))}}
            for k in range(5)]
    rows += [pkg.r.ledger_row(f"j{k}", _job_snapshot(pkg, seed + k, "j"))
             for k in range(2)]
    rows += pkg.r.bench_rows([{"round": 11, "mode": "FAILED",
                               "metrics": None},
                              {"round": 12, "metrics": {"a.b": 1.0}}])
    return rows


def _baseline(seed):
    rs = np.random.RandomState(1000 + seed)
    metrics = {"bench:r03/tps": {"min": float(rs.uniform(40, 160))},
               "bench:r04/tps": {"max": float(rs.uniform(40, 160)),
                                 "justification": "known" if rs.rand()
                                 < 0.5 else None},
               "ledger:j0/goodput_fraction": {"min": float(rs.uniform())},
               "ledger:j1/conservation_error": {"max": 0.01},
               "bench:r09/gone": {"min": 1.0},
               "bench:r12/a.b": {"min": 0.1}}
    return {"metrics": metrics,
            "buckets": {"input_stall": {"max_fraction": float(
                rs.uniform(0, 0.5))},
                "checkpoint_blocking": {"max_fraction": 0.05,
                                        "justification": "slow disk"}},
            "watch": ["bench:*/x", "bench:*/tps"]}


@pytest.mark.parametrize("seed", range(10))
def test_regress_check_equals_reference(seed):
    out = []
    for pkg in (REF, PORT):
        rows = _rows(pkg, seed)
        f = pkg.r.check(rows, _baseline(seed))
        out.append((rows, [x.as_dict() for x in f], [x.render() for x in f],
                    pkg.r.gate(f)))
    assert out[0] == out[1]
    assert out[1][1]                # the seeds reach findings


def test_committed_baseline_reads_the_same(P):
    base = P.r.load_baseline(BASELINE)
    assert base == ref_regress.load_baseline(BASELINE)
    assert base["metrics"]
    for b in base.get("buckets") or {}:
        assert b in P.g.BUCKETS


def test_sentinel_fails_undocumented_regression_waives_justified(P):
    rows = [{"source": "bench:r09", "metrics": {"tps": 100.0}}]
    f = P.r.check(rows, {"metrics": {"bench:r09/tps": {"min": 150.0}}})
    assert [x.severity for x in f] == ["fail"] and not P.r.gate(f)
    f = P.r.check(rows, {"metrics": {"bench:r09/tps": {
        "min": 150.0, "justification": "known CPU-proxy slowdown"}}})
    assert [x.severity for x in f] == ["waived"] and P.r.gate(f)


def test_ledger_row_folds_buckets_to_fractions_of_owned(P):
    clk = FakeClock()
    led = P.g.GoodputLedger(name="serve", devices=2, clock=clk)
    clk.tick(5.0)
    led.fold_split({"goodput": 3.0, "queue_wait": 2.0})
    row = P.r.ledger_row("serve", led.snapshot())
    assert row["source"] == "ledger:serve"
    assert row["metrics"]["buckets.goodput"] == pytest.approx(0.6)
    assert row["metrics"]["buckets.queue_wait"] == pytest.approx(0.4)
    assert row["metrics"]["owned_s"] == pytest.approx(10.0)
    f = P.r.check([row], {"metrics": {
        "ledger:serve/goodput_fraction": {"min": 0.6 * 1.1}}})
    assert not P.r.gate(f)
    assert P.r.gate(P.r.check([row], {"metrics": {
        "ledger:serve/goodput_fraction": {"min": 0.6}}}))
