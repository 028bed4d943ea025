"""The port's autoscaler (``bigdl_tpu_torch/autoscale``) against the
reference's ``bigdl_tpu/autoscale``.

``AutoscalePolicy.decide`` and ``read_signals`` are host arithmetic on an
injected clock: over seeded signal sequences both packages return the
same decisions, reasons and snapshots.  The controller is driven as the
reference's tests drive it, against the port's ``ReplicaSet`` and
``DevicePool``: up and down against a pool, borrowing from a donor and
giving back, blocked when the pool is dry or when a fleet job's floor
refuses the borrow.
"""
import time

import numpy as np
import pytest

import bigdl_tpu.autoscale as ref_auto
import bigdl_tpu.observability as ref_obs
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.autoscale import (AutoscaleController,
                                       AutoscalePolicy, Signals,
                                       read_signals)
from bigdl_tpu_torch.fleet import DevicePool, FleetScheduler
from bigdl_tpu_torch.observability import (InMemorySink, MetricsAggregator,
                                           Recorder, SeriesStore,
                                           SLObjective, SLOEngine)
from bigdl_tpu_torch.serving import (ModelRegistry, ServingEngine,
                                     build_replica_set)


def make_policy(mod=None, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("idle_ticks", 3)
    kw.setdefault("cooldown_up", 10.0)
    kw.setdefault("cooldown_down", 40.0)
    return (mod or AutoscalePolicy)(**kw)


def sig(mod=Signals, **kw):
    kw.setdefault("at", 0.0)
    kw.setdefault("no_data", False)
    return mod(**kw)


# --------------------------------------------------------------------- #
# the policy and the signals against the reference's                     #
# --------------------------------------------------------------------- #
def _signal_kw(rs, t, regime):
    """One tick's signals in a traffic regime: hot (pressure), calm
    (scale-down territory) or mid (the dead band), with missing fields,
    no-data ticks, surges and breaches mixed in."""
    kw = {"at": t, "no_data": bool(rs.rand() < 0.05)}
    lo, hi = {"hot": (0.8, 1.0), "calm": (0.0, 0.2),
              "mid": (0.3, 0.8)}[regime]
    if rs.rand() < 0.9:
        kw["occupancy"] = float(rs.uniform(lo, hi))
    if rs.rand() < 0.8:
        kw["queue_depth"] = float(rs.uniform(0, 40) if regime == "hot"
                                  else rs.uniform(0, 2))
    if rs.rand() < 0.3:
        kw["burn_fast"] = float(rs.uniform(0, 10))
    if regime == "hot" and rs.rand() < 0.2:
        kw["breached"] = ("decode_ttft_p99",)
    return kw


@pytest.mark.parametrize("seed", range(6))
def test_policy_decide_equals_reference_on_seeded_sequences(seed):
    """Two policies with the same seeded knobs fed the same 150 signals
    on one injected clock; a decision is actuated (``mark_scaled``) or
    blocked by the same draws, as a controller would."""
    rs = np.random.RandomState(seed)
    cd_up = float(rs.uniform(0, 10))
    knobs = dict(min_replicas=int(rs.randint(1, 3)),
                 max_replicas=int(rs.randint(3, 7)),
                 occupancy_high=float(rs.uniform(0.7, 0.95)),
                 occupancy_low=float(rs.uniform(0.1, 0.4)),
                 queue_high=float(rs.uniform(2, 16)),
                 burn_surge=float(rs.uniform(2, 8)),
                 idle_ticks=int(rs.randint(1, 5)), cooldown_up=cd_up,
                 cooldown_down=cd_up + float(rs.uniform(0, 30)),
                 max_step=int(rs.randint(1, 4)))
    pols = (ref_auto.AutoscalePolicy(clock=lambda: 0.0, **knobs),
            AutoscalePolicy(clock=lambda: 0.0, **knobs))
    n, t, seen = knobs["min_replicas"], 0.0, set()
    for i in range(150):
        if i % 15 == 0:
            regime = str(rs.choice(["hot", "calm", "mid"]))
        t += float(rs.uniform(0.0, 6.0))
        kw = _signal_kw(rs, t, regime)
        ds = [p.decide(m(**kw), n, now=t) for p, m in
              zip(pols, (ref_auto.Signals, Signals))]
        assert ds[1].as_dict() == ds[0].as_dict()
        assert ds[1].evidence == ds[0].evidence == ()
        seen.add(ds[1].direction)
        if ds[1].direction != "hold" and rs.rand() < 0.8:
            for p in pols:
                p.mark_scaled(ds[1].direction, t)
            n += ds[1].delta if ds[1].direction == "up" else -ds[1].delta
        assert [vars_of(p) for p in pols[1:]] == [vars_of(pols[0])]
    assert seen == {"up", "down", "hold"}


def vars_of(p):
    return (p.last_scaled_at, p.last_direction, p.idle_streak)


def _store_and_engine(mod_obs, seed):
    rs = np.random.RandomState(seed)
    clk = [1000.0]
    st = mod_obs.SeriesStore(clock=lambda: clk[0])
    for k in range(int(rs.randint(1, 4))):
        for _ in range(int(rs.randint(1, 6))):
            clk[0] += float(rs.uniform(0, 20))
            st.observe(f"serve.replica{k}/bigdl_decode_queue_depth",
                       float(rs.randint(0, 30)))
            st.observe(f"serve.replica{k}/bigdl_decode_occupancy",
                       float(rs.uniform()))
            st.observe(f"r{k}/kv_pool_fill", float(rs.uniform()))
            st.observe(f"r{k}/decode_ttft_ms/p99",
                       float(rs.exponential(100)))
            st.observe("set/bigdl_replica_queue_rows_0",
                       float(rs.randint(0, 9)))
    eng = mod_obs.SLOEngine(st, [mod_obs.SLObjective(
        "ttft", target=0.9, window=60.0, series=("*ttft*",),
        threshold=100.0, burn_alert=1.5)], clock=lambda: clk[0])
    if rs.rand() < 0.8:
        eng.evaluate()
    return st, eng, float(rs.uniform(5, 60))


@pytest.mark.parametrize("seed", range(6))
def test_read_signals_equals_reference(seed):
    import bigdl_tpu_torch.observability as port_obs
    out = []
    for obs, read in ((ref_obs, ref_auto.read_signals),
                      (port_obs, read_signals)):
        st, eng, fresh = _store_and_engine(obs, seed)
        out.append((read(eng, st, fresh=fresh).as_dict(),
                    read(store=st, fresh=fresh).as_dict()))
    assert out[1] == out[0]


def test_policy_verdicts_and_cooldowns():
    p = make_policy()
    d = p.decide(Signals(at=0.0, no_data=True), 2, now=0.0)
    assert d.direction == "hold" and d.reason == "no_data"
    for pressure in (dict(breached=("decode_ttft_p99",)),
                     dict(occupancy=0.95), dict(queue_depth=30.0)):
        d = make_policy().decide(sig(**pressure), 2, now=0.0)
        assert d.direction == "up" and d.delta == 1, pressure
    p = make_policy(burn_surge=6.0)
    assert p.decide(sig(occupancy=0.95, burn_fast=8.0), 1, 0.0).delta == 2
    assert p.decide(sig(occupancy=0.95, burn_fast=8.0), 3, 0.0).delta == 1
    d = p.decide(sig(occupancy=0.95, burn_fast=8.0), 4, now=0.0)
    assert d.direction == "hold" and d.reason.startswith("at_max")
    p = make_policy(cooldown_up=10.0)
    assert p.decide(sig(occupancy=0.95), 1, now=0.0).direction == "up"
    assert p.decide(sig(occupancy=0.95), 1, now=1.0).direction == "up"
    p.mark_scaled("up", 0.0)
    d = p.decide(sig(occupancy=0.95), 2, now=5.0)
    assert d.direction == "hold" and "cooldown_up" in d.reason
    assert p.decide(sig(occupancy=0.95), 2, now=10.0).direction == "up"


def test_policy_scale_down_streak_dead_band_and_floors():
    p = make_policy(idle_ticks=3, cooldown_up=10.0, cooldown_down=40.0)
    p.mark_scaled("up", 0.0)
    calm = dict(occupancy=0.05, queue_depth=0.0)
    assert p.decide(sig(**calm), 2, now=20.0).direction == "hold"
    assert p.decide(sig(**calm), 2, now=25.0).direction == "hold"
    d3 = p.decide(sig(**calm), 2, now=30.0)
    assert d3.direction == "hold" and "cooldown_down" in d3.reason
    d4 = p.decide(sig(**calm), 2, now=45.0)
    assert d4.direction == "down" and d4.delta == 1
    p = make_policy(idle_ticks=2, cooldown_down=0.0, cooldown_up=0.0)
    mid = dict(occupancy=0.50, queue_depth=0.0)
    assert p.decide(sig(**calm), 2, now=0.0).direction == "hold"
    assert p.decide(sig(**mid), 2, now=1.0).reason == "steady"
    assert p.decide(sig(**calm), 2, now=2.0).direction == "hold"
    assert p.decide(sig(**calm), 2, now=3.0).direction == "down"
    p = make_policy(min_replicas=2, idle_ticks=1, cooldown_down=0.0,
                    cooldown_up=0.0)
    d = p.decide(sig(occupancy=0.05, queue_depth=0.0), 2, now=0.0)
    assert d.direction == "hold" and d.reason == "at_min"


@pytest.mark.parametrize("kw", [dict(cooldown_up=30.0, cooldown_down=10.0),
                                dict(occupancy_low=0.9, occupancy_high=0.5),
                                dict(min_replicas=0),
                                dict(min_replicas=3, max_replicas=2)])
def test_policy_invalid_knobs_rejected(kw):
    with pytest.raises(ValueError) as mine:
        AutoscalePolicy(**kw)
    with pytest.raises(ValueError) as theirs:
        ref_auto.AutoscalePolicy(**kw)
    assert str(mine.value) == str(theirs.value)


def test_read_signals_folds_store_and_slo_and_ignores_stale():
    clk = [1000.0]
    store = SeriesStore(clock=lambda: clk[0])
    store.observe("decode/queue_depth", 12.0)
    store.observe("decode/occupancy", 0.9)
    store.observe("decode/ttft_ms/p99", 500.0)
    eng = SLOEngine(store, [SLObjective(
        "ttft", target=0.9, window=60.0, series=("*ttft*",),
        threshold=100.0, burn_alert=2.0)], clock=lambda: clk[0])
    eng.evaluate()
    s = read_signals(eng, store)
    assert s.queue_depth == 12.0 and s.occupancy == 0.9
    assert s.breached == ("ttft",) and s.burn_fast is not None
    assert not s.no_data
    clk[0] += 100.0
    s = read_signals(store=store, fresh=30.0)
    assert s.occupancy is None and s.no_data


# --------------------------------------------------------------------- #
# the controller against a replica set and a pool                        #
# --------------------------------------------------------------------- #
def make_model():
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))


def make_engine(model):
    reg = ModelRegistry()
    reg.register("m", model, input_shape=(4,))
    return ServingEngine(reg, max_batch=4, max_delay_ms=1.0,
                         max_queue_rows=16, recorder=Recorder())


def make_rs(model, n=1, **kw):
    kw.setdefault("engine_kw", dict(max_batch=4, max_delay_ms=1.0,
                                    max_queue_rows=16))
    kw.setdefault("health_interval", 0.05)
    kw.setdefault("probe_interval", 0.05)
    rs = build_replica_set(model, n, name="m", input_shape=(4,), **kw)
    return rs.warmup()


def wait_for(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {msg}"
        time.sleep(0.02)


def make_controller(model, rs, pool=None, store=None, **kw):
    kw.setdefault("policy", make_policy(
        idle_ticks=2, cooldown_up=5.0, cooldown_down=20.0))
    return AutoscaleController(rs, lambda: make_engine(model),
                               pool=pool, store=store, **kw)


def _calm(store, clk, t):
    clk[0] = t
    store.observe("decode/occupancy", 0.05)
    store.observe("decode/queue_depth", 0.0)


def test_controller_scales_up_then_down_against_pool():
    """Up: a slot claimed, the joiner probe-gated into rotation and
    serving; down after the calm streak: decommissioned (terminal), the
    slot free, the member deregistered from the aggregator."""
    clk = [0.0]
    model = make_model()
    rs = make_rs(model, 1, recorder=Recorder(sinks=[InMemorySink()]))
    pool = DevicePool(devices=[0, 1, "cuda:2"])
    store = SeriesStore(clock=lambda: clk[0])
    agg = MetricsAggregator(clock=lambda: clk[0], stale_after=5.0)
    agg.add(rs, name="serve")
    try:
        rs.start()
        ctl = make_controller(model, rs, pool=pool, store=store,
                              claimant="serve", aggregator=agg,
                              member_name="serve")
        store.observe("decode/occupancy", 0.95)
        assert ctl.tick(now=0.0).direction == "up"
        assert pool.owned_by("serve") == [0]
        assert pool.schedulable() == [1, "cuda:2"]
        assert "serve.replica1" in agg.source_names()
        h = rs.health()[1]
        assert h["state"] in ("ejected", "healthy")
        wait_for(lambda: rs.health()[1]["state"] == "healthy",
                 msg="scaled-up replica in rotation")
        assert ctl.live_replicas() == 2
        y = rs.predict("m", np.ones((2, 4), np.float32), timeout=30)
        assert np.shape(y) == (2, 2)
        _calm(store, clk, 30.0)
        assert ctl.tick(now=30.0).direction == "hold"
        assert ctl.tick(now=31.0).direction == "down"
        assert rs.health()[1]["reason"] == "scaled_down"
        assert pool.owned_by("serve") == [] and pool.free() == \
            [0, 1, "cuda:2"]
        assert "serve.replica1" not in agg.source_names()
        assert agg.recorder.counter_value("agg/deregistered") == 1.0
        rec = rs.recorder
        assert rec.counter_value("autoscale/scale_ups") == 1
        assert rec.counter_value("autoscale/scale_downs") == 1
        assert [r["kind"] for r in rec.recent_records(
            rec_type="autoscale_event")] == ["scale_up", "scale_down"]
        assert [n for n, _ in rs.telemetry_sources()] == ["set",
                                                          "replica0"]
    finally:
        rs.shutdown(drain=True)


def test_controller_borrows_from_donor_and_returns():
    clk = [0.0]
    model = make_model()
    rs = make_rs(model, 1)
    pool = DevicePool(devices=[0, 1])
    pool.claim("train", 2)
    store = SeriesStore(clock=lambda: clk[0])
    try:
        rs.start()
        ctl = make_controller(model, rs, pool=pool, store=store,
                              claimant="serve", donor="train",
                              donor_take="head")
        store.observe("decode/occupancy", 0.95)
        assert ctl.tick(now=0.0).direction == "up"
        assert pool.owned_by("train") == [1]
        assert pool.owned_by("serve") == [0]
        wait_for(lambda: rs.health()[1]["state"] == "healthy",
                 msg="borrowed replica in rotation")
        _calm(store, clk, 30.0)
        ctl.tick(now=30.0)
        assert ctl.tick(now=31.0).direction == "down"
        assert sorted(pool.owned_by("train")) == [0, 1]
        assert pool.owned_by("serve") == []
    finally:
        rs.shutdown(drain=True)


def test_controller_blocked_when_pool_dry_or_donor_at_its_floor(tmp_path):
    """A dry pool with no donor blocks, and so does a fleet job at its
    floor (the port's transfer floor): nothing actuates, the job keeps
    its slot, and the cooldown is not burned.  Once the job's slot comes
    back to the pool, the next tick scales up onto it."""
    model = make_model()
    rs = make_rs(model, 1, recorder=Recorder(sinks=[InMemorySink()]))
    pool = DevicePool(devices=["cuda:0"])
    pool.claim("train", 1)
    store = SeriesStore(clock=lambda: 0.0)
    fl = FleetScheduler([0], handle_sigterm=False)
    fl.admit("train", _never, {"dp": 1}, min_axes={"dp": 1}, steps=1,
             batch_fn=_never, ckpt_dir=str(tmp_path), device="cpu",
             handle_sigterm=False)
    try:
        rs.start()
        ctl = make_controller(model, rs, pool=pool, store=store,
                              claimant="serve")
        store.observe("decode/occupancy", 0.95)
        assert ctl.tick(now=0.0).direction == "up"
        assert ctl.live_replicas() == 1
        rec = rs.recorder
        assert rec.counter_value("autoscale/blocked") == 1
        assert ctl.tick(now=1.0).direction == "up"
        assert rec.counter_value("autoscale/blocked") == 2
        ctl2 = make_controller(model, rs, pool=fl.pool, store=store,
                               claimant="serve", donor="train")
        assert ctl2.tick(now=2.0).direction == "up"
        assert rec.counter_value("autoscale/blocked") == 3
        assert fl.pool.owned_by("train") == [0]
        assert fl.job("train").capacity() == [0]
        kinds = [r["kind"] for r in rec.recent_records(
            rec_type="autoscale_event")]
        assert kinds == ["blocked"] * 3
        # the job leaves: its slot returns to the pool, and the next
        # pressured tick claims it
        job = fl.job("train")
        with fl._lock:
            job.state = "completed"
        fl.pool.set_floor("train", None)
        fl._replan("job_done")
        assert fl.pool.free() == [0]
        assert ctl2.tick(now=3.0).direction == "up"
        assert fl.pool.owned_by("serve") == [0]
        assert rec.counter_value("autoscale/scale_ups") == 1
    finally:
        rs.shutdown(drain=True)


def _never(*a):
    raise AssertionError("never run here")


def test_a_serving_set_reads_its_backlog_as_occupancy_and_scales_down():
    """The port's own: a set of ServingEngines exports no decode
    occupancy, so ``read_signals`` reads the set's queued rows over a full
    batch of every live replica.  The plain controller then scales such
    a set up under a backlog and back down once it drains; without an
    occupancy the policy would hold at "steady" for ever."""
    clk = [0.0]
    model = make_model()
    rs = make_rs(model, 1, recorder=Recorder(sinks=[InMemorySink()]))
    pool = DevicePool(devices=[0])
    store = SeriesStore(clock=lambda: clk[0])
    try:
        rs.start()
        assert read_signals(store=store, replica_set=rs).occupancy is None
        store.observe("replica/queue_rows.0", 3.0)
        assert read_signals(store=store).occupancy is None
        s = read_signals(store=store, replica_set=rs)
        assert s.occupancy == 0.75 and s.queue_depth == 3.0
        assert s.evidence[-1]["series"] == "queue_rows/max_batch"
        store.observe("replica/queue_rows.0", 12.0)
        ctl = make_controller(model, rs, pool=pool, store=store,
                              claimant="serve")
        d = ctl.tick(now=0.0)
        assert (d.direction, d.reason) == ("up", "occupancy 1.00")
        wait_for(lambda: rs.health()[1]["state"] == "healthy",
                 msg="scaled-up replica in rotation")
        clk[0] = 30.0
        store.observe("replica/queue_rows.0", 1.0)
        store.observe("replica/queue_rows.1", 0.0)
        assert read_signals(store=store, replica_set=rs).occupancy == 0.125
        assert ctl.tick(now=30.0).direction == "hold"
        d = ctl.tick(now=31.0)
        assert (d.direction, d.reason) == ("down", "idle x2, occupancy 0.12")
        assert rs.health()[1]["reason"] == "scaled_down"
        assert pool.free() == [0]
        # a decode occupancy series, where there is one, is what is read
        store.observe("decode/occupancy", 0.5)
        assert read_signals(store=store, replica_set=rs).occupancy == 0.5
    finally:
        rs.shutdown(drain=True)


def test_controller_background_loop_stops_with_a_timeout():
    model = make_model()
    rs = make_rs(model, 1)
    try:
        ctl = make_controller(model, rs, store=SeriesStore())
        ctl.start(interval=0.01)
        wait_for(lambda: rs.recorder.counter_value("autoscale/holds") > 0)
        ctl.stop()
        assert ctl._thread is None
    finally:
        rs.shutdown(drain=True)
