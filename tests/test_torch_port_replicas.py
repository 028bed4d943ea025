"""The port's serving control plane held against the reference's: the
same scenario runs on ``bigdl_tpu`` and on ``bigdl_tpu_torch`` (the
reference's ``Sequential(Linear(4, 8), ReLU, Linear(8, 2))``, its weights
copied into the port by position) and must give the same outcomes and
counters — routing, kill and total outage, wedge ejection with failover
and probe readmission, error ejection, the failover budget, the overload
controller and brownout ladder, canary promotion, rejection with bitwise
rollback, drift rejection, publish retry on a transient
``serving.publish`` fault, and the ``sync_from_model`` bridge.

Where a count depends on timing (how many health ticks saw a wedge), the
scenario reports the predicate the reference's own test asserts, not the
raw count.  Shedding is driven by counts with an injected clock, never by
wall-clock deadlines."""
import time
import types

import numpy as np
import pytest
import torch

import bigdl_tpu.serving as JS
from bigdl_tpu import faults as JF
from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import faults as TF
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import serving as TS
from bigdl_tpu_torch.models.convert import from_jax_weights

SET_COUNTERS = ("requests", "shed_overload", "shed_predicted",
                "brownout_requests", "dispatches", "failovers",
                "failover_exhausted", "ejected", "readmitted", "wedged",
                "stale_results", "scaled_up", "scaled_down")


def _jax_model(scale=1.0):
    m = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    m.evaluate()
    m.ensure_initialized()
    if scale != 1.0:
        m.set_weights([np.asarray(w) * np.float32(scale)
                       for w in m.get_weights()])
    return m


def _side(name, scale=1.0):
    """(namespace of the side's API, its model), the two sides' models
    holding the same weights."""
    jm = _jax_model(scale)
    if name == "ref":
        api = types.SimpleNamespace(
            S=JS, faults=JF, model=jm,
            params=lambda m: m._params,
            scaled=lambda m, f: {k: {kk: np.asarray(v) * np.float32(f)
                                     for kk, v in sub.items()}
                                 for k, sub in m._params.items()},
            poisoned=lambda m: {k: {kk: np.full_like(np.asarray(v), np.nan)
                                    for kk, v in sub.items()}
                                for k, sub in m._params.items()},
            run=lambda m, x: np.asarray(m.run(m._params, x,
                                              state=m._state)[0]))
        return api
    tm = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    from_jax_weights([np.asarray(w) for w in jm.get_weights()], tm)

    def run(m, x):
        with torch.inference_mode():
            return m.run(m.param_dict(), torch.from_numpy(
                np.asarray(x, np.float32)))[0].numpy()
    return types.SimpleNamespace(
        S=TS, faults=TF, model=tm, params=lambda m: m.param_dict(),
        scaled=lambda m, f: {k: {kk: v.detach() * f for kk, v in sub.items()}
                             for k, sub in m.param_dict().items()},
        poisoned=lambda m: {k: {kk: torch.full_like(v, float("nan"))
                                for kk, v in sub.items()}
                            for k, sub in m.param_dict().items()},
        run=run)


def _rs(api, n=2, **kw):
    kw.setdefault("engine_kw", dict(max_batch=4, max_delay_ms=1.0,
                                    max_queue_rows=16))
    kw.setdefault("health_interval", 0.05)
    kw.setdefault("probe_interval", 0.05)
    rs = api.S.build_replica_set(api.model, n, name="m", input_shape=(4,),
                                 **kw)
    return rs.warmup()


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def _counters(rs):
    st = rs.stats()
    return {k: st[k] for k in SET_COUNTERS}


def both(scenario, **kw):
    """Run ``scenario(api)`` on the reference and the port; the port's
    outcome must equal the reference's."""
    out = {}
    for name in ("ref", "port"):
        JF.reset()
        TF.reset()
        try:
            out[name] = scenario(_side(name), **kw)
        finally:
            JF.reset()
            TF.reset()
    assert out["port"] == out["ref"]
    return out["port"]


# --------------------------------------------------------------------- #
# routing, kill, outage                                                 #
# --------------------------------------------------------------------- #
def _routes(api):
    rs = _rs(api)
    try:
        x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
        y = rs.predict("m", x, timeout=30)
        big = rs.predict("m", np.ones((9, 4), np.float32), timeout=30)
        ok = np.allclose(y, api.run(api.model, x), rtol=1e-5, atol=1e-6)
        return dict(ok=ok, big=np.shape(big), y=np.round(y, 5).tolist(),
                    health=sorted(rs.health()), healthy=rs.healthy,
                    counters=_counters(rs))
    finally:
        rs.shutdown(drain=True)


def test_routes_and_answers():
    out = both(_routes)
    assert out["ok"] and out["big"] == (9, 2)
    assert out["counters"]["requests"] == out["counters"]["dispatches"] == 4


def _kill_and_outage(api):
    rs = _rs(api)
    try:
        rs.start()
        rs.kill(1)
        shapes = [np.shape(rs.predict("m", np.ones((2, 4), np.float32),
                                      timeout=30)) for _ in range(4)]
        time.sleep(0.3)              # killed replicas are never probed back
        h = rs.health()[1]
        out = dict(shapes=shapes, killed=rs.recorder.counter_value(
            "replica/killed"), state=(h["state"], h["reason"]),
            healthy=rs.healthy)
        rs.kill(0)
        try:
            rs.submit("m", np.ones((1, 4), np.float32))
            out["outage"] = "admitted"
        except Exception as e:
            out["outage"] = type(e).__name__
        out["healthy_after"] = rs.healthy
        with pytest.raises(ValueError):
            rs.submit("m", np.ones((1, 4), np.float32), priority="vip")
        return out
    finally:
        rs.shutdown(drain=True)


def test_kill_fails_over_and_total_outage_raises():
    out = both(_kill_and_outage)
    assert out["state"] == ("ejected", "killed")
    assert out["outage"] == "NoHealthyReplicaError"


# --------------------------------------------------------------------- #
# wedge, errors, budget                                                 #
# --------------------------------------------------------------------- #
def _wedge(api):
    rs = _rs(api, wedge_after=0.2)
    try:
        rs.start()
        api.faults.arm("serving.compute:delay:1500@0")
        y = rs.submit("m", np.ones((2, 4), np.float32)).result(30)
        rec = rs.recorder
        readmitted = _wait(lambda: rec.counter_value("replica/readmitted")
                           >= 1)
        stale = _wait(lambda: rec.counter_value("replica/stale_results")
                      >= 1)
        return dict(shape=np.shape(y),
                    fired=api.faults.injected_total("serving.compute"),
                    wedged=rec.counter_value("replica/wedged"),
                    failed_over=rec.counter_value("replica/failovers") >= 1,
                    readmitted=readmitted, stale=stale,
                    all_healthy=all(h["state"] == "healthy"
                                    for h in rs.health().values()))
    finally:
        rs.shutdown(drain=True)


def test_wedged_replica_ejected_failed_over_probed_back():
    out = both(_wedge)
    assert out == dict(shape=(2, 2), fired=1, wedged=1, failed_over=True,
                       readmitted=True, stale=True, all_healthy=True)


def _last_replica(api):
    rs = _rs(api, n=1, wedge_after=0.15)
    try:
        rs.start()
        api.faults.arm("serving.compute:delay:800@0")
        f = rs.submit("m", np.ones((1, 4), np.float32))
        deferred = _wait(lambda: rs.recorder.counter_value(
            "replica/eject_deferred") >= 1)
        return dict(deferred=deferred, state=rs.health()[0]["state"],
                    shape=np.shape(f.result(30)),
                    ejected=rs.recorder.counter_value("replica/ejected"))
    finally:
        rs.shutdown(drain=True)


def test_last_replica_never_health_ejected():
    assert both(_last_replica) == dict(deferred=True, state="healthy",
                                       shape=(1, 2), ejected=0)


def _errors(api):
    rs = _rs(api, eject_min_requests=3)
    try:
        rs.start()
        bad = rs.replicas[0].engine
        orig = bad._run_batch

        def broken(entry, q, batch):
            raise RuntimeError("replica 0 exploded")

        bad._run_batch = broken
        shapes = [np.shape(rs.predict("m", np.ones((1, 4), np.float32),
                                      timeout=30)) for _ in range(6)]
        ejected = _wait(lambda: rs.health()[0]["state"] == "ejected")
        reason = rs.health()[0]["reason"]
        bad._run_batch = orig
        back = _wait(lambda: rs.health()[0]["state"] == "healthy")
        rec = rs.recorder
        return dict(shapes=shapes, ejected=ejected, reason=reason,
                    back=back,
                    failed_over=rec.counter_value("replica/failovers") >= 1,
                    readmitted=rec.counter_value("replica/readmitted") >= 1)
    finally:
        rs.shutdown(drain=True)


def test_error_replica_ejected_then_probed_back():
    out = both(_errors)
    assert out["reason"] == "errors" and out["back"] and out["readmitted"]


def _budget(api):
    rs = _rs(api, failover_rate=0.0, failover_burst=0)
    try:
        rs.start()

        def broken(entry, q, batch):
            raise RuntimeError("boom")

        for rep in rs.replicas:
            rep.engine._run_batch = broken
        try:
            rs.submit("m", np.ones((1, 4), np.float32)).result(30)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        rec = rs.recorder
        return dict(raised=raised,
                    failovers=rec.counter_value("replica/failovers"),
                    exhausted=rec.counter_value(
                        "replica/failover_exhausted") >= 1)
    finally:
        rs.shutdown(drain=True)


def test_failover_budget_caps_retry_storms():
    assert both(_budget) == dict(raised="boom", failovers=0, exhausted=True)


# --------------------------------------------------------------------- #
# overload controller, shedding and brownout, by counts                 #
# --------------------------------------------------------------------- #
def _controller(api):
    clock = [0.0]
    c = api.S.OverloadController(brownout_enter=0.75, brownout_exit=0.35,
                                 hold_s=1.0, time_fn=lambda: clock[0])
    grid = [(p, s, c.admits(p, s)) for p in ("interactive", "normal",
                                             "batch")
            for s in (0.0, 0.4, 0.5, 0.6, 0.84, 0.85, 0.9, 0.99, 1.0)]
    seq = [(0.0, 0.8), (0.5, 0.8), (0.6, 0.2), (1.0, 0.8), (2.1, 0.8),
           (2.2, 0.5), (3.0, 0.2), (3.5, 0.9), (3.6, 0.1), (4.7, 0.1),
           (5.8, 0.1), (6.0, 0.76), (7.0, 0.76), (7.1, 0.3)]
    trail = []
    for t, sat in seq:
        clock[0] = t
        trail.append((t, c.update(sat), c.browned))
    with pytest.raises(ValueError):
        api.S.OverloadController(shed_thresholds={"batch": 0.5})
    return dict(grid=grid, trail=trail)


def test_overload_controller_decisions_equal():
    out = both(_controller)
    assert ("enter" in [u for _, u, _ in out["trail"]]
            and "exit" in [u for _, u, _ in out["trail"]])


def _shed_and_brownout(api):
    """Saturation set by each engine's reported queue fill, the brownout
    hold timers by an injected clock; every decision read as a count."""
    clock = [0.0]
    ctl = api.S.OverloadController(hold_s=1.0, time_fn=lambda: clock[0])
    cheap = _side("ref" if api.S is JS else "port", scale=2.0).model
    rs = api.S.build_replica_set(
        api.model, 2, name="m", input_shape=(4,), controller=ctl,
        degrade={"m": "m.cheap"}, health_interval=3600.0,
        engine_kw=dict(max_batch=4, max_delay_ms=1.0, max_queue_rows=16))
    for rep in rs.replicas:
        rep.engine.registry.register("m.cheap", cheap, input_shape=(4,))
    rs.warmup()
    fill = [0.0]
    for rep in rs.replicas:
        rep.engine.max_queue_fill = lambda: fill[0]
    x = np.ones((1, 4), np.float32)
    out = {}
    try:
        fill[0] = 0.6
        for prio in ("batch", "normal", "interactive"):
            try:
                rs.submit("m", x, priority=prio).result(30)
                out[prio] = "served"
            except api.S.LoadShedError as e:
                out[prio] = e.reason
        # the predictive shed: a deadline the measured rate cannot meet
        rs._service_rate = 1.0
        try:
            rs.submit("m", x, deadline_ms=10.0)
            out["predicted"] = "admitted"
        except api.S.LoadShedError as e:
            out["predicted"] = e.reason
        rs._service_rate = None
        fill[0] = 0.8
        for t in (0.0, 0.5, 1.1):
            clock[0] = t
            rs.check_health()
        out["browned"] = rs.stats()["brownout"]
        y = rs.predict("m", x, timeout=30, priority="interactive")
        out["degraded"] = bool(np.allclose(y, api.run(cheap, x),
                                           rtol=1e-5, atol=1e-6))
        fill[0] = 0.2
        for t in (2.0, 2.5, 3.1):
            clock[0] = t
            rs.check_health()
        out["after_exit"] = rs.stats()["brownout"]
        rec = rs.recorder
        out["counts"] = {k: rec.counter_value(k) for k in (
            "serving/shed_overload", "serving/shed_predicted",
            "serving/brownout_requests", "serving/brownout_enter",
            "serving/brownout_exit")}
        return out
    finally:
        rs.shutdown(drain=True)


def test_priority_shed_predictive_shed_and_brownout_by_counts():
    out = both(_shed_and_brownout)
    assert out["batch"] == "overload" and out["normal"] == "served"
    assert out["predicted"] == "predicted"
    assert out["browned"] and out["degraded"] and not out["after_exit"]
    assert out["counts"] == {"serving/shed_overload": 1,
                             "serving/shed_predicted": 1,
                             "serving/brownout_requests": 1,
                             "serving/brownout_enter": 1,
                             "serving/brownout_exit": 1}


# --------------------------------------------------------------------- #
# canary publication                                                    #
# --------------------------------------------------------------------- #
def _promote(api):
    rs = _rs(api, n=3)
    try:
        golden = np.random.RandomState(1).rand(4, 4).astype(np.float32)
        pub = api.S.CanaryPublisher(rs, {"m": golden}, drift_rtol=100.0)
        snap = pub.publish("m", api.scaled(api.model, 1.1))
        y = rs.predict("m", golden, timeout=30)
        rec = rs.recorder
        return dict(versions=[r.engine.registry.get("m").snapshot.version
                              for r in rs.replicas], version=snap.version,
                    y=np.round(y, 5).tolist(),
                    promoted=rec.counter_value("serving/canary_promoted"),
                    rollbacks=rec.counter_value("serving/canary_rollbacks"),
                    healthy=[h["state"] for h in rs.health().values()])
    finally:
        rs.shutdown(drain=True)


def test_canary_promotes_fleet_wide():
    out = both(_promote)
    assert out["versions"] == [out["version"]] * 3 and out["promoted"] == 1


def _reject_nan(api):
    rs = _rs(api)
    try:
        golden = np.random.RandomState(2).rand(4, 4).astype(np.float32)
        pub = api.S.CanaryPublisher(rs, {"m": golden})
        before = [np.asarray(r.engine.predict("m", golden, timeout=30))
                  for r in rs.replicas]
        snaps = [r.engine.registry.get("m").snapshot for r in rs.replicas]
        try:
            pub.publish("m", api.poisoned(api.model))
            reason = None
        except api.S.CanaryRejectedError as e:
            reason = e.reason
        after = [np.asarray(r.engine.predict("m", golden, timeout=30))
                 for r in rs.replicas]
        rec = rs.recorder
        return dict(reason=reason,
                    bitwise=[np.array_equal(a, b)
                             for a, b in zip(before, after)],
                    untouched=rs.replicas[1].engine.registry.get("m")
                    .snapshot is snaps[1],
                    rejected=rec.counter_value("serving/canary_rejected"),
                    rollbacks=rec.counter_value("serving/canary_rollbacks"))
    finally:
        rs.shutdown(drain=True)


def test_canary_rejects_nan_and_rolls_back_bitwise():
    assert both(_reject_nan) == dict(reason="non_finite",
                                     bitwise=[True, True], untouched=True,
                                     rejected=1, rollbacks=1)


def _reject_drift(api):
    rs = _rs(api)
    try:
        golden = np.random.RandomState(3).rand(4, 4).astype(np.float32)
        pub = api.S.CanaryPublisher(rs, {"m": golden}, drift_rtol=0.01,
                                    drift_atol=1e-6)
        try:
            pub.publish("m", api.scaled(api.model, 5.0))
            reason = None
        except api.S.CanaryRejectedError as e:
            reason = e.reason
        return dict(reason=reason, version=rs.replicas[0].engine.registry
                    .get("m").snapshot.version)
    finally:
        rs.shutdown(drain=True)


def test_canary_rejects_excessive_drift():
    assert both(_reject_drift) == dict(reason="drift", version="v1")


def _publish_retry(api):
    rs = _rs(api)
    try:
        api.faults.arm("serving.publish:err:EIO@0")
        golden = np.random.RandomState(4).rand(4, 4).astype(np.float32)
        pub = api.S.CanaryPublisher(rs, {"m": golden}, drift_rtol=100.0)
        snap = pub.publish("m", api.scaled(api.model, 1.05))
        return dict(fired=api.faults.injected_total("serving.publish"),
                    retried=rs.recorder.counter_value(
                        "retry/attempts.serving.publish"),
                    versions=[r.engine.registry.get("m").snapshot.version
                              == snap.version for r in rs.replicas])
    finally:
        rs.shutdown(drain=True)


def test_canary_publish_retries_transient_fault():
    assert both(_publish_retry) == dict(fired=1, retried=1,
                                        versions=[True, True])


def _sync_bridge(api):
    rs = _rs(api)
    try:
        golden = np.random.RandomState(5).rand(4, 4).astype(np.float32)
        pub = api.S.CanaryPublisher(rs, {"m": golden}, drift_rtol=100.0)
        shell = rs.replicas[0].engine.registry.get("m").model
        shell.set_weights([np.asarray(w) * np.float32(0.9)
                           for w in shell.get_weights()])
        snap = pub.publish_from_model("m")
        y = rs.predict("m", golden, timeout=30)
        return dict(ok=bool(np.allclose(y, api.run(shell, golden),
                                        rtol=1e-5, atol=1e-6)),
                    y=np.round(y, 5).tolist(), new=snap.version != "v1")
    finally:
        rs.shutdown(drain=True)


def test_publish_from_model_is_the_sync_bridge():
    out = both(_sync_bridge)
    assert out["ok"] and out["new"]


def _scaling(api):
    rs = _rs(api, n=1)
    try:
        rs.start()
        eng = api.S.ServingEngine(
            rs.replicas[0].engine.registry, max_batch=4, max_delay_ms=1.0)
        idx = rs.add_replica(eng, warm=True)
        joined = rs.health()[idx]["reason"]
        back = _wait(lambda: rs.health()[idx]["state"] == "healthy")
        rs.decommission(0)
        y = rs.predict("m", np.ones((2, 4), np.float32), timeout=30)
        with pytest.raises(ValueError, match="last replica"):
            rs.decommission(idx)
        return dict(idx=idx, joined=joined, back=back, shape=np.shape(y),
                    out=(rs.health()[0]["state"], rs.health()[0]["reason"]),
                    counters=_counters(rs)["scaled_up"],
                    down=_counters(rs)["scaled_down"],
                    sources=[n for n, _ in rs.telemetry_sources()])
    finally:
        rs.shutdown(drain=True)


def test_add_replica_probe_gated_and_decommission():
    out = both(_scaling)
    assert out["joined"] == "joining" and out["back"]
    assert out["out"] == ("ejected", "scaled_down")


# --------------------------------------------------------------------- #
# the int8 brownout entry and its refresh on promotion                  #
# --------------------------------------------------------------------- #
def _calib():
    return [np.random.RandomState(0).rand(4, 4).astype(np.float32)]


def _int8_brownout(api):
    calib = _calib()
    rs = _rs(api, n=1, int8_degrade=True, calibration_data=calib)
    try:
        x = calib[0]
        exact = np.asarray(rs.predict("m", x, timeout=30))
        rs.controller.browned = True      # force the ladder's verdict
        browned = np.asarray(rs.predict("m", x, timeout=30))
        reg = rs.replicas[0].engine.registry
        entry8 = reg.get("m.int8")
        try:
            reg.swap_weights("m.int8", entry8.snapshot.params)
            swap = None
        except ValueError as e:
            swap = "int8/inference-only" in str(e)
        return dict(
            close=np.allclose(browned, exact, rtol=0.2, atol=0.1),
            differs=not np.array_equal(browned, exact),
            y=np.round(browned, 5).tolist(),
            brownout=rs.recorder.counter_value(
                "serving/brownout_requests") >= 1,
            kinds=sorted(type(m).__name__ for m in entry8.model.modules()),
            inference_only=entry8.inference_only, swap=swap,
            version=entry8.snapshot.version)
    finally:
        rs.shutdown(drain=True)


def test_brownout_routes_to_int8_degrade_entry():
    out = both(_int8_brownout)
    assert out["close"] and out["differs"] and out["brownout"]
    assert out["inference_only"] and out["swap"]
    assert out["kinds"].count("QuantizedLinear") == 2


def _int8_refresh(api):
    calib = _calib()
    rs = _rs(api, n=2, int8_degrade=True, calibration_data=calib)
    try:
        golden = calib[0]
        pub = api.S.CanaryPublisher(rs, {"m": golden}, drift_rtol=100.0)
        rs.controller.browned = True
        before = np.asarray(rs.predict("m", golden, timeout=30))
        rs.controller.browned = False
        snap = pub.publish("m", api.scaled(api.model, 1.2), {})
        versions = [r.engine.registry.get("m.int8").snapshot.version
                    for r in rs.replicas]
        exact = np.asarray(rs.predict("m", golden, timeout=30))
        rs.controller.browned = True
        browned = [np.asarray(r.engine.predict("m", golden, timeout=30))
                   for r in rs.replicas]
        via_set = np.asarray(rs.predict("m", golden, timeout=30))
        return dict(
            fresh=versions == [snap.version] * 2,
            refreshed=rs.recorder.counter_value("serving/degrade_refreshed"),
            failures=rs.recorder.counter_value(
                "serving/degrade_refresh_failures"),
            tracks=all(np.allclose(b, exact, rtol=0.25, atol=0.15)
                       for b in browned),
            moved=not np.allclose(via_set, before, rtol=0.05, atol=0.05),
            y=np.round(via_set, 5).tolist())
    finally:
        rs.shutdown(drain=True)


def test_canary_promotion_refreshes_int8_degrade_entry():
    out = both(_int8_refresh)
    assert out["fresh"] and out["refreshed"] == 2 and out["failures"] == 0
    assert out["tracks"] and out["moved"]


# --------------------------------------------------------------------- #
# the aggregated introspection server                                   #
# --------------------------------------------------------------------- #
def _get(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _served(api):
    """``serve_metrics`` of a 2-replica set: the replicas' recorders as
    ``job`` sources on /metrics, /healthz 200 while one replica serves
    and 503 once both are out; shutdown stops the server."""
    import json
    import threading
    before = set(threading.enumerate())
    rs = _rs(api, n=2)
    try:
        srv = rs.serve_metrics()
        for x in np.random.RandomState(3).randn(4, 4).astype(np.float32):
            rs.predict("m", x[None], timeout=30)
        code, text = _get(srv.url("/metrics"))
        jobs = sorted({line.split('job="')[1].split('"')[0]
                       for line in text.splitlines()
                       if 'job="' in line})
        healthy = _get(srv.url("/healthz"))[0]
        rs.kill(0)
        rs.kill(1)
        out_code, body = _get(srv.url("/healthz"))
        verdict = json.loads(body)
    finally:
        rs.shutdown(drain=True)
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith("introspection:")]
    return dict(metrics=code, jobs=jobs, healthy=healthy, outage=out_code,
                diverged=verdict["diverged"], left=left)


def test_unported_control_plane_options_raise():
    """``ReplicaSet.serve_metrics`` (ported since): the reference's
    aggregated server, the same outcome on both sides."""
    out = both(_served)
    assert out["metrics"] == 200 and out["jobs"] == ["replica0", "replica1"]
    assert out["healthy"] == 200 and out["outage"] == 503
    assert out["diverged"] and out["left"] == []
