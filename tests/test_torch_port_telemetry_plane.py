"""The port's fleet telemetry plane (``bigdl_tpu_torch.observability``'s
``timeseries``, ``slo``, ``aggregate``, the Recorder's ``keep_series`` and
the ``/series`` route) against the reference's.

Every scenario runs on both packages (the ``P`` fixture), and the pure
functions (the series reducers at a ring's wrap, ``SLObjective.evaluate``,
``parse_prometheus``/``series_key``) are held equal, value for value, on
the same seeded inputs: they are host float arithmetic.
"""
import json
import math
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import bigdl_tpu.observability as ref_obs
import bigdl_tpu.observability.aggregate as ref_agg
import bigdl_tpu.observability.recorder as ref_rec
import bigdl_tpu_torch.observability as port_obs
import bigdl_tpu_torch.observability.aggregate as port_agg
import bigdl_tpu_torch.observability.recorder as port_rec


def _ns(obs, agg, rec_mod, rec_kw):
    def recorder(**kw):
        return obs.Recorder(**rec_kw, **kw)
    return types.SimpleNamespace(
        name=obs.__name__.split(".")[0], Recorder=recorder,
        MetricSeries=obs.MetricSeries, SeriesStore=obs.SeriesStore,
        SLObjective=obs.SLObjective, SLOEngine=obs.SLOEngine,
        default_objectives=obs.default_objectives,
        MetricsAggregator=obs.MetricsAggregator,
        IntrospectionServer=obs.IntrospectionServer,
        parse_prometheus=agg.parse_prometheus, series_key=agg.series_key,
        render_prometheus=obs.render_prometheus,
        quantile=rec_mod._quantile)


REF = _ns(ref_obs, ref_agg, ref_rec, {"annotate": False})
PORT = _ns(port_obs, port_agg, port_rec, {})


@pytest.fixture(params=["reference", "port"])
def P(request):
    return REF if request.param == "reference" else PORT


def _get(url):
    """(status, body) without raising on 5xx."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# --------------------------------------------------------------------- #
# MetricSeries and SeriesStore                                           #
# --------------------------------------------------------------------- #
def _reducers(pkg, cap, pts, window, now):
    s = pkg.MetricSeries(capacity=cap)
    for t, v in pts:
        s.append(t, v)
    return (s.points(window, now), s.last(), s.mean(window, now),
            s.delta(window, now), s.rate(window, now),
            s.quantile(50.0, window, now), s.quantile(99.0, window, now),
            s.vmin(window, now), s.vmax(window, now), len(s))


@pytest.mark.parametrize("seed", range(8))
def test_series_reducers_equal_reference_at_the_ring_wrap(seed):
    """Seeded rings appended past their capacity (so the window straddles
    the physical wrap), windowed by time: every reducer equals the
    reference's value exactly."""
    rs = np.random.RandomState(seed)
    cap = int(rs.randint(3, 12))
    n = cap + int(rs.randint(1, 3 * cap))
    ts = np.cumsum(rs.uniform(0.0, 2.0, n)).tolist()
    vs = rs.normal(0.0, 10.0, n).tolist()
    pts = list(zip(ts, vs))
    for window, now in ((None, None), (float(rs.uniform(1, 8)), None),
                        (float(rs.uniform(1, 8)), ts[-1] + 0.5),
                        (0.0, ts[-1])):
        assert _reducers(PORT, cap, pts, window, now) == \
            _reducers(REF, cap, pts, window, now)


def test_series_ring_wraps_and_stays_chronological(P):
    s = P.MetricSeries(capacity=4)
    for i in range(10):
        s.append(float(i), float(i * 10))
    assert len(s) == 4
    assert s.points() == [(6.0, 60.0), (7.0, 70.0), (8.0, 80.0),
                          (9.0, 90.0)]
    assert s.last() == (9.0, 90.0)


def test_series_windowed_reducers_at_ring_wrap_boundary(P):
    s = P.MetricSeries(capacity=5)
    for i in range(12):
        s.append(float(i), float(i))
    pts = s.points(window=3.0, now=11.0)
    assert pts == [(8.0, 8.0), (9.0, 9.0), (10.0, 10.0), (11.0, 11.0)]
    assert s.mean(3.0, now=11.0) == (8 + 9 + 10 + 11) / 4.0
    assert s.delta(3.0, now=11.0) == 3.0
    assert s.rate(3.0, now=11.0) == 1.0
    assert s.vmin(3.0, now=11.0) == 8.0
    assert s.vmax(3.0, now=11.0) == 11.0
    assert s.quantile(50.0, 3.0, now=11.0) == \
        P.quantile([8.0, 9.0, 10.0, 11.0], 50.0)


def test_series_reducers_never_raise_on_thin_data(P):
    s = P.MetricSeries(capacity=8)
    assert s.points() == []
    assert s.mean() is None and s.delta() is None and s.rate() is None
    assert s.quantile(99.0) is None and s.last() is None
    s.append(5.0, 42.0)
    assert s.mean() == 42.0
    assert s.delta() is None and s.rate() is None
    s.append(5.0, 43.0)             # zero elapsed time: no rate
    assert s.rate() is None


def test_series_window_defaults_to_newest_timestamp(P):
    s = P.MetricSeries(capacity=8)
    s.append(100.0, 1.0)
    s.append(109.0, 2.0)
    assert s.points(window=10.0) == [(100.0, 1.0), (109.0, 2.0)]
    assert s.points(window=5.0) == [(109.0, 2.0)]


def test_series_store_clock_match_drop_and_summary(P):
    clk = [50.0]
    st = P.SeriesStore(capacity=16, clock=lambda: clk[0])
    st.observe("decode/ttft_ms/p99", 10.0)
    clk[0] = 60.0
    st.observe("decode/ttft_ms/p99", 20.0)
    st.observe("replica0/bigdl_decode_ttft_ms/p99", 30.0)
    st.observe("other", 1.0)
    assert st.get("decode/ttft_ms/p99").points() == [(50.0, 10.0),
                                                     (60.0, 20.0)]
    assert st.match("decode/ttft_ms/p99") == ["decode/ttft_ms/p99"]
    assert st.match("bigdl_decode_ttft_ms/p99") == \
        ["replica0/bigdl_decode_ttft_ms/p99"]
    assert st.match("*decode*ttft_ms/p99") == [
        "decode/ttft_ms/p99", "replica0/bigdl_decode_ttft_ms/p99"]
    summ = st.summary("decode/ttft_ms/p99")
    assert summ["n"] == 2 and summ["mean"] == 15.0
    assert summ["delta"] == 10.0 and summ["rate"] == 1.0
    assert st.summary("missing") is None
    assert st.summary("other")["n"] == 1
    assert st.drop("replica0/*") == 1 and len(st) == 2
    assert st.drop("nothing*") == 0


# --------------------------------------------------------------------- #
# Recorder keep_series= and the /series route                            #
# --------------------------------------------------------------------- #
def test_recorder_keep_series_feeds_store_from_end_step(P):
    clk = [1000.0]
    rec = P.Recorder(keep_series=32, series_clock=lambda: clk[0])
    for step in range(3):
        rec.start_step(step)
        rec.inc("data/batches")
        rec.gauge("queue", step)
        rec.observe("lat_ms", 10.0 * (step + 1))
        rec.end_step(step, loss=1.0 / (step + 1))
        clk[0] += 5.0
    st = rec.series
    assert st.get("loss").points() == [(1000.0, 1.0), (1005.0, 0.5),
                                       (1010.0, 1.0 / 3.0)]
    assert st.get("data/batches").points()[-1] == (1010.0, 3.0)
    assert st.get("queue").points()[-1] == (1010.0, 2.0)
    assert st.get("lat_ms/p99").points() == [(1000.0, 10.0),
                                             (1005.0, 20.0),
                                             (1010.0, 30.0)]


def test_recorder_series_tick_without_step_loop(P):
    clk = [0.0]
    rec = P.Recorder(keep_series=8, series_clock=lambda: clk[0])
    rec.inc("serving.requests", 5)
    rec.observe("serving.latency_ms", 7.0)
    rec.series_tick()
    clk[0] = 2.0
    rec.inc("serving.requests", 3)
    rec.series_tick()
    assert rec.series.get("serving.requests").points() == [(0.0, 5.0),
                                                           (2.0, 8.0)]
    assert rec.series.get("serving.latency_ms/p99").points() == \
        [(0.0, 7.0), (2.0, 7.0)]
    assert P.Recorder().series is None
    assert P.Recorder().series_tick() is None


def test_series_http_route_and_404_without_store(P):
    clk = [10.0]
    rec = P.Recorder(keep_series=8, series_clock=lambda: clk[0])
    rec.start_step(0)
    rec.end_step(0, loss=2.5)
    srv = P.IntrospectionServer(rec).start()
    bare = P.IntrospectionServer(P.Recorder()).start()
    try:
        code, body = _get(srv.url("/series"))
        assert code == 200 and "loss" in json.loads(body)["names"]
        code, body = _get(srv.url("/series?name=loss&window=60"))
        payload = json.loads(body)
        assert code == 200 and payload["points"] == [[10.0, 2.5]]
        assert payload["summary"]["n"] == 1
        code, body = _get(srv.url("/series?name=missing"))
        assert json.loads(body)["points"] == []
        assert _get(bare.url("/series"))[0] == 404
    finally:
        srv.stop()
        bare.stop()


# --------------------------------------------------------------------- #
# Prometheus parser and series keys                                      #
# --------------------------------------------------------------------- #
def _exposition(seed):
    """A reference recorder's exposition with seeded counters, gauges,
    summaries, buckets and escaped labels, plus malformed lines."""
    rs = np.random.RandomState(seed)
    rec = REF.Recorder()
    rec.set_hist_buckets({"decode/*": (1.0, 10.0, 100.0)})
    for i in range(int(rs.randint(1, 6))):
        rec.inc(f"c{i}/n", float(rs.randint(0, 50)))
        rec.gauge(f"g{i}", float(rs.normal()))
        for v in rs.exponential(20.0, int(rs.randint(1, 9))):
            rec.observe(f"decode/h{i}_ms", float(v))
            rec.observe(f"lat{i}_ms", float(v))
    rec.gauge("nan_gauge", float("nan"))
    text = REF.render_prometheus(
        rec, labels={"job": 'a"b\\c\nd', "zone": str(seed)})
    return text + ("garbage line without value\n123bad_name 2\n"
                   "ok_inf +Inf\nx{q=\"1\"} -Inf 1234\n")


def _canon(parsed):
    return ([(n, l, "nan" if math.isnan(v) else v)
             for n, l, v in parsed["samples"]],
            parsed["types"], parsed["help"])


@pytest.mark.parametrize("seed", range(6))
def test_parse_prometheus_and_series_key_equal_reference(seed):
    text = _exposition(seed)
    mine, theirs = PORT.parse_prometheus(text), REF.parse_prometheus(text)
    assert _canon(mine) == _canon(theirs)
    assert len(mine["samples"]) > 10
    keys = [PORT.series_key(f"src{seed}", n, dict(l, source="s", stale="1"))
            for n, l, _ in mine["samples"]]
    assert keys == [REF.series_key(f"src{seed}", n,
                                   dict(l, source="s", stale="1"))
                    for n, l, _ in theirs["samples"]]
    assert any(k.endswith("/p99") for k in keys)


def test_parse_prometheus_round_trip_with_escaped_labels(P):
    rec = P.Recorder()
    rec.inc("fault/injected", 2)
    rec.gauge("mem/peak", float("nan"))
    rec.gauge('weird"name\\x', 1.0)
    text = P.render_prometheus(rec, labels={"job": 'a"b\\c\nd'})
    p = P.parse_prometheus(text)
    by = {n: (l, v) for n, l, v in p["samples"]}
    labels, v = by["bigdl_fault_injected_total"]
    assert labels == {"job": 'a"b\\c\nd'} and v == 2.0
    assert math.isnan(by["bigdl_mem_peak"][1])
    assert p["types"]["bigdl_fault_injected_total"] == "counter"


def test_series_key_flattens_quantiles_and_sorts_labels(P):
    assert P.series_key("r0", "bigdl_decode_ttft_ms",
                        {"quantile": "0.99"}) == \
        "r0/bigdl_decode_ttft_ms/p99"
    assert P.series_key("r0", "m", {"b": "2", "a": "1"}) == "r0/m{a=1,b=2}"
    assert P.series_key("r0", "m", {"source": "x", "stale": "1"}) == "r0/m"


# --------------------------------------------------------------------- #
# MetricsAggregator: merge, staleness, member removal, real HTTP         #
# --------------------------------------------------------------------- #
def _mk_replica(P, ttft_ms):
    rec = P.Recorder()
    rec.inc("decode/requests", 10)
    for v in ttft_ms:
        rec.observe("decode/ttft_ms", v)
    return rec


def test_aggregator_merges_sources_and_reparses(P):
    clk = [100.0]
    agg = P.MetricsAggregator(clock=lambda: clk[0], stale_after=5.0)
    agg.add_recorder("replica0", _mk_replica(P, [10.0, 12.0]))
    agg.add_recorder("replica1", _mk_replica(P, [20.0, 22.0]))
    assert agg.scrape() == {"time": 100.0, "sources": 2, "ok": 2,
                            "errors": 0, "stale": []}
    body = agg.render()
    assert 'bigdl_decode_requests_total{source="replica0"} 10.0' in body
    assert agg.store.get("replica1/bigdl_decode_ttft_ms/p99") is not None
    p = P.parse_prometheus(body)
    reqs = [(l, v) for n, l, v in p["samples"]
            if n == "bigdl_decode_requests_total"]
    assert ({"source": "replica1"}, 10.0) in reqs
    assert p["types"]["bigdl_decode_ttft_ms"] == "summary"
    assert any(n == "bigdl_agg_scrapes_total" for n, _, _ in p["samples"])


def test_aggregator_render_and_store_equal_reference():
    """The same two sources scraped on the same clock by both packages'
    aggregators: equal merged expositions, series and verdicts."""
    out = []
    for P in (REF, PORT):
        clk = [3.0]
        agg = P.MetricsAggregator(clock=lambda: clk[0], stale_after=2.0)
        alive = [True]
        src = _mk_replica(P, [5.0, 7.0, 9.0])

        def fetch(P=P, src=src, alive=alive):
            if not alive[0]:
                raise ConnectionError("gone")
            return P.render_prometheus(src)
        agg.add_source("a", fetch)
        agg.add_recorder("b", _mk_replica(P, [1.0]))
        agg.scrape()
        alive[0] = False
        clk[0] = 6.0
        agg.scrape()
        out.append((agg.render(), {k: agg.store.points(k)
                                   for k in agg.store.names()},
                    agg.healthz()["stale_sources"]))
    assert out[0][1] == out[1][1] and out[0][2] == out[1][2] == ["a"]
    assert out[0][0] == out[1][0]


def test_aggregator_staleness_retains_and_flags_then_recovers(P):
    clk = [0.0]
    healthy = [True]
    rec = _mk_replica(P, [10.0])

    def fetch():
        if not healthy[0]:
            raise ConnectionError("member died mid-scrape")
        return P.render_prometheus(rec)

    agg = P.MetricsAggregator(clock=lambda: clk[0], stale_after=3.0)
    agg.add_source("rep", fetch)
    agg.scrape()
    healthy[0] = False
    clk[0] = 2.0
    out = agg.scrape()
    assert out["errors"] == 1 and out["stale"] == []
    assert 'stale="1"' not in agg.render()
    clk[0] = 4.0
    assert agg.scrape()["stale"] == ["rep"]
    assert 'bigdl_decode_requests_total{source="rep",stale="1"} 10.0' \
        in agg.render()
    hz = agg.healthz()
    assert hz["ok"] is False and hz["stale_sources"] == ["rep"]
    assert agg.recorder.counter_value("agg/scrape_errors") == 2.0
    healthy[0] = True
    clk[0] = 5.0
    assert agg.scrape()["stale"] == []
    assert agg.healthz()["ok"] is True


def test_remove_member_drops_samples_series_and_verdict(P):
    clk = [0.0]
    agg = P.MetricsAggregator(clock=lambda: clk[0], stale_after=3.0)
    agg.add_recorder("replica0", _mk_replica(P, [10.0]))
    agg.add_recorder("replica1", _mk_replica(P, [20.0]))
    agg.scrape()
    assert agg.remove_member("replica1") is True
    assert agg.source_names() == ["replica0"]
    body = agg.render()
    assert 'source="replica1"' not in body
    assert "agg_stale_replica1" not in body     # no ghost gauge
    assert agg.store.match("replica1/*") == []
    assert agg.store.get("replica0/bigdl_decode_ttft_ms/p99") is not None
    clk[0] = 100.0
    agg.scrape()
    hz = agg.healthz()
    assert hz["ok"] is True and hz["stale_sources"] == []
    assert agg.recorder.counter_value("agg/deregistered") == 1.0
    assert agg.remove_member("replica1") is False
    assert agg.recorder.counter_value("agg/deregistered") == 1.0
    agg.add_recorder("keep", _mk_replica(P, [10.0]))
    agg.scrape()
    assert agg.remove_member("keep", purge_series=False) is True
    assert agg.store.match("keep/*") != []


def test_aggregator_staleness_and_remove_member_over_real_http(P):
    """Members scraped through ``add_endpoint``: a member's server dies
    (retained and flagged stale), restarts on its port (readmitted), and
    another member removed on purpose leaves no stale verdict."""
    rec = _mk_replica(P, [15.0])
    srv = P.IntrospectionServer(rec).start()
    other = P.IntrospectionServer(_mk_replica(P, [3.0])).start()
    port = srv.port
    clk = [0.0]
    agg = P.MetricsAggregator(clock=lambda: clk[0], stale_after=1.0,
                              timeout=5.0)
    agg.add_endpoint("member", f"http://127.0.0.1:{port}")
    agg.add_endpoint("scaled", other.url(""))
    try:
        assert agg.scrape()["ok"] == 2
        srv.stop()
        other.stop()
        assert agg.remove_member("scaled") is True
        clk[0] = 2.0
        out = agg.scrape()
        assert out["errors"] == 1 and out["stale"] == ["member"]
        body = agg.render()
        assert 'source="member",stale="1"' in body
        assert 'source="scaled"' not in body
        srv = P.IntrospectionServer(rec, port=port).start()
        clk[0] = 3.0
        assert agg.scrape()["stale"] == []
        assert agg.healthz()["ok"] is True
    finally:
        srv.stop()
        agg.close()


def test_aggregator_add_auto_detects_hooked_objects(P):
    class Host:
        def __init__(self):
            self.r1, self.r2 = P.Recorder(), P.Recorder()

        def telemetry_sources(self):
            return [("set", self.r1), ("replica0", self.r2)]

    agg = P.MetricsAggregator(clock=lambda: 1.0)
    agg.add(Host(), name="serve")
    agg.add(P.Recorder(), name="bare")
    assert agg.source_names() == ["serve.set", "serve.replica0", "bare"]
    with pytest.raises(TypeError):
        agg.add(42)


def test_serving_engine_and_optimizer_expose_telemetry_sources():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer
    from bigdl_tpu_torch.serving import ModelRegistry, ServingEngine
    reg = ModelRegistry()
    reg.register("m", nn.Sequential(nn.Linear(4, 2)),
                 input_shape=(4,))
    eng = ServingEngine(reg, max_batch=4, max_delay_ms=1.0,
                        recorder=port_obs.Recorder())
    try:
        assert eng.telemetry_sources() == [("serving", eng.recorder)]
    finally:
        eng.shutdown(drain=False)
    x = np.zeros((4, 4), np.float32)
    y = np.ones(4, np.float32)
    opt = LocalOptimizer(nn.Sequential(nn.Linear(4, 2),
                                       nn.LogSoftMax()),
                         (x, y), nn.ClassNLLCriterion(), batch_size=4,
                         device="cpu").set_optim_method(SGD(0.1))
    (name, rec), = opt.telemetry_sources()
    assert name == "trainer" and rec is opt.recorder and opt._telemetry
    agg = port_obs.MetricsAggregator(clock=lambda: 1.0)
    agg.add(opt, name="train").add(eng, name="serve")
    assert agg.source_names() == ["train.trainer", "serve.serving"]


def test_aggregator_series_filter_and_http_surface(P):
    agg = P.MetricsAggregator(clock=lambda: 1.0, stale_after=100.0,
                              series_filter=lambda key: "ttft" in key)
    agg.add_recorder("rep", _mk_replica(P, [10.0]))
    agg.scrape()
    assert agg.store.names() and all("ttft" in n
                                     for n in agg.store.names())
    srv = agg.serve(port=0)
    try:
        code, body = _get(srv.url("/metrics"))
        assert code == 200 and 'source="rep"' in body
        code, body = _get(srv.url("/healthz"))
        assert code == 200 and json.loads(body)["ok"] is True
        code, body = _get(
            srv.url("/series?name=rep/bigdl_decode_ttft_ms/p99"))
        assert code == 200 and json.loads(body)["points"]
    finally:
        agg.close()


# --------------------------------------------------------------------- #
# SLOs                                                                   #
# --------------------------------------------------------------------- #
def _slo_case(pkg, seed):
    rs = np.random.RandomState(seed)
    st = pkg.SeriesStore(capacity=int(rs.randint(8, 64)),
                         clock=lambda: 0.0)
    t = 0.0
    for _ in range(int(rs.randint(20, 120))):
        t += float(rs.uniform(0.0, 3.0))
        for r in range(2):
            st.observe(f"r{r}/decode_ttft_ms/p99",
                       float(rs.exponential(80.0)), t=t)
        st.observe("r0/decode_requests_total", t * 10.0, t=t)
        st.observe("r0/decode_shed_deadline_total",
                   float(int(t * rs.uniform(0.0, 2.0))), t=t)
    objs = [pkg.SLObjective("ttft", target=0.9, window=float(
                rs.uniform(10, 120)), threshold=100.0,
                series=("*decode_ttft_ms/p99",), burn_alert=1.5),
            pkg.SLObjective("ttft_hi", target=0.99, window=60.0,
                            fast_window=5.0, threshold=50.0,
                            good_below=False, series=("*ttft*",)),
            pkg.SLObjective("shed", target=0.95, window=float(
                rs.uniform(10, 200)), bad_series=("*shed_*",),
                total_series=("*requests*",), burn_alert=1.0)]
    return [o.evaluate(st, now=t - k) for o in objs for k in (0.0, 7.5)]


@pytest.mark.parametrize("seed", range(8))
def test_slo_evaluate_equals_reference(seed):
    """Both modes over seeded stores whose rings have wrapped: the
    verdicts (compliance, burn rates, budget, breach) are equal."""
    assert _slo_case(PORT, seed) == _slo_case(REF, seed)


def test_slo_threshold_burn_rate_matches_hand_computed_fixture(P):
    st = P.SeriesStore(capacity=64, clock=lambda: 120.0)
    for i in range(20):
        st.observe("r0/decode_ttft_ms/p99",
                   150.0 if i >= 17 else 50.0, t=6.0 * (i + 1))
    obj = P.SLObjective("ttft", target=0.9, window=120.0,
                        fast_window=18.0, threshold=100.0,
                        series=("*decode_ttft_ms/p99",), burn_alert=2.0)
    r = obj.evaluate(st, now=120.0)
    assert (r["good"], r["total"]) == (17.0, 20.0)
    assert r["burn_slow"] == (1.0 - 17.0 / 20.0) / (1.0 - 0.9)
    assert r["budget_remaining"] == 1.0 - r["burn_slow"]
    assert r["burn_fast"] == (1.0 - 1.0 / 4.0) / (1.0 - 0.9)
    assert r["breach"] is False
    for extra, breach in ((1, False), (2, True)):
        st.observe("r0/decode_ttft_ms/p99", 150.0, t=120.0)
        r = obj.evaluate(st, now=120.0)
        assert r["burn_slow"] == (1.0 - 17.0 / (20 + extra)) / (1.0 - 0.9)
        assert r["breach"] is breach


def test_slo_ratio_mode_and_no_data(P):
    st = P.SeriesStore(capacity=64, clock=lambda: 100.0)
    for t, (req, shed) in ((0.0, (0.0, 0.0)), (100.0, (100.0, 8.0))):
        st.observe("r0/decode_requests_total", req, t=t)
        st.observe("r0/decode_shed_deadline_total", shed, t=t)
    obj = P.SLObjective("shed", target=0.95, window=200.0,
                        fast_window=200.0, bad_series=("*shed_*",),
                        total_series=("*requests*",), burn_alert=1.0)
    r = obj.evaluate(st, now=100.0)
    assert (r["good"], r["total"]) == (8.0, 100.0)
    assert r["burn_slow"] == (1.0 - (1.0 - 8.0 / 100.0)) / (1.0 - 0.95)
    assert r["breach"] is True
    eng = P.SLOEngine(st, [P.SLObjective("x", target=0.9, window=60.0,
                                         series=("*missing*",),
                                         threshold=1.0)])
    r = eng.evaluate()["x"]
    assert r["no_data"] is True and r["breach"] is False
    assert r["compliance"] is None and r["budget_remaining"] is None
    assert eng.recorder.gauge_value("slo/x/no_data") == 1.0


def test_slo_engine_emits_transition_events_and_gauges(P):
    clk = [0.0]
    st = P.SeriesStore(capacity=256, clock=lambda: clk[0])
    obj = P.SLObjective("ttft", target=0.5, window=10.0, fast_window=10.0,
                        series=("lat/p99",), threshold=100.0,
                        burn_alert=1.5)
    eng = P.SLOEngine(st, [obj], clock=lambda: clk[0])
    for t in range(5):
        st.observe("lat/p99", 10.0, t=float(t))
    clk[0] = 4.0
    assert eng.evaluate()["ttft"]["breach"] is False
    assert eng.recorder.recent_records(rec_type="slo_event") == []
    clk[0] = 20.0
    for t in range(15, 21):
        st.observe("lat/p99", 500.0, t=float(t))
    assert eng.evaluate()["ttft"]["breach"] is True
    assert eng.evaluate()["ttft"]["breach"] is True
    events = eng.recorder.recent_records(rec_type="slo_event")
    assert [e["kind"] for e in events] == ["breach"]
    assert eng.recorder.gauge_value("slo/ttft/breach") == 1.0
    assert eng.breached() == ["ttft"]
    clk[0] = 40.0
    for t in range(31, 41):
        st.observe("lat/p99", 10.0, t=float(t))
    assert eng.evaluate()["ttft"]["breach"] is False
    assert [e["kind"] for e in eng.recorder.recent_records(
        rec_type="slo_event")] == ["breach", "recovered"]
    assert eng.recorder.counter_value("slo/recoveries") == 1.0
    summary = eng.summary_record()
    assert summary["type"] == "slo_summary"
    eng.start(interval=0.01)
    eng.stop()
    assert eng._thread is None


def test_slo_objective_validation(P):
    with pytest.raises(ValueError):
        P.SLObjective("x", target=0.9, window=1.0)
    with pytest.raises(ValueError):
        P.SLObjective("x", target=0.9, window=1.0, series=("a",),
                      bad_series=("b",), total_series=("c",))
    with pytest.raises(ValueError):
        P.SLObjective("x", target=0.9, window=1.0, series=("a",))
    with pytest.raises(ValueError):
        P.SLObjective("x", target=1.5, window=1.0, series=("a",),
                      threshold=1.0)


def test_default_objectives_match_both_naming_planes(P):
    st = P.SeriesStore(clock=lambda: 0.0)
    st.observe("decode/ttft_ms/p99", 1.0, t=0.0)
    st.observe("serve.replica0/bigdl_decode_ttft_ms/p99", 2.0, t=0.0)
    objs = {o.name: o for o in P.default_objectives()}
    assert sorted(st.match(objs["decode_ttft_p99"].series)) == [
        "decode/ttft_ms/p99", "serve.replica0/bigdl_decode_ttft_ms/p99"]
    assert set(objs) == {"decode_ttft_p99", "decode_intertoken_p99",
                         "shed_rate", "checkpoint_writes"}
    mine = [vars(o) for o in PORT.default_objectives(window=60.0)]
    assert mine == [vars(o) for o in REF.default_objectives(window=60.0)]


def test_e2e_breach_with_stale_member(P):
    clk = [0.0]
    reps = [_mk_replica(P, []), _mk_replica(P, [])]
    alive = [True, True]

    def fetcher(i):
        def fetch():
            if not alive[i]:
                raise ConnectionError("killed mid-scrape")
            return P.render_prometheus(reps[i])
        return fetch

    agg = P.MetricsAggregator(clock=lambda: clk[0], stale_after=5.0)
    agg.add_source("replica0", fetcher(0))
    agg.add_source("replica1", fetcher(1))
    obj = P.SLObjective("decode_ttft_p99", target=0.9, window=40.0,
                        fast_window=10.0, threshold=100.0,
                        series=("*decode*ttft_ms/p99",), burn_alert=2.0)
    slo = P.SLOEngine(agg.store, [obj], recorder=agg.recorder,
                      clock=lambda: clk[0])
    for t, v in ((2.0, 50.0), (4.0, 50.0), (6.0, 50.0), (8.0, 50.0),
                 (10.0, 5e3), (12.0, 5e3), (14.0, 5e3), (16.0, 5e3)):
        clk[0] = t
        for r in reps:
            r.observe("decode/ttft_ms", v)
        agg.scrape()
        res = slo.evaluate()["decode_ttft_p99"]
    assert (res["good"], res["total"]) == (8.0, 16.0)
    assert res["burn_slow"] == (1.0 - 8.0 / 16.0) / (1.0 - 0.9)
    assert res["burn_fast"] == (1.0 - 4.0 / 12.0) / (1.0 - 0.9)
    assert res["breach"] is True
    assert "bigdl_slo_decode_ttft_p99_breach 1.0" in agg.render()
    alive[1] = False
    clk[0] = 30.0
    assert agg.scrape()["stale"] == ["replica1"]
    assert 'source="replica1",stale="1"' in agg.render()
    hz = agg.healthz()
    assert hz["ok"] is False and hz["stale_sources"] == ["replica1"]
