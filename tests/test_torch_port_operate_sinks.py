"""The port's read side of telemetry held against the reference's: the
same sequence of ``inc`` / ``gauge`` / ``observe`` / spans / step
records goes into a ``bigdl_tpu`` Recorder and a ``bigdl_tpu_torch``
one, on one fake clock, and must come out the same:

  * ``render_prometheus`` and ``render_prometheus_multi`` text, buckets
    and escaping included (exact);
  * ``TensorBoardSink`` event files, read back: the same scalars;
  * the ``IntrospectionServer``'s ``/metrics``, ``/records`` and
    ``/healthz`` (200 and 503) bodies and statuses, and ``/trace``'s
    structure; after ``stop()`` no serving thread is left, and a server
    started again on the same port binds it.

Inputs come from a numpy seed."""
import json
import threading
import time as _time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import bigdl_tpu.observability.context as j_context
import bigdl_tpu.observability.recorder as j_recorder
import bigdl_tpu_torch.observability.context as t_context
import bigdl_tpu_torch.observability.recorder as t_recorder
from bigdl_tpu.observability import http as j_http
from bigdl_tpu.observability import sinks as j_sinks
from bigdl_tpu.observability.profile import trace as j_trace
from bigdl_tpu.visualization import event_writer as j_events
from bigdl_tpu_torch.observability import http as t_http
from bigdl_tpu_torch.observability import sinks as t_sinks
from bigdl_tpu_torch.observability.profile import trace as t_trace
from bigdl_tpu_torch.visualization import event_writer as t_events


class _Clock:
    """Wall and monotonic time that advance only when read, the same
    sequence on both sides.

    Only the test's own thread and the servers' request threads read it.
    Any other thread of the process reads the real clock: a stall
    watchdog that an earlier test left running in the same worker polls
    its recorder's ``step_age()`` through the patched module, and its
    reads would otherwise advance one side's clock between that side's
    own reads."""

    def __init__(self):
        self.wall, self.mono = 1.7e9, 100.0
        self.owner = threading.current_thread()

    def _ours(self):
        t = threading.current_thread()
        return t is self.owner or t.name.endswith("(process_request_thread)")

    def time(self):
        if not self._ours():
            return _time.time()
        self.wall += 0.25
        return self.wall

    def monotonic(self):
        if not self._ours():
            return _time.monotonic()
        self.mono += 0.125
        return self.mono


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock a side, patched into its recorder and trace clock."""
    out = {}
    for side, rec_mod, ctx_mod in (("ref", j_recorder, j_context),
                                   ("port", t_recorder, t_context)):
        c = _Clock()
        monkeypatch.setattr(rec_mod, "time", types.SimpleNamespace(
            time=c.time, monotonic=c.monotonic))
        monkeypatch.setattr(ctx_mod, "trace_now", c.monotonic)
        out[side] = c
    return out


def _recorder(side, **kw):
    if side == "ref":
        return j_recorder.Recorder(annotate=False, **kw)
    return t_recorder.Recorder(**kw)


BUCKETS = {"serving.latency_ms": [1.0, 5.0, 10.0, 50.0],
           "decode/*": [0.5, 2.0], "decode/ttft_ms/x": [3.0]}


def _feed(rec, seed=0, steps=3):
    """The sequence both sides record: buckets opted in, counters (one
    named so it needs escaping), per-model queue depths (a label value
    with a quote, a backslash and a newline), non-finite gauges, step
    records with spans and scalars, then the pending histograms."""
    rs = np.random.RandomState(seed)
    rec.set_hist_buckets(BUCKETS)
    rec.inc("serving.requests", 8)
    rec.inc("9lives/a-b.c", 2.5)
    rec.inc("already_total", 3)
    rec.gauge("serving.queue_depth.lm", 3)
    rec.gauge('serving.queue_depth.we"ird\\m\nodel', 1)
    rec.gauge("health/nan_gauge", float("nan"))
    rec.gauge("mem/inf", float("inf"))
    rec.gauge("mem/neg_inf", float("-inf"))
    for k in range(steps):
        rec.start_step(k)
        with rec.span("train_step"):
            rec.observe("serving.latency_ms", float(rs.lognormal(1.5, 1)))
        rec.add_span("h2d", 0.001 * (k + 1))
        rec.scalar("loss", float(rs.rand()))
        rec.scalar("records", 64)
        rec.end_step(k)
    for v in rs.lognormal(1.0, 1.2, 40):
        rec.observe("serving.latency_ms", float(v))
        rec.observe("decode/ttft_ms", float(v) / 3)
        rec.observe("decode/ttft_ms/x", float(v))
        rec.observe("plain_hist", float(v) * 7)
    rec.emit_record("profile", kind="train_step", cost={"flops": 1.0e9})
    return rec


def both(fn):
    return {side: fn(side) for side in ("ref", "port")}


# --------------------------------------------------------------------- #
# Prometheus                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("namespace,labels", [
    ("bigdl", None), ("job_ns", {"job": 'a"b', "zone": "eu\\1"}),
    ("", {"replica": "0"})])
def test_render_prometheus_is_the_references(clocks, namespace, labels):
    text = both(lambda side: (j_sinks if side == "ref" else t_sinks)
                .render_prometheus(_feed(_recorder(side)), namespace,
                                   labels))
    assert text["port"] == text["ref"]
    assert '_bucket{le="+Inf"}' in text["port"] or "+Inf" in text["port"]
    assert "# TYPE bigdl_serving_latency_ms histogram" in text["port"] \
        or namespace != "bigdl"


def test_render_prometheus_multi_is_the_references(clocks):
    def render(side):
        mod = j_sinks if side == "ref" else t_sinks
        sources = [(None, _feed(_recorder(side), seed=1)),
                   ({"job": "replica0"}, _feed(_recorder(side), seed=2)),
                   ({"job": "replica1"}, _feed(_recorder(side), seed=3))]
        return mod.render_prometheus_multi(sources)
    text = both(render)
    assert text["port"] == text["ref"]
    # one HELP/TYPE header a metric, one sample a source
    assert text["port"].count("# TYPE bigdl_serving_requests_total ") == 1
    assert text["port"].count("bigdl_serving_requests_total{") == 2


@pytest.mark.parametrize("name", ["a.b/c-d", "9x", "ok_name:sub", "ü"])
def test_prometheus_names_and_escapes(name):
    assert t_sinks.prometheus_name(name) == j_sinks.prometheus_name(name)
    assert t_sinks.prometheus_escape_help(name + "\\\n") == \
        j_sinks.prometheus_escape_help(name + "\\\n")
    assert t_sinks.prometheus_escape_label(name + '"\n\\') == \
        j_sinks.prometheus_escape_label(name + '"\n\\')


def test_hist_buckets_resolve_as_the_references(clocks):
    got = both(lambda side: {
        n: _feed(_recorder(side)).hist_buckets(n)
        for n in ("serving.latency_ms", "decode/ttft_ms",
                  "decode/ttft_ms/x", "plain_hist")})
    assert got["port"] == got["ref"]
    bounds, bins = got["port"]["decode/ttft_ms/x"]
    assert bounds == (3.0,) and sum(bins) == 40
    assert got["port"]["plain_hist"] is None


# --------------------------------------------------------------------- #
# TensorBoard                                                           #
# --------------------------------------------------------------------- #
def test_tensorboard_sink_writes_the_references_scalars(clocks, tmp_path):
    def run(side):
        d = str(tmp_path / side)
        sink = (j_sinks if side == "ref" else t_sinks).TensorBoardSink(d)
        rec = _recorder(side, sinks=[sink])
        _feed(rec)
        rec.flush()
        rec.close()
        reader = j_events if side == "ref" else t_events
        return {tag: [(s, v) for s, v, _ in reader.read_scalar(d, tag)]
                for tag in ("telemetry/loss", "telemetry/records",
                            "telemetry/records_per_sec",
                            "telemetry/span_ms/train_step",
                            "telemetry/span_ms/h2d")}
    got = both(run)
    assert got["port"] == got["ref"]
    assert len(got["port"]["telemetry/loss"]) == 3


# --------------------------------------------------------------------- #
# the introspection server                                              #
# --------------------------------------------------------------------- #
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _traces(side):
    mod = j_trace if side == "ref" else t_trace
    rs = np.random.RandomState(7)
    out = []
    for i in range(3):
        tr = mod.RequestTrace(f"trace{i}", "lm")
        t = 10.0 + i
        for name in ("admit", "queue", "compute", "reply"):
            dt = float(rs.rand())
            tr.add_span(name, t, t + dt, bucket=4)
            t += dt
        out.append(tr)
    return mod.dump_chrome_trace(out, extra_meta={"dropped_traces": 0})


def _structure(body):
    doc = json.loads(body)
    return [(e["ph"], e["name"], e["pid"], e["tid"],
             sorted((e.get("args") or {}))) for e in doc["traceEvents"]]


def _serve(side, stalled, diverged):
    rec = _feed(_recorder(side))
    if stalled:
        rec.gauge("health/stalled", 1)
    monitor = types.SimpleNamespace(healthy=not diverged)
    mod = j_http if side == "ref" else t_http
    srv = mod.IntrospectionServer(rec, monitor=monitor,
                                  trace_source=lambda: _traces(side))
    srv.start()
    try:
        return {path: _get(srv.url(path)) for path in (
            "/metrics", "/healthz", "/records", "/records?n=2&type=step",
            "/records?n=0", "/trace", "/trace?trace_id=trace1", "/nope")}
    finally:
        srv.stop()


@pytest.mark.parametrize("stalled,diverged", [(False, False), (True, False),
                                              (False, True)])
def test_server_routes_are_the_references(clocks, stalled, diverged):
    got = both(lambda side: _serve(side, stalled, diverged))
    for path in ("/metrics", "/healthz", "/records",
                 "/records?n=2&type=step", "/records?n=0"):
        assert got["port"][path] == got["ref"][path], path
    code = 503 if stalled or diverged else 200
    assert got["port"]["/healthz"][0] == code
    assert json.loads(got["port"]["/healthz"][1])["ok"] == (code == 200)
    for path in ("/trace", "/trace?trace_id=trace1"):
        assert got["port"][path][0] == got["ref"][path][0] == 200
        assert _structure(got["port"][path][1]) == \
            _structure(got["ref"][path][1])
    assert got["port"]["/nope"][0] == got["ref"]["/nope"][0] == 404


def _jobs_healthz(side):
    """/healthz with a stalled job registered, then without it, and the
    /metrics status after."""
    mod = j_http if side == "ref" else t_http
    srv = mod.IntrospectionServer(_feed(_recorder(side)))
    job = _feed(_recorder(side), seed=4)
    job.gauge("health/stalled", 1)
    srv.add_job("replica0", job).start()
    try:
        first = _get(srv.url("/healthz"))
        srv.remove_job("replica0")
        return first, _get(srv.url("/healthz")), \
            _get(srv.url("/metrics"))[0]
    finally:
        srv.stop()


def test_healthz_counts_jobs_worst_of(clocks):
    """A registered job's stall makes the aggregate 503 on both sides."""
    got = both(_jobs_healthz)
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == 503 and got["port"][1][0] == 200


def test_healthz_parity_holds_beside_a_polling_watchdog(clocks):
    """A reference stall watchdog polling its own recorder's
    ``step_age()`` every millisecond on its own thread, as one left
    running by an earlier test in the worker does, moves neither side's
    clock: the bodies stay the same."""
    rec = j_recorder.Recorder(annotate=False)
    rec.start_step(0)
    rec.end_step(0)
    from bigdl_tpu.observability.health.watchdog import StallWatchdog
    dog = StallWatchdog(rec, min_history=1, poll_interval=0.001).start()
    try:
        got = both(_jobs_healthz)
    finally:
        dog.stop()
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == 503 and got["port"][1][0] == 200


def _server_threads(before=()):
    """The serving threads started since ``before`` (a set of threads)."""
    return [t for t in set(threading.enumerate()) - set(before)
            if t.name.startswith("introspection:")]


def test_stop_leaves_no_thread_and_a_restart_rebinds_the_port():
    before = set(threading.enumerate())
    rec = t_recorder.Recorder()
    srv = t_http.IntrospectionServer(rec).start()
    port = srv.port
    assert _get(srv.url("/healthz"))[0] == 200
    assert any(t.name == f"introspection:{port}"
               for t in _server_threads(before))
    srv.stop()
    assert not _server_threads(before)
    # the port just vacated binds again (a reconfigured server)
    again = t_http.IntrospectionServer(rec, port=port).start()
    try:
        assert again.port == port and _get(again.url("/metrics"))[0] == 200
    finally:
        again.stop()
    assert not _server_threads(before)


def test_trainer_serve_metrics_reconfigures_without_a_leak():
    import torch
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    torch.manual_seed(0)
    before = set(threading.enumerate())
    tr = SpmdTrainer(T.build("tiny", device="cpu", seed=0), AdamW(1e-3),
                     device="cpu")
    first = tr.serve_metrics()
    second = tr.serve_metrics()
    try:
        assert first._thread is None and first._server is None
        assert [t.name for t in _server_threads(before)] == [
            f"introspection:{second.port}"]
        ids = np.random.RandomState(0).randint(0, 256, (2, 33))
        tr.step(ids[:, :-1], ids[:, 1:])
        code, body = _get(second.url("/records?type=step"))
        assert code == 200 and [r["step"] for r in json.loads(body)] == [0]
    finally:
        tr.stop_metrics()
    assert not _server_threads(before)
    assert not any(t.name == "health-watchdog"
                   for t in set(threading.enumerate()) - before)


def test_swap_into_frees_the_old_port_and_refuses_a_closed_owner():
    """``serve_metrics``' one swap: the server before is stopped before
    the new one binds (the same fixed port binds again), and a closed
    owner stops the new server and raises."""
    owner = types.SimpleNamespace(_http_server=None, _closed=False)
    lock = threading.Lock()
    first = t_http.IntrospectionServer(t_recorder.Recorder()).swap_into(
        owner, lock)
    again = t_http.IntrospectionServer(t_recorder.Recorder(),
                                       port=first.port)
    assert again.swap_into(owner, lock) is again
    assert owner._http_server is again and first._thread is None
    with urllib.request.urlopen(again.url("/healthz"), timeout=30) as r:
        assert r.status == 200
    owner._closed = True
    late = t_http.IntrospectionServer(t_recorder.Recorder())
    with pytest.raises(RuntimeError, match="closed"):
        late.swap_into(owner, lock, RuntimeError("closed"))
    assert late._thread is None and owner._http_server is again
    again.stop()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("introspection:")]
