"""The port's causal trace spine and goodput ledger held against the
reference's: the same spans merge into the same Perfetto document, the
same intervals attribute to the same critical path (coverage compared
within 1e-9, not ``== 1.0``), span trees recorded through the Tracer
have the same shape, and the same ledger call sequence folds to the same
buckets within 1e-12.  Then the engines' ledgers: folded without changing
a token, and conserved."""
import json
import threading

import numpy as np
import pytest

from bigdl_tpu.observability import goodput as JG
from bigdl_tpu.observability import tracing as JX
from bigdl_tpu.observability.context import TraceContext as JCtx
from bigdl_tpu.observability.profile import TraceRing as JRing
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.observability import Recorder
from bigdl_tpu_torch.observability import goodput as TG
from bigdl_tpu_torch.observability import tracing as TX
from bigdl_tpu_torch.observability.context import TraceContext as TCtx
from bigdl_tpu_torch.observability.profile import TraceRing as TRing
from bigdl_tpu_torch.serving import DecodeEngine, ModelRegistry

EXACT = 1e-12


def _hex(i, n):
    return f"{i:0{n}x}"


def _spans(X, Ctx):
    """A fixed forest: two traces, nested spans, a causal link, a point."""
    root_a = Ctx(_hex(1, 32), _hex(1, 16))
    root_b = Ctx(_hex(2, 32), _hex(2, 16))
    a1 = Ctx(root_a.trace_id, _hex(3, 16), root_a.span_id)
    a2 = Ctx(root_a.trace_id, _hex(4, 16), a1.span_id)
    return [
        X.Span("rs.admit", root_a, 1.0, 1.5, subsystem="replicaset",
               args={"rows": 3}),
        X.Span("dispatch", a1, 1.5, 3.0, subsystem="replicaset"),
        X.Span("compute", a2, 1.75, 2.5, subsystem="serving",
               links=[(root_b.trace_id, root_b.span_id, "causes")]),
        X.Span("stream.publish", root_b, 0.5, 4.0, subsystem="stream"),
        X.Span("rs.failover", Ctx(root_b.trace_id, _hex(5, 16),
                                  root_b.span_id), 2.0, 2.0),
    ]


def _ring(Ring, Ctx):
    ring = Ring(8)
    tr = ring.new_trace("lm", ctx=Ctx(_hex(9, 32), _hex(9, 16)))
    tr.add_span("admit", 1.0, 1.25)
    tr.add_span("prefill", 1.25, 2.0, bucket=16)
    tr.add_span("token", 2.0, 2.0)
    tr.meta["tokens"] = 1
    ring.finish(tr)
    return ring


def test_merge_perfetto_equal():
    want = JX.merge_perfetto(
        [("set", _spans(JX, JCtx)), ("replica0", _ring(JRing, JCtx))],
        extra_meta={"run": 1})
    got = TX.merge_perfetto(
        [("set", _spans(TX, TCtx)), ("replica0", _ring(TRing, TCtx))],
        extra_meta={"run": 1})
    assert json.loads(got) == json.loads(want)
    assert TX.spans_from_chrome(got) == JX.spans_from_chrome(want)


@pytest.mark.parametrize("case", [
    [("a", 0.0, 1.0), ("b", 0.25, 0.5), ("c", 0.75, 2.0)],
    [("a", 0.0, 1.0), ("b", 2.0, 3.0)],                # a gap: untraced
    [("x", 1.0, 1.0)],
    [],
    [("outer", 0.0, 10.0), ("mid", 1.0, 9.0), ("in", 2.0, 3.0),
     ("in", 4.0, 8.5), ("late", 8.0, 12.0)],
])
def test_critical_path_equal(case):
    want = JX.critical_path(case)
    got = TX.critical_path(case)
    assert got["attribution"].keys() == want["attribution"].keys()
    for k, v in want["attribution"].items():
        assert abs(got["attribution"][k] - v) <= 1e-9
    assert abs(got["total"] - want["total"]) <= 1e-9
    assert abs(got["coverage"] - want["coverage"]) <= 1e-9


def _tree(X, tracer):
    """Record one request's spans through a Tracer: begin/end across a
    thread, a context-manager span, an event and a link; return the tree
    as (name, parent name, subsystem, args, n links) with ids mapped."""
    root = tracer.begin("rs.admit", subsystem="replicaset")
    done = threading.Event()

    def worker(h):
        with tracer.span("compute", h.context, subsystem="serving") as s:
            s.link(root.context)
        h.end(rows=2)
        done.set()

    hop = tracer.begin("dispatch", root.context)
    threading.Thread(target=worker, args=(hop,)).start()
    done.wait(10)
    tracer.event("rs.failover", root.context, subsystem="replicaset",
                 attempt=1)
    root.end(model="m")
    spans = tracer.store.spans()
    by_id = {s.context.span_id: s.name for s in spans}
    assert len({s.trace_id for s in spans}) == 1
    return sorted((s.name, by_id.get(s.context.parent_span_id),
                   s.subsystem, json.dumps(s.args, sort_keys=True),
                   len(s.links)) for s in spans)


def test_span_trees_equal_and_default_tracer():
    assert _tree(TX, TX.Tracer()) == _tree(JX, JX.Tracer())
    mine = TX.Tracer(capacity=2)
    prev = TX.set_tracer(mine)
    try:
        assert TX.get_tracer() is mine
        for i in range(3):
            TX.get_tracer().event(f"e{i}")
        assert len(mine.store) == 2 and mine.store.dropped == 1
    finally:
        TX.set_tracer(prev)
    assert TX.get_tracer() is prev
    ctx = TCtx.new_root()
    TX.note_actuation("job", ctx)
    assert TX.take_actuation("job") == ctx and TX.take_actuation("job") is None


# --------------------------------------------------------------------- #
# goodput ledger                                                        #
# --------------------------------------------------------------------- #
def _fold(G):
    t = [100.0]
    led = G.GoodputLedger(name="job", devices=2, clock=lambda: t[0])
    trail = []
    t[0] = 100.5
    led.note_step_begin()
    t[0] = 101.0
    led.fold_step(0.4, {"data_fetch": 0.1, "serving.compile": 0.05,
                        "unknown": 9.0})
    t[0] = 101.3
    with led.phase("failover"):
        t[0] = 101.9
        with led.phase("probe_readmission"):
            t[0] = 102.0
        t[0] = 102.2
    trail.append(led.snapshot()["buckets"])
    led.declare("brownout")
    t[0] = 103.0
    led.fold_split({"goodput": 3, "queue_wait": 1, "idle": 4})
    led.set_devices(1)
    t[0] = 103.7
    led.fold_split({"goodput": 0, "idle": 0})      # -> the background
    led.declare("idle", now=104.0)
    led.fold_step(None, now=104.5)
    t[0] = 104.25                                  # the clock went back
    led.note_step_begin()
    trail.append(led.snapshot())
    rec = {}

    class Rec:
        def gauge(self, k, v):
            rec[k] = v
    led.publish(Rec())
    return trail, rec


def test_goodput_folds_equal():
    (jt, jrec), (tt, trec) = _fold(JG), _fold(TG)
    assert TG.BUCKETS == JG.BUCKETS
    assert TG.SPAN_BUCKETS == JG.SPAN_BUCKETS
    for a, b in zip(jt[0:1], tt[0:1]):
        assert a.keys() == b.keys()
        assert all(abs(a[k] - b[k]) <= EXACT for k in a)
    ja, ta = jt[1], tt[1]
    for k in ("owned_s", "goodput_fraction", "conservation_error"):
        assert abs(ja[k] - ta[k]) <= EXACT
    assert all(abs(ja["buckets"][k] - ta["buckets"][k]) <= EXACT
               for k in ja["buckets"])
    assert ta["conservation_error"] <= EXACT
    assert trec.keys() == jrec.keys()
    assert all(abs(trec[k] - jrec[k]) <= EXACT for k in jrec)


def test_ledger_phase_without_a_ledger_is_a_no_op():
    rec = Recorder()
    assert rec.get_ledger() is None
    with TG.ledger_phase(rec, "failover"):
        pass
    with TG.ledger_phase(object(), "failover"):
        pass
    led = TG.GoodputLedger()
    assert rec.set_ledger(led) is rec and rec.get_ledger() is led


def test_decode_engine_ledger_folds_without_changing_tokens():
    """The engine's ledger folds prefills, steps (by occupancy) and warmup
    into their buckets and conserves; the tokens are those of the engine
    with its ledger detached (the folds are host arithmetic only)."""
    tm = TT.build("tiny", device="cpu", n_layers=2, max_len=128)
    geo = dict(slots=4, page_size=8, max_context=32, max_prompt=16,
               max_new_tokens=6)
    prompts = [np.random.RandomState(i).randint(0, 256, 5 + i)
               .astype(np.int32) for i in range(6)]
    outs = []
    for keep in (True, False):
        reg = ModelRegistry()
        reg.register("lm", tm)
        rec = Recorder()
        if not keep:
            rec.set_ledger(None)
            rec.get_ledger = lambda: None      # the engine installs none
        eng = DecodeEngine(reg, "lm", recorder=rec, **geo).warmup()
        try:
            outs.append([f.result(60) for f in
                         [eng.submit("lm", p) for p in prompts]])
        finally:
            eng.shutdown()
        if keep:
            snap = rec.get_ledger().snapshot()
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    b = snap["buckets"]
    assert snap["name"] == "decode:lm" and snap["devices"] == 1
    assert b["goodput"] > 0 and b["compile_warmup"] > 0
    assert snap["conservation_error"] <= 1e-9
    assert set(k for k, v in b.items() if v) <= {
        "goodput", "compile_warmup", "queue_wait", "idle"}
