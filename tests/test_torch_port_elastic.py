"""The elastic supervisor and its mesh planner (``bigdl_tpu_torch/elastic``)
against the reference's (``bigdl_tpu/elastic``).

The planner's pure functions must equal the reference's over a grid of
templates and capacities.  The supervisor runs each segment as gloo rank
processes (``tests/_torch_port_elastic_rank.py``'s factory, a cut
TransformerLM ``tiny`` under Adam) and must pass the reference's five
scenarios (``tests/test_elastic.py``): shrink 4→2 and regrow, a regrow
during the drain deferred to the next planning cycle, a SIGTERM shrink,
retries then raise, and a hang abort that replans.  Losses: a segment on
another mesh sums the same global batch's gradients in another order,
so resumed losses stay within ``RESHARD_REL`` of an uninterrupted run
(the reference's reshard tests' band for dp re-layouts); a resume on
the same mesh is bitwise.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest

from bigdl_tpu.elastic import plan as JP
from bigdl_tpu_torch import faults
from bigdl_tpu_torch.checkpoint import reshard, scan
from bigdl_tpu_torch.elastic import ElasticSupervisor, plan as TP
from bigdl_tpu_torch.observability import InMemorySink, Recorder

import _torch_port_elastic_rank as R

RESHARD_REL = 1e-4

TEMPLATES = [{"dp": 8}, {"dp": 4, "tp": 2}, {"dp": 6, "tp": 4},
             {"dp": 2, "fsdp": 2, "sp": 2, "tp": 2}, {"pp": 2, "ep": 4},
             {"dp": 3, "sp": 3}]


@pytest.mark.parametrize("template", TEMPLATES,
                         ids=lambda t: "x".join(f"{k}{v}" for k, v in
                                                t.items()))
def test_plans_equal_the_references(template):
    for n in range(1, 26):
        for floors, costs in [(None, None), ({"tp": 2}, None),
                              (None, {"tp": 0.5, "dp": 8.0})]:
            try:
                want = JP.plan_mesh(n, template, floors, costs)
            except ValueError:
                with pytest.raises(ValueError):
                    TP.plan_mesh(n, template, floors, costs)
                continue
            got = TP.plan_mesh(n, template, floors, costs)
            assert got == want and list(got) == list(want)
            assert TP.plan_devices(got, list(range(n))) \
                == JP.plan_devices(want, list(range(n)))
            assert TP.shrink_cost(template, got, costs) \
                == JP.shrink_cost(template, want, costs)
    assert tuple(TP.SHRINK_PRIORITY) == tuple(JP.SHRINK_PRIORITY)
    with pytest.raises(ValueError):
        TP.plan_devices({"dp": 4}, [0, 1])


def _sup(tmp_path, template, **kw):
    rec = Recorder(sinks=[InMemorySink()])
    kw.setdefault("handle_sigterm", False)
    return rec, ElasticSupervisor(R.factory, str(tmp_path / "ck"), template,
                                  recorder=rec, device="cpu", **kw)


def _kinds(rec):
    return [r["kind"] for r in rec.recent_records()
            if r.get("type") == "elastic_event"]


def _uninterrupted(tmp_path, steps, template):
    _, sup = _sup(tmp_path / "u", template, capacity_fn=lambda: _prod(
        template), ckpt_every=100, replan_every=0)
    return sup.run(R.batch, steps=steps)


def _prod(t):
    return int(np.prod(list(t.values())))


def test_shrinks_and_regrows_on_capacity(tmp_path):
    cap = {"n": 4}

    def batch(s):
        if s >= 4:
            cap["n"] = 2
        if s >= 7:
            cap["n"] = 4
        return R.batch(s)

    rec, sup = _sup(tmp_path, {"dp": 4}, capacity_fn=lambda: cap["n"],
                    ckpt_every=2, replan_every=2)
    losses = sup.run(batch, steps=10)
    assert len(losses) == 10 and all(np.isfinite(losses))
    base = _uninterrupted(tmp_path, 10, {"dp": 4})
    np.testing.assert_allclose(losses, base, rtol=RESHARD_REL)
    c = rec.counter_value
    assert (c("elastic/shrinks"), c("elastic/regrows"), c("elastic/resumes"),
            c("elastic/reshards"), c("health/elastic_shrink")) \
        == (1, 1, 2, 2, 1)
    assert _kinds(rec) == ["reshard", "shrink", "resume", "reshard",
                           "regrow", "resume"]
    cands = scan(str(tmp_path / "ck"))
    assert reshard.mesh_axes(cands[-1][1].mesh) == {"dp": 4}
    # the stop() latch re-arms: a later run() keeps training
    sup.stop()
    more = sup.run(batch, steps=11)
    assert len(more) == 1 and np.isfinite(more[0])


def test_regrow_mid_drain_defers_to_next_planning_cycle(tmp_path):
    cap = {"n": 4}
    fired = {"done": False}
    reads = []

    def capacity():
        n = cap["n"]
        reads.append(n)
        if n == 2:
            cap["n"] = 4        # the regrow lands right after this read
        return n

    def batch(s):
        if s == 4 and not fired["done"]:
            fired["done"] = True
            cap["n"] = 2
        return R.batch(s)

    rec, sup = _sup(tmp_path, {"dp": 4}, capacity_fn=capacity,
                    ckpt_every=4, replan_every=2)
    losses = sup.run(batch, steps=8)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert reads.count(2) == 1
    assert _kinds(rec) == ["resume"]
    assert (rec.counter_value("elastic/shrinks"),
            rec.counter_value("elastic/regrows"),
            rec.counter_value("elastic/resumes")) == (0, 0, 1)
    # the same mesh throughout: bitwise the uninterrupted run
    assert losses == _uninterrupted(tmp_path, 8, {"dp": 4})


def test_survives_sigterm_by_shrinking(tmp_path):
    cap = {"n": 4}
    fired = {"done": False}

    def meddle():
        cap["n"] = 2
        os.kill(os.getpid(), signal.SIGTERM)

    def batch(s):
        if s == 5 and not fired["done"]:
            fired["done"] = True
            threading.Thread(target=meddle).start()
            time.sleep(0.3)     # the signal lands inside this step
        return R.batch(s)

    rec, sup = _sup(tmp_path, {"dp": 4}, capacity_fn=lambda: cap["n"],
                    ckpt_every=3, replan_every=100, handle_sigterm=True)
    losses = sup.run(batch, steps=9)
    assert len(losses) == 9 and all(np.isfinite(losses))
    assert rec.counter_value("elastic/preemptions") == 1
    assert rec.counter_value("elastic/shrinks") == 1
    tags = [mf.tag for _, mf in scan(str(tmp_path / "ck"))]
    assert any(t.startswith("preempt_step_") for t in tags), tags
    np.testing.assert_allclose(
        losses, _uninterrupted(tmp_path, 9, {"dp": 4}), rtol=RESHARD_REL)


def test_retries_with_backoff_then_raises(tmp_path):
    def bad_batch(s):
        raise RuntimeError("data plane on fire")

    rec, sup = _sup(tmp_path, {"dp": 2}, capacity_fn=lambda: 2,
                    ckpt_every=2, max_restarts=2, backoff_base=0.01)
    with pytest.raises(RuntimeError, match="on fire"):
        sup.run(bad_batch, steps=4)
    assert rec.counter_value("elastic/failures") == 3    # 2 retries + 1
    assert rec.counter_value("retry/giveups.elastic") == 1
    assert rec.counter_value("retry/attempts.elastic") == 2


def test_hang_abort_replans_instead_of_hanging(tmp_path):
    from bigdl_tpu_torch.observability.health import StallWatchdog
    rec = Recorder(sinks=[InMemorySink()])
    faults.reset()
    faults.arm("step.dispatch:delay:120000@10")      # step 10: a 2 min wedge
    wd = StallWatchdog(rec, factor=3.0, min_history=4, floor_seconds=0.6,
                       poll_interval=0.05)
    sup = ElasticSupervisor(
        R.factory, str(tmp_path / "ck"), {"dp": 2}, capacity_fn=lambda: 2,
        recorder=rec, ckpt_every=4, replan_every=100, backoff_base=0.05,
        handle_sigterm=False, hang_abort_grace=0.3, watchdog=wd,
        flight_dir=str(tmp_path / "flight"), device="cpu")
    t0 = time.time()
    try:
        losses = sup.run(R.batch, steps=14)
        fired = faults.injected_total("step.dispatch")
    finally:
        faults.reset()
    assert len(losses) == 14 and all(np.isfinite(losses))
    assert time.time() - t0 < 100
    assert fired == 1
    c = rec.counter_value
    assert c("elastic/hang_aborts") == 1 and c("health/hang_aborts") == 1
    assert c("elastic/failures") >= 1 and c("elastic/resumes") >= 1
    assert len(os.listdir(tmp_path / "flight")) == 1
    evs = [r["condition"] for r in rec.recent_records()
           if r.get("type") == "health_event"]
    assert "hang_abort" in evs
    # the replanned run resumed on the same mesh from step 8: bitwise
    assert losses == _uninterrupted(tmp_path, 14, {"dp": 2})
