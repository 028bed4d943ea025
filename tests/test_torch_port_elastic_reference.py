"""The port's ``ElasticSupervisor`` against the reference's on the same
capacity schedule, batches and initial weights: shrink 4→2 and regrow,
and a SIGTERM that shrinks (``tests/test_elastic.py``'s scenarios at dp
4).  The reference runs in this process on virtual CPU devices, the
port on gloo rank processes (``tests/_torch_port_elastic_rank.py``).
Their ``elastic_event`` kinds and ``elastic/*`` counters must be equal,
and their losses agree within ``RESHARD_REL``, the band of the
reference's reshard tests (each package sums a dp group's gradients in
its own order)."""
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest

from bigdl_tpu.elastic import ElasticSupervisor as JSupervisor
from bigdl_tpu.observability import InMemorySink as JSink
from bigdl_tpu.observability import Recorder as JRecorder
from bigdl_tpu.parallel.mesh import create_mesh
from bigdl_tpu_torch.elastic import ElasticSupervisor
from bigdl_tpu_torch.observability import InMemorySink, Recorder

import _torch_port_elastic_rank as R

RESHARD_REL = 1e-4
STEPS = 10


def _ref_factory(mesh):
    from bigdl_tpu.models import transformer as T
    from bigdl_tpu.optim import Adam
    from bigdl_tpu.parallel.spmd import SpmdTrainer
    model = T.build("tiny", dropout=0.0, **R.CFG)
    return SpmdTrainer(model, Adam(learning_rate=1e-3), mesh=mesh,
                       fsdp=False, seed=0)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's initial parameters, for the port's ranks."""
    tr = _ref_factory(create_mesh({"dp": 4}, devices=jax.devices()[:4]))
    tr.init()
    flat = {f"{mod}::{name}": np.array(v)
            for mod, sub in tr.params.items() for name, v in sub.items()}
    tr.detach()
    path = str(tmp_path_factory.mktemp("elastic_ref") / "init.npz")
    np.savez(path, **flat)
    return path


def _observed(rec):
    kinds = [r["kind"] for r in rec.recent_records()
             if r.get("type") == "elastic_event"]
    counters = {k: v for k, v in rec.snapshot()["counters"].items()
                if k.startswith("elastic/")}
    return kinds, counters


def _both(tmp_path, weights, scenario, **kw):
    """``scenario()`` gives a fresh ``(capacity, batch_fn)`` pair, the
    capacity as a count; each package runs it under ``kw``."""
    cap, batch = scenario()
    jrec = JRecorder(sinks=[JSink()], annotate=False)
    jsup = JSupervisor(_ref_factory, str(tmp_path / "ref"), {"dp": 4},
                       capacity_fn=lambda: jax.devices()[:cap()],
                       recorder=jrec, shard_arrays=True, **kw)
    want = [float(v) for v in jsup.run(batch, steps=STEPS)]
    cap, batch = scenario()
    rec = Recorder(sinks=[InMemorySink()])
    sup = ElasticSupervisor(R.Factory(weights), str(tmp_path / "port"),
                            {"dp": 4}, capacity_fn=cap, recorder=rec,
                            device="cpu", **kw)
    got = sup.run(batch, steps=STEPS)
    return (want, *_observed(jrec)), (got, *_observed(rec))


def _shrink_regrow():
    state = {"n": 4}

    def batch(s):
        if s >= 4:
            state["n"] = 2
        if s >= 7:
            state["n"] = 4
        return R.batch(s)
    return lambda: state["n"], batch


def _sigterm_shrink():
    state = {"n": 4, "fired": False}

    def meddle():
        state["n"] = 2
        os.kill(os.getpid(), signal.SIGTERM)

    def batch(s):
        if s == 5 and not state["fired"]:
            state["fired"] = True
            threading.Thread(target=meddle).start()
            time.sleep(0.3)     # the signal lands inside this step
        return R.batch(s)
    return lambda: state["n"], batch


@pytest.mark.parametrize("scenario,kw", [
    (_shrink_regrow, dict(ckpt_every=2, replan_every=2,
                          handle_sigterm=False)),
    (_sigterm_shrink, dict(ckpt_every=3, replan_every=100,
                           handle_sigterm=True)),
], ids=["shrink_regrow", "sigterm_shrink"])
def test_supervisor_matches_the_reference(tmp_path, weights, scenario, kw):
    (want, jkinds, jcounters), (got, kinds, counters) = _both(
        tmp_path, weights, scenario, **kw)
    assert kinds == jkinds
    assert counters == jcounters
    assert len(got) == len(want) == STEPS
    assert "resume" in kinds and counters["elastic/shrinks"] == 1
    np.testing.assert_allclose(got, want, rtol=RESHARD_REL)
