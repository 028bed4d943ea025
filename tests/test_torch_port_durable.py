"""Durable training, the port against the reference: LeNet-5 through
``LocalOptimizer`` on shared weights (``models.convert.from_jax_weights``)
with telemetry, checkpoints and health, and ``DistriOptimizer``'s
checkpoints under fsdp and zero1 on gloo ranks.

Tolerances: the device-side health scalars within ``rtol=1e-5`` of the
reference's ``health_scalars`` (fp32 sums of squares over the same
values in another order); a resumed run's losses within ``rtol=1e-6`` of
the reference's resumed run and its weights within ``rtol=1e-5,
atol=1e-7`` (``tests/test_torch_port_classifier.py``'s LeNet-5 limits:
XLA-CPU and ATen-CPU round convolutions differently); a same-layout
resume bitwise; a resume onto another layout or world size within
``RESHARD_REL`` of the uninterrupted run (a 2-rank mean of half-batch
gradients against one full-batch gradient).
"""
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.data.dataset import DataSet as JDataSet
from bigdl_tpu.data.minibatch import MiniBatch as JMiniBatch
from bigdl_tpu.models import lenet as JL
from bigdl_tpu.observability import InMemorySink as JSink
from bigdl_tpu.observability import Recorder as JRecorder
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocal
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.checkpoint import CheckpointManager, read_manifest
from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.data.minibatch import MiniBatch
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.observability import InMemorySink, Recorder
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.parallel.allreduce import tree_leaves

REPO = Path(__file__).resolve().parents[1]
HEALTH_REL = 1e-5
LOSS_REL = 1e-6
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-7)
RESHARD_REL = 1e-5
HEALTH_KEYS = ("grad_norm", "param_norm", "update_norm", "update_ratio",
               "nonfinite_grads")


def _data(n=48):
    rs = np.random.RandomState(0)
    x = rs.randn(n, 784).astype(np.float32)
    y = (rs.randint(0, 10, n) + 1).astype(np.float32)
    return x, y


def _models():
    jm = JL.build(10)
    params, state = jm.init_params(1)
    jm.set_params(params, state)
    tm = TL.build(10, device="cpu")
    from_jax_weights(jm.get_weights(), tm)
    return jm, tm


class _Poison:
    """Wrap a dataset: a NaN into batch ``at`` (0-based), once."""

    def __init__(self, inner, at, mb_cls):
        self.inner, self.at, self.mb_cls, self.armed = inner, at, mb_cls, True

    def data(self, train=True, epoch=None):
        for i, mb in enumerate(self.inner.data(train=train, epoch=epoch)):
            if self.armed and i == self.at:
                self.armed = False
                xx = np.array(mb.get_input())
                xx[0, 0] = np.nan
                mb = self.mb_cls(xx, mb.get_target())
            yield mb


def _ref_opt(jm, ds, iters, ck=None, poison=None, policy=None):
    sink = JSink()
    opt = (JLocal(jm, ds, jnn.ClassNLLCriterion(), batch_size=8)
           .set_optim_method(JSGD(learning_rate=0.05))
           .set_end_when(JTrigger.max_iteration(iters))
           .set_telemetry(JRecorder(sinks=[sink], annotate=False),
                          capture_cost=False))
    if ck:
        opt.set_checkpoint(ck, JTrigger.several_iteration(3))
    if policy:
        opt.set_health(policy=policy, install_crash_hooks=False)
    return opt, sink


def _port_opt(tm, ds, iters, ck=None, policy=None):
    sink = InMemorySink()
    opt = (LocalOptimizer(tm, ds, tnn.ClassNLLCriterion(), batch_size=8,
                          device="cpu")
           .set_optim_method(SGD(learning_rate=0.05))
           .set_end_when(Trigger.max_iteration(iters))
           .set_telemetry(Recorder(sinks=[sink])))
    if ck:
        opt.set_checkpoint(ck, Trigger.several_iteration(3))
    if policy:
        opt.set_health(policy=policy, install_crash_hooks=False)
    return opt, sink


def _steps(sink):
    return [r for r in sink.records if r.get("type") == "step"]


def test_health_scalars_match_the_reference():
    """LeNet-5, SGD(0.05) (K6's plain version), 6 steps at batch 8: every
    step's loss and device-side health scalars against the reference's."""
    x, y = _data()
    jm, tm = _models()
    jo, js = _ref_opt(jm, JDataSet.minibatch_arrays(x, y, 8), 6)
    jo.optimize()
    to, ts = _port_opt(tm, DataSet.minibatch_arrays(x, y, 8), 6)
    to.optimize()
    ref, port = _steps(js), _steps(ts)
    assert [r["step"] for r in port] == [r["step"] for r in ref] == \
        list(range(1, 7))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a["scalars"]["loss"],
                                   b["scalars"]["loss"], rtol=LOSS_REL)
        for k in HEALTH_KEYS:
            np.testing.assert_allclose(a["scalars"][k], b["scalars"][k],
                                       rtol=HEALTH_REL, err_msg=k)
        assert a["scalars"]["learning_rate"] == pytest.approx(0.05)
    assert port[-1]["scalars"]["nonfinite_grads"] == 0.0


def test_resumed_run_matches_the_reference_resumed_run(tmp_path):
    """Each package trains 6 steps with a checkpoint every 3, then a
    fresh optimizer resumes its own iteration-3 checkpoint (mid-epoch:
    6 batches an epoch) and trains to 10: the resumed steps' losses and
    the final weights agree, and each resume equals its package's own
    uninterrupted run."""
    x, y = _data()
    out = {}
    for who in ("ref", "port"):
        ck, resume = str(tmp_path / who), str(tmp_path / f"{who}_resume")
        jm, tm = _models()
        if who == "ref":
            opt, _ = _ref_opt(jm, JDataSet.minibatch_arrays(x, y, 8), 6, ck)
        else:
            opt, _ = _port_opt(tm, DataSet.minibatch_arrays(x, y, 8), 6, ck)
        opt.optimize()
        os.makedirs(resume)
        shutil.copytree(os.path.join(ck, "ckpt_iter_3"),
                        os.path.join(resume, "ckpt_iter_3"))
        jm, tm = _models()
        if who == "ref":
            opt, sink = _ref_opt(jm, JDataSet.minibatch_arrays(x, y, 8), 10,
                                 resume)
        else:
            opt, sink = _port_opt(tm, DataSet.minibatch_arrays(x, y, 8), 10,
                                  resume)
        opt.optimize()
        out[who] = ([r["scalars"]["loss"] for r in _steps(sink)],
                    [r["step"] for r in _steps(sink)],
                    [np.asarray(w) for w in (jm if who == "ref" else tm)
                     .get_weights()])
    assert out["port"][1] == out["ref"][1] == list(range(4, 11))
    np.testing.assert_allclose(out["port"][0], out["ref"][0], rtol=LOSS_REL)
    for a, b in zip(out["port"][2], out["ref"][2]):
        np.testing.assert_allclose(a, b, **WEIGHT_TOL)
    _, tm = _models()
    _port_opt(tm, DataSet.minibatch_arrays(x, y, 8), 10)[0].optimize()
    for a, b in zip(tm.get_weights(), out["port"][2]):
        assert np.array_equal(a.numpy(), b)


def test_rollback_gives_the_reference_step_sequence(tmp_path):
    """One NaN batch under ``policy="rollback"`` with a checkpoint every
    3 steps: both packages trip at the same step, roll back once to the
    same committed checkpoint, see the same step sequence and finish
    with finite losses."""
    x, y = _data()
    seqs = {}
    for who in ("ref", "port"):
        jm, tm = _models()
        ck = str(tmp_path / who)
        if who == "ref":
            ds = _Poison(JDataSet.minibatch_arrays(x, y, 8), 4, JMiniBatch)
            opt, sink = _ref_opt(jm, ds, 9, ck, policy="rollback")
        else:
            ds = _Poison(DataSet.minibatch_arrays(x, y, 8), 4, MiniBatch)
            opt, sink = _port_opt(tm, ds, 9, ck, policy="rollback")
        opt.optimize()
        steps = _steps(sink)
        seqs[who] = [r["step"] for r in steps]
        assert opt._health_monitor.rollbacks == 1
        k = seqs[who].index(5)
        assert not math.isfinite(steps[k]["scalars"]["loss"])
        assert all(math.isfinite(r["scalars"]["loss"])
                   for r in steps[k + 1:])
    assert seqs["port"] == seqs["ref"]
    assert seqs["port"].count(5) == 2 and seqs["port"][-1] == 9


# --------------------------------------------------------------------- #
# DistriOptimizer on gloo ranks                                          #
# --------------------------------------------------------------------- #
def _spawn(world, root, out, store):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_port_durable_rank.py"),
         str(r), str(world), str(store), str(root), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return logs


@pytest.fixture(scope="module")
def distri(tmp_path_factory):
    """World 2 (fsdp, zero1, the resumes at world 2), then world 1 (dp
    from each world-2 checkpoint)."""
    import pickle
    d = tmp_path_factory.mktemp("durable_distri")
    root = d / "root"
    root.mkdir()
    logs = _spawn(2, root, d / "w2.pkl", d / "store2")
    logs += _spawn(1, root, d / "w1.pkl", d / "store1")
    with open(d / "w2.pkl", "rb") as f:
        runs = pickle.load(f)
    with open(d / "w1.pkl", "rb") as f:
        runs.update(pickle.load(f))
    return root, runs, "\n".join(logs)


@pytest.mark.parametrize("layout", ["fsdp", "zero1"])
def test_world2_checkpoint_assembles_to_the_trained_state(distri, layout):
    """Each rank wrote a part-manifest of its fragments; rank 0 merged
    them.  ``restore_latest`` assembles the global weights and momentum,
    bitwise those the run ended with."""
    root, runs, _ = distri
    d = str(root / layout / "ckpt_iter_6")
    mf = read_manifest(d)
    assert mf.mesh == {"axes": [["dp", 2]], "devices": 2, "processes": 2}
    assert mf.meta["layout"] == layout
    assert os.path.exists(os.path.join(d, "MANIFEST.part1.json"))
    slices = {s.of for s in mf.shards if s.kind == "slices"}
    assert slices == ({"params", "opt_state"} if layout == "fsdp"
                      else {"opt_state"})
    assert {s.name for s in mf.shards} >= {"loop_rng/0", "loop_rng/1"}
    _, trees, meta = CheckpointManager(str(root / layout)).restore_latest()
    assert meta["iteration"] == 6
    params = trees["params"] if "params" in trees else {
        k[len("params/"):]: v for k, v in trees.items()
        if k.startswith("params/")}
    got = [params["fc1"]["weight"], params["fc1"]["bias"],
           params["fc2"]["weight"], params["fc2"]["bias"]]
    for a, b in zip(got, runs[layout]["weights"]):
        assert np.array_equal(a, b)
    for a, b in zip(tree_leaves(trees["opt_state"]["velocity"]),
                    runs[layout]["velocity"]):
        assert np.array_equal(a, b)


def test_reference_reads_the_fsdp_fragment_checkpoint(distri):
    """The reference's manager assembles the port's fsdp fragments (its
    skeleton and index maps) to the same arrays."""
    from bigdl_tpu.checkpoint import CheckpointManager as JManager
    root, runs, _ = distri
    _, trees, meta = JManager(str(root / "fsdp")).restore_latest()
    assert meta["iteration"] == 6
    np.testing.assert_array_equal(np.asarray(trees["params"]["fc1"]
                                             ["weight"]),
                                  runs["fsdp"]["weights"][0])


def test_same_layout_resume_is_bitwise(distri):
    """fsdp at world 2 resumed from its own iteration-3 checkpoint: the
    steps 4–6 and the final weights are the uninterrupted run's bits."""
    _, runs, _ = distri
    assert runs["fsdp_same"]["losses"] == runs["fsdp"]["losses"][3:]
    for a, b in zip(runs["fsdp_same"]["weights"], runs["fsdp"]["weights"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("run,src", [
    ("fsdp2dp", "fsdp"), ("zero12dp", "zero1"),
    ("fsdp2zero1", "fsdp"), ("zero12fsdp", "zero1")])
def test_resume_onto_another_layout_or_world(distri, run, src):
    """A world-2 fsdp or zero1 checkpoint resumes at dp world 1, and at
    the other layout at world 2: the resume says what changed, and steps
    7–9 stay within the band of the uninterrupted 9-step run."""
    _, runs, logs = distri
    assert f"resharding {src} →" in logs
    got, want = runs[run]["losses"], runs["fsdp9"]["losses"][6:]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=RESHARD_REL)
    for a, b in zip(runs[run]["weights"], runs["fsdp9"]["weights"]):
        np.testing.assert_allclose(a, b, rtol=RESHARD_REL, atol=1e-6)
