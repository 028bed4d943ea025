"""The port's checkpoint package (``bigdl_tpu_torch.checkpoint``) against
the reference's (``bigdl_tpu.checkpoint``): the scenarios of
``tests/test_checkpoint.py`` run on the port's manager and optimizer
(atomic manifests, CRC fallback, retention, async off the step loop,
preemption, the optimizer's resume), files crossing both ways (a port
checkpoint through the reference's ``verify``, ``read_manifest``,
``load_state_file``, ``CheckpointManager`` and ``scripts/ckpt_inspect.py``;
a reference checkpoint through the port's ``restore_latest``), and the
snapshot that must own its memory while the parameters change in place.

The subprocess kill tests are in ``test_torch_port_ckpt_faults.py``.
"""
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.checkpoint import (CheckpointError, CheckpointManager,
                                        PreemptionHandler, faults,
                                        host_snapshot, read_manifest,
                                        reshard, scan, verify)
from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.observability import InMemorySink, Recorder
from bigdl_tpu_torch.optim import SGD, Adam, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils import serializer as tser


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.set_plan(None)
    yield
    faults.set_plan(None)


def _tree(i):
    return {"w": np.full((4, 3), float(i), np.float32),
            "b": np.arange(3, dtype=np.float32) + i}


def _save_n(mgr, n, **meta_extra):
    for i in range(n):
        mgr.save({"params/fc": _tree(i), "opt_state": {"step": i}},
                 dict({"iteration": i, "epoch": 1}, **meta_extra),
                 tag=f"iter_{i}")
    mgr.wait()


# --------------------------------------------------------------------- #
# manifest commit protocol                                               #
# --------------------------------------------------------------------- #
def test_manifest_roundtrip_and_latest_pointer(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root)
    _save_n(mgr, 3)
    kind, trees, meta = mgr.restore_latest()
    assert kind == "manifest"
    assert meta["iteration"] == 2
    np.testing.assert_array_equal(trees["params/fc"]["w"], _tree(2)["w"])
    assert open(os.path.join(root, "latest")).read() == "ckpt_iter_2"
    mf = read_manifest(os.path.join(root, "ckpt_iter_2"))
    assert {s.name for s in mf.shards} == {"params/fc", "opt_state"}
    assert not verify(os.path.join(root, "ckpt_iter_2"), mf, deep=True)


def test_checkpoint_without_manifest_does_not_exist(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root)
    _save_n(mgr, 2)
    os.remove(os.path.join(root, "ckpt_iter_1", "MANIFEST.json"))
    assert [os.path.basename(d) for d, _ in scan(root)] == ["ckpt_iter_0"]
    _, _, meta = mgr.restore_latest()
    assert meta["iteration"] == 0


def test_crc_detects_flipped_byte_and_falls_back(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root)
    _save_n(mgr, 2)
    newest = os.path.join(root, "ckpt_iter_1")
    shard = os.path.join(newest, read_manifest(newest).shards[0].file)
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0x01        # same length, one bit off
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    assert verify(newest, read_manifest(newest), deep=True)
    _, _, meta = mgr.restore_latest()
    assert meta["iteration"] == 0
    assert mgr._rec().counter_value("checkpoint/verify_retries") == 1


def test_truncated_shard_falls_back(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root)
    _save_n(mgr, 2)
    newest = os.path.join(root, "ckpt_iter_1")
    shard = os.path.join(newest, read_manifest(newest).shards[0].file)
    blob = open(shard, "rb").read()
    with open(shard, "wb") as f:
        f.write(blob[: len(blob) // 2])
    _, _, meta = mgr.restore_latest()
    assert meta["iteration"] == 0


def test_dangling_and_corrupt_latest_pointer(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root)
    _save_n(mgr, 2)
    with open(os.path.join(root, "latest"), "w") as f:
        f.write("ckpt_iter_99999")              # dangling
    assert mgr.restore_latest()[2]["iteration"] == 1
    with open(os.path.join(root, "latest"), "wb") as f:
        f.write(b"\x00\xff garbage")            # corrupt
    assert mgr.restore_latest()[2]["iteration"] == 1
    os.remove(os.path.join(root, "latest"))     # missing entirely
    assert mgr.restore_latest()[2]["iteration"] == 1


def test_restore_on_empty_root(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore_latest() is None


def test_exotic_leaves_fall_back_to_pickle_shard(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"opt_state": {"blob": b"\x00raw", "n": 3}}, {"iteration": 0},
             tag="iter_0", sync=True)
    _, trees, _ = mgr.restore_latest()
    assert trees["opt_state"]["blob"] == b"\x00raw"


@pytest.mark.parametrize("spec,site", [
    ("ckpt.shard_write:err:EIO@0", "ckpt.shard_write"),
    ("ckpt.manifest:err:ENOSPC@0", "ckpt.manifest")])
def test_transient_write_errors_retry_through_the_fault_plane(tmp_path,
                                                              spec, site):
    """The ``BIGDL_FAULT`` write sites: one transient error at a shard or
    the manifest is retried and the checkpoint commits."""
    from bigdl_tpu_torch import faults as plane
    plane.reset()
    plane.arm(spec)
    try:
        rec = Recorder()
        mgr = CheckpointManager(str(tmp_path), recorder_fn=lambda: rec)
        _save_n(mgr, 1)
        assert plane.injected_total(site) == 1
        assert rec.counter_value("retry/attempts.ckpt") == 1
        assert rec.counter_value("checkpoint/committed") == 1
        assert mgr.restore_latest()[2]["iteration"] == 0
    finally:
        plane.reset()


def test_corrupt_write_is_caught_by_the_crc(tmp_path):
    """``corrupt`` flips a shard's tail after its CRC was taken: the
    checkpoint commits but never verifies, and resume falls back."""
    from bigdl_tpu_torch import faults as plane
    mgr = CheckpointManager(str(tmp_path))
    _save_n(mgr, 1)
    plane.reset()
    plane.arm("ckpt.shard_write:corrupt:4@0")
    try:
        mgr.save({"params/fc": _tree(1)}, {"iteration": 1}, tag="iter_1",
                 sync=True)
    finally:
        plane.reset()
    d = os.path.join(str(tmp_path), "ckpt_iter_1")
    assert any("CRC32C" in p for p in verify(d, read_manifest(d)))
    assert mgr.restore_latest()[2]["iteration"] == 0


# --------------------------------------------------------------------- #
# retention                                                              #
# --------------------------------------------------------------------- #
def test_retention_keep_last_n(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep_last=2)
    _save_n(mgr, 5)
    kept = sorted(d for d in os.listdir(root) if d.startswith("ckpt_"))
    assert kept == ["ckpt_iter_3", "ckpt_iter_4"]


def test_retention_keeps_every_m_epochs(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep_last=1, keep_every_epochs=2)
    for ep in range(1, 6):
        mgr.save({"params/fc": _tree(ep)},
                 {"iteration": ep * 10, "epoch": ep, "epoch_boundary": True},
                 tag=f"epoch_{ep}")
    mgr.wait()
    kept = sorted(d for d in os.listdir(root) if d.startswith("ckpt_"))
    assert kept == ["ckpt_epoch_2", "ckpt_epoch_4", "ckpt_epoch_5"]


def test_gc_removes_torn_directories(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "ckpt_torn"))
    with open(os.path.join(root, "ckpt_torn", "shard0000.bin"), "wb") as f:
        f.write(b"half a shard")
    mgr = CheckpointManager(root, keep_last=3)
    _save_n(mgr, 1)
    assert not os.path.exists(os.path.join(root, "ckpt_torn"))
    assert os.path.exists(os.path.join(root, "ckpt_iter_0"))


def test_multi_host_part_manifest_merge(tmp_path):
    """Two writers: round-robin shard ownership by sorted name, a part
    manifest each, writer 0 merges them into the one commit."""
    root = str(tmp_path)
    trees = {"params/a": _tree(1), "params/b": _tree(2),
             "params/c": _tree(3), "opt_state": {"step": 7}}
    meta = {"iteration": 7, "epoch": 1}
    h1 = CheckpointManager(root, process_index=1, process_count=2,
                           async_write=False)
    h0 = CheckpointManager(root, process_index=0, process_count=2,
                           async_write=False, part_timeout=10)
    h1.save(trees, meta, tag="iter_7")
    d = os.path.join(root, "ckpt_iter_7")
    assert os.path.exists(os.path.join(d, "MANIFEST.part1.json"))
    assert not os.path.exists(os.path.join(d, "MANIFEST.json"))
    h0.save(trees, meta, tag="iter_7")
    mf = read_manifest(d)
    assert {s.name for s in mf.shards} == set(trees)
    assert not verify(d, mf, deep=True)
    _, restored, rmeta = h0.restore_latest()
    assert rmeta["iteration"] == 7
    np.testing.assert_array_equal(restored["params/b"]["w"], _tree(2)["w"])
    assert int(restored["opt_state"]["step"]) == 7


# --------------------------------------------------------------------- #
# the snapshot owns its memory                                           #
# --------------------------------------------------------------------- #
def test_host_snapshot_owns_its_memory():
    """``t.cpu()`` of a CPU tensor is the tensor and ``.numpy()`` shares
    its storage: the snapshot must be a copy, whatever the leaf."""
    t = torch.arange(6, dtype=torch.float32)
    a = np.arange(3, dtype=np.float32)
    snap = host_snapshot({"t": t, "a": a, "n": 3, "s": [t]})
    t.add_(100.0)
    a += 100.0
    np.testing.assert_array_equal(snap["t"], np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(snap["a"], np.arange(3, dtype=np.float32))
    np.testing.assert_array_equal(snap["s"][0], np.arange(6,
                                                          dtype=np.float32))
    assert snap["n"] == 3


def test_in_place_update_after_save_leaves_the_committed_shard_old(
        tmp_path):
    """The C4 hazard class: the port updates its parameters in place.
    A save whose write is still queued (every shard write delayed) must
    commit the values of the moment it was called, not those written
    into the same tensors after it returned."""
    faults.set_plan("sleep:80")
    p = torch.full((5, 4), 1.0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"params/fc": host_snapshot({"weight": p})}, {"iteration": 1},
             tag="iter_1")
    p.mul_(7.0)                            # the next step, in place
    mgr.save({"params/fc": host_snapshot({"weight": p})}, {"iteration": 2},
             tag="iter_2")
    p.fill_(-1.0)
    mgr.wait()
    faults.set_plan(None)
    for it, want in ((1, 1.0), (2, 7.0)):
        path = os.path.join(str(tmp_path), f"ckpt_iter_{it}")
        shard = read_manifest(path).shards[0].file
        got = tser.load_state_file(os.path.join(path, shard))
        np.testing.assert_array_equal(got["weight"], np.full((5, 4), want,
                                                             np.float32))


# --------------------------------------------------------------------- #
# the optimizer                                                          #
# --------------------------------------------------------------------- #
def _training_parts(seed=11):
    rng = np.random.RandomState(0)
    x = rng.randn(128, 10).astype(np.float32)
    w = rng.randn(10, 1).astype(np.float32)
    y = (x @ w).astype(np.float32)
    ds = DataSet.minibatch_arrays(x, y, batch_size=32, shuffle=True, seed=4)
    model = nn.Sequential(nn.Linear(10, 8, name="fc1"), nn.Tanh(),
                          nn.Linear(8, 1, name="fc2"))
    wr = np.random.RandomState(seed)
    model.set_weights([wr.randn(*t.shape).astype(np.float32) * 0.3
                       for t in model.get_weights()])
    return model, ds


def _opt(model, ds, iters, **ckpt):
    opt = (LocalOptimizer(model, ds, nn.MSECriterion(), batch_size=32,
                          device="cpu")
           .set_optim_method(Adam(learning_rate=1e-2))
           .set_end_when(Trigger.max_iteration(iters)))
    if ckpt:
        opt.set_checkpoint(**ckpt)
    return opt


def test_async_write_is_off_the_step_loop(tmp_path):
    """``checkpoint.blocking`` covers the device→host copy (and writer
    backpressure) only; the slowed serialize and write run on the writer
    thread while steps keep completing."""
    model, ds = _training_parts()
    sink = InMemorySink()
    rec = Recorder(sinks=[sink])
    faults.set_plan("sleep:60")          # 60 ms a shard write, no kill
    opt = _opt(model, ds, 12, path=str(tmp_path / "ck"),
               trigger=Trigger.several_iteration(5)).set_telemetry(
                   rec, health=False)
    opt.optimize()
    steps = sink.steps()
    assert len(steps) == 12
    blocking = [s["spans"]["checkpoint.blocking"] for s in steps
                if "checkpoint.blocking" in s.get("spans", {})]
    assert len(blocking) == 2            # triggers at iterations 5, 10
    write_s = rec.counter_value("checkpoint/write_seconds")
    assert write_s >= 0.2
    assert sum(blocking) < write_s / 2
    assert rec.counter_value("checkpoint/committed") == 2
    assert rec.counter_value("checkpoint/bytes_written") > 0
    for part in ("encode", "crc", "io", "commit", "d2h"):
        assert rec.counter_value(f"checkpoint/{part}_seconds") > 0, part
    assert any(s["gauges"].get("checkpoint/in_flight", 0) >= 1
               for s in steps)
    assert len(scan(str(tmp_path / "ck"))) == 2
    # the post-drain summary carries the commits after the last record
    summary = [r for r in sink.records if r["type"] == "checkpoint_summary"]
    assert summary[-1]["counters"]["checkpoint/committed"] == 2
    # the goodput ledger booked the blocking copies
    assert steps[-1]["gauges"]["goodput/checkpoint_blocking_s"] > 0


def test_async_failure_does_not_kill_training(tmp_path):
    model, ds = _training_parts()
    opt = _opt(model, ds, 8, path=str(tmp_path / "ck"),
               trigger=Trigger.several_iteration(4))
    mgr = opt._ckpt_mgr

    def broken(trees, meta, tag, **kw):
        raise OSError("disk on fire")
    mgr._write_manifest_ckpt = broken
    opt.optimize()                       # must complete
    assert isinstance(mgr.writer.last_error, OSError)
    assert opt.recorder.counter_value("checkpoint/failed") == 2


def test_preemption_handler_flag():
    h = PreemptionHandler().install()
    try:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if h.requested:
                break
            time.sleep(0.01)
        assert h.requested
    finally:
        h.uninstall()


def test_optimizer_preemption_emits_final_checkpoint(tmp_path):
    """SIGTERM mid-run: the optimizer finishes the in-flight write,
    commits a final checkpoint, and optimize() returns; a resumed run
    continues from the preemption point to the uninterrupted run's
    weights, bitwise."""
    model, ds = _training_parts()
    ck = str(tmp_path / "ck")
    end = Trigger.max_epoch(50)

    class _KillAt6(Trigger):
        def __call__(self, state):
            if state.iteration == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            return end(state)
    opt = _opt(model, ds, 1, path=ck, trigger=Trigger.several_iteration(4),
               handle_preemption=True).set_end_when(_KillAt6())
    try:
        opt.optimize()                   # returns instead of dying
    finally:
        opt._preemption.uninstall()
    assert opt.state.iteration == 7      # the flag is read a step later
    newest = scan(ck)[-1][1]
    assert newest.tag == "preempt_iter_7"
    assert newest.meta["iteration"] == 7
    assert newest.meta["batch_in_epoch"] == 3
    resumed, _ = _training_parts()
    _opt(resumed, ds, 12, path=ck).optimize()
    ref, _ = _training_parts()
    _opt(ref, ds, 12).optimize()
    for a, b in zip(resumed.get_weights(), ref.get_weights()):
        assert torch.equal(a, b)


def test_optimizer_resume_skips_torn_newest(tmp_path):
    model, ds = _training_parts()
    ck = str(tmp_path / "ck")
    _opt(model, ds, 8, path=ck, trigger=Trigger.several_iteration(4)) \
        .optimize()
    dirs = sorted(d for d in os.listdir(ck) if d.startswith("ckpt_"))
    assert "ckpt_iter_4" in dirs and "ckpt_iter_8" in dirs
    mf = read_manifest(os.path.join(ck, "ckpt_iter_8"))
    with open(os.path.join(ck, "ckpt_iter_8", mf.shards[0].file),
              "wb") as f:
        f.write(b"torn")
    model2, ds2 = _training_parts()
    opt2 = _opt(model2, ds2, 12, path=ck)
    opt2.optimize()
    assert opt2.state.iteration == 12    # resumed from iter_4 and ran on


def test_file_layout_pointer_recovery(tmp_path):
    model, ds = _training_parts()
    ck = str(tmp_path / "ck")
    _opt(model, ds, 8, path=ck, trigger=Trigger.several_iteration(4),
         layout="file").optimize()
    assert os.path.isfile(os.path.join(ck, "checkpoint_iter_8.bin"))
    with open(os.path.join(ck, "latest"), "w") as f:
        f.write(os.path.join(ck, "checkpoint_iter_9999.bin"))  # dangling
    model2, ds2 = _training_parts()
    opt2 = _opt(model2, ds2, 12, path=ck, layout="file")
    opt2.optimize()
    assert opt2.state.iteration == 12


def test_restore_into_a_model_with_other_names_raises(tmp_path):
    """A restore whose keys do not match the model's never loads
    nothing: it raises, naming the leaves."""
    model, ds = _training_parts()
    ck = str(tmp_path / "ck")
    _opt(model, ds, 4, path=ck, trigger=Trigger.several_iteration(4)) \
        .optimize()
    other = nn.Sequential(nn.Linear(10, 8, name="enc"), nn.Tanh(),
                          nn.Linear(8, 1, name="fc2"))
    with pytest.raises(CheckpointError, match="do not match the model"):
        _opt(other, ds, 8, path=ck).optimize()
    wide = nn.Sequential(nn.Linear(10, 16, name="fc1"), nn.Tanh(),
                         nn.Linear(16, 1, name="fc2"))
    with pytest.raises(CheckpointError, match=r"fc1/weight: saved \(8, 10\)"
                                              r", model \(16, 10\)"):
        _opt(wide, ds, 8, path=ck).optimize()
    same, _ = _training_parts()          # Adam's state into SGD's
    with pytest.raises(CheckpointError, match="optimizer state do not"):
        _opt(same, ds, 8, path=ck).set_optim_method(
            SGD(0.1, momentum=0.9)).optimize()


def test_optim_method_save_load_roundtrip(tmp_path):
    m = SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    m.save(str(tmp_path / "sgd.bin"))
    back = SGD.load(str(tmp_path / "sgd.bin"))
    assert type(back) is SGD
    assert (back.lr, back.momentum, back.dampening, back.weight_decay) == \
        (0.1, 0.9, 0.9, 1e-4)
    with pytest.raises(FileExistsError):
        m.save(str(tmp_path / "sgd.bin"), overwrite=False)


# --------------------------------------------------------------------- #
# files crossing between the packages                                   #
# --------------------------------------------------------------------- #
def _port_training_dir(tmp_path):
    model, ds = _training_parts()
    ck = str(tmp_path / "port_ck")
    opt = _opt(model, ds, 6, path=ck, trigger=Trigger.several_iteration(3))
    opt.optimize()
    return ck, model, opt


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    """A checkpoint the port's optimizer wrote passes the reference's
    ``verify`` and ``read_manifest``; each shard loads through its
    ``load_state_file``, and its manager restores the trained weights
    and Adam state, equal arrays."""
    from bigdl_tpu.checkpoint import CheckpointManager as JManager
    from bigdl_tpu.checkpoint import manifest as jmanifest
    from bigdl_tpu.utils.serializer import load_state_file as jload
    ck, model, opt = _port_training_dir(tmp_path)
    d = os.path.join(ck, "ckpt_iter_6")
    mf = jmanifest.read_manifest(d)
    assert jmanifest.verify(d, mf, deep=True) == []
    assert mf.meta["iteration"] == 6 and mf.meta["layout"] == "local"
    for s in mf.shards:
        mine = tser.load_state_file(os.path.join(d, s.file))
        theirs = jload(os.path.join(d, s.file))
        for a, b in zip(_leaves(mine), _leaves(theirs)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, trees, meta = JManager(ck).restore_latest()
    np.testing.assert_array_equal(np.asarray(trees["params/fc1"]["weight"]),
                                  model.get_weights()[0].numpy())
    np.testing.assert_array_equal(
        np.asarray(trees["opt_state"]["m"]["fc2"]["bias"]),
        opt.opt_state["m"]["fc2"]["bias"].numpy())
    assert int(np.asarray(trees["opt_state"]["step"])) == 6


def test_ckpt_inspect_reads_a_port_checkpoint(tmp_path, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(os.path.dirname(__file__), "..",
                                     "scripts", "ckpt_inspect.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ck, _, _ = _port_training_dir(tmp_path)
    capsys.readouterr()
    assert tool.main(["verify", ck, "--json"]) in (0, None)
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True
    tool.main(["list", ck, "--json"])
    listed = json.loads(capsys.readouterr().out)
    assert [c["tag"] for c in listed["checkpoints"]] == ["iter_3", "iter_6"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's manager writes whole trees (and the reference's
    ``split_fragments`` slices of a sharded-looking jax array); the
    port's ``restore_latest`` reads both to equal numpy arrays."""
    import jax.numpy as jnp
    from bigdl_tpu.checkpoint import CheckpointManager as JManager
    from bigdl_tpu.checkpoint import reshard as jreshard
    root = str(tmp_path)
    rng = np.random.RandomState(3)
    tree = {"fc": {"weight": rng.randn(4, 3).astype(np.float32),
                   "bias": rng.randn(3).astype(np.float32)},
            "step": np.int32(5)}
    frag = jreshard.split_fragments({"w": jnp.array(tree["fc"]["weight"]),
                                     "b": jnp.arange(5.0)})
    jm = JManager(root)
    jm.save({"params/fc": tree["fc"], "opt_state": {"step": tree["step"]},
             "frag": frag}, {"iteration": 5, "epoch": 1}, tag="iter_5",
            sync=True)
    _, trees, meta = CheckpointManager(root).restore_latest()
    assert meta["iteration"] == 5
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(trees["params/fc"][k], tree["fc"][k])
    assert int(trees["opt_state"]["step"]) == 5
    np.testing.assert_array_equal(trees["frag"]["w"], tree["fc"]["weight"])
    np.testing.assert_array_equal(trees["frag"]["b"], np.arange(5.0))


def test_reference_optimizer_checkpoint_restores_in_the_port(tmp_path):
    """A directory the reference's ``LocalOptimizer`` checkpointed into
    restores through the port's manager to the reference's arrays."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.data.dataset import DataSet as JDataSet
    from bigdl_tpu.optim import Adam as JAdam
    from bigdl_tpu.optim import LocalOptimizer as JLocal
    from bigdl_tpu.optim import Trigger as JTrigger
    rng = np.random.RandomState(0)
    x = rng.randn(64, 10).astype(np.float32)
    y = x[:, :1].copy()
    jm = jnn.Sequential(jnn.Linear(10, 4, name="fc1"), jnn.Tanh(),
                        jnn.Linear(4, 1, name="fc2"))
    jm.reset(11)
    ck = str(tmp_path / "ck")
    (JLocal(jm, JDataSet.minibatch_arrays(x, y, 32, seed=4),
            jnn.MSECriterion(), batch_size=32)
     .set_optim_method(JAdam(learning_rate=1e-2))
     .set_end_when(JTrigger.max_iteration(2))
     .set_checkpoint(ck, JTrigger.several_iteration(2))).optimize()
    _, trees, meta = CheckpointManager(ck).restore_latest()
    assert meta["iteration"] == 2
    for mod in ("fc1", "fc2"):
        for k, v in jm._params[mod].items():
            np.testing.assert_array_equal(trees[f"params/{mod}"][k],
                                          np.asarray(v))


def test_state_files_cross_both_ways(tmp_path):
    """The state-file container is the reference's: each package loads
    the other's file to equal arrays, tuples and scalars."""
    from bigdl_tpu.utils import serializer as jser
    rng = np.random.RandomState(1)
    tree = {"a": rng.randn(3, 2).astype(np.float32),
            "t": (np.int32(4), [1.5, "x"]), "nested": {"i": np.arange(4)}}
    tser.save_state_file({**tree, "tensor": torch.ones(2)},
                         str(tmp_path / "port.bin"))
    back = jser.load_state_file(str(tmp_path / "port.bin"))
    np.testing.assert_array_equal(np.asarray(back["a"]), tree["a"])
    np.testing.assert_array_equal(np.asarray(back["tensor"]), np.ones(2))
    assert back["t"][1] == [1.5, "x"]
    jser.save_state_file(tree, str(tmp_path / "ref.bin"))
    mine = tser.load_state_file(str(tmp_path / "ref.bin"))
    np.testing.assert_array_equal(mine["a"], tree["a"])
    assert isinstance(mine["t"], tuple) and int(mine["t"][0]) == 4
    np.testing.assert_array_equal(mine["nested"]["i"], np.arange(4))
    with pytest.raises(tser.SerializationError):
        tser.state_file_bytes({"f": lambda: 0})
    with open(tmp_path / "junk.bin", "wb") as f:
        f.write(b"PK\x03\x04 not a zip")
    with pytest.raises(tser.SerializationError):
        tser.load_state_file(str(tmp_path / "junk.bin"))


def test_fragments_assemble_and_refuse_missing_coverage():
    """The port's fragments: row blocks and flat ranges of a leaf from
    two writers assemble to the global arrays; a writer's missing
    fragments raise instead of restoring zeros."""
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    b = np.arange(5, dtype=np.float32)
    parts = []
    for r in range(2):
        tree = {"w": reshard.Pieces(w.shape, w.dtype, [(
                    [[3 * r, 3 * r + 3], [0, 4]], w[3 * r:3 * r + 3])]),
                "b": reshard.Pieces([5], b.dtype, [(
                    [[3 * r, min(5, 3 * r + 3)]], b[3 * r:3 * r + 3])],
                    reshape=[5]),
                "step": np.int32(3)}
        parts.append(reshard.split_fragments(tree, r))
    out = reshard.assemble(parts)
    np.testing.assert_array_equal(out["w"], w)
    np.testing.assert_array_equal(out["b"], b)
    assert int(out["step"]) == 3
    with pytest.raises(CheckpointError, match="incomplete fragment"):
        reshard.assemble(parts[:1])
    msg = reshard.describe_delta(
        {"axes": [["dp", 2]], "devices": 2, "processes": 2},
        {"axes": [["dp", 1]], "devices": 1, "processes": 1})
    assert "dp 2→1" in msg
    assert "LOCAL" in reshard.explain_shape_delta(
        (3, 4), (6, 4), {"axes": [["dp", 2]], "devices": 2}, None)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
