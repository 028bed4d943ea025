"""TensorBoard summaries in the port (``bigdl_tpu_torch.visualization``),
held against ``bigdl_tpu.visualization``: the event files of either
package are read by the other's ``read_scalar``, their records are byte
for byte the same but for the wall time, and the summaries of
``LocalOptimizer`` and ``SpmdTrainer`` hold the values the loops saw.
"""
import os
import struct

import numpy as np
import pytest

from bigdl_tpu.utils import proto as jproto
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu.visualization.event_writer import read_events as j_read_events
from bigdl_tpu.visualization.event_writer import read_scalar as j_read_scalar
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.optim import SGD, AdamW, LocalOptimizer, Loss, Trigger
from bigdl_tpu_torch.parallel import SpmdTrainer
from bigdl_tpu_torch.utils import proto
from bigdl_tpu_torch.visualization import (TrainSummary, ValidationSummary,
                                           read_events, read_scalar)

SCALARS = [("Loss", 2.5, 1), ("Loss", 1.25, 2), ("LearningRate", 0.1, 2),
           ("Loss", -3.0e-8, 7)]


def _write(summary_cls, log_dir):
    s = summary_cls(str(log_dir), "app")
    for tag, v, step in SCALARS:
        s.add_scalar(tag, v, step)
    s.add_histogram("w", np.linspace(-1, 1, 101), 3)
    s.close()
    return s.folder


def _histograms(folder):
    """(step, tag) of every histogram record."""
    out = []
    for payload in read_events(folder):
        step = 0
        for field, _, v in proto.iter_fields(payload):
            if field == 2:
                step = v
            if field != 5:
                continue
            for f2, _, value in proto.iter_fields(v):
                fields = dict((f3, v3) for f3, _, v3 in
                              proto.iter_fields(value)) if f2 == 1 else {}
                if 5 in fields:
                    out.append((step, fields[1].decode()))
    return out


def _values(rows):
    return [(step, v) for step, v, _ in rows]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_event_files_cross_between_the_packages(tmp_path, writer):
    cls = TrainSummary if writer == "port" else JTrainSummary
    folder = _write(cls, tmp_path)
    for reader in (read_scalar, j_read_scalar):
        assert _values(reader(folder, "Loss")) == [
            (1, 2.5), (2, 1.25), (7, np.float32(-3.0e-8))]
        assert _values(reader(folder, "LearningRate")) == [
            (2, np.float32(0.1))]
    assert len(read_events(folder)) == len(j_read_events(folder)) == 6


def test_records_are_the_reference_bytes_but_the_wall_time():
    hist = proto.histogram_proto(-1.0, 1.0, 3.0, 0.5, 1.5, [0.0, 1.0],
                                 [1, 2])
    assert hist == jproto.histogram_proto(-1.0, 1.0, 3.0, 0.5, 1.5,
                                          [0.0, 1.0], [1, 2])
    for kw in (dict(file_version="brain.Event:2"),
               dict(summary_values=[proto.summary_value_scalar("x", 0.5),
                                    proto.summary_value_histo("h", hist)])):
        assert proto.event(12.5, 3, **kw) == jproto.event(12.5, 3, **kw)
    ev = proto.event(1.0, 2 ** 40, summary_values=[
        proto.summary_value_scalar("big", 7.0)])
    assert proto.decode_scalar_event(ev) == (1.0, 2 ** 40, [("big", 7.0)])


def test_a_torn_record_stops_the_strict_reader_and_salvage_skips_it(
        tmp_path):
    folder = _write(ValidationSummary, tmp_path)
    path = os.path.join(folder, os.listdir(folder)[0])
    data = bytearray(open(path, "rb").read())
    # flip a payload byte of the second record (after the version record)
    first = struct.unpack("<Q", data[:8])[0] + 16
    data[first + 14] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert len(read_events(folder)) == 1
    payloads, bad = read_events(folder, salvage=True)
    assert bad >= 1 and len(payloads) == 5
    assert len(j_read_events(folder)) == 1


def test_train_summary_triggers():
    s = TrainSummary.__new__(TrainSummary)
    s._triggers = {}
    with pytest.raises(ValueError, match="unsupported summary tag"):
        s.set_summary_trigger("Accuracy", Trigger.several_iteration(1))
    t = Trigger.several_iteration(2)
    assert s.set_summary_trigger("Parameters", t) is s
    assert s.get_summary_trigger("Parameters") is t


def test_local_optimizer_writes_train_and_validation_summaries(tmp_path):
    rs = np.random.RandomState(0)
    x = rs.randn(64, 784).astype(np.float32)
    y = rs.randint(1, 11, 64).astype(np.float32)
    model = lenet.build(10, device="cpu")
    train = TrainSummary(str(tmp_path), "lenet")
    train.set_summary_trigger("Parameters", Trigger.several_iteration(4))
    train.set_summary_trigger("LearningRate", Trigger.several_iteration(2))
    val = ValidationSummary(str(tmp_path), "lenet")
    opt = (LocalOptimizer(model, (x, y), tnn.ClassNLLCriterion(),
                          batch_size=16, device="cpu")
           .set_optim_method(SGD(learning_rate=0.05))
           .set_end_when(Trigger.max_epoch(2))
           .set_validation(Trigger.every_epoch(), (x[:32], y[:32]),
                           [Loss()], batch_size=16)
           .set_train_summary(train).set_val_summary(val))
    assert opt.train_summary is train and opt.val_summary is val
    opt.optimize()
    losses = train.read_scalar("Loss")
    assert [s for s, _, _ in losses] == list(range(1, 9))
    assert all(np.isfinite(v) for _, v, _ in losses)
    assert _values(train.read_scalar("LearningRate")) == [
        (s, np.float32(0.05)) for s in (2, 4, 6, 8)]
    assert [s for s, _, _ in train.read_scalar("Throughput")] == [4, 8]
    n_leaves = sum(len(sub) for sub in model.param_dict().values())
    hists = _histograms(train.folder)
    assert sorted({step for step, _ in hists}) == [4, 8]
    assert len(hists) == 2 * n_leaves
    vals = val.read_scalar("Loss")
    assert [s for s, _, _ in vals] == [4, 8]
    assert vals[-1][1] == np.float32(opt.last_validation[0][1].result()[0])


def test_spmd_trainer_summaries_hold_the_losses_it_returned(tmp_path):
    model = TT.build("tiny", device="cpu", seed=0)
    train = TrainSummary(str(tmp_path), "lm")
    val = ValidationSummary(str(tmp_path), "lm")
    tr = (SpmdTrainer(model, AdamW(learning_rate=1e-3), device="cpu")
          .set_train_summary(train).set_val_summary(val))
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(5):
        tok = rs.randint(0, 256, (2, 33))
        batches.append((tok[:, :-1], tok[:, 1:]))
    losses = tr.fit(batches, summary_flush_every=2)
    got = train.read_scalar("Loss")
    assert [s for s, _, _ in got] == [1, 2, 3, 4, 5]
    np.testing.assert_array_equal([v for _, v, _ in got],
                                  np.float32(losses))
    # a flush every 2 steps and one at the end: 3 throughput points
    assert [s for s, _, _ in train.read_scalar("Throughput")] == [2, 4, 5]
    res = tr.evaluate(iter(batches[:2]))
    assert _values(val.read_scalar("Loss")) == [(5, np.float32(res["loss"]))]
    assert _values(val.read_scalar("Perplexity")) == [
        (5, np.float32(res["perplexity"]))]
