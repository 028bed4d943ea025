"""The data cursor in both trainers' checkpoints: ``SpmdTrainer``
(``set_data_pipeline``) and ``LocalOptimizer`` fed by a
``ShardedRecordDataSet``, preempted and resumed from the last checkpoint
by a fresh trainer over a fresh dataset, must train bitwise as the
uninterrupted run and consume every record exactly once — mid-epoch and
exactly at an epoch boundary.  The port's ``SpmdTrainer`` against the
reference's, on the same weights and shards, stays within the band its
step tests use (losses 2e-5)."""
import struct

import numpy as np
import pytest
import torch

from bigdl_tpu.data import sharded as JS
from bigdl_tpu.models import transformer as JT
from bigdl_tpu.optim.optim_method import AdamW as JAdamW
from bigdl_tpu.parallel.mesh import create_mesh
from bigdl_tpu.parallel.spmd import SpmdTrainer as JSpmdTrainer
from bigdl_tpu_torch.checkpoint import scan
from bigdl_tpu_torch.data import sharded as TS
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, AdamW, LocalOptimizer, Trigger
from bigdl_tpu_torch.parallel import SpmdTrainer
from bigdl_tpu_torch.utils.tfrecord import write_tfrecords

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64)
SEQ, LM_FILES, LM_PER_FILE, LM_BATCH = 16, 6, 10, 4      # 15 batches/epoch


@pytest.fixture(autouse=True)
def _deterministic():
    """The CPU's embedding backward accumulates in an order that varies
    from run to run unless deterministic algorithms are on."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(prev)


def _lm_shards(tmp_path):
    rs = np.random.RandomState(11)
    paths, gid = [], 0
    for f in range(LM_FILES):
        recs = []
        for _ in range(LM_PER_FILE):
            toks = rs.randint(0, SMALL["vocab_size"], SEQ + 1)
            recs.append(struct.pack("<i", gid)
                        + toks.astype(np.int32).tobytes())
            gid += 1
        p = str(tmp_path / f"lm{f}.tfr")
        write_tfrecords(p, recs)
        paths.append(p)
    return paths


def _lm_decode(b):
    t = np.frombuffer(b[4:], np.int32).astype(np.int64)
    return t[:-1], t[1:], struct.unpack("<i", b[:4])[0]


def _lm_collate(samples):
    xs, ys, ids = zip(*samples)
    return np.stack(xs), np.stack(ys), np.array(ids)


def _lm_ds(pkg, paths):
    return pkg.ShardedRecordDataSet(paths, "tfrecord", _lm_decode,
                                    batch_size=LM_BATCH, n_workers=2,
                                    seed=3, collate=_lm_collate)


def _logged(stream, log):
    """The trainer's feed: each batch's record ids logged as it is
    consumed."""
    for x, y, ids in stream:
        log.append([int(i) for i in ids])
        yield x, y


def _spmd(tmp_path, ckpt=None, every=3):
    tr = SpmdTrainer(TT.build("tiny", device="cpu", seed=0, **SMALL),
                     AdamW(learning_rate=3e-3), device="cpu")
    if ckpt is not None:
        tr.set_checkpoint(str(ckpt), every_steps=every)
    return tr


@pytest.mark.parametrize("every,stop", [(3, 7), (5, 16)],
                         ids=["mid_epoch", "epoch_boundary"])
def test_spmd_trainer_resumes_bitwise_and_exactly_once(tmp_path, every,
                                                       stop):
    paths, total = _lm_shards(tmp_path), 20
    ids_a = []
    a = _spmd(tmp_path)
    ds_a = _lm_ds(TS, paths)
    want = a.set_data_pipeline(ds_a).fit(_logged(ds_a.stream(), ids_a),
                                         steps=total)
    ck = tmp_path / "ck"
    ids_b1 = []
    b1 = _spmd(tmp_path, ck, every)
    ds_b1 = _lm_ds(TS, paths)
    b1.set_data_pipeline(ds_b1).fit(_logged(ds_b1.stream(), ids_b1),
                                    steps=stop)
    last = (stop // every) * every      # the newest checkpoint's step
    cursor = scan(str(ck))[-1][1].meta["data_cursor"]
    assert cursor["epoch"] == 0 and cursor["workers"] is not None
    b2 = _spmd(tmp_path, ck, every)
    ds_b2 = _lm_ds(TS, paths)
    b2.set_data_pipeline(ds_b2).load_checkpoint(str(ck))
    assert b2._step_count == last
    ids_b2 = []
    got = b2.fit(_logged(ds_b2.stream(), ids_b2), steps=total - last)
    assert want[last:] == got
    for (k, p), (k2, q) in zip(sorted(a.model.state_dict().items()),
                               sorted(b2.model.state_dict().items())):
        assert torch.equal(p, q), k
    assert ids_b1[:last] + ids_b2 == ids_a
    n = LM_FILES * LM_PER_FILE
    flat = [i for b in ids_a for i in b]
    assert sorted(flat[:n]) == list(range(n))       # epoch 0: each once


def test_spmd_trainer_on_shards_matches_the_reference(tmp_path):
    paths = _lm_shards(tmp_path)
    jm = JT.build("tiny", **SMALL)
    jt = JSpmdTrainer(jm, JAdamW(learning_rate=3e-3),
                      mesh=create_mesh({"dp": 1},
                                       devices=__import__("jax").devices()
                                       [:1]), fsdp=False).init()
    tm = TT.build("tiny", device="cpu", **SMALL)
    from_jax_params({k: {kk: np.array(vv) for kk, vv in sub.items()}
                     for k, sub in jt.params.items()}, tm)
    tt = SpmdTrainer(tm, AdamW(learning_rate=3e-3), device="cpu")
    jds, tds = _lm_ds(JS, paths), _lm_ds(TS, paths)
    jt.set_data_pipeline(jds)
    tt.set_data_pipeline(tds)
    want = jt.fit(((x, y) for x, y, _ in jds.stream()), steps=8)
    got = tt.fit(((x, y) for x, y, _ in tds.stream()), steps=8)
    np.testing.assert_allclose(got, [float(v) for v in want], rtol=2e-5,
                               atol=2e-5)
    # the port's fit(steps=8) pulls 8 batches, so its cursor is that of
    # the last batch trained; the reference's pulls a 9th (ROADMAP C9)
    eight, nine = _lm_ds(JS, paths), _lm_ds(JS, paths)
    for ds, n in ((eight, 8), (nine, 9)):
        it = ds.data(train=True, epoch=0)
        for _ in range(n):
            next(it)
    assert tds.state() == eight.state()
    assert jds.state() == nine.state()


# --------------------------------------------------------------------- #
# LocalOptimizer: LeNet-5 over fixed-length records                     #
# --------------------------------------------------------------------- #
IMG, LE_FILES, LE_PER_FILE, LE_BATCH = 28 * 28, 4, 12, 8   # 6 batches/epoch
LE_REC = IMG + 8


def _lenet_shards(tmp_path):
    rs = np.random.RandomState(5)
    paths, gid = [], 0
    for f in range(LE_FILES):
        p = str(tmp_path / f"le{f}.bin")
        with open(p, "wb") as fh:
            for _ in range(LE_PER_FILE):
                fh.write(rs.randint(0, 256, IMG).astype(np.uint8).tobytes())
                fh.write(struct.pack("<ii", gid, gid % 10 + 1))
                gid += 1
        paths.append(p)
    return paths


def _lenet_decode(b):
    x = np.frombuffer(b[:IMG], np.uint8).reshape(28, 28) / np.float32(255)
    return x.astype(np.float32), np.float32(struct.unpack("<i", b[-4:])[0])


def _lenet_ds(paths, recorder=None):
    return TS.ShardedRecordDataSet(paths, "fixed", _lenet_decode,
                                   batch_size=LE_BATCH, record_bytes=LE_REC,
                                   n_workers=2, seed=1, recorder=recorder)


def _optimizer(paths, ckpt, every, end):
    model = TL.build(10, device="cpu", seed=0)
    opt = LocalOptimizer(model, _lenet_ds(paths), ClassNLLCriterion(),
                         device="cpu")
    opt.set_optim_method(SGD(learning_rate=0.05)) \
        .set_end_when(Trigger.max_iteration(end)).set_prefetch(2)
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(every))
    return model, opt


def _id_stream(paths):
    return TS.ShardedRecordDataSet(
        paths, "fixed", lambda b: (np.int64(struct.unpack("<i",
                                                          b[IMG:IMG + 4])
                                            [0]), None),
        batch_size=LE_BATCH, record_bytes=LE_REC, n_workers=2, seed=1)


def _drain_ids(ds, n, epoch):
    """The record ids of the next ``n`` batches, epoch by epoch from
    ``epoch`` (the optimizer's epochs count from 1)."""
    out = []
    while len(out) < n:
        for ids, _ in ds.data(train=True, epoch=epoch):
            out.append(ids.tolist())
            if len(out) == n:
                break
        epoch += 1
    return out


@pytest.mark.parametrize("every,stop", [(4, 5), (3, 7)],
                         ids=["mid_epoch", "epoch_boundary"])
def test_local_optimizer_resumes_bitwise_and_exactly_once(tmp_path, every,
                                                          stop):
    paths, total = _lenet_shards(tmp_path), 14
    ma, oa = _optimizer(paths, None, every, total)
    oa.optimize()
    ck = tmp_path / "ck"
    _, ob1 = _optimizer(paths, ck, every, stop)
    ob1.optimize()
    last = (stop // every) * every
    mf = scan(str(ck))[-1][1]
    assert mf.meta["iteration"] == last
    cursor = mf.meta["data_cursor"]
    mb, ob2 = _optimizer(paths, ck, every, total)
    ob2.optimize()
    assert ob2.state.iteration == total
    for (k, p), (k2, q) in zip(sorted(ma.state_dict().items()),
                               sorted(mb.state_dict().items())):
        assert torch.equal(p, q), k
    # exactly once: the first run's committed batches, then the stream
    # the checkpoint's cursor restores, are the uninterrupted sequence
    want = _drain_ids(_id_stream(paths), total, 1)
    rest = _drain_ids(_id_stream(paths).restore(cursor), total - last,
                      cursor["epoch"])
    assert want[:last] + rest == want
    n = LE_FILES * LE_PER_FILE
    assert sorted(i for b in want[:n // LE_BATCH] for i in b) \
        == list(range(n))


def test_phase_data_elastic_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``phase_data_elastic`` at its small size on the
    CPU, children, supervisor ranks and all: every gate it holds on the
    card but the launch counts and device times."""
    import importlib
    import sys
    from pathlib import Path
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    cs = importlib.import_module("chip_smoke")
    out = cs.phase_data_elastic("cpu", device="cpu", small=True)
    checks = out["checks"]
    assert checks["losses_bitwise"] and checks["params_bitwise"]
    assert checks["ids_exactly_once"] and checks["module_logits_bitwise"]
    assert checks["topology_equal"]
    assert out["elastic"]["losses_bitwise"]
    assert out["elastic"]["events"] == ["preemption", "resume"]
    assert out["lenet"]["params_bitwise"] and out["lenet"]["exactly_once"]
