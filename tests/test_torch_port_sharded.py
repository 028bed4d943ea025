"""The sharded data plane (``bigdl_tpu_torch/data/sharded.py``) against
the reference's (``bigdl_tpu/data/sharded.py``): the same shards, read by
both, give bitwise-equal batches and JSON-equal cursors (TFRecord,
SequenceFile and fixed-length records; 1–4 workers; two process indices;
``drop_last``; salvage over a corrupt region), a cursor written by one
package restores the other's stream, ``replan_cursors`` regroups the
remaining work exactly once, and shard I/O faults are retried or skip
the file loudly.  Everything here is exact: records are bytes."""
import json
import os
import struct

import numpy as np
import pytest

from bigdl_tpu.data import sharded as JS
from bigdl_tpu.observability import Recorder as JRecorder
from bigdl_tpu.utils.seqfile import SequenceFileWriter as JSeqWriter
from bigdl_tpu_torch import faults
from bigdl_tpu_torch.data import sharded as TS
from bigdl_tpu_torch.observability import Recorder as TRecorder
from bigdl_tpu_torch.utils.seqfile import SequenceFileWriter
from bigdl_tpu_torch.utils.tfrecord import write_tfrecords

N_FILES, PER_FILE, REC = 5, 17, 12      # REC: bytes of a fixed record


def write_shards(tmp_path, fmt, n_files=N_FILES, per_file=PER_FILE):
    """Shard files whose records carry a global int32 id, and the ids'
    count."""
    rng = np.random.RandomState(0)
    paths, gid = [], 0
    for f in range(n_files):
        recs = []
        for _ in range(per_file):
            recs.append(struct.pack("<i", gid)
                        + rng.bytes(REC - 4))
            gid += 1
        p = str(tmp_path / f"shard{f:02d}.{fmt}")
        if fmt == "tfrecord":
            write_tfrecords(p, recs)
        elif fmt == "seqfile":
            with SequenceFileWriter(p) as w:
                for r in recs:
                    w.append(r[:4], r)
        else:
            with open(p, "wb") as fh:
                fh.write(b"HD")
                fh.write(b"".join(recs))
        paths.append(p)
    return paths, gid


def decode(rec):
    """``(the record's bytes as floats, its id)``; a SequenceFile record
    is ``(key, value)``, and one salvaged out of a corrupt region may be
    short (the format has no CRC), so it is padded."""
    key, b = rec if isinstance(rec, tuple) else (rec, rec)
    i = struct.unpack("<i", key[:4].ljust(4, b"\0"))[0]
    b = b[:REC].ljust(REC, b"\0")
    return np.frombuffer(b, np.uint8).astype(np.float32), np.int32(i)


def make(pkg, paths, fmt, **kw):
    kw.setdefault("batch_size", 8)
    kw.setdefault("n_workers", 3)
    kw.setdefault("seed", 7)
    kw.setdefault("drop_last", False)
    if fmt == "fixed":
        kw.update(record_bytes=REC, header_bytes=2)
    return pkg.ShardedRecordDataSet(paths, fmt, decode, **kw)


def ids_of(it):
    return [int(v) for _, y in it for v in y]


def same(a, b):
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("fmt", ["tfrecord", "seqfile", "fixed"])
@pytest.mark.parametrize("n_workers", [1, 2, 4])
@pytest.mark.parametrize("process_index", [0, 1])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batches_and_cursors_equal_the_references(tmp_path, fmt, n_workers,
                                                  process_index, drop_last):
    paths, _ = write_shards(tmp_path, fmt)
    kw = dict(n_workers=n_workers, process_index=process_index,
              process_count=2, drop_last=drop_last)
    j, t = make(JS, paths, fmt, **kw), make(TS, paths, fmt, **kw)
    assert same(j.state(), t.state())
    ji, ti = j.data(train=True, epoch=1), t.data(train=True, epoch=1)
    n = 0
    while True:
        jb, tb = next(ji, None), next(ti, None)
        if jb is None or tb is None:
            assert jb is None and tb is None
            break
        assert np.array_equal(jb[0], tb[0]) and np.array_equal(jb[1], tb[1])
        assert same(j.state(), t.state())
        n += 1
    assert n > 0 and same(j.state(), t.state()) and t.state()["done"]
    assert j.size() == t.size()


@pytest.mark.parametrize("fmt", ["tfrecord", "seqfile"])
def test_salvage_over_a_corrupt_region_equals_the_references(tmp_path, fmt):
    paths, n = write_shards(tmp_path, fmt, per_file=40)
    data = bytearray(open(paths[1], "rb").read())
    off = len(data) // 2
    data[off:off + 40] = b"\xff\x00" * 20  # spans a length field
    open(paths[1], "wb").write(bytes(data))
    jr, tr = JRecorder(annotate=False), TRecorder()
    j = make(JS, paths, fmt, recorder=jr)
    t = make(TS, paths, fmt, recorder=tr)
    jids, tids = ids_of(j.data(epoch=0)), ids_of(t.data(epoch=0))
    assert tids == jids and len(tids) < n
    if fmt == "tfrecord":       # CRC-framed: nothing read twice
        assert len(set(tids)) == len(tids)
    skipped = tr.counter_value("data/resync_skipped_bytes")
    assert skipped > 0
    assert skipped == jr.counter_value("data/resync_skipped_bytes")
    # resume determinism holds across the corrupt region
    t2 = make(TS, paths, fmt)
    it = t2.data(train=True, epoch=0)
    head = [int(v) for _ in range(3) for v in next(it)[1]]
    cur = t2.state()
    it.close()
    assert head + ids_of(make(TS, paths, fmt).restore(cur).data(epoch=0)) \
        == tids


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_cursor_restores_the_other_packages_stream(tmp_path, writer):
    paths, n = write_shards(tmp_path, "tfrecord")
    src_pkg, dst_pkg = (JS, TS) if writer == "reference" else (TS, JS)
    src = make(src_pkg, paths, "tfrecord", batch_size=5)
    it = src.data(train=True, epoch=0)
    head = [int(v) for _ in range(4) for v in next(it)[1]]
    cur = json.loads(json.dumps(src.state()))
    rest = ids_of(it)
    dst = make(dst_pkg, paths, "tfrecord", batch_size=5).restore(cur)
    assert ids_of(dst.data(epoch=0)) == rest
    assert sorted(head + rest) == list(range(n))


def test_replan_cursors_is_exactly_once_and_equals_the_references(tmp_path):
    paths, n = write_shards(tmp_path, "tfrecord", n_files=7)
    states, seen = [], []
    for pi in range(2):
        ds = make(TS, paths, "tfrecord", n_workers=2, process_index=pi,
                  process_count=2, batch_size=4)
        it = ds.data(train=True, epoch=0)
        seen += [int(v) for _ in range(2 + pi) for v in next(it)[1]]
        states.append(ds.state())
        it.close()
    fresh = make(TS, paths, "tfrecord", n_workers=2, process_index=1,
                 process_count=2).state()
    for world in [(1, 3), (3, 1), (2, 2)]:
        mine = TS.replan_cursors(states, *world)
        assert same(mine, JS.replan_cursors(states, *world))
        rest = []
        for cur in mine:
            ds = make(TS, paths, "tfrecord", n_workers=world[1],
                      process_index=cur["process_index"],
                      process_count=world[0])
            rest += ids_of(ds.restore(cur).data(epoch=0))
        assert sorted(seen + rest) == list(range(n))
    # a fresh cursor stands for its whole epoch plan
    both = TS.replan_cursors([states[0], fresh], 1, 2, n_files=len(paths))
    assert same(both, JS.replan_cursors([states[0], fresh], 1, 2,
                                        n_files=len(paths)))
    with pytest.raises(ValueError, match="missing"):
        TS.replan_cursors(states[:1], 1, 2)


def test_epoch_boundary_and_stream_roll_over(tmp_path):
    paths, n = write_shards(tmp_path, "tfrecord")
    ds = make(TS, paths, "tfrecord")
    first = ids_of(ds.data(train=True, epoch=0))
    cur = ds.state()
    assert cur["done"] and sorted(first) == list(range(n))
    # a resume exactly at the boundary: the finished epoch yields nothing
    again = make(TS, paths, "tfrecord").restore(cur)
    assert ids_of(again.data(train=True, epoch=0)) == []
    assert ids_of(again.data(train=True)) == ids_of(
        make(JS, paths, "tfrecord").data(train=True, epoch=1))
    s = make(TS, paths, "tfrecord")
    streamed = ids_of(s.stream(max_epochs=2))
    assert streamed[:n] == first and sorted(streamed[n:]) == list(range(n))


def test_fixed_records_seek_through_the_native_ring(tmp_path):
    paths, _ = write_shards(tmp_path, "fixed", n_files=1, per_file=10)
    got = [decode(r)[1] for r in TS.iter_fixed_records(paths[0], REC, 2)]
    assert got == list(range(10))
    assert [decode(r)[1] for r in TS.iter_fixed_records(
        paths[0], REC, 2, start=4)] == list(range(4, 10))
    assert TS.count_records(paths[0], "fixed", REC, 2) == 10


def test_a_transient_eio_is_retried_exactly_once(tmp_path):
    paths, n = write_shards(tmp_path, "tfrecord")
    rec = TRecorder()
    faults.reset()
    faults.arm("data.record_read:err:EIO@7")
    try:
        ids = ids_of(make(TS, paths, "tfrecord", recorder=rec).data(epoch=0))
    finally:
        faults.reset()
    assert sorted(ids) == list(range(n))
    assert rec.counter_value("retry/attempts") >= 1
    assert rec.counter_value("data/files_skipped") == 0


def test_eacces_skips_the_file_with_a_count_and_a_health_event(tmp_path):
    paths, n = write_shards(tmp_path, "tfrecord")
    rec = TRecorder()
    faults.reset()
    faults.arm("data.shard_open:err:EACCES@0")
    try:
        ids = ids_of(make(TS, paths, "tfrecord", recorder=rec).data(epoch=0))
    finally:
        faults.reset()
    assert len(ids) == n - PER_FILE and len(set(ids)) == len(ids)
    assert rec.counter_value("data/files_skipped") == 1
    evs = [r for r in rec.recent_records()
           if r.get("type") == "health_event"]
    assert evs and evs[-1]["condition"] == "data_file_skipped" \
        and evs[-1]["action"] == "skip"


def test_a_decode_error_surfaces_at_the_consumer(tmp_path):
    paths, _ = write_shards(tmp_path, "tfrecord")

    def bad(_):
        raise FileNotFoundError(2, "missing side file")

    ds = TS.ShardedRecordDataSet(paths, "tfrecord", bad, batch_size=4)
    with pytest.raises(FileNotFoundError):
        for _ in ds.data(train=True, epoch=0):
            pass
    assert ds.recorder.counter_value("data/files_skipped") == 0
