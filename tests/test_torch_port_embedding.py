"""The port's ``embedding/`` held against the reference's on the same seeded
numpy inputs, and its own contracts as the reference states them
(docs/embedding.md), on one process:

  * ``dense_bag`` forward and the table's gradient over every combiner and
    per-id weights: bitwise the reference's;
  * ``ShardedEmbeddingBag`` against ``dense_bag`` of its reference table:
    forward and backward bitwise (plain), the dedup forward bitwise and
    its backward within the reference's float32 envelope (rtol 3e-6,
    atol 1e-6); ids past a full bucket dropped (their positions zero);
    the exchange's accounting handed to a recorder, none without one;
  * the host dedup stage: the same arrays and gauges;
  * the sparse optimizers: ``SparseSGD`` bitwise the port's dense ``SGD``
    on unique ids (and over ``combine_duplicates``), ``SparseAdam``
    bitwise the port's dense ``Adam``; ``SparseSGD`` bitwise the
    reference's, ``SparseAdam`` within about one ulp of it (rtol 2.5e-7,
    the reference's own cross-backend envelope); LazyAdam freezes untouched rows; zero1 row slices
    concatenate bitwise;
  * the int8 table and bag: bitwise the reference's.

The exchange over several ranks runs on gloo in
``tests/test_torch_port_recsys.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import embedding as je
from bigdl_tpu.observability.recorder import Recorder as JRecorder
from bigdl_tpu_torch import embedding as te
from bigdl_tpu_torch.observability import Recorder
from bigdl_tpu_torch.optim import SGD, Adam

V, D, B, L = 100, 16, 32, 12
DEDUP_TOL = dict(rtol=3e-6, atol=1e-6)
# the reference's own cross-backend contract for Adam: about one ulp
ADAM_TOL = dict(rtol=2.5e-7, atol=0)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _eq(port, ref):
    np.testing.assert_array_equal(_np(port), _np(ref))


def _ids(seed=3, b=B, l=L, v=V):
    return np.random.RandomState(seed).randint(0, v + 1, (b, l)) \
        .astype(np.int32)


def _table(seed=0, v=V):
    return np.random.RandomState(seed).randn(v, D).astype(np.float32)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("weighted", [False, True])
def test_dense_bag_forward_and_backward_are_the_references(combiner,
                                                           weighted):
    ids, w = _ids(), _table()
    wts = np.random.RandomState(11).rand(B, L).astype(np.float32)
    g = np.random.RandomState(7).randn(B, D).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_()
    yt = te.dense_bag(tw, torch.from_numpy(ids),
                      torch.from_numpy(wts) if weighted else None, combiner)
    (yt * torch.from_numpy(g)).sum().backward()
    yj, vjp = jax.vjp(lambda t: je.dense_bag(
        t, jnp.asarray(ids), jnp.asarray(wts) if weighted else None,
        combiner), jnp.asarray(w))
    _eq(yt, yj)
    _eq(tw.grad, vjp(jnp.asarray(g))[0])


def _bag(combiner="sum", capacity=None, seed=0):
    bag = te.ShardedEmbeddingBag(V, D, combiner=combiner, capacity=capacity,
                                 gen=torch.Generator().manual_seed(seed))
    return bag, bag.param_dict()


def _grads(bag, x, g, dense_ids=None):
    """``(y, dW)`` of ``<bag(x), g>`` and of the dense bag over the
    reference table on ``dense_ids``."""
    w = bag.weight.detach().clone().requires_grad_()
    y = bag.run({bag.name: {"weight": w}}, x)[0]
    (gw,) = torch.autograd.grad((y * g).sum(), [w])
    wd = bag.weight.detach().clone().requires_grad_()
    yd = te.dense_bag(te.reference_table({bag.name: {"weight": wd}}, bag),
                      dense_ids, combiner=bag.combiner)
    (gd,) = torch.autograd.grad((yd * g).sum(), [wd])
    return y, gw, yd, gd


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_sharded_bag_is_bitwise_the_dense_bag(combiner):
    """One shard, no process group (the exchange runs locally): the
    plain path's forward and backward bitwise, and with per-id weights."""
    bag, p = _bag(combiner)
    ids = torch.from_numpy(_ids(5))
    g = torch.from_numpy(np.random.RandomState(7).randn(B, D)
                         .astype(np.float32))
    y, gw, yd, gd = _grads(bag, ids, g, ids)
    assert torch.equal(y, yd) and torch.equal(gw, gd)
    wts = torch.from_numpy(np.random.RandomState(11).rand(B, L)
                           .astype(np.float32))
    yw = bag.run(p, (ids, wts))[0]
    ydw = te.dense_bag(te.reference_table(p, bag), ids, wts, combiner)
    assert torch.equal(yw, ydw)
    assert bag.weight.shape == (V, D) and bag.row_bounds() == (0, V)


def test_dedup_forward_bitwise_backward_in_the_envelope():
    bag, _ = _bag()
    ids = _ids(13)
    uniq, inv = te.dedup_for_mesh(ids, 1)
    g = torch.from_numpy(np.random.RandomState(17).randn(B, D)
                         .astype(np.float32))
    y, gw, yd, gd = _grads(bag, (torch.from_numpy(uniq),
                                 torch.from_numpy(inv)), g,
                           torch.from_numpy(ids))
    assert torch.equal(y, yd)
    np.testing.assert_allclose(_np(gw), _np(gd), **DEDUP_TOL)


def test_capacity_overflow_is_dropped_without_an_error():
    """A bucket of 8 slots for 12 ids a bag row: ids past it read zeros
    (a bag over fewer ids), the others are untouched, and nothing
    raises."""
    ids = np.full((2, 12), 0, np.int32)
    ids[0] = np.arange(1, 13)
    ids[1, :3] = [4, 5, 6]
    bag, p = _bag(capacity=8)
    y = bag.run(p, torch.from_numpy(ids))[0]
    # the local exchange sorts by owner (all one shard): slots in order,
    # so the first 8 positions of the flat batch are kept
    kept = ids.copy()
    kept[0, 8:] = 0
    kept[1] = 0
    want = te.dense_bag(te.reference_table(p, bag), torch.from_numpy(kept))
    assert torch.equal(y, want)
    y.sum().backward()


def test_exchange_accounting_goes_to_the_recorder_handed_in():
    bag, p = _bag()
    bag.run(p, torch.from_numpy(_ids()))         # no recorder: nothing
    rec = Recorder()
    bag.set_recorder(rec).run(p, torch.from_numpy(_ids()))
    s = B * L
    assert rec.gauge_value("embedding/exchange_ids") == float(s)
    assert rec.gauge_value("embedding/lookup_exchange_bytes") == \
        float(s * 4 + s * D * 4)
    assert rec.gauge_value("comm/group.tp.all-to-all_bytes") == \
        float(s * 4 + s * D * 4)


def test_shard_spec_pad_and_batch_checks():
    assert te.row_shard_spec(V, 8) == (13, 104)
    p = te.pad_table(torch.ones((V, D)), 8)
    assert p.shape == (104, D) and float(p[V:].sum()) == 0.0
    _eq(p, je.pad_table(jnp.ones((V, D)), 8))
    bag, params = _bag()
    with pytest.raises(ValueError, match="sum|mean|sqrtn"):
        te.ShardedEmbeddingBag(V, D, combiner="max")
    with pytest.raises(ValueError, match="rows"):
        bag.run({bag.name: {"weight": torch.zeros((3, D))}},
                torch.from_numpy(_ids()))


def test_dedup_stage_is_the_references():
    ids = _ids(21, v=20)
    jr, tr = JRecorder(annotate=False), Recorder()
    for n in (1, 4, 8):
        ju, ji = je.dedup_for_mesh(ids, n, recorder=jr)
        tu, ti = te.dedup_for_mesh(ids, n, recorder=tr)
        _eq(tu, ju)
        _eq(ti, ji)
    lists = [[1, 2], [3], list(range(1, 20))]
    _eq(te.pad_ragged(lists, recorder=tr, min_len=8),
        je.pad_ragged(lists, recorder=jr, min_len=8))
    for name in ("embedding/dedup_in_ids", "embedding/dedup_out_ids",
                 "embedding/pad_slots", "embedding/pad_ids"):
        assert tr.counter_value(name) == jr.counter_value(name), name
    for name in ("embedding/dedup_ratio", "embedding/padding_waste"):
        assert tr.gauge_value(name) == jr.gauge_value(name), name
    assert te.bucket_ladder(5000) == je.bucket_ladder(5000) == 8192
    assert te.exchange_ids_without_dedup(ids) == \
        je.exchange_ids_without_dedup(ids)


def _grad(i, nnz=20, slots=32):
    r = np.random.RandomState(100 + i)
    ids = np.full(slots, -1, np.int32)
    ids[:nnz] = r.choice(V, nnz, replace=False)
    vals = np.zeros((slots, D), np.float32)
    vals[:nnz] = r.randn(nnz, D)
    return ids, vals


def _pair(i):
    ids, vals = _grad(i)
    return (te.SparseRowGrad(torch.from_numpy(ids), torch.from_numpy(vals),
                             V),
            je.SparseRowGrad(jnp.asarray(ids), jnp.asarray(vals), V))


@pytest.mark.parametrize("which", ["sgd", "adam", "lazy_adam"])
def test_sparse_updates_are_the_references_and_the_dense_ones(which):
    """Ten steps: the port's sparse update the reference's (SGD bitwise,
    Adam within about one ulp, ``ADAM_TOL``), and (SGD, exact Adam)
    bitwise the port's dense update over ``to_dense()``."""
    make = {"sgd": (lambda m: m.SparseSGD(learning_rate=0.05,
                                          lr_decay=0.01),
                    lambda: SGD(learning_rate=0.05,
                                learning_rate_decay=0.01)),
            "adam": (lambda m: m.SparseAdam(learning_rate=0.01),
                     lambda: Adam(learning_rate=0.01)),
            "lazy_adam": (lambda m: m.SparseAdam(learning_rate=0.01,
                                                 lazy=True), None)}[which]
    t0 = _table(1)
    ts, js = make[0](te), make[0](je)
    pt, pj = torch.from_numpy(t0.copy()), jnp.asarray(t0)
    st, sj = ts.init_state(pt), js.init_state(pj)
    dense = make[1]() if make[1] else None
    pd = {"t": {"w": torch.from_numpy(t0.copy())}}
    sd = dense.init_state(pd) if dense else None
    for i in range(10):
        gt, gj = _pair(i)
        pt, st = ts.update(pt, gt, st)
        pj, sj = js.update(pj, gj, sj)
        if dense:
            _, sd = dense.update({"t": {"w": gt.to_dense()}}, pd, sd)
    if which == "sgd":
        _eq(pt, pj)
    else:
        # Adam's quotient rounds differently in a few elements
        np.testing.assert_allclose(_np(pt), _np(pj), **ADAM_TOL)
    if dense:
        assert torch.equal(pt, pd["t"]["w"])
    if which == "lazy_adam":
        touched = set()
        for i in range(10):
            touched |= set(_grad(i)[0][_grad(i)[0] >= 0].tolist())
        untouched = sorted(set(range(V)) - touched)
        _eq(pt[untouched], t0[untouched])


def test_combine_duplicates_and_sparse_grad_surface():
    r = np.random.RandomState(5)
    ids = np.asarray([3, 7, 3, -1, 7, 3, 12, -1], np.int32)
    vals = r.randn(len(ids), D).astype(np.float32)
    vals[ids < 0] = 0.0
    gt = te.SparseRowGrad(torch.from_numpy(ids), torch.from_numpy(vals), V)
    gj = je.SparseRowGrad(jnp.asarray(ids), jnp.asarray(vals), V)
    ct, cj = te.combine_duplicates(gt), je.combine_duplicates(gj)
    _eq(ct.ids, cj.ids)
    _eq(ct.values, cj.values)
    _eq(gt.to_dense(), gj.to_dense())
    _eq(ct.to_dense(), gt.to_dense())
    p = torch.from_numpy(_table(3))
    pd = {"t": {"w": p.clone()}}
    dense = SGD(learning_rate=0.1)
    dense.update({"t": {"w": gt.to_dense()}}, pd, dense.init_state(pd))
    sparse = te.SparseSGD(learning_rate=0.1)
    ps, _ = sparse.update(p.clone(), ct, sparse.init_state(p))
    assert torch.equal(ps, pd["t"]["w"])
    assert gt.wire_bytes() == gj.wire_bytes() < V * D * 4
    rec = Recorder()
    assert te.touched_fraction(gt, rec) == je.touched_fraction(gj)
    assert rec.gauge_value("embedding/touched_rows_fraction") == len(ids) / V
    fd = te.SparseRowGrad.from_dense(gt.to_dense(), torch.tensor([3, -1, 7]))
    _eq(fd.values, je.SparseRowGrad.from_dense(
        gj.to_dense(), jnp.asarray([3, -1, 7])).values)


def test_zero1_row_slices_concatenate_bitwise():
    sparse = te.SparseSGD(learning_rate=0.05)
    p = torch.from_numpy(_table(4))
    g = _pair(1)[0]
    full, _ = sparse.update(p.clone(), g, sparse.init_state(p))
    parts = []
    for rank in range(4):
        lo, hi = te.zero1_row_bounds(V, rank, 4)
        assert (lo, hi) == je.zero1_row_bounds(V, rank, 4)
        shard = p[lo:hi].clone()
        out, _ = sparse.update(shard, te.slice_grad_rows(g, lo, hi),
                               sparse.init_state(shard))
        parts.append(out)
    assert torch.equal(torch.cat(parts), full)


def test_int8_table_and_bag_are_the_references():
    w = np.random.RandomState(6).randn(V, D).astype(np.float32)
    qt, st = te.quantize_table(torch.from_numpy(w))
    qj, sj = je.quantize_table(jnp.asarray(w))
    _eq(qt, qj)
    _eq(st, sj)
    _eq(te.dequantize_table(qt, st), je.dequantize_table(qj, sj))
    ids = _ids(31)
    for combiner in ("sum", "mean"):
        yt = te.quantized_dense_bag(qt, st, torch.from_numpy(ids),
                                    combiner=combiner)
        _eq(yt, je.quantized_dense_bag(qj, sj, jnp.asarray(ids),
                                       combiner=combiner))
    yf = te.dense_bag(torch.from_numpy(w), torch.from_numpy(ids),
                      combiner="mean")
    yq = te.quantized_dense_bag(qt, st, torch.from_numpy(ids),
                                combiner="mean")
    assert float((yq - yf).abs().max()) < 0.05
    assert te.table_bytes(torch.from_numpy(w)) == je.table_bytes(w)
    assert te.quantized_table_bytes(qt, st) == \
        je.quantized_table_bytes(qj, sj) == V * D + V * 4
