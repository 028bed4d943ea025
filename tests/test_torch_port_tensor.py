"""The port's ``tensor/`` (1-based index helpers, the COO ``SparseTensor``,
``embedding_bag``, int8 helpers), ``nn/sparse.py``'s three layers and
``BCECriterion`` held against the reference's on the same seeded numpy
inputs, op by op as ``tests/test_tensor.py`` lists them.

Tolerances: every op here is bitwise the reference's on the CPU (the port
adds repeated indices in XLA's scatter-add order, ``tensor/_segment.py``),
except ``max_norm`` (the norm's sum may associate otherwise: 1e-6) and
``BCECriterion`` (``log`` of two libraries: 1e-6)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu import tensor as bt
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import tensor as tt
from bigdl_tpu_torch.models.convert import from_jax_params


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _eq(port, ref):
    np.testing.assert_array_equal(_np(port), _np(ref))


def _sparse_pair(dense):
    return tt.SparseTensor.from_dense(dense), bt.SparseTensor.from_dense(dense)


def _both(idx, vals, shape):
    return (tt.SparseTensor(idx, vals, shape),
            bt.SparseTensor(idx, vals, shape))


@pytest.mark.parametrize("op", ["narrow", "select", "index_select",
                                "index_add", "index_copy", "index_fill",
                                "gather", "scatter", "scatter_add",
                                "masked_fill", "masked_select"])
def test_index_helpers_are_the_references(op):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 4).astype(np.float32)
    tx, jx = torch.from_numpy(x.copy()), jnp.asarray(x)
    idx = np.array([2, 5, 2])               # a duplicate accumulates
    src = rng.randn(3, 4).astype(np.float32)
    index = rng.randint(1, 6, (3, 4))
    mask = rng.rand(5, 4) < 0.4
    # rows distinct within each column: a scatter's duplicates are
    # unspecified in both packages
    unique = np.array([[1, 2, 3, 4], [3, 4, 5, 1], [5, 1, 2, 3]])
    calls = {
        "narrow": lambda m, a: m.narrow(a, 1, 2, 3),
        "select": lambda m, a: m.select(a, 2, 3),
        "index_select": lambda m, a: m.index_select(a, 1, [3, 1, 3]),
        "index_add": lambda m, a: m.index_add(a, 1, idx, src),
        "index_copy": lambda m, a: m.index_copy(a, 1, [2, 5], src[:2]),
        "index_fill": lambda m, a: m.index_fill(a, 2, [1, 3], 7.0),
        "gather": lambda m, a: m.gather(a, 1, index),
        "scatter": lambda m, a: m.scatter(a, 1, unique, src),
        "scatter_add": lambda m, a: m.scatter_add(a, 1, index, src),
        "masked_fill": lambda m, a: m.masked_fill(a, mask, -1.0),
        "masked_select": lambda m, a: m.masked_select(a, mask),
    }
    _eq(calls[op](tt, tx), calls[op](bt, jx))


def test_sparse_round_trip_matmul_and_surface():
    rng = np.random.RandomState(2)
    d = rng.randn(5, 7).astype(np.float32)
    d[rng.rand(5, 7) < 0.6] = 0.0
    ts, js = _sparse_pair(d)
    _eq(ts.indices, js.indices)
    _eq(ts.to_dense(), js.to_dense())
    w = rng.randn(7, 3).astype(np.float32)
    _eq(tt.sparse_dense_matmul(ts, torch.from_numpy(w)),
        bt.sparse_dense_matmul(js, jnp.asarray(w)))
    _eq((ts * 2).to_dense(), (js * 2).to_dense())
    _eq((ts / 3).to_dense(), (js / 3).to_dense())
    _eq((-ts).to_dense(), (-js).to_dense())
    _eq(ts.abs().to_dense(), js.abs().to_dense())
    _eq(ts.apply1(torch.square).to_dense(), js.apply1(jnp.square).to_dense())
    assert float(ts.sum()) == float(js.sum())
    _eq(ts.narrow(1, 2, 2).to_dense(), js.narrow(1, 2, 2).to_dense())
    _eq(ts.select(1, 3).to_dense(), js.select(1, 3).to_dense())
    _eq(ts.t().to_dense(), js.t().to_dense())
    _eq(ts.row_ids(), js.row_ids())
    _eq(ts.num_nonzero_by_row(), js.num_nonzero_by_row())
    for dim in (1, 2):
        _eq(tt.sparse_concat([ts, ts], dim=dim).to_dense(),
            bt.sparse_concat([js, js], dim=dim).to_dense())
    base = rng.randn(5, 7).astype(np.float32)
    _eq(tt.sparse_dense_add(ts, torch.from_numpy(base)),
        bt.sparse_dense_add(js, jnp.asarray(base)))
    assert ts.astype(torch.bfloat16).dtype == torch.bfloat16
    assert ts.nnz == int(js.nnz) and ts.ndim == js.ndim == 2
    # duplicate coordinates add in order, as the reference's scatter
    dup_t, dup_j = _both(np.array([[0, 1, 0], [2, 0, 2]], np.int32),
                         rng.randn(3).astype(np.float32), (2, 3))
    _eq(dup_t.to_dense(), dup_j.to_dense())


def _bags(seed, n_bags=6, max_len=5, v=10, empty=(), dup=True):
    """COO ids of ``n_bags`` ragged bags (1-based), some empty, with
    repeated ids; per-id weights beside them."""
    rng = np.random.RandomState(seed)
    rows, cols, vals = [], [], []
    for b in range(n_bags):
        if b in empty:
            continue
        n = rng.randint(1, max_len + 1)
        ids = rng.randint(1, v + 1, n)
        if dup and n > 1:
            ids[-1] = ids[0]
        rows += [b] * n
        cols += list(range(n))
        vals += list(ids)
    idx = np.array([rows, cols], np.int32)
    return (idx, np.array(vals, np.float32), (n_bags, max_len),
            rng.rand(len(vals)).astype(np.float32))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_forward_and_backward_are_the_references(combiner,
                                                               weighted):
    """Empty bags (zeros), repeated ids, per-id weights; the table's
    gradient of ``<y, g>``: bitwise."""
    idx, vals, shape, wts = _bags(3, empty=(1, 4))
    table = np.random.RandomState(4).randn(10, 8).astype(np.float32)
    g = np.random.RandomState(5).randn(shape[0], 8).astype(np.float32)
    ts, js = _both(idx, vals, shape)
    tw = torch.from_numpy(wts) if weighted else None
    jw = jnp.asarray(wts) if weighted else None
    wt = torch.from_numpy(table.copy()).requires_grad_()
    yt = tt.embedding_bag(wt, ts, tw, combiner)
    (yt * torch.from_numpy(g)).sum().backward()
    yj, vjp = jax.vjp(lambda w: bt.embedding_bag(w, js, jw, combiner),
                      jnp.asarray(table))
    _eq(yt, yj)
    _eq(yt[1], np.zeros(8, np.float32))
    _eq(wt.grad, vjp(jnp.asarray(g))[0])


def test_embedding_bag_max_norm_within_1e_6():
    idx, vals, shape, _ = _bags(6)
    table = 3 * np.random.RandomState(7).randn(10, 8).astype(np.float32)
    ts, js = _both(idx, vals, shape)
    yt = tt.embedding_bag(torch.from_numpy(table), ts, combiner="mean",
                          max_norm=1.5)
    yj = bt.embedding_bag(jnp.asarray(table), js, combiner="mean",
                          max_norm=1.5)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [0.0, 11.0, -1.0])
def test_embedding_bag_out_of_range_ids(bad, monkeypatch):
    """Ids on the host raise as the reference's concrete ids do; on a
    device (no host check) the offending bag is NaN, as under the
    reference's trace, and the others are untouched."""
    table = torch.zeros((10, 4))
    ts = tt.SparseTensor(np.array([[0, 1], [0, 0]], np.int32),
                         np.array([1.0, bad], np.float32), (2, 2))
    with pytest.raises(IndexError, match="out of range"):
        tt.embedding_bag(table, ts)
    js = bt.SparseTensor(np.array([[0, 1], [0, 0]], np.int32),
                         np.array([1.0, bad], np.float32), (2, 2))
    with pytest.raises(IndexError, match="out of range"):
        bt.embedding_bag(jnp.zeros((10, 4)), js)
    monkeypatch.setattr(tt, "_check_ids", lambda *a: None)
    y = tt.embedding_bag(table, ts)
    assert torch.isnan(y[1]).all() and torch.isfinite(y[0]).all()


def test_quantize_symmetric_and_quantized_tensor():
    x = np.random.RandomState(4).randn(6, 8).astype(np.float32)
    for axis in (None, 0, 1):
        q, s = tt.quantize_symmetric(torch.from_numpy(x), axis=axis)
        qj, sj = bt.quantize_symmetric(jnp.asarray(x), axis=axis)
        _eq(q, qj)
        _eq(s, sj)
        _eq(tt.dequantize(q, s), bt.dequantize(qj, sj))
    qt = tt.QuantizedTensor.quantize(torch.from_numpy(x), axis=0)
    qr = bt.QuantizedTensor.quantize(jnp.asarray(x), axis=0)
    _eq(qt.dequantize(), qr.dequantize())
    assert qt.shape == tuple(qr.shape) and qt.dtype == torch.int8
    assert qt.axis == 0


# --------------------------------------------------------------------- #
# nn/sparse.py and BCECriterion                                         #
# --------------------------------------------------------------------- #
def _port_of(jm, tm):
    params, _ = jm.init_params(0)
    from_jax_params({k: {n: np.asarray(a) for n, a in sub.items()}
                     for k, sub in params.items()}, tm)
    return params


def test_sparse_linear_is_the_references():
    rs = np.random.RandomState(0)
    d = (rs.rand(5, 8) * (rs.rand(5, 8) > 0.6)).astype(np.float32)
    jm = jnn.SparseLinear(8, 4, name="sl")
    tm = tnn.SparseLinear(8, 4, name="sl")
    params = _port_of(jm, tm)
    ts, js = _sparse_pair(d)
    _eq(tm.run(tm.param_dict(), ts)[0], jm.run(params, js)[0])


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_is_the_references(combiner):
    idx, vals, shape, wts = _bags(9, n_bags=4, v=5)
    jm = jnn.LookupTableSparse(5, 4, combiner=combiner, name="lt")
    tm = tnn.LookupTableSparse(5, 4, combiner=combiner, name="lt")
    params = _port_of(jm, tm)
    ts, js = _both(idx, vals, shape)
    _eq(tm.run(tm.param_dict(), ts)[0], jm.run(params, js)[0])
    # (ids, weights): a table of two SparseTensors of one sparsity
    tw, jw = _both(idx, wts, shape)
    from bigdl_tpu.utils.table import T
    _eq(tm.run(tm.param_dict(), (ts, tw))[0], jm.run(params, T(js, jw))[0])


def test_sparse_join_table_is_the_references():
    from bigdl_tpu.utils.table import T
    a = np.array([[1, 0], [0, 2]], np.float32)
    b = np.array([[0, 3], [4, 0]], np.float32)
    (ta, ja), (tb, jb) = _sparse_pair(a), _sparse_pair(b)
    for dim in (1, 2):
        got = tnn.SparseJoinTable(dim).run({}, (ta, tb))[0]
        want = jnn.SparseJoinTable(dim).run({}, T(ja, jb))[0]
        _eq(got.to_dense(), want.to_dense())


@pytest.mark.parametrize("weights,size_average", [
    (None, True), (None, False), ("w", True)])
def test_bce_criterion_within_1e_6(weights, size_average):
    rs = np.random.RandomState(1)
    p = rs.rand(6, 3).astype(np.float32)
    p[0, 0], p[1, 1] = 0.0, 1.0              # the clamp at 1e-12
    t = (rs.rand(6, 3) > 0.5).astype(np.float32)
    w = rs.rand(3).astype(np.float32) if weights else None
    tc = tnn.BCECriterion(weights=w, size_average=size_average)
    jc = jnn.BCECriterion(weights=w, size_average=size_average)
    pt = torch.from_numpy(p).requires_grad_()
    lt = tc.forward(pt, torch.from_numpy(t))
    lj, gj = jax.value_and_grad(lambda x: jc.forward(x, jnp.asarray(t)))(
        jnp.asarray(p))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    lt.backward()
    np.testing.assert_allclose(_np(pt.grad), _np(gj), rtol=1e-6, atol=1e-6)
