"""The launch plan of the port's multi-tensor Adam/AdamW kernel (K4 in
``bigdl_tpu_torch/csrc/fused_adam.cu``), on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it bitwise
against the plain update.  What surrounds it is Python and is tested here:
the leaf tables of four pointers a leaf that ``fused_optim.leaf_tables``
builds for it (beside K5/K6's tables of three, which stay as they were), a
numpy emulation of the kernel's block -> (leaf, chunk) -> element map, and
the wrapper's one C call per table, recorded with the C function replaced.
The JAX reference (``bigdl_tpu/kernels/fused_optim.py``, ``_adam_kernel``
via ``_run_blocked``) launches once per leaf; its values are held against
the port's in ``tests/test_torch_port_optim.py``.
"""
import contextlib
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.kernels import fused_optim as fo
from bigdl_tpu_torch.ops import _build
from test_torch_port_fused_sgd import _OnCard, _emulate, _rows

CSRC = Path(fo.__file__).resolve().parent.parent / "csrc"
CHUNK = fo.CHUNK
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8)


def _constants(cu):
    src = (CSRC / cu).read_text() + (CSRC / "multi_tensor.cuh").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("NT", "VPT", "CAP", "PARAM_BYTES")}


def _param_bytes(nptr, cap, n_ptr_args, n_float_args):
    """Bytes of a launch's kernel parameters: mt::LeafTable<nptr, cap> as
    the compiler lays it out, then the kernel's pointer and float
    arguments."""
    size = 8 * nptr * cap + 8 * cap + 3 * 4 * cap + cap     # ... vec[cap]
    size = -(-size // 4) * 4 + 4                            # int32 count
    size = -(-size // 8) * 8                                # 8-byte align
    return size + 8 * n_ptr_args + 4 * n_float_args


@pytest.mark.parametrize("cu,cap,nptr,args", [
    ("fused_adam.cu", fo.ADAM_CAPACITY, 4, (3, 6)),   # clr, bc1, bc2; 6 f
    ("fused_sgd.cu", fo.SGD_CAPACITY, 3, (1, 3)),     # clr; mu, omd, wd
])
def test_capacity_is_the_largest_multiple_of_8_that_fits(cu, cap, nptr,
                                                         args):
    c = _constants(cu)
    assert cap == c["CAP"]
    assert fo.CHUNK == c["NT"] * c["VPT"] * 4 == 4096
    assert _param_bytes(nptr, cap, *args) <= c["PARAM_BYTES"] == 32764
    assert _param_bytes(nptr, cap + 8, *args) > c["PARAM_BYTES"]


def _leaves(sizes, seed=0, state=2):
    rs = np.random.RandomState(seed)
    out = []
    for n in sizes:
        p = torch.from_numpy(rs.randn(int(n)).astype(np.float32))
        out.append((p, torch.randn(int(n)),
                    *(torch.zeros_like(p) for _ in range(state))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_block_map_covers_every_element_once(seed):
    rs = np.random.RandomState(seed)
    edges = [1, 3, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 5]
    sizes = list(rs.permutation(edges + list(rs.randint(1, 3 * CHUNK, 10))))
    leaves = _leaves(sizes, seed)
    if seed % 2:            # the scalar path: m at a 4-byte offset
        p = torch.zeros(CHUNK + 3)
        m = torch.zeros(CHUNK + 8)[1:CHUNK + 4]
        leaves.append((p, torch.zeros_like(p), m, torch.zeros_like(p)))
        sizes.append(p.numel())
    tables, kept = fo.leaf_tables(leaves, "k", ("p", "m", "v"))
    assert len(tables) == 1 and kept == []
    (meta,) = _rows(tables)
    assert list(meta[:, 0]) == sizes
    assert list(np.diff(meta[:, 1])) == [-(-n // CHUNK) for n in sizes[:-1]]
    assert (meta[:, 4] == 0).sum() == seed % 2
    c = _constants("fused_adam.cu")
    for cover in _emulate(meta, c["NT"], c["VPT"]):
        assert (cover == 1).all()


def test_k4_tables_carry_m_beside_k5s_and_k6s_tables_as_they_were():
    """The same leaves give K5 (p, g, v), K6 (p, g) and K4 (p, g, m, v)
    tables with the same meta; K5/K6 keep three pointers a leaf, K6's
    third 0, and K4 takes m between g and v."""
    base = _leaves([5, 9, CHUNK + 1, 2], state=2)
    k4, _ = fo.leaf_tables(base, "k", ("p", "m", "v"))
    k5, _ = fo.leaf_tables([(p, g, v) for p, g, _, v in base], "k",
                           ("p", "v"))
    k6, _ = fo.leaf_tables([(p, g) for p, g, _, _ in base], "k", ("p",))
    rows = {name: np.asarray(t[0][0]).reshape(4, -1)
            for name, t in (("k4", k4), ("k5", k5), ("k6", k6))}
    want = np.asarray([[t.data_ptr() for t in leaf] for leaf in base])
    np.testing.assert_array_equal(rows["k4"], want)
    np.testing.assert_array_equal(rows["k5"], want[:, [0, 1, 3]])
    np.testing.assert_array_equal(rows["k6"][:, :2], want[:, :2])
    assert (rows["k6"][:, 2] == 0).all()
    for t in (k5, k6):
        assert list(t[0][1]) == list(k4[0][1]) and t[0][2] == 4


@pytest.mark.parametrize("count", [1, 615, 616, 617, 2000])
def test_over_capacity_plans_ceil_launches(count):
    sizes = np.random.RandomState(count).randint(1, 301, size=count)
    leaves = _leaves(sizes)
    tables, _ = fo.leaf_tables(leaves, "k", ("p", "m", "v"))
    cap = fo.ADAM_CAPACITY
    assert [c for _, _, c in tables] == [min(cap, count - lo)
                                         for lo in range(0, count, cap)]
    done = 0
    for (ptrs, _, c), meta in zip(tables, _rows(tables)):
        assert meta[0, 1] == 0                  # chunks count per launch
        assert list(meta[:, 0]) == list(sizes[done:done + c])
        assert np.asarray(ptrs).reshape(-1, 4)[0, 2] == \
            leaves[done][2].data_ptr()
        done += c
    assert done == count


@pytest.fixture
def recorder(monkeypatch):
    """Replaces K4's C function with one that records, at call time, the
    leaf table it was handed; no CUDA runtime is touched."""
    calls = []

    def fn(ptrs, meta, count, *tail):
        calls.append({
            "ptrs": list((ctypes.c_int64 * (4 * count)).from_address(ptrs)),
            "meta": list((ctypes.c_int64 * (5 * count)).from_address(meta)),
            "count": count, "tail": tail})
        return 0
    monkeypatch.setattr(fo, "_adam_fn", lambda dtype=torch.float32: fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return calls


def _card_trees(sizes, seed=0):
    """params, grads, m, v of leaves of ``sizes``; every seventh leaf is a
    conv weight (n, 2, 3, 3) whose gradient is channels-last."""
    rs = np.random.RandomState(seed)
    trees = ({}, {}, {}, {})
    for i, n in enumerate(sizes):
        shape = (int(n),) if i % 7 else (int(n), 2, 3, 3)
        p = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        if len(shape) == 4:                  # cuDNN's weight-gradient layout
            g = g.contiguous(memory_format=torch.channels_last)
        for tree, t in zip(trees, (p, g, torch.zeros_like(p),
                                   torch.zeros_like(p))):
            tree[f"m{i}"] = {"weight": t.as_subclass(_OnCard)}
    return trees


def _scalars(dtype=torch.float32):
    return {k: torch.full((), x, dtype=dtype).as_subclass(_OnCard)
            for k, x in (("clr", 3e-4), ("bc1", 0.1), ("bc2", 0.001))}


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_one_update_of_111_leaves_is_one_call(recorder, wd):
    sizes = np.random.RandomState(1).randint(1, 3000, size=111)
    trees = _card_trees(sizes)
    sc = _scalars()
    before = _build.launch_counts().get(fo.KERNEL_NAME, 0)
    fo.fused_adam_update(*trees, **sc, **ADAM, weight_decay=wd)
    assert _build.launch_counts().get(fo.KERNEL_NAME, 0) - before == 1
    (call,) = recorder
    assert call["count"] == 111
    leaves = fo.zip_leaves(*trees)
    addr = np.asarray(call["ptrs"]).reshape(-1, 4)
    # p, g, m, v; the channels-last gradients are handed over in place
    for j in range(4):
        assert list(addr[:, j]) == [leaf[j].data_ptr() for leaf in leaves]
    meta = np.asarray(call["meta"]).reshape(-1, 5)
    assert list(meta[:, 0]) == [leaf[0].numel() for leaf in leaves]
    assert (meta[::7, 2:4] == [2, 9]).all() and (meta[1::7, 2] == 0).all()
    tail = call["tail"]
    assert tail[:3] == tuple(sc[k].data_ptr() for k in ("clr", "bc1", "bc2"))
    assert tail[3:] == (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8, wd,
                        int(wd > 0), 7)              # ..., decay, stream


def test_over_capacity_update_is_two_calls(recorder):
    cap = fo.ADAM_CAPACITY
    trees = _card_trees([3] * (cap + 1))
    before = _build.launch_counts().get(fo.KERNEL_NAME, 0)
    fo.fused_adam_update(*trees, **_scalars(), **ADAM)
    assert _build.launch_counts().get(fo.KERNEL_NAME, 0) - before == 2
    assert [c["count"] for c in recorder] == [cap, 1]
    last = trees[3][f"m{cap}"]["weight"]
    assert recorder[1]["ptrs"][3] == last.data_ptr()


def test_empty_leaves_are_skipped_in_the_table(recorder):
    trees = _card_trees([4, 0, 6])
    fo.fused_adam_update(*trees, **_scalars(), **ADAM)
    (call,) = recorder
    assert call["count"] == 2
    assert np.asarray(call["meta"]).reshape(-1, 5)[:, 0].tolist() == \
        [4 * 2 * 3 * 3, 6]            # leaf 0 is a (4, 2, 3, 3) conv weight


def test_a_gradient_in_neither_layout_is_copied_and_kept(recorder):
    trees = _card_trees([5, 6])
    g_t = torch.randn(6, 5).t().as_subclass(_OnCard)
    trees[0]["m1"]["weight"] = torch.zeros(5, 6).as_subclass(_OnCard)
    trees[2]["m1"]["weight"] = torch.zeros(5, 6).as_subclass(_OnCard)
    trees[3]["m1"]["weight"] = torch.zeros(5, 6).as_subclass(_OnCard)
    trees[1]["m1"]["weight"] = g_t
    fo.fused_adam_update(*trees, **_scalars(), **ADAM)
    (call,) = recorder
    addr = np.asarray(call["ptrs"]).reshape(-1, 4)
    assert addr[1, 1] != g_t.data_ptr()         # the contiguous copy's
    assert addr[0, 1] == trees[1]["m0"]["weight"].data_ptr()


@pytest.mark.parametrize("bad,err,match", [
    ("bf16 last", NotImplementedError, "takes float32"),
    ("bf16 m", NotImplementedError, "takes float32"),
    ("shape", ValueError, "does not match"),
    ("strided v", ValueError, "contiguous"),
    ("clr", ValueError, "clr must be one float32"),
    ("bc2 of two", ValueError, "bc2 must be one float32"),
])
def test_checks_raise_before_any_call(recorder, bad, err, match):
    params, grads, m, v = _card_trees(range(1, 112))
    last = params["m110"]["weight"]
    sc = _scalars(torch.float64 if bad == "clr" else torch.float32)
    if bad == "bf16 last":
        params["m110"]["weight"] = last.to(torch.bfloat16)
    elif bad == "bf16 m":
        m["m110"]["weight"] = m["m110"]["weight"].to(torch.bfloat16)
    elif bad == "shape":
        grads["m110"]["weight"] = torch.zeros(3).as_subclass(_OnCard)
    elif bad == "strided v":
        v["m110"]["weight"] = torch.zeros(2 * last.numel())[::2] \
            .as_subclass(_OnCard)
    elif bad == "bc2 of two":
        sc["bc2"] = torch.ones(2).as_subclass(_OnCard)
    with pytest.raises(err, match=match):
        fo.fused_adam_update(params, grads, m, v, **sc, **ADAM)
    assert recorder == []
