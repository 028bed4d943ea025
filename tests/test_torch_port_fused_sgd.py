"""The launch plan of the port's multi-tensor SGD kernels (K5, K6 in
``bigdl_tpu_torch/csrc/fused_sgd.cu``), on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it bitwise
against the plain update.  What surrounds it is Python and is tested here:
the leaf tables that ``fused_optim.leaf_tables`` builds (chunk prefix sums,
the split into launches, each gradient's layout tag and the float4
alignment flag), a numpy emulation of the kernel's block -> (leaf, chunk)
-> element map and of its channels-last index map, and the wrapper's one
C call per table, recorded with the C function replaced.  The JAX
reference (``bigdl_tpu/kernels/fused_optim.py``, ``_run_blocked``) pads
each leaf to (rows, 128) tiles and launches once per leaf; its values are
held against the port's in ``tests/test_torch_port_optim.py``.
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

CSRC = Path(fo.__file__).resolve().parent.parent / "csrc"
CU = CSRC / "fused_sgd.cu"
CUH = CSRC / "multi_tensor.cuh"
CHUNK = fo.CHUNK


def _constants(cu=CU):
    src = cu.read_text() + CUH.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("NT", "VPT", "CAP")}


def test_python_constants_match_the_kernel_source():
    c = _constants()
    assert fo.SGD_CAPACITY == c["CAP"]
    assert fo.CHUNK == c["NT"] * c["VPT"] * 4
    assert "constexpr int CHUNK = NT * VPT * 4;" in CUH.read_text()


def _leaves(sizes, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for n in sizes:
        p = torch.from_numpy(rs.randn(int(n)).astype(np.float32))
        out.append((p, torch.zeros_like(p), torch.zeros_like(p)))
    return out


def _rows(tables):
    return [np.asarray(m, np.int64).reshape(-1, 5) for _, m, _ in tables]


def _emulate(meta, nt, vpt):
    """Every element each block of one launch touches, as the kernel
    computes it: the last leaf whose first chunk is <= b (binary search),
    the chunk's offset, then the float4 lanes and the ragged tail (or the
    scalar loop).  Returns one coverage count array per leaf."""
    n, start, vec = meta[:, 0], meta[:, 1], meta[:, 4]
    chunk = nt * vpt * 4
    blocks = int(start[-1] + -(-n[-1] // chunk))
    cover = [np.zeros(int(k), np.int64) for k in n]
    for b in range(blocks):
        lo, hi = 0, len(n) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if start[mid] <= b:
                lo = mid
            else:
                hi = mid - 1
        off = (b - start[lo]) * chunk
        length = min(chunk, n[lo] - off)
        assert length > 0
        if vec[lo]:
            nv = length >> 2
            j = np.arange(nt * vpt)
            j = j[j < nv]
            e = (4 * j[:, None] + np.arange(4)).ravel()
            tail = (nv << 2) + np.arange(nt)
            e = np.concatenate([e, tail[tail < length]])
        else:
            e = np.concatenate([np.arange(t, length, nt) for t in range(nt)])
        np.add.at(cover[lo], off + e, 1)
    return cover


@pytest.mark.parametrize("seed", range(4))
def test_block_map_covers_every_element_once(seed):
    rs = np.random.RandomState(seed)
    edges = [1, 3, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 5]
    sizes = list(rs.permutation(edges + list(rs.randint(1, 3 * CHUNK, 10))))
    leaves = _leaves(sizes, seed)
    if seed % 2:            # the scalar path: a leaf at a 4-byte offset
        base = torch.zeros(CHUNK + 8)
        p = base[1:CHUNK + 4]
        leaves.append((p, torch.zeros_like(p), torch.zeros_like(p)))
        sizes.append(p.numel())
    tables, kept = fo.leaf_tables(leaves, "k", ("p", "v"))
    assert len(tables) == 1 and kept == []
    (meta,) = _rows(tables)
    assert list(meta[:, 0]) == sizes
    assert meta[0, 1] == 0
    assert list(np.diff(meta[:, 1])) == [-(-n // CHUNK) for n in sizes[:-1]]
    assert (meta[:, 4] == 0).sum() == seed % 2
    c = _constants()
    for cover in _emulate(meta, c["NT"], c["VPT"]):
        assert (cover == 1).all()


@pytest.mark.parametrize("shape", [(64, 3, 7, 7), (512, 512, 3, 3),
                                   (2048, 512, 1, 1)])
def test_channels_last_index_map_reads_the_contiguous_gradient(shape):
    """The kernel's map from p's element ((o*I + i)*HW + hw) to g's
    ((o*HW + hw)*I + i), in 32-bit arithmetic as on the card, picks what
    g.contiguous() holds; a 1x1 conv's channels-last gradient counts as
    contiguous (PyTorch ignores the strides of size-1 dims)."""
    g = torch.randn(shape).contiguous(memory_format=torch.channels_last)
    want = g.contiguous().flatten().numpy()
    mem = torch.as_strided(g, (g.numel(),), (1,)).numpy()
    cin, hw = fo.grad_layout(g)
    if shape[2:] == (1, 1):
        assert (cin, hw) == (0, 0)
        np.testing.assert_array_equal(mem, want)
        return
    assert (cin, hw) == (shape[1], shape[2] * shape[3])
    e = np.arange(g.numel(), dtype=np.uint32)
    per_o = np.uint32(cin * hw)
    o = e // per_o
    r = e - o * per_o
    i = r // np.uint32(hw)
    s = r - i * np.uint32(hw)
    idx = (o * np.uint32(hw) + s) * np.uint32(cin) + i
    np.testing.assert_array_equal(mem[idx], want)


def test_layout_tags_alignment_and_copies():
    p4 = torch.zeros(8, 4, 3, 3)
    g_cl = torch.randn(8, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    p2 = torch.zeros(6, 5)
    g_t = torch.randn(5, 6).t()                 # neither layout: a copy
    base = torch.zeros(64)
    p_off = base[1:33]                          # a view at a 4-byte offset
    g_off = torch.zeros(40)[3:35]
    v_off = torch.zeros(40)[2:34]               # 8 bytes: not a float4's 16
    leaves = [(p4, g_cl, torch.zeros_like(p4)),
              (p2, g_t, torch.zeros_like(p2)),
              (p_off, torch.zeros(32), torch.zeros(32)),
              (torch.zeros(32), g_off, torch.zeros(32)),
              (torch.zeros(32), torch.zeros(32), v_off)]
    assert fo.grad_layout(g_t) is None
    tables, kept = fo.leaf_tables(leaves, "k", ("p", "v"))
    (ptrs, meta, count), = tables
    rows = np.asarray(meta).reshape(-1, 5)
    assert count == 5 and len(kept) == 1
    assert [tuple(r[2:4]) for r in rows] == [(4, 9)] + [(0, 0)] * 4
    # a channels-last g is gathered: only p and v need to be aligned
    assert list(rows[:, 4]) == [1, 1, 0, 0, 0]
    addr = np.asarray(ptrs).reshape(-1, 3)
    assert addr[0, 1] == g_cl.data_ptr()
    assert addr[1, 1] != g_t.data_ptr()         # the copy's address
    assert addr[2, 0] == p_off.data_ptr()


@pytest.mark.parametrize("count", [1, 719, 720, 721, 2000])
def test_over_capacity_plans_ceil_launches(count):
    sizes = np.random.RandomState(count).randint(1, 301, size=count)
    leaves = _leaves(sizes)
    tables, _ = fo.leaf_tables(leaves, "k", ("p", "v"))
    cap = fo.SGD_CAPACITY
    assert len(tables) == -(-count // cap)
    assert [c for _, _, c in tables] == [min(cap, count - lo)
                                         for lo in range(0, count, cap)]
    done = 0
    for (ptrs, _, c), meta in zip(tables, _rows(tables)):
        assert meta[0, 1] == 0                  # chunks count per launch
        assert list(meta[:, 0]) == list(sizes[done:done + c])
        assert np.asarray(ptrs).reshape(-1, 3)[0, 0] == \
            leaves[done][0].data_ptr()
        done += c
    assert done == count


def test_k6_tables_leave_the_velocity_slot_empty():
    leaves = [(p, g) for p, g, _ in _leaves([5, 9])]
    tables, _ = fo.leaf_tables(leaves, "k", ("p",))
    (ptrs, meta, count), = tables
    addr = np.asarray(ptrs).reshape(-1, 3)
    assert count == 2 and (addr[:, 2] == 0).all()
    assert list(addr[:, 1]) == [g.data_ptr() for _, g in leaves]


def test_zip_leaves_flattens_in_the_first_trees_order():
    a = {"x": {"w": 1, "b": 2}, "y": {"w": 3}}
    b = {"y": {"w": 30}, "x": {"b": 20, "w": 10}}
    assert fo.zip_leaves(a, b) == [(1, 10), (2, 20), (3, 30)]
    t = torch.zeros(2)
    assert fo.zip_leaves(t, t) == [(t, t)]
    assert fo.zip_leaves(types.MappingProxyType({"k": t})) == [(t,)]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper
    without a card (the C function is replaced by a recorder)."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the C function of K5/K6 with one that records, at call
    time, the leaf table it was handed; no CUDA runtime is touched."""
    calls = []

    def fn(ptrs, meta, count, *tail):
        calls.append({
            "ptrs": list((ctypes.c_int64 * (3 * count)).from_address(ptrs)),
            "meta": list((ctypes.c_int64 * (5 * count)).from_address(meta)),
            "count": count, "tail": tail})
        return 0
    monkeypatch.setattr(fo, "_sgd_fn", lambda mom, dtype=torch.float32: fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return calls


def _card_trees(sizes, mom=True, seed=0):
    rs = np.random.RandomState(seed)
    params, grads, vel = {}, {}, {}
    for i, n in enumerate(sizes):
        shape = (int(n),) if i % 7 else (int(n), 2, 3, 3)
        p = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        if len(shape) == 4:                  # cuDNN's weight-gradient layout
            g = g.contiguous(memory_format=torch.channels_last)
        params[f"m{i}"] = {"weight": p.as_subclass(_OnCard)}
        grads[f"m{i}"] = {"weight": g.as_subclass(_OnCard)}
        vel[f"m{i}"] = {"weight": torch.zeros_like(p).as_subclass(_OnCard)}
    return params, grads, (vel if mom else None)


@pytest.mark.parametrize("mom", [True, False])
def test_one_update_of_161_leaves_is_one_call(recorder, mom):
    from bigdl_tpu_torch.ops import _build
    sizes = np.random.RandomState(1).randint(1, 3000, size=161)
    params, grads, vel = _card_trees(sizes, mom)
    clr = torch.full((), 0.1).as_subclass(_OnCard)
    kernel = fo.SGD_MOM if mom else fo.SGD_PLAIN
    before = _build.launch_counts().get(kernel, 0)
    fo.fused_sgd_update(params, grads, vel, clr=clr,
                        momentum=0.9 if mom else 0.0, dampening=0.9,
                        weight_decay=1e-4)
    assert _build.launch_counts().get(kernel, 0) - before == 1
    (call,) = recorder
    assert call["count"] == 161
    leaves = fo.zip_leaves(params, grads, vel or grads)
    addr = np.asarray(call["ptrs"]).reshape(-1, 3)
    assert list(addr[:, 0]) == [p.data_ptr() for p, _, _ in leaves]
    # the channels-last gradients are handed over in place: no copy
    assert list(addr[:, 1]) == [g.data_ptr() for _, g, _ in leaves]
    assert list(addr[:, 2]) == ([v.data_ptr() for _, _, v in leaves]
                                if mom else [0] * 161)
    meta = np.asarray(call["meta"]).reshape(-1, 5)
    assert (meta[::7, 2:4] == [2, 9]).all() and (meta[1::7, 2] == 0).all()
    tail = call["tail"]
    assert tail[0] == clr.data_ptr() and tail[-1] == 7       # the stream
    if mom:     # mu, 1 - dampening, wd, decay, nesterov
        assert tail[1:6] == (0.9, 1.0 - 0.9, 1e-4, 1, 0)
    else:       # wd, decay
        assert tail[1:3] == (1e-4, 1)


def test_each_update_builds_its_table_anew(recorder):
    params, grads, vel = _card_trees([10, 20, 30])
    clr = torch.full((), 0.1).as_subclass(_OnCard)
    fo.fused_sgd_update(params, grads, vel, clr=clr, momentum=0.9)
    grads2 = {k: {"weight": (t["weight"] * 2).as_subclass(_OnCard)}
              for k, t in grads.items()}
    fo.fused_sgd_update(params, grads2, vel, clr=clr, momentum=0.9)
    first, second = (np.asarray(c["ptrs"]).reshape(-1, 3) for c in recorder)
    assert list(second[:, 1]) == [t["weight"].data_ptr()
                                  for t in grads2.values()]
    assert (first[:, 0] == second[:, 0]).all()
    assert not (first[:, 1] == second[:, 1]).any()


@pytest.mark.parametrize("bad,err,match", [
    ("bf16 last", NotImplementedError, "takes float32"),
    ("bf16 velocity", NotImplementedError, "takes float32"),
    ("shape", ValueError, "does not match"),
    ("strided v", ValueError, "contiguous"),
    ("clr", ValueError, "clr must be one float32"),
])
def test_checks_raise_before_any_call(recorder, bad, err, match):
    params, grads, vel = _card_trees(range(1, 162))
    last = params["m160"]["weight"]
    if bad == "bf16 last":
        params["m160"]["weight"] = last.to(torch.bfloat16)
    elif bad == "bf16 velocity":
        vel["m160"]["weight"] = vel["m160"]["weight"].to(torch.bfloat16)
    elif bad == "shape":
        grads["m160"]["weight"] = torch.zeros(3).as_subclass(_OnCard)
    elif bad == "strided v":
        vel["m160"]["weight"] = torch.zeros(2 * last.numel())[::2] \
            .as_subclass(_OnCard)
    clr = torch.full((), 0.1, dtype=torch.float64 if bad == "clr"
                     else torch.float32).as_subclass(_OnCard)
    with pytest.raises(err, match=match):
        fo.fused_sgd_update(params, grads, vel, clr=clr, momentum=0.9)
    assert recorder == []


def test_empty_leaves_are_skipped_in_the_table(recorder):
    params, grads, vel = _card_trees([4, 0, 6])
    clr = torch.full((), 0.1).as_subclass(_OnCard)
    fo.fused_sgd_update(params, grads, vel, clr=clr, momentum=0.9)
    (call,) = recorder
    assert call["count"] == 2
    assert np.asarray(call["meta"]).reshape(-1, 5)[:, 0].tolist() == \
        [4 * 2 * 3 * 3, 6]            # leaf 0 is a (4, 2, 3, 3) conv weight
