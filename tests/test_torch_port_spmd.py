"""The port's SpmdTrainer over a composed mesh against the reference.

The reference runs its GSPMD trainer on the 8 virtual CPU devices of
``tests/conftest.py``; the port runs ``SpmdTrainer`` over gloo ranks
(``_torch_port_spmd_rank.py``, spawned once for the module while the
reference runs), each rank on its shard, with the reference's weights
(``from_jax_params``).  The bands are the reference's own
(``tests/test_parallel.py``, ``tests/test_compose.py``): a loss within
1e-4, parameters within rtol 1e-3 / atol 2e-4 of the reference at the same
mesh, and a mesh against one device within rtol 2e-3.

Also here: ring attention against full attention (over ranks, and its
merge order in one process), the layouts against the reference's
sharding metadata, zero1, ``compose.build_trainer``, and the plain
versions of K4–K6 on a tree of f32 and bf16 leaves against the
reference's ``fused_adam_update`` / ``fused_sgd_update``.
"""
import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels import fused_optim as jfo
from bigdl_tpu.models import transformer as JT
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Adam as JAdam
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.parallel.spmd import SpmdTrainer as JSpmd
from bigdl_tpu_torch.kernels import fused_optim as tfo
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.ops.flash_attention import attention_reference
from bigdl_tpu_torch.optim import SGD, Adam
from bigdl_tpu_torch.parallel import SpmdTrainer, spmd as tspmd
from bigdl_tpu_torch.parallel import mesh as tmesh
from bigdl_tpu_torch.parallel.compose import ComposedConfig, build_trainer
from bigdl_tpu_torch.parallel.ring_attention import ring_attention_merge

from _torch_port_spmd_rank import collect, save_npz, spawn

LOSS_ABS = 1e-4                         # port vs reference, same mesh
PARAM_TOL = dict(rtol=1e-3, atol=2e-4)
SINGLE_RTOL = 2e-3                      # a mesh vs one device
Z1_TOL = dict(rtol=1e-5, atol=1e-6)     # zero1 Adam vs unsharded
ATTN_TOL = 1e-4                         # the ring vs full attention
STEPS = 2
Z1_MODEL = dict(dropout=0.0, n_layers=2, d_model=64, n_heads=2, d_ff=128,
                vocab_size=64, max_len=32)
MESHES = {"ring": ({"dp": 2, "tp": 2, "sp": 2}, True, False),
          "fsdp": ({"dp": 2, "fsdp": 2, "tp": 2}, False, True)}
SP_GATHER = {"dp": 4, "sp": 2}          # sp without the ring
BF16_MODEL = dict(dtype="bfloat16")


def _lm_batch(b=4, s=64, vocab=256, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, (b, s + 1))
    return tok[:, :-1], tok[:, 1:]


def _qkv(b=2, h=4, s=64, d=32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


def _suffix(tree):
    """A param tree keyed by the module name after its root."""
    return {mod.split(".", 1)[1] if "." in mod else "": dict(sub)
            for mod, sub in tree.items()}


@contextlib.contextmanager
def _ref_mesh(axes):
    saved = jmesh._current_mesh
    try:
        yield jmesh.create_mesh(axes)
    finally:
        jmesh.set_mesh(saved)


def _ref_train(axes, ring, fsdp, x, y, optim=None, model_kw=None,
               **trainer_kw):
    """The reference's trainer: (per-step losses, final params, trainer)."""
    with _ref_mesh(axes) as mesh:
        model = JT.build("tiny", use_ring_attention=ring,
                         **(model_kw or {}))
        tr = JSpmd(model, optim or JSGD(learning_rate=0.1), mesh=mesh,
                   fsdp=fsdp, seed=0, min_fsdp_size=1, **trainer_kw).init()
        losses = [float(tr.step(x, y)) for _ in range(STEPS)]
        params = jax.tree_util.tree_map(np.asarray, tr.params)
        tr.detach()
    return losses, params, tr


def _weights(model_kw=None, ring=False):
    return jax.tree_util.tree_map(np.asarray, JT.build(
        "tiny", use_ring_attention=ring, **(model_kw or {})).init(
            jax.random.PRNGKey(0)))


def _job(name, mesh, weights, batch, ring=False, fsdp=False, optim=None,
         model_kw=None, **trainer):
    return {"name": name, "mesh": mesh, "weights": weights, "batch": batch,
            "model": {"preset": "tiny", "overrides": {
                "use_ring_attention": ring, **(model_kw or {})}},
            "optim": optim or ["SGD", {"learning_rate": 0.1}],
            "trainer": {"fsdp": fsdp, "min_fsdp_size": 1, **trainer},
            "steps": STEPS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results (8 gloo ranks, one spawn) and the reference's
    runs, made while the ranks run."""
    d = tmp_path_factory.mktemp("spmd")
    w = str(d / "w.npz")
    save_npz(w, _weights())
    wz = str(d / "wz.npz")
    save_npz(wz, _weights(Z1_MODEL))
    x, y = _lm_batch()
    np.savez(d / "b4.npz", x=x, y=y)
    x8, y8 = _lm_batch(b=8, seed=1)
    np.savez(d / "b8.npz", x=x8, y=y8)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 64, (8, 17))
    np.savez(d / "bz.npz", x=tok[:, :-1], y=tok[:, 1:])
    q, k, v = _qkv()
    np.savez(d / "qkv.npz", q=q, k=k, v=v)
    b4, b8, bz = (str(d / f) for f in ("b4.npz", "b8.npz", "bz.npz"))
    z1 = dict(model_kw=Z1_MODEL, zero1_min_size=0)
    jobs = [
        _job("ring", MESHES["ring"][0], w, b4, ring=True, evaluate=True),
        _job("fsdp", MESHES["fsdp"][0], w, b4, fsdp=True, telemetry=True,
             count_saved=True),
        _job("fsdp_bf16", MESHES["fsdp"][0], w, b4, fsdp=True,
             count_saved=True, model_kw=BF16_MODEL),
        _job("dp8", {"dp": 8}, w, b8),
        _job("tp2", {"dp": 4, "tp": 2}, w, b8),
        _job("sp2", {"dp": 4, "sp": 2}, w, b8, ring=True),
        _job("sp2_gather", SP_GATHER, w, b8),
        _job("z1_sgd", {"dp": 4, "tp": 2}, wz, bz, zero1=True,
             optim=["SGD", {"learning_rate": 0.1, "momentum": 0.9}], **z1),
        _job("sgd", {"dp": 4, "tp": 2}, wz, bz,
             optim=["SGD", {"learning_rate": 0.1, "momentum": 0.9}], **z1),
        _job("z1_adam", {"dp": 4, "tp": 2}, wz, bz, zero1=True,
             optim=["Adam", {"learning_rate": 1e-3}], **z1),
        _job("adam", {"dp": 4, "tp": 2}, wz, bz,
             optim=["Adam", {"learning_rate": 1e-3}], **z1),
    ]
    for job in jobs:        # the rank helper's own keys, not trainer kw
        for key in ("model_kw", "evaluate", "telemetry", "count_saved"):
            val = job["trainer"].pop(key, None)
            if key == "model_kw" and val:
                job["model"]["overrides"].update(val)
            elif val:
                job[key] = val
    qkv = str(d / "qkv.npz")
    jobs += [{"kind": "ring", "name": f"attn_{c}_{bk}", "qkv": qkv,
              "causal": c, "block_k": bk}
             for c, bk in ((False, None), (True, None), (True, 3),
                           (False, 3))]
    started = spawn(8, jobs, d)
    ref = {name: _ref_train(axes, ring, fsdp, x, y)[:2]
           for name, (axes, ring, fsdp) in MESHES.items()}
    ref["sp2_gather"] = _ref_train(SP_GATHER, False, False, x8, y8)[:2]
    with _ref_mesh({"dp": 4, "tp": 2}) as mesh:
        zt = JSpmd(JT.build("tiny", **Z1_MODEL), JAdam(1e-3), mesh=mesh,
                   fsdp=False, seed=0, zero1=True, zero1_min_size=0).init()
        ref["z1_shapes"] = {
            "/".join(str(getattr(p, "key", p)) for p in path):
            tuple(leaf.sharding.shard_shape(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                zt.opt_state)[0] if leaf.ndim}
    ranks = collect(started)
    return {"ranks": ranks, "ref": ref, "w": _weights(), "x": x, "y": y,
            "x8": x8, "y8": y8, "qkv": (q, k, v)}


def _single(np_params, x, y, **model_kw):
    """The port on one device from the same weights: per-step losses and
    final params."""
    tm = TT.build("tiny", device="cpu", **model_kw)
    from_jax_params(np_params, tm)
    tr = SpmdTrainer(tm, SGD(learning_rate=0.1), device="cpu")
    losses = [float(tr.step(x, y)) for _ in range(STEPS)]
    return losses, {mod: {k: t.detach().numpy() for k, t in sub.items()}
                    for mod, sub in tr.params.items()}


def _close_params(got, want, **tol):
    got, want = _suffix(got), _suffix(want)
    assert sorted(got) == sorted(want)
    for mod in want:
        for k in want[mod]:
            np.testing.assert_allclose(got[mod][k], np.asarray(want[mod][k]),
                                       err_msg=f"{mod}.{k}", **tol)


# --------------------------------------------------------------------- #
def test_ranks_stay_jax_free_and_agree(world):
    r0 = world["ranks"][0]
    assert all(r["jax_free"] for r in world["ranks"])
    for name in ("ring", "fsdp", "fsdp_bf16", "dp8", "tp2", "sp2",
                 "sp2_gather"):
        for r in world["ranks"][1:]:
            assert r[name]["losses"] == r0[name]["losses"], name


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_matches_the_reference_and_one_device(world, name):
    """The reference's test_spmd_trainer_parallel_matches_single, on the
    port: dp2×tp2×sp2 with the ring, dp2×fsdp2×tp2 with fsdp."""
    port = world["ranks"][0][name]
    ref_losses, ref_params = world["ref"][name]
    np.testing.assert_allclose(port["losses"], ref_losses, rtol=0,
                               atol=LOSS_ABS)
    _close_params(port["params"], ref_params, **PARAM_TOL)
    single, single_params = _single(world["w"], world["x"], world["y"],
                                    use_ring_attention=MESHES[name][1])
    assert single[-1] < single[0]
    np.testing.assert_allclose(port["losses"], single, rtol=SINGLE_RTOL)
    _close_params(port["params"], single_params, rtol=SINGLE_RTOL,
                  atol=PARAM_TOL["atol"])


@pytest.mark.parametrize("name", ["tp2", "sp2"])
def test_tp_and_the_sp_ring_match_dp_only(world, name):
    r0 = world["ranks"][0]
    np.testing.assert_allclose(r0[name]["losses"], r0["dp8"]["losses"],
                               rtol=SINGLE_RTOL)
    _close_params(r0[name]["params"], r0["dp8"]["params"],
                  rtol=SINGLE_RTOL, atol=PARAM_TOL["atol"])


def test_sp_without_the_ring_matches_the_reference_and_dp_only(world):
    """dp4×sp2 with the ring off: each rank gathers q, k and v over sp (a
    reduce-scatter backward) and keeps its rows of the attention; the
    reference at the same mesh lets GSPMD place the gathers."""
    r0 = world["ranks"][0]
    port = r0["sp2_gather"]
    ref_losses, ref_params = world["ref"]["sp2_gather"]
    np.testing.assert_allclose(port["losses"], ref_losses, rtol=0,
                               atol=LOSS_ABS)
    _close_params(port["params"], ref_params, **PARAM_TOL)
    np.testing.assert_allclose(port["losses"], r0["dp8"]["losses"],
                               rtol=SINGLE_RTOL)
    _close_params(port["params"], r0["dp8"]["params"], rtol=SINGLE_RTOL,
                  atol=PARAM_TOL["atol"])


def test_fsdp_in_bf16_keeps_no_gathered_weight_for_the_backward(world):
    """dp2×fsdp2×tp2 with bf16 compute over f32 parameters: each gathered
    weight the backward needs is saved as the model's bf16 cast of it, and
    the hooks keep its shard instead and gather and cast it again, as
    many as in f32 (and it keeps as many other tensors); the losses are
    the one-device port's in bf16 (measured: within 3e-4)."""
    f32 = world["ranks"][0]["fsdp"]["saved"]
    assert f32["marks"] > 0
    for r in world["ranks"]:
        assert r["fsdp_bf16"]["saved"] == f32
    single, _ = _single(world["w"], world["x"], world["y"], **BF16_MODEL)
    np.testing.assert_allclose(world["ranks"][0]["fsdp_bf16"]["losses"],
                               single, rtol=SINGLE_RTOL)


def test_health_scalars_reduce_over_the_mesh(world):
    """The step record's norms on dp2×fsdp2×tp2 (each leaf's block summed
    once over the mesh) are the one-device trainer's."""
    from bigdl_tpu_torch.observability import Recorder
    got = world["ranks"][0]["fsdp"]["health"]
    tm = TT.build("tiny", device="cpu")
    from_jax_params(world["w"], tm)
    tr = SpmdTrainer(tm, SGD(learning_rate=0.1), device="cpu")
    tr.set_telemetry(Recorder())
    for _ in range(STEPS):
        tr.step(world["x"], world["y"])
    want = tr.recorder.recent_records(rec_type="step")[-1]["scalars"]
    keys = ("grad_norm", "param_norm", "update_norm", "update_ratio",
            "nonfinite_grads", "loss")
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=SINGLE_RTOL,
                                   err_msg=k)
        assert all(r["fsdp"]["health"][k] == got[k]
                   for r in world["ranks"]), k


def test_evaluate_reduces_over_the_mesh(world):
    got = world["ranks"][0]["ring"]["evaluate"]
    tm = TT.build("tiny", device="cpu")
    from_jax_params(world["w"], tm)
    tr = SpmdTrainer(tm, SGD(learning_rate=0.1), device="cpu")
    for _ in range(STEPS):
        tr.step(world["x"], world["y"])
    want = tr.evaluate([(world["x"], world["y"])])
    assert got["tokens"] == want["tokens"] == world["x"].size
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=SINGLE_RTOL)


def _torch_attention(q, k, v, causal):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention_reference(*ts, causal=causal)
    out.sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal,block_k", [(False, None), (True, None),
                                            (True, 3), (False, 3)])
def test_ring_attention_matches_full_attention(world, causal, block_k):
    """Eight ranks of 8 positions each; block_k 3 splits each held chunk
    into blocks that do not divide it."""
    got = [r[f"attn_{causal}_{block_k}"] for r in world["ranks"]]
    out = np.concatenate([g["out"] for g in got], axis=2)
    grads = [np.concatenate([g["grads"][i] for g in got], axis=2)
             for i in range(3)]
    want, want_g = _torch_attention(*world["qkv"], causal)
    assert np.abs(out - want).max() < ATTN_TOL
    for a, b in zip(grads, want_g):
        assert np.abs(a - b).max() < ATTN_TOL


@pytest.mark.parametrize("sp,block_k", [(4, None), (4, 6), (2, 1024)])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_merge_in_one_process_matches_full_attention(sp, block_k,
                                                          causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed=2))
    got = ring_attention_merge(q, k, v, sp, causal=causal, block_k=block_k)
    want = attention_reference(q, k, v, causal=causal)
    assert (got - want).abs().max().item() < ATTN_TOL


# the ring's merge in bf16 against the flash forward: the bf16 limit
# chip_smoke.py holds K1 to (KERNEL_TOL), and its phase_spmd the merge
RING_BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_merge_in_bf16_within_the_kernel_band(causal):
    """(1, 4, 256, 64) bf16 at sp=2, block_k 64: the merge's fp32
    accumulators rounded once to bf16, against the plain flash forward."""
    from bigdl_tpu_torch.ops.flash_attention import flash_forward_plain
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(b=1, h=4, s=256, d=64, seed=3))
    got = ring_attention_merge(q, k, v, 2, causal=causal, block_k=64)
    want, _ = flash_forward_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **RING_BF16_TOL)


@pytest.mark.parametrize("axes,fsdp,min_size", [
    ({"dp": 2, "fsdp": 2, "tp": 2}, True, 1),
    ({"dp": 2, "fsdp": 2, "tp": 2}, True, 2 ** 16),
    ({"dp": 2, "tp": 2, "sp": 2}, False, 1),
    ({"fsdp": 4, "tp": 2}, True, 4096)])
def test_layouts_match_the_references_sharding(axes, fsdp, min_size):
    """Each parameter's spec (tp from pspec, fsdp layered onto the first
    free divisible dim, the embedding exempt) equals the reference's."""
    with _ref_mesh(axes) as mesh:
        jm = JT.build("tiny")
        jp = jm.init(jax.random.PRNGKey(0))
        tr = JSpmd(jm, JSGD(learning_rate=0.1), mesh=mesh, fsdp=fsdp,
                   min_fsdp_size=min_size)
        want = jax.tree_util.tree_map(
            lambda s: tuple(s.spec) + (None,) * 4, tr._param_shardings(jp),
            is_leaf=lambda s: hasattr(s, "spec"))
    tm = TT.build("tiny", device="cpu")
    got = tspmd.param_shardings(tm, tm.param_dict(), axes, fsdp, min_size)
    want, got = _suffix(want), _suffix(got)
    assert sorted(got) == sorted(want)
    for mod in want:
        for k, spec in got[mod].items():
            assert spec == want[mod][k][:len(spec)], (mod, k)
    assert any("fsdp" in s for sub in got.values() for s in sub.values()) \
        == (fsdp and min_size <= 128 * 256)


def test_zero1_moment_shapes_equal_the_references_sharding(world):
    """Each rank's local Adam moments have the shard shape the reference's
    zero1 annotation gives them on dp4×tp2."""
    want = world["ref"]["z1_shapes"]

    def strip(path):
        parts = path.split("/")
        return "/".join(p.split(".", 1)[1] if p.startswith("TransformerLM")
                        and "." in p else p for p in parts)
    want = {strip(p): s for p, s in want.items()}
    for r in world["ranks"]:
        got = {strip(p): s for p, s in r["z1_adam"]["opt_shapes"].items()}
        assert got == want
    # the dp layer really shards: the moments hold ~1/(dp·tp) of the
    # parameters
    full = sum(int(np.prod(s)) for p, s in want.items())
    per_param = sum(int(np.prod(a.shape)) for sub in
                    _weights(Z1_MODEL).values() for a in sub.values())
    assert full < 2 * per_param / 4


def test_zero1_sgd_is_bitwise_the_unsharded_update(world):
    r0 = world["ranks"][0]
    assert r0["z1_sgd"]["losses"] == r0["sgd"]["losses"]
    for mod, sub in r0["sgd"]["params"].items():
        for k, a in sub.items():
            np.testing.assert_array_equal(
                _suffix(r0["z1_sgd"]["params"])[mod.split(".", 1)[1]][k], a)


def test_zero1_adam_within_the_references_tolerance(world):
    r0 = world["ranks"][0]
    np.testing.assert_allclose(r0["z1_adam"]["losses"],
                               r0["adam"]["losses"], rtol=Z1_TOL["rtol"])
    _close_params(r0["z1_adam"]["params"], r0["adam"]["params"], **Z1_TOL)


def test_zero1_needs_dp_and_pp_ep_raise():
    tm = TT.build("tiny", device="cpu")
    with pytest.raises(ValueError, match="dp > 1"):
        SpmdTrainer(tm, Adam(1e-3), mesh={"tp": 2}, zero1=True,
                    device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        SpmdTrainer(tm, Adam(1e-3), mesh={"dp": 2, "pp": 2}, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        SpmdTrainer(tm, Adam(1e-3), mesh={"dp": 2}, device="cpu")


def test_build_trainer_picks_the_engine_and_rejects_bad_knobs():
    def model():
        return TT.build("tiny", device="cpu")

    tr = build_trainer(model(), SGD(learning_rate=0.1),
                       ComposedConfig("dp1,fsdp1,tp1,sp1"), device="cpu")
    assert type(tr).__name__ == "SpmdTrainer" and not tr.fsdp
    assert tr._m is None and tr.mesh == {"dp": 1, "fsdp": 1, "tp": 1,
                                         "sp": 1}
    opt = Adam(1e-3, fused=True)
    assert build_trainer(model(), opt, ComposedConfig("dp1"),
                         device="cpu").optim is opt and opt.fused
    with pytest.raises(ValueError, match="dp > 1"):
        build_trainer(model(), SGD(learning_rate=0.1),
                      ComposedConfig("tp1", zero1=True), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        build_trainer(model(), SGD(learning_rate=0.1),
                      ComposedConfig("dp2,tp2"), device="cpu")
    for cfg, err, match in (
            (ComposedConfig("dp2,pp2"), NotImplementedError, "item 5"),
            (ComposedConfig("ep2"), NotImplementedError, "item 5"),
            (ComposedConfig("dp2,tp2", bucket_bytes=4), ValueError,
             "compiler-owned"),
            (ComposedConfig("dp2", compress="fp16"), ValueError,
             "compiler-owned"),
            (ComposedConfig("dp2,tp2", overlap_grad_chunks=2), ValueError,
             "pp axis"),
            (ComposedConfig("dp2,tp2", n_microbatches=16), ValueError,
             "n_microbatches"),
            (ComposedConfig("dp1", fused_optim=True), ValueError,
             "fused=True")):
        with pytest.raises(err, match=match):
            build_trainer(model(), SGD(learning_rate=0.1), cfg,
                          device="cpu")


@pytest.mark.parametrize("template", ["dp2x tp2 x sp2", "dp2,fsdp2,tp2",
                                      "dp=2 tp=2", "dp2×tp2×pp2",
                                      {"dp": 2, "tp": 4}])
def test_parse_template_matches_the_reference(template):
    assert list(tmesh.parse_template(template).items()) == \
        list(jmesh.parse_template(template).items())


@pytest.mark.parametrize("bad", ["dpp2", "dp2,dp2", "xx2", "dp0"])
def test_parse_template_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        jmesh.parse_template(bad)
    with pytest.raises(ValueError):
        tmesh.parse_template(bad)


def test_mesh_layout_is_row_major_with_dp_outermost():
    rows = tmesh._rows([2, 2, 2], ("dp", "tp", "sp"), ("tp",))
    assert rows == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert tmesh._rows([2, 2, 2], ("dp", "tp", "sp"), ("dp", "sp")) == \
        [[0, 1, 4, 5], [2, 3, 6, 7]]
    devs = np.arange(8).reshape(2, 2, 2)
    with _ref_mesh({"dp": 2, "tp": 2, "sp": 2}) as mesh:
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert (ids == devs).all()


# --------------------------------------------------------------------- #
# K4–K6's plain versions on a tree of f32 and bf16 leaves               #
# --------------------------------------------------------------------- #
# an f32 leaf's band: how far the port's new value may lie from the
# reference's, relative to the largest change the reference made to the
# leaf (measured: at most 1e-5; the reference's f32 leaves go through its
# Pallas kernel, which XLA's CPU backend contracts into multiply-adds).
# A skipped update, or one of the wrong sign, is off by 1 or more.
F32_BAND = 2 ** -14
SHAPES = {"w": (768, 96), "w16": (768, 96), "b16": (3072,), "e16": (0,)}


def _mixed_trees(seed):
    rng = np.random.RandomState(seed)
    trees = []
    for scale, pos in ((1.0, False), (0.1, False), (0.01, False),
                       (1e-4, True)):
        t = {}
        for k, s in SHAPES.items():
            a = rng.randn(*s).astype(np.float32) * scale
            t[k] = np.abs(a) if pos else a
        trees.append(t)

    def jax_tree(t):
        return {k: jnp.asarray(v, jnp.bfloat16 if "16" in k
                               else jnp.float32) for k, v in t.items()}

    def torch_tree(t):
        return {k: torch.from_numpy(np.array(
            jax_tree(t)[k].astype(jnp.float32))).to(
                torch.bfloat16 if "16" in k else torch.float32)
            for k in t}
    return [jax_tree(t) for t in trees], [torch_tree(t) for t in trees]


def _held(name, got, want, old):
    """A leaf's new value ``got`` against the reference's ``want``, both
    updated from ``old``: a bf16 leaf bitwise, an f32 one within
    :data:`F32_BAND` of the reference's largest change; the reference's
    update must move the leaf."""
    a, b = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    o = old.float().numpy()
    assert got.dtype == (torch.bfloat16 if "16" in name else torch.float32)
    if not a.size:
        return
    moved = np.abs(b - o).max()
    assert moved > 0, name
    if "16" in name:
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert np.abs(a - b).max() <= F32_BAND * moved, name


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_plain_on_a_mixed_tree_matches_the_reference(wd):
    """K4's plain version (``fused=False``'s update, and what the card
    holds K4's bf16 instantiation against) over f32 and bf16 leaves.  The
    reference's bf16 leaves go through its tree-map math, whose Python
    scalars JAX rounds to bf16 (``beta2`` = 0.999 becomes 1.0), as the
    port rounds them: p, m and v bitwise.  Its f32 leaves go through its
    kernel on the CPU: within :data:`F32_BAND` of each change."""
    (jp, jg, jm, jv), (tp, tg, tm, tv) = _mixed_trees(0)
    old = (_clone(tp), _clone(tm), _clone(tv))
    step = jnp.asarray(0, jnp.int32)
    t = step + 1
    clr = 1e-3 / (1.0 + step * 0.0)
    bc1 = 1.0 - 0.9 ** t.astype(jnp.float32)
    bc2 = 1.0 - 0.999 ** t.astype(jnp.float32)
    rp, rm, rv = jfo.fused_adam_update(jp, jg, jm, jv, clr=clr, bc1=bc1,
                                       bc2=bc2, beta1=0.9, beta2=0.999,
                                       eps=1e-8, weight_decay=wd)
    tfo.fused_adam_update_plain(
        tp, tg, tm, tv, clr=torch.tensor(float(clr)),
        bc1=torch.tensor(float(bc1)), bc2=torch.tensor(float(bc2)),
        beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd)
    for got, want, was in zip((tp, tm, tv), (rp, rm, rv), old):
        for k in SHAPES:
            _held(k, got[k], want[k], was[k])


@pytest.mark.parametrize("mom,nesterov,wd", [(0.0, False, 0.0),
                                             (0.0, False, 1e-4),
                                             (0.9, False, 0.0),
                                             (0.9, True, 1e-4)])
def test_sgd_plain_on_a_mixed_tree_matches_the_reference(mom, nesterov, wd):
    """K5's and K6's plain versions over f32 and bf16 leaves: the
    parameters and the velocity, bf16 leaves bitwise (the port rounds the
    scalars to bf16 as JAX rounds the reference's), f32 ones within
    :data:`F32_BAND` of each change (the reference's CPU kernel fuses
    multiply-adds)."""
    (jp, jg, jv, _), (tp, tg, tv, _) = _mixed_trees(1)
    old_p, old_v = _clone(tp), _clone(tv)
    step = jnp.asarray(0, jnp.int32)
    clr = 0.1 / (1.0 + step * 0.0)
    rp, rv = jfo.fused_sgd_update(jp, jg, jv if mom else None, clr=clr,
                                  momentum=mom, nesterov=nesterov,
                                  weight_decay=wd)
    tfo.fused_sgd_update_plain(tp, tg, tv if mom else None,
                               clr=torch.tensor(float(clr)), momentum=mom,
                               nesterov=nesterov, weight_decay=wd)
    for k in SHAPES:
        _held(k, tp[k], rp[k], old_p[k])
        if mom:
            _held(k, tv[k], rv[k], old_v[k])


class _OnCard(torch.Tensor):
    """A CPU tensor the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernel", ["adam", "sgd_mom", "sgd_plain"])
def test_a_mixed_tree_is_one_launch_per_dtype(monkeypatch, kernel):
    """A tree of f32 and bf16 leaves on the card: one call of the f32
    kernel with the f32 leaves and one of the bf16 kernel with the bf16
    ones (8-byte alignment for their vector path), its Python scalars
    rounded to bf16 as JAX rounds the reference's; a leaf of mixed dtypes
    raises before any launch."""
    calls = []

    def fake(mom=None, dtype=torch.float32):
        def fn(ptrs, meta, count, *tail):
            n = 4 if kernel == "adam" else 3
            calls.append((dtype, count, list((ctypes.c_int64 * (n * count))
                                             .from_address(ptrs)), tail))
            return 0
        return fn
    monkeypatch.setattr(tfo, "_adam_fn", lambda dtype=torch.float32:
                        fake(None, dtype))
    monkeypatch.setattr(tfo, "_sgd_fn", fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    rng = np.random.RandomState(0)
    trees = [{}, {}, {}, {}]
    for i, dt in enumerate([torch.float32, torch.bfloat16, torch.float32,
                            torch.bfloat16, torch.bfloat16]):
        for tree in trees:
            tree[f"l{i}"] = torch.from_numpy(rng.randn(37 + i).astype(
                np.float32)).to(dt).as_subclass(_OnCard)
    clr = torch.tensor(0.1).as_subclass(_OnCard)
    if kernel == "adam":
        tfo.fused_adam_update(*trees, clr=clr, bc1=clr, bc2=clr, beta1=0.9,
                              beta2=0.999, eps=1e-8)
    else:
        tfo.fused_sgd_update(trees[0], trees[1],
                             trees[2] if kernel == "sgd_mom" else None,
                             clr=clr, momentum=0.9 if kernel == "sgd_mom"
                             else 0.0)
    assert [(c[0], c[1]) for c in calls] == [(torch.float32, 2),
                                             (torch.bfloat16, 3)]
    n = 4 if kernel == "adam" else 3
    assert calls[1][2][0::n] == [trees[0][f"l{i}"].data_ptr()
                                 for i in (1, 3, 4)]
    scalars = {"adam": (slice(3, 7), (0.9, 1 - 0.9, 0.999, 1 - 0.999)),
               "sgd_mom": (slice(1, 4), (0.9, 1.0, 0.0)),
               "sgd_plain": (slice(1, 2), (0.0,))}[kernel]
    assert calls[0][3][scalars[0]] == scalars[1]
    assert calls[1][3][scalars[0]] == tuple(
        float(jnp.asarray(x, jnp.bfloat16)) for x in scalars[1])
    if kernel == "adam":
        assert calls[1][3][7] == 1e-8
    trees[1]["l0"] = trees[1]["l0"].to(torch.bfloat16).as_subclass(_OnCard)
    calls.clear()
    with pytest.raises(NotImplementedError, match="throughout"):
        tfo.fused_sgd_update(trees[0], trees[1], clr=clr)
    assert not calls
