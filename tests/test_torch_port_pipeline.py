"""The port's GPipe ``PipelineLMTrainer`` (and ``pipelined``,
``compose``'s pp branch) against the reference.

The reference runs its ``shard_map`` pipeline on the virtual CPU devices
of ``tests/conftest.py``; the port runs ``PipelineLMTrainer`` over gloo
ranks (``_torch_port_pipeline_rank.py``: worlds of 2, 4 and 8 ranks,
started together while the reference runs), with the reference's
initial weights (``from_jax_params``) and the same batch.

Bands: a port run against the reference at the same mesh within rtol
2e-4 / atol 2e-5 on the losses (the reference's own against one process,
``tests/test_pipeline_trainer.py``) and rtol 1e-4 / atol 1e-5 on the
merged parameters; the composed knobs against the port's plain pipeline
in the reference's classes (``tests/test_compose.py``): zero1 SGD and the
bucketed exchange bitwise, zero1 Adam within rtol 1e-6 / atol 1e-7, the
overlapped chunks within rtol 1e-5 / atol 1e-6, the whole stack with an
fp16 wire within rtol 2e-3 / atol 1e-3; the health scalars within rtol
1e-4 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerConfig as JCfg
from bigdl_tpu.models.transformer import TransformerLM as JLM
from bigdl_tpu.observability import Recorder as JRecorder
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.parallel.pipeline import PipelineLMTrainer as JPipe
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.optim.optim_method import LARS
from bigdl_tpu_torch.parallel.compose import ComposedConfig, build_trainer
from bigdl_tpu_torch.parallel.pipeline import PipelineLMTrainer

from _torch_port_pipeline_rank import collect, spawn
from _torch_port_spmd_rank import save_npz

LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
OVERLAP_TOL = dict(rtol=1e-5, atol=1e-6)
FP16_TOL = dict(rtol=2e-3, atol=1e-3)
HEALTH_RTOL = 1e-4
STEPS = 2
SEED = 3
CFG = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64,
           max_len=16, dropout=0.0)
MOE = dict(CFG, moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
# name: (mesh, model config, trainer keywords), each run by both packages
REF_CASES = {
    "pp2": ({"pp": 2}, CFG, {}),
    "dp2_pp2": ({"dp": 2, "pp": 2}, CFG, {}),
    "pp2_tp2": ({"pp": 2, "tp": 2}, CFG, {}),
    "dp2_pp2_tp2": ({"dp": 2, "pp": 2, "tp": 2}, CFG, {}),
    "pp2_sp2": ({"pp": 2, "sp": 2}, CFG, {"loss_chunk": 8}),
    "dp2_pp2_sp2": ({"dp": 2, "pp": 2, "sp": 2}, CFG, {"loss_chunk": 8}),
    "pp2_moe": ({"pp": 2}, MOE, {}),
    "dp2_pp2_clip": ({"dp": 2, "pp": 2}, CFG, {"clip_norm": 0.5}),
    "z1_stack": ({"dp": 2, "pp": 2}, CFG,
                 {"zero1": True, "compress": "fp16", "clip_norm": 0.5,
                  "overlap_grad_chunks": 2, "n_microbatches": 4}),
}
DP2PP2 = {"dp": 2, "pp": 2}
MOMENTUM = ["SGD", {"learning_rate": 0.1, "momentum": 0.9}]
ADAM = ["Adam", {"learning_rate": 1e-3}]
# name: (optimizer, trainer keywords) on dp2×pp2, 4 microbatches
KNOB_CASES = {
    "plain_sgd": (MOMENTUM, {}),
    "z1_sgd": (MOMENTUM, {"zero1": True}),
    "bucketed": (MOMENTUM, {"bucket_bytes": 1 << 12}),
    "z1_fused_sgd": (MOMENTUM, {"zero1": True, "fused_optim": True}),
    "plain_adam": (ADAM, {}),
    "z1_adam": (ADAM, {"zero1": True}),
    "overlap": (MOMENTUM, {"overlap_grad_chunks": 2}),
    "full_stack": (MOMENTUM, {"zero1": True, "bucket_bytes": 1 << 12,
                              "compress": "fp16", "fused_optim": True,
                              "overlap_grad_chunks": 2}),
}
PIPELINED = dict(n_stages=4, n_micro=4, b=8, d=16)


def _batch():
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 64, (8, 16)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1).astype(np.int32)


def _suffix(tree):
    return {mod.split(".", 1)[1]: dict(sub) for mod, sub in tree.items()}


def _close(got, want, **tol):
    got, want = _suffix(got), _suffix(want)
    assert sorted(got) == sorted(want)
    for mod in want:
        assert sorted(got[mod]) == sorted(want[mod]), mod
        for k in want[mod]:
            np.testing.assert_allclose(np.asarray(got[mod][k]),
                                       np.asarray(want[mod][k]),
                                       err_msg=f"{mod}.{k}", **tol)


def _ref_run(axes, cfg, x, y, telemetry=False, **kw):
    """The reference's pipeline: (losses, merged params, step scalars)."""
    n = int(np.prod(list(axes.values())))
    saved = jmesh._current_mesh
    try:
        mesh = jmesh.create_mesh(axes, devices=jax.devices()[:n])
        kw = {"n_microbatches": 2, **kw}
        tr = JPipe(JLM(JCfg(**cfg)), JSGD(learning_rate=0.1), mesh,
                   seed=SEED, **kw)
        rec = None
        if telemetry:
            rec = JRecorder()
            tr.set_telemetry(rec)
        tr.init()
        losses = [float(tr.step(jnp.asarray(x), jnp.asarray(y)))
                  for _ in range(STEPS)]
        scalars = None if rec is None else \
            rec.recent_records(rec_type="step")[-1]["scalars"]
        return losses, jax.tree_util.tree_map(np.asarray, tr.merge()), \
            scalars
    finally:
        jmesh.set_mesh(saved)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    x, y = _batch()
    b = str(d / "b.npz")
    np.savez(b, x=x, y=y)
    paths = {}
    for name, cfg in (("dense", CFG), ("moe", MOE)):
        paths[name] = str(d / f"w_{name}.npz")
        save_npz(paths[name], jax.tree_util.tree_map(
            np.asarray, JLM(JCfg(**cfg)).init(jax.random.PRNGKey(SEED))))

    def job(name, mesh, cfg=CFG, optim=None, **trainer):
        return {"name": name, "mesh": mesh, "cfg": cfg, "batch": b,
                "weights": paths["moe" if cfg is MOE else "dense"],
                "optim": optim or ["SGD", {"learning_rate": 0.1}],
                "trainer": {"n_microbatches": 2, **trainer},
                "steps": STEPS}
    worlds = {2: [], 4: [], 8: []}
    for name, (mesh, cfg, kw) in REF_CASES.items():
        j = job(name, mesh, cfg, **kw)
        j["telemetry"] = name in ("dp2_pp2_clip", "z1_stack")
        worlds[int(np.prod(list(mesh.values())))].append(j)
    for name, (optim, kw) in KNOB_CASES.items():
        worlds[4].append(job(name, DP2PP2, optim=optim,
                             **{"n_microbatches": 4, **kw}))
    worlds[4] += [
        dict(job("compose", None), kind="compose", template="dp2,pp2",
             config={"n_microbatches": 2, "zero1": True}),
        dict(job("refuse_dp", DP2PP2), kind="step_refusals"),
        dict(job("refuse_sp", {"pp": 2, "sp": 2}), kind="step_refusals"),
    ]
    rng = np.random.RandomState(0)
    p = PIPELINED
    ws = (rng.randn(p["n_stages"], p["d"], p["d"]) * 0.3).astype(np.float32)
    xs = rng.randn(p["b"], p["d"]).astype(np.float32)
    np.savez(d / "pipelined.npz", ws=ws, x=xs)
    worlds[4].append({"name": "pipelined", "kind": "pipelined",
                      "data": str(d / "pipelined.npz"),
                      "n_micro": p["n_micro"]})
    started = {}
    for n, jobs in worlds.items():
        sub = d / f"w{n}"
        sub.mkdir()
        started[n] = spawn(n, jobs, sub)
    ref = {name: _ref_run(mesh, cfg, x, y,
                          telemetry=name in ("dp2_pp2_clip", "z1_stack"),
                          **kw)
           for name, (mesh, cfg, kw) in REF_CASES.items()}
    ranks = {n: collect(s) for n, s in started.items()}
    out = {"jax_free": []}
    for n, rs in ranks.items():
        out["jax_free"] += [r.pop("jax_free") for r in rs]
        for name in rs[0]:
            out[name] = [r[name] for r in rs]
    return {"out": out, "ref": ref, "pipelined": (ws, xs)}


# --------------------------------------------------------------------- #
def test_ranks_stay_jax_free_and_agree(world):
    assert all(world["out"]["jax_free"])
    for name in list(REF_CASES) + list(KNOB_CASES):
        rs = world["out"][name]
        for r in rs[1:]:
            assert r["losses"] == rs[0]["losses"], name


@pytest.mark.parametrize("name", sorted(REF_CASES))
def test_pipeline_matches_the_reference_at_the_same_mesh(world, name):
    """Losses and merged parameters: pp2, dp2×pp2, pp2×tp2, dp2×pp2×tp2,
    pp2×sp2 and dp2×pp2×sp2 (both with the chunked loss), pp2 on an MoE
    model (the reference's pipeline drops the aux loss; so does the
    port's), clipping, and zero1 with an fp16 wire, clipping and
    overlapped chunks."""
    port = world["out"][name][0]
    ref_losses, ref_params, _ = world["ref"][name]
    np.testing.assert_allclose(port["losses"], ref_losses, **LOSS_TOL)
    tol = FP16_TOL if name == "z1_stack" else PARAM_TOL
    _close(port["merged"], ref_params, **tol)


@pytest.mark.parametrize("name", ["dp2_pp2_clip", "z1_stack"])
def test_scoped_health_matches_the_reference(world, name):
    """The step record's axis-group-scoped norms: the grad norm after an
    active clip is the clip threshold on every rank, and the parameter
    and update norms are the reference's."""
    _, _, ref = world["ref"][name]
    for r in world["out"][name]:
        h = r["health"]
        np.testing.assert_allclose(h["grad_norm"], 0.5, rtol=1e-5)
        assert h["nonfinite_grads"] == 0.0
        for k in ("grad_norm", "param_norm", "update_norm",
                  "update_ratio"):
            np.testing.assert_allclose(h[k], ref[k], rtol=HEALTH_RTOL,
                                       err_msg=k)


def test_group_accounting_of_the_composed_step(world):
    """dp scatter ships half its raw bytes on an fp16 wire, the parameter
    gather is uncompressed, and the pp sum of the rest is its own
    family."""
    g = world["out"]["z1_stack"][0]["gauges"]
    assert g["comm/group.dp.reduce_scatter_wire_bytes"] * 2 == \
        g["comm/group.dp.reduce_scatter_bytes"]
    assert g["comm/group.dp.allgather_wire_bytes"] == \
        g["comm/group.dp.allgather_bytes"]
    assert g["comm/group.pp.allreduce_wire_bytes"] > 0
    assert g["comm/group.dp.wire_bytes_per_step"] > 0


def test_merge_returns_the_models_names_on_every_stage(world):
    rs = world["out"]["pp2"]
    merged = rs[0]["merged"]
    want = JLM(JCfg(**CFG)).init(jax.random.PRNGKey(0))
    assert sorted(_suffix(merged)) == sorted(_suffix(want))
    # each stage holds its half of the blocks
    stages = [sorted(m.split(".", 1)[1] for m in r["stage_modules"])
              for r in rs]
    assert stages[0][0].startswith("block0") and \
        stages[1][0].startswith("block2")
    assert not set(stages[0]) & set(stages[1])


def test_chunked_loss_is_the_full_loss(world):
    """pp2×sp2 with ``loss_chunk=8`` (each sp rank's block is one chunk)
    follows pp2 with the full projection."""
    np.testing.assert_allclose(world["out"]["pp2_sp2"][0]["losses"],
                               world["out"]["pp2"][0]["losses"],
                               rtol=1e-5)
    _close(world["out"]["pp2_sp2"][0]["merged"],
           world["out"]["pp2"][0]["merged"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["z1_sgd", "bucketed", "z1_fused_sgd"])
def test_zero1_and_buckets_are_bitwise_the_plain_exchange(world, name):
    base = world["out"]["plain_sgd"][0]
    got = world["out"][name][0]
    assert got["losses"] == base["losses"]
    for mod, sub in _suffix(base["merged"]).items():
        for k, a in sub.items():
            np.testing.assert_array_equal(_suffix(got["merged"])[mod][k], a,
                                          err_msg=f"{mod}.{k}")


def test_zero1_adam_within_band_and_moments_are_sharded(world):
    base = world["out"]["plain_adam"][0]
    z1 = world["out"]["z1_adam"]
    np.testing.assert_allclose(z1[0]["losses"], base["losses"],
                               rtol=ADAM_TOL["rtol"])
    _close(z1[0]["merged"], base["merged"], **ADAM_TOL)
    plain = world["out"]["plain_adam"]
    for fam in ("rest", "blocks"):
        for r_z, r_p in zip(z1, plain):
            got = sum(int(np.prod(s)) for p, s in r_z["opt_shapes"].items()
                      if p.startswith(f"{fam}/m/"))
            if fam == "rest":
                want = sum(int(np.prod(s)) for p, s in
                           r_p["opt_shapes"].items()
                           if p.startswith("m/") and ".block" not in p)
            else:
                want = sum(int(np.prod(s)) for p, s in
                           r_p["opt_shapes"].items()
                           if p.startswith("m/") and ".block" in p)
            # this rank's 1/dp of its stage's moments (1/(pp·dp) of the
            # model's blocks), up to a flat bucket's padding
            assert 0 <= 2 * got - want < 2 * 4, (fam, got, want)


@pytest.mark.parametrize("name,tol", [("overlap", OVERLAP_TOL),
                                      ("full_stack", FP16_TOL)])
def test_overlap_and_fp16_wire_in_their_class(world, name, tol):
    base = world["out"]["plain_sgd"][0]
    got = world["out"][name][0]
    np.testing.assert_allclose(got["losses"], base["losses"],
                               rtol=tol["rtol"])
    _close(got["merged"], base["merged"], **tol)


def test_pipelined_matches_sequential(world):
    """The reference's ``test_pipeline_matches_sequential`` case: 4
    stages, 4 microbatches; output on the last stage and the gradients of
    every stage's weight and of the input."""
    ws, xs = world["pipelined"]
    rs = world["out"]["pipelined"]

    def seq(w, x):
        for i in range(w.shape[0]):
            x = jnp.tanh(x @ w[i])
        return x
    want = np.asarray(seq(jnp.asarray(ws), jnp.asarray(xs)))
    np.testing.assert_allclose(rs[-1]["out"], want, atol=1e-5)
    gw, gx = jax.grad(lambda w, x: seq(w, x).sum(), argnums=(0, 1))(
        jnp.asarray(ws), jnp.asarray(xs))
    for i, r in enumerate(rs):
        np.testing.assert_allclose(r["gw"], np.asarray(gw[i]), atol=1e-5)
        if i == 0:
            np.testing.assert_allclose(r["gx"], np.asarray(gx), atol=1e-5)
        else:
            assert r["gx"] is None or not np.any(r["gx"])


def test_compose_builds_a_working_pipeline_on_ranks(world):
    for r in world["out"]["compose"]:
        assert r["type"] == "PipelineLMTrainer"
        assert r["losses"][1] < r["losses"][0]


def test_step_refusals(world):
    dp = world["out"]["refuse_dp"][0]
    assert "must divide by dp=2" in dp[0]
    assert "n_microbatches=2" in dp[1]
    assert dp[2] is None            # no sp axis: any sequence length
    sp = world["out"]["refuse_sp"][0]
    assert "must divide by sp=2" in sp[2]


def _model(**kw):
    return TransformerLM(TransformerConfig(**{**CFG, **kw}))


@pytest.mark.parametrize("kw,optim,err,match", [
    ({}, None, ValueError, "needs a 'pp' axis"),
    ({"n_layers": 3}, None, ValueError, "must divide by pp=2"),
    ({"dropout": 0.1}, None, ValueError, "dropout=0.0"),
    ({"zero1": True}, None, ValueError, "dp axis > 1"),
    ({"compress": "fp16"}, None, ValueError, "dp axis > 1"),
    ({"compress": "f16", "dp": 2}, None, ValueError, "unknown compress"),
    ({"zero1": True, "dp": 2}, "lars", ValueError, "whole-tensor norms"),
    ({"fused_optim": True, "dp": 2}, "lars", ValueError, "no fused kernel"),
    ({"overlap_grad_chunks": 3, "dp": 2}, None, ValueError,
     "divide n_microbatches"),
    ({"dp": 2, "pp_only": False}, "lars", NotImplementedError,
     "layer-stacked"),
    ({"fsdp": 2}, None, ValueError, "fsdp does not compose"),
    ({"dp": 2}, None, RuntimeError, "process group"),
])
def test_init_refusals(kw, optim, err, match):
    kw = dict(kw)
    axes = {"pp": 2}
    if kw.pop("dp", None):
        axes = {"dp": 2, "pp": 2}
    if kw.pop("fsdp", None):
        axes = {"fsdp": 2, "pp": 2}
    kw.pop("pp_only", None)
    if match == "needs a 'pp' axis":
        axes = {"dp": 2}
    model_kw = {k: kw.pop(k) for k in ("n_layers", "dropout") if k in kw}
    opt = LARS(learning_rate=0.1) if optim == "lars" else \
        SGD(learning_rate=0.1)
    with pytest.raises(err, match=match):
        PipelineLMTrainer(_model(**model_kw), opt, axes, **kw)


def test_init_refuses_a_frozen_model():
    m = _model()
    m.blocks[0].freeze()
    with pytest.raises(NotImplementedError, match="freeze"):
        PipelineLMTrainer(m, SGD(learning_rate=0.1), {"pp": 1})


@pytest.mark.parametrize("template,kw,err,match", [
    ("fsdp2,pp2", {}, ValueError, "fsdp does not compose"),
    ("dp2,pp2", {"grad_accum": 8, "n_microbatches": 2}, ValueError,
     "grad_accum"),
    ("dp2,pp2", {"n_microbatches": 2}, RuntimeError,
     "PipelineLMTrainer.*process group"),
])
def test_compose_pp_branch_refusals(template, kw, err, match):
    with pytest.raises(err, match=match):
        build_trainer(_model(), SGD(learning_rate=0.1),
                      ComposedConfig(template, **kw), device="cpu")


def test_one_stage_on_one_device_matches_the_reference():
    """``{"pp": 1}`` without a process group: one device, the reference's
    pp1 losses."""
    x, y = _batch()
    losses, _, _ = _ref_run({"pp": 1}, CFG, x, y)
    jm_w = JLM(JCfg(**CFG)).init(jax.random.PRNGKey(SEED))
    from bigdl_tpu_torch.models.convert import from_jax_params
    m = _model()
    from_jax_params(jax.tree_util.tree_map(np.asarray, jm_w), m)
    tr = PipelineLMTrainer(m, SGD(learning_rate=0.1), {"pp": 1},
                           n_microbatches=2, device="cpu")
    got = [float(tr.step(x, y)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, losses, **LOSS_TOL)
