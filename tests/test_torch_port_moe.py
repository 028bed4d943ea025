"""The port's SwitchFFN and MoE TransformerLM against the reference.

``SwitchFFN`` alone (routing, capacity drops, the aux loss through
``ctx.add_loss``, gradients), the MoE model trained by ``SpmdTrainer``
with a capacity that drops tokens (``moe_capacity_factor=0.5``) over
``{"dp": 2}``, ``{"dp": 2, "sp": 2}`` and ``{"dp": 2, "ep": 2, "tp": 2}``
on gloo ranks (``_torch_port_spmd_rank.py``) against the reference's GSPMD
trainer at the same mesh (virtual CPU devices) and against one device,
an ep-sharded checkpoint restored on one device, and ``generate`` on an
MoE model.  The reference runs its Pallas attention in interpret mode.

Bands: ``SwitchFFN`` alone within the reference's own
(``tests/test_moe.py``: rtol 2e-4, atol 2e-5); a mesh's loss within 1e-4
of the reference and of one device (the reference's bound for ep
against dp only), its parameters within rtol 1e-3 / atol 2e-4.  A
capacity-limited mesh whose ranks routed their own rows alone would drop
other tokens and miss these bands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import transformer as JT
from bigdl_tpu.nn.module import Ctx as JCtx
from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.parallel.spmd import SpmdTrainer as JSpmd
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.nn.moe import SwitchFFN
from bigdl_tpu_torch.nn.module import Ctx
from bigdl_tpu_torch.optim import SGD, Adam
from bigdl_tpu_torch.parallel import SpmdTrainer

from _torch_port_spmd_rank import collect, save_npz, spawn

FFN_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_ABS = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=2e-4)
STEPS = 2
MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=32,
           max_len=16, dropout=0.0, moe_experts=4, moe_top_k=2,
           moe_capacity_factor=0.5)
MESHES = {"dp2": {"dp": 2}, "dp2_sp2": {"dp": 2, "sp": 2},
          "dp2_ep2_tp2": {"dp": 2, "ep": 2, "tp": 2}}


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, 64, (4, 16)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1).astype(np.int32)


def _suffix(tree):
    return {mod.split(".", 1)[1]: dict(sub) for mod, sub in tree.items()}


def _close_params(got, want, **tol):
    got, want = _suffix(got), _suffix(want)
    assert sorted(got) == sorted(want)
    for mod in want:
        for k in want[mod]:
            np.testing.assert_allclose(np.asarray(got[mod][k]),
                                       np.asarray(want[mod][k]),
                                       err_msg=f"{mod}.{k}", **tol)


def _weights():
    return jax.tree_util.tree_map(np.asarray, JT.build("tiny", **MOE).init(
        jax.random.PRNGKey(0)))


def _ref_train(axes, x, y):
    n = int(np.prod(list(axes.values())))
    saved = jmesh._current_mesh
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        mesh = jmesh.create_mesh(axes, devices=jax.devices()[:n])
        tr = JSpmd(JT.build("tiny", **MOE), JSGD(learning_rate=0.1),
                   mesh=mesh, fsdp=False, seed=0).init()
        losses = [float(tr.step(x, y)) for _ in range(STEPS)]
        params = jax.tree_util.tree_map(np.asarray, tr.params)
        tr.detach()
    finally:
        jmesh.set_mesh(saved)
        jfa._INTERPRET = old
    return losses, params


def _port_model(weights, **kw):
    tm = TT.build("tiny", device="cpu", **{**MOE, **kw})
    from_jax_params(weights, tm)
    return tm


def _job(name, mesh, w, b, **kw):
    job = {"name": name, "mesh": mesh, "weights": w, "batch": b,
           "model": {"preset": "tiny", "overrides": MOE},
           "optim": ["SGD", {"learning_rate": 0.1}],
           "trainer": {"fsdp": False}, "steps": STEPS}
    job.update(kw)
    return job


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results (a world of 2, 4 and 8 gloo ranks, started
    together) and the reference's runs, made while the ranks run."""
    d = tmp_path_factory.mktemp("moe")
    weights = _weights()
    w = str(d / "w.npz")
    save_npz(w, weights)
    x, y = _batch()
    b = str(d / "b.npz")
    np.savez(b, x=x, y=y)
    ckpt = str(d / "ckpt")
    big = MESHES["dp2_ep2_tp2"]
    worlds = {}
    for name, axes in MESHES.items():
        n = int(np.prod(list(axes.values())))
        jobs = [_job(name, axes, w, b)]
        if name == "dp2_ep2_tp2":
            adam = ["Adam", {"learning_rate": 1e-3}]
            jobs += [_job("ckpt_save", big, w, b, optim=adam, save=ckpt),
                     _job("ckpt_next", big, w, b, optim=adam, load=ckpt,
                          steps=1)]
        sub = d / name
        sub.mkdir()
        worlds[name] = spawn(n, jobs, sub)
    ref = {name: _ref_train(axes, x, y) for name, axes in MESHES.items()}
    ref["one"] = _ref_train({"dp": 1}, x, y)
    ranks = {name: collect(started) for name, started in worlds.items()}
    return {"ranks": ranks, "ref": ref, "w": weights, "x": x, "y": y,
            "ckpt": ckpt}


# --------------------------------------------------------------------- #
# SwitchFFN alone                                                         #
# --------------------------------------------------------------------- #
def _ffn_pair(d, f, e, top_k, cf, aux=0.1):
    jm = jnn.SwitchFFN(d, f, e, top_k=top_k, capacity_factor=cf,
                       aux_loss_weight=aux)
    params, _ = jm.init_params(0)
    tm = SwitchFFN(d, f, e, top_k=top_k, capacity_factor=cf,
                   aux_loss_weight=aux)
    return jm, params, tm


@pytest.mark.parametrize("top_k,cf", [(1, 8.0), (2, 8.0), (1, 0.5),
                                      (2, 0.5)])
def test_switch_ffn_matches_the_reference(top_k, cf):
    """Output, aux loss and every gradient of ``sum(y²) + aux``; with
    ``cf=0.5`` tokens are dropped."""
    jm, params, tm = _ffn_pair(8, 16, 4, top_k, cf)
    x = np.random.RandomState(0).randn(2, 6, 8).astype(np.float32) * 0.5

    def f(p, xx):
        ctx = JCtx(state={}, training=True, rng_key=jax.random.PRNGKey(0))
        yy = jm.apply(p, xx, ctx)
        return jnp.sum(yy ** 2) + ctx.side_losses[0], (yy,
                                                      ctx.side_losses[0])
    (_, (y, aux)), (g, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tp = {tm.name: {k: torch.tensor(np.asarray(v), requires_grad=True)
                    for k, v in params[jm.name].items()}}
    xt = torch.tensor(x, requires_grad=True)
    ctx = Ctx(training=True)
    yt = tm.apply(tp, xt, ctx)
    assert len(ctx.side_losses) == 1
    (torch.sum(yt ** 2) + ctx.side_losses[0]).backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               **FFN_TOL)
    np.testing.assert_allclose(float(ctx.side_losses[0].detach()),
                               float(aux), rtol=1e-6)
    for k, v in tp[tm.name].items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(g[jm.name][k]),
                                   err_msg=k, **FFN_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **FFN_TOL)


def test_capacity_drops_overflow_tokens():
    """At most one slot an expert: at most two tokens have an output, the
    same ones as the reference's."""
    jm, params, tm = _ffn_pair(4, 8, 2, 1, 0.01, aux=0.0)
    x = np.random.RandomState(1).randn(1, 8, 4).astype(np.float32)
    want = np.asarray(jm.run(params, jnp.asarray(x))[0])
    tp = {tm.name: {k: torch.tensor(np.asarray(v))
                    for k, v in params[jm.name].items()}}
    got = tm.run(tp, torch.tensor(x))[0].numpy()
    live = np.abs(got[0]).sum(-1) > 1e-7
    assert live.sum() <= 2
    np.testing.assert_array_equal(live, np.abs(want[0]).sum(-1) > 1e-7)
    np.testing.assert_allclose(got, want, **FFN_TOL)


def test_aux_loss_flows_through_ctx():
    """The reference's test on its weights: one side loss in training, the
    reference's value and at least the weight; none in inference."""
    jm, params, tm = _ffn_pair(4, 8, 2, 1, 1.25)
    x = np.random.RandomState(2).randn(1, 4, 4).astype(np.float32)
    jctx = JCtx(state={}, training=True, rng_key=jax.random.PRNGKey(0))
    jm.apply(params, jnp.asarray(x), jctx)
    tp = {tm.name: {k: torch.tensor(np.asarray(v))
                    for k, v in params[jm.name].items()}}
    ctx = Ctx(training=True)
    tm.apply(tp, torch.tensor(x), ctx)
    assert len(ctx.side_losses) == 1
    aux = float(ctx.side_losses[0])
    np.testing.assert_allclose(aux, float(jctx.side_losses[0]), rtol=1e-6)
    assert aux >= 0.1 * 0.999
    ctx2 = Ctx(training=False)
    tm.apply(tp, torch.tensor(x), ctx2)
    assert not ctx2.side_losses


# --------------------------------------------------------------------- #
# the MoE model over a mesh                                               #
# --------------------------------------------------------------------- #
def test_ranks_stay_jax_free_and_agree(world):
    for name, ranks in world["ranks"].items():
        assert all(r["jax_free"] for r in ranks)
        for r in ranks[1:]:
            assert r[name]["losses"] == ranks[0][name]["losses"], name


@pytest.mark.parametrize("name", sorted(MESHES))
def test_capacity_limited_mesh_matches_the_reference_and_one_device(
        world, name):
    port = world["ranks"][name][0][name]
    ref_losses, ref_params = world["ref"][name]
    np.testing.assert_allclose(port["losses"], ref_losses, rtol=0,
                               atol=LOSS_ABS)
    _close_params(port["params"], ref_params, **PARAM_TOL)
    one_losses, one_params = world["ref"]["one"]
    np.testing.assert_allclose(port["losses"], one_losses, rtol=0,
                               atol=LOSS_ABS)
    tr = SpmdTrainer(_port_model(world["w"]), SGD(learning_rate=0.1),
                     device="cpu")
    single = [float(tr.step(world["x"], world["y"])) for _ in range(STEPS)]
    np.testing.assert_allclose(port["losses"], single, rtol=0,
                               atol=LOSS_ABS)
    _close_params(port["params"], {m: {k: t.detach().numpy()
                                       for k, t in sub.items()}
                                   for m, sub in tr.params.items()},
                  **PARAM_TOL)


def test_expert_leaves_and_moments_shard_over_ep(world):
    """On dp2×ep2×tp2 each rank holds E/ep experts and F/tp of each, and
    Adam's moments of them, as the pspec lays them out."""
    r0 = world["ranks"]["dp2_ep2_tp2"][0]
    shapes = r0["ckpt_save"]["opt_shapes"]
    e, d, f = MOE["moe_experts"], MOE["d_model"], MOE["d_ff"]
    for moment in ("m", "v"):
        w1 = [s for p, s in shapes.items()
              if p.startswith(moment + "/") and p.endswith(".moe/w1")]
        w2 = [s for p, s in shapes.items()
              if p.startswith(moment + "/") and p.endswith(".moe/w2")]
        assert w1 and all(s == (e // 2, d, f // 2) for s in w1)
        assert w2 and all(s == (e // 2, f // 2, d) for s in w2)


def test_ep_sharded_checkpoint_restores_on_one_device(world):
    """The dp2×ep2×tp2 ranks' checkpoint (fragments of the ep- and
    tp-sharded experts and their Adam moments) restored on one device:
    the parameters are the mesh's, and the next step's loss is the
    mesh's next step's."""
    r0 = world["ranks"]["dp2_ep2_tp2"][0]
    tr = SpmdTrainer(_port_model(world["w"]), Adam(1e-3), device="cpu")
    tr.init()
    tr.load_checkpoint(world["ckpt"])
    assert tr._step_count == STEPS
    saved = r0["ckpt_save"]["params"]
    got = {m: {k: t.detach().numpy() for k, t in sub.items()}
           for m, sub in tr.params.items()}
    for mod, sub in _suffix(saved).items():
        for k, a in sub.items():
            np.testing.assert_array_equal(_suffix(got)[mod][k], a)
    nxt = float(tr.step(world["x"], world["y"]))
    np.testing.assert_allclose(nxt, r0["ckpt_next"]["losses"][0], rtol=0,
                               atol=LOSS_ABS)


def test_moe_aux_loss_included_in_the_spmd_loss():
    """The reference's test on one device: the step's loss (lr 0) exceeds
    the cross-entropy alone by the aux term."""
    cfg = dict(MOE, n_layers=1, moe_top_k=1, moe_capacity_factor=1.25)
    tm = TT.build("tiny", device="cpu", **cfg)
    x, y = _batch(4)
    tr = SpmdTrainer(tm, SGD(learning_rate=0.0), device="cpu")
    total = float(tr.step(x[:2], y[:2]))
    with torch.no_grad():
        ce = float(tm.loss(tm.param_dict(), torch.tensor(x[:2]),
                           torch.tensor(y[:2])))
    assert total > ce + 1e-4, (total, ce)


def test_generate_with_moe_model():
    """The reference's ``test_generate_with_moe_model`` on the same
    weights: greedy tokens equal to the reference's, and the cached
    decode path through SwitchFFN blocks matches the full forward
    (teacher forced; a dropless capacity, as that test explains)."""
    cfg = dict(dropout=0.0, moe_experts=4, moe_top_k=2,
               moe_capacity_factor=8.0)
    jm = JT.build("tiny", **cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TT.build("tiny", device="cpu", **cfg)
    from_jax_params(jax.tree_util.tree_map(np.asarray, params), tm)
    tp = tm.param_dict()
    prompt = np.random.RandomState(10).randint(0, 256, (2, 5))
    want = np.asarray(jm.generate(params, prompt, 6))
    got = tm.generate(tp, prompt, 6).numpy()
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got, want)
    toks = torch.tensor(np.random.RandomState(11).randint(0, 256, (2, 9)))
    with torch.no_grad():
        full = tm.apply(tp, toks, Ctx())
        cache = tm.init_cache(2)
        lg, cache = tm.apply_with_cache(tp, toks[:, :4], cache, 0)
        np.testing.assert_allclose(lg.numpy(), full[:, :4].numpy(),
                                   rtol=2e-3, atol=2e-3)
        for i in range(4, 9):
            lg, cache = tm.apply_with_cache(tp, toks[:, i:i + 1], cache, i)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(),
                                       rtol=2e-3, atol=2e-3)
