"""The port's training slice held against the reference on the CPU.

A narrow TransformerLM (d_model 256, 2 heads of 128, 2 layers, d_ff 512,
vocab 512, S=128, batch 4) is built and initialised in ``bigdl_tpu``; its
weights go through numpy into ``bigdl_tpu_torch`` (``from_jax_params``).
The reference runs its Pallas flash kernels, forward and backward, in
interpret mode; the port runs its plain attention.  Then the loss and its
gradients, and three ``SpmdTrainer`` steps with ``AdamW``, are compared.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.models import transformer as JT
from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu.optim.optim_method import AdamW as JAdamW
from bigdl_tpu.parallel.mesh import create_mesh
from bigdl_tpu.parallel.spmd import SpmdTrainer as JSpmdTrainer
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.optim import AdamW
from bigdl_tpu_torch.parallel import SpmdTrainer

NARROW = dict(vocab_size=512, d_model=256, n_heads=2, n_layers=2, d_ff=512,
              max_len=256)
S, B = 128, 4
# fp32 on both sides, summed in other orders by XLA-CPU and ATen-CPU
# through two blocks and the vocab head: the loss (~6.3) to 1e-5
# relative; gradients to 1e-4 relative plus an absolute floor of 1e-6
# (their largest entries are ~1e-2)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# params after three AdamW steps (lr 1e-3, params move by up to ~3e-3).
# Adam's update is lr * m / (sqrt(v) + eps): for an entry whose gradient
# stays small (|g| ~ 1e-6 in the embedding, some from cancellation) a
# rounding difference in g of ~1e-8 (GRAD_TOL) moves the update by up to
# ~lr * 1e-2.  Both trainers use eps = 1e-6, which bounds that
# amplification; every entry must agree within PARAM_TOL_ALL (1 % of the
# 3 * lr three steps can move it), and all but 1 in 10^4 entries of each
# leaf within PARAM_TOL.  The update's math itself is held to 1e-6 by
# tests/test_torch_port_optim.py.
PARAM_TOL = dict(rtol=1e-5, atol=5e-6)
PARAM_TOL_ALL = dict(rtol=1e-5, atol=3e-5)
PARAM_OUTLIERS = 1e-4
ADAM_EPS = 1e-6


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _np_params(jparams):
    return {k: {kk: np.array(vv) for kk, vv in sub.items()}
            for k, sub in jparams.items()}


@pytest.fixture(scope="module")
def narrow():
    """(reference model, numpy params)."""
    jm = JT.build("tiny", **NARROW)
    jparams, _ = jm.init_params(seed=5)
    return jm, _np_params(jparams)


def _port(np_params, seed=0):
    tm = TT.build("tiny", device="cpu", seed=seed, **NARROW)
    from_jax_params(np_params, tm)
    return tm


def _batch(seed, pad=False):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, NARROW["vocab_size"], (B, S + 1)).astype(np.int32)
    tokens, targets = ids[:, :-1], ids[:, 1:].copy()
    if pad:   # ragged valid lengths, padded with -1
        for i, n in enumerate((S, S - 40, 7, S - 1)):
            targets[i, n:] = -1
    return tokens, targets


def _by_suffix(tree):
    return {k[k.index("."):]: v for k, v in tree.items()}


@pytest.mark.parametrize("pad", [False, True])
def test_loss_and_grads_match_reference(narrow, pad):
    jm, np_params = narrow
    tokens, targets = _batch(1, pad=pad)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens), jnp.asarray(targets)))(
            jparams)
    tm = _port(np_params)
    params = tm.param_dict()
    loss = tm.loss(params, torch.from_numpy(tokens),
                   torch.from_numpy(targets), training=True)
    leaves = [p for sub in params.values() for p in sub.values()]
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               **LOSS_TOL)
    it = iter(grads)
    want_g = _by_suffix(want_g)
    for name, sub in params.items():
        for pname in sub:
            np.testing.assert_allclose(
                next(it).numpy(), np.asarray(want_g[name[name.index("."):]]
                                             [pname]),
                **GRAD_TOL, err_msg=f"{name}.{pname}")


def test_token_nll_clips_targets_and_masks_ignore_index():
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 5, 7).astype(np.float32)
    targets = np.array([[0, 6, 9, -1, 3], [-1, -1, 2, 7, -3]], np.int32)
    for ignore in (-1, 2):
        want = JT.lm_token_nll(jnp.asarray(logits), jnp.asarray(targets),
                               ignore)
        got = TT.lm_token_nll(torch.from_numpy(logits),
                              torch.from_numpy(targets), ignore)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        np.testing.assert_allclose(
            float(TT.lm_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(targets), ignore)),
            float(JT.lm_cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(targets), ignore)),
            rtol=1e-6)


def test_trainer_matches_reference_spmd_trainer(narrow):
    """Three steps from the same weights: losses and final params."""
    jm, _ = narrow
    jt = JSpmdTrainer(jm, JAdamW(learning_rate=1e-3, epsilon=ADAM_EPS),
                      mesh=create_mesh({"dp": 1},
                                       devices=jax.devices()[:1]),
                      fsdp=False)
    jt.init()
    tm = _port(_np_params(jt.params))
    tt = SpmdTrainer(tm, AdamW(learning_rate=1e-3, epsilon=ADAM_EPS),
                     device="cpu")
    batches = [_batch(10 + i, pad=(i == 1)) for i in range(3)]
    want = [float(jt.step(*b)) for b in batches]
    got = tt.fit(batches)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert int(tt.opt_state["step"]) == 3
    final = _by_suffix(_np_params(jt.params))
    for name, sub in tm.param_dict().items():
        for pname, p in sub.items():
            got_p = p.detach().numpy()
            want_p = final[name[name.index("."):]][pname]
            np.testing.assert_allclose(got_p, want_p, **PARAM_TOL_ALL,
                                       err_msg=f"{name}.{pname}")
            off = ~np.isclose(got_p, want_p, **PARAM_TOL)
            assert off.mean() <= PARAM_OUTLIERS, (name, pname, off.sum())


def test_grad_accum_weights_microbatches_by_valid_tokens(narrow):
    _, np_params = narrow
    tokens, targets = _batch(3, pad=True)
    got = []
    for accum in (1, 2):
        tm = _port(np_params)
        tr = SpmdTrainer(tm, AdamW(learning_rate=1e-3), device="cpu",
                         grad_accum=accum).init()
        (loss, _), grads = tr._grads_fn(tr.params, {},
                                        torch.from_numpy(tokens),
                                        torch.from_numpy(targets))
        got.append((loss, grads))
    # the same sums over the same tokens, split in two and reweighted
    torch.testing.assert_close(got[1][0], got[0][0], rtol=1e-6, atol=1e-6)
    accum = _by_suffix(got[1][1])
    for name, sub in got[0][1].items():
        for pname, g in sub.items():
            torch.testing.assert_close(accum[name[name.index("."):]][pname],
                                       g, **GRAD_TOL)


def test_side_losses_are_added_to_the_loss(narrow):
    _, np_params = narrow
    tokens, targets = _batch(4)
    tm = _port(np_params)
    with torch.no_grad():
        base = float(tm.loss(tm.param_dict(), torch.from_numpy(tokens),
                             torch.from_numpy(targets)))
    norm = tm.final_norm
    orig = norm.apply

    def with_aux(params, x, ctx):
        ctx.side_losses.append(torch.tensor(0.25))
        return orig(params, x, ctx)
    norm.apply = with_aux
    tr = SpmdTrainer(tm, AdamW(learning_rate=0.0, weight_decay=0.0),
                     device="cpu")
    np.testing.assert_allclose(float(tr.step(tokens, targets)),
                               base + 0.25, rtol=1e-6)


def test_fit_returns_floats_and_logs(narrow, capsys):
    _, np_params = narrow
    tr = SpmdTrainer(_port(np_params), AdamW(learning_rate=1e-3),
                     device="cpu")
    batch = _batch(5)
    losses = tr.fit(iter([batch] * 4), steps=3, log_every=2)
    assert len(losses) == 3 and all(isinstance(x, float) for x in losses)
    assert losses[-1] < losses[0]
    assert "step 2: loss=" in capsys.readouterr().out


MESH_MODEL = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2,
                  d_ff=128, max_len=64)
MESH_KWS = [dict(mesh={"dp": 2}), dict(mesh={"dp": 1, "tp": 4}),
            dict(mesh={"fsdp": 2, "sp": 1})]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each mesh of MESH_KWS trained over its own gloo ranks (all spawned
    at once, ``_torch_port_spmd_rank.py``): rank 0's results."""
    from _torch_port_spmd_rank import collect, spawn
    d = tmp_path_factory.mktemp("meshes")
    rs = np.random.RandomState(3)
    ids = rs.randint(0, MESH_MODEL["vocab_size"], (4, 33))
    np.savez(d / "b.npz", x=ids[:, :-1], y=ids[:, 1:])
    started = []
    for i, kw in enumerate(MESH_KWS):
        sub = d / f"m{i}"
        sub.mkdir()
        started.append(spawn(int(np.prod(list(kw["mesh"].values()))), [{
            "name": "run", "mesh": kw["mesh"], "batch": str(d / "b.npz"),
            "model": {"preset": "tiny", "overrides": MESH_MODEL},
            "optim": ["AdamW", {"learning_rate": 1e-3}], "steps": 2,
            "trainer": {"fsdp": True, "min_fsdp_size": 1}}], sub))
    x, y = ids[:, :-1], ids[:, 1:]
    tr = SpmdTrainer(TT.build("tiny", device="cpu", **MESH_MODEL),
                     AdamW(learning_rate=1e-3), device="cpu")
    single = [float(tr.step(x, y)) for _ in range(2)]
    return single, [collect(s)[0]["run"] for s in started]


@pytest.mark.parametrize("kw", MESH_KWS)
def test_mesh_arguments_raise_and_name_the_roadmap_item(kw, mesh_runs):
    """A mesh with an axis larger than 1 builds over the started process
    group and trains as one device does (gloo ranks); without a process
    group it needs one; a mesh whose every axis is 1 is one device, where
    fsdp and the ring ask for nothing, as in the reference without those
    axes; zero1 needs dp > 1 there too."""
    single, runs = mesh_runs
    run = runs[MESH_KWS.index(kw)]
    np.testing.assert_allclose(run["losses"], single, rtol=2e-3)
    assert run["step"] == 2
    with pytest.raises(RuntimeError, match="process group"):
        SpmdTrainer(None, AdamW(), device="cpu", **kw)
    with pytest.raises(TypeError, match="unexpected"):
        SpmdTrainer(None, AdamW(), device="cpu", tp=2)
    with pytest.raises(ValueError, match="dp > 1"):
        SpmdTrainer(None, AdamW(), device="cpu", zero1=True)
    one = {a: 1 for a in kw["mesh"]}
    tr = SpmdTrainer(None, AdamW(), device="cpu", mesh=one, fsdp=True,
                     ring_attention=True, min_fsdp_size=1)
    assert tr.mesh == one and tr.params is None
    SpmdTrainer(None, AdamW(), device="cpu", mesh=None, fsdp=False)


def test_a_seed_that_would_seed_nothing_raises():
    """A seed seeds each step's draws now (dropout, the input
    transform): it is taken, and kept for the checkpoint's meta."""
    assert SpmdTrainer(None, AdamW(), device="cpu", seed=1).seed == 1
    assert SpmdTrainer(None, AdamW(), device="cpu", seed=0).params is None


def test_unported_loss_options_raise(narrow):
    """The chunked loss and dropout in training, once raising, run: a
    chunk equals the full loss, and dropout needs a generator."""
    _, np_params = narrow
    tm = _port(np_params)
    tokens, targets = (torch.from_numpy(a) for a in _batch(6))
    full = tm.loss(tm.param_dict(), tokens, targets)
    torch.testing.assert_close(
        tm.loss(tm.param_dict(), tokens, targets, loss_chunk=32), full,
        rtol=1e-6, atol=1e-6)
    # a chunk that covers the sequence is the unchunked loss
    torch.testing.assert_close(
        tm.loss(tm.param_dict(), tokens, targets, loss_chunk=S), full)
    drop = TT.build("tiny", device="cpu", dropout=0.1)
    with pytest.raises(ValueError, match="generator"):
        drop.loss(drop.param_dict(), tokens[:, :8] % 256, targets[:, :8],
                  training=True)
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(drop.loss(drop.param_dict(), tokens[:, :8] % 256,
                                    targets[:, :8], training=True,
                                    generator=gen))


def test_trainer_refuses_a_model_on_another_device(narrow):
    _, np_params = narrow
    tr = SpmdTrainer(_port(np_params), AdamW(), device="meta")
    with pytest.raises(ValueError, match="move the model first"):
        tr.init()


def test_default_device_needs_cuda(narrow):
    _, np_params = narrow
    if torch.cuda.is_available():
        assert SpmdTrainer(None, AdamW()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpmdTrainer(_port(np_params), AdamW())
