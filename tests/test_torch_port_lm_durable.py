"""Durable LM training in the port: ``SpmdTrainer``'s manifest
checkpoints against the reference's (each package restores the other's
and continues within the trainer tolerance), a SIGTERM preemption resumed
bitwise, and a rollback after a NaN step, on the reference recipe's own
preset (``examples/transformer_spmd.py``: ``tiny``, ``remat=True``,
``loss_chunk=32``, batch 2 x 64) with ``dropout=0.1`` and ``seed=3``.

Resumes run in this process: a fresh trainer's model gets another root
name, which the restore rewrites (``_rekey_root``), and one process keeps
the CPU kernels' summation order, so that a resume can be bitwise.
"""
import os
import signal

import numpy as np
import jax
import pytest
import torch

from bigdl_tpu.models import transformer as JT
from bigdl_tpu.optim.optim_method import SGD as JSGD
from bigdl_tpu.parallel.mesh import create_mesh
from bigdl_tpu.parallel.spmd import SpmdTrainer as JSpmdTrainer
from bigdl_tpu_torch.checkpoint import read_manifest, scan
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.observability import InMemorySink, Recorder
from bigdl_tpu_torch.optim import SGD, AdamW
from bigdl_tpu_torch.parallel import SpmdTrainer

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _recipe(vocab=256):
    """The recipe's trainer: a fresh model from seed 0 each time."""
    model = TT.build("tiny", device="cpu", seed=0, remat=True, dropout=0.1)
    return SpmdTrainer(model, AdamW(learning_rate=3e-4), device="cpu",
                       mesh={"dp": 1, "fsdp": 1}, fsdp=True,
                       min_fsdp_size=1, loss_chunk=32, seed=3)


def _batches(n, vocab=256, b=2, s=64, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tok = rs.randint(0, vocab, (b, s + 1)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _state(tr):
    return {f"p/{n}/{k}": v.detach().clone()
            for n, sub in tr.params.items() for k, v in sub.items()} | {
        f"o/{k}/{n}/{kk}": v.detach().clone()
        for k, t in tr.opt_state.items() if isinstance(t, dict)
        for n, sub in t.items() for kk, v in sub.items()}


def _same_state(a, b):
    """Equal leaves after dropping each tree's root name."""
    strip = lambda d: {"/".join(p.split(".", 1)[-1] for p in k.split("/")):
                       v for k, v in d.items()}
    a, b = strip(a), strip(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_preempted_run_resumes_bitwise(tmp_path):
    batches = _batches(12)
    ref = _recipe()
    want = ref.fit(batches)
    ck = str(tmp_path / "ck")

    def killed_at_6():
        for i, batch in enumerate(batches):
            if i == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    first = _recipe().set_checkpoint(ck, every_steps=4,
                                     handle_preemption=True)
    try:
        got = first.fit(killed_at_6())
    finally:
        first._preemption.uninstall()
    assert len(got) == 7 and first._step_count == 7   # the flag is read
    assert got == want[:7]                              # after the step
    tags = [mf.tag for _, mf in scan(ck)]
    assert tags == ["step_4", "preempt_step_7"]
    second = _recipe()
    second.load_checkpoint(ck)
    assert second._step_count == 7 and second.seed == 3
    assert second.fit(batches[7:]) == want[7:]
    _same_state(_state(second), _state(ref))


def test_rollback_restores_the_last_checkpoint_after_a_nan_step(tmp_path):
    batches = _batches(12)
    bad = batches[5][0].copy()
    bad[0, 0] = 10 ** 6            # out of range: a NaN embedding row
    batches[5] = (bad, batches[5][1])
    sink = InMemorySink()
    tr = (_recipe().set_telemetry(Recorder(sinks=[sink]))
          .set_checkpoint(str(tmp_path / "ck"), every_steps=4)
          .set_health(policy="rollback", install_crash_hooks=False))
    losses = tr.fit(batches)
    assert tr._health_monitor.rollbacks == 1
    assert len(losses) == 11 and all(np.isfinite(losses))
    assert tr._step_count == 4 + 6          # rolled back to step 4
    steps = [r["step"] for r in sink.records if r["type"] == "step"]
    assert steps == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]
    for (n, sub) in tr.params.items():
        for k, v in sub.items():
            assert torch.isfinite(v).all(), (n, k)


def _ref_trainer(**kw):
    jm = JT.build("tiny", **SMALL)
    return JSpmdTrainer(jm, JSGD(learning_rate=0.1, momentum=0.9),
                        mesh=create_mesh({"dp": 1},
                                         devices=jax.devices()[:1]),
                        fsdp=False, **kw).init()


def _port_trainer(np_params=None, seed=1):
    tm = TT.build("tiny", device="cpu", seed=seed, **SMALL)
    if np_params is not None:
        from_jax_params(np_params, tm)
    return SpmdTrainer(tm, SGD(learning_rate=0.1, momentum=0.9),
                       device="cpu", loss_chunk=16)


def _np(tree):
    return {k: {kk: np.array(vv) for kk, vv in sub.items()}
            for k, sub in tree.items()}


def _compare(tt, jparams):
    final = {k[k.index("."):]: v for k, v in _np(jparams).items()}
    for name, sub in tt.params.items():
        for k, p in sub.items():
            np.testing.assert_allclose(
                p.detach().numpy(), final[name[name.index("."):]][k],
                **PARAM_TOL, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("shard_arrays", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_manifest_checkpoints_cross_between_the_packages(tmp_path, writer,
                                                         shard_arrays):
    """Two SGD-with-momentum steps on both sides from the same weights;
    one package saves, a fresh trainer of the other restores (another
    root name, other weights) and both go on for two steps."""
    batches = _batches(4, vocab=64, b=2, s=32, seed=7)
    jt = _ref_trainer(loss_chunk=16)
    tt = _port_trainer(_np(jt.params))
    for b in batches[:2]:
        jt.step(*b)
        tt.step(*b)
    ck = str(tmp_path / "ck")
    if writer == "reference":
        jt.set_checkpoint(ck, layout="manifest", shard_arrays=shard_arrays)
        jt.save_checkpoint(ck, sync=True)
        other = _port_trainer()
        other.load_checkpoint(ck)
        assert other._step_count == 2
        want = [float(jt.step(*b)) for b in batches[2:]]
        got = other.fit(batches[2:])
        _compare(other, jt.params)
    else:
        tt.set_checkpoint(ck, shard_arrays=shard_arrays)
        tt.save_checkpoint(ck, sync=True)
        mf = read_manifest(scan(ck)[-1][0])
        assert any(s.name.startswith("opt_state") for s in mf.shards)
        assert mf.mesh["axes"] == [["dp", 1]]
        other = _ref_trainer(loss_chunk=16, seed=9)
        other.load_checkpoint(ck)
        assert other._step_count == 2
        got = [float(other.step(*b)) for b in batches[2:]]
        want = tt.fit(batches[2:])
        _compare(tt, other.params)
    np.testing.assert_allclose(got, want, **STEP_TOL)


def test_a_checkpoint_of_another_model_is_refused(tmp_path):
    tt = _port_trainer()
    tt.step(*_batches(1, vocab=64, s=32)[0])
    tt.save_checkpoint(str(tmp_path / "ck"), sync=True)
    wide = TT.build("tiny", device="cpu", **{**SMALL, "d_ff": 128})
    with pytest.raises(ValueError, match="leaf"):
        SpmdTrainer(wide, SGD(learning_rate=0.1, momentum=0.9),
                    device="cpu").load_checkpoint(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        _port_trainer().load_checkpoint(str(tmp_path / "empty"))


def test_mesh_axes_larger_than_one_and_zero1_still_raise():
    with pytest.raises(NotImplementedError, match="item 5"):
        SpmdTrainer(None, AdamW(), device="cpu", mesh={"dp": 2})
    with pytest.raises(ValueError, match="dp > 1"):
        SpmdTrainer(None, AdamW(), device="cpu", zero1=True)
