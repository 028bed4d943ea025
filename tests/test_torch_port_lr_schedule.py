"""The port's learning-rate schedules against the reference's, through
each package's ``SGD`` learning rate (``rate(step) / (1 + step *
lr_decay)``) over steps 0..N, plus Plateau's factor sequence and the
``SequentialSchedule`` boundaries.

Tolerance: both sides compute in fp32 in the same op order.  Where no
transcendental function enters (``Default``, ``Warmup``) the rates are
bitwise; where
``pow`` or ``exp`` enters, within 2 ulps (``rtol=2.5e-7``): XLA's CPU
``pow``/``exp`` and the C library's that ATen calls round differently by
up to an ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.optim import lr_schedule as J
from bigdl_tpu.optim.optim_method import SGD as JSGD
from bigdl_tpu_torch.optim import lr_schedule as T
from bigdl_tpu_torch.optim.optim_method import SGD as TSGD

STEPS = 40

SCHEDULES = {
    "Default": lambda m: m.Default(),
    "Step": lambda m: m.Step(3, 0.7),
    "MultiStep": lambda m: m.MultiStep([2, 5, 9, 30], 0.3),
    "MultiStep_empty": lambda m: m.MultiStep([], 0.3),
    "Exponential": lambda m: m.Exponential(4, 0.9),
    "Exponential_staircase": lambda m: m.Exponential(4, 0.9, staircase=True),
    "NaturalExp": lambda m: m.NaturalExp(3, 0.37),
    "Poly": lambda m: m.Poly(0.5, 27),
    "Poly_2": lambda m: m.Poly(2.0, 13),
    "Warmup": lambda m: m.Warmup(0.0123),
    "Sequential": lambda m: m.SequentialSchedule(8).add(
        m.Warmup(0.0125), 8).add(m.Poly(0.5, 8), 8),
    "Sequential_3": lambda m: m.SequentialSchedule().add(
        m.Warmup(0.01), 5).add(m.Default(), 7).add(m.Step(4, 0.5), 100),
    "EpochDecay": lambda m: m.EpochDecay(lambda e: e // 2, 3),
    "EpochStep": lambda m: m.EpochStep(2, 0.5, 3),
}
EXACT = ("Default", "Warmup")
ULPS = dict(rtol=2.5e-7, atol=0)


def _rates(mod_sched, sgd, schedule, lr_decay, steps=STEPS):
    m = sgd(0.1, learning_rate_schedule=schedule(mod_sched),
            learning_rate_decay=lr_decay)
    if sgd is JSGD:
        return np.array([np.float32(m.current_lr(jnp.int32(s)))
                         for s in range(steps)], np.float32)
    out = []
    for s in range(steps):
        clr = m.get_learning_rate({"step": torch.tensor(s,
                                                        dtype=torch.int32)})
        assert clr.dtype == torch.float32 and clr.shape == ()
        out.append(clr.item())
    return np.array(out, np.float32)


@pytest.mark.parametrize("lr_decay", [0.0, 0.01])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_the_reference(name, lr_decay):
    got = _rates(T, TSGD, SCHEDULES[name], lr_decay)
    want = _rates(J, JSGD, SCHEDULES[name], lr_decay)
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **ULPS)
    assert np.all(np.isfinite(got))


def test_sequential_boundaries():
    """Each schedule takes the step from its own start: Warmup's last step
    (7) is lr + 7·δ, Poly's first (8) is lr, its last (15) lr·(1/8)^0.5."""
    got = _rates(T, TSGD, SCHEDULES["Sequential"], 0.0, steps=24)
    f = np.float32
    assert got[0] == f(0.1)
    assert got[7] == f(f(0.1) + f(0.0125) * f(7))
    assert got[8] == f(0.1)
    np.testing.assert_allclose(got[15], 0.1 * (1 / 8) ** 0.5, rtol=1e-6)
    assert got[16] == 0.0 and got[23] == 0.0      # Poly past its end


def test_plateau_factor_sequence_matches_the_reference():
    metrics = [5.0, 4.0, 4.0, 4.0, 3.99995, 4.5, 4.0, 4.1, 2.0, 2.0, 2.0,
               2.0, 2.0, 2.0, 2.0]
    for kw in (dict(patience=2, factor=0.5),
               dict(patience=1, factor=0.1, cooldown=2, min_lr=1e-3),
               dict(patience=2, mode="max", epsilon=0.5)):
        t, j = T.Plateau(**kw), J.Plateau(**kw)
        tm, jm = TSGD(0.1, learning_rate_schedule=t), \
            JSGD(0.1, learning_rate_schedule=j)
        seq = []
        for m in metrics:
            t.on_epoch_end(m)
            j.on_epoch_end(m)
            assert (t.current_factor, t.wait, t.cooldown_counter, t.best) \
                == (j.current_factor, j.wait, j.cooldown_counter, j.best)
            step = {"step": torch.tensor(3, dtype=torch.int32)}
            got = tm.get_learning_rate(step).item()
            want = np.float32(jm.current_lr(jnp.int32(3)))
            np.testing.assert_allclose(np.float32(got), want, **ULPS)
            seq.append(t.current_factor)
        assert len(set(seq)) > 1, kw          # the factor did change


def test_schedule_rate_is_a_device_tensor_of_the_step():
    """A step-dependent rate is computed from the step tensor (no host
    float); a constant one is filled on the step's device."""
    step = torch.tensor(5, dtype=torch.int32)
    m = TSGD(0.1)
    for name in ("Step", "Poly", "Warmup", "Sequential", "EpochStep"):
        r = SCHEDULES[name](T).rate(m, step)
        assert isinstance(r, torch.Tensor) and r.dtype == torch.float32
    assert isinstance(T.Default().rate(m, step), float)
    assert isinstance(T.Plateau().rate(m, step), float)
