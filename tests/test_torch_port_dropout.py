"""The port's stochastic layers (``bigdl_tpu_torch/nn/dropout.py``) held
against the reference's on the CPU.

``jax.random`` streams cannot be reproduced in torch, so the reference's
own draws (``bernoulli`` / ``normal`` of ``fold_in(key, uid % 2**31)``,
the reference module's uid) are fed to the port through ``Ctx.draws``.
With the same mask, ``Dropout`` is bitwise the reference's, in fp32 and
in bf16 (where the order ``where`` then ``/ keep`` and keep's dtype
decide the bits), and so is its input gradient; the Gaussian layers,
whose noise is added or multiplied in fp32, agree within 2e-5.  Then the
port's own draws: from the loop's generator, reproducible by ``seed``,
and a keep share within 6σ of ``1 - p``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

from _torch_port_parity import port_run, rand, ref_run

TOL = dict(rtol=2e-5, atol=2e-5)
KEY = jax.random.PRNGKey(7)


def _key_of(jm):
    return jax.random.fold_in(KEY, jm._uid % (2 ** 31))


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("p", [0.3, 0.5])
def test_dropout_bitwise_at_the_reference_mask(p, scale):
    jm, tm = jnn.Dropout(p, scale=scale), tnn.Dropout(p, scale=scale)
    x, dy = rand(0, (4, 6, 5)), rand(1, (4, 6, 5))
    mask = np.array(jax.random.bernoulli(_key_of(jm), 1 - p, x.shape))
    assert 0 < mask.sum() < mask.size
    yj, _, gxj, _ = ref_run(jm, {}, x, dy, training=True, rng=KEY)
    yt, _, gxt, _ = port_run(tm, x, dy, training=True,
                             draws={tm.name: mask})
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(gxt, gxj)
    np.testing.assert_array_equal(yt == 0, ~mask | (x == 0))


@pytest.mark.parametrize("p", [0.3, 0.4, 0.5])
def test_dropout_bf16_bits(p):
    """keep rounds to bf16 before the division, as JAX rounds the weakly
    typed scalar: 1/0.6 in bf16 is not 1/0.6 in fp32."""
    jm, tm = jnn.Dropout(p), tnn.Dropout(p)
    x = rand(2, (8, 16))
    mask = np.array(jax.random.bernoulli(_key_of(jm), 1 - p, x.shape))
    yj = jm.run({}, jnp.asarray(x, jnp.bfloat16), training=True,
                rng=KEY)[0]
    yt = tm.run({}, torch.from_numpy(x).bfloat16(), training=True,
                draws={tm.name: mask})[0]
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(yt.float().numpy(),
                                  np.asarray(yj.astype(jnp.float32)))


def test_dropout_eval_and_p0_are_identity_and_train_needs_a_generator():
    x = torch.from_numpy(rand(3, (2, 5)))
    tm = tnn.Dropout(0.5)
    assert tm.run({}, x, training=False)[0] is x
    assert tnn.Dropout(0.0).run({}, x, training=True)[0] is x
    with pytest.raises(ValueError, match="needs a generator"):
        tm.run({}, x, training=True)


@pytest.mark.parametrize("layer", ["GaussianDropout", "GaussianNoise"])
def test_gaussian_layers_at_the_reference_noise(layer):
    jm, tm = getattr(jnn, layer)(0.3), getattr(tnn, layer)(0.3)
    x, dy = rand(4, (3, 7)), rand(5, (3, 7))
    noise = np.array(jax.random.normal(_key_of(jm), x.shape, jnp.float32))
    yj, _, gxj, _ = ref_run(jm, {}, x, dy, training=True, rng=KEY)
    yt, _, gxt, _ = port_run(tm, x, dy, training=True,
                             draws={tm.name: noise})
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(gxt, gxj, **TOL)
    assert np.abs(yt - x).max() > 0.05
    # inference: identity
    np.testing.assert_array_equal(tm.run({}, torch.from_numpy(x))[0], x)


def test_gaussian_sampler_at_the_reference_noise():
    jm, tm = jnn.GaussianSampler(), tnn.GaussianSampler()
    mean, log_var = rand(6, (4, 3)), rand(7, (4, 3), 0.5)
    eps = np.array(jax.random.normal(_key_of(jm), mean.shape, jnp.float32))
    yj = jm.run({}, [jnp.asarray(mean), jnp.asarray(log_var)], rng=KEY)[0]
    yt = tm.run({}, [torch.from_numpy(mean), torch.from_numpy(log_var)],
                draws={tm.name: eps})[0]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("case", ["1D", "2D NCHW", "2D NHWC", "3D NCDHW",
                                  "3D NDHWC"])
def test_spatial_dropout_masks_whole_maps(case):
    kind, fmt = (case.split() + [None])[:2]
    kw = {} if fmt is None else dict(format=fmt)
    jm = getattr(jnn, f"SpatialDropout{kind}")(0.5, **kw)
    tm = getattr(tnn, f"SpatialDropout{kind}")(0.5, **kw)
    shape = {"1D": (3, 5, 4), "2D": (3, 4, 5, 6),
             "3D": (2, 4, 3, 5, 6)}[kind]
    x, dy = rand(8, shape), rand(9, shape)
    channels_last = fmt in (None, "NHWC", "NDHWC")
    mshape = [1] * len(shape)
    mshape[0] = shape[0]
    mshape[-1 if channels_last else 1] = shape[-1 if channels_last else 1]
    mask = np.array(jax.random.bernoulli(_key_of(jm), 0.5, tuple(mshape)))
    yj, _, gxj, _ = ref_run(jm, {}, x, dy, training=True, rng=KEY)
    yt, _, gxt, _ = port_run(tm, x, dy, training=True,
                             draws={tm.name: mask})
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(gxt, gxj)


def test_dropout_draws_from_the_generator():
    tm = tnn.Dropout(0.4)
    x = torch.ones(400, 250)
    draw = lambda seed: tm.run({}, x, training=True,  # noqa: E731
                               generator=torch.Generator().manual_seed(seed)
                               )[0]
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    zero = float((a == 0).float().mean())
    sd = (0.4 * 0.6 / x.numel()) ** 0.5
    assert abs(zero - 0.4) < 6 * sd, zero
    kept = a[a != 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0 / np.float32(0.6)))


def _mlp_run(seed):
    torch.manual_seed(0)
    m = tnn.Sequential(tnn.Linear(6, 16), tnn.ReLU(), tnn.Dropout(0.5),
                       tnn.Linear(16, 3), tnn.LogSoftMax())
    rng = np.random.RandomState(0)
    x = rng.randn(32, 6).astype(np.float32)
    y = (rng.randint(0, 3, 32) + 1).astype(np.float32)
    opt = (LocalOptimizer(m, (x, y), tnn.ClassNLLCriterion(), batch_size=8,
                          seed=seed, device="cpu")
           .set_optim_method(SGD(learning_rate=0.1))
           .set_end_when(Trigger.max_epoch(1)))
    losses = []
    fire = opt._fire_mid_epoch

    def hook():
        losses.append(float(opt.state.loss))
        return fire()
    opt._fire_mid_epoch = hook
    opt.optimize()
    return losses


def test_the_loop_seed_drives_the_dropout_draws():
    a, b, c = _mlp_run(0), _mlp_run(0), _mlp_run(1)
    assert a == b
    assert a != c
