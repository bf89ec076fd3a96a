"""The port's MIND-SSC (dg_tta_tpu_torch/ops/mind.py) against the JAX
package's, and `Model.apply` of the MIND families against the JAX
`Model.apply`.

Both sides get the same numpy-seeded images; the noise is JAX's own
`normal(k_mind, ...)` draw, handed to the port as `noise`.

Tolerances, f32 on the CPU:
* `_ssc_shift_pairs`, `gaussian_kernel_1d`: bit-equal (the same numpy);
* `smooth3d`: 1e-6 relative (the same taps summed in the same order; the
  port fuses each tap's multiply into its add);
* `mind3d`, against the JAX function under `jax.jit`: the exponent
  x = -log(descriptor) = mind / mind_var within 1e-5 absolute, and the
  descriptor within 1e-5 relative where x <= 1.  The error is absolute in
  x (the sums behind mind and mind_var rounded in another order; `ssd -
  min` cancels where x is near 0, so x has no relative bound there): JAX's
  own eager and jitted forms differ by up to 4.3e-6 in x, and each side
  lies within 3.4e-6 (port) and 2.6e-6 (JAX, jitted) of a float64
  evaluation, under ATEN_CPU_CAPABILITY=default, avx2 and avx512 alike
  (the port 1.5e-6 from JAX's jitted x under avx2 and avx512, 4.3e-6
  under default); 1e-5 holds the sum of both with 1.7x to spare.  The
  first `torch.exp` of a process, run while other processes load the CPU,
  returned one element 1.49e-4 off (1 run in ~12; the same call again,
  exact), so the module makes one warm-up call before it compares;
* `Model.apply`: 1e-4 of the logits' range plus 1e-5, the bound of the
  port's U-Net parity tests, on MIND features that agree to 1e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.models.network import Model as JaxModel
from dg_tta_tpu.models.plans import ArchSpec as JaxArchSpec
from dg_tta_tpu.ops import gin as jgin
from dg_tta_tpu.ops import mind as jmind
from dg_tta_tpu_torch.models.convert import params_from_jax
from dg_tta_tpu_torch.models.network import Model
from dg_tta_tpu_torch.models.plans import ArchSpec
from dg_tta_tpu_torch.ops import mind
from dg_tta_tpu_torch.ops.gin import GinDraws

SPEC = dict(features_per_stage=(8, 16), kernel_sizes=((3, 3, 3),) * 2,
            strides=((1, 1, 1), (2, 2, 2)), n_conv_per_stage_encoder=(1, 1),
            n_conv_per_stage_decoder=(1,), num_input_channels=12,
            num_classes=4)
PATCH = (16, 16, 16)


def _image(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_shift_pairs_bit_equal():
    for got, ref in zip(mind._ssc_shift_pairs(), jmind._ssc_shift_pairs()):
        np.testing.assert_array_equal(got, ref)
    assert mind.MIND_OUT_CHANNELS == jmind.MIND_OUT_CHANNELS == 12


@pytest.mark.parametrize("sigma", [0.8, 1.0, 2.0])
def test_gaussian_kernel_bit_equal(sigma):
    np.testing.assert_array_equal(mind.gaussian_kernel_1d(sigma).numpy(),
                                  np.asarray(jmind.gaussian_kernel_1d(sigma)))


@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_smooth3d_matches_jax(sigma):
    x = _image(1, (2, 9, 12, 10, 12)) ** 2
    ref = np.asarray(jmind.smooth3d(jnp.asarray(x), sigma))
    got = mind.smooth3d(torch.from_numpy(x), sigma).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One `torch.exp` before any comparison (module docstring)."""
    torch.exp(torch.zeros(4096))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("noisy", [False, True])
def test_mind3d_matches_jax(batch, noisy):
    """With a batch of 2 the clip bound is the mean over both patches, in
    either package.  Bounds: the module docstring."""
    img = _image(2, (batch, 12, 14, 10, 1))
    noise = None
    if noisy:
        key = jax.random.PRNGKey(3)
        ref = jax.jit(lambda x, k: jmind.mind3d(x, key=k))(jnp.asarray(img),
                                                           key)
        noise = torch.from_numpy(np.array(jax.random.normal(
            key, (*img.shape[:-1], 12), jnp.float32)))
    else:
        ref = jax.jit(jmind.mind3d)(jnp.asarray(img))
    ref = np.asarray(ref)
    got = mind.mind3d(torch.from_numpy(img), noise=noise).numpy()
    assert got.shape == ref.shape == (*img.shape[:-1], 12)
    x_ref = -np.log(ref.astype(np.float64))
    x_got = -np.log(got.astype(np.float64))
    np.testing.assert_allclose(x_got, x_ref, rtol=0, atol=1e-5)
    small = x_ref <= 1.0
    assert small.sum() > 100
    np.testing.assert_allclose(got[small], ref[small], rtol=1e-5, atol=0)


def test_mind3d_clip_bound_is_batch_wide():
    """A patch's descriptor depends on the patches that share its call,
    through the clip bound: a smooth patch next to a rough one is clipped
    by the batch mean."""
    smooth = _image(4, (1, 10, 10, 10, 1)) * 1e-3
    rough = _image(5, (1, 10, 10, 10, 1)) * 1e3
    alone = mind.mind3d(torch.from_numpy(smooth))
    paired = mind.mind3d(torch.from_numpy(np.concatenate([smooth, rough])))
    assert not torch.allclose(alone, paired[:1])
    ref = jmind.mind3d(jnp.asarray(np.concatenate([smooth, rough])))
    np.testing.assert_allclose(paired.numpy(), np.asarray(ref), rtol=1e-5)


def test_mind3d_rejects_multichannel_and_misshapen_noise():
    with pytest.raises(ValueError, match="single-channel"):
        mind.mind3d(torch.zeros(1, 4, 4, 4, 2))
    with pytest.raises(ValueError, match="noise"):
        mind.mind3d(torch.zeros(1, 4, 4, 4, 1), noise=torch.zeros(1, 4, 4, 4))


def _models(trainer):
    gin, use_mind = {"nnUNetTrainer_MIND": (False, True),
                     "nnUNetTrainer_GIN_MIND": (True, True)}[trainer]
    jm = JaxModel(spec=JaxArchSpec(**SPEC), patch_size=PATCH,
                  trainer_name=trainer, uses_gin_internal=gin,
                  uses_mind=use_mind)
    tm = Model(spec=ArchSpec(**SPEC), patch_size=PATCH, trainer_name=trainer,
               uses_gin_internal=gin, uses_mind=use_mind)
    return jm, tm


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_gin_draws(key, nb, nc, ndim):
    keys = jax.random.split(key, jgin.GIN_N_LAYER + 1)
    widths = [nc] + [jgin.GIN_INTERM_CHANNELS] * (jgin.GIN_N_LAYER - 1) \
        + [nc]
    layers = [jgin._rand_layer_params(keys[li], nb, widths[li],
                                      widths[li + 1], ndim, jnp.float32)
              for li in range(jgin.GIN_N_LAYER)]
    return layers, jax.random.uniform(keys[-1], (nb,), jnp.float32)


def jax_gin_draws(key, nb, nc, ndim=3):
    """The draws of the JAX `gin_aug(key, x)` for x of nb samples and nc
    channels: split(key, 5), one `_rand_layer_params` per layer, then
    `uniform(keys[-1], (nb,))`."""
    layers, alphas = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                  _jax_gin_draws(key, nb, nc, ndim))
    return GinDraws(layers=tuple(tuple(kw) for kw in layers), alphas=alphas)


def jax_model_draws(key, x_shape, gin):
    """`Model.apply(key=key)`'s GIN draws (None without `gin`) and MIND
    noise: (k_gin, k_mind) = split(key)."""
    k_gin, k_mind = jax.random.split(key)
    noise = jax.random.normal(k_mind, (*x_shape[:-1], 12), jnp.float32)
    return (jax_gin_draws(k_gin, x_shape[0], x_shape[-1]) if gin else None,
            torch.from_numpy(np.array(noise)))


@pytest.mark.parametrize("trainer,internal_aug", [
    ("nnUNetTrainer_MIND", False), ("nnUNetTrainer_GIN_MIND", True)])
def test_model_apply_matches_jax(trainer, internal_aug):
    """GIN (under internal_aug), then MIND with noise, then the U-Net, in
    both packages, on a batch of 2."""
    jm, tm = _models(trainer)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    net = tm.build_network(params_from_jax(jax.tree.map(np.asarray, params)),
                           device="cpu")
    x = _image(6, (2, *PATCH, 1))
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax.jit(
        lambda p, x, k: jm.apply(p, x, key=k, internal_aug=internal_aug))(
            params, jnp.asarray(x), key))
    gin_draws, noise = jax_model_draws(key, x.shape, internal_aug)
    with torch.no_grad():
        got = tm.apply(net, torch.from_numpy(x), internal_aug=internal_aug,
                       gin_draws=gin_draws, mind_noise=noise).numpy()
    assert got.shape == ref.shape == (2, *PATCH, 4)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max() + 1e-5)


def test_model_apply_needs_gin_draws_for_internal_aug():
    _, tm = _models("nnUNetTrainer_GIN_MIND")
    net = tm.build_network(device="cpu")
    with pytest.raises(ValueError, match="gin_draws"):
        tm.apply(net, torch.zeros(1, *PATCH, 1), internal_aug=True)
    assert tm.needs_mind_noise
    assert not dataclasses.replace(tm, mind_noise_scale=0.0).needs_mind_noise
