"""The port's GIN (dg_tta_tpu_torch/ops/gin.py) against the JAX package's.

`gin_aug` takes its random net as an argument, so the port runs on the
draws of JAX's own key path (`jax_gin_draws`: split(key, 5), one
`_rand_layer_params` per layer, then the alphas) and both packages
compute the same function of the same numbers.

Tolerances, f32 on the CPU: `_grouped_conv` and `gin_aug` 1e-5 of the
output's range (the same grouped conv summed in another order, through
four layers, a blend and a renormalization).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.ops import gin as jgin
from dg_tta_tpu_torch.ops import gin
from tests.test_torch_mind import jax_gin_draws


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_constants_match_jax():
    assert (gin.GIN_N_LAYER, gin.GIN_INTERM_CHANNELS, gin.LEAKY_SLOPE) == \
        (jgin.GIN_N_LAYER, jgin.GIN_INTERM_CHANNELS, jgin.LEAKY_SLOPE)


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("spatial", [(7, 9, 6), (11, 8)])
@pytest.mark.parametrize("center_only", [False, True])
def test_grouped_conv_matches_jax(nb, spatial, center_only):
    """Per-sample convs, 2-D and 3-D, with a full 3^d kernel and with one
    masked to its centre tap (a drawn size-1 layer)."""
    rng = np.random.default_rng(len(spatial) + nb)
    cin, cout = 2, 3
    x = rng.normal(size=(nb, *spatial, cin)).astype(np.float32)
    k = rng.normal(size=(nb * cout, cin) + (3,) * len(spatial)) \
        .astype(np.float32)
    if center_only:
        mask = np.zeros((3,) * len(spatial), np.float32)
        mask[(1,) * len(spatial)] = 1.0
        k = k * mask
    ref = jax.jit(jgin._grouped_conv, static_argnums=(2, 3, 4))(
        jnp.asarray(x), jnp.asarray(k), nb, cin, cout)
    got = gin._grouped_conv(torch.from_numpy(x), torch.from_numpy(k), nb,
                            cin, cout)
    assert got.shape == (nb, *spatial, cout)
    _close(got.numpy(), ref)


def _layer_sizes(draws):
    """Per layer, 3 for a full kernel, 1 for one masked to its centre."""
    out = []
    for k, _ in draws.layers:
        off_centre = k.clone()
        off_centre[(slice(None), slice(None)) + (1,) * (k.dim() - 2)] = 0
        out.append(3 if off_centre.abs().sum() > 0 else 1)
    return out


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("spatial", [(10, 9, 12), (14, 11)])
def test_gin_aug_matches_jax(nb, spatial):
    """JAX's draws for two keys whose layers together take both kernel
    sizes, in 2-D and 3-D."""
    rng = np.random.default_rng(nb)
    sizes = set()
    for seed in (0, 5):
        key = jax.random.PRNGKey(seed)
        x = rng.normal(size=(nb, *spatial, 1)).astype(np.float32)
        draws = jax_gin_draws(key, nb, 1, ndim=len(spatial))
        sizes.update(_layer_sizes(draws))
        ref = jax.jit(jgin.gin_aug)(key, jnp.asarray(x))
        got = gin.gin_aug(torch.from_numpy(x), draws)
        assert got.shape == x.shape
        _close(got.numpy(), ref)
    assert sizes == {1, 3}


def test_draw_gin_shapes_masks_and_seed():
    draws = gin.draw_gin(torch.Generator().manual_seed(0), nb=2, nc=1)
    widths = [1, 2, 2, 2, 1]
    assert len(draws.layers) == gin.GIN_N_LAYER
    for (k, s), cin, cout in zip(draws.layers, widths[:-1], widths[1:]):
        assert k.shape == (2 * cout, cin, 3, 3, 3) and s.shape == (2 * cout,)
    assert draws.alphas.shape == (2,)
    assert ((draws.alphas >= 0) & (draws.alphas < 1)).all()
    again = gin.draw_gin(torch.Generator().manual_seed(0), nb=2, nc=1)
    for (k, s), (k2, s2) in zip(draws.layers, again.layers):
        assert torch.equal(k, k2) and torch.equal(s, s2)
    sizes = set()
    for seed in range(8):
        sizes.update(_layer_sizes(gin.draw_gin(
            torch.Generator().manual_seed(seed), nb=1, nc=1)))
    assert sizes == {1, 3}


def test_gin_aug_keeps_each_samples_norm():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 8, 9, 10, 1)).astype(np.float32))
    x[1] *= 5.0
    out = gin.gin_aug(x, gin.draw_gin(torch.Generator().manual_seed(1), 2, 1))
    torch.testing.assert_close(out.flatten(1).norm(dim=1),
                               x.flatten(1).norm(dim=1), rtol=1e-4, atol=0)
    assert not torch.allclose(out, x)
