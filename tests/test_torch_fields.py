"""The port's deformable fields (dg_tta_tpu_torch/core/fields.py) against
the JAX package's (dg_tta_tpu/core/fields.py), on the same numpy-seeded or
JAX-drawn inputs, each JAX side under `jax.jit`.

The port keeps its fields channels-first inside the module; its private
functions take (B, C, D, H, W), the JAX ones (B, D, H, W, C), so these
tests transpose.  On the CPU the field warps run the warp kernel's plain
version (`kernels/warp.warp_flat_reference`).

Tolerances, f32:
* the smoothing: 1e-6 absolute (the same 5^3 or 4^3 window sum in another
  order);
* the resize: 1e-6 absolute on unit-scale input (JAX rounds its weights
  from float64, F.interpolate computes them in f32);
* a random field: 1e-4 of its largest value: normalizing a field whose
  std after three smoothings is ~1e-2 amplifies the resize's rounding
  ~100x;
* the diffeomorphic loop, and the displacement fields built on a random
  field: 1e-5 and 1e-4 of the largest value (ten trilinear warps, whose
  eight products each side sums in its own order, and the random field's
  own rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.core import fields as jf
from dg_tta_tpu.core import grid as jgrid
from dg_tta_tpu_torch.core import fields as tf
from dg_tta_tpu_torch.core.grid import identity_grid
from dg_tta_tpu_torch.kernels.warp import warp_flat


def _cf(a):
    """numpy channels-last (B, D, H, W, C) -> torch channels-first."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _assert_rel(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("k,shape", [(5, (1, 5, 6, 7, 3)),
                                     (4, (2, 3, 6, 4, 2))])
def test_avg_pool3d_same_matches_jax(rng, k, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = jax.jit(jf._avg_pool3d_same, static_argnums=1)(x, k)
    got = _cl(tf._avg_pool3d_same(_cf(x), k))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(22, 112), (3, 16), (5, 5), (7, 3)])
def test_resize_axis_matrix_matches_jax(n_in, n_out):
    ref = np.asarray(jf._resize_axis_matrix(n_in, n_out))
    np.testing.assert_array_equal(tf._resize_axis_matrix(n_in, n_out).numpy(),
                                  ref)


@pytest.mark.parametrize("src,size", [((3, 4, 5), (16, 20, 25)),
                                      ((4, 4, 5), (20, 21, 25))])
def test_resize_trilinear_matches_jax_and_the_axis_matrices(rng, src, size):
    x = rng.standard_normal((1, *src, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jf._resize_trilinear, static_argnums=1)(x, size))
    got = tf._resize_trilinear(_cf(x), size)
    np.testing.assert_allclose(_cl(got), ref, atol=1e-6)
    # the product of the three axes' interpolation matrices
    mz, my, mx = (tf._resize_axis_matrix(n, m) for n, m in zip(src, size))
    prod = torch.einsum("Dd,Hh,Ww,bcdhw->bcDHW", mz, my, mx, _cf(x))
    np.testing.assert_allclose(got.numpy(), prod.numpy(), atol=1e-6)


@pytest.mark.parametrize("size,factor", [((20, 24, 25), 5),
                                         ((24, 24, 24), 4)])
def test_rf_field_matches_jax_on_its_noise(size, factor):
    key = jax.random.PRNGKey(2)
    ref = jax.jit(lambda k: jf.get_rf_field(
        k, 2, size, interpolation_factor=factor, num_fields=3))(key)
    small = tuple(s // factor for s in size)
    noise = np.array(jax.random.normal(key, (2, *small, 3), jnp.float32))
    got = tf.get_rf_field(torch.from_numpy(noise), size, factor)
    assert got.shape == (2, *size, 3)
    _assert_rel(got.numpy(), ref, 1e-4)
    # zero mean, population std under 1 per (batch, field): the std is
    # divided by 1e-3 + std
    f = got.numpy()
    np.testing.assert_allclose(f.mean(axis=(1, 2, 3)), 0.0, atol=1e-5)
    assert np.all((f.std(axis=(1, 2, 3)) > 0.2)
                  & (f.std(axis=(1, 2, 3)) <= 1.0))


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_warp_field_matches_jax(rng, padding_mode):
    size = (6, 8, 10)
    field = (0.3 * rng.standard_normal((1, *size, 3))).astype(np.float32)
    ident = np.stack([np.asarray(g) for g in jgrid.identity_grid(
        size, align_corners=True)], axis=-1)[None]
    pos = (ident + 0.2 * rng.standard_normal((1, *size, 3))).astype(
        np.float32)
    ref = jax.jit(lambda f, p: jf._warp_field(
        f, p, padding_mode=padding_mode))(field, pos)
    before = warp_flat.launches
    got = tf._warp_field(_cf(field), _cf(pos), padding_mode)
    assert warp_flat.launches == before  # the plain version on the CPU
    np.testing.assert_allclose(_cl(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("ensure", [True, False])
@pytest.mark.parametrize("time_steps,override", [(5, None), (3, 2)])
def test_consistent_field_matches_jax_anisotropic(rng, ensure, time_steps,
                                                  override):
    """A (6, 8, 10) patch pins the reference's quirk: the xyz-ordered
    channels are divided by (D, H, W) in that order, so a port that scaled
    x by W would miss."""
    size = (6, 8, 10)
    d = (0.3 * rng.standard_normal((1, *size, 3))).astype(np.float32)
    di = (0.3 * rng.standard_normal((1, *size, 3))).astype(np.float32)
    ref = jax.jit(lambda a, b: jf.calc_consistent_diffeomorphic_field(
        a, b, time_steps, ensure_inverse_consistency=ensure,
        iter_steps_override=override))(d, di)
    got = tf.calc_consistent_diffeomorphic_field(
        torch.from_numpy(d), torch.from_numpy(di), time_steps,
        ensure_inverse_consistency=ensure, iter_steps_override=override)
    for g, r in zip(got, ref):
        assert g.shape == (1, *size, 3)
        _assert_rel(g.numpy(), r, 1e-5)


def test_consistent_field_of_zero_is_zero():
    z = torch.zeros((1, 8, 8, 8, 3))
    for f in tf.calc_consistent_diffeomorphic_field(z, z, 5):
        assert torch.equal(f, torch.zeros_like(f))


SIZE = (20, 24, 25)


@pytest.fixture(scope="module")
def disp_fields():
    """JAX's `get_disp_field` at the engine's settings (factor 0.5,
    interpolation factor 5) on an anisotropic patch, with its own noise."""
    key = jax.random.PRNGKey(1)
    ref = jax.jit(lambda k: jf.get_disp_field(
        k, 1, SIZE, factor=0.5, interpolation_factor=5))(key)
    noise = np.array(jax.random.normal(
        key, (1, *(s // 5 for s in SIZE), 3), jnp.float32))
    return noise, ref


def test_disp_field_matches_jax_on_its_noise(disp_fields):
    noise, (ref, ref_inv) = disp_fields
    before = warp_flat.launches
    disp, inv = tf.get_disp_field(torch.from_numpy(noise), SIZE, factor=0.5,
                                  interpolation_factor=5)
    assert warp_flat.launches == before
    for got, want in ((disp, ref), (inv, ref_inv)):
        assert len(got) == 3 and all(g.shape == (1, *SIZE) for g in got)
        for g, r in zip(got, want):
            _assert_rel(g.numpy(), r, 1e-4)
    assert np.abs(ref[0]).max() > 1e-2   # a field, not the identity


def test_deformable_grids_add_the_engine_identity(disp_fields):
    """The grids of a deformable branch: the align_corners=False identity
    plus the displacement and plus its inverse (engine.py:286-288 of the
    JAX package)."""
    noise, (ref, ref_inv) = disp_fields
    ident = jgrid.identity_grid(SIZE, align_corners=False)
    grid, grid_inv = tf.deformable_grids(torch.from_numpy(noise), SIZE)
    for got, disp in ((grid, ref), (grid_inv, ref_inv)):
        for g, i, d in zip(got, ident, disp):
            want = np.asarray(i[None] + d)
            _assert_rel(g.numpy(), want, 1e-5)


def test_disp_field_is_inverse_consistent(disp_fields):
    """The field composed with its inverse nearly cancels inside the patch
    (tests/test_fields.py's check, on the port's fields)."""
    noise, _ = disp_fields
    disp, inv = tf._disp_fields(torch.from_numpy(noise), SIZE, 0.5, 5)
    norm = torch.tensor([SIZE[2], SIZE[1], SIZE[0]],
                        dtype=torch.float32).reshape(1, 3, 1, 1, 1)
    d, di = disp / norm, inv / norm
    ident = torch.stack(identity_grid(SIZE, True))[None]
    residual = d + tf._warp_field(di, ident + d)
    assert residual[:, :, 4:-4, 4:-4, 4:-4].abs().mean() < 5e-3


def test_field_noise_shape_is_checked():
    with pytest.raises(ValueError, match="noise"):
        tf.get_disp_field(torch.zeros((1, 4, 4, 4, 3)), SIZE)
    with pytest.raises(ValueError, match="noise"):
        tf.get_rf_field(torch.zeros((1, 4, 4, 5)), SIZE, 5)
