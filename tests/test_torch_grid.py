"""The port's resampling (dg_tta_tpu_torch/core/grid.py, the warp kernel's
wrapper and plain version) against the JAX package.

On the CPU `grid_sample_flat` runs its plain version; these tests hold it
against the JAX `grid_sample_flat` and `grid_sample` on the cases of
tests/test_grid.py (trilinear and nearest, zeros and border, both
align_corners, C = 1 and C > 1, output shape unlike the source), against
the Pallas kernel `grid_sample_flat_pallas` in interpret mode on the
in-window cases of tests/test_warp_pallas.py, and the warp adjoint of the
TTA unwarp against `jax.vjp` of the JAX `_warp_with_inverse`.  The CUDA
kernel itself needs the card: tests/test_torch_cuda.py and chip_smoke.py.

Tolerances, f32: 1e-5 absolute (the bound of tests/test_grid.py; the same
eight products summed in the same order, rounded the same way up to
XLA's fusion); nearest is exact, since both sides round the same f32
coordinates half to even; against the Pallas kernel rtol 1e-5 / atol 2e-5,
the bound of tests/test_warp_pallas.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.core import grid as jgrid
from dg_tta_tpu.core.fields import get_rand_affine as jax_rand_affine
from dg_tta_tpu.ops.experimental.warp_pallas_staged import \
    grid_sample_flat_pallas
from dg_tta_tpu.tta.engine import _warp_with_inverse as jax_wwi
from dg_tta_tpu_torch.core import grid as tgrid
from dg_tta_tpu_torch.core.fields import affine_abs_det, get_rand_affine
from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat, warp_flat,
                                           warp_flat_reference,
                                           warp_source_voxels)
from dg_tta_tpu_torch.tta.engine import _warp_with_inverse

ATOL = 1e-5


def _theta(rng, b):
    return (np.eye(3, 4)[None] + 0.1 * rng.standard_normal((b, 3, 4))
            ).astype(np.float32)


def _grid_np(theta, out_spatial, align_corners):
    return tuple(np.asarray(g) for g in jgrid.affine_grid(
        jnp.asarray(theta), out_spatial, align_corners=align_corners))


def _t(arrs):
    return tuple(torch.from_numpy(np.array(a)) for a in arrs)


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_and_identity_grid_match_jax(rng, align_corners):
    theta = _theta(rng, 2)
    size = (5, 6, 7)
    ref = _grid_np(theta, size, align_corners)
    got = tgrid.affine_grid(torch.from_numpy(theta), size,
                            align_corners=align_corners)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-6)
    for g, r in zip(tgrid.identity_grid(size, align_corners),
                    jgrid.identity_grid(size, align_corners)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    packed = tgrid.pack_grid(got)
    assert packed.shape == (2, *size, 3)
    for g, u in zip(got, tgrid.unpack_grid(packed)):
        assert torch.equal(g, u)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_grid_sample_flat_matches_jax(rng, mode, padding_mode,
                                      align_corners, C):
    B, src, out = 2, (6, 5, 7), (4, 5, 6)   # not endomorphic
    flat = rng.standard_normal((B, C, int(np.prod(src)))).astype(np.float32)
    grid = _grid_np(_theta(rng, B), out, align_corners)
    ref = np.asarray(jgrid.grid_sample_flat(
        jnp.asarray(flat), src, tuple(map(jnp.asarray, grid)), mode=mode,
        padding_mode=padding_mode, align_corners=align_corners))
    before = warp_flat.launches
    got = tgrid.grid_sample_flat(torch.from_numpy(flat), src, _t(grid),
                                 mode=mode, padding_mode=padding_mode,
                                 align_corners=align_corners)
    assert warp_flat.launches == before  # the plain version on the CPU
    assert got.shape == (B, C, int(np.prod(out)))
    if mode == "nearest":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_warp_source_voxels_counts_what_the_warp_reads(rng, mode,
                                                       padding_mode):
    """The source voxels a warp needs (the bytes bound of its kernel) are
    those its output depends on: the nonzero entries of the gradient of
    the summed output (every weight is nonnegative, so none cancel)."""
    B, src, out = 2, (9, 8, 10), (5, 6, 7)
    grid = _t(_grid_np(_theta(rng, B), out, False))
    flat = torch.ones((B, 1, int(np.prod(src))), requires_grad=True)
    warp_flat_reference(flat, src, grid, mode=mode,
                        padding_mode=padding_mode).sum().backward()
    want = int((flat.grad != 0).sum())
    assert 0 < want < flat.numel()
    assert warp_source_voxels(src, grid, B, mode, padding_mode) == want
    # a unit-stride patch of a larger volume needs the patch's voxels only
    # (offsets 3, 2, 0 in x, y, z; every coordinate exact in binary)
    patch = tgrid.affine_grid(torch.tensor(
        [[[0.5, 0, 0, 0.25], [0, 0.5, 0, 0], [0, 0, 0.5, -0.5]]]), (4, 4, 4))
    assert warp_source_voxels((8, 8, 8), patch, 1, mode,
                              padding_mode) == 4 * 4 * 4


@pytest.mark.parametrize("mode,padding_mode,align_corners", [
    ("trilinear", "zeros", False), ("trilinear", "border", True),
    ("nearest", "zeros", False)])
def test_grid_sample_matches_jax(rng, mode, padding_mode, align_corners):
    B, C, src, out = 2, 3, (6, 5, 7), (4, 5, 6)
    vol = rng.standard_normal((B, *src, C)).astype(np.float32)
    grid = _grid_np(_theta(rng, B), out, align_corners)
    ref = np.asarray(jgrid.grid_sample(
        jnp.asarray(vol), tuple(map(jnp.asarray, grid)), mode=mode,
        padding_mode=padding_mode, align_corners=align_corners))
    got = tgrid.grid_sample(torch.from_numpy(vol), _t(grid), mode=mode,
                            padding_mode=padding_mode,
                            align_corners=align_corners)
    assert got.shape == (B, *out, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_identity_grid_roundtrip(rng):
    vol = rng.standard_normal((1, 6, 6, 6, 2)).astype(np.float32)
    grid = tuple(g[None] for g in tgrid.identity_grid((6, 6, 6)))
    got = tgrid.grid_sample(torch.from_numpy(vol), grid)
    np.testing.assert_allclose(got.numpy(), vol, atol=ATOL)


PALLAS_DHW = (8, 10, 128)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_flat_matches_pallas_interpret(padding_mode):
    """The in-window cases of tests/test_warp_pallas.py, where the TPU
    kernel is exact."""
    B, C, N = 1, 3, int(np.prod(PALLAS_DHW))
    flat = jax.random.normal(jax.random.PRNGKey(4), (B, C, N), jnp.float32)
    theta, _ = jax_rand_affine(jax.random.PRNGKey(11), B)
    grid = jgrid.affine_grid(theta, PALLAS_DHW, align_corners=False)
    ref = np.asarray(grid_sample_flat_pallas(
        flat, grid, PALLAS_DHW, padding_mode=padding_mode,
        align_corners=False, interpret=True))
    got = tgrid.grid_sample_flat(torch.from_numpy(np.array(flat)),
                                 PALLAS_DHW, _t(map(np.asarray, grid)),
                                 padding_mode=padding_mode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)


# The warp's four call sites in adaptation, as (C, source, output, mode,
# padding, scaled, batch): the border warp of the C = 1 input, the zeros
# unwarp of the logits, its adjoint (times 1 / |det|), and the nearest
# label sampling of a larger volume onto the patch (one volume).
AFFINE_SITES = {
    "border_input_c1": (1, (6, 8, 10), (6, 8, 10), "trilinear", "border",
                        False, 2),
    "zeros_unwarp_c3": (3, (6, 8, 10), (6, 8, 10), "trilinear", "zeros",
                        False, 2),
    "adjoint_scaled_c3": (3, (6, 8, 10), (6, 8, 10), "trilinear", "zeros",
                          True, 2),
    "nearest_labels": (1, (13, 17, 22), (6, 8, 9), "nearest", "zeros",
                       False, 1),
}


@pytest.mark.parametrize("site", sorted(AFFINE_SITES))
def test_warp_affine_flat_matches_jax_and_warp_flat(rng, site):
    """`warp_affine_flat` against the JAX `grid_sample_flat` on the JAX
    `affine_grid(theta)` (times the scale) at 1e-5, and exactly equal to
    `warp_flat` on the port's `affine_grid(theta)`."""
    C, src, out, mode, pad, scaled, B = AFFINE_SITES[site]
    theta = _theta(rng, B)
    flat = rng.standard_normal((B, C, int(np.prod(src)))).astype(np.float32)
    if mode == "nearest":
        flat = np.round(flat * 3)
    scale = (1.0 + 0.1 * rng.standard_normal(B)).astype(np.float32)
    ref = np.asarray(jgrid.grid_sample_flat(
        jnp.asarray(flat), src, jgrid.affine_grid(jnp.asarray(theta), out),
        mode=mode, padding_mode=pad))
    if scaled:
        ref = ref * scale[:, None, None]
    before = (warp_affine_flat.launches, warp_flat.launches)
    got = warp_affine_flat(torch.from_numpy(flat), src,
                           torch.from_numpy(theta), out, mode=mode,
                           padding_mode=pad,
                           scale=torch.from_numpy(scale) if scaled else None)
    assert (warp_affine_flat.launches, warp_flat.launches) == before
    assert got.shape == (B, C, int(np.prod(out)))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    same = warp_flat(torch.from_numpy(flat), src, tgrid.affine_grid(
        torch.from_numpy(theta), out), mode=mode, padding_mode=pad)
    if scaled:
        same = same * torch.from_numpy(scale).reshape(-1, 1, 1)
    assert torch.equal(got, same)


def test_warp_affine_flat_rejects_what_it_does_not_build(rng):
    flat = torch.zeros((2, 1, 6 * 8 * 10))
    theta = torch.from_numpy(_theta(rng, 2))
    with pytest.raises(ValueError, match="align_corners"):
        warp_affine_flat(flat, (6, 8, 10), theta, (6, 8, 10),
                         align_corners=True)
    with pytest.raises(ValueError, match="theta"):
        warp_affine_flat(flat, (6, 8, 10), theta[:, :2], (6, 8, 10))
    with pytest.raises(ValueError, match="scale"):
        warp_affine_flat(flat, (6, 8, 10), theta, (6, 8, 10),
                         scale=torch.ones(3))


def test_warp_adjoint_matches_jax_vjp(rng):
    """The unwarp of the TTA engine: forward by grid_inv, backward by grid
    times |det R(theta)| (engine.py:277-280, 336, 84-90 of the JAX
    package); the port takes the two affines and builds their grids in the
    warp kernel's affine entry."""
    B, C, spatial = 2, 3, (6, 8, 10)
    N = int(np.prod(spatial))
    noise = rng.standard_normal((B, 3, 4)).astype(np.float32)
    theta, theta_inv = get_rand_affine(torch.from_numpy(noise))
    grid = tgrid.affine_grid(theta, spatial)
    grid_inv = tgrid.affine_grid(theta_inv, spatial)
    adj = affine_abs_det(theta)
    x = rng.standard_normal((B, C, N)).astype(np.float32)
    ct = rng.standard_normal((B, C, N)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    out = _warp_with_inverse(xt, theta_inv, theta, adj, spatial, "zeros")
    (out * torch.from_numpy(ct)).sum().backward()

    def j(a):
        return tuple(jnp.asarray(g.numpy()) for g in a)

    ref_out, vjp = jax.vjp(
        lambda v: jax_wwi(v, j(grid_inv), j(grid), jnp.asarray(adj.numpy()),
                          spatial, "zeros"), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               atol=ATOL)


def test_rand_affine_matches_jax_on_the_same_noise():
    """get_rand_affine takes the noise that the JAX function draws."""
    key = jax.random.PRNGKey(3)
    k1, _ = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k1, (4, 3, 4), jnp.float32))
    ref, ref_inv = jax_rand_affine(key, 4)
    got, got_inv = get_rand_affine(torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)
    np.testing.assert_allclose(got_inv.numpy(), np.asarray(ref_inv),
                               atol=1e-6)
    from dg_tta_tpu.core.fields import compose_affine as jcompose
    from dg_tta_tpu_torch.core.fields import compose_affine
    np.testing.assert_allclose(
        compose_affine(got_inv, got).numpy(),
        np.asarray(jcompose(ref_inv, ref)), atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_and_affine_inside_mask_match_jax(rng, align_corners):
    """`warp` (grid_sample at identity + displacement) and the analytic
    inside-mask of an affine, against the JAX functions."""
    B, C, size = 2, 3, (5, 6, 7)
    vol = rng.standard_normal((B, *size, C)).astype(np.float32)
    ident = jgrid.identity_grid(size, align_corners)
    disp = [0.2 * rng.standard_normal((B, *size)).astype(np.float32)
            for _ in range(3)]
    grid = tuple(np.asarray(i[None] + d) for i, d in zip(ident, disp))
    ref = np.asarray(jax.jit(lambda v, g: jgrid.warp(
        v, g, padding_mode="border", align_corners=align_corners))(
            vol, grid))
    got = tgrid.warp(torch.from_numpy(vol), _t(grid), padding_mode="border",
                     align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    theta = _theta(rng, B) * np.float32(1.3)   # some voxels map outside
    ref_m = np.asarray(jgrid.affine_inside_mask_flat(
        jnp.asarray(theta), size, align_corners))
    got_m = tgrid.affine_inside_mask_flat(torch.from_numpy(theta), size,
                                          align_corners)
    assert got_m.dtype == torch.float32 and got_m.shape == (B, 1, 210)
    assert 0 < ref_m.sum() < ref_m.size
    np.testing.assert_array_equal(got_m.numpy(), ref_m)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_warp_adjoint_plain_matches_jax_vjp(rng, padding_mode,
                                            align_corners, C):
    """`warp_flat_adjoint`'s plain version against `jax.vjp` of the JAX
    `grid_sample_flat` (autodiff of its gather: the exact scatter-add), at
    1e-5: the same products, each summed into its source voxel in another
    order.  The grid reaches outside the source, so both paddings show."""
    from dg_tta_tpu_torch.kernels.warp import (warp_flat_adjoint,
                                               warp_flat_op)

    B, src, out = 2, (6, 5, 7), (4, 5, 6)
    flat = rng.standard_normal((B, C, int(np.prod(src)))).astype(np.float32)
    g = rng.standard_normal((B, C, int(np.prod(out)))).astype(np.float32)
    grid = _grid_np(_theta(rng, B) * np.float32(1.2), out, align_corners)
    _, vjp = jax.vjp(lambda v: jgrid.grid_sample_flat(
        v, src, tuple(map(jnp.asarray, grid)), padding_mode=padding_mode,
        align_corners=align_corners), jnp.asarray(flat))
    (ref,) = vjp(jnp.asarray(g))
    before = warp_flat_adjoint.launches
    got = warp_flat_adjoint(torch.from_numpy(g), src, _t(grid),
                            padding_mode=padding_mode,
                            align_corners=align_corners)
    assert warp_flat_adjoint.launches == before  # the plain version
    assert got.shape == flat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # through autograd: the grid entry forward, this adjoint backward
    xt = torch.from_numpy(flat).requires_grad_(True)
    y = warp_flat_op(xt, src, _t(grid), padding_mode=padding_mode,
                     align_corners=align_corners)
    (y * torch.from_numpy(g)).sum().backward()
    assert torch.equal(xt.grad, got)


def test_warp_adjoint_bf16_and_rejects(rng):
    """A bf16 gradient gives a bf16 adjoint, the f32 one rounded once; the
    wrapper refuses a shape that does not fit the grid."""
    from dg_tta_tpu_torch.kernels.warp import warp_flat_adjoint

    src = (6, 8, 10)
    grid = _t(_grid_np(_theta(rng, 1), src, False))
    g = torch.from_numpy(rng.standard_normal((1, 4, 480)).astype(np.float32))
    g16 = g.to(torch.bfloat16)
    got = warp_flat_adjoint(g16, src, grid)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, warp_flat_adjoint(g16.float(), src, grid)
                       .to(torch.bfloat16))
    with pytest.raises(ValueError, match="outputs"):
        warp_flat_adjoint(g[:, :, :100], src, grid)
    with pytest.raises(ValueError, match="padding_mode"):
        warp_flat_adjoint(g, src, grid, padding_mode="reflect")
