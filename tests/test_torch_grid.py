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
from dg_tta_tpu_torch.kernels.warp import (ADJOINT_PLAN, BRICK_XY,
                                           GRID_BLOCK, STAGE_MAX,
                                           STAGE_VOXELS,
                                           warp_affine_flat,
                                           warp_brick_paths, warp_bricks,
                                           warp_flat, warp_flat_reference,
                                           warp_plan, warp_source_voxels)
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


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_warp_affine_adjoint_plain_matches_jax_vjp(rng, padding_mode, C):
    """`warp_affine_flat_adjoint`'s plain version against `jax.vjp` of the
    JAX `grid_sample_flat` on the JAX `affine_grid(theta)` at 1e-5 (the
    same products, summed into each source voxel in another order; theta
    reaches outside the source, so both paddings show), a bf16 g giving
    that f32 adjoint rounded once; and `warp_affine_op` equal to
    `warp_flat_op` on the port's `affine_grid(theta)`, forward and
    gradient."""
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat_adjoint,
                                               warp_affine_op, warp_flat_op)

    B, src, out = 2, (6, 8, 10), (5, 8, 9)
    theta = _theta(rng, B) * np.float32(1.2)
    flat = rng.standard_normal((B, C, int(np.prod(src)))).astype(np.float32)
    g = rng.standard_normal((B, C, int(np.prod(out)))).astype(np.float32)
    jvjp = jax.jit(lambda v, t, c: jax.vjp(lambda x: jgrid.grid_sample_flat(
        x, src, jgrid.affine_grid(t, out), padding_mode=padding_mode),
        v)[1](c)[0])
    ref = np.asarray(jvjp(flat, theta, g))
    tt, gt = torch.from_numpy(theta), torch.from_numpy(g)
    before = warp_affine_flat_adjoint.launches
    got = warp_affine_flat_adjoint(gt, src, tt, out, padding_mode)
    assert warp_affine_flat_adjoint.launches == before  # the plain version
    assert got.shape == flat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    g16 = gt.to(torch.bfloat16)
    got16 = warp_affine_flat_adjoint(g16, src, tt, out, padding_mode)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, warp_affine_flat_adjoint(
        g16.float(), src, tt, out, padding_mode).to(torch.bfloat16))
    grads = []
    for op in ("affine", "grid"):
        xt = torch.from_numpy(flat).requires_grad_(True)
        y = (warp_affine_op(xt, src, tt, out, padding_mode) if op == "affine"
             else warp_flat_op(xt, src, tgrid.affine_grid(tt, out),
                               padding_mode))
        (y * gt).sum().backward()
        grads.append((y.detach(), xt.grad))
    (ya, ga), (yg, gg) = grads
    assert torch.equal(ya, yg) and torch.equal(ga, gg)
    assert torch.equal(ga, got)


# The forward kernel's bricks and the path each takes (staged source box or
# gathers from device memory), as `warp_brick_paths` predicts them: the
# card tests hold the kernel's counts to it.
def _brick_paths_loop(src, grid, C, element_size, mode, align_corners,
                      adjoint=False):
    """warp_brick_paths, brick by brick in numpy (f32 coordinates); with
    `adjoint`, the exact adjoint's: ADJOINT_PLAN's bricks and buffer, f32
    boxes, staged when one channel fits."""
    bz, buffer = warp_plan(C, element_size)
    if adjoint:
        element_size, mode = 4, "trilinear"
        bz, buffer = ADJOINT_PLAN
    D, H, W = src
    gx, gy, gz = (np.asarray(g, np.float32) for g in grid)
    B, Do, Ho, Wo = gx.shape
    by, bx = BRICK_XY
    vec = 16 // element_size
    paths = [0, 0]
    for b in range(B):
        for z0 in range(0, Do, bz):
            for y0 in range(0, Ho, by):
                for x0 in range(0, Wo, bx):
                    at = (b, slice(z0, z0 + bz), slice(y0, y0 + by),
                          slice(x0, x0 + bx))
                    box = 1
                    for c, n, axis in ((gz, D, "z"), (gy, H, "y"),
                                       (gx, W, "x")):
                        u = (((c[at] + np.float32(1)) * np.float32(n - 1)
                              * np.float32(0.5)) if align_corners else
                             ((c[at] + np.float32(1)) * np.float32(n)
                              - np.float32(1)) * np.float32(0.5))
                        first = np.rint(u) if mode == "nearest" \
                            else np.floor(u)
                        last = first + (mode != "nearest")
                        lo = int(np.clip(first, 0, n - 1).min())
                        hi = int(np.clip(last, 0, n - 1).max())
                        if axis == "x" and n % vec == 0:
                            lo -= lo % vec
                            box *= -(-(hi + 1 - lo) // vec) * vec
                        else:
                            box *= hi + 1 - lo
                    paths[box * (1 if adjoint else C) * element_size
                          > buffer] += 1
    return tuple(paths)


@pytest.mark.parametrize("case", [
    # C, element size, source, output, mode, align_corners, grid, adjoint
    (1, 4, (9, 21, 40), (9, 21, 40), "trilinear", False, "affine", False),
    (4, 2, (11, 17, 37), (6, 19, 45), "trilinear", False, "affine", False),
    (1, 4, (19, 13, 37), (19, 13, 37), "trilinear", True, "random", False),
    (1, 2, (19, 13, 37), (19, 13, 37), "trilinear", True, "random", False),
    (1, 4, (26, 30, 64), (9, 10, 33), "nearest", False, "patch", False),
    # the exact adjoint's bricks (f32 boxes, channels in passes): a bf16 g
    # on an affine grid, a random grid, a W that takes no 16-byte chunks
    (4, 2, (11, 17, 36), (6, 19, 45), "trilinear", False, "affine", True),
    (3, 4, (19, 13, 40), (19, 13, 40), "trilinear", True, "random", True),
    (12, 4, (9, 21, 37), (9, 21, 37), "trilinear", False, "affine", True),
    (4, 4, (24, 40, 64), (24, 40, 64), "trilinear", False, "random", True),
    (2, 4, (12, 40, 64), (12, 40, 64), "trilinear", False, "random", True),
])
def test_warp_brick_paths_matches_a_loop_over_bricks(rng, case):
    C, es, src, out, mode, align, kind, adjoint = case
    if kind == "random":
        ident = tgrid.identity_grid(out, align)
        grid = tuple(i[None] + torch.from_numpy(rng.normal(
            0.0, 0.2, size=(2, *out)).astype(np.float32)) for i in ident)
    elif kind == "patch":  # a unit-stride crop of the larger source
        grid = tgrid.affine_grid(torch.tensor(
            [[[33 / 64, 0, 0, 0.25], [0, 1 / 3, 0, 0.1],
              [0, 0, 9 / 26, -0.3]]]), out)
    else:
        grid = tgrid.affine_grid(torch.from_numpy(_theta(rng, 2)), out)
    B = grid[0].shape[0]
    got = warp_brick_paths(src, grid, C, es, B, mode, align, adjoint=adjoint)
    assert got == _brick_paths_loop(src, grid, C, es, mode, align, adjoint)
    depth = warp_plan(C, es)[0]
    if adjoint:  # the same bricks whichever entry
        assert warp_brick_paths(src, grid, C, es, B, mode, align, False,
                                True) == got
        depth = ADJOINT_PLAN[0]
    assert sum(got) == warp_bricks(B, out, depth) == B * np.prod(
        [-(-o // b) for o, b in zip(out, (depth, *BRICK_XY))])
    assert warp_brick_paths(src, grid, C, es, B, mode, align,
                            affine=False) == (0, B * -(-int(np.prod(out))
                                                       // GRID_BLOCK))


def test_warp_plan_holds_a_tta_brick_and_four_blocks():
    """The affine entry's bricks are 8 deep for C <= 2 and 4 deep above;
    a box buffer holds STAGE_VOXELS of the depth in every channel, at most
    STAGE_MAX, and at least 3500 voxels (a 4-deep brick's box under all but
    the strongest TTA draws) or 7000 (an 8-deep one's) for the main path's
    C (at most 4) in either type; it is a whole number of 16-byte chunks,
    and four blocks (with the 1 KB the card reserves per block) fit in an
    SM's 228 KB."""
    for es in (2, 4):
        for C in range(1, 9):
            depth, n = warp_plan(C, es)
            assert depth == (8 if C <= 2 else 4)
            assert n == min(C * es * STAGE_VOXELS[depth], STAGE_MAX)
            assert n % 16 == 0 and 4 * (n + 1024) <= 228 << 10
            if C <= 4:
                assert n // (C * es) >= (7000 if depth == 8 else 3500)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tta_sites_stage_every_brick(dtype):
    """At the four affine call sites of adaptation (chip_smoke's seeded
    draws, at the full patch) every brick stages its source box; over 16
    strength-0.05 draws (and their inverses) every brick does at C = 1,
    and at least 99% do at C = n_opt (the largest f32 boxes of a strong
    draw exceed a buffer); a strong zoom and rotation sends the bricks near
    the centre of the patch to device memory (those at the edges read
    clamped corners); so would a random grid, every brick (the grid entry,
    which takes such grids, stages none)."""
    import chip_smoke as cs

    es = torch.finfo(getattr(torch, dtype)).bits // 8
    P = cs.PATCH
    sites = cs._warp_sites(torch.Generator().manual_seed(2), "cpu")
    for _, C, src, theta, _, mode, _ in sites:
        grid = tgrid.affine_grid(theta, P)
        assert warp_brick_paths(src, grid, C, es, 1, mode) == \
            (warp_bricks(1, P, warp_plan(C, es)[0]), 0)
    gen = torch.Generator().manual_seed(5)
    staged = 0
    for _ in range(16):
        for theta in get_rand_affine(torch.randn((1, 3, 4), generator=gen)):
            grid = tgrid.affine_grid(theta, P)
            assert warp_brick_paths(P, grid, 1, es) == \
                (warp_bricks(1, P, 8), 0)
            staged += warp_brick_paths(P, grid, cs.N_OPT, es)[0]
    assert staged >= 0.99 * 32 * warp_bricks(1, P, 4)
    c, s = 3 * np.cos(0.3), 3 * np.sin(0.3)
    strong = torch.tensor([[[c, -s, 0.0, 0.0], [s, c, 0.0, 0.0],
                            [0.0, 0.0, 3.0, 0.0]]], dtype=torch.float32)
    staged, glob = warp_brick_paths(P, tgrid.affine_grid(strong, P), 1, es)
    assert glob > 0 and staged > 0
    ident = tgrid.identity_grid((24, 32, 64))
    noisy = tuple(i[None] + 0.5 * torch.randn((1, 24, 32, 64),
                                                generator=gen)
                  for i in ident)
    assert warp_brick_paths((24, 32, 64), noisy, 1, es)[0] == 0
    assert warp_brick_paths((24, 32, 64), noisy, 1, es, affine=False) == \
        (0, 24 * 32 * 64 // GRID_BLOCK)


def test_adjoint_sites_stage_every_brick():
    """The exact adjoint at the logit site (C = n_opt, the full patch):
    every brick stages its f32 box under 16 TTA draws of the inverse
    affine and on a deformable branch's inverse grid, where the box of all
    four channels overflows the buffer in about half of the bricks, so
    the kernel takes them in passes (one channel always fits)."""
    import chip_smoke as cs
    from dg_tta_tpu_torch.core.fields import deformable_grids

    P, C = cs.PATCH, cs.N_OPT
    n = warp_bricks(1, P, ADJOINT_PLAN[0])
    gen = torch.Generator().manual_seed(4)
    _, grid_inv = deformable_grids(
        torch.randn((1, *(s // 5 for s in P), 3), generator=gen), P)
    assert warp_brick_paths(P, grid_inv, C, 4, adjoint=True) == (n, 0)
    whole = warp_brick_paths(P, grid_inv, C, 4)   # all channels at once
    assert 0.3 * n < whole[1] < 0.7 * n
    for _ in range(16):
        _, theta_inv = get_rand_affine(torch.randn((1, 3, 4), generator=gen))
        grid = tgrid.affine_grid(theta_inv, P)
        assert warp_brick_paths(P, grid, C, 2, adjoint=True) == (n, 0)
