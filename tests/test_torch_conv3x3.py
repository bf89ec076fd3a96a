"""The port's conv3x3 (dg_tta_tpu_torch/kernels/conv3x3.py) against the
Pallas kernel it replaces and the XLA conv.

On the CPU `conv3x3` runs its plain version; these tests hold that version
against `conv3x3_pallas` in interpret mode and `ops/conv2d._plain_conv2d`
on the cases of tests/test_conv2d_pallas.py plus C=1, and the three-z-tap
form against the JAX U-Net's `_conv`.  The CUDA kernel itself needs the
card: tests/test_torch_cuda.py (marker `cuda`) and chip_smoke.py hold it
against the plain version there.

Tolerances: f32 1e-5 relative / 1e-4 absolute, the bound of
tests/test_conv2d_pallas.py (the same products summed in another order);
bf16 rtol 0.03 / atol 0.05 as there (both round an f32 sum to bf16, the
Pallas kernel per z-tap).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dg_tta_tpu.models.unet import _conv as jax_conv3d
from dg_tta_tpu.ops.conv2d import _plain_conv2d
from dg_tta_tpu.ops.conv2d_pallas import conv3x3_pallas
from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_flops,
                                              conv3x3_reference)

TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=0.03, atol=0.05)}
CASES = {
    # name: (seed, N, H, W, C, CO, dtype)
    "multitile": (0, 2, 28, 12, 8, 16, "float32"),
    "bf16_four_tiles": (1, 1, 64, 10, 8, 8, "bfloat16"),
    "h_prime": (2, 1, 5, 9, 4, 4, "float32"),
    "c1": (3, 2, 7, 11, 1, 8, "float32"),
    "c_ragged_bf16": (4, 3, 9, 13, 5, 12, "bfloat16"),
    # the stem of a MIND model (the "few" route on the card)
    "mind_stem": (11, 2, 9, 13, 12, 32, "float32"),
}


def _inputs(seed, N, H, W, C, CO, dtype, kz=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    wshape = (3, 3, C, CO) if kz is None else (kz, 3, 3, C, CO)
    w = (rng.normal(size=wshape) * 0.1).astype(np.float32)
    return x, w


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_and_xla(case):
    seed, N, H, W, C, CO, dtype = CASES[case]
    x, w = _inputs(seed, N, H, W, C, CO, dtype)
    got = conv3x3(_to_torch(x, dtype), _to_torch(w, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (N, H, W, CO)
    got = got.float().numpy()
    xj, wj = _to_jax(x, dtype), _to_jax(w, dtype)
    xla = np.asarray(_plain_conv2d(xj, wj, ((1, 1), (1, 1)), (1, 1)),
                     np.float32)
    pallas = np.asarray(conv3x3_pallas(xj, wj, interpret=True,
                                       mode_name="pairs"), np.float32)
    np.testing.assert_allclose(got, xla, **TOL[dtype])
    np.testing.assert_allclose(got, pallas, **TOL[dtype])


def _check_z_taps(B, D, H, W, C, CO, dtype):
    x, w = _inputs(5, B * D, H, W, C, CO, dtype, kz=3)
    got = conv3x3(_to_torch(x, dtype), _to_torch(w, dtype), depth=D)
    ref = jax_conv3d(_to_jax(x, dtype).reshape(B, D, H, W, C),
                     _to_jax(w, dtype), None)
    np.testing.assert_allclose(
        got.float().numpy().reshape(B, D, H, W, CO),
        np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D", [(1, 6), (2, 3), (1, 1)])
def test_z_taps_match_jax_unet_conv(B, D, dtype):
    """(3, 3, 3, C, CO) weights: the sum of the three z-tap 2D convs that
    `dg_tta_tpu/models/unet.py::_conv` builds, per volume of D planes."""
    _check_z_taps(B, D, 9, 12, 6, 10, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D", [(2, 3), (1, 1)])
def test_z_taps_match_jax_unet_conv_mind_stem(B, D, dtype):
    """The same at a MIND model's stem, C = 12 -> 32 (the "few" route on
    the card)."""
    _check_z_taps(B, D, 7, 11, 12, 32, dtype)


def _im2col(x, kz):
    """(N, D, H, W, C) -> (N, D, H, W, kz * 9 * C): the zero-padded
    neighbourhood of every voxel in the "few" route's K order, k = ((kz * 3
    + ky) * 3 + kx) * C + ci (z-taps past the volume read zeros)."""
    N, D, H, W, C = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    cols = [xp[:, z:z + D, ky:ky + H, kx:kx + W]
            for z in ((0, 1, 2) if kz == 3 else (1,))
            for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, axis=-1)


@pytest.mark.parametrize("layout", ["float32", "bfloat16"])
@pytest.mark.parametrize("kz", [1, 3])
def test_folded_k_order_matches_jax(kz, layout):
    """The "few" route's GEMM: an im2col of x in the kernel's (kz, ky, kx,
    ci) order (f32: each (kz, ky) row of taps the 3 x 12 floats of three
    pixels of the staged plane and, in its K padding to 40, the first 4
    channels of the next pixel, K = 360; bf16: 16 channels per tap, K =
    432), times the matrix `pack_few_weights` returns on the CPU equals
    JAX's `conv3x3_pallas` (one z-tap, interpret mode) and the JAX U-Net's
    `_conv` (three) within TOL: the index map the kernel uses, whose
    padded K reads land on zero rows."""
    from dg_tta_tpu_torch.kernels.conv3x3 import few_k, pack_few_weights

    B, D, H, W, C, CO = 2, 3, 7, 10, 12, 32
    x, w = _inputs(12, B * D, H, W, C, CO, "float32",
                   kz=None if kz == 1 else 3)
    cs, kp_route = few_k(C, kz, getattr(torch, layout))
    # f32: 9 (kz, ky) rows of 36 -> 40 (five k8 steps), 3 rows at one
    # z-tap; bf16: one k16 step of 16 channels per tap
    assert (cs, kp_route) == {(3, "float32"): (12, 360),
                              (3, "bfloat16"): (16, 432),
                              (1, "float32"): (12, 120),
                              (1, "bfloat16"): (16, 144)}[kz, layout]
    m = pack_few_weights(torch.from_numpy(w), getattr(torch, layout))
    assert m.dtype == torch.float32 and m.shape == (kp_route, CO)
    kr = kp_route // (kz * 3)
    rows = m.reshape(kz * 3, kr, CO)
    assert not rows[:, 3 * cs:].any()
    # the kernel's A: a (kz, ky) row of taps is kr contiguous values of
    # the staged plane from the pixel (h + ky - 1, w - 1): its three
    # pixels' cs channels and then the next pixel's first channels
    xs = np.pad(x, ((0, 0),) * 3 + ((0, cs - C),)).reshape(B, D, H, W, cs)
    xp = np.pad(xs, ((0, 0), (1, 1), (1, 1), (1, 3), (0, 0)))
    flat = xp.reshape(B, D + 2, H + 2, -1)
    cols = np.concatenate(
        [flat[:, z:z + D, ky:ky + H][..., np.arange(W)[:, None] * cs
                                     + np.arange(kr)]
         for z in ((0, 1, 2) if kz == 3 else (1,)) for ky in range(3)],
        axis=-1)
    got = (cols.reshape(-1, kp_route).astype(np.float64)
           @ m.numpy().astype(np.float64)).reshape(B * D, H, W, CO)
    if kz == 1:
        ref = conv3x3_pallas(_to_jax(x, "float32"), _to_jax(w, "float32"),
                             interpret=True, mode_name="pairs")
    else:
        ref = jax_conv3d(_to_jax(x, "float32").reshape(B, D, H, W, C),
                         _to_jax(w, "float32"), None)
    np.testing.assert_allclose(got, np.asarray(ref, np.float64).reshape(
        B * D, H, W, CO), **TOL["float32"])


def test_folded_k_pads_channels_to_16_in_bf16():
    """bf16: each tap's K rows hold 16 channels, zeros past C (the halo's
    32-byte pixels); f32 holds C rounded up to 4 channels per tap (the
    staged pixel's floats, 16-byte rows for ldmatrix), zeros past C, and
    each (kz, ky) row of three taps zero rows up to the k8 step."""
    from dg_tta_tpu_torch.kernels.conv3x3 import few_k, pack_few_weights

    w = torch.from_numpy(_inputs(13, 1, 1, 1, 5, 8, "float32", kz=3)[1])
    assert few_k(5, 3, torch.bfloat16) == (16, 432)
    assert few_k(5, 3, torch.float32) == (8, 216)
    assert few_k(2, 3, torch.float32) == (4, 144)
    assert few_k(15, 1, torch.float32) == (16, 144)
    m = pack_few_weights(w.bfloat16())
    assert m.dtype == torch.bfloat16 and m.shape == (432, 8)
    rows = m.float().reshape(27, 16, 8)
    assert torch.equal(rows[:, :5], w.bfloat16().float().reshape(27, 5, 8))
    assert not rows[:, 5:].any()
    m = pack_few_weights(w)
    assert m.shape == (216, 8)
    taps = m.reshape(27, 8, 8)
    assert torch.equal(taps[:, :5], w.reshape(27, 5, 8))
    assert not taps[:, 5:].any()


# The "c1" route's GEMMs (C = 1): (N, depth, H, W, CO, kz).  Ragged planes,
# one z-tap (K = 9 taps padded to 16), CO = 7 and 40 (zero columns past CO
# in the last 32-channel tile).
C1_GEMM_CASES = {
    "kz1_ragged_co7": (4, 2, 5, 7, 7, 1),
    "kz3_co32": (4, 4, 7, 10, 32, 3),
    "kz3_ragged_co40": (6, 3, 6, 9, 40, 3),
    "kz3_depth1_co7": (3, 1, 4, 3, 7, 3),
}


def c1_k(kz):
    """K of the "c1" GEMMs (csrc/conv3x3_c1.cu): the kz * 9 taps padded to
    whole MMA K steps, 16 (kz = 1) or 32 (kz = 3), in either type."""
    return 16 if kz == 1 else 32


# The "c1" forward's column order within each 32-channel tile: MMA column
# 8 j + 2 t + e (n8 tile j, accumulator columns 2 t + e of lane t) holds
# output channel 8 t + 2 j + e.
C1_COLUMNS = tuple(8 * (n % 8 // 2) + 2 * (n // 8) + n % 2 for n in range(32))


def pack_c1_weights(w):
    """The B operand that the "c1" forward kernel builds in registers from
    w (kz, 3, 3, 1, CO): a (c1_k(kz), COp) matrix, COp = CO rounded up to
    32, row k = tap (kz * 3 + ky) * 3 + kx (zero rows past kz * 9), column
    32 c + n = output channel 32 c + C1_COLUMNS[n] (zero past CO)."""
    kz, CO = w.shape[0], w.shape[-1]
    cop = -(-CO // 32) * 32
    m = np.zeros((c1_k(kz), cop), np.float64)
    m[:kz * 9, :CO] = w.reshape(kz * 9, CO)
    cols = [32 * (c // 32) + C1_COLUMNS[c % 32] for c in range(cop)]
    return m[:, cols]


def _c1_im2col(x, depth, kz):
    """(N, H, W, 1) -> (N, H, W, c1_k(kz)): the rows of the "c1" GEMMs'
    im2col operand, tap k = (kz * 3 + ky) * 3 + kx in column k (zeros past
    kz * 9), x zero-padded in H, W and past each group of `depth` planes."""
    N, H, W, _ = x.shape
    vp = np.pad(x[..., 0].reshape(N // depth, depth, H, W),
                ((0, 0), (1, 1), (1, 1), (1, 1)))
    cols = [vp[:, z:z + depth, ky:ky + H, kx:kx + W]
            for z in ((0, 1, 2) if kz == 3 else (1,))
            for ky in range(3) for kx in range(3)]
    a = np.stack(cols, axis=-1).reshape(N, H, W, kz * 9)
    return np.pad(a, ((0, 0),) * 3 + ((0, c1_k(kz) - kz * 9),))


def _c1_case(case):
    N, D, H, W, CO, kz = C1_GEMM_CASES[case]
    rng = np.random.default_rng(sorted(C1_GEMM_CASES).index(case) + 20)
    x = rng.normal(size=(N, H, W, 1)).astype(np.float32)
    w = (rng.normal(size=(kz, 3, 3, 1, CO)) * 0.3).astype(np.float32)
    dy = rng.normal(size=(N, H, W, CO)).astype(np.float64)
    return x, w, dy


@pytest.mark.parametrize("case", sorted(C1_GEMM_CASES))
def test_c1_forward_gemm_matches_jax(case):
    """The "c1" forward as its kernel computes it: im2col(x) (taps in K,
    zero-padded to `c1_k`) times the B operand the kernel builds
    (`pack_c1_weights`: zero rows past the taps, columns permuted within
    each 32-channel tile), the columns mapped back through `C1_COLUMNS`,
    equals `conv3x3_reference` and JAX (`conv3x3_pallas` in interpret mode
    for one z-tap, the U-Net's `_conv` for three) within TOL."""
    N, D, H, W, CO, kz = C1_GEMM_CASES[case]
    x, w, _ = _c1_case(case)
    b = pack_c1_weights(w)
    cop = -(-CO // 32) * 32
    assert b.shape == (c1_k(kz), cop) and not b[kz * 9:].any()
    packed = _c1_im2col(x, D, kz).astype(np.float64) @ b
    y = np.empty_like(packed)
    cols = [32 * (c // 32) + C1_COLUMNS[c % 32] for c in range(cop)]
    y[..., cols] = packed
    assert not y[..., CO:].any()
    y = y[..., :CO]
    w_in = w[0] if kz == 1 else w
    ref = conv3x3_reference(torch.from_numpy(x), torch.from_numpy(w_in),
                            depth=D).numpy()
    np.testing.assert_allclose(y, ref, **TOL["float32"])
    if kz == 1:
        jax_ref = conv3x3_pallas(_to_jax(x, "float32"),
                                 _to_jax(w_in, "float32"), interpret=True,
                                 mode_name="pairs")
    else:
        jax_ref = jax_conv3d(_to_jax(x, "float32").reshape(N // D, D, H, W,
                                                           1),
                             _to_jax(w, "float32"), None)
    np.testing.assert_allclose(
        y, np.asarray(jax_ref, np.float64).reshape(N, H, W, CO),
        **TOL["float32"])


@pytest.mark.parametrize("case", sorted(C1_GEMM_CASES))
def test_c1_wgrad_gemm_matches_jax(case):
    """The "c1" weight gradient as its kernel computes it: dW^T = dy^T
    im2col(x), the taps in N in the forward's K order (zero columns past
    the taps contribute zero rows), equals `conv3x3_wgrad_reference` and
    `jax.vjp` of the JAX U-Net's `_conv` with respect to w."""
    import jax

    from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3_wgrad_reference

    N, D, H, W, CO, kz = C1_GEMM_CASES[case]
    x, w, dy = _c1_case(case)
    a = _c1_im2col(x, D, kz).reshape(-1, _c1_im2col(x, D, kz).shape[-1])
    dwt = dy.reshape(-1, CO).T @ a.astype(np.float64)  # (CO, K)
    assert not dwt[:, kz * 9:].any()
    got = dwt[:, :kz * 9].T.reshape(kz, 3, 3, 1, CO)
    ref = conv3x3_wgrad_reference(torch.from_numpy(x),
                                  torch.from_numpy(dy.astype(np.float32)),
                                  depth=D, kz=kz).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    _, vjp = jax.vjp(lambda b: jax_conv3d(
        _to_jax(x, "float32").reshape(N // D, D, H, W, 1), b, None),
        _to_jax(w, "float32"))
    (jax_dw,) = vjp(_to_jax(dy.astype(np.float32).reshape(N // D, D, H, W,
                                                          CO), "float32"))
    np.testing.assert_allclose(got, np.asarray(jax_dw, np.float64),
                               rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("shape,co,dtype,splits", [
    # a trained step at TS104's first conv: one wave of 264 blocks
    ((224, 112, 112, 1), 32, torch.bfloat16, 264),
    ((224, 112, 112, 1), 32, torch.float32, 264),
    # two channel tiles share the wave
    ((224, 112, 112, 1), 40, torch.bfloat16, 132),
    # fewer tiles than blocks: one tile each (bf16 8 x 64, f32 4 x 64)
    ((4, 9, 70, 1), 32, torch.bfloat16, 4 * 2 * 2),
    ((4, 9, 70, 1), 32, torch.float32, 4 * 3 * 2),
])
def test_wgrad_c1_splits(shape, co, dtype, splits):
    from dg_tta_tpu_torch.kernels.conv3x3 import wgrad_c1_splits

    assert wgrad_c1_splits(shape, co, dtype) == splits


def test_c1_columns_give_each_lane_eight_contiguous_channels():
    """Lane t of a quad accumulates MMA columns 8 j + 2 t + e (n8 tile j);
    through `C1_COLUMNS` those are channels 8 t .. 8 t + 7 in the order
    (j, e), which the kernel stores as one 16-byte run per pixel."""
    assert sorted(C1_COLUMNS) == list(range(32))
    for t in range(4):
        assert [C1_COLUMNS[8 * j + 2 * t + e] for j in range(4)
                for e in range(2)] == list(range(8 * t, 8 * t + 8))


def test_single_z_tap_weight_equals_2d():
    x, w = _inputs(6, 4, 8, 8, 3, 5, "float32")
    a = conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    b = conv3x3(torch.from_numpy(x), torch.from_numpy(w)[None], depth=2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("bad", ["x_rank", "w_kernel", "channels", "depth",
                                 "dtype_mix", "dtype_f16"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 6, 6, 3)
    w = torch.zeros(3, 3, 3, 3, 5)
    args = {"x_rank": (x[0], w, 1),
            "w_kernel": (x, torch.zeros(3, 5, 5, 3, 5), 1),
            "channels": (x, torch.zeros(3, 3, 3, 4, 5), 1),
            "depth": (x, w, 3),
            "dtype_mix": (x, w.bfloat16(), 1),
            "dtype_f16": (x.half(), w.half(), 1)}[bad]
    with pytest.raises(ValueError):
        conv3x3(*args)


def test_cpu_path_does_not_count_launches():
    before = conv3x3.launches
    x, w = _inputs(7, 2, 5, 5, 2, 3, "float32")
    conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    assert conv3x3.launches == before


def _taps_inside(N, H, W, depth, kz):
    """Brute-force count of (output point, tap) pairs that read x inside
    its volume, not its zero padding."""
    n = 0
    for p in range(N):
        z = p % depth
        for h in range(H):
            for w in range(W):
                for dz in (range(-1, 2) if kz == 3 else (0,)):
                    for dy in range(-1, 2):
                        for dx in range(-1, 2):
                            n += (0 <= z + dz < depth and 0 <= h + dy < H
                                  and 0 <= w + dx < W)
    return n


def test_flops_count_skips_z_taps_past_the_volume():
    """And H/W taps past the plane's edges."""
    # depth 4: 4 centre z-taps + 3 + 3 neighbour z-taps = 10 = 3 * 4 - 2;
    # likewise 3 * 5 - 2 = 13 taps in H and 3 * 7 - 2 = 19 in W
    assert conv3x3_flops((8, 5, 7, 3), (3, 3, 3, 3, 2), depth=4) == \
        2 * 13 * 19 * 3 * 2 * 2 * 10
    assert conv3x3_flops((8, 5, 7, 3), (3, 3, 3, 2)) == \
        2 * 13 * 19 * 3 * 2 * 8
    for N, H, W, depth, kz in [(8, 5, 7, 4, 3), (8, 5, 7, 1, 1),
                               (3, 1, 2, 3, 3), (2, 1, 1, 1, 3),
                               (6, 4, 3, 2, 1)]:
        w_shape = (3, 3, 3, 3, 2) if kz == 3 else (3, 3, 3, 2)
        assert conv3x3_flops((N, H, W, 3), w_shape, depth) == \
            2 * 3 * 2 * _taps_inside(N, H, W, depth, kz)


@pytest.mark.parametrize("C,CO,dtype,route,wgrad_route", [
    (32, 32, torch.bfloat16, "wgmma", "wgmma"),
    (16, 40, torch.bfloat16, "wgmma", "wgmma"),
    (320, 320, torch.bfloat16, "wgmma", "wgmma"),
    # the first conv, on the image, in either type, for any CO
    (1, 32, torch.bfloat16, "c1", "c1"),
    (1, 32, torch.float32, "c1", "c1"),
    (1, 7, torch.float32, "c1", "c1"),
    (1, 7, torch.bfloat16, "c1", "c1"),
    (1, 40, torch.float32, "c1", "c1"),
    (1, 40, torch.bfloat16, "c1", "c1"),
    # C % 16 != 0: on x and w zero-padded to 32 channels
    (24, 32, torch.bfloat16, "wgmma", "wgmma"),
    (32, 12, torch.bfloat16, "cuda_core", "cuda_core"),  # CO % 8 != 0
    # f32 on the tensor cores as 3xTF32, its weight gradient too
    (32, 32, torch.float32, "wgmma_tf32x3", "wgmma_tf32x3"),
    (24, 40, torch.float32, "wgmma_tf32x3", "wgmma_tf32x3"),
    (512, 256, torch.float32, "wgmma_tf32x3", "wgmma_tf32x3"),
    # a few input channels: the taps folded into K, either type
    (8, 8, torch.float32, "few", "few"),
    (32, 12, torch.float32, "cuda_core", "cuda_core"),   # CO % 8 != 0
    # the 12-channel stem of a MIND model, at its own C in either type
    (12, 32, torch.float32, "few", "few"),
    (12, 32, torch.bfloat16, "few", "few"),
    (2, 32, torch.bfloat16, "few", "few"),
    (15, 16, torch.float32, "few", "few"),
    (15, 40, torch.bfloat16, "few", "few"),
    (16, 32, torch.bfloat16, "wgmma", "wgmma"),
    (16, 32, torch.float32, "wgmma_tf32x3", "wgmma_tf32x3"),
    (12, 20, torch.bfloat16, "cuda_core", "cuda_core"),  # CO % 8 != 0
    (12, 20, torch.float32, "cuda_core", "cuda_core"),
    # a plan's ragged widths (base 30, cap 300) and a GIN_MIND stem into
    # them: the catch-all, on the tensor cores
    (30, 30, torch.bfloat16, "cuda_core", "cuda_core"),
    (30, 30, torch.float32, "cuda_core", "cuda_core"),
    (60, 60, torch.bfloat16, "cuda_core", "cuda_core"),
    (60, 60, torch.float32, "cuda_core", "cuda_core"),
    (300, 300, torch.bfloat16, "cuda_core", "cuda_core"),
    (300, 300, torch.float32, "cuda_core", "cuda_core"),
    (120, 60, torch.bfloat16, "cuda_core", "cuda_core"),
    (120, 60, torch.float32, "cuda_core", "cuda_core"),
    (12, 30, torch.bfloat16, "cuda_core", "cuda_core"),
    (12, 30, torch.float32, "cuda_core", "cuda_core"),
])
def test_routes(C, CO, dtype, route, wgrad_route):
    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_route,
                                                  conv3x3_wgrad_route)

    assert conv3x3_route(C, CO, dtype) == route
    assert conv3x3_wgrad_route(C, CO, dtype) == wgrad_route


@pytest.mark.parametrize("route,chosen,dtype,picked", [
    (None, "few", torch.bfloat16, "few"),
    ("wgmma", "few", torch.bfloat16, "wgmma"),
    ("wgmma_tf32x3", "few", torch.float32, "wgmma_tf32x3"),
    ("cuda_core", "few", torch.float32, "cuda_core"),
    ("cuda_core", "wgmma", torch.bfloat16, "cuda_core"),
    ("wgmma_tf32x3", "few", torch.bfloat16, None),
    ("wgmma", "few", torch.float32, None),
    ("few", "wgmma", torch.bfloat16, None),
    ("c1", "few", torch.float32, None),
])
def test_forced_routes(route, chosen, dtype, picked):
    """A caller may force the catch-all kernels onto any shape and the
    type's wgmma route (on zero-padded channels) onto a shape that chooses
    "few", to time two routes on one shape; nothing else."""
    from dg_tta_tpu_torch.kernels.conv3x3 import _pick_route

    if picked is None:
        with pytest.raises(ValueError, match="does not take"):
            _pick_route(route, chosen, dtype)
    else:
        assert _pick_route(route, chosen, dtype) == picked


@pytest.mark.parametrize("C,route,padded", [
    (12, "wgmma", 16), (12, "wgmma_tf32x3", 16), (20, "wgmma", 32),
    (20, "wgmma_tf32x3", 24), (16, "wgmma", 16), (12, "cuda_core", 12),
    (1, "c1", 1)])
def test_padded_channels_leave_conv_and_wgrad_unchanged(C, route, padded):
    """What the tensor-core routes run for a C that is not a multiple of
    their K step: x and w zero-padded to `route_channels`, which leaves the
    conv unchanged and whose weight gradient, cut back to C, is the
    unpadded one (plain versions, f32; 1e-5 of the range: the same products
    and zeros, summed in another order)."""
    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_wgrad_reference,
                                                  pad_channels,
                                                  route_channels)

    assert route_channels(C, route) == padded
    x, w = _inputs(9, 6, 7, 9, C, 8, "float32", kz=3)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    xp, wp = pad_channels(x, padded), pad_channels(w, padded, dim=-2)
    assert xp.shape == (6, 7, 9, padded) and wp.shape == (3, 3, 3, padded, 8)
    assert torch.equal(xp[..., :C], x) and not xp[..., C:].any()
    assert pad_channels(x, C) is x
    ref = conv3x3_reference(x, w, depth=3)
    torch.testing.assert_close(conv3x3_reference(xp, wp, depth=3), ref,
                               rtol=0, atol=1e-5 * ref.abs().max().item())
    dy = torch.from_numpy(np.random.default_rng(10).normal(
        size=(6, 7, 9, 8)).astype(np.float32))
    dw = conv3x3_wgrad_reference(x, dy, depth=3)
    dwp = conv3x3_wgrad_reference(xp, dy, depth=3)
    torch.testing.assert_close(dwp[..., :C, :], dw, rtol=0,
                               atol=1e-5 * dw.abs().max().item())
    assert not dwp[..., C:, :].any()


def test_tf32_split_is_exact():
    """w_hi has its low 13 mantissa bits clear and w_hi + w_lo == w
    exactly; |w_lo| <= 2^-11 |w| (round to nearest)."""
    from dg_tta_tpu_torch.kernels.conv3x3 import tf32_split

    rng = np.random.default_rng(8)
    w = torch.from_numpy((rng.normal(size=4096)
                          * 10.0 ** rng.uniform(-6, 3, size=4096))
                         .astype(np.float32))
    hi, lo = tf32_split(w)
    assert hi.dtype == lo.dtype == torch.float32
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, w)
    assert (lo.abs() <= w.abs() * 2.0 ** -11).all()


def _tf32(a, mode):
    """a (float64 array of f32 values) as tf32: rounded to nearest
    ("rna", the kernel's cvt.rna) or truncated ("rz", the low bits a
    tensor core ignores)."""
    bits = a.astype(np.float32).view(np.int32)
    if mode == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(np.float32).astype(np.float64)


def _conv64(x, w):
    """(N, D, H, W, C) x (3, 3, 3, C, CO) conv in float64, zero-padded."""
    import torch.nn.functional as F

    y = F.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                 torch.from_numpy(w).permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("C", [8, 64, 512])
def test_3xtf32_products_meet_the_f32_tolerance(C):
    """The "wgmma_tf32x3" forward's algorithm in float64: x split in the
    kernel (hi rounded to tf32; lo the exact remainder, as the tensor core
    reads it, truncated), w by `tf32_split` (hi; lo truncated too), the
    three products x_hi w_hi + x_hi w_lo + x_lo w_hi summed exactly.  It
    stays within the route's f32 tolerance of the exact conv, 5e-5 of the
    output's range (chip_smoke KERNEL_RTOL), where TF32 alone misses it.
    (The weight gradient rounds its lo parts to nearest: closer still.)"""
    from dg_tta_tpu_torch.kernels.conv3x3 import tf32_split

    rng = np.random.default_rng(C)
    x = rng.normal(size=(1, 3, 5, 6, C)).astype(np.float32).astype(np.float64)
    w32 = (rng.normal(size=(3, 3, 3, C, 8)) * (2.0 / (27 * C)) ** 0.5) \
        .astype(np.float32)
    w = w32.astype(np.float64)
    w_hi, w_lo = (t.numpy().astype(np.float64)
                  for t in tf32_split(torch.from_numpy(w32)))
    x_hi = _tf32(x, "rna")
    x_lo = _tf32(x - x_hi, "rz")
    w_lo = _tf32(w_lo, "rz")
    exact = _conv64(x, w)
    scale = np.abs(exact).max()
    got = _conv64(x_hi, w_hi) + _conv64(x_hi, w_lo) + _conv64(x_lo, w_hi)
    assert np.abs(got - exact).max() <= 5e-5 * scale / 10
    tf32_alone = _conv64(x_hi, w_hi)
    assert np.abs(tf32_alone - exact).max() > 5e-5 * scale


def _longest_wgrad_few_k():
    """The most positions one accumulator of the "few" route's f32 weight
    gradient sums at the MIND stem's shape: a trained step's batch and the
    grouped runs' (`few_plan`'s `longest`)."""
    from dg_tta_tpu_torch.kernels.conv3x3 import few_plan

    cs = _chip_smoke()
    depth, H, W, C, CO = cs.STEM_SHAPE
    groups = [1] + [g for n, g in cs.GROUPED_RUNS if n == "float32"]
    return max(few_plan(2 * g * depth, depth, H, W, C, CO, torch.float32,
                        wgrad=True)["longest"] for g in groups)


def _longest_wgrad_tf32x3_k(kernel="tf32x3_n32"):
    """The most positions one block of the f32 weight gradient's `kernel`
    (csrc/conv3x3_wgrad_wgmma.cu, `wgrad_plan`) sums at a TS104 shape: a
    trained step's batch (N = 2 x depth planes) and the grouped runs'."""
    from dg_tta_tpu_torch.kernels.conv3x3 import wgrad_plan

    cs = _chip_smoke()
    groups = [1] + [g for n, g in cs.GROUPED_RUNS if n == "float32"]
    longest = 0
    for depth, H, W, C, CO, _ in cs.TS104_CONV_SHAPES:
        if C == 1:
            continue
        for g in groups:
            p = wgrad_plan(2 * g * depth, H, W, C, CO, torch.float32)
            if p["kernel"] == kernel:
                longest = max(longest, p["longest"])
    return longest


def _longest_wgmma_k():
    """The longest sum one block of the f32 forward accumulates at a
    main-path shape (window, step and grouped step, forward and input
    gradient): its run of (z-tap, channel chunk) stages of an interior
    plane, 9 x kc of K each (`wgmma_plan`; a cluster's blocks split the
    stages, and their partial sums are added with rounding)."""
    from dg_tta_tpu_torch.kernels.conv3x3 import wgmma_plan

    cs = _chip_smoke()
    groups = [1] + [g for n, g in cs.GROUPED_RUNS if n == "float32"]
    longest = 0
    for depth, H, W, C, CO, _ in cs.TS104_CONV_SHAPES:
        if C == 1:
            continue
        for N in [depth] + [2 * g * depth for g in groups]:
            for c, co in ((C, CO), (CO, C)):
                p = wgmma_plan(N, depth, H, W, c, co, torch.float32)
                stages = 3 * (c // p["kc"])
                longest = max(longest,
                              -(-stages // p["splits"]) * 9 * p["kc"])
    return longest


# how each kernel rounds the lo part of the operand it splits itself: the
# forward and the weight gradient leave the exact remainder for the tensor
# core to truncate
LO_ROUNDING = {"conv3x3_wgmma.cu": "rz", "conv3x3_wgrad_wgmma.cu": "rz",
               "conv3x3_few.cu": "rz"}


@pytest.mark.parametrize("source,k_per_stage,tol", [
    # the forward and input gradient: 9 taps x 16 channels per stage, K =
    # the longest run of stages of one block (27 x 512)
    ("conv3x3_wgmma.cu", 144, 5e-5),
    # the weight gradient, 32 output columns a block: 64 positions per
    # stage, K = the longest sum of one block (the splits' partial sums
    # are then added with rounding)
    ("conv3x3_wgrad_wgmma.cu", 64, 1e-4),
    # its 64-column kernel: no promotion, K = its longest split
    ("conv3x3_wgrad_wgmma.cu", None, 1e-4),
    # the "few" route's forward: K = 360 at the MIND stem, no promotion
    ("conv3x3_few.cu", None, 5e-5),
    # its weight gradient: 24 positions per accumulator a step (half of 6 x
    # 8), the longest accumulator's sum
    ("conv3x3_few.cu", 24, 1e-4),
])
def test_3xtf32_promotion_bounds_truncated_accumulation(source, k_per_stage,
                                                        tol):
    """The tensor cores add each step's products into the f32 accumulator
    with truncation.  Over the longest K of the main path that drift
    reaches ~1e-4 of the output's range (forward, K = 27 x 512 in one
    block) or ~3e-4 (weight gradient, ~37k positions per block, and up
    to 131072 on its 32-column f32 kernel); each kernel therefore adds its
    accumulator into a second, rounded f32 sum every `kPromote` stages
    (csrc/conv3x3_wgmma.cu: 3 stages of 9 taps x 16 channels;
    csrc/conv3x3_wgrad_wgmma.cu's 32-column f32 kernel, the weight
    gradient of csrc/conv3x3_few.cu), except the "few" forward, whose K of
    360 needs none, and the 64-column f32 weight gradient, whose plan
    keeps each block's sum to 2048 positions.  A model of that: k8 steps
    of three exact 8-term products, each step's sum truncated to f32, with
    and without the promotion; it must stay within half the route's
    tolerance (chip_smoke KERNEL_RTOL, WGRAD_RTOL)."""
    import re
    from pathlib import Path

    from dg_tta_tpu_torch.kernels.conv3x3 import few_k

    src = (Path(__file__).resolve().parents[1] / "dg_tta_tpu_torch"
           / "kernels" / "csrc" / source).read_text()
    steps_per_promotion = 0
    if k_per_stage is not None:
        promote = int(re.search(r"constexpr int kPromote = (\d+);", src)[1])
        steps_per_promotion = promote * k_per_stage // 8
    rng = np.random.default_rng(9)
    M = 96
    K = {"conv3x3_wgmma.cu": _longest_wgmma_k,
         "conv3x3_wgrad_wgmma.cu": lambda: _longest_wgrad_tf32x3_k(
             "tf32x3_n32" if k_per_stage else "tf32x3_n64"),
         "conv3x3_few.cu": lambda: (few_k(12, 3, torch.float32)[1]
                                    if k_per_stage is None
                                    else _longest_wgrad_few_k())}[source]()
    assert K >= 8 * steps_per_promotion
    a = rng.normal(size=(M, K)).astype(np.float32).astype(np.float64)
    b = (rng.normal(size=K) * (2.0 / K) ** 0.5).astype(np.float32) \
        .astype(np.float64)
    exact = a @ b
    a_hi = _tf32(a, "rna")
    a_lo = _tf32(a - a_hi, LO_ROUNDING.get(source, "rna"))
    b_hi = _tf32(b, "rna")
    b_lo = _tf32(b - b_hi, "rz")

    def trunc32(v):
        f = v.astype(np.float32)
        over = np.abs(f.astype(np.float64)) > np.abs(v)
        f[over] = np.nextafter(f[over], np.float32(0))
        return f.astype(np.float64)

    def run(every):
        acc = np.zeros(M)
        tot = np.zeros(M, np.float32)
        for s, k0 in enumerate(range(0, K, 8)):
            sl = slice(k0, k0 + 8)
            for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                acc = trunc32(acc + pa[:, sl] @ pb[sl])
            if every and (s + 1) % every == 0:
                tot = tot + acc.astype(np.float32)
                acc[:] = 0
        tot = tot + acc.astype(np.float32)
        return np.abs(tot - exact).max() / np.abs(exact).max()

    assert run(steps_per_promotion) <= tol / 2
    if steps_per_promotion:
        assert run(0) > run(steps_per_promotion)


def test_strided_convs_run_without_tf32(monkeypatch):
    """The U-Net's stride-2 convs (cuDNN on the card) see
    `torch.backends.cudnn.allow_tf32` False in their forward and in their
    backward, which autograd runs outside the forward's scope; the flag is
    PyTorch's default again afterwards; the gradients are those of
    `F.conv3d`."""
    import torch.nn.functional as F

    from dg_tta_tpu_torch.models.plans import ArchSpec
    from dg_tta_tpu_torch.models.unet import (PlainConvUNet, _StridedConv3d,
                                              init_unet_)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    def recording(fn, what):
        # the strided convs only: the stride-1 convs' plain versions, which
        # the CPU runs in place of the kernels, call these too
        def wrapped(*args, **kw):
            if kw.get("stride", 1) not in (1, (1, 1, 1)):
                seen.append((what, torch.backends.cudnn.allow_tf32))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(F, "conv3d", recording(F.conv3d, "forward"))
    monkeypatch.setattr(torch.nn.grad, "conv3d_input",
                        recording(torch.nn.grad.conv3d_input, "dgrad"))
    monkeypatch.setattr(torch.nn.grad, "conv3d_weight",
                        recording(torch.nn.grad.conv3d_weight, "wgrad"))
    spec = ArchSpec(features_per_stage=(4, 8, 8),
                    kernel_sizes=((3, 3, 3),) * 3,
                    strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
                    n_conv_per_stage_encoder=(1, 1, 1),
                    n_conv_per_stage_decoder=(1, 1), num_input_channels=1,
                    num_classes=3)
    net = init_unet_(PlainConvUNet(spec), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(1, 8, 8, 8, 1)).astype(np.float32))
    net(x).square().sum().backward()
    assert torch.backends.cudnn.allow_tf32 is True
    assert sorted(set(seen)) == [("dgrad", False), ("forward", False),
                                 ("wgrad", False)]
    assert len([s for s in seen if s[0] == "forward"]) == 2

    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.normal(size=(2, 3, 7, 9, 5)))
    ws = torch.from_numpy(rng.normal(size=(4, 3, 3, 3, 3)))
    ct = torch.from_numpy(rng.normal(size=(2, 4, 4, 5, 3)))
    outs = []
    for fn in (lambda a, b: _StridedConv3d.apply(a, b, (2, 2, 2), (1, 1, 1)),
               lambda a, b: F.conv3d(a, b, stride=2, padding=1)):
        a, b = xs.clone().requires_grad_(), ws.clone().requires_grad_()
        y = fn(a, b)
        (y * ct).sum().backward()
        outs.append((y.detach(), a.grad, b.grad))
    for ref, got in zip(*outs):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expected_launches_route_split(dtype):
    """chip_smoke's launch count at a tiny spec, worked out by hand.

    Stride-1 convs per forward: stage 0 (1 -> 16, 16 -> 16), stage 1's
    second (32 -> 32; its first is strided, cuDNN), decoder (32 -> 16,
    16 -> 16): 5 forward launches, 4 input gradients (not the first), 5
    weight gradients.  The C = 1 conv takes the "c1" route (forward and
    weight gradient) in both types; the other four take "wgmma" in bf16,
    "wgmma_tf32x3" in f32 (forward, input and weight gradient).  Plan: 2 epochs x 4 patches, the
    second epoch trained: 8 patch forwards + 2 evals = 10 forwards, 4
    trained steps; 3 windows; 2 members.
      conv3x3 = 2 x (10 x 5 + 4 x 4) + 3 x 2 x 5 = 162, of it
        c1 = 2 x 10 + 3 x 2 = 26, the wgmma route of the type 136
      conv3x3_wgrad = 2 x 4 x 5 = 40, of it c1 8, the wgmma route of
        the type 32, none on "cuda_core"
      warp_affine = 2 x (8 x 4 + 4 x 2 + 2) = 84 (every warp is by an
        affine), warp (the grid entry) = 0, warp_adjoint and
        warp_affine_adjoint (exact) = 0
    """
    from dg_tta_tpu_torch.models.plans import ArchSpec

    spec = ArchSpec(features_per_stage=(16, 32),
                    kernel_sizes=((3, 3, 3),) * 2,
                    strides=((1, 1, 1), (2, 2, 2)),
                    n_conv_per_stage_encoder=(2, 2),
                    n_conv_per_stage_decoder=(2,), num_input_channels=1,
                    num_classes=4)
    plan = dict(epochs=2, patches_to_be_accumulated=4, start_tta_at_epoch=1)
    got = _chip_smoke().expected_launches(spec, 3, 2, plan, dtype)
    bf16 = dtype == "bfloat16"
    assert got == dict(
        conv3x3=162, conv3x3_c1=26, conv3x3_few=0,
        conv3x3_wgmma=136 if bf16 else 0,
        conv3x3_wgmma_tf32x3=0 if bf16 else 136, conv3x3_cuda_core=0,
        conv3x3_wgrad=40, conv3x3_wgrad_c1=8, conv3x3_wgrad_few=0,
        conv3x3_wgrad_wgmma=32 if bf16 else 0,
        conv3x3_wgrad_wgmma_tf32x3=0 if bf16 else 32,
        conv3x3_wgrad_cuda_core=0, conv3x3_padded=0,
        conv3x3_wgrad_padded=0, warp=0, warp_affine=84, warp_adjoint=0,
        warp_affine_adjoint=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expected_launches_mind_stem(dtype):
    """The same spec with a MIND model's 12 input channels: the stem
    (12 -> 16, no input gradient) leaves "c1" for the "few" route in
    either type, at its own 12 channels: its 2 x 10 + 3 x 2 = 26 forwards
    and 2 x 4 = 8 weight gradients, none of them padded; the other convs
    keep the wgmma route of the type (136 forwards, 32 weight
    gradients)."""
    from dg_tta_tpu_torch.models.plans import ArchSpec

    spec = ArchSpec(features_per_stage=(16, 32),
                    kernel_sizes=((3, 3, 3),) * 2,
                    strides=((1, 1, 1), (2, 2, 2)),
                    n_conv_per_stage_encoder=(2, 2),
                    n_conv_per_stage_decoder=(2,), num_input_channels=12,
                    num_classes=4)
    plan = dict(epochs=2, patches_to_be_accumulated=4, start_tta_at_epoch=1)
    got = _chip_smoke().expected_launches(spec, 3, 2, plan, dtype)
    bf16 = dtype == "bfloat16"
    assert got == dict(
        conv3x3=162, conv3x3_c1=0, conv3x3_few=26,
        conv3x3_wgmma=136 if bf16 else 0,
        conv3x3_wgmma_tf32x3=0 if bf16 else 136, conv3x3_cuda_core=0,
        conv3x3_wgrad=40, conv3x3_wgrad_c1=0, conv3x3_wgrad_few=8,
        conv3x3_wgrad_wgmma=32 if bf16 else 0,
        conv3x3_wgrad_wgmma_tf32x3=0 if bf16 else 32,
        conv3x3_wgrad_cuda_core=0, conv3x3_padded=0,
        conv3x3_wgrad_padded=0, warp=0, warp_affine=84, warp_adjoint=0,
        warp_affine_adjoint=0)


@pytest.mark.parametrize("spatial,exact,warps", [
    ("deformable", False, (400, 4, 0, 0)),
    ("deformable", True, (384, 4, 16, 0)),
    ("affine", True, (0, 68, 0, 16)),
    ("affine", False, (0, 84, 0, 0)),
])
def test_expected_launches_warp_entries(spatial, exact, warps):
    """The warp's four entries at the plan of
    test_expected_launches_route_split (2 members, 8 patch steps of which
    4 trained, 2 evals, both branches warped), worked out by hand as
    (grid entry, affine entry, exact adjoint's grid entry, its affine
    entry):
      deformable: per step and branch 10 field warps, the input warp and
        the unwarp, 2 x 8 x 2 x 12 = 384, plus the fast adjoints on the
        grid entry, 2 x 4 x 2 = 16, or the exact ones on the exact
        adjoint's grid entry; the affine entry samples the evals' labels
        only, 2 x 2 = 4;
      affine, exact: the input warps and the unwarps (2 x 8 x 2 x 2 = 64)
        and the label samplings (4) on the affine entry, the exact
        adjoints (16) on the exact adjoint's affine entry; no grid entry.
    The conv counts do not depend on the warps."""
    from dg_tta_tpu_torch.models.plans import ArchSpec

    spec = ArchSpec(features_per_stage=(16, 32),
                    kernel_sizes=((3, 3, 3),) * 2,
                    strides=((1, 1, 1), (2, 2, 2)),
                    n_conv_per_stage_encoder=(2, 2),
                    n_conv_per_stage_decoder=(2,), num_input_channels=1,
                    num_classes=4)
    plan = dict(epochs=2, patches_to_be_accumulated=4, start_tta_at_epoch=1,
                spatial_aug_type=spatial, do_spatial_aug_in="both")
    mod = _chip_smoke()
    got = mod.expected_launches(spec, 3, 2, plan, "float32", exact)
    assert (got["warp"], got["warp_affine"], got["warp_adjoint"],
            got["warp_affine_adjoint"]) == warps
    base = mod.expected_launches(spec, 3, 2, dict(
        epochs=2, patches_to_be_accumulated=4, start_tta_at_epoch=1),
        "float32")
    assert {k: v for k, v in got.items() if k.startswith("conv")} == \
        {k: v for k, v in base.items() if k.startswith("conv")}
