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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D", [(1, 6), (2, 3), (1, 1)])
def test_z_taps_match_jax_unet_conv(B, D, dtype):
    """(3, 3, 3, C, CO) weights: the sum of the three z-tap 2D convs that
    `dg_tta_tpu/models/unet.py::_conv` builds, per volume of D planes."""
    H, W, C, CO = 9, 12, 6, 10
    x, w = _inputs(5, B * D, H, W, C, CO, dtype, kz=3)
    got = conv3x3(_to_torch(x, dtype), _to_torch(w, dtype), depth=D)
    ref = jax_conv3d(_to_jax(x, dtype).reshape(B, D, H, W, C),
                     _to_jax(w, dtype), None)
    np.testing.assert_allclose(
        got.float().numpy().reshape(B, D, H, W, CO),
        np.asarray(ref, np.float32), **TOL[dtype])


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
