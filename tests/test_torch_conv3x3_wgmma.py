"""The blocking of the tensor-core conv3x3 forward (csrc/conv3x3_wgmma.cu,
routes "wgmma" and "wgmma_tf32x3") on the CPU: its plan
(`kernels/conv3x3.py::wgmma_plan`) and a float64 model of what its blocks
compute, held against the plain version and the JAX package.

The kernel itself needs the card (tests/test_torch_cuda.py, marker
`cuda`); these tests check the part of its design that numpy can: which
halo box a tile stages, at which shifts its nine taps read that box, which
run of (z-tap, channel chunk) stages each block of a cluster sums, and the
order in which rank 0 adds the blocks' partial sums.

Tolerance: the model sums in float64, the plain version and JAX in f32:
rtol 1e-5 / atol 1e-4, as tests/test_torch_conv3x3.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dg_tta_tpu.models.unet import _conv as jax_conv3d
from dg_tta_tpu.ops.conv2d_pallas import conv3x3_pallas
from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3_reference, wgmma_plan

TOL = dict(rtol=1e-5, atol=1e-4)
SMS = 132


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_path_shapes():
    """(dtype, N, depth, H, W, C, CO) of every wgmma-route conv3x3 launch
    of the main path: window and trained-step forwards and input
    gradients, and the grouped runs' steps."""
    cs = _chip_smoke()
    out = set()
    for name in ("float32", "bfloat16"):
        groups = [1] + [g for n, g in cs.GROUPED_RUNS if n == name]
        for depth, H, W, C, CO, _ in cs.TS104_CONV_SHAPES:
            if C == 1:
                continue
            out.add((name, depth, depth, H, W, C, CO))
            for g in groups:
                for c, co in ((C, CO), (CO, C)):
                    out.add((name, 2 * g * depth, depth, H, W, c, co))
    return sorted(out)


def _halo_rows(th, tw):
    """The halo row (pixel of the (th + 2) x (tw + 2) box) that output
    pixel p of a th x tw tile reads at tap (0, 0); tap (ky, kx) adds
    ky * (tw + 2) + kx."""
    p = np.arange(th * tw)
    return (p // tw) * (tw + 2) + p % tw


def model_conv(x, w, depth, dtype):
    """y as csrc/conv3x3_wgmma.cu's blocks compute it, in float64.

    x (N, H, W, C), w (kz, 3, 3, C, CO).  For every work item of
    `wgmma_plan` (plane n, tile, column tile) and every block (rank) of its
    cluster: the rank's run of the item's stages (z-taps inside the group
    of `depth` planes, chunk-major), each stage one zero-filled halo box
    x[n + dz, h0 - 1 : +TH + 2, w0 - 1 : +TW + 2, ci0 : +KC] and the nine
    taps read from it at their shifts; the ranks' partial sums added in
    rank order; rows past H and W and columns past CO dropped."""
    N, H, W, C = x.shape
    kz, CO = w.shape[0], w.shape[-1]
    plan = wgmma_plan(N, depth, H, W, C, CO, dtype, kz=kz)
    th, tw = plan["tile"]
    bn, kc, splits = plan["bn"], plan["kc"], plan["splits"]
    nch = C // kc
    tiles_h, tiles_w, co_tiles = -(-H // th), -(-W // tw), -(-CO // bn)
    assert plan["items"] == N * tiles_h * tiles_w * co_tiles
    # out-of-bounds reads give zeros, as TMA's fill; the weights' columns
    # past CO too
    xp = np.pad(x, ((0, 0), (1, th + 1), (1, tw + 1), (0, 0)))
    wp = np.pad(w, ((0, 0),) * 4 + ((0, co_tiles * bn - CO),))
    rows = _halo_rows(th, tw)
    y = np.zeros((N, H, W, CO))
    for item in range(plan["items"]):
        ct, r = item % co_tiles, item // co_tiles
        w0, r = (r % tiles_w) * tw, r // tiles_w
        h0, n = (r % tiles_h) * th, r // tiles_h
        co0 = ct * bn
        d = n % depth
        kz_lo = 1 if kz == 3 and d == 0 else 0
        kz_hi = 1 if kz == 3 and d == depth - 1 else kz - 1
        total = (kz_hi - kz_lo + 1) * nch
        parts = []
        for rank in range(splits):
            acc = np.zeros((th * tw, bn))
            for s in range(rank * total // splits,
                           (rank + 1) * total // splits):
                z, ch = kz_lo + s // nch, s % nch
                halo = xp[n + z - kz // 2, h0:h0 + th + 2, w0:w0 + tw + 2,
                          ch * kc:(ch + 1) * kc].reshape(-1, kc)
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    acc += halo[rows + ky * (tw + 2) + kx] @ \
                        wp[z, ky, kx, ch * kc:(ch + 1) * kc, co0:co0 + bn]
            parts.append(acc)
        tot = parts[0]
        for part in parts[1:]:
            tot = tot + part
        tile = tot.reshape(th, tw, bn)[:H - h0, :W - w0, :CO - co0]
        y[n, h0:h0 + th, w0:w0 + tw, co0:co0 + bn] = tile
    return y


# (N, depth, H, W, C, CO, kz): a 7 x 8 plane (the "small" layout, its items
# shared by clusters, the first and last planes of each group skipping a
# z-tap), a ragged plane with a ragged column tile, depth 1 (one z-tap
# inside), one z-tap of weights
MODEL_CASES = {
    "plane_7x8_c32": (6, 3, 7, 8, 32, 40, 3),
    "ragged_19x37_c16": (4, 2, 19, 37, 16, 40, 3),
    "depth1_c32": (3, 1, 9, 21, 32, 32, 3),
    "one_z_tap_c16": (4, 2, 11, 13, 16, 24, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_blocking_model_matches_plain_and_jax(case, dtype):
    """The kernel's blocking in float64 (halo boxes with zero fill, taps at
    shifts, clusters' partial sums in rank order) equals
    `conv3x3_reference` and JAX: the U-Net's `_conv` for three z-taps,
    `conv3x3_pallas` in interpret mode for one."""
    N, D, H, W, C, CO, kz = MODEL_CASES[case]
    rng = np.random.default_rng(sorted(MODEL_CASES).index(case) + 40)
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(kz, 3, 3, C, CO)) * 0.1).astype(np.float32)
    plan = wgmma_plan(N, D, H, W, C, CO, dtype, kz=kz)
    if case == "plane_7x8_c32":
        assert plan["layout"] == "small" and plan["splits"] > 1
    got = model_conv(x.astype(np.float64), w.astype(np.float64), D, dtype)
    w_in = w[0] if kz == 1 else w
    ref = conv3x3_reference(torch.from_numpy(x), torch.from_numpy(w_in),
                            depth=D).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    if kz == 1:
        jax_ref = conv3x3_pallas(jnp.asarray(x), jnp.asarray(w_in),
                                 interpret=True, mode_name="pairs")
    else:
        jax_ref = jax_conv3d(jnp.asarray(x).reshape(N // D, D, H, W, C),
                             jnp.asarray(w), None)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref, np.float64).reshape(N, H, W, CO), **TOL)


@pytest.mark.parametrize("shape", _main_path_shapes())
def test_wgmma_plan_fills_the_card_or_says_why(shape):
    """Every main-path launch runs at least one block per SM, or its plan
    says why not; a cluster never splits an item into runs without a
    stage, and its launch is one block per (item, rank).  A plane's
    blocking, and so the order of its sums, is that of a one-volume
    launch (a window's), which stays in about one wave: a grouped step
    sums each plane as the ungrouped step and the window do."""
    name, N, depth, H, W, C, CO = shape
    p = wgmma_plan(N, depth, H, W, C, CO, getattr(torch, name))
    assert p["layout"] == ("small" if H <= 8 and W <= 8 else "big")
    assert C % p["kc"] == 0 and 1 <= p["splits"] <= 4
    fewest = (C // p["kc"]) * (1 if depth == 1 else 2)
    assert p["splits"] <= fewest
    if p["splits"] > 1:
        assert p["blocks"] == p["items"] * p["splits"]
    else:
        assert p["blocks"] == min(p["items"], SMS)
    assert (p["blocks"] >= SMS) == (p["reason"] is None)
    one = wgmma_plan(depth, depth, H, W, C, CO, getattr(torch, name))
    keys = ("layout", "tile", "wn", "bn", "kc", "splits")
    assert [p[k] for k in keys] == [one[k] for k in keys]
    assert one["splits"] == 1 or one["blocks"] <= SMS * 3 // 2


@pytest.mark.parametrize("N,depth,H,W,C,CO,splits,blocks", [
    # the 7 x 8 level: a window's 35 items in one wave of 3-block clusters;
    # a step's 70 in 3-block clusters too
    (7, 7, 7, 8, 320, 320, 3, 105),
    (14, 7, 7, 8, 320, 320, 3, 210),
    # 14 x 16: a window's 56 items in one wave of pairs, a step's 112 in
    # pairs; 512 output channels, 112 items a window, alone
    (14, 14, 14, 16, 512, 256, 2, 112),
    (28, 14, 14, 16, 256, 256, 2, 224),
    (28, 14, 14, 16, 256, 512, 1, 132),
    # the top level: persistent blocks, one per SM
    (224, 112, 112, 128, 32, 32, 1, 132),
])
def test_wgmma_plan_splits(N, depth, H, W, C, CO, splits, blocks):
    for dtype in (torch.float32, torch.bfloat16):
        p = wgmma_plan(N, depth, H, W, C, CO, dtype)
        assert (p["splits"], p["blocks"]) == (splits, blocks)


@pytest.mark.parametrize("layout,H,W", [("big", 19, 37), ("small", 7, 8)])
def test_halo_covers_every_tap(layout, H, W):
    """Each tile's halo box (from row h0 - 1 and column w0 - 1) holds, at
    the row the kernel reads for tap (ky, kx), the input pixel (h + ky - 1,
    w + kx - 1) of every output (h, w) of the tile."""
    p = wgmma_plan(2, 1, H, W, 16, 32, torch.bfloat16)
    assert p["layout"] == layout
    th, tw = p["tile"]
    rows = _halo_rows(th, tw)
    for h0 in range(0, H, th):
        for w0 in range(0, W, tw):
            hh, ww = np.divmod(np.arange(th * tw), tw)
            for ky in range(3):
                for kx in range(3):
                    r = rows + ky * (tw + 2) + kx
                    assert (r >= 0).all() and (r < (th + 2) * (tw + 2)).all()
                    # the halo row's pixel, in input coordinates
                    ih = h0 - 1 + r // (tw + 2)
                    iw = w0 - 1 + r % (tw + 2)
                    assert np.array_equal(ih, h0 + hh + ky - 1)
                    assert np.array_equal(iw, w0 + ww + kx - 1)
