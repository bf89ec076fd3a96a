"""The blocking of the tensor-core weight gradient
(csrc/conv3x3_wgrad_wgmma.cu: routes "wgmma" and "wgmma_tf32x3") on the CPU:
its plan (`kernels/conv3x3.py::wgrad_plan`) and a float64 model of what its
blocks compute, built from the kernels' own address arithmetic, held against
the plain version and the JAX package.

The kernels themselves need the card (tests/test_torch_cuda.py, marker
`cuda`; chip_smoke.py); these tests check what numpy can: which block sums
which (z-tap, tap, channel, output channel, positions), which halo row and
channel each fragment register reads, the layout of the f32 kernel's
transposed dy (written through the TMA swizzle and the transpose, read
through the wgmma descriptor), that those accesses meet no shared-memory
bank conflict, the z-first walk of the bf16 kernel, the order in which the
splits' partial sums are added, and the tf32 split.

Tolerance: the model sums in float64 and adds the splits in f32, the plain
version and JAX sum in f32: max |diff| <= 1e-5 of the largest |dW|.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.models.unet import _conv as jax_conv3d
from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_wgrad_reference,
                                              tf32_split, wgrad_kernel,
                                              wgrad_plan)

RTOL = 1e-5
SMS = 132
TH, TW = 4, 16           # positions of a stage
HH, HW = TH + 2, TW + 2  # the halo box
# the kernels' halo rows in channels (32 and padding)
ROW_C = {"tf32x3": 36, "bf16_zfirst": 40}


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f32_ci(g):
    """The kernel's `f32_ci`: the channel of fragment row g of a warp's 16
    (row g + 8 is the next)."""
    return 2 * (g & 1) + 4 * (g >> 2) + 16 * ((g >> 1) & 1)


# ---- the fragments' addresses ---------------------------------------------

def tf32x3_a_map():
    """{(tile, row, k): (halo row, channel)} of `wgrad_tf32x3_kernel`'s A
    fragments, from its addresses: warpgroup wg = tile, warp w, lane (g,
    t4) loads 8 bytes at abase + koff (rows g, g + 8, column t4) and at 4
    halo rows further (column t4 + 4), abase = ((ky * 18 + kx + t4) * 144
    + channel * 4, koff = ((k / 2) * 18 + 8 (k % 2)) * 144; a padding
    tap's registers stay zero (absent from the map).  Also {(tile, row):
    (tap, channel)} as its epilogue stores them."""
    a, store = {}, {}
    row_bytes = ROW_C["tf32x3"] * 4
    for wg in range(5):
        for w in range(4):
            tap = 2 * wg + w // 2
            for lane in range(32):
                g, t4 = divmod(lane, 4)
                c = 8 * (w % 2) + f32_ci(g)
                store[(wg, 16 * w + g)] = (tap, c)
                store[(wg, 16 * w + g + 8)] = (tap, c + 1)
                if tap >= 9:
                    continue
                abase = ((tap // 3) * HW + tap % 3 + t4) * row_bytes + c * 4
                for k in range(8):
                    koff = ((k // 2) * HW + 8 * (k % 2)) * row_bytes
                    for q, (r, col) in enumerate(
                            [(g, t4), (g + 8, t4), (g, t4 + 4),
                             (g + 8, t4 + 4)]):
                        off = abase + koff + (4 * row_bytes if q >= 2 else 0) \
                            + 4 * (q % 2)
                        a[(wg, 16 * w + r, 8 * k + col)] = divmod(
                            off, row_bytes)
    return {key: (hr, c // 4) for key, (hr, c) in a.items()}, store


def zfirst_a_map(KZ=3):
    """{(tile, row, position): (halo row, channel)} and {(tile, row): (tap
    T of the KZ x 9, channel)} of `wgrad_bf16_zfirst_kernel`: warpgroup
    wg, tile i (M tile 2 wg + i), warp w (tap T = 2 (2 wg + i) + w / 2);
    lane l of ldmatrix.x4.trans addresses row l % 8 of matrix m = l / 8 at
    ((ky * 18 + kx + 8 (m / 2) + l % 8) * 80 + (16 (w % 2) + 8 (m % 2)) *
    2, plus k * 18 * 80 at k16 step k; the .trans delivers element (row
    2 t + e, column g) of each matrix to lane (g, t), register m = the
    fragment's a[m] (rows g (+ 8 for m odd), columns 2 t + e (+ 8 for m >=
    2))."""
    row_bytes = ROW_C["bf16_zfirst"] * 2
    a, store = {}, {}
    for wg in range(7):
        for i in range(2):
            tile = 2 * wg + i
            for w in range(4):
                T = 2 * tile + w // 2
                for g in range(8):
                    for r in range(2):
                        store[(tile, 16 * w + g + 8 * r)] = (
                            T, 16 * (w % 2) + g + 8 * r)
                if T >= 9 * KZ:
                    continue
                tap = T % 9
                for m in range(4):
                    for row in range(8):  # the lane 8 m + row's address
                        addr = ((tap // 3) * HW + tap % 3 + 8 * (m // 2)
                                + row) * row_bytes \
                            + (16 * (w % 2) + 8 * (m % 2)) * 2
                        for k in range(4):
                            for g in range(8):  # column g of the matrix
                                hr, cb = divmod(addr + k * HW * row_bytes
                                                + 2 * g, row_bytes)
                                a[(tile, 16 * w + 8 * (m % 2) + g,
                                   16 * k + 8 * (m // 2) + row)] = (hr,
                                                                    cb // 2)
    return a, store


def _dense(amap, tiles):
    """The map as index arrays (tiles, 64 rows, 64 positions): halo row,
    channel and a mask (False: a zero register)."""
    hr = np.zeros((tiles, 64, 64), int)
    ch = np.zeros((tiles, 64, 64), int)
    ok = np.zeros((tiles, 64, 64), bool)
    for (t, r, p), (h, c) in amap.items():
        hr[t, r, p], ch[t, r, p], ok[t, r, p] = h, c, True
    return hr, ch, ok


# ---- the f32 kernel's dy layouts ------------------------------------------

def swz128(off):
    """TMA's 128-byte swizzle within a 1024-byte aligned buffer: 16-byte
    chunk ^= row % 8 (128-byte rows)."""
    return off ^ (((off >> 7) & 7) << 4)


def swz32(off):
    """The 32-byte swizzle (16-byte chunk ^= bit 7)."""
    return off ^ (((off >> 7) & 1) << 4)


def dyt_from_raw(bn):
    """Where the f32 kernel's B element (k8 step k, column kk, output
    channel n) comes from: dy box position p and channel co, found by
    writing every element's id through TMA's 128-byte swizzle (boxes of 32
    channels, 128-byte rows), reading it back with the transpose's address
    arithmetic (lane j8, c4 of unit (k, cg)) into the K-major buffer
    (`swz32` of k * bn * 32 + co * 32 + j8 * 4), and reading that buffer
    through the wgmma descriptor's K-major 32-byte-swizzled view (row n =
    32 bytes of k8 step k, 4 bytes a column).  Returns (bn, 8, 8, 2): [n,
    k, kk] -> (p, co)."""
    raw = np.full((bn // 32) * 64 * 32, -1)
    for co in range(bn):
        for p in range(64):
            j, c = divmod(co, 32)
            off = j * 8192 + swz128(p * 128 + c * 4)
            raw[off // 4] = p * bn + co
    dyt = np.full(8 * bn * 8, -1)
    for k in range(8):
        for cg in range(bn // 4):
            for lane in range(32):
                j8, c4 = lane % 8, lane // 8
                p, co = 8 * k + j8, 4 * cg + c4
                src = (cg // 8) * 8192 + p * 128 + (((cg % 8) ^ j8) << 4) \
                    + c4 * 4
                dst = swz32(k * (bn * 32) + co * 32 + j8 * 4)
                dyt[dst // 4] = raw[src // 4]
    out = np.zeros((bn, 8, 8, 2), int)
    for n in range(bn):
        for k in range(8):
            for kk in range(8):
                v = dyt[(k * bn * 32 + swz32(n * 32 + kk * 4)) // 4]
                out[n, k, kk] = divmod(v, bn)
    return out


# ---- the model -------------------------------------------------------------

def _halo(xp, plane, h0, w0, c0, nc):
    """The halo box of a stage, zero-filled past every edge (xp: x padded
    by one position before and enough after, and in channels)."""
    return xp[plane, h0:h0 + HH, w0:w0 + HW, c0:c0 + nc].reshape(-1, nc)


def model_wgrad(x, dy, depth, kz, dtype):
    """dW as the blocks of csrc/conv3x3_wgrad_wgmma.cu compute it, in
    float64, each block's partial sums stored in f32 and the splits added
    in their order in f32.  x (N, H, W, C), dy (N, H, W, CO).  The f32 and
    z-first bf16 kernels gather A through their fragment addresses; the
    descriptor kernel (bf16, C > 32) reads A as the halo at each tap's
    shift."""
    N, H, W, C = x.shape
    CO = dy.shape[-1]
    p = wgrad_plan(N, H, W, C, CO, dtype, kz)
    kern, ci, co, splits = p["kernel"], p["ci"], p["co"], p["splits"]
    tiles_h, tiles_w = -(-H // TH), -(-W // TW)
    tpp = tiles_h * tiles_w
    n_tiles = N * tpp
    assert p["tiles"] == n_tiles
    per = -(-n_tiles // splits)
    ci_tiles, co_tiles = -(-C // ci), -(-CO // co)
    box_c = {"tf32x3_n32": 36, "tf32x3_n64": 36, "bf16_zfirst": 40,
             "bf16_desc_n32": 64, "bf16_desc_n64": 64}[kern]
    xp = np.zeros((N + 2, H + HH + 1, W + HW + 1, ci_tiles * ci + box_c))
    xp[1:N + 1, 1:H + 1, 1:W + 1, :C] = x
    dyp = np.zeros((N, H + TH, W + TW, co_tiles * co))
    dyp[:, :H, :W, :CO] = dy
    half = kz // 2
    parts = np.zeros((splits, kz, 9, C, CO), np.float32)

    def store(split, z, tap, c, c0, acc_row):
        if c < C:
            n = min(co, CO - c0)
            parts[split, z, tap, c, c0:c0 + n] = acc_row[:n]

    if kern.startswith("tf32x3"):
        amap, rows = tf32x3_a_map()
        hr, ch, ok = _dense(amap, 5)
        bmap = dyt_from_raw(co)  # [n, k, kk] -> (p, channel of the box)
        b_p = bmap[..., 0].transpose(1, 2, 0).reshape(64, co)
        b_c = bmap[..., 1].transpose(1, 2, 0).reshape(64, co)
        assert kern.endswith(str(co))
        items = kz * ci_tiles * co_tiles
        for b in range(splits * items):
            split, item = divmod(b, items)
            cot, item = item % co_tiles, item // co_tiles
            cit, z = item % ci_tiles, item // ci_tiles
            acc = np.zeros((5, 64, co))
            for t in range(split * per, min(n_tiles, split * per + per)):
                n, tt = divmod(t, tpp)
                if not 0 <= n % depth + z - half < depth:
                    continue
                h0, w0 = (tt // tiles_w) * TH, (tt % tiles_w) * TW
                halo = _halo(xp, n + z - half + 1, h0, w0, cit * ci, box_c)
                a = np.where(ok, halo[hr, ch], 0.0)
                box = dyp[n, h0:h0 + TH, w0:w0 + TW,
                          cot * co:(cot + 1) * co].reshape(64, co)
                acc += a @ box[b_p, b_c]
            for (tile, r), (tap, c) in rows.items():
                if tap < 9:
                    store(split, z, tap, cit * ci + c, cot * co,
                          acc[tile, r])
    elif kern == "bf16_zfirst":
        amap, rows = zfirst_a_map(kz)
        hr, ch, ok = _dense(amap, 14)
        items = ci_tiles * co_tiles
        for b in range(splits * items):
            split, item = divmod(b, items)
            cot, cit = item % co_tiles, item // co_tiles
            acc = np.zeros((14, 64, co))
            # steps l = tile * N + plane: planes fastest
            for l in range(split * per, min(n_tiles, split * per + per)):
                tt, n = divmod(l, N)
                h0, w0 = (tt // tiles_w) * TH, (tt % tiles_w) * TW
                box = dyp[n, h0:h0 + TH, w0:w0 + TW,
                          cot * co:(cot + 1) * co].reshape(64, co)
                for t in range(14):
                    for half_rows in (0, 32):  # warps 0-1, 2-3: one tap
                        T = rows[(t, half_rows)][0]
                        if T >= 9 * kz:
                            continue
                        z = T // 9
                        if not 0 <= n % depth + z - half < depth:
                            continue
                        halo = _halo(xp, n + z - half + 1, h0, w0, cit * ci,
                                     box_c)
                        sl = slice(half_rows, half_rows + 32)
                        a = np.where(ok[t, sl], halo[hr[t, sl], ch[t, sl]],
                                     0.0)
                        acc[t, sl] += a @ box
            for (tile, r), (T, c) in rows.items():
                if T < 9 * kz:
                    store(split, T // 9, T % 9, cit * ci + c, cot * co,
                          acc[tile, r])
    else:  # bf16_desc_n32, bf16_desc_n64
        items = kz * ci_tiles * co_tiles
        for b in range(splits * items):
            split, item = divmod(b, items)
            cot, item = item % co_tiles, item // co_tiles
            cit, z = item % ci_tiles, item // ci_tiles
            acc = np.zeros((9, ci, co))
            for t in range(split * per, min(n_tiles, split * per + per)):
                n, tt = divmod(t, tpp)
                if not 0 <= n % depth + z - half < depth:
                    continue
                h0, w0 = (tt // tiles_w) * TH, (tt % tiles_w) * TW
                halo = _halo(xp, n + z - half + 1, h0, w0, cit * ci, ci)
                box = dyp[n, h0:h0 + TH, w0:w0 + TW,
                          cot * co:(cot + 1) * co].reshape(64, co)
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    # 16 positions of tile row r read halo rows (r + ky)
                    # * 18 + kx on
                    rows_ = np.concatenate([np.arange(16) + (r + ky) * HW
                                            + kx for r in range(TH)])
                    acc[tap] += halo[rows_].T @ box
            for tap in range(9):
                for c in range(ci):
                    store(split, z, tap, cit * ci + c, cot * co,
                          acc[tap, c])
    tot = parts[0]
    for part in parts[1:]:
        tot = tot + part  # f32, in split order (sum_splits_kernel)
    return tot.reshape(kz, 3, 3, C, CO)


# (N, depth, H, W, C, CO, kz), each over several splits: ragged planes and
# column tiles, the first and last plane of each volume skipping a z-tap,
# depth 1, one z-tap of weights, 64 output channels (the 64-column f32
# kernel), C > 32 (the bf16 descriptor kernel)
MODEL_CASES = {
    "ragged_19x37_c16": (4, 2, 19, 37, 16, 40, 3),
    "planes_7x8_c32": (18, 3, 7, 8, 32, 24, 3),
    "depth1_c32": (9, 1, 9, 21, 32, 32, 3),
    "one_z_tap_c48": (12, 2, 11, 13, 48, 24, 1),
    "c32_co64": (8, 2, 12, 20, 32, 64, 3),
    "c64_co64": (8, 4, 16, 16, 64, 64, 3),
}


@pytest.fixture(scope="module")
def jax_wgrad():
    """dW of `dg_tta_tpu.models.unet._conv` by `jax.vjp`, under `jax.jit`."""

    @jax.jit
    def f(x5, w, dy5):
        _, vjp = jax.vjp(lambda w_: jax_conv3d(x5, w_, None), w)
        return vjp(dy5)[0]

    return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_blocking_model_matches_plain_and_jax(case, dtype, jax_wgrad):
    """The kernels' blocking in float64 (their plan's splits and items,
    halo boxes with zero fill, fragment addresses, the transposed dy, the
    z-first walk, partial sums added in split order) equals
    `conv3x3_wgrad_reference` and `jax.vjp` of the JAX U-Net's `_conv`
    (its centre z-tap for one)."""
    N, D, H, W, C, CO, kz = MODEL_CASES[case]
    rng = np.random.default_rng(sorted(MODEL_CASES).index(case) + 60)
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    dy = rng.normal(size=(N, H, W, CO)).astype(np.float32)
    p = wgrad_plan(N, H, W, C, CO, dtype, kz)
    assert p["splits"] > 1
    got = model_wgrad(x.astype(np.float64), dy.astype(np.float64), D, kz,
                      dtype)
    ref = conv3x3_wgrad_reference(torch.from_numpy(x), torch.from_numpy(dy),
                                  depth=D, kz=kz).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)
    w = np.zeros((3, 3, 3, C, CO), np.float32)
    jw = np.asarray(jax_wgrad(jnp.asarray(x).reshape(N // D, D, H, W, C),
                              jnp.asarray(w),
                              jnp.asarray(dy).reshape(N // D, D, H, W, CO)))
    if kz == 1:
        jw = jw[1:2]
    np.testing.assert_allclose(got, jw, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("kern,kz", [("tf32x3", 3), ("bf16_zfirst", 3),
                                     ("bf16_zfirst", 1)])
def test_rows_read_the_channels_they_store(kern, kz):
    """Every M row's fragment registers read, at every position, the halo
    channel of the (tap, channel) its epilogue stores the row as, from the
    halo row of its tap's shift; the live rows cover each (tap, channel)
    once, the rest are the padding tap."""
    if kern == "tf32x3":
        amap, rows = tf32x3_a_map()
        taps = 9
    else:
        amap, rows = zfirst_a_map(kz)
        taps = 9 * kz
    seen = set()
    for (tile, r), (T, c) in rows.items():
        if T >= taps:
            assert not any((tile, r, p) in amap for p in range(64))
            continue
        assert (T, c) not in seen
        seen.add((T, c))
        tap = T % 9
        for p in range(64):
            h, w = divmod(p, TW)
            assert amap[(tile, r, p)] == ((h + tap // 3) * HW + w + tap % 3,
                                          c)
    assert seen == {(T, c) for T in range(taps) for c in range(32)}


@pytest.mark.parametrize("bn", [32, 64])
def test_f32_dy_layout_round_trips(bn):
    """The f32 kernel's B: dy written by TMA with the 128-byte swizzle,
    moved by the transpose, read back through the K-major descriptor view:
    element (k8 step k, column kk, channel n) is dy at position 8 k + kk,
    channel n; every element once."""
    out = dyt_from_raw(bn)
    k, kk = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    for n in range(bn):
        assert np.array_equal(out[n, :, :, 0], 8 * k + kk)
        assert (out[n, :, :, 1] == n).all()


def _banks(byte_offsets):
    return [(o // 4) % 32 for o in byte_offsets]


def test_f32_accesses_meet_no_bank_conflict():
    """The f32 kernel's shared-memory accesses, per warp instruction: the
    fragment loads (8 bytes a lane, two phases of 16 lanes) and the
    transpose's 4-byte read of the swizzled dy box and write of the
    K-major buffer each touch every bank at most once a phase."""
    row_bytes = ROW_C["tf32x3"] * 4
    for tap in range(9):
        for w in range(4):
            for k in range(8):
                for q in range(2):
                    offs = []
                    for lane in range(32):
                        g, t4 = divmod(lane, 4)
                        c = 8 * (w % 2) + f32_ci(g)
                        off = ((tap // 3) * HW + tap % 3 + t4) * row_bytes \
                            + c * 4 + ((k // 2) * HW + 8 * (k % 2)
                                       + 4 * q) * row_bytes
                        offs.append(off)
                    for half in (offs[:16], offs[16:]):
                        banks = _banks(half) + _banks([o + 4 for o in half])
                        assert len(set(banks)) == 32
    for bn in (32, 64):
        for k in range(8):
            for cg in range(bn // 4):
                reads, writes = [], []
                for lane in range(32):
                    j8, c4 = lane % 8, lane // 8
                    p, co = 8 * k + j8, 4 * cg + c4
                    reads.append((cg // 8) * 8192 + p * 128
                                 + (((cg % 8) ^ j8) << 4) + c4 * 4)
                    writes.append(swz32(k * (bn * 32) + co * 32 + j8 * 4))
                assert len(set(_banks(reads))) == 32
                assert len(set(_banks(writes))) == 32


def test_bf16_ldmatrix_rows_meet_no_bank_conflict():
    """ldmatrix reads each 8 x 16-byte matrix in one phase: the eight row
    addresses of every matrix, at every tap and k16 step, fall in eight
    distinct 16-byte bank groups of the 80-byte halo rows."""
    row_bytes = ROW_C["bf16_zfirst"] * 2
    for tap in range(9):
        for w in range(4):
            for m in range(4):
                for k in range(4):
                    groups = {((((tap // 3) * HW + tap % 3 + 8 * (m // 2)
                                 + r + k * HW) * row_bytes
                                + (16 * (w % 2) + 8 * (m % 2)) * 2) // 16)
                              % 8 for r in range(8)}
                    assert len(groups) == 8


def _round_tf32(a):
    """`hopper.cuh::round_tf32`: (bits + 0x1000) & ~0x1FFF."""
    bits = a.astype(np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def test_round_tf32_split_with_truncated_lo():
    """The kernels split x and dy as hi = round_tf32(v), lo = v - hi (f32,
    exact), and the tensor core truncates lo to tf32: hi equals
    `tf32_split`'s, hi + lo == v, |lo| <= 2^-11 |v|; a block's 3xTF32 sum
    (lo_a hi_b + hi_a lo_b + hi_a hi_b over 2048 positions, exact adds)
    lies within 1e-6 of the exact dot product's scale, where TF32 alone
    misses 1e-4."""
    rng = np.random.default_rng(16)
    v = (rng.normal(size=4096) * 10.0 ** rng.uniform(-4, 3, size=4096)) \
        .astype(np.float32)
    hi = _round_tf32(v)
    assert np.array_equal(hi, tf32_split(torch.from_numpy(v))[0].numpy())
    lo = v - hi
    assert np.array_equal(hi.astype(np.float64) + lo, v.astype(np.float64))
    assert (np.abs(lo) <= np.abs(v) * 2.0 ** -11).all()

    def trunc(a):
        return (a.astype(np.float32).view(np.int32) & -0x2000) \
            .view(np.float32).astype(np.float64)

    a = rng.normal(size=(64, 2048)).astype(np.float32)
    b = rng.normal(size=2048).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ah, bh = _round_tf32(a).astype(np.float64), _round_tf32(b).astype(
        np.float64)
    al, bl = trunc(a - _round_tf32(a)), trunc(b - _round_tf32(b))
    got = al @ bh + ah @ bl + ah @ bh
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1e-6 * scale
    assert np.abs(ah @ bh - exact).max() > 1e-4 * scale


def test_zfirst_walk_stages_each_plane_once_a_run():
    """The z-first kernel's halo ring, as its producer loads and its
    consumers give back: a run (a split's steps of one tile) loads its
    first step's KZ planes and then one plane a step; each step reads the
    KZ planes n - 1 .. n + 1 from the slots the consumers track; the halos
    go back in the order they were loaded, and a restart holds at most 2 x
    KZ of them (the ring's 7 slots suffice)."""
    for N, tiles, splits, KZ in ((10, 3, 4, 3), (7, 2, 3, 3), (5, 2, 3, 1)):
        n_steps = N * tiles
        per = -(-n_steps // splits)
        for split in range(splits):
            loads, live, released = [], [], []
            hz = [0, 0, 0]
            hc = 0
            l0, l1 = split * per, min(n_steps, split * per + per)
            for l in range(l0, l1):
                tile, n = divmod(l, N)
                restart = l == l0 or n == 0
                rel = list(hz[:KZ]) if restart and l > l0 else \
                    ([] if restart else [hz[0]])
                if restart:
                    for j in range(KZ):
                        loads.append((tile, n - KZ // 2 + j))
                        hz[j] = hc
                        hc += 1
                else:
                    hz[0], hz[1] = hz[1], hz[2]
                    hz[KZ - 1] = hc
                    loads.append((tile, n + KZ // 2))
                    hc += 1
                live = [c for c in live if c not in rel] + \
                    [c for c in hz[:KZ] if c not in live]
                assert len(live) <= KZ and len(rel) + len(live) <= 2 * KZ
                released += rel
                for j in range(KZ):
                    assert loads[hz[j]] == (tile, n - KZ // 2 + j)
            assert released == sorted(released)
            assert len(set(loads)) == len(loads)


def _main_path_shapes():
    """(dtype name, N, depth, H, W, C, CO) of every weight gradient the
    main path runs on these kernels: a trained step's (2 x depth planes)
    and the grouped runs'."""
    cs = _chip_smoke()
    out = set()
    for name in ("float32", "bfloat16"):
        groups = [1] + [g for n, g in cs.GROUPED_RUNS if n == name]
        for depth, H, W, C, CO, _ in cs.TS104_CONV_SHAPES:
            if C == 1:
                continue
            for g in groups:
                out.add((name, 2 * g * depth, depth, H, W, C, CO))
    return sorted(out)


@pytest.mark.parametrize("shape", _main_path_shapes())
def test_wgrad_plan_fills_the_card_or_says_why(shape):
    """Every main-path launch runs at least one block per SM, or its plan
    says why not; its blocks are splits x items; each split sums 16 tiles
    to its kernel's most, and no split is empty; the splits fill their
    waves as well as any other count of non-empty splits."""
    name, N, depth, H, W, C, CO = shape
    dtype = getattr(torch, name)
    p = wgrad_plan(N, H, W, C, CO, dtype)
    assert p["kernel"] == wgrad_kernel(C, CO, dtype)
    assert p["blocks"] == p["splits"] * p["items"]
    assert (p["blocks"] >= SMS) == (p["reason"] is None)
    per = -(-p["tiles"] // p["splits"])
    assert (p["splits"] - 1) * per < p["tiles"]
    most = {"tf32x3_n32": 2048, "tf32x3_n64": 32, "bf16_zfirst": 2048,
            "bf16_desc_n32": 288, "bf16_desc_n64": 288}[p["kernel"]]
    assert per <= most and (per >= 16 or p["splits"] * 16 > p["tiles"])
    assert p["longest"] == per * TH * TW

    def rate(s):
        return s / -(-s * p["items"] // SMS)

    tiles = p["tiles"]
    counts = {-(-tiles // -(-tiles // s))  # the same tiles, none empty
              for s in range(-(-tiles // most), tiles // 16 + 1)}
    assert all(rate(s) <= rate(p["splits"]) for s in counts)


@pytest.mark.parametrize("N,H,W,C,CO,dtype,kernel,splits,blocks", [
    # the top level of a trained step: one wave of 3 z-taps x 44 splits
    # (f32), of 132 z-first splits (bf16)
    (224, 112, 128, 32, 32, torch.float32, "tf32x3_n32", 44, 132),
    (224, 112, 128, 32, 32, torch.bfloat16, "bf16_zfirst", 132, 132),
    # 64 -> 32: bf16 on the descriptor kernel, sums of at most 288 tiles
    (224, 112, 128, 64, 32, torch.bfloat16, "bf16_desc_n32", 176, 528),
    # 56 x 64: f32 on 64 columns, splits of at most 32 tiles (26), 11
    # full waves
    (112, 56, 64, 64, 64, torch.float32, "tf32x3_n64", 242, 1452),
])
def test_wgrad_plan_splits(N, H, W, C, CO, dtype, kernel, splits, blocks):
    p = wgrad_plan(N, H, W, C, CO, dtype)
    assert (p["kernel"], p["splits"], p["blocks"]) == (kernel, splits,
                                                       blocks)


def test_split_sums_are_added_in_split_order():
    """The partial sums of a launch's splits add in the fixed order of
    `sum_splits_kernel` (split 0 first, f32): the model's result is that
    sum bit for bit, and another order differs in the last bits, which is
    why the order is fixed (a launch sums the same way every time)."""
    N, D, H, W, C, CO, kz = MODEL_CASES["ragged_19x37_c16"]
    rng = np.random.default_rng(7)
    parts = rng.normal(size=(5, 64)).astype(np.float32) * \
        10.0 ** rng.uniform(-3, 3, size=(5, 64)).astype(np.float32)
    fixed = parts[0]
    for part in parts[1:]:
        fixed = fixed + part
    backwards = parts[-1]
    for part in parts[-2::-1]:
        backwards = backwards + part
    assert fixed.dtype == np.float32
    assert not np.array_equal(fixed, backwards)
    x = rng.normal(size=(N, H, W, C))
    dy = rng.normal(size=(N, H, W, CO))
    a = model_wgrad(x, dy, D, kz, torch.float32)
    b = model_wgrad(x, dy, D, kz, torch.float32)
    assert np.array_equal(a, b)
