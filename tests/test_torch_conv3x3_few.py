"""The "few" route's kernels (csrc/conv3x3_few.cu: the MIND stem's conv,
1 < C < 16) on the CPU: their plan (`kernels/conv3x3.py::few_plan`), the
walk of each block over a run of plane steps with its ring of staged
planes, and float64 models of what the blocks compute, held against the
plain versions and the JAX package.

The kernels themselves need the card (tests/test_torch_cuda.py, marker
`cuda`); these tests check the part of the design that numpy can: which
block walks which steps (run of planes, tile, member), which plane sits
in which ring slot at each step (a volume's first and last planes, a run
that starts or crosses into the next tile mid-volume), that no copy
overwrites a plane a step still reads, the K order with its padded reads
and zero weight rows, the split of every staged value into tf32 hi
(`round_tf32`, the bits of `tf32_split`) and a remainder the tensor core
truncates, the order in which partial sums are added, and that the plan
tiles the planes as the kernels' source does.

Tolerances: the models sum in float64, the plain versions in f32: rtol
1e-5 / atol 1e-4 (tests/test_torch_conv3x3.py's), for the weight
gradient 1e-5 of its largest value (sums over every position); bf16
inputs are rounded to bf16 first, and the forward's bf16 output is
compared before its rounding to bf16.  The 3xTF32 products (hi and lo of
each value: the same bits whether a kernel splits it once, as the weight
gradient does, or at each load, as the forward does) keep the models
within 5e-6 of the exact f32 conv, well inside the card's KERNEL_RTOL of
5e-5.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.models.unet import _conv as jax_conv3d
from dg_tta_tpu.ops.conv2d_pallas import conv3x3_pallas
from dg_tta_tpu_torch.kernels import conv3x3 as cc
from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_reference,
                                              conv3x3_wgrad_reference,
                                              few_k, few_plan,
                                              pack_few_weights, tf32_split)

TOL = dict(rtol=1e-5, atol=1e-4)
WGRAD_TOL = 1e-5
# the kernels' source: their tiles, rings and the f32 weight gradient's
# steps between promotions (kPromote) are read from it
SRC = (Path(__file__).resolve().parents[1] / "dg_tta_tpu_torch" / "kernels"
       / "csrc" / "conv3x3_few.cu").read_text()


def _const(name):
    """The value of a `constexpr int` of the source (one of a list too)."""
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)[;,]", SRC)[1])


# the rings: the forwards' slots (the zb + kz - 1 planes a step reads, and
# the zb of the next step; f32 at C of 13-15 and three z-taps has no room
# for those, "fwd_f32_mid", and copies them from mid-step on), the bf16
# weight gradient's x planes, the f32 weight gradient's dy planes
BF16_WGRAD_RING, F32_WGRAD_DY = _const("kBgRing"), _const("kGDy")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def few_sms(monkeypatch):
    """Sets the SMs `few_plan` fills (few at a small shape: runs of
    several steps that cross tiles and volumes), its cache cleared."""
    def set_sms(n):
        monkeypatch.setattr(cc, "_FEW_SMS", n)
        few_plan.cache_clear()
    yield set_sms
    few_plan.cache_clear()


def _stem_launches():
    """(use, dtype, one member's planes, wgrad?) of every "few" launch of
    the main path at the MIND stem: a window's forward, a trained step's
    forward and weight gradient, at the grouped runs' batches too (a
    chunk of members plans each member's planes as a launch of its own)."""
    cs = _chip_smoke()
    depth = cs.STEM_SHAPE[0]
    out = []
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        out.append(("window forward", dt, depth, False))
        for g in [1] + [g for n, g in cs.GROUPED_RUNS if n == name]:
            out.append((f"step x{g} forward", dt, 2 * g * depth, False))
            out.append((f"step x{g} wgrad", dt, 2 * g * depth, True))
    return out


@pytest.mark.parametrize("use,dtype,N,wgrad", _stem_launches(),
                         ids=lambda v: str(v))
def test_plan_at_the_stem(use, dtype, N, wgrad):
    """At every stem launch one wave of blocks (a block on each of 132
    SMs) walks runs of equal length, none empty; the staged pixels
    per output pixel (or position) stay below 1.75, where the first design
    staged 3.8-5.1 (three planes a step); the forward runs two output
    planes a step, the weight gradients one."""
    cs = _chip_smoke()
    depth, H, W, C, CO = cs.STEM_SHAPE
    p = few_plan(N, depth, H, W, C, CO, dtype, wgrad=wgrad)
    th, tw = p["tile"]
    assert p["tiles"] == -(-H // th) * -(-W // tw)
    assert p["zb"] == (1 if wgrad else 2)
    assert p["steps"] == N // depth * -(-depth // p["zb"]) * p["tiles"]
    wave = cc._FEW_SMS
    assert p["rows"] == 1 and p["blocks"] <= wave
    assert p["run"] == -(-p["steps"] // wave)
    assert (p["blocks"] - 1) * p["run"] < p["steps"] <= p["blocks"] * p["run"]
    assert p["halo"] < 1.75
    # a member of a chunk plans from its own planes: the window's plan is
    # the same for one member and for each of three
    assert few_plan(N, depth, H, W, C, CO, dtype, wgrad=wgrad) is p


def test_plan_tiles_as_the_kernels_do():
    """`few_plan` walks the tiles, output planes a step and m64 tiles a
    block that the kernels' source is built with: a copy edited alone
    would walk another ring and wave than the kernels run."""
    assert cc._FEW_TILE == {
        (torch.bfloat16, False): (_const("kBfWG"), _const("kBfRow")),
        (torch.float32, False): (_const("kFH"), _const("kFW")),
        (torch.bfloat16, True): (_const("kBgH"), _const("kBgW")),
        (torch.float32, True): (_const("kGH"), _const("kGW"))}
    assert cc._FEW_ZB == _const("kZB")
    assert cc._FEW_M_TILES == _const("kGMT")


def _walks(plan, depth):
    """Per block, its steps as (vol, tile, d, fresh): the kernels' walk
    (s = (vol * tiles + tile) * ceil(depth / zb) + d / zb; a step is fresh
    where its block's run starts or its tile starts)."""
    zb, tiles, run = plan["zb"], plan["tiles"], plan["run"]
    dsteps = -(-depth // zb)
    out = []
    for b in range(plan["blocks"]):
        steps = []
        for s in range(b * run, min(plan["steps"], (b + 1) * run)):
            tv, j = divmod(s, dsteps)
            vol, tile = divmod(tv, tiles)
            steps.append((vol, tile, zb * j, s == b * run or j == 0))
        out.append(steps)
    return out


def _simulate_ring(plan, depth, kz, kind):
    """Runs the ring of every block as the kernel of `kind` fills it
    ("fwd_bf16", "fwd_f32", "fwd_f32_mid", "wgrad_bf16", "wgrad_f32") and
    checks each
    step: the planes it reads sit in their slots (plane p in slot (p + 1) %
    slots) and were staged for its own volume and tile; no copy lands in a
    slot whose plane a step or a running wgmma group still reads.  Returns
    {(vol, tile, plane): times staged} and the steps' output planes."""
    zb, lead = plan["zb"], kz // 2
    slots = {"fwd_bf16": 2 * zb + 2 * lead, "fwd_f32": 2 * zb + 2 * lead,
             "fwd_f32_mid": zb + 2 * lead, "wgrad_bf16": BF16_WGRAD_RING,
             "wgrad_f32": F32_WGRAD_DY}[kind]
    staged, outputs = {}, []
    for steps in _walks(plan, depth):
        ring = {}

        def stage(vol, tile, p, busy):
            slot = (p + 1) % slots
            assert ring.get(slot) not in busy, (kind, vol, tile, p, slot)
            ring[slot] = (vol, tile, p)
            staged[vol, tile, p] = staged.get((vol, tile, p), 0) + 1

        running = set()  # planes a wgmma group may still read
        for k, (vol, tile, d, fresh) in enumerate(steps):
            nxt = k + 1 < len(steps) and not steps[k + 1][3]
            if kind == "wgrad_f32":
                # dy planes d - lead .. d + lead; the step converts d + lead
                # while the last step's groups may still run
                need = range(d - lead, d + lead + 1)
                if fresh:
                    running = set()
                    for n in need:
                        stage(vol, tile, n, set())
                else:
                    stage(vol, tile, d + lead, running | {
                        (vol, tile, n) for n in need[:-1]})
            else:
                need = range(d - lead, d + zb + lead)
                if fresh:
                    running = set()
                    for p in need:
                        stage(vol, tile, p, set())
            reads = {(vol, tile, p) for p in need}
            for p in need:
                assert ring[(p + 1) % slots] == (vol, tile, p), (kind, p)
            new = range(d + zb + lead, d + 2 * zb + lead)
            if kind == "wgrad_f32":
                running = reads
            elif kind == "fwd_f32_mid":
                # copied once the first zb planes' fragments are loaded
                later = {(vol, tile, p) for p in need[zb:]}
                if nxt:
                    for p in new:
                        stage(vol, tile, p, later)
            else:
                # copied before this step's groups, while the last one runs
                if nxt:
                    for p in new:
                        stage(vol, tile, p, reads | running)
                running = reads if kind == "wgrad_bf16" else set()
            outputs += [(vol, tile, d + z) for z in range(zb)
                        if d + z < depth]
    return staged, outputs


@pytest.mark.parametrize("kind", ["fwd_bf16", "fwd_f32", "fwd_f32_mid",
                                  "wgrad_bf16", "wgrad_f32"])
@pytest.mark.parametrize("depth,sms,kz", [(5, 3, 3), (7, 2, 3), (1, 4, 3),
                                          (2, 5, 3), (6, 3, 1)])
def test_ring_walk(kind, depth, sms, kz, few_sms):
    """Every output plane of every tile is one step of one block; each
    block's ring holds, at each step, the planes it reads, staged for its
    own volume and tile (planes past a volume's ends are zeros, never the
    next volume's); no copy overwrites a plane still read.  A plane is
    staged once per walk through it, twice more where a run starts inside
    a tile (its edge planes)."""
    few_sms(sms)
    dtype = torch.bfloat16 if kind.endswith("bf16") else torch.float32
    wgrad = kind.startswith("wgrad")
    vols, H, W = 2, 9, 40
    C = 15 if kind == "fwd_f32_mid" else 12
    plan = few_plan(vols * depth, depth, H, W, C, 32, dtype, kz=kz,
                    wgrad=wgrad)
    staged, outputs = _simulate_ring(plan, depth, kz, kind)
    every = [(v, t, d) for v in range(vols) for t in range(plan["tiles"])
             for d in range(depth)]
    assert sorted(outputs) == every
    lead = kz // 2
    for (vol, tile, p), n in staged.items():
        assert -lead <= p < depth + plan["zb"] + lead
        assert n <= 1 + sum(
            1 for steps in _walks(plan, depth) for (v, t, d, fresh) in steps
            if fresh and (v, t) == (vol, tile))
    assert sum(staged.values()) == plan["staged"]


@pytest.mark.parametrize("kz", [3, 1])
def test_f32_forward_ring_depth(kz):
    """The f32 forward's ring (launch_forward_f32) gives the next step's
    planes slots of their own where the reads' and the next step's planes
    fit beside the split weights in the opt-in shared memory: at C <= 12
    (the stem) and at one z-tap ("fwd_f32" in test_ring_walk); at C of
    13-15 and three z-taps (16-channel pixels, K = 48 a row of taps) they
    do not, and that ring copies them mid-step ("fwd_f32_mid")."""
    zb, lead = _const("kZB"), kz // 2
    hr, hw = _const("kFH") + 2, _const("kFW") + 2
    for C in range(2, 16):
        cs, kp = few_k(C, kz, torch.float32)
        fixed = 1024 + 2 * (kp // 8) * 1024
        plane = (hr * hw * cs + 4) * 4
        own = fixed + (2 * zb + 2 * lead) * plane <= _const("kSmemMax")
        assert own == (C <= 12 or kz == 1), C
        assert fixed + (zb + 2 * lead) * plane <= _const("kSmemMax")


# ---- float64 models ---------------------------------------------------------


def _split(a):
    """f32 values a (float64 array) split as the kernels split them: hi =
    `round_tf32` (nearest, ties away; `tf32_split`'s bits), lo = a - hi
    as the tensor core reads it, truncated to tf32."""
    bits = a.astype(np.float32).view(np.int32)
    hi = ((bits + 0x1000) & -0x2000).view(np.float32).astype(np.float64)
    lo = (a - hi).astype(np.float32).view(np.int32)
    return hi, (lo & -0x2000).view(np.float32).astype(np.float64)


def _halo(x5, vol, p, h0, w0, hr, hw, cs):
    """The staged plane: x5[vol, p] (zeros where p is outside the volume),
    rows h0 - 1 .. + hr, pixels w0 - 1 .. + hw, cs channels (zeros past
    C and past the plane)."""
    _, D, H, W, C = x5.shape
    out = np.zeros((hr, hw, cs))
    if 0 <= p < D:
        hs, ws = max(h0 - 1, 0), max(w0 - 1, 0)
        he, we = min(h0 - 1 + hr, H), min(w0 - 1 + hw, W)
        out[hs - h0 + 1:he - h0 + 1, ws - w0 + 1:we - w0 + 1, :C] = \
            x5[vol, p, hs:he, ws:we]
    return out


def model_forward(x, w, depth, dtype):
    """y as csrc/conv3x3_few.cu's forward blocks compute it, in float64,
    before the cast to x's type.  Each block walks its run of steps
    (`few_plan`); a step computes zb output planes of a tile, one
    accumulator each, from the staged planes d - lead .. d + zb - 1 + lead:
    each plane's fragments serve every output plane it reaches (z-tap i -
    z).  f32: a (kz, ky) row of taps is the kr floats of the staged plane
    from the output pixel's row start (its last 4 the next pixel's first
    channels, against zero rows of `pack_few_weights`; 4 zeros past the
    plane's end), each value split (`_split`), three products per k8 step;
    bf16:
    one 16-channel pixel per tap."""
    N, H, W, C = x.shape
    kz, CO = w.shape[0], w.shape[-1]
    plan = few_plan(N, depth, H, W, C, CO, dtype, kz=kz)
    th, tw = plan["tile"]
    zb, lead = plan["zb"], kz // 2
    cs, kp = few_k(C, kz, dtype)
    kr = kp // (kz * 3)
    B = pack_few_weights(torch.from_numpy(w), dtype).double().numpy()
    x5 = x.reshape(N // depth, depth, H, W, C)
    hr, hw = th + 2, tw + 2
    pix = np.arange(th * tw)
    if dtype == torch.float32:
        base = ((pix // tw) * hw + pix % tw) * cs
        b_hi, b_lo = _split(B)
    y = np.zeros((N, H, W, CO))
    for steps in _walks(plan, depth):
        for vol, tile, d, _ in steps:
            h0, w0 = (tile // -(-W // tw)) * th, (tile % -(-W // tw)) * tw
            acc = np.zeros((zb, th * tw, CO))
            for i in range(zb + 2 * lead):
                plane = _halo(x5, vol, d - lead + i, h0, w0, hr, hw, cs)
                if dtype == torch.float32:
                    flat = np.concatenate([plane.reshape(-1), np.zeros(4)])
                    hi, lo = _split(flat)
                for ky in range(3):
                    for z in range(zb):
                        k = i - z
                        if not 0 <= k < kz:
                            continue
                        r = (k * 3 + ky) * kr
                        if dtype == torch.float32:
                            idx = base[:, None] + ky * hw * cs + np.arange(kr)
                            acc[z] += (lo[idx] @ b_hi[r:r + kr]
                                       + hi[idx] @ b_lo[r:r + kr]
                                       + hi[idx] @ b_hi[r:r + kr])
                        else:
                            for kx in range(3):
                                a = plane[pix // tw + ky, pix % tw + kx]
                                t = r + kx * 16
                                acc[z] += a @ B[t:t + cs]
            for z in range(zb):
                n = vol * depth + d + z
                if d + z >= depth:
                    continue
                hh, ww = h0 + pix // tw, w0 + pix % tw
                ok = (hh < H) & (ww < W)
                y[n, hh[ok], ww[ok]] = acc[z][ok]
    return y


def model_wgrad(x, dy, depth, dtype, kz=3):
    """dW as csrc/conv3x3_few.cu's weight-gradient blocks compute it, in
    float64.  Each block walks its run of steps; its partial sum is added
    to the others in block order.  f32: x plane d (split once, as three
    kx-shifted copies) meets dy planes d + lead - kz (split once), rows
    (ky, kx, ci) and 6 x 8 positions a step, each warpgroup half the
    step's rows, the halves' sums added at the end, each accumulator
    promoted into a second sum every kPromote steps; bf16: x plane d -
    lead + kz meets dy plane d, (kx, 16 channels) rows per ky, a k16 step
    per row of 16 positions."""
    N, H, W, C = x.shape
    CO = dy.shape[-1]
    plan = few_plan(N, depth, H, W, C, CO, dtype, kz=kz, wgrad=True)
    th, tw = plan["tile"]
    lead = kz // 2
    x5 = x.reshape(N // depth, depth, H, W, C)
    dy5 = dy.reshape(N // depth, depth, H, W, CO)
    tiles_w = -(-W // tw)
    promote = _const("kPromote")

    def dy_tile(vol, n, h0, w0):
        out = np.zeros((th, tw, CO))
        if 0 <= n < depth:
            t = dy5[vol, n, h0:h0 + th, w0:w0 + tw]
            out[:t.shape[0], :t.shape[1]] = t
        return out

    dw = np.zeros((kz, 3, 3, C, CO))
    for steps in _walks(plan, depth):
        tot = np.zeros((2, kz, 9 * C, CO)) if dtype == torch.float32 \
            else np.zeros((kz, 3, 3, C, CO))
        acc = np.zeros_like(tot)
        for k, (vol, tile, d, _) in enumerate(steps):
            h0, w0 = (tile // tiles_w) * th, (tile % tiles_w) * tw
            if dtype == torch.float32:
                halo = _halo(x5, vol, d, h0, w0, th + 2, tw + 2, C)
                # A[(ky, kx, ci)][(row, q)] = x[row + ky][q + kx][ci]
                a = np.stack([halo[ky:ky + th, kx:kx + tw]
                              for ky in range(3) for kx in range(3)])
                a = a.transpose(0, 3, 1, 2).reshape(9 * C, th, tw)
                a_hi, a_lo = _split(a)
                for z in range(kz):
                    d_hi, d_lo = _split(dy_tile(vol, d + lead - z, h0, w0))
                    for kh in range(2):
                        rows = slice(kh * th // 2, (kh + 1) * th // 2)
                        ah, al = (t[:, rows].reshape(9 * C, -1)
                                  for t in (a_hi, a_lo))
                        bh, bl = (t[rows].reshape(-1, CO)
                                  for t in (d_hi, d_lo))
                        acc[kh, z] += al @ bh + ah @ bl + ah @ bh
                if (k + 1) % promote == 0:
                    tot += acc
                    acc[:] = 0
            else:
                dyt = dy_tile(vol, d, h0, w0).reshape(-1, CO)
                for z in range(kz):
                    halo = _halo(x5, vol, d - lead + z, h0, w0, th + 2,
                                 tw + 2, C)
                    for ky in range(3):
                        for kx in range(3):
                            a = halo[ky:ky + th, kx:kx + tw].reshape(-1, C)
                            acc[z, ky, kx] += a.T @ dyt
        tot += acc
        if dtype == torch.float32:
            part = (tot[0] + tot[1]).reshape(kz, 3, 3, C, CO)
        else:
            part = tot
        dw += part
    return dw


def _inputs(seed, N, H, W, C, CO, kz, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(kz, 3, 3, C, CO)) * (2.0 / (27 * C)) ** 0.5) \
        .astype(np.float32)
    dy = rng.normal(size=(N, H, W, CO)).astype(np.float32)
    if dtype == torch.bfloat16:  # the values a bf16 launch sees
        x, w, dy = (torch.from_numpy(t).bfloat16().float().numpy()
                    for t in (x, w, dy))
    return x.astype(np.float64), w.astype(np.float64), dy.astype(np.float64)


# (N, depth, H, W, C, CO, kz, SMs): tiles ragged in H and W, C at its own
# width (2, 5 and the stem's 12), runs that start inside a tile
MODEL_CASES = {
    "c2": (6, 3, 7, 20, 2, 8, 3, 2),
    "c5_depth1": (3, 1, 5, 9, 5, 16, 3, 2),
    "c12": (8, 4, 9, 18, 12, 32, 3, 3),
    "c12_one_z_tap": (4, 2, 6, 17, 12, 8, 1, 2),
}


def _jax_conv(x, w, depth):
    N, H, W, C = x.shape
    if w.shape[0] == 1:
        return np.asarray(conv3x3_pallas(
            jnp.asarray(x, jnp.float32), jnp.asarray(w[0], jnp.float32),
            interpret=True, mode_name="pairs"), np.float64)
    fn = jax.jit(lambda a, b: jax_conv3d(a, b, None))
    y = fn(jnp.asarray(x.reshape(N // depth, depth, H, W, C), jnp.float32),
           jnp.asarray(w, jnp.float32))
    return np.asarray(y, np.float64).reshape(N, H, W, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_forward_model_matches_plain_and_jax(case, dtype, few_sms):
    """The float64 model of the forward's blocks equals `conv3x3_reference`
    and JAX's conv (`conv3x3_pallas` in interpret mode at one z-tap, the
    U-Net's `_conv` under `jax.jit` at three) within TOL."""
    N, depth, H, W, C, CO, kz, sms = MODEL_CASES[case]
    few_sms(sms)
    dt = getattr(torch, dtype)
    x, w, _ = _inputs(21, N, H, W, C, CO, kz, dt)
    got = model_forward(x, w, depth, dt)
    ref = conv3x3_reference(torch.from_numpy(x).float(),
                            torch.from_numpy(w).float(), depth).double()
    np.testing.assert_allclose(got, ref.numpy(), **TOL)
    np.testing.assert_allclose(got, _jax_conv(x, w, depth), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_wgrad_model_matches_plain_and_jax_vjp(case, dtype, few_sms):
    """The float64 model of the weight gradient's blocks equals
    `conv3x3_wgrad_reference` and the weight cotangent of `jax.vjp` of the
    JAX U-Net's `_conv` (under `jax.jit`; at one z-tap each plane a volume
    of its own) within WGRAD_TOL of its largest value."""
    N, depth, H, W, C, CO, kz, sms = MODEL_CASES[case]
    few_sms(sms)
    dt = getattr(torch, dtype)
    x, w, dy = _inputs(22, N, H, W, C, CO, kz, dt)
    got = model_wgrad(x, dy, depth, dt, kz=kz)
    ref = conv3x3_wgrad_reference(torch.from_numpy(x).float(),
                                  torch.from_numpy(dy).float(), depth,
                                  kz=kz).double().numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= WGRAD_TOL * scale
    # one z-tap: each plane its own volume
    vd = depth if kz == 3 else 1
    x5 = jnp.asarray(x.reshape(N // vd, vd, H, W, C), jnp.float32)
    _, vjp = jax.vjp(jax.jit(lambda v: jax_conv3d(x5, v, None)),
                     jnp.asarray(w, jnp.float32))
    (gw,) = vjp(jnp.asarray(dy.reshape(N // vd, vd, H, W, CO), jnp.float32))
    assert np.abs(got - np.asarray(gw, np.float64)).max() <= \
        WGRAD_TOL * scale


def test_split_once_is_tf32_split_and_meets_the_tolerance():
    """The split the kernels apply to each staged value (the weight
    gradient once as it lands, the forward at each load: the same bits)
    and weight (`round_tf32`, the remainder fed raw and truncated by the
    tensor core) has `tf32_split`'s hi bits; the three products of a stem-sized sum
    stay within 5e-6 of the exact one (KERNEL_RTOL 5e-5 on the card),
    where tf32 alone misses by over 1e-4."""
    rng = np.random.default_rng(23)
    a = (rng.normal(size=(64, 360)) * 10.0 ** rng.integers(
        -3, 3, size=(64, 1))).astype(np.float32).astype(np.float64)
    b = (rng.normal(size=(360, 32)) * 0.1).astype(np.float32) \
        .astype(np.float64)
    hi, lo = _split(a)
    th, tl = tf32_split(torch.from_numpy(a.astype(np.float32)))
    assert np.array_equal(hi, th.double().numpy())
    assert np.array_equal(a - hi, tl.double().numpy())
    b_hi, b_lo = _split(b)
    exact = a @ b
    scale = np.abs(exact).max(axis=1, keepdims=True)
    got = lo @ b_hi + hi @ b_lo + hi @ b_hi
    assert (np.abs(got - exact) <= 5e-6 * scale).all()
    assert (np.abs(hi @ b_hi - exact) > 1e-4 * scale).any()
