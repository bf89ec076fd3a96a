"""The catch-all conv route ("cuda_core": csrc/conv3x3.cu forward and input
gradient, csrc/conv3x3_wgrad.cu weight gradient) on the CPU, at ragged
channel counts: a plan with `UNet_base_num_features` 30 (widths 30, 60,
120, 240, 300) puts half of the network's stride-1 convs there.

* the plain version against `conv3x3_pallas` in interpret mode at ragged C
  and CO (tolerances of tests/test_torch_conv3x3.py: f32 1e-5 relative /
  1e-4 absolute, bf16 rtol 0.03 / atol 0.05);
* the host plans (`cuda_core_plan`, `cuda_core_wgrad_plan`) at every
  shape the ragged net gives the route, against the constants of the
  sources, and the weight pack (`pack_cuda_core_weights`);
* float64 models of the two kernels' block and stage loops (the packed
  weight blocks, the halo at nine shifts, the z-taps skipped at a volume's
  ends, each volume's runs of tiles and its partials summed in order)
  against the plain versions (1e-10 relative: float64 sums);
* a small PlainConvUNet at ragged widths (6, 10, 20), forward and
  gradient, against the JAX U-Net (f32 atol 2e-4 on the logits,
  tests/test_torch_unet.py's bound; gradients 1e-4 of each leaf's largest
  value), and its members side by side bit for bit its serial members.

The kernels themselves run only on the card: tests/test_torch_cuda.py -k
cuda_core and chip_smoke.py.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.models.unet import unet_apply
from dg_tta_tpu.ops.conv2d_pallas import conv3x3_pallas
from dg_tta_tpu_torch.kernels import conv3x3 as cc
from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_reference,
                                              conv3x3_route, conv3x3_wgrad,
                                              conv3x3_wgrad_reference,
                                              conv3x3_wgrad_route,
                                              cuda_core_plan,
                                              cuda_core_wgrad_plan,
                                              pack_cuda_core_weights)
from dg_tta_tpu_torch.models.convert import params_from_jax, params_to_jax
from dg_tta_tpu_torch.models.plans import ArchSpec
from dg_tta_tpu_torch.models.unet import (PlainConvUNet, init_unet_,
                                          stack_members)

CSRC = Path(cc.__file__).resolve().parent / "csrc"
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=0.03, atol=0.05)}
# the ragged net's stride-1 convs on this route, (depth, H, W, C, CO) at
# the TS104 patch: 30 -> 30 and 60 -> 30 at the top level, 60 -> 60 and
# 120 -> 60 at 56 x 64, 300 -> 300 at 7 x 8; and the input gradients
# there (30 -> 60 for 60 -> 30)
RAGGED_NET_SHAPES = [
    (112, 112, 128, 30, 30), (112, 112, 128, 60, 30),
    (112, 112, 128, 30, 60), (56, 56, 64, 60, 60), (56, 56, 64, 120, 60),
    (7, 7, 8, 300, 300)]
SMEM_LIMIT = 232448  # bytes a block may use on an H100
SM_SMEM = 233472  # bytes of an SM (a block also takes 1 KB of its own)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kz", [1, 3])
@pytest.mark.parametrize("C,CO", [(5, 1), (5, 6), (5, 30), (30, 1), (30, 6),
                                  (30, 30)])
def test_plain_matches_pallas_at_ragged_channels(dtype, kz, C, CO):
    """The plain version (what a CPU tensor runs) against the Pallas kernel
    in interpret mode, z-tap by z-tap as the JAX U-Net sums them."""
    rng = np.random.default_rng(C * 100 + CO + kz)
    B, D, H, W = 2, 3, 9, 11
    x = rng.normal(size=(B * D, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(kz, 3, 3, C, CO)) * 0.1).astype(np.float32)
    got = conv3x3(torch.from_numpy(x).to(getattr(torch, dtype)),
                  torch.from_numpy(w).to(getattr(torch, dtype)), depth=D)
    jd = getattr(jnp, dtype)
    xj = jnp.asarray(x, jd).reshape(B, D, H, W, C)
    ref = 0.0
    for z in range(kz):
        dz = z - kz // 2
        shifted = jnp.zeros_like(xj)
        lo, hi = max(0, -dz), min(D, D - dz)
        shifted = shifted.at[:, lo:hi].set(xj[:, lo + dz:hi + dz])
        part = conv3x3_pallas(shifted.reshape(B * D, H, W, C),
                              jnp.asarray(w[z], jd), interpret=True,
                              mode_name="pairs")
        ref = ref + np.asarray(part, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,CO,dgrad_route", [
    (30, 30, "cuda_core"), (60, 60, "cuda_core"), (300, 300, "cuda_core"),
    (120, 60, None), (60, 30, "cuda_core"), (12, 30, None)])
def test_ragged_net_routes(dtype, C, CO, dgrad_route):
    """Every ragged width takes the catch-all; the input gradient of 120 ->
    60 (60 -> 120) and of the GIN_MIND stem 12 -> 30 (30 -> 12) go where
    their own shapes send them."""
    wgmma = "wgmma" if dtype == torch.bfloat16 else "wgmma_tf32x3"
    assert conv3x3_route(C, CO, dtype) == "cuda_core"
    assert conv3x3_wgrad_route(C, CO, dtype) == "cuda_core"
    expect = dgrad_route or {(120, 60): wgmma,
                             (12, 30): "cuda_core"}[C, CO]
    assert conv3x3_route(CO, C, dtype) == expect


def _source_int(name, pattern):
    m = re.search(pattern, (CSRC / name).read_text())
    assert m, (name, pattern)
    return [int(g) for g in m.groups()]


def _ring(dtype):
    """The sources' ring stages and row pitches (bytes) per type: the
    forward's (kStages, kPitch), the weight gradient's (kStages, kPitch)."""
    name = "bf16" if dtype == torch.bfloat16 else "float"
    fwd = _source_int("conv3x3.cu", r"Cfg<%s> \{\s*static constexpr int "
                      r"kKC = \d+, kStages = (\d+)" % name)
    return (fwd + _source_int("conv3x3.cu", r"kPitch = (\d+);"),
            _source_int("conv3x3_wgrad.cu", r"kStages = (\d+);")
            + _source_int("conv3x3_wgrad.cu", r"Cfg<%s> \{\s*static "
                          r"constexpr int kPitch = (\d+)" % name))


def test_plans_match_the_sources():
    """The wrappers' copies of the kernels' tiles, chunks and items are
    the sources' constants, and the C entries take the plans' column
    tiles and input-channel items."""
    assert _source_int("conv3x3.cu", r"kTH = (\d+), kTW = (\d+);") == \
        list(cc._CC_TILE)
    src = (CSRC / "conv3x3.cu").read_text()
    m = re.search(r"int launch_bn\(.*?switch \(bn\) \{(.*?)\n  \}", src,
                  re.S)
    assert tuple(int(b) for b in re.findall(r"case (\d+):", m.group(1))) == \
        cc._CC_BN
    wsrc = (CSRC / "conv3x3_wgrad.cu").read_text()
    m = re.search(r"switch \(ci\) \{(.*?)\n  \}", wsrc, re.S)
    cases = re.findall(r"case (\d+):\s*(if constexpr \(sizeof\(T\) == 4\))?",
                       m.group(1))
    assert tuple(int(c) for c, _ in cases) == cc._CCW_CI[torch.float32]
    assert tuple(int(c) for c, f32 in cases if not f32) == \
        cc._CCW_CI[torch.bfloat16]
    assert _source_int("conv3x3_wgrad.cu", r"kCh = (\d+);") == [cc._CCW_CH]
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "float")):
        assert _source_int("conv3x3.cu", r"Cfg<%s> \{\s*static constexpr "
                           r"int kKC = (\d+)" % name) == [cc._CC_KC[dt]]
    assert _source_int("conv3x3_wgrad.cu", r"kTH = (\d+), kTW = (\d+);") \
        == list(cc._CCW_TILE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RAGGED_NET_SHAPES)
def test_ragged_net_plans(dtype, shape):
    """At every ragged-net shape: the forward's tiles, columns and ring fit
    (shared memory within an H100 block's 227 KB); the weight gradient's
    runs cut each volume into non-empty runs, from the volume's shape
    alone (the plans take neither the batch, nor `patch_group`, nor the
    members side by side), with enough blocks for a wave."""
    depth, H, W, C, CO = shape
    kc, parts = cc._CC_KC[dtype], 2 if dtype == torch.float32 else 1
    th, tw = cc._CC_TILE
    halo = (th + 2) * (tw + 2)
    (ring, pitch), (wring, wpitch) = _ring(dtype)
    halo_bytes = -(-halo * pitch // 256) * 256
    p = cuda_core_plan(depth, H, W, C, CO, dtype, 3)
    bn = p["bn"]
    # CO rounded up to the narrowest tile that holds it, else column tiles
    # of 64
    assert bn in cc._CC_BN and (bn >= CO or bn == 64)
    assert bn == 64 or bn // 2 < CO or bn == min(cc._CC_BN)
    # every split a non-empty run of stages, none left out, as the source
    # checks them
    stages = 3 * -(-C // kc)
    assert (p["splits"] - 1) * p["per_split"] < stages <= \
        p["splits"] * p["per_split"]
    assert p["splits"] <= cc._CC_MAX_SPLITS
    items = depth * -(-H // th) * -(-W // tw) * -(-CO // bn)
    assert p["splits"] == 1 or p["splits"] * items <= \
        cc._CC_TARGET_BLOCKS + items
    # the source's smem_bytes: slack, the ring of halo and weights, the
    # halo's offsets; bf16 two blocks an SM (kMinBlocks), at every tile
    for bn in cc._CC_BN:
        smem = (1024 + ring
                * (halo_bytes + parts * 9 * bn * 32) + halo * 4)
        blocks = 1 if dtype == torch.float32 else 2
        assert smem <= SMEM_LIMIT and blocks * (smem + 1024) <= SM_SMEM
    wp = cuda_core_wgrad_plan(depth, H, W, C, CO, dtype)
    wth, wtw = cc._CCW_TILE
    tiles = depth * -(-H // wth) * -(-W // wtw)
    assert (wp["splits"] - 1) * wp["per_split"] < tiles <= \
        wp["splits"] * wp["per_split"]
    # C rounded up to the narrowest item that holds it, else items of 32
    assert wp["ci"] in cc._CCW_CI[dtype] and (wp["ci"] >= C or wp["ci"] == 32)
    items = 3 * -(-C // wp["ci"]) * -(-CO // cc._CCW_CH)
    assert wp["splits"] * items >= min(cc._CC_TARGET_BLOCKS, tiles * items)
    # the source's smem_bytes: a ring of x halo and dy stages, two tables
    # of the halo's pixel indices
    whalo = (wth + 2) * (wtw + 2)
    wsmem = wring * (whalo + wth * wtw) * wpitch + 2 * whalo * 4
    assert ring >= 2 and wring >= 2 and wsmem <= SMEM_LIMIT


def unswizzle(wp):
    """The packed blocks with each row's 16-byte halves in order again
    (the swizzle swaps them in rows whose bit 2 is set; it is its own
    inverse)."""
    bn, kc = wp.shape[-2:]
    halves = wp.reshape(wp.shape[:-1] + (2, kc // 2))
    swap = ((torch.arange(bn) >> 2) & 1).bool().view(bn, 1, 1)
    return torch.where(swap, halves.flip(-2), halves).reshape(wp.shape)


def unpack_cuda_core_weights(wp, C, CO):
    """`pack_cuda_core_weights`' input back from its output: (M, kz, 3, 3,
    C, CO), f32 as the sum of its two parts (exact)."""
    M, kz, nch, ct, _, _, bn, kc = wp.shape
    wp = unswizzle(wp)
    w = wp.sum(dim=4) if wp.dtype == torch.float32 else wp[:, :, :, :, 0]
    w = w.permute(0, 1, 4, 2, 6, 3, 5).reshape(M, kz, 3, 3, nch * kc,
                                                ct * bn)
    return w[..., :C, :CO]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,kz,C,CO", [(1, 3, 30, 30), (3, 1, 5, 1),
                                       (2, 3, 12, 300), (1, 3, 300, 60)])
def test_weight_pack(dtype, M, kz, C, CO):
    """Each packed block holds its chunk's channels and its tile's columns
    at [part][tap][column][channel], each row's 16-byte halves swapped
    where bit 2 of the row is set (the 32-byte swizzle); padded columns
    and channels are zero; f32's two parts are `tf32_split`'s; unpacking
    gives the input back; at every column tile."""
    g = torch.Generator().manual_seed(C + CO)
    w = torch.randn((M, kz, 3, 3, C, CO), generator=g).to(dtype)
    kc = cc._CC_KC[dtype]
    parts = 2 if dtype == torch.float32 else 1
    nch = -(-C // kc)
    for bn in cc._CC_BN:
        wp = pack_cuda_core_weights(w, bn)
        ct = -(-CO // bn)
        assert wp.shape == (M, kz, nch, ct, parts, 9, bn, kc)
        assert torch.equal(unpack_cuda_core_weights(wp, C, CO), w)
        flat = unswizzle(wp)
        full = flat.sum(dim=4) if parts == 2 else flat[:, :, :, :, 0]
        ci = torch.arange(nch * kc).view(nch, 1, 1, 1, kc)
        co = (torch.arange(ct).view(1, -1, 1, 1, 1) * bn
              + torch.arange(bn).view(1, 1, 1, -1, 1))
        pad = ((ci >= C) | (co >= CO)).expand(nch, ct, 9, bn, kc)
        assert not full[:, :, pad].any()
        if parts == 2:
            hi, lo = cc.tf32_split(full)
            assert torch.equal(flat[:, :, :, :, 0], hi)
            assert torch.equal(flat[:, :, :, :, 1], lo)
        # row 4 holds channels kc / 2 .. kc first: the swizzle
        if bn >= 8:
            assert torch.equal(wp[..., 4, :kc // 2], flat[..., 4, kc // 2:])
        # a block's rows are contiguous in memory, the stage a cp.async
        # copies as it lies
        assert wp.is_contiguous()


def _model_forward(x, wp, depth, CO, members, splits):
    """csrc/conv3x3.cu's loops in float64: per plane, column tile and
    split, the split's run of (z-tap, chunk) stages less those whose plane
    lies outside the group, the halo of the chunk's channels read at the
    nine shifts, each against its packed block (f32: the parts' sum); the
    splits' partials added in order."""
    N, H, W, C = x.shape
    wp = unswizzle(wp)
    full = (wp.double().sum(dim=4) if wp.dtype == torch.float32
            else wp[:, :, :, :, 0].double())
    _, KZ, nch, co_tiles, _, bn, kc = full.shape
    per = -(-KZ * nch // splits)
    xd = torch.nn.functional.pad(x.double(), (0, nch * kc - C, 1, 1, 1, 1))
    part = torch.zeros(splits, N, H, W, co_tiles * bn, dtype=torch.float64)
    for n in range(N):
        m, d = n // (N // members), n % depth
        for sp in range(splits):
            for f in range(sp * per, min((sp + 1) * per, KZ * nch)):
                z, c = divmod(f, nch)
                dz = z - KZ // 2
                if not 0 <= d + dz < depth:
                    continue  # the whole block skips the stage
                halo = xd[n + dz, :, :, c * kc:(c + 1) * kc]
                for ct in range(co_tiles):
                    blk = full[m, z, c, ct]  # (9, bn, kc)
                    for tap in range(9):
                        ky, kx = divmod(tap, 3)
                        a = halo[ky:ky + H, kx:kx + W]  # the shifted A
                        part[sp, n, :, :, ct * bn:(ct + 1) * bn] += \
                            a @ blk[tap].T
    y = part[0]
    for p in part[1:]:
        y = y + p
    return y[..., :CO]


def _model_wgrad(x, dy, depth, kz, members):
    """csrc/conv3x3_wgrad.cu's loops in float64: each volume cut into the
    plan's runs of 8 x 16 position tiles, a run's tiles summed per z-tap
    (the x plane's outside the group skipped), a member's partials added
    in order (volume, run)."""
    N, H, W, C = x.shape
    CO = dy.shape[-1]
    plan = cuda_core_wgrad_plan(depth, H, W, C, CO, x.dtype, kz)
    th, tw = cc._CCW_TILE
    tiles_w, tiles_plane = -(-W // tw), -(-H // th) * -(-W // tw)
    tiles = depth * tiles_plane
    xd = torch.nn.functional.pad(x.double(), (0, 0, 1, tw + 1, 1, th + 1))
    dd = torch.nn.functional.pad(dy.double(), (0, 0, 0, tw, 0, th))
    out = []
    volumes = N // members // depth
    for m in range(members):
        parts = []
        for v in range(volumes):
            base = (m * volumes + v) * depth
            for s in range(plan["splits"]):
                part = torch.zeros(kz, 3, 3, C, CO, dtype=torch.float64)
                lo = s * plan["per_split"]
                hi = min(lo + plan["per_split"], tiles)
                for z in range(kz):
                    dz = z - kz // 2
                    for tt in range(lo, hi):
                        d, tp = divmod(tt, tiles_plane)
                        if not 0 <= d + dz < depth:
                            continue
                        h0, w0 = tp // tiles_w * th, tp % tiles_w * tw
                        g = dd[base + d, h0:h0 + th, w0:w0 + tw]
                        for tap in range(9):
                            ky, kx = divmod(tap, 3)
                            a = xd[base + d + dz, h0 + ky:h0 + ky + th,
                                   w0 + kx:w0 + kx + tw]
                            part[z, ky, kx] += torch.einsum("hwc,hwo->co",
                                                            a, g)
                parts.append(part)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        out.append(total)
    return torch.stack(out)


def _conv64(x, w5, depth):
    """The conv in float64, `conv3x3_reference`'s views."""
    N, H, W, C = x.shape
    x5 = x.double().reshape(N // depth, depth, H, W, C).permute(0, 4, 1, 2, 3)
    wk = w5.double().permute(4, 3, 0, 1, 2)
    pad = (1, 1, 1) if w5.shape[0] == 3 else (0, 1, 1)
    y = torch.nn.functional.conv3d(x5, wk, padding=pad)
    return y.permute(0, 2, 3, 4, 1).reshape(N, H, W, -1)


def _wgrad64(x, dy, depth, kz):
    N, H, W, C = x.shape
    CO = dy.shape[-1]

    def cf(t):
        return t.double().reshape(N // depth, depth, H, W, -1) \
            .permute(0, 4, 1, 2, 3)

    pad = (1, 1, 1) if kz == 3 else (0, 1, 1)
    dw = torch.nn.grad.conv3d_weight(cf(x), (CO, C, kz, 3, 3), cf(dy),
                                     padding=pad)
    return dw.permute(2, 3, 4, 1, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,H,W,C,CO,kz", [
    (1, 3, 9, 19, 30, 30, 3),   # depth edges, ragged tiles
    (2, 2, 17, 18, 5, 7, 3),    # members, a second tile row and column
    (1, 1, 5, 3, 60, 1, 3),     # depth 1: only the middle z-tap
    (3, 4, 6, 7, 12, 70, 1),    # one z-tap, two column tiles
    (1, 2, 9, 10, 5, 7, 1),     # one stage: no split
])
def test_kernel_models_match_plain(dtype, M, D, H, W, C, CO, kz):
    g = torch.Generator().manual_seed(D * 100 + C)
    N = M * 2 * D
    x = torch.randn((N, H, W, C), generator=g).to(dtype)
    w = torch.randn((M, kz, 3, 3, C, CO), generator=g).to(dtype)
    dy = torch.randn((N, H, W, CO), generator=g).to(dtype)
    p = cuda_core_plan(D, H, W, C, CO, dtype, kz)
    y = _model_forward(x, pack_cuda_core_weights(w, p["bn"]), D, CO, M,
                       p["splits"])
    ref = torch.cat([_conv64(xm, wm, D) for xm, wm in zip(x.chunk(M), w)])
    assert ((y - ref).abs().max() / ref.abs().max()).item() < 1e-10
    # the plain version the kernel is held to on the card agrees
    plain = conv3x3_reference(x, w, D).double()
    assert ((plain - ref).abs().max() / ref.abs().max()).item() < 1e-2
    dw = _model_wgrad(x, dy, D, kz, M)
    ref = torch.stack([_wgrad64(xm, dm, D, kz) for xm, dm in
                       zip(x.chunk(M), dy.chunk(M))])
    assert ((dw - ref).abs().max() / ref.abs().max()).item() < 1e-10
    plain = conv3x3_wgrad_reference(x, dy, D, kz, members=M).double()
    assert ((plain - ref).abs().max() / ref.abs().max()).item() < 1e-4


def test_wgrad_splits_follow_one_volume():
    """Two volumes in one call are cut as each alone: the partials of a
    volume do not depend on the launch's batch, `patch_group` or members
    (a grouped step's volumes sum their positions as the ungrouped ones)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((8, 20, 40, 30), generator=g)
    dy = torch.randn((8, 20, 40, 30), generator=g)
    plan = cuda_core_wgrad_plan(4, 20, 40, 30, 30, torch.float32)
    assert plan["splits"] > 1
    both = _model_wgrad(x, dy, 4, 3, 1)
    one = _model_wgrad(x[:4], dy[:4], 4, 3, 1)
    two = _model_wgrad(x[4:], dy[4:], 4, 3, 1)
    assert ((both - one - two).abs().max() / both.abs().max()) < 1e-12
    assert _model_wgrad(x, dy, 4, 3, 2).shape == (2, 3, 3, 3, 30, 30)


RAGGED_SPEC = ArchSpec(
    features_per_stage=(6, 10, 20),
    kernel_sizes=((3, 3, 3),) * 3,
    strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
    n_conv_per_stage_encoder=(2, 2, 2),
    n_conv_per_stage_decoder=(2, 2),
    num_input_channels=1,
    num_classes=4,
)
_jax_unet = jax.jit(unet_apply, static_argnames=(
    "spec", "deep_supervision", "compute_dtype", "head_channel_idx"))


def _jax_spec():
    from dg_tta_tpu.models.plans import ArchSpec as JaxArchSpec
    return JaxArchSpec(**dataclasses.asdict(RAGGED_SPEC))


def _ragged_nets(n):
    return [init_unet_(PlainConvUNet(RAGGED_SPEC),
                       torch.Generator().manual_seed(s)) for s in range(n)]


def test_ragged_unet_routes():
    """Every stride-1 conv of the small ragged net takes "cuda_core" (CO
    6, 10, 20 are no multiple of 8) but the first, on the image."""
    f = RAGGED_SPEC.features_per_stage
    for c, co in [(f[0], f[0]), (f[1], f[1]), (f[2], f[2]),
                  (2 * f[1], f[1]), (2 * f[0], f[0])]:
        assert conv3x3_route(c, co, torch.float32) == "cuda_core"
    assert conv3x3_route(1, f[0], torch.float32) == "c1"


def test_ragged_unet_forward_and_gradient_match_jax():
    """The small ragged PlainConvUNet's logits and every parameter's
    gradient of a squared-logit loss against the JAX U-Net's."""
    (net,) = _ragged_nets(1)
    params = params_to_jax(net.state_dict())
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 16, 1)) \
        .astype(np.float32)
    spec = _jax_spec()
    ref = np.asarray(_jax_unet(params, jnp.asarray(x), spec), np.float32)
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-4)
    got.square().sum().backward()

    def loss(p):
        return jnp.sum(jnp.square(unet_apply(p, jnp.asarray(x), spec)))

    jgrads = params_from_jax(jax.jit(jax.grad(loss))(params))
    for name, p in net.named_parameters():
        ref_g = jgrads[name].numpy()
        got_g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).numpy()
        scale = max(np.abs(ref_g).max(), 1e-30)
        assert np.abs(got_g - ref_g).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_ragged_unet_members_equal_serial(dtype):
    """Three ragged nets side by side (`forward_members` on stacked
    weights): each member's logits and gradients bit for bit its serial
    forward's."""
    M = 3
    nets = _ragged_nets(M)
    params = {k: p.detach().clone().requires_grad_()
              for k, p in stack_members(nets).items()}
    x = torch.randn(M * 2, 16, 16, 16, 1,
                    generator=torch.Generator().manual_seed(4))
    out = nets[0].forward_members(params, x, compute_dtype=dtype)
    out.float().square().sum().backward()
    for m, (net, xm) in enumerate(zip(nets, x.chunk(M))):
        ref = net(xm, compute_dtype=dtype)
        ref.float().square().sum().backward()
        assert torch.equal(out.chunk(M)[m], ref)
        for name, p in net.named_parameters():
            got = params[name].grad
            if p.grad is None:
                assert got is None or not got[m].any(), name
            else:
                assert torch.equal(got[m], p.grad), name
