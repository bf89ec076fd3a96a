"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the `cuda` marker and skips without a GPU.  The
file imports neither JAX nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, max |kernel - plain| over max |plain|:
* conv3x3: 5e-5 in f32 (the same products summed in another order, on
  the "wgmma_tf32x3" route each from three tf32 products; TF32 off for the
  plain version) and 2^-7 in bf16 (both round one f32 sum to bf16), on
  every route ("c1" for C = 1, "few" for 1 < C < 16, "wgmma" for bf16
  and "wgmma_tf32x3" for f32 with CO a multiple of 8, C zero-padded to a
  multiple of 16/8, else "cuda_core", the catch-all on the tensor cores
  by mma.sync, f32 as 3xTF32);
* conv3x3_wgrad: 1e-4, f32 out from f32 or bf16 in (sums over every
  position, split across blocks, in another order than cuDNN's);
* warp, trilinear: 1e-5 in f32 (eight products, fused multiply-adds in the
  kernel), 2^-7 in bf16 (one rounding of an f32 sum); nearest is exact
  (both round the same f32 coordinates half to even); the affine entry
  equals the grid entry on the card's `affine_grid` exactly;
* the warp's adjoint: 1e-5 in f32 (the same products, added into each
  source voxel by atomics in an order that varies from run to run), 2^-7
  in bf16 (one rounding of the f32 sum);
* the pretraining's deep-supervision targets: bit for bit; its
  augmentation, card against CPU: the labels bit for bit, the image 1e-5
  of its range (blur, gamma and products summed in another order);
* the deformable fields, card against CPU: 1e-4 of their largest value
  (ten warps and the smoothing summed in another order; the field's
  normalization amplifies that ~100x, as against the JAX package).
The card-vs-CPU runs of the conv's autograd Function, of a small
`tta_one_volume`, of MIND and of GIN state theirs in place.
"""

import copy

import numpy as np
import pytest
import torch

from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_op,
                                              conv3x3_reference,
                                              conv3x3_route, conv3x3_wgrad,
                                              conv3x3_wgrad_reference,
                                              conv3x3_wgrad_route)
from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                           warp_affine_reference, warp_flat,
                                           warp_flat_adjoint,
                                           warp_flat_adjoint_reference,
                                           warp_flat_op,
                                           warp_flat_reference)

RTOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}
WARP_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _max_rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kz,shape", [
    (1, (12, 6, 19, 37, 13, 40)),   # N, depth, H, W, C, CO: ragged tiles
    (3, (12, 6, 19, 37, 13, 40)),
    (3, (8, 8, 16, 16, 1, 32)),     # C = 1, the first U-Net conv
    (3, (4, 1, 5, 3, 9, 70)),       # depth 1: no z-neighbours
])
def test_conv3x3_kernel_matches_plain(cuda_device, dtype, kz, shape):
    N, D, H, W, C, CO = shape
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(kz, 3, 3, C, CO)) * 0.1)
                         .astype(np.float32))
    x, w = x.to(cuda_device, dt), w.to(cuda_device, dt)
    before = conv3x3.launches
    got = conv3x3(x, w, depth=D)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    assert got.dtype == dt and got.shape == (N, H, W, CO)
    assert _max_rel_err(got, conv3x3_reference(x, w, depth=D)) <= RTOL[dtype]


@pytest.mark.cuda
def test_conv3x3_kernel_rejects_non_contiguous_input(cuda_device):
    x = torch.zeros(4, 6, 8, 3, device=cuda_device)[:, :, ::2]
    w = torch.zeros(3, 3, 3, 5, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x, w)


@pytest.mark.cuda
def test_unet_on_card_matches_cpu(cuda_device):
    """A small U-Net through the kernel on the card against the same
    network on the CPU (plain versions): f32, 1e-4 of the logits' range."""
    from dg_tta_tpu_torch.models.plans import ArchSpec
    from dg_tta_tpu_torch.models.unet import PlainConvUNet, init_unet_

    spec = ArchSpec(features_per_stage=(8, 16, 32),
                    kernel_sizes=((3, 3, 3),) * 3,
                    strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
                    n_conv_per_stage_encoder=(2, 2, 2),
                    n_conv_per_stage_decoder=(2, 2),
                    num_input_channels=1, num_classes=4)
    net = init_unet_(PlainConvUNet(spec), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 16, 16, 16, 1)).astype(np.float32))
    with torch.no_grad():
        ref = net.eval()(x)
        before = conv3x3.launches
        got = net.to(cuda_device)(x.to(cuda_device)).cpu()
    assert conv3x3.launches - before == 8  # 4 encoder + 4 decoder convs
    assert _max_rel_err(got, ref) <= 1e-4


def _affine_grid(rng, B, out_spatial, device):
    from dg_tta_tpu_torch.core.grid import affine_grid

    theta = torch.from_numpy((np.eye(3, 4)[None] + 0.1 * rng.normal(
        size=(B, 3, 4))).astype(np.float32))
    return affine_grid(theta.to(device), out_spatial)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,padding_mode", [
    ("trilinear", "zeros"), ("trilinear", "border"), ("nearest", "zeros"),
    ("nearest", "border")])
@pytest.mark.parametrize("C,src,out", [
    (1, (19, 13, 37), (19, 13, 37)),    # ragged, endomorphic
    (5, (9, 14, 11), (6, 17, 23)),      # not endomorphic
])
def test_warp_kernel_matches_plain(cuda_device, dtype, mode, padding_mode,
                                   C, src, out):
    rng = np.random.default_rng(0)
    B = 2
    flat = torch.from_numpy(rng.normal(size=(B, C, int(np.prod(src))))
                            .astype(np.float32)).to(cuda_device,
                                                    getattr(torch, dtype))
    grid = _affine_grid(rng, B, out, cuda_device)
    before = warp_flat.launches
    got = warp_flat(flat, src, grid, mode=mode, padding_mode=padding_mode)
    torch.cuda.synchronize()
    assert warp_flat.launches == before + 1
    ref = warp_flat_reference(flat, src, grid, mode=mode,
                              padding_mode=padding_mode)
    assert got.dtype == flat.dtype and got.shape == (B, C, int(np.prod(out)))
    if mode == "nearest":
        assert torch.equal(got, ref)
    else:
        assert _max_rel_err(got, ref) <= WARP_RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kz,shape", [
    (3, (12, 6, 19, 37, 13, 40)),   # N, depth, H, W, C, CO: ragged tiles
    (3, (8, 8, 16, 16, 1, 32)),     # C = 1, the first U-Net conv
    (3, (4, 1, 5, 3, 9, 70)),       # depth 1: no z-neighbours
    (1, (6, 3, 9, 20, 36, 7)),      # one z-tap
    (3, (64, 32, 40, 48, 8, 8)),    # enough positions to split the sum
])
def test_wgrad_kernel_matches_plain(cuda_device, dtype, kz, shape):
    N, D, H, W, C, CO = shape
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    x, dy = x.to(cuda_device, dt), dy.to(cuda_device, dt)
    before = conv3x3_wgrad.launches
    got = conv3x3_wgrad(x, dy, depth=D, kz=kz)
    torch.cuda.synchronize()
    assert conv3x3_wgrad.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (kz, 3, 3, C, CO)
    ref = conv3x3_wgrad_reference(x, dy, depth=D, kz=kz)
    assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 13])
def test_conv_autograd_on_card_matches_cpu(cuda_device, C):
    """Forward, input and weight gradients of `conv3x3_op` on the card
    against the CPU (plain versions): f32, 1e-4 of each range."""
    rng = np.random.default_rng(2)
    N, D, H, W, CO = 10, 5, 11, 21, 17
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, C, CO)) * 0.2)
                         .astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        xd = x.detach().to(dev).requires_grad_(True)
        wd = w.detach().to(dev).requires_grad_(True)
        y = conv3x3_op(xd, wd, depth=D)
        (y * ct.to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    for ref, got in zip(*outs):
        assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
def test_tta_one_volume_on_card_matches_cpu(cuda_device):
    """A small adaptation (tiny U-Net, 1 member, 3 epochs x 2 patches, the
    last two trained, the same injected draws) on the card against the
    CPU: losses 1e-3 relative; each parameter's update (final - initial)
    within 5% of the CPU's in norm (AdamW's ~lr x sign steps may flip on
    near-zero gradients; no update, or a wrong one, misses by 100%); the
    parameters the loss never reaches decayed by exactly (1 - lr x weight
    decay) per trained epoch, 1e-6 relative; and the kernels launched as
    counted."""
    from dg_tta_tpu_torch.models.network import Model
    from dg_tta_tpu_torch.models.plans import ArchSpec
    from dg_tta_tpu_torch.models.unet import init_unet_
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import tta_one_volume
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    spec = ArchSpec(features_per_stage=(8, 16), kernel_sizes=((3, 3, 3),) * 2,
                    strides=((1, 1, 1), (2, 2, 2)),
                    n_conv_per_stage_encoder=(1, 1),
                    n_conv_per_stage_decoder=(1,), num_input_channels=1,
                    num_classes=4)
    model = Model(spec=spec, patch_size=(16, 16, 16),
                  trainer_name="nnUNetTrainer_GIN", uses_gin_internal=True,
                  uses_mind=False)
    net = init_unet_(model.build_network(device="cpu"),
                     torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    with torch.no_grad():
        # nonzero conv biases (unused before InstanceNorm), so that their
        # weight decay shows
        for name, p in net.named_parameters():
            if name.endswith("conv.bias"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape)))
    init = {n: p.detach().clone() for n, p in net.named_parameters()}
    vol = rng.normal(size=(1, 24, 28, 20, 1)).astype(np.float32) * 0.1
    vol[0, 6:12, 7:14, 5:10] += 2.0
    lab = np.zeros((1, 24, 28, 20, 1), np.float32)
    lab[0, 6:12, 7:14, 5:10] = 1.0
    plan = TTAPlan(epochs=3, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=1, start_tta_at_epoch=1)
    idx = np.arange(3)
    runs = []
    for dev in ("cpu", cuda_device):
        counts = (conv3x3.launches, conv3x3_wgrad.launches,
                  warp_affine_flat.launches, warp_flat.launches)
        nets, losses, dices = tta_one_volume(
            model, plan, net.to(dev), torch.from_numpy(vol).to(dev),
            [[24.0, 28.0, 20.0]], idx, idx, TorchDraws(seed=5),
            labels_padded=torch.from_numpy(lab).to(dev))
        counts = (conv3x3.launches - counts[0],
                  conv3x3_wgrad.launches - counts[1],
                  warp_affine_flat.launches - counts[2],
                  warp_flat.launches - counts[3])
        runs.append((nets[0].cpu().state_dict(), losses, dices, counts))
    (ref_p, ref_l, ref_d, cpu_counts), (got_p, got_l, got_d, counts) = runs
    assert cpu_counts == (0, 0, 0, 0)
    # 2 stride-1 convs per forward; 6 steps forward, 4 of them trained
    # (dgrad of the second conv only), 3 evals; 4 warps per step, 2
    # adjoints per trained step, 1 label warp per eval, all through the
    # warp's affine entry
    assert counts == (6 * 2 + 4 * 1 + 3 * 2, 4 * 2, 6 * 4 + 4 * 2 + 3, 0)
    np.testing.assert_allclose(got_l, ref_l, rtol=1e-3)
    np.testing.assert_allclose(got_d, ref_d, atol=2e-2)
    decay = (1.0 - plan.lr * 0.01) ** (plan.epochs - plan.start_tta_at_epoch)
    for name, p0 in init.items():
        ref_dp, got_dp = ref_p[name] - p0, got_p[name] - p0
        assert ref_dp.norm() > 0, name
        assert (got_dp - ref_dp).norm() <= 0.05 * ref_dp.norm(), name
        # unused: conv biases before InstanceNorm, the logit channel of
        # class 3 (outside idx)
        sl = (slice(None) if name.endswith("conv.bias") else
              3 if name.startswith("decoder.seg_layers.") else None)
        if sl is not None:
            for p in (ref_p[name], got_p[name]):
                np.testing.assert_allclose(p[sl].numpy(),
                                           decay * p0[sl].numpy(),
                                           rtol=1e-6, err_msg=name)


# The wgmma route (bf16, C % 16 == 0, CO % 8 == 0): (N, depth, H, W, C, CO,
# kz).  Ragged planes leave pixel tiles part empty; CO = 40 leaves the
# 64-channel tile part empty; the deepest TS104 level is a 7 x 8 plane at
# C = CO = 320 (the "small" layout, its items shared by clusters of
# blocks); C = 512 at 14 x 16 splits each item over a cluster too;
# persistent_c32 gives each persistent block several work items
# (`wgmma_plan`).
WGMMA_CASES = {
    "persistent_c32": (40, 4, 33, 35, 32, 32, 3),
    "ragged_c16": (12, 6, 19, 37, 16, 40, 3),
    "depth1_c32": (4, 1, 9, 21, 32, 32, 3),
    "two_volumes_co320": (8, 4, 20, 18, 32, 320, 3),
    "plane_7x8_c320": (6, 3, 7, 8, 320, 320, 3),
    "c512": (4, 2, 14, 16, 512, 256, 3),
    "one_z_tap": (6, 3, 11, 13, 64, 32, 1),
}


def _wgmma_inputs(case, seed, device):
    N, D, H, W, C, CO, kz = WGMMA_CASES[case]
    assert conv3x3_route(C, CO, torch.bfloat16) == "wgmma"
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(kz, 3, 3, C, CO))
                          * (2.0 / (27 * C)) ** 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    return [t.to(device, torch.bfloat16) for t in (x, w, dy)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_conv3x3_wgmma_matches_plain(cuda_device, case):
    x, w, _ = _wgmma_inputs(case, 3, cuda_device)
    depth = WGMMA_CASES[case][1]
    before = (conv3x3.launches, conv3x3.wgmma_launches)
    got = conv3x3(x, w, depth=depth)
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3.wgmma_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (*x.shape[:3],
                                                         w.shape[-1])
    ref = conv3x3_reference(x, w, depth=depth)
    assert _max_rel_err(got, ref) <= RTOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["depth1_c32", "two_volumes_co320",
                                  "plane_7x8_c320"])
def test_conv3x3_wgmma_dgrad_with_flipped_swapped_weights(cuda_device, case):
    """The input gradient as Conv3x3Function.backward runs it: dy (CO
    channels) through the kernel with the forward weights flipped in
    (kz, ky, kx) and their channel axes swapped."""
    _, w, dy = _wgmma_inputs(case, 4, cuda_device)
    depth = WGMMA_CASES[case][1]
    wt = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
    assert conv3x3_route(wt.shape[3], wt.shape[4], wt.dtype) == "wgmma"
    before = conv3x3.wgmma_launches
    got = conv3x3(dy, wt, depth=depth)
    torch.cuda.synchronize()
    assert conv3x3.wgmma_launches == before + 1
    ref = conv3x3_reference(dy, wt, depth=depth)
    assert _max_rel_err(got, ref) <= RTOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_wgrad_wgmma_matches_plain(cuda_device, case):
    x, _, dy = _wgmma_inputs(case, 5, cuda_device)
    N, D, H, W, C, CO, kz = WGMMA_CASES[case]
    assert conv3x3_wgrad_route(C, CO, torch.bfloat16) == "wgmma"
    before = (conv3x3_wgrad.launches, conv3x3_wgrad.wgmma_launches)
    got = conv3x3_wgrad(x, dy, depth=D, kz=kz)
    torch.cuda.synchronize()
    assert (conv3x3_wgrad.launches, conv3x3_wgrad.wgmma_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (kz, 3, 3, C, CO)
    ref = conv3x3_wgrad_reference(x, dy, depth=D, kz=kz)
    assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
def test_wgmma_routes_reject_misaligned_tensors(cuda_device):
    """TMA reads from 16-byte boundaries: a view that starts 2 bytes in
    raises before any launch."""
    shape = (4, 6, 8, 16)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda_device)
    x = buf[1:n + 1].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    w = torch.zeros((3, 3, 3, 16, 32), dtype=torch.bfloat16,
                    device=cuda_device)
    dy = torch.zeros((4, 6, 8, 32), dtype=torch.bfloat16, device=cuda_device)
    before = (conv3x3.launches, conv3x3_wgrad.launches)
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3(x, w, depth=2)
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3_wgrad(x, dy, depth=2)
    assert (conv3x3.launches, conv3x3_wgrad.launches) == before


# The "wgmma_tf32x3" route (f32, C % 8 == 0, CO % 8 == 0): (N, depth, H, W,
# C, CO, kz).  C = 8 and 24 take the 32-byte rows (8 channels per stage),
# the rest 64 bytes (16 channels); C = 512 is the longest sum of the main
# path, where the accumulator's promotion matters; the layouts, clusters
# and persistent blocks as in WGMMA_CASES.
TF32X3_CASES = {
    "persistent_c32": (40, 4, 33, 35, 32, 32, 3),
    "ragged_c16": (12, 6, 19, 37, 16, 40, 3),
    "c8": (6, 3, 11, 13, 8, 16, 3),
    "c24": (4, 2, 9, 21, 24, 32, 3),
    "c48": (4, 2, 10, 18, 48, 64, 3),
    "depth1_c32": (4, 1, 9, 21, 32, 32, 3),
    "two_volumes_co320": (8, 4, 20, 18, 32, 320, 3),
    "plane_7x8_c320": (6, 3, 7, 8, 320, 320, 3),
    "c512": (4, 2, 14, 16, 512, 256, 3),
    "one_z_tap": (6, 3, 11, 13, 64, 32, 1),
}


def _tf32x3_route(C, CO):
    """The `route` argument that runs a shape on "wgmma_tf32x3": forced
    where the shape chooses "few" (C < 16, on channels zero-padded to a
    multiple of 8), else the shape's own."""
    chosen = conv3x3_route(C, CO, torch.float32)
    assert chosen in ("wgmma_tf32x3", "few")
    return "wgmma_tf32x3" if chosen == "few" else None


def _tf32x3_inputs(case, seed, device):
    N, D, H, W, C, CO, kz = TF32X3_CASES[case]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(kz, 3, 3, C, CO))
                          * (2.0 / (27 * C)) ** 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    return [t.to(device) for t in (x, w, dy)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TF32X3_CASES))
def test_conv3x3_tf32x3_matches_plain(cuda_device, case):
    """f32 on the tensor cores at f32's tolerance (5e-5), not TF32's."""
    x, w, _ = _tf32x3_inputs(case, 6, cuda_device)
    depth = TF32X3_CASES[case][1]
    before = (conv3x3.launches, conv3x3.tf32x3_launches)
    got = conv3x3(x, w, depth=depth,
                  route=_tf32x3_route(x.shape[-1], w.shape[-1]))
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3.tf32x3_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (*x.shape[:3],
                                                        w.shape[-1])
    ref = conv3x3_reference(x, w, depth=depth)
    assert _max_rel_err(got, ref) <= RTOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["depth1_c32", "two_volumes_co320",
                                  "plane_7x8_c320", "c512"])
def test_conv3x3_tf32x3_dgrad_with_flipped_swapped_weights(cuda_device,
                                                           case):
    """The input gradient as Conv3x3Function.backward runs it, f32."""
    _, w, dy = _tf32x3_inputs(case, 7, cuda_device)
    depth = TF32X3_CASES[case][1]
    wt = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
    assert conv3x3_route(wt.shape[3], wt.shape[4], wt.dtype) == \
        "wgmma_tf32x3"
    before = conv3x3.tf32x3_launches
    got = conv3x3(dy, wt, depth=depth)
    torch.cuda.synchronize()
    assert conv3x3.tf32x3_launches == before + 1
    ref = conv3x3_reference(dy, wt, depth=depth)
    assert _max_rel_err(got, ref) <= RTOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["persistent_c32", "plane_7x8_c320", "c512",
                                  "depth1_c32"])
def test_wgmma_forward_is_deterministic(cuda_device, dtype, case):
    """Two launches on the same inputs give the same bits, on persistent
    blocks and on clusters (whose partial sums rank 0 adds in rank order:
    no atomics)."""
    if dtype == "bfloat16":
        x, w, _ = _wgmma_inputs(case, 8, cuda_device)
        depth = WGMMA_CASES[case][1]
    else:
        x, w, _ = _tf32x3_inputs(case, 8, cuda_device)
        depth = TF32X3_CASES[case][1]
    first = conv3x3(x, w, depth=depth)
    second = conv3x3(x, w, depth=depth)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _max_rel_err(first, conv3x3_reference(x, w, depth=depth)) <= \
        RTOL[dtype]


@pytest.mark.cuda
def test_tf32x3_route_rejects_misaligned_tensors(cuda_device):
    shape = (4, 6, 8, 16)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.float32, device=cuda_device)
    x = buf[1:n + 1].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    w = torch.zeros((3, 3, 3, 16, 32), device=cuda_device)
    before = conv3x3.launches
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3(x, w, depth=2)
    assert conv3x3.launches == before


# The "c1" route (C = 1, either type): (N, depth, H, W, CO, kz).  Ragged
# planes leave the 8 x 64 (forward, bf16 weight gradient) and 4 x 64 (f32
# weight gradient) tiles part empty, and W = 100 the last 16-pixel M tile
# of a row; a plane of one row leaves all but one row of a tile empty;
# CO = 40 takes two channel slices, the second part empty (channel-wise
# stores); CO = 7 is odd (no vector accesses: element-wise staging of dy).
C1_CASES = {
    "first_conv": (8, 8, 16, 16, 32, 3),
    "ragged": (12, 6, 19, 37, 32, 3),
    "depth1": (4, 1, 5, 3, 32, 3),
    "co40": (4, 2, 17, 33, 40, 3),
    "co7_odd": (6, 3, 9, 20, 7, 3),
    "one_z_tap": (6, 3, 11, 45, 32, 1),
    "many_tiles": (64, 32, 40, 72, 32, 3),
    "w100_ragged_m_tile": (6, 3, 10, 100, 32, 3),
    "one_row_plane": (8, 4, 1, 70, 32, 3),
}


def _c1_inputs(case, seed, dtype, device):
    N, D, H, W, CO, kz = C1_CASES[case]
    assert conv3x3_route(1, CO, dtype) == "c1"
    assert conv3x3_wgrad_route(1, CO, dtype) == "c1"
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(N, H, W, 1)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(kz, 3, 3, 1, CO)) * 0.3)
                         .astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    return [t.to(device, dtype) for t in (x, w, dy)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_conv3x3_c1_matches_plain(cuda_device, dtype, case):
    dt = getattr(torch, dtype)
    x, w, _ = _c1_inputs(case, 8, dt, cuda_device)
    depth = C1_CASES[case][1]
    before = (conv3x3.launches, conv3x3.c1_launches)
    got = conv3x3(x, w, depth=depth)
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3.c1_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == dt and got.shape == (*x.shape[:3], w.shape[-1])
    assert _max_rel_err(got, conv3x3_reference(x, w, depth=depth)) \
        <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_wgrad_c1_matches_plain(cuda_device, dtype, case):
    dt = getattr(torch, dtype)
    x, _, dy = _c1_inputs(case, 9, dt, cuda_device)
    N, D, H, W, CO, kz = C1_CASES[case]
    before = (conv3x3_wgrad.launches, conv3x3_wgrad.c1_launches)
    got = conv3x3_wgrad(x, dy, depth=D, kz=kz)
    torch.cuda.synchronize()
    assert (conv3x3_wgrad.launches, conv3x3_wgrad.c1_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (kz, 3, 3, 1, CO)
    ref = conv3x3_wgrad_reference(x, dy, depth=D, kz=kz)
    assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_c1_is_deterministic(cuda_device, dtype):
    """Two runs of the "c1" weight gradient give the same dW bit for bit:
    each block sums its tiles and its warps in a fixed order, and a second
    kernel adds the blocks' partials in a fixed order (no atomics)."""
    from dg_tta_tpu_torch.kernels.conv3x3 import wgrad_c1_splits

    dt = getattr(torch, dtype)
    x, _, dy = _c1_inputs("many_tiles", 10, dt, cuda_device)
    assert wgrad_c1_splits(x.shape, dy.shape[-1], dt) > 1
    a = conv3x3_wgrad(x, dy, depth=C1_CASES["many_tiles"][1])
    b = conv3x3_wgrad(x, dy, depth=C1_CASES["many_tiles"][1])
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# The weight gradient's "wgmma_tf32x3" route (f32, C % 8 == 0, CO % 8 == 0):
# the TF32X3_CASES shapes (ragged planes, C = 8 / 24 / 48 below one 32-channel
# halo row, the 7 x 8 level, C = 512, CO = 320, one z-tap) and a longer sum
# over many splits, each past the accumulator's promotion.
WGRAD_TF32X3_CASES = dict(TF32X3_CASES,
                          long_sum_c32=(16, 8, 56, 64, 32, 32, 3),
                          # N * H > 65535 rows (a patch_group = 4 TTA step's
                          # top level has 896 x 112), once past one grid
                          # dimension of the first design's dy pre-pass
                          many_rows=(600, 8, 112, 8, 16, 16, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGRAD_TF32X3_CASES))
def test_wgrad_tf32x3_matches_plain(cuda_device, case):
    """f32 weight gradient on the tensor cores at f32's 1e-4."""
    N, D, H, W, C, CO, kz = WGRAD_TF32X3_CASES[case]
    assert conv3x3_wgrad_route(C, CO, torch.float32) in ("wgmma_tf32x3",
                                                         "few")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    x, dy = x.to(cuda_device), dy.to(cuda_device)
    before = (conv3x3_wgrad.launches, conv3x3_wgrad.tf32x3_launches)
    got = conv3x3_wgrad(x, dy, depth=D, kz=kz, route=_tf32x3_route(C, CO))
    torch.cuda.synchronize()
    assert (conv3x3_wgrad.launches, conv3x3_wgrad.tf32x3_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (kz, 3, 3, C, CO)
    ref = conv3x3_wgrad_reference(x, dy, depth=D, kz=kz)
    assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,CO", [(32, 32), (64, 32), (64, 64)])
def test_wgrad_wgmma_is_deterministic(cuda_device, dtype, C, CO):
    """Two launches of the tensor-core weight gradient give the same dW bit
    for bit, on each of csrc/conv3x3_wgrad_wgmma.cu's kernels (f32 at 32
    and 64 columns, bf16 z-first and by descriptor) over several splits:
    each block sums in a fixed order, and a second kernel adds the splits'
    partial sums in a fixed order (no atomics)."""
    from dg_tta_tpu_torch.kernels.conv3x3 import wgrad_plan

    dt = getattr(torch, dtype)
    N, D, H, W = 16, 8, 28, 32
    assert wgrad_plan(N, H, W, C, CO, dt)["splits"] > 1
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    x, dy = x.to(dt).to(cuda_device), dy.to(dt).to(cuda_device)
    a = conv3x3_wgrad(x, dy, depth=D)
    b = conv3x3_wgrad(x, dy, depth=D)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = conv3x3_wgrad_reference(x, dy, depth=D)
    assert _max_rel_err(a, ref) <= 1e-4


@pytest.mark.cuda
def test_wgrad_tf32x3_rejects_misaligned_tensors(cuda_device):
    shape = (4, 6, 8, 16)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.float32, device=cuda_device)
    x = buf[1:n + 1].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    dy = torch.zeros((4, 6, 8, 32), device=cuda_device)
    before = conv3x3_wgrad.launches
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3_wgrad(x, dy, depth=2)
    buf2 = torch.zeros(2 * n + 8, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3_wgrad(dy[..., :16].contiguous(),
                      buf2[1:2 * n + 1].view(4, 6, 8, 32), depth=2)
    assert conv3x3_wgrad.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,padding_mode", [
    ("trilinear", "zeros"), ("trilinear", "border"), ("nearest", "zeros"),
    ("nearest", "border")])
@pytest.mark.parametrize("C,src,out,scaled", [
    (1, (19, 13, 37), (19, 13, 37), False),   # ragged W: no vector stores
    (4, (12, 16, 24), (12, 16, 24), True),    # the adjoint's scale
    (3, (9, 14, 11), (6, 17, 20), False),     # not endomorphic
])
def test_warp_affine_matches_grid_entry_and_plain(cuda_device, dtype, mode,
                                                 padding_mode, C, src, out,
                                                 scaled):
    """The affine entry equals the grid entry on the card's `affine_grid`
    bit for bit (times the scale in flat's type), and its plain version
    within WARP_RTOL."""
    from dg_tta_tpu_torch.core.grid import affine_grid

    rng = np.random.default_rng(12)
    B = 2
    dt = getattr(torch, dtype)
    flat = torch.from_numpy(rng.normal(size=(B, C, int(np.prod(src))))
                            .astype(np.float32)).to(cuda_device, dt)
    theta = torch.from_numpy((np.eye(3, 4)[None] + 0.1 * rng.normal(
        size=(B, 3, 4))).astype(np.float32)).to(cuda_device)
    scale = (torch.from_numpy((1.0 + 0.1 * rng.normal(size=B))
                              .astype(np.float32)).to(cuda_device)
             if scaled else None)
    kw = dict(mode=mode, padding_mode=padding_mode)
    before = (warp_affine_flat.launches, warp_flat.launches)
    got = warp_affine_flat(flat, src, theta, out, scale=scale, **kw)
    torch.cuda.synchronize()
    assert (warp_affine_flat.launches, warp_flat.launches) == \
        (before[0] + 1, before[1])
    assert got.dtype == dt and got.shape == (B, C, int(np.prod(out)))
    same = warp_flat(flat, src, affine_grid(theta, out), **kw)
    if scaled:
        same = same * scale.reshape(-1, 1, 1).to(dt)
    assert (got.float() - same.float()).abs().max().item() == 0.0
    ref = warp_affine_reference(flat, src, theta, out, scale=scale, **kw)
    if mode == "nearest":
        assert torch.equal(got, ref)
    else:
        assert _max_rel_err(got, ref) <= WARP_RTOL[dtype]


# Cases of the forward kernel's two paths (a brick's source box staged in
# shared memory, or gathered from device memory), as (C, B, source, output,
# points, mode, padding, the affine entry's paths): "tta" draws of
# get_rand_affine at the TTA's strength (0.05), one per batch entry; "zoom"
# a rotation times a zoom of `z`; "crop" a unit-stride crop of a larger
# volume (the labels site); "random" identity plus independent noise and
# "field" identity plus a smooth displacement at align_corners=True (the
# field warps), both through the grid entry only, which stages nothing.
PATH_CASES = {
    "tta_c4_zeros": (4, 2, (40, 48, 96), (40, 48, 96), "tta", "trilinear",
                     "zeros", "staged"),
    "tta_c1_border_ragged": (1, 2, (37, 45, 83), (37, 45, 83), "tta",
                             "trilinear", "border", "staged"),
    "tta_c3_not_endomorphic": (3, 2, (21, 30, 50), (13, 27, 70), "tta",
                               "trilinear", "zeros", "staged"),
    "zoom15_c5_zeros": (5, 2, (40, 48, 96), (40, 48, 96), 1.5, "trilinear",
                        "zeros", "both"),
    "zoom22_c5_border": (5, 1, (40, 48, 96), (40, 48, 96), 2.2, "trilinear",
                         "border", "both"),
    "zoom_c1_strong": (1, 2, (40, 48, 96), (40, 48, 96), 3.0, "trilinear",
                       "border", "both"),
    "crop_labels": (1, 1, (60, 64, 96), (30, 32, 48), "crop", "nearest",
                    "zeros", "staged"),
    "random_c4": (4, 2, (24, 40, 64), (24, 40, 64), "random", "trilinear",
                  "zeros", None),
    "field_c3_align": (3, 1, (30, 40, 50), (30, 40, 50), "field",
                       "trilinear", "border", None),
}


def _path_case_points(rng, kind, B, src, out, device):
    """(theta or None, grid, align_corners) of a PATH_CASES case."""
    from dg_tta_tpu_torch.core.fields import get_rand_affine
    from dg_tta_tpu_torch.core.grid import affine_grid, identity_grid

    if kind in ("random", "field"):
        align = kind == "field"
        ident = identity_grid(out, align)
        if kind == "random":
            d = rng.normal(0.0, 0.5, size=(3, B, *out))
        else:
            coarse = torch.from_numpy(rng.normal(
                0.0, 0.05, size=(B, 3, *(s // 5 for s in out))))
            d = torch.nn.functional.interpolate(
                coarse, size=out, mode="trilinear").movedim(1, 0).numpy()
        return None, tuple(
            (i[None] + torch.from_numpy(e.astype(np.float32))).to(device)
            for i, e in zip(ident, d)), align
    if kind == "tta":
        theta, _ = get_rand_affine(torch.from_numpy(
            rng.normal(size=(B, 3, 4)).astype(np.float32)))
    elif kind == "crop":
        theta = torch.tensor([[[out[2] / src[2], 0, 0, 0.2],
                               [0, out[1] / src[1], 0, -0.1],
                               [0, 0, out[0] / src[0], 0.3]]],
                             dtype=torch.float32)
    else:
        a = rng.uniform(0.2, 0.4, size=B)
        theta = torch.from_numpy(np.stack([
            [[kind * np.cos(t), -kind * np.sin(t), 0, 0],
             [kind * np.sin(t), kind * np.cos(t), 0, 0],
             [0, 0, kind, 0.05]] for t in a]).astype(np.float32))
    theta = theta.to(device)
    return theta, affine_grid(theta, out), False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_warp_paths_match_grid_entry_and_plain(cuda_device, dtype, case):
    """Both forward entries on both paths of the kernel: the bricks of each
    launch count themselves by path (`brick_paths`) exactly as
    `warp_brick_paths` predicts (the grid entry's all on device memory),
    the affine entry takes the paths its case is built for and equals the
    grid entry on the card's `affine_grid` bit for bit, and both agree
    with the plain version within WARP_RTOL (nearest exactly)."""
    from dg_tta_tpu_torch.kernels.warp import (brick_paths,
                                               warp_brick_paths)

    C, B, src, out, kind, mode, pad, paths = PATH_CASES[case]
    rng = np.random.default_rng(40)
    dt = getattr(torch, dtype)
    flat = torch.from_numpy(rng.normal(size=(B, C, int(np.prod(src))))
                            .astype(np.float32)).to(cuda_device, dt)
    theta, grid, align = _path_case_points(rng, kind, B, src, out,
                                           cuda_device)
    kw = dict(mode=mode, padding_mode=pad)
    es = flat.element_size()
    with brick_paths() as counts:
        got = warp_flat(flat, src, grid, align_corners=align, **kw)
        torch.cuda.synchronize()
        assert tuple(counts.tolist()) == warp_brick_paths(
            src, grid, C, es, B, mode, align, affine=False)
    ref = warp_flat_reference(flat, src, grid, align_corners=align, **kw)
    if mode == "nearest":
        assert torch.equal(got, ref)
    else:
        assert _max_rel_err(got, ref) <= WARP_RTOL[dtype]
    if theta is None:
        return
    want = warp_brick_paths(src, grid, C, es, B, mode, align)
    assert want[0] > 0 if paths in ("staged", "both") else want[0] == 0
    assert want[1] > 0 if paths in ("global", "both") else want[1] == 0
    with brick_paths() as counts:
        same = warp_affine_flat(flat, src, theta, out, **kw)
        torch.cuda.synchronize()
        assert tuple(counts.tolist()) == want
    assert torch.equal(same, got)


@pytest.mark.cuda
def test_warp_affine_broadcasts_one_theta(cuda_device):
    rng = np.random.default_rng(13)
    flat = torch.from_numpy(rng.normal(size=(3, 2, 8 * 12 * 16))
                            .astype(np.float32)).to(cuda_device)
    theta = torch.from_numpy((np.eye(3, 4)[None] + 0.1 * rng.normal(
        size=(1, 3, 4))).astype(np.float32)).to(cuda_device)
    got = warp_affine_flat(flat, (8, 12, 16), theta, (8, 12, 16))
    ref = warp_affine_flat(flat, (8, 12, 16), theta.expand(3, 3, 4)
                           .contiguous(), (8, 12, 16))
    assert torch.equal(got, ref)


# Channel counts that are not a multiple of the wgmma routes' K step (16
# bf16, 8 f32), zero-padded onto them: the 12-channel stem of a MIND model
# (forced there: its shapes choose "few") and a ragged C = 20 (padded by
# choice).  (N, depth, H, W, C, CO)
PADDED_CASES = {
    "mind_stem_c12": (8, 4, 19, 37, 12, 32),
    "ragged_c20": (6, 3, 11, 13, 20, 40),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PADDED_CASES))
def test_padded_channels_on_wgmma_routes_match_plain(cuda_device, dtype,
                                                     case):
    """Forward and weight gradient of a C that the routes pad, each one
    launch on the type's wgmma route, at the routes' tolerances."""
    N, D, H, W, C, CO = PADDED_CASES[case]
    dt = getattr(torch, dtype)
    route, counter = (("wgmma", "wgmma_launches") if dtype == "bfloat16"
                      else ("wgmma_tf32x3", "tf32x3_launches"))
    chosen = conv3x3_route(C, CO, dt)
    assert chosen == conv3x3_wgrad_route(C, CO, dt) == (
        "few" if C < 16 else route)
    forced = route if chosen == "few" else None
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, C, CO))
                          * (2.0 / (27 * C)) ** 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    x, w, dy = (t.to(cuda_device, dt) for t in (x, w, dy))
    before = (conv3x3.launches, getattr(conv3x3, counter),
              conv3x3.padded_launches)
    got = conv3x3(x, w, depth=D, route=forced)
    torch.cuda.synchronize()
    assert (conv3x3.launches, getattr(conv3x3, counter),
            conv3x3.padded_launches) == tuple(n + 1 for n in before)
    assert got.dtype == dt and got.shape == (N, H, W, CO)
    assert _max_rel_err(got, conv3x3_reference(x, w, depth=D)) <= RTOL[dtype]
    before = (conv3x3_wgrad.launches, getattr(conv3x3_wgrad, counter),
              conv3x3_wgrad.padded_launches)
    dw = conv3x3_wgrad(x, dy, depth=D, route=forced)
    torch.cuda.synchronize()
    assert (conv3x3_wgrad.launches, getattr(conv3x3_wgrad, counter),
            conv3x3_wgrad.padded_launches) == tuple(n + 1 for n in before)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, 3, C, CO)
    assert dw.is_contiguous()
    ref = conv3x3_wgrad_reference(x, dy, depth=D)
    assert _max_rel_err(dw, ref) <= 1e-4


# The "few" route (1 < C < 16, CO % 8 == 0, either type): (N, depth, H, W,
# C, CO, kz).  Ragged planes leave every tile part empty (bf16: 4 x 64
# forward, 8 x 16 weight gradient; f32: 16 x 16 and 6 x 8); every kernel
# stages its planes into a ring by cp.async, in 16-, 8- or 4-byte units
# (C = 3 and 15 odd: bf16 element by element); C = 15 is the most the
# route takes (f32 forward: 16-channel pixels, K = 48 a row of taps; f32
# weight gradient: three m64 tiles of (ky, kx, ci) rows, two a block, so a
# second block row); CO = 40 takes two 32-channel tiles, the second part
# empty; the stem's plane size (112 x 128) at two volumes of 16 planes, and
# the stem's own shape (one volume of 112 planes), both with enough
# positions to split the weight gradient.
FEW_CASES = {
    "mind_stem": (8, 4, 19, 37, 12, 32, 3),
    "stem_one_z_tap": (6, 3, 11, 21, 12, 32, 1),
    "depth1": (4, 1, 7, 9, 12, 32, 3),
    "c2": (4, 2, 9, 17, 2, 8, 3),
    "c3_odd": (6, 3, 13, 20, 3, 16, 3),
    "c8_co40": (4, 2, 10, 18, 8, 40, 3),
    "c15": (6, 2, 9, 33, 15, 24, 3),
    "c15_one_z_tap": (4, 2, 6, 17, 15, 8, 1),
    "stem_planes": (32, 16, 112, 128, 12, 32, 3),
    "stem_shape": (112, 112, 112, 128, 12, 32, 3),
}


def _few_inputs(case, seed, dtype, device):
    N, D, H, W, C, CO, kz = FEW_CASES[case]
    assert conv3x3_route(C, CO, dtype) == "few"
    assert conv3x3_wgrad_route(C, CO, dtype) == "few"
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(kz, 3, 3, C, CO))
                          * (2.0 / (27 * C)) ** 0.5).astype(np.float32))
    if kz == 1:
        w = w[0]
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    return [t.to(device, dtype) for t in (x, w, dy)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FEW_CASES))
def test_conv3x3_few_matches_plain(cuda_device, dtype, case):
    dt = getattr(torch, dtype)
    x, w, _ = _few_inputs(case, 14, dt, cuda_device)
    depth = FEW_CASES[case][1]
    before = (conv3x3.launches, conv3x3.few_launches,
              conv3x3.padded_launches)
    got = conv3x3(x, w, depth=depth)
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3.few_launches,
            conv3x3.padded_launches) == (before[0] + 1, before[1] + 1,
                                         before[2])
    assert got.dtype == dt and got.shape == (*x.shape[:3], w.shape[-1])
    assert _max_rel_err(got, conv3x3_reference(x, w, depth=depth)) \
        <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FEW_CASES))
def test_wgrad_few_matches_plain(cuda_device, dtype, case):
    dt = getattr(torch, dtype)
    x, _, dy = _few_inputs(case, 15, dt, cuda_device)
    N, D, H, W, C, CO, kz = FEW_CASES[case]
    before = (conv3x3_wgrad.launches, conv3x3_wgrad.few_launches,
              conv3x3_wgrad.padded_launches)
    got = conv3x3_wgrad(x, dy, depth=D, kz=kz)
    torch.cuda.synchronize()
    assert (conv3x3_wgrad.launches, conv3x3_wgrad.few_launches,
            conv3x3_wgrad.padded_launches) == (before[0] + 1, before[1] + 1,
                                               before[2])
    assert got.dtype == torch.float32 and got.shape == (kz, 3, 3, C, CO)
    ref = conv3x3_wgrad_reference(x, dy, depth=D, kz=kz)
    assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_few_route_rejects_misaligned_or_non_contiguous(cuda_device, dtype):
    """cp.async copies 16-byte units of dy (and of x where C allows): a
    view that starts off a 16-byte boundary raises before any launch, and
    so does a non-contiguous x."""
    dt = getattr(torch, dtype)
    shape = (4, 6, 8, 12)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=dt, device=cuda_device)
    x = buf[1:n + 1].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.zeros((3, 3, 3, 12, 32), dtype=dt, device=cuda_device)
    dy = torch.zeros((4, 6, 8, 32), dtype=dt, device=cuda_device)
    before = (conv3x3.launches, conv3x3_wgrad.launches)
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3(x, w, depth=2)
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3_wgrad(x, dy, depth=2)
    dbuf = torch.zeros(dy.numel() + 8, dtype=dt, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3_wgrad(x.contiguous().clone(),
                      dbuf[1:dy.numel() + 1].view(dy.shape), depth=2)
    strided = torch.zeros(4, 6, 16, 12, dtype=dt, device=cuda_device)[:, :,
                                                                      ::2]
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(strided, w, depth=2)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_wgrad(strided, dy, depth=2)
    assert (conv3x3.launches, conv3x3_wgrad.launches) == before


@pytest.mark.cuda
def test_few_conv_autograd_on_card_matches_cpu(cuda_device):
    """`conv3x3_op` at a MIND stem's channels, 12 -> 32, forward and both
    gradients on the card (the forward and weight gradient on "few", the
    input gradient, 32 -> 12 with CO % 8 != 0, on "cuda_core") against the
    CPU: f32, 1e-4 of each range."""
    rng = np.random.default_rng(16)
    N, D, H, W, C, CO = 8, 4, 13, 22, 12, 32
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, C, CO)) * 0.1)
                         .astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        xd = x.detach().to(dev).requires_grad_(True)
        wd = w.detach().to(dev).requires_grad_(True)
        before = (conv3x3.few_launches, conv3x3_wgrad.few_launches)
        y = conv3x3_op(xd, wd, depth=D)
        (y * ct.to(dev)).sum().backward()
        moved = (conv3x3.few_launches - before[0],
                 conv3x3_wgrad.few_launches - before[1])
        assert moved == ((0, 0) if dev == "cpu" else (1, 1))
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    for ref, got in zip(*outs):
        assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
def test_gin_aug_on_card_is_full_f32_under_cudnn_tf32(cuda_device,
                                                      monkeypatch):
    """GIN's grouped conv runs in cuDNN with TF32 off even where the
    caller leaves `torch.backends.cudnn.allow_tf32 = True` (PyTorch's
    default): the card equals the CPU's full f32 to 1e-5 of the range
    (TF32 would miss by ~1e-3), and the flag is restored afterwards."""
    from dg_tta_tpu_torch.ops.gin import draw_gin, gin_aug

    x = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2, 40, 48, 56, 1)).astype(np.float32))
    draws = draw_gin(torch.Generator().manual_seed(0), 2, 1)
    ref = gin_aug(x, draws)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    got = gin_aug(x.to(cuda_device), draws).cpu()
    assert torch.backends.cudnn.allow_tf32 is True
    assert _max_rel_err(got, ref) <= 1e-5


@pytest.mark.cuda
def test_mind3d_on_card_matches_cpu(cuda_device):
    """MIND with noise on a batch of 2, card against CPU: 1e-5 of the
    range (channel and batch means summed in another order, then exp)."""
    from dg_tta_tpu_torch.ops.mind import mind3d

    rng = np.random.default_rng(14)
    img = torch.from_numpy(rng.normal(size=(2, 40, 48, 56, 1))
                           .astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(2, 40, 48, 56, 12))
                             .astype(np.float32))
    ref = mind3d(img, noise=noise)
    got = mind3d(img.to(cuda_device), noise=noise.to(cuda_device)).cpu()
    assert got.shape == ref.shape == (2, 40, 48, 56, 12)
    assert _max_rel_err(got, ref) <= 1e-5


def _near_identity_grid(rng, B, out_spatial, align_corners, device):
    """identity + a random displacement (independent per voxel, std 0.075,
    shifted by 0.05), reaching past the edges."""
    from dg_tta_tpu_torch.core.grid import identity_grid

    ident = identity_grid(out_spatial, align_corners)
    return tuple((i[None] + torch.from_numpy(
        0.15 * rng.normal(size=(B, *out_spatial)).astype(np.float32))
        * 0.5 + 0.05).to(device) for i in ident)


# The exact adjoint's cases, as (C, source, output): C = 1 (8-deep bricks),
# 3 and 4 (4-deep), 12 (its box taken in passes of channels); W % 4 != 0
# (scalar flushes) and == 0 (16-byte flushes).
ADJOINT_CASES = [
    (1, (19, 13, 37), (19, 13, 37)),    # ragged, endomorphic
    (4, (9, 14, 11), (6, 17, 23)),      # not endomorphic
    (3, (12, 16, 40), (12, 16, 40)),
    (12, (10, 12, 20), (10, 12, 20)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("C,src,out", ADJOINT_CASES)
def test_warp_adjoint_kernel_matches_plain(cuda_device, dtype, padding_mode,
                                           align_corners, C, src, out):
    """The grid entry of the exact adjoint within WARP_RTOL of its plain
    version, its bricks by path as `warp_brick_paths(adjoint=True)`
    predicts."""
    from dg_tta_tpu_torch.kernels.warp import brick_paths, warp_brick_paths

    rng = np.random.default_rng(30)
    B = 2
    dt = getattr(torch, dtype)
    g = torch.from_numpy(rng.normal(size=(B, C, int(np.prod(out))))
                         .astype(np.float32)).to(cuda_device, dt)
    grid = _near_identity_grid(rng, B, out, align_corners, cuda_device)
    before = warp_flat_adjoint.launches
    with brick_paths() as counts:
        got = warp_flat_adjoint(g, src, grid, padding_mode, align_corners)
        torch.cuda.synchronize()
        assert tuple(counts.tolist()) == warp_brick_paths(
            src, grid, C, 4, B, align_corners=align_corners, adjoint=True)
    assert warp_flat_adjoint.launches == before + 1
    ref = warp_flat_adjoint_reference(g, src, grid, padding_mode,
                                      align_corners)
    assert got.dtype == dt and got.shape == (B, C, int(np.prod(src)))
    assert _max_rel_err(got, ref) <= WARP_RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("C,src,out", ADJOINT_CASES)
def test_warp_affine_adjoint_kernel_matches_plain(cuda_device, dtype,
                                                  padding_mode, C, src, out):
    """The affine entry of the exact adjoint (theta reaching outside the
    source) within WARP_RTOL of its plain version and of the grid entry on
    the card's `affine_grid`, its bricks by path as predicted."""
    from dg_tta_tpu_torch.core.grid import affine_grid
    from dg_tta_tpu_torch.kernels.warp import (brick_paths,
                                               warp_affine_adjoint_reference,
                                               warp_affine_flat_adjoint,
                                               warp_brick_paths)

    rng = np.random.default_rng(34)
    B = 2
    dt = getattr(torch, dtype)
    g = torch.from_numpy(rng.normal(size=(B, C, int(np.prod(out))))
                         .astype(np.float32)).to(cuda_device, dt)
    theta = torch.from_numpy((np.eye(3, 4)[None] + 0.12 * rng.normal(
        size=(B, 3, 4))).astype(np.float32)).to(cuda_device)
    grid = affine_grid(theta, out)
    before = (warp_affine_flat_adjoint.launches, warp_flat_adjoint.launches)
    with brick_paths() as counts:
        got = warp_affine_flat_adjoint(g, src, theta, out, padding_mode)
        torch.cuda.synchronize()
        assert tuple(counts.tolist()) == warp_brick_paths(
            src, grid, C, 4, B, adjoint=True)
    assert (warp_affine_flat_adjoint.launches, warp_flat_adjoint.launches) \
        == (before[0] + 1, before[1])
    ref = warp_affine_adjoint_reference(g, src, theta, out, padding_mode)
    assert got.dtype == dt and got.shape == (B, C, int(np.prod(src)))
    assert _max_rel_err(got, ref) <= WARP_RTOL[dtype]
    same = warp_flat_adjoint(g, src, grid, padding_mode)
    assert _max_rel_err(got, same) <= WARP_RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_adjoint_strong_grid_takes_the_global_path(cuda_device, dtype):
    """A random grid whose boxes do not all fit the buffer: the bricks that
    overflow add into dx by global atomics, the others sum in shared
    memory, each counted by path as predicted, and the sums agree with
    the plain version."""
    from dg_tta_tpu_torch.core.grid import identity_grid
    from dg_tta_tpu_torch.kernels.warp import brick_paths, warp_brick_paths

    rng = np.random.default_rng(35)
    C, B, src = 4, 2, (24, 40, 64)
    grid = tuple((i[None] + torch.from_numpy(rng.normal(
        0.0, 0.2, size=(B, *src)).astype(np.float32))).to(cuda_device)
        for i in identity_grid(src))
    g = torch.from_numpy(rng.normal(size=(B, C, int(np.prod(src))))
                         .astype(np.float32)).to(cuda_device,
                                                 getattr(torch, dtype))
    want = warp_brick_paths(src, grid, C, 4, B, adjoint=True)
    assert want[0] > 0 and want[1] > 0
    with brick_paths() as counts:
        got = warp_flat_adjoint(g, src, grid)
        torch.cuda.synchronize()
        assert tuple(counts.tolist()) == want
    ref = warp_flat_adjoint_reference(g, src, grid)
    assert _max_rel_err(got, ref) <= WARP_RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_warp_affine_adjoint_corners_equal_grid_entry(cuda_device, dtype,
                                                      padding_mode):
    """A one-hot g whose nonzero outputs lie 4 apart on every axis and 6
    from every face, so that under a TTA draw no two share a corner and no
    corner is clamped: every voxel of dx is one product, and the affine
    entry equals the grid entry on the card's `affine_grid` bit for bit
    (the same corners and weights), in every channel."""
    from dg_tta_tpu_torch.core.fields import get_rand_affine
    from dg_tta_tpu_torch.core.grid import affine_grid
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_adjoint_reference,
                                               warp_affine_flat_adjoint)

    rng = np.random.default_rng(36)
    C, B, size = 4, 2, (40, 48, 96)
    _, theta = get_rand_affine(torch.from_numpy(
        rng.normal(size=(B, 3, 4)).astype(np.float32)))
    theta = theta.to(cuda_device)
    lattice = (slice(None), slice(None)) + (slice(6, -6, 4),) * 3
    g = np.zeros((B, C, *size), np.float32)
    g[lattice] = rng.normal(size=g[lattice].shape)
    g = torch.from_numpy(g.reshape(B, C, -1)).to(cuda_device,
                                                 getattr(torch, dtype))
    got = warp_affine_flat_adjoint(g, size, theta, size, padding_mode)
    same = warp_flat_adjoint(g, size, affine_grid(theta, size), padding_mode)
    assert torch.equal(got, same)
    assert (got != 0).sum() == 8 * C * B * 7 * 9 * 21
    ref = warp_affine_adjoint_reference(g, size, theta, size, padding_mode)
    assert _max_rel_err(got, ref) <= WARP_RTOL[dtype]


@pytest.mark.cuda
def test_warp_affine_op_backward_on_card_matches_cpu(cuda_device):
    """The affine entry through autograd: the forward on the affine entry,
    the backward on the affine adjoint, against the same Function on the
    CPU (plain versions)."""
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat_adjoint,
                                               warp_affine_op)

    rng = np.random.default_rng(37)
    src = (12, 16, 20)
    n = int(np.prod(src))
    x = torch.from_numpy(rng.normal(size=(1, 4, n)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(1, 4, n)).astype(np.float32))
    theta = torch.from_numpy((np.eye(3, 4)[None] + 0.1 * rng.normal(
        size=(1, 3, 4))).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        xd = x.detach().to(dev).requires_grad_(True)
        counts = (warp_affine_flat.launches,
                  warp_affine_flat_adjoint.launches)
        y = warp_affine_op(xd, src, theta.to(dev), src)
        (y * ct.to(dev)).sum().backward()
        outs.append((y.detach().cpu(), xd.grad.cpu(),
                     (warp_affine_flat.launches - counts[0],
                      warp_affine_flat_adjoint.launches - counts[1])))
    (y0, g0, c0), (y1, g1, c1) = outs
    assert c0 == (0, 0) and c1 == (1, 1)
    assert _max_rel_err(y1, y0) <= 1e-5
    assert _max_rel_err(g1, g0) <= 1e-5


@pytest.mark.cuda
def test_warp_flat_op_backward_on_card_matches_cpu(cuda_device):
    """The grid entry through autograd: the forward on the grid entry, the
    backward on the adjoint kernel, against the same Function on the CPU
    (plain versions)."""
    rng = np.random.default_rng(31)
    src = (12, 16, 20)
    n = int(np.prod(src))
    x = torch.from_numpy(rng.normal(size=(1, 4, n)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(1, 4, n)).astype(np.float32))
    grid = _near_identity_grid(rng, 1, src, False, "cpu")
    outs = []
    for dev in ("cpu", cuda_device):
        xd = x.detach().to(dev).requires_grad_(True)
        counts = (warp_flat.launches, warp_flat_adjoint.launches)
        y = warp_flat_op(xd, src, tuple(c.to(dev) for c in grid))
        (y * ct.to(dev)).sum().backward()
        outs.append((y.detach().cpu(), xd.grad.cpu(),
                     (warp_flat.launches - counts[0],
                      warp_flat_adjoint.launches - counts[1])))
    (y0, g0, c0), (y1, g1, c1) = outs
    assert c0 == (0, 0) and c1 == (1, 1)
    assert _max_rel_err(y1, y0) <= 1e-5
    assert _max_rel_err(g1, g0) <= 1e-5


@pytest.mark.cuda
def test_disp_field_on_card_matches_cpu(cuda_device):
    """`get_disp_field` at the engine's settings on a 30 x 40 x 50 patch
    from one noise tensor: its ten field warps on the grid entry, card
    against CPU."""
    from dg_tta_tpu_torch.core.fields import get_disp_field

    size = (30, 40, 50)
    noise = torch.from_numpy(np.random.default_rng(32).normal(
        size=(1, 6, 8, 10, 3)).astype(np.float32))
    ref = get_disp_field(noise, size, factor=0.5, interpolation_factor=5)
    before = warp_flat.launches
    got = get_disp_field(noise.to(cuda_device), size, factor=0.5,
                         interpolation_factor=5)
    torch.cuda.synchronize()
    assert warp_flat.launches == before + 10
    for got_f, ref_f in zip(got, ref):
        for a, b in zip(got_f, ref_f):
            assert a.is_cuda and a.shape == (1, *size)
            assert _max_rel_err(a.cpu(), b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
def test_deformable_patch_step_on_card_matches_cpu(cuda_device, exact):
    """One deformable patch step of a tiny U-Net on a 30^3 patch, the
    same injected field noise on both devices, card against CPU: loss
    1e-4 relative and each gradient 1e-3 of its largest entry (f32
    rounding in another order through the fields, the warps and the
    network), and the kernels launched as counted: 12 grid-entry warps per
    branch, then the fast adjoints on the grid entry, or the exact ones."""
    import dataclasses

    from dg_tta_tpu_torch.core.patches import extract_batch
    from dg_tta_tpu_torch.models.network import Model
    from dg_tta_tpu_torch.models.plans import ArchSpec
    from dg_tta_tpu_torch.models.unet import init_unet_
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import make_tta_functions
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    spec = ArchSpec(features_per_stage=(8, 16), kernel_sizes=((3, 3, 3),) * 2,
                    strides=((1, 1, 1), (2, 2, 2)),
                    n_conv_per_stage_encoder=(1, 1),
                    n_conv_per_stage_decoder=(1,), num_input_channels=1,
                    num_classes=4)
    patch = (30, 30, 30)
    model = Model(spec=spec, patch_size=patch,
                  trainer_name="nnUNetTrainer_GIN", uses_gin_internal=True,
                  uses_mind=False)
    net0 = init_unet_(model.build_network(device="cpu"),
                      torch.Generator().manual_seed(0))
    rng = np.random.default_rng(33)
    vol = rng.normal(size=(1, 40, 44, 36, 1)).astype(np.float32) * 0.1
    vol[0, 10:25, 12:30, 8:24] += 2.0
    d = TorchDraws(seed=6).patch(0, 0, 0, 1, 1)
    noise = {k: torch.from_numpy(rng.normal(size=(1, 6, 6, 6, 3))
                                 .astype(np.float32))
             for k in ("field_a", "field_b")}
    d = dataclasses.replace(d, **{
        k: (lambda shape, device, n=n: n.to(device))
        for k, n in noise.items()})
    fns = make_tta_functions(model, TTAPlan(spatial_aug_type="deformable"),
                             np.arange(3), np.arange(3),
                             exact_warp_grad=exact)
    out = []
    for dev in ("cpu", cuda_device):
        net = copy.deepcopy(net0).to(dev)
        imgs, _ = extract_batch(d.vol_idx, d.uniforms,
                                torch.from_numpy(vol).to(dev),
                                [[40.0, 44.0, 36.0]], patch, 1)
        counts = (warp_flat.launches, warp_flat_adjoint.launches)
        loss = fns.patch_loss(net, d, imgs)
        loss.backward()
        out.append((loss.item(), {n: p.grad.cpu() for n, p in
                                  net.named_parameters()
                                  if p.grad is not None},
                    (warp_flat.launches - counts[0],
                     warp_flat_adjoint.launches - counts[1])))
    (l0, g0, c0), (l1, g1, c1) = out
    assert c0 == (0, 0)
    assert c1 == ((24, 2) if exact else (26, 0))
    assert l0 > 1e-3 and abs(l1 - l0) <= 1e-4 * l0
    assert sorted(g0) == sorted(g1)
    for name, ref in g0.items():
        assert _max_rel_err(g1[name], ref) <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("out", [(8, 8, 8), (56, 56, 64), (28, 28, 32),
                                 (14, 14, 16)])
def test_downsample_target_kernel_equals_plain(cuda_device, out):
    """The deep-supervision targets on the warp's grid entry, bit for bit
    the plain version's: every sample of a stride-2 scale lies on a
    rounding tie, which both break half to even on the same f32 point."""
    from dg_tta_tpu_torch.train.losses import downsample_target

    src = tuple(2 * n for n in out)
    t = torch.randint(0, 105, (2, *src),
                      generator=torch.Generator().manual_seed(0))
    n = warp_flat.launches
    got = downsample_target(t.to(cuda_device), out).cpu()
    assert warp_flat.launches == n + 1
    assert torch.equal(got, downsample_target(t, out))


@pytest.mark.cuda
@pytest.mark.parametrize("multires", [False, True])
def test_augment_batch_warps_on_card_match_cpu(cuda_device, multires):
    """The pretraining augmentation with every gate on, card against CPU
    on the same draws: the labels (the affine entry, nearest) bit for bit,
    the image (the affine entry, the grid entry's low-resolution pass or
    MultiRes's operators, blur, gamma) to 1e-5 of its range."""
    import dataclasses

    from dg_tta_tpu_torch.train.augment import (MULTIRES_ZOOMS, DAConfig,
                                                augment_batch, draw_sample)

    cfg = DAConfig(p_rotation=1.0, p_scale=1.0, p_noise=1.0, p_blur=1.0,
                   p_brightness=1.0, p_contrast=1.0, p_lowres=1.0,
                   p_gamma_invert=1.0, p_gamma=1.0,
                   discrete_lowres_zooms=MULTIRES_ZOOMS if multires
                   else None)
    shape = (40, 48, 56)
    g = torch.Generator().manual_seed(1)
    noise = torch.randn((*shape, 1), generator=g)
    draws = [dataclasses.replace(draw_sample(g, cfg, None),
                                 noise=lambda s, d: noise.to(d))
             for _ in range(2)]
    imgs = torch.randn((2, *shape, 1), generator=g)
    segs = torch.randint(0, 4, (2, *shape, 1), generator=g).float()
    n_affine, n_grid = warp_affine_flat.launches, warp_flat.launches
    got_i, got_s = augment_batch(draws, imgs.to(cuda_device),
                                 segs.to(cuda_device), cfg)
    assert warp_affine_flat.launches == n_affine + 2
    assert warp_flat.launches == n_grid + (0 if multires else 1)
    ref_i, ref_s = augment_batch(draws, imgs, segs, cfg)
    assert torch.equal(got_s.cpu(), ref_s)
    assert _max_rel_err(got_i.cpu(), ref_i) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,CO,H,W", [
    (1, 32, 19, 70),     # "c1"
    (12, 32, 19, 37),    # "few", the MIND stem
    (32, 32, 28, 32),    # the wgmma routes, big layout, several splits
    (64, 128, 7, 8),     # small layout, clusters
    (16, 36, 9, 11),     # "cuda_core" (CO % 8 != 0)
    (30, 30, 19, 37),    # "cuda_core", a ragged plan's width
    (60, 300, 7, 8),     # "cuda_core", five column tiles
])
def test_members_launch_equals_member_launches(cuda_device, dtype, C, CO,
                                               H, W):
    """Three members' weights in one launch of every route (forward, input
    gradient, weight gradient) give each member's planes the bits of that
    member's own launch, within the tolerances of the plain version, in
    one launch on every route."""
    from dg_tta_tpu_torch.kernels.conv3x3 import route_launches
    M, n, D = 3, 8, 4
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(C + CO)
    x = torch.from_numpy(rng.normal(size=(M * n, H, W, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(M, 3, 3, 3, C, CO))
                         .astype(np.float32) / (27 * C) ** 0.5)
    dy = torch.from_numpy(rng.normal(size=(M * n, H, W, CO))
                          .astype(np.float32))
    x, w, dy = (t.to(dt).to(cuda_device) for t in (x, w, dy))
    route = conv3x3_route(C, CO, dt)
    before = route_launches(conv3x3)[route]
    y = conv3x3(x, w, D)
    torch.cuda.synchronize()
    assert route_launches(conv3x3)[route] - before == 1
    ys = torch.cat([conv3x3(xm, wm, D) for xm, wm in zip(x.chunk(M), w)])
    assert torch.equal(y, ys)
    assert _max_rel_err(y, conv3x3_reference(x, w, D)) <= RTOL[dtype]
    wt = w.flip((1, 2, 3)).transpose(-2, -1).contiguous()
    dx = conv3x3(dy, wt, D)
    assert torch.equal(dx, torch.cat([conv3x3(dm, wm, D) for dm, wm in
                                      zip(dy.chunk(M), wt)]))
    before = route_launches(conv3x3_wgrad)[route]
    dw = conv3x3_wgrad(x, dy, D, members=M)
    torch.cuda.synchronize()
    assert route_launches(conv3x3_wgrad)[route] - before == 1
    assert dw.shape == (M, 3, 3, 3, C, CO)
    assert torch.equal(dw, torch.stack([
        conv3x3_wgrad(xm, dm, D) for xm, dm in zip(x.chunk(M),
                                                   dy.chunk(M))]))
    ref = conv3x3_wgrad_reference(x, dy, D, members=M)
    assert _max_rel_err(dw, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_members_conv_op_gradients_equal_member_ops(cuda_device, dtype):
    """`conv3x3_op` on members' stacked weights: each member's output, input
    gradient and weight gradient bit for bit its own op's on the card."""
    M, n, D, H, W, C, CO = 3, 8, 4, 28, 32, 32, 64
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(M * n, H, W, C, generator=g).to(dt).to(cuda_device)
    w = (torch.randn(M, 3, 3, 3, C, CO, generator=g) / 30).to(dt)
    w = w.to(cuda_device)
    dy = torch.randn(M * n, H, W, CO, generator=g).to(dt).to(cuda_device)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = conv3x3_op(xg, wg, D)
    y.backward(dy)
    for m in range(M):
        xm = x.chunk(M)[m].clone().requires_grad_()
        wm = w[m].clone().requires_grad_()
        ym = conv3x3_op(xm, wm, D)
        ym.backward(dy.chunk(M)[m])
        assert torch.equal(y.chunk(M)[m], ym)
        assert torch.equal(xg.grad.chunk(M)[m], xm.grad)
        assert torch.equal(wg.grad[m], wm.grad)


# the catch-all route ("cuda_core", csrc/conv3x3.cu and conv3x3_wgrad.cu):
# every input and output channel count of a ragged plan and of a stem's
# input gradient, odd and ragged CO, cp.async granules of 2 (bf16 at odd
# C), 4, 8 and 16 bytes
RAGGED_C = [2, 5, 12, 30, 60, 300]
RAGGED_CO = [1, 7, 12, 30, 60, 300]


def _ragged_inputs(C, CO, kz, dtype, device, N=6, D=3, H=9, W=19, seed=0):
    rng = np.random.default_rng(seed + C * 1000 + CO)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(kz, 3, 3, C, CO))
                          / (9 * kz * C) ** 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, H, W, CO)).astype(np.float32))
    return (t.to(dt).to(device) for t in (x, w, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kz", [1, 3])
@pytest.mark.parametrize("C", RAGGED_C)
@pytest.mark.parametrize("CO", RAGGED_CO)
def test_cuda_core_ragged_matches_plain(cuda_device, dtype, kz, C, CO):
    """The forward and the weight gradient at every (C, CO) of the ragged
    sets, three planes a volume (both depth edges), a 9 x 19 plane (ragged
    16 x 16 and 8 x 16 tiles): f32 at the wgmma_tf32x3 route's tolerance,
    bf16 at one rounding."""
    from dg_tta_tpu_torch.kernels.conv3x3 import route_launches
    x, w, dy = _ragged_inputs(C, CO, kz, dtype, cuda_device)
    assert conv3x3_route(C, CO, x.dtype) == "cuda_core"
    before = route_launches(conv3x3)["cuda_core"]
    y = conv3x3(x, w, depth=3)
    torch.cuda.synchronize()
    assert route_launches(conv3x3)["cuda_core"] == before + 1
    assert _max_rel_err(y, conv3x3_reference(x, w, depth=3)) <= RTOL[dtype]
    before = route_launches(conv3x3_wgrad)["cuda_core"]
    dw = conv3x3_wgrad(x, dy, depth=3, kz=kz)
    torch.cuda.synchronize()
    assert route_launches(conv3x3_wgrad)["cuda_core"] == before + 1
    ref = conv3x3_wgrad_reference(x, dy, depth=3, kz=kz)
    assert _max_rel_err(dw, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,CO,D,H,W", [
    (1, 32, 8, 33, 70),     # a "c1" shape
    (12, 32, 6, 19, 37),    # a "few" shape, the MIND stem
    (32, 64, 4, 28, 32),    # a wgmma shape
    (320, 320, 8, 7, 8),    # the TS104 bottleneck
    (30, 30, 1, 40, 40),    # depth 1: no z-neighbours
])
def test_cuda_core_forced_matches_plain(cuda_device, dtype, C, CO, D, H, W):
    """Shapes of the other routes forced onto the catch-all kernels, as
    chip_smoke and obs/conv_times.py time them."""
    x, w, dy = _ragged_inputs(C, CO, 3, dtype, cuda_device, N=2 * D, D=D,
                              H=H, W=W)
    y = conv3x3(x, w, depth=D, route="cuda_core")
    assert _max_rel_err(y, conv3x3_reference(x, w, depth=D)) <= RTOL[dtype]
    dw = conv3x3_wgrad(x, dy, depth=D, route="cuda_core")
    ref = conv3x3_wgrad_reference(x, dy, depth=D)
    assert _max_rel_err(dw, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,CO", [(30, 30), (60, 300), (5, 7)])
def test_cuda_core_is_deterministic(cuda_device, dtype, C, CO):
    """Two weight-gradient launches equal bit for bit (each volume's splits
    summed in a fixed order, no atomics), at a shape with many splits; and
    two forwards."""
    from dg_tta_tpu_torch.kernels.conv3x3 import cuda_core_wgrad_plan
    x, w, dy = _ragged_inputs(C, CO, 3, dtype, cuda_device, N=32, D=16,
                              H=40, W=48)
    assert cuda_core_wgrad_plan(16, 40, 48, C, CO, x.dtype)["splits"] > 1
    assert torch.equal(conv3x3_wgrad(x, dy, depth=16),
                       conv3x3_wgrad(x, dy, depth=16))
    assert torch.equal(conv3x3(x, w, depth=16), conv3x3(x, w, depth=16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_core_offset_views_and_grouped_volumes(cuda_device, dtype):
    """A member's planes as a view at an odd element offset (the granule
    narrows to what the address allows) give the bits of an aligned copy;
    the weight gradient of two volumes in one launch is the sum of each
    volume's partials, the same partials a launch of each computes."""
    x, w, dy = _ragged_inputs(30, 30, 3, dtype, cuda_device, N=6, D=3)
    big = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    xo = big[1:].view(x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16
    assert torch.equal(conv3x3(xo, w, depth=3), conv3x3(x, w, depth=3))
    both = conv3x3_wgrad(x, dy, depth=3)
    one = conv3x3_wgrad(x[:3], dy[:3], depth=3)
    two = conv3x3_wgrad(x[3:].contiguous(), dy[3:].contiguous(), depth=3)
    ref = conv3x3_wgrad_reference(x, dy, depth=3)
    assert _max_rel_err(both, ref) <= 1e-4
    assert _max_rel_err(one + two, both) <= 1e-6


@pytest.mark.cuda
def test_cuda_core_never_takes_the_plain_version(cuda_device, monkeypatch):
    """A CUDA tensor launches the kernel: the plain versions are not called,
    and a launch the kernel refuses raises."""
    from dg_tta_tpu_torch.kernels import conv3x3 as mod

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(mod, "conv3x3_reference", refuse)
    monkeypatch.setattr(mod, "conv3x3_wgrad_reference", refuse)
    x, w, dy = _ragged_inputs(30, 30, 3, "float32", cuda_device)
    mod.conv3x3(x, w, depth=3)
    mod.conv3x3_wgrad(x, dy, depth=3)
    # a column tile the C entry does not take
    monkeypatch.setattr(mod, "cuda_core_plan",
                        lambda *a, **k: dict(bn=48, splits=1, per_split=12))
    with pytest.raises(RuntimeError, match="launch failed"):
        mod.conv3x3(x, w, depth=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,kz,C,CO", [(1, 3, 30, 30), (3, 1, 5, 1),
                                       (2, 3, 12, 300), (1, 3, 300, 60)])
def test_cuda_core_pack_kernel_matches_plain(cuda_device, dtype, M, kz, C,
                                             CO):
    """The forward's pack kernel writes the bits of its plain version
    (`pack_cuda_core_weights` on the CPU) at every column tile."""
    from dg_tta_tpu_torch.kernels.conv3x3 import (_CC_BN,
                                                  pack_cuda_core_weights)
    g = torch.Generator().manual_seed(C + CO)
    w = torch.randn((M, kz, 3, 3, C, CO), generator=g).to(getattr(torch,
                                                                  dtype))
    for bn in _CC_BN:
        got = pack_cuda_core_weights(w.to(cuda_device), bn)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), pack_cuda_core_weights(w, bn)), bn


@pytest.mark.cuda
def test_cuda_core_failed_build_raises(cuda_device, monkeypatch, tmp_path):
    """A source that does not compile raises at first use; no other kernel
    or plain version takes its place."""
    from dg_tta_tpu_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "conv3x3.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_FUNCTIONS", {})
    x, w, _ = _ragged_inputs(30, 30, 3, "float32", cuda_device)
    with pytest.raises(RuntimeError, match="build failed"):
        conv3x3(x, w, depth=3)
