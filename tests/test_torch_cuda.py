"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the `cuda` marker and skips without a GPU.  The
file imports neither JAX nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max |kernel - plain| over max |plain|, 5e-5 in f32 (the same
products summed in another order; TF32 off for the plain version) and
2^-7 in bf16 (both round one f32 sum to bf16).
"""

import numpy as np
import pytest
import torch

from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3, conv3x3_reference

RTOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}


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
