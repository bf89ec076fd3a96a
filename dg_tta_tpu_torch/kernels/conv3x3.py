"""NHWC 3x3 stride-1 pad-1 convolution: the Hopper kernel and its plain
version.

Replaces `dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas`.  With `w` of
shape (3, 3, C, CO) it computes that kernel's function: a torch-padded 3x3
conv of each (H, W, C) plane.  With `w` of shape (3, 3, 3, C, CO) one launch
also sums the three z-taps that `dg_tta_tpu/models/unet.py::_conv` adds up
for every stride-1 3x3x3 conv: `x` is then a (B*depth, H, W, C) view of a
(B, depth, H, W, C) volume, and plane n's z-tap kz reads plane n + kz - 1
of the same volume (zeros past its ends).  One launch per 3D conv keeps
the z-tap partial sums in registers instead of three output passes.

The CUDA source (`csrc/conv3x3.cu`) says what bounds it on an H100 and
what its design does about that.  f32 or bf16 in, f32 accumulation, output
in the input's type.

`conv3x3` launches the kernel for CUDA tensors, or raises; it runs
`conv3x3_reference` only for tensors on the CPU.  `conv3x3.launches` counts
the kernel's launches.
"""

import ctypes

import torch
import torch.nn.functional as F

from dg_tta_tpu_torch.kernels import build

SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3.cu"
REPLACES = "dg_tta_tpu/ops/conv2d_pallas.py:99"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _as_5d(w: torch.Tensor) -> torch.Tensor:
    return w.unsqueeze(0) if w.dim() == 4 else w


def _check(x: torch.Tensor, w: torch.Tensor, depth: int):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if w.dim() not in (4, 5):
        raise ValueError(f"w must be (3, 3, C, CO) or (3, 3, 3, C, CO), "
                         f"got {tuple(w.shape)}")
    w5 = _as_5d(w)
    if tuple(w5.shape[:3]) not in ((1, 3, 3), (3, 3, 3)) \
            or w5.shape[3] != x.shape[3]:
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if depth < 1 or x.shape[0] % depth:
        raise ValueError(f"depth {depth} does not divide N={x.shape[0]}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16, got "
                         f"{x.dtype} and {w.dtype}")
    return w5


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      depth: int = 1) -> torch.Tensor:
    """Plain PyTorch version: `F.conv2d` (one z-tap) or `F.conv3d` (three)
    on channels-first views, computed in f32 and cast to x's type."""
    w5 = _check(x, w, depth)
    N, H, W, C = x.shape
    CO = w5.shape[-1]
    if w5.shape[0] == 1:
        y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                     w5[0].permute(3, 2, 0, 1).float(), padding=1)
        y = y.permute(0, 2, 3, 1)
    else:
        x5 = x.reshape(N // depth, depth, H, W, C).permute(0, 4, 1, 2, 3)
        y = F.conv3d(x5.float(), w5.permute(4, 3, 0, 1, 2).float(), padding=1)
        y = y.permute(0, 2, 3, 4, 1).reshape(N, H, W, CO)
    return y.to(x.dtype).contiguous()


def _launch(x, w5, y, depth):
    lib = build.load("conv3x3")
    fn = lib.dgtta_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    N, H, W, C = x.shape
    err = fn(x.data_ptr(), w5.data_ptr(), y.data_ptr(), N, depth, H, W, C,
             w5.shape[-1], w5.shape[0], _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed with CUDA error "
                           f"{err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w5.shape)}, depth {depth}")


def conv3x3(x: torch.Tensor, w: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """y[n,h,w,co] = sum_{kz,ky,kx,ci} x[n+kz-KZ//2, h+ky-1, w+kx-1, ci]
    * w[kz,ky,kx,ci,co], zero-padded in H, W and within each group of
    `depth` planes; KZ = 1 for a (3, 3, C, CO) `w`, 3 for (3, 3, 3, C, CO).

    x: (N, H, W, C), N a multiple of depth.  Returns (N, H, W, CO) in x's
    type.  CPU tensors take the plain version; CUDA tensors the kernel.
    """
    w5 = _check(x, w, depth)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_reference(x, w, depth)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x and w must lie on one CUDA device or both on "
                         f"the CPU, got {x.device} and {w.device}")
    if not (x.is_contiguous() and w5.is_contiguous()):
        raise ValueError("conv3x3 needs contiguous x and w")
    N, H, W, _ = x.shape
    y = torch.empty((N, H, W, w5.shape[-1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch(x, w5, y, depth)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


def conv3x3_flops(x_shape, w_shape, depth: int = 1) -> int:
    """Operations (2 per multiply-add) that one call needs.  A tap that
    falls past an edge reads only zero padding and is not counted: along an
    axis of n points there are 3 * n - 2 taps inside, in H, in W and, with
    three z-taps, in each volume of `depth` planes."""
    N, H, W, C = x_shape
    kz = 1 if len(w_shape) == 4 else w_shape[0]
    plane_taps = N if kz == 1 else (N // depth) * (3 * depth - 2)
    return 2 * (3 * H - 2) * (3 * W - 2) * C * w_shape[-1] * plane_taps
