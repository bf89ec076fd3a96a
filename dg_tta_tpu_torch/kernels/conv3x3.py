"""NHWC 3x3 stride-1 pad-1 convolution: the Hopper kernels and their plain
version.

Replaces `dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas`.  With `w` of
shape (3, 3, C, CO) it computes that kernel's function: a torch-padded 3x3
conv of each (H, W, C) plane.  With `w` of shape (3, 3, 3, C, CO) one launch
also sums the three z-taps that `dg_tta_tpu/models/unet.py::_conv` adds up
for every stride-1 3x3x3 conv: `x` is then a (B*depth, H, W, C) view of a
(B, depth, H, W, C) volume, and plane n's z-tap kz reads plane n + kz - 1
of the same volume (zeros past its ends).  One launch per 3D conv keeps
the z-tap partial sums in registers instead of three output passes.

Five routes, each a CUDA source with its own C entry, chosen by
`conv3x3_route(C, CO, dtype)` from the call's shapes alone (no fallback:
a launch error raises, and a misaligned tensor raises before the launch):
* "c1" (`csrc/conv3x3_c1.cu`): C == 1, f32 and bf16, the first conv on
  the 1-channel image: the taps in the GEMM's K axis on the tensor cores
  (mma.sync; f32 as 3xTF32), the weights packed into that order by the
  kernel itself; bound by the bytes of y (forward) and dy (weight
  gradient);
* "few" (`csrc/conv3x3_few.cu`): 1 < C < 16 with CO % 8 == 0, f32
  (3xTF32) and bf16, the stem of a MIND model (C = 12): x read at its own
  C into a halo in shared memory, the taps in the GEMM's K axis, the
  weights packed once per call into that order (`pack_few_weights`);
* "wgmma" (`csrc/conv3x3_wgmma.cu`): bf16 with C >= 16 and CO % 8 == 0,
  an implicit GEMM on the tensor cores fed by TMA;
* "wgmma_tf32x3" (the same source, its f32 instantiation): f32 with
  C >= 16 and CO % 8 == 0, each product at f32 accuracy from three tf32
  products (3xTF32); the weights are split once per call into a tf32
  part and its remainder (`tf32_split`);
* "cuda_core" (`csrc/conv3x3.cu`): CO % 8 != 0; f32 FMAs on the CUDA
  cores.
The wgmma routes step 16 (bf16) or 8 (f32) input channels at a time: a
C that is not a multiple of the step (C = 20, say) runs on x and w
zero-padded to the next multiple (`route_channels`, `pad_channels`), and
the weight gradient drops the padded channels' rows.  A caller may force
the type's wgmma route onto a shape that chooses "few" (`route=`, to time
the two on one shape); the main path never does.  Every TS104 conv and
input gradient takes "c1" (the first conv of a 1-channel model), "few"
(the stem of a MIND model) or a wgmma route.  The sources say what bounds
each on an H100 and what the design does about it.  f32 accumulation,
output in the input's type.

`conv3x3` launches a kernel for CUDA tensors, or raises; it runs
`conv3x3_reference` only for tensors on the CPU.  `conv3x3.launches`
counts its launches on every route; `conv3x3.wgmma_launches`,
`conv3x3.tf32x3_launches`, `conv3x3.c1_launches` and
`conv3x3.few_launches` those on the "wgmma", "wgmma_tf32x3", "c1" and
"few" routes (`route_launches` gives them all, "cuda_core" included), and
`conv3x3.padded_launches` those that ran on zero-padded channels.

The backward, for TTA: `conv3x3_wgrad` is the weight gradient, with the
same five routes chosen by the same shapes (`conv3x3_wgrad_route`: "c1",
`csrc/conv3x3_c1.cu`; "few", `csrc/conv3x3_few.cu`, dy transposed and
split in shared memory in f32; "wgmma", `csrc/conv3x3_wgrad_wgmma.cu`,
for bf16; "wgmma_tf32x3", `csrc/conv3x3_wgrad_tf32x3.cu`, for f32,
3xTF32 with dy split and transposed by a pre-pass; "cuda_core",
`csrc/conv3x3_wgrad.cu`, for the other channel counts; plain version
`conv3x3_wgrad_reference`; counts `conv3x3_wgrad.launches`,
`.wgmma_launches`, `.tf32x3_launches`, `.c1_launches`, `.few_launches`
and `.padded_launches`).  The input gradient needs no
kernel of its own: it is the same zero-padded conv of dy with the weights
flipped in (kz, ky, kx) and their channel axes swapped, so it runs through
`conv3x3` again.  `Conv3x3Function` ties the three together as a
`torch.autograd.Function`; `conv3x3_op` applies it.
"""

import ctypes

import torch
import torch.nn.functional as F

from dg_tta_tpu_torch.kernels import build

SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3.cu"
WGRAD_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_wgrad.cu"
WGMMA_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_wgmma.cu"
WGRAD_WGMMA_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_wgrad_wgmma.cu"
WGRAD_TF32X3_SOURCE = \
    "dg_tta_tpu_torch/kernels/csrc/conv3x3_wgrad_tf32x3.cu"
C1_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_c1.cu"
FEW_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_few.cu"
REPLACES = "dg_tta_tpu/ops/conv2d_pallas.py:99"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# the tensor-core route of each type for C >= 16
_WGMMA_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "wgmma_tf32x3"}


def conv3x3_route(C: int, CO: int, dtype) -> str:
    """The kernel that runs `conv3x3` on CUDA tensors of C input and CO
    output channels: "c1" for C == 1; with CO % 8 == 0 (16-byte rows of y
    and dy), "few" for 1 < C < 16 and for C >= 16 the tensor-core route of
    the type, "wgmma" for bf16 and "wgmma_tf32x3" for f32, on x and w
    zero-padded to a multiple of the route's K step (`route_channels`)
    where C is not one; else "cuda_core"."""
    if C == 1:
        return "c1"
    if CO % 8 == 0 and dtype in _WGMMA_ROUTE:
        return "few" if C < 16 else _WGMMA_ROUTE[dtype]
    return "cuda_core"


def conv3x3_wgrad_route(C: int, CO: int, dtype) -> str:
    """The kernel that runs `conv3x3_wgrad`: the route `conv3x3_route`
    picks for the same shapes ("wgmma_tf32x3" is then
    `csrc/conv3x3_wgrad_tf32x3.cu`, which also steps 8 channels along M and
    needs 16-byte rows; "few" the weight gradient in
    `csrc/conv3x3_few.cu`)."""
    return conv3x3_route(C, CO, dtype)


# input channels per K step of the tensor-core routes: 16 bf16 values (32
# bytes) per wgmma step, 8 f32 values per tf32 step
_K_STEP = {"wgmma": 16, "wgmma_tf32x3": 8}


def route_channels(C: int, route: str) -> int:
    """The input channels that `route` runs C on: C rounded up to the
    route's K step on the wgmma routes (C = 12, forced there, runs as 16 in
    either type), C elsewhere ("few" reads x at its own C)."""
    step = _K_STEP.get(route, 1)
    return -(-C // step) * step


def pad_channels(t: torch.Tensor, C: int, dim: int = -1) -> torch.Tensor:
    """`t` zero-padded at the end of axis `dim` (negative) to C channels;
    the tensor itself when it has C already."""
    extra = C - t.shape[dim]
    return t if extra == 0 else F.pad(t, (0, 0) * (-dim - 1) + (0, extra))


# the launch counter of each route but "cuda_core", per wrapper
_COUNTERS = {"wgmma": "wgmma_launches", "wgmma_tf32x3": "tf32x3_launches",
             "c1": "c1_launches", "few": "few_launches"}


def _count(fn, route):
    fn.launches += 1
    if route in _COUNTERS:
        name = _COUNTERS[route]
        setattr(fn, name, getattr(fn, name) + 1)


def route_launches(fn) -> dict:
    """{route: launches} of `conv3x3` or `conv3x3_wgrad` since their
    counters were last set to 0; "cuda_core" is the rest of `launches`."""
    out = {route: getattr(fn, name) for route, name in _COUNTERS.items()
           if hasattr(fn, name)}
    out["cuda_core"] = fn.launches - sum(out.values())
    return out


def zero_launches(fn):
    """Sets every launch counter of `conv3x3` or `conv3x3_wgrad` to 0."""
    fn.launches = fn.padded_launches = 0
    for name in _COUNTERS.values():
        if hasattr(fn, name):
            setattr(fn, name, 0)


def tf32_split(w: torch.Tensor):
    """(hi, lo) of an f32 tensor: hi = w rounded to the nearest tf32 value
    (ties away from zero; the low 13 mantissa bits cleared), lo = w - hi.
    hi and w agree to a factor of 2, so lo is exact and hi + lo == w."""
    bits = w.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def few_k(C: int, kz: int, dtype):
    """(Cs, Kp) of the "few" route for C input channels, kz z-taps and
    compute type `dtype`: the channels per tap in its K order and K =
    kz * 9 * Cs rounded up to the K step of one wgmma.  bf16 takes one k16
    step per tap, 16 channels (zeros past C: its halo holds each pixel as
    32 bytes, and a tap is a shift of the operand); f32 folds the taps at C
    channels each into k8 steps (C = 12, kz = 3: 432 and 328)."""
    if dtype == torch.bfloat16:
        return 16, kz * 9 * 16
    return C, -(-kz * 9 * C // 8) * 8


def pack_few_weights(w: torch.Tensor, dtype=None) -> torch.Tensor:
    """The weights of the "few" route: w (3, 3, C, CO) or (kz, 3, 3, C, CO)
    as a (Kp, CO) matrix in the GEMM's K order, row k = ((kz * 3 + ky) * 3
    + kx) * Cs + ci, zero rows for the channels past C and past kz * 9 * Cs
    (`few_k` for compute type `dtype`, w's type by default).  In w's type,
    on w's device: a plain tensor op, once per call."""
    w5 = _as_5d(w)
    kz, _, _, C, CO = w5.shape
    cs, kp = few_k(C, kz, w.dtype if dtype is None else dtype)
    m = pad_channels(w5, cs, dim=-2).reshape(kz * 9 * cs, CO)
    return F.pad(m, (0, 0, 0, kp - m.shape[0])).contiguous()


def _check_aligned(route, **tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the {route} route's TMA or vector accesses, "
                             f"got data_ptr() % 16 == {t.data_ptr() % 16}")


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
    fn = build.function("conv3x3", "dgtta_conv3x3",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
    N, H, W, C = x.shape
    err = fn(x.data_ptr(), w5.data_ptr(), y.data_ptr(), N, depth, H, W, C,
             w5.shape[-1], w5.shape[0], _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed with CUDA error "
                           f"{err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w5.shape)}, depth {depth}")


def _launch_wgmma(x, w5, y, depth):
    fn = build.function("conv3x3_wgmma", "dgtta_conv3x3_wgmma",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
    # K-major weights for the GEMM: (kz, 3, 3, CO, C), ci contiguous; f32
    # as a tf32 part and its remainder (3xTF32)
    wt = w5.transpose(3, 4).contiguous()
    wt_lo = None
    if x.dtype == torch.float32:
        wt, wt_lo = tf32_split(wt)
    N, H, W, C = x.shape
    err = fn(x.data_ptr(), wt.data_ptr(),
             0 if wt_lo is None else wt_lo.data_ptr(), y.data_ptr(), N,
             depth, H, W, C, w5.shape[-1], w5.shape[0],
             _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 wgmma kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w5.shape)}, depth {depth}")


def _launch_c1(x, w5, y, depth):
    # the kernel packs w into its GEMM's B operand itself: no launch but
    # its own
    fn = build.function("conv3x3_c1", "dgtta_conv3x3_c1",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])
    N, H, W, _ = x.shape
    err = fn(x.data_ptr(), w5.data_ptr(), y.data_ptr(), N, depth, H, W,
             w5.shape[-1], w5.shape[0], _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 c1 kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w5.shape)}, depth {depth}")


def _launch_few(x, w5, y, depth):
    fn = build.function("conv3x3_few", "dgtta_conv3x3_few",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
    # the weights in the GEMM's K order; f32 as a tf32 part and its
    # remainder (3xTF32)
    wk, wk_lo = pack_few_weights(w5), None
    if x.dtype == torch.float32:
        wk, wk_lo = tf32_split(wk)
    N, H, W, C = x.shape
    err = fn(x.data_ptr(), wk.data_ptr(),
             0 if wk_lo is None else wk_lo.data_ptr(), y.data_ptr(), N,
             depth, H, W, C, w5.shape[-1], w5.shape[0], wk.shape[0],
             _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 few kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w5.shape)}, depth {depth}")


_LAUNCH = {"cuda_core": _launch, "wgmma": _launch_wgmma,
           "wgmma_tf32x3": _launch_wgmma, "c1": _launch_c1,
           "few": _launch_few}


def _pick_route(route, chosen, dtype):
    """`route` if given, else the route the shapes choose; the CUDA-core
    kernels take every shape, the type's wgmma route also the shapes that
    choose "few" (on zero-padded channels), another route only the shapes
    it chose."""
    if route is None or route == chosen:
        return chosen
    if route != "cuda_core" and not (
            chosen == "few" and route == _WGMMA_ROUTE.get(dtype)):
        raise ValueError(f"route {route!r} does not take this call (its "
                         f"shapes choose {chosen!r})")
    return route


def conv3x3(x: torch.Tensor, w: torch.Tensor, depth: int = 1,
            route=None) -> torch.Tensor:
    """y[n,h,w,co] = sum_{kz,ky,kx,ci} x[n+kz-KZ//2, h+ky-1, w+kx-1, ci]
    * w[kz,ky,kx,ci,co], zero-padded in H, W and within each group of
    `depth` planes; KZ = 1 for a (3, 3, C, CO) `w`, 3 for (3, 3, 3, C, CO).

    x: (N, H, W, C), N a multiple of depth.  Returns (N, H, W, CO) in x's
    type.  CPU tensors take the plain version; CUDA tensors the kernel of
    `conv3x3_route`, or of `route="cuda_core"` where the caller asks for the
    CUDA-core kernel, or of the type's wgmma route on a shape that chooses
    "few" (to compare the routes on one shape).
    """
    w5 = _check(x, w, depth)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_reference(x, w, depth)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x and w must lie on one CUDA device or both on "
                         f"the CPU, got {x.device} and {w.device}")
    if not (x.is_contiguous() and w5.is_contiguous()):
        raise ValueError("conv3x3 needs contiguous x and w")
    N, H, W, C = x.shape
    route = _pick_route(route, conv3x3_route(C, w5.shape[-1], x.dtype),
                        x.dtype)
    if route in ("wgmma", "wgmma_tf32x3"):
        # zero channels add nothing to the sum
        x = pad_channels(x, route_channels(C, route))
        w5 = pad_channels(w5, x.shape[-1], dim=-2)
    if route in ("wgmma", "wgmma_tf32x3", "few"):
        _check_aligned(route, x=x)
    padded = x.shape[-1] != C
    y = torch.empty((N, H, W, w5.shape[-1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _LAUNCH[route](x, w5, y, depth)
    _count(conv3x3, route)
    conv3x3.padded_launches += padded
    return y


conv3x3.launches = conv3x3.padded_launches = 0
conv3x3.wgmma_launches = conv3x3.tf32x3_launches = conv3x3.c1_launches = 0
conv3x3.few_launches = 0


def conv3x3_flops(x_shape, w_shape, depth: int = 1) -> int:
    """Operations (2 per multiply-add) that one call needs.  A tap that
    falls past an edge reads only zero padding and is not counted: along an
    axis of n points there are 3 * n - 2 taps inside, in H, in W and, with
    three z-taps, in each volume of `depth` planes."""
    N, H, W, C = x_shape
    kz = 1 if len(w_shape) == 4 else w_shape[0]
    plane_taps = N if kz == 1 else (N // depth) * (3 * depth - 2)
    return 2 * (3 * H - 2) * (3 * W - 2) * C * w_shape[-1] * plane_taps


# conv3x3_wgrad tiles (csrc/conv3x3_wgrad.cu): 4 x 16 positions per tile,
# 32 output channels per block, 4 or 32 input channels per block.
_WG_TILE_H, _WG_TILE_W, _WG_TCO = 4, 16, 32
# blocks to aim for when the positions are split: 8 per SM of an H100
_WG_TARGET_BLOCKS = 8 * 132
# conv3x3_wgrad_wgmma tiles (csrc/conv3x3_wgrad_wgmma.cu): 4 x 16 positions
# per stage, 64 input channels and 32 or 64 output channels per block, one
# block per kz; aim for 4 blocks per SM (one resident at a time)
_WGW_TILE_H, _WGW_TILE_W, _WGW_TCI = 4, 16, 64
_WGW_TARGET_BLOCKS = 4 * 132
# conv3x3_wgrad_tf32x3 tiles (csrc/conv3x3_wgrad_tf32x3.cu): 4 x 16 positions
# per stage, 32 input and 32 output channels per block, one block per kz;
# one block per SM is resident (672 threads)
_WGT_TCI, _WGT_TCO = 32, 32
# conv3x3_c1's weight gradient (csrc/conv3x3_c1.cu): positions per tile
# (bf16 8 x 64, f32 4 x 64), 32 output channels per block; a block sums a
# contiguous range of tiles, one wave of blocks, two per SM
_C1_TILE = {torch.bfloat16: (8, 64), torch.float32: (4, 64)}
_C1_TCO = 32
_C1_TARGET_BLOCKS = 2 * 132
# conv3x3_few's weight gradient (csrc/conv3x3_few.cu): positions per stage
# (bf16 8 x 16, f32 4 x 16), 32 output channels per block; bf16 keeps 2
# blocks per SM resident, f32 one
_FEW_TILE = {torch.bfloat16: (8, 16), torch.float32: (4, 16)}
_FEW_TCO = 32
_FEW_TARGET_BLOCKS = {torch.bfloat16: 2 * 132, torch.float32: 132}


def _wgrad_check(x, dy, depth, kz):
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"x (N, H, W, C) and dy (N, H, W, CO) must share "
                         f"N, H, W, got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if kz not in (1, 3):
        raise ValueError(f"kz must be 1 or 3, got {kz}")
    if depth < 1 or x.shape[0] % depth:
        raise ValueError(f"depth {depth} does not divide N={x.shape[0]}")
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise ValueError(f"x and dy must both be float32 or bfloat16, got "
                         f"{x.dtype} and {dy.dtype}")


def conv3x3_wgrad_reference(x: torch.Tensor, dy: torch.Tensor,
                            depth: int = 1, kz: int = 3) -> torch.Tensor:
    """Plain PyTorch version: `torch.nn.grad.conv{2,3}d_weight` in f32 on
    channels-first views.  Returns (kz, 3, 3, C, CO) f32."""
    _wgrad_check(x, dy, depth, kz)
    N, H, W, C = x.shape
    CO = dy.shape[-1]
    if kz == 1:
        dw = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2).float(), (CO, C, 3, 3),
            dy.permute(0, 3, 1, 2).float(), padding=1)
        return dw.permute(2, 3, 1, 0).unsqueeze(0).contiguous()

    def cf(t):
        return t.reshape(N // depth, depth, H, W, t.shape[-1]) \
            .permute(0, 4, 1, 2, 3).float()

    dw = torch.nn.grad.conv3d_weight(cf(x), (CO, C, 3, 3, 3), cf(dy),
                                     padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def wgrad_splits(x_shape, co: int, kz: int = 3) -> int:
    """How many blocks share the sum over positions of one output tile."""
    N, H, W, C = x_shape
    tc = 4 if C <= 4 else 32
    tiles = N * (-(-H // _WG_TILE_H)) * (-(-W // _WG_TILE_W))
    base = kz * (-(-C // tc)) * (-(-co // _WG_TCO))
    return max(1, min(-(-tiles // 4), -(-_WG_TARGET_BLOCKS // base)))


def wgrad_wgmma_splits(x_shape, co: int, kz: int = 3) -> int:
    """How many blocks share the sum over positions of one output tile on
    the "wgmma" route: enough for `_WGW_TARGET_BLOCKS`, at least 16
    position tiles each."""
    N, H, W, C = x_shape
    tiles = N * (-(-H // _WGW_TILE_H)) * (-(-W // _WGW_TILE_W))
    bn = 32 if co <= 32 else 64
    base = kz * (-(-C // _WGW_TCI)) * (-(-co // bn))
    return max(1, min(-(-tiles // 16), -(-_WGW_TARGET_BLOCKS // base)))


def wgrad_tf32x3_splits(x_shape, co: int, kz: int = 3) -> int:
    """How many blocks share the sum over positions of one output tile on
    the "wgmma_tf32x3" route: enough for `_WGW_TARGET_BLOCKS`, at least 16
    position tiles each."""
    N, H, W, C = x_shape
    tiles = N * (-(-H // _WGW_TILE_H)) * (-(-W // _WGW_TILE_W))
    base = kz * (-(-C // _WGT_TCI)) * (-(-co // _WGT_TCO))
    return max(1, min(-(-tiles // 16), -(-_WGW_TARGET_BLOCKS // base)))


def wgrad_few_splits(x_shape, co: int, dtype) -> int:
    """How many blocks share the sum over positions on the "few" route:
    enough for one wave of `_FEW_TARGET_BLOCKS`, at least 8 position tiles
    each."""
    N, H, W, _ = x_shape
    th, tw = _FEW_TILE[dtype]
    tiles = N * (-(-H // th)) * (-(-W // tw))
    return max(1, min(-(-tiles // 8), _FEW_TARGET_BLOCKS[dtype]
                      // -(-co // _FEW_TCO)))


def wgrad_c1_splits(x_shape, co: int, dtype) -> int:
    """How many blocks share the sum over positions on the "c1" route:
    one wave of `_C1_TARGET_BLOCKS` over the output-channel tiles, at least
    one position tile each."""
    N, H, W, _ = x_shape
    th, tw = _C1_TILE[dtype]
    tiles = N * (-(-H // th)) * (-(-W // tw))
    return max(1, min(tiles, _C1_TARGET_BLOCKS // -(-co // _C1_TCO)))


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor, depth: int = 1,
                  kz: int = 3, route=None) -> torch.Tensor:
    """dW[kz,ky,kx,ci,co] = sum_{n,h,w} x[n+kz-KZ//2, h+ky-1, w+kx-1, ci]
    * dy[n,h,w,co], zero-padded as `conv3x3` pads: the weight gradient of
    `conv3x3(x, W, depth)`.  Returns (kz, 3, 3, C, CO) f32.  CPU tensors
    take the plain version; CUDA tensors the kernel of
    `conv3x3_wgrad_route`, or of a forced route as in `conv3x3`."""
    _wgrad_check(x, dy, depth, kz)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return conv3x3_wgrad_reference(x, dy, depth, kz)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"x and dy must lie on one CUDA device or both on "
                         f"the CPU, got {x.device} and {dy.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv3x3_wgrad needs contiguous x and dy")
    N, H, W, C = x.shape
    CO = dy.shape[-1]
    route = _pick_route(route, conv3x3_wgrad_route(C, CO, x.dtype), x.dtype)
    if route_channels(C, route) != C:
        # the gradient of the zero channels is computed and dropped
        dw = conv3x3_wgrad(pad_channels(x, route_channels(C, route)), dy,
                           depth, kz, route)
        conv3x3_wgrad.padded_launches += 1
        return dw[..., :C, :].contiguous()
    if route == "wgmma_tf32x3":
        return _wgrad_tf32x3(x, dy, depth, kz)
    if route == "wgmma":
        _check_aligned(route, x=x, dy=dy)
        splits = wgrad_wgmma_splits(x.shape, CO, kz)
        fn = build.function("conv3x3_wgrad_wgmma", "dgtta_conv3x3_wgrad_wgmma",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p])
    elif route == "c1":
        _check_aligned(route, dy=dy)
        splits = wgrad_c1_splits(x.shape, CO, x.dtype)
        fn = build.function("conv3x3_c1", "dgtta_conv3x3_wgrad_c1",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p])
    elif route == "few":
        _check_aligned(route, x=x, dy=dy)
        splits = wgrad_few_splits(x.shape, CO, x.dtype)
        fn = build.function("conv3x3_few", "dgtta_conv3x3_wgrad_few",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p])
    else:
        splits = wgrad_splits(x.shape, CO, kz)
        fn = build.function("conv3x3_wgrad", "dgtta_conv3x3_wgrad",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p])
    dw = torch.empty((kz, 3, 3, C, CO), dtype=torch.float32, device=x.device)
    scratch = (torch.empty((splits,) + tuple(dw.shape), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    args = [x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), N, depth, H, W]
    args += [CO, kz, splits] if route == "c1" else [C, CO, kz, splits]
    if route != "wgmma":
        args.append(_DTYPE_CODES[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad {route} kernel launch failed with "
                           f"CUDA error {err} for x {tuple(x.shape)} "
                           f"{x.dtype}, dy {tuple(dy.shape)}, depth {depth}, "
                           f"kz {kz}")
    _count(conv3x3_wgrad, route)
    return dw


def _wgrad_tf32x3(x, dy, depth, kz):
    """`conv3x3_wgrad` on the "wgmma_tf32x3" route: the pre-pass writes dy
    transposed and split (hi, lo) into `dyt`, then the 3xTF32 kernel and
    the fixed-order sum of the splits run."""
    _check_aligned("wgmma_tf32x3", x=x, dy=dy)
    N, H, W, C = x.shape
    CO = dy.shape[-1]
    splits = wgrad_tf32x3_splits(x.shape, CO, kz)
    fn = build.function("conv3x3_wgrad_tf32x3", "dgtta_conv3x3_wgrad_tf32x3",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
    dyt = torch.empty(2 * N * H * CO * (-(-W // 4) * 4), dtype=torch.float32,
                      device=x.device)
    dw = torch.empty((kz, 3, 3, C, CO), dtype=torch.float32, device=x.device)
    scratch = (torch.empty((splits,) + tuple(dw.shape), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), dyt.data_ptr(), dw.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(), N, depth, H,
                 W, C, CO, kz, splits,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad wgmma_tf32x3 kernel launch failed "
                           f"with CUDA error {err} for x {tuple(x.shape)}, "
                           f"dy {tuple(dy.shape)}, depth {depth}, kz {kz}")
    _count(conv3x3_wgrad, "wgmma_tf32x3")
    return dw


conv3x3_wgrad.launches = conv3x3_wgrad.padded_launches = 0
conv3x3_wgrad.wgmma_launches = conv3x3_wgrad.tf32x3_launches = 0
conv3x3_wgrad.c1_launches = conv3x3_wgrad.few_launches = 0


class Conv3x3Function(torch.autograd.Function):
    """`conv3x3` with its backward: dx through `conv3x3` with flipped,
    channel-swapped weights (skipped when x needs no gradient, as the
    image entering the first conv), dW through `conv3x3_wgrad`."""

    @staticmethod
    def forward(ctx, x, w, depth):
        ctx.depth = depth
        ctx.save_for_backward(x, w)
        return conv3x3(x, w, depth)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        w5 = _as_5d(w)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w5.flip((0, 1, 2)).transpose(3, 4).contiguous()
            dx = conv3x3(dy, wt if w.dim() == 5 else wt[0], ctx.depth)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, dy, ctx.depth, kz=w5.shape[0])
            dw = dw.reshape(w.shape).to(w.dtype)
        return dx, dw, None


def conv3x3_op(x: torch.Tensor, w: torch.Tensor,
               depth: int = 1) -> torch.Tensor:
    """`conv3x3(x, w, depth)` that autograd differentiates through the
    port's kernels (`Conv3x3Function`)."""
    return Conv3x3Function.apply(x, w, depth)
