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
  C into a ring of staged planes in shared memory, a block walking the
  planes of a tile so that each staged plane serves its three z-taps
  (`few_plan`), the taps in the GEMM's K axis, the weights packed into
  that order by the kernel itself (`pack_few_weights` is that matrix as a
  plain tensor op);
* "wgmma" (`csrc/conv3x3_wgmma.cu`): bf16 with C >= 16 and CO % 8 == 0,
  an implicit GEMM on the tensor cores fed by TMA: a halo of x staged per
  (z-tap, channel chunk) and read at the nine (ky, kx) shifts, the
  weights read as they are; persistent blocks or, where the work items
  are fewer than the SMs, a cluster of blocks per item (`wgmma_plan`);
* "wgmma_tf32x3" (the same source, its f32 instantiation): f32 with
  C >= 16 and CO % 8 == 0, each product at f32 accuracy from three tf32
  products (3xTF32); a first launch of the same call writes the weights
  transposed and split into a tf32 part and its remainder (the bits of
  `tf32_split`) into scratch the wrapper allocates;
* "cuda_core" (`csrc/conv3x3.cu`): the catch-all, CO % 8 != 0 (a plan's
  widths 30, 60, 300; a stem's input gradient) and any shape a caller
  forces onto it: the tensor cores (wgmma; f32 as 3xTF32), x read at
  its own C by cp.async into a ring of (z-tap, channel chunk) stages, the
  weights packed by a first launch of the same call
  (`pack_cuda_core_weights` is its plain version: CO rounded up to the
  block's 8, 16, 32 or 64 columns, C to the chunk, f32 split), the
  splits `cuda_core_plan`'s; the name is the one it had when it ran on
  the CUDA cores, kept so that scripts force it by one name on every
  checkout.
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
split in shared memory in f32; "wgmma" (bf16) and "wgmma_tf32x3" (f32,
3xTF32, dy transposed and split in shared memory), the kernels of
`csrc/conv3x3_wgrad_wgmma.cu` that `wgrad_plan` picks; "cuda_core",
`csrc/conv3x3_wgrad.cu`, for the other channel counts, its splits
`cuda_core_wgrad_plan`'s; plain version
`conv3x3_wgrad_reference`; counts `conv3x3_wgrad.launches`,
`.wgmma_launches`, `.tf32x3_launches`, `.c1_launches`, `.few_launches`
and `.padded_launches`).  The input gradient needs no
kernel of its own: it is the same zero-padded conv of dy with the weights
flipped in (kz, ky, kx) and their channel axes swapped, so it runs through
`conv3x3` again.  `Conv3x3Function` ties the three together as a
`torch.autograd.Function`; `conv3x3_op` applies it.

Members side by side: a `w` of shape (M, KZ, 3, 3, C, CO) holds the
weights of M ensemble members, and `x` is then (M * n, H, W, C), member
m's n planes (a multiple of `depth`) after member m - 1's.  Each plane
takes its member's weights, in one launch on every route.  The
weight gradient of such a call (`conv3x3_wgrad(..., members=M)`) is (M,
KZ, 3, 3, C, CO), dw[m] summed over member m's positions alone.  Every
plan and split count is computed from one member's n planes, never from
M * n, so that a member's outputs and gradients are the bits of a call of
that member alone; M = 1 is the call without a member axis.  The plain
versions take the member axis too, one member after another.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from dg_tta_tpu_torch.kernels import build

SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3.cu"
WGRAD_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_wgrad.cu"
WGMMA_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_wgmma.cu"
# both tensor-core weight gradients, bf16 ("wgmma") and f32 ("wgmma_tf32x3")
WGRAD_WGMMA_SOURCE = "dg_tta_tpu_torch/kernels/csrc/conv3x3_wgrad_wgmma.cu"
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
    picks for the same shapes ("wgmma" and "wgmma_tf32x3" are then the
    kernels of `csrc/conv3x3_wgrad_wgmma.cu`, `wgrad_kernel`; "few" the
    weight gradient in `csrc/conv3x3_few.cu`)."""
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
    hi and w agree to a factor of 2, so lo is exact and hi + lo == w.
    The kernels compute the same bits (`round_tf32`):
    `csrc/conv3x3_wgmma.cu` in its weight pass, `csrc/conv3x3_few.cu` for
    its weights and for each staged value of x."""
    bits = w.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def few_k(C: int, kz: int, dtype):
    """(Cs, Kp) of the "few" route for C input channels, kz z-taps and
    compute type `dtype`: the channels per tap in its K order (zeros past
    C) and K.  bf16 takes one k16 step per tap, 16 channels (its halo
    holds each pixel as 32 bytes, and a tap is a shift of the operand):
    Kp = kz * 9 * 16.  f32 reads a (kz, ky) row of taps as 3 x Cs
    contiguous floats of its staged plane, Cs = C rounded up to 4 (the
    16-byte rows of ldmatrix), padded to the k8 step: Kr = 3 x Cs rounded
    up to 8 a row, Kp = kz * 3 * Kr (C = 12, kz = 3: 432 and 360)."""
    if dtype == torch.bfloat16:
        return 16, kz * 9 * 16
    cs = -(-C // 4) * 4
    return cs, kz * 3 * (-(-3 * cs // 8) * 8)


def pack_few_weights(w: torch.Tensor, dtype=None) -> torch.Tensor:
    """The weights of the "few" route: w (3, 3, C, CO) or (kz, 3, 3, C, CO)
    as a (Kp, CO) matrix in the GEMM's K order, (kz, ky) row r of taps at
    rows r * Kr + kx * Cs + ci, zero rows for the channels past C and past
    3 x Cs in each row of Kr = Kp / (kz * 3) (`few_k` for compute type
    `dtype`, w's type by default); members' weights (M, kz, 3, 3, C, CO)
    as (M, Kp, CO), one such matrix each.  In w's type, on w's device.
    The kernels build the same matrix in shared memory from w as it is
    (f32: split by `tf32_split`'s bits); this is its plain statement."""
    w6 = _as_6d(w)
    M, kz, _, _, C, CO = w6.shape
    cs, kp = few_k(C, kz, w.dtype if dtype is None else dtype)
    m = pad_channels(w6, cs, dim=-2).reshape(M, kz * 3, 3 * cs, CO)
    m = F.pad(m, (0, 0, 0, kp // (kz * 3) - 3 * cs)).reshape(M, kp, CO)
    return m.contiguous() if w.dim() == 6 else m[0].contiguous()


def _check_aligned(route, **tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the {route} route's TMA or vector accesses, "
                             f"got data_ptr() % 16 == {t.data_ptr() % 16}")


def _as_5d(w: torch.Tensor) -> torch.Tensor:
    return w.unsqueeze(0) if w.dim() == 4 else w


def _as_6d(w: torch.Tensor) -> torch.Tensor:
    """w with its member axis: (M, kz, 3, 3, C, CO)."""
    return w if w.dim() == 6 else _as_5d(w).unsqueeze(0)


def _check_members(N: int, members: int, depth: int):
    if members < 1 or N % members or depth < 1 or (N // members) % depth:
        raise ValueError(f"N={N} must be {members} members' planes, each a "
                         f"multiple of depth {depth}")


def _check(x: torch.Tensor, w: torch.Tensor, depth: int):
    """w as (M, kz, 3, 3, C, CO), checked against x and depth."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if w.dim() not in (4, 5, 6):
        raise ValueError(f"w must be (3, 3, C, CO), (3, 3, 3, C, CO) or "
                         f"members' (M, kz, 3, 3, C, CO), got "
                         f"{tuple(w.shape)}")
    w6 = _as_6d(w)
    if tuple(w6.shape[1:4]) not in ((1, 3, 3), (3, 3, 3)) \
            or w6.shape[4] != x.shape[3]:
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    _check_members(x.shape[0], w6.shape[0], depth)
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16, got "
                         f"{x.dtype} and {w.dtype}")
    return w6


def _member_planes(t: torch.Tensor, members: int):
    """The members' slices of t's planes, (N / members, ...) each."""
    return t.chunk(members) if members > 1 else (t,)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      depth: int = 1) -> torch.Tensor:
    """Plain PyTorch version: `F.conv2d` (one z-tap) or `F.conv3d` (three)
    on channels-first views, computed in f32 and cast to x's type; with
    members' weights, one member after another."""
    w6 = _check(x, w, depth)
    if w6.shape[0] > 1:
        return torch.cat([conv3x3_reference(xm, wm, depth) for xm, wm in
                          zip(_member_planes(x, w6.shape[0]), w6)])
    w5 = w6[0]
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


# the catch-all route (csrc/conv3x3.cu, csrc/conv3x3_wgrad.cu): the
# forward's output tile (pixels), input channels of a stage per type (one
# MMA depth), ring stages per type, halo row pitch (bytes); the weight
# gradient's position tile, output channels of an item, ring stages and
# row pitch per type: the sources' constants (kTH x kTW, kKC, kStages,
# kPitch; kCh), which
# tests/test_torch_conv3x3_ragged.py holds these to.  The SMs of an H100.
_CC_TILE = (16, 16)
_CC_KC = {torch.bfloat16: 16, torch.float32: 8}
_CC_STAGES = {torch.bfloat16: 3, torch.float32: 3}
_CC_PITCH = 48
_CCW_TILE = (8, 16)
_CCW_STAGES = 3
_CCW_PITCH = {torch.bfloat16: 80, torch.float32: 160}
_CC_SMS = 132
# the blocks a volume's launch aims at where it splits (two waves), and
# the forward's most stage splits
_CC_TARGET_BLOCKS = 2 * _CC_SMS
_CC_MAX_SPLITS = 8
# the forward's columns of a block (the source's launch_bn cases); the
# weight gradient's input channels of an item per type (launch_ci) and
# output channels of an item (kCh)
_CC_BN = (8, 16, 32, 64)
_CCW_CI = {torch.float32: (8, 16, 32), torch.bfloat16: (16, 32)}
_CCW_CH = 32


def cuda_core_vec(element_size: int, *rows_and_ptrs) -> int:
    """The bytes of the catch-all kernels' cp.async granule: the widest of
    16, 8, 4 (and 2, for bf16) that divides every row's bytes (channels x
    element size) and every address given (ints, mixed)."""
    for v in (16, 8, 4, 2):
        if v >= element_size and all(r % v == 0 for r in rows_and_ptrs):
            return v
    raise ValueError(f"no cp.async granule divides {rows_and_ptrs}")


@functools.lru_cache(maxsize=None)
def cuda_core_plan(depth: int, H: int, W: int, C: int, CO: int, dtype,
                   kz: int = 3) -> dict:
    """How `csrc/conv3x3.cu` runs one forward on the "cuda_core" route,
    from one volume's shape (`depth` planes of (H, W), C -> CO, kz
    z-taps) alone, never from the batch or the members side by side, so
    that a plane's sums do not depend on the batch, `patch_group` or the
    members beside it:
    * bn: output channels of a block (wgmma's N): CO rounded up to 8, 16
      or 32, else column tiles of 64;
    * splits, per_split: where one volume has fewer (plane, 16 x 16 tile,
      column tile) items than SMs (the 7 x 8 and 14 x 16 levels: 35-56),
      the runs of per_split (z-tap, chunk of `_CC_KC` channels) stages the
      kz x ceil(C / KC) stages are cut into, a block each, their partial
      sums added in order by a second pass: as many as give the volume's
      items `_CC_TARGET_BLOCKS` blocks, at most `_CC_MAX_SPLITS` and the
      stages, none empty (the 28 x 32 level's 224 items ran slower with 2
      in bf16: 0.109 against 0.090 ms a window).
    Cached."""
    bn = next(b for b in _CC_BN if CO <= b or b == 64)
    th, tw = _CC_TILE
    items = depth * -(-H // th) * -(-W // tw) * -(-CO // bn)
    stages = kz * -(-C // _CC_KC[dtype])
    splits = (1 if items >= _CC_SMS else
              max(1, min(_CC_MAX_SPLITS, stages,
                         -(-_CC_TARGET_BLOCKS // items))))
    per = -(-stages // splits)
    return dict(bn=bn, splits=-(-stages // per), per_split=per)


def pack_cuda_core_weights(w: torch.Tensor, bn: int) -> torch.Tensor:
    """The weights of the "cuda_core" forward, w (3, 3, C, CO), (kz, 3, 3,
    C, CO) or members' (M, kz, 3, 3, C, CO), as its stages take them, for
    column tiles of bn: (M, kz, chunks, co_tiles, parts, 9, bn, kc) in w's
    type, for each member, z-tap, chunk of kc input channels and tile of
    bn output channels one contiguous block, a tap's bn rows of kc
    channels (K contiguous: the B operand), C and CO zero-padded; f32 in
    two parts, the tf32 part and its remainder (`tf32_split`), bf16 in
    one; each 32-byte row with its two 16-byte halves swapped where bit 2
    of the row is set (wgmma's 32-byte swizzle).  On a CUDA tensor the
    source's `pack_kernel` (one launch; the forward's C entry runs it
    itself), on the CPU this plain version."""
    w6 = _as_6d(w)
    M, kz, _, _, C, CO = w6.shape
    kc = _CC_KC[w.dtype]
    nch, ct = -(-C // kc), -(-CO // bn)
    parts = 2 if w.dtype == torch.float32 else 1
    if w.device.type == "cuda":
        out = torch.empty((M, kz, nch, ct, parts, 9, bn, kc), dtype=w.dtype,
                          device=w.device)
        fn = build.function("conv3x3", "dgtta_conv3x3_pack",
                            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p])
        with torch.cuda.device(w.device):
            err = fn(w6.contiguous().data_ptr(), out.data_ptr(), M, kz, C,
                     CO, bn, _DTYPE_CODES[w.dtype],
                     torch.cuda.current_stream(w.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"conv3x3 pack kernel launch failed with CUDA "
                               f"error {err} for w {tuple(w6.shape)}, bn {bn}")
        return out
    p = F.pad(w6, (0, ct * bn - CO, 0, nch * kc - C))
    p = p.reshape(M, kz, 9, nch, kc, ct, bn).permute(0, 1, 3, 5, 2, 6, 4)
    p = torch.stack(tf32_split(p) if parts == 2 else (p,), dim=4)
    halves = p.reshape(p.shape[:-1] + (2, kc // 2))
    swap = ((torch.arange(bn) >> 2) & 1).bool().view(bn, 1, 1)
    return torch.where(swap, halves.flip(-2), halves).reshape(p.shape) \
        .contiguous()


def _launch(x, w6, y, depth):
    """The catch-all kernel, every member in one launch (the weights
    packed by a first launch of the same call)."""
    fn = build.function("conv3x3", "dgtta_conv3x3",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                        + [ctypes.c_void_p])
    M, kz, _, _, C, CO = w6.shape
    N, H, W, _ = x.shape
    plan = cuda_core_plan(depth, H, W, C, CO, x.dtype, kz)
    bn, kc = plan["bn"], _CC_KC[x.dtype]
    wp = torch.empty(M * kz * -(-C // kc) * -(-CO // bn) * 9 * bn * kc
                     * (2 if x.dtype == torch.float32 else 1),
                     dtype=x.dtype, device=x.device)
    vec = cuda_core_vec(x.element_size(), C * x.element_size(), x.data_ptr())
    # the splits' partial sums
    scratch = (torch.empty((plan["splits"],) + tuple(y.shape),
                           dtype=torch.float32, device=x.device)
               if plan["splits"] > 1 else None)
    err = fn(x.data_ptr(), w6.data_ptr(), wp.data_ptr(), y.data_ptr(),
             0 if scratch is None else scratch.data_ptr(), N, M, depth, H, W,
             C, CO, kz, bn, vec, plan["splits"], plan["per_split"],
             _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)} "
                           f"{x.dtype}, w {tuple(w6.shape)}, depth "
                           f"{depth}")


# conv3x3_wgmma (csrc/conv3x3_wgmma.cu): output tiles of the "big" and the
# "small" layout (pixels), the SMs of an H100 (one block per SM is
# resident: ~200 KB of ring), and the most blocks that may share one work
# item (a cluster)
_WGMMA_TILE = {"big": (16, 16), "small": (8, 8)}
_WGMMA_SMS = 132
_WGMMA_MAX_SPLITS = 4


def wgmma_plan(N: int, depth: int, H: int, W: int, C: int, CO: int, dtype,
               kz: int = 3, members: int = 1) -> dict:
    """How `csrc/conv3x3_wgmma.cu` runs one call: x (N, H, W, C) in groups
    of `depth` planes, CO output channels, kz z-taps, on the wgmma route of
    `dtype`; N is one member's planes, and `members` of them run side by
    side (items and blocks count them all, the rest is one member's).
    * layout "small" (an 8 x 8 tile, two warpgroups of 32 columns on its
      one m64 tile: 64 columns a block) for planes of at most 8 x 8, else
      "big" (16 x 16, two warpgroups of two m64 tiles, `wn` = 32 columns
      for CO <= 32, else 64);
    * kc: the channels of one stage, 64 bytes of them where C is a
      multiple, else 32;
    * items: planes x tiles x column tiles;
    * splits: the blocks (a cluster, at most 4) that share each item's
      (z-tap, channel chunk) stages, from one volume's items (`depth`
      planes: a window's launch) and never from N, so that a plane's sums
      do not depend on the batch (a grouped step's planes get the
      ungrouped step's bits): the most that keep that launch in one wave
      of clusters, one more where that wave would leave over a quarter of
      the SMs idle (a second, part-full wave cost more on the card: the
      source's note), at most the item's fewest stages (a plane at the
      end of its group has 2 z-taps, depth 1 one);
    * blocks: items x splits with several splits, else min(items, SMs):
      persistent blocks that walk the items.
    `reason` says why a launch has fewer blocks than SMs (None if not)."""
    e = 2 if dtype == torch.bfloat16 else 4
    span = 64 if C * e % 64 == 0 else 32
    layout = "small" if H <= 8 and W <= 8 else "big"
    th, tw = _WGMMA_TILE[layout]
    wn = 32 if layout == "small" or CO <= 32 else 64
    bn = 2 * wn if layout == "small" else wn
    per_plane = -(-H // th) * -(-W // tw) * -(-CO // bn)
    items = members * N * per_plane
    kc = span // e
    fewest = (C // kc) * (1 if kz == 1 or depth == 1 else 2)
    # one wave of clusters for one volume, one more split where it would
    # leave over a quarter of the SMs idle
    volume = depth * per_plane
    splits = max(1, min(_WGMMA_MAX_SPLITS, _WGMMA_SMS // volume))
    if volume * splits < _WGMMA_SMS * 3 // 4:
        splits += 1
    splits = max(1, min(splits, _WGMMA_MAX_SPLITS, fewest))
    blocks = items * splits if splits > 1 else min(items, _WGMMA_SMS)
    reason = None
    if blocks < _WGMMA_SMS:
        reason = (f"{items} items x {splits} splits: "
                  + (f"an item's fewest stages ({fewest}) cap the splits"
                     if splits == fewest else
                     "the most blocks a cluster shares"
                     if splits == _WGMMA_MAX_SPLITS else
                     "one wave: another split would start a second wave "
                     "of clusters for a volume"))
    return dict(layout=layout, tile=(th, tw), wn=wn, bn=bn, kc=kc,
                items=items, splits=splits, blocks=blocks, reason=reason)


def _launch_wgmma(x, w6, y, depth):
    fn = build.function("conv3x3_wgmma", "dgtta_conv3x3_wgmma",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
                        + [ctypes.c_void_p])
    # f32: scratch for the K-major weights the kernel writes first, (M, kz,
    # 3, 3, CO, C), ci contiguous, as a tf32 part and its remainder
    # (3xTF32); bf16 reads w as it is
    M, kz, _, _, C, CO = w6.shape
    wt = wt_lo = None
    if x.dtype == torch.float32:
        wt = torch.empty((2, M, kz, 3, 3, CO, C), dtype=x.dtype,
                         device=x.device)
        wt, wt_lo = wt[0], wt[1]
    N, H, W, _ = x.shape
    plan = wgmma_plan(N // M, depth, H, W, C, CO, x.dtype, kz=kz, members=M)
    err = fn(x.data_ptr(), w6.data_ptr(), 0 if wt is None else wt.data_ptr(),
             0 if wt_lo is None else wt_lo.data_ptr(), y.data_ptr(), N, M,
             depth, H, W, C, CO, kz,
             _DTYPE_CODES[x.dtype], 0 if plan["layout"] == "big" else 1,
             plan["wn"], plan["kc"], plan["splits"], plan["blocks"],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 wgmma kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w6.shape)}, depth {depth}")


def _launch_c1(x, w6, y, depth):
    # the kernel packs w into its GEMM's B operand itself: no launch but
    # its own
    fn = build.function("conv3x3_c1", "dgtta_conv3x3_c1",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
    N, H, W, _ = x.shape
    err = fn(x.data_ptr(), w6.data_ptr(), y.data_ptr(), N, w6.shape[0],
             depth, H, W, w6.shape[-1], w6.shape[1], _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 c1 kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w6.shape)}, depth {depth}")


def _launch_few(x, w6, y, depth):
    # the kernel packs (and in f32 splits) each member's weights into its
    # K order itself, from w as it is
    fn = build.function("conv3x3_few", "dgtta_conv3x3_few",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                        + [ctypes.c_void_p])
    M, kz, _, _, C, CO = w6.shape
    N, H, W, _ = x.shape
    plan = few_plan(N // M, depth, H, W, C, CO, x.dtype, kz)
    err = fn(x.data_ptr(), w6.data_ptr(), y.data_ptr(), N, M, depth, H, W,
             C, CO, kz, plan["blocks"], _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 few kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)} {x.dtype}, "
                           f"w {tuple(w6.shape)}, depth {depth}")


# conv3x3_few (csrc/conv3x3_few.cu), per (type, weight gradient?): the
# tile of a step (output pixels or positions, rows x columns); the SMs of
# an H100, each holding one block of any of the four kernels; the f32
# weight gradient's m64 tiles of (ky, kx, ci) rows a block.  The source's
# constants (kBfWG x kBfRow, kFH x kFW, kBgH x kBgW, kGH x kGW, kGMT, kZB),
# which tests/test_torch_conv3x3_few.py holds these to.
_FEW_TILE = {(torch.bfloat16, False): (4, 64), (torch.float32, False): (16, 16),
             (torch.bfloat16, True): (8, 16), (torch.float32, True): (6, 8)}
_FEW_SMS = 132
_FEW_M_TILES = 2
# the forwards' output planes a step (one accumulator each)
_FEW_ZB = 2


@functools.lru_cache(maxsize=None)
def few_plan(N: int, depth: int, H: int, W: int, C: int, CO: int, dtype,
             kz: int = 3, wgrad: bool = False) -> dict:
    """How `csrc/conv3x3_few.cu` runs one call on the "few" route: x (N,
    H, W, C) of one member (its planes, groups of `depth`), CO output
    channels, kz z-taps; the forward, or with `wgrad` the weight gradient.
    * tile: the output pixels (forward) or positions (weight gradient) of
      a step, rows x columns (bf16 4 x 64 and 8 x 16, f32 16 x 16 and 6 x
      8); tiles: a plane's; zb: the output planes of a step (the
      forwards' two, one accumulator each, share each staged plane's
      fragments; the weight gradients one); steps: tiles x ceil(depth /
      zb) a volume, zb output planes of one tile each, ordered s = (volume
      * tiles + tile) * ceil(depth / zb) + d / zb;
    * rows: the blocks a step's outputs need side by side: ceil(CO / 32)
      column tiles, times the f32 weight gradient's blocks of two m64
      tiles of the 9 x C (ky, kx, ci) rows (two blocks at C = 15);
    * run: the steps a block walks in order, ceil(steps / one wave), a
      wave being 132 SMs (a block each) over the rows; blocks:
      ceil(steps / run), of each member and row, none empty (the weight
      gradient's splits, one partial sum each);
    * walks: the runs of consecutive planes of one tile that the blocks
      walk (a block's run starts one, and so does each tile and volume it
      reaches); each stages kz - 1 planes beyond its first step's own, so
      that `staged` = steps x zb + walks x (kz - 1) planes are staged, zb a
      step elsewhere; `halo`: staged pixels per output pixel (or per
      position): a staged plane's halo pixels x staged / (N x tiles x
      tile);
    * per_acc: the positions (weight gradient) or output pixels of a
      step that one accumulator sums (the f32 weight gradient's
      warpgroups take half a step's rows each); `longest`: the weight
      gradient's run x per_acc, the longest sum one accumulator takes
      (None for the forward, whose sums end with each step).
    Every count comes from one member's planes, never from the launch's.
    Cached."""
    th, tw = _FEW_TILE[dtype, wgrad]
    zb = 1 if wgrad else _FEW_ZB
    tiles = -(-H // th) * -(-W // tw)
    dsteps = -(-depth // zb)
    steps = N // depth * dsteps * tiles
    rows = -(-CO // 32)
    if wgrad and dtype == torch.float32:
        rows *= -(-(-(-9 * C // 64)) // _FEW_M_TILES)
    run = -(-steps // max(1, _FEW_SMS // rows))
    blocks = -(-steps // run)
    walks = len(set(range(0, steps, run)) | set(range(0, steps, dsteps)))
    staged = steps * zb + walks * (kz - 1)
    halo_px = (th + 2) * (tw + 2)
    # the f32 weight gradient's warpgroups sum half a step's positions each
    per_acc = th * tw // (2 if wgrad and dtype == torch.float32 else 1)
    return dict(tile=(th, tw), zb=zb, tiles=tiles, steps=steps, rows=rows,
                run=run, blocks=blocks, walks=walks, staged=staged,
                halo=halo_px * staged / (N * tiles * th * tw),
                per_acc=per_acc, longest=run * per_acc if wgrad else None)


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
    type.  With members' weights (M, KZ, 3, 3, C, CO), plane n takes member
    n // (N / M)'s (module docstring).  CPU tensors take the plain version;
    CUDA tensors the kernel of `conv3x3_route`, or of `route="cuda_core"`
    where the caller asks for the CUDA-core kernel, or of the type's wgmma
    route on a shape that chooses "few" (to compare the routes on one
    shape).
    """
    w6 = _check(x, w, depth)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_reference(x, w, depth)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x and w must lie on one CUDA device or both on "
                         f"the CPU, got {x.device} and {w.device}")
    if not (x.is_contiguous() and w6.is_contiguous()):
        raise ValueError("conv3x3 needs contiguous x and w")
    N, H, W, C = x.shape
    route = _pick_route(route, conv3x3_route(C, w6.shape[-1], x.dtype),
                        x.dtype)
    if route in ("wgmma", "wgmma_tf32x3"):
        # zero channels add nothing to the sum
        x = pad_channels(x, route_channels(C, route))
        w6 = pad_channels(w6, x.shape[-1], dim=-2)
    if route in ("wgmma", "wgmma_tf32x3", "few"):
        _check_aligned(route, x=x)
    if route == "wgmma":  # TMA reads the weights as they are
        _check_aligned(route, w=w6)
    padded = x.shape[-1] != C
    y = torch.empty((N, H, W, w6.shape[-1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _LAUNCH[route](x, w6, y, depth)
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
    kz = 1 if len(w_shape) == 4 else w_shape[-5]
    plane_taps = N if kz == 1 else (N // depth) * (3 * depth - 2)
    return 2 * (3 * H - 2) * (3 * W - 2) * C * w_shape[-1] * plane_taps


# conv3x3_wgrad_wgmma (csrc/conv3x3_wgrad_wgmma.cu): 4 x 16 positions per
# stage; per kernel the input and output channels of a block, whether it
# sums the three z-taps itself, and the most position tiles a split may sum
# (the f32 and z-first bf16 kernels promote their accumulators; the
# descriptor kernel keeps its sums short instead); one block per SM is
# resident
_WGR_TILE_H, _WGR_TILE_W = 4, 16
_WGR_KERNELS = {
    # name: (the C entry's code, ci tile, co tile, all z-taps in one block,
    # most tiles a split)
    "tf32x3_n32": (0, 32, 32, False, 2048),
    "tf32x3_n64": (1, 32, 64, False, 32),
    "bf16_zfirst": (2, 32, 32, True, 2048),
    "bf16_desc_n32": (3, 64, 32, False, 288),
    "bf16_desc_n64": (4, 64, 64, False, 288),
}
_WGR_SMS = 132
# the fewest position tiles a split sums
_WGR_MIN_TILES = 16
# conv3x3_c1's weight gradient (csrc/conv3x3_c1.cu): positions per tile
# (bf16 8 x 64, f32 4 x 64), 32 output channels per block; a block sums a
# contiguous range of tiles, one wave of blocks, two per SM
_C1_TILE = {torch.bfloat16: (8, 64), torch.float32: (4, 64)}
_C1_TCO = 32
_C1_TARGET_BLOCKS = 2 * 132


def _wgrad_check(x, dy, depth, kz, members=None):
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"x (N, H, W, C) and dy (N, H, W, CO) must share "
                         f"N, H, W, got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if kz not in (1, 3):
        raise ValueError(f"kz must be 1 or 3, got {kz}")
    _check_members(x.shape[0], members or 1, depth)
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise ValueError(f"x and dy must both be float32 or bfloat16, got "
                         f"{x.dtype} and {dy.dtype}")


def conv3x3_wgrad_reference(x: torch.Tensor, dy: torch.Tensor,
                            depth: int = 1, kz: int = 3,
                            members=None) -> torch.Tensor:
    """Plain PyTorch version: `torch.nn.grad.conv{2,3}d_weight` in f32 on
    channels-first views.  Returns (kz, 3, 3, C, CO) f32; with `members`
    M, (M, kz, 3, 3, C, CO), one member after another."""
    _wgrad_check(x, dy, depth, kz, members)
    if members is not None:
        return torch.stack([
            conv3x3_wgrad_reference(xm, dym, depth, kz) for xm, dym in
            zip(_member_planes(x, members), _member_planes(dy, members))])
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


@functools.lru_cache(maxsize=None)
def cuda_core_wgrad_plan(depth: int, H: int, W: int, C: int, CO: int, dtype,
                         kz: int = 3) -> dict:
    """How `csrc/conv3x3_wgrad.cu` runs one volume's weight gradient on
    the "cuda_core" route: `depth` planes of (H, W), C input and CO output
    channels, kz z-taps, from this volume's shape alone (never from the
    batch, `patch_group` or the members side by side, so that a volume's
    partial sums are the same whatever launch carries it).
    * ci: the input channels of an item (the N of its mma.sync tiles), C
      rounded up to 8 (f32), 16 or 32, else items of 32; an item's output
      channels are 32;
    * splits, per_split: runs of per_split 8 x 16 position tiles (the last
      shorter, none empty) that cut the volume, enough for
      `_CC_TARGET_BLOCKS` (two waves of 132 SMs) of one volume's kz x
      ceil(C / ci) x ceil(CO / 32) items, at most one run a tile; every
      volume of the launch is cut the same way, and a member's volumes x
      splits partials are added in a fixed order.
    Cached."""
    cis = _CCW_CI[dtype]
    ci = next(c for c in cis if C <= c or c == cis[-1])
    th, tw = _CCW_TILE
    tiles = depth * -(-H // th) * -(-W // tw)
    items = kz * -(-C // ci) * -(-CO // _CCW_CH)
    splits = max(1, min(tiles, -(-_CC_TARGET_BLOCKS // items)))
    per = -(-tiles // splits)
    return dict(ci=ci, splits=-(-tiles // per), per_split=per)


def wgrad_kernel(C: int, CO: int, dtype) -> str:
    """The kernel of `csrc/conv3x3_wgrad_wgmma.cu` that runs a weight
    gradient of C input and CO output channels: for f32 "tf32x3_n32" (32
    output channels a block) where CO < 64, else "tf32x3_n64" (64, no
    promotion: short splits); for bf16 "bf16_zfirst" (the three z-taps in
    one block, planes walked first) where C <= 32, else "bf16_desc_n32" or
    "bf16_desc_n64" (both operands by descriptor, one z-tap a block, 32
    output channels a block for CO <= 32, else 64)."""
    if dtype == torch.float32:
        return "tf32x3_n32" if CO < 64 else "tf32x3_n64"
    if C <= 32:
        return "bf16_zfirst"
    return "bf16_desc_n32" if CO <= 32 else "bf16_desc_n64"


@functools.lru_cache(maxsize=None)
def wgrad_plan(N: int, H: int, W: int, C: int, CO: int, dtype,
               kz: int = 3) -> dict:
    """How `csrc/conv3x3_wgrad_wgmma.cu` runs one weight gradient: x (N,
    H, W, C) and dy (N, H, W, CO) of `dtype`, kz z-taps.
    * kernel: `wgrad_kernel(C, CO, dtype)`, code: its number in the C
      entry; ci, co: the input and output channels of a block;
    * tiles: 4 x 16 position tiles (a stage each, or a step of the z-first
      walk);
    * items: the blocks of one split, channel tiles of C and CO, times the
      z-taps where a block takes one; neighbours in the launch order, so
      that they meet in L2;
    * splits: runs of position tiles, one a block of each item, none
      empty: of the counts that give each split 16 tiles to the kernel's
      most (2048; 32 for "tf32x3_n64", 288 by descriptor), the one that
      gives each SM the most of a split's work per wave, splits /
      ceil(splits x items / 132), the fewest such; blocks = splits x
      items, waves = ceil(blocks / 132).
    The splits follow from N: a grouped step sums a plane in another order
    than the ungrouped one (held by tolerance, ROADMAP C).  `reason` says
    why a launch has fewer blocks than SMs (None if not); `longest`: the
    most positions one block sums.  Cached: the search over split counts
    takes milliseconds of host time at the top level, once per shape."""
    kernel = wgrad_kernel(C, CO, dtype)
    code, ci, co, zfirst, most_tiles = _WGR_KERNELS[kernel]
    tiles = N * -(-H // _WGR_TILE_H) * -(-W // _WGR_TILE_W)
    items = -(-C // ci) * -(-CO // co) * (1 if zfirst else kz)
    least = -(-tiles // most_tiles)
    most = max(least, tiles // _WGR_MIN_TILES)
    splits, best = least, 0.0
    for s in range(least, most + 1):
        # no empty split: the kernel gives each ceil(tiles / s) tiles
        s = -(-tiles // -(-tiles // s))
        rate = s / -(-s * items // _WGR_SMS)
        if rate > best:
            splits, best = s, rate
    blocks = splits * items
    reason = None
    if blocks < _WGR_SMS:
        reason = (f"{items} items x {splits} splits: a split sums at least "
                  f"{_WGR_MIN_TILES} of the {tiles} position tiles")
    per = -(-tiles // splits)
    return dict(kernel=kernel, code=code, ci=ci, co=co, tiles=tiles,
                items=items, splits=splits, blocks=blocks,
                waves=-(-blocks // _WGR_SMS), reason=reason,
                longest=per * _WGR_TILE_H * _WGR_TILE_W)


def wgrad_c1_splits(x_shape, co: int, dtype) -> int:
    """How many blocks share the sum over positions on the "c1" route:
    one wave of `_C1_TARGET_BLOCKS` over the output-channel tiles, at least
    one position tile each."""
    N, H, W, _ = x_shape
    th, tw = _C1_TILE[dtype]
    tiles = N * (-(-H // th)) * (-(-W // tw))
    return max(1, min(tiles, _C1_TARGET_BLOCKS // -(-co // _C1_TCO)))


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor, depth: int = 1,
                  kz: int = 3, route=None, members=None) -> torch.Tensor:
    """dW[kz,ky,kx,ci,co] = sum_{n,h,w} x[n+kz-KZ//2, h+ky-1, w+kx-1, ci]
    * dy[n,h,w,co], zero-padded as `conv3x3` pads: the weight gradient of
    `conv3x3(x, W, depth)`.  Returns (kz, 3, 3, C, CO) f32; with `members`
    M (x and dy M members' planes, module docstring), (M, kz, 3, 3, C, CO),
    each member's sum over its own planes.  CPU tensors take the plain
    version; CUDA tensors the kernel of `conv3x3_wgrad_route`, or of a
    forced route as in `conv3x3`."""
    _wgrad_check(x, dy, depth, kz, members)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return conv3x3_wgrad_reference(x, dy, depth, kz, members)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"x and dy must lie on one CUDA device or both on "
                         f"the CPU, got {x.device} and {dy.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv3x3_wgrad needs contiguous x and dy")
    N, H, W, C = x.shape
    CO = dy.shape[-1]
    M = members or 1
    route = _pick_route(route, conv3x3_wgrad_route(C, CO, x.dtype), x.dtype)
    if route_channels(C, route) != C:
        # the gradient of the zero channels is computed and dropped
        dw = conv3x3_wgrad(pad_channels(x, route_channels(C, route)), dy,
                           depth, kz, route, members)
        conv3x3_wgrad.padded_launches += 1
        return dw[..., :C, :].contiguous()
    # one member's planes: every plan and split count is theirs
    n_shape = (N // M, H, W, C)
    code = _DTYPE_CODES[x.dtype]
    if route in ("wgmma", "wgmma_tf32x3"):
        _check_aligned(route, x=x, dy=dy)
        plan = wgrad_plan(N // M, H, W, C, CO, x.dtype, kz)
        splits, code = plan["splits"], plan["code"]
        fn = build.function("conv3x3_wgrad_wgmma", "dgtta_conv3x3_wgrad_wgmma",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                            + [ctypes.c_void_p])
    elif route == "c1":
        _check_aligned(route, dy=dy)
        splits = wgrad_c1_splits(n_shape, CO, x.dtype)
        fn = build.function("conv3x3_c1", "dgtta_conv3x3_wgrad_c1",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p])
    elif route == "few":
        _check_aligned(route, x=x, dy=dy)
        splits = few_plan(N // M, depth, H, W, C, CO, x.dtype, kz,
                          wgrad=True)["blocks"]
        fn = build.function("conv3x3_few", "dgtta_conv3x3_wgrad_few",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                            + [ctypes.c_void_p])
    else:
        plan = cuda_core_wgrad_plan(depth, H, W, C, CO, x.dtype, kz)
        splits = plan["splits"]
        e = x.element_size()
        # x's granule, and dy's: 16 bytes where its rows allow, else x's
        vec = cuda_core_vec(e, C * e, x.data_ptr())
        dvec = cuda_core_vec(e, CO * e, dy.data_ptr())
        if dvec != 16:
            vec = dvec = min(vec, dvec)
        fn = build.function("conv3x3_wgrad", "dgtta_conv3x3_wgrad",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                            + [ctypes.c_void_p])
    dw = torch.empty((M, kz, 3, 3, C, CO), dtype=torch.float32,
                     device=x.device)
    # a member's partial sums (on "cuda_core" each volume's splits)
    n_part = splits * (N // M // depth if route == "cuda_core" else 1)
    scratch = (torch.empty((M, n_part) + tuple(dw.shape[1:]),
                           dtype=torch.float32, device=x.device)
               if n_part > 1 else None)
    args = [x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), N, M, depth, H, W]
    if route == "cuda_core":
        args += [C, CO, kz, plan["ci"], splits, plan["per_split"], vec,
                 dvec]
    else:
        args += [CO, kz, splits] if route == "c1" else [C, CO, kz, splits]
    args.append(code)
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad {route} kernel launch failed with "
                           f"CUDA error {err} for x {tuple(x.shape)} "
                           f"{x.dtype}, dy {tuple(dy.shape)}, depth {depth}, "
                           f"kz {kz}, members {M}")
    _count(conv3x3_wgrad, route)
    return dw if members is not None else dw[0]


conv3x3_wgrad.launches = conv3x3_wgrad.padded_launches = 0
conv3x3_wgrad.wgmma_launches = conv3x3_wgrad.tf32x3_launches = 0
conv3x3_wgrad.c1_launches = conv3x3_wgrad.few_launches = 0


class Conv3x3Function(torch.autograd.Function):
    """`conv3x3` with its backward: dx through `conv3x3` with flipped,
    channel-swapped weights (skipped when x needs no gradient, as the
    image entering the first conv), dW through `conv3x3_wgrad`; members'
    weights (M, kz, 3, 3, C, CO) get each member's gradient."""

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
            # (kz, ky, kx) flipped, C and CO swapped, per member
            wt = w5.flip((-5, -4, -3)).transpose(-2, -1).contiguous()
            dx = conv3x3(dy, wt if w.dim() >= 5 else wt[0], ctx.depth)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, dy, ctx.depth, kz=w5.shape[-5],
                               members=w.shape[0] if w.dim() == 6 else None)
            dw = dw.reshape(w.shape).to(w.dtype)
        return dx, dw, None


def conv3x3_op(x: torch.Tensor, w: torch.Tensor,
               depth: int = 1) -> torch.Tensor:
    """`conv3x3(x, w, depth)` that autograd differentiates through the
    port's kernels (`Conv3x3Function`)."""
    return Conv3x3Function.apply(x, w, depth)
