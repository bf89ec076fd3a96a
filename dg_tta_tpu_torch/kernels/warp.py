"""Trilinear and nearest resampling of channels-first flat volumes: the
Hopper kernel and its plain version.

Replaces `dg_tta_tpu/ops/experimental/warp_pallas_staged.py::
grid_sample_flat_pallas` (reached through `ops/warp_pallas.py::
warp_flat_auto`) and computes `dg_tta_tpu/core/grid.py::grid_sample_flat`:
`flat` (B, C, D*H*W) sampled at an (x, y, z) tuple of (B, Do, Ho, Wo)
normalized coordinates gives (B, C, Do*Ho*Wo).  Trilinear or nearest
(half to even), zeros or border padding, both `align_corners`, any source
and output shapes.  f32 or bf16 in, f32 sums, output in the input's type.

Two forward entries (`csrc/warp.cu`, which says what bounds them on an
H100 and what its design does about that):
* `warp_flat` samples at a grid, an (x, y, z) tuple of coordinate arrays:
  a deformable plan's fields and warps take it;
* `warp_affine_flat` samples at the grid `core/grid.affine_grid(theta,
  out_spatial)` would make, built in the kernel from theta's 12 numbers per
  batch entry (no grid in memory, bit for bit the same points), with an
  optional per-batch factor on the output; every warp of an affine plan's
  adaptation takes it.  Its blocks take 3D bricks of outputs and stage each
  brick's source box in shared memory (`warp_plan` sizes both), or gather
  from device memory where the box does not fit.
A third entry is the exact adjoint of the grid entry's trilinear warp,
the scatter-add that autodiff of the JAX package's gather computes:
* `warp_flat_adjoint` gives the gradient with respect to `flat` of
  `sum(warp_flat(flat, ...) * g)`; `warp_flat_op` is the grid entry as an
  autograd Function whose backward it is.
Each launches the kernel for CUDA tensors, or raises; it runs its plain
version (`warp_flat_reference`, `warp_affine_reference`,
`warp_flat_adjoint_reference`) only for tensors on the CPU.
`warp_flat.launches`, `warp_affine_flat.launches` and
`warp_flat_adjoint.launches` count the kernel's launches through each;
`brick_paths` counts the forward entries' blocks by path on the card (the
affine entry's bricks staged or gathered from device memory; the grid
entry's blocks all the latter), and `warp_brick_paths` predicts those
counts.
"""

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from dg_tta_tpu_torch.kernels import build

SOURCE = "dg_tta_tpu_torch/kernels/csrc/warp.cu"
REPLACES = "dg_tta_tpu/ops/experimental/warp_pallas_staged.py:360"
MODES = ("trilinear", "nearest")
PADDINGS = ("zeros", "border")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The affine entry's brick of outputs, a block's unit of work, is 32
# x-consecutive outputs (a warp's lanes) by 8 y by `depth` z (csrc/warp.cu's
# kBX, kBY, KBZ); the grid entry's blocks take GRID_BLOCK consecutive
# outputs (kFlat), one a thread, in the kernel of the wide register budget
# from GRID_WIDE_C channels on.
BRICK_XY = (8, 32)
GRID_BLOCK = 256
GRID_WIDE_C = 4
# Source voxels per channel that an affine block's box buffer is sized for,
# by brick depth: under the TTA's draws (get_rand_affine at strength 0.05)
# a 4-deep brick's box holds ~2800-3200 at the median draw and up to ~5300
# (bf16 rows are widened to 8 voxels), an 8-deep one's ~5000.
STAGE_VOXELS = {4: 6144, 8: 12288}
# The largest box buffer: four blocks fit an SM's 228 KB of shared memory
# (four f32 channels of a 4-deep brick: 3520 voxels).
STAGE_MAX = 55 << 10
_PATHS = []  # the device counters of the open `brick_paths`


def warp_plan(channels: int, element_size: int) -> tuple:
    """(brick depth, box buffer bytes) of an affine entry call.  Bricks 8
    deep for C <= 2, whose boxes are small, so that a block's fixed work
    (the box, its copy, its barrier) spreads over more outputs; 4 deep for
    more channels, whose boxes of all channels must fit the buffer.  The
    buffer holds STAGE_VOXELS of the depth in every channel, at most
    STAGE_MAX; a brick whose box of all channels does not fit gathers from
    device memory.  (The grid entry stages nothing.)"""
    depth = 8 if channels <= 2 else 4
    return depth, min(channels * element_size * STAGE_VOXELS[depth],
                      STAGE_MAX)


def warp_bricks(batch: int, out_spatial, depth: int) -> int:
    """Bricks of one call of the forward kernel at brick depth `depth`."""
    n = batch
    for s, b in zip(out_spatial, (depth, *BRICK_XY)):
        n *= -(-int(s) // b)
    return n


@contextlib.contextmanager
def brick_paths(device=None):
    """While open, the forward entries' kernel adds one to a device
    counter of each brick's path: yields an int64 CUDA tensor (staged,
    global), read after the launches complete.  Off (no counter passed)
    otherwise, as on the main path."""
    counts = torch.zeros(2, dtype=torch.int64,
                         device=device if device is not None else "cuda")
    _PATHS.append(counts)
    try:
        yield counts
    finally:
        _PATHS.remove(counts)


def _paths_ptr(device) -> int:
    return next((c.data_ptr() for c in reversed(_PATHS)
                 if c.device == device), 0)


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _check(flat, src_spatial, grid, mode, padding_mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if padding_mode not in PADDINGS:
        raise ValueError(f"padding_mode must be one of {PADDINGS}, got "
                         f"{padding_mode!r}")
    if flat.dim() != 3:
        raise ValueError(f"flat must be (B, C, N), got {tuple(flat.shape)}")
    D, H, W = (int(s) for s in src_spatial)
    if flat.shape[2] != D * H * W:
        raise ValueError(f"flat {tuple(flat.shape)} does not hold a "
                         f"{(D, H, W)} volume")
    if flat.dtype not in _DTYPE_CODES:
        raise ValueError(f"flat must be float32 or bfloat16, got {flat.dtype}")
    if len(grid) != 3:
        raise ValueError("grid must be an (x, y, z) tuple")
    out_spatial = tuple(grid[0].shape[-3:])
    for g in grid:
        if g.dim() != 4 or tuple(g.shape[-3:]) != out_spatial \
                or g.shape[0] not in (1, flat.shape[0]):
            raise ValueError(f"grid arrays must be (B, Do, Ho, Wo), got "
                             f"{[tuple(c.shape) for c in grid]}")
    return (D, H, W), out_spatial


def warp_flat_reference(flat, src_spatial, grid, mode: str = "trilinear",
                        padding_mode: str = "zeros",
                        align_corners: bool = False):
    """Plain PyTorch version: the JAX `grid_sample_flat` with
    `torch.gather`, corner by corner in its order, computed in f32 and
    cast to flat's type."""
    (D, H, W), out_spatial = _check(flat, src_spatial, grid, mode,
                                    padding_mode)
    B, C, _ = flat.shape
    gx, gy, gz = (g.float().expand(B, *out_spatial) for g in grid)
    x = _unnormalize(gx, W, align_corners)
    y = _unnormalize(gy, H, align_corners)
    z = _unnormalize(gz, D, align_corners)
    src = flat.float()

    def gather(zi, yi, xi, w=None):
        inb = ((zi >= 0) & (zi <= D - 1) & (yi >= 0) & (yi <= H - 1)
               & (xi >= 0) & (xi <= W - 1))
        lin = ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
               + xi.clamp(0, W - 1)).reshape(B, 1, -1)
        vals = torch.gather(src, 2, lin.expand(B, C, lin.shape[-1]))
        if padding_mode == "zeros":
            scale = inb.float() if w is None else w * inb.float()
        else:
            scale = w
        if scale is not None:
            vals = vals * scale.reshape(B, 1, -1)
        return vals

    if mode == "nearest":
        out = gather(*(torch.round(c).long() for c in (z, y, x)))
        return out.to(flat.dtype)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx, ty, tz = x - x0, y - y0, z - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    out = (gather(z0, y0, x0, (1 - tz) * (1 - ty) * (1 - tx))
           + gather(z0, y0, x1, (1 - tz) * (1 - ty) * tx)
           + gather(z0, y1, x0, (1 - tz) * ty * (1 - tx))
           + gather(z0, y1, x1, (1 - tz) * ty * tx)
           + gather(z1, y0, x0, tz * (1 - ty) * (1 - tx))
           + gather(z1, y0, x1, tz * (1 - ty) * tx)
           + gather(z1, y1, x0, tz * ty * (1 - tx))
           + gather(z1, y1, x1, tz * ty * tx))
    return out.to(flat.dtype)


def _launch(flat, gx, gy, gz, out, src_spatial, out_spatial, nearest,
            border, align):
    fn = build.function("warp", "dgtta_warp",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                        + [ctypes.c_void_p] * 2)
    B, C, _ = flat.shape
    err = fn(flat.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
             out.data_ptr(), B, C, *src_spatial, *out_spatial, int(nearest),
             int(border), int(align), _DTYPE_CODES[flat.dtype],
             int(C >= GRID_WIDE_C), _paths_ptr(flat.device),
             torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed with CUDA error {err} "
                           f"for flat {tuple(flat.shape)} {flat.dtype}, "
                           f"source {tuple(src_spatial)}, output "
                           f"{tuple(out_spatial)}")


def warp_flat(flat, src_spatial, grid, mode: str = "trilinear",
              padding_mode: str = "zeros", align_corners: bool = False):
    """`flat` (B, C, D*H*W) resampled at `grid`, an (x, y, z) tuple of
    (B, Do, Ho, Wo) normalized coordinates (batch 1 broadcasts): returns
    (B, C, Do*Ho*Wo) in flat's type.  CPU tensors take the plain version;
    CUDA tensors the kernel."""
    src_spatial, out_spatial = _check(flat, src_spatial, grid, mode,
                                      padding_mode)
    devices = {flat.device, *(g.device for g in grid)}
    if devices == {torch.device("cpu")}:
        return warp_flat_reference(flat, src_spatial, grid, mode,
                                   padding_mode, align_corners)
    if flat.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"flat and grid must lie on one CUDA device or all "
                         f"on the CPU, got {sorted(map(str, devices))}")
    if not flat.is_contiguous():
        raise ValueError("warp_flat needs a contiguous flat volume")
    B, C, _ = flat.shape
    gx, gy, gz = (g.to(torch.float32).expand(B, *out_spatial).contiguous()
                  for g in grid)
    n_out = out_spatial[0] * out_spatial[1] * out_spatial[2]
    out = torch.empty((B, C, n_out), dtype=flat.dtype, device=flat.device)
    with torch.cuda.device(flat.device):
        _launch(flat, gx, gy, gz, out, src_spatial, out_spatial,
                mode == "nearest", padding_mode == "border", align_corners)
    warp_flat.launches += 1
    return out


warp_flat.launches = 0


def warp_flat_adjoint_reference(g, src_spatial, grid,
                                padding_mode: str = "zeros",
                                align_corners: bool = False):
    """Plain PyTorch version of `warp_flat_adjoint`: autograd of
    `warp_flat_reference` (trilinear) with respect to its f32 input, cast
    to g's type."""
    D, H, W = (int(s) for s in src_spatial)
    x = torch.zeros((g.shape[0], g.shape[1], D * H * W), device=g.device,
                    requires_grad=True)
    with torch.enable_grad():
        out = warp_flat_reference(x, (D, H, W), tuple(c.detach() for c in grid),
                                  "trilinear", padding_mode, align_corners)
        (dx,) = torch.autograd.grad(out, x, g.float())
    return dx.to(g.dtype)


_ADJOINT_FN = []  # the C entry, resolved at the first launch


def warp_flat_adjoint(g, src_spatial, grid, padding_mode: str = "zeros",
                      align_corners: bool = False):
    """The exact adjoint of the trilinear `warp_flat(flat, src_spatial,
    grid, padding_mode=..., align_corners=...)`: for `g` (B, C, Do*Ho*Wo)
    at `grid` (an (x, y, z) tuple of (B or 1, Do, Ho, Wo) coordinates),
    returns the gradient of `sum(warp_flat(flat, ...) * g)` with respect to
    `flat`, (B, C, D*H*W) in g's type.  CPU tensors take the plain version;
    CUDA tensors the kernel (an f32 scatter-add by atomics, cast to bf16 by
    one pass for a bf16 g)."""
    if padding_mode not in PADDINGS:
        raise ValueError(f"padding_mode must be one of {PADDINGS}, got "
                         f"{padding_mode!r}")
    if g.dim() != 3 or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"g must be a float32 or bfloat16 (B, C, N') "
                         f"tensor, got {tuple(g.shape)} {g.dtype}")
    D, H, W = (int(s) for s in src_spatial)
    if len(grid) != 3:
        raise ValueError("grid must be an (x, y, z) tuple")
    out_spatial = tuple(grid[0].shape[-3:])
    B, C, n_out = g.shape
    for c in grid:
        if c.dim() != 4 or tuple(c.shape[-3:]) != out_spatial \
                or c.shape[0] not in (1, B):
            raise ValueError(f"grid arrays must be (B, Do, Ho, Wo), got "
                             f"{[tuple(a.shape) for a in grid]}")
    if n_out != out_spatial[0] * out_spatial[1] * out_spatial[2]:
        raise ValueError(f"g {tuple(g.shape)} does not hold the grid's "
                         f"{out_spatial} outputs")
    devices = {g.device, *(c.device for c in grid)}
    if devices == {torch.device("cpu")}:
        return warp_flat_adjoint_reference(g, (D, H, W), grid, padding_mode,
                                           align_corners)
    if g.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"g and grid must lie on one CUDA device or all on "
                         f"the CPU, got {sorted(map(str, devices))}")
    if not g.is_contiguous():
        raise ValueError("warp_flat_adjoint needs a contiguous g")
    if not _ADJOINT_FN:
        _ADJOINT_FN.append(build.function(
            "warp", "dgtta_warp_adjoint",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]))
    gx, gy, gz = (c.to(torch.float32).expand(B, *out_spatial).contiguous()
                  for c in grid)
    dx = torch.zeros((B, C, D * H * W), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = _ADJOINT_FN[0](
            g.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
            dx.data_ptr(), B, C, D, H, W, n_out,
            int(padding_mode == "border"), int(align_corners),
            _DTYPE_CODES[g.dtype],
            torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp adjoint kernel launch failed with CUDA "
                           f"error {err} for g {tuple(g.shape)} {g.dtype}, "
                           f"source {(D, H, W)}")
    warp_flat_adjoint.launches += 1
    return dx if g.dtype == torch.float32 else dx.to(g.dtype)


warp_flat_adjoint.launches = 0


class _WarpFlatExact(torch.autograd.Function):
    """The trilinear `warp_flat` whose backward is its exact adjoint
    (`warp_flat_adjoint`); no gradient for the grid."""

    @staticmethod
    def forward(ctx, flat, src_spatial, grid, padding_mode, align_corners):
        ctx.args = (src_spatial, grid, padding_mode, align_corners)
        return warp_flat(flat, src_spatial, grid, "trilinear", padding_mode,
                         align_corners)

    @staticmethod
    def backward(ctx, g):
        return warp_flat_adjoint(g.contiguous(), *ctx.args), None, None, \
            None, None


def warp_flat_op(flat, src_spatial, grid, padding_mode: str = "zeros",
                 align_corners: bool = False):
    """The trilinear `warp_flat` through autograd: its gradient with
    respect to `flat` is the exact adjoint (`warp_flat_adjoint`)."""
    return _WarpFlatExact.apply(flat, tuple(int(s) for s in src_spatial),
                                tuple(grid), padding_mode, align_corners)


def _check_affine(flat, src_spatial, theta, out_spatial, mode, padding_mode,
                  align_corners, scale):
    """Raises on a call `warp_affine_flat` does not take; returns the source
    and output shapes as int triples.  Lean: it runs at every launch."""
    if mode not in MODES or padding_mode not in PADDINGS:
        raise ValueError(f"mode must be one of {MODES} and padding_mode one "
                         f"of {PADDINGS}, got {mode!r}, {padding_mode!r}")
    if align_corners:
        raise ValueError("warp_affine_flat builds align_corners=False grids "
                         "only; use affine_grid and warp_flat")
    D, H, W = src_spatial
    Do, Ho, Wo = out_spatial
    fs, ts = flat.shape, theta.shape
    if len(fs) != 3 or fs[2] != D * H * W or flat.dtype not in _DTYPE_CODES:
        raise ValueError(f"flat must be a float32 or bfloat16 (B, C, N) "
                         f"volume of {(D, H, W)}, got {tuple(fs)} "
                         f"{flat.dtype}")
    if len(ts) != 3 or ts[0] not in (1, fs[0]) or ts[1] != 3 or ts[2] != 4 \
            or theta.dtype != torch.float32:
        raise ValueError(f"theta must be float32 ({fs[0]} or 1, 3, 4), got "
                         f"{tuple(ts)} {theta.dtype}")
    if scale is not None and (scale.dim() != 1
                              or scale.shape[0] not in (1, fs[0])
                              or scale.dtype != torch.float32):
        raise ValueError(f"scale must be float32 ({fs[0]} or 1,), got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    return (int(D), int(H), int(W)), (int(Do), int(Ho), int(Wo))


def warp_affine_reference(flat, src_spatial, theta, out_spatial,
                          mode: str = "trilinear",
                          padding_mode: str = "zeros",
                          align_corners: bool = False, scale=None):
    """Plain PyTorch version of `warp_affine_flat`: `core/grid.affine_grid`
    then `warp_flat_reference`, times `scale` in flat's type."""
    from dg_tta_tpu_torch.core.grid import affine_grid

    src_spatial, out_spatial = _check_affine(
        flat, src_spatial, theta, out_spatial, mode, padding_mode,
        align_corners, scale)
    grid = affine_grid(theta, out_spatial, align_corners=False)
    out = warp_flat_reference(flat, src_spatial, grid, mode, padding_mode,
                              align_corners=False)
    if scale is not None:
        out = out * scale.reshape(-1, 1, 1).to(out.dtype)
    return out


_AFFINE_FN = []  # the C entry, resolved at the first launch
_BASE_TABLES = {}  # (out_spatial, device): the affine entry's base coordinates


def _base_table(out_spatial, device):
    """x_n, y_n and z_n of an output of (Do, Ho, Wo) voxels, as
    `core/grid._base_coords` computes them (on the CPU: the division is a
    true division), concatenated and kept on `device`."""
    key = (out_spatial, device)
    table = _BASE_TABLES.get(key)
    if table is None:
        from dg_tta_tpu_torch.core.grid import _base_coords

        table = torch.cat([_base_coords(n, False) for n in
                           reversed(out_spatial)]).to(device)
        _BASE_TABLES[key] = table
    return table


def warp_affine_flat(flat, src_spatial, theta, out_spatial,
                     mode: str = "trilinear", padding_mode: str = "zeros",
                     align_corners: bool = False, scale=None):
    """`flat` (B, C, D*H*W) resampled at the points of
    `affine_grid(theta, out_spatial)`: theta is a float32 (B or 1, 3, 4)
    tensor on flat's device (no host sync), `align_corners` must be False
    (every caller's), and `scale`, if given, a float32 (B or 1,) factor
    applied as `out * scale.to(flat.dtype)`.  Returns (B, C, Do*Ho*Wo) in
    flat's type, equal to `warp_flat(flat, src_spatial, affine_grid(theta,
    out_spatial), ...) * scale`.  CPU tensors take the plain version; CUDA
    tensors the kernel, with one shape check and no tensor made but the
    output."""
    src_spatial, out_spatial = _check_affine(
        flat, src_spatial, theta, out_spatial, mode, padding_mode,
        align_corners, scale)
    dev = flat.device
    if dev.type == "cpu" and theta.device == dev \
            and (scale is None or scale.device == dev):
        return warp_affine_reference(flat, src_spatial, theta, out_spatial,
                                     mode, padding_mode, False, scale)
    if dev.type != "cuda" or theta.device != dev \
            or (scale is not None and scale.device != dev):
        raise ValueError(f"flat, theta and scale must lie on one CUDA device "
                         f"or all on the CPU, got {dev}, {theta.device} and "
                         f"{None if scale is None else scale.device}")
    if not (flat.is_contiguous() and theta.is_contiguous()
            and (scale is None or scale.is_contiguous())):
        raise ValueError("warp_affine_flat needs contiguous flat, theta and "
                         "scale")
    if not _AFFINE_FN:
        _AFFINE_FN.append(build.function(
            "warp", "dgtta_warp_affine",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 13 + [ctypes.c_void_p] * 2))
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"warp_affine_flat launches on the current CUDA "
                         f"device, {torch.cuda.current_device()}, got "
                         f"tensors on {dev}")
    B, C, _ = flat.shape
    (D, H, W), (Do, Ho, Wo) = src_spatial, out_spatial
    out = torch.empty((B, C, Do * Ho * Wo), dtype=flat.dtype, device=dev)
    err = _AFFINE_FN[0](
        flat.data_ptr(), theta.data_ptr(), 12 if theta.shape[0] > 1 else 0,
        0 if scale is None else scale.data_ptr(),
        1 if scale is not None and scale.shape[0] > 1 else 0,
        _base_table(out_spatial, dev).data_ptr(), out.data_ptr(),
        B, C, D, H, W, Do, Ho, Wo, int(mode == "nearest"),
        int(padding_mode == "border"), _DTYPE_CODES[flat.dtype],
        *warp_plan(C, flat.element_size()), _paths_ptr(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp affine kernel launch failed with CUDA "
                           f"error {err} for flat {tuple(flat.shape)} "
                           f"{flat.dtype}, source {src_spatial}, output "
                           f"{out_spatial}")
    warp_affine_flat.launches += 1
    return out


warp_affine_flat.launches = 0


def warp_source_voxels(src_spatial, grid, batch: int = 1,
                       mode: str = "trilinear", padding_mode: str = "zeros",
                       align_corners: bool = False) -> int:
    """Distinct source voxels that a call at `grid` needs, summed over the
    batch: the corners it weighs with a nonzero weight that lie in range
    (border padding clamps every corner into range)."""
    D, H, W = (int(s) for s in src_spatial)
    out_spatial = tuple(grid[0].shape[-3:])
    gx, gy, gz = (g.float().expand(batch, *out_spatial).reshape(batch, -1)
                  for g in grid)
    x = _unnormalize(gx, W, align_corners)
    y = _unnormalize(gy, H, align_corners)
    z = _unnormalize(gz, D, align_corners)
    if mode == "nearest":
        corners = [(torch.round(z), torch.round(y), torch.round(x), None)]
    else:
        x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
        tx, ty, tz = x - x0, y - y0, z - z0
        corners = [(z0 + dz, y0 + dy, x0 + dx,
                    (tz if dz else 1 - tz) * (ty if dy else 1 - ty)
                    * (tx if dx else 1 - tx))
                   for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    need = torch.zeros(batch * D * H * W, dtype=torch.bool, device=gx.device)
    base = (torch.arange(batch, device=gx.device) * (D * H * W))[:, None]
    for zi, yi, xi, w in corners:
        keep = torch.ones_like(zi, dtype=torch.bool) if w is None else w != 0
        if padding_mode == "zeros":
            keep &= ((zi >= 0) & (zi <= D - 1) & (yi >= 0) & (yi <= H - 1)
                     & (xi >= 0) & (xi <= W - 1))
        lin = ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
               + xi.clamp(0, W - 1)).long() + base
        need[lin[keep]] = True
    return int(need.sum())


def warp_brick_paths(src_spatial, grid, channels: int, element_size: int,
                     batch: int = 1, mode: str = "trilinear",
                     align_corners: bool = False, affine: bool = True):
    """The forward kernel's bricks by path, (staged, global), for a call
    with a 16-byte-aligned `flat`: the affine entry (`affine`, `grid` the
    points of its `affine_grid`) stages a brick when its box of clamped
    corners, widened to 16-byte chunks where W allows, fits `warp_plan`'s
    buffer in every channel; the grid entry stages none.  Plain PyTorch on
    the grid's device.  The grid entry's counts are its blocks."""
    out_spatial = tuple(grid[0].shape[-3:])
    if not affine:
        n_out = out_spatial[0] * out_spatial[1] * out_spatial[2]
        return 0, batch * -(-n_out // GRID_BLOCK)
    depth, buffer = warp_plan(channels, element_size)
    size = tuple(int(s) for s in src_spatial)
    brick = (depth, *BRICK_XY)
    nb = [-(-s // b) for s, b in zip(out_spatial, brick)]
    pad = []
    for s, n, b in zip(reversed(out_spatial), reversed(nb), reversed(brick)):
        pad += [0, n * b - s]

    def per_brick(t, fill, reduce):
        t = F.pad(t, pad, value=fill).reshape(batch, nb[0], brick[0], nb[1],
                                              brick[1], nb[2], brick[2])
        return reduce(t, dim=(2, 4, 6)).long()

    ext = []
    for c, n, axis in zip(reversed(grid), size, "zyx"):
        u = _unnormalize(c.float().expand(batch, *out_spatial), n,
                         align_corners)
        first = torch.round(u) if mode == "nearest" else torch.floor(u)
        last = first if mode == "nearest" else first + 1
        lo = per_brick(first.clamp(0, n - 1), n, torch.amin)
        hi = per_brick(last.clamp(0, n - 1), -1, torch.amax)
        vec = 16 // element_size
        if axis == "x" and n % vec == 0:
            lo = lo - lo % vec
            ext.append((hi + vec - lo) // vec * vec)
        else:
            ext.append(hi + 1 - lo)
    box = ext[0] * ext[1] * ext[2] * channels * element_size
    staged = int((box <= buffer).sum())
    return staged, warp_bricks(batch, out_spatial, depth) - staged


def warp_bytes(flat_shape, n_source: int, n_out: int, element_size: int,
               grid_bytes: int) -> int:
    """Bytes one call must move: the `n_source` source voxels it needs
    (`warp_source_voxels`) read once per channel, the output written once,
    and `grid_bytes` of sample points: three f32 coordinates per output
    voxel for `warp_flat` (12 * B * n_out), theta's 48 bytes per batch
    entry for `warp_affine_flat`."""
    B, C, _ = flat_shape
    return (C * n_source + B * C * n_out) * element_size + grid_bytes


def warp_adjoint_bytes(g_shape, n_source: int, element_size: int) -> int:
    """Bytes one `warp_flat_adjoint` call must move: g read once, the
    (B, C, n_source) gradient written once in g's type, and three f32
    coordinates per output voxel."""
    B, C, n_out = g_shape
    return (B * C * n_out + B * C * n_source) * element_size + 12 * B * n_out


def warp_flops(flat_shape, n_out: int, mode: str = "trilinear") -> int:
    """Operations of one call: per output voxel and channel, 8 multiply-adds
    (trilinear) or none (nearest)."""
    B, C, _ = flat_shape
    return 0 if mode == "nearest" else 16 * B * C * n_out
