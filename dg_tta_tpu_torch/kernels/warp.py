"""Trilinear and nearest resampling of channels-first flat volumes: the
Hopper kernel and its plain version.

Replaces `dg_tta_tpu/ops/experimental/warp_pallas_staged.py::
grid_sample_flat_pallas` (reached through `ops/warp_pallas.py::
warp_flat_auto`) and computes `dg_tta_tpu/core/grid.py::grid_sample_flat`:
`flat` (B, C, D*H*W) sampled at an (x, y, z) tuple of (B, Do, Ho, Wo)
normalized coordinates gives (B, C, Do*Ho*Wo).  Trilinear or nearest
(half to even), zeros or border padding, both `align_corners`, any source
and output shapes.  f32 or bf16 in, f32 sums, output in the input's type.

Two entries into the kernel (`csrc/warp.cu`, which says what bounds it on
an H100 and what its design does about that):
* `warp_flat` samples at a grid, an (x, y, z) tuple of coordinate arrays;
* `warp_affine_flat` samples at the grid `core/grid.affine_grid(theta,
  out_spatial)` would make, built in the kernel from theta's 12 numbers per
  batch entry (no grid in memory, bit for bit the same points), with an
  optional per-batch factor on the output; every warp of adaptation takes
  it.
Each launches the kernel for CUDA tensors, or raises; it runs its plain
version (`warp_flat_reference`, `warp_affine_reference`) only for tensors
on the CPU.  `warp_flat.launches` and `warp_affine_flat.launches` count
the kernel's launches through each.
"""

import ctypes

import torch

from dg_tta_tpu_torch.kernels import build

SOURCE = "dg_tta_tpu_torch/kernels/csrc/warp.cu"
REPLACES = "dg_tta_tpu/ops/experimental/warp_pallas_staged.py:360"
MODES = ("trilinear", "nearest")
PADDINGS = ("zeros", "border")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _launch(flat, gx, gy, gz, out, src_spatial, nearest, border, align):
    fn = build.function("warp", "dgtta_warp",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_longlong] + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
    B, C, _ = flat.shape
    D, H, W = src_spatial
    err = fn(flat.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
             out.data_ptr(), B, C, D, H, W, out.shape[2], int(nearest),
             int(border), int(align), _DTYPE_CODES[flat.dtype],
             torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed with CUDA error {err} "
                           f"for flat {tuple(flat.shape)} {flat.dtype}, "
                           f"source {tuple(src_spatial)}, output "
                           f"{out.shape[2]} voxels")


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
        _launch(flat, gx, gy, gz, out, src_spatial, mode == "nearest",
                padding_mode == "border", align_corners)
    warp_flat.launches += 1
    return out


warp_flat.launches = 0


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
             ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 11
            + [ctypes.c_void_p]))
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
        1 if scale is not None and scale.shape[0] > 1 else 0, out.data_ptr(),
        B, C, D, H, W, Do, Ho, Wo, int(mode == "nearest"),
        int(padding_mode == "border"), _DTYPE_CODES[flat.dtype],
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


def warp_bytes(flat_shape, n_source: int, n_out: int, element_size: int,
               grid_bytes: int) -> int:
    """Bytes one call must move: the `n_source` source voxels it needs
    (`warp_source_voxels`) read once per channel, the output written once,
    and `grid_bytes` of sample points: three f32 coordinates per output
    voxel for `warp_flat` (12 * B * n_out), theta's 48 bytes per batch
    entry for `warp_affine_flat`."""
    B, C, _ = flat_shape
    return (C * n_source + B * C * n_out) * element_size + grid_bytes


def warp_flops(flat_shape, n_out: int, mode: str = "trilinear") -> int:
    """Operations of one call: per output voxel and channel, 8 multiply-adds
    (trilinear) or none (nearest)."""
    B, C, _ = flat_shape
    return 0 if mode == "nearest" else 16 * B * C * n_out
