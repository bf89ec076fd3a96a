"""Trilinear and nearest resampling of channels-first flat volumes: the
Hopper kernel and its plain version.

Replaces `dg_tta_tpu/ops/experimental/warp_pallas_staged.py::
grid_sample_flat_pallas` (reached through `ops/warp_pallas.py::
warp_flat_auto`) and computes `dg_tta_tpu/core/grid.py::grid_sample_flat`:
`flat` (B, C, D*H*W) sampled at an (x, y, z) tuple of (B, Do, Ho, Wo)
normalized coordinates gives (B, C, Do*Ho*Wo).  Trilinear or nearest
(half to even), zeros or border padding, both `align_corners`, any source
and output shapes.  f32 or bf16 in, f32 sums, output in the input's type.

The CUDA source (`csrc/warp.cu`) says what bounds it on an H100 and what
its design does about that.  `warp_flat` launches the kernel for CUDA
tensors, or raises; it runs `warp_flat_reference` only for tensors on the
CPU.  `warp_flat.launches` counts the kernel's launches.
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


def warp_bytes(flat_shape, n_source: int, n_out: int,
               element_size: int) -> int:
    """Bytes one call must move: the `n_source` source voxels it needs
    (`warp_source_voxels`) read once per channel, three f32 coordinates per
    output voxel, the output written once."""
    B, C, _ = flat_shape
    return (C * n_source + B * C * n_out) * element_size + 3 * 4 * B * n_out


def warp_flops(flat_shape, n_out: int, mode: str = "trilinear") -> int:
    """Operations of one call: per output voxel and channel, 8 multiply-adds
    (trilinear) or none (nearest)."""
    B, C, _ = flat_shape
    return 0 if mode == "nearest" else 16 * B * C * n_out
