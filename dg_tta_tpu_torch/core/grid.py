"""Spatial resampling: affine grids and grid sampling (the port of
`dg_tta_tpu/core/grid.py`).

Conventions, as in the JAX package:
  * volumes are channels-last (B, D, H, W, C); the warps run on
    channels-first flat (B, C, D*H*W) views;
  * grids are (x, y, z) tuples of three (B, D, H, W) f32 tensors of
    normalized xyz coordinates in [-1, 1]: x indexes W, y H, z D;
  * `align_corners` follows torch.

`grid_sample_flat` is the wrapper of the hand-written warp kernel
(`kernels/warp.py`) for a grid in memory (the deformable fields and their
warps); warps by an affine call the kernel's affine entry
(`kernels/warp.warp_affine_flat`), which builds the points of
`affine_grid` itself.  Every resample of the port goes through one of the
two.
"""

import torch

from dg_tta_tpu_torch.kernels.warp import warp_flat


def _base_coords(size: int, align_corners: bool, device=None):
    """Normalized sample coordinates along one axis, torch convention,
    computed on the CPU (its division by `size` is a true division, which
    the warp kernel's affine entry repeats) and moved to `device`."""
    if align_corners:
        return torch.linspace(-1.0, 1.0, size).to(device)
    i = torch.arange(size, dtype=torch.float32)
    return ((2.0 * i + 1.0) / size - 1.0).to(device)


def identity_grid(spatial_size, align_corners: bool = False, device=None):
    """Identity grid as an (x, y, z) tuple of (D, H, W) tensors."""
    D, H, W = spatial_size
    z = _base_coords(D, align_corners, device)[:, None, None]
    y = _base_coords(H, align_corners, device)[None, :, None]
    x = _base_coords(W, align_corners, device)[None, None, :]
    shape = (D, H, W)
    return x.expand(shape), y.expand(shape), z.expand(shape)


def affine_grid(theta, spatial_size, align_corners: bool = False):
    """Sampling grid of a batch of (B, 3, 4) affines acting on xyz-ordered
    homogeneous normalized coordinates (torch `F.affine_grid` semantics).
    Returns an (x, y, z) tuple of (B, D, H, W) tensors on theta's device."""
    xb, yb, zb = identity_grid(spatial_size, align_corners, theta.device)
    out = []
    for i in range(3):
        t = theta[:, i, :, None, None, None]
        out.append(t[:, 0] * xb + t[:, 1] * yb + t[:, 2] * zb + t[:, 3])
    return tuple(out)


def pack_grid(grid):
    """(x, y, z) tuple -> (B, D, H, W, 3) packed tensor (torch interop)."""
    if isinstance(grid, (tuple, list)):
        return torch.stack(tuple(grid), dim=-1)
    return grid


def unpack_grid(grid):
    """(..., 3) packed tensor or tuple -> (x, y, z) tuple."""
    if isinstance(grid, (tuple, list)):
        return tuple(grid)
    if grid.shape[-1] != 3:
        raise ValueError(f"a packed grid ends in 3, got {tuple(grid.shape)}")
    return grid[..., 0], grid[..., 1], grid[..., 2]


def grid_sample_flat(flat, src_spatial, grid, mode: str = "trilinear",
                     padding_mode: str = "zeros",
                     align_corners: bool = False):
    """grid_sample on a channels-first flat volume: (B, C, N) -> (B, C, N')
    with N = prod(src_spatial) and N' the voxels of `grid`, an (x, y, z)
    tuple of (B, Do, Ho, Wo) coordinates (or a packed (..., 3) tensor).
    Trilinear or nearest, zeros or border padding.  Runs the warp kernel on
    CUDA tensors, its plain version on CPU tensors."""
    return warp_flat(flat, tuple(src_spatial), unpack_grid(grid), mode=mode,
                     padding_mode=padding_mode, align_corners=align_corners)


def grid_sample(vol, grid, mode: str = "trilinear",
                padding_mode: str = "zeros", align_corners: bool = False):
    """Sample a channels-last (B, D, H, W, C) volume at `grid` (torch
    `F.grid_sample` semantics): returns (B, Do, Ho, Wo, C)."""
    B, D, H, W, C = vol.shape
    grid = unpack_grid(grid)
    out_spatial = tuple(grid[0].shape[-3:])
    flat = vol.movedim(-1, 1).reshape(B, C, D * H * W).contiguous()
    out = grid_sample_flat(flat, (D, H, W), grid, mode=mode,
                           padding_mode=padding_mode,
                           align_corners=align_corners)
    return out.reshape(B, C, *out_spatial).movedim(1, -1)


def warp(vol, disp_grid, **kw):
    """Sample `vol` at `disp_grid`, an (identity + displacement) grid: the
    JAX package's convenience name for `grid_sample`."""
    return grid_sample(vol, disp_grid, **kw)


def affine_inside_mask_flat(theta, spatial_size, align_corners: bool = False):
    """(B, 1, N) f32 mask: 1 where the (B, 3, 4) affine `theta` maps the
    output voxel inside the normalized cube [-1, 1]^3 (the zero band a
    zeros-padded resample by theta stamps, without a resample)."""
    gx, gy, gz = affine_grid(theta, spatial_size, align_corners)
    inside = (gx.abs() <= 1.0) & (gy.abs() <= 1.0) & (gz.abs() <= 1.0)
    return inside.float().reshape(inside.shape[0], 1, -1)
