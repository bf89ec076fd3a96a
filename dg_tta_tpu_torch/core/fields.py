"""Random spatial augmentation fields: random affines, and the smooth,
inverse-consistent diffeomorphic displacement fields of deformable TTA
(the port of `dg_tta_tpu/core/fields.py`).

The JAX package draws its noise from a PRNG key inside `get_rand_affine`
and `get_rf_field`.  JAX's threefry and torch's generators never give the
same bits, so here the caller hands in the standard-normal noise
(`tta/draws.py`), and the same noise gives the same fields in both
packages.

The deformable fields are channels-first (B, 3, D, H, W) inside this
module: each (B, 3, N) view is the warp kernel's flat layout, and the x,
y and z components of a grid are contiguous slices, so the
scaling-and-squaring loop transposes nothing.  The public functions take
and give the JAX package's layouts.  The field warps are the warp
kernel's grid entry (`kernels/warp.warp_flat`, `align_corners=True`); the
smoothing and the resize are library calls (`F.avg_pool3d`,
`F.interpolate`), as they are XLA ops, not Pallas kernels, in the JAX
package.  Only the full-resolution field loop is ported: the JAX
package's `field_res="half"` and its `shear` field warp approximate the
math for the TPU.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dg_tta_tpu_torch.core.grid import identity_grid
from dg_tta_tpu_torch.kernels.warp import warp_flat


def get_rand_affine(noise: torch.Tensor, strength: float = 0.05):
    """Random affine near the identity plus its inverse
    (augmentation_utils.py:156-170 of the reference).

    noise: (B, 3, 4) standard-normal draws.  Returns (theta, theta_inv),
    each (B, 3, 4), acting on xyz-ordered homogeneous normalized
    coordinates.  The inverse is the closed form (adjugate over the
    determinant), as in the JAX package.
    """
    theta = noise * strength + torch.eye(3, 4, dtype=noise.dtype,
                                         device=noise.device)
    R, t = theta[:, :, :3], theta[:, :, 3]
    c0, c1, c2 = R[:, :, 0], R[:, :, 1], R[:, :, 2]
    cross12 = torch.linalg.cross(c1, c2, dim=-1)
    det = (c0 * cross12).sum(-1)
    r_inv = torch.stack([cross12, torch.linalg.cross(c2, c0, dim=-1),
                         torch.linalg.cross(c0, c1, dim=-1)],
                        dim=1) / det[:, None, None]
    t_inv = -torch.einsum("bij,bj->bi", r_inv, t)
    return theta, torch.cat([r_inv, t_inv[:, :, None]], dim=2)


def affine_abs_det(theta: torch.Tensor) -> torch.Tensor:
    """|det R| of (B, 3, 4) affines, by the triple product: (B,)."""
    R = theta[:, :, :3]
    return (R[:, :, 0] * torch.linalg.cross(R[:, :, 1], R[:, :, 2],
                                            dim=-1)).sum(-1).abs()


def compose_affine(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """The composition z -> P(Q(z)) of two (B, 3, 4) affines: R = R_P R_Q,
    t = R_P t_Q + t_P."""
    R = torch.einsum("bij,bjk->bik", P[:, :, :3], Q[:, :, :3])
    t = torch.einsum("bij,bj->bi", P[:, :, :3], Q[:, :, 3]) + P[:, :, 3]
    return torch.cat([R, t[:, :, None]], dim=2)


def _avg_pool3d_same(x, k: int):
    """Average pool of channels-first (B, C, D, H, W) `x` with stride 1 and
    zero padding k // 2 on every side, the zeros counted (torch's default,
    which the reference uses): each axis grows by 2 (k // 2) - k + 1.  The
    zeros are padded first, because `F.avg_pool3d` refuses an axis shorter
    than k, which the JAX package and small patches take."""
    p = k // 2
    return F.avg_pool3d(F.pad(x, (p,) * 6), k, stride=1)


def _resize_axis_matrix(n_in: int, n_out: int, dtype=torch.float32):
    """(n_out, n_in) linear-interpolation matrix of one axis: output-voxel
    centres mapped into the input (align_corners=False), clamped to its
    ends.  `_resize_trilinear` is the product of the three axes' matrices
    (the JAX package computes it so)."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = pos - lo
    m = np.zeros((n_out, n_in), np.float64)
    np.add.at(m, (np.arange(n_out), lo), 1.0 - f)
    np.add.at(m, (np.arange(n_out), hi), f)
    return torch.from_numpy(m).to(dtype)


def _resize_trilinear(x, size_3d):
    """Trilinear resize of channels-first (B, C, d, h, w) `x` to `size_3d`
    (F.interpolate, align_corners=False)."""
    return F.interpolate(x, size=tuple(size_3d), mode="trilinear",
                         align_corners=False)


def _rf_field(noise, size_3d, interpolation_factor: int):
    """`get_rf_field` on channels-first noise (B, F, d, h, w): three
    smoothings, the resize to `size_3d`, then zero mean and (population)
    std per (batch, field) over the spatial axes."""
    field = noise
    for _ in range(3):
        field = _avg_pool3d_same(field, interpolation_factor)
    field = _resize_trilinear(field, size_3d)
    field = field - field.mean(dim=(2, 3, 4), keepdim=True)
    std = field.std(dim=(2, 3, 4), keepdim=True, correction=0)
    return field / (1e-3 + std)


def get_rf_field(noise: torch.Tensor, size_3d, interpolation_factor: int = 4):
    """Smoothed, zero-mean, unit-std random field
    (augmentation_utils.py:8-43 of the reference).

    noise: (B, D//f, H//f, W//f, F) standard-normal draws, f the
    interpolation factor.  Returns (B, D, H, W, F), channels-last."""
    small = tuple(int(s) // interpolation_factor for s in size_3d)
    if noise.dim() != 5 or tuple(noise.shape[1:4]) != small:
        raise ValueError(f"noise must be (B, *{small}, F) for size "
                         f"{tuple(size_3d)} and factor "
                         f"{interpolation_factor}, got {tuple(noise.shape)}")
    field = _rf_field(noise.movedim(-1, 1), size_3d, interpolation_factor)
    return field.movedim(1, -1)


@functools.lru_cache(maxsize=8)
def _identity(spatial, align_corners: bool, device):
    """(1, 3, D, H, W) identity grid, x, y and z channels, on `device`.
    Cached, as is `_dim_corr`: both are built on the CPU and copied to the
    device, a copy that waits for the host and that every branch of every
    step would repeat.  Callers must not write to them."""
    return torch.stack(identity_grid(spatial, align_corners, device))[None]


@functools.lru_cache(maxsize=8)
def _dim_corr(spatial, device):
    """(1, 3, 1, 1, 1): the reference's divisor of the xyz-ordered field
    channels, (D, H, W) in that order (see
    `calc_consistent_diffeomorphic_field`)."""
    return torch.tensor(spatial, dtype=torch.float32).reshape(
        1, 3, 1, 1, 1).to(device)


def _warp_field(field, positions, padding_mode: str = "border"):
    """Channels-first (B, 3, D, H, W) `field` sampled at `positions`, a
    (B, 3, D, H, W) tensor of normalized x, y, z coordinates: the warp
    kernel's grid entry, trilinear, align_corners=True."""
    B, C, D, H, W = field.shape
    out = warp_flat(field.reshape(B, C, D * H * W), (D, H, W),
                    positions.unbind(1), padding_mode=padding_mode,
                    align_corners=True)
    return out.reshape(B, C, D, H, W)


def _diffeomorphic(disp, inv_disp, time_steps: int,
                   ensure_inverse_consistency: bool, iter_steps_override):
    """`calc_consistent_diffeomorphic_field` on channels-first
    (B, 3, D, H, W) fields."""
    B, _, D, H, W = disp.shape
    dim_corr = _dim_corr((D, H, W), disp.device)
    identity = _identity((D, H, W), True, disp.device)
    dt = 1.0 / time_steps
    steps = iter_steps_override if iter_steps_override else time_steps
    ds = disp / dim_corr / (2 ** time_steps) * dt
    inv_ds = inv_disp / dim_corr / (2 ** time_steps) * dt
    for _ in range(steps):
        # both from the old pair; 0.5 a - 0.5 b == 0.5 (a - b) exactly
        if ensure_inverse_consistency:
            ds, inv_ds = (
                (ds - _warp_field(inv_ds, identity + ds)).mul_(0.5),
                (inv_ds - _warp_field(ds, identity + inv_ds)).mul_(0.5))
        else:
            ds, inv_ds = (
                ds + _warp_field(ds, identity + ds, "zeros"),
                inv_ds + _warp_field(inv_ds, identity + inv_ds, "zeros"))
    if ensure_inverse_consistency:
        return (ds * (2 ** time_steps) * dim_corr,
                inv_ds * (2 ** time_steps) * dim_corr)
    return ds * dim_corr, inv_ds * dim_corr


def calc_consistent_diffeomorphic_field(disp_field, inverse_disp_field,
                                        time_steps: int = 1,
                                        ensure_inverse_consistency: bool = True,
                                        iter_steps_override=None):
    """Scaling and squaring with optional inverse-consistency iterations
    (augmentation_utils.py:46-135 of the reference).

    Fields are channels-last (B, D, H, W, 3) normalized-grid offsets,
    xyz-ordered.  Inside, each is divided by (D, H, W), in that order, on
    its (x, y, z) channels: the reference's quirk (the x component, which
    indexes W, is scaled by D), kept because the iterations compose in
    that scaled space.  Each iteration updates the field and its inverse
    from the old pair at once.  Returns (disp, inverse_disp),
    channels-last, in the input's units."""
    out = _diffeomorphic(disp_field.movedim(-1, 1).contiguous(),
                         inverse_disp_field.movedim(-1, 1).contiguous(),
                         time_steps, ensure_inverse_consistency,
                         iter_steps_override)
    return tuple(f.movedim(1, -1) for f in out)


# scaling-and-squaring steps of the displacement fields
# (`get_disp_field`, fields.py:216 of the JAX package)
STEPS = 5


def _disp_fields(noise, size_3d, factor: float, interpolation_factor: int):
    """`get_disp_field` as channels-first (B, 3, D, H, W) fields."""
    small = tuple(int(s) // interpolation_factor for s in size_3d)
    if noise.dim() != 5 or tuple(noise.shape[1:]) != (*small, 3):
        raise ValueError(f"noise must be (B, *{small}, 3) for size "
                         f"{tuple(size_3d)} and factor "
                         f"{interpolation_factor}, got {tuple(noise.shape)}")
    field = _rf_field(noise.movedim(-1, 1), size_3d, interpolation_factor)
    return _diffeomorphic(field * factor, torch.zeros_like(field), STEPS,
                          True, None)


def get_disp_field(noise: torch.Tensor, size_3d, factor: float = 0.1,
                   interpolation_factor: int = 5):
    """Random inverse-consistent displacement fields in normalized units
    (augmentation_utils.py:138-153 of the reference), at full resolution.

    noise: (B, D//f, H//f, W//f, 3) standard-normal draws, f the
    interpolation factor.  Returns (disp, inverse_disp), each an (x, y, z)
    tuple of (B, D, H, W) offsets to add to an identity grid."""
    disp, inv = _disp_fields(noise, size_3d, factor, interpolation_factor)
    return tuple(disp.unbind(1)), tuple(inv.unbind(1))


def deformable_grids(noise: torch.Tensor, size_3d, factor: float = 0.5,
                     interpolation_factor: int = 5):
    """The sampling grids of a deformable TTA branch: the
    `align_corners=False` identity plus `get_disp_field`'s displacement,
    and plus its inverse.  Returns (grid, grid_inv), each an (x, y, z)
    tuple of (B, D, H, W) views of one channels-first tensor."""
    disp, inv = _disp_fields(noise, size_3d, factor, interpolation_factor)
    identity = _identity(tuple(int(s) for s in size_3d), False, disp.device)
    return tuple((identity + disp).unbind(1)), \
        tuple((identity + inv).unbind(1))
