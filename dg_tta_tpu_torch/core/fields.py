"""Random affine augmentation fields (the affine part of
`dg_tta_tpu/core/fields.py`).

The JAX package draws its noise from a PRNG key inside `get_rand_affine`.
JAX's threefry and torch's generators never give the same bits, so here the
caller hands in the standard-normal noise (`tta/draws.py`), and the same
noise gives the same affine in both packages.  The deformable fields come
with a later slice.
"""

import torch


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
