"""Bucket padding and patch extraction of channels-last volumes (the port
of `dg_tta_tpu/core/patches.py`).

The reference's `get_batch` (torch_utils.py:13-76): a diagonal affine with
scale patch_size / volume_size and a uniform random translation that keeps
the patch inside the volume; the image is sampled trilinearly with the
volume's minimum outside it, labels by nearest neighbour with zeros.
Volumes are zero-padded at the high end to a bucket shape and the true
shape is folded into the sampling affine, as in the JAX package.

The random draws come from the caller (`tta/draws.py`) instead of a PRNG
key: per patch a volume index and three uniforms in [0, 1) in (D, H, W)
order.  The affines are computed on the host in f32, in the JAX package's
order of operations, because the unit-stride image path needs the integer
start of each patch; the sampling runs on the volumes' device.
"""

import numpy as np
import torch
import torch.nn.functional as F

from dg_tta_tpu_torch.kernels.warp import _unnormalize, warp_affine_flat


def pad_to_bucket(vol: torch.Tensor, bucket_shape, pad_value=0.0):
    """Pad a (D, H, W, C) volume at the high end to bucket_shape.

    For image volumes pass pad_value=float(vol.min()): the reference treats
    everything outside the volume as the volume minimum.  Labels pad with 0.
    """
    D, H, W, C = vol.shape
    bd, bh, bw = bucket_shape
    if not (bd >= D and bh >= H and bw >= W):
        raise ValueError(f"bucket {tuple(bucket_shape)} smaller than volume "
                         f"{tuple(vol.shape)}")
    return F.pad(vol, (0, 0, 0, bw - W, 0, bh - H, 0, bd - D),
                 value=float(pad_value))


def bucket_shape_for(shape, multiple: int = 32, min_size=None):
    """Round a volume shape up to `multiple` per axis."""
    out = tuple(-(-int(s) // multiple) * multiple for s in shape)
    if min_size is not None:
        out = tuple(max(o, m) for o, m in zip(out, min_size))
    return out


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def patch_affine(uniforms, true_shape, patch_size, fixed: bool = False):
    """Patch-sampling affine (1, 3, 4), f32 on the CPU, in the true-volume
    normalized frame.  uniforms: 3 draws in [0, 1) in (D, H, W) order
    (ignored when fixed, the centre patch).  Scales are flipped to the
    grid's (x, y, z) = (W, H, D) order."""
    t_patch = _f32(patch_size)
    t_in = _f32(true_shape)
    scales_xyz = (t_patch / t_in).flip(0)
    if fixed:
        offset_xyz = torch.zeros(3)
    else:
        rand = 2.0 * _f32(uniforms) - 1.0
        offset_range = ((t_in - t_patch) / t_in).clamp_min(0.0)
        offset_xyz = (rand * offset_range).flip(0)
    theta = torch.cat([torch.eye(3) * scales_xyz[None, :],
                       offset_xyz[:, None]], dim=1)
    return theta[None]


def _compose_pad_correction(theta, true_shape, padded_shape):
    """Map true-volume normalized coords into padded-volume normalized
    coords: with align_corners=False and padding at the high end,
    u_padded = a * u_true + (a - 1), a = S_true / S_padded per xyz axis."""
    a_xyz = (_f32(true_shape) / _f32(padded_shape)).flip(0)
    theta2 = theta * a_xyz[None, :, None]
    theta2[:, :, 3] += a_xyz[None] - 1.0
    return theta2


def sample_with_affine(vol_padded, true_shape, theta, patch_size,
                       mode: str = "trilinear", pad_with_min: bool = True):
    """Sample one (1, *patch_size, C) patch of a (D, H, W, C) volume by a
    true-frame affine (1, 3, 4), through the warp kernel's affine entry
    (`warp_affine_flat`: the grid of `affine_grid`, built in the kernel)."""
    theta = _compose_pad_correction(theta, true_shape, vol_padded.shape[:3])
    D, H, W, C = vol_padded.shape
    vol = vol_padded
    if pad_with_min:
        vmin = vol.min()
        vol = vol - vmin
    flat = vol.movedim(-1, 0).reshape(1, C, D * H * W).contiguous()
    patch = warp_affine_flat(flat, (D, H, W), theta.to(vol.device),
                             patch_size, mode=mode, padding_mode="zeros")
    patch = patch.reshape(1, C, *patch_size).movedim(1, -1)
    return patch + vmin if pad_with_min else patch


def _padded_block(v, start, size, fill):
    """v[start : start + size] per spatial axis with `fill` (a 0-d tensor)
    outside v: the slice of the JAX package's patch-size padding, without
    padding the whole volume."""
    block = v.new_empty((*size, v.shape[-1])).fill_(fill)
    src, dst = [], []
    for s, n, extent in zip(start, size, v.shape[:3]):
        lo, hi = max(s, 0), min(s + n, extent)
        if hi <= lo:
            return block
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    block[tuple(dst)] = v[tuple(src)]
    return block


def sample_unit_stride(vol_padded, true_shape, theta, patch_size,
                       pad_with_min: bool = True):
    """Trilinear patch of a `patch_affine` affine without a warp.

    The patch grid has exactly unit voxel spacing and one constant
    fractional offset per axis, so trilinear sampling is one (P+1)^3 block
    and three lerps with scalar weights: the same sampling positions as
    `sample_with_affine`, with the volume minimum outside the volume.
    Returns (1, *patch_size, C).
    """
    Dp, Hp, Wp, _ = vol_padded.shape
    Pd, Ph, Pw = patch_size
    theta2 = _compose_pad_correction(theta, true_shape, (Dp, Hp, Wp))

    def start(ax, p_out, size_in):
        base0 = 1.0 / p_out - 1.0  # first align_corners=False coordinate
        return _unnormalize(theta2[0, ax, ax] * base0 + theta2[0, ax, 3],
                            size_in, False)

    cx, cy, cz = start(0, Pw, Wp), start(1, Ph, Hp), start(2, Pd, Dp)
    oz, oy, ox = torch.floor(cz), torch.floor(cy), torch.floor(cx)
    fz, fy, fx = (float(cz - oz), float(cy - oy), float(cx - ox))
    # the JAX package shifts the whole volume by its minimum and pads with
    # zeros; filling with the minimum and shifting the block is the same
    vmin = (vol_padded.min() if pad_with_min
            else vol_padded.new_zeros(()))
    blk = _padded_block(vol_padded, (int(oz), int(oy), int(ox)),
                        (Pd + 1, Ph + 1, Pw + 1), vmin) - vmin
    blk = blk[:-1] * (1.0 - fz) + blk[1:] * fz
    blk = blk[:, :-1] * (1.0 - fy) + blk[:, 1:] * fy
    blk = blk[:, :, :-1] * (1.0 - fx) + blk[:, :, 1:] * fx
    return (blk + vmin)[None]


def extract_batch(vol_idx, uniforms, vols_padded, true_shapes, patch_size,
                  batch_size: int, labels_padded=None, fixed: bool = False):
    """A batch of patches from a stack of bucket-padded volumes.

    vol_idx: `batch_size` volume indices; uniforms: (batch_size, 3) draws
    (see `patch_affine`; None with fixed); vols_padded (N, D, H, W, C); true_shapes (N, 3)
    true (D, H, W) per volume; labels_padded optional (N, D, H, W, 1).
    Image and label share each patch's affine.  Returns imgs
    (B, *patch_size, C) and labels (B, *patch_size, 1) or None.
    """
    true_shapes = np.asarray(true_shapes, dtype=np.float32)
    uniforms = (np.zeros((batch_size, 3), np.float32) if uniforms is None
                else np.asarray(uniforms, np.float32).reshape(batch_size, 3))
    imgs, labs = [], []
    for b in range(batch_size):
        i = int(vol_idx[b])
        theta = patch_affine(uniforms[b], true_shapes[i], patch_size,
                             fixed=fixed)
        imgs.append(sample_unit_stride(vols_padded[i], true_shapes[i], theta,
                                       patch_size, pad_with_min=True)[0])
        if labels_padded is not None:
            labs.append(sample_with_affine(labels_padded[i], true_shapes[i],
                                           theta, patch_size, mode="nearest",
                                           pad_with_min=False)[0])
    imgs = torch.stack(imgs)
    return imgs, (torch.stack(labs) if labels_padded is not None else None)


def extract_patch(vol_padded, true_shape, patch_size, uniforms=None,
                  fixed: bool = False, mode: str = "trilinear",
                  pad_with_min: bool = True):
    """One (1, *patch_size, C) patch of a padded (D, H, W, C) volume; for
    labels pass mode="nearest", pad_with_min=False."""
    theta = patch_affine(uniforms, true_shape, patch_size, fixed=fixed)
    if mode == "trilinear":
        return sample_unit_stride(vol_padded, true_shape, theta, patch_size,
                                  pad_with_min=pad_with_min)
    return sample_with_affine(vol_padded, true_shape, theta, patch_size,
                              mode=mode, pad_with_min=pad_with_min)
