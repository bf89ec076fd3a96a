"""Gaussian-weighted sliding-window ensemble inference (the port of
`dg_tta_tpu/infer/sliding_window.py`).

nnUNet's predictor semantics: a 0.5-overlap window grid, Gaussian
importance weighting, logit accumulation, and the mean over an ensemble of
networks (the TTA-adapted members).  Mirroring is absent, as in the DG
trainers.

Eager PyTorch needs no static shapes, so unlike the JAX program this one
runs only the valid window origins: the padded, masked origins that
`window_origins` adds to bucket compilations are skipped.  A volume whose
grid has n windows costs n x E network forwards.  The members run one
after another on each window batch; accumulators live on the volume's
device, in bf16 for bf16 models, and are normalized in f32.
"""

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

from dg_tta_tpu_torch.core.patches import bucket_shape_for


def compute_gaussian(patch_size, sigma_scale: float = 1.0 / 8,
                     value_scaling_factor: float = 10.0) -> np.ndarray:
    """Gaussian importance map, nnUNet semantics: unit impulse at the patch
    center, blurred with sigma = patch_size * sigma_scale, peak-normalized,
    scaled, and floored to its smallest nonzero value."""
    tmp = np.zeros(patch_size, dtype=np.float32)
    center = tuple(s // 2 for s in patch_size)
    tmp[center] = 1.0
    g = gaussian_filter(tmp, sigma=[s * sigma_scale for s in patch_size])
    g = g / g.max() * value_scaling_factor
    g = g.astype(np.float32)
    nonzero_min = g[g > 0].min()
    g[g == 0] = nonzero_min
    return g


def compute_steps_for_sliding_window(image_size, patch_size,
                                     step_fraction: float = 0.5):
    """Per-axis window start positions, nnUNet semantics: cover [0, I-k] with
    ceil((I-k)/(k*f))+1 evenly spread, rounded starts."""
    steps = []
    for i, k in zip(image_size, patch_size):
        assert i >= k, (image_size, patch_size)
        if i == k:
            steps.append([0])
            continue
        target = k * step_fraction
        num = int(math.ceil((i - k) / target)) + 1
        actual = (i - k) / (num - 1)
        steps.append([int(round(actual * j)) for j in range(num)])
    return steps


def window_origins(image_size, patch_size, step_fraction: float = 0.5,
                   pad_multiple: int = 8):
    """All (z, y, x) window origins plus a validity mask, padded with
    invalid (0, 0, 0) origins to a multiple of `pad_multiple`."""
    steps = compute_steps_for_sliding_window(image_size, patch_size,
                                             step_fraction)
    origins = np.array([(z, y, x) for z in steps[0] for y in steps[1]
                        for x in steps[2]], dtype=np.int32)
    n = origins.shape[0]
    n_pad = -(-n // pad_multiple) * pad_multiple
    valid = np.zeros((n_pad,), np.float32)
    valid[:n] = 1.0
    origins = np.concatenate(
        [origins, np.zeros((n_pad - n, 3), np.int32)], axis=0)
    return origins, valid


def padded_shape(volume_shape, patch_size, bucket_multiple: int = 32):
    """The (D, H, W) that `predict_volume` pads a volume to: at least the
    patch, then up to a multiple of `bucket_multiple` per axis."""
    covered = [max(int(s), int(k)) for s, k in zip(volume_shape, patch_size)]
    if bucket_multiple > 1:
        covered = bucket_shape_for(covered, multiple=bucket_multiple)
    return tuple(covered)


@torch.no_grad()
def predict_volume(model, members: Sequence[torch.nn.Module],
                   vol: torch.Tensor, modify_input_fn=None,
                   modify_output_fn=None, bucket_multiple: int = 32,
                   window_batch: int = 1) -> torch.Tensor:
    """Ensemble-mean logits of a (D, H, W, C) volume, (D, H, W, C_out) f32
    on the volume's device.

    The volume is padded with its minimum to at least the patch size and
    then to a multiple of `bucket_multiple` per axis, symmetrically (the
    JAX package's geometry, so both give the same window grid); the pad
    band is cropped away.  `window_batch` windows go through each member
    as one batch.  The modifier functions take and return
    (B, D, H, W, C) and run on every window, as the reference's model
    hooks do.  No epsilon in the normalization: every voxel is covered by
    a window whose floored Gaussian weight is > 0.
    """
    members = list(members)
    if not members:
        raise ValueError("predict_volume needs at least one member")
    wb = int(window_batch)
    if wb < 1:
        raise ValueError(f"window_batch must be >= 1, got {window_batch}")
    D, H, W, _ = vol.shape
    patch = tuple(model.patch_size)
    covered = padded_shape((D, H, W), patch, bucket_multiple)
    pads = [(t - s) // 2 for s, t in zip((D, H, W), covered)]
    pads = [(lo, t - s - lo) for lo, s, t in zip(pads, (D, H, W), covered)]
    volp = F.pad(vol, (0, 0, *pads[2], *pads[1], *pads[0]),
                 value=float(vol.min()))
    origins, valid = window_origins(volp.shape[:3], patch, pad_multiple=1)
    origins = origins[valid > 0].tolist()

    dtype = (torch.bfloat16 if model.compute_dtype == "bfloat16"
             else torch.float32)
    n_out = model.spec.num_classes
    gauss = torch.from_numpy(compute_gaussian(patch)).to(vol.device)[..., None]
    gauss_acc = gauss.to(dtype)
    acc = torch.zeros((*volp.shape[:3], n_out), dtype=dtype,
                      device=vol.device)
    wacc = torch.zeros((*volp.shape[:3], 1), dtype=dtype, device=vol.device)
    pd, ph, pw = patch

    for g0 in range(0, len(origins), wb):
        group = origins[g0:g0 + wb]
        patches = torch.stack([volp[z:z + pd, y:y + ph, x:x + pw]
                               for z, y, x in group])
        total = None
        for net in members:
            x = patches if modify_input_fn is None else modify_input_fn(patches)
            logits = model.apply(net, x)
            if modify_output_fn is not None:
                logits = modify_output_fn(logits)
            total = logits.float() if total is None else total + logits.float()
        mean = total / len(members)
        for i, (z, y, x) in enumerate(group):
            acc[z:z + pd, y:y + ph, x:x + pw] += (mean[i] * gauss).to(dtype)
            wacc[z:z + pd, y:y + ph, x:x + pw] += gauss_acc

    out = acc.float() / wacc.float()
    return out[pads[0][0]:pads[0][0] + D, pads[1][0]:pads[1][0] + H,
               pads[2][0]:pads[2][0] + W]
