"""Bucket padding of channels-last volumes (the part of
`dg_tta_tpu/core/patches.py` that inference uses)."""

import torch
import torch.nn.functional as F


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
