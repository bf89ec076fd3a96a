"""Preprocessing with nnUNet-v2 semantics (CPU, once per volume).

Re-implements the pipeline the reference invokes through
`DefaultPreprocessor.run_case` (upstream DG-TTA dg_tta/tta/nnunet_utils.py:
170-204): transpose → crop-to-nonzero → per-channel normalization → spline
resample to the plans' target spacing; plus the inverse path used at export
(`convert_predicted_logits_to_segmentation_with_correct_shape`,
nnunet_utils.py:17-18,221-225): resample logits back, argmax, un-crop.

Divergences (documented):
* spline resampling uses scipy.ndimage.zoom (mode="nearest") instead of
  skimage.transform.resize; values agree in the interior, edge handling
  differs at the last voxel ring.

nnUNet's "separate z" low-res path for >3x anisotropy IS special-cased (see
`_resample_data` below and tests/test_data.py): in-plane spline resample per
slice, then nearest/linear along z, both directions of the pipeline.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


@dataclasses.dataclass
class Fingerprint:
    """Per-channel foreground intensity statistics (plans.json
    `foreground_intensity_properties_per_channel`)."""

    mean: float
    std: float
    percentile_00_5: float
    percentile_99_5: float

    @classmethod
    def from_plans(cls, plans: dict, channel: int = 0) -> "Fingerprint":
        p = plans["foreground_intensity_properties_per_channel"][str(channel)]
        return cls(mean=p["mean"], std=p["std"],
                   percentile_00_5=p["percentile_00_5"],
                   percentile_99_5=p["percentile_99_5"])


@dataclasses.dataclass
class PreprocInfo:
    """Everything needed to map a prediction back to the original geometry."""

    original_shape: Tuple[int, ...]      # (D, H, W) after transpose_forward
    original_spacing: Tuple[float, ...]  # (z, y, x) after transpose_forward
    bbox: Tuple[Tuple[int, int], ...]    # crop bounds per axis (lo, hi)
    cropped_shape: Tuple[int, ...]
    resampled_shape: Tuple[int, ...]
    target_spacing: Tuple[float, ...]
    transpose_forward: Tuple[int, ...] = (0, 1, 2)


def crop_to_nonzero(data: np.ndarray, seg: Optional[np.ndarray] = None):
    """Crop (C, D, H, W) data to the bounding box of nonzero voxels.

    Matches nnUNet: the nonzero mask is the union over channels; voxels
    outside it get seg label -1 (consumed by masked normalization).
    Returns (data, seg, bbox).
    """
    mask = np.zeros(data.shape[1:], bool)
    for c in range(data.shape[0]):
        mask |= data[c] != 0
    if not mask.any():
        bbox = tuple((0, s) for s in data.shape[1:])
    else:
        axes_idx = np.where(mask)
        bbox = tuple((int(a.min()), int(a.max()) + 1) for a in axes_idx)
    sl = tuple(slice(lo, hi) for lo, hi in bbox)
    data = data[(slice(None),) + sl]
    mask = mask[sl]
    if seg is not None:
        seg = seg[(slice(None),) + sl].copy()
        seg[(np.broadcast_to(~mask, seg.shape))] = -1
    else:
        seg = np.where(mask, 0, -1)[None].astype(np.int8)
    return data, seg, bbox


def normalize(data: np.ndarray, schemes: Sequence[str],
              use_mask_for_norm: Sequence[bool], plans: dict,
              seg: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-channel normalization (nnUNet scheme names from plans.json)."""
    out = data.astype(np.float32, copy=True)
    for c in range(data.shape[0]):
        scheme = schemes[c % len(schemes)]
        use_mask = use_mask_for_norm[c % len(use_mask_for_norm)]
        x = out[c]
        if scheme == "CTNormalization":
            fp = Fingerprint.from_plans(plans, c)
            x = np.clip(x, fp.percentile_00_5, fp.percentile_99_5)
            x = (x - fp.mean) / max(fp.std, 1e-8)
        elif scheme in ("ZScoreNormalization", "ZScore"):
            if use_mask and seg is not None:
                m = seg[0] >= 0
                mean, std = float(x[m].mean()), float(x[m].std())
                x = np.where(m, (x - mean) / max(std, 1e-8), x)
            else:
                mean, std = float(x.mean()), float(x.std())
                x = (x - mean) / max(std, 1e-8)
        elif scheme in ("NoNormalization", "None", None):
            pass
        else:
            raise ValueError(f"Unknown normalization scheme {scheme!r}")
        out[c] = x
    return out


def _new_shape(shape, old_spacing, new_spacing):
    return tuple(int(round(s * o / n))
                 for s, o, n in zip(shape, old_spacing, new_spacing))


ANISOTROPY_THRESHOLD = 3.0  # nnUNet's separate_z_anisotropy_threshold


def get_do_separate_z(spacing, threshold: float = ANISOTROPY_THRESHOLD):
    """nnUNet: resample the low-resolution axis separately (nearest) when
    the spacing anisotropy exceeds 3x (default_resampling semantics).
    Returns the anisotropic axis index or None."""
    spacing = np.asarray(spacing, float)
    if spacing.max() / spacing.min() > threshold:
        return int(np.argmax(spacing))
    return None


def resample_to_spacing(data: np.ndarray, old_spacing, new_spacing,
                        is_seg: bool = False, order: int = 3,
                        separate_z_axis=None) -> np.ndarray:
    """Resample (C, D, H, W) to a new (z, y, x) spacing.

    Data: spline of `order`.  Seg: per-label one-hot, linear, argmax
    (nnUNet's resample_data_or_seg(is_seg=True) behavior).
    separate_z_axis: when set (nnUNet's "do_separate_z" path for >3x
    anisotropic spacings), in-plane slices are resampled with `order` and
    the anisotropic axis with order-0 nearest-slice mapping.
    """
    new_shape = _new_shape(data.shape[1:], old_spacing, new_spacing)
    if separate_z_axis is not None:
        return resample_separate_z(data, new_shape, separate_z_axis,
                                   is_seg=is_seg, order=order)
    return resample_to_shape(data, new_shape, is_seg=is_seg, order=order)


def resample_separate_z(data: np.ndarray, new_shape, axis: int,
                        is_seg: bool = False, order: int = 3) -> np.ndarray:
    """nnUNet's separate-z resampling (default_resampling.py semantics):
    each slice along the anisotropic `axis` is resampled in-plane with
    `order` (segs per-label one-hot, order 1), then the axis itself is
    mapped with order-0 nearest using sklearn-resize coordinate centers
    (idx = scale * (i + 0.5) - 0.5, rounded) — no interpolation ACROSS
    slices, which would blur thick-slice data.

    Args: data (C, D, H, W); axis is spatial (0..2).
    """
    spatial = list(data.shape[1:])
    new_shape = list(new_shape)
    inplane_new = [s for i, s in enumerate(new_shape) if i != axis]

    # in-plane pass, slice by slice along `axis`
    out_slices = []
    for z in range(spatial[axis]):
        sl = [slice(None)] * 3
        sl[axis] = z
        plane = data[(slice(None), *sl)]  # (C, a, b)
        plane = resample_to_shape(plane, inplane_new, is_seg=is_seg,
                                  order=1 if is_seg else order)
        out_slices.append(plane)
    stacked = np.stack(out_slices, axis=1 + axis)  # (C, ...) old-z-count

    # along-axis pass: nearest-slice selection at sklearn-style centers
    old_n, new_n = spatial[axis], new_shape[axis]
    if old_n != new_n:
        scale = old_n / new_n
        idx = np.round(scale * (np.arange(new_n) + 0.5) - 0.5).astype(int)
        idx = np.clip(idx, 0, old_n - 1)
        stacked = np.take(stacked, idx, axis=1 + axis)
    return stacked


def resample_to_shape(data: np.ndarray, new_shape, is_seg: bool = False,
                      order: int = 3) -> np.ndarray:
    if tuple(data.shape[1:]) == tuple(new_shape):
        return data
    zoom = [n / s for n, s in zip(new_shape, data.shape[1:])]
    if not is_seg:
        out = np.stack([
            ndimage.zoom(data[c].astype(np.float32), zoom, order=order,
                         mode="nearest", grid_mode=False)
            for c in range(data.shape[0])])
        # guard rounding: zoom can be off by one voxel
        return _crop_or_pad(out, new_shape)
    out_channels = []
    for c in range(data.shape[0]):
        labels = np.unique(data[c])
        acc = np.zeros(new_shape, np.float32)
        lab_out = np.full(new_shape, labels[0], data.dtype)
        for lbl in labels[1:] if len(labels) > 1 else []:
            oh = (data[c] == lbl).astype(np.float32)
            ohr = ndimage.zoom(oh, zoom, order=1, mode="nearest")
            ohr = _crop_or_pad(ohr[None], new_shape)[0]
            better = ohr > acc
            sel = better & (ohr >= 0.5)
            lab_out[sel] = lbl
            acc = np.maximum(acc, ohr)
        out_channels.append(lab_out)
    return np.stack(out_channels)


def _crop_or_pad(x: np.ndarray, shape) -> np.ndarray:
    """Force (C, *) spatial dims to `shape` (rounding guard for zoom)."""
    sl = (slice(None),) + tuple(slice(0, s) for s in shape)
    x = x[sl]
    pads = [(0, 0)] + [(0, s - d) for s, d in zip(shape, x.shape[1:])]
    if any(p[1] for p in pads):
        x = np.pad(x, pads, mode="edge")
    return x


def preprocess_case(data: np.ndarray, props: dict, plans: dict,
                    configuration: str = "3d_fullres",
                    seg: Optional[np.ndarray] = None):
    """Full preprocessing of one case.

    Args:
      data: (C, D, H, W) raw image, props from `read_nifti`.
    Returns:
      (data_pp (C, D', H', W') float32, seg_pp or None, PreprocInfo)
    """
    cfg = plans["configurations"][configuration]
    tf = tuple(plans.get("transpose_forward", [0, 1, 2]))
    data = np.transpose(data, (0,) + tuple(t + 1 for t in tf))
    if seg is not None:
        seg = np.transpose(seg, (0,) + tuple(t + 1 for t in tf))
    spacing = tuple(np.asarray(props["spacing"], float)[list(tf)])
    original_shape = data.shape[1:]

    data, seg_c, bbox = crop_to_nonzero(data, seg)
    cropped_shape = data.shape[1:]

    data = normalize(data, cfg["normalization_schemes"],
                     cfg["use_mask_for_norm"], plans, seg_c)

    target_spacing = tuple(cfg["spacing"])
    sep_axis = get_do_separate_z(spacing)
    data = resample_to_spacing(data, spacing, target_spacing, order=3,
                               separate_z_axis=sep_axis)
    seg_out = None
    if seg is not None:
        seg_out = resample_to_spacing(seg_c, spacing, target_spacing,
                                      is_seg=True, order=1,
                                      separate_z_axis=sep_axis)

    info = PreprocInfo(
        original_shape=tuple(original_shape),
        original_spacing=tuple(float(s) for s in spacing),
        bbox=bbox,
        cropped_shape=tuple(cropped_shape),
        resampled_shape=tuple(data.shape[1:]),
        target_spacing=target_spacing,
        transpose_forward=tf,
    )
    return data.astype(np.float32), seg_out, info


def undo_preprocessing_logits(logits: np.ndarray, info: PreprocInfo) -> np.ndarray:
    """Map (D', H', W', C) predicted logits back to the original geometry:
    resample to the cropped shape (linear), argmax, paste into the original
    shape at the crop bbox, undo the transpose.  Returns (D, H, W) uint16."""
    ch_first = np.moveaxis(logits, -1, 0)
    sep_axis = get_do_separate_z(info.original_spacing)
    if sep_axis is not None:
        back = resample_separate_z(ch_first, info.cropped_shape, sep_axis,
                                   order=1)
    else:
        back = resample_to_shape(ch_first, info.cropped_shape, order=1)
    seg_cropped = np.argmax(back, axis=0)
    out = np.zeros(info.original_shape, np.uint16)
    sl = tuple(slice(lo, hi) for lo, hi in info.bbox)
    out[sl] = seg_cropped
    tb = np.argsort(info.transpose_forward)
    return np.transpose(out, tb)
