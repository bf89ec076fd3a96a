"""Pretraining dataset pipeline: fingerprint, plans, preprocessed store,
folds, and the foreground-oversampling patch sampler (the port's copy of
`dg_tta_tpu/train/dataset.py`, numpy only, on the port's own `data/`
modules: on the same seed it gives the same arrays, bit for bit).

Covers the nnUNet surfaces the reference's `dgtta pretrain` reaches through
`nnunetv2` (SURVEY §2.2): fingerprint extraction, experiment planning,
preprocessing to an on-disk store, 5-fold splits, and nnUNet's patch
sampling rule (33% of patches forced to contain foreground).

The experiment planner here is deliberately simple (median spacing/shape,
fixed feature schedule, pool until the patch is small or 5 stages) — plans
produced by real nnUNet are accepted unchanged, which is the expected path
for parity work.
"""

import json
from pathlib import Path

import numpy as np

from dg_tta_tpu_torch.data.io import SUPPORTED_ENDINGS, read_image
from dg_tta_tpu_torch.data.preprocess import preprocess_case


def fingerprint_dataset(raw_dir, num_cases: int = 50, seed: int = 0):
    """Crop shapes, spacings and foreground intensity stats over (a sample
    of) the training cases -> dataset_fingerprint dict."""
    raw_dir = Path(raw_dir)
    with open(raw_dir / "dataset.json") as f:
        dataset_json = json.load(f)
    images = sorted((raw_dir / "imagesTr").iterdir())
    rng = np.random.default_rng(seed)
    if len(images) > num_cases:
        images = [images[i] for i in
                  rng.choice(len(images), num_cases, replace=False)]

    spacings, shapes, fg_samples = [], [], []
    for img_path in images:
        data, props = read_image(img_path)
        case = img_path.name
        for ext in SUPPORTED_ENDINGS:
            if case.endswith(ext):
                case = case[: -len(ext)]
        case = case.rsplit("_", 1)[0]
        ext = "".join(Path(img_path).suffixes)
        seg_path = raw_dir / "labelsTr" / f"{case}{ext}"
        spacings.append(list(props["spacing"]))
        shapes.append(list(data.shape[1:]))
        if seg_path.is_file():
            seg, _ = read_image(seg_path)
            fg = data[0][seg[0] > 0]
            if fg.size:
                k = min(10000, fg.size)
                fg_samples.append(rng.choice(fg, k, replace=False))

    fg = np.concatenate(fg_samples) if fg_samples else np.zeros((1,))
    return {
        "spacings": spacings,
        "shapes_after_crop": shapes,
        "foreground_intensity_properties_per_channel": {
            "0": {
                "mean": float(fg.mean()),
                "std": float(fg.std()),
                "median": float(np.median(fg)),
                "min": float(fg.min()),
                "max": float(fg.max()),
                "percentile_00_5": float(np.percentile(fg, 0.5)),
                "percentile_99_5": float(np.percentile(fg, 99.5)),
            }
        },
    }


def plan_experiment(dataset_json: dict, fingerprint: dict,
                    dataset_name: str = "DatasetXXX",
                    max_patch=(112, 112, 128)) -> dict:
    """Generate a plans dict (simplified nnUNet ExperimentPlanner)."""
    spacings = np.asarray(fingerprint["spacings"], float)
    shapes = np.asarray(fingerprint["shapes_after_crop"], float)
    target_spacing = np.median(spacings, axis=0)
    median_shape = np.median(shapes * spacings / target_spacing, axis=0)

    patch = [int(min(m, p)) for m, p in zip(
        (np.floor(median_shape / 16) * 16).clip(min=32), max_patch)]

    n_stages = 1
    s = np.asarray(patch, float)
    pools = [[1, 1, 1]]
    while n_stages < 5 and np.all(s / 2 >= 4) and np.all(s % 2 == 0):
        s = s / 2
        pools.append([2, 2, 2])
        n_stages += 1

    # detect CT by clipped-looking stats (fallback: zscore)
    schemes = (["CTNormalization"]
               if "CT" in str(dataset_json.get("channel_names",
                                               {"0": ""})).upper()
               else ["ZScoreNormalization"])

    return {
        "dataset_name": dataset_name,
        "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel":
            fingerprint["foreground_intensity_properties_per_channel"],
        "configurations": {
            "3d_fullres": {
                "data_identifier": "nnUNetPlans_3d_fullres",
                "preprocessor_name": "DefaultPreprocessor",
                "batch_size": 2,
                "patch_size": patch,
                "spacing": [float(x) for x in target_spacing],
                "normalization_schemes": schemes,
                "use_mask_for_norm": [False],
                "UNet_class_name": "PlainConvUNet",
                "UNet_base_num_features": 32,
                "unet_max_num_features": 320,
                "n_conv_per_stage_encoder": [2] * n_stages,
                "n_conv_per_stage_decoder": [2] * (n_stages - 1),
                "pool_op_kernel_sizes": pools,
                "conv_kernel_sizes": [[3, 3, 3]] * n_stages,
                "batch_dice": True,
            }
        },
    }


def preprocess_dataset(raw_dir, plans: dict, out_dir,
                       configuration: str = "3d_fullres"):
    """Preprocess all training cases into an .npz store.

    Each case file holds `data` (C, D, H, W) float32, `seg` (1, D, H, W)
    int16, and `fg_coords` — up to 10k foreground voxel coordinates for the
    oversampling patch sampler (nnUNet stores the same idea in its *.pkl
    properties)."""
    raw_dir, out_dir = Path(raw_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    images = sorted((raw_dir / "imagesTr").iterdir())
    rng = np.random.default_rng(0)
    cases = []
    for img_path in images:
        case = img_path.name
        for ext in SUPPORTED_ENDINGS:
            if case.endswith(ext):
                case = case[: -len(ext)]
        case = case.rsplit("_", 1)[0]
        ext = "".join(Path(img_path).suffixes)
        data, props = read_image(img_path)
        seg_path = raw_dir / "labelsTr" / f"{case}{ext}"
        seg = None
        if seg_path.is_file():
            seg_raw, _ = read_image(seg_path)
            seg = seg_raw.astype(np.int16)
        data_pp, seg_pp, info = preprocess_case(data, props, plans,
                                                configuration, seg=seg)
        if seg_pp is None:
            seg_pp = np.zeros((1, *data_pp.shape[1:]), np.int16)
        fg = np.argwhere(seg_pp[0] > 0)
        if fg.shape[0] > 10000:
            fg = fg[rng.choice(fg.shape[0], 10000, replace=False)]
        np.savez_compressed(out_dir / f"{case}.npz", data=data_pp,
                            seg=seg_pp.astype(np.int16),
                            fg_coords=fg.astype(np.int32))
        cases.append(case)
    return cases


def make_splits(cases, n_folds: int = 5, seed: int = 12345):
    """Deterministic 5-fold CV splits (nnUNet splits_final.json shape)."""
    rng = np.random.default_rng(seed)
    cases = sorted(cases)
    order = rng.permutation(len(cases))
    folds = [[] for _ in range(n_folds)]
    for i, idx in enumerate(order):
        folds[i % n_folds].append(cases[idx])
    splits = []
    for f in range(n_folds):
        val = sorted(folds[f])
        train = sorted(c for c in cases if c not in val)
        splits.append({"train": train, "val": val})
    return splits


class PatchSampler:
    """Random patches with nnUNet's 33% forced-foreground oversampling.

    Keeps decompressed cases in an LRU cache; sampling itself is numpy
    (host-side) and feeds fixed-shape batches to the device."""

    def __init__(self, store_dir, cases, patch_size,
                 oversample_fg: float = 0.33, cache_size: int = 8,
                 seed: int = 0):
        self.store_dir = Path(store_dir)
        self.cases = list(cases)
        self.patch_size = tuple(patch_size)
        self.oversample_fg = oversample_fg
        self.reseed(seed)
        self._cache = {}
        self._cache_size = cache_size

    def reseed(self, *seed):
        """Restart the patch stream from `seed` (ints: `default_rng`'s
        seed sequence)."""
        self.rng = np.random.default_rng(seed if len(seed) > 1 else seed[0])

    def _load(self, case):
        if case not in self._cache:
            if len(self._cache) >= self._cache_size:
                self._cache.pop(next(iter(self._cache)))
            with np.load(self.store_dir / f"{case}.npz") as z:
                self._cache[case] = {k: z[k] for k in z.files}
        return self._cache[case]

    def _one(self):
        case = self.cases[self.rng.integers(len(self.cases))]
        entry = self._load(case)
        data, seg, fg = entry["data"], entry["seg"], entry["fg_coords"]
        shape = np.asarray(data.shape[1:])
        psz = np.asarray(self.patch_size)

        force_fg = (self.rng.random() < self.oversample_fg
                    and fg.shape[0] > 0)
        if force_fg:
            center = fg[self.rng.integers(fg.shape[0])]
            lo = center - psz // 2
        else:
            max_lo = np.maximum(shape - psz, 0)
            lo = self.rng.integers(0, max_lo + 1)

        lo = np.clip(lo, -(psz // 2), np.maximum(shape - psz // 2, 0))
        hi = lo + psz
        pad_lo = np.maximum(-lo, 0)
        pad_hi = np.maximum(hi - shape, 0)
        lo_c = np.maximum(lo, 0)
        hi_c = np.minimum(hi, shape)
        sl = tuple(slice(a, b) for a, b in zip(lo_c, hi_c))
        img = data[(slice(None),) + sl]
        lab = seg[(slice(None),) + sl]
        pads = [(0, 0)] + [(int(a), int(b)) for a, b in zip(pad_lo, pad_hi)]
        img = np.pad(img, pads, mode="constant",
                     constant_values=float(data.min()))
        lab = np.pad(lab, pads, mode="constant", constant_values=0)
        return img, lab

    def batch(self, batch_size: int):
        imgs, labs = zip(*(self._one() for _ in range(batch_size)))
        # channels-last device layout
        return (np.stack([np.moveaxis(i, 0, -1) for i in imgs]),
                np.stack([np.moveaxis(l, 0, -1) for l in labs]))
