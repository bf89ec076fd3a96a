"""Label-space mapping between a pretrained model's classes and a TTA
dataset (the port of `dg_tta_tpu/core/labels.py`).

`generate_label_mapping` is the name-intersection of two `{name: idx}`
dicts; `map_label_argmaxed` rewrites label values onto the optimized label
list.
"""

import numpy as np


def generate_label_mapping(source_label_dict: dict,
                           target_label_dict: dict) -> dict:
    """{name: (source_idx, target_idx)} over the intersecting label names,
    in source-dict order."""
    assert all(isinstance(k, str) for k in source_label_dict)
    assert all(isinstance(k, str) for k in target_label_dict)
    common = set(source_label_dict) & set(target_label_dict)
    assert common, "There are no intersecting label names in given dicts."
    mapping = {}
    for key in list(source_label_dict) + list(target_label_dict):
        if key in common and key not in mapping:
            mapping[key] = (source_label_dict[key], target_label_dict[key])
    return mapping


def get_map_idxs(label_mapping: dict, optimized_labels: list,
                 input_type: str) -> np.ndarray:
    """Index vector selecting, per optimized label, its id in the source
    (pretrain) or target (tta) label space."""
    assert input_type in ("pretrain_labels", "tta_labels")
    assert optimized_labels[0] == "background"
    idxs = []
    for eval_label in optimized_labels:
        src_idx, tgt_idx = label_mapping[eval_label]
        # nnUNet dataset.json may store ids as str or list (region-based)
        pick = src_idx if input_type == "pretrain_labels" else tgt_idx
        if isinstance(pick, (list, tuple)):
            pick = pick[0]
        idxs.append(int(pick))
    return np.asarray(idxs, dtype=np.int32)


def map_label_argmaxed(label: np.ndarray, map_idxs) -> np.ndarray:
    """Rewrite label values: voxels equal to map_idxs[i] become i, all other
    values become 0."""
    out = np.zeros_like(label)
    for i, v in enumerate(np.asarray(map_idxs).tolist()):
        out = np.where(label == int(v), i, out).astype(label.dtype)
    return out
