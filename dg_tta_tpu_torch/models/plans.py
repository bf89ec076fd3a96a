"""nnUNet-v2 plans.json parsing into a static architecture spec.

The reference delegates this to nnunetv2's PlansManager/ConfigurationManager
(upstream DG-TTA dg_tta/tta/nnunet_utils.py:11-16); here the relevant subset is
parsed natively. The shipped dummy plans
(upstream DG-TTA dg_tta/__resources__/dummy_results/*/plans.json) define the
flagship config: PlainConvUNet, 5 stages, features 32..320, 3^3 kernels,
stride-2 downsampling x4, patch 112x112x128, 1.5mm spacing.
"""

import dataclasses
import json
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Static, hashable description of a PlainConvUNet."""

    features_per_stage: Tuple[int, ...]
    kernel_sizes: Tuple[Tuple[int, int, int], ...]
    strides: Tuple[Tuple[int, int, int], ...]
    n_conv_per_stage_encoder: Tuple[int, ...]
    n_conv_per_stage_decoder: Tuple[int, ...]
    num_input_channels: int
    num_classes: int
    norm_eps: float = 1e-5
    leaky_slope: float = 0.01

    @property
    def n_stages(self) -> int:
        return len(self.features_per_stage)

    def with_input_channels(self, c: int) -> "ArchSpec":
        return dataclasses.replace(self, num_input_channels=c)


def load_plans(plans_path) -> dict:
    with open(plans_path) as f:
        return json.load(f)


def arch_spec_from_plans(
    plans: dict,
    configuration: str = "3d_fullres",
    num_input_channels: int = 1,
    num_classes: int = 2,
) -> ArchSpec:
    cfg = plans["configurations"][configuration]
    n_stages = len(cfg["conv_kernel_sizes"])
    base = cfg["UNet_base_num_features"]
    cap = cfg["unet_max_num_features"]
    features = tuple(min(base * 2**i, cap) for i in range(n_stages))
    return ArchSpec(
        features_per_stage=features,
        kernel_sizes=tuple(tuple(k) for k in cfg["conv_kernel_sizes"]),
        strides=tuple(tuple(s) for s in cfg["pool_op_kernel_sizes"]),
        n_conv_per_stage_encoder=tuple(cfg["n_conv_per_stage_encoder"]),
        n_conv_per_stage_decoder=tuple(cfg["n_conv_per_stage_decoder"]),
        num_input_channels=num_input_channels,
        num_classes=num_classes,
    )


def patch_size_from_plans(plans: dict, configuration: str = "3d_fullres"):
    return tuple(plans["configurations"][configuration]["patch_size"])


def num_classes_from_dataset_json(dataset_json: dict) -> int:
    labels = dataset_json["labels"]
    ids = []
    for v in labels.values():
        if isinstance(v, (list, tuple)):
            ids.extend(int(x) for x in v)
        else:
            ids.append(int(v))
    return max(ids) + 1


def deep_supervision_scales(spec: ArchSpec) -> List[Tuple[float, ...]]:
    """Cumulative downsampling factors of each deep-supervision output
    (nnUNet semantics: every decoder resolution but the lowest), highest
    resolution first."""
    cum = np.cumprod(np.vstack(spec.strides), axis=0)
    scales = [tuple(1.0 / f for f in row) for row in cum]
    return scales[: len(spec.n_conv_per_stage_decoder)]
