"""Model bundle: architecture spec plus the input pipeline of each trainer
family (the port of `dg_tta_tpu/models/network.py`).

A trainer name declares whether GIN runs as an internal augmentation
(pretraining only, off at TTA and inference) and whether the MIND
descriptor is a permanent part of the model's input transform.  This slice
runs the families without MIND at inference; MIND and GIN augmentation
raise `NotImplementedError` until their slices land.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from dg_tta_tpu_torch.models.plans import (
    ArchSpec,
    arch_spec_from_plans,
    num_classes_from_dataset_json,
    patch_size_from_plans,
)
from dg_tta_tpu_torch.models.unet import PlainConvUNet, resolve_compute_dtype
from dg_tta_tpu_torch.utils.device import resolve_device

MIND_OUT_CHANNELS = 12

# trainer name -> (internal GIN at pretraining, MIND descriptor always)
TRAINER_REGISTRY = {
    "nnUNetTrainer": (False, False),
    "nnUNetTrainer_GIN": (True, False),
    "nnUNetTrainer_MIND": (False, True),
    "nnUNetTrainer_GIN_MIND": (True, True),
    "nnUNetTrainer_GIN_MultiRes": (True, False),
    "nnUNetTrainer_MIND_MultiRes": (False, True),
    "nnUNetTrainer_GIN_MIND_MultiRes": (True, True),
}


@dataclasses.dataclass(frozen=True)
class Model:
    """Static model description; the weights live in a `PlainConvUNet`
    made by `build_network`."""

    spec: ArchSpec
    patch_size: Tuple[int, int, int]
    trainer_name: str
    uses_gin_internal: bool
    uses_mind: bool
    compute_dtype: Optional[str] = None  # None (float32) or "bfloat16"

    def __post_init__(self):
        resolve_compute_dtype(self.compute_dtype)

    def build_network(self, state_dict=None, device=None) -> PlainConvUNet:
        """A `PlainConvUNet` of this spec in eval mode on `device` (CUDA
        unless the caller passes "cpu"), loaded from `state_dict`
        (strictly) when one is given."""
        device = resolve_device(device)
        net = PlainConvUNet(self.spec)
        if state_dict is not None:
            net.load_state_dict(state_dict, strict=True)
        return net.to(device).eval()

    def apply(self, net: PlainConvUNet, x: torch.Tensor,
              deep_supervision: bool = False, internal_aug: bool = False,
              head_channel_idx=None):
        """Forward pass including the trainer's input transforms.

        x: (B, D, H, W, C_img) channels-last image.  internal_aug is True
        only during DG pretraining (GIN active).
        """
        if internal_aug and self.uses_gin_internal:
            raise NotImplementedError("GIN is ported in a later slice")
        if self.uses_mind:
            raise NotImplementedError("MIND is ported in a later slice")
        return net(x, deep_supervision=deep_supervision,
                   compute_dtype=self.compute_dtype,
                   head_channel_idx=head_channel_idx)


def build_model(plans: dict, dataset_json: dict, trainer_name: str,
                configuration: str = "3d_fullres") -> Model:
    """The Model of a trainer/plans/dataset triple."""
    gin_flag, mind_flag = TRAINER_REGISTRY[trainer_name]
    num_classes = num_classes_from_dataset_json(dataset_json)
    n_img_channels = len(dataset_json.get(
        "channel_names", dataset_json.get("modality", {"0": "CT"})))
    in_ch = MIND_OUT_CHANNELS if mind_flag else n_img_channels
    spec = arch_spec_from_plans(plans, configuration,
                                num_input_channels=in_ch,
                                num_classes=num_classes)
    return Model(
        spec=spec,
        patch_size=tuple(patch_size_from_plans(plans, configuration)),
        trainer_name=trainer_name,
        uses_gin_internal=gin_flag,
        uses_mind=mind_flag,
    )
