"""Model bundle: architecture spec plus the input pipeline of each trainer
family (the port of `dg_tta_tpu/models/network.py`).

A trainer name declares whether GIN runs as an internal augmentation
(pretraining only, off at TTA and inference) and whether the MIND
descriptor is a permanent part of the model's input transform (at TTA and
inference, with its edge-map noise on, as in the reference).  `apply`
composes them in the JAX package's order: GIN, then MIND, then the U-Net.
The random draws of both are arguments (`gin_draws`, `mind_noise`).
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
from dg_tta_tpu_torch.models.unet import (PlainConvUNet, init_unet_,
                                          resolve_compute_dtype)
from dg_tta_tpu_torch.ops.gin import gin_aug
from dg_tta_tpu_torch.ops.mind import MIND_OUT_CHANNELS, mind3d
from dg_tta_tpu_torch.utils.device import resolve_device

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

# the trainers whose pretraining simulates discrete low resolutions
MULTIRES_TRAINERS = {t for t in TRAINER_REGISTRY if t.endswith("_MultiRes")}


@dataclasses.dataclass(frozen=True)
class Model:
    """Static model description; the weights live in a `PlainConvUNet`
    made by `build_network`."""

    spec: ArchSpec
    patch_size: Tuple[int, int, int]
    trainer_name: str
    uses_gin_internal: bool
    uses_mind: bool
    mind_noise_scale: float = 0.05  # the reference keeps it on at inference
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

    def init_params(self, generator: torch.Generator) -> dict:
        """He-initialized weights of this spec (`unet.init_unet_`: kaiming
        with a = the leaky slope, the JAX package's `init_params` scheme)
        drawn from `generator`, a CPU `torch.Generator`: a `state_dict` of
        CPU tensors."""
        net = PlainConvUNet(self.spec)
        init_unet_(net, generator)
        return net.state_dict()

    @property
    def needs_mind_noise(self) -> bool:
        """Whether `apply` takes MIND noise (the JAX package draws it
        whenever the model has MIND and a nonzero noise scale)."""
        return self.uses_mind and bool(self.mind_noise_scale)

    def apply(self, net: PlainConvUNet, x: torch.Tensor,
              deep_supervision: bool = False, internal_aug: bool = False,
              head_channel_idx=None, gin_draws=None, mind_noise=None,
              group=None):
        """Forward pass including the trainer's input transforms.

        x: (B, D, H, W, C_img) channels-last image.  internal_aug is True
        only during DG pretraining: GIN then runs with `gin_draws`
        (`ops/gin.GinDraws`, required).  A MIND model computes the
        descriptor of x in x's type, with `mind_noise` (standard normal,
        (B, D, H, W, 12)) on its edge maps; None adds no noise.  `group`:
        the process group of a data-parallel step, for MIND's clip bound
        (`ops/mind.mind3d`).
        """
        if internal_aug and self.uses_gin_internal:
            if gin_draws is None:
                raise ValueError("GIN internal augmentation needs gin_draws")
            x = gin_aug(x, gin_draws)
        if self.uses_mind:
            x = mind3d(x, noise=mind_noise,
                       noise_scale=self.mind_noise_scale, group=group)
        return net(x, deep_supervision=deep_supervision,
                   compute_dtype=self.compute_dtype,
                   head_channel_idx=head_channel_idx)

    def apply_members(self, net: PlainConvUNet, params: dict, x: torch.Tensor,
                      deep_supervision: bool = False, head_channel_idx=None,
                      mind_noise=None):
        """`apply` of M ensemble members side by side, at TTA and inference
        (no internal augmentation): params {name: (M, *shape)}
        (`unet.stack_members`), x (M * b, D, H, W, C_img) member m's b
        samples after member m - 1's, `mind_noise` the same rows.  A MIND
        model takes each member's clip bound over that member's samples
        (`ops/mind.mind3d(members=)`), as the JAX package's vmap does.
        `net` gives the architecture; its own weights are not read."""
        M = next(iter(params.values())).shape[0]
        if self.uses_mind:
            x = mind3d(x, noise=mind_noise,
                       noise_scale=self.mind_noise_scale, members=M)
        return net.forward_members(params, x,
                                   deep_supervision=deep_supervision,
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
