"""The editable TTA plan: hyperparameters + generated artifact keys.

Field-compatible with the reference's TEMPLATE_PLAN JSON
(upstream DG-TTA dg_tta/tta/config_log_utils.py:24-41), so plans prepared for
the torch version load unchanged.
"""

import dataclasses
import json
from typing import Optional

TEMPLATE_PLAN = dict(
    tta_across_all_samples=False,
    tta_eval_patches=1,
    batch_size=1,
    patches_to_be_accumulated=16,
    lr=1e-5,
    ensemble_count=3,
    epochs=12,
    start_tta_at_epoch=1,
    intensity_aug_function="GIN",      # ['GIN', 'disabled']
    spatial_aug_type="affine",         # ['affine', 'deformable']
    params_with_grad="all",            # ['all', 'norms', 'encoder']
    have_grad_in="branch_a",           # ['branch_a', 'branch_b', 'both']
    do_intensity_aug_in="none",        # ['branch_a', 'branch_b', 'both', 'none']
    do_spatial_aug_in="both",          # ['branch_a', 'branch_b', 'both', 'none']
    num_processes=1,
    wandb_mode="disabled",
)


@dataclasses.dataclass(frozen=True)
class TTAPlan:
    """Frozen, hashable plan."""

    tta_across_all_samples: bool = False
    tta_eval_patches: int = 1
    batch_size: int = 1
    patches_to_be_accumulated: int = 16
    lr: float = 1e-5
    ensemble_count: int = 3
    epochs: int = 12
    start_tta_at_epoch: int = 1
    intensity_aug_function: str = "GIN"
    spatial_aug_type: str = "affine"
    params_with_grad: str = "all"
    have_grad_in: str = "branch_a"
    do_intensity_aug_in: str = "none"
    do_spatial_aug_in: str = "both"
    num_processes: int = 1
    wandb_mode: str = "disabled"
    # --- adaptation knobs of the JAX package's plan (extensions over the
    # reference plan), so plan files round-trip between the two packages.
    # The driver hands patch_group, remat and ensemble_chunk to the engine
    # (a chunk spreads over the GPUs, one process each, and its members on
    # one device run side by side); the split engine raises. --------------
    ensemble_chunk: Optional[int] = None
    patch_group: int = 1
    remat: bool = False
    engine: str = "fused"
    # generated keys (not hyperparameters; excluded from hashing-sensitive use)
    optimized_labels: Optional[tuple] = None
    tta_data_filepaths: Optional[tuple] = None
    pretrained_weights_filepath: Optional[str] = None

    def __post_init__(self):
        assert self.intensity_aug_function in ("GIN", "disabled")
        assert self.spatial_aug_type in ("affine", "deformable")
        assert self.params_with_grad in ("all", "norms", "encoder")
        assert self.have_grad_in in ("branch_a", "branch_b", "both")
        assert self.do_intensity_aug_in in ("branch_a", "branch_b", "both", "none")
        assert self.do_spatial_aug_in in ("branch_a", "branch_b", "both", "none")
        assert self.engine in ("fused", "split")
        assert self.patch_group >= 1

    @classmethod
    def from_dict(cls, d: dict) -> "TTAPlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in fields:
                continue  # tolerate __pretrained_dataset_name__ etc.
            if isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("optimized_labels", "tta_data_filepaths"):
            if d[k] is not None:
                d[k] = list(d[k])
            else:
                d.pop(k)
        if d.get("pretrained_weights_filepath") is None:
            d.pop("pretrained_weights_filepath", None)
        return d

    @classmethod
    def load(cls, path) -> "TTAPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path, extra: Optional[dict] = None):
        d = self.to_dict()
        if extra:
            d.update(extra)
        with open(path, "w") as f:
            json.dump(d, f, indent=4)
