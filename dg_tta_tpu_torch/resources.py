"""Shipped resources: the TS104 trainer scaffolds and the input-check
notebook (copies of `dg_tta_tpu/resources.py`'s facts; the notebook's cells
use torch).

The upstream project ships per-trainer nnUNet metadata (plans.json /
dataset.json) for its published TS104 checkpoints.  This module writes
equivalent fixtures from the embedded architecture spec below; the label
table comes from the checkpoint bundle the user places beside it.
"""

import json
from pathlib import Path

# Where the package looks for upstream resource files that it does not
# ship (the TS104 orientation view of `obs/views.py`).
RESOURCES = Path(__file__).resolve().parent / "__resources__"

TRAINER_DIRS = [
    "nnUNetTrainer_GIN__nnUNetPlans__3d_fullres",
    "nnUNetTrainer_MIND__nnUNetPlans__3d_fullres",
    "nnUNetTrainer_GIN_MIND__nnUNetPlans__3d_fullres",
    "nnUNetTrainer_GIN_MultiRes__nnUNetPlans__3d_fullres",
    "nnUNetTrainer_MIND_MultiRes__nnUNetPlans__3d_fullres",
    "nnUNetTrainer_GIN_MIND_MultiRes__nnUNetPlans__3d_fullres",
]

# Architecture facts of the published TS104 checkpoints (their plans.json
# `configurations.3d_fullres`): 5 stages, 32->320 features, 2 convs/stage,
# 3^3 kernels, stride-2 pools x4, patch 112x112x128, 1.5mm.
TS104_3D_FULLRES = {
    "data_identifier": "nnUNetPlans_3d_fullres",
    "preprocessor_name": "DefaultPreprocessor",
    "batch_size": 2,
    "patch_size": [112, 112, 128],
    "spacing": [1.5, 1.5, 1.5],
    "normalization_schemes": ["CTNormalization"],
    "use_mask_for_norm": [False],
    "UNet_class_name": "PlainConvUNet",
    "UNet_base_num_features": 32,
    "unet_max_num_features": 320,
    "n_conv_per_stage_encoder": [2, 2, 2, 2, 2],
    "n_conv_per_stage_decoder": [2, 2, 2, 2],
    "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2], [2, 2, 2],
                             [2, 2, 2]],
    "conv_kernel_sizes": [[3, 3, 3]] * 5,
    "batch_dice": True,
}


def materialize_scaffold(trainer_dir: str, target_path: Path) -> bool:
    """Write plans.json (the embedded spec) and, unless one is already
    there, a placeholder dataset.json for a TS104 trainer under
    target_path.  Returns False: the exact upstream fixtures are not
    shipped with this package."""
    target_path.mkdir(parents=True, exist_ok=True)
    plans = {
        "dataset_name": "Dataset505_TS104",
        "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "image_reader_writer": "SimpleITKIO",
        "foreground_intensity_properties_per_channel": {
            "0": {"mean": -143.88, "std": 464.90,
                  "percentile_00_5": -1005.0, "percentile_99_5": 1137.0,
                  "min": -9010.0, "max": 6868.0, "median": 33.0}},
        "configurations": {"3d_fullres": dict(TS104_3D_FULLRES)},
    }
    with open(target_path / "plans.json", "w") as f:
        json.dump(plans, f, indent=2)
    if not (target_path / "dataset.json").is_file():
        with open(target_path / "dataset.json", "w") as f:
            json.dump({
                "channel_names": {"0": "CT"},
                "labels": {"background": 0},
                "__comment__": ("Placeholder: supply the TS104 105-label "
                                "table from the published checkpoint "
                                "bundle."),
                "file_ending": ".nii.gz",
            }, f, indent=2)
    return False


CHECK_NOTEBOOK_CELLS = [
    "# TTA input orientation check\n"
    "Inspect whether the target-domain volumes are oriented like the\n"
    "pretraining data, and verify that your modifier functions invert\n"
    "cleanly. Edit `PLAN_DIR` and run all cells.",

    "import json, pathlib\n"
    "import numpy as np\n"
    "import torch\n"
    "import matplotlib.pyplot as plt\n"
    "from dg_tta_tpu_torch.data.io import read_image\n"
    "from dg_tta_tpu_torch.tta.config import load_current_modifier_functions\n"
    "PLAN_DIR = pathlib.Path('.')\n"
    "plan = json.load(open(PLAN_DIR / 'tta_plan.json'))\n"
    "mod = load_current_modifier_functions(PLAN_DIR)\n"
    "fns = mod.ModifierFunctions",

    "img_path = plan['tta_data_filepaths'][0]\n"
    "data, props = read_image(img_path)\n"
    "print(img_path, data.shape, props['spacing'])",

    "def show_planes(vol, title=''):\n"
    "    vol = np.asarray(vol)\n"
    "    fig, axes = plt.subplots(3, 4, figsize=(12, 9))\n"
    "    for row, axis in enumerate(range(3)):\n"
    "        idxs = np.linspace(0, vol.shape[axis]-1, 4).astype(int)\n"
    "        for col, i in enumerate(idxs):\n"
    "            sl = np.take(vol, i, axis=axis)\n"
    "            axes[row, col].imshow(sl, cmap='gray')\n"
    "            axes[row, col].set_title(f'axis{axis}[{i}]')\n"
    "            axes[row, col].axis('off')\n"
    "    fig.suptitle(title)\n"
    "    plt.show()\n"
    "show_planes(data[0], 'raw target volume')",

    "# modifier roundtrip: output modifier must invert the input modifier\n"
    "x = torch.from_numpy(data[0][None, ..., None])\n"
    "modified = fns.modify_tta_input_fn(x)\n"
    "show_planes(modified[0, ..., 0].numpy(), 'after input modifier')",

    "reverse = fns.modify_tta_output_after_mapping_fn(modified)\n"
    "ok = torch.allclose(reverse, x)\n"
    "print('modifier roundtrip OK:', ok)\n"
    "assert ok, 'Output modifier does not invert the input modifier'",
]


def write_check_notebook(path: Path):
    """The check_tta_input.ipynb of the upstream project, for this port."""
    cells = []
    for i, src in enumerate(CHECK_NOTEBOOK_CELLS):
        kind = "markdown" if i == 0 else "code"
        cell = {
            "cell_type": kind,
            "metadata": {},
            "source": src.splitlines(keepends=True),
        }
        if kind == "code":
            cell["outputs"] = []
            cell["execution_count"] = None
        cells.append(cell)
    nb = {"cells": cells, "metadata": {"language_info": {"name": "python"}},
          "nbformat": 4, "nbformat_minor": 5}
    with open(path, "w") as f:
        json.dump(nb, f, indent=1)
