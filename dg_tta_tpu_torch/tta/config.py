"""TTA preparation: plan, label-mapping and modifier files, and the path
schema (the port of `dg_tta_tpu/tta/config.py`).

Same DG_TTA_ROOT folder layout and the same generated files (tta_plan.json,
two *_label_mapping.json, modifier_functions.py) as the JAX package, so a
plan directory prepared by either package runs with the other.  The
modifier template is written for torch tensors in the package's
channels-last layout.  Checkpoints may be nnUNet `.pth` files or `.npz`
parameter archives in the JAX package's format.
"""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

from dg_tta_tpu_torch.data.io import check_file_ending_supported
from dg_tta_tpu_torch.resources import materialize_scaffold, write_check_notebook
from dg_tta_tpu_torch.tta.plan import TEMPLATE_PLAN
from dg_tta_tpu_torch.utils.paths import (
    dg_tta_root,
    maybe_convert_to_dataset_name,
    nnunet_raw,
    nnunet_results,
)

TS104_ALIASES = {
    "TS104_GIN": "nnUNetTrainer_GIN",
    "TS104_MIND": "nnUNetTrainer_MIND",
    "TS104_GIN_MIND": "nnUNetTrainer_GIN_MIND",
    "TS104_GIN_MultiRes": "nnUNetTrainer_GIN_MultiRes",
    "TS104_MIND_MultiRes": "nnUNetTrainer_MIND_MultiRes",
    "TS104_GIN_MIND_MultiRes": "nnUNetTrainer_GIN_MIND_MultiRes",
}

# Upstream checkpoint URLs.  Downloads need network access; a checkpoint
# placed at the target path beforehand is used without one.
TS104_DOWNLOAD_LINKS = {
    "TS104_GIN": "https://cloud.imi.uni-luebeck.de/s/ERK6Wic3D95qDKz/download",
    "TS104_MIND": "https://cloud.imi.uni-luebeck.de/s/LZByo9m3A5c6Dki/download",
    "TS104_GIN_MIND": "https://cloud.imi.uni-luebeck.de/s/dkGdfFGwbnzWya4/download",
    "TS104_GIN_MultiRes": "https://cloud.imi.uni-luebeck.de/s/xcR7wLL6ZM7tiGf/download",
    "TS104_MIND_MultiRes": "https://cloud.imi.uni-luebeck.de/s/cmrPBj7EYtwTjNP/download",
    "TS104_GIN_MIND_MultiRes": "https://cloud.imi.uni-luebeck.de/s/bycFSFPkS5P2G8k/download",
}

MODIFIER_TEMPLATE = '''"""User-editable modifier functions (torch, channels-last).

Edit these to fix dataset orientation (flips/permutes) or post-process
results; they are imported dynamically at run_tta time.
"""

import pathlib

import torch


class ModifierFunctions:

    @staticmethod
    def modify_tta_input_fn(image):
        # Called on the network input; image is a (B, D, H, W, C) tensor.
        assert image.ndim == 5
        return image

    @staticmethod
    def modify_tta_model_output_fn(pred_logits):
        # Called on the model's output logits during BOTH adaptation and
        # sliding-window inference: the inverse orientation fix of
        # modify_tta_input_fn belongs here.  Must be a spatial-only
        # transform (flip/permute); (B, D, H, W, C).
        assert pred_logits.ndim == 5
        return pred_logits

    @staticmethod
    def modify_tta_output_after_mapping_fn(mapped_logits):
        # Called during ADAPTATION only, after logits are mapped to the
        # optimized label set.
        assert mapped_logits.ndim == 5
        return mapped_logits

    @staticmethod
    def postprocess_results_fn(results_dir: pathlib.Path):
        # Called on the final output directory.
        pass
'''


def check_dataset_pretrain_config(pretrained_dataset_id, pretrainer,
                                  pretrainer_config, pretrainer_fold):
    """Resolve a TS104 alias or check a numeric pretrained dataset id."""
    if isinstance(pretrained_dataset_id, str) and pretrained_dataset_id.isnumeric():
        pretrained_dataset_id = int(pretrained_dataset_id)
    if isinstance(pretrainer_fold, str) and pretrainer_fold.isnumeric():
        pretrainer_fold = int(pretrainer_fold)

    if isinstance(pretrained_dataset_id, int):
        if pretrainer is None or pretrainer_config is None:
            raise SystemExit(
                f"Numeric pretrained dataset id {pretrained_dataset_id} "
                "requires --pretrainer and --pretrainer_config "
                "(and --pretrainer_fold, default 0).")
        if pretrainer_fold is None:
            pretrainer_fold = 0
        assert pretrainer_fold == "all" or isinstance(pretrainer_fold, int)
    else:
        if pretrained_dataset_id not in TS104_ALIASES:
            raise SystemExit(
                f"Unknown pretrained dataset alias {pretrained_dataset_id!r};"
                f" expected one of {sorted(TS104_ALIASES)} or a numeric id.")
        pretrainer = TS104_ALIASES[pretrained_dataset_id]
        pretrainer_config = "3d_fullres"
        pretrainer_fold = "0"
    return pretrained_dataset_id, pretrainer, pretrainer_config, pretrainer_fold


def get_tta_folders(pretrained_dataset_id, tta_dataset_id, pretrainer,
                    pretrainer_config, pretrainer_fold):
    """DG_TTA_ROOT/{plans,results}/Pretrained_{src}_at_{tgt}/{trainer}__{cfg}/
    fold_{f}."""
    root = dg_tta_root()
    tta_dataset_name = maybe_convert_to_dataset_name(tta_dataset_id)
    if isinstance(pretrained_dataset_id, int):
        pretrained_dataset_name = maybe_convert_to_dataset_name(
            pretrained_dataset_id)
    else:
        pretrained_dataset_name = pretrained_dataset_id

    fold_folder = (f"fold_{pretrainer_fold}" if pretrainer_fold != "all"
                   else "all")
    map_folder = f"Pretrained_{pretrained_dataset_name}_at_{tta_dataset_name}"
    pretrainer_folder = f"{pretrainer}__{pretrainer_config}"

    plan_dir = root / "plans" / map_folder / pretrainer_folder / fold_folder
    results_dir = root / "results" / map_folder / pretrainer_folder / fold_folder
    tta_data_dir = nnunet_raw() / tta_dataset_name
    return (tta_data_dir, plan_dir, results_dir, pretrained_dataset_name,
            tta_dataset_name)


def get_data_filepaths(tta_dataset_name: str, bucket: str):
    raw_dir = nnunet_raw() / tta_dataset_name
    folders = {"imagesTr": ["imagesTr"], "imagesTs": ["imagesTs"],
               "imagesTrAndTs": ["imagesTr", "imagesTs"]}[bucket]
    files = []
    for f in folders:
        d = raw_dir / f
        if d.is_dir():
            files.extend(sorted(p for p in d.iterdir() if p.is_file()))
    return files


def fetch_pretrained_weights(pretrained_dataset_id: str):
    """Scaffold the pretrained-weights dir of a TS104 alias and locate (or
    download) its checkpoint.  A checkpoint_final.npz or .pth placed there
    beforehand is used as it is."""
    trainer = TS104_ALIASES[pretrained_dataset_id]
    trainer_dir = f"{trainer}__nnUNetPlans__3d_fullres"
    target_path = dg_tta_root() / "_pretrained_weights" / trainer_dir
    weights_pth = target_path / "fold_0" / "checkpoint_final.pth"
    weights_npz = target_path / "fold_0" / "checkpoint_final.npz"

    target_path.mkdir(exist_ok=True, parents=True)
    weights_pth.parent.mkdir(exist_ok=True)
    materialize_scaffold(trainer_dir, target_path)

    if weights_npz.exists():
        return target_path, weights_npz
    if not weights_pth.exists():
        link = TS104_DOWNLOAD_LINKS[pretrained_dataset_id]
        try:
            subprocess.run(["wget", "-q", link, "-O", str(weights_pth)],
                           check=True, timeout=600)
        except (OSError, subprocess.SubprocessError) as e:
            weights_pth.unlink(missing_ok=True)
            raise FileNotFoundError(
                f"Checkpoint not found at {weights_pth} and download failed "
                f"({e}). Place the checkpoint file there manually.") from e
    return target_path, weights_pth


def prepare_tta(pretrained_dataset_id, tta_dataset_id, pretrainer=None,
                pretrainer_config=None, pretrainer_fold=None,
                tta_dataset_bucket="imagesTs"):
    """Generate the editable plan directory."""
    (pretrained_dataset_id, pretrainer, pretrainer_config, pretrainer_fold) = \
        check_dataset_pretrain_config(pretrained_dataset_id, pretrainer,
                                      pretrainer_config, pretrainer_fold)

    (_, plan_dir, results_dir, pretrained_dataset_name, tta_dataset_name) = \
        get_tta_folders(pretrained_dataset_id, tta_dataset_id, pretrainer,
                        pretrainer_config, pretrainer_fold)

    shutil.rmtree(plan_dir, ignore_errors=True)
    plan_dir.mkdir(exist_ok=True, parents=True)
    results_dir.mkdir(exist_ok=True, parents=True)

    if isinstance(pretrained_dataset_id, str):
        target_path, weights_file_path = fetch_pretrained_weights(
            pretrained_dataset_id)
        with open(target_path / "dataset.json") as f:
            pretrained_classes = json.load(f)["labels"]
    else:
        raw_dir = nnunet_raw() / pretrained_dataset_name
        with open(raw_dir / "dataset.json") as f:
            pretrained_classes = json.load(f)["labels"]
        fold_dir = (f"fold_{pretrainer_fold}" if pretrainer_fold != "all"
                    else "all")
        results_pre = (nnunet_results() / pretrained_dataset_name /
                       f"{pretrainer}__nnUNetPlans__{pretrainer_config}" /
                       fold_dir)
        weights_file_path = results_pre / "checkpoint_final.pth"
        if not (weights_file_path.is_file()
                or weights_file_path.with_suffix(".npz").is_file()):
            raise FileNotFoundError(
                f"Could not find weights file at {weights_file_path}")
        if not weights_file_path.is_file():
            weights_file_path = weights_file_path.with_suffix(".npz")

    with open(nnunet_raw() / tta_dataset_name / "dataset.json") as f:
        tta_dataset_json = json.load(f)
    tta_dataset_classes = tta_dataset_json["labels"]
    # fail at prepare time for image formats the codecs do not read
    check_file_ending_supported(
        tta_dataset_json.get("file_ending", ".nii.gz"))

    with open(plan_dir / f"{pretrained_dataset_name}_label_mapping.json",
              "w") as f:
        json.dump(pretrained_classes, f, indent=4)
    with open(plan_dir / f"{tta_dataset_name}_label_mapping.json", "w") as f:
        json.dump(tta_dataset_classes, f, indent=4)

    initial_plan = dict(TEMPLATE_PLAN)
    initial_plan["__pretrained_dataset_name__"] = pretrained_dataset_name
    initial_plan["__tta_dataset_name__"] = tta_dataset_name
    initial_plan["pretrained_weights_filepath"] = str(weights_file_path)

    intersection = sorted(set(pretrained_classes) & set(tta_dataset_classes))
    assert "background" in intersection, \
        "Background class must be present in both datasets!"
    intersection.remove("background")
    intersection.insert(0, "background")
    initial_plan["optimized_labels"] = intersection

    initial_plan["tta_data_filepaths"] = [
        str(p) for p in get_data_filepaths(tta_dataset_name,
                                           tta_dataset_bucket)]

    with open(plan_dir / "tta_plan.json", "w") as f:
        json.dump(initial_plan, f, indent=4)
    with open(plan_dir / "modifier_functions.py", "w") as f:
        f.write(MODIFIER_TEMPLATE)
    write_check_notebook(plan_dir / "check_tta_input.ipynb")

    print(f"\nPreparation done. You can edit the plan, modifier functions "
          f"and optimized labels in {plan_dir} prior to running TTA.")
    return plan_dir


def load_current_modifier_functions(plan_dir):
    """Import the plan dir's modifier_functions.py."""
    return load_modifier_functions_file(Path(plan_dir) /
                                        "modifier_functions.py")


def load_modifier_functions_file(mod_path):
    """Import a modifier functions file (a process of a sharded run
    reloads the run's file by its path)."""
    name = "dg_tta_tpu_torch.current_modifier_functions"
    spec = importlib.util.spec_from_file_location(name, mod_path)
    dyn_mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = dyn_mod
    spec.loader.exec_module(dyn_mod)
    return dyn_mod


def get_parameters_save_path(save_path, sample_id, ensemble_idx) -> Path:
    """{sample}__ensemble_idx_{i}_tta_parameters.npz, the JAX package's
    name and format for a member's parameters."""
    sample_id = str(sample_id).split("/")[-1]
    return Path(save_path) / \
        f"{sample_id}__ensemble_idx_{ensemble_idx}_tta_parameters.npz"


def get_global_idx(list_of_tuple_idx_max):
    """A global step id packed in decimal digits from (index, maximum)
    pairs, the last pair in the lowest digits (config_log_utils.py:353-362
    of the reference): each pair takes as many digits as its maximum
    has."""
    global_idx = 0
    next_multiplier = 1
    for idx, max_of_idx in reversed(list_of_tuple_idx_max):
        global_idx += next_multiplier * idx
        next_multiplier *= 10 ** len(str(int(max_of_idx)))
    return global_idx
