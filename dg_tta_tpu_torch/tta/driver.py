"""The TTA program driver: adaptation -> inference -> evaluation (the port
of `dg_tta_tpu/tta/driver.py`).

This slice runs Phases 2 and 3.  When every member's parameter file of a
sample already exists, Phase 1 (adaptation) has nothing to do for it; a
missing member raises `NotImplementedError` until adaptation is ported.
Member files are `.npz` archives in the JAX package's format, so members
adapted by `dg_tta_tpu` load unchanged.

At the end the run directory gets `timings.json`: the device and the
wall-clock seconds of every phase (`obs/timers.PhaseTimer`).
"""

import dataclasses
import json
import os
import re
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from dg_tta_tpu_torch.core.labels import get_map_idxs, map_label_argmaxed
from dg_tta_tpu_torch.data.io import SUPPORTED_ENDINGS, read_image, write_image
from dg_tta_tpu_torch.data.preprocess import (preprocess_case,
                                              undo_preprocessing_logits)
from dg_tta_tpu_torch.eval.metrics import compute_metrics_on_folder
from dg_tta_tpu_torch.infer.sliding_window import predict_volume
from dg_tta_tpu_torch.models.convert import load_flat_npz, load_torch_checkpoint
from dg_tta_tpu_torch.models.network import build_model
from dg_tta_tpu_torch.obs.timers import PhaseTimer
from dg_tta_tpu_torch.tta.config import get_parameters_save_path
from dg_tta_tpu_torch.tta.plan import TTAPlan
from dg_tta_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TTASample:
    sample_id: str               # e.g. "tta_outputTs/mycase"
    case_name: str
    bucket: str                  # "Ts" | "Tr"
    file_extension: str
    data: np.ndarray             # (C, D', H', W') preprocessed
    label: Optional[np.ndarray]  # (1, D', H', W') dense GT ids or None
    info: object                 # PreprocInfo
    props: dict


def load_state_dict_file(weights_file):
    """A `.npz` (JAX package format) or `.pth` (nnUNet) checkpoint as a
    `state_dict` of CPU tensors."""
    weights_file = Path(weights_file)
    if weights_file.suffix == ".npz":
        return load_flat_npz(weights_file)
    return load_torch_checkpoint(weights_file)


def load_pretrained_bundle(weights_file, device=None):
    """(Model, network on `device`, plans, dataset_json) from a checkpoint
    in the nnUNet results layout `{trainer}__nnUNetPlans__{config}/fold_*/
    checkpoint_final.{pth,npz}`.  `DGTTA_COMPUTE_DTYPE=bfloat16` selects
    bf16 compute, as in the JAX package."""
    weights_file = Path(weights_file)
    model_dir = weights_file.parents[1]
    trainer, _, configuration = model_dir.name.split("__")
    with open(model_dir / "plans.json") as f:
        plans = json.load(f)
    with open(model_dir / "dataset.json") as f:
        dataset_json = json.load(f)
    model = build_model(plans, dataset_json, trainer, configuration)
    cd = os.environ.get("DGTTA_COMPUTE_DTYPE")
    if cd:
        model = dataclasses.replace(model, compute_dtype=cd)
    net = model.build_network(load_state_dict_file(weights_file), device)
    return model, net, plans, dataset_json


_CHANNEL_SUFFIX = re.compile(r"(.*)_\d{4}$")


def case_name_from_image_path(path) -> str:
    """Strip the nnUNet channel suffix: case_0000.nii.gz -> case."""
    name = Path(path).name
    for ext in SUPPORTED_ENDINGS:
        if name.endswith(ext):
            name = name[: -len(ext)]
            break
    m = _CHANNEL_SUFFIX.match(name)
    return m.group(1) if m else name


def load_tta_data(plan: TTAPlan, tta_data_dir, plans: dict,
                  configuration: str = "3d_fullres") -> List[TTASample]:
    """Preprocess every file in the plan's tta_data_filepaths (each image
    file is its own case)."""
    tta_data_dir = Path(tta_data_dir)
    samples = []
    for bucket in ("Ts", "Tr"):
        image_dirname = f"images{bucket}"
        for fp in plan.tta_data_filepaths or ():
            fp = Path(fp)
            if fp.parts[-2] != image_dirname:
                continue
            case = case_name_from_image_path(fp)
            ext = "".join(fp.suffixes)
            data, props = read_image(fp)
            label_fp = tta_data_dir / f"labels{bucket}" / f"{case}{ext}"
            seg = None
            if label_fp.is_file():
                seg_raw, _ = read_image(label_fp)
                seg = seg_raw.astype(np.int16)
            data_pp, seg_pp, info = preprocess_case(
                data, props, plans, configuration, seg=seg)
            samples.append(TTASample(
                sample_id=f"tta_output{bucket}/{case}",
                case_name=case,
                bucket=bucket,
                file_extension=ext,
                data=data_pp,
                label=seg_pp,
                info=info,
                props=props,
            ))
    return samples


def _member_paths(plan: TTAPlan, save_path: Path, sample: TTASample):
    if plan.tta_across_all_samples:
        param_dir, param_id = save_path / "tta_output", "all_samples"
    else:
        param_dir = save_path / Path(sample.sample_id).parent
        param_id = sample.sample_id.split("/")[-1]
    return [get_parameters_save_path(param_dir, param_id, i)
            for i in range(plan.ensemble_count)]


def tta_main(run_name: str, plan: TTAPlan, tta_data_dir, save_base_path,
             label_mapping: dict, modifier_fn_module=None,
             timer: Optional[PhaseTimer] = None, verbose: bool = True,
             device=None):
    """Run the TTA pipeline on `device` (default CUDA).  Returns
    {bucket: summary dict}."""
    device = resolve_device(device)
    timer = timer or PhaseTimer()
    save_path = Path(save_base_path) / run_name
    save_path.mkdir(exist_ok=True, parents=True)
    plan.save(save_path / "tta_plan.json")

    mod = getattr(modifier_fn_module, "ModifierFunctions", None)
    modify_input_fn = getattr(mod, "modify_tta_input_fn", None)
    modify_model_output_fn = getattr(mod, "modify_tta_model_output_fn", None)
    postprocess_fn = getattr(mod, "postprocess_results_fn", lambda d: None)

    optimized_labels = list(plan.optimized_labels)
    map_pre = get_map_idxs(label_mapping, optimized_labels, "pretrain_labels")
    map_tta = get_map_idxs(label_mapping, optimized_labels, "tta_labels")

    with timer.phase("load_model"):
        model, _, plans, _ = load_pretrained_bundle(
            plan.pretrained_weights_filepath, device)

    with timer.phase("preprocess"):
        samples = load_tta_data(plan, tta_data_dir, plans)
    if verbose:
        print(f"# Loaded {len(samples)} samples")

    # ---- Phase 1: adaptation -------------------------------------------
    for sample in samples:
        missing = [i for i, p in enumerate(_member_paths(plan, save_path,
                                                         sample))
                   if not p.is_file()]
        if missing:
            raise NotImplementedError(
                "adaptation is ported in the next slice: members "
                f"{missing} of {sample.sample_id} have no parameter file")
        if verbose:
            print(f"TTA parameters exist, skipping {sample.sample_id}")

    # ---- Phase 2: inference --------------------------------------------
    prediction_paths = []
    for sample in samples:
        members = [model.build_network(load_flat_npz(p), device)
                   for p in _member_paths(plan, save_path, sample)]
        vol = torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(sample.data, 0, -1))).to(device)
        if verbose:
            print(f"# Inference {sample.sample_id}")
        with timer.phase("inference"):
            # the modifier hooks stay active at inference; the raw-logit
            # output hook applies here, label mapping after export
            logits = predict_volume(
                model, members, vol,
                modify_input_fn=modify_input_fn,
                modify_output_fn=modify_model_output_fn)
            logits = logits.cpu().numpy()
        with timer.phase("export"):
            seg = undo_preprocessing_logits(logits, sample.info)
            seg_mapped = map_label_argmaxed(seg.astype(np.int32), map_pre)
            out_path = save_path / (sample.sample_id + sample.file_extension)
            out_path.parent.mkdir(exist_ok=True, parents=True)
            write_image(out_path, seg_mapped.astype(np.uint8), sample.props)
        prediction_paths.append((out_path, sample))

    # ---- Phase 3: evaluation -------------------------------------------
    summaries = {}
    tta_data_dir = Path(tta_data_dir)
    for out_path, sample in prediction_paths:
        orig_label = (tta_data_dir / f"labels{sample.bucket}" /
                      f"{sample.case_name}{sample.file_extension}")
        if not orig_label.is_file():
            continue
        mapped_dir = save_path / f"mapped_target_labels{sample.bucket}"
        mapped_dir.mkdir(exist_ok=True)
        target = mapped_dir / out_path.name
        shutil.copy(orig_label, target)
        seg_raw, props = read_image(target)
        mapped = map_label_argmaxed(seg_raw[0].astype(np.int32), map_tta)
        write_image(target, mapped.astype(np.uint8), props)

    for bucket in ("Ts", "Tr"):
        mapped_dir = save_path / f"mapped_target_labels{bucket}"
        pred_dir = save_path / f"tta_output{bucket}"
        if not (mapped_dir.is_dir() and pred_dir.is_dir()):
            continue
        postprocess_fn(pred_dir)
        with timer.phase("evaluation"):
            summary = compute_metrics_on_folder(
                pred_dir, mapped_dir,
                labels=list(range(len(optimized_labels))),
                num_processes=plan.num_processes,
                output_file=f"../summary_{bucket}.json")
        summaries[bucket] = summary
        if verbose:
            print(f"summary_{bucket}: foreground mean Dice = "
                  f"{summary['foreground_mean']['Dice']:.4f}")

    with open(save_path / "timings.json", "w") as f:
        json.dump({"device": str(device), "phases": timer.summary()}, f,
                  indent=2)
    if verbose:
        print(timer.report())
    return summaries
