"""The TTA program driver: adaptation -> inference -> evaluation (the port
of `dg_tta_tpu/tta/driver.py`).

Phase 1 adapts, per sample (or once for all samples with
`tta_across_all_samples`), every ensemble member whose parameter file is
missing (`tta/engine.tta_one_volume`); members whose file exists are
skipped, so an interrupted run resumes member by member.  Each member is
saved as soon as it finishes, as an `.npz` archive in the JAX package's
format, so members adapted by either package load in both.  Its per-epoch
losses and Dices go to the log and, beside the member file, to
`{id}__ensemble_idx_{m}_tta_results.json`.  Members run one after another
(the plan's `ensemble_chunk` schedules nothing here).  Phase 2 predicts
each sample with its members, Phase 3 evaluates against the labels.

At the end the run directory gets `timings.json`: the device and the
wall-clock seconds of every phase (`obs/timers.PhaseTimer`): "adaptation",
"inference" and the rest.

`DGTTA_EXACT_WARP_GRAD` (any non-empty value, as in the JAX driver) gives
the unwarp its exact adjoint (`tta/engine.make_tta_functions`).

Not in this slice, and raising `NotImplementedError`: wandb logging, the
loss plots (`obs/plots.py`; ROADMAP A.6), the JAX driver's environment
overrides DGTTA_PATCH_GROUP, DGTTA_REMAT and DGTTA_ENGINE, and the
adaptation features that `tta/engine.check_supported` names.
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
from dg_tta_tpu_torch.core.patches import bucket_shape_for, pad_to_bucket
from dg_tta_tpu_torch.data.io import SUPPORTED_ENDINGS, read_image, write_image
from dg_tta_tpu_torch.data.preprocess import (preprocess_case,
                                              undo_preprocessing_logits)
from dg_tta_tpu_torch.eval.metrics import compute_metrics_on_folder
from dg_tta_tpu_torch.infer.sliding_window import predict_volume
from dg_tta_tpu_torch.models.convert import (load_flat_npz,
                                             load_torch_checkpoint,
                                             save_flat_npz)
from dg_tta_tpu_torch.models.network import build_model
from dg_tta_tpu_torch.obs.timers import PhaseTimer
from dg_tta_tpu_torch.tta.config import get_parameters_save_path
from dg_tta_tpu_torch.tta.draws import TorchDraws
from dg_tta_tpu_torch.tta.engine import check_supported, tta_one_volume
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


def _to_device_volume(sample: TTASample, bucket_shape, device):
    """(C, D, H, W) -> bucket-padded channels-last (D, H, W, C) on `device`
    (padded with the volume's minimum), its labels as f32 (padded with 0)
    or None, and the true (D, H, W)."""
    vol = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(sample.data, 0, -1), dtype=np.float32)).to(device)
    padded = pad_to_bucket(vol, bucket_shape, pad_value=float(vol.min()))
    lab = None
    if sample.label is not None:
        lab = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(sample.label, 0, -1), dtype=np.float32)).to(device)
        lab = pad_to_bucket(lab, bucket_shape, pad_value=0.0)
    return padded, lab, [float(s) for s in vol.shape[:3]]


def _check_driver_supported(plan: TTAPlan):
    """The adaptation knobs of the JAX driver that this slice does not run
    raise instead of being ignored."""
    later = []
    if plan.wandb_mode != "disabled":
        later.append(f"wandb logging (wandb_mode={plan.wandb_mode!r}; "
                     "ROADMAP A.6)")
    for env in ("DGTTA_PATCH_GROUP", "DGTTA_REMAT", "DGTTA_ENGINE"):
        if os.environ.get(env):
            later.append(f"{env} (ROADMAP A.5, left out)")
    if later:
        raise NotImplementedError(
            "not ported to dg_tta_tpu_torch yet: " + "; ".join(later))


def adapt_samples(plan: TTAPlan, samples: List[TTASample], model, net,
                  save_path: Path, map_pre, map_tta, device,
                  timer: PhaseTimer, modify_input_fn=None,
                  modify_output_fn=None, modify_after_mapping_fn=None,
                  verbose: bool = True):
    """Phase 1: adapt and save every missing member of every sample group
    (one group per sample, or all samples with tta_across_all_samples)."""
    if plan.tta_across_all_samples:
        groups = [samples] if samples else []
    else:
        groups = [[s] for s in samples]
    for smp_idx, group in enumerate(groups):
        group_id = ("all_samples" if plan.tta_across_all_samples
                    else group[0].sample_id)
        member_paths = _member_paths(plan, save_path, group[0])
        param_id = group_id.split("/")[-1]
        missing = [i for i, p in enumerate(member_paths) if not p.is_file()]
        if not missing:
            if verbose:
                print(f"TTA parameters exist, skipping {group_id}")
            continue
        member_paths[0].parent.mkdir(exist_ok=True, parents=True)

        bucket = bucket_shape_for(np.max([s.data.shape[1:] for s in group],
                                         axis=0))
        parts = [_to_device_volume(s, bucket, device) for s in group]
        vols = torch.stack([p[0] for p in parts])
        shapes = [p[2] for p in parts]
        labs = (torch.stack([p[1] for p in parts])
                if all(p[1] is not None for p in parts) else None)

        def log_fn(member, epoch, loss, dice):
            print(f"  member {member} epoch {epoch:3d} loss={loss:.4f} "
                  f"pseudo-dice={100 * dice:.1f}%")

        def save_member(m, net_m, loss_m, dice_m, member_paths=member_paths,
                        param_id=param_id):
            save_flat_npz(net_m.state_dict(), member_paths[m])
            results = member_paths[m].parent / (
                f"{param_id}__ensemble_idx_{m}_tta_results.json")
            results.write_text(json.dumps({
                "losses": [float(v) for v in loss_m],
                "eval_dices": [float(v) for v in dice_m]}, indent=2))

        if verbose:
            print(f"# TTA {group_id} (members {missing})")
        with timer.phase("adaptation"):
            # the draws of a member depend on (sample index, member id)
            # only, so a resumed run redraws what a full run would have
            tta_one_volume(
                model, plan, net, vols, shapes, map_pre, map_tta,
                TorchDraws(seed=0, sample_index=smp_idx), labels_padded=labs,
                modify_input_fn=modify_input_fn,
                modify_output_fn=modify_output_fn,
                modify_after_mapping_fn=modify_after_mapping_fn,
                log_fn=log_fn if verbose else None, member_indices=missing,
                save_member_fn=save_member,
                exact_warp_grad=bool(os.environ.get("DGTTA_EXACT_WARP_GRAD")))
            if device.type == "cuda":
                torch.cuda.synchronize(device)


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

    _check_driver_supported(plan)
    mod = getattr(modifier_fn_module, "ModifierFunctions", None)
    modify_input_fn = getattr(mod, "modify_tta_input_fn", None)
    # adaptation folds the label mapping into the seg head, so there the
    # model-output hook sees mapped logits (the JAX driver's note); at
    # inference it sees the raw full-class logits, as in the reference
    modify_model_output_fn = getattr(mod, "modify_tta_model_output_fn", None)
    modify_after_mapping_fn = getattr(
        mod, "modify_tta_output_after_mapping_fn", None)
    postprocess_fn = getattr(mod, "postprocess_results_fn", lambda d: None)

    optimized_labels = list(plan.optimized_labels)
    map_pre = get_map_idxs(label_mapping, optimized_labels, "pretrain_labels")
    map_tta = get_map_idxs(label_mapping, optimized_labels, "tta_labels")

    with timer.phase("load_model"):
        model, net, plans, _ = load_pretrained_bundle(
            plan.pretrained_weights_filepath, device)
    check_supported(model, plan)

    with timer.phase("preprocess"):
        samples = load_tta_data(plan, tta_data_dir, plans)
    if verbose:
        print(f"# Loaded {len(samples)} samples")

    # ---- Phase 1: adaptation -------------------------------------------
    adapt_samples(plan, samples, model, net, save_path, map_pre, map_tta,
                  device, timer, modify_input_fn=modify_input_fn,
                  modify_output_fn=modify_model_output_fn,
                  modify_after_mapping_fn=modify_after_mapping_fn,
                  verbose=verbose)
    del net

    # ---- Phase 2: inference --------------------------------------------
    prediction_paths = []
    for smp_idx, sample in enumerate(samples):
        members = [model.build_network(load_flat_npz(p), device)
                   for p in _member_paths(plan, save_path, sample)]
        vol = torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(sample.data, 0, -1))).to(device)
        if verbose:
            print(f"# Inference {sample.sample_id}")
        with timer.phase("inference"):
            # the modifier hooks stay active at inference; the raw-logit
            # output hook applies here, label mapping after export
            # a MIND model's inference noise, per (window, member)
            logits = predict_volume(
                model, members, vol,
                modify_input_fn=modify_input_fn,
                modify_output_fn=modify_model_output_fn,
                draws=TorchDraws(seed=0, sample_index=smp_idx))
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
