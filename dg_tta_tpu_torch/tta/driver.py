"""The TTA program driver: adaptation -> inference -> evaluation (the port
of `dg_tta_tpu/tta/driver.py`).

Phase 1 adapts, per sample (or once for all samples with
`tta_across_all_samples`), every ensemble member whose parameter file is
missing (`tta/engine.tta_one_volume`); members whose file exists are
skipped, so an interrupted run resumes member by member.  Each member is
saved as soon as it finishes, as an `.npz` archive in the JAX package's
format, so members adapted by either package load in both.  Its per-epoch
losses and Dices go to the log, to wandb where a run is active
(`obs/wandb_log.py`: per epoch and, after evaluation, per bucket), and,
beside the member file, to `{id}__ensemble_idx_{m}_tta_results.json` and
the JAX package's loss plot `{id}__ensemble_idx_{m}_tta_results.png`
(`obs/plots.py`; where matplotlib cannot be imported the run prints one
line and writes no plot).  With several GPUs (all the visible ones;
`CUDA_VISIBLE_DEVICES` restricts them, `num_devices` sets the number)
the plan's `ensemble_chunk` (default: as many members as GPUs, for a
full-size patch; `DGTTA_ENSEMBLE_CHUNK` overrides it) spreads each chunk
of members over one process per GPU (`adapt_samples`).  On one GPU a
chunk of more than one member runs side by side, as the JAX package vmaps
a chunk (`tta/engine.TTAFunctions.chunk_run`: one sequence of launches,
each conv launch reading each member's weights); the default leaves a
full-size patch at one member a chunk there, so `DGTTA_ENSEMBLE_CHUNK=3`
(or the plan's `ensemble_chunk`) asks for three side by side.
Phase 2 predicts each sample with its members and Phase 3 evaluates
against the labels, both here on the first device, as in the JAX
driver.

At the end the run directory gets `timings.json`: the device, the ranks
of Phase 1 and the wall-clock seconds of every phase
(`obs/timers.PhaseTimer`): "adaptation", "inference" and the rest.

`DGTTA_EXACT_WARP_GRAD` (any non-empty value, as in the JAX driver) gives
the unwarp its exact adjoint (`tta/engine.make_tta_functions`).  The
plan's `patch_group` and `remat` reach the engine, overridden by
`DGTTA_PATCH_GROUP` (an int) and `DGTTA_REMAT` (0 or 1) as in the JAX
driver.  The split engine (the plan's `engine: "split"` or
`DGTTA_ENGINE=split`) raises `NotImplementedError`
(`tta/engine.check_supported`).
"""

import dataclasses
import functools
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
from dg_tta_tpu_torch.obs.plots import matplotlib_available, plot_run_results
from dg_tta_tpu_torch.obs.timers import PhaseTimer
from dg_tta_tpu_torch.obs.wandb_log import wandb_log, wandb_run_is_available
from dg_tta_tpu_torch.parallel.mesh import visible_devices
from dg_tta_tpu_torch.parallel.tta import member_chunks
from dg_tta_tpu_torch.tta.config import (get_global_idx,
                                         get_parameters_save_path,
                                         load_modifier_functions_file)
from dg_tta_tpu_torch.tta.draws import TorchDraws
from dg_tta_tpu_torch.tta.engine import (AdaptJob, VolumeJob,
                                         adapt_sharded, check_patch_group,
                                         check_supported, compose_output_fns,
                                         tta_one_volume)
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


# a patch of at least this many voxels is a full-size model: one member
# per device step (the JAX driver's `big`)
BIG_PATCH_VOXELS = 2 ** 20


def adaptation_knobs(plan: TTAPlan) -> TTAPlan:
    """The plan with the JAX driver's environment overrides applied:
    `DGTTA_PATCH_GROUP` (an int), `DGTTA_REMAT` (0 or 1), `DGTTA_ENGINE`
    ("fused" or "split") and `DGTTA_ENSEMBLE_CHUNK` (an int)."""
    changes = {}
    if os.environ.get("DGTTA_PATCH_GROUP"):
        changes["patch_group"] = int(os.environ["DGTTA_PATCH_GROUP"])
    if os.environ.get("DGTTA_REMAT"):
        changes["remat"] = bool(int(os.environ["DGTTA_REMAT"]))
    if os.environ.get("DGTTA_ENGINE"):
        changes["engine"] = os.environ["DGTTA_ENGINE"]
    if os.environ.get("DGTTA_ENSEMBLE_CHUNK"):
        changes["ensemble_chunk"] = int(os.environ["DGTTA_ENSEMBLE_CHUNK"])
    return dataclasses.replace(plan, **changes) if changes else plan


def default_ensemble_chunk(plan: TTAPlan, patch_size,
                           n_devices: int) -> TTAPlan:
    """The plan with the JAX driver's default `ensemble_chunk`
    (`dg_tta_tpu/tta/driver.py:255-270`) where it sets none: a patch of
    >= 2^20 voxels runs min(ensemble_count, n_devices) members a chunk on
    `n_devices` > 1 devices, one on one; a smaller one leaves it None (all
    members one chunk)."""
    if plan.ensemble_chunk is not None \
            or int(np.prod(patch_size)) < BIG_PATCH_VOXELS:
        return plan
    return dataclasses.replace(plan, ensemble_chunk=(
        min(plan.ensemble_count, n_devices) if n_devices > 1 else 1))


def _print_epoch(member, epoch, loss, dice):
    print(f"  member {member} epoch {epoch:3d} loss={loss:.4f} "
          f"pseudo-dice={100 * dice:.1f}%")


def _wandb_epoch(plan, smp_idx, n_groups, param_id, member, epoch, loss,
                 dice):
    step = get_global_idx([(smp_idx, n_groups),
                           (member, plan.ensemble_count),
                           (epoch, plan.epochs)])
    wandb_log({f"losses/loss__{param_id}": loss,
               f"scores/eval_dice__{param_id}": dice}, step=step)


def _results_path(member_path: Path, param_id: str, m: int) -> Path:
    return (member_path.parent
            / f"{param_id}__ensemble_idx_{m}_tta_results.json")


def _save_member(member_paths, param_id, plots, m, net_m, loss_m, dice_m):
    """A finished member's `.npz`, its `_tta_results.json` and, with
    `plots`, its loss plot."""
    save_flat_npz(net_m.state_dict(), member_paths[m])
    _results_path(member_paths[m], param_id, m).write_text(json.dumps({
        "losses": [float(v) for v in loss_m],
        "eval_dices": [float(v) for v in dice_m]}, indent=2))
    if plots:
        plot_run_results(member_paths[m].parent, param_id, m, loss_m, dice_m)


def _modifier_hooks(mod):
    """(input, model-output, after-mapping, postprocess) hooks of a
    modifier functions module (each None where it defines none)."""
    fns = getattr(mod, "ModifierFunctions", None)
    return tuple(getattr(fns, name, None) for name in (
        "modify_tta_input_fn", "modify_tta_model_output_fn",
        "modify_tta_output_after_mapping_fn", "postprocess_results_fn"))


@dataclasses.dataclass(frozen=True)
class _Group:
    """One adaptation group: its samples and the members to adapt."""

    smp_idx: int
    group_id: str
    param_id: str
    samples: list
    member_paths: list
    missing: list


def _group_volumes(group: _Group, device):
    """The group's bucket-padded volumes, their true shapes and their
    labels (or None), on `device`."""
    bucket = bucket_shape_for(np.max([s.data.shape[1:] for s in group.samples],
                                     axis=0))
    parts = [_to_device_volume(s, bucket, device) for s in group.samples]
    vols = torch.stack([p[0] for p in parts])
    labs = (torch.stack([p[1] for p in parts])
            if all(p[1] is not None for p in parts) else None)
    return vols, [p[2] for p in parts], labs


def _rank_setup(weights_file, modifier_path, device):
    """A sharded Phase 1's `engine.AdaptJob.setup`: each rank loads the
    model and reloads the modifier functions itself."""
    model, net, _, _ = load_pretrained_bundle(weights_file, device)
    hooks = (None,) * 3
    if modifier_path is not None:
        hooks = _modifier_hooks(load_modifier_functions_file(
            modifier_path))[:3]
    return model, net, hooks[0], compose_output_fns(hooks[1], hooks[2])


def adapt_samples(plan: TTAPlan, samples: List[TTASample], model, net,
                  save_path: Path, map_pre, map_tta, device,
                  timer: PhaseTimer, modify_input_fn=None,
                  modify_output_fn=None, modify_after_mapping_fn=None,
                  verbose: bool = True, num_devices: int = 1,
                  backend: Optional[str] = None,
                  modifier_path: Optional[str] = None) -> int:
    """Phase 1: adapt and save every missing member of every sample group
    (one group per sample, or all samples with tta_across_all_samples).

    The plan's `ensemble_chunk` decides, with `num_devices`, how members
    spread over ranks (`parallel/tta.member_chunks`).  With one rank the
    members adapt here, chunk after chunk, a chunk's members side by side
    (`engine.tta_one_volume`).  With more, one launch of the
    engine's sharded worker (`engine.adapt_sharded`; `backend`: as in
    `engine.tta_one_volume`) runs every group: each rank loads the model
    and the groups' volumes on its device, reloads the modifier functions
    from `modifier_path`, and writes its members' files;
    the per-epoch wandb lines are then logged here from the members'
    results files.  Returns the number of ranks."""
    if plan.tta_across_all_samples:
        sample_groups = [samples] if samples else []
    else:
        sample_groups = [[s] for s in samples]
    plots = matplotlib_available()
    if not plots and sample_groups and verbose:
        print("matplotlib cannot be imported: the loss plots are skipped "
              "(the losses and Dices are in the *_tta_results.json files)")
    groups = []
    for smp_idx, group in enumerate(sample_groups):
        group_id = ("all_samples" if plan.tta_across_all_samples
                    else group[0].sample_id)
        member_paths = _member_paths(plan, save_path, group[0])
        missing = [i for i, p in enumerate(member_paths) if not p.is_file()]
        if not missing:
            if verbose:
                print(f"TTA parameters exist, skipping {group_id}")
            continue
        member_paths[0].parent.mkdir(exist_ok=True, parents=True)
        groups.append(_Group(smp_idx, group_id, group_id.split("/")[-1],
                             group, member_paths, missing))
    chunks = [member_chunks(g.missing, plan.ensemble_chunk, num_devices)
              for g in groups]
    ranks = max((r for c in chunks for _, r in c), default=1)
    n_groups = len(sample_groups)
    exact = bool(os.environ.get("DGTTA_EXACT_WARP_GRAD"))
    if ranks > 1:
        if verbose:
            for g, c in zip(groups, chunks):
                print(f"# TTA {g.group_id} (members {g.missing}; chunks "
                      f"over ranks {c})")
        if (modify_input_fn, modify_output_fn,
                modify_after_mapping_fn) != (None,) * 3 \
                and modifier_path is None:
            raise ValueError("sharded adaptation reloads the modifier "
                             "functions in each rank: pass modifier_path")
        job = AdaptJob(
            setup=functools.partial(_rank_setup,
                                    plan.pretrained_weights_filepath,
                                    modifier_path),
            plan=plan, map_idxs_pretrain=np.asarray(map_pre),
            map_idxs_tta=np.asarray(map_tta),
            volumes=[VolumeJob(
                functools.partial(_group_volumes, g),
                TorchDraws(seed=0, sample_index=g.smp_idx), c,
                functools.partial(_save_member, g.member_paths, g.param_id,
                                  plots))
                for g, c in zip(groups, chunks)],
            exact_warp_grad=exact, patch_group=plan.patch_group,
            remat=plan.remat, log_fn=_print_epoch if verbose else None,
            return_nets=False)
        with timer.phase("adaptation"):
            adapt_sharded(job, ranks, device.type, backend)
        if wandb_run_is_available():
            for g in groups:
                for m in g.missing:
                    res = json.loads(_results_path(
                        g.member_paths[m], g.param_id, m).read_text())
                    for ep, (loss, dice) in enumerate(zip(
                            res["losses"], res["eval_dices"])):
                        _wandb_epoch(plan, g.smp_idx, n_groups, g.param_id,
                                     m, ep, loss, dice)
        return ranks

    for g in groups:
        vols, shapes, labs = _group_volumes(g, device)

        def log_fn(member, epoch, loss, dice, g=g):
            if verbose:
                _print_epoch(member, epoch, loss, dice)
            if wandb_run_is_available():
                _wandb_epoch(plan, g.smp_idx, n_groups, g.param_id, member,
                             epoch, loss, dice)

        if verbose:
            print(f"# TTA {g.group_id} (members {g.missing})")
        with timer.phase("adaptation"):
            # the draws of a member depend on (sample index, member id)
            # only, so a resumed run redraws what a full run would have
            tta_one_volume(
                model, plan, net, vols, shapes, map_pre, map_tta,
                TorchDraws(seed=0, sample_index=g.smp_idx),
                labels_padded=labs,
                modify_input_fn=modify_input_fn,
                modify_output_fn=modify_output_fn,
                modify_after_mapping_fn=modify_after_mapping_fn,
                log_fn=log_fn, member_indices=g.missing,
                save_member_fn=functools.partial(
                    _save_member, g.member_paths, g.param_id, plots),
                exact_warp_grad=exact,
                patch_group=plan.patch_group, remat=plan.remat,
                ensemble_chunk=plan.ensemble_chunk, num_devices=1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return 1


def tta_main(run_name: str, plan: TTAPlan, tta_data_dir, save_base_path,
             label_mapping: dict, modifier_fn_module=None,
             timer: Optional[PhaseTimer] = None, verbose: bool = True,
             device=None, num_devices: Optional[int] = None,
             backend: Optional[str] = None):
    """Run the TTA pipeline on `device` (default CUDA).  `num_devices`:
    the devices Phase 1 may spread members over (default: the visible
    GPUs for CUDA, 1 on the CPU); `backend`: their `torch.distributed`
    backend (`engine.tta_one_volume`).  Returns {bucket: summary dict}."""
    device = resolve_device(device)
    n_dev = (visible_devices(device.type) if num_devices is None
             else int(num_devices))
    timer = timer or PhaseTimer()
    save_path = Path(save_base_path) / run_name
    save_path.mkdir(exist_ok=True, parents=True)
    plan.save(save_path / "tta_plan.json")

    plan = adaptation_knobs(plan)
    check_supported(plan)
    check_patch_group(plan, plan.patch_group)

    # adaptation folds the label mapping into the seg head, so there the
    # model-output hook sees mapped logits (the JAX driver's note); at
    # inference it sees the raw full-class logits, as in the reference
    (modify_input_fn, modify_model_output_fn, modify_after_mapping_fn,
     postprocess_fn) = _modifier_hooks(modifier_fn_module)
    postprocess_fn = postprocess_fn or (lambda d: None)

    optimized_labels = list(plan.optimized_labels)
    map_pre = get_map_idxs(label_mapping, optimized_labels, "pretrain_labels")
    map_tta = get_map_idxs(label_mapping, optimized_labels, "tta_labels")

    with timer.phase("load_model"):
        model, net, plans, _ = load_pretrained_bundle(
            plan.pretrained_weights_filepath, device)
    plan = default_ensemble_chunk(plan, model.patch_size, n_dev)

    with timer.phase("preprocess"):
        samples = load_tta_data(plan, tta_data_dir, plans)
    if verbose:
        print(f"# Loaded {len(samples)} samples")

    # ---- Phase 1: adaptation -------------------------------------------
    ranks = adapt_samples(
        plan, samples, model, net, save_path, map_pre, map_tta, device,
        timer, modify_input_fn=modify_input_fn,
        modify_output_fn=modify_model_output_fn,
        modify_after_mapping_fn=modify_after_mapping_fn, verbose=verbose,
        num_devices=n_dev, backend=backend,
        modifier_path=getattr(modifier_fn_module, "__file__", None))
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
        if wandb_run_is_available():
            wandb_log({f"scores/tta_dice_mean_{bucket}":
                       summary["foreground_mean"]["Dice"]})

    with open(save_path / "timings.json", "w") as f:
        json.dump({"device": str(device), "ranks": ranks,
                   "phases": timer.summary()}, f, indent=2)
    if verbose:
        print(timer.report())
    return summaries
