"""A synthetic TS104 workspace for runs of the port on the GPU: a seeded
full-width TS104 checkpoint (TS104_GIN by default; TS104_GIN_MIND and the
other families by their trainer) and one CT-like target volume with
labels, laid out as `prepare_tta` / `run_tta` expect.

    ws = make_workspace(Path(tmp), seed=0)
    cli(["prepare_tta", "TS104_GIN", ws.dataset_id])

    ws = make_workspace(Path(tmp), trainer="nnUNetTrainer_GIN_MIND")
    cli(["prepare_tta", "TS104_GIN_MIND", ws.dataset_id])

`chip_smoke.py` and `obs/profile_adaptation.py` build their runs on it.

`make_pretrain_dataset` writes a labelled nnUNet raw dataset of synthetic
CTs and the full-width TS104 plans for `dgtta pretrain`
(`train/pretrain.run_pretraining`); `chip_smoke.py` and
`obs/profile_pretrain.py` train on it.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

VOLUME_SHAPE = (224, 224, 256)   # voxels at the TS104 spacing of 1.5 mm
DATASET_ID = "900"
PRETRAIN_DATASET_ID = "901"
# the pretraining cases: the TS104 patch (112 x 112 x 128) fits without
# resampling or padding
PRETRAIN_SHAPE = (128, 128, 144)
TARGET_LABELS = {"background": 0, "liver": 1, "spleen": 2, "kidney_left": 3}


def synthetic_ct(rng, shape=VOLUME_SHAPE):
    """A CT-like volume in HU (air, body, organs, spine) and its labels
    (1 liver, 2 spleen, 3 kidney_left), int16 / uint8."""
    D, H, W = shape
    z, y, x = np.meshgrid(np.linspace(-1, 1, D), np.linspace(-1, 1, H),
                          np.linspace(-1, 1, W), indexing="ij")
    vol = np.full(shape, -1000.0, np.float32)
    seg = np.zeros(shape, np.uint8)
    body = (y / 0.8) ** 2 + (x / 0.9) ** 2 < 1.0
    vol[body] = 30.0
    organs = [(1, (0.1, 0.2, -0.35), (0.5, 0.3, 0.3), 60.0),
              (2, (0.1, 0.2, 0.45), (0.3, 0.2, 0.15), 45.0),
              (3, (-0.1, 0.45, 0.3), (0.25, 0.12, 0.12), 35.0)]
    for lbl, c, r, hu in organs:
        m = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
             + ((x - c[2]) / r[2]) ** 2) < 1.0
        vol[m] = hu
        seg[m] = lbl
    spine = ((y - 0.55) / 0.1) ** 2 + (x / 0.1) ** 2 < 1.0
    vol[spine] = 700.0
    vol += rng.normal(0.0, 20.0, size=shape).astype(np.float32)
    return np.clip(vol, -1024, 3071).astype(np.int16), seg


@dataclasses.dataclass(frozen=True)
class Workspace:
    root: Path
    raw: Path
    results: Path
    checkpoint: Path
    n_params: int
    dataset_id: str = DATASET_ID


def make_workspace(work: Path, seed: int = 0, shape=VOLUME_SHAPE,
                   trainer: str = "nnUNetTrainer_GIN") -> Workspace:
    """Write the workspace under `work` and point DG_TTA_ROOT, nnUNet_raw
    and nnUNet_results at it.  The checkpoint holds the full-width TS104
    U-Net of `trainer` (105 classes; 12 input channels for a MIND family)
    with weights drawn from `seed`, under that trainer's directory; the
    target dataset one synthetic CT of `shape` with its labels."""
    from dg_tta_tpu_torch.data.io import write_image
    from dg_tta_tpu_torch.models.convert import save_flat_npz
    from dg_tta_tpu_torch.obs.profile_inference import (N_CLASSES,
                                                        seeded_net,
                                                        ts104_model)

    work = Path(work)
    root, raw, results = work / "dg_tta_root", work / "raw", work / "results"
    for d in (root, raw, results):
        d.mkdir(parents=True)
    os.environ.update(DG_TTA_ROOT=str(root), nnUNet_raw=str(raw),
                      nnUNet_results=str(results))

    labels = ts104_labels(N_CLASSES)
    trainer_dir = (root / "_pretrained_weights" /
                   f"{trainer}__nnUNetPlans__3d_fullres")
    (trainer_dir / "fold_0").mkdir(parents=True)
    with open(trainer_dir / "dataset.json", "w") as f:
        json.dump({"labels": labels, "channel_names": {"0": "CT"},
                   "file_ending": ".nii.gz"}, f)
    net = seeded_net(ts104_model(trainer=trainer), seed, "cpu")
    checkpoint = trainer_dir / "fold_0" / "checkpoint_final.npz"
    save_flat_npz(net.state_dict(), checkpoint)

    tgt = raw / f"Dataset{DATASET_ID}_SynthCT"
    (tgt / "imagesTs").mkdir(parents=True)
    (tgt / "labelsTs").mkdir()
    with open(tgt / "dataset.json", "w") as f:
        json.dump({"labels": TARGET_LABELS, "channel_names": {"0": "CT"},
                   "numTraining": 0, "file_ending": ".nii.gz"}, f)
    vol, seg = synthetic_ct(np.random.default_rng(seed), shape)
    props = {"spacing": (1.5, 1.5, 1.5)}
    write_image(tgt / "imagesTs" / "case_0000.nii.gz", vol, props,
                dtype=np.int16)
    write_image(tgt / "labelsTs" / "case.nii.gz", seg, props)
    return Workspace(root=root, raw=raw, results=results,
                     checkpoint=checkpoint,
                     n_params=sum(p.numel() for p in net.parameters()))


def ts104_labels(n_classes: int):
    """The label table of the synthetic TS104 checkpoints: five named
    organs, then `class_006` ...; {name: id}."""
    labels = {"background": 0, "spleen": 1, "kidney_right": 2,
              "kidney_left": 3, "gallbladder": 4, "liver": 5}
    labels.update({f"class_{i:03d}": i for i in range(6, n_classes)})
    return labels


def make_pretrain_dataset(work: Path, n_cases: int = 3, seed: int = 0,
                          shape=PRETRAIN_SHAPE):
    """Write `n_cases` synthetic CTs of `shape` at 1.5 mm with their labels
    as the nnUNet raw dataset `Dataset901_SynthPretrain` under `work`
    (`nnUNet_raw`, `nnUNet_results` and `nnUNet_preprocessed` point there),
    labelled in the 105-class TS104 table: the phantom's organs as liver,
    spleen and kidney_left, and its spine (the bone band, > 400 HU) as
    class 10.  Returns (dataset id, the full-width TS104 plans)."""
    from dg_tta_tpu_torch.data.io import write_image
    from dg_tta_tpu_torch.obs.profile_inference import N_CLASSES
    from dg_tta_tpu_torch.resources import materialize_scaffold

    work = Path(work)
    raw = work / "raw" / f"Dataset{PRETRAIN_DATASET_ID}_SynthPretrain"
    (raw / "imagesTr").mkdir(parents=True)
    (raw / "labelsTr").mkdir()
    (work / "results").mkdir()
    os.environ.update(nnUNet_raw=str(work / "raw"),
                      nnUNet_results=str(work / "results"),
                      nnUNet_preprocessed=str(work / "preprocessed"))
    labels = ts104_labels(N_CLASSES)
    with open(raw / "dataset.json", "w") as f:
        json.dump({"labels": labels, "channel_names": {"0": "CT"},
                   "numTraining": n_cases, "file_ending": ".nii.gz"}, f)
    code = np.array([0, labels["liver"], labels["spleen"],
                     labels["kidney_left"]], np.uint8)
    rng = np.random.default_rng(seed)
    props = {"spacing": (1.5, 1.5, 1.5)}
    for i in range(n_cases):
        vol, seg = synthetic_ct(rng, shape)
        seg = code[seg]
        seg[(vol > 400) & (seg == 0)] = 10
        write_image(raw / "imagesTr" / f"case{i}_0000.nii.gz", vol, props,
                    dtype=np.int16)
        write_image(raw / "labelsTr" / f"case{i}.nii.gz", seg, props)
    materialize_scaffold("nnUNetTrainer_GIN__nnUNetPlans__3d_fullres",
                         work / "scaffold")
    plans = json.loads((work / "scaffold" / "plans.json").read_text())
    plans["dataset_name"] = raw.name
    return PRETRAIN_DATASET_ID, plans


def edit_plan(pretrained_config="TS104_GIN", **changes):
    """Change keys of the prepared plan of `pretrained_config` (a TS104
    alias) for the synthetic dataset (after `prepare_tta`); returns the
    run results directory and the plan as a dict."""
    from dg_tta_tpu_torch.tta.config import TS104_ALIASES, get_tta_folders

    _, plan_dir, results_dir, _, _ = get_tta_folders(
        pretrained_config, DATASET_ID, TS104_ALIASES[pretrained_config],
        "3d_fullres", "0")
    path = plan_dir / "tta_plan.json"
    plan = json.loads(path.read_text())
    plan.update(changes)
    path.write_text(json.dumps(plan, indent=4))
    return results_dir, plan
