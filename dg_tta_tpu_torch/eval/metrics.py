"""Folder-level segmentation metrics with nnUNet's summary.json schema.

Replaces the reference's call into nnUNet's
`compute_metrics_on_folder_simple` (upstream DG-TTA dg_tta/tta/tta.py:463-470):
per-case per-class Dice/IoU over matching files in a prediction and a
reference folder, aggregated into `mean` and `foreground_mean`, written as
summary.json.  Cases are processed with a thread pool (IO-bound reads;
`num_processes` keeps the reference's plan knob meaningful).
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from dg_tta_tpu_torch.data.io import SUPPORTED_ENDINGS, read_image


def _case_metrics(pred_file, ref_file, labels):
    pred, _ = read_image(pred_file)
    ref, _ = read_image(ref_file)
    pred = pred[0].astype(np.int32)
    ref = ref[0].astype(np.int32)
    out = {}
    for lbl in labels:
        p = pred == lbl
        r = ref == lbl
        tp = int(np.logical_and(p, r).sum())
        fp = int(p.sum()) - tp
        fn = int(r.sum()) - tp
        denom = 2 * tp + fp + fn
        dice = 2 * tp / denom if denom > 0 else float("nan")
        union = tp + fp + fn
        iou = tp / union if union > 0 else float("nan")
        out[str(lbl)] = {"Dice": dice, "IoU": iou, "FP": fp, "FN": fn,
                         "TP": tp, "n_pred": tp + fp, "n_ref": tp + fn}
    return out


def compute_metrics_on_folder(pred_dir, ref_dir, labels, num_processes: int = 1,
                              output_file="summary.json", chill: bool = True):
    """Compare same-named files in pred_dir vs ref_dir.

    Args:
      labels: iterable of integer label ids INCLUDING background 0 (it is
        excluded from foreground_mean, like nnUNet).
      chill: tolerate reference files without a prediction (tta.py:469).
    Returns the summary dict (also written to pred_dir/output_file).
    """
    pred_dir, ref_dir = Path(pred_dir), Path(ref_dir)
    labels = [int(l) for l in labels]
    ref_files = sorted(p for p in ref_dir.iterdir()
                       if p.name.endswith(SUPPORTED_ENDINGS))
    pairs = []
    for rf in ref_files:
        pf = pred_dir / rf.name
        if not pf.exists():
            if chill:
                continue
            raise FileNotFoundError(f"Missing prediction {pf}")
        pairs.append((pf, rf))

    with ThreadPoolExecutor(max_workers=max(1, num_processes)) as ex:
        per_case = list(ex.map(
            lambda pr: _case_metrics(pr[0], pr[1], labels), pairs))

    metric_per_case = [
        {"prediction_file": str(pf), "reference_file": str(rf),
         "metrics": m}
        for (pf, rf), m in zip(pairs, per_case)]

    mean = {}
    for lbl in labels:
        key = str(lbl)
        mean[key] = {}
        for metric in ("Dice", "IoU"):
            vals = [m[key][metric] for m in per_case]
            mean[key][metric] = float(np.nanmean(vals)) if vals else float("nan")

    fg = [mean[str(l)]["Dice"] for l in labels if l != 0]
    foreground_mean = {"Dice": float(np.nanmean(fg)) if fg else float("nan")}

    summary = {"foreground_mean": foreground_mean, "mean": mean,
               "metric_per_case": metric_per_case}
    out_path = pred_dir / output_file
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=4)
    return summary
