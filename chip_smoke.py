"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device: requires `torch.cuda.is_available()`; prints the card's name and
   power limit as `nvidia-smi` reports them;
2. build: compiles every CUDA kernel of the main path from the checkout's
   sources (one `nvcc` per source, all started together);
3. kernels: holds `conv3x3` against its plain version on the card at every
   stride-1 conv shape of a TS104 window forward, in f32 (TF32 off for the
   reference) and bf16, and times the kernel, the plain version and one
   `F.conv3d` call (a yardstick only; the port never calls it);
4. reference: the full-width TS104_GIN U-Net and `predict_volume` on small
   inputs, on the card, against the same code on the CPU (plain versions);
5. main path: `prepare_tta` and `run_tta` through the port's CLI on a
   synthetic CT volume of 224 x 224 x 256 voxels at 1.5 mm (27 windows),
   a seeded full-width TS104_GIN checkpoint (105 classes) and three seeded
   members; checks the segmentation's shape and that every window forward
   went through the kernel.

It prints one JSON line with the kernels' numbers and, last, one JSON line
naming the device.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# TS104 window forward (patch 112 x 112 x 128): every stride-1 3x3x3 conv as
# (depth, H, W, C, CO, convs of this shape per forward).
TS104_CONV_SHAPES = [
    (112, 112, 128, 1, 32, 1),
    (112, 112, 128, 32, 32, 2),
    (112, 112, 128, 64, 32, 1),
    (56, 56, 64, 64, 64, 2),
    (56, 56, 64, 128, 64, 1),
    (28, 28, 32, 128, 128, 2),
    (28, 28, 32, 256, 128, 1),
    (14, 14, 16, 256, 256, 2),
    (14, 14, 16, 512, 256, 1),
    (7, 7, 8, 320, 320, 1),
]
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores, HBM3 bandwidth.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# Kernel vs plain version, max |diff| / max |plain|: both sum the same
# products in f32 in another order (f32), and both round that sum to bf16
# once, so they may differ by the last bit at the largest magnitude (bf16).
KERNEL_RTOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}
# Network on the card vs on the CPU (plain versions), f32, max |diff| over
# max |CPU|: summation order only, compounded over the layers.
REF_RTOL = 1e-4
N_CLASSES = 105
VOLUME_SHAPE = (224, 224, 256)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    from dg_tta_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(["conv3x3"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_flops,
                                                  conv3x3_reference)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, max_abs_err=0.0)
        for depth, H, W, C, CO, mult in TS104_CONV_SHAPES:
            x = torch.randn((depth, H, W, C), generator=gen).to(dt).cuda()
            w = (torch.randn((3, 3, 3, C, CO), generator=gen)
                 * (2.0 / (27 * C)) ** 0.5).to(dt).cuda()
            got = conv3x3(x, w, depth=depth)
            torch.cuda.synchronize()
            ref = conv3x3_reference(x, w, depth=depth)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = KERNEL_RTOL[name] * scale
            if not err <= tol:
                raise AssertionError(f"conv3x3 {name} {(depth, H, W, C, CO)}:"
                                     f" max abs err {err} > tol {tol}")
            x5 = x.view(1, depth, H, W, C).permute(0, 4, 1, 2, 3)
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            k_ms = time_ms(lambda: conv3x3(x, w, depth=depth))
            p_ms = time_ms(lambda: conv3x3_reference(x, w, depth=depth))
            l_ms = time_ms(lambda: F.conv3d(x5, wt, padding=1))
            ops = conv3x3_flops(x.shape, w.shape, depth)
            nbytes = (x.numel() + w.numel() + depth * H * W * CO) \
                * x.element_size()
            ops_ms = ops / PEAK_OPS[name] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            log(f"conv3x3 {name} depth={depth} {H}x{W} {C}->{CO}: "
                f"max_abs_err={err:.3e} (tol {tol:.3e}) "
                f"max_rel_err={err / scale:.3e} (tol {KERNEL_RTOL[name]:.1e}) "
                f"kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                f"bound_ms={max(ops_ms, bytes_ms):.4f} "
                f"({'operations' if ops_ms >= bytes_ms else 'bytes'}) "
                f"TFLOP/s={ops / k_ms / 1e9:.2f} x{mult}/forward")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("library_ms", l_ms), ("ops_ms", ops_ms),
                           ("bytes_ms", bytes_ms)):
                tot[key] += mult * v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        n_convs = sum(shape[-1] for shape in TS104_CONV_SHAPES)
        log(f"conv3x3 {name} per window forward ({n_convs} convs): "
            f"kernel_ms={tot['ms']:.3f} plain_ms={tot['plain_ms']:.3f} "
            f"library_ms={tot['library_ms']:.3f} "
            f"bound_ms={max(tot['ops_ms'], tot['bytes_ms']):.3f}")
        totals[name] = tot
    return totals


def phase_reference():
    """Full-width network and predict_volume on the card against the CPU."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.infer.sliding_window import predict_volume
    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ts104_model(patch_size=(32, 48, 64))
    cpu_nets = [seeded_net(model, s, "cpu") for s in (11, 12)]
    gpu_nets = [seeded_net(model, s, "cuda") for s in (11, 12)]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 32, 48, 64, 1))
                         .astype(np.float32))
    with torch.no_grad():
        ref = cpu_nets[0](x)
        got = gpu_nets[0](x.cuda()).cpu()
        got_bf16 = gpu_nets[0](x.cuda(), compute_dtype="bfloat16").float().cpu()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    # f32: the same math summed in another order over the network's layers
    if not (got.shape == ref.shape and torch.isfinite(got).all()
            and err <= REF_RTOL * scale):
        raise AssertionError(f"U-Net f32 card vs CPU: err {err} scale {scale}")
    rel = (got_bf16 - ref).abs().max().item() / scale
    # bf16 compute vs f32: the bound of tests/test_unet.py
    if not rel < 0.05:
        raise AssertionError(f"U-Net bf16 card vs f32 CPU: rel {rel}")
    log(f"reference: U-Net {tuple(x.shape)} f32 max_abs_err={err:.3e} "
        f"(tol {REF_RTOL * scale:.3e}); bf16 rel_err={rel:.3e} (tol 5e-2)")

    vol = torch.from_numpy(rng.standard_normal((40, 56, 70, 1))
                           .astype(np.float32))
    with torch.no_grad():
        ref_v = predict_volume(model, cpu_nets, vol, bucket_multiple=16)
        got_v = predict_volume(model, gpu_nets, vol.cuda(),
                               bucket_multiple=16).cpu()
    err_v = (got_v - ref_v).abs().max().item()
    scale_v = ref_v.abs().max().item()
    if not (got_v.shape == (40, 56, 70, N_CLASSES)
            and torch.isfinite(got_v).all() and err_v <= REF_RTOL * scale_v):
        raise AssertionError(f"predict_volume card vs CPU: err {err_v}")
    log(f"reference: predict_volume E=2 {tuple(vol.shape)} "
        f"max_abs_err={err_v:.3e} (tol {REF_RTOL * scale_v:.3e})")


def synthetic_ct(rng, shape):
    """A CT-like volume in HU (air, body, organs, spine) and its labels
    (1 liver, 2 spleen, 3 kidney_left), int16 / uint8."""
    import numpy as np

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


def phase_main_path(work: Path):
    import numpy as np
    import torch

    from dg_tta_tpu_torch.cli.main import main as cli
    from dg_tta_tpu_torch.data.io import read_image, write_image
    from dg_tta_tpu_torch.infer.sliding_window import (padded_shape,
                                                         window_origins)
    from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3
    from dg_tta_tpu_torch.models.convert import save_flat_npz
    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.tta.config import (get_parameters_save_path,
                                             get_tta_folders)

    root, raw, results = work / "dg_tta_root", work / "raw", work / "results"
    for d in (root, raw, results):
        d.mkdir()
    os.environ.update(DG_TTA_ROOT=str(root), nnUNet_raw=str(raw),
                      nnUNet_results=str(results))

    model = ts104_model()
    labels = {"background": 0, "spleen": 1, "kidney_right": 2,
              "kidney_left": 3, "gallbladder": 4, "liver": 5}
    labels.update({f"class_{i:03d}": i for i in range(6, N_CLASSES)})
    trainer_dir = (root / "_pretrained_weights" /
                   "nnUNetTrainer_GIN__nnUNetPlans__3d_fullres")
    (trainer_dir / "fold_0").mkdir(parents=True)
    with open(trainer_dir / "dataset.json", "w") as f:
        json.dump({"labels": labels, "channel_names": {"0": "CT"},
                   "file_ending": ".nii.gz"}, f)
    pretrained = seeded_net(model, 0, "cpu")
    n_params = sum(p.numel() for p in pretrained.parameters())
    save_flat_npz(pretrained.state_dict(),
                  trainer_dir / "fold_0" / "checkpoint_final.npz")

    tgt = raw / "Dataset900_SynthCT"
    (tgt / "imagesTs").mkdir(parents=True)
    (tgt / "labelsTs").mkdir()
    with open(tgt / "dataset.json", "w") as f:
        json.dump({"labels": {"background": 0, "liver": 1, "spleen": 2,
                              "kidney_left": 3},
                   "channel_names": {"0": "CT"}, "numTraining": 0,
                   "file_ending": ".nii.gz"}, f)
    vol, seg = synthetic_ct(np.random.default_rng(0), VOLUME_SHAPE)
    props = {"spacing": (1.5, 1.5, 1.5)}
    write_image(tgt / "imagesTs" / "case_0000.nii.gz", vol, props,
                dtype=np.int16)
    write_image(tgt / "labelsTs" / "case.nii.gz", seg, props)

    cli(["prepare_tta", "TS104_GIN", "900"])
    _, plan_dir, results_dir, _, _ = get_tta_folders(
        "TS104_GIN", "900", "nnUNetTrainer_GIN", "3d_fullres", "0")
    plan = json.loads((plan_dir / "tta_plan.json").read_text())
    n_members = plan["ensemble_count"]
    run_dir = results_dir / "chip_smoke-001"
    for i in range(n_members):
        member = seeded_net(model, 100 + i, "cpu")
        path = get_parameters_save_path(run_dir / "tta_outputTs", "case", i)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_flat_npz(member.state_dict(), path)
    log(f"main path: TS104_GIN {n_params} parameters, {N_CLASSES} classes, "
        f"volume {VOLUME_SHAPE}, {n_members} members")

    windows = int(window_origins(padded_shape(VOLUME_SHAPE, model.patch_size),
                                 model.patch_size)[1].sum())
    convs_per_forward = (sum(model.spec.n_conv_per_stage_encoder)
                         - sum(1 for s in model.spec.strides if s != (1, 1, 1))
                         + sum(model.spec.n_conv_per_stage_decoder))
    torch.cuda.synchronize()
    conv3x3.launches = 0
    t0 = time.perf_counter()
    summaries = cli(["run_tta", "TS104_GIN", "900", "--run_no", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = conv3x3.launches

    expected = windows * n_members * convs_per_forward
    if launches != expected:
        raise AssertionError(f"conv3x3 launched {launches} times, expected "
                             f"{windows} windows x {n_members} members x "
                             f"{convs_per_forward} convs = {expected}")
    pred, _ = read_image(run_dir / "tta_outputTs" / "case.nii.gz")
    if pred.shape != (1, *VOLUME_SHAPE):
        raise AssertionError(f"segmentation shape {pred.shape}")
    n_opt = len(plan["optimized_labels"])
    if not (np.isfinite(pred).all() and pred.min() >= 0
            and pred.max() < n_opt):
        raise AssertionError("segmentation labels out of range")
    if "Ts" not in summaries:
        raise AssertionError("no evaluation summary")
    timings = json.loads((run_dir / "timings.json").read_text())
    infer_s = timings["phases"]["inference"]["total_s"]
    if not timings["device"].startswith("cuda"):
        raise AssertionError(f"run_tta ran on {timings['device']}")
    log(f"main path: run_tta {wall:.2f} s wall; phases " + ", ".join(
        f"{k}={v['total_s']:.2f}s" for k, v in timings["phases"].items()))
    log(f"main path: inference {infer_s:.3f} s/volume = "
        f"{60.0 / infer_s:.2f} vol/min ({windows} windows x {n_members} "
        f"members, {launches} conv3x3 launches, f32); foreground Dice "
        f"{summaries['Ts']['foreground_mean']['Dice']:.4f} (random weights)")
    return launches


def main():
    phase_device()
    import torch

    from dg_tta_tpu_torch.kernels.conv3x3 import REPLACES, SOURCE

    phase_build()
    totals = phase_kernels()
    phase_reference()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_main_path(Path(tmp))

    f32 = totals["float32"]
    bound_by = "operations" if f32["ops_ms"] >= f32["bytes_ms"] else "bytes"
    print(json.dumps({"kernels": [{
        "name": "conv3x3", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": max(f32["ops_ms"], f32["bytes_ms"]),
        "bound_by": bound_by, "library_ms": f32["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
