"""Where the time of one TS104 ensemble inference goes on the GPU.

    python -m dg_tta_tpu_torch.obs.profile_inference
        [--dtype float32|bfloat16] [--trace trace.json]

Runs `predict_volume` of the full-width TS104_GIN U-Net (105 classes,
seeded random weights, E = 3 members as in the TTA plan) over a
224 x 224 x 256 volume (27 windows) once to warm up, then once under
`torch.profiler`, including the copy of the logits to the host as
`tta/driver.py` does.  Prints the wall time, the device time summed per
kernel name (top 15), and the device's idle share: one minus the summed
device time over the wall time (one stream, so device intervals do not
overlap).  `--trace` writes the Chrome trace.

`ts104_model` and `seeded_net` also build the model of `chip_smoke.py`.
"""

import argparse
import dataclasses
import time
from collections import defaultdict

import torch

VOLUME_SHAPE = (224, 224, 256)
N_CLASSES = 105
MEMBERS = 3


def ts104_model(patch_size=None, compute_dtype=None,
                trainer="nnUNetTrainer_GIN", features=None):
    """The TS104 model of `trainer` (TS104_GIN by default; 105 classes),
    optionally with another patch, or with `features` = (base, cap), the
    plan's `UNet_base_num_features` and `unet_max_num_features` (widths
    min(base * 2**i, cap)) in place of the published 32 and 320."""
    from dg_tta_tpu_torch.models.network import build_model
    from dg_tta_tpu_torch.resources import TS104_3D_FULLRES

    cfg = dict(TS104_3D_FULLRES)
    if patch_size is not None:
        cfg["patch_size"] = list(patch_size)
    if features is not None:
        cfg["UNet_base_num_features"], cfg["unet_max_num_features"] = \
            features
    plans = {"configurations": {"3d_fullres": cfg}}
    ds = {"labels": {f"c{i}": i for i in range(N_CLASSES)},
          "channel_names": {"0": "CT"}}
    model = build_model(plans, ds, trainer)
    return dataclasses.replace(model, compute_dtype=compute_dtype)


def seeded_net(model, seed, device):
    """`model`'s network with weights drawn on the CPU from `seed`, then
    moved to `device`, so every device gets the same weights."""
    return model.build_network(
        model.init_params(torch.Generator().manual_seed(seed)), device)


def main(argv=None):
    from dg_tta_tpu_torch.infer.sliding_window import predict_volume
    from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3
    from dg_tta_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)

    device = resolve_device("cuda")
    model = ts104_model(
        compute_dtype=None if args.dtype == "float32" else args.dtype)
    nets = [seeded_net(model, 100 + i, device) for i in range(MEMBERS)]
    gen = torch.Generator().manual_seed(0)
    vol = torch.randn((*VOLUME_SHAPE, 1), generator=gen).to(device)

    predict_volume(model, nets, vol).cpu()
    torch.cuda.synchronize()
    launches0 = conv3x3.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        predict_volume(model, nets, vol).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = defaultdict(float)
    counts = defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            counts[evt.name] += 1
    busy = sum(per_name.values())
    print(f"device {torch.cuda.get_device_name(0)}; {MEMBERS} members, "
          f"{args.dtype}, volume {VOLUME_SHAPE}; "
          f"conv3x3 launches {conv3x3.launches - launches0}")
    print(f"wall {wall * 1e3:.1f} ms (profiled), device busy {busy:.1f} ms, "
          f"idle share {1 - busy / (wall * 1e3):.3f}")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{ms:10.1f} ms {100 * ms / busy:5.1f}% x{counts[name]:<6d} "
              f"{name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
