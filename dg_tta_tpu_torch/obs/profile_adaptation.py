"""Where the time of TTA adaptation goes on the GPU, and one full run of the
default plan through the CLI.

    python -m dg_tta_tpu_torch.obs.profile_adaptation
        [--dtype float32|bfloat16] [--pretrained TS104_GIN|TS104_GIN_MIND|...]
        [--trace trace.json] [--no-cli]

1. Profile: the full-width U-Net of `--pretrained` (TS104_GIN by default;
   a MIND family computes its descriptor in every forward; 105 classes,
   seeded random weights) adapts on a 224 x 224 x 256 volume at patch
   112 x 112 x 128.
   One training epoch of `STEPS` accumulated patch steps runs once to
   warm up, then once under `torch.profiler`: prints the wall time per
   step, the device time summed per kernel name (top 15), the device's
   idle share (one minus the summed device time over the wall time; one
   stream, so device intervals do not overlap), the device kernels per
   step (every kernel the profiler saw, library ones included), the
   launches of the port's kernels and the peak device memory.
2. CLI (unless --no-cli): `prepare_tta` and `run_tta` of the default
   TEMPLATE_PLAN (12 epochs x 16 patches x 3 members) on the synthetic
   workspace of `obs/synthetic.py`, with no member files, in `--dtype`
   (`DGTTA_COMPUTE_DTYPE` is set for the call and restored after it);
   prints the phases of `timings.json`, tta_sec_per_volume (adaptation +
   inference), the peak device memory, the members' final losses and the
   kernels' launches per route.
"""

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

VOLUME_SHAPE = (224, 224, 256)
# accumulated patch steps of the profiled epoch
STEPS = 4


def _counters():
    from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3, conv3x3_wgrad
    from dg_tta_tpu_torch.kernels.warp import warp_affine_flat, warp_flat

    return {"conv3x3": conv3x3, "conv3x3_wgrad": conv3x3_wgrad,
            "warp": warp_flat, "warp_affine": warp_affine_flat}


def _route_counts():
    """{kernel: {route: launches}} of the port's kernels so far."""
    from dg_tta_tpu_torch.kernels.conv3x3 import route_launches

    return {k: (route_launches(c) if k.startswith("conv3x3")
                else {"cuda": c.launches})
            for k, c in _counters().items()}


def _trainer(pretrained):
    from dg_tta_tpu_torch.tta.config import TS104_ALIASES

    return TS104_ALIASES[pretrained]


def profile_steps(dtype, trace=None, pretrained="TS104_GIN"):
    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.obs.synthetic import synthetic_ct
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import (make_optimizer,
                                             make_tta_functions)
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    import numpy as np

    device = torch.device("cuda")
    model = ts104_model(
        compute_dtype=None if dtype == "float32" else dtype,
        trainer=_trainer(pretrained))
    plan = TTAPlan(patches_to_be_accumulated=STEPS)
    net = seeded_net(model, 0, device)
    opt = make_optimizer(plan, list(net.parameters()))
    vol, _ = synthetic_ct(np.random.default_rng(0), VOLUME_SHAPE)
    # a CT-like scale: the preprocessing maps HU to roughly unit variance
    vols = torch.from_numpy(vol.astype(np.float32) / 500.0)[None, ..., None]
    vols = vols.to(device)
    shapes = [list(map(float, VOLUME_SHAPE))]
    idx = np.arange(4)
    fns = make_tta_functions(model, plan, idx, idx)
    draws = TorchDraws(seed=0)

    fns.epoch_train(net, opt, draws, 0, 0, vols, shapes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    before = {k: c.launches for k, c in counters.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss = fns.epoch_train(net, opt, draws, 0, 1, vols, shapes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    per_name, counts = defaultdict(float), defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            counts[evt.name] += 1
    busy = sum(per_name.values())
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    print(f"profile: device {torch.cuda.get_device_name(0)}; {pretrained}; "
          f"{dtype}; one epoch of {STEPS} patch steps (batch 2 x 112x112x128, both "
          f"branches) + AdamW; loss {float(loss):.5f}")
    print(f"profile: wall {wall * 1e3:.1f} ms = {wall * 1e3 / STEPS:.1f} "
          f"ms/step (profiled), device busy {busy:.1f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}, device kernels per step "
          f"{sum(counts.values()) / STEPS:.1f}, peak device memory "
          f"{peak:.2f} GiB, launches {launches}")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{ms:10.1f} ms {100 * ms / busy:5.1f}% x{counts[name]:<6d} "
              f"{name[:110]}")
    if trace:
        prof.export_chrome_trace(trace)


def run_default_plan(dtype="float32", pretrained="TS104_GIN"):
    from dg_tta_tpu_torch.cli.main import main as cli
    from dg_tta_tpu_torch.obs.synthetic import edit_plan, make_workspace

    with tempfile.TemporaryDirectory(prefix="profile_adaptation_") as tmp:
        ws = make_workspace(Path(tmp), seed=0, shape=VOLUME_SHAPE,
                            trainer=_trainer(pretrained))
        cli(["prepare_tta", pretrained, ws.dataset_id])
        results_dir, plan = edit_plan(pretrained)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _route_counts()
        saved = os.environ.get("DGTTA_COMPUTE_DTYPE")
        os.environ["DGTTA_COMPUTE_DTYPE"] = dtype
        try:
            t0 = time.perf_counter()
            cli(["run_tta", pretrained, ws.dataset_id])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            if saved is None:
                del os.environ["DGTTA_COMPUTE_DTYPE"]
            else:
                os.environ["DGTTA_COMPUTE_DTYPE"] = saved
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {k: {r: n - before[k][r] for r, n in routes.items()}
                    for k, routes in _route_counts().items()}
        (run_dir,) = [p for p in results_dir.iterdir() if p.is_dir()]
        timings = json.loads((run_dir / "timings.json").read_text())
        final = [json.loads(p.read_text())["losses"][-1] for p in
                 sorted((run_dir / "tta_outputTs").glob("*_results.json"))]
    phases = timings["phases"]
    adapt = phases["adaptation"]["total_s"]
    infer = phases["inference"]["total_s"]
    print(f"cli: {pretrained} default plan ({plan['epochs']} epochs x "
          f"{plan['patches_to_be_accumulated']} patches x "
          f"{plan['ensemble_count']} members, {dtype}) on "
          f"{timings['device']}: "
          f"run_tta wall {wall:.2f} s; phases " + ", ".join(
              f"{k}={v['total_s']:.3f}s" for k, v in phases.items()))
    print(f"cli: tta_sec_per_volume {adapt + infer:.3f} (adaptation "
          f"{adapt:.3f} + inference {infer:.3f}); peak device memory "
          f"{peak:.2f} GiB; final losses {final}")
    print("cli: launches per route " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))


def main(argv=None):
    from dg_tta_tpu_torch.tta.config import TS104_ALIASES
    from dg_tta_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--pretrained", default="TS104_GIN",
                   choices=sorted(TS104_ALIASES))
    p.add_argument("--trace", default=None)
    p.add_argument("--no-cli", action="store_true")
    args = p.parse_args(argv)
    resolve_device("cuda")
    profile_steps(args.dtype, args.trace, args.pretrained)
    if not args.no_cli:
        run_default_plan(args.dtype, args.pretrained)


if __name__ == "__main__":
    main()
