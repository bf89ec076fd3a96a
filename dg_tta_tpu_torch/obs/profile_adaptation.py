"""Where the time of TTA adaptation goes on the GPU, and one full run of the
default plan through the CLI.

    python -m dg_tta_tpu_torch.obs.profile_adaptation
        [--dtype float32|bfloat16 ...]
        [--pretrained TS104_GIN|TS104_GIN_MIND|...]
        [--spatial-aug affine|deformable ...] [--patch-group N ...]
        [--ensemble-chunk M ...] [--remat] [--exact-warp-grad]
        [--trace trace.json] [--no-cli]

Each combination of `--dtype`, `--spatial-aug` (default: affine;
`--spatial-aug affine deformable` profiles both back to back, for the
deformable premium per step and per volume from one call) and
`--patch-group` (default 1; `--patch-group 1 2 4` folds 1, 2 and 4 patch
draws into each step, so that one call compares them on one card) and
`--ensemble-chunk` (default 1; `--ensemble-chunk 1 3` adapts 1 and 3
members side by side, `tta/engine.TTAFunctions.chunk_run`) runs both
parts; `--remat` recomputes both branches in the backward
(`DGTTA_REMAT`) and `--exact-warp-grad` gives the unwarps their exact
adjoint (`DGTTA_EXACT_WARP_GRAD`) in both.  The last lines print one
JSON object per profiled combination (`summary:`; a combination whose
step does not fit the card's memory prints that and its summary says
`out_of_memory`):

1. Profile: the full-width U-Net of `--pretrained` (TS104_GIN by default;
   a MIND family computes its descriptor in every forward; 105 classes,
   seeded random weights) adapts on a 224 x 224 x 256 volume at patch
   112 x 112 x 128.
   One training epoch of `DRAWS` patch draws (DRAWS / N trained steps of
   N draws each at patch group N) runs once to warm up, then once under
   `torch.profiler`: prints the wall time per trained step and per patch
   draw, the device time summed per kernel name (top 15), the device's
   idle share (one minus the summed device time over the wall time; one
   stream, so device intervals do not overlap), the device kernels per
   step and per draw (every kernel the profiler saw, library ones
   included), the launches of the port's kernels and the peak device
   memory.  With M members side by side a step takes each member's draws,
   and the time per member-draw is the wall time over DRAWS x M.
2. CLI (unless --no-cli): `prepare_tta` and `run_tta` of the default
   TEMPLATE_PLAN (12 epochs x 16 patches x 3 members; the plan's
   patch_group and remat set as given) on the synthetic workspace of
   `obs/synthetic.py`, with no member files, in `--dtype`
   (`DGTTA_COMPUTE_DTYPE`, `DGTTA_ENSEMBLE_CHUNK`, and
   `DGTTA_EXACT_WARP_GRAD` with `--exact-warp-grad`, are set for the call
   and restored after it);
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
# patch draws of the profiled epoch (every patch group of --patch-group
# divides it)
DRAWS = 8


def _counters():
    from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3, conv3x3_wgrad
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                               warp_affine_flat_adjoint,
                                               warp_flat, warp_flat_adjoint)

    return {"conv3x3": conv3x3, "conv3x3_wgrad": conv3x3_wgrad,
            "warp": warp_flat, "warp_affine": warp_affine_flat,
            "warp_adjoint": warp_flat_adjoint,
            "warp_affine_adjoint": warp_affine_flat_adjoint}


def _route_counts():
    """{kernel: {route: launches}} of the port's kernels so far."""
    from dg_tta_tpu_torch.kernels.conv3x3 import route_launches

    return {k: (route_launches(c) if k.startswith("conv3x3")
                else {"cuda": c.launches})
            for k, c in _counters().items()}


def _trainer(pretrained):
    from dg_tta_tpu_torch.tta.config import TS104_ALIASES

    return TS104_ALIASES[pretrained]


def profile_steps(dtype, trace=None, pretrained="TS104_GIN",
                  spatial_aug="affine", exact=False, patch_group=1,
                  remat=False, chunk=1):
    """Profile one epoch of DRAWS patch draws of `chunk` members side by
    side; returns its summary."""
    from dg_tta_tpu_torch.models.unet import stack_members
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
    plan = TTAPlan(patches_to_be_accumulated=DRAWS,
                   spatial_aug_type=spatial_aug)
    steps = DRAWS // patch_group
    net = seeded_net(model, 0, device)
    # one member: its own network; several: their stacked weights
    params, member = None, 0
    leaves = list(net.parameters())
    if chunk > 1:
        params, member = stack_members([net] * chunk), list(range(chunk))
        leaves = [p.requires_grad_(True) for p in params.values()]
    opt = make_optimizer(plan, leaves)
    vol, _ = synthetic_ct(np.random.default_rng(0), VOLUME_SHAPE)
    # a CT-like scale: the preprocessing maps HU to roughly unit variance
    vols = torch.from_numpy(vol.astype(np.float32) / 500.0)[None, ..., None]
    vols = vols.to(device)
    shapes = [list(map(float, VOLUME_SHAPE))]
    idx = np.arange(4)
    fns = make_tta_functions(model, plan, idx, idx, exact_warp_grad=exact,
                             patch_group=patch_group, remat=remat)
    draws = TorchDraws(seed=0)

    fns.epoch_train(net, opt, draws, member, 0, vols, shapes, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    before = {k: c.launches for k, c in counters.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss = fns.epoch_train(net, opt, draws, member, 1, vols, shapes,
                               params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    per_name, counts = defaultdict(float), defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            counts[evt.name] += 1
    busy = sum(per_name.values())
    kernels = sum(counts.values())
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    losses = loss.reshape(-1).tolist()
    print(f"profile: device {torch.cuda.get_device_name(0)}; {pretrained}; "
          f"{spatial_aug}{' exact warp gradient' if exact else ''}; "
          f"{dtype}; patch_group {patch_group}{'; remat' if remat else ''}; "
          f"{chunk} member(s) side by side; one epoch of {DRAWS} patch "
          f"draws a member in {steps} trained steps (batch "
          f"{2 * patch_group * chunk} x 112x112x128: both branches) + "
          f"AdamW; loss {losses}")
    print(f"profile: wall {wall * 1e3:.1f} ms = {wall * 1e3 / steps:.1f} "
          f"ms/step = {wall * 1e3 / (DRAWS * chunk):.1f} ms/member-draw "
          f"(profiled), device busy {busy:.1f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}, device kernels per step "
          f"{kernels / steps:.1f} = per member-draw "
          f"{kernels / (DRAWS * chunk):.1f}, peak device memory "
          f"{peak:.2f} GiB, launches {launches}")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{ms:10.1f} ms {100 * ms / busy:5.1f}% x{counts[name]:<6d} "
              f"{name[:110]}")
    if trace:
        prof.export_chrome_trace(trace)
    return {"dtype": dtype, "pretrained": pretrained,
            "spatial_aug": spatial_aug, "exact": exact,
            "patch_group": patch_group, "remat": remat,
            "ensemble_chunk": chunk, "ms_per_step": wall * 1e3 / steps,
            "ms_per_member_draw": wall * 1e3 / (DRAWS * chunk),
            "idle_share": 1 - busy / (wall * 1e3),
            "kernels_per_step": kernels / steps,
            "kernels_per_member_draw": kernels / (DRAWS * chunk),
            "peak_gib": peak, "launches": launches, "loss": losses}


def run_default_plan(dtype="float32", pretrained="TS104_GIN",
                     spatial_aug="affine", exact=False, patch_group=1,
                     remat=False, chunk=1):
    from dg_tta_tpu_torch.cli.main import main as cli
    from dg_tta_tpu_torch.obs.synthetic import edit_plan, make_workspace

    with tempfile.TemporaryDirectory(prefix="profile_adaptation_") as tmp:
        ws = make_workspace(Path(tmp), seed=0, shape=VOLUME_SHAPE,
                            trainer=_trainer(pretrained))
        cli(["prepare_tta", pretrained, ws.dataset_id])
        results_dir, plan = edit_plan(pretrained,
                                      spatial_aug_type=spatial_aug,
                                      patch_group=patch_group, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _route_counts()
        saved = {k: os.environ.pop(k, None) for k in (
            "DGTTA_COMPUTE_DTYPE", "DGTTA_EXACT_WARP_GRAD",
            "DGTTA_ENSEMBLE_CHUNK")}
        os.environ["DGTTA_COMPUTE_DTYPE"] = dtype
        os.environ["DGTTA_ENSEMBLE_CHUNK"] = str(chunk)
        if exact:
            os.environ["DGTTA_EXACT_WARP_GRAD"] = "1"
        try:
            t0 = time.perf_counter()
            cli(["run_tta", pretrained, ws.dataset_id])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
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
    print(f"cli: {pretrained} default plan, {spatial_aug}"
          f"{' exact warp gradient' if exact else ''}"
          f"{' remat' if remat else ''} patch_group {patch_group} "
          f"ensemble_chunk {chunk} ({plan['epochs']} epochs x "
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
    p.add_argument("--dtype", nargs="+", default=["float32"],
                   choices=["float32", "bfloat16"])
    p.add_argument("--pretrained", default="TS104_GIN",
                   choices=sorted(TS104_ALIASES))
    p.add_argument("--spatial-aug", nargs="+", default=["affine"],
                   choices=["affine", "deformable"])
    p.add_argument("--patch-group", nargs="+", type=int, default=[1])
    p.add_argument("--ensemble-chunk", nargs="+", type=int, default=[1])
    p.add_argument("--remat", action="store_true")
    p.add_argument("--exact-warp-grad", action="store_true")
    p.add_argument("--trace", default=None)
    p.add_argument("--no-cli", action="store_true")
    args = p.parse_args(argv)
    bad = [g for g in args.patch_group if g < 1 or DRAWS % g]
    if bad:
        p.error(f"--patch-group must divide {DRAWS}, got {bad}")
    resolve_device("cuda")
    if any(m < 1 for m in args.ensemble_chunk):
        p.error(f"--ensemble-chunk must be >= 1, got {args.ensemble_chunk}")
    combos = [(dt, aug, g, m) for dt in args.dtype
              for aug in args.spatial_aug for g in args.patch_group
              for m in args.ensemble_chunk]
    summaries = []
    for dt, aug, g, m in combos:
        trace = args.trace
        if trace and len(combos) > 1:   # one file per combination
            trace = str(Path(trace).with_suffix(
                f".{dt}_{aug}_g{g}_m{m}.json"))
        try:
            summaries.append(profile_steps(dt, trace, args.pretrained, aug,
                                           args.exact_warp_grad, g,
                                           args.remat, m))
        except torch.cuda.OutOfMemoryError as e:
            # a combination that does not fit the card is a result too
            print(f"profile: {dt} patch_group {g} ensemble_chunk {m} does "
                  f"not fit the card: {str(e).splitlines()[0]}")
            summaries.append({"dtype": dt, "spatial_aug": aug,
                              "patch_group": g, "ensemble_chunk": m,
                              "out_of_memory": True})
            torch.cuda.empty_cache()
            continue
        torch.cuda.empty_cache()
        if not args.no_cli:
            run_default_plan(dt, args.pretrained, aug, args.exact_warp_grad,
                             g, args.remat, m)
    for s in summaries:
        print("summary: " + json.dumps(s))


if __name__ == "__main__":
    main()
