"""Where the time of DG pretraining goes on the GPU, and one epoch of it.

    python -m dg_tta_tpu_torch.obs.profile_pretrain
        [--trainer nnUNetTrainer_GIN_MIND nnUNetTrainer_GIN ...]
        [--steps 4] [--iters 250] [--val-iters 50] [--trace trace.json]

On `obs/synthetic.make_pretrain_dataset`'s three 128 x 128 x 144 CTs at
1.5 mm, with the full-width TS104 plans (`resources.TS104_3D_FULLRES`: 105
classes, patch 112 x 112 x 128, batch 2), in f32, for each trainer:

1. Profile: the trainer's network (seeded weights) trains `--steps`
   iterations (`train/pretrain.make_train_step`: the augmentation, GIN and
   MIND as the trainer has them, the deep-supervised loss, the SGD step)
   once to warm up, then again under `torch.profiler`: prints the wall
   time per step, the device time summed per kernel name (top 15), the
   device's idle share (one minus the summed device time over the wall
   time; one stream, so device intervals do not overlap), the device
   kernels per step by name (every kernel the profiler saw, library ones
   included), the launches of the port's kernels and the peak device
   memory.
2. Epoch: `run_pretraining` for one epoch of `--iters` iterations and
   `--val-iters` validation batches (nnUNet's 250 and 50), measured end to
   end: prints the epoch's seconds, its training part and the peak device
   memory.
"""

import argparse
import json
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

STEPS = 4
TRAINERS = ("nnUNetTrainer_GIN_MIND", "nnUNetTrainer_GIN")


def profile_steps(plans, trainer, steps=STEPS, trace=None, seed=0):
    """Profile `steps` training iterations of `trainer` on the prepared
    dataset (`make_pretrain_dataset` and `_ensure_preprocessed` done);
    prints and returns {"ms_per_step", "busy_ms", "idle_share",
    "kernels_per_step", "peak_gib", "launches", "loss"}."""
    import numpy as np

    from dg_tta_tpu_torch.models.network import MULTIRES_TRAINERS, build_model
    from dg_tta_tpu_torch.obs.profile_adaptation import _counters
    from dg_tta_tpu_torch.obs.profile_inference import seeded_net
    from dg_tta_tpu_torch.obs.synthetic import PRETRAIN_DATASET_ID
    from dg_tta_tpu_torch.train.augment import MULTIRES_ZOOMS, DAConfig
    from dg_tta_tpu_torch.train.dataset import PatchSampler
    from dg_tta_tpu_torch.train.pretrain import (PretrainDraws,
                                                 _ensure_preprocessed,
                                                 make_optimizer,
                                                 make_train_step,
                                                 preprocessed_dir)
    from dg_tta_tpu_torch.utils.paths import maybe_convert_to_dataset_name

    device = torch.device("cuda")
    name = maybe_convert_to_dataset_name(PRETRAIN_DATASET_ID)
    dataset_json, plans, store, splits = _ensure_preprocessed(
        name, plans, preprocessed_dir(name))
    cfg = plans["configurations"]["3d_fullres"]
    model = build_model(plans, dataset_json, trainer)
    da_cfg = DAConfig(discrete_lowres_zooms=(
        MULTIRES_ZOOMS if trainer in MULTIRES_TRAINERS else None))
    net = seeded_net(model, seed, device)
    opt = make_optimizer(net)
    step = make_train_step(model, da_cfg)
    sampler = PatchSampler(store, splits[0]["train"], cfg["patch_size"],
                           seed=seed)
    draws = PretrainDraws(seed)
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                     .to(device) for a in sampler.batch(cfg["batch_size"]))
               for _ in range(steps)]

    def run(epoch):
        loss = None
        for it, (imgs, segs) in enumerate(batches):
            d = draws.step(epoch, it, imgs.shape[0], da_cfg,
                           gin=model.uses_gin_internal)
            loss = step(net, opt, imgs, segs, d, 1e-2)
        return loss

    run(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    before = {k: c.launches for k, c in counters.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss = float(run(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_name, counts = defaultdict(float), defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            counts[evt.name] += 1
    busy = sum(per_name.values())
    out = dict(ms_per_step=wall * 1e3 / steps, busy_ms=busy / steps,
               idle_share=1 - busy / (wall * 1e3),
               kernels_per_step=sum(counts.values()) / steps, peak_gib=peak,
               launches={k: c.launches - before[k]
                         for k, c in counters.items()}, loss=loss)
    print(f"profile: device {torch.cuda.get_device_name(0)}; {trainer}; "
          f"float32; {steps} iterations (batch {cfg['batch_size']} x "
          f"{'x'.join(map(str, cfg['patch_size']))}, deep supervision, "
          f"SGD); loss {loss:.5f}")
    print(f"profile: wall {wall * 1e3:.1f} ms = {out['ms_per_step']:.1f} "
          f"ms/step (profiled), device busy {out['busy_ms']:.1f} ms/step, "
          f"idle share {out['idle_share']:.3f}, device kernels per step "
          f"{out['kernels_per_step']:.1f}, peak device memory {peak:.2f} "
          f"GiB, launches {out['launches']}")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{ms / steps:10.3f} ms/step {100 * ms / busy:5.1f}% "
              f"x{counts[name] / steps:<6.1f} {name[:100]}")
    if trace:
        prof.export_chrome_trace(trace)
    return out


def run_epoch(plans, trainer, iters, val_iters, seed=0):
    """One epoch of `run_pretraining` (`iters` iterations, `val_iters`
    validation batches) on the prepared dataset; prints and returns the
    epoch's log entry with the peak device memory."""
    from dg_tta_tpu_torch.obs.synthetic import PRETRAIN_DATASET_ID
    from dg_tta_tpu_torch.train.pretrain import run_pretraining

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_pretraining(PRETRAIN_DATASET_ID, trainer_name=trainer,
                          num_epochs=1, iters_per_epoch=iters,
                          val_iters_per_epoch=val_iters, plans=plans,
                          seed=seed, verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (entry,) = [json.loads(line) for line in
                (out / "training_log.jsonl").read_text().splitlines()]
    entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"epoch: {trainer}, {iters} iterations + {val_iters} validation "
          f"batches: {entry['seconds']:.3f} s (training "
          f"{entry['train_seconds']:.3f} s = "
          f"{1e3 * entry['train_seconds'] / iters:.1f} ms/iteration; "
          f"run_pretraining wall {wall:.3f} s with set-up and checkpoints), "
          f"loss {entry['loss']:.5f}, peak device memory "
          f"{entry['peak_gib']:.2f} GiB")
    return entry


def main(argv=None):
    from dg_tta_tpu_torch.models.network import TRAINER_REGISTRY
    from dg_tta_tpu_torch.obs.synthetic import make_pretrain_dataset
    from dg_tta_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--trainer", nargs="+", default=list(TRAINERS),
                   choices=sorted(TRAINER_REGISTRY))
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--iters", type=int, default=250)
    p.add_argument("--val-iters", type=int, default=50)
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)
    resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="profile_pretrain_") as tmp:
        _, plans = make_pretrain_dataset(Path(tmp))
        for trainer in args.trainer:
            profile_steps(plans, trainer, args.steps, args.trace)
            run_epoch(plans, trainer, args.iters, args.val_iters)


if __name__ == "__main__":
    main()
