"""A self-checking dry run of every sharded path (the port of
`__graft_entry__.dryrun_multichip`):

    python3 -m dg_tta_tpu_torch.parallel.dryrun --ranks N
        [--backend nccl|gloo] [--device cuda|cpu] [--full-width]

Each check runs a sharded path over N ranks (`parallel/mesh.launch`) and
its one-rank run on the same weights, data and draws, prints both and the
measured differences, and raises on a mismatch:

1. members: `tta.engine.tta_one_volume(ensemble_chunk=E)` with E members
   over N devices against the same call on one (its members one after
   another here); E = N, and at full width also the default plan's 3;
2. streams: `parallel/tta.sharded_stream_run` over N streams, each a
   member on its own volume, against each stream's `member_run` here;
3. windows: `predict_volume(group=...)` against the unsharded call in
   rank 0, and the all-reduce of an accumulator of the full volume's
   shape timed;
4. data-parallel pretraining: one step of a global batch of N x B/N over
   the ranks (`train/pretrain.make_train_step(group=...)`) against the
   one-process step on the whole batch here, the replicas held equal;
   then, at full width, the steps timed;
5. run_tta, at full width only: the CLI's `run_tta` on a synthetic
   workspace, N members over N ranks (`engine.adapt_sharded`, as users
   run it: each rank loads the checkpoint and the volume and writes its
   members' files) against `--num_devices 1`, the smoke plan (2 x 4).

Small (default): the tiny U-Net (`SMALL_SPEC`, patch 16^3) on a 24 x 28 x
20 volume and a batch of 2 a rank; `--full-width`: the TS104 nets (105
classes, patch 112 x 112 x 128) on a 224 x 224 x 256 synthetic CT, the
default plan (12 epochs x 16 patches) for check 1, the smoke plan (2 x 4)
for check 2, 3 members for check 3, batch 1 a rank for check 4.
Tolerances: on the CPU the ranks and this process run the same ops on one
thread each, so the runs agree to rounding (members and streams 1e-5
relative, 1e-6 absolute; windows 1e-4 / 1e-5; the step's loss 1e-5 /
1e-6 and parameters 1e-4 / 1e-6, the JAX package's own DP test).  On the
card the same, except: members and streams hold the epoch-0 losses (a
warm-up epoch) to 1e-4 and the later ones to 1e-2, each parameter's
update to 0.3 of its norm (AdamW steps ~lr x sign(gradient), so a
gradient summed in another order flips the entries near zero, as
`chip_smoke.py`'s card-vs-CPU check holds them), and run_tta's
segmentations may differ in 1e-3 of the voxels; the step's loss, its
update of all parameters together to 1e-3 of its norm, and each
parameter's own update to 5e-2 of its norm, but those whose update is
zero to rounding (`update_errors`: on an H100 the step's per-parameter
differences reach 1.5e-2 of their update where the whole's is 5.7e-4,
PERF.md §6).  The
checks run in the order 3, 4, 2, 1, 5.  Prints
one line per check and, last, a JSON object of the numbers.

The workers (`stream_rank`, `predict_rank`, `dp_step_rank`) are this
module's functions so that spawned ranks import them from the package;
`tests/test_torch_parallel.py` runs them too.
"""

import argparse
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from dg_tta_tpu_torch.parallel.mesh import (all_reduce_pieces,
                                            broadcast_state, default_backend,
                                            launch)
from dg_tta_tpu_torch.parallel.tta import Stream, sharded_stream_run

SMALL_SPEC = dict(features_per_stage=(8, 16, 16),
                  kernel_sizes=((3, 3, 3),) * 3,
                  strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
                  n_conv_per_stage_encoder=(1, 1, 1),
                  n_conv_per_stage_decoder=(1, 1), num_input_channels=1,
                  num_classes=4)
SMALL_PATCH = (16, 16, 16)
SMALL_VOLUME = (24, 28, 20)
FULL_VOLUME = (224, 224, 256)
N_OPT = 4                      # optimized labels: background + 3 organs

CPU_TOL = dict(member_rtol=1e-5, member_atol=1e-6, dice_atol=1e-6,
               loss0_rtol=1e-5,
               update_rtol=None, window_rtol=1e-4, window_atol=1e-5,
               step_rtol=1e-5, step_atol=1e-6, param_rtol=1e-4,
               param_atol=1e-6, step_update_rtol=None,
               step_leaf_rtol=None)
CARD_TOL = dict(member_rtol=1e-2, member_atol=0.0, dice_atol=2e-2,
                loss0_rtol=1e-4, seg_differ=1e-3,
                update_rtol=0.3, window_rtol=1e-4, window_atol=1e-5,
                step_rtol=1e-3, step_atol=0.0, param_rtol=None,
                param_atol=None, step_update_rtol=1e-3,
                step_leaf_rtol=5e-2)


def log(*a):
    print(*a, flush=True)


def small_model(trainer="nnUNetTrainer_GIN"):
    """The dry run's tiny model of `trainer` (12 input channels for a MIND
    family)."""
    from dg_tta_tpu_torch.models.network import TRAINER_REGISTRY, Model
    from dg_tta_tpu_torch.models.plans import ArchSpec

    gin, mind = TRAINER_REGISTRY[trainer]
    spec = dict(SMALL_SPEC, num_input_channels=12 if mind else 1)
    return Model(spec=ArchSpec(**spec), patch_size=SMALL_PATCH,
                 trainer_name=trainer, uses_gin_internal=gin,
                 uses_mind=mind)


def seeded_state(model, seed: int) -> dict:
    return model.init_params(torch.Generator().manual_seed(seed))


def synthetic_volume(seed: int, shape, full: bool):
    """(1, D, H, W, 1) f32 volume and labels (< N_OPT): at full width the
    synthetic CT (`obs/synthetic.synthetic_ct`) scaled to unit spread,
    else noise with two bright blocks."""
    rng = np.random.default_rng(seed)
    if full:
        from dg_tta_tpu_torch.obs.synthetic import synthetic_ct
        vol, seg = synthetic_ct(rng, shape)
        vol = vol.astype(np.float32)
        vol = (vol - vol.mean()) / vol.std()
        lab = seg.astype(np.float32)
    else:
        vol = rng.normal(size=shape).astype(np.float32) * 0.1
        lab = np.zeros(shape, np.float32)
        d, h, w = shape
        vol[d // 4:d // 2, h // 4:h // 2, w // 4:w // 2] += 2.0
        lab[d // 4:d // 2, h // 4:h // 2, w // 4:w // 2] = 1.0
        lab[d // 2:d // 2 + 4, h // 2:h // 2 + 5, w // 3:w // 2] = 2.0
    return (torch.from_numpy(vol[None, ..., None]),
            torch.from_numpy(lab[None, ..., None]))


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def leaf_update_rel(got: dict, ref: dict, init: dict) -> float:
    """The largest relative difference of two updates (final - initial)
    over the parameters: |du - dr| / |dr|, where dr is nonzero."""
    worst = 0.0
    for k, r in ref.items():
        dr = (r.double() - init[k].double().to(r.device))
        du = got[k].double().to(r.device) - init[k].double().to(r.device)
        n = float(dr.norm())
        if n > 0:
            worst = max(worst, float((du - dr).norm()) / n)
    return worst


# A parameter whose reference update has an RMS below this share of the
# whole update's RMS is zero to rounding: in exact arithmetic its gradient
# cancels (a conv bias before an instance norm; exactly 0 on the CPU and
# on an H100), so its relative difference reads rounding alone.  The rule
# reads the reference's update (an SGD step: its gradient, scaled), never
# a parameter's name.
ZERO_UPDATE_SHARE = 1e-3


def update_errors(got: dict, ref: dict, init: dict) -> dict:
    """`got`'s update (final - initial) against `ref`'s: "whole": |du -
    dr| / |dr| of every parameter flattened into one vector (as
    `chip_smoke.py` holds a card's SGD update to the CPU's); "leaves":
    {name: (|du_k - dr_k| / |dr_k|, share)}, share = rms(dr_k) / rms(dr);
    "held": the parameters whose share is at least ZERO_UPDATE_SHARE;
    "worst": the largest relative difference of a held parameter, which
    sees a fault confined to a small parameter (a norm scale, the MIND
    stem) that "whole", ruled by the large conv weights, cannot."""
    du = {k: got[k].double().cpu() - init[k].double().cpu() for k in init}
    dr = {k: ref[k].double().cpu() - init[k].double().cpu() for k in init}
    flat_u = torch.cat([du[k].flatten() for k in sorted(init)])
    flat_r = torch.cat([dr[k].flatten() for k in sorted(init)])
    rms = float(flat_r.norm()) / flat_r.numel() ** 0.5
    leaves = {}
    for k in sorted(init):
        n, diff = float(dr[k].norm()), float((du[k] - dr[k]).norm())
        leaves[k] = (diff / n if n > 0 else (0.0 if diff == 0
                                             else float("inf")),
                     n / max(dr[k].numel(), 1) ** 0.5 / rms)
    held = [k for k, (_, share) in leaves.items()
            if share >= ZERO_UPDATE_SHARE]
    return dict(whole=float((flat_u - flat_r).norm() / flat_r.norm()),
                leaves=leaves, held=held,
                worst=max((leaves[k][0] for k in held), default=0.0))


def update_report(e: dict, n: int = 3) -> str:
    """The whole update's error, the `n` worst held parameters and the
    number left out, each with its relative difference and share."""
    worst = sorted(e["held"], key=lambda k: -e["leaves"][k][0])[:n]
    out = len(e["leaves"]) - len(e["held"])
    return (f"whole update rel {e['whole']:.3e}; worst of "
            f"{len(e['held'])} parameters held: "
            + ", ".join(f"{k} {e['leaves'][k][0]:.3e} (share "
                        f"{e['leaves'][k][1]:.2e})" for k in worst)
            + f"; {out} zero to rounding (share < {ZERO_UPDATE_SHARE:g}) "
            f"left out")


def _check_close(what, got, ref, rtol, atol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not np.allclose(got, ref, rtol=rtol, atol=atol, equal_nan=True):
        raise AssertionError(f"{what}: {got.tolist()} vs {ref.tolist()} "
                             f"(rtol {rtol}, atol {atol})")


# ------------------------------------------------------------ workers


@dataclasses.dataclass(frozen=True)
class StreamJob:
    model: Any
    plan: Any
    state: dict
    streams: list
    map_idx: np.ndarray


def stream_rank(rank, ranks, device, job: StreamJob):
    """A rank of check 2: its block of `job.streams`."""
    from dg_tta_tpu_torch.tta.engine import make_tta_functions

    fns = make_tta_functions(job.model, job.plan, job.map_idx, job.map_idx)
    net0 = job.model.build_network(job.state, device)
    return sharded_stream_run(fns, net0, job.streams, device)


@dataclasses.dataclass(frozen=True)
class PredictJob:
    model: Any
    states: list
    vol: torch.Tensor           # (D, H, W, C) on the CPU
    draws: Any = None
    bucket_multiple: int = 32
    return_output: bool = True
    time_all_reduce: bool = False


def predict_rank(rank, ranks, device, job: PredictJob):
    """A rank of check 3: the window-sharded `predict_volume`; rank 0 then
    runs the unsharded call and returns {"max_abs_err", "ref_max_abs",
    "close", "output" (the sharded logits on the CPU, with
    `return_output`), "sharded_s", "serial_s", "all_reduce_ms" (with
    `time_all_reduce`: an all-reduce of an f32 accumulator of the padded
    volume's shape, as `predict_volume` sums it)}."""
    from dg_tta_tpu_torch.infer.sliding_window import (padded_shape,
                                                       predict_volume)

    nets = [job.model.build_network(s, device) for s in job.states]
    vol = job.vol.to(device)
    kw = dict(draws=job.draws, bucket_multiple=job.bucket_multiple)
    _sync(device)
    t0 = time.perf_counter()
    got = predict_volume(job.model, nets, vol, group=dist.group.WORLD, **kw)
    _sync(device)
    sharded_s = time.perf_counter() - t0
    all_reduce_ms = None
    if job.time_all_reduce:
        shape = (*padded_shape(vol.shape[:3], job.model.patch_size,
                               job.bucket_multiple),
                 job.model.spec.num_classes)
        acc = torch.ones(shape, device=device)
        all_reduce_pieces(acc)         # warm-up
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        all_reduce_pieces(acc)
        _sync(device)
        all_reduce_ms = 1e3 * (time.perf_counter() - t0)
        del acc
    if rank != 0:
        return None
    t0 = time.perf_counter()
    ref = predict_volume(job.model, nets, vol, **kw)
    _sync(device)
    serial_s = time.perf_counter() - t0
    err = float((got - ref).abs().max())
    ref_max = float(ref.abs().max())
    close = bool(torch.allclose(got, ref, rtol=job_tol(device)["window_rtol"],
                                atol=job_tol(device)["window_atol"]))
    return dict(max_abs_err=err, ref_max_abs=ref_max, close=close,
                output=got.cpu() if job.return_output else None,
                sharded_s=sharded_s, serial_s=serial_s,
                all_reduce_ms=all_reduce_ms)


def job_tol(device) -> dict:
    return CPU_TOL if torch.device(device).type == "cpu" else CARD_TOL


@dataclasses.dataclass(frozen=True)
class StepJob:
    model: Any
    state: dict
    imgs: np.ndarray            # (B, D, H, W, C), the global batch
    segs: np.ndarray            # (B, D, H, W, 1)
    draws: list                 # a `StepDraws` of the global batch a step
    lrs: list
    da_cfg: Any
    local_dice: bool = False
    timed_steps: int = 0


def dp_step_rank(rank, ranks, device, job: StepJob):
    """A rank of check 4: `len(job.draws)` data-parallel steps on its rows
    of the global batch and of each step's draws, then `timed_steps` more
    on the last draws, timed.  Every rank returns (losses, state_dict on
    the CPU, ms per timed step).  `local_dice`: the batch Dice of each
    rank's rows alone (the cross-rank sum left out: a wrong step, which
    the comparison must catch)."""
    from dg_tta_tpu_torch.train import pretrain
    from dg_tta_tpu_torch.train.losses import deep_supervised_loss

    group = dist.group.WORLD
    b = job.imgs.shape[0] // ranks
    lo, hi = rank * b, (rank + 1) * b
    net = job.model.build_network(job.state, device)
    broadcast_state(net, 0, group)
    opt = pretrain.make_optimizer(net)
    step = pretrain.make_train_step(job.model, job.da_cfg, group=group)
    imgs = torch.from_numpy(np.ascontiguousarray(job.imgs[lo:hi])).to(device)
    segs = torch.from_numpy(np.ascontiguousarray(job.segs[lo:hi])).to(device)
    if job.local_dice:
        pretrain.deep_supervised_loss = functools.partial(
            _local_dice_loss, deep_supervised_loss)
    try:
        losses = [float(step(net, opt, imgs, segs, d.rows(lo, hi), lr))
                  for d, lr in zip(job.draws, job.lrs)]
    finally:
        pretrain.deep_supervised_loss = deep_supervised_loss
    state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    ms = None
    if job.timed_steps:
        d = job.draws[-1].rows(lo, hi)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(job.timed_steps):
            step(net, opt, imgs, segs, d, job.lrs[-1])
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0) / job.timed_steps
    return losses, state, ms


def all_reduce_rank(rank, ranks, device, numel: int):
    """One all-reduce of `numel` ones after a warm-up: (every entry equals
    the number of ranks, its ms)."""
    x = torch.ones(numel, device=device)
    dist.all_reduce(x.clone())
    _sync(device)
    t0 = time.perf_counter()
    dist.all_reduce(x)
    _sync(device)
    return bool((x == ranks).all()), 1e3 * (time.perf_counter() - t0)


def jobs_rank(rank, ranks, device, jobs):
    """Several of the workers above in one launch: `jobs` [(worker, job)]
    run in order; returns their results."""
    return [worker(rank, ranks, device, job) for worker, job in jobs]


def _local_dice_loss(loss_fn, outputs, target, batch_dice=True, group=None):
    return loss_fn(outputs, target, batch_dice=batch_dice)


def one_process_steps(job: StepJob, device):
    """Check 4's one-process run: the same steps on the whole batch;
    returns (losses, state_dict)."""
    from dg_tta_tpu_torch.train import pretrain

    net = job.model.build_network(job.state, device)
    opt = pretrain.make_optimizer(net)
    step = pretrain.make_train_step(job.model, job.da_cfg)
    imgs = torch.from_numpy(job.imgs).to(device)
    segs = torch.from_numpy(job.segs).to(device)
    losses = [float(step(net, opt, imgs, segs, d, lr))
              for d, lr in zip(job.draws, job.lrs)]
    return losses, {k: v.detach() for k, v in net.state_dict().items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------- checks


def check_members(args, out, full, device, tol):
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import tta_one_volume
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    model = (ts104_model() if full else small_model())
    sizes = sorted({min(3, args.ranks), args.ranks}) if full else \
        [args.ranks]
    plan = (TTAPlan(ensemble_count=max(sizes)) if full else
            TTAPlan(epochs=3, patches_to_be_accumulated=2, lr=1e-3,
                    ensemble_count=max(sizes), start_tta_at_epoch=1))
    vols, labs = synthetic_volume(0, FULL_VOLUME if full else SMALL_VOLUME,
                                  full)
    vols, labs = vols.to(device), labs.to(device)
    shapes = [[float(s) for s in vols.shape[1:4]]]
    idx = np.arange(N_OPT)
    net0 = model.build_network(seeded_state(model, 0), device)
    init = {k: v.clone() for k, v in net0.state_dict().items()}
    draws = TorchDraws(seed=0)
    kw = dict(labels_padded=labs)
    serial, serial_s = [], []
    for m in range(max(sizes)):
        _sync(device)
        t0 = time.perf_counter()
        serial.append(tta_one_volume(model, plan, net0, vols, shapes, idx,
                                     idx, draws, member_indices=[m],
                                     num_devices=1, **kw))
        _sync(device)
        serial_s.append(time.perf_counter() - t0)
    for e in sizes:
        stats = tempfile.mkdtemp(prefix="dgtta_dryrun_stats_")
        os.environ["DGTTA_RANK_STATS_DIR"] = stats
        try:
            t0 = time.perf_counter()
            nets, losses, dices = tta_one_volume(
                model, plan, net0, vols, shapes, idx, idx, draws,
                member_indices=list(range(e)), ensemble_chunk=e,
                num_devices=args.ranks, backend=args.backend, **kw)
            sharded_s = time.perf_counter() - t0
        finally:
            del os.environ["DGTTA_RANK_STATS_DIR"]
        ranks = [json.loads(p.read_text())
                 for p in sorted(Path(stats).glob("rank*.json"))]
        ref_l = np.concatenate([s[1] for s in serial[:e]], axis=1)
        ref_d = np.concatenate([s[2] for s in serial[:e]], axis=1)
        loss0 = _rel(losses[0], ref_l[0])
        upd = max(leaf_update_rel(n.state_dict(), s[0][0].state_dict(), init)
                  for n, s in zip(nets, serial))
        bit = all(torch.equal(a, b) for n, s in zip(nets, serial)
                  for a, b in zip(n.state_dict().values(),
                                  s[0][0].state_dict().values()))
        res = dict(members=e, ranks=len(ranks), serial_s=sum(serial_s[:e]),
                   sharded_s=sharded_s,
                   rank_s=[r["seconds"] for r in ranks],
                   rank_peak_gib=[(r["peak_bytes"] or 0) / 2 ** 30
                                  for r in ranks],
                   epoch0_loss_rel=loss0, loss_rel=_rel(losses, ref_l),
                   dice_abs=float(np.nanmax(np.abs(dices - ref_d))),
                   update_rel=upd, bit_equal=bit)
        log(f"members: {e} members over {len(ranks)} ranks "
            f"({args.backend}): tta_one_volume {sharded_s:.2f} s (ranks "
            f"{[round(s, 2) for s in res['rank_s']]} s, peak "
            f"{[round(g, 2) for g in res['rank_peak_gib']]} GiB) against "
            f"{res['serial_s']:.2f} s one after another; losses rel "
            f"{res['loss_rel']:.3e} (epoch 0 {loss0:.3e}), Dices abs "
            f"{res['dice_abs']:.3e}, updates rel {upd:.3e}, bit equal {bit}")
        _check_close("epoch-0 member losses", losses[0], ref_l[0],
                     tol["loss0_rtol"], 0.0)
        _check_close("member losses", losses, ref_l, tol["member_rtol"],
                     tol["member_atol"])
        _check_close("member Dices", dices, ref_d, 0.0, tol["dice_atol"])
        if tol["update_rtol"] is not None:
            if not upd <= tol["update_rtol"]:
                raise AssertionError(f"member updates rel {upd}")
        else:
            for n, s in zip(nets, serial):
                for (k, a), b in zip(n.state_dict().items(),
                                     s[0][0].state_dict().values()):
                    _check_close(f"member parameter {k}", a.cpu(), b.cpu(),
                                 tol["member_rtol"], tol["member_atol"])
        out[f"members_{e}"] = res


def check_streams(args, out, full, device, tol):
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import make_tta_functions
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    model = ts104_model() if full else small_model()
    plan = TTAPlan(epochs=2, patches_to_be_accumulated=4 if full else 1,
                   lr=1e-3, ensemble_count=1, start_tta_at_epoch=1)
    idx = np.arange(N_OPT)
    state = seeded_state(model, 1)
    streams = []
    for s in range(args.ranks):
        vols, labs = synthetic_volume(10 + s, FULL_VOLUME if full
                                      else SMALL_VOLUME, full)
        streams.append(Stream(TorchDraws(seed=0, sample_index=s), 0, vols,
                              [[float(v) for v in vols.shape[1:4]]], labs))
    t0 = time.perf_counter()
    got = launch(stream_rank, args.ranks, device.type, args.backend,
                 args=(StreamJob(model, plan, state, streams, idx),))[0]
    sharded_s = time.perf_counter() - t0
    fns = make_tta_functions(model, plan, idx, idx)
    net0 = model.build_network(state, device)
    t0 = time.perf_counter()
    ref = [fns.member_run(net0, s.draw_source, s.member, s.vols.to(device),
                          s.shapes, s.labels.to(device)) for s in streams]
    _sync(device)
    serial_s = time.perf_counter() - t0
    losses = np.stack([g[2] for g in got])
    ref_l = np.stack([r[1] for r in ref])
    init = {k: v.to(device) for k, v in state.items()}
    upd = max(leaf_update_rel(g[1], r[0].state_dict(), init)
              for g, r in zip(got, ref))
    log(f"streams: {len(streams)} streams over {args.ranks} ranks: "
        f"{sharded_s:.2f} s against {serial_s:.2f} s one after another; "
        f"losses {losses[:, -1].tolist()}, rel {_rel(losses, ref_l):.3e} "
        f"(epoch 0 {_rel(losses[:, 0], ref_l[:, 0]):.3e}), updates rel "
        f"{upd:.3e}")
    _check_close("epoch-0 stream losses", losses[:, 0], ref_l[:, 0],
                 tol["loss0_rtol"], 0.0)
    _check_close("stream losses", losses, ref_l, tol["member_rtol"],
                 tol["member_atol"])
    if len(set(np.round(losses[:, 0], 8).tolist())) < 2:
        raise AssertionError(f"streams on distinct volumes gave one loss "
                             f"{losses[:, 0]}")
    if tol["update_rtol"] is not None and not upd <= tol["update_rtol"]:
        raise AssertionError(f"stream updates rel {upd}")
    out["streams"] = dict(streams=len(streams), sharded_s=sharded_s,
                          serial_s=serial_s, loss_rel=_rel(losses, ref_l),
                          update_rel=upd)


def check_windows(args, out, full, device, tol):
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model

    model = ts104_model() if full else small_model()
    states = [seeded_state(model, 20 + m) for m in range(3 if full else 2)]
    vol, _ = synthetic_volume(3, FULL_VOLUME if full else SMALL_VOLUME,
                              full)
    job = PredictJob(model, states, vol[0], bucket_multiple=32 if full else 4,
                     return_output=False, time_all_reduce=full)
    res = launch(predict_rank, args.ranks, device.type, args.backend,
                 args=(job,))[0]
    log(f"windows: predict_volume over {args.ranks} ranks "
        f"{res['sharded_s']:.2f} s against {res['serial_s']:.2f} s "
        f"unsharded; max abs err {res['max_abs_err']:.3e} of "
        f"{res['ref_max_abs']:.3e}; all-reduce of the accumulator "
        f"{res['all_reduce_ms']} ms")
    if not res["close"]:
        raise AssertionError(f"window-sharded predict_volume: {res}")
    out["windows"] = {k: v for k, v in res.items() if k != "output"}


def step_job(model, batch, steps, seed, full, timed_steps=0):
    """A `StepJob` of `steps` steps on a seeded global batch of `batch`
    patches of `model`, every augmentation gate on."""
    from dg_tta_tpu_torch.train.augment import DAConfig
    from dg_tta_tpu_torch.train.pretrain import PretrainDraws

    cfg = DAConfig(p_rotation=1.0, p_scale=1.0, p_noise=1.0, p_blur=1.0,
                   p_lowres=1.0)
    rng = np.random.default_rng(seed)
    shape = (batch, *model.patch_size, 1)
    imgs = rng.normal(size=shape).astype(np.float32)
    n_cls = model.spec.num_classes if not full else 4
    segs = rng.integers(-1, n_cls, size=shape).astype(np.float32)
    draws = [PretrainDraws(seed).step(0, it, batch, cfg,
                                      gin=model.uses_gin_internal)
             for it in range(steps)]
    return StepJob(model, seeded_state(model, seed), imgs, segs, draws,
                   [1e-2, 8e-3][:steps], cfg, timed_steps=timed_steps)


def check_step(args, out, full, device, tol):
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model

    trainer = "nnUNetTrainer_GIN_MIND"
    model = (ts104_model(trainer=trainer) if full
             else small_model(trainer))
    per_rank = 1 if full else 2
    job = step_job(model, per_rank * args.ranks, 1, 5, full,
                   timed_steps=4 if full else 0)
    _sync(device)
    t0 = time.perf_counter()
    ref_losses, ref = one_process_steps(job, device)
    _sync(device)
    one_ms = 1e3 * (time.perf_counter() - t0)
    init = {k: v.to(device) for k, v in job.state.items()}
    ref = {k: v for k, v in ref.items()}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = launch(dp_step_rank, args.ranks, device.type, args.backend,
                 args=(job,))
    losses, state, ms = got[0]
    replicas = all(torch.equal(a, b) for g in got[1:]
                   for a, b in zip(g[1].values(), state.values()))
    loss_rel = _rel(losses, ref_losses)
    e = update_errors(state, ref, init)
    log(f"data-parallel step: {trainer}, batch {per_rank} x {args.ranks} "
        f"ranks: loss {losses} against {ref_losses} one process (rel "
        f"{loss_rel:.3e}), replicas equal {replicas}; {update_report(e)}"
        f"; {ms} ms a step over the ranks, one process's first step "
        f"{one_ms:.1f} ms (its build included)")
    if not replicas:
        raise AssertionError("data-parallel replicas differ after the step")
    _check_close("data-parallel loss", losses, ref_losses, tol["step_rtol"],
                 tol["step_atol"])
    if tol["step_update_rtol"] is not None:
        if not (e["whole"] <= tol["step_update_rtol"]
                and e["worst"] <= tol["step_leaf_rtol"]):
            raise AssertionError(f"data-parallel update: {update_report(e)}")
    else:
        for k, r in ref.items():
            _check_close(f"data-parallel parameter {k}", state[k],
                         r.cpu(), tol["param_rtol"], tol["param_atol"])
    out["dp_step"] = dict(trainer=trainer, batch_per_rank=per_rank,
                          loss_rel=loss_rel, update_rel=e["whole"],
                          worst_leaf_rel=e["worst"],
                          ms_per_step=ms, replicas_equal=replicas)


def check_run_tta(args, out, full, device, tol):
    """`run_tta` through the CLI, as a user runs it, on the synthetic
    workspace (`obs/synthetic.make_workspace`, the TS104_GIN checkpoint
    and a 224 x 224 x 256 CT), the smoke plan with one member a rank:
    Phase 1 over the ranks against `--num_devices 1`."""
    from dg_tta_tpu_torch.cli.main import main as cli
    from dg_tta_tpu_torch.data.io import read_image
    from dg_tta_tpu_torch.models.convert import load_flat_npz
    from dg_tta_tpu_torch.obs.synthetic import edit_plan, make_workspace
    from dg_tta_tpu_torch.tta.config import get_parameters_save_path

    work = Path(tempfile.mkdtemp(prefix="dgtta_dryrun_run_tta_"))
    ws = make_workspace(work, seed=0, shape=FULL_VOLUME)
    cli(["prepare_tta", "TS104_GIN", ws.dataset_id])
    results_dir, plan = edit_plan("TS104_GIN", epochs=2,
                                  patches_to_be_accumulated=4,
                                  start_tta_at_epoch=1,
                                  ensemble_count=args.ranks)
    runs = {}
    for n in (args.ranks, 1):
        before = set(results_dir.iterdir()) if results_dir.is_dir() \
            else set()
        t0 = time.perf_counter()
        cli(["run_tta", "TS104_GIN", ws.dataset_id, "--num_devices",
             str(n), "--backend", args.backend])
        wall = time.perf_counter() - t0
        (run_dir,) = set(results_dir.iterdir()) - before
        timings = json.loads((run_dir / "timings.json").read_text())
        if timings["ranks"] != n:
            raise AssertionError(f"run_tta --num_devices {n}: timings "
                                 f"{timings}")
        runs[n] = dict(dir=run_dir, wall_s=wall, adaptation_s=timings[
            "phases"]["adaptation"]["total_s"])
    init = load_flat_npz(ws.checkpoint)
    losses, upd = [], 0.0
    for m in range(args.ranks):
        path = {n: get_parameters_save_path(r["dir"] / "tta_outputTs",
                                            "case", m)
                for n, r in runs.items()}
        res = {n: json.loads((p.parent / f"case__ensemble_idx_{m}"
                              "_tta_results.json").read_text())["losses"]
               for n, p in path.items()}
        losses.append((res[args.ranks], res[1]))
        got, ref = (load_flat_npz(path[n]) for n in (args.ranks, 1))
        upd = max(upd, leaf_update_rel(got, ref, init))
    got_l = np.asarray([g for g, _ in losses])
    ref_l = np.asarray([r for _, r in losses])
    segs = [read_image(runs[n]["dir"] / "tta_outputTs" / "case.nii.gz")[0]
            for n in (args.ranks, 1)]
    differ = float(np.mean(segs[0] != segs[1]))
    log(f"run_tta: {args.ranks} members over {args.ranks} ranks "
        f"({args.backend}): adaptation {runs[args.ranks]['adaptation_s']:.2f}"
        f" s, run_tta {runs[args.ranks]['wall_s']:.2f} s, against "
        f"{runs[1]['adaptation_s']:.2f} s and {runs[1]['wall_s']:.2f} s in "
        f"one process; member losses rel {_rel(got_l, ref_l):.3e} (epoch 0 "
        f"{_rel(got_l[:, 0], ref_l[:, 0]):.3e}), updates rel {upd:.3e}, "
        f"segmentation voxels that differ {differ:.3e}")
    _check_close("run_tta epoch-0 member losses", got_l[:, 0], ref_l[:, 0],
                 tol["loss0_rtol"], 0.0)
    _check_close("run_tta member losses", got_l, ref_l, tol["member_rtol"],
                 tol["member_atol"])
    if not upd <= tol["update_rtol"]:
        raise AssertionError(f"run_tta member updates rel {upd}")
    if not differ <= tol["seg_differ"]:
        raise AssertionError(f"run_tta segmentations differ in {differ} of "
                             f"the voxels")
    out["run_tta"] = dict(members=args.ranks,
                          adaptation_s=runs[args.ranks]["adaptation_s"],
                          wall_s=runs[args.ranks]["wall_s"],
                          one_process_adaptation_s=runs[1]["adaptation_s"],
                          one_process_wall_s=runs[1]["wall_s"],
                          loss_rel=_rel(got_l, ref_l), update_rel=upd,
                          seg_differ=differ)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--full-width", action="store_true")
    args = p.parse_args(argv)
    from dg_tta_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    args.backend = args.backend or default_backend(device.type)
    full = args.full_width
    if full and device.type != "cuda":
        raise SystemExit("--full-width runs on the card only")
    if device.type == "cpu":
        torch.set_num_threads(1)
    tol = job_tol(device)
    out = {"ranks": args.ranks, "backend": args.backend,
           "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                      else "cpu"),
           "full_width": full}
    log(f"dryrun: {args.ranks} ranks, {args.backend}, {out['device']}, "
        f"{'full width' if full else 'small'}")
    t0 = time.perf_counter()
    # the short checks first: a collective that fails, fails early
    checks = [check_windows, check_step, check_streams, check_members]
    for check in checks + ([check_run_tta] if full else []):
        t1 = time.perf_counter()
        check(args, out, full, device, tol)
        log(f"  ({check.__name__}: {time.perf_counter() - t1:.1f} s)")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"dryrun OK: {args.ranks} ranks, {out['seconds']:.1f} s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
