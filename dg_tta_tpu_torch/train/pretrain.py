"""DG pretraining: the nnUNet training loop on one GPU or data-parallel on
several (the port of `dg_tta_tpu/train/pretrain.py`, `dgtta pretrain`).

Per iteration (`make_train_step`): the augmentation (`train/augment.py`:
the warp kernel's affine entry for rotation and scale, its grid entry for
the low-resolution simulation), then the trainer's input transforms (GIN
with fresh random nets, MIND with noise on its edge maps), the U-Net with
deep supervision (every stride-1 conv, forward and backward, on the conv
kernels; the stem's input takes no gradient, so no input-gradient conv
runs for it), the deep-supervised Dice + CE (`train/losses.py`; each
head's target resampled on the warp's grid entry), and one SGD step:
momentum 0.99, Nesterov, weight decay 3e-5, the learning rate set per
epoch by `poly_lr`.  That is the JAX package's `add_decayed_weights` ->
`trace(nesterov)` -> `-lr` chain, first step included, once every
parameter has a gradient: parameters the loss never reaches (the conv
biases before InstanceNorm) get a zero one, as JAX's are zero, so weight
decay and momentum run on them too.  250 iterations an epoch, then
`val_iters_per_epoch` validation batches (`make_val_step`): per-class
tp / fp / fn summed over all of them, the global pseudo-Dice, and its 0.9
EMA choosing `checkpoint_best`.

The random draws come from a draw source (`PretrainDraws` by default):
every iteration's draws are a function of (seed, epoch, iteration), and
the patch samplers restart each epoch from (seed, epoch), so a run resumed
with `continue_training` from the end of an epoch follows the
uninterrupted run's trajectory: `training_state.json` holds the epoch,
the EMA state and the seed, `checkpoint_latest_optimizer.npz` the momentum
buffers.  A host thread samples the next batches while the device trains.

Outputs land in the nnUNet results layout
(`nnUNet_results/{dataset}/{trainer}__{plans}__{config}/fold_{f}/`):
`checkpoint_{final,latest,best}.npz` in the JAX package's flat-npz layout
(`models/convert.save_flat_npz`), which `prepare_tta` / `run_tta` of
either package read, `checkpoint_latest_optimizer.npz` (the momentum
buffers in the same layout), `training_log.jsonl`, `training_state.json`,
and beside the fold the plans, dataset and fingerprint JSONs.

With `num_devices` N > 1 (`batch_size % N == 0`, as the JAX package
asserts), N processes train one copy each (`parallel/mesh.launch`: rank r
on cuda:r over NCCL, or the caller's backend), rank 0's parameters
broadcast at the start and after a resume.  Every rank samples the same
global batch and makes the same draws (the same samplers and draw source
from the same seed) and takes its rows r B/N .. (r + 1) B/N - 1 of both
(`StepDraws.rows`), so neither depends on N.  The step's batch Dice and
MIND's clip bound sum over the ranks (`train/losses.py`, `ops/mind.py`),
one all-reduce averages the gradients and the loss after the backward,
and the update then equals the one-process step on the global batch.
Validation splits its batches alike and sums its counts over the ranks
once an epoch.  Rank 0 alone writes the checkpoints, the log and the
state, and the ranks meet at a barrier after each epoch.
"""

import dataclasses
import functools
import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dg_tta_tpu_torch.models.convert import load_flat_npz, save_flat_npz
from dg_tta_tpu_torch.models.network import (MULTIRES_TRAINERS,
                                             TRAINER_REGISTRY, build_model)
from dg_tta_tpu_torch.ops.gin import GinDraws, draw_gin
from dg_tta_tpu_torch.ops.mind import MIND_OUT_CHANNELS
from dg_tta_tpu_torch.parallel.mesh import (broadcast_state, default_backend,
                                            launch)
from dg_tta_tpu_torch.train.augment import (MULTIRES_ZOOMS, DAConfig,
                                            SampleDraws, augment_batch,
                                            draw_sample)
from dg_tta_tpu_torch.train.dataset import (PatchSampler,
                                            fingerprint_dataset, make_splits,
                                            plan_experiment,
                                            preprocess_dataset)
from dg_tta_tpu_torch.train.losses import deep_supervised_loss, poly_lr
from dg_tta_tpu_torch.tta.draws import TorchDraws
from dg_tta_tpu_torch.utils.device import resolve_device
from dg_tta_tpu_torch.utils.paths import (maybe_convert_to_dataset_name,
                                          nnunet_raw, nnunet_results)

ITERS_PER_EPOCH = 250
VAL_ITERS_PER_EPOCH = 50  # nnUNet's num_val_iterations_per_epoch
INITIAL_LR = 1e-2
WEIGHT_DECAY = 3e-5
MOMENTUM = 0.99


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """One iteration's draws: the augmentation's per sample, GIN's nets
    (None for a trainer without GIN) and the MIND noise source,
    `(shape, device) -> standard-normal tensor`."""

    da: Tuple[SampleDraws, ...]
    gin: Optional[GinDraws] = None
    mind_noise: Optional[Callable] = None

    def rows(self, lo: int, hi: int) -> "StepDraws":
        """The draws of batch rows lo..hi-1 (a data-parallel rank's
        share): those samples' augmentation draws and GIN nets, and the
        MIND noise drawn at the whole batch's shape, cut to those rows."""
        return StepDraws(
            da=self.da[lo:hi],
            gin=None if self.gin is None else self.gin.rows(lo, hi),
            mind_noise=None if self.mind_noise is None else _RowsOf(
                self.mind_noise, len(self.da), lo, hi))


@dataclasses.dataclass(frozen=True)
class _RowsOf:
    """`(shape, device)` -> rows lo..hi-1 of `draw` at batch `batch`."""

    draw: Callable
    batch: int
    lo: int
    hi: int

    def __call__(self, shape, device):
        return self.draw((self.batch, *shape[1:]), device)[self.lo:self.hi]


class PretrainDraws(TorchDraws):
    """The default draw source: iteration `it` of epoch `epoch` draws from
    a CPU generator seeded by a hash of (seed, epoch, it), the
    augmentation's values and gates sample by sample, then GIN's nets; the
    large normal draws (each sample's image noise, where its gate is on,
    and the MIND noise) come from a generator on the device that needs
    them, seeded from the same hash with the sample and "noise", or
    "mind", appended."""

    def step(self, epoch: int, it: int, batch: int, cfg: DAConfig,
             gin: bool = False, channels: int = 1) -> StepDraws:
        g = self._generator("pretrain", epoch, it)
        da = tuple(draw_sample(g, cfg, functools.partial(
            self._normal, self._seed("pretrain", epoch, it, b, "noise")))
            for b in range(batch))
        return StepDraws(
            da=da, gin=draw_gin(g, batch, channels) if gin else None,
            mind_noise=functools.partial(
                self._normal, self._seed("pretrain", epoch, it, "mind")))


def make_optimizer(net: torch.nn.Module) -> torch.optim.SGD:
    """nnUNet's optimizer: SGD, momentum 0.99, Nesterov, weight decay 3e-5
    (the learning rate is set per epoch)."""
    return torch.optim.SGD(net.parameters(), lr=INITIAL_LR,
                           momentum=MOMENTUM, nesterov=True,
                           weight_decay=WEIGHT_DECAY)


def _average_grads(params, loss, group):
    """Average each parameter's gradient and the loss over the ranks of
    `group`, by one all-reduce of them all flattened; returns the mean
    loss."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1]


def make_train_step(model, da_cfg: DAConfig, batch_dice: bool = True,
                    group=None):
    """`step(net, optimizer, imgs, segs, draws, lr)`: one iteration on a
    (B, D, H, W, C) f32 image batch and its (B, D, H, W, 1) f32 labels,
    with `draws` (`StepDraws`); returns the loss (a 0-d tensor on the
    device, not synchronized).  `group`: the process group of a
    data-parallel step, each rank calling it on its share of the batch
    and of the draws; the loss returned is then the global batch's."""

    def step(net, optimizer, imgs, segs, draws: StepDraws, lr: float):
        imgs_aug, segs_aug = augment_batch(draws.da, imgs, segs, da_cfg)
        noise = None
        if model.needs_mind_noise:
            noise = draws.mind_noise(
                (*imgs.shape[:-1], MIND_OUT_CHANNELS), imgs.device)
        outputs = model.apply(net, imgs_aug, deep_supervision=True,
                              internal_aug=True, gin_draws=draws.gin,
                              mind_noise=noise, group=group)
        loss = deep_supervised_loss(outputs, segs_aug[..., 0].long(),
                                    batch_dice=batch_dice, group=group)
        for param_group in optimizer.param_groups:
            param_group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = list(net.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if group is not None:
            loss = _average_grads(params, loss, group)
        optimizer.step()
        return loss.detach()

    return step


def make_val_step(model, group=None):
    """`val_step(net, imgs, segs)`: per foreground class, the true
    positives, false positives and false negatives of the argmax of the
    un-augmented batch (MIND without noise), int64 tensors of
    (num_classes - 1,).  `group`: as in `make_train_step` (MIND's clip
    bound over the global batch); the counts stay the rank's own."""
    n_cls = model.spec.num_classes

    def count(v):
        # labels outside [0, n_cls) (the preprocessing's -1) match no class
        return torch.bincount(v[(v >= 0) & (v < n_cls)],
                              minlength=n_cls)[1:]

    @torch.no_grad()
    def val_step(net, imgs, segs):
        pred = torch.argmax(model.apply(net, imgs, group=group),
                            dim=-1).flatten()
        gt = segs[..., 0].long().flatten()
        tp = count(gt[pred == gt])
        return tp, count(pred) - tp, count(gt) - tp

    return val_step


def _global_pseudo_dice(tp, fp, fn):
    """nnUNet's on_validation_epoch_end: the global per-class Dice of the
    summed counts; a class absent from prediction and labels gives nan and
    is left out of the foreground mean."""
    tp, fp, fn = (np.asarray(v, np.float64) for v in (tp, fp, fn))
    denom = 2.0 * tp + fp + fn
    per_class = np.where(denom > 0, 2.0 * tp / np.maximum(denom, 1e-8),
                         np.nan)
    if np.all(np.isnan(per_class)):
        return 0.0, per_class
    return float(np.nanmean(per_class)), per_class


def preprocessed_dir(dataset_name: str) -> Path:
    """`$nnUNet_preprocessed/{dataset}`, by default beside
    `nnUNet_results`."""
    return Path(os.environ.get(
        "nnUNet_preprocessed",
        nnunet_results().parent / "nnUNet_preprocessed")) / dataset_name


def _ensure_preprocessed(dataset_name: str, plans: Optional[dict],
                         preprocessed_dir: Path,
                         configuration: str = "3d_fullres",
                         plans_name: str = "nnUNetPlans"):
    """Fingerprint and plan (unless `plans` is given or stored), preprocess
    into the configuration's store (unless its completion marker lists
    every case), and make the folds; returns (dataset_json, plans, store,
    splits)."""
    raw_dir = nnunet_raw() / dataset_name
    with open(raw_dir / "dataset.json") as f:
        dataset_json = json.load(f)
    # "nnUNetPlans" keeps the plans.json name; other identifiers (nnUNet's
    # -p) live at {plans_name}.json
    plans_fname = ("plans.json" if plans_name == "nnUNetPlans"
                   else f"{plans_name}.json")
    plans_path = preprocessed_dir / plans_fname
    if plans is None:
        if plans_path.is_file():
            plans = json.loads(plans_path.read_text())
        else:
            fp = fingerprint_dataset(raw_dir)
            plans = plan_experiment(dataset_json, fp, dataset_name)
            plans["plans_name"] = plans_name
            for c in plans.get("configurations", {}).values():
                if "data_identifier" in c:
                    c["data_identifier"] = (
                        f"{plans_name}_"
                        f"{c['data_identifier'].split('_', 1)[1]}")
            preprocessed_dir.mkdir(parents=True, exist_ok=True)
            with open(preprocessed_dir / "dataset_fingerprint.json", "w") as f:
                json.dump(fp, f, indent=2)
    preprocessed_dir.mkdir(parents=True, exist_ok=True)
    with open(plans_path, "w") as f:
        json.dump(plans, f, indent=2)

    if configuration not in plans.get("configurations", {}):
        raise KeyError(
            f"configuration {configuration!r} not in plans "
            f"(available: {sorted(plans.get('configurations', {}))})")
    # the store is named by the configuration's data_identifier
    cfg = plans["configurations"][configuration]
    store = preprocessed_dir / cfg.get(
        "data_identifier", f"{plans.get('plans_name', plans_name)}"
                           f"_{configuration}")
    splits_path = preprocessed_dir / "splits_final.json"
    # a store is complete only if its marker lists exactly the cases there:
    # an interrupted preprocessing run is redone
    marker = store / ".preprocess_complete.json"
    complete = False
    if marker.is_file():
        listed = json.loads(marker.read_text()).get("cases", [])
        complete = bool(listed) and all(
            (store / f"{c}.npz").is_file() for c in listed)
    if not complete:
        cases = preprocess_dataset(raw_dir, plans, store,
                                   configuration=configuration)
        with open(marker, "w") as f:
            json.dump({"cases": sorted(cases)}, f)
    else:
        cases = sorted(json.loads(marker.read_text())["cases"])
    if not splits_path.is_file():
        with open(splits_path, "w") as f:
            json.dump(make_splits(cases), f, indent=2)
    splits = json.loads(splits_path.read_text())
    return dataset_json, plans, store, splits


def _save_momentum(optimizer, net, path):
    """The SGD momentum buffers, by parameter name, in the flat-npz
    layout."""
    bufs = {name: optimizer.state[p]["momentum_buffer"].detach().cpu()
            for name, p in net.named_parameters()}
    save_flat_npz(bufs, path)


def _load_momentum(optimizer, net, path):
    bufs = load_flat_npz(path)
    for name, p in net.named_parameters():
        optimizer.state[p]["momentum_buffer"] = bufs[name].to(p.device,
                                                             p.dtype)


def _prefetch(sampler, batch_size, seed, epochs, iters, device):
    """Start a host thread that samples `iters` batches per epoch of
    `epochs`, restarting the sampler from (seed, epoch) at each, as
    tensors (pinned when `device` is CUDA); returns (queue, stop event,
    thread).  An exception in the thread is put on the queue in place of
    the batch (`_next_batch` raises it)."""
    q: "queue.Queue" = queue.Queue(maxsize=4)
    stop = threading.Event()
    pin = device.type == "cuda"

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for epoch in epochs:
                sampler.reseed(seed, epoch)
                for _ in range(iters):
                    imgs, segs = sampler.batch(batch_size)
                    b = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
                         for a in (imgs, segs)]
                    if pin:
                        b = [t.pin_memory() for t in b]
                    if not put(b):
                        return
        except Exception as e:  # handed to the training loop
            put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    return q, stop, thread


def _next_batch(q):
    """The prefetch thread's next batch; raises what the thread raised."""
    item = q.get()
    if isinstance(item, Exception):
        raise RuntimeError("the prefetch thread failed") from item
    return item


@dataclasses.dataclass(frozen=True)
class _Training:
    """A pretraining run, set up: what every rank needs."""

    out_dir: Path
    store: Path
    train_cases: list
    val_cases: list
    patch_size: tuple
    model: object
    trainer_name: str
    da_cfg: DAConfig
    batch_dice: bool
    batch_size: int
    n_img_channels: int
    num_epochs: int
    iters_per_epoch: int
    val_iters_per_epoch: int
    continue_training: bool
    seed: int
    verbose: bool


def run_pretraining(dataset_id, configuration: str = "3d_fullres",
                    fold=0, trainer_name: str = "nnUNetTrainer_GIN",
                    num_epochs: int = 1000, continue_training: bool = False,
                    plans: Optional[dict] = None,
                    iters_per_epoch: int = ITERS_PER_EPOCH,
                    val_iters_per_epoch: int = VAL_ITERS_PER_EPOCH,
                    batch_size: Optional[int] = None,
                    num_devices: int = 1, plans_name: str = "nnUNetPlans",
                    seed: int = 0, verbose: bool = True, device=None,
                    backend: Optional[str] = None):
    """The `dgtta pretrain` entry: trains `trainer_name` on the nnUNet raw
    dataset `dataset_id` on `device` (CUDA unless "cpu"), data-parallel
    over `num_devices` processes (module docstring; `backend`: as in
    `parallel/mesh.launch`, default NCCL on CUDA, gloo on the CPU).
    Returns the fold's results directory."""
    if trainer_name not in TRAINER_REGISTRY:
        raise KeyError(f"unknown trainer {trainer_name!r}; one of "
                       f"{sorted(TRAINER_REGISTRY)}")
    num_devices = int(num_devices)
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    device = resolve_device(device)
    dataset_name = maybe_convert_to_dataset_name(dataset_id)
    fold = int(fold) if str(fold).isnumeric() else fold

    pre_dir = preprocessed_dir(dataset_name)
    dataset_json, plans, store, splits = _ensure_preprocessed(
        dataset_name, plans, pre_dir, configuration=configuration,
        plans_name=plans_name)
    cfg = plans["configurations"][configuration]
    patch_size = tuple(cfg["patch_size"])
    if batch_size is None:
        batch_size = int(cfg.get("batch_size", 2))
    if batch_size % num_devices:
        raise ValueError(f"batch size {batch_size} is not divisible by "
                         f"num_devices {num_devices}")

    out_dir = (nnunet_results() / dataset_name /
               f"{trainer_name}__{plans_name}__{configuration}" /
               (f"fold_{fold}" if fold != "all" else "all"))
    out_dir.mkdir(parents=True, exist_ok=True)
    # the results folder always carries plans.json (nnUNet's convention)
    with open(out_dir.parent / "plans.json", "w") as f:
        json.dump(plans, f, indent=2)
    src = pre_dir / "dataset_fingerprint.json"
    if src.is_file():
        shutil.copy(src, out_dir.parent / "dataset_fingerprint.json")
    with open(out_dir.parent / "dataset.json", "w") as f:
        json.dump(dataset_json, f, indent=2)

    if fold == "all":
        train_cases = sorted({c for s in splits for c in s["train"]}
                             | {c for s in splits for c in s["val"]})
        val_cases = train_cases
    else:
        train_cases = splits[fold]["train"]
        val_cases = splits[fold]["val"] or train_cases

    run = _Training(
        out_dir=out_dir, store=store, train_cases=list(train_cases),
        val_cases=list(val_cases), patch_size=patch_size,
        model=build_model(plans, dataset_json, trainer_name, configuration),
        trainer_name=trainer_name,
        da_cfg=DAConfig(discrete_lowres_zooms=(
            MULTIRES_ZOOMS if trainer_name in MULTIRES_TRAINERS else None)),
        batch_dice=bool(cfg.get("batch_dice", True)), batch_size=batch_size,
        n_img_channels=len(dataset_json.get("channel_names", {"0": "CT"})),
        num_epochs=num_epochs, iters_per_epoch=iters_per_epoch,
        val_iters_per_epoch=val_iters_per_epoch,
        continue_training=continue_training, seed=seed, verbose=verbose)
    if num_devices == 1:
        _train(run, device)
    else:
        launch(_train_rank, num_devices, device.type,
               backend or default_backend(device.type), args=(run,))
    if verbose:
        print(f"Training done -> {out_dir / 'checkpoint_final.npz'}")
    return out_dir


def _train_rank(rank, ranks, device, run: _Training):
    """A rank of a data-parallel run (`parallel/mesh.launch`)."""
    _train(run, device, dist.group.WORLD)


def _train(run: _Training, device, group=None):
    """The training loop of `run` on `device`: alone (`group` None) or as
    one rank of `group` (the module docstring)."""
    rank = dist.get_rank(group) if group is not None else 0
    ranks = dist.get_world_size(group) if group is not None else 1
    lead = rank == 0
    share = run.batch_size // ranks
    lo, hi = rank * share, (rank + 1) * share
    model, seed, out_dir = run.model, run.seed, run.out_dir
    sampler = PatchSampler(run.store, run.train_cases, run.patch_size,
                           seed=seed)
    val_sampler = PatchSampler(run.store, run.val_cases, run.patch_size,
                               oversample_fg=1.0, seed=seed + 1)
    step = make_train_step(model, run.da_cfg, batch_dice=run.batch_dice,
                           group=group)
    val_step = make_val_step(model, group=group)
    draws = PretrainDraws(seed)
    verbose = run.verbose and lead

    ckpt_latest = out_dir / "checkpoint_latest.npz"
    ckpt_best = out_dir / "checkpoint_best.npz"
    ckpt_opt = out_dir / "checkpoint_latest_optimizer.npz"
    state_path = out_dir / "training_state.json"
    start_epoch, ema_dice, best_ema = 0, None, None
    resume = run.continue_training and ckpt_latest.is_file()
    if resume:
        net = model.build_network(load_flat_npz(ckpt_latest), device)
        meta = json.loads(state_path.read_text())
        start_epoch = meta["epoch"] + 1
        ema_dice, best_ema = meta.get("ema_dice"), meta.get("best_ema")
    else:
        net = model.build_network(
            model.init_params(torch.Generator().manual_seed(seed)), device)
    if group is not None:
        broadcast_state(net, 0, group)
    optimizer = make_optimizer(net)
    if resume:
        if ckpt_opt.is_file():
            _load_momentum(optimizer, net, ckpt_opt)
        elif verbose:
            print("WARNING: no optimizer checkpoint found; the momentum "
                  "restarts from zero")
        if verbose:
            print(f"Resuming from epoch {start_epoch}")

    q, stop, producer = _prefetch(sampler, run.batch_size, seed,
                                  range(start_epoch, run.num_epochs),
                                  run.iters_per_epoch, device)
    log_path = out_dir / "training_log.jsonl"
    try:
        for epoch in range(start_epoch, run.num_epochs):
            lr = poly_lr(INITIAL_LR, epoch, run.num_epochs)
            t0 = time.perf_counter()
            losses = []
            for it in range(run.iters_per_epoch):
                imgs, segs = (t[lo:hi].to(device, non_blocking=True)
                              for t in _next_batch(q))
                d = draws.step(epoch, it, run.batch_size, run.da_cfg,
                               gin=model.uses_gin_internal,
                               channels=run.n_img_channels)
                if ranks > 1:
                    d = d.rows(lo, hi)
                losses.append(step(net, optimizer, imgs, segs, d, lr))
            mean_loss = float(torch.stack(losses).float().mean())
            train_s = time.perf_counter() - t0
            # nnUNet's validation: a fixed number of batches, counts summed
            # over all of them (and over the ranks), the EMA of the global
            # pseudo-Dice
            val_sampler.reseed(seed + 1, epoch)
            acc = None
            for _ in range(run.val_iters_per_epoch):
                vi, vs = val_sampler.batch(run.batch_size)
                counts = val_step(net, torch.from_numpy(vi[lo:hi]).to(device),
                                  torch.from_numpy(vs[lo:hi].astype(
                                      np.float32)).to(device))
                acc = counts if acc is None else tuple(
                    a + c for a, c in zip(acc, counts))
            if group is not None:
                acc = torch.stack(acc)
                dist.all_reduce(acc, group=group)
            val_dice, _ = _global_pseudo_dice(*(a.cpu().numpy()
                                                for a in acc))
            ema_dice = (val_dice if ema_dice is None
                        else 0.9 * ema_dice + 0.1 * val_dice)
            dt = time.perf_counter() - t0
            if verbose:
                print(f"epoch {epoch:4d}  loss={mean_loss:.4f}  "
                      f"val_pseudo_dice={val_dice:.4f}  ema={ema_dice:.4f}"
                      f"  lr={lr:.2e}  {dt:.1f}s")
            new_best = best_ema is None or ema_dice > best_ema
            best_ema = ema_dice if new_best else best_ema
            if lead:
                with open(log_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch, "loss": mean_loss,
                                        "val_pseudo_dice": val_dice,
                                        "ema_dice": ema_dice, "lr": lr,
                                        "seconds": dt,
                                        "train_seconds": train_s}) + "\n")
                save_flat_npz(net.state_dict(), ckpt_latest)
                if new_best:
                    save_flat_npz(net.state_dict(), ckpt_best)
                _save_momentum(optimizer, net, ckpt_opt)
                state_path.write_text(json.dumps({
                    "epoch": epoch, "trainer": run.trainer_name,
                    "seed": seed, "ema_dice": ema_dice,
                    "best_ema": best_ema}))
            if new_best and verbose:
                print(f"  new best EMA pseudo-Dice {best_ema:.4f} "
                      f"-> checkpoint_best")
            if group is not None:
                dist.barrier(group)
    finally:
        stop.set()
        producer.join()
    if lead:
        save_flat_npz(net.state_dict(), out_dir / "checkpoint_final.npz")
