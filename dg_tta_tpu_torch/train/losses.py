"""nnUNet pretraining loss: deep-supervised Dice + cross-entropy (the port
of `dg_tta_tpu/train/losses.py`).

nnUNetTrainer._build_loss semantics (nnunetv2 2.2.1): soft Dice with
batch_dice (plans.json `batch_dice: true`), smooth 1e-5, background
excluded, plus the mean voxel cross-entropy; deep-supervision weights
1/2^i with the lowest resolution zeroed, normalized.

Each head's target is the label map resampled nearest onto the head's
grid, on the warp kernel's grid entry (border padding).  At a stride-s
scale every sample lies on a rounding tie (s j + (s - 1) / 2 voxels), so
which neighbour it takes rests on the last f32 bit of its coordinate.  The
JAX package's step runs under `jax.jit`, where XLA folds the identity
grid's division by the output size and the unnormalization into one
product by the size ratio: each output voxel takes source voxel
round-half-even(((2j + 1) r - 1) / 2), r = fl(fl(1 / n) N), exactly
s j + s / 2 at the integer strides of deep supervision (JAX run eagerly
divides first and, at the TS104 patch's 1/2 scale, picks the other
neighbour for one target voxel in ten).  `downsample_target` computes that
index on the host and hands the kernel the picked voxel's centre, which
its nearest rounding maps back to that voxel with no tie.

Under data parallelism (`group`: the process group whose ranks each hold
an equal share of the batch) the batch Dice sums its true positives,
false positives and false negatives over the ranks with a differentiable
all-reduce (`parallel/mesh.all_reduce_sum`), so every rank's Dice is the
global batch's; the cross-entropy stays a mean over the rank's share,
and the ranks' mean of it is the global mean.  With the gradients then
averaged over the ranks, a step equals the one-process step on the whole
batch (nnUNet's DDP Dice, its AllGatherGrad).
"""

from typing import Sequence

import torch

from dg_tta_tpu_torch.core.grid import _base_coords, grid_sample
from dg_tta_tpu_torch.parallel.mesh import all_reduce_sum


def soft_dice_ce(logits, target, batch_dice: bool = True,
                 smooth: float = 1e-5, group=None):
    """Dice + CE of one resolution: logits (B, D, H, W, C) in any float
    type (the loss is computed in f32), target (B, D, H, W) int labels.  A
    label outside [0, C) (the preprocessing's -1 outside the nonzero mask)
    has an all-zero one-hot row, as `jax.nn.one_hot` gives it: it adds to
    no class and to no cross-entropy term, but counts in the mean.
    `group`: as in the module docstring (None: one process)."""
    C = logits.shape[-1]
    logits = logits.float()
    target = target.long()
    sm = torch.softmax(logits, dim=-1)
    valid = (target >= 0) & (target < C)
    onehot = (target[..., None] == torch.arange(C, device=target.device)
              ).to(logits.dtype)

    dims = (0, 1, 2, 3) if batch_dice else (1, 2, 3)
    tp = torch.sum(sm * onehot, dim=dims)
    fp = torch.sum(sm * (1.0 - onehot), dim=dims)
    fn = torch.sum((1.0 - sm) * onehot, dim=dims)
    if group is not None and batch_dice:
        tp, fp, fn = all_reduce_sum(torch.stack([tp, fp, fn]), group)
    dc = (2.0 * tp + smooth) / (2.0 * tp + fp + fn + smooth)
    dice_loss = -torch.mean(dc[..., 1:])   # background excluded

    # sum(onehot * log_softmax) over classes: the target's log-prob
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, torch.where(valid, target, 0)[..., None])[..., 0]
    ce = -torch.mean(torch.where(valid, picked, 0.0))
    return dice_loss + ce


def _target_axis(n_src: int, n_out: int) -> torch.Tensor:
    """The normalized coordinates along one axis at which the targets of
    an `n_out`-voxel head sample an `n_src`-voxel axis: the centre of the
    source voxel the JAX step picks (module docstring), clamped into the
    volume (border padding)."""
    j = torch.arange(n_out, dtype=torch.float32)
    r = (torch.tensor(1.0) / n_out) * n_src
    k = torch.round(((2.0 * j + 1.0) * r - 1.0) * 0.5).clamp(0, n_src - 1)
    return _base_coords(n_src, False)[k.long()]


def downsample_target(target, out_spatial):
    """Nearest resample of (B, D, H, W) labels (an int or float tensor)
    onto an `out_spatial` grid, as the JAX package's jitted step computes
    it (module docstring): the warp kernel's grid entry, border padding."""
    if tuple(target.shape[1:4]) == tuple(out_spatial):
        return target
    D, H, W = out_spatial
    z, y, x = (_target_axis(n, m).to(target.device) for n, m in
               zip(target.shape[1:4], out_spatial))
    grid = (x[None, None, None, :].expand(1, D, H, W),
            y[None, None, :, None].expand(1, D, H, W),
            z[None, :, None, None].expand(1, D, H, W))
    out = grid_sample(target[..., None].float(), grid, mode="nearest",
                      padding_mode="border", align_corners=False)
    return out[..., 0].to(target.dtype)


def deep_supervision_weights(n_outputs: int):
    w = [1.0 / (2 ** i) for i in range(n_outputs)]
    if n_outputs > 1:
        w[-1] = 0.0
    s = sum(w)
    return [x / s for x in w]


def deep_supervised_loss(outputs: Sequence, target, batch_dice: bool = True,
                         group=None):
    """Weighted Dice + CE over the deep-supervision heads (highest
    resolution first); a head of weight 0 is not computed.  `group`: as
    in `soft_dice_ce`."""
    weights = deep_supervision_weights(len(outputs))
    total = 0.0
    for w, out in zip(weights, outputs):
        if w == 0.0:
            continue
        tgt = downsample_target(target, out.shape[1:4])
        total = total + w * soft_dice_ce(out, tgt, batch_dice=batch_dice,
                                         group=group)
    return total


def poly_lr(initial_lr: float, epoch: int, max_epochs: int,
            exponent: float = 0.9) -> float:
    """nnUNet's PolyLRScheduler."""
    return initial_lr * (1.0 - epoch / max_epochs) ** exponent
