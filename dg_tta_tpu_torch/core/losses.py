"""Dice losses and metrics (the port of `dg_tta_tpu/core/losses.py`).

The reference's semantics (torch_utils.py:90-117 of the reference): the
consistency soft Dice has no epsilon in the ratio, only a guard for an
all-zero denominator, and the evaluation Dice a 1e-8 epsilon.  The loss
math runs in f32 whatever the logits' type.
"""

import torch


def _guarded_ratio(nominator, denominator):
    """nominator / denominator, 0 where the denominator is 0, and all ones
    when every denominator is 0 (the reference's guard)."""
    safe = torch.where(denominator == 0.0,
                       torch.ones_like(denominator), denominator)
    dice = nominator / safe * (denominator != 0.0)
    return torch.where(denominator.sum() == 0.0, torch.ones_like(dice), dice)


def soft_dice_loss(sm_a, sm_b):
    """Per-(batch, class) soft Dice of two (B, D, H, W, C) probability
    volumes: (B, C)."""
    B, C = sm_a.shape[0], sm_a.shape[-1]
    a = sm_a.reshape(B, -1, C)
    b = sm_b.reshape(B, -1, C)
    nominator = (2.0 * a * b).mean(dim=1)
    denominator = (0.5 * (a + b) ** 2).mean(dim=1)
    return _guarded_ratio(nominator, denominator)


def consistency_loss(logits_a, logits_b, start_class: int = 1):
    """The TTA loss on channels-last logits (tta.py:262-269 of the
    reference): mask to the voxels both branches cover, softmax both,
    1 - mean foreground soft Dice."""
    logits_a, logits_b = logits_a.float(), logits_b.float()
    common = ((logits_a.sum(-1, keepdim=True) > 0.0).float()
              * (logits_b.sum(-1, keepdim=True) > 0.0).float())
    sm_a = torch.softmax(logits_a, dim=-1) * common
    sm_b = torch.softmax(logits_b, dim=-1) * common
    return 1.0 - soft_dice_loss(sm_a, sm_b)[:, start_class:].mean()


def consistency_loss_flat(logits_a, logits_b, start_class: int = 1,
                          members=None):
    """`consistency_loss` on channels-first flat (B, C, N) logits, the
    layout the unwarp produces.  With `members` M, the rows are M ensemble
    members' patches, member after member, and the result is each
    member's loss, (M,), computed on its own patches (its guard over them,
    as the JAX package's vmap takes it, and its means summed as its own
    call sums them)."""
    if members is not None:
        return torch.stack([
            consistency_loss_flat(a, b, start_class) for a, b in
            zip(logits_a.chunk(members), logits_b.chunk(members))])
    logits_a, logits_b = logits_a.float(), logits_b.float()
    common = ((logits_a.sum(1, keepdim=True) > 0.0).float()
              * (logits_b.sum(1, keepdim=True) > 0.0).float())
    sm_a = torch.softmax(logits_a, dim=1) * common
    sm_b = torch.softmax(logits_b, dim=1) * common
    nominator = (2.0 * sm_a * sm_b).mean(dim=2)
    denominator = (0.5 * (sm_a + sm_b) ** 2).mean(dim=2)
    dice = _guarded_ratio(nominator, denominator)
    return 1.0 - dice[:, start_class:].mean()


def dice_coeff(outputs, labels, max_label: int):
    """Hard Dice per foreground class 1..max_label-1 of two integer label
    volumes of one shape: (max_label - 1,) f32."""
    outputs = outputs.reshape(-1)
    labels = labels.reshape(-1)
    dices = []
    for c in range(1, max_label):
        iflat = (outputs == c).float()
        tflat = (labels == c).float()
        intersection = (iflat * tflat).mean()
        dices.append(2.0 * intersection
                     / (1e-8 + iflat.mean() + tflat.mean()))
    return torch.stack(dices)
