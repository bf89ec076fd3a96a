"""The TTA adaptation engine: per volume, each ensemble member adapts a copy
of the pretrained network by a two-branch consistency loss (the port of
`dg_tta_tpu/tta/engine.py`, reference tta.py:157-374 and :480-579).

One patch step: extract a batch of patches, augment each branch (GIN where
the plan puts it in the branch, then a random spatial warp of the input,
border padding: an affine, or a deformable plan's diffeomorphic field),
run both branches through ONE network forward (2B batch; a MIND model
computes its descriptor of the 2B patches in that forward), unwarp each
branch's logits back to the patch frame (zeros padding) and take
1 - mean foreground soft Dice between them.
`patches_to_be_accumulated` steps sum their gradients; the mean gradient
takes one AdamW step over the released parameters.  Every affine warp is
the hand-written warp kernel's affine entry
(`kernels/warp.warp_affine_flat`: the points built from theta in the
kernel, no grid in memory); the deformable fields (`core/fields.py`) and
their warps take its grid entry (`kernels/warp.warp_flat`); every
stride-1 conv of the forward and backward the conv kernels
(`kernels/conv3x3.py`).

The math is the JAX package's CPU default: the exact trilinear warp, the
original-frame loss, full-resolution fields and the plain z-tap U-Net,
with the approximate inverse-map adjoint of the unwarp
(`_WarpWithInverse`, `_GridWarpWithInverse`), or with
`exact_warp_grad` the exact one (the warp kernel's scatter-add adjoint:
`kernels/warp.warp_affine_op` on an affine branch, `warp_flat_op` on a
deformable one).  The random draws come from a draw source
(`tta/draws.py`).

Reference quirks kept, as in the JAX package:
* `have_grad_in` gates on the plan value only, never the branch:
  "branch_a" and "both" put gradients in BOTH branches; "branch_b" turns
  adaptation into a forward-only run that changes nothing.
* The unwarp pads with zeros while the input warp pads with the border; the
  zero band defines the common-content mask of the loss.
* Epochs before `start_tta_at_epoch` compute the loss but do not update.

`patch_group` folds that many accumulation steps into the batch, as in
the JAX package: each trained or warm-up step runs B = batch_size x
patch_group patches (2B in the forward), an epoch takes
patches_to_be_accumulated // patch_group steps, and their summed gradient
is divided by that count; the evaluation stays at batch_size.  The loss
and the mean gradient average per patch, so a grouped run equals the
ungrouped one up to the order of its sums, except where an operation
couples the patches of one call (MIND's clip bound, the loss's
all-zero-denominator guard; ROADMAP C).  `remat` runs both branches
(augmentation, forward, unwarps) under `torch.utils.checkpoint`, as the
JAX package runs them under `jax.checkpoint(both_branches)`: the forward
keeps only their inputs and the backward recomputes them.  As one
segment it does not lower the peak memory, since the recompute holds
every activation again before the backward frees any (ROADMAP C).  The
draws are handed in and the noise callables are seeded per call, so the
recompute redraws nothing.

The split engine (a TPU dispatch workaround) raises
`NotImplementedError` (`check_supported`; ROADMAP "Not ported").

`ensemble_chunk` runs the members in chunks, as the JAX package does.  A
chunk of size > 1 with more than one device spreads over
`parallel/mesh.ranks_for(chunk, devices)` processes, one device each, a
contiguous block of members each (`parallel/tta.sharded_member_run`).  A
chunk on one device (or a rank's block of it) runs its members side by
side, as the JAX package vmaps a chunk (`TTAFunctions.chunk_run`): one
sequence of launches adapts them all, every parameter carrying a leading
member axis (`models/unet.stack_members`), each conv launch reading each
member's own weights (`kernels/conv3x3.py`).  No member's math changes:
each keeps its own patches and draws, its MIND clip bound and loss guard
over its own patches, its own gradient (the chunk's loss is the sum of
its members'), and its own AdamW (one optimizer over the stacked leaves:
the update is elementwise).  A chunk of one member runs `member_run`.
"""

import copy
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from dg_tta_tpu_torch.core.fields import (affine_abs_det, deformable_grids,
                                          get_rand_affine)
from dg_tta_tpu_torch.core.labels import map_label_argmaxed
from dg_tta_tpu_torch.core.losses import consistency_loss_flat, dice_coeff
from dg_tta_tpu_torch.core.patches import extract_batch
from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat, warp_affine_op,
                                           warp_flat, warp_flat_op)
from dg_tta_tpu_torch.models.network import Model
from dg_tta_tpu_torch.models.unet import stack_members
from dg_tta_tpu_torch.ops.gin import gin_aug
from dg_tta_tpu_torch.ops.mind import MIND_OUT_CHANNELS
from dg_tta_tpu_torch.parallel.mesh import (default_backend, launch,
                                            visible_devices)
from dg_tta_tpu_torch.parallel.tta import member_chunks, sharded_member_run
from dg_tta_tpu_torch.tta.draws import member_draws
from dg_tta_tpu_torch.tta.plan import TTAPlan


def _in_branch(setting: str, branch_id: str) -> bool:
    return setting in (branch_id, "both")


def check_supported(plan: TTAPlan):
    """Raise `NotImplementedError` for the split engine, which the port
    does not run."""
    if plan.engine == "split":
        raise NotImplementedError(
            "the split engine is not ported to dg_tta_tpu_torch: a TPU "
            "dispatch workaround (ROADMAP \"Not ported\"); use the fused "
            "engine")


def check_patch_group(plan: TTAPlan, patch_group: int) -> int:
    """`patch_group` as an int >= 1 that divides the plan's
    patches_to_be_accumulated, or ValueError."""
    group = int(patch_group)
    if group < 1 or plan.patches_to_be_accumulated % group:
        raise ValueError(f"patch_group {patch_group} must be >= 1 and "
                         f"divide patches_to_be_accumulated="
                         f"{plan.patches_to_be_accumulated}")
    return group


class _WarpWithInverse(torch.autograd.Function):
    """The warp of `x` by the affine `theta` (`warp_affine_flat`) whose
    backward resamples the incoming gradient by `theta_inv` (zeros
    padding) times `inv_det`.

    The true adjoint of a resample is a scatter-add.  The TTA branch warps
    come with their exact inverse map, and the continuous adjoint of
    x -> x o theta is y -> |det theta|^-1 y o theta^-1, so the backward is
    the same forward kernel on the other affine, with the factor applied
    in its store; its discretization error is O(h^2) for the
    near-identity warps of TTA.  Plain autograd through an exact resample
    would not match the JAX package, which uses this form (with the two
    affines' grids).
    """

    @staticmethod
    def forward(ctx, x, theta, theta_inv, inv_det, spatial, padding_mode):
        ctx.spatial = spatial
        ctx.save_for_backward(theta_inv, inv_det)
        return warp_affine_flat(x, spatial, theta, spatial,
                                padding_mode=padding_mode)

    @staticmethod
    def backward(ctx, g):
        theta_inv, inv_det = ctx.saved_tensors
        dx = warp_affine_flat(g.contiguous(), ctx.spatial, theta_inv,
                              ctx.spatial, padding_mode="zeros",
                              scale=inv_det)
        return dx, None, None, None, None, None


def _warp_with_inverse(x, theta, theta_inv, inv_det, spatial, padding_mode):
    return _WarpWithInverse.apply(x, theta, theta_inv, inv_det,
                                  tuple(spatial), padding_mode)


class _GridWarpWithInverse(torch.autograd.Function):
    """The warp of `x` at `grid` (`warp_flat`) whose backward resamples the
    incoming gradient at `grid_inv` (zeros padding): `_WarpWithInverse`
    for a deformable branch, whose inverse-consistent field is near the
    identity, so |det| ~ 1 and the JAX package's factor of 1 is left out
    (`_wwi_fwd`/`_wwi_bwd` there)."""

    @staticmethod
    def forward(ctx, x, grid, grid_inv, spatial, padding_mode):
        ctx.spatial, ctx.grid_inv = spatial, grid_inv
        return warp_flat(x, spatial, grid, padding_mode=padding_mode)

    @staticmethod
    def backward(ctx, g):
        dx = warp_flat(g.contiguous(), ctx.spatial, ctx.grid_inv,
                       padding_mode="zeros")
        return dx, None, None, None, None


def params_with_grad_mask(net: torch.nn.Module, mode: str) -> dict:
    """{parameter name: released?} replicating the reference's
    release_{all,norms,encoder} (torch_utils.py:120-137): "norms" releases
    the parameters with a `norm` path component, "encoder" those under
    `encoder.`."""
    if mode not in ("all", "norms", "encoder"):
        raise ValueError(f"params_with_grad must be all, norms or encoder, "
                         f"got {mode!r}")
    mask = {}
    for name, _ in net.named_parameters():
        parts = name.split(".")
        mask[name] = (mode == "all" or (mode == "norms" and "norm" in parts)
                      or (mode == "encoder" and parts[0] == "encoder"))
    return mask


def make_optimizer(plan: TTAPlan, params) -> torch.optim.AdamW:
    """AdamW with torch's defaults (betas 0.9/0.999, eps 1e-8, weight decay
    0.01; tta.py:185 of the reference) over the released parameters only:
    frozen parameters get neither an update nor weight decay."""
    return torch.optim.AdamW(params, lr=plan.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


@dataclasses.dataclass(frozen=True)
class TTAFunctions:
    """The engine's functions for one (model, plan, label mapping)."""

    branch_aug: Callable     # (draws, imgs, branch_id) -> (x, warp_ctx)
    both_branches: Callable  # (net, draws, imgs) -> (la, lb) flat logits
    patch_loss: Callable     # (net, draws, imgs) -> loss
    draw_and_loss: Callable  # (net, draws, vols, shapes) -> loss
    epoch_train: Callable    # (net, opt, draws, member, epoch, vols, shapes)
    epoch_fwd: Callable      # (net, draws, member, epoch, vols, shapes)
    eval_step: Callable      # (net, draws, member, epoch, rep, vols,
    #                           shapes, labels) -> mean Dice
    member_run: Callable     # (net, draws, member, vols, shapes[, labels,
    #                           log_fn]) -> (net, losses, dices)
    chunk_run: Callable      # (net, draws, members, vols, shapes[, labels,
    #                           log_fn]) -> [(net, losses, dices)]
    grads_enabled: bool

    def run(self, net0, draw_source, members, vols, shapes, labels=None,
            log_fn=None) -> list:
        """[(adapted network, losses, dices)] of `members` on one device,
        in order: side by side (`chunk_run`), or `member_run` for one."""
        members = list(members)
        if len(members) == 1:
            return [self.member_run(net0, draw_source, members[0], vols,
                                    shapes, labels, log_fn)]
        return self.chunk_run(net0, draw_source, members, vols, shapes,
                              labels, log_fn)


def make_tta_functions(model: Model, plan: TTAPlan, map_idxs_pretrain,
                       map_idxs_tta,
                       modify_input_fn: Optional[Callable] = None,
                       modify_output_fn: Optional[Callable] = None,
                       exact_warp_grad: bool = False,
                       patch_group: int = 1,
                       remat: bool = False) -> TTAFunctions:
    """The engine's functions.  modify_input_fn runs after the branch
    augmentation, before the model; modify_output_fn on the mapped logits
    (the user's modifier functions, config_log_utils.py:44-69 of the
    reference).  exact_warp_grad: the unwarp's backward is the exact
    adjoint of its warp (a scatter-add), not the inverse-map resample.
    patch_group, remat: as in the module docstring (the JAX package's
    keyword arguments; the driver reads them from the plan)."""
    check_supported(plan)
    group = check_patch_group(plan, patch_group)
    patch_size = tuple(model.patch_size)
    B_eval = plan.batch_size
    n_acc = plan.patches_to_be_accumulated // group
    map_pre = [int(i) for i in np.asarray(map_idxs_pretrain).tolist()]
    n_opt = len(map_pre)
    grads_enabled = plan.have_grad_in in ("branch_a", "both")
    gin_branches = tuple(
        b for b in ("branch_a", "branch_b")
        if plan.intensity_aug_function == "GIN"
        and _in_branch(plan.do_intensity_aug_in, b))

    def patch_draws(draw_source, member, epoch, step, vols):
        return draw_source.patch(member, epoch, step, vols.shape[0],
                                 plan.batch_size, gin_branches=gin_branches,
                                 channels=vols.shape[-1], group=group)

    deformable = plan.spatial_aug_type == "deformable"
    # the deformable fields' interpolation factor (JAX engine.py:281-285)
    # and the noise it takes per branch, (B, D//f, H//f, W//f, 3)
    field_factor = 5

    def branch_aug(draws, imgs, branch_id, members=1):
        """One branch's input augmentation: GIN where the plan puts it in
        this branch, then the warp; returns the augmented input and what
        undoes the warp, or None: ("affine", theta, theta_inv, adjoint
        scale) or ("grid", grid, grid_inv).  With `members` > 1 (imgs and
        draws a chunk's, member after member) GIN and the deformable
        fields run once per member, as in each member's own run."""
        a = branch_id == "branch_a"
        if branch_id in gin_branches:
            gin = draws.gin_a if a else draws.gin_b
            n = imgs.shape[0] // members
            imgs = gin_aug(imgs, gin) if members == 1 else torch.cat(
                [gin_aug(imgs[i:i + n], gin.rows(i, i + n))
                 for i in range(0, imgs.shape[0], n)])
        if not _in_branch(plan.do_spatial_aug_in, branch_id):
            return imgs, None
        Bi, Cin = imgs.shape[0], imgs.shape[-1]
        xf = imgs.movedim(-1, 1).reshape(Bi, Cin, -1).contiguous()
        if deformable:
            field_shape = (Bi, *(s // field_factor for s in patch_size), 3)
            noise = (draws.field_a if a else draws.field_b)(field_shape,
                                                           imgs.device)
            # a chunk's fields member by member, as a member's own run
            # builds them (their smoothing convs sum in another order at
            # another batch)
            grids = [deformable_grids(n, patch_size, factor=0.5,
                                      interpolation_factor=field_factor)
                     for n in noise.chunk(members)]
            grid, grid_inv = grids[0] if members == 1 else (
                tuple(torch.cat(c) for c in zip(*[g[k] for g in grids]))
                for k in (0, 1))
            xf = warp_flat(xf, patch_size, grid, padding_mode="border")
            ctx = ("grid", grid, grid_inv)
        else:
            theta, theta_inv = get_rand_affine(torch.tensor(
                draws.noise_a if a else draws.noise_b, dtype=torch.float32,
                device=imgs.device))
            # adjoint scale of the inverse warp: 1 / |det theta_inv| = |det R|
            adj_scale = affine_abs_det(theta)
            xf = warp_affine_flat(xf, patch_size, theta, patch_size,
                                  padding_mode="border")
            ctx = ("affine", theta, theta_inv, adj_scale)
        return xf.reshape(Bi, Cin, *patch_size).movedim(1, -1), ctx

    def branch_unwarp_flat(logits_flat, warp_ctx):
        """Undo a branch's warp on channels-first flat (B, C, N) logits; the
        backward resamples by the forward warp (`_WarpWithInverse`,
        `_GridWarpWithInverse`), or with exact_warp_grad is the unwarp's
        exact adjoint (`warp_flat_op` on a deformable branch's inverse grid,
        `warp_affine_op` on an affine branch's inverse affine)."""
        if warp_ctx is None:
            return logits_flat
        if exact_warp_grad:
            if warp_ctx[0] == "grid":
                return warp_flat_op(logits_flat, patch_size, warp_ctx[2])
            return warp_affine_op(logits_flat, patch_size, warp_ctx[2],
                                  patch_size)
        if warp_ctx[0] == "grid":
            _, grid, grid_inv = warp_ctx
            return _GridWarpWithInverse.apply(logits_flat, grid_inv, grid,
                                              patch_size, "zeros")
        _, theta, theta_inv, adj_scale = warp_ctx
        return _warp_with_inverse(logits_flat, theta_inv, theta, adj_scale,
                                  patch_size, "zeros")

    def apply(net, x, noise, params=None):
        """The model on x: `net` alone, or with `params` the members'
        stacked weights side by side (x member after member)."""
        if params is None:
            return model.apply(net, x, head_channel_idx=map_pre,
                               mind_noise=noise)
        return model.apply_members(net, params, x, head_channel_idx=map_pre,
                                   mind_noise=noise)

    def both_branches_once(net, draws, imgs, params=None):
        """Both branches through one network forward of batch 2B; returns
        the unwarped channels-first flat (B, n_opt, N) logits of each.
        With `params` (M members' stacked weights), imgs are M members' B
        patches each, member after member, and the forward holds member
        m's 2B patches (branch a, then b) after member m - 1's."""
        M = 1 if params is None else next(iter(params.values())).shape[0]
        xa, ctx_a = branch_aug(draws, imgs, "branch_a", M)
        xb, ctx_b = branch_aug(draws, imgs, "branch_b", M)
        if M == 1:
            x = torch.cat([xa, xb], dim=0)
        else:
            x = torch.stack([xa.unflatten(0, (M, -1)),
                             xb.unflatten(0, (M, -1))], dim=1).flatten(0, 2)
        if modify_input_fn is not None:
            x = modify_input_fn(x)
        noise = (draws.mind_noise((x.shape[0], *patch_size,
                                   MIND_OUT_CHANNELS), x.device)
                 if model.needs_mind_noise else None)
        logits = apply(net, x, noise, params)
        if modify_output_fn is not None:
            logits = modify_output_fn(logits)
        Bi = imgs.shape[0] // M
        lf = logits.movedim(-1, 1).reshape(M, 2, Bi, n_opt, -1)
        la, lb = (lf[:, i].reshape(M * Bi, n_opt, -1).contiguous()
                  for i in (0, 1))
        return branch_unwarp_flat(la, ctx_a), branch_unwarp_flat(lb, ctx_b)

    def both_branches(net, draws, imgs, params=None):
        """`both_branches_once`; with `remat` (and a gradient to take)
        recomputed in the backward."""
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                both_branches_once, net, draws, imgs, params,
                use_reentrant=False)
        return both_branches_once(net, draws, imgs, params)

    def patch_loss(net, draws, imgs, params=None):
        """The loss; with `params`, each member's, (M,)."""
        la, lb = both_branches(net, draws, imgs, params)
        if params is None:
            return consistency_loss_flat(la, lb, start_class=1)
        M = next(iter(params.values())).shape[0]
        return consistency_loss_flat(la, lb, start_class=1, members=M)

    def draw_and_loss(net, draws, vols, shapes, params=None):
        imgs, _ = extract_batch(draws.vol_idx, draws.uniforms, vols, shapes,
                                patch_size, len(draws.vol_idx))
        return patch_loss(net, draws, imgs, params)

    def step_draws(draw_source, member, epoch, step, vols, params):
        """A step's draws of member `member`, or with `params` those of the
        members `member` side by side (`member_draws`)."""
        if params is None:
            return patch_draws(draw_source, member, epoch, step, vols)
        return member_draws([patch_draws(draw_source, m, epoch, step, vols)
                             for m in member])

    def zero_losses(member, params, device):
        return torch.zeros(() if params is None else len(member),
                           device=device)

    def epoch_train(net, opt, draw_source, member, epoch, vols, shapes,
                    params=None):
        """n_acc patch steps (of B patches each), their summed gradient
        over n_acc, one AdamW step.  Returns the mean loss (a 0-d
        tensor).  With `params`, the stacked weights of the members
        `member` (a list), their steps side by side: the sum of their
        losses is differentiated, so each member's gradient is its own;
        returns each member's mean loss, (M,)."""
        leaves = [p for g in opt.param_groups for p in g["params"]]
        for p in leaves:
            p.grad = None
        loss_sum = zero_losses(member, params, vols.device)
        for step in range(n_acc):
            d = step_draws(draw_source, member, epoch, step, vols, params)
            loss = draw_and_loss(net, d, vols, shapes, params)
            loss.sum().backward()
            loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            for p in leaves:
                # the JAX package's gradient of an unused parameter (the
                # conv bias before InstanceNorm, the deep-supervision heads)
                # is zero, and AdamW still decays it
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.div_(n_acc)
        opt.step()
        return loss_sum / n_acc

    @torch.no_grad()
    def epoch_fwd(net, draw_source, member, epoch, vols, shapes,
                  params=None):
        """The mean loss of an epoch's steps without an update; members
        side by side as in `epoch_train`."""
        loss_sum = zero_losses(member, params, vols.device)
        for step in range(n_acc):
            d = step_draws(draw_source, member, epoch, step, vols, params)
            loss_sum = loss_sum + draw_and_loss(net, d, vols, shapes, params)
        return loss_sum / n_acc

    @torch.no_grad()
    def eval_step(net, draw_source, member, epoch, rep, vols, shapes,
                  labels, params=None):
        """Centre-patch Dice against the ground truth (tta.py:283-338 of
        the reference), nanmean over the foreground classes.  With
        `params`, the members `member` side by side, each on its own
        patches and noise: each member's Dice, (M,)."""
        members = [member] if params is None else list(member)
        idx = np.concatenate([
            draw_source.eval_volumes(m, epoch, rep, vols.shape[0], B_eval)
            for m in members])
        imgs, labs = extract_batch(idx, None, vols, shapes, patch_size,
                                   len(idx), labels_padded=labels,
                                   fixed=True)
        if modify_input_fn is not None:
            imgs = modify_input_fn(imgs)
        noise = (torch.cat([draw_source.eval_mind_noise(
            m, epoch, rep, (B_eval, *patch_size, MIND_OUT_CHANNELS),
            imgs.device) for m in members])
            if model.needs_mind_noise else None)
        logits = apply(net, imgs, noise, params)
        if modify_output_fn is not None:
            logits = modify_output_fn(logits)
        pred = logits.argmax(dim=-1)
        gt = map_label_argmaxed(labs[..., 0].long(), map_idxs_tta)
        dices = [torch.nanmean(dice_coeff(p, g, n_opt)) for p, g in
                 zip(pred.chunk(len(members)), gt.chunk(len(members)))]
        return dices[0] if params is None else torch.stack(dices)

    n_ep, start_ep = int(plan.epochs), int(plan.start_tta_at_epoch)

    def released_optimizer(net, named):
        """AdamW over the tensors of `named` ((name, tensor) pairs of
        `net`'s parameter names) that the plan releases; each takes a
        gradient where released."""
        mask = params_with_grad_mask(net, plan.params_with_grad)
        released = []
        for name, p in named:
            p.requires_grad_(grads_enabled and mask[name])
            if mask[name]:
                released.append(p)
        return make_optimizer(plan, released)

    def run_epochs(net, opt, draw_source, member, vols, shapes, labels,
                   log_fn, params=None):
        """Every epoch's training or warm-up and evaluation; log_fn(member,
        epoch, loss, dice) after each epoch, for each member in order.
        Returns the per-epoch losses and Dices, (epochs, members) numpy
        arrays (Dice NaN without labels)."""
        members = [member] if params is None else list(member)
        # repeats differ only by the volume draw or the MIND noise; with
        # neither, one evaluation is their mean
        deterministic = vols.shape[0] == 1 and not model.needs_mind_noise
        eval_reps = 1 if deterministic else plan.tta_eval_patches
        losses, dices = [], []
        for ep in range(n_ep):
            if grads_enabled and ep >= start_ep:
                loss = epoch_train(net, opt, draw_source, member, ep, vols,
                                   shapes, params)
            else:
                loss = epoch_fwd(net, draw_source, member, ep, vols, shapes,
                                 params)
            if labels is None:
                dice = [float("nan")] * len(members)
            else:
                dice = torch.stack([
                    eval_step(net, draw_source, member, ep, r, vols, shapes,
                              labels, params)
                    for r in range(eval_reps)]).mean(dim=0).reshape(-1) \
                    .tolist()
            losses.append(loss.reshape(-1).tolist())
            dices.append(dice)
            if log_fn is not None:
                for m, lm, dm in zip(members, losses[-1], dice):
                    log_fn(m, ep, lm, dm)
        return (np.asarray(losses, np.float32).reshape(n_ep, len(members)),
                np.asarray(dices, np.float32).reshape(n_ep, len(members)))

    def member_run(net0, draw_source, member, vols, shapes, labels=None,
                   log_fn=None):
        """One member's adaptation of a copy of `net0`.  Returns the
        adapted network and the per-epoch losses and Dices ((epochs,)
        numpy arrays; Dice NaN without labels).  log_fn(member, epoch,
        loss, dice) runs after every epoch."""
        net = copy.deepcopy(net0)
        opt = released_optimizer(net, net.named_parameters())
        losses, dices = run_epochs(net, opt, draw_source, member, vols,
                                   shapes, labels, log_fn)
        for p in net.parameters():
            p.requires_grad_(True)
        return net, losses[:, 0], dices[:, 0]

    def chunk_run(net0, draw_source, members, vols, shapes, labels=None,
                  log_fn=None):
        """The members `members` of a chunk adapted side by side, each from
        a copy of `net0`'s weights (module docstring).  Returns [(adapted
        network, losses, dices)] in member order, as `member_run` gives
        each; log_fn(member, epoch, loss, dice) runs after every epoch for
        each member in order."""
        members = list(members)
        params = stack_members([net0] * len(members))
        opt = released_optimizer(net0, params.items())
        losses, dices = run_epochs(net0, opt, draw_source, members, vols,
                                   shapes, labels, log_fn, params)
        out = []
        for i in range(len(members)):
            net = copy.deepcopy(net0)
            with torch.no_grad():
                for name, p in net.named_parameters():
                    p.copy_(params[name][i])
            out.append((net, losses[:, i], dices[:, i]))
        return out

    return TTAFunctions(branch_aug=branch_aug, both_branches=both_branches,
                        patch_loss=patch_loss, draw_and_loss=draw_and_loss,
                        epoch_train=epoch_train, epoch_fwd=epoch_fwd,
                        eval_step=eval_step, member_run=member_run,
                        chunk_run=chunk_run, grads_enabled=grads_enabled)


@dataclasses.dataclass(frozen=True)
class _Then:
    first: Callable
    second: Callable

    def __call__(self, x):
        return self.second(self.first(x))


def compose_output_fns(modify_output_fn: Optional[Callable] = None,
                       modify_after_mapping_fn: Optional[Callable] = None):
    """The model-output hook, then the after-mapping hook, as one (the
    reference's hook order: model_utils.py:21-35, then tta.py:566);
    picklable where both are."""
    if modify_after_mapping_fn is None:
        return modify_output_fn
    if modify_output_fn is None:
        return modify_after_mapping_fn
    return _Then(modify_output_fn, modify_after_mapping_fn)


def adapt_chunks(fns: TTAFunctions, net0, draw_source, chunks, vols, shapes,
                 labels=None, log_fn=None, save_member_fn=None,
                 return_nets: bool = True) -> list:
    """Every rank of the process group: the chunks of `member_chunks` in
    turn, each through `sharded_member_run`.  Returns, on rank 0, [(member,
    state_dict, losses, dices)] in chunk order; [] on the other ranks."""
    out = []
    for ids, ranks in chunks:
        out += sharded_member_run(fns, net0, draw_source, ids, vols, shapes,
                                  labels, ranks=ranks, log_fn=log_fn,
                                  save_member_fn=save_member_fn,
                                  return_nets=return_nets) or []
    return out


@dataclasses.dataclass(frozen=True)
class VolumeJob:
    """One volume (or stack of volumes) of a sharded adaptation, picklable:
    `load(device)` -> (bucket-padded volumes, true shapes, labels or None)
    on a rank's device; its `draw_source`; its chunks of members
    (`parallel/tta.member_chunks`); `save_member_fn(member, net, losses,
    dices)`, run in the rank as each of its members finishes, or None."""

    load: Callable
    draw_source: object
    chunks: list
    save_member_fn: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class AdaptJob:
    """What every rank of a sharded adaptation needs, picklable:
    `setup(device)` -> (Model, the pretrained network on `device`, the
    input hook, the output hook); the plan, the label maps and
    `make_tta_functions`' options; the `volumes` (`VolumeJob`) in turn;
    `log_fn(member, epoch, loss, dice)` run in the ranks after each epoch;
    whether rank 0 gets the adapted weights back."""

    setup: Callable
    plan: TTAPlan
    map_idxs_pretrain: np.ndarray
    map_idxs_tta: np.ndarray
    volumes: list
    exact_warp_grad: bool = False
    patch_group: int = 1
    remat: bool = False
    log_fn: Optional[Callable] = None
    return_nets: bool = True


def adapt_rank(rank, ranks, device, job: AdaptJob) -> list:
    """A rank of a sharded adaptation (`parallel/mesh.launch`): sets the
    model up on `device` and adapts its share of each volume's chunks
    (`adapt_chunks`).  Returns, per volume, rank 0's [(member, state_dict
    on the CPU or None, losses, dices)] in chunk order ([] elsewhere)."""
    model, net0, modify_input_fn, modify_output_fn = job.setup(device)
    fns = make_tta_functions(model, job.plan, job.map_idxs_pretrain,
                             job.map_idxs_tta,
                             modify_input_fn=modify_input_fn,
                             modify_output_fn=modify_output_fn,
                             exact_warp_grad=job.exact_warp_grad,
                             patch_group=job.patch_group, remat=job.remat)
    out = []
    for v in job.volumes:
        vols, shapes, labels = v.load(device)
        out.append(adapt_chunks(fns, net0, v.draw_source, v.chunks, vols,
                                shapes, labels, log_fn=job.log_fn,
                                save_member_fn=v.save_member_fn,
                                return_nets=job.return_nets))
        del vols, labels
    return out


def adapt_sharded(job: AdaptJob, ranks: int, device_type: str,
                  backend: Optional[str] = None) -> list:
    """`adapt_rank` over `ranks` new processes (`parallel/mesh.launch`;
    `backend` default "nccl" on CUDA, "gloo" on the CPU); returns rank 0's
    result."""
    return launch(adapt_rank, ranks, device_type,
                  backend or default_backend(device_type), args=(job,))[0]


def _network_from_state(model, state, modify_input_fn, modify_output_fn,
                        device):
    """An `AdaptJob.setup` that ships the network's weights."""
    return (model, model.build_network(state, device), modify_input_fn,
            modify_output_fn)


def _tensors_to(vols, shapes, labels, device):
    """A `VolumeJob.load` that ships the volumes."""
    return (vols.to(device), shapes,
            None if labels is None else labels.to(device))


def tta_one_volume(model: Model, plan: TTAPlan, pretrained_net,
                   vols_padded, true_shapes, map_idxs_pretrain, map_idxs_tta,
                   draw_source, labels_padded=None,
                   modify_input_fn: Optional[Callable] = None,
                   modify_output_fn: Optional[Callable] = None,
                   modify_after_mapping_fn: Optional[Callable] = None,
                   log_fn: Optional[Callable] = None, member_indices=None,
                   save_member_fn: Optional[Callable] = None,
                   exact_warp_grad: bool = False,
                   patch_group: int = 1, remat: bool = False,
                   ensemble_chunk: Optional[int] = None,
                   num_devices: Optional[int] = None,
                   backend: Optional[str] = None):
    """Adapt the ensemble members of one volume (or, with
    tta_across_all_samples, of a stack of volumes) on the volumes' device,
    or spread over devices (module docstring).

    vols_padded: (N, D, H, W, C) bucket-padded volumes; true_shapes: (N, 3)
    true (D, H, W); labels_padded: optional (N, D, H, W, 1).
    member_indices: the global member ids to adapt (default all): a
    member's draws depend on its id only (`draw_source`), so a resume
    subset redraws what the full run would have.  save_member_fn(member,
    net, losses, dices) runs as soon as a member (on one device: a chunk)
    finishes.  exact_warp_grad, patch_group, remat: as in
    `make_tta_functions`.  ensemble_chunk: members per chunk (None: all),
    a chunk on one device side by side; num_devices: the
    devices to spread a chunk over (default: the visible GPUs for CUDA
    volumes, 1 on the CPU); backend: the ranks' `torch.distributed`
    backend (default "nccl" on CUDA, "gloo" on the CPU; "gloo" lets the
    ranks share cards, `parallel/mesh.launch`).  Sharded (`adapt_sharded`,
    as the driver's Phase 1), the ranks get CPU copies of the arguments
    (the modifier functions and `draw_source` must be picklable), and
    `log_fn` and `save_member_fn` run here once every rank has finished,
    in `member_indices` order.

    Returns (adapted networks in member_indices order, losses (epochs, M),
    dices (epochs, M)).
    """
    out_fn = compose_output_fns(modify_output_fn, modify_after_mapping_fn)
    fns = make_tta_functions(model, plan, map_idxs_pretrain, map_idxs_tta,
                             modify_input_fn=modify_input_fn,
                             modify_output_fn=out_fn,
                             exact_warp_grad=exact_warp_grad,
                             patch_group=patch_group, remat=remat)
    members = (list(range(plan.ensemble_count)) if member_indices is None
               else list(member_indices))
    device_type = vols_padded.device.type
    n_dev = (visible_devices(device_type) if num_devices is None
             else int(num_devices))
    chunks = member_chunks(members, ensemble_chunk, n_dev)
    ranks = max((r for _, r in chunks), default=1)
    if ranks == 1:
        nets, losses, dices = [], [], []
        for ids, _ in chunks:
            for m, (net, lm, dm) in zip(ids, fns.run(
                    pretrained_net, draw_source, ids, vols_padded,
                    true_shapes, labels_padded, log_fn)):
                if save_member_fn is not None:
                    save_member_fn(m, net, lm, dm)
                nets.append(net)
                losses.append(lm)
                dices.append(dm)
        return nets, np.stack(losses, axis=1), np.stack(dices, axis=1)

    def cpu(t):
        return None if t is None else t.detach().cpu()

    state = {k: cpu(v) for k, v in pretrained_net.state_dict().items()}
    job = AdaptJob(
        setup=functools.partial(_network_from_state, model, state,
                                modify_input_fn, out_fn),
        plan=plan, map_idxs_pretrain=np.asarray(map_idxs_pretrain),
        map_idxs_tta=np.asarray(map_idxs_tta),
        volumes=[VolumeJob(functools.partial(
            _tensors_to, cpu(vols_padded),
            [list(map(float, s)) for s in np.asarray(true_shapes)],
            cpu(labels_padded)), draw_source, chunks)],
        exact_warp_grad=exact_warp_grad, patch_group=patch_group,
        remat=remat)
    (results,) = adapt_sharded(job, ranks, device_type, backend)
    device = next(pretrained_net.parameters()).device
    nets, losses, dices = [], [], []
    for m, state, lm, dm in results:
        net = model.build_network(state, device)
        if log_fn is not None:
            for ep in range(len(lm)):
                log_fn(m, ep, float(lm[ep]), float(dm[ep]))
        if save_member_fn is not None:
            save_member_fn(m, net, lm, dm)
        nets.append(net)
        losses.append(lm)
        dices.append(dm)
    return nets, np.stack(losses, axis=1), np.stack(dices, axis=1)
