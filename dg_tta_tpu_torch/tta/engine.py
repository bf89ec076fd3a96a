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
contiguous block of members each (`parallel/tta.sharded_member_run`); a
chunk those do not divide, and every chunk on one device, runs its
members one after another.  Side by side on one device, as the JAX
package vmaps a chunk, is not ported: it needs per-member weights in one
conv launch (ROADMAP A.6).
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
from dg_tta_tpu_torch.ops.gin import gin_aug
from dg_tta_tpu_torch.ops.mind import MIND_OUT_CHANNELS
from dg_tta_tpu_torch.parallel.mesh import (default_backend, launch,
                                            visible_devices)
from dg_tta_tpu_torch.parallel.tta import member_chunks, sharded_member_run
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
    grads_enabled: bool


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
    B = plan.batch_size * group
    B_eval = plan.batch_size
    n_acc = plan.patches_to_be_accumulated // group
    map_pre = [int(i) for i in np.asarray(map_idxs_pretrain).tolist()]
    n_opt = len(map_pre)
    grads_enabled = plan.have_grad_in in ("branch_a", "both")
    gin_branches = tuple(
        b for b in ("branch_a", "branch_b")
        if plan.intensity_aug_function == "GIN"
        and _in_branch(plan.do_intensity_aug_in, b))
    mind_shape = (2 * B, *patch_size, MIND_OUT_CHANNELS)

    def patch_draws(draw_source, member, epoch, step, vols):
        return draw_source.patch(member, epoch, step, vols.shape[0],
                                 plan.batch_size, gin_branches=gin_branches,
                                 channels=vols.shape[-1], group=group)

    deformable = plan.spatial_aug_type == "deformable"
    # the deformable fields' interpolation factor (JAX engine.py:281-285)
    # and the noise it takes per branch, (B, D//f, H//f, W//f, 3)
    field_factor = 5
    field_shape = (B, *(s // field_factor for s in patch_size), 3)

    def branch_aug(draws, imgs, branch_id):
        """One branch's input augmentation: GIN where the plan puts it in
        this branch, then the warp; returns the augmented input and what
        undoes the warp, or None: ("affine", theta, theta_inv, adjoint
        scale) or ("grid", grid, grid_inv)."""
        a = branch_id == "branch_a"
        if branch_id in gin_branches:
            imgs = gin_aug(imgs, draws.gin_a if a else draws.gin_b)
        if not _in_branch(plan.do_spatial_aug_in, branch_id):
            return imgs, None
        Bi, Cin = imgs.shape[0], imgs.shape[-1]
        xf = imgs.movedim(-1, 1).reshape(Bi, Cin, -1).contiguous()
        if deformable:
            noise = (draws.field_a if a else draws.field_b)(field_shape,
                                                           imgs.device)
            grid, grid_inv = deformable_grids(
                noise, patch_size, factor=0.5,
                interpolation_factor=field_factor)
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

    def both_branches_once(net, draws, imgs):
        """Both branches through one network forward of batch 2B; returns
        the unwarped channels-first flat (B, n_opt, N) logits of each."""
        xa, ctx_a = branch_aug(draws, imgs, "branch_a")
        xb, ctx_b = branch_aug(draws, imgs, "branch_b")
        x = torch.cat([xa, xb], dim=0)
        if modify_input_fn is not None:
            x = modify_input_fn(x)
        noise = (draws.mind_noise(mind_shape, x.device)
                 if model.needs_mind_noise else None)
        logits = model.apply(net, x, head_channel_idx=map_pre,
                             mind_noise=noise)
        if modify_output_fn is not None:
            logits = modify_output_fn(logits)
        lf = logits.movedim(-1, 1).reshape(2 * B, n_opt, -1).contiguous()
        return (branch_unwarp_flat(lf[:B], ctx_a),
                branch_unwarp_flat(lf[B:], ctx_b))

    def both_branches(net, draws, imgs):
        """`both_branches_once`; with `remat` (and a gradient to take)
        recomputed in the backward."""
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                both_branches_once, net, draws, imgs, use_reentrant=False)
        return both_branches_once(net, draws, imgs)

    def patch_loss(net, draws, imgs):
        la, lb = both_branches(net, draws, imgs)
        return consistency_loss_flat(la, lb, start_class=1)

    def draw_and_loss(net, draws, vols, shapes):
        imgs, _ = extract_batch(draws.vol_idx, draws.uniforms, vols, shapes,
                                patch_size, B)
        return patch_loss(net, draws, imgs)

    def epoch_train(net, opt, draw_source, member, epoch, vols, shapes):
        """n_acc patch steps (of B patches each), their summed gradient
        over n_acc, one AdamW step.  Returns the mean loss (a 0-d
        tensor)."""
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), device=vols.device)
        for step in range(n_acc):
            d = patch_draws(draw_source, member, epoch, step, vols)
            loss = draw_and_loss(net, d, vols, shapes)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            for p in params:
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
    def epoch_fwd(net, draw_source, member, epoch, vols, shapes):
        loss_sum = torch.zeros((), device=vols.device)
        for step in range(n_acc):
            d = patch_draws(draw_source, member, epoch, step, vols)
            loss_sum = loss_sum + draw_and_loss(net, d, vols, shapes)
        return loss_sum / n_acc

    @torch.no_grad()
    def eval_step(net, draw_source, member, epoch, rep, vols, shapes,
                  labels):
        """Centre-patch Dice against the ground truth (tta.py:283-338 of
        the reference), nanmean over the foreground classes."""
        idx = draw_source.eval_volumes(member, epoch, rep, vols.shape[0],
                                       B_eval)
        imgs, labs = extract_batch(idx, None, vols, shapes, patch_size,
                                   B_eval, labels_padded=labels, fixed=True)
        if modify_input_fn is not None:
            imgs = modify_input_fn(imgs)
        noise = (draw_source.eval_mind_noise(
            member, epoch, rep, (B_eval, *patch_size, MIND_OUT_CHANNELS),
            imgs.device) if model.needs_mind_noise else None)
        logits = model.apply(net, imgs, head_channel_idx=map_pre,
                             mind_noise=noise)
        if modify_output_fn is not None:
            logits = modify_output_fn(logits)
        pred = logits.argmax(dim=-1)
        gt = map_label_argmaxed(labs[..., 0].long(), map_idxs_tta)
        return torch.nanmean(dice_coeff(pred, gt, n_opt))

    n_ep, start_ep = int(plan.epochs), int(plan.start_tta_at_epoch)

    def member_run(net0, draw_source, member, vols, shapes, labels=None,
                   log_fn=None):
        """One member's adaptation of a copy of `net0`.  Returns the
        adapted network and the per-epoch losses and Dices ((epochs,)
        numpy arrays; Dice NaN without labels).  log_fn(member, epoch,
        loss, dice) runs after every epoch."""
        net = copy.deepcopy(net0)
        mask = params_with_grad_mask(net, plan.params_with_grad)
        released = []
        for name, p in net.named_parameters():
            p.requires_grad_(grads_enabled and mask[name])
            if mask[name]:
                released.append(p)
        opt = make_optimizer(plan, released)
        # repeats differ only by the volume draw or the MIND noise; with
        # neither, one evaluation is their mean
        deterministic = vols.shape[0] == 1 and not model.needs_mind_noise
        eval_reps = 1 if deterministic else plan.tta_eval_patches
        losses, dices = [], []
        for ep in range(n_ep):
            if grads_enabled and ep >= start_ep:
                loss = epoch_train(net, opt, draw_source, member, ep, vols,
                                   shapes)
            else:
                loss = epoch_fwd(net, draw_source, member, ep, vols, shapes)
            if labels is None:
                dice = float("nan")
            else:
                dice = float(torch.stack([
                    eval_step(net, draw_source, member, ep, r, vols, shapes,
                              labels) for r in range(eval_reps)]).mean())
            losses.append(float(loss))
            dices.append(dice)
            if log_fn is not None:
                log_fn(member, ep, losses[-1], dice)
        for p in net.parameters():
            p.requires_grad_(True)
        return (net, np.asarray(losses, np.float32),
                np.asarray(dices, np.float32))

    return TTAFunctions(branch_aug=branch_aug, both_branches=both_branches,
                        patch_loss=patch_loss, draw_and_loss=draw_and_loss,
                        epoch_train=epoch_train, epoch_fwd=epoch_fwd,
                        eval_step=eval_step, member_run=member_run,
                        grads_enabled=grads_enabled)


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
    net, losses, dices) runs as soon as a member finishes.
    exact_warp_grad, patch_group, remat: as in `make_tta_functions`.
    ensemble_chunk: members per chunk (None: all); num_devices: the
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
        for m in members:
            net, lm, dm = fns.member_run(pretrained_net, draw_source, m,
                                         vols_padded, true_shapes,
                                         labels_padded, log_fn)
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
