"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device: requires `torch.cuda.is_available()`; prints the card's name and
   power limit as `nvidia-smi` reports them;
2. build: compiles every CUDA kernel of the main path from the checkout's
   sources (`conv3x3`, `conv3x3_wgrad`, `warp`, `conv3x3_wgmma`,
   `conv3x3_wgrad_wgmma`, `conv3x3_c1`, `conv3x3_few`: one `nvcc` per
   source, all started together), and asserts that the SASS of the wgmma
   kernels (bf16 and f32 3xTF32 instantiations of `conv3x3_wgmma`; the
   weight gradient's `wgrad_tf32x3_kernel` (f32, 32 and 64 columns),
   `wgrad_bf16_zfirst_kernel` and `wgrad_bf16_desc_kernel` in
   `conv3x3_wgrad_wgmma`) holds tensor-core (`HGMMA`) and TMA (`UTMALDG`)
   instructions, `conv3x3_wgmma`'s and the z-first kernel's also the
   ldmatrix (`LDSM`) that reads their A fragments from the staged halo;
   prints any wgmma that ptxas serialized (C7513, C7511, C7512), and
   fails if it serialized one of `conv3x3_wgrad_wgmma` for a running
   group's registers (C7513, C7511); that of `conv3x3_few`'s four kernels
   (forward and weight gradient, bf16 and f32) `HGMMA`, their ring of
   staged planes filled by cp.async (`LDGSTS`) and, but for the bf16
   weight gradient (both operands by descriptor), their A fragments
   loaded by ldmatrix (`LDSM`), and fails if ptxas serialized any of
   their wgmmas (C7513, C7511, C7512), and that of
   `conv3x3_c1`'s four (the C = 1 forward and weight gradient, bf16 and
   f32 3xTF32) tensor-core `HMMA` (mma.sync), the weight gradients' dy
   loads cp.async (`LDGSTS`), and that of the warp's affine-entry kernels
   cp.async (`LDGSTS`) and shared-memory gathers (`LDS`), and that of the
   exact adjoint's kernels shared-memory atomics (`ATOMS`) and 16-byte
   global reductions (`REDG.E.ADD.F32x4`), and that of the catch-all
   kernels (`conv3x3`, `conv3x3_wgrad`: both types) tensor-core
   instructions (the forward `HGMMA`: wgmma; the weight gradient `HMMA`:
   mma.sync), their rings filled by cp.async (`LDGSTS`) and, but for the
   f32 weight gradient (32-bit loads), their fragments read by ldmatrix
   (`LDSM`);
   prints their ptxas notes (registers and spills per instantiation, the
   warpgroup.arrives injected, C7519) and fails on any wgmma serialized
   there (C7510-C7515);
3. kernels: holds each kernel against its plain version on the card at the
   main path's shapes, and times the kernel, the plain version and one
   PyTorch library call of the same function (a yardstick only; the port
   never calls it), with TF32 off for the plain versions and the library
   calls only (`tf32_off`: the flags are restored after each):
   * `conv3x3` at every shape the main path launches it at, f32 and bf16
     (library: `F.conv3d`): each stride-1 conv of a TS104 window forward
     (one volume), and of a trained TTA step (two volumes, both branches),
     forward and input gradient (the same kernel on dy with flipped,
     channel-swapped weights); each shape prints its route
     (`conv3x3_route`: "c1" for the C = 1 first conv, "wgmma" for bf16,
     "wgmma_tf32x3" for f32); the shapes of the "c1" and "wgmma_tf32x3"
     routes also run on the CUDA-core kernel they took before
     (`route="cuda_core"`, marked "forced"), and so do the "wgmma"
     (bf16) shapes, so both are timed in one call; each bound is the
     larger of the bytes floor and the operations floor on the tensor
     cores, where every route computes (`_ops_ms`: bf16 at its rate, f32
     as three tf32 products), the catch-all's shapes printing the CUDA
     cores' f32 floor beside it (`cuda_core_floor_ms`), and the "c1"
     shapes print both floors; the wgmma and catch-all shapes also print
     their device time (`device_ms`: a CUDA graph of the calls, no host
     work between them); the ragged net's shapes on the catch-all route
     (`_ragged_cases`: `RAGGED_FEATURES`, widths 30 .. 300, a window
     forward, a trained step's forward and input gradients), a second
     launch at its step forward bit for bit the first;
     and the stem conv of a MIND model (12 -> 32 channels, route "few")
     at its window forward and its step forward, also forced onto the
     type's wgmma route (zero-padded to 16 channels: the route it took
     before) and the CUDA-core kernel, its bound counting the true C = 12
     work, and a second launch at the step shape bit for bit the first;
   * `conv3x3_wgrad` at the same shapes with the batch of a TTA step (two
     patches: both branches), f32 and bf16 (library: cuDNN's weight
     gradient, `torch.nn.grad.conv3d_weight`), with its route ("c1",
     "wgmma" for bf16, "wgmma_tf32x3" for f32), the C = 1 and f32 shapes
     also forced onto the CUDA-core kernel, and the f32 routes' per-step
     totals on the same shapes side by side; the MIND stem's shape too, on
     "few", forced onto the padded wgmma route and the CUDA-core kernel;
     the ragged net's shapes on the catch-all route; at the top level (the
     first shape with C > 1), at the stem and at the ragged net's shapes
     two launches of each type are held equal bit for bit (a fixed
     summation order, no atomics);
   * `warp` at its four call sites of adaptation, f32 and bf16: the C=1
     border warp of the input, the C=n_opt zeros unwarp of the logits and
     its adjoint (112 x 112 x 128, times 1 / |det|), and the nearest label
     sampling of a 224 x 224 x 256 label volume onto the patch, through
     both entries: `warp_affine_flat` (the main path's: the points built
     from theta in the kernel), held bit for bit to `warp_flat` on the
     card's `affine_grid`, and `warp_flat` on that precomputed grid; each
     timed eagerly (CUDA events around back-to-back calls, which measure
     the host where it is slower), on the device alone (the calls replayed
     from a CUDA graph) and, for the affine entry, in host microseconds
     per call (library: `F.grid_sample` on a precomputed grid, and
     `F.affine_grid` + `F.grid_sample`), with its share of the bound; the
     bricks of each call counted by path (`brick_paths`: the source box
     staged in shared memory, or gathered from device memory; the grid
     entry stages none) and held to `warp_brick_paths`' prediction;
   * `warp`'s grid entry at a deformable branch's sites
     (`phase_warp_deformable`): the field warps (C = 3, f32,
     align_corners=True, border and zeros, on identity plus a full-size
     field from `get_disp_field`), the input warp, the unwarp and its fast
     adjoint (f32 and bf16), each against its plain version, its blocks
     counted by path as above, and timed eagerly and on the device against
     `F.grid_sample`; and the exact
     adjoint (f32 and bf16) at the logit site: its affine entry
     (`warp_affine_flat_adjoint`) at an inverse affine, its grid entry
     (`warp_flat_adjoint`) on that affine's grid and on a deformable
     branch's inverse grid, each against its plain version (twice: its
     atomics sum in a varying order, and the two runs' difference is
     printed), its bricks counted by path (each brick's scatter summed in
     shared memory, or added into device memory) and held to
     `warp_brick_paths`, and timed against autograd of `F.grid_sample`
     with respect to its input;
   * `warp` at the sites of a DG pretraining step
     (`phase_warp_pretrain`, f32, batch 2 at the patch): the
     augmentation's image (trilinear, border) and labels (nearest, zeros)
     on the affine entry, its continuous low-resolution simulation
     (trilinear, border) and the deep-supervision targets at 1/2 and 1/4
     (nearest, border: every sample on a rounding tie) on the grid entry,
     each against its plain version (nearest bit for bit) and timed
     against it and `F.grid_sample`;
   * the kernels at the grouped main-path runs' shapes
     (`phase_grouped_kernels`, `GROUPED_RUNS`): `conv3x3`'s forward and
     input gradient and `conv3x3_wgrad` at every stride-1 conv of a
     trained step of 2 x 4 patches (f32) and 2 x 2 (bf16), among them
     the f32 top level's weight gradient over 100352 dy rows (past grid
     z's 65535: the tf32x3 pre-pass's row loop), and the warp's affine
     entry at the three patch sites with 4 (f32) and 2 (bf16) patches a
     branch, a theta each; each against its plain version at the
     tolerance of its ungrouped check, its max abs error going into the
     kernels line's row;
   * the conv kernels with CHUNK ensemble members' weights in one launch
     (`phase_member_chunk_kernels`): every route ("c1", "few", "wgmma",
     "wgmma_tf32x3") at every stride-1 TS104 shape and the MIND stem's,
     forward, input gradient and weight gradient, f32 and bf16, at a
     chunk's trained step (2 volumes a member), each launch held bit for
     bit to the members' own launches and to the plain version at the
     ungrouped checks' tolerances, its ms beside theirs;
4. reference, under PyTorch's default precision flags (asserted), as a
   user's run finds them: the full-width TS104_GIN U-Net on a small patch,
   its forward and one step's gradient, a stride-2 stage-entry conv
   forward and backward (cuDNN, which the port runs with TF32 off), and
   `predict_volume`, the conv's autograd backward, one adaptation patch
   step's gradient and a short `tta_one_volume` (injected draws, 1 member,
   3 epochs x 2 patches, two of them trained), `mind3d` on two
   112 x 112 x 128 patches and `gin_aug` on one (injected noise and
   draws; GIN's grouped conv in cuDNN, where TF32 is on by default), and
   the full-width TS104_GIN_MIND net's forward and one step's gradient on
   a small patch, a deformable branch's displacement fields at the patch
   size from one noise tensor, and one deformable trained step's gradient
   of the full-width TS104_GIN net on a small patch, each on the card
   against the same code on the CPU (plain versions); and one DG
   pretraining step of the full-width TS104_GIN_MIND net on a small patch
   (every augmentation gate on, GIN, MIND, deep supervision, SGD) and
   MultiRes's operators at the patch size with matmul TF32 turned on
   around the call (`reference_pretrain`); and the patch step and short
   `tta_one_volume` again on the ragged net (`RAGGED_FEATURES`);
5. remat (`phase_remat`): one trained step of the full-width TS104_GIN
   net at the TS104 patch in f32, with and without `remat` (both branches
   recomputed in the backward), on the same weights and draws: the
   gradients held to each other (REMAT_GRAD_RTOL), each step's launches
   to `expected_launches` (the recompute launches every forward kernel
   again), and each variant's ms and peak device memory; then one
   member's adaptation run twice in this process (`phase_repeat`:
   TS104_GIN f32 at the smoke plan, the same weights and draws), printing
   how far the second run's losses and updates lie from the first's (a
   trace of the several-rank gap, ROADMAP C; it asserts nothing); then
   the catch-all route's main path (`phase_ragged_tta`): the full-width
   ragged net adapted by `tta_one_volume` (the smoke plan, 3 members) in
   f32 one member at a time, bf16 one at a time and bf16 with CHUNK side
   by side, each run's launches held to `expected_launches` (the
   catch-all's above 0), its losses finite, the chunk's members held to
   the serial bf16 run's at CHUNK_LOSS_RTOL / CHUNK_UPDATE_RTOL;
6. DG pretraining (`phase_pretrain`, configs 4-5), f32: `run_pretraining`
   on three synthetic 128 x 128 x 144 CTs at 1.5 mm with a 105-label
   `dataset.json` (`obs/synthetic.make_pretrain_dataset`) at the full
   TS104 width (patch 112 x 112 x 128, batch 2), nnUNetTrainer_GIN_MIND
   for 2 epochs x 4 iterations, nnUNetTrainer_GIN_MultiRes for 1 x 2 (the
   `c1` stem, the discrete low-resolution simulation), then the first
   resumed for a third epoch, each with 2 validation batches an epoch;
   checks every run's launches against `expected_pretrain_launches` (0
   `cuda_core`, so no input-gradient conv for the stem; the warp's entries
   as the augmentation and the deep supervision predict), a finite loss
   per logged epoch, and `checkpoint_final.npz` read back by the port's
   `run_tta` bundle loader; then profiles two steps (ms per step, device
   busy share, kernels per step, peak memory);
7. main path, eleven times, each in a fresh workspace and under the
   default flags, f32 (the default), then bf16
   (`DGTTA_COMPUTE_DTYPE=bfloat16`), for each of two seeded full-width
   checkpoints (105 classes): TS104_GIN, then TS104_GIN_MIND (12 input
   channels: MIND in every forward, with noise; the plan also puts GIN in
   both branches); then TS104_GIN in f32 with `DGTTA_EXACT_WARP_GRAD=1`
   (the exact adjoint's affine entry); then TS104_GIN with a deformable
   plan (`spatial_aug_type: "deformable"`), in f32 with the fast adjoint
   and in bf16 with `DGTTA_EXACT_WARP_GRAD=1`; then TS104_GIN with the
   plan's `patch_group` at 4 in f32 (the 4 patches of an epoch in one step
   of 8 patches through the network) and at 2 in bf16, each run's epoch-0
   member losses (a forward-only epoch on the same weights and, by
   `TorchDraws`' grouped draws, the same patches) held to the ungrouped
   TS104_GIN run of its type (GROUPED_LOSS_RTOL); then TS104_GIN with the
   plan's `ensemble_chunk` at CHUNK (the three members side by side) in
   f32 and bf16, each held to the serial TS104_GIN run of its type
   (`check_member_chunk`: every conv route's adaptation launches a
   CHUNKth of the serial run's, the members' losses at CHUNK_LOSS_RTOL
   and updates at CHUNK_UPDATE_RTOL, the gaps printed beside
   `phase_repeat`'s):
   `prepare_tta` and `run_tta` through the port's CLI on a synthetic CT
   volume of 224 x 224 x 256 voxels at 1.5 mm (27 windows), with no member
   files: `run_tta` adapts three members (Phase 1), then predicts and
   evaluates.  The plan is the default cut in depth only: epochs=2,
   patches_to_be_accumulated=4, start_tta_at_epoch=1 (one warm-up and one
   trained epoch).  Checks the member files and the segmentation, that
   every kernel launched exactly as often as the plan says it must, on
   each route and on padded channels (`expected_launches`: a grouped
   run's launches per patch draw fall by its group), that the
   CUDA-core `conv3x3` and `conv3x3_wgrad` launched not at all, that no
   launch ran on padded channels (a MIND model's stem runs on "few"), and
   that
   the warp's grid entry and the exact adjoint's two entries launched
   where the plan and the flag put them (the affine runs: no grid entry,
   the exact one the adjoint's affine entry only);
8. several processes (`phase_parallel`, `parallel/`), sharing this one
   card over gloo: `run_tta` of the TS104_GIN f32 smoke plan with Phase
   1 over 3 ranks (`--num_devices 3 --backend gloo`, a member each), its
   launches this process's and the ranks' summed (`DGTTA_RANK_STATS_DIR`)
   and held to `expected_launches`, its epoch-0 member losses to the
   serial run's; one data-parallel pretraining step of the full-width
   TS104_GIN_MIND net over 2 ranks x batch 1 against the one-process step
   at batch 2; window-sharded `predict_volume` over 2 ranks against the
   unsharded call; and a one-rank NCCL group with an all-reduce.

It prints one JSON line with the kernels' numbers (f32, with bf16 fields
beside them where a kernel serves both types; the catch-all rows
(`conv3x3`, `conv3x3_wgrad`, route "cuda_core") at the ragged net's
shapes, their launches the ragged TTA runs', with the TS104 shapes forced
onto them and the CUDA cores' floor beside them; the
"c1" rows with their operations and bytes floors and their shapes' times
and bounds on the CUDA-core kernels (forced); the
MIND stem's rows on "few" with the forced padded-route and CUDA-core
times beside them; the warp's
grid entry per deformable branch of a trained step, the exact adjoint's
grid entry on a deformable grid and its affine entry; each row's launches
count the main-path runs, `phase_parallel`'s ranks included; the conv
rows' `member_chunk_launches` those of the chunk runs alone) and, last,
one JSON line naming the device.  Before them it logs each phase's wall
seconds as it ends and, in one line, all of them ("seconds per phase").
"""

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# TS104 window forward (patch 112 x 112 x 128): every stride-1 3x3x3 conv as
# (depth, H, W, C, CO, convs of this shape per forward).
TS104_CONV_SHAPES = [
    (112, 112, 128, 1, 32, 1),
    (112, 112, 128, 32, 32, 2),
    (112, 112, 128, 64, 32, 1),
    (56, 56, 64, 64, 64, 2),
    (56, 56, 64, 128, 64, 1),
    (28, 28, 32, 128, 128, 2),
    (28, 28, 32, 256, 128, 1),
    (14, 14, 16, 256, 256, 2),
    (14, 14, 16, 512, 256, 1),
    (7, 7, 8, 320, 320, 1),
]
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores
# (the CUDA cores), bf16 on the tensor cores, HBM3 bandwidth.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# The f32 tensor-core routes ("wgmma_tf32x3", "few", "c1") do three tf32
# products per f32 product (495 TFLOP/s dense): their bound is 3 x ops /
# 495e12 s.
PEAK_TF32 = 495e12
# Kernel vs plain version, max |diff| / max |plain|: both sum the same
# products in f32 in another order (f32), and both round that sum to bf16
# once, so they may differ by the last bit at the largest magnitude (bf16).
KERNEL_RTOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}
# wgrad kernel vs plain (f32 out), max |diff| / max |plain|: sums over up to
# 3.2M positions, split across blocks, in another order than cuDNN's.
WGRAD_RTOL = 1e-4
# warp kernel vs plain, max |diff| / max |plain|: trilinear f32 sums eight
# products with fused multiply-adds (f32), both round one f32 sum to bf16
# (bf16); nearest is exact.
WARP_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# Network on the card vs on the CPU (plain versions), f32, max |diff| over
# max |CPU|: summation order only, compounded over the layers.
REF_RTOL = 1e-4
# One step's gradient of that network on a 32 x 48 x 64 patch, card vs CPU
# (f32), |diff| / |CPU| over all parameters at once: InstanceNorm over the
# few voxels of the deepest stages amplifies f32 rounding, so the CPU's own
# f32 gradient lies 2.8e-3 from its float64 gradient (measured on the CPU),
# while TF32 in the stride-2 convs' forward alone moves it by 8e-2.
GRAD_RTOL = 2e-2
N_CLASSES = 105
VOLUME_SHAPE = (224, 224, 256)
PATCH = (112, 112, 128)
N_OPT = 4          # background + the 3 labels of the synthetic target
# The main path's plan, cut in depth only (module docstring).
SMOKE_PLAN = dict(epochs=2, patches_to_be_accumulated=4,
                  start_tta_at_epoch=1)
# MIND and GIN on the card vs the CPU, max |diff| / max |CPU|: channel and
# batch means summed in another order, then exp (MIND); four grouped convs
# in cuDNN, with TF32 off, a blend and a renormalization (GIN; TF32 would
# miss by ~1e-3).
MIND_RTOL = GIN_RTOL = 1e-5
# The stem conv of a MIND model, 12 descriptor channels -> 32: (depth, H, W,
# C, CO) at the TS104 patch; route "few" (the wgmma routes, forced, run it
# zero-padded to 16).
STEM_SHAPE = (112, 112, 128, 12, 32)
# The warp's exact adjoint vs its plain version, max |diff| / max |plain|:
# the same products added into each source voxel by shared-memory and
# device-memory atomics, in an order that varies from run to run (f32); one
# rounding of the f32 sum (bf16).
ADJOINT_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# A deformable branch's displacement fields at the patch size, card vs CPU,
# max |diff| / max |CPU|: ten warps and the smoothing summed in another
# order, amplified ~100x by the field's normalization (its std after the
# smoothing is ~1e-2; tests/test_torch_fields.py holds the CPU to the JAX
# package at the same bound).
FIELD_RTOL = 1e-4
# DG pretraining (`phase_pretrain`): run_pretraining of
# nnUNetTrainer_GIN_MIND (config 5) for PRETRAIN_EPOCHS epochs of
# PRETRAIN_ITERS iterations and PRETRAIN_VAL_ITERS validation batches, then
# nnUNetTrainer_GIN_MultiRes (the C = 1 stem, the discrete low-resolution
# simulation) for one epoch of PRETRAIN_MULTIRES_ITERS, then the first run
# resumed (`continue_training`) for one more epoch; the nnUNet defaults
# are 250 and 50 a epoch, cut in depth only.
PRETRAIN_EPOCHS = 2
PRETRAIN_ITERS = 4
PRETRAIN_MULTIRES_ITERS = 2
PRETRAIN_VAL_ITERS = 2
# One pretraining step of the full-width TS104_GIN_MIND net on a small
# patch, card vs CPU: the loss, |diff| / |CPU| (summation order through the
# net, as REF_RTOL); the step's update (new - old weights) over all
# parameters at once at GRAD_RTOL of its norm (SGD's first update is the
# gradient times -lr (1 + momentum), so the gradient's bound holds).
PRETRAIN_LOSS_RTOL = 1e-4
# MultiRes's per-axis operators at the patch size, card vs CPU, max |diff|
# / max |CPU|: three f32 products of 112-128 terms summed in another order;
# TF32 (~1e-3) would miss it.
MULTIRES_RTOL = 1e-5
# The grouped main-path runs' epoch-0 member losses (a forward-only epoch,
# the same weights and, by `TorchDraws`' grouped draws, the same patches)
# against the ungrouped run of the same type, |diff| / |ungrouped|: the
# stride-1 convs compute each plane as at any batch, but cuDNN's stride-2
# convs may pick another algorithm at another batch and the loss's means
# sum in another order (f32: a few roundings of 1e-7; bf16: one bf16
# rounding of some activations, 2^-8, averaged over 1.6M voxels).
GROUPED_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
# One full-width f32 trained step with and without `remat`, |g_remat - g| /
# |g| over all parameters at once: the recompute runs the same kernels on
# the same inputs (bit for bit equal on the CPU,
# tests/test_torch_patch_group.py), but cuDNN's stride-2 gradients may sum
# in a varying order, and the consistency loss's cancelling gradient
# amplifies that f32 rounding.
REMAT_GRAD_RTOL = 1e-3
# The grouped main-path runs, (type, patch_group): the smoke plan's 4
# patches in one step of 4 (f32: the top level's weight gradient has
# 2 x 4 x 112 planes x 112 rows = 100352 dy rows, past grid z's 65535)
# and in two steps of 2 (bf16).
GROUPED_RUNS = (("float32", 4), ("bfloat16", 2))
# phase_parallel: the ranks of its run_tta (one member each, sharing the
# card), and its tolerances against the serial run: the epoch-0 member
# losses (a warm-up epoch: the same forwards in another process) at
# PARALLEL_LOSS_RTOL, the later ones at PARALLEL_LATER_RTOL and each
# parameter's update (adapted - pretrained) at PARALLEL_UPDATE_RTOL of its
# norm (the dry run's card tolerances, `parallel/dryrun.CARD_TOL`: AdamW
# steps ~lr x sign(gradient), so a gradient summed in another order flips
# the entries near zero); the data-parallel step's and the data-parallel
# run_pretraining's logged losses, their updates of all parameters
# together (of its norm) and each parameter's difference per entry (of
# the update's RMS: `parallel/dryrun.update_errors`), at DP_STEP_RTOL
# against the one-process run's (sums over the batch in another order)
PARALLEL_RANKS = 3
PARALLEL_LOSS_RTOL = 1e-4
PARALLEL_LATER_RTOL = 1e-2
PARALLEL_UPDATE_RTOL = 0.3
DP_STEP_RTOL = 1e-3
DP_LEAF_RTOL = 5e-2
# the data-parallel run_pretraining: 2 ranks x batch 1
DP_RANKS = 2
# The members side by side (`ensemble_chunk`, `phase_member_chunk_kernels`
# and the chunk runs of the main path), and the chunk runs' tolerances
# against the serial run of the same type, fixed before the first card
# run: the members' epoch losses, |diff| / |serial|, and each member's
# update (adapted - pretrained) over all its parameters at once, of its
# norm.  The convs compute each member's planes bit for bit as its own
# launch does, and the operations that sum over a member's positions
# (InstanceNorm, the transposed convs, the heads, the loss) run per member;
# what may still differ is what differs between two serial runs
# (`phase_repeat`: cuDNN's stride-2 backward), which AdamW's first step
# turns into whole sign steps where a gradient is near zero.
CHUNK = 3
CHUNK_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
CHUNK_UPDATE_RTOL = {"float32": 1e-3, "bfloat16": 1e-2}
# The ragged net: TS104_3D_FULLRES with UNet_base_num_features 30 and
# unet_max_num_features 300 (widths 30, 60, 120, 240, 300; PERF.md §4): no
# published checkpoint has these widths, a plan a user can write, and the
# shape set that runs the catch-all conv route ("cuda_core") at full width
# (output channels that are no multiple of 8).  Its TTA runs
# (`phase_ragged_tta`): the smoke plan, 3 members, f32 one at a time, bf16
# one at a time and CHUNK side by side.
RAGGED_FEATURES = (30, 300)
RAGGED_RUNS = (("float32", 1), ("bfloat16", 1), ("bfloat16", CHUNK))
# every CUDA source of the main path (dg_tta_tpu_torch/kernels/csrc)
SOURCES = ["conv3x3", "conv3x3_wgrad", "warp", "conv3x3_wgmma",
           "conv3x3_wgrad_wgmma", "conv3x3_c1", "conv3x3_few"]


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def tf32_off():
    """TF32 off in cuDNN and matmuls for the plain versions and the library
    yardsticks (full f32, as the CPU computes), restored afterwards: the
    main path runs under PyTorch's defaults, as a user's run does."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    from dg_tta_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            # ptxas's register and spill report, and its notes on wgmma
            # (C75xx: serialized, or fenced for registers)
            if any(k in line for k in ("registers", "spill", "wgmma",
                                       "C75")):
                log(f"  {name}: {line.strip()}")
    # the wgmma routes run on the tensor cores, fed by TMA: the bf16 and
    # the f32 (3xTF32) instantiations of conv3x3_wgmma (their A fragments
    # read from the staged halo by ldmatrix, LDSM), and the weight
    # gradient's kernels (conv3x3_wgrad_wgmma: f32 at 32 and 64 columns,
    # A hand-loaded; bf16 z-first, A by ldmatrix; bf16 by descriptor),
    # whose wgmmas ptxas must not serialize for a running group's
    # registers (C7513, C7511); the "few" route's four kernels on the
    # tensor cores, their rings of staged planes filled by cp.async
    # (LDGSTS), A by ldmatrix (LDSM) but in the bf16 weight gradient, and
    # no wgmma of theirs serialized (C7513, C7511, C7512); the
    # "c1" route's four by mma.sync (HMMA), the weight gradients' dy by
    # cp.async; the warp's affine entry stages its boxes by cp.async and
    # gathers from shared memory (LDS); the exact adjoint sums in shared
    # memory (ATOMS: compare-and-swap loops) and flushes by 16-byte global
    # reductions
    tma, cp_async = ("HGMMA", "UTMALDG"), ("HGMMA", "LDGSTS")
    ring = ("HGMMA", "LDGSTS", "LDSM")
    halo = ("HGMMA", "UTMALDG", "LDSM")
    hmma, hmma_cp = ("HMMA",), ("HMMA", "LDGSTS")
    hmma_ring = ("HMMA", "LDGSTS", "LDSM")
    for name, marker, ops in (
            ("conv3x3", "conv3x3_kernelI13__nv_bfloat16", ring),
            ("conv3x3", "conv3x3_kernelIf", ring),
            ("conv3x3_wgrad", "wgrad_kernelI13__nv_bfloat16", hmma_ring),
            ("conv3x3_wgrad", "wgrad_kernelIf", hmma_cp),
            ("conv3x3_wgmma", "conv3x3_wgmma_kernelI13__nv_", halo),
            ("conv3x3_wgmma", "conv3x3_wgmma_kernelIf", halo),
            ("conv3x3_wgrad_wgmma", "wgrad_tf32x3_kernel", tma),
            ("conv3x3_wgrad_wgmma", "wgrad_bf16_zfirst_kernel", halo),
            ("conv3x3_wgrad_wgmma", "wgrad_bf16_desc_kernel", tma),
            ("conv3x3_few", "few_forward_bf16_kernel", ring),
            ("conv3x3_few", "few_forward_f32_kernel", ring),
            ("conv3x3_few", "few_wgrad_bf16_kernel", cp_async),
            ("conv3x3_few", "few_wgrad_f32_kernel", ring),
            ("conv3x3_c1", "c1_forward_kernelI13__nv_bfloat16", hmma),
            ("conv3x3_c1", "c1_forward_kernelIf", hmma),
            ("conv3x3_c1", "c1_wgrad_kernelI13__nv_bfloat16", hmma_cp),
            ("conv3x3_c1", "c1_wgrad_kernelIf", hmma_cp),
            ("warp", "warp_brick_kernel", ("LDGSTS", "LDS")),
            ("warp", "adjoint_brick_kernel", ("ATOMS", "REDG.E.ADD.F32x4"))):
        funcs = [f for f in build.sass(name).split("Function : ")[1:]
                 if marker in f.split("\n", 1)[0]]
        counts = {op: sum(f.count(op) for f in funcs) for op in ops}
        if not funcs or not all(counts.values()):
            raise AssertionError(f"{name} {marker}: {len(funcs)} functions, "
                                 f"SASS instruction counts {counts}")
        log(f"  {name} {marker}: {len(funcs)} instantiations, SASS {counts}")
    # the catch-all kernels: registers and spills per instantiation; no
    # wgmma serialized (C7510-C7515) in the forward, none in the weight
    # gradient (mma.sync); the warpgroup.arrives ptxas injected for
    # registers (C7519), counted
    for name in ("conv3x3", "conv3x3_wgrad"):
        text = build.library_path(name).with_suffix(".log").read_text()
        notes = [line.strip() for line in text.splitlines()
                 if any(f"C75{c}" in line for c in
                        ("10", "11", "12", "13", "14", "15"))]
        if notes:
            raise AssertionError(f"{name}: ptxas serialized wgmmas: "
                                 + "; ".join(notes))
        arrives = sum("C7519" in line for line in text.splitlines())
        notes = _ptxas_notes(text)
        log(f"  {name}: ptxas, {len(notes)} kernels, no wgmma serialized "
            f"(C7510-C7515), {arrives} warpgroup.arrive injected (C7519): "
            + "; ".join(f"{k} {r} registers, spill {st}/{ld} bytes "
                        f"stored/loaded" for k, r, st, ld in notes))
    for name, codes in (("conv3x3_wgrad_wgmma", ("C7513", "C7511")),
                        ("conv3x3_few", ("C7513", "C7511", "C7512"))):
        text = build.library_path(name).with_suffix(".log").read_text()
        serialized = [line.strip() for line in text.splitlines()
                      if any(c in line for c in codes)]
        if serialized:
            raise AssertionError(f"{name}: ptxas serialized wgmmas: "
                                 + "; ".join(serialized))
        log(f"  {name}: no wgmma serialized ({', '.join(codes)})")
        if name == "conv3x3_few":
            # the wgmmas before which ptxas injected a warpgroup.arrive
            # for their registers (C7519), per kernel
            fenced = {k: sum("C7519" in line and k in line
                             for line in text.splitlines())
                      for k in ("few_forward_bf16_kernel",
                                "few_forward_f32_kernel",
                                "few_wgrad_bf16_kernel",
                                "few_wgrad_f32_kernel")}
            log(f"  {name}: warpgroup.arrive injected (C7519): {fenced}")


def _ptxas_notes(text, kernels=("conv3x3_kernel", "wgrad_kernel",
                                 "sum_splits_kernel", "pack_kernel")):
    """[(kernel, registers, spill stores, spill loads)] of a ptxas -v log,
    each of `kernels` named with its template arguments
    (`conv3x3_kernel<bf16, 64, 16>`)."""
    import re

    out, name, spill = [], "?", (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), m.group(1))
            rest = m.group(1).split(name, 1)[-1]
            targs = (["bf16"] if rest.startswith("I13__nv_bfloat16") else
                     ["f32"] if rest.startswith("If") else [])
            name += f"<{', '.join(targs + re.findall(r'Li(\d+)E', rest))}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), *spill))
    return out


def _record(tot, err, k_ms, p_ms, l_ms, ops_ms, bytes_ms, mult=1):
    for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                   ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
        tot[key] += mult * v
    tot["max_abs_err"] = max(tot["max_abs_err"], err)


def _new_totals():
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0,
                bytes_ms=0.0, max_abs_err=0.0)


def _log_routes(kernel, per, totals):
    for key, t in sorted(totals.items()):
        if "/" in key:
            log(f"{kernel} {key} per {per}: kernel_ms={t['ms']:.3f} "
                f"plain_ms={t['plain_ms']:.3f} "
                f"library_ms={t['library_ms']:.3f} "
                f"bound_ms={max(t['ops_ms'], t['bytes_ms']):.3f}")


def _conv_cases():
    """Every conv3x3 launch shape of the main path, as (use, volumes,
    depth, H, W, C, CO, launches of this shape per use, dgrad?): a window
    forward of inference and eval (one volume), and a trained step's
    forward and input gradient (two volumes: both branches).  The input
    gradient runs dy through the kernel with the weights flipped and their
    channels swapped; the first conv, on the image, takes none."""
    cases = [("window forward", 1, *s, False) for s in TS104_CONV_SHAPES]
    cases += [("step forward", 2, *s, False) for s in TS104_CONV_SHAPES]
    cases += [("step dgrad", 2, depth, H, W, CO, C, mult, True)
              for depth, H, W, C, CO, mult in TS104_CONV_SHAPES if C > 1]
    return cases


def _stem_cases():
    """The MIND stem's conv3x3 shapes, as `_conv_cases`: its window
    forward and its trained step's forward (no input gradient: MIND's
    output needs none); route "few"."""
    return [("stem window forward", 1, *STEM_SHAPE, 1, False),
            ("stem step forward", 2, *STEM_SHAPE, 1, False)]


def _ragged_shapes():
    """The ragged net's stride-1 convs on the catch-all route, as
    (depth, H, W, C, CO, convs per forward, input gradient there too?):
    `obs/conv_times.RAGGED_NET`."""
    from dg_tta_tpu_torch.obs.conv_times import RAGGED_NET

    return RAGGED_NET


def ragged_model(patch_size=None, compute_dtype=None):
    """The ragged net: TS104_GIN's plan at `UNet_base_num_features` 30
    and `unet_max_num_features` 300 (`RAGGED_FEATURES`)."""
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model

    return ts104_model(patch_size, compute_dtype, features=RAGGED_FEATURES)


def _ragged_cases():
    """The ragged net's conv3x3 shapes on the catch-all route, as
    `_conv_cases` (uses prefixed "ragged"): a window forward, a trained
    step's forward and its input gradients where they take the route too
    (all but 120 -> 60's, whose 60 -> 120 takes a wgmma route)."""
    cases = [(f"ragged {use}", vols, d, H, W, C, CO, mult, False)
             for use, vols in (("window forward", 1), ("step forward", 2))
             for d, H, W, C, CO, mult, _ in _ragged_shapes()]
    cases += [("ragged step dgrad", 2, d, H, W, CO, C, mult, True)
              for d, H, W, C, CO, mult, dgrad in _ragged_shapes() if dgrad]
    return cases


def _group(use):
    """The totals' prefix of a shape: the MIND stem's "stem12/", the
    ragged net's "ragged/", the TS104 net's none."""
    return ("stem12/" if use.startswith("stem") else
            "ragged/" if use.startswith("ragged") else "")


def _ops_ms(ops, name, route):
    """The least time for `ops` operations of type `name` on the unit
    that `route` computes on: every route on the tensor cores, bf16 at its
    rate and f32 as three tf32 products (3xTF32); the catch-all
    ("cuda_core") runs there too since its redesign (`cuda_core_floor_ms`
    is the CUDA cores' f32 floor it was held to before)."""
    if name == "float32":
        return ops / (PEAK_TF32 / 3) * 1e3
    return ops / PEAK_OPS["bfloat16"] * 1e3


def cuda_core_floor_ms(ops):
    """The least time for `ops` operations on the CUDA cores' f32 rate
    (67 TFLOP/s): the unit the catch-all route ran on before its
    redesign, printed beside its tensor-core bound."""
    return ops / PEAK_OPS["float32"] * 1e3


def _bound_text(ops_ms, bytes_ms, both):
    """The bound of one shape, the larger floor named; with `both`, the
    operations and the bytes floor beside it."""
    text = (f"bound_ms={max(ops_ms, bytes_ms):.4f} "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
    if both:
        text += f" [ops_floor_ms={ops_ms:.4f} bytes_floor_ms={bytes_ms:.4f}]"
    return text


def _route_totals(totals, name, main, route, group):
    """The totals a shape's time on `route` adds to: its route's per type
    ("<type>/<route>", the MIND stem's "<type>/stem12/<route>", the ragged
    net's "<type>/ragged/<route>") and, for a "c1" shape forced onto
    another route, "<type>/c1/<route>" too."""
    at = [totals.setdefault(f"{name}/{group}{route}", _new_totals())]
    if main == "c1" and route != main:
        at.append(totals.setdefault(f"{name}/c1/{route}", _new_totals()))
    return at


def _side_routes(main, stem, dtype):
    """The routes timed beside the main path's on one shape: the MIND
    stem's (on "few") also on the type's wgmma route, which runs it
    zero-padded to 16 channels, and on the catch-all kernel; the "c1",
    "wgmma_tf32x3" and "wgmma" shapes on the catch-all ("cuda_core")
    kernel, which takes every shape."""
    import torch

    if stem:
        return [{torch.float32: "wgmma_tf32x3",
                 torch.bfloat16: "wgmma"}[dtype], "cuda_core"]
    return (["cuda_core"] if main in ("c1", "wgmma_tf32x3", "wgmma")
            else [])


def phase_kernels():
    """conv3x3 at every shape of the main path, on the route it takes
    there; where that is "c1" or "wgmma_tf32x3", also on the CUDA-core
    kernel that ran the shape before (`route="cuda_core"`), so that both
    are timed in one call.  The MIND stem's shapes (C = 12, "few") also on
    the padded wgmma route and the CUDA-core kernel, in totals of their own
    ("<type>/stem12/<route>")."""
    import torch
    import torch.nn.functional as F

    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_flops,
                                                  conv3x3_reference,
                                                  conv3x3_route)

    gen = torch.Generator().manual_seed(0)
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        tot = _new_totals()
        per_use = {}
        for use, vols, depth, H, W, C, CO, mult, dgrad in \
                _conv_cases() + _stem_cases() + _ragged_cases():
            group = _group(use)
            stem = group == "stem12/"
            N = vols * depth
            x = torch.randn((N, H, W, C), generator=gen).to(dt).cuda()
            if dgrad:
                # the forward conv's weights (CO -> C), flipped and swapped
                # as Conv3x3Function.backward does
                w = (torch.randn((3, 3, 3, CO, C), generator=gen)
                     * (2.0 / (27 * CO)) ** 0.5).to(dt).cuda()
                w = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
            else:
                w = (torch.randn((3, 3, 3, C, CO), generator=gen)
                     * (2.0 / (27 * C)) ** 0.5).to(dt).cuda()
            x5 = x.view(vols, depth, H, W, C).permute(0, 4, 1, 2, 3)
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            with tf32_off():
                ref = conv3x3_reference(x, w, depth=depth)
                p_ms = time_ms(lambda: conv3x3_reference(x, w, depth=depth))
                l_ms = time_ms(lambda: F.conv3d(x5, wt, padding=1))
            scale = ref.float().abs().max().item()
            tol = KERNEL_RTOL[name] * scale
            ops = conv3x3_flops(x.shape, w.shape, depth)
            nbytes = (x.numel() + w.numel() + N * H * W * CO) \
                * x.element_size()
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            main = conv3x3_route(C, CO, dt)
            for route in [main] + _side_routes(main, stem, dt):
                got = conv3x3(x, w, depth=depth, route=route)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                if not err <= tol:
                    raise AssertionError(
                        f"conv3x3 {name} {use} route={route} "
                        f"{(N, depth, H, W, C, CO)}: max abs err {err} > "
                        f"tol {tol}")
                if route == main and use in ("stem step forward",
                                             "ragged step forward"):
                    # a fixed order of sums: a second launch, bit for bit
                    again = conv3x3(x, w, depth=depth)
                    if not torch.equal(again, got):
                        raise AssertionError(
                            f"conv3x3 {name} {use} route={route}: two "
                            f"launches differ by "
                            f"{(again.float() - got.float()).abs().max()}")
                    log(f"conv3x3 {name} {use} route={route}: two launches "
                        f"equal bit for bit")
                    del again
                k_ms = time_ms(lambda: conv3x3(x, w, depth=depth,
                                               route=route))
                dev = ""
                if route in ("wgmma", "wgmma_tf32x3", "cuda_core"):
                    # the device time too (CUDA graph: no host work
                    # between the launches)
                    d_ms = device_ms(lambda: conv3x3(x, w, depth=depth,
                                                     route=route), reps=10)
                    dev = f"device_ms={d_ms:.4f} "
                ops_ms = _ops_ms(ops, name, route)
                floor = (f"cuda_core_floor_ms={cuda_core_floor_ms(ops):.4f} "
                         if route == "cuda_core" else "")
                log(f"conv3x3 {name} {use} N={N} depth={depth} {H}x{W} "
                    f"{C}->{CO} route={route}"
                    f"{'' if route == main else ' (forced)'}: "
                    f"max_abs_err={err:.3e} (tol {tol:.3e}) "
                    f"max_rel_err={err / scale:.3e} "
                    f"(tol {KERNEL_RTOL[name]:.1e}) kernel_ms={k_ms:.4f} "
                    f"{dev}plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                    f"{_bound_text(ops_ms, bytes_ms, main == 'c1')} "
                    f"{floor}TFLOP/s={ops / k_ms / 1e9:.2f} x{mult}/{use}")
                at = _route_totals(totals, name, main, route, group)
                if route == main and not group:
                    at += [tot, per_use.setdefault(use, _new_totals())]
                for t in at:
                    _record(t, err, k_ms, p_ms, l_ms, ops_ms, bytes_ms, mult)
        for use, t in per_use.items():
            log(f"conv3x3 {name} per {use}: kernel_ms={t['ms']:.3f} "
                f"plain_ms={t['plain_ms']:.3f} "
                f"library_ms={t['library_ms']:.3f} "
                f"bound_ms={max(t['ops_ms'], t['bytes_ms']):.3f}")
        log(f"conv3x3 {name} window forward + trained step (row total, the "
            f"main path's routes): kernel_ms={tot['ms']:.3f} "
            f"plain_ms={tot['plain_ms']:.3f} "
            f"library_ms={tot['library_ms']:.3f} "
            f"bound_ms={max(tot['ops_ms'], tot['bytes_ms']):.3f}")
        totals[name] = tot
    _log_routes("conv3x3", "window forward + trained step", totals)
    return totals


def phase_wgrad():
    """conv3x3_wgrad at every TS104 stride-1 conv shape, with the batch of
    one TTA step: both branches of one patch, N = 2 x depth planes; the
    C = 1 conv on the "c1" route and the f32 shapes on "wgmma_tf32x3",
    each also, for comparison, on the CUDA-core kernel that ran it
    before.  The MIND stem's shape (C = 12, "few") too, also on the padded
    wgmma route and the CUDA-core kernel, in totals of its own."""
    import torch

    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_flops,
                                                  conv3x3_wgrad,
                                                  conv3x3_wgrad_reference,
                                                  conv3x3_wgrad_route)

    gen = torch.Generator().manual_seed(1)
    totals = {}
    # the top level: the first shape past the C = 1 conv
    top = next(sh[:5] for sh in TS104_CONV_SHAPES if sh[3] > 1)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        tot = _new_totals()
        side = {}  # f32: both routes' per-step totals on the tf32x3 shapes
        for depth, H, W, C, CO, mult, group in \
                [(*sh, "") for sh in TS104_CONV_SHAPES] \
                + [(*STEM_SHAPE, 1, "stem12/")] \
                + [(*sh[:6], "ragged/") for sh in _ragged_shapes()]:
            stem = group == "stem12/"
            N = 2 * depth
            x = torch.randn((N, H, W, C), generator=gen).to(dt).cuda()
            dy = torch.randn((N, H, W, CO), generator=gen).to(dt).cuda()
            x5 = x.view(2, depth, H, W, C).permute(0, 4, 1, 2, 3)
            dy5 = dy.view(2, depth, H, W, CO).permute(0, 4, 1, 2, 3)
            with tf32_off():
                ref = conv3x3_wgrad_reference(x, dy, depth=depth)
                p_ms = time_ms(lambda: conv3x3_wgrad_reference(
                    x, dy, depth=depth))
                l_ms = time_ms(lambda: torch.nn.grad.conv3d_weight(
                    x5, (CO, C, 3, 3, 3), dy5, padding=1))
            scale = ref.abs().max().item()
            ops = conv3x3_flops(x.shape, (3, 3, 3, C, CO), depth)
            nbytes = (x.numel() + dy.numel()) * x.element_size() \
                + 27 * C * CO * 4
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            main = conv3x3_wgrad_route(C, CO, dt)
            for route in [main] + _side_routes(main, stem, dt):
                ops_ms = _ops_ms(ops, name, route)
                got = conv3x3_wgrad(x, dy, depth=depth, route=route)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                if not err <= WGRAD_RTOL * scale:
                    raise AssertionError(
                        f"conv3x3_wgrad {name} route={route} "
                        f"{(N, depth, H, W, C, CO)}: max abs err {err} > "
                        f"{WGRAD_RTOL * scale}")
                if route == main and ((depth, H, W, C, CO) == top
                                      or group):
                    # a fixed order of sums: a second launch, bit for bit
                    again = conv3x3_wgrad(x, dy, depth=depth)
                    if not torch.equal(again, got):
                        raise AssertionError(
                            f"conv3x3_wgrad {name} route={route} "
                            f"{(N, depth, H, W, C, CO)}: two launches differ "
                            f"by {(again - got).abs().max().item()}")
                    log(f"conv3x3_wgrad {name} N={N} {H}x{W} {C}->{CO} "
                        f"route={route}: two launches equal bit for bit")
                    del again
                k_ms = time_ms(lambda: conv3x3_wgrad(x, dy, depth=depth,
                                                     route=route))
                floor = (f"cuda_core_floor_ms={cuda_core_floor_ms(ops):.4f} "
                         if route == "cuda_core" else "")
                log(f"conv3x3_wgrad {name} N={N} depth={depth} {H}x{W} "
                    f"{C}->{CO} route={route}"
                    f"{'' if route == main else ' (forced)'}"
                    f"{' MIND stem' if stem else ''}"
                    f"{' ragged net' if group == 'ragged/' else ''}: "
                    f"max_abs_err={err:.3e} (tol {WGRAD_RTOL * scale:.3e}) "
                    f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={l_ms:.4f} "
                    f"{_bound_text(ops_ms, bytes_ms, main == 'c1')} "
                    f"{floor}TFLOP/s={ops / k_ms / 1e9:.2f} x{mult}/step")
                if main == "wgmma_tf32x3" and not group:
                    side[route] = side.get(route, 0.0) + mult * k_ms
                at = _route_totals(totals, name, main, route, group)
                if route == main and not group:
                    at.append(tot)
                for t in at:
                    _record(t, err, k_ms, p_ms, l_ms, ops_ms, bytes_ms, mult)
        if side:
            log(f"conv3x3_wgrad {name} per trained step on the "
                f"wgmma_tf32x3 shapes: wgmma_tf32x3 "
                f"{side['wgmma_tf32x3']:.3f} ms, cuda_core (forced) "
                f"{side['cuda_core']:.3f} ms, ratio "
                f"{side['wgmma_tf32x3'] / side['cuda_core']:.3f}")
        log(f"conv3x3_wgrad {name} per trained step (14 convs, the main "
            f"path's routes): kernel_ms={tot['ms']:.3f} "
            f"plain_ms={tot['plain_ms']:.3f} "
            f"library_ms={tot['library_ms']:.3f} "
            f"bound_ms={max(tot['ops_ms'], tot['bytes_ms']):.3f}")
        totals[name] = tot
    _log_routes("conv3x3_wgrad", "trained step", totals)
    return totals


def phase_grouped_kernels(totals):
    """The kernels at the shapes the grouped main-path runs give them
    (`GROUPED_RUNS`, batch_size 1: a trained step puts 2 x group volumes
    through the network and group patches through each branch's warps):
    conv3x3's forward and input gradient and conv3x3_wgrad at every
    stride-1 conv on the route of the type, and the warp's affine entry at
    its three patch sites with a theta per patch, each held to its plain
    version at the ungrouped checks' tolerances.  Their max abs errors go
    into `totals` (the kernels line's rows)."""
    import torch

    from dg_tta_tpu_torch.core.fields import affine_abs_det, get_rand_affine
    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_reference,
                                                  conv3x3_route,
                                                  conv3x3_wgrad,
                                                  conv3x3_wgrad_reference,
                                                  conv3x3_wgrad_route)
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                               warp_affine_reference)

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    def check(what, got, ref, rtol, totals_at):
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= rtol * scale:
            raise AssertionError(f"{what}: max abs err {err} > "
                                 f"{rtol * scale}")
        totals_at["max_abs_err"] = max(totals_at["max_abs_err"], err)
        return f"max_abs_err={err:.3e} (tol {rtol * scale:.3e})"

    for name, group in GROUPED_RUNS:
        dt = getattr(torch, name)
        vols = 2 * group
        for depth, H, W, C, CO, _ in TS104_CONV_SHAPES:
            N = vols * depth
            shape = f"N={N} depth={depth} {H}x{W}"
            x = randn(N, H, W, C, dt=dt)
            w = randn(3, 3, 3, C, CO, dt=dt, scale=(2.0 / (27 * C)) ** 0.5)
            route = conv3x3_route(C, CO, dt)
            with tf32_off():
                ref = conv3x3_reference(x, w, depth=depth)
            got = conv3x3(x, w, depth=depth)
            torch.cuda.synchronize()
            text = check(f"conv3x3 {name} grouped forward {shape} {C}->{CO}",
                         got, ref, KERNEL_RTOL[name],
                         totals["conv3x3"][f"{name}/{route}"])
            log(f"conv3x3 {name} patch_group {group} step forward {shape} "
                f"{C}->{CO} route={route}: {text} kernel_ms="
                f"{time_ms(lambda: conv3x3(x, w, depth=depth)):.4f}")
            dy = randn(N, H, W, CO, dt=dt)
            if C > 1:
                # the input gradient: dy through the kernel with the
                # forward's weights flipped and their channels swapped
                wd = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
                route = conv3x3_route(CO, C, dt)
                with tf32_off():
                    ref = conv3x3_reference(dy, wd, depth=depth)
                got = conv3x3(dy, wd, depth=depth)
                torch.cuda.synchronize()
                text = check(f"conv3x3 {name} grouped dgrad {shape} "
                             f"{CO}->{C}", got, ref, KERNEL_RTOL[name],
                             totals["conv3x3"][f"{name}/{route}"])
                log(f"conv3x3 {name} patch_group {group} step dgrad {shape} "
                    f"{CO}->{C} route={route}: {text} kernel_ms="
                    f"{time_ms(lambda: conv3x3(dy, wd, depth=depth)):.4f}")
            route = conv3x3_wgrad_route(C, CO, dt)
            with tf32_off():
                ref = conv3x3_wgrad_reference(x, dy, depth=depth)
            got = conv3x3_wgrad(x, dy, depth=depth)
            torch.cuda.synchronize()
            text = check(f"conv3x3_wgrad {name} grouped {shape} {C}->{CO}",
                         got, ref, WGRAD_RTOL,
                         totals["conv3x3_wgrad"][f"{name}/{route}"])
            log(f"conv3x3_wgrad {name} patch_group {group} {shape} "
                f"{C}->{CO} route={route} ({N * H} dy rows): {text} "
                f"kernel_ms="
                f"{time_ms(lambda: conv3x3_wgrad(x, dy, depth=depth)):.4f}")
            del x, w, dy, ref, got
        theta, theta_inv = get_rand_affine(
            torch.randn((group, 3, 4), generator=gen, device="cuda"))
        n = PATCH[0] * PATCH[1] * PATCH[2]
        for site, C, th, scale, pad in (
                ("border input warp", 1, theta, None, "border"),
                ("zeros unwarp", N_OPT, theta_inv, None, "zeros"),
                ("adjoint", N_OPT, theta, affine_abs_det(theta), "zeros")):
            flat = randn(group, C, n, dt=dt)
            kw = dict(scale=scale, padding_mode=pad)
            ref = warp_affine_reference(flat, PATCH, th, PATCH, **kw)
            got = warp_affine_flat(flat, PATCH, th, PATCH, **kw)
            torch.cuda.synchronize()
            text = check(f"warp {name} grouped {site}", got, ref,
                         WARP_RTOL[name], totals["warp"][name]["affine"])
            log(f"warp {name} patch_group {group} {site} B={group} C={C} "
                f"{PATCH}, a theta per patch: {text}")


def phase_member_chunk_kernels(totals):
    """Every route of the conv kernels at CHUNK members' weights in one
    launch, at the shapes a trained step of a chunk gives them (2 volumes a
    member: both branches): each stride-1 TS104 conv and the MIND stem,
    forward, input gradient (the forward's weights flipped and their
    channels swapped, per member) and weight gradient, f32 and bf16.  Each
    stacked launch is held bit for bit to the CHUNK one-member launches of
    the same route on each member's planes, and to the plain version at
    the ungrouped checks' tolerances (its max abs error into `totals`);
    prints the stacked launch's ms beside the one-member launches'
    summed."""
    import torch

    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_reference,
                                                  conv3x3_route,
                                                  conv3x3_wgrad,
                                                  conv3x3_wgrad_reference,
                                                  conv3x3_wgrad_route)

    gen = torch.Generator(device="cuda").manual_seed(17)
    M = CHUNK

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    def check(what, got, parts, ref, rtol, totals_at):
        if not torch.equal(got, parts):
            raise AssertionError(f"{what}: the stacked launch differs from "
                                 f"the members' own launches by "
                                 f"{(got.float() - parts.float()).abs().max()}")
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= rtol * scale:
            raise AssertionError(f"{what}: max abs err {err} > "
                                 f"{rtol * scale}")
        totals_at["max_abs_err"] = max(totals_at["max_abs_err"], err)
        return f"bit-equal to {M} launches, max_abs_err={err:.3e} (tol " \
               f"{rtol * scale:.3e})"

    def at(kernel, name, route, stem):
        return totals[kernel].setdefault(
            f"{name}/{'stem12/' if stem else ''}{route}", _new_totals())

    def timed(stacked, single):
        return (f"ms {time_ms(stacked, iters=5):.4f} stacked vs "
                f"{time_ms(single, iters=5):.4f} for {M} member launches")

    shapes = [s[:5] for s in TS104_CONV_SHAPES] + [STEM_SHAPE]
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        for depth, H, W, C, CO in shapes:
            stem = (C, CO) == STEM_SHAPE[3:]
            n = 2 * depth                  # a member's planes
            shape = f"{M} members x N={n} depth={depth} {H}x{W}"
            x = randn(M * n, H, W, C, dt=dt)
            w = randn(M, 3, 3, 3, C, CO, dt=dt,
                      scale=(2.0 / (27 * C)) ** 0.5)
            xs = x.chunk(M)
            route = conv3x3_route(C, CO, dt)
            with tf32_off():
                ref = conv3x3_reference(x, w, depth=depth)
            got = conv3x3(x, w, depth=depth)
            parts = torch.cat([conv3x3(xm, wm, depth=depth)
                               for xm, wm in zip(xs, w)])
            torch.cuda.synchronize()
            text = check(f"conv3x3 {name} members forward {shape} "
                         f"{C}->{CO}", got, parts, ref, KERNEL_RTOL[name],
                         at("conv3x3", name, route, stem))
            log(f"member chunk: conv3x3 {name} forward {shape} {C}->{CO} "
                f"route={route}: {text}; " + timed(
                    lambda: conv3x3(x, w, depth=depth),
                    lambda: [conv3x3(xm, wm, depth=depth)
                             for xm, wm in zip(xs, w)]))
            dy = randn(M * n, H, W, CO, dt=dt)
            dys = dy.chunk(M)
            if C > 1 and not stem:
                # the input gradient (the first conv and the stem take none)
                wd = w.flip((1, 2, 3)).transpose(-2, -1).contiguous()
                route = conv3x3_route(CO, C, dt)
                with tf32_off():
                    ref = conv3x3_reference(dy, wd, depth=depth)
                got = conv3x3(dy, wd, depth=depth)
                parts = torch.cat([conv3x3(dm, wm, depth=depth)
                                   for dm, wm in zip(dys, wd)])
                torch.cuda.synchronize()
                text = check(f"conv3x3 {name} members dgrad {shape} "
                             f"{CO}->{C}", got, parts, ref, KERNEL_RTOL[name],
                             at("conv3x3", name, route, False))
                log(f"member chunk: conv3x3 {name} dgrad {shape} {CO}->{C} "
                    f"route={route}: {text}")
                del wd
            route = conv3x3_wgrad_route(C, CO, dt)
            with tf32_off():
                ref = conv3x3_wgrad_reference(x, dy, depth=depth, members=M)
            got = conv3x3_wgrad(x, dy, depth=depth, members=M)
            parts = torch.stack([conv3x3_wgrad(xm, dm, depth=depth)
                                 for xm, dm in zip(xs, dys)])
            torch.cuda.synchronize()
            text = check(f"conv3x3_wgrad {name} members {shape} {C}->{CO}",
                         got, parts, ref, WGRAD_RTOL,
                         at("conv3x3_wgrad", name, route, stem))
            log(f"member chunk: conv3x3_wgrad {name} {shape} {C}->{CO} "
                f"route={route}: {text}; " + timed(
                    lambda: conv3x3_wgrad(x, dy, depth=depth, members=M),
                    lambda: [conv3x3_wgrad(xm, dm, depth=depth)
                             for xm, dm in zip(xs, dys)]))
            del x, w, dy, xs, dys, ref, got, parts


def _warp_sites(gen, device):
    """The warp's four call sites in adaptation: (name, C, source shape,
    theta, scale, mode, padding)."""
    import torch

    from dg_tta_tpu_torch.core.fields import affine_abs_det, get_rand_affine
    from dg_tta_tpu_torch.core.patches import (_compose_pad_correction,
                                               patch_affine)

    theta, theta_inv = get_rand_affine(
        torch.randn((1, 3, 4), generator=gen).to(device))
    theta_p = _compose_pad_correction(
        patch_affine(torch.rand(3, generator=gen).numpy(), VOLUME_SHAPE,
                     PATCH), VOLUME_SHAPE, VOLUME_SHAPE).to(device)
    return [("border input warp", 1, PATCH, theta, None, "trilinear",
             "border"),
            ("zeros unwarp", N_OPT, PATCH, theta_inv, None, "trilinear",
             "zeros"),
            ("adjoint", N_OPT, PATCH, theta, affine_abs_det(theta),
             "trilinear", "zeros"),
            ("nearest labels", 1, VOLUME_SHAPE, theta_p, None, "nearest",
             "zeros")]


def device_ms(fn, reps=20):
    """Device time per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed, so no host work separates the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, iters=5, warmup=1) / reps


def host_us(fn, calls=200):
    """Host microseconds per call of `fn` (its enqueue time: the device
    runs behind it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _counted_paths(calls, src, grid, C, element_size, mode="trilinear",
                   align_corners=False):
    """The results of the warp calls `calls`, (fn, affine?) pairs of the
    forward kernel's affine entry at `grid`'s affine or its grid entry at
    `grid`, and their bricks by path (staged, global), each call's counts
    held to `warp_brick_paths`' prediction."""
    import torch

    from dg_tta_tpu_torch.kernels.warp import brick_paths, warp_brick_paths

    outs, paths = [], []
    for fn, affine in calls:
        want = warp_brick_paths(src, grid, C, element_size, 1, mode,
                                align_corners, affine)
        with brick_paths() as counts:
            outs.append(fn())
            torch.cuda.synchronize()
            got = tuple(counts.tolist())
        if got != want:
            raise AssertionError(f"warp: bricks by path (staged, global) "
                                 f"{got}, predicted {want}")
        paths.append(got)
    return outs, paths


def phase_warp():
    """The warp kernel at its four call sites, through both entries: the
    affine entry the main path takes, and the grid entry on the grid that
    `affine_grid` makes on the card; each site's bricks by path (source
    box staged in shared memory, or gathered from device memory) counted
    and held to `warp_brick_paths`."""
    import torch
    import torch.nn.functional as F

    from dg_tta_tpu_torch.core.grid import affine_grid, pack_grid
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                               warp_affine_reference,
                                               warp_bytes, warp_flat,
                                               warp_flops,
                                               warp_source_voxels)

    gen = torch.Generator().manual_seed(2)
    n_out = PATCH[0] * PATCH[1] * PATCH[2]
    totals = {}
    log("warp: the bf16 library yardsticks sample at bf16-rounded points "
        "(F.grid_sample takes its grid in the input's type), so the f32 "
        "comparison is the one that decides")
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        tot = {"affine": _new_totals(), "grid": _new_totals()}
        extra = dict(device_ms=0.0, host_us=0.0, grid_device_ms=0.0,
                     library_device_ms=0.0, library_affine_ms=0.0,
                     staged_bricks=0, global_bricks=0)
        for site, C, src, theta, scale, mode, pad in _warp_sites(gen, "cuda"):
            n_src = src[0] * src[1] * src[2]
            flat = torch.randn((1, C, n_src), generator=gen).to(dt).cuda()
            grid = affine_grid(theta, PATCH)
            kw = dict(mode=mode, padding_mode=pad)

            def affine():
                return warp_affine_flat(flat, src, theta, PATCH, scale=scale,
                                        **kw)

            def by_grid():
                out = warp_flat(flat, src, grid, **kw)
                return out if scale is None else \
                    out * scale.reshape(-1, 1, 1).to(dt)

            (got, same), (paths, _) = _counted_paths(
                ((affine, True), (by_grid, False)), src, grid, C,
                flat.element_size(), mode)
            ref = warp_affine_reference(flat, src, theta, PATCH, scale=scale,
                                        **kw)
            diff = (got.float() - same.float()).abs().max().item()
            if diff != 0.0:
                raise AssertionError(f"warp {name} {site}: warp_affine_flat "
                                     f"differs from warp_flat on the card's "
                                     f"affine_grid by {diff}")
            err = (got.float() - ref.float()).abs().max().item()
            scale_ref = ref.float().abs().max().item()
            tol = 0.0 if mode == "nearest" else WARP_RTOL[name] * scale_ref
            if not err <= tol:
                raise AssertionError(f"warp {name} {site}: max abs err "
                                     f"{err} > {tol}")
            vol5 = flat.view(1, C, *src)
            packed = pack_grid(grid).to(dt)
            lib_mode = "bilinear" if mode == "trilinear" else "nearest"
            theta_l = theta.to(dt)

            def library():
                return F.grid_sample(vol5, packed, mode=lib_mode,
                                     padding_mode=pad, align_corners=False)

            def library_affine():
                g = F.affine_grid(theta_l, (1, C, *PATCH),
                                  align_corners=False)
                return F.grid_sample(vol5, g, mode=lib_mode,
                                     padding_mode=pad, align_corners=False)

            k_ms = time_ms(affine)
            k_dev = device_ms(affine)
            k_host = host_us(affine)
            g_ms = time_ms(lambda: warp_flat(flat, src, grid, **kw))
            g_dev = device_ms(lambda: warp_flat(flat, src, grid, **kw))
            p_ms = time_ms(lambda: warp_affine_reference(
                flat, src, theta, PATCH, scale=scale, **kw))
            l_ms = time_ms(library)
            l_dev = device_ms(library)
            la_ms = time_ms(library_affine)
            n_need = warp_source_voxels(src, grid, 1, mode, pad)
            ops_ms = warp_flops(flat.shape, n_out, mode) \
                / PEAK_OPS["float32"] * 1e3
            bytes_ms = {e: warp_bytes(flat.shape, n_need, n_out,
                                      flat.element_size(), gb)
                        / PEAK_BYTES * 1e3
                        for e, gb in (("affine", 48), ("grid", 12 * n_out))}
            bound = {e: max(ops_ms, b) for e, b in bytes_ms.items()}
            log(f"warp {name} {site} C={C} {src}->{PATCH} {mode} {pad}"
                f"{'' if scale is None else ' x 1/|det|'}: affine entry "
                f"== grid entry on affine_grid (max |diff| 0); "
                f"max_abs_err={err:.3e} (tol {tol:.3e}); affine entry "
                f"bricks staged {paths[0]} of {sum(paths)} (as "
                f"warp_brick_paths predicts; the grid entry stages none); "
                f"affine entry "
                f"kernel_ms={k_ms:.4f} device_ms={k_dev:.4f} "
                f"host_us={k_host:.1f} bound_ms={bound['affine']:.4f} "
                f"(share of bound {bound['affine'] / k_dev:.3f}); "
                f"grid entry kernel_ms={g_ms:.4f} device_ms={g_dev:.4f} "
                f"bound_ms={bound['grid']:.4f} (share of bound "
                f"{bound['grid'] / g_dev:.3f}); "
                f"plain_ms={p_ms:.4f}; library F.grid_sample "
                f"library_ms={l_ms:.4f} device_ms={l_dev:.4f}, "
                f"F.affine_grid + F.grid_sample {la_ms:.4f} ms; source "
                f"voxels needed {n_need} of {n_src}; affine entry "
                f"GB/s={bytes_ms['affine'] * PEAK_BYTES / 1e9 / k_dev:.1f} "
                f"(device)")
            _record(tot["affine"], err, k_ms, p_ms, l_ms, ops_ms,
                    bytes_ms["affine"])
            _record(tot["grid"], err, g_ms, p_ms, l_ms, ops_ms,
                    bytes_ms["grid"])
            for key, v in (("device_ms", k_dev), ("host_us", k_host),
                           ("grid_device_ms", g_dev),
                           ("library_device_ms", l_dev),
                           ("library_affine_ms", la_ms),
                           ("staged_bricks", paths[0]),
                           ("global_bricks", paths[1])):
                extra[key] += v
        extra["staged_share"] = extra["staged_bricks"] / (
            extra["staged_bricks"] + extra["global_bricks"])
        tot["affine"].update(extra)
        bound = {e: max(t["ops_ms"], t["bytes_ms"]) for e, t in tot.items()}
        log(f"warp {name} over the four call sites: affine entry "
            f"kernel_ms={tot['affine']['ms']:.4f} "
            f"device_ms={extra['device_ms']:.4f} "
            f"host_us={extra['host_us']:.1f} "
            f"bound_ms={bound['affine']:.4f} (share of bound "
            f"{bound['affine'] / extra['device_ms']:.3f}); "
            f"grid entry kernel_ms={tot['grid']['ms']:.4f} "
            f"device_ms={extra['grid_device_ms']:.4f} "
            f"bound_ms={bound['grid']:.4f} (share of bound "
            f"{bound['grid'] / extra['grid_device_ms']:.3f}); bricks "
            f"staged {extra['staged_share']:.3f}; "
            f"plain_ms={tot['affine']['plain_ms']:.4f}; library "
            f"F.grid_sample library_ms={tot['affine']['library_ms']:.4f} "
            f"device_ms={extra['library_device_ms']:.4f}, F.affine_grid + "
            f"F.grid_sample {extra['library_affine_ms']:.4f} ms")
        totals[name] = tot
    return totals


def _deformable_sites(gen):
    """A deformable branch's warps at the patch size on the card, from one
    seeded field noise: (name, C, grid, padding, align_corners, launches per
    branch of a trained step, the field itself for the field sites).  The
    field sites sample the loop's scaled displacement at identity + itself
    (align_corners=True): border in the main path's loop, zeros in the
    loop without inverse consistency, which the main path does not run."""
    import torch

    from dg_tta_tpu_torch.core.fields import deformable_grids, get_disp_field
    from dg_tta_tpu_torch.core.grid import identity_grid

    noise = torch.randn((1, *(s // 5 for s in PATCH), 3),
                        generator=gen).cuda()
    disp, _ = get_disp_field(noise, PATCH, factor=0.5, interpolation_factor=5)
    # the first iteration's field: disp / (D, H, W) / 2^5 / 5
    ds = torch.stack([d / float(n) / 32 * 0.2
                      for d, n in zip(disp, PATCH)], dim=1)
    pos = tuple(i + d for i, d in zip(identity_grid(PATCH, True, "cuda"),
                                      ds.unbind(1)))
    grid, grid_inv = deformable_grids(noise, PATCH)
    field = ds.reshape(1, 3, -1).contiguous()
    return [("field warp", 3, pos, "border", True, 10, field),
            ("field warp zeros", 3, pos, "zeros", True, 0, field),
            ("deformable input warp", 1, grid, "border", False, 1, None),
            ("deformable unwarp", N_OPT, grid_inv, "zeros", False, 1, None),
            ("deformable fast adjoint", N_OPT, grid, "zeros", False, 1,
             None)]


def phase_warp_deformable():
    """The warp's grid entry at a deformable branch's call sites (the
    field warps, C = 3 f32, and the input warp, the unwarp and its fast
    adjoint, f32 and bf16), held against its plain version and timed
    against `F.grid_sample`; then the exact adjoint at the logit site
    (C = n_opt), f32 and bf16: its affine entry at an inverse affine, its
    grid entry on that affine's grid and on a deformable branch's inverse
    grid, each against its plain version (twice: its atomics sum in a
    varying order), its bricks by path held to `warp_brick_paths`, and
    timed against autograd of `F.grid_sample` with respect to its input
    (ATen's own scatter).  Totals: per branch of a trained step (10 border
    field warps, the input warp, the unwarp and the fast adjoint), and
    each adjoint site."""
    import torch
    import torch.nn.functional as F

    from dg_tta_tpu_torch.core.fields import get_rand_affine
    from dg_tta_tpu_torch.core.grid import affine_grid, pack_grid
    from dg_tta_tpu_torch.kernels.warp import (brick_paths,
                                               warp_adjoint_bytes,
                                               warp_affine_adjoint_reference,
                                               warp_affine_flat_adjoint,
                                               warp_brick_paths, warp_bytes,
                                               warp_flat, warp_flat_adjoint,
                                               warp_flat_adjoint_reference,
                                               warp_flat_reference,
                                               warp_flops,
                                               warp_source_voxels)

    gen = torch.Generator().manual_seed(4)
    n = PATCH[0] * PATCH[1] * PATCH[2]
    sites = _deformable_sites(gen)
    _, theta_inv = get_rand_affine(torch.randn((1, 3, 4), generator=gen)
                                   .cuda())
    # the exact adjoint at the logit site: an affine branch's through the
    # affine entry (the main path's since the affine entry took it) and
    # through the grid entry on the card's affine_grid, and a deformable
    # branch's on its inverse grid
    aff_grid = affine_grid(theta_inv, PATCH)
    adjoint_sites = [("affine entry", aff_grid, True),
                     ("affine grid", aff_grid, False),
                     ("deformable grid", sites[3][2], False)]
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        tot = _new_totals()
        tot.update(device_ms=0.0, library_device_ms=0.0, staged_bricks=0,
                   global_bricks=0)
        for site, C, grid, pad, align, mult, field in sites:
            # the fields are f32 in either compute type
            src_dt = torch.float32 if field is not None else dt
            flat = (field if field is not None else torch.randn(
                (1, C, n), generator=gen)).to(src_dt).cuda()
            kw = dict(padding_mode=pad, align_corners=align)

            def kernel():
                return warp_flat(flat, PATCH, grid, **kw)

            (got,), (paths,) = _counted_paths(((kernel, False),), PATCH,
                                              grid, C, flat.element_size(),
                                              align_corners=align)
            ref = warp_flat_reference(flat, PATCH, grid, **kw)
            err = (got.float() - ref.float()).abs().max().item()
            tol = WARP_RTOL[str(src_dt).split(".")[-1]] \
                * ref.float().abs().max().item()
            if not err <= tol:
                raise AssertionError(f"warp {name} {site}: max abs err "
                                     f"{err} > {tol}")
            vol5 = flat.view(1, C, *PATCH)
            packed = pack_grid(grid).to(src_dt)

            def library():
                return F.grid_sample(vol5, packed, mode="bilinear",
                                     padding_mode=pad, align_corners=align)

            k_ms, k_dev = time_ms(kernel), device_ms(kernel)
            p_ms = time_ms(lambda: warp_flat_reference(flat, PATCH, grid,
                                                       **kw))
            l_ms, l_dev = time_ms(library), device_ms(library)
            n_need = warp_source_voxels(PATCH, grid, 1, "trilinear", pad,
                                        align)
            ops_ms = warp_flops(flat.shape, n) / PEAK_OPS["float32"] * 1e3
            bytes_ms = warp_bytes(flat.shape, n_need, n, flat.element_size(),
                                  12 * n) / PEAK_BYTES * 1e3
            log(f"warp {name} {site} C={C} {str(src_dt).split('.')[-1]} "
                f"{pad} align_corners={align} (x{mult} per branch of a "
                f"trained step): grid entry max_abs_err={err:.3e} (tol "
                f"{tol:.3e}) bricks staged {paths[0]} of {sum(paths)} "
                f"kernel_ms={k_ms:.4f} device_ms={k_dev:.4f} "
                f"bound_ms={max(ops_ms, bytes_ms):.4f} (share of bound "
                f"{max(ops_ms, bytes_ms) / k_dev:.3f}); plain_ms="
                f"{p_ms:.4f}; library F.grid_sample library_ms={l_ms:.4f} "
                f"device_ms={l_dev:.4f}; source voxels needed {n_need} of "
                f"{n}")
            _record(tot, err, k_ms, p_ms, l_ms, ops_ms, bytes_ms, mult)
            tot["device_ms"] += mult * k_dev
            tot["library_device_ms"] += mult * l_dev
            tot["staged_bricks"] += mult * paths[0]
            tot["global_bricks"] += mult * paths[1]
        tot["staged_share"] = tot["staged_bricks"] / (
            tot["staged_bricks"] + tot["global_bricks"])
        bound = max(tot['ops_ms'], tot['bytes_ms'])
        log(f"warp {name} grid entry per deformable branch of a trained "
            f"step (13 launches): kernel_ms={tot['ms']:.4f} "
            f"device_ms={tot['device_ms']:.4f} "
            f"bound_ms={bound:.4f} (share of bound "
            f"{bound / tot['device_ms']:.3f}); bricks staged "
            f"{tot['staged_share']:.3f}; "
            f"plain_ms={tot['plain_ms']:.4f}; library F.grid_sample "
            f"library_ms={tot['library_ms']:.4f} "
            f"device_ms={tot['library_device_ms']:.4f}")
        totals[name] = tot

        for site, grid, affine in adjoint_sites:
            g = torch.randn((1, N_OPT, n), generator=gen).to(dt).cuda()

            def adjoint():
                if affine:
                    return warp_affine_flat_adjoint(g, PATCH, theta_inv,
                                                    PATCH)
                return warp_flat_adjoint(g, PATCH, grid)

            want = warp_brick_paths(PATCH, grid, N_OPT, 4, adjoint=True)
            with brick_paths() as counts:
                got = adjoint()
                torch.cuda.synchronize()
                paths = tuple(counts.tolist())
            if paths != want:
                raise AssertionError(f"warp adjoint {name} {site}: bricks by "
                                     f"path (staged, global) {paths}, "
                                     f"predicted {want}")
            again = adjoint()
            ref = (warp_affine_adjoint_reference(g, PATCH, theta_inv, PATCH)
                   if affine else warp_flat_adjoint_reference(g, PATCH, grid))
            scale = ref.float().abs().max().item()
            err = max((t.float() - ref.float()).abs().max().item()
                      for t in (got, again))
            runs = (got.float() - again.float()).abs().max().item()
            tol = ADJOINT_RTOL[name] * scale
            if not err <= tol:
                raise AssertionError(f"warp adjoint {name} {site}: max abs "
                                     f"err {err} > {tol}")
            vol5 = torch.zeros((1, N_OPT, *PATCH), dtype=dt, device="cuda",
                               requires_grad=True)
            out5 = F.grid_sample(vol5, pack_grid(grid).to(dt),
                                 mode="bilinear", padding_mode="zeros",
                                 align_corners=False)
            g5 = g.view(1, N_OPT, *PATCH)
            k_ms, k_dev = time_ms(adjoint), device_ms(adjoint)
            p_ms = time_ms(lambda: warp_affine_adjoint_reference(
                g, PATCH, theta_inv, PATCH) if affine else
                warp_flat_adjoint_reference(g, PATCH, grid))
            l_ms = time_ms(lambda: torch.autograd.grad(
                out5, vol5, g5, retain_graph=True))
            ops_ms = warp_flops(g.shape, n) / PEAK_OPS["float32"] * 1e3
            # the whole of dx is the output (the voxels no corner reaches
            # are written too, as zeros)
            bytes_ms = warp_adjoint_bytes(g.shape, n, g.element_size(),
                                          48 if affine else 12 * n) \
                / PEAK_BYTES * 1e3
            bound = max(ops_ms, bytes_ms)
            log(f"warp adjoint {name} {site} C={N_OPT} zeros: "
                f"max_abs_err={err:.3e} (tol {tol:.3e}, two runs; the runs "
                f"differ by max |diff| {runs:.3e}) bricks staged {paths[0]} "
                f"of {sum(paths)} (as warp_brick_paths predicts) "
                f"kernel_ms={k_ms:.4f} device_ms={k_dev:.4f} "
                f"bound_ms={bound:.4f} "
                f"({'operations' if ops_ms >= bytes_ms else 'bytes'}; share "
                f"of bound {bound / k_dev:.3f}); plain_ms={p_ms:.4f}; "
                f"library autograd of F.grid_sample library_ms={l_ms:.4f}")
            t = _new_totals()
            _record(t, err, k_ms, p_ms, l_ms, ops_ms, bytes_ms)
            t.update(device_ms=k_dev, runs_max_diff=runs,
                     staged_share=paths[0] / sum(paths))
            totals[f"{name}/adjoint/{site}"] = t
    return totals


def reference_deformable():
    """A deformable branch's fields at the patch size from one noise
    tensor, then one deformable trained step's gradient of the full-width
    TS104_GIN net on a small patch (the same injected draws), card against
    CPU under PyTorch's default flags: the fields within FIELD_RTOL, the
    gradient within GRAD_RTOL of its norm, as the network's own."""
    import dataclasses

    import numpy as np
    import torch

    from dg_tta_tpu_torch.core.fields import get_disp_field
    from dg_tta_tpu_torch.core.patches import extract_batch
    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import make_tta_functions
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    rng = np.random.default_rng(6)
    noise = torch.from_numpy(rng.standard_normal(
        (1, *(s // 5 for s in PATCH), 3)).astype(np.float32))
    ref = get_disp_field(noise, PATCH, factor=0.5, interpolation_factor=5)
    got = get_disp_field(noise.cuda(), PATCH, factor=0.5,
                         interpolation_factor=5)
    for what, got_f, ref_f in zip(("disp", "inverse disp"), got, ref):
        for axis, a, b in zip("xyz", got_f, ref_f):
            _card_vs_cpu(f"get_disp_field {what} {axis}", a.cpu(), b,
                         FIELD_RTOL)

    model = ts104_model(patch_size=(32, 48, 64))
    shape = (40, 56, 70)
    vol = rng.normal(0.0, 0.3, size=(1, *shape, 1)).astype(np.float32)
    vol[0, 10:25, 15:40, 20:50] += 2.0
    idx = np.arange(N_OPT)
    fns = make_tta_functions(model, TTAPlan(spatial_aug_type="deformable"),
                             idx, idx)
    fields = {k: torch.from_numpy(rng.standard_normal(
        (1, 6, 9, 12, 3)).astype(np.float32)) for k in ("field_a", "field_b")}
    draws = dataclasses.replace(
        TorchDraws(seed=8).patch(0, 1, 0, 1, 1),
        **{k: (lambda shape, device, f=f: f.to(device))
           for k, f in fields.items()})
    net0 = seeded_net(model, 11, "cpu")
    grads, losses = [], []
    for dev in ("cpu", "cuda"):
        net = copy.deepcopy(net0).to(dev)
        imgs, _ = extract_batch(draws.vol_idx, draws.uniforms,
                                torch.from_numpy(vol).to(dev), [shape],
                                model.patch_size, 1)
        loss = fns.patch_loss(net, draws, imgs)
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad.cpu() for k, p in net.named_parameters()
                      if p.grad is not None})
    if sorted(grads[0]) != sorted(grads[1]):
        raise AssertionError("deformable step: card and CPU differ in which "
                             "parameters get a gradient")
    names = sorted(grads[0])
    flat = [torch.cat([g[k].flatten() for k in names]) for g in grads]
    g_rel = ((flat[1] - flat[0]).norm() / flat[0].norm()).item()
    l_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    if not (torch.isfinite(flat[1]).all() and g_rel <= GRAD_RTOL
            and l_rel <= 1e-3 and losses[0] > 0):
        raise AssertionError(f"deformable step card vs CPU: loss "
                             f"{losses[1]} vs {losses[0]}, gradient "
                             f"{g_rel} of its norm (tol {GRAD_RTOL})")
    log(f"reference: deformable TTA step, TS104 patch {model.patch_size}: "
        f"loss {losses[1]:.6f} vs CPU {losses[0]:.6f} (rel {l_rel:.2e}, tol "
        f"1e-3); gradient of {len(names)} parameters {g_rel:.3e} of its "
        f"norm (tol {GRAD_RTOL:.0e})")


def phase_reference():
    """Full-width network and predict_volume on the card against the CPU."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.infer.sliding_window import predict_volume
    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model

    # PyTorch's default flags, as a user's run_tta finds them: cuDNN may
    # use TF32 for f32 convs, and the port's f32 path must not
    defaults = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    if defaults != (True, False):
        raise AssertionError(f"reference: precision flags {defaults} are "
                             f"not PyTorch's defaults (True, False)")
    model = ts104_model(patch_size=(32, 48, 64))
    cpu_nets = [seeded_net(model, s, "cpu") for s in (11, 12)]
    gpu_nets = [seeded_net(model, s, "cuda") for s in (11, 12)]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 32, 48, 64, 1))
                         .astype(np.float32))
    with torch.no_grad():
        ref = cpu_nets[0](x)
        got = gpu_nets[0](x.cuda()).cpu()
        got_bf16 = gpu_nets[0](x.cuda(), compute_dtype="bfloat16").float().cpu()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    # f32: the same math summed in another order over the network's layers
    if not (got.shape == ref.shape and torch.isfinite(got).all()
            and err <= REF_RTOL * scale):
        raise AssertionError(f"U-Net f32 card vs CPU: err {err} scale {scale}")
    rel = (got_bf16 - ref).abs().max().item() / scale
    # bf16 compute vs f32: the bound of tests/test_unet.py
    if not rel < 0.05:
        raise AssertionError(f"U-Net bf16 card vs f32 CPU: rel {rel}")
    log(f"reference: U-Net {tuple(x.shape)} f32 under default flags "
        f"max_abs_err={err:.3e} (tol {REF_RTOL * scale:.3e}); bf16 "
        f"rel_err={rel:.3e} (tol 5e-2)")

    # one step's gradient of the full-width network, f32 under the default
    # flags: every stride-1 conv's forward, input and weight gradient, and
    # the stride-2 convs' forward and backward in cuDNN, whose TF32 would
    # miss GRAD_RTOL
    ct = torch.from_numpy(rng.standard_normal(tuple(ref.shape))
                          .astype(np.float32))
    grads = []
    for net, dev in ((cpu_nets[0], "cpu"), (gpu_nets[0], "cuda")):
        net.zero_grad(set_to_none=True)
        (net(x.to(dev)) * ct.to(dev)).sum().backward()
        grads.append({k: p.grad.cpu() for k, p in net.named_parameters()
                      if p.grad is not None})
        net.zero_grad(set_to_none=True)
    if sorted(grads[0]) != sorted(grads[1]):
        raise AssertionError("U-Net gradient: card and CPU differ in which "
                             "parameters get a gradient")
    names = sorted(grads[0])
    flat = [torch.cat([g[k].flatten() for k in names]) for g in grads]
    g_rel = ((flat[1] - flat[0]).norm() / flat[0].norm()).item()
    worst = max(names, key=lambda k: (grads[1][k] - grads[0][k]).norm()
                / grads[0][k].norm())
    w_rel = ((grads[1][worst] - grads[0][worst]).norm()
             / grads[0][worst].norm()).item()
    if not (torch.isfinite(flat[1]).all() and g_rel <= GRAD_RTOL):
        raise AssertionError(f"U-Net f32 gradient card vs CPU under default "
                             f"flags: {g_rel} of its norm (tol {GRAD_RTOL})")
    log(f"reference: U-Net f32 gradient of one step under default flags, "
        f"{len(names)} parameters: error {g_rel:.3e} of its norm (tol "
        f"{GRAD_RTOL:.0e}); worst parameter {worst} {w_rel:.3e}")

    # the stride-2 conv alone, forward and backward, at a TS104 stage entry
    # (32 -> 64 channels): TF32 in either (~1e-3) would miss REF_RTOL, which
    # the whole network's gradient could not show past its own f32 noise
    from dg_tta_tpu_torch.models.unet import _conv

    xs = torch.from_numpy(rng.standard_normal((2, 32, 40, 48, 32))
                          .astype(np.float32))
    ws = torch.from_numpy((rng.standard_normal((64, 32, 3, 3, 3))
                           * (2.0 / (27 * 32)) ** 0.5).astype(np.float32))
    cts = torch.from_numpy(rng.standard_normal((2, 16, 20, 24, 64))
                           .astype(np.float32))
    outs = []
    for dev in ("cpu", "cuda"):
        xd, wd = (t.detach().to(dev).requires_grad_(True) for t in (xs, ws))
        y = _conv(xd, wd, (2, 2, 2))
        (y * cts.to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    for what, ref_t, got_t in zip(("y", "dx", "dW"), *outs):
        err_t = (got_t - ref_t).abs().max().item()
        scale_t = ref_t.abs().max().item()
        if not err_t <= REF_RTOL * scale_t:
            raise AssertionError(f"stride-2 conv {what} card vs CPU under "
                                 f"default flags: err {err_t} scale "
                                 f"{scale_t}")
        log(f"reference: stride-2 conv {what} {tuple(ref_t.shape)} under "
            f"default flags max_abs_err={err_t:.3e} "
            f"(tol {REF_RTOL * scale_t:.3e})")

    vol = torch.from_numpy(rng.standard_normal((40, 56, 70, 1))
                           .astype(np.float32))
    with torch.no_grad():
        ref_v = predict_volume(model, cpu_nets, vol, bucket_multiple=16)
        got_v = predict_volume(model, gpu_nets, vol.cuda(),
                               bucket_multiple=16).cpu()
    err_v = (got_v - ref_v).abs().max().item()
    scale_v = ref_v.abs().max().item()
    if not (got_v.shape == (40, 56, 70, N_CLASSES)
            and torch.isfinite(got_v).all() and err_v <= REF_RTOL * scale_v):
        raise AssertionError(f"predict_volume card vs CPU: err {err_v}")
    log(f"reference: predict_volume E=2 {tuple(vol.shape)} "
        f"max_abs_err={err_v:.3e} (tol {REF_RTOL * scale_v:.3e})")

    # the conv's autograd backward: dgrad through conv3x3 with flipped
    # weights, wgrad through conv3x3_wgrad
    from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3_op

    depth, H, W, C, CO = 6, 28, 40, 32, 32
    x = torch.from_numpy(rng.standard_normal((2 * depth, H, W, C))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, C, CO))
                          * (2.0 / (27 * C)) ** 0.5).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2 * depth, H, W, CO))
                          .astype(np.float32))
    outs = []
    for dev in ("cpu", "cuda"):
        xd, wd = (t.detach().to(dev).requires_grad_(True) for t in (x, w))
        y = conv3x3_op(xd, wd, depth=depth)
        (y * ct.to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    for what, ref_t, got_t in zip(("y", "dx", "dW"), *outs):
        err_t = (got_t - ref_t).abs().max().item()
        scale_t = ref_t.abs().max().item()
        if not err_t <= REF_RTOL * scale_t:
            raise AssertionError(f"conv3x3_op {what} card vs CPU: err "
                                 f"{err_t} scale {scale_t}")
        log(f"reference: conv3x3_op backward {what} {tuple(ref_t.shape)} "
            f"max_abs_err={err_t:.3e} (tol {REF_RTOL * scale_t:.3e})")
    reference_adaptation()
    reference_mind_gin()
    reference_deformable()


def _card_vs_cpu(what, got, ref, rtol):
    import torch

    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not (got.shape == ref.shape and torch.isfinite(got).all()
            and err <= rtol * scale):
        raise AssertionError(f"{what} card vs CPU under default flags: err "
                             f"{err} scale {scale} (rtol {rtol})")
    log(f"reference: {what} {tuple(ref.shape)} under default flags "
        f"max_abs_err={err:.3e} (tol {rtol * scale:.3e})")


def reference_mind_gin():
    """MIND on a 2-patch batch and GIN on one patch (112 x 112 x 128, with
    injected noise and draws), then the full-width TS104_GIN_MIND net's
    forward and one step's gradient on a small patch, card against CPU
    under PyTorch's default flags: GIN's grouped conv runs in cuDNN, where
    TF32 is on by default, and must not use it."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.ops.gin import draw_gin, gin_aug
    from dg_tta_tpu_torch.ops.mind import MIND_OUT_CHANNELS, mind3d

    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.standard_normal((2, *PATCH, 1))
                           .astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(
        (2, *PATCH, MIND_OUT_CHANNELS)).astype(np.float32))
    _card_vs_cpu("mind3d", mind3d(img.cuda(), noise=noise.cuda()).cpu(),
                 mind3d(img, noise=noise), MIND_RTOL)
    draws = draw_gin(torch.Generator().manual_seed(5), 1, 1)
    _card_vs_cpu("gin_aug", gin_aug(img[:1].cuda(), draws).cpu(),
                 gin_aug(img[:1], draws), GIN_RTOL)
    # their times at the main path's shapes: MIND of a trained step's 2B
    # patches and of one window, GIN of one branch's patch
    img_c, noise_c = img.cuda(), noise.cuda()
    log(f"reference: on the card, mind3d 2 x {PATCH} "
        f"{time_ms(lambda: mind3d(img_c, noise=noise_c)):.3f} ms, 1 x "
        f"{PATCH} {time_ms(lambda: mind3d(img_c[:1], noise=noise_c[:1])):.3f}"
        f" ms; gin_aug 1 x {PATCH} "
        f"{time_ms(lambda: gin_aug(img_c[:1], draws)):.3f} ms (CUDA events, "
        f"10 calls after 2)")

    model = ts104_model(patch_size=(32, 48, 64),
                        trainer="nnUNetTrainer_GIN_MIND")
    x = torch.from_numpy(rng.standard_normal((1, 32, 48, 64, 1))
                         .astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(
        (1, 32, 48, 64, MIND_OUT_CHANNELS)).astype(np.float32))
    outs, grads = [], []
    ct = None
    for dev in ("cpu", "cuda"):
        net = seeded_net(model, 13, dev)
        y = model.apply(net, x.to(dev), mind_noise=noise.to(dev))
        if ct is None:
            ct = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                                  .astype(np.float32))
        (y * ct.to(dev)).sum().backward()
        outs.append(y.detach().cpu())
        grads.append({k: p.grad.cpu() for k, p in net.named_parameters()
                      if p.grad is not None})
    _card_vs_cpu("TS104_GIN_MIND U-Net f32 forward", outs[1], outs[0],
                 REF_RTOL)
    if sorted(grads[0]) != sorted(grads[1]):
        raise AssertionError("TS104_GIN_MIND gradient: card and CPU differ "
                             "in which parameters get a gradient")
    names = sorted(grads[0])
    flat = [torch.cat([g[k].flatten() for k in names]) for g in grads]
    g_rel = ((flat[1] - flat[0]).norm() / flat[0].norm()).item()
    if not (torch.isfinite(flat[1]).all() and g_rel <= GRAD_RTOL):
        raise AssertionError(f"TS104_GIN_MIND f32 gradient card vs CPU: "
                             f"{g_rel} of its norm (tol {GRAD_RTOL})")
    log(f"reference: TS104_GIN_MIND U-Net f32 gradient of one step under "
        f"default flags, {len(names)} parameters: error {g_rel:.3e} of its "
        f"norm (tol {GRAD_RTOL:.0e})")


def reference_adaptation(features=None):
    """The adaptation of the full-width TS104_GIN net (with `features`,
    the ragged net's widths: `RAGGED_FEATURES`) on a small patch, on the
    card against the CPU, with the same injected draws: one patch step's
    gradient, then a short `tta_one_volume`.

    Tolerances: the consistency loss compares two nearly equal branches,
    so its gradient is a sum that mostly cancels, and f32 rounding in
    another order moves it by up to about 1% of a parameter's norm.
    AdamW then steps ~lr x sign(gradient): the entries whose gradient is
    near zero step either way, so after two trained epochs a parameter's
    update moves by up to about 12%.  Gradients are held to 5% of each
    parameter's norm and updates to 30%; a missing or wrong backward, or
    no update, misses by 100%."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.core.patches import extract_batch
    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import make_tta_functions, tta_one_volume
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    model = ts104_model(patch_size=(32, 48, 64), features=features)
    net_name = "TS104" if features is None else f"ragged net {features}"
    # two trained epochs: the losses of the last one follow an update
    plan = TTAPlan(epochs=3, patches_to_be_accumulated=2, ensemble_count=1,
                   start_tta_at_epoch=1)
    rng = np.random.default_rng(3)
    shape = (40, 56, 70)
    vol = rng.normal(0.0, 0.3, size=(1, *shape, 1)).astype(np.float32)
    lab = np.zeros((1, *shape, 1), np.float32)
    vol[0, 10:25, 15:40, 20:50] += 2.0
    lab[0, 10:25, 15:40, 20:50] = 1.0
    idx = np.arange(N_OPT)
    net0 = seeded_net(model, 11, "cpu")
    with torch.no_grad():
        # nonzero conv biases (unused before InstanceNorm), so that their
        # weight decay shows
        for name, p in net0.named_parameters():
            if name.endswith("conv.bias"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape)))
    init = {k: v.clone() for k, v in net0.state_dict().items()}

    fns = make_tta_functions(model, plan, idx, idx)
    draws = TorchDraws(seed=7).patch(0, 1, 0, 1, 1)
    grads = []
    for dev in ("cpu", "cuda"):
        net = copy.deepcopy(net0).to(dev)
        imgs, _ = extract_batch(draws.vol_idx, draws.uniforms,
                                torch.from_numpy(vol).to(dev), [shape],
                                model.patch_size, 1)
        fns.patch_loss(net, draws, imgs).backward()
        grads.append({k: p.grad.cpu() for k, p in net.named_parameters()
                      if p.grad is not None})
    if sorted(grads[0]) != sorted(grads[1]):
        raise AssertionError("patch step: card and CPU differ in which "
                             "parameters get a gradient")
    g_rel = max((grads[1][k] - g).norm().item() / g.norm().item()
                for k, g in grads[0].items())
    if not g_rel <= 0.05:
        raise AssertionError(f"patch step gradient card vs CPU: {g_rel}")

    runs = []
    for dev in ("cpu", "cuda"):
        nets, losses, dices = tta_one_volume(
            model, plan, copy.deepcopy(net0).to(dev),
            torch.from_numpy(vol).to(dev), [shape], idx, idx,
            TorchDraws(seed=7), labels_padded=torch.from_numpy(lab).to(dev))
        runs.append((nets[0].cpu().state_dict(), losses, dices))
    (ref_p, ref_l, ref_d), (got_p, got_l, got_d) = runs
    # parameters the loss never reaches (conv biases before InstanceNorm,
    # unused heads and logit channels) decay by exactly (1 - lr x weight
    # decay) per trained epoch: 1e-6 relative
    decay = (1.0 - plan.lr * 0.01) ** (plan.epochs - plan.start_tta_at_epoch)
    p_rel, moved = 0.0, 0
    for k, p0 in init.items():
        ref_dp, got_dp = ref_p[k] - p0, got_p[k] - p0
        ref_n, err = ref_dp.norm().item(), (got_dp - ref_dp).norm().item()
        # every nonzero parameter moves, by its gradient or its decay; a
        # zero one with no gradient (a head's bias) stays zero
        if (p0.norm().item() > 0 and ref_n == 0) or err > 0.3 * ref_n:
            raise AssertionError(f"tta_one_volume card vs CPU: update of {k}"
                                 f" off by {err} of {ref_n}")
        if ref_n > 0:
            moved += 1
            p_rel = max(p_rel, err / ref_n)
        if k.endswith("conv.bias") and not torch.allclose(
                got_p[k], decay * p0, rtol=1e-6, atol=0):
            raise AssertionError(f"tta_one_volume: {k} not decayed by "
                                 f"{decay}")
    # losses: the same math in another summation order
    l_err = float(np.abs(got_l - ref_l).max() / np.abs(ref_l).max())
    if not (np.all(np.isfinite(got_l)) and l_err <= 1e-3
            and np.all(np.abs(got_d - ref_d) <= 2e-2)):
        raise AssertionError(f"tta_one_volume card vs CPU: losses "
                             f"{got_l.ravel()} vs {ref_l.ravel()}, dices "
                             f"{got_d.ravel()} vs {ref_d.ravel()}")
    log(f"reference: {net_name} patch {model.patch_size}, one patch step: "
        f"{len(grads[0])} gradients, largest error {g_rel:.3e} of its norm "
        f"(tol 5e-2)")
    log(f"reference: tta_one_volume {net_name} patch {model.patch_size}, "
        f"1 member "
        f"x {plan.epochs} epochs x {plan.patches_to_be_accumulated} patches: "
        f"losses {got_l.ravel()} vs CPU {ref_l.ravel()} (rel err "
        f"{l_err:.2e}, tol 1e-3); dices {got_d.ravel()} vs "
        f"{ref_d.ravel()} (tol 2e-2); {moved} parameters updated, largest "
        f"update error {p_rel:.3e} of its norm (tol 3e-1); conv biases "
        f"decayed by {decay!r}")


def _stride1_convs(spec):
    """(C, CO, takes an input gradient) of every stride-1 3x3 conv of one
    forward of `spec`, in order; the first conv, on the image, takes no
    input gradient, and a stage's strided first conv runs in cuDNN."""
    f = spec.features_per_stage
    convs = []
    for s, n in enumerate(spec.n_conv_per_stage_encoder):
        for i in range(n):
            if i == 0 and tuple(spec.strides[s]) != (1, 1, 1):
                continue
            c_in = f[s] if i else (spec.num_input_channels if s == 0
                                   else f[s - 1])
            convs.append((c_in, f[s], not (s == 0 and i == 0)))
    for d, n in enumerate(spec.n_conv_per_stage_decoder):
        here = f[len(f) - 2 - d]
        convs += [(2 * here if i == 0 else here, here, True)
                  for i in range(n)]
    return convs


CONV_ROUTES = ("c1", "few", "wgmma", "wgmma_tf32x3", "cuda_core")
WGRAD_ROUTES = ("c1", "few", "wgmma", "wgmma_tf32x3", "cuda_core")


def _conv_launches(spec, forwards, trained, dtype):
    """The launches of `conv3x3` and `conv3x3_wgrad` for `forwards`
    forwards and `trained` trained steps of `spec` in compute type
    `dtype`: their totals, their launches on each route (`conv3x3_<route>`,
    `conv3x3_wgrad_<route>`, as `conv3x3_route` and `conv3x3_wgrad_route`
    pick them) and on zero-padded channels (`conv3x3_padded`,
    `conv3x3_wgrad_padded`).  A trained step runs each stride-1 conv's
    input gradient but the first's (its input takes none) and each one's
    weight gradient."""
    import torch

    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_route,
                                                  conv3x3_wgrad_route,
                                                  route_channels)

    dt = getattr(torch, dtype)
    out = {f"conv3x3_{r}": 0 for r in CONV_ROUTES}
    out.update({f"conv3x3_wgrad_{r}": 0 for r in WGRAD_ROUTES})
    out["conv3x3_padded"] = out["conv3x3_wgrad_padded"] = 0

    def add(kernel, route, c, n):
        out[f"{kernel}_{route}"] += n
        if route_channels(c, route) != c:
            out[f"{kernel}_padded"] += n

    for c, co, dgrad in _stride1_convs(spec):
        add("conv3x3", conv3x3_route(c, co, dt), c, forwards)
        if dgrad:
            add("conv3x3", conv3x3_route(co, c, dt), co, trained)
        add("conv3x3_wgrad", conv3x3_wgrad_route(c, co, dt), c, trained)
    out["conv3x3"] = sum(out[f"conv3x3_{r}"] for r in CONV_ROUTES)
    out["conv3x3_wgrad"] = sum(out[f"conv3x3_wgrad_{r}"]
                               for r in WGRAD_ROUTES)
    return out


def expected_launches(spec, windows, members, plan, dtype="float32",
                      exact=False, evals=1):
    """Kernel launches that `run_tta` must make for `plan` on a volume of
    `windows` sliding windows with labels (`evals` evaluations per epoch),
    in compute type `dtype`, with `DGTTA_EXACT_WARP_GRAD` set if `exact`:
    the conv kernels' (`_conv_launches`), and those of the warp's affine
    entry (`warp_affine`), grid entry (`warp`) and the exact adjoint's grid
    entry (`warp_adjoint`) and affine entry (`warp_affine_adjoint`).  An
    epoch runs patches_to_be_accumulated / patch_group patch steps (each
    launch carries patch_group patch draws), and with `remat` each trained
    step runs its forward twice (both branches recomputed in the backward:
    the convs, the input warps, the fields and the unwarps).  Per patch
    step, each branch the plan warps makes one input warp and one unwarp,
    and each trained step one adjoint
    of each unwarp: an affine plan's on the affine entry (with `exact`,
    the exact adjoint's affine entry); a deformable plan's on the grid
    entry, after the 10 field warps of its branch's displacement field (5
    iterations, 2 warps each; with `exact`, the exact adjoint's grid
    entry); each eval samples its labels on the affine entry, a launch
    per member.  The plan's `ensemble_chunk` (unset: 1, the default for a
    full-size patch on one card) runs that many members side by side: a
    chunk's patch steps and evals launch each kernel once for all its
    members, but its deformable fields member by member; inference runs
    every member's windows."""
    chunk = plan.get("ensemble_chunk") or 1
    seqs = -(-members // chunk)   # side-by-side launch sequences
    acc = (plan["patches_to_be_accumulated"]
           // plan.get("patch_group", 1))   # patch steps per epoch
    epochs = plan["epochs"]
    trained = acc * max(0, epochs - plan["start_tta_at_epoch"])
    # patch-step forwards, the trained ones' recomputes, the evals
    runs = acc * epochs + (trained if plan.get("remat") else 0)
    forwards = runs + evals * epochs
    out = _conv_launches(spec, seqs * forwards + members * windows,
                         seqs * trained, dtype)
    branches = {"both": 2, "none": 0}.get(
        plan.get("do_spatial_aug_in", "both"), 1)
    steps = runs * branches                # branch warps of patch steps
    adjoints = trained * branches
    fast = 0 if exact else adjoints
    deformable = plan.get("spatial_aug_type", "affine") == "deformable"
    if deformable:
        out["warp"] = members * steps * 10 + seqs * (steps * 2 + fast)
        out["warp_affine"] = members * evals * epochs
    else:
        out["warp"] = 0
        out["warp_affine"] = seqs * (steps * 2 + fast) \
            + members * evals * epochs
    exact_adjoints = seqs * adjoints if exact else 0
    out["warp_adjoint"] = exact_adjoints if deformable else 0
    out["warp_affine_adjoint"] = 0 if deformable else exact_adjoints
    return out


def _read_counts():
    from dg_tta_tpu_torch.kernels.counts import read_counts

    return read_counts()


def _zero_counts():
    from dg_tta_tpu_torch.kernels.counts import zero_counts

    zero_counts()


def phase_main_path(work: Path, dtype: str, pretrained: str = "TS104_GIN",
                    exact: bool = False, cli_args=(), ranks: int = 1,
                    **plan_changes):
    """`run_tta` of a seeded `pretrained` checkpoint through the CLI with
    `DGTTA_COMPUTE_DTYPE=dtype` (and `DGTTA_EXACT_WARP_GRAD=1` if `exact`),
    the smoke plan changed by `plan_changes`, `cli_args` appended; returns
    the kernels' launch counts of that run, each member's per-epoch
    losses (from its `*_tta_results.json`) and the member files' paths
    and the pretrained checkpoint's.  With `ranks` > 1 (Phase 1
    spread over that many processes by `cli_args`), the launches are this
    process's and the ranks' (`DGTTA_RANK_STATS_DIR`) summed, and
    `timings.json` must name the ranks."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.cli.main import main as cli
    from dg_tta_tpu_torch.data.io import read_image
    from dg_tta_tpu_torch.infer.sliding_window import (padded_shape,
                                                       window_origins)
    from dg_tta_tpu_torch.models.convert import load_flat_npz
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model
    from dg_tta_tpu_torch.obs.synthetic import edit_plan, make_workspace
    from dg_tta_tpu_torch.tta.config import (TS104_ALIASES,
                                             get_parameters_save_path)

    trainer = TS104_ALIASES[pretrained]
    ws = make_workspace(work, seed=0, shape=VOLUME_SHAPE, trainer=trainer)
    model = ts104_model(trainer=trainer)
    cli(["prepare_tta", pretrained, ws.dataset_id])
    results_dir, plan = edit_plan(pretrained, **SMOKE_PLAN, **plan_changes)
    n_members = plan["ensemble_count"]
    tag = (f"main path {pretrained} {plan['spatial_aug_type']} {dtype}"
           f"{' exact warp gradient' if exact else ''}"
           + (f" patch_group {plan['patch_group']}"
              if plan.get("patch_group", 1) > 1 else "")
           + (f" ensemble_chunk {plan['ensemble_chunk']}"
              if (plan.get("ensemble_chunk") or 1) > 1 else "")
           + (f" over {ranks} ranks" if ranks > 1 else ""))
    log(f"{tag}: {ws.n_params} parameters, {N_CLASSES} classes, "
        f"{model.spec.num_input_channels} input channels, volume "
        f"{VOLUME_SHAPE}, {n_members} members adapted from scratch; plan "
        f"cut in depth to {SMOKE_PLAN}, changed by {plan_changes}")

    windows = int(window_origins(padded_shape(VOLUME_SHAPE, model.patch_size),
                                 model.patch_size)[1].sum())
    expected = expected_launches(model.spec, windows, n_members, plan, dtype,
                                 exact)
    os.environ["DGTTA_COMPUTE_DTYPE"] = dtype
    if exact:
        os.environ["DGTTA_EXACT_WARP_GRAD"] = "1"
    stats = work / "rank_stats"
    stats.mkdir(parents=True, exist_ok=True)
    os.environ["DGTTA_RANK_STATS_DIR"] = str(stats)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        summaries = cli(["run_tta", pretrained, ws.dataset_id,
                         *cli_args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        del os.environ["DGTTA_COMPUTE_DTYPE"]
        del os.environ["DGTTA_RANK_STATS_DIR"]
        os.environ.pop("DGTTA_EXACT_WARP_GRAD", None)
    rank_stats = [json.loads(p.read_text())
                  for p in sorted(stats.glob("rank*.json"))]
    if len(rank_stats) != (ranks if ranks > 1 else 0):
        raise AssertionError(f"{tag}: {len(rank_stats)} ranks wrote their "
                             f"stats, expected {ranks}")
    for r in rank_stats:
        launches = {k: v + r["launches"][k] for k, v in launches.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected} from the plan")
    for key in ("conv3x3_cuda_core", "conv3x3_wgrad_cuda_core",
                "conv3x3_padded", "conv3x3_wgrad_padded"):
        if launches[key]:
            raise AssertionError(f"the main path launched {key} "
                                 f"{launches[key]} times")
    # a MIND model's stem runs on "few", every forward and weight gradient
    if model.spec.num_input_channels > 1 and not (
            launches["conv3x3_few"] and launches["conv3x3_wgrad_few"]):
        raise AssertionError(f"the stem of a {model.spec.num_input_channels}"
                             f"-channel model launched no \"few\" kernel")
    # the grid entry carries a deformable plan's warps and nothing of an
    # affine plan's; the exact adjoint runs with `exact` only, on the entry
    # of the plan's warps
    deformable = plan["spatial_aug_type"] == "deformable"
    if (launches["warp"] > 0) != deformable \
            or (launches["warp_adjoint"] > 0) != (exact and deformable) \
            or (launches["warp_affine_adjoint"] > 0) != (exact
                                                         and not deformable):
        raise AssertionError(f"the main path launched the grid entry "
                             f"{launches['warp']}, the exact adjoint's grid "
                             f"entry {launches['warp_adjoint']} and its "
                             f"affine entry {launches['warp_affine_adjoint']} "
                             f"times")
    (run_dir,) = [p for p in results_dir.iterdir() if p.is_dir()]
    pretrained = load_flat_npz(ws.checkpoint)
    losses, member_paths = [], []
    for i in range(n_members):
        path = get_parameters_save_path(run_dir / "tta_outputTs", "case", i)
        member_paths.append(path)
        losses.append(json.loads((path.parent / f"case__ensemble_idx_{i}"
                                  "_tta_results.json").read_text())["losses"])
        sd = load_flat_npz(path)
        if not all(torch.isfinite(v).all() for v in sd.values()):
            raise AssertionError(f"member {i}: non-finite parameters")
        if all(torch.equal(v, pretrained[k]) for k, v in sd.items()):
            raise AssertionError(f"member {i} equals the pretrained weights")
    pred, _ = read_image(run_dir / "tta_outputTs" / "case.nii.gz")
    if pred.shape != (1, *VOLUME_SHAPE):
        raise AssertionError(f"segmentation shape {pred.shape}")
    n_opt = len(plan["optimized_labels"])
    if not (np.isfinite(pred).all() and pred.min() >= 0
            and pred.max() < n_opt):
        raise AssertionError("segmentation labels out of range")
    if "Ts" not in summaries:
        raise AssertionError("no evaluation summary")
    timings = json.loads((run_dir / "timings.json").read_text())
    phases = timings["phases"]
    if not (timings["device"].startswith("cuda") and "adaptation" in phases
            and "inference" in phases and timings["ranks"] == ranks):
        raise AssertionError(f"timings.json: {timings}")
    if rank_stats:
        log(f"{tag}: ranks {[r['device'] for r in rank_stats]}, "
            f"{[round(r['seconds'], 2) for r in rank_stats]} s each, peak "
            f"device memory "
            f"{[round(r['peak_bytes'] / 2 ** 30, 2) for r in rank_stats]} "
            f"GiB; this process's launches (Phase 2) and the ranks' summed")
    adapt_s = phases["adaptation"]["total_s"]
    infer_s = phases["inference"]["total_s"]
    log(f"{tag}: run_tta {wall:.2f} s wall; phases "
        + ", ".join(f"{k}={v['total_s']:.2f}s" for k, v in phases.items()))
    log(f"{tag}: adaptation {adapt_s:.3f} s ({n_members} members"
        f" x {plan['epochs']} epochs x {plan['patches_to_be_accumulated']} "
        f"patches, {dtype}), inference {infer_s:.3f} s/volume = "
        f"{60.0 / infer_s:.2f} vol/min ({windows} windows x {n_members} "
        f"members), peak device memory {peak_gib:.2f} GiB; launches "
        f"{launches} (expected {expected}); foreground Dice "
        f"{summaries['Ts']['foreground_mean']['Dice']:.4f} (random weights)"
        f"; member losses {losses}")
    return launches, np.asarray(losses), (member_paths, ws.checkpoint)


def phase_remat():
    """One trained step of the full-width TS104_GIN net at the TS104 patch
    in f32, with and without `remat` (both branches recomputed in the
    backward, `torch.utils.checkpoint`): the same seeded weights and
    draws, the gradients held to each other at REMAT_GRAD_RTOL, each
    step's launches to `expected_launches` (a recomputed forward per
    trained step), and the ms and peak device memory of each printed.
    Each variant runs once to warm up, then once measured."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import make_tta_functions
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    model = ts104_model()
    rng = np.random.default_rng(4)
    vols = torch.from_numpy(rng.normal(0.0, 0.3, size=(1, *VOLUME_SHAPE, 1))
                            .astype(np.float32)).cuda()
    vols[0, 60:140, 80:160, 90:190] += 2.0
    shapes = [list(map(float, VOLUME_SHAPE))]
    idx = np.arange(N_OPT)
    draws = TorchDraws(seed=9).patch(0, 1, 0, 1, 1)
    net0 = seeded_net(model, 13, "cuda")
    out = {}
    for remat in (False, True):
        plan = TTAPlan(patches_to_be_accumulated=1)
        fns = make_tta_functions(model, plan, idx, idx, remat=remat)
        net = copy.deepcopy(net0)
        for measured in (False, True):
            net.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            loss = fns.draw_and_loss(net, draws, vols, shapes)
            loss.backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts()
        expected = expected_launches(
            model.spec, 0, 1, dict(patches_to_be_accumulated=1, epochs=1,
                                   start_tta_at_epoch=0, remat=remat),
            evals=0)
        if launches != expected:
            raise AssertionError(f"remat={remat} step: launches {launches}, "
                                 f"expected {expected}")
        grads = {k: p.grad.detach().clone() for k, p in net.named_parameters()
                 if p.grad is not None}
        out[remat] = (loss.item(), grads, ms,
                      torch.cuda.max_memory_allocated() / 2 ** 30, launches)
    (l0, g0, ms0, gib0, n0), (l1, g1, ms1, gib1, n1) = out[False], out[True]
    if sorted(g0) != sorted(g1):
        raise AssertionError("remat: another set of parameters got a "
                             "gradient")
    diff = math.sqrt(sum((g1[k] - g).double().norm().item() ** 2
                         for k, g in g0.items()))
    norm = math.sqrt(sum(g.double().norm().item() ** 2 for g in g0.values()))
    worst = max((g1[k] - g).norm().item() / max(g.norm().item(), 1e-30)
                for k, g in g0.items())
    if not (math.isfinite(l1) and diff <= REMAT_GRAD_RTOL * norm):
        raise AssertionError(f"remat: gradient off by {diff / norm:.3e} of "
                             f"its norm (tol {REMAT_GRAD_RTOL}), loss {l1} vs "
                             f"{l0}")
    log(f"remat: TS104_GIN one trained step at {model.patch_size}, f32, "
        f"batch 2 (both branches): loss {l1!r} vs {l0!r} without; gradient "
        f"off by {diff / norm:.3e} of its norm (tol {REMAT_GRAD_RTOL}), "
        f"largest per parameter {worst:.3e}; {ms1:.1f} ms vs {ms0:.1f} ms, "
        f"peak device memory {gib1:.2f} GiB vs {gib0:.2f} GiB without; "
        f"conv3x3 launches {n1['conv3x3']} vs {n0['conv3x3']}, warp_affine "
        f"{n1['warp_affine']} vs {n0['warp_affine']} (expected)")


def phase_repeat():
    """One member of the full-width TS104_GIN net adapted twice in this
    process on this card, f32, the smoke plan (2 epochs x 4 patches), the
    same seeded weights, volume and draws (`tta_one_volume`, one member):
    prints the largest relative difference of the two runs' losses, and of
    their updates (adapted - pretrained) per parameter and over all
    parameters at once.  Zero means a run is reproducible on the card, so a
    gap between a sharded and a one-process run (ROADMAP C) comes from
    the sharding; asserts nothing."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import tta_one_volume
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    model = ts104_model()
    plan = TTAPlan(ensemble_count=1, **SMOKE_PLAN)
    rng = np.random.default_rng(4)
    vol = torch.from_numpy(rng.normal(0.0, 0.3, size=(1, *VOLUME_SHAPE, 1))
                           .astype(np.float32)).cuda()
    vol[0, 60:140, 80:160, 90:190] += 2.0
    idx = np.arange(N_OPT)
    net0 = seeded_net(model, 13, "cuda")
    init = {k: v.detach().clone() for k, v in net0.state_dict().items()}
    runs = []
    for _ in range(2):
        nets, losses, _ = tta_one_volume(
            model, plan, copy.deepcopy(net0), vol,
            [list(map(float, VOLUME_SHAPE))], idx, idx, TorchDraws(seed=21))
        runs.append(({k: v.detach() - init[k]
                      for k, v in nets[0].state_dict().items()},
                     np.asarray(losses, np.float64)))
    (d0, l0), (d1, l1) = runs
    l_rel = float(np.max(np.abs(l1 - l0) / np.maximum(np.abs(l0), 1e-30)))
    per = [((d1[k] - d).norm() / d.norm()).item()
           for k, d in d0.items() if d.norm().item() > 0]
    whole = math.sqrt(sum((d1[k] - d).double().norm().item() ** 2
                          for k, d in d0.items()))
    norm = math.sqrt(sum(d.double().norm().item() ** 2 for d in d0.values()))
    log(f"repeat: TS104_GIN f32, one member x {plan.epochs} epochs x "
        f"{plan.patches_to_be_accumulated} patches, run twice in one "
        f"process: losses {l1.ravel().tolist()} vs {l0.ravel().tolist()} "
        f"(max rel diff {l_rel:.3e}); updates off by {whole / norm:.3e} of "
        f"their norm, largest per parameter {max(per):.3e} "
        f"({sum(p > 0 for p in per)} of {len(per)} parameters differ)")
    return l_rel, whole / norm


def phase_ragged_tta():
    """The ragged net (`RAGGED_FEATURES`: widths 30 .. 300, half of its
    stride-1 convs on the catch-all route) adapted through
    `tta/engine.tta_one_volume` at full width (the TS104 patch, 105
    classes, seeded weights) on `phase_repeat`'s volume, the smoke plan (2
    epochs x 4 patches) for 3 members, once per `RAGGED_RUNS` entry: f32
    one member at a time, bf16 one at a time, bf16 with CHUNK members
    side by side.  Each run's launches are held to `expected_launches`
    (the catch-all's above 0), its losses must be finite and every member
    moved; the chunk run's members are held to the serial bf16 run's as
    `check_member_chunk` holds the main path's (losses CHUNK_LOSS_RTOL,
    updates CHUNK_UPDATE_RTOL of their norm).  The card-vs-CPU check of
    this net is `reference_adaptation(RAGGED_FEATURES)`.  Returns {(name,
    dtype): launches} for the kernels line."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.obs.profile_inference import seeded_net
    from dg_tta_tpu_torch.tta.draws import TorchDraws
    from dg_tta_tpu_torch.tta.engine import tta_one_volume
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    members = 3
    rng = np.random.default_rng(4)
    vol = torch.from_numpy(rng.normal(0.0, 0.3, size=(1, *VOLUME_SHAPE, 1))
                           .astype(np.float32)).cuda()
    vol[0, 60:140, 80:160, 90:190] += 2.0
    idx = np.arange(N_OPT)
    launches, results = {}, {}
    for dtype, chunk in RAGGED_RUNS:
        model = ragged_model(
            compute_dtype=None if dtype == "float32" else dtype)
        plan = TTAPlan(ensemble_count=members, **SMOKE_PLAN)
        net0 = seeded_net(model, 13, "cuda")
        init = {k: v.detach().clone() for k, v in net0.state_dict().items()}
        expected = expected_launches(
            model.spec, 0, members, dict(SMOKE_PLAN, ensemble_chunk=chunk),
            dtype, evals=0)
        key = (f"ragged{f' ensemble_chunk {chunk}' if chunk > 1 else ''}",
               dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        nets, losses, _ = tta_one_volume(
            model, plan, net0, vol, [list(map(float, VOLUME_SHAPE))], idx,
            idx, TorchDraws(seed=21), ensemble_chunk=chunk, num_devices=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_counts()
        if got != expected:
            raise AssertionError(f"{key}: launches {got}, expected "
                                 f"{expected}")
        if not (got["conv3x3_cuda_core"] > 0
                and got["conv3x3_wgrad_cuda_core"] > 0):
            raise AssertionError(f"{key}: the catch-all route launched "
                                 f"{got['conv3x3_cuda_core']} forwards and "
                                 f"{got['conv3x3_wgrad_cuda_core']} weight "
                                 f"gradients")
        losses = np.asarray(losses, np.float64)
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{key}: losses {losses.tolist()}")
        states = [{k: v.detach().clone() for k, v in n.state_dict().items()}
                  for n in nets]
        for i, sd in enumerate(states):
            if all(torch.equal(v, init[k]) for k, v in sd.items()):
                raise AssertionError(f"{key}: member {i} did not move")
        launches[key] = got
        results[key] = (losses, states, init)
        log(f"ragged TTA {model.spec.features_per_stage} {dtype}, {members} "
            f"members x {plan.epochs} epochs x "
            f"{plan.patches_to_be_accumulated} patches, ensemble_chunk "
            f"{chunk}: {wall:.2f} s wall, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"launches {got} (expected); losses {losses.T.tolist()}")
        del nets, net0
    # the chunk run's members against the serial run of its type
    (s_l, s_sd, init), (c_l, c_sd, _) = (
        results["ragged", "bfloat16"],
        results[f"ragged ensemble_chunk {CHUNK}", "bfloat16"])
    loss_rel = float(np.max(np.abs(c_l - s_l) / np.abs(s_l)))
    upd = []
    for got, ref in zip(c_sd, s_sd):
        diff = sum(((got[k].double() - ref[k].double()).norm() ** 2).item()
                   for k in ref)
        norm = sum(((ref[k].double() - init[k].double()).norm() ** 2)
                   .item() for k in ref)
        upd.append(math.sqrt(diff / norm))
    log(f"ragged TTA bfloat16: {CHUNK} members side by side against one "
        f"after another: losses max rel diff {loss_rel:.3e} (tol "
        f"{CHUNK_LOSS_RTOL['bfloat16']}); member updates off by "
        f"{[f'{u:.3e}' for u in upd]} of their norm (tol "
        f"{CHUNK_UPDATE_RTOL['bfloat16']})")
    if not (loss_rel <= CHUNK_LOSS_RTOL["bfloat16"]
            and max(upd) <= CHUNK_UPDATE_RTOL["bfloat16"]):
        raise AssertionError("ragged TTA: the chunk's members miss the "
                             "serial run's")
    return launches


def check_member_chunk(dtype, serial, chunk, repeat):
    """The main path's chunk run (`ensemble_chunk` CHUNK: the smoke plan's
    members side by side) against the serial run of type `dtype`, each a
    `phase_main_path` result: every conv route's launches of the
    adaptation (the run's launches less inference's, a forward per window
    and member) are 1 / CHUNK of the serial run's; the members' epoch
    losses within CHUNK_LOSS_RTOL and each member's update within
    CHUNK_UPDATE_RTOL of its norm.  Prints the gaps beside
    `phase_repeat`'s (`repeat`: its loss and update gaps) and the
    several-rank run's (ROADMAP C: updates 4-5e-3 of their norm)."""
    import numpy as np

    from dg_tta_tpu_torch.infer.sliding_window import (padded_shape,
                                                       window_origins)
    from dg_tta_tpu_torch.models.convert import load_flat_npz
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model

    (s_runs, s_losses, (s_paths, ckpt)) = serial
    (c_runs, c_losses, (c_paths, _)) = chunk
    model = ts104_model()
    windows = int(window_origins(padded_shape(VOLUME_SHAPE, model.patch_size),
                                 model.patch_size)[1].sum())
    infer = _conv_launches(model.spec, len(s_paths) * windows, 0, dtype)
    ratios = {}
    for k, n in infer.items():
        adapt_s, adapt_c = s_runs[k] - n, c_runs[k] - n
        if adapt_s != CHUNK * adapt_c:
            raise AssertionError(f"member chunk {dtype}: {k} adapted with "
                                 f"{adapt_c} launches, the serial run with "
                                 f"{adapt_s}; expected a {CHUNK}th")
        if adapt_s:
            ratios[k] = f"{adapt_c}/{adapt_s}"
    loss_rel = float(np.max(np.abs(c_losses - s_losses)
                            / np.abs(s_losses)))
    init = load_flat_npz(ckpt)
    upd = []
    for a, b in zip(c_paths, s_paths):
        got, ref = load_flat_npz(a), load_flat_npz(b)
        diff = sum(((got[k] - ref[k]).double().norm() ** 2).item()
                   for k in ref)
        norm = sum(((ref[k] - init[k]).double().norm() ** 2).item()
                   for k in ref)
        upd.append(math.sqrt(diff / norm))
    log(f"member chunk {dtype}: {CHUNK} members side by side against one "
        f"after another: adaptation launches chunk/serial {ratios}; "
        f"losses {c_losses.tolist()} vs {s_losses.tolist()}, max rel diff "
        f"{loss_rel:.3e} (tol {CHUNK_LOSS_RTOL[dtype]}); member updates off "
        f"by {[f'{u:.3e}' for u in upd]} of their norm (tol "
        f"{CHUNK_UPDATE_RTOL[dtype]}); beside: phase_repeat's f32 rerun "
        f"{repeat[0]:.3e} (losses) and {repeat[1]:.3e} (updates), the "
        f"several-rank run's updates 4-5e-3 (ROADMAP C)")
    if not (loss_rel <= CHUNK_LOSS_RTOL[dtype]
            and max(upd) <= CHUNK_UPDATE_RTOL[dtype]):
        raise AssertionError(f"member chunk {dtype}: the members miss the "
                             f"serial run's")


def _pretrain_warp_sites(gen):
    """The warps of one pretraining step at the TS104 patch, batch 2 (the
    augmentation's draws with rotation, scale and the low-resolution
    simulation on): (name, entry, mode, padding, output shape, theta or
    grid).  The affine entry warps the image and the labels by one theta;
    the grid entry takes the low-resolution grid and the deep-supervision
    targets' identity grids at 1/2 and 1/4 (the 1/8 head has weight 0)."""
    import torch

    from dg_tta_tpu_torch.core.grid import identity_grid
    from dg_tta_tpu_torch.train.augment import (DAConfig, _lowres_grid,
                                                draw_sample,
                                                rot_scale_affine)

    cfg = DAConfig(p_rotation=1.0, p_scale=1.0, p_lowres=1.0)
    draws = [draw_sample(gen, cfg, None) for _ in range(2)]
    theta = torch.stack([rot_scale_affine(d) for d in draws]).cuda()
    sites = [("augmentation image", "affine", "trilinear", "border", PATCH,
              theta),
             ("augmentation labels", "affine", "nearest", "zeros", PATCH,
              theta),
             ("low-resolution simulation", "grid", "trilinear", "border",
              PATCH, _lowres_grid([d.lowres for d in draws], PATCH, "cuda"))]
    for f in (2, 4):
        out = tuple(p // f for p in PATCH)
        sites.append((f"target 1/{f}", "grid", "nearest", "border", out,
                      tuple(c[None] for c in identity_grid(out,
                                                           device="cuda"))))
    return sites


def phase_warp_pretrain():
    """The warp kernel at the sites of a pretraining step (C = 1, batch 2):
    the augmentation's spatial transform on the affine entry (image
    trilinear with border padding, labels nearest with zeros), the
    low-resolution simulation and the deep-supervision targets (nearest
    with border padding: every sample of a stride-2 target lies on a
    rounding tie) on the grid entry; each against its plain version
    (nearest bit for bit), timed against its plain version and
    `F.grid_sample`.  Returns the step's totals per entry."""
    import torch
    import torch.nn.functional as F

    from dg_tta_tpu_torch.core.grid import affine_grid, pack_grid
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                               warp_affine_reference,
                                               warp_bytes, warp_flat,
                                               warp_flat_reference,
                                               warp_flops,
                                               warp_source_voxels)

    gen = torch.Generator().manual_seed(5)
    n_src = PATCH[0] * PATCH[1] * PATCH[2]
    totals = {"affine": _new_totals(), "grid": _new_totals()}
    for site, entry, mode, pad, out, where in _pretrain_warp_sites(gen):
        n_out = out[0] * out[1] * out[2]
        if mode == "nearest":
            flat = torch.randint(0, N_CLASSES, (2, 1, n_src),
                                 generator=gen).float().cuda()
        else:
            flat = torch.randn((2, 1, n_src), generator=gen).cuda()
        kw = dict(mode=mode, padding_mode=pad)
        if entry == "affine":
            grid = affine_grid(where, out)

            def kernel():
                return warp_affine_flat(flat, PATCH, where, out, **kw)

            def plain():
                return warp_affine_reference(flat, PATCH, where, out, **kw)
        else:
            grid = where

            def kernel():
                return warp_flat(flat, PATCH, grid, **kw)

            def plain():
                return warp_flat_reference(flat, PATCH, grid, **kw)
        got, ref = kernel(), plain()
        err = (got - ref).abs().max().item()
        tol = 0.0 if mode == "nearest" else \
            WARP_RTOL["float32"] * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"warp pretraining {site}: max abs err "
                                 f"{err} > {tol}")
        vol5 = flat.view(2, 1, *PATCH)
        packed = pack_grid(tuple(c.expand(2, *out) for c in grid))
        lib_mode = "bilinear" if mode == "trilinear" else "nearest"
        with tf32_off():
            p_ms = time_ms(plain)
            l_ms = time_ms(lambda: F.grid_sample(
                vol5, packed, mode=lib_mode, padding_mode=pad,
                align_corners=False))
        k_ms = time_ms(kernel)
        n_need = warp_source_voxels(PATCH, grid, 2, mode, pad)
        ops_ms = warp_flops(flat.shape, n_out, mode) \
            / PEAK_OPS["float32"] * 1e3
        # theta's 48 bytes a sample, or the grid's 3 f32 coordinates per
        # output voxel of each of its samples (the targets' grid has one)
        bytes_ms = warp_bytes(flat.shape, n_need, n_out, 4,
                              2 * 48 if entry == "affine"
                              else 12 * where[0].shape[0] * n_out) \
            / PEAK_BYTES * 1e3
        _record(totals[entry], err, k_ms, p_ms, l_ms, ops_ms, bytes_ms)
        log(f"warp pretraining {site}: {entry} entry, {mode} {pad}, batch 2 "
            f"{PATCH}->{out}: max_abs_err={err:.3e} (tol {tol:.3e}) "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"library_ms={l_ms:.4f} bound_ms={max(ops_ms, bytes_ms):.4f}")
    for entry, t in totals.items():
        log(f"warp pretraining step, {entry} entry: kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
            f"bound_ms={max(t['ops_ms'], t['bytes_ms']):.4f}")
    return totals


def reference_pretrain():
    """One pretraining step of the full-width TS104_GIN_MIND net (config 5)
    on a small patch, the card against the CPU under PyTorch's default
    flags, on the same weights and draws (every augmentation gate on: both
    warp entries, noise, blur, gamma; GIN, MIND with noise, deep
    supervision, SGD); and MultiRes's operators at the patch size with
    matmul TF32 turned on around the call (the function turns it off)."""
    import dataclasses

    import numpy as np
    import torch

    from dg_tta_tpu_torch.obs.profile_inference import seeded_net, ts104_model
    from dg_tta_tpu_torch.obs.synthetic import synthetic_ct
    from dg_tta_tpu_torch.train.augment import (MULTIRES_ZOOMS, DAConfig,
                                                _discrete_lowres)
    from dg_tta_tpu_torch.train.pretrain import (PretrainDraws, StepDraws,
                                                 make_optimizer,
                                                 make_train_step)

    shape = (32, 48, 64)
    model = ts104_model(patch_size=shape, trainer="nnUNetTrainer_GIN_MIND")
    rng = np.random.default_rng(3)
    vols, labels = zip(*(synthetic_ct(rng, shape) for _ in range(2)))
    imgs = torch.from_numpy(np.stack(vols).astype(np.float32) / 500.0)
    segs = torch.from_numpy(np.stack(labels).astype(np.float32))
    cfg = DAConfig(p_rotation=1.0, p_scale=1.0, p_noise=1.0, p_blur=1.0,
                   p_brightness=1.0, p_contrast=1.0, p_lowres=1.0,
                   p_gamma_invert=1.0, p_gamma=1.0)
    d = PretrainDraws(0).step(0, 0, 2, cfg, gin=True)

    def fixed(t):
        return lambda shape, device: t.to(device)

    # the normal draws made once on the CPU and handed to both devices
    draws = StepDraws(
        da=tuple(dataclasses.replace(s, noise=fixed(s.noise((*shape, 1),
                                                            "cpu")))
                 for s in d.da),
        gin=d.gin, mind_noise=fixed(d.mind_noise((2, *shape, 12), "cpu")))
    step = make_train_step(model, cfg)
    losses, updates = [], []
    for dev in ("cpu", "cuda"):
        net = seeded_net(model, 21, dev)
        before = [p.detach().cpu().clone() for p in net.parameters()]
        loss = step(net, make_optimizer(net), imgs[..., None].to(dev),
                    segs[..., None].to(dev), draws, 1e-2)
        losses.append(float(loss))
        updates.append(torch.cat([(p.detach().cpu() - b).flatten()
                                  for p, b in zip(net.parameters(), before)]))
    l_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    u_rel = ((updates[1] - updates[0]).norm() / updates[0].norm()).item()
    if not (np.isfinite(losses[1]) and torch.isfinite(updates[1]).all()
            and l_rel <= PRETRAIN_LOSS_RTOL and u_rel <= GRAD_RTOL):
        raise AssertionError(f"pretraining step card vs CPU: loss "
                             f"{losses} ({l_rel}), update {u_rel}")
    log(f"reference: pretraining step nnUNetTrainer_GIN_MIND full width, "
        f"batch 2 x {shape}, every augmentation gate on, under default "
        f"flags: loss {losses[1]:.6f} vs CPU {losses[0]:.6f} ({l_rel:.3e}, "
        f"tol {PRETRAIN_LOSS_RTOL:.0e}); the SGD update {u_rel:.3e} of its "
        f"norm (tol {GRAD_RTOL:.0e})")
    x = torch.from_numpy(rng.standard_normal((*PATCH, 1)).astype(np.float32))
    ref = _discrete_lowres(x, (0, 1, 2), MULTIRES_ZOOMS, PATCH)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = _discrete_lowres(x.cuda(), (0, 1, 2), MULTIRES_ZOOMS,
                               PATCH).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    _card_vs_cpu("MultiRes operators, zooms 1/6, 1/4, 1/2, matmul TF32 on "
                 "around the call", got, ref, MULTIRES_RTOL)


def expected_pretrain_launches(spec, steps, val_batches, multires,
                               dtype="float32"):
    """Kernel launches of `steps` pretraining iterations and `val_batches`
    validation batches of `spec` (batch 2: one launch a conv): the conv
    kernels' (`_conv_launches`; the stem takes no input gradient); per
    step, two of the warp's affine entry (the augmentation's image and
    labels), one of its grid entry for the continuous low-resolution
    simulation (none with MultiRes, a tensordot) and one for each
    deep-supervision head of nonzero weight below full resolution (its
    target); none of the exact adjoint."""
    from dg_tta_tpu_torch.train.losses import deep_supervision_weights

    out = _conv_launches(spec, steps + val_batches, steps, dtype)
    heads = deep_supervision_weights(len(spec.n_conv_per_stage_decoder))
    targets = sum(1 for w in heads[1:] if w)
    out["warp_affine"] = 2 * steps
    out["warp"] = steps * ((0 if multires else 1) + targets)
    out["warp_adjoint"] = out["warp_affine_adjoint"] = 0
    return out


def phase_pretrain(work: Path):
    """DG pretraining through `run_pretraining` on three synthetic CTs at
    the full TS104 width (`obs/synthetic.make_pretrain_dataset`), f32: the
    runs of the PRETRAIN_* constants, each with the counts zeroed before and
    read after, held to `expected_pretrain_launches`; a finite logged loss
    per epoch; the checkpoints read back by the port's `run_tta` bundle
    loader; then a profiled step (ms, device busy share, kernels per step,
    peak memory: `obs/profile_pretrain.profile_steps`).  Returns each run's
    launch counts, and what `phase_parallel`'s data-parallel runs are held
    to: the dataset, its plans and the GIN_MIND run's initial weights, and
    its logs and final weights after PRETRAIN_EPOCHS and after the
    resumed epoch ("runs")."""
    import torch

    from dg_tta_tpu_torch.models.convert import load_flat_npz
    from dg_tta_tpu_torch.models.network import MULTIRES_TRAINERS, build_model
    from dg_tta_tpu_torch.obs.profile_pretrain import profile_steps
    from dg_tta_tpu_torch.obs.synthetic import make_pretrain_dataset
    from dg_tta_tpu_torch.train.pretrain import run_pretraining
    from dg_tta_tpu_torch.tta.driver import load_pretrained_bundle

    t0 = time.perf_counter()
    dataset_id, plans = make_pretrain_dataset(work)
    dataset_json = {"labels": {f"c{i}": i for i in range(N_CLASSES)},
                    "channel_names": {"0": "CT"}}
    log(f"pretraining: dataset of 3 synthetic CTs written in "
        f"{time.perf_counter() - t0:.1f} s")
    gin_mind, multires = "nnUNetTrainer_GIN_MIND", "nnUNetTrainer_GIN_MultiRes"
    runs = {}
    ref = dict(work=Path(work), dataset_id=dataset_id, plans=plans,
               dataset_json=dataset_json, runs=[])
    for tag, trainer, epochs, iters, resume in (
            ("GIN_MIND", gin_mind, (0, PRETRAIN_EPOCHS), PRETRAIN_ITERS,
             False),
            ("GIN_MultiRes", multires, (0, 1), PRETRAIN_MULTIRES_ITERS, False),
            ("GIN_MIND resumed", gin_mind,
             (PRETRAIN_EPOCHS, PRETRAIN_EPOCHS + 1), PRETRAIN_ITERS, True)):
        model = build_model(plans, dataset_json, trainer)
        n = epochs[1] - epochs[0]
        expected = expected_pretrain_launches(
            model.spec, n * iters, n * PRETRAIN_VAL_ITERS,
            trainer in MULTIRES_TRAINERS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        out = run_pretraining(dataset_id, trainer_name=trainer,
                              num_epochs=epochs[1], iters_per_epoch=iters,
                              val_iters_per_epoch=PRETRAIN_VAL_ITERS,
                              plans=plans, continue_training=resume,
                              verbose=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if launches != expected:
            raise AssertionError(f"pretraining {tag}: kernel launches "
                                 f"{launches}, expected {expected}")
        for key in ("conv3x3_cuda_core", "conv3x3_wgrad_cuda_core",
                    "conv3x3_padded", "conv3x3_wgrad_padded"):
            if launches[key]:
                raise AssertionError(f"pretraining {tag} launched {key} "
                                     f"{launches[key]} times")
        log_lines = (out / "training_log.jsonl").read_text().splitlines()
        entries = [json.loads(line) for line in log_lines]
        if [e["epoch"] for e in entries] != list(range(epochs[1])) or \
                not all(math.isfinite(e["loss"]) for e in entries):
            raise AssertionError(f"pretraining {tag}: log {entries}")
        _, net, _, _ = load_pretrained_bundle(out / "checkpoint_final.npz",
                                              device="cuda")
        saved = load_flat_npz(out / "checkpoint_final.npz")
        if not all(torch.equal(v.cpu(), saved[k]) and torch.isfinite(v).all()
                   for k, v in net.state_dict().items()):
            raise AssertionError(f"pretraining {tag}: checkpoint_final.npz "
                                 f"does not load back")
        new = entries[epochs[0]:]
        train_s = sum(e["train_seconds"] for e in new)
        log(f"pretraining {tag}: {trainer}, epochs {epochs[0]}..{epochs[1]} "
            f"x {iters} iterations + {PRETRAIN_VAL_ITERS} validation batches "
            f"(batch 2 x {PATCH}, f32): run_pretraining {wall:.2f} s wall, "
            f"training {1e3 * train_s / (n * iters):.1f} ms/iteration "
            f"(first iteration included), losses "
            f"{[round(e['loss'], 5) for e in new]}, val pseudo-Dice "
            f"{[round(e['val_pseudo_dice'], 5) for e in new]}, peak device "
            f"memory {peak_gib:.2f} GiB; launches {launches} (expected "
            f"{expected}); checkpoint_final.npz read by the run_tta bundle "
            f"loader")
        runs[f"pretrain {tag}", "float32"] = launches
        if trainer == gin_mind:
            ref["runs"].append((entries, saved))
            # run_pretraining's initial weights (its default seed, 0)
            ref["init"] = model.init_params(torch.Generator().manual_seed(0))
    prof = profile_steps(plans, gin_mind, steps=2)
    log(f"pretraining profile: {gin_mind} {prof['ms_per_step']:.1f} ms/step, "
        f"device busy {prof['busy_ms']:.1f} ms/step (busy share "
        f"{1 - prof['idle_share']:.3f}), {prof['kernels_per_step']:.1f} "
        f"device kernels per step, peak device memory "
        f"{prof['peak_gib']:.2f} GiB")
    return runs, ref


def _dp_pretraining(work: Path, pre):
    """`run_pretraining(num_devices=DP_RANKS, backend="gloo")` of
    TS104_GIN_MIND on `phase_pretrain`'s dataset, at its PRETRAIN_EPOCHS x
    PRETRAIN_ITERS (batch 2, one patch a rank), then resumed for one more
    epoch; each run held to the one-process run's (`pre`): launches
    summed over the ranks (`DGTTA_RANK_STATS_DIR`) to DP_RANKS times
    `expected_pretrain_launches`, the logged losses and
    `checkpoint_final.npz`'s whole update at DP_STEP_RTOL, its parameters'
    at DP_LEAF_RTOL (`parallel/dryrun.update_errors`).  Returns each run's
    launch counts."""
    from dg_tta_tpu_torch.models.convert import load_flat_npz
    from dg_tta_tpu_torch.models.network import build_model
    from dg_tta_tpu_torch.parallel import dryrun
    from dg_tta_tpu_torch.train.pretrain import run_pretraining

    gin_mind = "nnUNetTrainer_GIN_MIND"
    model = build_model(pre["plans"], pre["dataset_json"], gin_mind)
    results, stats = work / "results", work / "rank_stats"
    results.mkdir(parents=True)
    stats.mkdir()
    pwork = pre["work"]
    os.environ.update(nnUNet_raw=str(pwork / "raw"),
                      nnUNet_preprocessed=str(pwork / "preprocessed"),
                      nnUNet_results=str(results),
                      DGTTA_RANK_STATS_DIR=str(stats))
    runs = {}
    try:
        for tag, epochs, resume, (ref_log, ref_final) in (
                ("", (0, PRETRAIN_EPOCHS), False, pre["runs"][0]),
                (" resumed", (PRETRAIN_EPOCHS, PRETRAIN_EPOCHS + 1), True,
                 pre["runs"][1])):
            for f in stats.glob("rank*.json"):
                f.unlink()
            n = epochs[1] - epochs[0]
            expected = {k: DP_RANKS * v for k, v in expected_pretrain_launches(
                model.spec, n * PRETRAIN_ITERS, n * PRETRAIN_VAL_ITERS,
                False).items()}
            _zero_counts()
            t0 = time.perf_counter()
            out = run_pretraining(pre["dataset_id"], trainer_name=gin_mind,
                                  num_epochs=epochs[1],
                                  iters_per_epoch=PRETRAIN_ITERS,
                                  val_iters_per_epoch=PRETRAIN_VAL_ITERS,
                                  plans=pre["plans"],
                                  continue_training=resume, verbose=False,
                                  device="cuda", num_devices=DP_RANKS,
                                  backend="gloo")
            wall = time.perf_counter() - t0
            launches = _read_counts()
            ranks = [json.loads(f.read_text())
                     for f in sorted(stats.glob("rank*.json"))]
            if len(ranks) != DP_RANKS:
                raise AssertionError(f"data-parallel pretraining{tag}: "
                                     f"{len(ranks)} ranks wrote their stats")
            for r in ranks:
                launches = {k: v + r["launches"][k]
                            for k, v in launches.items()}
            entries = [json.loads(line) for line in
                       (out / "training_log.jsonl").read_text().splitlines()]
            got = [e["loss"] for e in entries]
            want = [e["loss"] for e in ref_log]
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            e = dryrun.update_errors(load_flat_npz(out / "checkpoint_final"
                                                   ".npz"), ref_final,
                                     pre["init"])
            log(f"parallel: data-parallel run_pretraining{tag}, {gin_mind}, "
                f"epochs {epochs[0]}..{epochs[1]} x {PRETRAIN_ITERS} "
                f"iterations + {PRETRAIN_VAL_ITERS} validation batches, "
                f"{DP_RANKS} ranks x batch 1 (gloo, one card): {wall:.2f} s "
                f"wall (ranks {[round(r['seconds'], 2) for r in ranks]} s, "
                f"peak {[round(r['peak_bytes'] / 2 ** 30, 2) for r in ranks]}"
                f" GiB); logged losses {got} vs {want} one process (rel "
                f"{loss_err:.3e}, tol {DP_STEP_RTOL}); val pseudo-Dice "
                f"{[x['val_pseudo_dice'] for x in entries]} vs "
                f"{[x['val_pseudo_dice'] for x in ref_log]}; "
                f"checkpoint_final.npz: {dryrun.update_report(e)} (tol "
                f"{DP_STEP_RTOL}, a parameter {DP_LEAF_RTOL}); launches "
                f"{launches} (expected {expected})")
            if launches != expected:
                raise AssertionError(f"data-parallel pretraining{tag}: "
                                     f"launches {launches}, expected "
                                     f"{expected}")
            if [x["epoch"] for x in entries] != list(range(epochs[1])) \
                    or not (loss_err <= DP_STEP_RTOL
                            and e["whole"] <= DP_STEP_RTOL
                            and e["worst"] <= DP_LEAF_RTOL):
                raise AssertionError(f"data-parallel pretraining{tag} "
                                     f"misses the one-process run")
            runs[f"pretrain GIN_MIND over {DP_RANKS} ranks{tag}",
                 "float32"] = launches
    finally:
        del os.environ["DGTTA_RANK_STATS_DIR"]
    return runs


def phase_parallel(work: Path, serial_losses, serial_members, pre):
    """The several-process paths (`parallel/`) on this one card, its ranks
    sharing it over gloo, each against its one-process run:

    * `run_tta` of the smoke plan (TS104_GIN, f32) with Phase 1 over
      PARALLEL_RANKS ranks (`--num_devices 3 --backend gloo`, one member
      each): every check of `phase_main_path`, its launches this
      process's and the ranks' summed; the member losses held to the
      serial run's (`serial_losses`: epoch 0, a warm-up epoch, at
      PARALLEL_LOSS_RTOL, the trained epoch at PARALLEL_LATER_RTOL), and
      each member's parameter file to the serial run's
      (`serial_members`), each parameter's update at PARALLEL_UPDATE_RTOL;
    * `run_pretraining` over DP_RANKS ranks, and resumed
      (`_dp_pretraining`), against `phase_pretrain`'s runs (`pre`);
    * one data-parallel pretraining step of the full-width TS104_GIN_MIND
      net, 2 ranks x batch 1, against the one-process step at batch 2
      (`parallel/dryrun.dp_step_rank`, every augmentation gate on): the
      loss and the SGD update of all parameters together within
      DP_STEP_RTOL, each parameter's update but those zero to rounding
      (`parallel/dryrun.update_errors`) within DP_LEAF_RTOL, the replicas
      equal;
    * window-sharded `predict_volume` (3 TS104_GIN members, the 224 x 224 x
      256 volume) over 2 ranks against the unsharded call in rank 0
      (`parallel/dryrun.predict_rank`: rtol 1e-4, atol 1e-5);
    * a one-rank NCCL group on cuda:0 and an all-reduce
      (`parallel/dryrun.all_reduce_rank`), so that the NCCL path starts
      on this machine too.

    Returns the main-path runs' launch counts."""
    import numpy as np
    import torch

    from dg_tta_tpu_torch.models.convert import load_flat_npz
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model
    from dg_tta_tpu_torch.parallel import dryrun
    from dg_tta_tpu_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    launches, losses, (paths, checkpoint) = phase_main_path(
        work / "tta", "float32", ranks=PARALLEL_RANKS,
        cli_args=["--num_devices", str(PARALLEL_RANKS), "--backend", "gloo"])
    runs = {("TS104_GIN parallel", "float32"): launches}
    rel = np.abs(losses - serial_losses) / np.abs(serial_losses)
    init = load_flat_npz(checkpoint)
    upd, bit = 0.0, True
    for a, b in zip(paths, serial_members[0]):
        got, ref = load_flat_npz(a), load_flat_npz(b)
        upd = max(upd, dryrun.leaf_update_rel(got, ref, init))
        bit &= all(torch.equal(got[k], ref[k]) for k in ref)
    log(f"parallel: run_tta over {PARALLEL_RANKS} ranks on one card "
        f"{time.perf_counter() - t0:.1f} s; member losses "
        f"{losses.tolist()} vs {serial_losses.tolist()} serial, rel err "
        f"epoch 0 {rel[:, 0].max():.3e} (tol {PARALLEL_LOSS_RTOL}), later "
        f"{rel[:, 1:].max():.3e} (tol {PARALLEL_LATER_RTOL}); member files "
        f"against the serial run's: worst parameter update rel {upd:.3e} "
        f"(tol {PARALLEL_UPDATE_RTOL}), bit-equal {bit}")
    if not (rel[:, 0].max() <= PARALLEL_LOSS_RTOL
            and rel[:, 1:].max() <= PARALLEL_LATER_RTOL
            and upd <= PARALLEL_UPDATE_RTOL):
        raise AssertionError("parallel run_tta: the members miss the "
                             "serial run's")

    runs.update(_dp_pretraining(work / "pretrain", pre))

    t0 = time.perf_counter()
    model = ts104_model(trainer="nnUNetTrainer_GIN_MIND")
    job = dryrun.step_job(model, 2, 1, 5, full=True)
    ref_losses, ref = dryrun.one_process_steps(job, "cuda")
    ref = {k: v.cpu() for k, v in ref.items()}
    torch.cuda.empty_cache()
    got = launch(dryrun.dp_step_rank, 2, "cuda", "gloo", args=(job,))
    (dp_losses, state, _), (_, other, _) = got
    replicas = all(torch.equal(a, b) for a, b in zip(state.values(),
                                                     other.values()))
    loss_err = abs(dp_losses[0] - ref_losses[0]) / abs(ref_losses[0])
    e = dryrun.update_errors(state, ref, job.state)
    log(f"parallel: data-parallel step, TS104_GIN_MIND, 2 ranks x batch 1 "
        f"vs one process at batch 2: loss {dp_losses[0]:.6f} vs "
        f"{ref_losses[0]:.6f} (rel {loss_err:.3e}), replicas equal "
        f"{replicas}; {dryrun.update_report(e)} (tol {DP_STEP_RTOL}, a "
        f"parameter {DP_LEAF_RTOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (replicas and loss_err <= DP_STEP_RTOL
            and e["whole"] <= DP_STEP_RTOL and e["worst"] <= DP_LEAF_RTOL):
        raise AssertionError("parallel: the data-parallel step misses the "
                             "one-process step")

    t0 = time.perf_counter()
    model = ts104_model()
    vol = dryrun.synthetic_volume(3, VOLUME_SHAPE, full=True)[0][0]
    job = dryrun.PredictJob(model, [dryrun.seeded_state(model, 20 + m)
                                    for m in range(3)], vol,
                            return_output=False)
    res = launch(dryrun.predict_rank, 2, "cuda", "gloo", args=(job,))[0]
    log(f"parallel: predict_volume over 2 ranks {res['sharded_s']:.2f} s vs "
        f"{res['serial_s']:.2f} s unsharded (rank 0); max abs err "
        f"{res['max_abs_err']:.3e} of {res['ref_max_abs']:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not res["close"]:
        raise AssertionError(f"parallel: window-sharded predict_volume {res}")

    t0 = time.perf_counter()
    ok, ms = launch(dryrun.all_reduce_rank, 1, "cuda", "nccl",
                    args=(1 << 20,))[0]
    log(f"parallel: NCCL, one rank on cuda:0: all-reduce of 4 MiB {ms:.3f} "
        f"ms, sum right {ok}; {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError("parallel: the NCCL all-reduce is wrong")
    return runs


def _row(name, source, replaces, launches, t, bf16=None, bf16_route=None,
         **extra):
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": t["max_abs_err"], "ms": t["ms"],
           "plain_ms": t["plain_ms"],
           "bound_ms": max(t["ops_ms"], t["bytes_ms"]),
           "bound_by": ("operations" if t["ops_ms"] >= t["bytes_ms"]
                        else "bytes"),
           "library_ms": t["library_ms"]}
    if bf16 is not None:
        row.update(bf16_route=bf16_route, bf16_ms=bf16["ms"],
                   bf16_plain_ms=bf16["plain_ms"],
                   bf16_bound_ms=max(bf16["ops_ms"], bf16["bytes_ms"]),
                   bf16_library_ms=bf16["library_ms"],
                   bf16_max_abs_err=bf16["max_abs_err"])
    row.update(extra)
    return row


def _cuda_core_extra(totals):
    """The catch-all rows' extras: the TS104 shapes forced onto it (ms,
    bound, library ms), and the CUDA cores' f32 floor of the ragged rows
    and of the forced ones."""
    out = {}
    for dt, pre in (("float32", ""), ("bfloat16", "bf16_")):
        t, f = totals[f"{dt}/ragged/cuda_core"], totals[f"{dt}/cuda_core"]
        # the operations floor on the CUDA cores from the tensor cores'
        # (`_ops_ms`: the same operations at another rate)
        to_cc = _ops_ms(1e12, dt, "cuda_core") / cuda_core_floor_ms(1e12)
        out.update({f"{pre}cuda_core_floor_ms": t["ops_ms"] / to_cc,
                    f"{pre}forced_ms": f["ms"],
                    f"{pre}forced_bound_ms": max(f["ops_ms"], f["bytes_ms"]),
                    f"{pre}forced_library_ms": f["library_ms"],
                    f"{pre}forced_cuda_core_floor_ms": f["ops_ms"] / to_cc})
    return out


def _c1_extra(totals):
    """The "c1" rows' floors by unit and their forced CUDA-core times."""
    out = {}
    for dt, pre in (("float32", ""), ("bfloat16", "bf16_")):
        t, cc = totals[f"{dt}/c1"], totals[f"{dt}/c1/cuda_core"]
        out.update({f"{pre}ops_floor_ms": t["ops_ms"],
                    f"{pre}bytes_floor_ms": t["bytes_ms"],
                    f"{pre}cuda_core_ms": cc["ms"],
                    f"{pre}cuda_core_bound_ms": max(cc["ops_ms"],
                                                    cc["bytes_ms"])})
    return out


def timed(fn, *args, **kw):
    """fn(*args, **kw), its wall seconds logged and kept in SECONDS under
    its name (summed over calls)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        dt = time.perf_counter() - t0
        SECONDS[fn.__name__] = SECONDS.get(fn.__name__, 0.0) + dt
        log(f"{fn.__name__}: {dt:.1f} s")


SECONDS = {}


def main():
    t0 = time.perf_counter()
    phase_device()
    import numpy as np
    import torch

    from dg_tta_tpu_torch.kernels import conv3x3, warp

    timed(phase_build)
    totals = {"conv3x3": timed(phase_kernels),
              "conv3x3_wgrad": timed(phase_wgrad),
              "warp": timed(phase_warp),
              "warp_grid": timed(phase_warp_deformable),
              "warp_pretrain": timed(phase_warp_pretrain)}
    timed(phase_grouped_kernels, totals)
    timed(phase_member_chunk_kernels, totals)
    timed(phase_reference)
    timed(reference_pretrain)
    timed(reference_adaptation, RAGGED_FEATURES)
    timed(phase_remat)
    repeat = timed(phase_repeat)
    runs, losses = {}, {}
    # the catch-all route's main path: the ragged net's TTA runs
    runs.update(timed(phase_ragged_tta))

    members = {}

    def main_path(key, *args, **kw):
        runs[key], losses[key], members[key] = timed(phase_main_path, *args,
                                                     **kw)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # DG pretraining (configs 4-5): GIN_MIND, GIN_MultiRes, a resume
        pre_runs, pre_ref = timed(phase_pretrain, Path(tmp) / "pretrain")
        runs.update(pre_runs)
        for dtype in ("float32", "bfloat16"):
            main_path(("TS104_GIN", dtype), Path(tmp) / f"gin_{dtype}", dtype)
        # MIND in every forward, GIN in both branches of every step
        for dtype in ("float32", "bfloat16"):
            main_path(("TS104_GIN_MIND", dtype),
                      Path(tmp) / f"gin_mind_{dtype}", dtype,
                      "TS104_GIN_MIND", do_intensity_aug_in="both")
        # affine TTA with the exact adjoint (its affine entry)
        main_path(("TS104_GIN exact", "float32"),
                  Path(tmp) / "exact_float32", "float32", exact=True)
        # deformable TTA: f32 with the fast adjoint, bf16 with the exact one
        main_path(("TS104_GIN deformable", "float32"),
                  Path(tmp) / "deformable_float32", "float32",
                  spatial_aug_type="deformable")
        main_path(("TS104_GIN deformable exact", "bfloat16"),
                  Path(tmp) / "deformable_exact_bfloat16", "bfloat16",
                  exact=True, spatial_aug_type="deformable")
        # patch_group: the smoke plan's 4 patches in one step of 4 (f32)
        # and in two steps of 2 (bf16), each held to the ungrouped run
        for dtype, group in GROUPED_RUNS:
            key = (f"TS104_GIN patch_group {group}", dtype)
            main_path(key, Path(tmp) / f"group{group}_{dtype}", dtype,
                      patch_group=group)
            got, ref = losses[key][:, 0], losses["TS104_GIN", dtype][:, 0]
            err = float(np.max(np.abs(got - ref) / np.abs(ref)))
            if not err <= GROUPED_LOSS_RTOL[dtype]:
                raise AssertionError(f"{key}: epoch-0 member losses {got} "
                                     f"vs {ref} ungrouped (rel err {err})")
            log(f"main path TS104_GIN {dtype} patch_group {group}: epoch-0 "
                f"member losses {got.tolist()} vs {ref.tolist()} ungrouped, "
                f"rel err {err:.3e} (tol {GROUPED_LOSS_RTOL[dtype]}); "
                f"epoch-1 {losses[key][:, 1].tolist()} vs "
                f"{losses['TS104_GIN', dtype][:, 1].tolist()}")
        # the smoke plan's members side by side (ensemble_chunk), each run
        # held to the serial run of its type
        for dtype in ("float32", "bfloat16"):
            key = (f"TS104_GIN ensemble_chunk {CHUNK}", dtype)
            main_path(key, Path(tmp) / f"chunk{CHUNK}_{dtype}", dtype,
                      ensemble_chunk=CHUNK)
            serial = ("TS104_GIN", dtype)
            check_member_chunk(
                dtype, (runs[serial], losses[serial], members[serial]),
                (runs[key], losses[key], members[key]), repeat)
        # Phase 1 over 3 ranks sharing the card, a data-parallel step,
        # window-sharded inference, NCCL
        runs.update(timed(
            phase_parallel, Path(tmp) / "parallel",
            losses["TS104_GIN", "float32"], members["TS104_GIN", "float32"],
            pre_ref))

    def both(key, dtype=None):
        # launches over the main-path runs (of one type)
        return sum(r[key] for (_, dt), r in runs.items()
                   if dtype in (None, dt))

    def chunked(key):
        # launches of the chunk runs (members side by side)
        return {"member_chunk_launches": sum(
            r[key] for (name, _), r in runs.items()
            if "ensemble_chunk" in name)}

    c, wg = totals["conv3x3"], totals["conv3x3_wgrad"]
    w32, w16 = totals["warp"]["float32"], totals["warp"]["bfloat16"]
    wg32, wg16 = totals["warp_grid"]["float32"], totals["warp_grid"]["bfloat16"]
    # the warp's sites in one pretraining step, per entry
    pre = {e: {f"pretrain_step_{k}": t[k] for k in ("ms", "plain_ms",
                                                     "library_ms")}
           | {"pretrain_step_bound_ms": max(t["ops_ms"], t["bytes_ms"]),
              "pretrain_step_max_abs_err": t["max_abs_err"]}
           for e, t in totals["warp_pretrain"].items()}
    adj, adj_aff, adj_entry = ({k: totals["warp_grid"][f"{k}/adjoint/{site}"]
                                for k in ("float32", "bfloat16")}
                               for site in ("deformable grid", "affine grid",
                                            "affine entry"))
    rows = [
        # the catch-all kernels ("cuda_core") at the ragged net's shapes
        # (a window forward and a trained step), their launches the ragged
        # TTA runs'; beside them the TS104 shapes forced onto them (every
        # conv, both types) and the CUDA cores' f32 floor of both
        _row("conv3x3", conv3x3.SOURCE, conv3x3.REPLACES,
             both("conv3x3_cuda_core"), c["float32/ragged/cuda_core"],
             c["bfloat16/ragged/cuda_core"], "cuda_core",
             **_cuda_core_extra(c), **chunked("conv3x3_cuda_core")),
        _row("conv3x3_wgrad", conv3x3.WGRAD_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgrad_cuda_core"), wg["float32/ragged/cuda_core"],
             wg["bfloat16/ragged/cuda_core"], "cuda_core",
             **_cuda_core_extra(wg), **chunked("conv3x3_wgrad_cuda_core")),
        # the warp's grid entry at its main-path sites, a deformable
        # branch of a trained step (10 field warps, the input warp, the
        # unwarp and its fast adjoint), with its times on the card's
        # affine_grid at the affine sites beside them; and its affine entry
        _row("warp", warp.SOURCE, warp.REPLACES, both("warp"), wg32, wg16,
             "cuda", device_ms=wg32["device_ms"],
             library_device_ms=wg32["library_device_ms"],
             bf16_device_ms=wg16["device_ms"],
             bf16_library_device_ms=wg16["library_device_ms"],
             affine_sites_ms=w32["grid"]["ms"],
             affine_sites_device_ms=w32["affine"]["grid_device_ms"],
             bf16_affine_sites_ms=w16["grid"]["ms"],
             bf16_affine_sites_device_ms=w16["affine"]["grid_device_ms"],
             staged_share=wg32["staged_share"],
             bf16_staged_share=wg16["staged_share"], **pre["grid"]),
        # the exact adjoint's grid entry at the logit site on a deformable
        # grid, its times on an affine grid beside them; and its affine
        # entry at that affine
        _row("warp_adjoint", warp.SOURCE, warp.REPLACES,
             both("warp_adjoint"), adj["float32"], adj["bfloat16"], "cuda",
             device_ms=adj["float32"]["device_ms"],
             bf16_device_ms=adj["bfloat16"]["device_ms"],
             runs_max_diff=adj["float32"]["runs_max_diff"],
             staged_share=adj["float32"]["staged_share"],
             affine_grid_ms=adj_aff["float32"]["ms"],
             affine_grid_device_ms=adj_aff["float32"]["device_ms"],
             bf16_affine_grid_ms=adj_aff["bfloat16"]["ms"],
             bf16_affine_grid_device_ms=adj_aff["bfloat16"]["device_ms"]),
        _row("warp_affine_adjoint", warp.SOURCE, warp.REPLACES,
             both("warp_affine_adjoint"), adj_entry["float32"],
             adj_entry["bfloat16"], "cuda",
             device_ms=adj_entry["float32"]["device_ms"],
             bf16_device_ms=adj_entry["bfloat16"]["device_ms"],
             runs_max_diff=adj_entry["float32"]["runs_max_diff"],
             staged_share=adj_entry["float32"]["staged_share"]),
        _row("warp_affine", warp.SOURCE, warp.REPLACES, both("warp_affine"),
             w32["affine"], w16["affine"], "cuda",
             **{k: w32["affine"][k] for k in (
                 "device_ms", "host_us", "library_device_ms",
                 "library_affine_ms", "staged_share")},
             **{f"bf16_{k}": w16["affine"][k] for k in (
                 "device_ms", "host_us", "library_device_ms",
                 "library_affine_ms", "staged_share")}, **pre["affine"]),
        _row("conv3x3_wgmma", conv3x3.WGMMA_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgmma", "bfloat16"), c["bfloat16/wgmma"],
             **chunked("conv3x3_wgmma")),
        _row("conv3x3_wgrad_wgmma", conv3x3.WGRAD_WGMMA_SOURCE,
             conv3x3.REPLACES, both("conv3x3_wgrad_wgmma", "bfloat16"),
             wg["bfloat16/wgmma"], **chunked("conv3x3_wgrad_wgmma")),
        _row("conv3x3_wgmma_tf32x3", conv3x3.WGMMA_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgmma_tf32x3", "float32"),
             c["float32/wgmma_tf32x3"], **chunked("conv3x3_wgmma_tf32x3")),
        _row("conv3x3_wgrad_tf32x3", conv3x3.WGRAD_WGMMA_SOURCE,
             conv3x3.REPLACES, both("conv3x3_wgrad_wgmma_tf32x3", "float32"),
             wg["float32/wgmma_tf32x3"],
             **chunked("conv3x3_wgrad_wgmma_tf32x3")),
        # the C = 1 first conv on "c1" (the tensor cores), its bytes and
        # operations floors beside the bound, and its shapes forced onto
        # the CUDA-core kernels with their bound there
        _row("conv3x3_c1", conv3x3.C1_SOURCE, conv3x3.REPLACES,
             both("conv3x3_c1"), c["float32/c1"], c["bfloat16/c1"], "c1",
             **_c1_extra(c), **chunked("conv3x3_c1")),
        _row("conv3x3_wgrad_c1", conv3x3.C1_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgrad_c1"), wg["float32/c1"], wg["bfloat16/c1"],
             "c1", **_c1_extra(wg), **chunked("conv3x3_wgrad_c1")),
        # the MIND stem (C = 12) on "few" in both types, its launches over
        # the main-path runs; beside them the same shapes forced onto the
        # wgmma route of the type, zero-padded to 16 channels (the route
        # that ran them before), and onto the CUDA-core kernels
        _row("conv3x3_stem12", conv3x3.FEW_SOURCE, conv3x3.REPLACES,
             both("conv3x3_few"), c["float32/stem12/few"],
             c["bfloat16/stem12/few"], "few",
             padded_ms=c["float32/stem12/wgmma_tf32x3"]["ms"],
             bf16_padded_ms=c["bfloat16/stem12/wgmma"]["ms"],
             cuda_core_ms=c["float32/stem12/cuda_core"]["ms"],
             bf16_cuda_core_ms=c["bfloat16/stem12/cuda_core"]["ms"]),
        _row("conv3x3_wgrad_stem12", conv3x3.FEW_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgrad_few"), wg["float32/stem12/few"],
             wg["bfloat16/stem12/few"], "few",
             padded_ms=wg["float32/stem12/wgmma_tf32x3"]["ms"],
             bf16_padded_ms=wg["bfloat16/stem12/wgmma"]["ms"],
             cuda_core_ms=wg["float32/stem12/cuda_core"]["ms"],
             bf16_cuda_core_ms=wg["bfloat16/stem12/cuda_core"]["ms"])]
    log("seconds per phase: " + json.dumps(
        {k: round(v, 1) for k, v in SECONDS.items()}
        | {"total": round(time.perf_counter() - t0, 1)}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
