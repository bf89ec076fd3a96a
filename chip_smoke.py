"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device: requires `torch.cuda.is_available()`; prints the card's name and
   power limit as `nvidia-smi` reports them;
2. build: compiles every CUDA kernel of the main path from the checkout's
   sources (`conv3x3`, `conv3x3_wgrad`, `warp`, `conv3x3_wgmma`,
   `conv3x3_wgrad_wgmma`, `conv3x3_c1`, `conv3x3_wgrad_tf32x3`,
   `conv3x3_few`: one `nvcc` per source, all started together), and
   asserts that the SASS of the wgmma kernels (bf16 and f32 3xTF32
   instantiations of `conv3x3_wgmma`, `conv3x3_wgrad_wgmma` and the f32
   `conv3x3_wgrad_tf32x3`) holds tensor-core (`HGMMA`) and TMA
   (`UTMALDG`) instructions, that of `conv3x3_few`'s four kernels
   (forward and weight gradient, bf16 and f32) `HGMMA` and their halo
   loads (bf16: cp.async, `LDGSTS`; f32: `UTMALDG`), and that of
   `conv3x3_c1`'s four (the C = 1 forward and weight gradient, bf16 and
   f32 3xTF32) tensor-core `HMMA` (mma.sync), the weight gradients' dy
   loads cp.async (`LDGSTS`), and that of the warp's affine-entry kernels
   cp.async (`LDGSTS`) and shared-memory gathers (`LDS`), and that of the
   exact adjoint's kernels shared-memory atomics (`ATOMS`) and 16-byte
   global reductions (`REDG.E.ADD.F32x4`);
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
     (`route="cuda_core"`, marked "forced"), so both are timed in one call;
     each bound is the larger of the bytes floor and the operations floor
     on the unit the route computes on (`_ops_ms`: the CUDA cores' f32
     rate for "cuda_core" in either type, the tensor cores for the other
     routes, f32 there as three tf32 products), and the "c1" shapes print
     both floors;
     and the stem conv of a MIND model (12 -> 32 channels, route "few")
     at its window forward and its step forward, also forced onto the
     type's wgmma route (zero-padded to 16 channels: the route it took
     before) and the CUDA-core kernel, its bound counting the true C = 12
     work;
   * `conv3x3_wgrad` at the same shapes with the batch of a TTA step (two
     patches: both branches), f32 and bf16 (library: cuDNN's weight
     gradient, `torch.nn.grad.conv3d_weight`), with its route ("c1",
     "wgmma" for bf16, "wgmma_tf32x3" for f32), the C = 1 and f32 shapes
     also forced onto the CUDA-core kernel, and the f32 routes' per-step
     totals on the same shapes side by side; the MIND stem's shape too, on
     "few", forced onto the padded wgmma route and the CUDA-core kernel;
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
   against the same code on the CPU (plain versions);
5. main path, seven times, each in a fresh workspace and under the
   default flags, f32 (the default), then bf16
   (`DGTTA_COMPUTE_DTYPE=bfloat16`), for each of two seeded full-width
   checkpoints (105 classes): TS104_GIN, then TS104_GIN_MIND (12 input
   channels: MIND in every forward, with noise; the plan also puts GIN in
   both branches); then TS104_GIN in f32 with `DGTTA_EXACT_WARP_GRAD=1`
   (the exact adjoint's affine entry); then TS104_GIN with a deformable
   plan (`spatial_aug_type: "deformable"`), in f32 with the fast adjoint
   and in bf16 with `DGTTA_EXACT_WARP_GRAD=1`:
   `prepare_tta` and `run_tta` through the port's CLI on a synthetic CT
   volume of 224 x 224 x 256 voxels at 1.5 mm (27 windows), with no member
   files: `run_tta` adapts three members (Phase 1), then predicts and
   evaluates.  The plan is the default cut in depth only: epochs=2,
   patches_to_be_accumulated=4, start_tta_at_epoch=1 (one warm-up and one
   trained epoch).  Checks the member files and the segmentation, that
   every kernel launched exactly as often as the plan says it must, on
   each route and on padded channels (`expected_launches`), that the
   CUDA-core `conv3x3` and `conv3x3_wgrad` launched not at all, that no
   launch ran on padded channels (a MIND model's stem runs on "few"), and
   that
   the warp's grid entry and the exact adjoint's two entries launched
   where the plan and the flag put them (the affine runs: no grid entry,
   the exact one the adjoint's affine entry only).

It prints one JSON line with the kernels' numbers (f32, with bf16 fields
beside them where a kernel serves both types; the CUDA-core rows at the
shapes they ran before the "c1" and "wgmma_tf32x3" routes took them; the
"c1" rows with their operations and bytes floors and their shapes' times
and bounds on the CUDA-core kernels (forced); the
MIND stem's rows on "few" with the forced padded-route and CUDA-core
times beside them; the warp's
grid entry per deformable branch of a trained step, the exact adjoint's
grid entry on a deformable grid and its affine entry) and, last, one JSON
line naming the device.
"""

import contextlib
import copy
import json
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
# every CUDA source of the main path (dg_tta_tpu_torch/kernels/csrc)
SOURCES = ["conv3x3", "conv3x3_wgrad", "warp", "conv3x3_wgmma",
           "conv3x3_wgrad_wgmma", "conv3x3_c1", "conv3x3_wgrad_tf32x3",
           "conv3x3_few"]


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
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  {name}: {line.strip()}")
    # the wgmma routes run on the tensor cores, fed by TMA: the bf16 and
    # the f32 (3xTF32) instantiations of conv3x3_wgmma, and wgrad's bf16
    # and f32 kernels; the "few" route's four kernels on the tensor cores,
    # the bf16 ones fed by cp.async (LDGSTS), the f32 ones by TMA; the
    # "c1" route's four by mma.sync (HMMA), the weight gradients' dy by
    # cp.async; the warp's affine entry stages its boxes by cp.async and
    # gathers from shared memory (LDS); the exact adjoint sums in shared
    # memory (ATOMS: compare-and-swap loops) and flushes by 16-byte global
    # reductions
    tma, cp_async = ("HGMMA", "UTMALDG"), ("HGMMA", "LDGSTS")
    hmma, hmma_cp = ("HMMA",), ("HMMA", "LDGSTS")
    for name, marker, ops in (
            ("conv3x3_wgmma", "conv3x3_wgmma_kernelI13__nv_", tma),
            ("conv3x3_wgmma", "conv3x3_wgmma_kernelIf", tma),
            ("conv3x3_wgrad_wgmma", "wgrad_wgmma_kernel", tma),
            ("conv3x3_wgrad_tf32x3", "wgrad_tf32x3_kernel", tma),
            ("conv3x3_few", "few_forward_bf16_kernel", cp_async),
            ("conv3x3_few", "few_forward_f32_kernel", tma),
            ("conv3x3_few", "few_wgrad_bf16_kernel", cp_async),
            ("conv3x3_few", "few_wgrad_f32_kernel", tma),
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


def _ops_ms(ops, name, route):
    """The least time for `ops` operations of type `name` on the unit
    that `route` computes on: "cuda_core" on the CUDA cores' f32 rate in
    either type (bf16 is widened to f32 there); every other route on the
    tensor cores, bf16 at its rate and f32 as three tf32 products
    (3xTF32)."""
    if route == "cuda_core":
        return ops / PEAK_OPS["float32"] * 1e3
    if name == "float32":
        return ops / (PEAK_TF32 / 3) * 1e3
    return ops / PEAK_OPS["bfloat16"] * 1e3


def _bound_text(ops_ms, bytes_ms, both):
    """The bound of one shape, the larger floor named; with `both`, the
    operations and the bytes floor beside it."""
    text = (f"bound_ms={max(ops_ms, bytes_ms):.4f} "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
    if both:
        text += f" [ops_floor_ms={ops_ms:.4f} bytes_floor_ms={bytes_ms:.4f}]"
    return text


def _route_totals(totals, name, main, route, stem):
    """The totals a shape's time on `route` adds to: its route's per type
    ("<type>/<route>", the MIND stem's "<type>/stem12/<route>") and, for a
    "c1" shape forced onto another route, "<type>/c1/<route>" too."""
    at = [totals.setdefault(f"{name}/{'stem12/' if stem else ''}{route}",
                            _new_totals())]
    if main == "c1" and route != main:
        at.append(totals.setdefault(f"{name}/c1/{route}", _new_totals()))
    return at


def _side_routes(main, stem, dtype):
    """The routes timed beside the main path's on one shape: the MIND
    stem's (on "few") also on the type's wgmma route, which runs it
    zero-padded to 16 channels, and on the CUDA-core kernel; the "c1" and
    "wgmma_tf32x3" shapes on the CUDA-core kernel that ran them before."""
    import torch

    if stem:
        return [{torch.float32: "wgmma_tf32x3",
                 torch.bfloat16: "wgmma"}[dtype], "cuda_core"]
    return ["cuda_core"] if main in ("c1", "wgmma_tf32x3") else []


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
                _conv_cases() + _stem_cases():
            stem = use.startswith("stem")
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
                k_ms = time_ms(lambda: conv3x3(x, w, depth=depth,
                                               route=route))
                ops_ms = _ops_ms(ops, name, route)
                log(f"conv3x3 {name} {use} N={N} depth={depth} {H}x{W} "
                    f"{C}->{CO} route={route}"
                    f"{'' if route == main else ' (forced)'}: "
                    f"max_abs_err={err:.3e} (tol {tol:.3e}) "
                    f"max_rel_err={err / scale:.3e} "
                    f"(tol {KERNEL_RTOL[name]:.1e}) kernel_ms={k_ms:.4f} "
                    f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                    f"{_bound_text(ops_ms, bytes_ms, main == 'c1')} "
                    f"TFLOP/s={ops / k_ms / 1e9:.2f} x{mult}/{use}")
                at = _route_totals(totals, name, main, route, stem)
                if route == main and not stem:
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
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        tot = _new_totals()
        side = {}  # f32: both routes' per-step totals on the tf32x3 shapes
        for depth, H, W, C, CO, mult, stem in \
                [(*sh, False) for sh in TS104_CONV_SHAPES] \
                + [(*STEM_SHAPE, 1, True)]:
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
                k_ms = time_ms(lambda: conv3x3_wgrad(x, dy, depth=depth,
                                                     route=route))
                log(f"conv3x3_wgrad {name} N={N} depth={depth} {H}x{W} "
                    f"{C}->{CO} route={route}"
                    f"{'' if route == main else ' (forced)'}"
                    f"{' MIND stem' if stem else ''}: "
                    f"max_abs_err={err:.3e} (tol {WGRAD_RTOL * scale:.3e}) "
                    f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={l_ms:.4f} "
                    f"{_bound_text(ops_ms, bytes_ms, main == 'c1')} "
                    f"TFLOP/s={ops / k_ms / 1e9:.2f} x{mult}/step")
                if main == "wgmma_tf32x3" and not stem:
                    side[route] = side.get(route, 0.0) + mult * k_ms
                at = _route_totals(totals, name, main, route, stem)
                if route == main and not stem:
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


def reference_adaptation():
    """The adaptation of the full-width TS104_GIN net on a small patch, on
    the card against the CPU, with the same injected draws: one patch
    step's gradient, then a short `tta_one_volume`.

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

    model = ts104_model(patch_size=(32, 48, 64))
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
    log(f"reference: TS104 patch {model.patch_size}, one patch step: "
        f"{len(grads[0])} gradients, largest error {g_rel:.3e} of its norm "
        f"(tol 5e-2)")
    log(f"reference: tta_one_volume TS104 patch {model.patch_size}, 1 member "
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


def expected_launches(spec, windows, members, plan, dtype="float32",
                      exact=False):
    """Kernel launches that `run_tta` must make for `plan` on a volume of
    `windows` sliding windows with labels (one eval per epoch), in compute
    type `dtype`, with `DGTTA_EXACT_WARP_GRAD` set if `exact`: the totals
    of `conv3x3` and `conv3x3_wgrad`, their launches on each route
    (`conv3x3_<route>`, `conv3x3_wgrad_<route>`, as `conv3x3_route` and
    `conv3x3_wgrad_route` pick them) and on zero-padded channels
    (`conv3x3_padded`, `conv3x3_wgrad_padded`: a MIND model's stem), and
    those of the warp's affine entry (`warp_affine`), grid entry (`warp`)
    and the exact adjoint's grid entry (`warp_adjoint`) and affine entry
    (`warp_affine_adjoint`).  Per patch step, each branch the plan warps
    makes one input warp and one unwarp, and each trained step one adjoint
    of each unwarp: an affine plan's on the affine entry (with `exact`,
    the exact adjoint's affine entry); a deformable plan's on the grid
    entry, after the 10 field warps of its branch's displacement field (5
    iterations, 2 warps each; with `exact`, the exact adjoint's grid
    entry); each eval samples its labels on the affine entry."""
    import torch

    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_route,
                                                  conv3x3_wgrad_route,
                                                  route_channels)

    dt = getattr(torch, dtype)
    acc, epochs = plan["patches_to_be_accumulated"], plan["epochs"]
    trained = acc * max(0, epochs - plan["start_tta_at_epoch"])
    forwards = acc * epochs + epochs   # patch steps and one eval per epoch
    out = {f"conv3x3_{r}": 0 for r in CONV_ROUTES}
    out.update({f"conv3x3_wgrad_{r}": 0 for r in WGRAD_ROUTES})
    out["conv3x3_padded"] = out["conv3x3_wgrad_padded"] = 0

    def add(kernel, route, c, n):
        out[f"{kernel}_{route}"] += n
        if route_channels(c, route) != c:
            out[f"{kernel}_padded"] += n

    for c, co, dgrad in _stride1_convs(spec):
        add("conv3x3", conv3x3_route(c, co, dt), c,
            members * (forwards + windows))
        if dgrad:
            add("conv3x3", conv3x3_route(co, c, dt), co, members * trained)
        add("conv3x3_wgrad", conv3x3_wgrad_route(c, co, dt), c,
            members * trained)
    out["conv3x3"] = sum(out[f"conv3x3_{r}"] for r in CONV_ROUTES)
    out["conv3x3_wgrad"] = sum(out[f"conv3x3_wgrad_{r}"]
                               for r in WGRAD_ROUTES)
    branches = {"both": 2, "none": 0}.get(
        plan.get("do_spatial_aug_in", "both"), 1)
    steps = acc * epochs * branches        # branch warps of patch steps
    adjoints = trained * branches
    fast = 0 if exact else adjoints
    deformable = plan.get("spatial_aug_type", "affine") == "deformable"
    if deformable:
        out["warp"] = members * (steps * 12 + fast)
        out["warp_affine"] = members * epochs
    else:
        out["warp"] = 0
        out["warp_affine"] = members * (steps * 2 + fast + epochs)
    exact_adjoints = members * adjoints if exact else 0
    out["warp_adjoint"] = exact_adjoints if deformable else 0
    out["warp_affine_adjoint"] = 0 if deformable else exact_adjoints
    return out


def _read_counts():
    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_wgrad,
                                                  route_launches)
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                               warp_affine_flat_adjoint,
                                               warp_flat, warp_flat_adjoint)

    out = {"conv3x3": conv3x3.launches,
           "conv3x3_wgrad": conv3x3_wgrad.launches,
           "conv3x3_padded": conv3x3.padded_launches,
           "conv3x3_wgrad_padded": conv3x3_wgrad.padded_launches,
           "warp": warp_flat.launches,
           "warp_affine": warp_affine_flat.launches,
           "warp_adjoint": warp_flat_adjoint.launches,
           "warp_affine_adjoint": warp_affine_flat_adjoint.launches}
    for fn, prefix in ((conv3x3, "conv3x3"), (conv3x3_wgrad, "conv3x3_wgrad")):
        out.update({f"{prefix}_{r}": n for r, n in route_launches(fn).items()})
    return out


def _zero_counts():
    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_wgrad,
                                                  zero_launches)
    from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                               warp_affine_flat_adjoint,
                                               warp_flat, warp_flat_adjoint)

    zero_launches(conv3x3)
    zero_launches(conv3x3_wgrad)
    warp_flat.launches = warp_affine_flat.launches = 0
    warp_flat_adjoint.launches = warp_affine_flat_adjoint.launches = 0


def phase_main_path(work: Path, dtype: str, pretrained: str = "TS104_GIN",
                    exact: bool = False, **plan_changes):
    """`run_tta` of a seeded `pretrained` checkpoint through the CLI with
    `DGTTA_COMPUTE_DTYPE=dtype` (and `DGTTA_EXACT_WARP_GRAD=1` if `exact`),
    the smoke plan changed by `plan_changes`; returns the kernels' launch
    counts of that run."""
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
           f"{' exact warp gradient' if exact else ''}")
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
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        summaries = cli(["run_tta", pretrained, ws.dataset_id])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        del os.environ["DGTTA_COMPUTE_DTYPE"]
        os.environ.pop("DGTTA_EXACT_WARP_GRAD", None)
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
    for i in range(n_members):
        path = get_parameters_save_path(run_dir / "tta_outputTs", "case", i)
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
            and "inference" in phases):
        raise AssertionError(f"timings.json: {timings}")
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
        f"{summaries['Ts']['foreground_mean']['Dice']:.4f} (random weights)")
    return launches


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


def main():
    phase_device()
    import torch

    from dg_tta_tpu_torch.kernels import conv3x3, warp

    phase_build()
    totals = {"conv3x3": phase_kernels(), "conv3x3_wgrad": phase_wgrad(),
              "warp": phase_warp(), "warp_grid": phase_warp_deformable()}
    phase_reference()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for dtype in ("float32", "bfloat16"):
            runs["TS104_GIN", dtype] = phase_main_path(
                Path(tmp) / f"gin_{dtype}", dtype)
        # MIND in every forward, GIN in both branches of every step
        for dtype in ("float32", "bfloat16"):
            runs["TS104_GIN_MIND", dtype] = phase_main_path(
                Path(tmp) / f"gin_mind_{dtype}", dtype, "TS104_GIN_MIND",
                do_intensity_aug_in="both")
        # affine TTA with the exact adjoint (its affine entry)
        runs["TS104_GIN exact", "float32"] = phase_main_path(
            Path(tmp) / "exact_float32", "float32", exact=True)
        # deformable TTA: f32 with the fast adjoint, bf16 with the exact one
        runs["TS104_GIN deformable", "float32"] = phase_main_path(
            Path(tmp) / "deformable_float32", "float32",
            spatial_aug_type="deformable")
        runs["TS104_GIN deformable exact", "bfloat16"] = phase_main_path(
            Path(tmp) / "deformable_exact_bfloat16", "bfloat16", exact=True,
            spatial_aug_type="deformable")

    def both(key, dtype=None):
        # launches over the main-path runs (of one type)
        return sum(r[key] for (_, dt), r in runs.items()
                   if dtype in (None, dt))

    c, wg = totals["conv3x3"], totals["conv3x3_wgrad"]
    w32, w16 = totals["warp"]["float32"], totals["warp"]["bfloat16"]
    wg32, wg16 = totals["warp_grid"]["float32"], totals["warp_grid"]["bfloat16"]
    adj, adj_aff, adj_entry = ({k: totals["warp_grid"][f"{k}/adjoint/{site}"]
                                for k in ("float32", "bfloat16")}
                               for site in ("deformable grid", "affine grid",
                                            "affine entry"))
    rows = [
        # the CUDA-core kernels, timed on the shapes they ran before the
        # later routes took them (f32: every conv; bf16: C = 1)
        _row("conv3x3", conv3x3.SOURCE, conv3x3.REPLACES,
             both("conv3x3_cuda_core"), c["float32/cuda_core"],
             c["bfloat16/cuda_core"], "cuda_core"),
        _row("conv3x3_wgrad", conv3x3.WGRAD_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgrad_cuda_core"), wg["float32/cuda_core"],
             wg["bfloat16/cuda_core"], "cuda_core"),
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
             bf16_staged_share=wg16["staged_share"]),
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
                 "library_affine_ms", "staged_share")}),
        _row("conv3x3_wgmma", conv3x3.WGMMA_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgmma", "bfloat16"), c["bfloat16/wgmma"]),
        _row("conv3x3_wgrad_wgmma", conv3x3.WGRAD_WGMMA_SOURCE,
             conv3x3.REPLACES, both("conv3x3_wgrad_wgmma", "bfloat16"),
             wg["bfloat16/wgmma"]),
        _row("conv3x3_wgmma_tf32x3", conv3x3.WGMMA_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgmma_tf32x3", "float32"),
             c["float32/wgmma_tf32x3"]),
        _row("conv3x3_wgrad_tf32x3", conv3x3.WGRAD_TF32X3_SOURCE,
             conv3x3.REPLACES, both("conv3x3_wgrad_wgmma_tf32x3", "float32"),
             wg["float32/wgmma_tf32x3"]),
        # the C = 1 first conv on "c1" (the tensor cores), its bytes and
        # operations floors beside the bound, and its shapes forced onto
        # the CUDA-core kernels with their bound there
        _row("conv3x3_c1", conv3x3.C1_SOURCE, conv3x3.REPLACES,
             both("conv3x3_c1"), c["float32/c1"], c["bfloat16/c1"], "c1",
             **_c1_extra(c)),
        _row("conv3x3_wgrad_c1", conv3x3.C1_SOURCE, conv3x3.REPLACES,
             both("conv3x3_wgrad_c1"), wg["float32/c1"], wg["bfloat16/c1"],
             "c1", **_c1_extra(wg)),
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
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
