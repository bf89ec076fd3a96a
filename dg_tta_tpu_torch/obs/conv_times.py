"""Times of the tensor-core conv3x3 forward (`conv3x3`, routes "wgmma" and
"wgmma_tf32x3"), weight gradient (`--wgrad`) or MIND-stem kernels
(`--few`) of one or more checkouts of the port on one card, for comparing
a change with its parent in one call.

    python3 dg_tta_tpu_torch/obs/conv_times.py [--splits|--wgrad|--few] CHECKOUT ...

Run it by path.  For each CHECKOUT, in the order given (e.g. parent,
change, change, parent: the card's clocks drift within a call), a
subprocess whose import path starts at that checkout builds its kernels
and times, in f32 and bf16, every shape of that checkout's
`chip_smoke._conv_cases` that takes the type's wgmma route (a window
forward, a trained step's forward and its input gradient) and the same
shapes at the grouped runs' batches (`chip_smoke.GROUPED_RUNS`: f32 at
`patch_group` 4, bf16 at 2), on seeded inputs:
* the kernel's device ms by CUDA graph (`chip_smoke.device_ms`) and its
  eager ms (`chip_smoke.time_ms`, the wrapper's host work included);
* `F.conv3d` on the same inputs (channels-first views; TF32 off in f32),
  device ms by CUDA graph: a yardstick the port never calls;
* the bound (`chip_smoke._ops_ms`: the tensor cores' rate, f32 as three
  tf32 products), TFLOP/s at the device time, and the blocks launched
  (`kernels.conv3x3.wgmma_plan` where the checkout has it, else the
  first design's grid of 8 x 16 pixel tiles);
* the error against the plain version, held to chip_smoke's KERNEL_RTOL.
Totals per type: the chip_smoke row (window forward + trained step, each
shape times its convs per use) and the grouped step.  With `--splits`,
where the checkout has `wgmma_plan`, each row shape of fewer work items
than two per SM is also timed (device ms) at every split count 1-4 the
plan allows, its other fields kept: how the plan's choice of clusters
compares with the others.  Prints the card's name and power limit, one
line per shape, then one JSON line per checkout: {"checkout", "float32":
{"shapes": [...], "row": {...}, "grouped": {...}}, "bfloat16": {...}}.

With `--wgrad` it times the weight gradient instead (`conv3x3_wgrad`,
routes "wgmma" and "wgmma_tf32x3"): every TS104 stride-1 shape with C > 1
at a trained step's batch (2 x depth planes: both branches) and at the
grouped runs' batches, on seeded inputs, printing per shape the device
and eager ms as above, cuDNN's `torch.nn.grad.conv3d_weight` on the same
inputs (device ms; TF32 off in f32), the bound, TFLOP/s, the blocks
launched (`kernels.conv3x3.wgrad_plan` where the checkout has it, else
the grid of the checkout's route) and the error against the plain
version, held to chip_smoke's WGRAD_RTOL; then per type the row (a
trained step: each shape times its convs, chip_smoke's
`conv3x3_wgrad_wgmma*` rows) and the grouped step.

With `--few` it times both kernels of the "few" route (`conv3x3` and
`conv3x3_wgrad` at the MIND stem, `chip_smoke.STEM_SHAPE`, C = 12 -> 32),
in f32 and bf16: the forward at a window's batch (one volume) and a
trained step's (two), the weight gradient at a trained step's; both at
the grouped runs' batches (`chip_smoke.GROUPED_RUNS`) and with three
members side by side (`chip_smoke.CHUNK`, a trained step's batch each,
one launch).  Per shape: device and eager ms as above, `F.conv3d` or
cuDNN's `conv3d_weight` (device ms, TF32 off in f32; at the rows' shapes
alone), the bound (`chip_smoke`'s: the larger of the operations
on the route's unit and the bytes of x, w and y, or x, dy and dW),
TFLOP/s at the device time, the blocks and the steps (output plane
tiles) each block walks (`kernels.conv3x3.few_plan` where the checkout
has it; else the forward's "-" and the weight gradient's splits), and
the error against the plain version at KERNEL_RTOL / WGRAD_RTOL.  Rows
as PERF.md's kernel table counts them: the forward's window + step, the
weight gradient's step.
"""

import json
import os
import subprocess
import sys
from pathlib import Path


def _blocks(cc, N, depth, H, W, C, CO, dtype):
    """(blocks, splits) of one launch of the checkout's kernel."""
    import torch

    if hasattr(cc, "wgmma_plan"):
        p = cc.wgmma_plan(N, depth, H, W, C, CO, dtype)
        return p["blocks"], p["splits"]
    bn = 32 if CO <= 32 else (128 if dtype == torch.bfloat16
                              and CO % 128 == 0 else 64)
    return N * -(-H // 8) * -(-W // 16) * -(-CO // bn), 1


def _cases(cs):
    """(use, volumes, depth, H, W, C, CO, convs per use, in the row?)."""
    rows = [(use, vols, d, H, W, C, CO, mult, True)
            for use, vols, d, H, W, C, CO, mult, _ in cs._conv_cases()
            if C > 1]
    for name, group in cs.GROUPED_RUNS:
        for d, H, W, C, CO, mult in cs.TS104_CONV_SHAPES:
            if C == 1:
                continue
            rows.append((f"{name} grouped step forward", 2 * group, d, H, W,
                         C, CO, mult, False))
            rows.append((f"{name} grouped step dgrad", 2 * group, d, H, W,
                         CO, C, mult, False))
    return rows


def _split_times(cc, cs, run, N, depth, H, W, C, CO, dtype):
    """{splits: device ms} of `run` with the plan's splits forced to each
    count 1-4 that the item's fewest stages allow."""
    plan = cc.wgmma_plan
    base = plan(N, depth, H, W, C, CO, dtype)
    fewest = (C // base["kc"]) * (1 if depth == 1 else 2)
    out = {}
    try:
        for splits in range(1, min(4, fewest) + 1):
            forced = dict(base, splits=splits,
                          blocks=base["items"] * splits if splits > 1
                          else min(base["items"], 132))
            cc.wgmma_plan = lambda *a, _p=forced, **k: _p
            out[splits] = cs.device_ms(run, reps=10)
    finally:
        cc.wgmma_plan = plan
    return out


def one(checkout: str, splits: bool = False) -> dict:
    """The times of `checkout`'s wgmma conv forward (in its own process)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dg_tta_tpu_torch.kernels import conv3x3 as cc

    out = {"checkout": checkout}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        gen = torch.Generator().manual_seed(3)
        shapes = []
        row = dict(device_ms=0.0, eager_ms=0.0, conv3d_ms=0.0, bound_ms=0.0)
        grouped = dict(row)
        for use, vols, depth, H, W, C, CO, mult, in_row in _cases(cs):
            if use.split()[0] in ("float32", "bfloat16") \
                    and not use.startswith(name):
                continue
            N = vols * depth
            x = torch.randn((N, H, W, C), generator=gen).to(dt).cuda()
            w = (torch.randn((3, 3, 3, C, CO), generator=gen)
                 * (2.0 / (27 * C)) ** 0.5).to(dt).cuda()
            route = cc.conv3x3_route(C, CO, dt)
            x5 = x.view(vols, depth, H, W, C).permute(0, 4, 1, 2, 3)
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            with cs.tf32_off():
                ref = cc.conv3x3_reference(x, w, depth=depth)
                conv3d_ms = cs.device_ms(
                    lambda: F.conv3d(x5, wt, padding=1), reps=10)
            got = cc.conv3x3(x, w, depth=depth)
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= cs.KERNEL_RTOL[name] * scale:
                raise AssertionError(f"{checkout} {name} {use} "
                                     f"{(N, H, W, C, CO)}: max abs err {err}")
            del got, ref

            def run():
                return cc.conv3x3(x, w, depth=depth)

            dev = cs.device_ms(run, reps=10)
            eager = cs.time_ms(run)
            ops = cc.conv3x3_flops(x.shape, w.shape, depth)
            bound = cs._ops_ms(ops, name, route)
            blocks, n_splits = _blocks(cc, N, depth, H, W, C, CO, dt)
            res = dict(use=use, N=N, depth=depth, H=H, W=W, C=C, CO=CO,
                       route=route, mult=mult, device_ms=dev,
                       eager_ms=eager, conv3d_ms=conv3d_ms, bound_ms=bound,
                       tflops=ops / dev / 1e9, blocks=blocks,
                       splits=n_splits, max_rel_err=err / scale)
            if splits and in_row and hasattr(cc, "wgmma_plan") and \
                    cc.wgmma_plan(N, depth, H, W, C, CO, dt)["items"] \
                    < 2 * 132:
                res["split_ms"] = _split_times(cc, cs, run, N, depth, H, W,
                                               C, CO, dt)
            shapes.append(res)
            tot = row if in_row else grouped
            for key in ("device_ms", "eager_ms", "conv3d_ms", "bound_ms"):
                tot[key] += mult * res[key]
            print(f"{checkout} {name} {use} N={N} {H}x{W} {C}->{CO} "
                  f"route={route} device_ms={dev:.4f} eager_ms={eager:.4f} "
                  f"conv3d_ms={conv3d_ms:.4f} bound_ms={bound:.4f} "
                  f"TFLOP/s={res['tflops']:.1f} blocks={blocks} "
                  f"splits={n_splits} rel_err={err / scale:.2e} x{mult}"
                  + (" split_ms=" + " ".join(
                      f"{k}:{v:.4f}" for k, v in res["split_ms"].items())
                     if "split_ms" in res else ""), flush=True)
            del x, w, x5, wt
        print(f"{checkout} {name} row (window forward + trained step): "
              + " ".join(f"{k}={v:.3f}" for k, v in row.items()), flush=True)
        print(f"{checkout} {name} grouped step: "
              + " ".join(f"{k}={v:.3f}" for k, v in grouped.items()),
              flush=True)
        out[name] = {"shapes": shapes, "row": row, "grouped": grouped}
    return out


def _wgrad_blocks(cc, N, H, W, C, CO, dtype):
    """Blocks of one weight-gradient launch of the checkout's route."""
    import torch

    if hasattr(cc, "wgrad_plan"):
        return cc.wgrad_plan(N, H, W, C, CO, dtype)["blocks"]
    tiles = N * -(-H // 4) * -(-W // 16)
    if dtype == torch.bfloat16:
        bn = 32 if CO <= 32 else 64
        per = 3 * -(-C // 64) * -(-CO // bn)
        return cc.wgrad_wgmma_splits((N, H, W, C), CO) * per
    per = 3 * -(-C // 32) * -(-CO // 32)
    return cc.wgrad_tf32x3_splits((N, H, W, C), CO) * per


def one_wgrad(checkout: str) -> dict:
    """The times of `checkout`'s tensor-core weight gradient (in its own
    process)."""
    import torch

    import chip_smoke as cs
    from dg_tta_tpu_torch.kernels import conv3x3 as cc

    out = {"checkout": checkout}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        gen = torch.Generator().manual_seed(4)
        cases = [("step", 2, False)] + [
            (f"patch_group {g} step", 2 * g, True)
            for n, g in cs.GROUPED_RUNS if n == name]
        shapes = []
        row = dict(device_ms=0.0, eager_ms=0.0, cudnn_ms=0.0, bound_ms=0.0)
        grouped = dict(row)
        for use, vols, is_grouped in cases:
            for depth, H, W, C, CO, mult in cs.TS104_CONV_SHAPES:
                if C == 1:
                    continue
                N = vols * depth
                x = torch.randn((N, H, W, C), generator=gen).to(dt).cuda()
                dy = torch.randn((N, H, W, CO), generator=gen).to(dt).cuda()
                x5 = x.view(vols, depth, H, W, C).permute(0, 4, 1, 2, 3)
                dy5 = dy.view(vols, depth, H, W, CO).permute(0, 4, 1, 2, 3)
                route = cc.conv3x3_wgrad_route(C, CO, dt)
                with cs.tf32_off():
                    ref = cc.conv3x3_wgrad_reference(x, dy, depth=depth)
                    cudnn_ms = cs.device_ms(
                        lambda: torch.nn.grad.conv3d_weight(
                            x5, (CO, C, 3, 3, 3), dy5, padding=1), reps=5)
                got = cc.conv3x3_wgrad(x, dy, depth=depth)
                torch.cuda.synchronize()
                scale = ref.abs().max().item()
                err = (got - ref).abs().max().item()
                if not err <= cs.WGRAD_RTOL * scale:
                    raise AssertionError(f"{checkout} {name} {use} "
                                         f"{(N, H, W, C, CO)}: max abs err "
                                         f"{err} > {cs.WGRAD_RTOL * scale}")
                del got, ref

                def run():
                    return cc.conv3x3_wgrad(x, dy, depth=depth)

                dev = cs.device_ms(run, reps=10)
                eager = cs.time_ms(run)
                ops = cc.conv3x3_flops(x.shape, (3, 3, 3, C, CO), depth)
                bound = cs._ops_ms(ops, name, route)
                blocks = _wgrad_blocks(cc, N, H, W, C, CO, dt)
                res = dict(use=use, N=N, depth=depth, H=H, W=W, C=C, CO=CO,
                           route=route, mult=mult, device_ms=dev,
                           eager_ms=eager, cudnn_ms=cudnn_ms, bound_ms=bound,
                           tflops=ops / dev / 1e9, blocks=blocks,
                           max_rel_err=err / scale)
                shapes.append(res)
                tot = grouped if is_grouped else row
                for key in ("device_ms", "eager_ms", "cudnn_ms", "bound_ms"):
                    tot[key] += mult * res[key]
                print(f"{checkout} wgrad {name} {use} N={N} {H}x{W} "
                      f"{C}->{CO} route={route} device_ms={dev:.4f} "
                      f"eager_ms={eager:.4f} cudnn_ms={cudnn_ms:.4f} "
                      f"bound_ms={bound:.4f} TFLOP/s={res['tflops']:.1f} "
                      f"blocks={blocks} rel_err={err / scale:.2e} x{mult}",
                      flush=True)
                del x, dy, x5, dy5
        print(f"{checkout} wgrad {name} row (a trained step): "
              + " ".join(f"{k}={v:.3f}" for k, v in row.items()), flush=True)
        print(f"{checkout} wgrad {name} grouped step: "
              + " ".join(f"{k}={v:.3f}" for k, v in grouped.items()),
              flush=True)
        out[name] = {"shapes": shapes, "row": row, "grouped": grouped}
    return out


def _few_cases(cs, name):
    """(use, volumes a member, members, weight gradient?, in the row?) of
    the stem shapes timed for type `name`."""
    cases = [("window forward", 1, 1, False, True),
             ("step forward", 2, 1, False, True),
             ("step wgrad", 2, 1, True, True)]
    for n, g in cs.GROUPED_RUNS:
        if n == name:
            cases += [(f"patch_group {g} step forward", 2 * g, 1, False,
                       False),
                      (f"patch_group {g} step wgrad", 2 * g, 1, True, False)]
    cases += [(f"{cs.CHUNK} members step forward", 2, cs.CHUNK, False, False),
              (f"{cs.CHUNK} members step wgrad", 2, cs.CHUNK, True, False)]
    return cases


def _few_blocks(cc, N, depth, H, W, C, CO, dtype, wgrad):
    """(blocks, steps a block walks) of one member's launch: the
    checkout's `few_plan`, else the first design's weight-gradient splits
    (its forward's grid came from the occupancy at run time)."""
    if hasattr(cc, "few_plan"):
        p = cc.few_plan(N, depth, H, W, C, CO, dtype, wgrad=wgrad)
        return p["blocks"], p["run"]
    if wgrad:
        return cc.wgrad_few_splits((N, H, W, C), CO, dtype), None
    return None, None


def one_few(checkout: str) -> dict:
    """The times of `checkout`'s "few" kernels at the MIND stem (in its own
    process)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dg_tta_tpu_torch.kernels import conv3x3 as cc

    depth, H, W, C, CO = cs.STEM_SHAPE
    out = {"checkout": checkout}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        gen = torch.Generator().manual_seed(6)
        shapes = []
        rows = {k: dict(device_ms=0.0, eager_ms=0.0, library_ms=0.0,
                        bound_ms=0.0) for k in ("forward", "wgrad")}
        for use, vols, M, wgrad, in_row in _few_cases(cs, name):
            N = M * vols * depth
            x = torch.randn((N, H, W, C), generator=gen).to(dt).cuda()
            xs = x.view(M, vols, depth, H, W, C).permute(0, 1, 5, 2, 3, 4)
            if wgrad:
                dy = torch.randn((N, H, W, CO), generator=gen).to(dt).cuda()
                dys = dy.view(M, vols, depth, H, W, CO) \
                    .permute(0, 1, 5, 2, 3, 4)
                members = M if M > 1 else None

                def run():
                    return cc.conv3x3_wgrad(x, dy, depth=depth,
                                            members=members)

                def lib():
                    for m in range(M):
                        torch.nn.grad.conv3d_weight(
                            xs[m], (CO, C, 3, 3, 3), dys[m], padding=1)

                with cs.tf32_off():
                    ref = cc.conv3x3_wgrad_reference(x, dy, depth=depth,
                                                     members=members)
                    # cuDNN's f32 weight gradient takes ~0.4 s a volume:
                    # timed at the row's shape alone
                    lib_ms = (cs.device_ms(lib, reps=2 if name == "float32"
                                           else 5) if in_row else None)
                rtol = cs.WGRAD_RTOL
                nbytes = (x.numel() + dy.numel()) * x.element_size() \
                    + M * 27 * C * CO * 4
                w_shape = (3, 3, 3, C, CO)
            else:
                w = (torch.randn((M, 3, 3, 3, C, CO), generator=gen)
                     * (2.0 / (27 * C)) ** 0.5).to(dt).cuda()
                if M == 1:
                    w = w[0]
                ws = w.view(M, 3, 3, 3, C, CO).permute(0, 5, 4, 1, 2, 3) \
                    .contiguous()

                def run():
                    return cc.conv3x3(x, w, depth=depth)

                def lib():
                    for m in range(M):
                        F.conv3d(xs[m], ws[m], padding=1)

                with cs.tf32_off():
                    ref = cc.conv3x3_reference(x, w, depth=depth)
                    lib_ms = cs.device_ms(lib, reps=10) if in_row else None
                rtol = cs.KERNEL_RTOL[name]
                nbytes = (x.numel() + w.numel() + N * H * W * CO) \
                    * x.element_size()
                w_shape = w.shape
            got = run()
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= rtol * scale:
                raise AssertionError(f"{checkout} {name} {use} "
                                     f"{(N, H, W, C, CO)}: max abs err {err}"
                                     f" > {rtol * scale}")
            del got, ref
            dev = cs.device_ms(run, reps=10)
            eager = cs.time_ms(run)
            ops = cc.conv3x3_flops(x.shape, w_shape, depth)
            bound = max(cs._ops_ms(ops, name, "few"),
                        nbytes / cs.PEAK_BYTES * 1e3)
            blocks, run_len = _few_blocks(cc, N // M, depth, H, W, C, CO, dt,
                                          wgrad)
            res = dict(use=use, N=N, members=M, depth=depth, H=H, W=W, C=C,
                       CO=CO, device_ms=dev, eager_ms=eager,
                       library_ms=lib_ms, bound_ms=bound,
                       tflops=ops / dev / 1e9, blocks=blocks, run=run_len,
                       max_rel_err=err / scale)
            shapes.append(res)
            if in_row:
                tot = rows["wgrad" if wgrad else "forward"]
                for key in ("device_ms", "eager_ms", "library_ms",
                            "bound_ms"):
                    tot[key] += res[key]
            print(f"{checkout} few {name} {use} N={N} members={M} {H}x{W} "
                  f"{C}->{CO} device_ms={dev:.4f} eager_ms={eager:.4f} "
                  f"library_ms={'-' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"bound_ms={bound:.4f} "
                  f"TFLOP/s={res['tflops']:.1f} blocks={blocks} "
                  f"run={run_len} rel_err={err / scale:.2e} "
                  f"(tol {rtol:.1e})", flush=True)
            del x
        for kind, tot in rows.items():
            print(f"{checkout} few {name} {kind} row "
                  f"({'window + step' if kind == 'forward' else 'a step'}): "
                  + " ".join(f"{k}={v:.4f}" for k, v in tot.items()),
                  flush=True)
        out[name] = {"shapes": shapes, "rows": rows}
    return out


def main(argv):
    splits = "--splits" in argv
    wgrad = "--wgrad" in argv
    few = "--few" in argv
    argv = [a for a in argv if a not in ("--splits", "--wgrad", "--few")]
    if argv[:1] == ["--one"]:
        res = (one_few(argv[1]) if few else one_wgrad(argv[1]) if wgrad
               else one(argv[1], splits))
        print(json.dumps(res), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for checkout in argv:
        root = Path(checkout).resolve()
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", checkout] + ["--splits"] * splits
                       + ["--wgrad"] * wgrad + ["--few"] * few,
                       cwd=root, check=True,
                       timeout=900, env={**os.environ,
                                         "PYTHONPATH": str(root)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
