"""Device times of the warp's exact adjoint (the scatter-add that
`DGTTA_EXACT_WARP_GRAD` runs in every trained step's backward) of one or
more checkouts of the port on one card, for comparing a change with its
parent in one call.

    python3 dg_tta_tpu_torch/obs/adjoint_times.py CHECKOUT [CHECKOUT ...]

Run it by path.  For each CHECKOUT, in the order given (e.g. parent,
change, change, parent: the card's clocks drift within a call), a
subprocess whose import path starts at that checkout builds its kernels
and times, in f32 and bf16, at the logit site (C = n_opt, the patch of
that checkout's `chip_smoke.py`, seeded as its `phase_warp_deformable`):
* the deformable site: `warp_flat_adjoint` on a deformable branch's
  inverse grid (`chip_smoke._deformable_sites`);
* the affine site, as that checkout's engine runs it for an affine
  branch: the affine adjoint entry (`warp_affine_flat_adjoint`) where the
  checkout has one, else `warp_flat_adjoint` on `affine_grid(theta_inv)`,
  with the time of building that grid beside it;
each by CUDA graph (`chip_smoke.device_ms`, device milliseconds per call,
the wrapper's zero fill and bf16 cast included; `affine_grid` copies from
the host and cannot be captured, so it is timed eagerly by CUDA events,
`chip_smoke.time_ms`) and eagerly, held against the plain version within
chip_smoke's ADJOINT_RTOL; and the affine site's whole exact unwarp, its
forward and adjoint as the engine calls them, eagerly.  Where the
checkout's adjoint counts its bricks by path (`kernels.warp.brick_paths`),
each site gives the share of bricks that summed in shared memory; else
null.  Prints the card's name and power limit, then one JSON line per
checkout: {"checkout", "float32": {"deformable": {...}, "affine": {...}},
"bfloat16": {...}}.
"""

import json
import os
import subprocess
import sys
from pathlib import Path


def _staged_share(warp, fn):
    """(fn's result, share of its bricks staged) where the checkout's
    adjoint counts its bricks by path, else (fn's result, None)."""
    import torch

    if not hasattr(warp, "brick_paths"):
        return fn(), None
    with warp.brick_paths() as counts:
        out = fn()
        torch.cuda.synchronize()
        staged, glob = counts.tolist()
    return out, (staged / (staged + glob) if staged + glob else None)


def one(checkout: str) -> dict:
    """The adjoint times of `checkout` (run in its own process)."""
    import torch

    import chip_smoke as cs
    from dg_tta_tpu_torch.core.fields import get_rand_affine
    from dg_tta_tpu_torch.core.grid import affine_grid
    from dg_tta_tpu_torch.kernels import warp

    P = cs.PATCH
    n = P[0] * P[1] * P[2]
    gen = torch.Generator().manual_seed(4)
    grid_inv = cs._deformable_sites(gen)[3][2]
    _, theta_inv = get_rand_affine(torch.randn((1, 3, 4), generator=gen)
                                   .cuda())
    grid = affine_grid(theta_inv, P)
    has_affine = hasattr(warp, "warp_affine_flat_adjoint")
    out = {"checkout": checkout, "affine_entry": has_affine}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        g = torch.randn((1, cs.N_OPT, n), generator=torch.Generator()
                        .manual_seed(7)).to(dt).cuda()
        res = {}
        for site in ("deformable", "affine"):
            if site == "deformable":
                ref = warp.warp_flat_adjoint_reference(g, P, grid_inv)

                def fn():
                    return warp.warp_flat_adjoint(g, P, grid_inv)
            elif has_affine:
                ref = warp.warp_affine_adjoint_reference(g, P, theta_inv, P)

                def fn():
                    return warp.warp_affine_flat_adjoint(g, P, theta_inv, P)

                def unwarp():
                    x = torch.zeros((1, cs.N_OPT, n), dtype=dt,
                                    device="cuda", requires_grad=True)
                    y = warp.warp_affine_op(x, P, theta_inv, P)
                    y.backward(g)
            else:
                ref = warp.warp_flat_adjoint_reference(g, P, grid)

                def fn():
                    return warp.warp_flat_adjoint(g, P, grid)

                def unwarp():
                    x = torch.zeros((1, cs.N_OPT, n), dtype=dt,
                                    device="cuda", requires_grad=True)
                    y = warp.warp_flat_op(x, P, affine_grid(theta_inv, P))
                    y.backward(g)
            got, share = _staged_share(warp, fn)
            again = fn()
            err = max((t.float() - ref.float()).abs().max().item()
                      for t in (got, again))
            tol = cs.ADJOINT_RTOL[name] * ref.float().abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{checkout} {name} {site}: max abs "
                                     f"err {err} > {tol}")
            r = {"device_ms": cs.device_ms(fn), "eager_ms": cs.time_ms(fn),
                 "staged_share": share, "max_abs_err": err,
                 "runs_max_diff": (got.float() - again.float()).abs().max()
                 .item()}
            if site == "affine":
                r["affine_grid_ms"] = 0.0 if has_affine else cs.time_ms(
                    lambda: affine_grid(theta_inv, P))
                r["with_grid_ms"] = r["device_ms"] + r["affine_grid_ms"]
                r["unwarp_eager_ms"] = cs.time_ms(unwarp)
            res[site] = r
        out[name] = res
    return out


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for checkout in argv:
        root = Path(checkout).resolve()
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", checkout], cwd=root, check=True,
                       timeout=600, env={**os.environ,
                                         "PYTHONPATH": str(root)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
