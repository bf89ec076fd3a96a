"""Device times of the warp kernel's two forward entries (`warp_affine_flat`
and `warp_flat`) of one or more checkouts of the port on one card, for
comparing a change with its parent in one call.

    python3 dg_tta_tpu_torch/obs/warp_times.py CHECKOUT [CHECKOUT ...]

Run it by path.  For each CHECKOUT, in the order given (e.g. parent,
change, change, parent: the card's clocks drift within a call), a
subprocess whose import path starts at that checkout builds its kernels
and times, in f32 and bf16, on the seeded inputs of that checkout's
`chip_smoke.py`:
* the four affine call sites of adaptation (`chip_smoke._warp_sites`:
  the border input warp, C = 1; the zeros unwarp and its adjoint,
  C = n_opt, the adjoint times 1 / |det|; the nearest labels, a
  224 x 224 x 256 volume onto the patch), through the affine entry and
  through the grid entry on the card's `affine_grid`;
* the five sites of a deformable branch (`chip_smoke._deformable_sites`:
  the field warps, C = 3 f32, border and zeros, align_corners=True; the
  input warp, the unwarp and the fast adjoint) through the grid entry;
each by CUDA graph (`chip_smoke.device_ms`, device milliseconds per call)
and in host microseconds per call (`chip_smoke.host_us`), held against
the plain version within chip_smoke's WARP_RTOL (nearest exactly), the
affine entry against the grid entry on `affine_grid` bit for bit.  Where
the checkout's kernel counts its bricks by path (`kernels.warp.
brick_paths`), each site gives the share of bricks that staged their
source box in shared memory; else null.  Totals: the affine entry over the
four sites, and the grid entry per deformable branch of a trained step
(10 field warps, the input warp, the unwarp and the fast adjoint).
Prints the card's name and power limit, then one JSON line per checkout:
{"checkout", "float32": {"sites": {site: {...}}, "affine_device_ms",
"branch_device_ms"}, "bfloat16": {...}}.
"""

import json
import os
import subprocess
import sys
from pathlib import Path


def _paths(warp, fn):
    """(fn's result, share of its bricks staged) where the checkout counts
    its bricks by path, else (fn's result, None)."""
    import torch

    if not hasattr(warp, "brick_paths"):
        return fn(), None
    with warp.brick_paths() as counts:
        out = fn()
        torch.cuda.synchronize()
        staged, glob = counts.tolist()
    return out, staged / (staged + glob)


def _check(name, site, got, ref, rtol, exact):
    err = (got.float() - ref.float()).abs().max().item()
    tol = 0.0 if exact else rtol * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name} {site}: max abs err {err} > {tol}")
    return err


def one(checkout: str) -> dict:
    """The times of `checkout`'s warp entries (run in its own process)."""
    import torch

    import chip_smoke as cs
    from dg_tta_tpu_torch.core.grid import affine_grid
    from dg_tta_tpu_torch.kernels import warp

    P = cs.PATCH
    out = {"checkout": checkout}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        gen = torch.Generator().manual_seed(2)
        sites, aff_total, branch = {}, 0.0, 0.0
        for site, C, src, theta, scale, mode, pad in cs._warp_sites(gen,
                                                                   "cuda"):
            flat = torch.randn((1, C, src[0] * src[1] * src[2]),
                               generator=gen).to(dt).cuda()
            grid = affine_grid(theta, P)
            kw = dict(mode=mode, padding_mode=pad)

            def affine():
                return warp.warp_affine_flat(flat, src, theta, P,
                                             scale=scale, **kw)

            def by_grid():
                return warp.warp_flat(flat, src, grid, **kw)

            got, share = _paths(warp, affine)
            same, grid_share = _paths(warp, by_grid)
            if scale is not None:
                same = same * scale.reshape(-1, 1, 1).to(dt)
            if not torch.equal(got, same):
                raise AssertionError(f"{checkout} {name} {site}: the affine "
                                     f"entry differs from the grid entry")
            ref = warp.warp_affine_reference(flat, src, theta, P,
                                             scale=scale, **kw)
            err = _check(name, site, got, ref, cs.WARP_RTOL[name],
                         mode == "nearest")
            res = {"affine_device_ms": cs.device_ms(affine),
                   "affine_host_us": cs.host_us(affine),
                   "grid_device_ms": cs.device_ms(by_grid),
                   "grid_host_us": cs.host_us(by_grid),
                   "staged_share": share, "grid_staged_share": grid_share,
                   "max_abs_err": err}
            aff_total += res["affine_device_ms"]
            sites[site] = res
        for site, C, grid, pad, align, mult, field in cs._deformable_sites(
                torch.Generator().manual_seed(4)):
            src_dt = torch.float32 if field is not None else dt
            flat = (field if field is not None else torch.randn(
                (1, C, P[0] * P[1] * P[2]), generator=gen)).to(src_dt).cuda()
            kw = dict(padding_mode=pad, align_corners=align)

            def by_grid():
                return warp.warp_flat(flat, P, grid, **kw)

            got, share = _paths(warp, by_grid)
            ref = warp.warp_flat_reference(flat, P, grid, **kw)
            err = _check(name, site, got, ref,
                         cs.WARP_RTOL[str(src_dt).split(".")[-1]], False)
            res = {"grid_device_ms": cs.device_ms(by_grid),
                   "grid_host_us": cs.host_us(by_grid),
                   "grid_staged_share": share, "per_branch": mult,
                   "max_abs_err": err}
            branch += mult * res["grid_device_ms"]
            sites[site] = res
        out[name] = {"sites": sites, "affine_device_ms": aff_total,
                     "branch_device_ms": branch}
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
