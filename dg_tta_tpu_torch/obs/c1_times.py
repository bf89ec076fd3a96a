"""Device times of the "c1" route (the C = 1 first conv of a 1-channel
model) of one or more checkouts of the port on one card, for comparing a
change with its parent in one call.

    python3 dg_tta_tpu_torch/obs/c1_times.py CHECKOUT [CHECKOUT ...]

Run it by path.  For each CHECKOUT, in the order given (e.g. parent,
change, change, parent: the card's clocks drift within a call), a
subprocess whose import path starts at that checkout builds its kernels
and times with CUDA events (`chip_smoke.time_ms`, 50 launches after 5 of
warm-up), in f32 and bf16, at TS104's first conv (112 planes of 112 x 128,
C = 1 -> 32):
* `conv3x3` on the shapes' own route ("c1"), a window forward (one volume)
  plus a trained step's forward (two volumes);
* `conv3x3_wgrad` on "c1", a trained step (two volumes);
each held against the plain version on the same seeded inputs within
chip_smoke's KERNEL_RTOL / WGRAD_RTOL.  Prints the card's name and power
limit, then one JSON line per checkout: {"checkout", "float32":
{"forward_ms", "wgrad_ms", "forward_rel_err", "wgrad_rel_err"},
"bfloat16": {...}}.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

# (depth, H, W, CO) of TS104's first conv
SHAPE = (112, 112, 128, 32)


def one(checkout: str) -> dict:
    """The times of `checkout`'s "c1" kernels (run in its own process)."""
    import torch

    import chip_smoke as cs
    from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_reference,
                                                  conv3x3_route, conv3x3_wgrad,
                                                  conv3x3_wgrad_reference)

    depth, H, W, CO = SHAPE
    gen = torch.Generator().manual_seed(0)
    out = {"checkout": checkout}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        assert conv3x3_route(1, CO, dt) == "c1"
        res = {"forward_ms": 0.0, "forward_rel_err": 0.0}
        w = (torch.randn((3, 3, 3, 1, CO), generator=gen)
             * (2.0 / 27) ** 0.5).to(dt).cuda()
        for vols in (1, 2):
            x = torch.randn((vols * depth, H, W, 1), generator=gen) \
                .to(dt).cuda()
            with cs.tf32_off():
                ref = conv3x3_reference(x, w, depth=depth).float()
            err = (conv3x3(x, w, depth=depth).float() - ref).abs().max() \
                .item() / ref.abs().max().item()
            if not err <= cs.KERNEL_RTOL[name]:
                raise AssertionError(f"{checkout} {name} forward x{vols}: "
                                     f"relative error {err}")
            res["forward_rel_err"] = max(res["forward_rel_err"], err)
            res["forward_ms"] += cs.time_ms(
                lambda: conv3x3(x, w, depth=depth), iters=50, warmup=5)
        x = torch.randn((2 * depth, H, W, 1), generator=gen).to(dt).cuda()
        dy = torch.randn((2 * depth, H, W, CO), generator=gen).to(dt).cuda()
        with cs.tf32_off():
            ref = conv3x3_wgrad_reference(x, dy, depth=depth)
        err = (conv3x3_wgrad(x, dy, depth=depth) - ref).abs().max().item() \
            / ref.abs().max().item()
        if not err <= cs.WGRAD_RTOL:
            raise AssertionError(f"{checkout} {name} wgrad: relative error "
                                 f"{err}")
        res["wgrad_rel_err"] = err
        res["wgrad_ms"] = cs.time_ms(lambda: conv3x3_wgrad(x, dy, depth=depth),
                                     iters=50, warmup=5)
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
