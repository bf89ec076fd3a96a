"""Where the warp's exact adjoint spends its time: device times of variants
of its kernel, each a copy of `csrc/warp.cu` with one part of the work
taken out, at the two adjoint sites of `obs/adjoint_times.py` (C = n_opt,
f32 and bf16; the grid entry on a deformable branch's inverse grid and on
an inverse affine's grid, the affine entry at that affine).

    python3 dg_tta_tpu_torch/obs/adjoint_variants.py PARENT_CHECKOUT

Run it by path from this checkout's root, on one card.  PARENT_CHECKOUT
holds the one-thread-per-output adjoint (8 f32 atomics per output and
channel into device memory), whose variants are:
* parent_full: as it is;
* parent_no_adds: its corners and weights, no adds;
* parent_own_index: its 8 x C atomics, each at the output's own index
  (coalesced, no two lanes on one word).
This checkout's kernel (each brick's scatter summed in shared memory and
flushed) gives:
* full: as it is;
* stores: plain shared-memory stores in place of the compare-and-swap
  loops (wrong sums: times the loops);
* no_leftovers: without the global reductions of the x1 products no
  neighbouring lane takes (wrong sums);
* no_flush: without the flush of the box into dx (wrong sums);
* no_x_combine: no lane takes its neighbour's x1 products, all go to dx
  by global reductions (right sums: a design tried and dropped).
Each variant is built by nvcc into build/torch_kernels/variants/ and its
raw C entry called on a preallocated gradient (no zero fill, no cast;
those are timed apart), by CUDA graph (`chip_smoke.device_ms`), twice in
opposite orders.  Prints the card's name and power limit, one line per
(type, site, variant) with both readings, and the same as one JSON line.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

# text substitutions that make each variant from its kernel's source
_RED = 'asm volatile("red.shared.add.f32 [%0], %1;\\n" ::"r"(addr), "f"(v));'
_LEFT = "if (!give[p] && v1 != 0.0f) atomicAdd(dc + lin1[p], v1);"
_FLUSH = "    if (p0 < P) {"
_TAKE = "take[p] = lane > 0 && valid && left == off0[p];"
_PARENT_LOOP = "  for (int c = 0; c < C; ++c) {\n    const float gv = to_f32(gb["
_PARENT_ADD = ("      if (wt[k] != 0.0f) atomicAdd(dc + lin[k], "
               "__fmul_rn(wt[k], gv));\n  }\n")
CHANGE = {
    "full": [],
    "stores": [(_RED, _RED.replace("red.shared.add.f32", "st.shared.f32"))],
    "no_leftovers": [(_LEFT, "")],
    "no_flush": [(_FLUSH, "    if (false) {")],
    "no_x_combine": [(_TAKE, "take[p] = false;")],
}
PARENT = {
    "parent_full": [],
    "parent_no_adds": [
        (_PARENT_LOOP, "  float sink = 0.0f;\n" + _PARENT_LOOP),
        (_PARENT_ADD, "      if (wt[k] != 0.0f) sink += __fmul_rn(wt[k], gv)"
                      " + static_cast<float>(lin[k]);\n  }\n"
                      "  if (sink == -1.2345f) dx[0] = sink;\n")],
    "parent_own_index": [
        (_PARENT_ADD, "      if (wt[k] != 0.0f) atomicAdd(dc + o, "
                      "__fmul_rn(wt[k], gv));\n  }\n")],
}


def _build(sources):
    """{name: ctypes library} of the variant sources, nvcc all at once."""
    from dg_tta_tpu_torch.kernels import build

    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in procs}


def _stream():
    """The current stream (a CUDA graph captures on its own)."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def _variants(source: str, edits):
    out = {}
    for name, subs in edits.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old[:40]!r} is not in the source "
                                 f"once")
            text = text.replace(old, new)
        out[name] = text
    return out


def main(argv):
    import torch

    import chip_smoke as cs
    from dg_tta_tpu_torch.core.fields import get_rand_affine
    from dg_tta_tpu_torch.core.grid import affine_grid
    from dg_tta_tpu_torch.kernels.warp import (ADJOINT_PLAN, _DTYPE_CODES,
                                               _base_table)

    if len(argv) != 1:
        raise SystemExit(__doc__)
    csrc = "dg_tta_tpu_torch/kernels/csrc/warp.cu"
    libs = _build({**_variants(Path(csrc).read_text(), CHANGE),
                   **_variants((Path(argv[0]) / csrc).read_text(), PARENT)})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    P = cs.PATCH
    n = P[0] * P[1] * P[2]
    gen = torch.Generator().manual_seed(4)
    grid_inv = cs._deformable_sites(gen)[3][2]
    _, theta_inv = get_rand_affine(torch.randn((1, 3, 4), generator=gen)
                                   .cuda())
    sites = {"deformable": grid_inv, "affine": affine_grid(theta_inv, P)}
    base = _base_table(P, theta_inv.device)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        g = torch.randn((1, cs.N_OPT, n), generator=torch.Generator()
                        .manual_seed(7)).to(dt).cuda()
        dx = torch.zeros((1, cs.N_OPT, n), device="cuda")
        code = _DTYPE_CODES[dt]
        res[f"{name}|zero fill"] = [cs.device_ms(
            lambda: torch.zeros((1, cs.N_OPT, n), device="cuda"))]
        res[f"{name}|bf16 cast"] = [cs.device_ms(
            lambda: dx.to(torch.bfloat16))]
        for rep, order in enumerate((list(libs), list(libs)[::-1])):
            for v in order:
                lib = libs[v]
                for site, grid in sites.items():
                    gx, gy, gz = (c.contiguous() for c in grid)
                    calls = []
                    if v.startswith("parent"):
                        fn = lib.dgtta_warp_adjoint
                        fn.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_longlong]
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
                        calls.append(("grid", lambda fn=fn, x=gx, y=gy, z=gz:
                                      fn(g.data_ptr(), x.data_ptr(),
                                         y.data_ptr(), z.data_ptr(),
                                         dx.data_ptr(), 1, cs.N_OPT, *P, n,
                                         0, 0, code, _stream())))
                    else:
                        fn = lib.dgtta_warp_adjoint
                        fn.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 12
                                       + [ctypes.c_void_p] * 2)
                        calls.append(("grid", lambda fn=fn, x=gx, y=gy, z=gz:
                                      fn(g.data_ptr(), x.data_ptr(),
                                         y.data_ptr(), z.data_ptr(),
                                         dx.data_ptr(), 1, cs.N_OPT, *P, *P,
                                         0, 0, code, ADJOINT_PLAN[1], None,
                                         _stream())))
                        if site == "affine":
                            fa = lib.dgtta_warp_affine_adjoint
                            fa.argtypes = ([ctypes.c_void_p] * 2
                                           + [ctypes.c_int]
                                           + [ctypes.c_void_p] * 2
                                           + [ctypes.c_int] * 11
                                           + [ctypes.c_void_p] * 2)
                            calls.append(("affine entry", lambda fa=fa: fa(
                                g.data_ptr(), theta_inv.data_ptr(), 0,
                                base.data_ptr(), dx.data_ptr(), 1, cs.N_OPT,
                                *P, *P, 0, code, ADJOINT_PLAN[1], None,
                                _stream())))
                    for entry, call in calls:
                        if call() != 0:
                            raise RuntimeError(f"{v} {site} {entry}: launch "
                                               f"failed")
                        key = f"{name}|{site} {entry}|{v}"
                        res.setdefault(key, []).append(cs.device_ms(call))
    for key, ms in res.items():
        print(key, " ".join(f"{t:.4f}" for t in ms), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path.cwd()))
    sys.exit(main(sys.argv[1:]))
