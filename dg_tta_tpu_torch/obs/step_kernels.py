"""Device kernels per trained patch step of a checkout of the port, for
comparing two checkouts (a change and its parent) on one card.

    python3 dg_tta_tpu_torch/obs/step_kernels.py CHECKOUT [float32|bfloat16]

Run it by path, not with `-m`: it imports `dg_tta_tpu_torch` from
CHECKOUT, runs that checkout's `obs.profile_adaptation.profile_steps` (which
prints its own step profile) with `torch.profiler.profile` wrapped so that
the profile is kept, and prints every device kernel the profile saw (the
port's and the library's) divided by the profiled steps.
"""

import sys

import torch


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root, dtype = argv[0], (argv[1] if len(argv) > 1 else "float32")
    sys.path.insert(0, root)
    kept = []

    class Keep(torch.profiler.profile):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    torch.profiler.profile = Keep
    from dg_tta_tpu_torch.obs import profile_adaptation

    profile_adaptation.profile_steps(dtype)
    n = sum(1 for e in kept[-1].events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"step_kernels: {root} {dtype}: device kernels per step "
          f"{n / profile_adaptation.STEPS:.1f}")


if __name__ == "__main__":
    main()
