"""The kernels' launch counters, read and reset together.

Each kernel wrapper adds one to its counter where it launches its kernel
(`kernels/conv3x3.py`, `kernels/warp.py`); these read them as one dict and
set them to 0.
"""

from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_wgrad,
                                              route_launches, zero_launches)
from dg_tta_tpu_torch.kernels.warp import (warp_affine_flat,
                                           warp_affine_flat_adjoint,
                                           warp_flat, warp_flat_adjoint)


def read_counts() -> dict:
    """{counter: launches} since the counters were last set to 0: each
    kernel's total (`conv3x3`, `conv3x3_wgrad`; `warp` for the warp's grid
    entry, `warp_affine` its affine entry, `warp_adjoint` and
    `warp_affine_adjoint` the exact adjoint's entries), the convs' per
    route (`conv3x3_<route>`, `conv3x3_wgrad_<route>`) and on zero-padded
    channels (`conv3x3_padded`, `conv3x3_wgrad_padded`)."""
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


def zero_counts():
    """Set every launch counter to 0."""
    zero_launches(conv3x3)
    zero_launches(conv3x3_wgrad)
    warp_flat.launches = warp_affine_flat.launches = 0
    warp_flat_adjoint.launches = warp_affine_flat_adjoint.launches = 0
