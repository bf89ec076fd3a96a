"""GIN: Global Intensity Non-linear augmentation, a random shallow conv net
(the port of `dg_tta_tpu/ops/gin.py`, after Ouyang et al., TMI 2022).

Four random grouped conv layers (kernel size 3 or 1 drawn per layer, fresh
Gaussian weights per call, leaky ReLU between layers), a per-sample blend
with the input by a uniform alpha, and a rescale to the input's
per-sample Frobenius norm.  Channels-last (B, *spatial, C), 2-D or 3-D.

As in the JAX package, a size-1 kernel is a 3^d kernel masked to its
centre tap (the same standard normal draw), so every layer is one conv
shape.  The draws are an argument (`GinDraws`), made by `draw_gin` from
a `torch.Generator` or handed in by a test from JAX's own key path.

The JAX package computes GIN in plain XLA (`lax.conv_general_dilated`
with `feature_group_count`), outside any Pallas kernel; the port runs the
same grouped conv as `F.conv3d(..., groups=nb)` (`F.conv2d` in 2-D), with
cuDNN's TF32 off around it (`models/unet._no_tf32`, restored after): the
JAX package computes it in full f32.  GIN takes no gradient: it augments
inputs only.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from dg_tta_tpu_torch.models.unet import _no_tf32

GIN_N_LAYER = 4
GIN_INTERM_CHANNELS = 2
LEAKY_SLOPE = 0.01  # torch F.leaky_relu default


@dataclasses.dataclass(frozen=True)
class GinDraws:
    """One call's random net: per layer (kernel (nb * cout, cin, 3, ..),
    shift (nb * cout,)), and the blend weights `alphas` (nb,)."""

    layers: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    alphas: torch.Tensor

    def rows(self, lo: int, hi: int) -> "GinDraws":
        """The nets of samples lo..hi-1 (a layer's rows are sample-major:
        sample b's are b * cout .. b * cout + cout - 1)."""
        nb = self.alphas.shape[0]
        layers = tuple((k[lo * (k.shape[0] // nb):hi * (k.shape[0] // nb)],
                        s[lo * (s.shape[0] // nb):hi * (s.shape[0] // nb)])
                       for k, s in self.layers)
        return GinDraws(layers=layers, alphas=self.alphas[lo:hi])


def _rand_layer_params(generator, nb, cin, cout, ndim, dtype):
    """(kernel (nb * cout, cin, 3, ..), shift (nb * cout,)) of one layer,
    drawn from `generator`; with probability 1/2 (one draw per layer) the
    kernel is masked to its centre tap, a size-1 conv."""
    spatial = (3,) * ndim
    kernel = torch.randn((nb * cout, cin, *spatial), generator=generator,
                         dtype=dtype)
    shift = torch.randn((nb * cout,), generator=generator, dtype=dtype)
    use3 = bool(torch.randint(0, 2, (), generator=generator))
    if not use3:
        mask = torch.zeros(spatial, dtype=dtype)
        mask[(1,) * ndim] = 1.0
        kernel = kernel * mask
    return kernel, shift


def draw_gin(generator, nb, nc, ndim=3, dtype=torch.float32,
             n_layer=GIN_N_LAYER,
             interm_channels=GIN_INTERM_CHANNELS) -> GinDraws:
    """The draws of one `gin_aug` call on (nb, *spatial, nc), from
    `generator` (a CPU generator: the draws are small)."""
    widths = [nc] + [interm_channels] * (n_layer - 1) + [nc]
    layers = tuple(_rand_layer_params(generator, nb, widths[i],
                                      widths[i + 1], ndim, dtype)
                   for i in range(n_layer))
    alphas = torch.rand((nb,), generator=generator, dtype=dtype)
    return GinDraws(layers=layers, alphas=alphas)


def _on(draws: GinDraws, device, dtype) -> GinDraws:
    """`draws` on `device` in `dtype`, moved in one copy."""
    parts = [t for k, s in draws.layers for t in (k, s)] + [draws.alphas]
    flat = torch.cat([t.reshape(-1) for t in parts]).to(device, dtype)
    moved = [v.view(t.shape) for v, t in
             zip(flat.split([t.numel() for t in parts]), parts)]
    return GinDraws(layers=tuple(zip(moved[:-1:2], moved[1:-1:2])),
                    alphas=moved[-1])


def _grouped_conv(x, kernel, nb, cin, cout):
    """Per-sample conv, channels-last, SAME zero padding: x (nb, *spatial,
    cin), kernel (nb * cout, cin, 3, ..) on x's device and in its type ->
    (nb, *spatial, cout).  The batch folds into the channels (sample b's
    input channels are b * cin .. b * cin + cin - 1) and the conv runs
    with groups = nb, TF32 off."""
    spatial = x.shape[1:-1]
    conv = F.conv3d if len(spatial) == 3 else F.conv2d
    xg = x.movedim(-1, 1).reshape(1, nb * cin, *spatial)
    with _no_tf32():
        out = conv(xg, kernel, padding=1, groups=nb)
    return out.reshape(nb, cout, *spatial).movedim(1, -1)


def gin_aug(x: torch.Tensor, draws: GinDraws) -> torch.Tensor:
    """GIN of a channels-last (B, *spatial, C) batch with the net `draws`
    (for B = nb samples of C = nc channels).  Returns the same shape,
    rescaled to the input's per-sample Frobenius norm."""
    nb, nc = x.shape[0], x.shape[-1]
    ndim = x.dim() - 2
    bcast = (nb,) + (1,) * ndim
    draws = _on(draws, x.device, x.dtype)
    h = x
    n_layer = len(draws.layers)
    for li, (kernel, shift) in enumerate(draws.layers):
        cin = h.shape[-1]
        cout = kernel.shape[0] // nb
        h = _grouped_conv(h, kernel, nb, cin, cout)
        h = h + shift.reshape(*bcast, cout)
        if li < n_layer - 1:
            h = torch.where(h >= 0, h, LEAKY_SLOPE * h)
    if h.shape[-1] != nc:
        raise ValueError(f"GIN draws end in {h.shape[-1]} channels, the "
                         f"input has {nc}")
    alphas = draws.alphas.reshape(*bcast, 1)
    mixed = alphas * h + (1.0 - alphas) * x
    dims = tuple(range(1, x.dim()))
    in_frob = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))
    self_frob = torch.sqrt(torch.sum(mixed * mixed, dim=dims, keepdim=True))
    return mixed * (1.0 / (self_frob + 1e-5)) * in_frob
