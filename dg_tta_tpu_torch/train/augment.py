"""nnUNet-style training data augmentation for DG pretraining (the port of
`dg_tta_tpu/train/augment.py` in its stock form, `DGTTA_DA_TPU=0`).

Transforms, in order (nnUNet v2.2.1 defaults for 3d_fullres; no
mirroring: the DG trainers turn it off): rotation and scaling (one affine,
p = 0.2 each), Gaussian noise (p = 0.1), Gaussian blur (p = 0.2),
multiplicative brightness (p = 0.15), contrast (p = 0.15), low-resolution
simulation (continuous, p = 0.25; or MultiRes's discrete zooms {1/6, 1/4,
1/2} per axis, p = 0.5), gamma of the inverted image (p = 0.1), gamma
(p = 0.3).

The random draws are an argument: JAX's threefry and torch's generators
never give the same bits, so `augment_batch` takes one `SampleDraws` per
sample (the values and the Bernoulli gates the JAX package draws from 16
keys a sample), made by `draw_sample` from a `torch.Generator` or handed
in by a test from JAX's own key splits.

Where the work runs:
* the spatial transform: the warp kernel's affine entry
  (`kernels/warp.warp_affine_flat`), the image trilinear with border
  padding and the labels nearest with zeros, one launch each per batch;
* the continuous low-resolution simulation: the warp kernel's grid entry
  (`kernels/warp.warp_flat`) at a grid quantized to the low-resolution
  lattice, built on the host per axis with the lattice index the JAX
  package's jitted step picks (`_lowres_axis`), one launch per batch;
* MultiRes: the exact per-axis operators (`_lowres_axis_matrices`, the
  scipy construction), applied by f32 `torch.tensordot` with TF32 off
  (restored after), as the JAX package computes them outside any Pallas
  kernel;
* noise, blur, brightness, contrast and gamma: plain PyTorch.
The JAX package computes every transform and selects by its gate.  Here a
transform whose gate is off is skipped where the select returns the input
unchanged bit for bit (noise, blur, brightness, contrast, gamma); the
spatial warp and the low-resolution pass run whatever their gate, as in
the JAX package: at the identity they are not the identity bit for bit
(the warp's coordinates carry f32 rounding into its weights).
"""

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dg_tta_tpu_torch.kernels.warp import warp_affine_flat, warp_flat
from dg_tta_tpu_torch.models.unet import _no_tf32


@dataclasses.dataclass(frozen=True)
class DAConfig:
    rotation_rad: float = 0.52          # ~30 degrees, nnUNet's 3D default
    p_rotation: float = 0.2
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_scale: float = 0.2
    p_noise: float = 0.1
    noise_sigma: Tuple[float, float] = (0.0, 0.1)
    p_blur: float = 0.2
    blur_sigma: Tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness: Tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast: Tuple[float, float] = (0.75, 1.25)
    p_lowres: float = 0.25
    lowres_zoom: Tuple[float, float] = (0.5, 1.0)
    discrete_lowres_zooms: Optional[Tuple[float, ...]] = None  # MultiRes
    p_gamma_invert: float = 0.1
    p_gamma: float = 0.3
    gamma_range: Tuple[float, float] = (0.7, 1.5)


MULTIRES_ZOOMS = (1.0 / 6.0, 0.25, 0.5)  # discrete_downsampling.py:20-24
BLUR_RADIUS = 4   # the support of the largest blur sigma (1.0)


@dataclasses.dataclass(frozen=True)
class SampleDraws:
    """The random draws of one sample's augmentation: each value beside its
    Bernoulli gate.  `lowres` is the continuous zoom (3,) in (D, H, W)
    order, or with MultiRes the zoom indices (3,) into
    `DAConfig.discrete_lowres_zooms`; `noise(shape, device)` gives the
    standard-normal noise of the image (drawn only where `do_noise`)."""

    angles: Tuple[float, float, float]
    do_rotation: bool
    scale: float
    do_scale: bool
    noise_sigma: float
    noise: Callable
    do_noise: bool
    blur_sigma: float
    do_blur: bool
    brightness: float
    do_brightness: bool
    contrast: float
    do_contrast: bool
    lowres: Tuple
    do_lowres: bool
    gamma_invert: float
    do_gamma_invert: bool
    gamma: float
    do_gamma: bool


def _f32(v) -> float:
    return float(np.float32(v))


def draw_sample(generator: torch.Generator, cfg: DAConfig,
                noise: Callable) -> SampleDraws:
    """One sample's draws from `generator` (a CPU generator), each value
    from the range and each gate at the probability of `cfg`; `noise` is
    the sample's standard-normal source, `(shape, device) -> tensor`."""
    def uniform(lo, hi, n=None):
        u = torch.rand(() if n is None else (n,), generator=generator)
        v = lo + u * (hi - lo)
        return _f32(v) if n is None else tuple(_f32(x) for x in v)

    def gate(p):
        return bool(torch.rand((), generator=generator) < p)

    if cfg.discrete_lowres_zooms is None:
        lowres = uniform(*cfg.lowres_zoom, 3)
        p_lowres = cfg.p_lowres
    else:
        lowres = tuple(int(i) for i in torch.randint(
            0, len(cfg.discrete_lowres_zooms), (3,), generator=generator))
        p_lowres = 0.5
    return SampleDraws(
        angles=uniform(-cfg.rotation_rad, cfg.rotation_rad, 3),
        do_rotation=gate(cfg.p_rotation),
        scale=uniform(*cfg.scale_range), do_scale=gate(cfg.p_scale),
        noise_sigma=uniform(*cfg.noise_sigma), noise=noise,
        do_noise=gate(cfg.p_noise),
        blur_sigma=uniform(*cfg.blur_sigma), do_blur=gate(cfg.p_blur),
        brightness=uniform(*cfg.brightness),
        do_brightness=gate(cfg.p_brightness),
        contrast=uniform(*cfg.contrast), do_contrast=gate(cfg.p_contrast),
        lowres=lowres, do_lowres=gate(p_lowres),
        gamma_invert=uniform(*cfg.gamma_range),
        do_gamma_invert=gate(cfg.p_gamma_invert),
        gamma=uniform(*cfg.gamma_range), do_gamma=gate(cfg.p_gamma))


def rot_scale_affine(d: SampleDraws) -> torch.Tensor:
    """The (3, 4) f32 affine of the rotation (per-axis Euler angles, where
    gated on) and isotropic scale (where gated on): rz @ ry @ rx times the
    scale, no translation (`_rand_rot_scale_affine`).  The scale
    multiplies the sampling grid: > 1 zooms out."""
    ang = torch.tensor(d.angles if d.do_rotation else (0.0, 0.0, 0.0),
                       dtype=torch.float32)
    ca, sa = torch.cos(ang), torch.sin(ang)
    one, zero = torch.ones(()), torch.zeros(())
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, ca[0], -sa[0]]),
                      torch.stack([zero, sa[0], ca[0]])])
    ry = torch.stack([torch.stack([ca[1], zero, sa[1]]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sa[1], zero, ca[1]])])
    rz = torch.stack([torch.stack([ca[2], -sa[2], zero]),
                      torch.stack([sa[2], ca[2], zero]),
                      torch.stack([zero, zero, one])])
    scale = d.scale if d.do_scale else 1.0
    mat = (rz @ ry @ rx) * torch.tensor(scale, dtype=torch.float32)
    return torch.cat([mat, torch.zeros(3, 1)], dim=1)


def _blur_1d(x, sigma: float, axis: int):
    """Gaussian blur of (D, H, W, C) `x` along spatial `axis`: a 9-tap
    kernel (radius 4, the support of the largest sigma) with edge padding,
    the taps summed in order."""
    offs = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=x.dtype)
    k = torch.exp(-0.5 * (offs / max(_f32(sigma), 1e-6)) ** 2)
    k = (k / torch.sum(k)).tolist()
    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    idx = torch.arange(-BLUR_RADIUS, n + BLUR_RADIUS, device=x.device)
    xp = xm.index_select(-1, idx.clamp(0, n - 1))   # edge padding
    out = 0.0
    for i in range(2 * BLUR_RADIUS + 1):
        out = out + xp[..., i:i + n] * k[i]
    return out.movedim(-1, axis)


def _gaussian_blur(x, sigma: float):
    for ax in (0, 1, 2):
        x = _blur_1d(x, sigma, ax)
    return x


@functools.lru_cache(maxsize=None)
def _lowres_axis_matrices(size: int, zooms: Tuple[float, ...]):
    """The exact per-axis operators of the discrete low-resolution
    simulation (the reference's SimulateDiscreteLowResolutionTransform:
    skimage.resize down, order 0, edge mode, no anti-aliasing, then up,
    order 3; a linear map, separable per axis): the identity pushed through
    scipy.ndimage.zoom as skimage.resize delegates to it.  Returns
    (len(zooms) + 1, size, size) float32, the last the identity (the gate's
    off branch)."""
    from scipy import ndimage

    mats = []
    for zm in zooms:
        tgt = max(int(round(size * zm)), 1)
        eye = np.eye(size, dtype=np.float64)
        down = ndimage.zoom(eye, (tgt / size, 1.0), order=0, mode="nearest",
                            grid_mode=True)
        up = ndimage.zoom(down, (size / down.shape[0], 1.0), order=3,
                          mode="nearest", grid_mode=True)
        assert up.shape == (size, size), (up.shape, size, zm)
        mats.append(up)
    mats.append(np.eye(size, dtype=np.float64))
    return np.stack(mats).astype(np.float32)


def _discrete_lowres(x, zoom_idx, zooms, patch_size):
    """The exact discrete low-resolution operator on (D, H, W, C) `x`, one
    matrix per axis: `zoom_idx` (3,) indexes `zooms` plus the identity."""
    with _no_tf32():
        for ax in range(3):
            m = torch.from_numpy(_lowres_axis_matrices(
                patch_size[ax], tuple(zooms))[zoom_idx[ax]]).to(x.device)
            x = torch.tensordot(m, x, dims=([1], [ax])).movedim(0, ax)
    return x


def _lowres_axis(size: int, zoom: float) -> torch.Tensor:
    """The sample coordinates along one axis of the continuous
    low-resolution simulation (`_lowres_sim`): each output voxel i snapped
    to the centre of its voxel u on a lattice of low = round(size * zoom)
    voxels, u = round-half-even((i + 1/2) low / size - 1/2).  Where that
    lies on a tie (every 7th voxel of a 112-voxel axis on a 64- or
    96-voxel lattice), the f32 rounding decides.  The JAX package's step
    runs under `jax.jit`, where XLA folds the identity grid into one
    product, (2i + 1) * fl(low * fl(1 / (2 size))), and contracts the
    - 1/2 into a fused multiply-add (one rounding); eagerly it divides
    first and picks the other neighbour at some ties.  The host computes
    the jitted form: the product and difference exact in float64, rounded
    once to f32."""
    zm = torch.tensor(zoom, dtype=torch.float32)
    low = torch.clamp(torch.round(size * zm), min=1.0)
    m = low * (1.0 / torch.tensor(2.0 * size, dtype=torch.float32))
    i = torch.arange(size, dtype=torch.float64)
    u = torch.round(((2.0 * i + 1.0) * m.double() - 0.5).float())
    return (2.0 * u + 1.0) / low - 1.0


def _lowres_grid(zooms, patch_size, device):
    """The batch's quantized grid, an (x, y, z) tuple of (B, D, H, W)
    tensors on `device`, from each sample's zoom (3,) in (D, H, W) order."""
    D, H, W = patch_size
    axes = [torch.stack([_lowres_axis(n, z[i]) for z in zooms])
            for i, n in enumerate((D, H, W))]
    B = len(zooms)
    zc = axes[0].to(device)[:, :, None, None].expand(B, D, H, W)
    yc = axes[1].to(device)[:, None, :, None].expand(B, D, H, W)
    xc = axes[2].to(device)[:, None, None, :].expand(B, D, H, W)
    return xc, yc, zc


def _gamma(x, g: float, invert: bool):
    y = -x if invert else x
    mn = torch.min(y)
    rng = torch.clamp(torch.max(y) - mn, min=1e-7)
    out = torch.pow((y - mn) / rng, _f32(g)) * rng + mn
    return -out if invert else out


def _flat(vol):
    """(B, D, H, W, C) -> channels-first flat (B, C, D*H*W)."""
    B, C = vol.shape[0], vol.shape[-1]
    return vol.movedim(-1, 1).reshape(B, C, -1).contiguous()


def _unflat(flat, spatial):
    return flat.reshape(flat.shape[0], flat.shape[1], *spatial).movedim(1, -1)


@torch.no_grad()
def augment_batch(draws: Sequence[SampleDraws], imgs, segs, cfg: DAConfig):
    """Augment a (B, D, H, W, C) f32 image batch and its (B, D, H, W, 1)
    label batch (f32) with one `SampleDraws` per sample; returns both,
    shapes unchanged."""
    B = imgs.shape[0]
    if len(draws) != B:
        raise ValueError(f"{len(draws)} draws for a batch of {B}")
    spatial = tuple(imgs.shape[1:4])
    dev = imgs.device

    # spatial: rotation + scale, one grid for image and labels
    theta = torch.stack([rot_scale_affine(d) for d in draws]).to(dev)
    imgs = _unflat(warp_affine_flat(_flat(imgs), spatial, theta, spatial,
                                    mode="trilinear", padding_mode="border"),
                   spatial)
    segs = _unflat(warp_affine_flat(_flat(segs), spatial, theta, spatial,
                                    mode="nearest", padding_mode="zeros"),
                   spatial)

    out = []
    for b, d in enumerate(draws):
        img = imgs[b]
        if d.do_noise:
            img = img + d.noise(tuple(img.shape), dev) * _f32(d.noise_sigma)
        if d.do_blur:
            img = _gaussian_blur(img, d.blur_sigma)
        if d.do_brightness:
            img = img * _f32(d.brightness)
        if d.do_contrast:
            mean = torch.mean(img)
            img = (img - mean) * _f32(d.contrast) + mean
        if cfg.discrete_lowres_zooms is not None:
            n = len(cfg.discrete_lowres_zooms)
            idx = d.lowres if d.do_lowres else (n, n, n)
            img = _discrete_lowres(img, idx, cfg.discrete_lowres_zooms,
                                   spatial)
        out.append(img)
    imgs = torch.stack(out)

    if cfg.discrete_lowres_zooms is None:
        zooms = [d.lowres if d.do_lowres else (1.0, 1.0, 1.0) for d in draws]
        imgs = _unflat(warp_flat(_flat(imgs), spatial,
                                 _lowres_grid(zooms, spatial, dev),
                                 mode="trilinear", padding_mode="border"),
                       spatial)

    out = []
    for b, d in enumerate(draws):
        img = imgs[b]
        if d.do_gamma_invert:
            img = _gamma(img, d.gamma_invert, invert=True)
        if d.do_gamma:
            img = _gamma(img, d.gamma, invert=False)
        out.append(img)
    return torch.stack(out), segs
