"""MIND-SSC: the Modality-Independent Neighbourhood Descriptor (the port of
`dg_tta_tpu/ops/mind.py`, after Heinrich et al.).

For each voxel, 12 self-similarity channels from the 6-neighbourhood (the
directed pairs of neighbours at squared distance 2): Gaussian-smoothed
squared differences of shifted copies of the image, minus their minimum
over the channels, divided by their mean over the channels (clipped to
[1e-3, 1e3] times that mean's mean over the whole batch), through exp(-x).
Channels-last: (B, D, H, W, 1) -> (B, D, H, W, 12).

Plain PyTorch on tensors, as the JAX package computes it in plain XLA
(static slices, pads and elementwise ops; no Pallas kernel).  What the
JAX package keeps, and the port with it:
* the edge maps get N(0, noise_scale^2) noise before they are squared, at
  TTA and at inference (the reference keeps it on); the caller hands in the
  standard-normal draws (`noise`), None for none;
* the clip bound is a mean over the whole batch, so the result depends on
  which patches share a call: every caller passes the batch its JAX
  counterpart passes; a data-parallel step (`group`, its ranks each
  holding an equal share of the batch) takes the mean over the ranks
  with a differentiable all-reduce (`parallel/mesh.all_reduce_sum`), the
  global batch's, as the JAX package's sharded step computes it;
* the descriptor computes in the input's type (f32 on every path: MIND
  runs before the U-Net casts to its compute type).

Replicate padding: the image's one-voxel edge pad is one `F.pad` launch
on a channels-first view (C = 1, so the view is free); each 1-D smoothing
pass pads its axis by one `torch.cat` of the axis's first and last slices
(broadcast views) around the tensor.  One descriptor costs 36 launches at
sigma 1 (5 taps): the pad, two stacks of the 12 shifted copies and their
difference, two for the noise, the square, 3 x (pad + 5 taps) of
smoothing, then min, difference, mean, the batch mean, two clip bounds,
the clip, the division, the negation and the exponential; none copies
from the host.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dg_tta_tpu_torch.parallel.mesh import all_reduce_sum

MIND_OUT_CHANNELS = 12


def _ssc_shift_pairs():
    """The 12 directed (shift1, shift2) offset pairs of the SSC pattern:
    all ordered pairs (i > j) of the 6-neighbourhood of a 3x3x3 cell whose
    squared distance is 2, shift1 the row neighbour and shift2 the column
    neighbour.  Each (12, 3), entries in {0, 1, 2}."""
    six = np.array(
        [[0, 1, 1], [1, 1, 0], [1, 0, 1], [1, 1, 2], [2, 1, 1], [1, 2, 1]],
        dtype=np.int64)
    d2 = ((six[:, None, :] - six[None, :, :]) ** 2).sum(-1)
    ii, jj = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    mask = (ii > jj) & (d2 == 2)
    s1 = six[np.repeat(np.arange(6), 6).reshape(6, 6)[mask]]
    s2 = six[np.tile(np.arange(6), 6).reshape(6, 6)[mask]]
    return s1, s2


_S1, _S2 = _ssc_shift_pairs()


def gaussian_kernel_1d(sigma: float, dtype=torch.float32) -> torch.Tensor:
    """Normalized 1-D Gaussian taps, 2 * ceil(1.5 sigma) + 1 of them."""
    n = int(np.ceil(sigma * 3.0 / 2.0)) * 2 + 1
    x = np.linspace(-(n // 2), n // 2, n)
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    w /= w.sum()
    return torch.tensor(w, dtype=dtype)


def smooth3d(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of channels-last (B, D, H, W, C) with
    replicate padding: along D, H and W in turn, the axis padded by its
    edge values, then the taps summed in order (the JAX package's order;
    each tap one multiply-add launch into the sum)."""
    w = [float(v) for v in gaussian_kernel_1d(sigma)]
    p = len(w) // 2
    for axis in (1, 2, 3):
        size = img.shape[axis]
        edge = list(img.shape)
        edge[axis] = p
        x = torch.cat([img.narrow(axis, 0, 1).expand(edge), img,
                       img.narrow(axis, size - 1, 1).expand(edge)], dim=axis)
        acc = x.narrow(axis, 0, size) * w[0]
        for t in range(1, len(w)):
            acc.add_(x.narrow(axis, t, size), alpha=w[t])
        img = acc
    return img


def mind3d(img: torch.Tensor, noise=None, delta: int = 1, sigma: float = 1.0,
           noise_scale: float = 0.05, group=None,
           members=None) -> torch.Tensor:
    """The 12-channel MIND-SSC descriptor of (B, D, H, W, 1) `img`, in
    (0, 1], (B, D, H, W, 12).  `noise`: standard-normal draws of shape
    (B, D, H, W, 12), added to the edge maps times `noise_scale`; None
    (or noise_scale 0) adds none.  `group`: the process group of a
    data-parallel step (module docstring), None for one process.
    `members` M: img (and noise) hold M ensemble members' samples, member
    after member, and each member's descriptor is computed on its own
    samples, its clip bound the mean over them (the JAX package's vmap
    over members)."""
    if members is not None:
        noises = [None] * members if noise is None else noise.chunk(members)
        return torch.cat([mind3d(x, n, delta, sigma, noise_scale, group)
                          for x, n in zip(img.chunk(members), noises)])
    B, D, H, W, C = img.shape
    if C != 1:
        raise ValueError(f"MIND expects a single-channel volume, got "
                         f"{tuple(img.shape)}")
    padded = F.pad(img.movedim(-1, 1), (delta,) * 6, mode="replicate")[:, 0]

    def shifted(offsets):
        return torch.stack(
            [padded[:, oz:oz + D, oy:oy + H, ox:ox + W]
             for oz, oy, ox in (offsets * delta).tolist()], dim=-1)

    edges = shifted(_S1) - shifted(_S2)
    if noise is not None and noise_scale:
        if tuple(noise.shape) != tuple(edges.shape):
            raise ValueError(f"MIND noise must be {tuple(edges.shape)}, got "
                             f"{tuple(noise.shape)}")
        edges = edges + noise_scale * noise.to(edges.dtype)

    ssd = smooth3d(edges * edges, sigma)
    mind = ssd - ssd.amin(dim=-1, keepdim=True)
    mind_var = mind.mean(dim=-1, keepdim=True)
    global_mean = mind_var.mean()
    if group is not None:
        global_mean = (all_reduce_sum(global_mean, group)
                       / dist.get_world_size(group))
    mind_var = torch.clamp(mind_var, global_mean * 0.001, global_mean * 1000)
    return torch.exp(-(mind / mind_var))
