"""The random draws of TTA adaptation and inference, as an injectable
source.

JAX's threefry and torch's generators never give the same bits from one
seed, so the engine (`tta/engine.py`) and `infer/sliding_window.py` do not
draw for themselves: they ask a draw source, and a test can hand in a
source built from the JAX package's own draws to hold both packages to the
same patches, augmentations and noise.

A source gives, for ensemble member `member`, epoch `epoch` and
accumulation step `step`, a `PatchDraws`:
  * `vol_idx` (B,): the volume of each patch (`tta_across_all_samples`
    stacks several volumes);
  * `uniforms` (B, 3): the patch offset draws in [0, 1), (D, H, W) order
    (`core/patches.patch_affine`);
  * `noise_a`, `noise_b` (B, 3, 4): the standard-normal affine noise of
    branch a and branch b (`core/fields.get_rand_affine`);
  * `gin_a`, `gin_b`: the GIN net of each branch that runs GIN
    (`ops/gin.GinDraws`, for the B patches), else None;
  * `mind_noise(shape, device)`: the standard-normal MIND noise of the
    step's one forward of both branches (2B patches), on `device`;
  * `field_a(shape, device)`, `field_b(shape, device)`: the standard-normal
    noise of each branch's deformable field, (B, D//5, H//5, W//5, 3) at
    the default plan (`core/fields.get_disp_field`), on `device`;
for the evaluation repeat `rep` of an epoch, the volume indices of the
centre patches (`eval_volumes`) and their MIND noise (`eval_mind_noise`);
and for sliding-window inference the MIND noise of window `window` (its
index in the window grid) through member `member`
(`window_mind_noise`).  A warm-up epoch and a training epoch read the same
draws.
"""

import dataclasses
import functools
import hashlib
from typing import Callable, Optional

import numpy as np
import torch

from dg_tta_tpu_torch.ops.gin import GinDraws, draw_gin


@dataclasses.dataclass(frozen=True)
class PatchDraws:
    vol_idx: np.ndarray    # (B,) int64
    uniforms: np.ndarray   # (B, 3) float32
    noise_a: np.ndarray    # (B, 3, 4) float32
    noise_b: np.ndarray    # (B, 3, 4) float32
    gin_a: Optional[GinDraws] = None
    gin_b: Optional[GinDraws] = None
    # (shape, device) -> standard-normal tensor
    mind_noise: Optional[Callable] = None
    field_a: Optional[Callable] = None
    field_b: Optional[Callable] = None


class TorchDraws:
    """The default source.  Every (member, epoch, step), evaluation repeat
    and (window, member) of inference has its own seed, a hash of (seed,
    sample index, member id, ...): the small draws come from a CPU
    `torch.Generator` of that seed, in a fixed order (GIN's nets after the
    affine noise, a only where branch a runs GIN), and the MIND noise
    (2 x 112 x 112 x 128 x 12 f32 per full-size step) and each branch's
    deformable field noise from a generator on the device that needs it,
    seeded from the same hash with "mind", or "field" and the branch,
    appended: drawn only when asked for, so they move no other draw.  A
    member's draws therefore do not depend on which other
    members run, or in which order: a resumed run that adapts only the
    missing members redraws exactly what a full run would have drawn for
    them."""

    def __init__(self, seed: int = 0, sample_index: int = 0):
        self.seed = int(seed)
        self.sample_index = int(sample_index)

    def _seed(self, *parts) -> int:
        text = "/".join(str(p) for p in (self.seed, self.sample_index, *parts))
        digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
        return int.from_bytes(digest, "little") & (2 ** 63 - 1)

    def _generator(self, *parts) -> torch.Generator:
        return torch.Generator().manual_seed(self._seed(*parts))

    def _normal(self, seed, shape, device) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(tuple(shape), generator=g, device=device)

    def patch(self, member: int, epoch: int, step: int, n_vols: int,
              batch: int, gin_branches=(), channels: int = 1) -> PatchDraws:
        """`gin_branches`: the branches ("branch_a", "branch_b") that run
        GIN on the `channels`-channel patches."""
        parts = (member, epoch, "step", step)
        g = self._generator(*parts)
        out = dict(
            vol_idx=torch.randint(0, n_vols, (batch,), generator=g).numpy(),
            uniforms=torch.rand((batch, 3), generator=g).numpy(),
            noise_a=torch.randn((batch, 3, 4), generator=g).numpy(),
            noise_b=torch.randn((batch, 3, 4), generator=g).numpy())
        for branch, key in (("branch_a", "gin_a"), ("branch_b", "gin_b")):
            if branch in gin_branches:
                out[key] = draw_gin(g, batch, channels)
        seeds = {k: self._seed(*parts, *tail) for k, tail in (
            ("mind_noise", ("mind",)), ("field_a", ("field", "branch_a")),
            ("field_b", ("field", "branch_b")))}
        return PatchDraws(**out, **{
            k: functools.partial(self._normal, seed)
            for k, seed in seeds.items()})

    def eval_volumes(self, member: int, epoch: int, rep: int, n_vols: int,
                     batch: int) -> np.ndarray:
        g = self._generator(member, epoch, "eval", rep)
        return torch.randint(0, n_vols, (batch,), generator=g).numpy()

    def eval_mind_noise(self, member: int, epoch: int, rep: int, shape,
                        device) -> torch.Tensor:
        return self._normal(self._seed(member, epoch, "eval", rep, "mind"),
                            shape, device)

    def window_mind_noise(self, window: int, member: int, shape,
                          device) -> torch.Tensor:
        return self._normal(self._seed("window", window, member, "mind"),
                            shape, device)
