"""The random draws of TTA adaptation, as an injectable source.

JAX's threefry and torch's generators never give the same bits from one
seed, so the engine (`tta/engine.py`) does not draw for itself: it asks a
draw source, and a test can hand in a source built from the JAX package's
own draws to hold both packages to the same patches and augmentations.

A source gives, for ensemble member `member`, epoch `epoch` and
accumulation step `step`, a `PatchDraws`:
  * `vol_idx` (B,): the volume of each patch (`tta_across_all_samples`
    stacks several volumes);
  * `uniforms` (B, 3): the patch offset draws in [0, 1), (D, H, W) order
    (`core/patches.patch_affine`);
  * `noise_a`, `noise_b` (B, 3, 4): the standard-normal affine noise of
    branch a and branch b (`core/fields.get_rand_affine`);
and, for the evaluation repeat `rep` of an epoch, the volume indices of
the centre patches (`eval_volumes`).  A warm-up epoch and a training epoch
read the same draws.
"""

import dataclasses
import hashlib

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PatchDraws:
    vol_idx: np.ndarray    # (B,) int64
    uniforms: np.ndarray   # (B, 3) float32
    noise_a: np.ndarray    # (B, 3, 4) float32
    noise_b: np.ndarray    # (B, 3, 4) float32


class TorchDraws:
    """The default source: every (member, epoch, step) and every
    evaluation repeat gets its own CPU `torch.Generator`, seeded from a hash
    of (seed, sample index, member id, ...).  A member's draws therefore do
    not depend on which other members run, or in which order: a resumed run
    that adapts only the missing members redraws exactly what a full run
    would have drawn for them."""

    def __init__(self, seed: int = 0, sample_index: int = 0):
        self.seed = int(seed)
        self.sample_index = int(sample_index)

    def _generator(self, *parts) -> torch.Generator:
        text = "/".join(str(p) for p in (self.seed, self.sample_index, *parts))
        digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
        return torch.Generator().manual_seed(
            int.from_bytes(digest, "little") & (2 ** 63 - 1))

    def patch(self, member: int, epoch: int, step: int, n_vols: int,
              batch: int) -> PatchDraws:
        g = self._generator(member, epoch, "step", step)
        return PatchDraws(
            vol_idx=torch.randint(0, n_vols, (batch,), generator=g).numpy(),
            uniforms=torch.rand((batch, 3), generator=g).numpy(),
            noise_a=torch.randn((batch, 3, 4), generator=g).numpy(),
            noise_b=torch.randn((batch, 3, 4), generator=g).numpy())

    def eval_volumes(self, member: int, epoch: int, rep: int, n_vols: int,
                     batch: int) -> np.ndarray:
        g = self._generator(member, epoch, "eval", rep)
        return torch.randint(0, n_vols, (batch,), generator=g).numpy()
