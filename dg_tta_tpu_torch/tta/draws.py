"""The random draws of TTA adaptation and inference, as an injectable
source.

JAX's threefry and torch's generators never give the same bits from one
seed, so the engine (`tta/engine.py`) and `infer/sliding_window.py` do not
draw for themselves: they ask a draw source, and a test can hand in a
source built from the JAX package's own draws to hold both packages to the
same patches, augmentations and noise.

A source gives, for ensemble member `member`, epoch `epoch` and
accumulation step `step` of `group` x `batch` patches (`patch_group`:
`group` patch draws folded into one step), a `PatchDraws`:
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

`group_draws` concatenates the draws of `group` ungrouped steps into the
draws of one grouped step, in the forward's layout: `TorchDraws` gives
group-g step s the draws of its ungrouped steps g*s .. g*s + g - 1, so a
grouped run adapts on exactly the patches and augmentations of the
ungrouped one.  `member_draws` concatenates the draws of one step of each
member of an ensemble chunk into the draws of the chunk's one step, in
the side-by-side forward's layout (member after member).
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


def _cat_gin(parts: list) -> Optional[GinDraws]:
    """The GIN nets of consecutive groups as one net of their patches: the
    per-patch kernels, shifts and blend weights of each group in turn (a
    layer's kernel rows are sample-major), each group keeping its own
    centre-tap masks."""
    if parts[0] is None:
        return None
    layers = tuple(
        (torch.cat([p.layers[i][0] for p in parts]),
         torch.cat([p.layers[i][1] for p in parts]))
        for i in range(len(parts[0].layers)))
    return GinDraws(layers=layers,
                    alphas=torch.cat([p.alphas for p in parts]))


def group_draws(parts: list) -> PatchDraws:
    """One step's draws from the draws of `len(parts)` ungrouped steps of
    `batch` patches each: the per-patch arrays and GIN nets of each group
    in turn; the MIND noise of the one forward of both branches (2 x
    group x batch patches) as the a-branch rows of every group, then the
    b-branch rows (the forward is cat([xa, xb])); each branch's field
    noise as the rows of each group in turn."""
    if len(parts) == 1:
        return parts[0]
    g = len(parts)

    def cat(key):
        return np.concatenate([getattr(p, key) for p in parts])

    def mind(shape, device):
        b = shape[0] // (2 * g)
        noise = [p.mind_noise((2 * b, *shape[1:]), device) for p in parts]
        return torch.cat([n[:b] for n in noise] + [n[b:] for n in noise])

    def field(key):
        def draw(shape, device):
            b = shape[0] // g
            return torch.cat([getattr(p, key)((b, *shape[1:]), device)
                              for p in parts])
        return draw

    first = parts[0]
    return PatchDraws(
        vol_idx=cat("vol_idx"), uniforms=cat("uniforms"),
        noise_a=cat("noise_a"), noise_b=cat("noise_b"),
        gin_a=_cat_gin([p.gin_a for p in parts]),
        gin_b=_cat_gin([p.gin_b for p in parts]),
        mind_noise=None if first.mind_noise is None else mind,
        field_a=None if first.field_a is None else field("field_a"),
        field_b=None if first.field_b is None else field("field_b"))


def member_draws(parts: list) -> PatchDraws:
    """One step of an ensemble chunk's members side by side, from each
    member's draws of that step (`parts`, in member order): the per-patch
    arrays and GIN nets of each member in turn; the MIND noise of the one
    forward as each member's rows of both branches in turn (the forward
    holds member m's 2B patches after member m - 1's); each branch's field
    noise as each member's rows in turn."""
    if len(parts) == 1:
        return parts[0]
    M = len(parts)

    def cat(key):
        return np.concatenate([getattr(p, key) for p in parts])

    def rows(key):
        def draw(shape, device):
            return torch.cat([getattr(p, key)((shape[0] // M, *shape[1:]),
                                              device) for p in parts])
        return draw

    first = parts[0]
    return PatchDraws(
        vol_idx=cat("vol_idx"), uniforms=cat("uniforms"),
        noise_a=cat("noise_a"), noise_b=cat("noise_b"),
        gin_a=_cat_gin([p.gin_a for p in parts]),
        gin_b=_cat_gin([p.gin_b for p in parts]),
        **{key: None if getattr(first, key) is None else rows(key)
           for key in ("mind_noise", "field_a", "field_b")})


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
              batch: int, gin_branches=(), channels: int = 1,
              group: int = 1) -> PatchDraws:
        """`gin_branches`: the branches ("branch_a", "branch_b") that run
        GIN on the `channels`-channel patches.  With `group` > 1, the
        draws of ungrouped steps group*step .. group*step + group - 1
        (`group_draws`)."""
        if group > 1:
            return group_draws([
                self.patch(member, epoch, group * step + i, n_vols, batch,
                           gin_branches, channels) for i in range(group)])
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


@dataclasses.dataclass(frozen=True)
class Recorded:
    """`(shape, device) -> tensor`: a normal draw made once by another
    source, replayed (picklable, unlike the sources' own closures)."""

    value: torch.Tensor

    def __call__(self, shape, device) -> torch.Tensor:
        if tuple(shape) != tuple(self.value.shape):
            raise ValueError(f"recorded draw of shape "
                             f"{tuple(self.value.shape)}, asked for "
                             f"{tuple(shape)}")
        return self.value.to(device)


class RecordedDraws:
    """A draw source that replays the patch draws and evaluation volumes
    another source made (`record`): plain tensors and arrays, so it can be
    handed to processes that cannot run the other source (one built on
    the JAX package's draws, in the ranks of a sharded run).  It records
    no MIND or deformable-field noise: a plan that asks for them fails."""

    def __init__(self, patches: dict, evals: dict):
        self.patches, self.evals = patches, evals

    @classmethod
    def record(cls, source, members, epochs: int, steps: int,
               eval_reps: int, n_vols: int, batch: int) -> "RecordedDraws":
        """`source`'s draws for `members` x `epochs` x `steps` patch steps
        of `batch` patches and `eval_reps` evaluations of `batch` centre
        patches an epoch."""
        patches, evals = {}, {}
        for m in members:
            for ep in range(epochs):
                for st in range(steps):
                    patches[m, ep, st] = dataclasses.replace(
                        source.patch(m, ep, st, n_vols, batch),
                        mind_noise=None, field_a=None, field_b=None)
                for r in range(eval_reps):
                    evals[m, ep, r] = np.asarray(source.eval_volumes(
                        m, ep, r, n_vols, batch))
        return cls(patches, evals)

    def patch(self, member, epoch, step, n_vols, batch, gin_branches=(),
              channels=1, group=1) -> PatchDraws:
        return self.patches[member, epoch, step]

    def eval_volumes(self, member, epoch, rep, n_vols, batch) -> np.ndarray:
        return self.evals[member, epoch, rep]
