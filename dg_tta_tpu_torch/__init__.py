"""DG-TTA in PyTorch for NVIDIA Hopper: the port of `dg_tta_tpu`.

The JAX package `dg_tta_tpu` stays the reference.  This package imports
`torch`, numpy and scipy and nothing of JAX or of `dg_tta_tpu`; what it needs
from that package's host-only modules it keeps as its own copies.

It covers `dgtta pretrain`, `prepare_tta` and `run_tta` for the six TS104
model families (GIN, MIND, GIN_MIND and their MultiRes variants): model
and checkpoint loading, preprocessing, affine and deformable TTA (Phase
1, GIN in a branch included, `patch_group` and `remat`), Gaussian
sliding-window ensemble inference, export and evaluation, wandb logging
and the loss plots, and runs over several GPUs, one process each
(`parallel/`: ensemble members in `run_tta`, data-parallel `pretrain`,
window-sharded inference).  The JAX package's split engine raises
`NotImplementedError` here.

Layout: every public function takes and returns channels-last tensors,
`(B, D, H, W, C)` for batches and `(D, H, W, C)` for volumes, as the JAX
package does, so the parity tests compare like with like.  Inside the
U-Net a `(B*D, H, W, C)` view of an activation feeds the NHWC conv kernel
(`kernels/conv3x3.py`) with no copy.  User modifier functions therefore see
`(B, D, H, W, C)` torch tensors (`tta/config.MODIFIER_TEMPLATE`).

Device: entry points take a `device` argument and default to `"cuda"`; a
CUDA request on a machine without a GPU raises `RuntimeError`
(`utils/device.resolve_device`).  On CUDA tensors every kernel wrapper
launches its hand-written kernel or raises; its plain PyTorch version runs
only for tensors on the CPU.
"""

__version__ = "0.1.0"
