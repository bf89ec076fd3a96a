"""DG-TTA in PyTorch for NVIDIA Hopper: the port of `dg_tta_tpu`.

The JAX package `dg_tta_tpu` stays the reference.  This package imports
`torch`, numpy and scipy and nothing of JAX or of `dg_tta_tpu`; what it needs
from that package's host-only modules it keeps as its own copies.

This slice covers `dgtta run_tta`'s inference path: model and checkpoint
loading, preprocessing, Gaussian sliding-window ensemble inference, export
and evaluation.  Adaptation (Phase 1), MIND and pretraining come in later
slices and raise `NotImplementedError` here.

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
