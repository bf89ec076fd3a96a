"""The backward of the port's conv3x3 (`Conv3x3Function`: the input
gradient through `conv3x3` with flipped, channel-swapped weights, the
weight gradient through `conv3x3_wgrad`) against `jax.vjp` of the JAX
U-Net's `_conv` (three z-tap 2D convs, or one with a (1, 3, 3) kernel).

On the CPU both wrappers run their plain versions; the kernels themselves
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerance, f32: max |port - JAX| <= 1e-5 x max |JAX| + 1e-6 per gradient:
the same products summed in another order over up to a few thousand
positions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.models.unet import _conv as jax_conv
from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3_op, conv3x3_wgrad,
                                              conv3x3_wgrad_reference)

CASES = {
    # name: (B, D, H, W, C, CO, kz)
    "ragged": (2, 5, 7, 9, 6, 5, 3),
    "c1_first_conv": (2, 4, 6, 5, 1, 8, 3),
    "depth1": (3, 1, 5, 6, 4, 3, 3),
    "wide": (1, 3, 4, 4, 40, 36, 3),
    "kz1": (2, 3, 6, 7, 5, 4, 1),
}


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_grads_match_jax_vjp(case):
    B, D, H, W, C, CO, kz = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(kz, 3, 3, C, CO)) * 0.2).astype(np.float32)
    ct = rng.normal(size=(B, D, H, W, CO)).astype(np.float32)

    ref_y, vjp = jax.vjp(lambda a, b: jax_conv(a, b, None),
                         jnp.asarray(x), jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = conv3x3_op(xt.reshape(B * D, H, W, C), wt, depth=D)
    (y.reshape(B, D, H, W, CO) * torch.from_numpy(ct)).sum().backward()
    _close(y.detach().reshape(B, D, H, W, CO).numpy(), ref_y)
    _close(xt.grad.numpy(), ref_dx)
    _close(wt.grad.numpy(), ref_dw)


def test_dgrad_skipped_for_an_input_without_grad(monkeypatch):
    """The first conv's input (the warped image) needs no gradient: the
    backward then runs no dgrad conv, only the weight gradient."""
    import dg_tta_tpu_torch.kernels.conv3x3 as k

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 5, 6, 1)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 1, 4)).astype(
        np.float32)).requires_grad_(True)
    calls = []
    real = k.conv3x3
    monkeypatch.setattr(k, "conv3x3",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    conv3x3_op(x, w, depth=2).sum().backward()
    assert len(calls) == 1          # the forward only
    assert w.grad is not None and w.grad.shape == w.shape


def test_wgrad_wrapper_is_the_plain_version_on_cpu():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(6, 5, 7, 3)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(6, 5, 7, 4)).astype(np.float32))
    before = conv3x3_wgrad.launches
    got = conv3x3_wgrad(x, dy, depth=3)
    assert conv3x3_wgrad.launches == before
    assert got.shape == (3, 3, 3, 3, 4) and got.dtype == torch.float32
    assert torch.equal(got, conv3x3_wgrad_reference(x, dy, depth=3))
    with pytest.raises(ValueError, match="depth"):
        conv3x3_wgrad(x, dy, depth=4)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_wgrad(x.to("meta"), dy.to("meta"), depth=3)
