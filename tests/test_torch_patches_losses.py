"""The port's patch extraction, losses and label mapping
(dg_tta_tpu_torch/core/{patches,losses,labels}.py) against the JAX
package, with the draws taken from the JAX functions' own keys.

Tolerances, f32: patches 1e-5 absolute (three lerps of the same block, in
the same order); labels exact (nearest of the same coordinates); losses
and Dice 1e-6 (the same reductions in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.core import labels as jl
from dg_tta_tpu.core import losses as jlo
from dg_tta_tpu.core import patches as jp
from dg_tta_tpu_torch.core import labels as tl
from dg_tta_tpu_torch.core import losses as tlo
from dg_tta_tpu_torch.core import patches as tp

PATCH = (16, 12, 10)


def _uniforms(key, batch=None):
    """The uniforms `patch_affine` / `extract_batch` draw from `key`."""
    if batch is None:
        return np.asarray(jax.random.uniform(key, (3,)))
    k_idx, k_patch = jax.random.split(key)
    keys = jax.random.split(k_patch, batch)
    return (np.asarray(jax.random.randint(k_idx, (batch,), 0, 2)),
            np.stack([np.asarray(jax.random.uniform(k, (3,)))
                      for k in keys]))


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("true_shape", [(24, 28, 20), (12, 30, 8)])
def test_patch_affine_matches_jax(true_shape, fixed):
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jp.patch_affine(key, jnp.asarray(true_shape, jnp.float32),
                                     PATCH, fixed=fixed))
    got = tp.patch_affine(_uniforms(key), true_shape, PATCH, fixed=fixed)
    assert got.shape == (1, 3, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_unit_stride_matches_jax(rng, seed):
    """The true volume may be smaller than the patch (second axis) or
    padded to a bucket (all axes)."""
    true_shape = (20, 10, 14)
    vol = rng.normal(size=(*true_shape, 2)).astype(np.float32)
    padded = np.asarray(jp.pad_to_bucket(jnp.asarray(vol), (32, 32, 32),
                                         float(vol.min())))
    key = jax.random.PRNGKey(seed)
    ts = jnp.asarray(true_shape, jnp.float32)
    theta = jp.patch_affine(key, ts, PATCH)
    ref = np.asarray(jp.sample_unit_stride(jnp.asarray(padded), ts, theta,
                                           PATCH))
    got = tp.sample_unit_stride(torch.from_numpy(padded), true_shape,
                                torch.from_numpy(np.array(theta)), PATCH)
    assert got.shape == (1, *PATCH, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the general resampling path samples the same positions
    warp = tp.sample_with_affine(torch.from_numpy(padded), true_shape,
                                 torch.from_numpy(np.array(theta)), PATCH)
    np.testing.assert_allclose(warp.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("fixed", [False, True])
def test_extract_batch_with_labels_matches_jax(rng, fixed):
    shapes = np.asarray([[24.0, 28.0, 20.0], [18.0, 22.0, 26.0]], np.float32)
    bucket = (32, 32, 32)
    vols, labs = [], []
    for s in shapes.astype(int):
        v = rng.normal(size=(*s, 1)).astype(np.float32)
        lab = rng.integers(0, 4, size=(*s, 1)).astype(np.float32)
        vols.append(np.asarray(jp.pad_to_bucket(jnp.asarray(v), bucket,
                                                float(v.min()))))
        labs.append(np.asarray(jp.pad_to_bucket(jnp.asarray(lab), bucket)))
    vols, labs = np.stack(vols), np.stack(labs)
    key = jax.random.PRNGKey(7)
    ref_img, ref_lab = jp.extract_batch(key, jnp.asarray(vols),
                                        jnp.asarray(shapes), PATCH, 3,
                                        labels_padded=jnp.asarray(labs),
                                        fixed=fixed)
    idx, uniforms = _uniforms(key, 3)
    img, lab = tp.extract_batch(idx, None if fixed else uniforms,
                                torch.from_numpy(vols), shapes, PATCH, 3,
                                labels_padded=torch.from_numpy(labs),
                                fixed=fixed)
    assert img.shape == (3, *PATCH, 1) and lab.shape == (3, *PATCH, 1)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=1e-5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_lab))


def test_extract_patch_and_bucket_padding_match_jax(rng):
    vol = rng.normal(size=(13, 17, 11, 1)).astype(np.float32)
    bucket = tp.bucket_shape_for(vol.shape[:3], 16)
    assert bucket == jp.bucket_shape_for(vol.shape[:3], 16) == (16, 32, 16)
    padded = tp.pad_to_bucket(torch.from_numpy(vol), bucket,
                              float(vol.min()))
    key = jax.random.PRNGKey(9)
    ref = jp.extract_patch(jnp.asarray(padded.numpy()),
                           jnp.asarray(vol.shape[:3], jnp.float32), PATCH,
                           key=key)
    got = tp.extract_patch(padded, vol.shape[:3], PATCH,
                           uniforms=_uniforms(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _logits(rng, shape, zero_band=True):
    a = rng.normal(size=shape).astype(np.float32) + 0.5
    if zero_band:
        a[..., :7] = 0.0   # the unwarp's zero band: outside the common mask
    return a


@pytest.mark.parametrize("start_class", [0, 1])
def test_consistency_losses_match_jax(rng, start_class):
    la = _logits(rng, (2, 4, 60))
    lb = _logits(rng, (2, 4, 60))
    ref = float(jlo.consistency_loss_flat(jnp.asarray(la), jnp.asarray(lb),
                                          start_class))
    got = tlo.consistency_loss_flat(torch.from_numpy(la),
                                    torch.from_numpy(lb), start_class)
    assert abs(float(got) - ref) <= 1e-6
    cl_a = np.moveaxis(la.reshape(2, 4, 3, 4, 5), 1, -1)
    cl_b = np.moveaxis(lb.reshape(2, 4, 3, 4, 5), 1, -1)
    ref_cl = float(jlo.consistency_loss(jnp.asarray(cl_a), jnp.asarray(cl_b),
                                        start_class))
    got_cl = tlo.consistency_loss(torch.from_numpy(cl_a),
                                  torch.from_numpy(cl_b), start_class)
    assert abs(float(got_cl) - ref_cl) <= 1e-6
    assert abs(ref_cl - ref) <= 1e-6


def test_consistency_loss_all_zero_guard():
    """No epsilon: an all-zero denominator gives Dice 1 (loss 0), as the
    reference's guard does."""
    z = np.zeros((1, 3, 10), np.float32)
    ref = float(jlo.consistency_loss_flat(jnp.asarray(z), jnp.asarray(z)))
    got = float(tlo.consistency_loss_flat(torch.from_numpy(z),
                                          torch.from_numpy(z)))
    assert got == ref == 0.0


def test_consistency_loss_flat_grad_matches_jax(rng):
    la = _logits(rng, (1, 3, 40))
    lb = _logits(rng, (1, 3, 40))
    ref = np.asarray(jax.grad(lambda a: jlo.consistency_loss_flat(
        a, jnp.asarray(lb)))(jnp.asarray(la)))
    t = torch.from_numpy(la).requires_grad_(True)
    tlo.consistency_loss_flat(t, torch.from_numpy(lb)).backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-6)


def test_dice_coeff_and_label_mapping_match_jax(rng):
    pred = rng.integers(0, 4, size=(5, 6, 7))
    gt = rng.integers(0, 6, size=(5, 6, 7))
    gt_mapped = tl.map_label_argmaxed(torch.from_numpy(gt), [0, 3, 5, 1])
    ref_mapped = jl.map_label_argmaxed(jnp.asarray(gt), np.array([0, 3, 5, 1]))
    np.testing.assert_array_equal(gt_mapped.numpy(), np.asarray(ref_mapped))
    ref = np.asarray(jlo.dice_coeff(jnp.asarray(pred), ref_mapped, 4))
    got = tlo.dice_coeff(torch.from_numpy(pred), gt_mapped, 4)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)

    logits = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.map_label_logits(torch.from_numpy(logits), [4, 0, 2]).numpy(),
        np.asarray(jl.map_label_logits(jnp.asarray(logits), [4, 0, 2])))
