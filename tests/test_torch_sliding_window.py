"""The port's sliding-window inference against the JAX package's.

`compute_gaussian` and `window_origins` must be bit-equal; `predict_volume`
over an ensemble of two members agrees with the JAX `predict_volume` to the
f32 tolerance of tests/test_sliding_window.py (atol/rtol 1e-4: the same
forwards and accumulation, summed in another order).  Members are drawn
from seeds with `init_unet_` and carried to JAX with `params_to_jax`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.infer import sliding_window as jsw
from dg_tta_tpu_torch.infer import sliding_window as tsw
from dg_tta_tpu_torch.models.convert import params_from_jax, params_to_jax
from dg_tta_tpu_torch.models.network import Model
from dg_tta_tpu_torch.models.plans import ArchSpec as TorchArchSpec
from dg_tta_tpu_torch.models.unet import init_unet_
from tests.test_tta_engine import tiny_model

JAX_MODEL = tiny_model()
MODEL = Model(spec=TorchArchSpec(**dataclasses.asdict(JAX_MODEL.spec)),
              patch_size=JAX_MODEL.patch_size,
              trainer_name=JAX_MODEL.trainer_name,
              uses_gin_internal=True, uses_mind=False)


def _members(seeds):
    nets = [init_unet_(MODEL.build_network(device="cpu"),
                       torch.Generator().manual_seed(s)) for s in seeds]
    trees = [params_to_jax(n.state_dict()) for n in nets]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    return nets, stacked


@pytest.mark.parametrize("patch", [(16, 16, 16), (112, 112, 128),
                                   (7, 12, 9)])
def test_gaussian_bit_equal(patch):
    np.testing.assert_array_equal(tsw.compute_gaussian(patch),
                                  jsw.compute_gaussian(patch))


@pytest.mark.parametrize("shape,patch,pad", [
    ((224, 224, 256), (112, 112, 128), 4),
    ((40, 16, 33), (16, 16, 16), 8),
    ((16, 16, 16), (16, 16, 16), 1),
    ((97, 130, 64), (32, 48, 64), 3),
])
def test_window_origins_bit_equal(shape, patch, pad):
    to, tv = tsw.window_origins(shape, patch, pad_multiple=pad)
    jo, jv = jsw.window_origins(shape, patch, pad_multiple=pad)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tv, jv)


def test_bucket_padding_matches_jax():
    from dg_tta_tpu.core.patches import bucket_shape_for as jax_bucket
    from dg_tta_tpu.core.patches import pad_to_bucket as jax_pad
    from dg_tta_tpu_torch.core.patches import bucket_shape_for, pad_to_bucket

    vol = np.random.default_rng(3).normal(size=(9, 14, 5, 2)).astype(
        np.float32)
    bucket = bucket_shape_for(vol.shape[:3], multiple=8, min_size=(16, 8, 8))
    assert bucket == jax_bucket(vol.shape[:3], multiple=8,
                                min_size=(16, 8, 8)) == (16, 16, 8)
    vmin = float(vol.min())
    np.testing.assert_array_equal(
        pad_to_bucket(torch.from_numpy(vol), bucket, pad_value=vmin).numpy(),
        np.asarray(jax_pad(jnp.asarray(vol), bucket, pad_value=vmin)))
    with pytest.raises(ValueError):
        pad_to_bucket(torch.from_numpy(vol), (8, 16, 8))


def test_padded_shape_matches_jax_geometry():
    assert tsw.padded_shape((224, 224, 256), (112, 112, 128)) == \
        (224, 224, 256)
    assert tsw.padded_shape((10, 40, 9), (16, 16, 16)) == (32, 64, 32)
    assert tsw.padded_shape((10, 40, 9), (16, 16, 16), 1) == (16, 40, 16)


@pytest.mark.parametrize("window_batch", [1, 3])
def test_predict_volume_ensemble_matches_jax(window_batch):
    nets, stacked = _members((1, 2))
    vol = np.random.default_rng(0).normal(size=(26, 19, 22, 1)).astype(
        np.float32)
    ref = np.asarray(jsw.predict_volume(JAX_MODEL, stacked, jnp.asarray(vol),
                                        window_batch=1))
    got = tsw.predict_volume(MODEL, nets, torch.from_numpy(vol),
                             window_batch=window_batch)
    assert got.dtype == torch.float32 and got.shape == (26, 19, 22, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_predict_volume_small_volume_and_modifiers():
    nets, _ = _members((3,))
    vol = torch.from_numpy(np.random.default_rng(1).normal(
        size=(10, 16, 12, 1)).astype(np.float32))
    base = tsw.predict_volume(MODEL, nets, vol, bucket_multiple=1)
    assert base.shape == (10, 16, 12, 4) and torch.isfinite(base).all()
    flip = lambda x: torch.flip(x, dims=(1,))  # noqa: E731
    mod = tsw.predict_volume(MODEL, nets, torch.flip(vol, dims=(0,)),
                             modify_input_fn=flip, modify_output_fn=flip,
                             bucket_multiple=1)
    np.testing.assert_allclose(mod.numpy(), torch.flip(base, dims=(0,)).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_predict_volume_bf16_accumulates_in_bf16():
    nets, _ = _members((4,))
    m16 = dataclasses.replace(MODEL, compute_dtype="bfloat16")
    vol = torch.from_numpy(np.random.default_rng(2).normal(
        size=(16, 20, 18, 1)).astype(np.float32))
    f32 = tsw.predict_volume(MODEL, nets, vol)
    b16 = tsw.predict_volume(m16, nets, vol)
    assert b16.dtype == torch.float32  # normalized in f32
    span = f32.abs().max().item()
    assert (b16 - f32).abs().max().item() / span < 0.05


def test_predict_volume_loads_jax_members(tmp_path):
    """Members saved by the JAX package load into the port unchanged."""
    from dg_tta_tpu.models.convert import params_to_flat_npz
    from dg_tta_tpu_torch.models.convert import load_flat_npz

    nets, stacked = _members((5,))
    tree = jax.tree.map(lambda p: p[0], stacked)
    params_to_flat_npz(tree, tmp_path / "m.npz")
    loaded = MODEL.build_network(load_flat_npz(tmp_path / "m.npz"),
                                 device="cpu")
    for k, v in nets[0].state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert params_from_jax(params_to_jax(loaded.state_dict())).keys() == \
        loaded.state_dict().keys()
