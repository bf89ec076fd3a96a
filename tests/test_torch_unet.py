"""The port's PlainConvUNet and checkpoint IO against the JAX U-Net.

Weights are drawn once from a seed (`init_unet_`), converted to the JAX
package's parameter tree with `params_to_jax` and carried back with
`params_from_jax`; inputs come from numpy seeds.  The JAX forward runs
under `jax.jit`.  Tolerances:
f32 atol 2e-4 (tests/test_unet.py's torch-parity bound: the same math
summed in another order); bf16 compute within 5% of the f32 logits' range
(tests/test_unet.py::test_bf16_compute_close_to_f32), since the two
packages round bf16 at different places.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.models.convert import (flat_npz_to_params,
                                       params_to_flat_npz)
from dg_tta_tpu.models.unet import unet_apply
from dg_tta_tpu_torch.models.convert import (clean_state_dict, load_flat_npz,
                                             params_from_jax, params_to_jax,
                                             save_flat_npz)
from dg_tta_tpu_torch.models.network import build_model
from dg_tta_tpu_torch.models.plans import ArchSpec as TorchArchSpec
from dg_tta_tpu_torch.models.unet import PlainConvUNet, init_unet_
from tests.test_unet import SMALL_SPEC, _TUNet

TORCH_SPEC = TorchArchSpec(**dataclasses.asdict(SMALL_SPEC))
_jax_unet = jax.jit(unet_apply, static_argnames=(
    "spec", "deep_supervision", "compute_dtype", "head_channel_idx"))


def jax_apply(params, x, **kw):
    return np.asarray(_jax_unet(params, jnp.asarray(x), SMALL_SPEC, **kw),
                      np.float32)


@pytest.fixture(scope="module")
def jax_params():
    seeded = init_unet_(PlainConvUNet(TORCH_SPEC),
                        torch.Generator().manual_seed(0))
    return params_to_jax(seeded.state_dict())


@pytest.fixture(scope="module")
def net(jax_params):
    n = PlainConvUNet(TORCH_SPEC)
    n.load_state_dict(params_from_jax(jax_params))
    return n.eval()


def _x(seed, shape=(2, 16, 16, 16, 1)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _run(net, x, **kw):
    with torch.no_grad():
        return net(torch.from_numpy(x), **kw)


def test_f32_forward_matches_jax(net, jax_params):
    x = _x(0)
    ref = jax_apply(jax_params, x)
    got = _run(net, x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_bf16_forward_close_to_jax(net, jax_params):
    x = _x(1, (1, 16, 16, 16, 1))
    f32 = jax_apply(jax_params, x)
    jbf = jax_apply(jax_params, x, compute_dtype=jnp.bfloat16)
    got = _run(net, x, compute_dtype="bfloat16")
    assert got.dtype == torch.bfloat16  # logits stay in the compute dtype
    got = got.float().numpy()
    span = np.abs(f32).max()
    assert np.abs(got - f32).max() / span < 0.05
    assert np.abs(got - jbf).max() / span < 0.05


def test_deep_supervision_and_head_channel_idx_match_jax(net, jax_params):
    x = _x(2, (1, 16, 16, 16, 1))
    idx = (3, 0, 2)
    refs = _jax_unet(jax_params, jnp.asarray(x), SMALL_SPEC,
                     deep_supervision=True, head_channel_idx=idx)
    gots = _run(net, x, deep_supervision=True, head_channel_idx=idx)
    assert len(gots) == len(refs) == 2
    assert gots[0].shape == (1, 16, 16, 16, 3)
    assert gots[1].shape == (1, 8, 8, 8, 3)
    for g, r in zip(gots, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4)


def test_npz_round_trip_with_jax_format(tmp_path, net, jax_params):
    # JAX writes, the port reads
    params_to_flat_npz(jax_params, tmp_path / "jax.npz")
    sd = load_flat_npz(tmp_path / "jax.npz")
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    # the port writes, JAX reads
    save_flat_npz(net.state_dict(), tmp_path / "torch.npz")
    back = flat_npz_to_params(tmp_path / "torch.npz")
    la, ta = jax.tree_util.tree_flatten(jax_params)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(tmp_path / "jax.npz") as zj, \
            np.load(tmp_path / "torch.npz") as zt:
        assert set(zj.files) == set(zt.files)
        assert "encoder/stages/0/convs/0/conv/w" in zt.files


def test_params_to_jax_inverts_params_from_jax(jax_params):
    tree = jax_params
    back = params_to_jax(params_from_jax(tree))
    la, ta = jax.tree_util.tree_flatten(tree)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)


def test_nnunet_state_dict_loads_and_matches_torch_oracle():
    """An nnUNet-named state_dict (the torch oracle of tests/test_unet.py)
    loads strictly, with DDP prefixes and nnUNet's module aliases."""
    torch.manual_seed(0)
    oracle = _TUNet(SMALL_SPEC).eval()
    sd = {"module." + k: v for k, v in oracle.state_dict().items()}
    sd["module.encoder.stages.0.0.convs.0.all_modules.0.weight"] = \
        sd["module.encoder.stages.0.0.convs.0.conv.weight"]
    port = PlainConvUNet(TORCH_SPEC)
    port.load_state_dict(clean_state_dict({"network_weights": sd}))
    x = _x(3, (1, 1, 16, 16, 16))
    with torch.no_grad():
        ref = oracle(torch.from_numpy(x))
        got = port.eval()(torch.from_numpy(np.moveaxis(x, 1, -1)))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), -1, 1), ref.numpy(),
                               atol=2e-4)


def test_pth_checkpoint_loads(tmp_path, net):
    """An nnUNet checkpoint_final.pth (weights under `network_weights`,
    beside other objects) loads with a plain load_state_dict."""
    from dg_tta_tpu_torch.tta.driver import load_state_dict_file

    path = tmp_path / "checkpoint_final.pth"
    torch.save({"network_weights": {"_orig_mod." + k: v for k, v in
                                    net.state_dict().items()},
                "trainer_name": "nnUNetTrainer_GIN",
                "init_args": {"fold": 0}}, path)
    port = PlainConvUNet(TORCH_SPEC)
    port.load_state_dict(load_state_dict_file(path))
    x = _x(5, (1, 16, 16, 16, 1))
    torch.testing.assert_close(_run(port.eval(), x), _run(net, x),
                               rtol=0, atol=0)


def test_init_is_seeded_and_he_scaled():
    a = init_unet_(PlainConvUNet(TORCH_SPEC), torch.Generator().manual_seed(1))
    b = init_unet_(PlainConvUNet(TORCH_SPEC), torch.Generator().manual_seed(1))
    c = init_unet_(PlainConvUNet(TORCH_SPEC), torch.Generator().manual_seed(2))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    w = a.encoder.stages[1][0].convs[0].conv.weight
    assert not torch.equal(w, c.encoder.stages[1][0].convs[0].conv.weight)
    expect = (2.0 / (1 + 0.01 ** 2)) ** 0.5 / (27 * 8) ** 0.5
    assert abs(w.std().item() / expect - 1) < 0.05


def test_stage_conv_bias_has_no_effect(net):
    """conv -> InstanceNorm cancels a per-channel shift, so the port skips
    the stage-conv bias (as the JAX package does); head biases count."""
    x = _x(4, (1, 16, 16, 16, 1))
    ref = _run(net, x)
    other = PlainConvUNet(TORCH_SPEC).eval()
    other.load_state_dict(net.state_dict())
    with torch.no_grad():
        for m in other.modules():
            if isinstance(m, torch.nn.Conv3d) and m.out_channels != 4:
                m.bias.add_(1.0)
    torch.testing.assert_close(_run(other, x), ref, rtol=0, atol=0)
    with torch.no_grad():
        other.decoder.seg_layers[-1].bias.add_(1.0)
    assert (_run(other, x) - ref).abs().max() > 0.5


def test_model_families():
    plans = {"configurations": {"3d_fullres": {
        "patch_size": [16, 16, 16], "UNet_base_num_features": 8,
        "unet_max_num_features": 16, "n_conv_per_stage_encoder": [1, 1],
        "n_conv_per_stage_decoder": [1],
        "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2]],
        "conv_kernel_sizes": [[3, 3, 3], [3, 3, 3]]}}}
    ds = {"labels": {"background": 0, "a": 1, "b": 2},
          "channel_names": {"0": "CT"}}
    x = torch.zeros(1, 16, 16, 16, 1)
    for trainer in ("nnUNetTrainer", "nnUNetTrainer_GIN",
                    "nnUNetTrainer_GIN_MultiRes"):
        m = build_model(plans, ds, trainer)
        assert m.spec.num_classes == 3 and m.spec.num_input_channels == 1
        with torch.no_grad():
            net = m.build_network(device="cpu")
            assert m.apply(net, x).shape == (1, 16, 16, 16, 3)
    with pytest.raises(NotImplementedError, match="GIN"):
        m.apply(m.build_network(device="cpu"), x, internal_aug=True)
    for trainer in ("nnUNetTrainer_MIND", "nnUNetTrainer_GIN_MIND"):
        m = build_model(plans, ds, trainer)
        assert m.spec.num_input_channels == 12
        with pytest.raises(NotImplementedError, match="MIND"):
            m.apply(m.build_network(device="cpu"),
                    torch.zeros(1, 16, 16, 16, 12))
    with pytest.raises(ValueError):
        dataclasses.replace(m, compute_dtype="float16")
