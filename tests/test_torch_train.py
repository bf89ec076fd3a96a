"""The port's DG pretraining (dg_tta_tpu_torch/train/) against the JAX
package's (dg_tta_tpu/train/), on small nets and 16^3 patches.

JAX's threefry and torch's generators never give the same bits, so the
port runs on the draws the JAX package makes, derived here from its own
key splits (augment.py:211-297: 16 keys a sample; pretrain.py:114-133:
(k_da, k_model) = split(key); network.py:131-137: (k_gin, k_mind) =
split(k_model)).  The JAX sides run under `jax.jit`, as JAX's own step
does.

Tolerances, f32 on the CPU:
* `_lowres_axis_matrices`, `deep_supervision_weights`, `poly_lr`, the
  dataset pipeline and `val_step`'s counts: equal, bit for bit;
* `downsample_target`: equal, bit for bit, at a stride-2 scale (every
  sample on a rounding tie) and at each TS104 deep-supervision scale;
* `soft_dice_ce`, `deep_supervised_loss`: 2e-6 relative (softmax and
  sums over the voxels in another order);
* the augmentation: theta 1e-6 absolute (cos, sin and a 3 x 3 product
  in another library); each intensity transform and the whole batch
  1e-5 of the image's range (pow, exp and the 9-tap, mean and
  tensordot sums in another order), the labels equal;
* the SGD step alone (`make_optimizer`) against JAX's optax chain, on
  the same parameters and gradients over three steps: 1e-6 of each
  leaf's largest entry (the same operations rounded in another order:
  2 ulp seen);
* one training step, two for config 5 (the second on the first one's
  momentum): the loss 1e-5 relative; the parameters after each step
  within 1e-4 of the leaf's largest entry, for the leaves that are
  nonzero at initialization (the others, zero-initialized biases, hold
  their updates alone); each leaf's update (new - old) within 1e-3 of its
  norm without MIND (1.04e-4 measured, GIN_MultiRes) and within 2e-2
  with it: MIND's descriptor differs from JAX's by ~6e-6 of its range
  here (exp of sums taken in another order, tests/test_torch_mind.py),
  and InstanceNorm over the 2^3 voxels of the deepest stage turns that
  into up to 1.2e-2 of a leaf's update (measured), as the card's f32
  rounding does in chip_smoke.py's full-width gradient check.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.models.convert import flat_npz_to_params
from dg_tta_tpu.models.network import Model as JaxModel
from dg_tta_tpu.models.plans import ArchSpec as JaxArchSpec
from dg_tta_tpu.models.plans import \
    deep_supervision_scales as jax_ds_scales
from dg_tta_tpu.train import augment as jaug
from dg_tta_tpu.train import dataset as jds
from dg_tta_tpu.train import losses as jlosses
from dg_tta_tpu.train import pretrain as jpre
from dg_tta_tpu_torch.models.convert import params_from_jax, params_to_jax
from dg_tta_tpu_torch.models.network import MULTIRES_TRAINERS, Model
from dg_tta_tpu_torch.models.plans import ArchSpec, deep_supervision_scales
from dg_tta_tpu_torch.train import augment as aug
from dg_tta_tpu_torch.train import dataset as ds
from dg_tta_tpu_torch.train import losses
from dg_tta_tpu_torch.train import pretrain
from dg_tta_tpu_torch.ops.gin import GinDraws
from tests.test_torch_mind import _jax_gin_draws

# 4 stages, so 3 deep-supervision heads: the 8^3 one takes a downsampled
# target (the lowest has weight 0)
SPEC = dict(features_per_stage=(8, 16, 16, 16),
            kernel_sizes=((3, 3, 3),) * 4,
            strides=((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
            n_conv_per_stage_encoder=(1, 1, 1, 1),
            n_conv_per_stage_decoder=(1, 1, 1), num_input_channels=1,
            num_classes=4)
PATCH = (16, 16, 16)
B = 2
TS104_PATCH = (112, 112, 128)
ALL_ON = dict(p_rotation=1.0, p_scale=1.0, p_noise=1.0, p_blur=1.0,
              p_brightness=1.0, p_contrast=1.0, p_lowres=1.0,
              p_gamma_invert=1.0, p_gamma=1.0)
ALL_OFF = {k: 0.0 for k in ALL_ON}


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One `torch.exp` before any comparison: a process's first one, under
    load, can return an element 1.5e-4 off (tests/test_torch_mind.py)."""
    torch.exp(torch.zeros(4096))


# ---------------------------------------------------------------- losses


def test_deep_supervision_weights_scales_and_poly_lr_equal():
    for n in range(1, 6):
        assert losses.deep_supervision_weights(n) == \
            jlosses.deep_supervision_weights(n)
    for e, m in ((0, 100), (37, 100), (99, 100), (3, 7)):
        assert losses.poly_lr(1e-2, e, m) == jlosses.poly_lr(1e-2, e, m)
    spec = SPEC | dict(features_per_stage=(32, 64, 128, 256))
    assert deep_supervision_scales(ArchSpec(**spec)) == \
        jax_ds_scales(JaxArchSpec(**spec))


def _ts104_scales():
    from dg_tta_tpu_torch.obs.profile_inference import ts104_model

    spec = ts104_model().spec
    return [tuple(int(round(p * f)) for p, f in zip(TS104_PATCH, s))
            for s in deep_supervision_scales(spec)]


@pytest.mark.parametrize("src,out", [((16, 16, 16), (8, 8, 8)),
                                     ((9, 12, 16), (5, 6, 4))]
                         + [(TS104_PATCH, s) for s in _ts104_scales()[1:]])
def test_downsample_target_bit_equal(src, out):
    t = np.random.default_rng(0).integers(0, 105, (1, *src)).astype(np.int32)
    ref = np.asarray(jax.jit(jlosses.downsample_target,
                             static_argnums=1)(jnp.asarray(t), out))
    got = losses.downsample_target(torch.from_numpy(t), out).numpy()
    assert got.shape == ref.shape == (1, *out)
    np.testing.assert_array_equal(got, ref)


def _soft_dice_ce_f64(logits, target, batch_dice=True, smooth=1e-5):
    """`soft_dice_ce` in float64 numpy."""
    x = logits.astype(np.float64)
    onehot = (target[..., None] == np.arange(x.shape[-1])).astype(np.float64)
    logp = x - x.max(-1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    sm = np.exp(logp)
    axes = (0, 1, 2, 3) if batch_dice else (1, 2, 3)
    tp = (sm * onehot).sum(axes)
    fp = (sm * (1 - onehot)).sum(axes)
    fn = ((1 - sm) * onehot).sum(axes)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    return -dc[..., 1:].mean() - (onehot * logp).sum(-1).mean()


def test_soft_dice_ce_and_deep_supervised_loss_match_jax():
    """Against JAX at 2e-6 relative: JAX's f32 sums over the voxels lie
    1.0-1.1e-6 from a float64 evaluation of the same loss here (its eager
    and jitted forms 4e-7 apart), the port's within 2e-7 of it, which is
    held too."""
    rng = np.random.default_rng(1)
    # -1: the preprocessing's label outside the nonzero mask
    target = rng.integers(-1, 4, (B, *PATCH)).astype(np.int32)
    outs = [rng.normal(size=(B, *(p // f for p in PATCH), 4))
            .astype(np.float32) * 3 for f in (1, 2, 4)]
    for batch_dice in (True, False):
        ref = float(jax.jit(functools.partial(
            jlosses.soft_dice_ce, batch_dice=batch_dice))(
                jnp.asarray(outs[0]), jnp.asarray(target)))
        got = float(losses.soft_dice_ce(torch.from_numpy(outs[0]),
                                        torch.from_numpy(target),
                                        batch_dice=batch_dice))
        exact = _soft_dice_ce_f64(outs[0], target, batch_dice)
        assert abs(got - exact) <= 2e-7 * abs(exact)
        assert abs(got - ref) <= 2e-6 * abs(ref)
    ref = float(jax.jit(jlosses.deep_supervised_loss)(
        [jnp.asarray(o) for o in outs], jnp.asarray(target)))
    got = float(losses.deep_supervised_loss(
        [torch.from_numpy(o) for o in outs], torch.from_numpy(target)))
    assert abs(got - ref) <= 2e-6 * abs(ref)


# ---------------------------------------------------------- augmentation


def _jax_da_values(key, cfg, shape):
    """The values and gates `augment_sample(key, ...)` draws for an image
    of `shape` (D, H, W, C), as arrays (traced: the callers jit it with
    what the draws feed)."""
    keys = jax.random.split(key, 16)
    ks = jax.random.split(keys[0], 5)

    def u(k, lo_hi, n=()):
        return jax.random.uniform(k, n, minval=lo_hi[0], maxval=lo_hi[1])

    def gate(k, p):
        return jax.random.uniform(k, ()) < p

    out = dict(
        angles=u(ks[0], (-cfg.rotation_rad, cfg.rotation_rad), (3,)),
        do_rotation=gate(ks[1], cfg.p_rotation),
        scale=u(ks[2], cfg.scale_range), do_scale=gate(ks[3], cfg.p_scale),
        noise_sigma=u(keys[1], cfg.noise_sigma),
        noise=jax.random.normal(keys[2], shape),
        do_noise=gate(keys[11], cfg.p_noise),
        blur_sigma=u(keys[3], cfg.blur_sigma),
        do_blur=gate(keys[4], cfg.p_blur),
        brightness=u(keys[5], cfg.brightness),
        do_brightness=gate(keys[12], cfg.p_brightness),
        contrast=u(keys[6], cfg.contrast),
        do_contrast=gate(keys[13], cfg.p_contrast),
        gamma_invert=u(keys[9], cfg.gamma_range),
        do_gamma_invert=gate(keys[14], cfg.p_gamma_invert),
        gamma=u(keys[10], cfg.gamma_range),
        do_gamma=gate(keys[15], cfg.p_gamma))
    if cfg.discrete_lowres_zooms is None:
        out.update(lowres=u(keys[7], cfg.lowres_zoom, (3,)),
                   do_lowres=gate(keys[8], cfg.p_lowres))
    else:
        out.update(lowres=jax.random.randint(
            keys[7], (3,), 0, len(cfg.discrete_lowres_zooms)),
            do_lowres=gate(keys[8], 0.5))
    return out


def _batch_values(key, cfg, imgs_shape):
    """The per-sample draws of the JAX `augment_batch(key, imgs, ...)`."""
    return [_jax_da_values(k, cfg, tuple(imgs_shape[1:]))
            for k in jax.random.split(key, imgs_shape[0])]


def sample_draws(values):
    """`SampleDraws` of one sample's JAX draws (`_jax_da_values`)."""
    v = jax.tree.map(np.asarray, dict(values))
    noise = torch.from_numpy(np.array(v.pop("noise")))
    fields = {}
    for k, a in v.items():
        if k.startswith("do_"):
            fields[k] = bool(a)
        elif a.ndim:
            fields[k] = tuple(a.tolist())
        else:
            fields[k] = float(a)
    return aug.SampleDraws(noise=lambda shape, device: noise.to(device),
                           **fields)


@functools.partial(jax.jit, static_argnums=1)
def _jax_theta(key, cfg):
    """The draws of `augment_sample(key)` and the theta it builds."""
    return (_jax_da_values(key, cfg, (*PATCH, 1)),
            jaug._rand_rot_scale_affine(jax.random.split(key, 16)[0], cfg))


@functools.partial(jax.jit, static_argnums=3)
def _jax_augment(key, imgs, segs, cfg):
    """The JAX `augment_batch` and the draws it makes, in one program."""
    return (_batch_values(key, cfg, imgs.shape),
            jaug.augment_batch(key, imgs, segs, cfg))


def _batch(seed, shape=(B, *PATCH)):
    """Images and labels, -1 (outside the nonzero mask) among them."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(*shape, 1)).astype(np.float32)
    segs = rng.integers(-1, 4, (*shape, 1)).astype(np.float32)
    return imgs, segs


def test_lowres_matrices_bit_equal():
    for size in (16, 112, 128):
        np.testing.assert_array_equal(
            aug._lowres_axis_matrices(size, aug.MULTIRES_ZOOMS),
            jaug._lowres_axis_matrices(size, jaug.MULTIRES_ZOOMS))


@pytest.mark.parametrize("on", [True, False])
def test_rot_scale_affine_matches_jax(on):
    cfg = jaug.DAConfig(**(ALL_ON if on else ALL_OFF))
    for seed in range(4):
        values, ref = _jax_theta(jax.random.PRNGKey(seed), cfg)
        got = aug.rot_scale_affine(sample_draws(values))
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
        if not on:
            np.testing.assert_array_equal(got.numpy(), np.eye(3, 4))


def test_intensity_transforms_match_jax():
    """Blur, gamma (both forms), the continuous low-resolution pass and
    the discrete one (each zoom and the identity), each on its own."""
    img, _ = _batch(2, (1, 12, 14, 16))
    img = img[0]
    spatial = img.shape[:3]
    x = torch.from_numpy(img)
    bound = 1e-5 * np.abs(img).max()
    for sigma in (0.5, 0.77, 1.0):
        ref = jax.jit(jaug._gaussian_blur)(jnp.asarray(img), sigma)
        np.testing.assert_allclose(aug._gaussian_blur(x, sigma).numpy(),
                                   np.asarray(ref), rtol=0, atol=bound)
    key = jax.random.PRNGKey(5)
    g = float(jax.random.uniform(key, (), minval=0.7, maxval=1.5))
    for invert in (True, False):
        ref = jax.jit(jaug._gamma, static_argnums=(2, 3))(
            jnp.asarray(img), key, (0.7, 1.5), invert)
        np.testing.assert_allclose(aug._gamma(x, g, invert).numpy(),
                                   np.asarray(ref), rtol=0, atol=bound)
    for zoom in ((0.5, 0.73, 1.0), (1.0, 1.0, 1.0), (0.61, 0.5, 0.9)):
        ref = jax.jit(jaug._lowres_sim, static_argnums=2)(
            jnp.asarray(img), jnp.asarray(zoom, jnp.float32), spatial)
        grid = aug._lowres_grid([zoom], spatial, "cpu")
        got = aug._unflat(aug.warp_flat(aug._flat(x[None]), spatial, grid,
                                        padding_mode="border"), spatial)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=bound)
    for idx in ((0, 1, 2), (2, 0, 3), (3, 3, 3)):
        ref = jax.jit(jaug._discrete_lowres, static_argnums=(2, 3))(
            jnp.asarray(img), jnp.asarray(idx), jaug.MULTIRES_ZOOMS, spatial)
        got = aug._discrete_lowres(x, idx, aug.MULTIRES_ZOOMS, spatial)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=bound)


@pytest.mark.parametrize("zoom", [(0.57, 0.86, 0.75), (0.86, 0.57, 0.5)])
def test_lowres_grid_matches_jitted_jax_at_ts104_patch(zoom):
    """The continuous low-resolution pass at the TS104 patch, 112 x 112 x
    128, at zooms whose lattices (64 and 96 voxels on the 112-voxel axes)
    put every 7th sample on a rounding tie, against the jitted JAX pass
    (run eagerly it takes the other neighbour at some of them).  The image
    is a sum of ramps, which trilinear sampling reproduces, so a sample
    moved one lattice voxel shows as an error of 112 / 96 = 1.17; the
    bound is 1e-5 of the image's range, as for the other transforms."""
    spatial = (112, 112, 128)
    d, h, w = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in spatial),
                          indexing="ij")
    img = (d + h + w)[..., None]
    ref = jax.jit(jaug._lowres_sim, static_argnums=2)(
        jnp.asarray(img), jnp.asarray(zoom, jnp.float32), spatial)
    grid = aug._lowres_grid([zoom], spatial, "cpu")
    got = aug._unflat(aug.warp_flat(aug._flat(torch.from_numpy(img)[None]),
                                    spatial, grid, padding_mode="border"),
                      spatial)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * img.max())


@pytest.mark.parametrize("multires,gates", [
    (False, "on"), (False, "off"), (False, "drawn"), (True, "on"),
    (True, "drawn")])
def test_augment_batch_matches_jax(multires, gates):
    """The whole batch: every gate on, every gate off, and the default
    probabilities (seed 3 draws a mix), for the stock and the MultiRes
    trainers (MultiRes's off branch, the identity operators, is
    `test_intensity_transforms_match_jax`'s index 3)."""
    probs = {"on": ALL_ON, "off": ALL_OFF, "drawn": {}}[gates]
    zooms = dict(discrete_lowres_zooms=jaug.MULTIRES_ZOOMS) if multires \
        else {}
    jcfg = jaug.DAConfig(**probs, **zooms)
    cfg = aug.DAConfig(**probs, **zooms)
    imgs, segs = _batch(3)
    key = jax.random.PRNGKey(3)
    values, (ref_i, ref_s) = _jax_augment(key, jnp.asarray(imgs),
                                          jnp.asarray(segs), jcfg)
    draws = tuple(sample_draws(v) for v in values)
    if gates == "drawn":
        fired = [f for d in draws for f in dataclasses.fields(d)
                 if f.name.startswith("do_") and getattr(d, f.name)]
        assert 0 < len(fired) < 20
    got_i, got_s = aug.augment_batch(draws, torch.from_numpy(imgs),
                                     torch.from_numpy(segs), cfg)
    ref_i = np.asarray(ref_i)
    np.testing.assert_allclose(got_i.numpy(), ref_i, rtol=0,
                               atol=1e-5 * np.abs(ref_i).max())
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_torch_draw_source_fires_gates_at_their_rates():
    cfg = aug.DAConfig()
    g = torch.Generator().manual_seed(0)
    draws = [aug.draw_sample(g, cfg, None) for _ in range(4000)]
    for name, p in (("rotation", 0.2), ("noise", 0.1), ("blur", 0.2),
                    ("brightness", 0.15), ("lowres", 0.25),
                    ("gamma_invert", 0.1), ("gamma", 0.3)):
        rate = np.mean([getattr(d, f"do_{name}") for d in draws])
        assert abs(rate - p) < 0.03, (name, rate)
    scales = np.array([d.scale for d in draws])
    assert 0.7 <= scales.min() and scales.max() <= 1.4
    g = torch.Generator().manual_seed(0)
    mcfg = aug.DAConfig(discrete_lowres_zooms=aug.MULTIRES_ZOOMS)
    idx = np.array([aug.draw_sample(g, mcfg, None).lowres
                    for _ in range(300)])
    assert set(np.unique(idx)) == {0, 1, 2}


# --------------------------------------------------------------- dataset


@pytest.fixture
def mini_raw(tmp_path):
    """tests/test_train.py's raw dataset (copied)."""
    from dg_tta_tpu.data.nifti import write_nifti
    raw = tmp_path / "raw" / "Dataset903_TrainMini"
    (raw / "imagesTr").mkdir(parents=True)
    (raw / "labelsTr").mkdir()
    with open(raw / "dataset.json", "w") as f:
        json.dump({"labels": {"background": 0, "organ": 1},
                   "channel_names": {"0": "CT"},
                   "file_ending": ".nii.gz"}, f)
    rng = np.random.default_rng(0)
    for i in range(3):
        vol = rng.normal(50, 200, size=(20, 18, 22)).astype(np.float32)
        seg = np.zeros((20, 18, 22), np.uint8)
        seg[5:12, 5:12, 5:12] = 1
        vol[5:12, 5:12, 5:12] += 400
        write_nifti(raw / "imagesTr" / f"case{i}_0000.nii.gz", vol,
                    {"spacing": (1.5, 1.5, 1.5)}, dtype=np.float32)
        write_nifti(raw / "labelsTr" / f"case{i}.nii.gz", seg,
                    {"spacing": (1.5, 1.5, 1.5)})
    return raw


def test_dataset_pipeline_bit_equal(mini_raw, tmp_path):
    fp = ds.fingerprint_dataset(mini_raw)
    assert fp == jds.fingerprint_dataset(mini_raw)
    dsj = json.loads((mini_raw / "dataset.json").read_text())
    plans = ds.plan_experiment(dsj, fp, "Dataset903_TrainMini")
    assert plans == jds.plan_experiment(dsj, fp, "Dataset903_TrainMini")
    cases = ds.preprocess_dataset(mini_raw, plans, tmp_path / "port")
    assert cases == jds.preprocess_dataset(mini_raw, plans, tmp_path / "jax")
    for c in cases:
        with np.load(tmp_path / "port" / f"{c}.npz") as a, \
                np.load(tmp_path / "jax" / f"{c}.npz") as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
    assert ds.make_splits(cases) == jds.make_splits(cases)
    assert ds.make_splits(cases, n_folds=3) == jds.make_splits(cases,
                                                               n_folds=3)
    for oversample in (0.33, 1.0):
        got = ds.PatchSampler(tmp_path / "port", cases, PATCH,
                              oversample_fg=oversample, seed=4)
        ref = jds.PatchSampler(tmp_path / "jax", cases, PATCH,
                               oversample_fg=oversample, seed=4)
        for _ in range(4):
            for a, b in zip(got.batch(B), ref.batch(B)):
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- training step


def _models(trainer):
    mind = "MIND" in trainer
    spec = SPEC | dict(num_input_channels=12 if mind else 1)
    jm = JaxModel(spec=JaxArchSpec(**spec), patch_size=PATCH,
                  trainer_name=trainer, uses_gin_internal="GIN" in trainer,
                  uses_mind=mind)
    tm = Model(spec=ArchSpec(**spec), patch_size=PATCH, trainer_name=trainer,
               uses_gin_internal="GIN" in trainer, uses_mind=mind)
    return jm, tm


def _da_cfgs(trainer):
    zooms = (dict(discrete_lowres_zooms=jaug.MULTIRES_ZOOMS)
             if trainer in MULTIRES_TRAINERS else {})
    # the rotation, noise, blur and low-resolution gates on, the rest
    # drawn: every spatial path and both low-resolution forms run
    probs = dict(p_rotation=1.0, p_scale=1.0, p_noise=1.0, p_blur=1.0,
                 p_lowres=1.0)
    return jaug.DAConfig(**probs, **zooms), aug.DAConfig(**probs, **zooms)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_step_values(key, cfg, imgs_shape):
    """The draws of the JAX step on `key`: (k_da, k_model) = split(key),
    the augmentation's from k_da, GIN's nets and the MIND noise from
    k_model ((k_gin, k_mind) = split(k_model), `Model.apply`)."""
    k_da, k_model = jax.random.split(key)
    k_gin, k_mind = jax.random.split(k_model)
    return (_batch_values(k_da, cfg, imgs_shape),
            _jax_gin_draws(k_gin, imgs_shape[0], imgs_shape[-1], 3),
            jax.random.normal(k_mind, (*imgs_shape[:-1], 12), jnp.float32))


def _step_draws(key, jcfg, imgs_shape, gin):
    """The port's `StepDraws` of the JAX step on `key`."""
    values, (layers, alphas), noise = _jax_step_values(key, jcfg,
                                                       tuple(imgs_shape))
    layers, alphas, noise = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), (layers, alphas, noise))
    return pretrain.StepDraws(
        da=tuple(sample_draws(v) for v in values),
        gin=GinDraws(layers=tuple(tuple(kw) for kw in layers),
                     alphas=alphas) if gin else None,
        mind_noise=lambda shape, device: noise.to(device))


def _params(tm, seed):
    """Weights drawn by the port's `init_params`, as JAX arrays."""
    sd = tm.init_params(torch.Generator().manual_seed(seed))
    return jax.tree.map(jnp.array, params_to_jax(sd))


def _leaves(state_dict):
    return jax.tree.leaves(params_to_jax(state_dict))


@pytest.mark.parametrize("trainer,steps", [("nnUNetTrainer_GIN_MIND", 2),
                                           ("nnUNetTrainer_GIN_MultiRes", 1)])
def test_train_step_matches_jax(trainer, steps):
    """`make_train_step` against the JAX step: the same weights, DA, GIN
    and MIND draws; the second step runs on the momentum of the first."""
    jm, tm = _models(trainer)
    jcfg, cfg = _da_cfgs(trainer)
    params = _params(tm, 0)
    tx, jstep = jpre.make_train_step(jm, jcfg)
    opt_state = tx.init(params)
    net = tm.build_network(params_from_jax(jax.tree.map(np.asarray, params)),
                           device="cpu")
    opt = pretrain.make_optimizer(net)
    step = pretrain.make_train_step(tm, cfg)
    imgs, segs = _batch(7)
    # each leaf's update, relative to its norm (module docstring)
    update_rtol = 2e-2 if "MIND" in trainer else 1e-3
    for i, lr in enumerate((1e-2, 8e-3)[:steps]):
        before = jax.tree.map(np.asarray, params)
        key = jax.random.PRNGKey(10 + i)
        params, opt_state, ref_loss = jstep(
            jax.tree.map(jnp.array, params), opt_state, key,
            jnp.asarray(imgs), jnp.asarray(segs), jnp.float32(lr))
        loss = step(net, opt, torch.from_numpy(imgs), torch.from_numpy(segs),
                    _step_draws(key, jcfg, imgs.shape, tm.uses_gin_internal),
                    lr)
        assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(
            float(ref_loss)), (i, float(loss), float(ref_loss))
        ref = jax.tree.leaves(jax.tree.map(np.asarray, params))
        got = _leaves(net.state_dict())
        old = jax.tree.leaves(before)
        if i == 0:
            initialized = [bool(np.any(o)) for o in old]
        moved = 0
        for g, r, o, nonzero in zip(got, ref, old, initialized):
            if nonzero:
                np.testing.assert_allclose(g, r, rtol=0,
                                           atol=1e-4 * np.abs(r).max())
            du, dr = g - o, r - o
            assert np.linalg.norm(du - dr) <= update_rtol * np.linalg.norm(dr)
            moved += bool(np.any(dr))
        assert moved >= len(ref) // 2


def test_sgd_nesterov_matches_optax_chain():
    """`make_optimizer` (torch SGD, momentum 0.99, Nesterov, weight decay
    3e-5) against the JAX step's `add_decayed_weights` -> `trace(nesterov)`
    -> `-lr` chain, on the same weights and gradients, lr changing per
    step as the poly schedule changes it per epoch; the first step
    included (torch starts its buffer at the first gradient, optax its
    trace at zero: the same value)."""
    import optax

    _, tm = _models("nnUNetTrainer_GIN")
    net = tm.build_network(tm.init_params(torch.Generator().manual_seed(4)),
                           device="cpu")
    opt = pretrain.make_optimizer(net)
    # copies: a numpy view of a torch parameter would follow its updates
    params = jax.tree.map(jnp.array, params_to_jax(net.state_dict()))
    tx = optax.chain(optax.add_decayed_weights(jpre.WEIGHT_DECAY),
                     optax.trace(decay=jpre.MOMENTUM, nesterov=True))
    state = tx.init(params)
    rng = np.random.default_rng(5)
    for lr in (1e-2, 6e-3, 2e-3):
        grads = {n: torch.from_numpy(rng.normal(size=tuple(p.shape))
                                     .astype(np.float32))
                 for n, p in net.named_parameters()}
        for n, p in net.named_parameters():
            p.grad = grads[n].clone()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        updates, state = tx.update(
            jax.tree.map(jnp.asarray, params_to_jax(grads)), state, params)
        params = optax.apply_updates(
            params, jax.tree.map(lambda u: -lr * u, updates))
        for g, r in zip(_leaves(net.state_dict()), jax.tree.leaves(params)):
            r = np.asarray(r)
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-6 * np.abs(r).max())


def test_val_step_counts_equal():
    jm, tm = _models("nnUNetTrainer_GIN")
    params = _params(tm, 1)
    # a larger head bias spreads the argmax over the classes
    params["decoder"]["seg_layers"][-1]["b"] = jnp.asarray(
        [0.0, 0.3, -0.2, 0.1], jnp.float32)
    net = tm.build_network(params_from_jax(jax.tree.map(np.asarray, params)),
                           device="cpu")
    imgs, segs = _batch(8)
    ref = jpre.make_val_step(jm)(params, jnp.asarray(imgs),
                                 jnp.asarray(segs))
    got = pretrain.make_val_step(tm)(net, torch.from_numpy(imgs),
                                     torch.from_numpy(segs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert all(int(t.sum()) > 0 for t in got)
    # JAX divides its f32 counts in f32, the port its int64 counts in f64
    np.testing.assert_allclose(
        pretrain._global_pseudo_dice(*got)[1],
        jpre._global_pseudo_dice(*(np.asarray(r) for r in ref))[1],
        rtol=1e-6)


def test_prefetch_hands_its_error_to_the_training_loop():
    """A sampler that raises in the prefetch thread: the training loop's
    next batch raises the error instead of waiting for a batch that never
    comes, and the thread ends."""
    class Broken:
        def reseed(self, seed, epoch):
            pass

        def batch(self, batch_size):
            raise ValueError("no cases to sample")

    q, stop, thread = pretrain._prefetch(Broken(), 2, 0, range(1), 2,
                                         torch.device("cpu"))
    try:
        with pytest.raises(RuntimeError) as err:
            pretrain._next_batch(q)
        assert isinstance(err.value.__cause__, ValueError)
    finally:
        stop.set()
        thread.join(timeout=10)
    assert not thread.is_alive()


# -------------------------------------------------------- the whole run


def _mini_plans(raw):
    fp = ds.fingerprint_dataset(raw)
    dsj = json.loads((raw / "dataset.json").read_text())
    plans = ds.plan_experiment(dsj, fp, "Dataset903_TrainMini",
                               max_patch=PATCH)
    plans["configurations"]["3d_fullres"].update(
        UNet_base_num_features=8, unet_max_num_features=16,
        n_conv_per_stage_encoder=[1, 1, 1], n_conv_per_stage_decoder=[1, 1],
        pool_op_kernel_sizes=[[1, 1, 1], [2, 2, 2], [2, 2, 2]],
        conv_kernel_sizes=[[3, 3, 3]] * 3)
    return plans


@pytest.fixture
def workspace(mini_raw, tmp_path, monkeypatch):
    def at(name):
        root = tmp_path / name
        (root / "results").mkdir(parents=True)
        monkeypatch.setenv("nnUNet_raw", str(mini_raw.parent))
        monkeypatch.setenv("nnUNet_results", str(root / "results"))
        monkeypatch.setenv("nnUNet_preprocessed", str(root / "pre"))
        return root
    return at


def _log(out_dir):
    return [{k: v for k, v in json.loads(line).items()
             if not k.endswith("seconds")}
            for line in (out_dir / "training_log.jsonl").read_text()
            .splitlines()]


def test_run_pretraining_resume_follows_the_uninterrupted_run(
        mini_raw, workspace, monkeypatch):
    """A 3-epoch run stopped after its second epoch (an error raised as the
    third begins, as an interrupted job stops), then resumed with
    `continue_training`, logs what the uninterrupted 3-epoch run logs and
    ends on its weights.  (The poly
    schedule depends on the run's length, so the stopped run is a 3-epoch
    run too.)  A 2-epoch run resumed to 3 epochs continues its EMA."""
    from dg_tta_tpu_torch.models.convert import load_flat_npz
    from dg_tta_tpu_torch.tta.driver import load_pretrained_bundle

    plans = _mini_plans(mini_raw)
    kw = dict(fold=0, trainer_name="nnUNetTrainer_GIN_MIND",
              iters_per_epoch=2, val_iters_per_epoch=2, plans=plans,
              batch_size=2, verbose=False, device="cpu", seed=5)
    workspace("straight")
    straight = pretrain.run_pretraining("903", num_epochs=3, **kw)

    resumed = workspace("resumed")
    poly_lr = pretrain.poly_lr

    class Stopped(Exception):
        pass

    def stop_at_epoch_2(lr, epoch, epochs):
        if epoch == 2:
            raise Stopped
        return poly_lr(lr, epoch, epochs)

    monkeypatch.setattr(pretrain, "poly_lr", stop_at_epoch_2)
    with pytest.raises(Stopped):
        pretrain.run_pretraining("903", num_epochs=3, **kw)
    monkeypatch.setattr(pretrain, "poly_lr", poly_lr)
    out = resumed / straight.relative_to(straight.parents[3])
    assert len(_log(out)) == 2
    state = json.loads((out / "training_state.json").read_text())
    assert state["epoch"] == 1 and state["seed"] == 5
    mom = load_flat_npz(out / "checkpoint_latest_optimizer.npz")
    assert any(float(v.abs().max()) > 0 for v in mom.values())
    out = pretrain.run_pretraining("903", num_epochs=3,
                                   continue_training=True, **kw)
    log = _log(out)
    assert log == _log(straight)
    assert [e["epoch"] for e in log] == [0, 1, 2]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["ema_dice"])
               for e in log)
    for name in ("checkpoint_final.npz", "checkpoint_best.npz"):
        a, b = load_flat_npz(out / name), load_flat_npz(straight / name)
        assert all(torch.equal(a[k], b[k]) for k in a)
    for f in ("plans.json", "dataset.json"):
        assert (out.parent / f).is_file()

    workspace("two_then_three")
    out = pretrain.run_pretraining("903", num_epochs=2, **kw)
    ema = json.loads((out / "training_state.json").read_text())["ema_dice"]
    out = pretrain.run_pretraining("903", num_epochs=3,
                                   continue_training=True, **kw)
    last = _log(out)[-1]
    assert last["epoch"] == 2
    assert abs(last["ema_dice"] - (0.9 * ema + 0.1 * last["val_pseudo_dice"])) \
        < 1e-12

    # the results folder serves run_tta in either package
    model, net, _, _ = load_pretrained_bundle(out / "checkpoint_final.npz",
                                              device="cpu")
    assert model.trainer_name == "nnUNetTrainer_GIN_MIND"
    assert model.spec.num_input_channels == 12
    jparams = flat_npz_to_params(out / "checkpoint_final.npz")
    for g, r in zip(_leaves(net.state_dict()), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_cli_pretrain_and_inject_trainers(mini_raw, workspace, monkeypatch,
                                          capsys):
    from dg_tta_tpu_torch.cli.main import main
    from dg_tta_tpu_torch.models.network import TRAINER_REGISTRY

    assert main(["inject_trainers"]) == list(TRAINER_REGISTRY)
    assert "nnUNetTrainer_GIN_MIND_MultiRes" in capsys.readouterr().out
    root = workspace("cli")
    pre = root / "pre" / "Dataset903_TrainMini"
    pre.mkdir(parents=True)
    (pre / "plans.json").write_text(json.dumps(_mini_plans(mini_raw)))
    # 2 iterations an epoch instead of 250: the arguments pass through
    monkeypatch.setattr(pretrain, "run_pretraining", functools.partial(
        pretrain.run_pretraining, iters_per_epoch=2, verbose=False))
    out = main(["pretrain", "903", "3d_fullres", "0", "-tr",
                "nnUNetTrainer_GIN_MultiRes", "--num_epochs", "1",
                "--val_iters_per_epoch", "1", "--device", "cpu"])
    assert out.name == "fold_0"
    assert out.parent.name == \
        "nnUNetTrainer_GIN_MultiRes__nnUNetPlans__3d_fullres"
    assert len(_log(out)) == 1 and (out / "checkpoint_final.npz").is_file()
    out = main(["pretrain", "903", "--num_epochs", "2", "-tr",
                "nnUNetTrainer_GIN_MultiRes", "--val_iters_per_epoch", "1",
                "--device", "cpu", "--c"])
    assert [e["epoch"] for e in _log(out)] == [0, 1]
    # data-parallel pretraining splits the batch (2 here) over the devices
    with pytest.raises(ValueError, match="divisible"):
        main(["pretrain", "903", "--num_devices", "3", "--device", "cpu"])
