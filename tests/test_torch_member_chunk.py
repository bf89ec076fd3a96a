"""Ensemble members side by side on one device (the port's
`TTAFunctions.chunk_run`, `PlainConvUNet.forward_members` and the conv
wrappers' member axis) against the JAX package's vmapped chunk and against
the port's serial members, on the tiny models of tests/test_torch_engine.py.

Tolerances, f32 on the CPU:
* the plain conv versions with M = 3 members' weights, forward, input
  gradient and weight gradient: bit for bit the three one-member calls
  (they run one member after another);
* the side-by-side forward and its gradients: bit for bit the serial
  forward of each member (the convs' stacked launches, and per member
  the operations that sum over a member's positions);
* MIND's clip bound and the loss's all-zero guard: each member's, as
  `jax.vmap` over members takes them: MIND 1e-5 relative, the loss 1e-6;
* a GIN_MIND chunk on two volumes against the JAX package's vmapped
  chunk: tests/test_torch_engine.py's trajectory tolerances (losses 1e-3
  relative, Dices 2e-2, each parameter's update within 5% of JAX's in
  norm);
* the side-by-side chunk against the serial members on `TorchDraws`:
  bit for bit (losses, Dices, weights) on an affine plan, at
  `patch_group` 2, with `remat` and on a deformable plan.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.core.losses import consistency_loss_flat as jax_loss_flat
from dg_tta_tpu.ops import mind as jmind
from dg_tta_tpu.tta.engine import tta_one_volume as jax_tta_one_volume
from dg_tta_tpu.tta.plan import TTAPlan as JaxPlan
from dg_tta_tpu_torch.core.losses import (_guarded_ratio,
                                          consistency_loss_flat)
from dg_tta_tpu_torch.kernels.conv3x3 import (conv3x3, conv3x3_op,
                                              conv3x3_wgrad, pack_few_weights,
                                              wgmma_plan)
from dg_tta_tpu_torch.models.unet import stack_members
from dg_tta_tpu_torch.ops import mind
from dg_tta_tpu_torch.tta import driver
from dg_tta_tpu_torch.tta.draws import TorchDraws
from dg_tta_tpu_torch.tta.engine import tta_one_volume
from dg_tta_tpu_torch.tta.plan import TTAPlan
from tests.test_torch_engine import (IDX3, VOL_SHAPE,  # noqa: F401
                                     JaxDraws, _biased, _check_trajectory,
                                     _same, _two_torch_threads, jax_model,
                                     port_model, port_net, synth_labels,
                                     synth_volume)

REPO = Path(__file__).resolve().parents[1]
M = 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 12, 32])
def test_plain_conv_members_equal_single_calls(dtype, C):
    """Forward, input gradient (through `conv3x3_op`) and weight gradient
    of M members' stacked weights on the plain versions: bit for bit the
    M one-member calls."""
    rng = np.random.default_rng(C)
    depth, n, H, W, CO = 2, 4, 6, 7, 16
    x = torch.from_numpy(rng.normal(size=(M * n, H, W, C))
                         .astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(M, 3, 3, 3, C, CO))
                         .astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(M * n, H, W, CO))
                          .astype(np.float32)).to(dtype)
    xs, dys = x.chunk(M), dy.chunk(M)
    y = conv3x3(x, w, depth)
    assert torch.equal(y, torch.cat([conv3x3(xm, wm, depth)
                                     for xm, wm in zip(xs, w)]))
    dw = conv3x3_wgrad(x, dy, depth, members=M)
    assert dw.shape == (M, 3, 3, 3, C, CO)
    assert torch.equal(dw, torch.stack([conv3x3_wgrad(xm, dym, depth)
                                        for xm, dym in zip(xs, dys)]))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    conv3x3_op(xg, wg, depth).backward(dy)
    for m in range(M):
        xm = xs[m].clone().requires_grad_()
        wm = w[m].clone().requires_grad_()
        conv3x3_op(xm, wm, depth).backward(dys[m])
        assert torch.equal(xg.grad.chunk(M)[m], xm.grad)
        assert torch.equal(wg.grad[m], wm.grad)


def test_member_plans_and_packing():
    """The forward's plan takes its splits from one member's planes (its
    items count every member's), the "few" route packs each member's
    weights as it packs one, and planes that do not split into members of
    whole volumes raise."""
    for dtype in (torch.float32, torch.bfloat16):
        for H, W in ((112, 128), (7, 8)):
            one = wgmma_plan(256, 128, H, W, 32, 64, dtype)
            chunk = wgmma_plan(256, 128, H, W, 32, 64, dtype, members=M)
            assert chunk["splits"] == one["splits"]
            assert chunk["items"] == M * one["items"]
    w = torch.randn(M, 3, 3, 3, 12, 32)
    for dtype in (torch.float32, torch.bfloat16):
        packed = pack_few_weights(w.to(dtype))
        assert torch.equal(packed, torch.stack(
            [pack_few_weights(wm.to(dtype)) for wm in w]))
    with pytest.raises(ValueError, match="members"):
        conv3x3(torch.zeros(8, 4, 4, 12), w, depth=2)   # 8 planes, 3 members
    with pytest.raises(ValueError, match="members"):
        conv3x3_wgrad(torch.zeros(6, 4, 4, 12), torch.zeros(6, 4, 4, 32),
                      depth=4, members=M)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_forward_members_equals_serial_forward(dtype):
    """`forward_members` on M networks' stacked weights: each member's
    logits, deep-supervision outputs and weight gradients bit for bit its
    serial forward's."""
    model = port_model()
    nets = [model.build_network(model.init_params(
        torch.Generator().manual_seed(s)), device="cpu") for s in range(M)]
    params = {k: p.requires_grad_() for k, p in stack_members(nets).items()}
    x = torch.randn(M * 2, 16, 16, 16, 1)
    outs = nets[0].forward_members(params, x, deep_supervision=True,
                                   compute_dtype=dtype, head_channel_idx=IDX3)
    sum(o.float().square().sum() for o in outs).backward()
    for m, (net, xm) in enumerate(zip(nets, x.chunk(M))):
        ref = net(xm, deep_supervision=True, compute_dtype=dtype,
                  head_channel_idx=IDX3)
        sum(o.float().square().sum() for o in ref).backward()
        for o, r in zip(outs, ref):
            assert torch.equal(o.chunk(M)[m], r)
        for name, p in net.named_parameters():
            got = params[name].grad
            if p.grad is None:
                assert got is None or not got[m].any(), name
            else:
                assert torch.equal(got[m], p.grad), name


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One `torch.exp` before any comparison (tests/test_torch_mind.py)."""
    torch.exp(torch.zeros(4096))


def test_mind_clip_bound_per_member_as_jax_vmap():
    """A smooth member beside a rough one: each member's clip bound is its
    own, as `jax.vmap` of the JAX MIND over members; the bound over the
    whole chunk clips the smooth member and misses."""
    rng = np.random.default_rng(4)
    smooth = rng.normal(size=(2, 10, 10, 10, 1)).astype(np.float32) * 1e-3
    rough = rng.normal(size=(2, 10, 10, 10, 1)).astype(np.float32) * 1e3
    img = np.concatenate([smooth, rough])
    ref = np.asarray(jax.jit(jax.vmap(jmind.mind3d))(
        jnp.asarray(img.reshape(2, 2, 10, 10, 10, 1)))).reshape(
            4, 10, 10, 10, 12)
    got = mind.mind3d(torch.from_numpy(img), members=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    chunk_wide = mind.mind3d(torch.from_numpy(img)).numpy()
    assert not np.allclose(chunk_wide, ref, rtol=1e-3)


def test_loss_guard_per_member_as_jax_vmap():
    """A member whose patches leave no common foreground (every
    denominator 0) gets the guard's Dice of 1 while the other member's
    loss is its own, as `jax.vmap` of the JAX loss over members; the guard
    over the whole chunk gives that member a Dice of 0 and misses."""
    rng = np.random.default_rng(5)
    la = rng.normal(size=(2 * 2, 3, 64)).astype(np.float32)
    lb = rng.normal(size=(2 * 2, 3, 64)).astype(np.float32)
    la[:2] = -np.abs(la[:2])     # member 0: no voxel with positive logits
    ref = np.asarray(jax.jit(jax.vmap(jax_loss_flat))(
        jnp.asarray(la.reshape(2, 2, 3, 64)),
        jnp.asarray(lb.reshape(2, 2, 3, 64))))
    got = consistency_loss_flat(torch.from_numpy(la), torch.from_numpy(lb),
                                members=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0 and got[1] > 0.0
    # the chunk's denominators guarded as one would give member 0's rows a
    # Dice of 0; its own guard gives 1
    den = torch.rand(4, 3)
    den[:2] = 0.0
    assert not _guarded_ratio(torch.ones(4, 3), den)[:2].any()
    assert _guarded_ratio(torch.ones(2, 3), den[:2]).eq(1).all()


def _two_volumes():
    """Two volumes of one shape, the second 300x the first's scale: the
    members' patches differ in MIND's edge energy by ~1e5."""
    rng = np.random.default_rng(6)
    vols = np.stack([synth_volume(rng), 300.0 * synth_volume(rng)])
    labels = np.stack([synth_labels(), synth_labels()])
    shapes = np.asarray([VOL_SHAPE] * 2, np.float32)
    return vols, shapes, labels


def test_gin_mind_chunk_matches_jax_vmapped_chunk(monkeypatch):
    """GIN_MIND, GIN in both branches, two members side by side on two
    volumes: each member's own patches, volumes, GIN nets and MIND noise
    against the JAX package's vmapped chunk.  The same run with MIND's
    clip bound taken over the chunk misses JAX's losses."""
    trainer = "nnUNetTrainer_GIN_MIND"
    vols, shapes, labels = _two_volumes()
    params = _biased(jax.jit(jax_model(trainer).init_params)(
        jax.random.PRNGKey(3)), 9)
    plan_kw = dict(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=2, start_tta_at_epoch=1,
                   do_intensity_aug_in="both", tta_across_all_samples=True)
    # members draw different volumes in three of the four steps
    key = jax.random.PRNGKey(13)
    ref = jax_tta_one_volume(jax_model(trainer), JaxPlan(**plan_kw), params,
                             jnp.asarray(vols), jnp.asarray(shapes), IDX3,
                             IDX3, key, labels_padded=jnp.asarray(labels))

    def run():
        return tta_one_volume(port_model(trainer), TTAPlan(**plan_kw),
                              port_net(params, trainer),
                              torch.from_numpy(vols), shapes, IDX3, IDX3,
                              JaxDraws(key, n_acc=2),
                              labels_padded=torch.from_numpy(labels),
                              ensemble_chunk=2)

    _check_trajectory(plan_kw, params, ref, run(), trainer)

    real = mind.mind3d
    monkeypatch.setattr(mind, "mind3d", lambda *a, members=None, **k:
                        real(*a, **k))
    from dg_tta_tpu_torch.models import network
    monkeypatch.setattr(network, "mind3d", mind.mind3d)
    _, wide_losses, _ = run()
    assert not np.allclose(wide_losses, np.asarray(ref[1]), rtol=1e-3)


def _port_run(plan_kw, members=None, chunk=None, patch=(16, 16, 16),
              vol_shape=VOL_SHAPE, **kw):
    rng = np.random.default_rng(0)
    vols = synth_volume(rng, vol_shape)[None]
    shapes = np.asarray([vol_shape], np.float32)
    labels = synth_labels(vol_shape)[None]
    model = port_model(patch=patch)
    net = model.build_network(model.init_params(
        torch.Generator().manual_seed(0)), device="cpu")
    return tta_one_volume(model, TTAPlan(**plan_kw), net,
                          torch.from_numpy(vols), shapes,
                          IDX3, IDX3, TorchDraws(seed=3),
                          labels_padded=torch.from_numpy(labels),
                          member_indices=members, ensemble_chunk=chunk, **kw)


PLAN = dict(epochs=2, patches_to_be_accumulated=2, lr=1e-3, ensemble_count=3,
            start_tta_at_epoch=1, do_intensity_aug_in="both")


DEFORMABLE = (dict(ensemble_count=2, spatial_aug_type="deformable"),
              dict(patch=(30, 30, 30), vol_shape=(30, 32, 30)))


@pytest.mark.parametrize("plan,kw", [
    (dict(), dict()), (dict(), dict(patch_group=2)),
    (dict(), dict(remat=True)), DEFORMABLE],
    ids=["affine", "patch_group_2", "remat", "deformable"])
def test_chunk_equals_serial_members(plan, kw):
    """The chunk side by side: every member's losses, Dices and weights
    bit for bit its serial run's, on the affine plan, at `patch_group` 2,
    with `remat` and on the deformable plan (a 30^3 patch: smaller ones
    make near-identity fields); a resume subset (member 1 alone) is member
    1 of the chunk."""
    plan = dict(PLAN, **plan)
    serial = _port_run(plan, chunk=1, **kw)
    chunk = _port_run(plan, chunk=plan["ensemble_count"], **kw)
    for a, b in zip(serial[1:], chunk[1:]):
        np.testing.assert_array_equal(a, b)
    assert all(_same(s, c) for s, c in zip(serial[0], chunk[0]))
    if not kw:
        solo = _port_run(plan, members=[1])
        np.testing.assert_array_equal(solo[1][:, 0], chunk[1][:, 1])
        assert _same(solo[0][0], chunk[0][1])


def test_driver_reaches_the_chunk(monkeypatch):
    """`DGTTA_ENSEMBLE_CHUNK` sets the plan's chunk; the default stays the
    JAX driver's (one member a chunk for a full-size patch on one device,
    all members below 2^20 voxels)."""
    plan = TTAPlan(ensemble_count=3)
    assert driver.default_ensemble_chunk(plan, (112, 112, 128),
                                         1).ensemble_chunk == 1
    assert driver.default_ensemble_chunk(plan, (64, 64, 64),
                                         1).ensemble_chunk is None
    monkeypatch.setenv("DGTTA_ENSEMBLE_CHUNK", "3")
    assert driver.adaptation_knobs(plan).ensemble_chunk == 3


def test_cli_module_runs():
    """`python -m dg_tta_tpu_torch.cli --help` exits 0, as the JAX
    package's `python -m dg_tta_tpu.cli` does."""
    out = subprocess.run([sys.executable, "-m", "dg_tta_tpu_torch.cli",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "run_tta" in out.stdout
