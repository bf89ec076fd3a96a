"""The port's TTA engine (dg_tta_tpu_torch/tta/engine.py) against the JAX
package's, on the tiny model of tests/test_tta_engine.py.

JAX's threefry and torch's generators never give the same bits, so the
port runs on `JaxDraws`: the patch offsets, volume indices, affine noise,
GIN nets and MIND noise that the JAX engine draws, derived here from the
same key folds and splits the JAX package uses (driver.py:186,245;
engine.py:503-506, 459-460, 402, 386-389, 346-348, 247-251, 259, 416;
network.py:131-137; patches.py:182-187).  The tests
first show that these draws give JAX's own patches, then compare one
patch step's loss and gradients, and whole `tta_one_volume` trajectories.

Tolerances, f32 on the CPU:
* one patch step: loss 1e-5 relative; each gradient 1e-4 of its largest
  entry plus 1e-7 (the same math, summed in another order through ~20
  layers);
* a trajectory: per-epoch losses 1e-3 relative and Dices 2e-2 (a few
  voxels of the 16^3 centre patch may flip class); each parameter's
  update (final - initial) within 5% of JAX's in norm: AdamW's step is
  ~lr x sign(gradient), so the few entries whose gradient is near zero
  may step the other way, while a port that did not update, or updated
  along wrong gradients, misses by 100% or more.  Parameters the loss
  never reaches (the conv biases before InstanceNorm, the logit channel
  outside the mapped labels) have a zero gradient, and AdamW decays them
  by exactly (1 - lr x weight decay) per trained epoch in both packages:
  1e-6 relative, the rounding of a few f32 multiplies.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.core import grid as jgrid
from dg_tta_tpu.core.fields import get_disp_field as jax_disp_field
from dg_tta_tpu.core.fields import get_rand_affine as jax_rand_affine
from dg_tta_tpu.core.losses import consistency_loss_flat as jax_loss_flat
from dg_tta_tpu.core.patches import extract_batch as jax_extract_batch
from dg_tta_tpu.models.network import Model as JaxModel
from dg_tta_tpu.models.plans import ArchSpec as JaxArchSpec
from dg_tta_tpu.tta.engine import _warp_with_inverse as jax_wwi
from dg_tta_tpu.tta.engine import tta_one_volume as jax_tta_one_volume
from dg_tta_tpu.tta.plan import TTAPlan as JaxPlan
from dg_tta_tpu_torch.core.patches import extract_batch
from dg_tta_tpu_torch.models.convert import params_from_jax, params_to_jax
from dg_tta_tpu_torch.models.network import Model
from dg_tta_tpu_torch.models.plans import ArchSpec
from dg_tta_tpu_torch.tta.draws import PatchDraws, TorchDraws
from dg_tta_tpu_torch.tta.engine import (make_tta_functions,
                                         params_with_grad_mask,
                                         tta_one_volume)
from dg_tta_tpu_torch.tta.plan import TTAPlan
from tests.test_torch_mind import jax_gin_draws

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the module's torch work, restored after:
    the suite runs six workers on one machine, where torch's default of a
    thread per core made deformable cases of tests/test_torch_patch_group.py
    (which imports this fixture) 10-45x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SPEC = dict(features_per_stage=(8, 16), kernel_sizes=((3, 3, 3),) * 2,
            strides=((1, 1, 1), (2, 2, 2)), n_conv_per_stage_encoder=(1, 1),
            n_conv_per_stage_decoder=(1,), num_input_channels=1,
            num_classes=4)
PATCH = (16, 16, 16)
VOL_SHAPE = (24, 28, 20)
IDX3 = np.arange(3, dtype=np.int32)


def _family(trainer):
    """(spec, uses_gin_internal, uses_mind) of a trainer: 12 input
    channels (the MIND features) for a MIND family."""
    mind = "MIND" in trainer
    spec = dict(SPEC, num_input_channels=12 if mind else 1)
    return spec, "GIN" in trainer, mind


def jax_model(trainer="nnUNetTrainer_GIN", patch=PATCH):
    spec, gin, mind = _family(trainer)
    return JaxModel(spec=JaxArchSpec(**spec), patch_size=patch,
                    trainer_name=trainer, uses_gin_internal=gin,
                    uses_mind=mind)


def port_model(trainer="nnUNetTrainer_GIN", patch=PATCH):
    spec, gin, mind = _family(trainer)
    return Model(spec=ArchSpec(**spec), patch_size=patch,
                 trainer_name=trainer, uses_gin_internal=gin,
                 uses_mind=mind)


def port_net(jax_params, trainer="nnUNetTrainer_GIN"):
    net = port_model(trainer).build_network(device="cpu")
    net.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax_params)))
    return net


def synth_volume(rng, shape=VOL_SHAPE):
    """tests/test_tta_engine.py's volume: noise with a bright blob."""
    vol = rng.normal(size=(*shape, 1)).astype(np.float32) * 0.1
    d, h, w = shape
    vol[d // 4: d // 2, h // 4: h // 2, w // 4: w // 2] += 2.0
    return vol


def synth_labels(shape=VOL_SHAPE):
    lab = np.zeros((*shape, 1), np.float32)
    d, h, w = shape
    lab[d // 4: d // 2, h // 4: h // 2, w // 4: w // 2] = 1.0
    lab[d // 2: d // 2 + 4, h // 2: h // 2 + 5, w // 3: w // 2] = 2.0
    return lab


class JaxDraws:
    """The draws of the JAX engine's `member_run` for base key `key` (the
    key `tta_one_volume` gets), in the port's draw-source interface.
    `n_acc` is the engine's steps per epoch: at `patch_group` g, the JAX
    engine draws step s from split(k_tr, n_acc // g)[s] at batch B * g,
    so a grouped run takes JaxDraws(key, n_acc // g), whose `patch`
    draws `group` x `batch` patches from that key."""

    def __init__(self, key, n_acc):
        self.key, self.n_acc = key, n_acc

    def _epoch_key(self, member, epoch):
        return jax.random.fold_in(jax.random.fold_in(self.key, member), epoch)

    def step_key(self, member, epoch, step):
        k_tr = jax.random.fold_in(self._epoch_key(member, epoch), 0)
        return jax.random.split(k_tr, self.n_acc)[step]

    def patch(self, member, epoch, step, n_vols, batch, gin_branches=(),
              channels=1, group=1):
        batch = batch * group
        k_patch, k_aug = jax.random.split(self.step_key(member, epoch, step))
        k_idx, k_p = jax.random.split(k_patch)
        idx = np.asarray(jax.random.randint(k_idx, (batch,), 0, n_vols))
        uniforms = np.stack([np.asarray(jax.random.uniform(k, (3,)))
                             for k in jax.random.split(k_p, batch)])
        ka, kb, k_model = jax.random.split(k_aug, 3)
        noise, gins, fields = [], [], []
        for branch, k_branch in (("branch_a", ka), ("branch_b", kb)):
            k_int, k_sp = jax.random.split(k_branch)
            k1, _ = jax.random.split(k_sp)
            noise.append(np.asarray(jax.random.normal(k1, (batch, 3, 4))))
            gins.append(jax_gin_draws(k_int, batch, channels)
                        if branch in gin_branches else None)
            fields.append(self._normal(k_sp))
        return PatchDraws(vol_idx=idx, uniforms=uniforms, noise_a=noise[0],
                          noise_b=noise[1], gin_a=gins[0], gin_b=gins[1],
                          mind_noise=self._mind_noise(k_model),
                          field_a=fields[0], field_b=fields[1])

    @staticmethod
    def _normal(key):
        """(shape, device) -> normal(key, shape): the deformable field noise
        of a branch is normal(k_sp, ...) (`get_rf_field`), k_sp the key the
        affine path splits again."""
        return lambda shape, device: torch.from_numpy(np.array(
            jax.random.normal(key, tuple(shape), jnp.float32))).to(device)

    @classmethod
    def _mind_noise(cls, k_model):
        """`Model.apply(key=k_model)`'s MIND noise: normal(k_mind, shape),
        (k_gin, k_mind) = split(k_model)."""
        return cls._normal(jax.random.split(k_model)[1])

    def _eval_keys(self, member, epoch, rep):
        k_e = jax.random.fold_in(self._epoch_key(member, epoch), 1 + rep)
        return jax.random.split(k_e)   # (k_patch, k_model)

    def eval_volumes(self, member, epoch, rep, n_vols, batch):
        k_patch, _ = self._eval_keys(member, epoch, rep)
        k_idx, _ = jax.random.split(k_patch)
        return np.asarray(jax.random.randint(k_idx, (batch,), 0, n_vols))

    def eval_mind_noise(self, member, epoch, rep, shape, device):
        _, k_model = self._eval_keys(member, epoch, rep)
        return self._mind_noise(k_model)(shape, device)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = jax_model().init_params(jax.random.PRNGKey(0))
    vols = synth_volume(rng)[None]
    shapes = np.asarray([VOL_SHAPE], np.float32)
    return params, vols, shapes, synth_labels()[None]


def test_jax_draws_reproduce_the_jax_patches(setup):
    params, vols, shapes, labels = setup
    draws = JaxDraws(jax.random.PRNGKey(1), n_acc=2)
    for member, epoch, step in ((0, 0, 0), (1, 2, 1)):
        k_patch, _ = jax.random.split(draws.step_key(member, epoch, step))
        ref, _ = jax_extract_batch(k_patch, jnp.asarray(vols),
                                   jnp.asarray(shapes), PATCH, 1)
        d = draws.patch(member, epoch, step, 1, 1)
        got, _ = extract_batch(d.vol_idx, d.uniforms, torch.from_numpy(vols),
                               shapes, PATCH, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _jax_patch_loss(model, params, imgs, k_aug):
    """The JAX engine's patch loss (engine.py:244-389) from its public
    pieces, at the CPU default: exact trilinear warps, original frame."""
    B = imgs.shape[0]
    ka, kb, _ = jax.random.split(k_aug, 3)
    xs, ctxs = [], []
    for k in (ka, kb):
        _, k_sp = jax.random.split(k)
        theta, theta_inv = jax_rand_affine(k_sp, B)
        grid = jgrid.affine_grid(theta, PATCH)
        grid_inv = jgrid.affine_grid(theta_inv, PATCH)
        R = theta[:, :, :3]
        adj = jnp.abs(jnp.einsum("bi,bi->b", R[:, :, 0],
                                 jnp.cross(R[:, :, 1], R[:, :, 2])))
        xf = jnp.moveaxis(imgs, -1, 1).reshape(B, 1, -1)
        xf = jgrid.grid_sample_flat(xf, PATCH, grid, padding_mode="border")
        xs.append(jnp.moveaxis(xf.reshape(B, 1, *PATCH), 1, -1))
        ctxs.append((grid, grid_inv, adj))
    logits = model.apply(params, jnp.concatenate(xs), head_channel_idx=IDX3)
    lf = jnp.moveaxis(logits, -1, 1).reshape(2 * B, 3, -1)
    la, lb = [jax_wwi(lf[i * B:(i + 1) * B], gi, g, adj, PATCH, "zeros")
              for i, (g, gi, adj) in enumerate(ctxs)]
    return jax_loss_flat(la, lb, start_class=1)


def test_one_patch_step_matches_jax_value_and_grad(setup):
    params, vols, shapes, _ = setup
    draws = JaxDraws(jax.random.PRNGKey(1), n_acc=2)
    k_patch, k_aug = jax.random.split(draws.step_key(0, 1, 1))
    imgs, _ = jax_extract_batch(k_patch, jnp.asarray(vols),
                                jnp.asarray(shapes), PATCH, 1)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: _jax_patch_loss(jax_model(), p, imgs, k_aug))(params)

    net = port_net(params)
    fns = make_tta_functions(port_model(), TTAPlan(), IDX3, IDX3)
    loss = fns.patch_loss(net, draws.patch(0, 1, 1, 1, 1),
                          torch.from_numpy(np.array(imgs)))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in net.named_parameters()}
    got = params_to_jax(grads)
    unused = 0
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref_grads)[0],
                            jax.tree.leaves(got)):
        r = np.asarray(r)
        if not np.any(r):
            unused += 1   # conv biases before InstanceNorm
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    assert unused > 0


TRAJECTORY_PLAN = dict(epochs=3, patches_to_be_accumulated=2, lr=1e-3,
                       ensemble_count=2, start_tta_at_epoch=1)


@pytest.fixture(scope="module")
def jax_trajectory(setup):
    """The JAX package's chunk of both members (vmapped on one device)."""
    params, vols, shapes, labels = setup
    params = _biased(params, 7)
    ref = jax_tta_one_volume(jax_model(), JaxPlan(**TRAJECTORY_PLAN), params,
                             jnp.asarray(vols), jnp.asarray(shapes), IDX3,
                             IDX3, jax.random.PRNGKey(1),
                             labels_padded=jnp.asarray(labels))
    return params, ref


@pytest.fixture(scope="module", params=[1, None],
                ids=["chunk_1", "chunk_all"])
def trajectories(setup, jax_trajectory, request):
    """The port's members one after another (`ensemble_chunk` 1) or side
    by side (a chunk of all, the JAX package's default)."""
    _, vols, shapes, labels = setup
    params, ref = jax_trajectory
    got = tta_one_volume(port_model(), TTAPlan(**TRAJECTORY_PLAN),
                         port_net(params), torch.from_numpy(vols), shapes,
                         IDX3, IDX3, JaxDraws(jax.random.PRNGKey(1), n_acc=2),
                         labels_padded=torch.from_numpy(labels),
                         ensemble_chunk=request.param)
    return TRAJECTORY_PLAN, params, ref, got


def _unused(name):
    """Entries of a parameter that the loss never reaches: the conv bias
    before InstanceNorm, and the logit channel of class 3 (outside IDX3)."""
    if name.endswith("conv.bias"):
        return np.s_[:]
    if name.startswith("decoder.seg_layers."):
        return np.s_[3]
    return None


def _check_trajectory(plan_kw, params, ref, got, trainer="nnUNetTrainer_GIN"):
    """The port's trajectory against JAX's at the module's tolerances."""
    ref_params, ref_losses, ref_dices = ref
    nets, losses, dices = got
    shape = (plan_kw["epochs"], plan_kw["ensemble_count"])
    assert losses.shape == dices.shape == shape
    np.testing.assert_allclose(losses, np.asarray(ref_losses), rtol=1e-3)
    np.testing.assert_allclose(dices, np.asarray(ref_dices), atol=2e-2)
    assert np.all(np.isfinite(dices))
    trained = plan_kw["epochs"] - plan_kw["start_tta_at_epoch"]
    init = {n: p.detach().numpy()
            for n, p in port_net(params, trainer).named_parameters()}
    decay = (1.0 - plan_kw["lr"] * 0.01) ** trained
    for m, net in enumerate(nets):
        final = {n: p.detach().numpy() for n, p in net.named_parameters()}
        ref = params_from_jax(jax.tree.map(lambda r: np.asarray(r)[m],
                                           ref_params))
        assert sorted(ref) == sorted(final)
        for name, p0 in init.items():
            ref_p = ref[name].numpy()
            ref_dp, got_dp = ref_p - p0, final[name] - p0
            assert np.linalg.norm(ref_dp) > 0, name
            rel = np.linalg.norm(got_dp - ref_dp) / np.linalg.norm(ref_dp)
            assert rel <= 0.05, (name, rel)
            sl = _unused(name)
            if sl is not None:
                for what, p in (("port", final[name]), ("jax", ref_p)):
                    np.testing.assert_allclose(
                        p[sl], decay * p0[sl], rtol=1e-6,
                        err_msg=f"{what} {name}")


def test_tta_one_volume_trajectory_matches_jax(trajectories):
    plan_kw, params, ref, got = trajectories
    _check_trajectory(plan_kw, params, ref, got)


def _biased(params, seed):
    """params with nonzero conv biases (initialized to zero, and unused
    before InstanceNorm), so that their weight decay shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.normal(size=a.shape), a.dtype)
                         if jax.tree_util.keystr(path).endswith(
                             "['conv']['b']") else a), params)


@pytest.mark.parametrize("trainer,intensity", [
    ("nnUNetTrainer_MIND", "none"), ("nnUNetTrainer_GIN_MIND", "both")])
def test_mind_trajectory_matches_jax(setup, trainer, intensity):
    """A MIND model on the default plan, and GIN_MIND with GIN in both
    branches: MIND's noisy descriptor of the 2B patches in every forward,
    and of each evaluation, on JAX's own draws."""
    _, vols, shapes, labels = setup
    params = _biased(jax.jit(jax_model(trainer).init_params)(
        jax.random.PRNGKey(3)), 9)
    plan_kw = dict(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=1, start_tta_at_epoch=1,
                   do_intensity_aug_in=intensity)
    key = jax.random.PRNGKey(4)
    ref = jax_tta_one_volume(jax_model(trainer), JaxPlan(**plan_kw), params,
                             jnp.asarray(vols), jnp.asarray(shapes), IDX3,
                             IDX3, key, labels_padded=jnp.asarray(labels))
    got = tta_one_volume(port_model(trainer), TTAPlan(**plan_kw),
                         port_net(params, trainer), torch.from_numpy(vols),
                         shapes, IDX3, IDX3, JaxDraws(key, n_acc=2),
                         labels_padded=torch.from_numpy(labels))
    _check_trajectory(plan_kw, params, ref, got, trainer)


def test_across_volumes_trajectory_matches_jax():
    """tta_across_all_samples: two volumes of different true shapes in one
    bucket, patches drawn from either, two evaluation repeats per epoch
    (tests/test_tta_engine.py's mixed-shape case, against JAX)."""
    from dg_tta_tpu.core.patches import pad_to_bucket as jax_pad

    rng = np.random.default_rng(5)
    bucket, shapes = (32, 32, 32), [(24, 28, 20), (18, 22, 26)]
    vols, labs = [], []
    for shape in shapes:
        v = synth_volume(rng, shape)
        vols.append(np.asarray(jax_pad(jnp.asarray(v), bucket,
                                       float(v.min()))))
        labs.append(np.asarray(jax_pad(jnp.asarray(synth_labels(shape)),
                                       bucket)))
    vols, labs = np.stack(vols), np.stack(labs)
    shapes = np.asarray(shapes, np.float32)
    plan_kw = dict(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=1, start_tta_at_epoch=0,
                   tta_across_all_samples=True, tta_eval_patches=2)
    params = jax_model().init_params(jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(6)
    _, ref_losses, ref_dices = jax_tta_one_volume(
        jax_model(), JaxPlan(**plan_kw), params, jnp.asarray(vols),
        jnp.asarray(shapes), IDX3, IDX3, key,
        labels_padded=jnp.asarray(labs))
    _, losses, dices = tta_one_volume(
        port_model(), TTAPlan(**plan_kw), port_net(params),
        torch.from_numpy(vols), shapes, IDX3, IDX3, JaxDraws(key, n_acc=2),
        labels_padded=torch.from_numpy(labs))
    np.testing.assert_allclose(losses, np.asarray(ref_losses), rtol=1e-3)
    np.testing.assert_allclose(dices, np.asarray(ref_dices), atol=2e-2)


def test_members_adapt_apart(trajectories):
    _, params, _, (nets, losses, _) = trajectories
    w0 = [n.encoder.stages[0][0].convs[0].conv.weight for n in nets]
    assert not torch.allclose(w0[0], w0[1])
    pre = port_net(params).encoder.stages[0][0].convs[0].conv.weight
    assert not torch.allclose(w0[0], pre)


def _run(plan, setup, **kw):
    params, vols, shapes, labels = setup
    net0 = port_net(params)
    out = tta_one_volume(port_model(), plan, net0, torch.from_numpy(vols),
                         shapes, IDX3, IDX3, TorchDraws(seed=3), **kw)
    return net0, out


def _same(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


def test_have_grad_in_branch_b_is_noop(setup):
    plan = TTAPlan(epochs=2, patches_to_be_accumulated=2, lr=1e-2,
                   ensemble_count=1, have_grad_in="branch_b")
    net0, (nets, losses, _) = _run(plan, setup)
    assert np.all(np.isfinite(losses))
    assert _same(net0, nets[0])


def test_warmup_epoch_does_not_update(setup):
    plan = TTAPlan(epochs=1, patches_to_be_accumulated=2, lr=1e-2,
                   ensemble_count=1, start_tta_at_epoch=1)
    net0, (nets, _, _) = _run(plan, setup)
    assert _same(net0, nets[0])


@pytest.mark.parametrize("mode", ["norms", "encoder"])
def test_released_parameters_only_change(setup, mode):
    plan = TTAPlan(epochs=2, patches_to_be_accumulated=2, lr=1e-2,
                   ensemble_count=1, start_tta_at_epoch=0,
                   params_with_grad=mode)
    net0, (nets, _, _) = _run(plan, setup)
    mask = params_with_grad_mask(net0, mode)
    before = dict(net0.named_parameters())
    changed = 0
    for name, p in nets[0].named_parameters():
        if mask[name]:
            changed += not torch.equal(p, before[name])
        else:
            assert torch.equal(p, before[name]), name
    assert changed > 0


def test_release_masks_match_jax(setup):
    from dg_tta_tpu.tta.engine import params_with_grad_mask as jax_mask

    net = port_net(setup[0])
    for mode in ("all", "norms", "encoder"):
        ref = jax.tree.leaves(jax_mask(setup[0], mode))
        got = params_to_jax({n: torch.tensor(float(v)) for n, v in
                             params_with_grad_mask(net, mode).items()})
        assert [bool(v) for v in jax.tree.leaves(got)] == ref


def test_member_streams_stable_under_subsets(setup):
    """A member's draws depend on its id only: member 1 alone (a resume
    subset) adapts exactly as member 1 of the full ensemble."""
    plan = TTAPlan(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=3, start_tta_at_epoch=0)
    saved = {}
    _, (full, losses_full, _) = _run(
        plan, setup, save_member_fn=lambda m, n, l, d: saved.update({m: l}))
    assert sorted(saved) == [0, 1, 2]
    _, (solo, losses_solo, _) = _run(plan, setup, member_indices=[1])
    np.testing.assert_array_equal(losses_full[:, 1], losses_solo[:, 0])
    assert _same(full[1], solo[0])


def test_gin_and_mind_draws_stable_under_member_subsets(setup):
    """`TorchDraws` draws each member's GIN nets and MIND noise from that
    member's own seeds, after (and without moving) its affine draws: member
    1 alone adapts a GIN_MIND model with GIN in both branches exactly as
    member 1 of the full ensemble."""
    trainer = "nnUNetTrainer_GIN_MIND"
    _, vols, shapes, labels = setup
    params = jax.jit(jax_model(trainer).init_params)(jax.random.PRNGKey(3))
    plan = TTAPlan(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=2, start_tta_at_epoch=0,
                   do_intensity_aug_in="both")
    runs = [tta_one_volume(port_model(trainer), plan,
                           port_net(params, trainer), torch.from_numpy(vols),
                           shapes, IDX3, IDX3, TorchDraws(seed=3),
                           labels_padded=torch.from_numpy(labels),
                           member_indices=ids)
            for ids in (None, [1])]
    (full, losses_full, dices_full), (solo, losses_solo, dices_solo) = runs
    np.testing.assert_array_equal(losses_full[:, 1], losses_solo[:, 0])
    np.testing.assert_array_equal(dices_full[:, 1], dices_solo[:, 0])
    assert _same(full[1], solo[0])

    both = ("branch_a", "branch_b")
    d1, d0 = (TorchDraws(seed=3).patch(m, 0, 0, 1, 1, gin_branches=both)
              for m in (1, 0))
    plain = TorchDraws(seed=3).patch(1, 0, 0, 1, 1)
    assert plain.gin_a is None and plain.gin_b is None
    np.testing.assert_array_equal(plain.noise_b, d1.noise_b)
    noise = d1.mind_noise((2, 4, 4, 4, 12), "cpu")
    assert torch.equal(noise, plain.mind_noise((2, 4, 4, 4, 12), "cpu"))
    assert not torch.equal(noise, d0.mind_noise((2, 4, 4, 4, 12), "cpu"))
    assert not torch.equal(d1.gin_a.layers[0][0], d1.gin_b.layers[0][0])


@pytest.mark.parametrize("change", [dict(engine="split")])
def test_features_of_later_slices_raise(setup, change):
    """The split engine, a TPU dispatch workaround, is not ported: it
    raises, naming ROADMAP's "Not ported" list (patch_group and remat run:
    tests/test_torch_patch_group.py)."""
    plan = TTAPlan(epochs=1, patches_to_be_accumulated=1, ensemble_count=1,
                   **change)
    with pytest.raises(NotImplementedError, match="Not ported"):
        _run(plan, setup)


@pytest.mark.parametrize("env", ["DGTTA_ENGINE"])
def test_driver_knobs_of_later_slices_raise(tmp_path, monkeypatch, env):
    """DGTTA_ENGINE=split raises before anything loads; wandb_mode and
    the other knobs run (tests/test_torch_patch_group.py)."""
    from dg_tta_tpu_torch.tta.driver import tta_main

    plan = TTAPlan(optimized_labels=("background",))
    monkeypatch.setenv(env, "split")
    with pytest.raises(NotImplementedError, match="Not ported"):
        tta_main("run", plan, tmp_path, tmp_path, {"background": (0, 0)},
                 device="cpu")


def test_bf16_adaptation_tracks_f32(setup):
    """DGTTA_COMPUTE_DTYPE=bfloat16: bf16 convs and logits (the warps run
    on bf16), f32 parameters and loss.  Per-epoch losses within 5% of the
    f32 run, the bound of tests/test_unet.py's bf16 forward."""
    params, vols, shapes, _ = setup
    plan = TTAPlan(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=1, start_tta_at_epoch=0)
    out = {}
    for dt in (None, "bfloat16"):
        model = dataclasses.replace(port_model(), compute_dtype=dt)
        nets, losses, _ = tta_one_volume(
            model, plan, port_net(params), torch.from_numpy(vols), shapes,
            IDX3, IDX3, TorchDraws(seed=4))
        assert all(p.dtype == torch.float32 for p in nets[0].parameters())
        out[dt] = losses
    assert np.all(np.isfinite(out["bfloat16"]))
    np.testing.assert_allclose(out["bfloat16"], out[None], rtol=0.05)


def test_bf16_trajectory_tracks_jax_bf16(setup):
    """DGTTA_COMPUTE_DTYPE=bfloat16 in both packages, with the JAX engine's
    own draws: per-epoch losses of the port within 5% of the JAX package's
    bf16 run, the bound of test_bf16_adaptation_tracks_f32 (the two
    frameworks round to bf16 at other places)."""
    params, vols, shapes, labels = setup
    plan_kw = dict(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=1, start_tta_at_epoch=0)
    key = jax.random.PRNGKey(8)
    _, ref_losses, _ = jax_tta_one_volume(
        dataclasses.replace(jax_model(), compute_dtype="bfloat16"),
        JaxPlan(**plan_kw), params, jnp.asarray(vols), jnp.asarray(shapes),
        IDX3, IDX3, key, labels_padded=jnp.asarray(labels))
    nets, losses, _ = tta_one_volume(
        dataclasses.replace(port_model(), compute_dtype="bfloat16"),
        TTAPlan(**plan_kw), port_net(params), torch.from_numpy(vols), shapes,
        IDX3, IDX3, JaxDraws(key, n_acc=2),
        labels_padded=torch.from_numpy(labels))
    assert all(p.dtype == torch.float32 for p in nets[0].parameters())
    assert losses.shape == (2, 1) and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, np.asarray(ref_losses), rtol=0.05)


# A deformable plan's field noise is drawn at patch // 5 and smoothed three
# times by a 5^3 window: on the 16^3 patch (3^3 noise) every window spans
# the whole axis, the field comes out nearly constant and the warps nearly
# the identity, so the deformable tests run at 30^3 (6^3 noise) on a volume
# that holds it.
DPATCH = (30, 30, 30)
DVOL_SHAPE = (40, 44, 36)


@pytest.fixture(scope="module")
def dsetup(setup):
    rng = np.random.default_rng(21)
    vols = synth_volume(rng, DVOL_SHAPE)[None]
    shapes = np.asarray([DVOL_SHAPE], np.float32)
    return setup[0], vols, shapes, synth_labels(DVOL_SHAPE)[None]


def _jax_patch_loss_grid(model, params, imgs, k_aug, deformable, exact):
    """The JAX engine's patch loss (engine.py:244-389) from its public
    pieces, with the branch warps as grids: a deformable plan's fields
    (engine.py:281-306) or the affine ones, and the unwarp's fast adjoint
    (`_warp_with_inverse`) or, with `exact`, autodiff of the exact
    resample (engine.py:330-333)."""
    B, patch = imgs.shape[0], model.patch_size
    ka, kb, _ = jax.random.split(k_aug, 3)
    ident = jgrid.identity_grid(patch, align_corners=False)
    xs, ctxs = [], []
    for k in (ka, kb):
        _, k_sp = jax.random.split(k)
        if deformable:
            disp, disp_inv = jax_disp_field(k_sp, B, patch, factor=0.5,
                                            interpolation_factor=5)
            grid = tuple(i[None] + d for i, d in zip(ident, disp))
            grid_inv = tuple(i[None] + d for i, d in zip(ident, disp_inv))
            adj = jnp.ones((B,))
        else:
            theta, theta_inv = jax_rand_affine(k_sp, B)
            grid = jgrid.affine_grid(theta, patch)
            grid_inv = jgrid.affine_grid(theta_inv, patch)
            R = theta[:, :, :3]
            adj = jnp.abs(jnp.einsum("bi,bi->b", R[:, :, 0],
                                     jnp.cross(R[:, :, 1], R[:, :, 2])))
        xf = jnp.moveaxis(imgs, -1, 1).reshape(B, 1, -1)
        xf = jgrid.grid_sample_flat(xf, patch, grid, padding_mode="border")
        xs.append(jnp.moveaxis(xf.reshape(B, 1, *patch), 1, -1))
        ctxs.append((grid, grid_inv, adj))
    logits = model.apply(params, jnp.concatenate(xs), head_channel_idx=IDX3)
    lf = jnp.moveaxis(logits, -1, 1).reshape(2 * B, 3, -1)
    outs = []
    for i, (g, gi, adj) in enumerate(ctxs):
        part = lf[i * B:(i + 1) * B]
        outs.append(jgrid.grid_sample_flat(part, patch, gi,
                                           padding_mode="zeros")
                    if exact else jax_wwi(part, gi, g, adj, patch, "zeros"))
    return jax_loss_flat(*outs, start_class=1)


def _port_grads(net):
    return params_to_jax({n: (p.grad if p.grad is not None
                              else torch.zeros_like(p))
                          for n, p in net.named_parameters()})


@pytest.mark.parametrize("spatial,exact", [
    ("deformable", False), ("deformable", True), ("affine", True)])
def test_one_patch_step_matches_jax_grid_warps(setup, dsetup, spatial,
                                               exact):
    """One patch step of a deformable plan (the fields from JAX's own
    noise, their warps, the unwarp by the inverse field with the fast
    adjoint), and of the exact warp gradient (DGTTA_EXACT_WARP_GRAD: the
    scatter-add adjoint) on either plan, against JAX's value and gradient
    at the module's one-step tolerances."""
    deformable = spatial == "deformable"
    patch = DPATCH if deformable else PATCH
    params, vols, shapes, _ = dsetup if deformable else setup
    draws = JaxDraws(jax.random.PRNGKey(1), n_acc=2)
    k_patch, k_aug = jax.random.split(draws.step_key(0, 1, 1))
    imgs, _ = jax_extract_batch(k_patch, jnp.asarray(vols),
                                jnp.asarray(shapes), patch, 1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, x: _jax_patch_loss_grid(jax_model(patch=patch), p, x,
                                          k_aug, deformable, exact)))(
        params, imgs)

    net = port_net(params)
    fns = make_tta_functions(port_model(patch=patch),
                             TTAPlan(spatial_aug_type=spatial), IDX3, IDX3,
                             exact_warp_grad=exact)
    loss = fns.patch_loss(net, draws.patch(0, 1, 1, 1, 1),
                          torch.from_numpy(np.array(imgs)))
    loss.backward()
    assert float(ref_loss) > 1e-3
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref_grads)[0],
                            jax.tree.leaves(_port_grads(net))):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_deformable_trajectory_matches_jax(dsetup):
    """A deformable plan's `tta_one_volume` against JAX's, at the module's
    trajectory tolerances: fields, warps and unwarps from JAX's own
    draws, one warm-up and one trained epoch."""
    params, vols, shapes, labels = dsetup
    params = _biased(params, 7)
    plan_kw = dict(epochs=2, patches_to_be_accumulated=2, lr=1e-3,
                   ensemble_count=1, start_tta_at_epoch=1,
                   spatial_aug_type="deformable")
    key = jax.random.PRNGKey(1)
    ref = jax_tta_one_volume(jax_model(patch=DPATCH), JaxPlan(**plan_kw),
                             params, jnp.asarray(vols), jnp.asarray(shapes),
                             IDX3, IDX3, key,
                             labels_padded=jnp.asarray(labels))
    got = tta_one_volume(port_model(patch=DPATCH), TTAPlan(**plan_kw),
                         port_net(params), torch.from_numpy(vols), shapes,
                         IDX3, IDX3, JaxDraws(key, n_acc=2),
                         labels_padded=torch.from_numpy(labels))
    assert np.all(got[1] > 1e-3)
    _check_trajectory(plan_kw, params, ref, got)


def test_fast_warp_adjoint_close_to_exact_deformable(dsetup):
    """The inverse-field adjoint of a deformable unwarp (no |det| factor)
    against the exact scatter-add adjoint: the gradients of one patch step
    on the same draws point the same way (cosine > 0.95, the bound of
    tests/test_tta_engine.py::test_fast_warp_adjoint_close_to_exact), but
    are not the same; the loss is (the forward does not change)."""
    params, vols, shapes, _ = dsetup
    plan = TTAPlan(spatial_aug_type="deformable")
    d = TorchDraws(seed=5).patch(0, 0, 0, 1, 1)
    imgs, _ = extract_batch(d.vol_idx, d.uniforms, torch.from_numpy(vols),
                            shapes, DPATCH, 1)
    out = {}
    for exact in (False, True):
        net = port_net(params)
        fns = make_tta_functions(port_model(patch=DPATCH), plan, IDX3, IDX3,
                                 exact_warp_grad=exact)
        loss = fns.patch_loss(net, d, imgs)
        loss.backward()
        out[exact] = (loss.item(), np.concatenate(
            [np.ravel(g) for g in jax.tree.leaves(_port_grads(net))]))
    assert out[True][0] == out[False][0] > 1e-3
    e, f = out[True][1], out[False][1]
    cos = float(e @ f / (np.linalg.norm(e) * np.linalg.norm(f)))
    assert cos > 0.95, cos
    assert not np.array_equal(e, f)


def test_affine_draws_unchanged_by_the_field_noise():
    """The field noise is drawn on demand from seeds of its own: an affine
    plan's draws are still those of the step generator, in their order
    (volume, offsets, affine noise of a, of b, then GIN's nets), and the
    MIND noise keeps its seed.  Each branch's field noise is its own."""
    src = TorchDraws(seed=3, sample_index=1)
    d = src.patch(2, 1, 0, 2, 1, gin_branches=("branch_b",))
    g = torch.Generator().manual_seed(src._seed(2, 1, "step", 0))
    assert np.array_equal(d.vol_idx,
                          torch.randint(0, 2, (1,), generator=g).numpy())
    assert np.array_equal(d.uniforms, torch.rand((1, 3), generator=g).numpy())
    for noise in (d.noise_a, d.noise_b):
        assert np.array_equal(noise, torch.randn((1, 3, 4), generator=g)
                              .numpy())
    from dg_tta_tpu_torch.ops.gin import draw_gin
    ref_gin = draw_gin(g, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(d.gin_b.layers), jax.tree.leaves(ref_gin.layers)))
    assert torch.equal(d.gin_b.alphas, ref_gin.alphas)
    mind = d.mind_noise((1, 4, 4, 4, 12), "cpu")
    shape = (1, 3, 3, 3, 3)
    fa, fb = d.field_a(shape, "cpu"), d.field_b(shape, "cpu")
    assert torch.equal(mind, src._normal(src._seed(2, 1, "step", 0, "mind"),
                                         (1, 4, 4, 4, 12), "cpu"))
    assert torch.equal(fa, d.field_a(shape, "cpu"))
    assert not torch.equal(fa, fb)
    assert not torch.equal(fa, mind.flatten()[:81].reshape(shape))
