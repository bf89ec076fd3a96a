"""`patch_group` and `remat` in the port's TTA engine and driver, wandb
logging, the loss plots and the orientation views, against the JAX
package on the tiny models of tests/test_torch_engine.py.

Tolerances, f32 on the CPU:
* one `epoch_train` at `patch_group` g against the JAX package's
  `make_tta_functions(..., patch_group=g)` on its own grouped draws
  (`JaxDraws(key, n_acc // g)`): the loss 1e-4 relative (computed
  before the update, as one patch step's at 1e-5 in
  tests/test_torch_engine.py, but a deformable plan's fields amplify f32
  rounding ~100x: 1.3e-5 measured on the 30^3 patch) and each parameter's
  update within 5% of JAX's in norm (AdamW's first step is ~lr x
  sign(gradient)), the untouched ones decayed by exactly (1 - lr x weight
  decay), 1e-6 relative;
* the port grouped against the port ungrouped on `TorchDraws` (whose
  grouped draws are the ungrouped ones concatenated): per-epoch losses
  1e-5 relative and each parameter's update within 1e-3 of its norm (the
  same patches in one batch: only the order of the sums differs, 3e-6
  measured), Dices 2e-2 as in the engine tests;
* `remat` against no `remat`: the recompute runs the same operations on
  the same inputs, so the loss and every gradient are bit for bit equal
  on the CPU.
"""

import dataclasses
import importlib.machinery
import json
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.tta.engine import make_tta_functions as jax_make_tta_functions
from dg_tta_tpu.tta.plan import TTAPlan as JaxPlan
from dg_tta_tpu_torch.models.convert import params_from_jax
from dg_tta_tpu_torch.tta.draws import TorchDraws, group_draws
from dg_tta_tpu_torch.tta.engine import (make_optimizer, make_tta_functions,
                                         tta_one_volume)
from dg_tta_tpu_torch.tta.plan import TTAPlan
from tests.test_pipeline_e2e import workspace  # noqa: F401
from tests.test_torch_engine import (DPATCH, DVOL_SHAPE, IDX3,  # noqa: F401
                                     VOL_SHAPE, JaxDraws, _biased,
                                     _two_torch_threads, _unused, jax_model,
                                     port_model, port_net, synth_labels,
                                     synth_volume)
from tests.test_torch_pipeline import ARGS, PLAN_DIR, RESULTS_DIR

LR = 1e-3


def _volume(shape, seed):
    vols = synth_volume(np.random.default_rng(seed), shape)[None]
    return vols, np.asarray([shape], np.float32)


# (trainer, plan changes, patch, volume shape, patches, patch_group): an
# affine plan in two steps of 2 and one step of 4, a MIND model with GIN
# in both branches, and a deformable plan at a 30^3 patch
PARITY_CASES = {
    "affine-2": ("nnUNetTrainer_GIN", {}, None, VOL_SHAPE, 4, 2),
    "affine-4": ("nnUNetTrainer_GIN", {}, None, VOL_SHAPE, 4, 4),
    "gin_mind-2": ("nnUNetTrainer_GIN_MIND",
                   dict(do_intensity_aug_in="both"), None, VOL_SHAPE, 2, 2),
    "deformable-2": ("nnUNetTrainer_GIN",
                     dict(spatial_aug_type="deformable"), DPATCH,
                     DVOL_SHAPE, 2, 2),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_grouped_epoch_train_matches_jax(case):
    """One trained epoch at `patch_group` g: its loss and the updated
    parameters against the JAX engine's `epoch_train` at the same g, on
    the JAX engine's grouped draws."""
    trainer, changes, patch, vol_shape, acc, g = PARITY_CASES[case]
    patch = patch or (16, 16, 16)
    plan_kw = dict(patches_to_be_accumulated=acc, lr=LR, **changes)
    params = _biased(jax.jit(jax_model(trainer, patch).init_params)(
        jax.random.PRNGKey(3)), 9)
    vols, shapes = _volume(vol_shape, 21)
    draws = JaxDraws(jax.random.PRNGKey(4), n_acc=acc // g)
    k_tr = jax.random.fold_in(draws._epoch_key(0, 1), 0)

    net = port_net(params, trainer)
    init = {n: p.detach().clone().numpy() for n, p in net.named_parameters()}
    jf = jax_make_tta_functions(jax_model(trainer, patch), JaxPlan(**plan_kw),
                                IDX3, IDX3, patch_group=g)
    own = jax.tree.map(jnp.array, params)   # epoch_train donates its input
    ref_params, _, ref_loss = jf.epoch_train(own, jf.init_opt_state(own),
                                             k_tr, jnp.asarray(vols),
                                             jnp.asarray(shapes))

    plan = TTAPlan(**plan_kw)
    fns = make_tta_functions(port_model(trainer, patch), plan, IDX3, IDX3,
                             patch_group=g)
    loss = fns.epoch_train(net, make_optimizer(plan, list(net.parameters())),
                           draws, 0, 1, torch.from_numpy(vols), shapes)
    assert float(ref_loss) > 1e-3
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * float(ref_loss)
    ref = params_from_jax(jax.tree.map(np.asarray, ref_params))
    for name, p in net.named_parameters():
        ref_dp, got_dp = ref[name].numpy() - init[name], \
            p.detach().numpy() - init[name]
        assert np.linalg.norm(ref_dp) > 0, name
        rel = np.linalg.norm(got_dp - ref_dp) / np.linalg.norm(ref_dp)
        assert rel <= 0.05, (name, rel)
        sl = _unused(name)
        if sl is not None:
            np.testing.assert_allclose(p.detach().numpy()[sl],
                                       (1 - LR * 0.01) * init[name][sl],
                                       rtol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(jax_model().init_params)(jax.random.PRNGKey(0))
    vols, shapes = _volume(VOL_SHAPE, 0)
    return _biased(params, 7), vols, shapes, synth_labels()[None]


def _adapt(setup, draws=None, patch_group=1, **plan_changes):
    params, vols, shapes, labels = setup
    plan = TTAPlan(epochs=3, patches_to_be_accumulated=4, lr=LR,
                   ensemble_count=1, start_tta_at_epoch=1,
                   do_intensity_aug_in="branch_a", **plan_changes)
    return tta_one_volume(port_model(), plan, port_net(params),
                          torch.from_numpy(vols), shapes, IDX3, IDX3,
                          draws or TorchDraws(seed=3),
                          labels_padded=torch.from_numpy(labels),
                          patch_group=patch_group)


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_trajectory_equals_ungrouped(setup, group):
    """GIN in branch a, no MIND: a grouped run adapts on the patches and
    augmentations of the ungrouped one (`TorchDraws`), in fewer, larger
    steps, and follows the same trajectory."""
    ref_nets, ref_losses, ref_dices = _adapt(setup)
    nets, losses, dices = _adapt(setup, patch_group=group)
    assert losses.shape == ref_losses.shape == (3, 1)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(dices, ref_dices, atol=2e-2)
    init = dict(port_net(setup[0]).named_parameters())
    for (name, a), b in zip(ref_nets[0].named_parameters(),
                            nets[0].parameters()):
        ref_dp = (a - init[name]).detach().numpy()
        got_dp = (b - init[name]).detach().numpy()
        assert np.linalg.norm(ref_dp) > 0, name
        rel = np.linalg.norm(got_dp - ref_dp) / np.linalg.norm(ref_dp)
        assert rel <= 1e-3, (name, rel)


def test_grouped_draws_concatenate_the_ungrouped_ones():
    """Group-g step s of `TorchDraws` is its ungrouped steps g*s .. g*s+g-1
    in the forward's layout: the per-patch arrays and GIN nets of each
    group in turn, the MIND noise's a-branch rows of every group before
    the b-branch rows, each branch's field noise group by group."""
    src = TorchDraws(seed=2)
    both = ("branch_a", "branch_b")
    d = src.patch(1, 0, 1, 2, 2, gin_branches=both, group=3)
    parts = [src.patch(1, 0, 3 + i, 2, 2, gin_branches=both)
             for i in range(3)]
    for key in ("vol_idx", "uniforms", "noise_a", "noise_b"):
        np.testing.assert_array_equal(
            getattr(d, key), np.concatenate([getattr(p, key) for p in parts]))
    for (k, s), *ref in zip(d.gin_b.layers, *(p.gin_b.layers for p in parts)):
        assert torch.equal(k, torch.cat([r[0] for r in ref]))
        assert torch.equal(s, torch.cat([r[1] for r in ref]))
    assert torch.equal(d.gin_a.alphas, torch.cat([p.gin_a.alphas
                                                  for p in parts]))
    mind = d.mind_noise((12, 4, 4, 4, 12), "cpu")
    rows = [p.mind_noise((4, 4, 4, 4, 12), "cpu") for p in parts]
    assert torch.equal(mind, torch.cat([r[:2] for r in rows]
                                       + [r[2:] for r in rows]))
    field = d.field_b((6, 3, 3, 3, 3), "cpu")
    assert torch.equal(field, torch.cat([p.field_b((2, 3, 3, 3, 3), "cpu")
                                         for p in parts]))
    assert group_draws(parts[:1]) is parts[0]


@pytest.mark.parametrize("group", [3, 0])
def test_patch_group_must_divide_the_patches(setup, group):
    with pytest.raises(ValueError, match="patch_group"):
        make_tta_functions(port_model(), TTAPlan(patches_to_be_accumulated=4),
                           IDX3, IDX3, patch_group=group)
    if group:
        with pytest.raises(ValueError, match="patch_group"):
            _adapt(setup, patch_group=group)


class _Recording:
    """A draw source that records every `patch` call and every noise
    tensor its draws hand out."""

    def __init__(self, source):
        self.source, self.patch_calls, self.noise = source, 0, []

    def patch(self, *args, **kw):
        self.patch_calls += 1
        d = self.source.patch(*args, **kw)

        def rec(fn):
            def draw(shape, device):
                out = fn(shape, device)
                self.noise.append(out)
                return out
            return draw

        return dataclasses.replace(d, mind_noise=rec(d.mind_noise),
                                   field_a=rec(d.field_a),
                                   field_b=rec(d.field_b))

    def __getattr__(self, name):
        return getattr(self.source, name)


@pytest.mark.parametrize("trainer,spatial,exact", [
    ("nnUNetTrainer_GIN", "affine", False),
    ("nnUNetTrainer_GIN", "affine", True),
    ("nnUNetTrainer_GIN", "deformable", True),
    ("nnUNetTrainer_GIN_MIND", "affine", False)])
def test_remat_gradient_equals_plain(trainer, spatial, exact):
    """One grouped patch step with `remat`: the loss and every gradient
    bit for bit those without it, with the fast or the exact unwarp
    adjoint; the recompute asks the source for no new draws and its noise
    callables give the first call's tensors again.  (The deformable case
    runs at 16^3: its field is near the identity there, which does not
    matter for a recompute.)"""
    vols, shapes = _volume(VOL_SHAPE, 5)
    model = port_model(trainer)
    state = model.init_params(torch.Generator().manual_seed(3))
    plan = TTAPlan(spatial_aug_type=spatial, patches_to_be_accumulated=2,
                   do_intensity_aug_in="both")
    out = {}
    for remat in (False, True):
        net = model.build_network(state, device="cpu")
        fns = make_tta_functions(model, plan, IDX3, IDX3,
                                 exact_warp_grad=exact, patch_group=2,
                                 remat=remat)
        src = _Recording(TorchDraws(seed=5))
        both = ("branch_a", "branch_b")
        d = src.patch(0, 0, 0, 1, 1, gin_branches=both, group=2)
        loss = fns.draw_and_loss(net, d, torch.from_numpy(vols), shapes)
        n_forward = len(src.noise)
        loss.backward()
        out[remat] = loss.item(), [p.grad for p in net.parameters()]
        assert src.patch_calls == 1
        # one draw of each branch's field noise (deformable), one of the
        # forward's MIND noise
        assert n_forward == (2 * (spatial == "deformable")
                             + ("MIND" in trainer))
        if remat:
            # the backward recomputed both branches on the same noise
            assert len(src.noise) == 2 * n_forward
            for a, b in zip(src.noise[:n_forward], src.noise[n_forward:]):
                assert torch.equal(a, b)
        else:
            assert len(src.noise) == n_forward
    assert out[True][0] == out[False][0]
    for a, b in zip(out[False][1], out[True][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_split_engine_still_raises(setup):
    with pytest.raises(NotImplementedError, match="Not ported"):
        _adapt(setup, engine="split")


def _prepare(root, **changes):
    from dg_tta_tpu_torch.cli.main import main as port_cli

    port_cli(["prepare_tta", *ARGS])
    plan_path = root / PLAN_DIR / "tta_plan.json"
    plan = json.loads(plan_path.read_text())
    plan.update({"epochs": 1, "patches_to_be_accumulated": 2,
                 "ensemble_count": 1, **changes})
    plan_path.write_text(json.dumps(plan))
    return port_cli


class _Stop(Exception):
    pass


@pytest.mark.parametrize("plan_changes,env,expected", [
    ({}, {}, (1, False)),
    (dict(patch_group=2, remat=True), {}, (2, True)),
    (dict(patch_group=2, remat=True), {"DGTTA_PATCH_GROUP": "1",
                                       "DGTTA_REMAT": "0"}, (1, False)),
    ({}, {"DGTTA_PATCH_GROUP": "2", "DGTTA_REMAT": "1"}, (2, True))])
def test_driver_hands_patch_group_and_remat_to_the_engine(
        workspace, monkeypatch, plan_changes, env, expected):  # noqa: F811
    """The plan's patch_group and remat reach `tta_one_volume`, the
    environment overriding them as in the JAX driver."""
    from dg_tta_tpu_torch.tta import driver

    root, _, _ = workspace
    cli = _prepare(root, **plan_changes)
    seen = []

    def record(*args, **kw):
        seen.append((kw["patch_group"], kw["remat"]))
        raise _Stop

    monkeypatch.setattr(driver, "tta_one_volume", record)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(_Stop):
        cli(["run_tta", *ARGS, "--device", "cpu"])
    assert seen == [expected]


@pytest.mark.parametrize("where", ["plan", "env"])
def test_driver_split_engine_raises(workspace, monkeypatch,  # noqa: F811
                                    where):
    root, _, _ = workspace
    cli = _prepare(root, **({"engine": "split"} if where == "plan" else {}))
    if where == "env":
        monkeypatch.setenv("DGTTA_ENGINE", "split")
    with pytest.raises(NotImplementedError, match="Not ported"):
        cli(["run_tta", *ARGS, "--device", "cpu"])


def _fake_wandb():
    """A `wandb` module whose `init` opens a run and whose `log` records
    (data, step)."""
    fake = types.ModuleType("wandb")
    fake.__spec__ = importlib.machinery.ModuleSpec("wandb", None)
    fake.logged, fake.inits, fake.run = [], [], None

    class Run:
        disabled = False

        def __enter__(self):
            fake.run = self
            return self

        def __exit__(self, *exc):
            fake.run = None

    def init(**kw):
        fake.inits.append(kw)
        return Run()

    fake.init = init
    fake.finish = lambda: None
    fake.log = lambda data, step=None: fake.logged.append((data, step))
    return fake


def test_wandb_log_without_wandb_or_run_is_a_noop(monkeypatch):
    from dg_tta_tpu_torch.obs import wandb_log as wl

    monkeypatch.setitem(sys.modules, "wandb", None)
    assert wl.wandb_module() is None and not wl.wandb_run_is_available()
    wl.wandb_log({"x": 1.0})
    assert wl.wandb_run(None, lambda **kw: kw["a"], a=3) == 3

    fake = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    wl.wandb_log({"x": 1.0}, step=2)          # no active run
    assert fake.logged == [] and not wl.wandb_run_is_available()
    plan = TTAPlan(wandb_mode="offline")
    out = wl.wandb_run("proj", lambda **kw: wl.wandb_log({"x": 2.0}, step=5)
                       or "done", plan=plan, run_name="r")
    assert out == "done" and fake.logged == [({"x": 2.0}, 5)]
    assert fake.inits == [dict(project="proj", name="r", mode="offline",
                               config=plan.to_dict())]


def test_global_idx_matches_jax():
    from dg_tta_tpu.tta.config import get_global_idx as jax_idx
    from dg_tta_tpu_torch.tta.config import get_global_idx

    for parts in ([(0, 1), (2, 3), (11, 12)], [(3, 10), (1, 3), (0, 150)],
                  [(5, 7)]):
        assert get_global_idx(parts) == jax_idx(parts)


@pytest.mark.parametrize("plots", [True, False])
def test_run_tta_logs_and_plots(workspace, monkeypatch, capsys,  # noqa: F811
                                plots):
    """A grouped `run_tta` through the CLI, in a wandb run (a fake module):
    per member and epoch the loss and Dice at the reference's global step,
    per bucket the mean Dice, and beside each member's results JSON the
    JAX package's loss plot; without matplotlib, one line and no plot."""
    root, _, _ = workspace
    cli = _prepare(root, patch_group=2, wandb_mode="offline", epochs=2)
    fake = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    if not plots:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    cli(["run_tta", *ARGS, "--device", "cpu"])
    (run_dir,) = list((root / RESULTS_DIR).iterdir())
    out = capsys.readouterr().out
    skipped = [line for line in out.splitlines() if "matplotlib" in line]
    assert len(skipped) == (0 if plots else 1)
    for smp, case in enumerate(("caseA", "caseB")):
        stem = run_dir / "tta_outputTs" / f"{case}__ensemble_idx_0_tta_results"
        res = json.loads(stem.with_suffix(".json").read_text())
        assert stem.with_suffix(".png").is_file() == plots
        for ep in range(2):
            # (sample, member, epoch) packed as one digit each
            (data, step), = [(d, s) for d, s in fake.logged
                             if f"losses/loss__{case}" in d
                             and s == 100 * smp + ep]
            assert data[f"losses/loss__{case}"] == pytest.approx(
                res["losses"][ep])
    assert [d for d, _ in fake.logged if "scores/tta_dice_mean_Ts" in d]
    assert len(fake.inits) == 1 and fake.run is None


def test_plot_run_results_writes_the_jax_file_name(tmp_path):
    from dg_tta_tpu.obs.plots import plot_run_results as jax_plot
    from dg_tta_tpu_torch.obs.plots import plot_run_results

    losses, dices = [0.3, 0.2, 0.25], [0.5, float("nan"), 0.7]
    (tmp_path / "jax").mkdir()
    ref = jax_plot(tmp_path / "jax", "tta_outputTs/case", 1, losses, dices)
    got = plot_run_results(tmp_path, "tta_outputTs/case", 1, losses, dices)
    assert got.name == ref.name == "case__ensemble_idx_1_tta_results.png"
    assert got.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_views(tmp_path, monkeypatch):
    from dg_tta_tpu.obs.views import plane_grid as jax_plane_grid
    from dg_tta_tpu_torch import resources
    from dg_tta_tpu_torch.data.io import write_image
    from dg_tta_tpu_torch.obs import views

    vol = np.random.default_rng(0).normal(size=(9, 14, 21)).astype(
        np.float32)
    for n in (4, 3):
        got, ref = views.plane_grid(vol, n), jax_plane_grid(vol, n)
        assert got.keys() == ref.keys()
        for ax in got:
            np.testing.assert_array_equal(got[ax], ref[ax])
    views.show_planes(vol, "v", save_path=tmp_path / "planes.png")
    assert (tmp_path / "planes.png").read_bytes()[:4] == b"\x89PNG"
    write_image(tmp_path / "img.nii.gz", vol[None],
                {"spacing": (1.0, 1.5, 2.0)})
    views.show_image_file(tmp_path / "img.nii.gz",
                          save_path=tmp_path / "file.png")
    assert (tmp_path / "file.png").is_file()

    monkeypatch.setattr(resources, "RESOURCES", tmp_path / "res")
    with pytest.raises(FileNotFoundError,
                       match=str(tmp_path / "res" / "TS104_input_view.png")):
        views.show_ts104_reference_image()
    (tmp_path / "res").mkdir()
    import matplotlib.image
    matplotlib.image.imsave(tmp_path / "res" / "TS104_input_view.png",
                            np.zeros((4, 4)))
    views.show_ts104_reference_image(save_path=tmp_path / "ts104.png")
    assert (tmp_path / "ts104.png").is_file()
    with pytest.raises(ValueError):
        views.show_planes(vol[0])
