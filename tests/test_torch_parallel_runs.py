"""The port's whole runs over several processes on the CPU (gloo, two
ranks): data-parallel `run_pretraining(num_devices=2)` against the
one-process run, and resumed; `run_tta --num_devices 2` against the
one-process run; the driver's default `ensemble_chunk`.

Tolerances: the data-parallel run's `checkpoint_final.npz` within the
data-parallel step's tolerance of the one-process run's (rtol 1e-4 /
atol 1e-6, tests/test_torch_parallel_shards.py), its logged losses 1e-5
relative, its validation pseudo-Dice 2e-3 absolute (two steps' rounding
may flip a voxel's argmax); a resumed data-parallel run logs and ends on
what the uninterrupted one does, bit for bit (the same ranks, the same
sums); `run_tta`'s members over two ranks equal the one-process run's to
rtol 1e-5 / atol 1e-6 and its segmentations voxel for voxel.
"""

import json
import sys

import numpy as np
import pytest
import torch

from dg_tta_tpu_torch.data.nifti import read_nifti
from dg_tta_tpu_torch.models.convert import load_flat_npz
from dg_tta_tpu_torch.train import pretrain
from dg_tta_tpu_torch.tta import driver
from dg_tta_tpu_torch.tta.config import get_global_idx
from dg_tta_tpu_torch.tta.plan import TTAPlan
from tests.test_pipeline_e2e import workspace  # noqa: F401
from tests.test_torch_parallel import \
    _one_thread_and_a_timeout  # noqa: F401  (the module fixture)
from tests.test_torch_patch_group import _fake_wandb, _prepare
from tests.test_torch_pipeline import ARGS, RESULTS_DIR
from tests.test_torch_train import _log, _mini_plans, mini_raw  # noqa: F401


@pytest.fixture
def results_at(mini_raw, tmp_path, monkeypatch):  # noqa: F811
    """tests/test_torch_train.py's `workspace`: a fresh results and
    preprocessed root by name."""
    def at(name):
        root = tmp_path / name
        (root / "results").mkdir(parents=True)
        monkeypatch.setenv("nnUNet_raw", str(mini_raw.parent))
        monkeypatch.setenv("nnUNet_results", str(root / "results"))
        monkeypatch.setenv("nnUNet_preprocessed", str(root / "pre"))
        return root
    return at


def _pretrain_kw(raw):
    return dict(fold=0, trainer_name="nnUNetTrainer_GIN_MIND",
                iters_per_epoch=2, val_iters_per_epoch=2,
                plans=_mini_plans(raw), batch_size=2, verbose=False,
                device="cpu", seed=5, num_epochs=2)


def test_data_parallel_pretraining_matches_one_process_and_resumes(
        mini_raw, results_at):  # noqa: F811
    kw = _pretrain_kw(mini_raw)
    results_at("one")
    one = pretrain.run_pretraining("903", **kw)
    results_at("dp")
    dp = pretrain.run_pretraining("903", num_devices=2, **kw)
    a = load_flat_npz(dp / "checkpoint_final.npz")
    b = load_flat_npz(one / "checkpoint_final.npz")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    log_dp, log_one = _log(dp), _log(one)
    assert [e["epoch"] for e in log_dp] == [0, 1]
    for e, f in zip(log_dp, log_one):
        assert abs(e["loss"] - f["loss"]) <= 1e-5 * abs(f["loss"])
        assert abs(e["val_pseudo_dice"] - f["val_pseudo_dice"]) <= 2e-3
        assert e["lr"] == f["lr"]
    state = json.loads((dp / "training_state.json").read_text())
    assert state["epoch"] == 1 and state["seed"] == 5

    # the first epoch alone (its learning rate is the 2-epoch run's:
    # poly_lr(lr, 0, n) = lr), then resumed to two: the uninterrupted run
    results_at("dp_resumed")
    pretrain.run_pretraining("903", num_devices=2, **{**kw, "num_epochs": 1})
    out = pretrain.run_pretraining("903", num_devices=2,
                                   continue_training=True, **kw)
    assert _log(out) == log_dp
    c = load_flat_npz(out / "checkpoint_final.npz")
    assert all(torch.equal(c[k], a[k]) for k in a)


def test_data_parallel_batch_must_divide(mini_raw, results_at):  # noqa: F811
    results_at("odd")
    with pytest.raises(ValueError, match="divisible"):
        pretrain.run_pretraining("903", num_devices=3,
                                 **_pretrain_kw(mini_raw))
    with pytest.raises(ValueError, match="num_devices"):
        pretrain.run_pretraining("903", num_devices=0,
                                 **_pretrain_kw(mini_raw))


def test_ensemble_chunk_default_follows_the_jax_driver(monkeypatch):
    """dg_tta_tpu/tta/driver.py:255-270: a >= 2^20-voxel patch runs
    min(E, devices) members a chunk on several devices, 1 on one; a
    smaller one all at once (None); `DGTTA_ENSEMBLE_CHUNK` overrides."""
    monkeypatch.delenv("DGTTA_ENSEMBLE_CHUNK", raising=False)

    def chunk(plan, patch, n_dev):
        plan = driver.adaptation_knobs(plan)
        return driver.default_ensemble_chunk(plan, patch, n_dev).ensemble_chunk

    plan = TTAPlan(ensemble_count=3)
    big, small = (112, 112, 128), (64, 64, 64)
    assert chunk(plan, big, 4) == 3
    assert chunk(plan, big, 2) == 2
    assert chunk(plan, big, 1) == 1
    assert chunk(plan, small, 4) is None
    assert driver.adaptation_knobs(plan).ensemble_chunk is None
    kept = TTAPlan(ensemble_count=3, ensemble_chunk=2)
    assert chunk(kept, big, 4) == 2
    monkeypatch.setenv("DGTTA_ENSEMBLE_CHUNK", "1")
    assert chunk(plan, small, 4) == 1
    assert chunk(plan, big, 4) == 1


def test_run_tta_over_two_ranks_matches_one_process(
        workspace, monkeypatch):  # noqa: F811
    """`run_tta --num_devices 2` on the CPU: each rank loads the model and
    adapts one member of each case (the tiny patch's chunk is both
    members), writing its files; the parent logs every member's epochs to
    wandb from them, then predicts and evaluates.  The same members and
    segmentations as the one-process run."""
    root, _, _ = workspace
    cli = _prepare(root, epochs=2, patches_to_be_accumulated=1,
                   ensemble_count=2, wandb_mode="offline")
    fake = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    cli(["run_tta", *ARGS, "--device", "cpu", "--num_devices", "2"])
    (sharded,) = list((root / RESULTS_DIR).iterdir())
    cli(["run_tta", *ARGS, "--device", "cpu"])
    (one,) = [d for d in (root / RESULTS_DIR).iterdir() if d != sharded]
    timings = [json.loads((d / "timings.json").read_text())
               for d in (sharded, one)]
    assert [t["ranks"] for t in timings] == [2, 1]
    assert all("adaptation" in t["phases"] for t in timings)
    bit = True
    for smp, case in enumerate(("caseA", "caseB")):
        for m in range(2):
            stem = f"{case}__ensemble_idx_{m}_tta_"
            a, b = (load_flat_npz(d / "tta_outputTs" / f"{stem}parameters.npz")
                    for d in (sharded, one))
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
                bit &= torch.equal(a[k], b[k])
            res = [json.loads((d / "tta_outputTs" / f"{stem}results.json")
                              .read_text()) for d in (sharded, one)]
            np.testing.assert_allclose(res[0]["losses"], res[1]["losses"],
                                       rtol=1e-5, atol=1e-6)
            for ep in range(2):
                step = get_global_idx([(smp, 2), (m, 2), (ep, 2)])
                logged = [d for d, s in fake.logged if s == step
                          and f"losses/loss__{case}" in d]
                # once by each run
                assert len(logged) == 2
                for d in logged:
                    assert d[f"losses/loss__{case}"] == pytest.approx(
                        res[0]["losses"][ep], rel=1e-5)
        segs = [read_nifti(d / "tta_outputTs" / f"{case}.nii.gz")[0]
                for d in (sharded, one)]
        np.testing.assert_array_equal(segs[0], segs[1])
    print(f"run_tta members over 2 ranks bit-equal to one process: {bit}")
