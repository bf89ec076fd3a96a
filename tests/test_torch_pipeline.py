"""The port's `run_tta` against the JAX package's, end to end through
both CLIs, on the workspace of tests/test_pipeline_e2e.py.

The JAX CLI prepares the plan and runs a tiny `run_tta` (adaptation with
two members, inference, evaluation).  The port's CLI then resumes that run
on the CPU: every member file exists, so it skips adaptation and runs
inference and evaluation from the same member `.npz` files.  Its logits
match the JAX logits to the f32 tolerance of tests/test_sliding_window.py
(1e-4) and its per-class Dice to 1e-3.  The port's own run adapts its
members from scratch and resumes without re-adapting
(tests/test_torch_engine.py holds its adaptation against the JAX
engine's).
"""

import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.test_pipeline_e2e import TRAINER, workspace  # noqa: F401

PLAN_DIR = ("plans/Pretrained_Dataset901_MiniSrc_at_Dataset902_MiniTgt/"
            f"{TRAINER}__3d_fullres/fold_0")
RESULTS_DIR = ("results/Pretrained_Dataset901_MiniSrc_at_Dataset902_MiniTgt/"
               f"{TRAINER}__3d_fullres/fold_0")
ARGS = ["901", "902", "--pretrainer", TRAINER, "--pretrainer_config",
        "3d_fullres", "--pretrainer_fold", "0"]


def _jax_prepare_and_run(root):
    from dg_tta_tpu.cli.main import main as jax_cli

    jax_cli(["prepare_tta", *ARGS])
    plan_path = root / PLAN_DIR / "tta_plan.json"
    plan = json.loads(plan_path.read_text())
    plan.update(epochs=1, patches_to_be_accumulated=1, ensemble_count=2)
    plan_path.write_text(json.dumps(plan))
    jax_cli(["run_tta", *ARGS])
    (run_dir,) = list((root / RESULTS_DIR).iterdir())
    return run_dir


def _member_file(run_dir, case, i):
    return run_dir / "tta_outputTs" / f"{case}__ensemble_idx_{i}_tta_parameters.npz"


def _jax_logits(run_dir, raw, case, n_members):
    """The JAX package's inference logits of `case` from the run's members,
    and the preprocessed volume they were computed on."""
    from dg_tta_tpu.infer.sliding_window import predict_volume
    from dg_tta_tpu.models.convert import flat_npz_to_params
    from dg_tta_tpu.tta.driver import load_pretrained_bundle, load_tta_data
    from dg_tta_tpu.tta.plan import TTAPlan

    plan = TTAPlan.load(run_dir / "tta_plan.json")
    model, _, plans, _ = load_pretrained_bundle(
        plan.pretrained_weights_filepath)
    (sample,) = [s for s in load_tta_data(plan, raw / "Dataset902_MiniTgt",
                                          plans) if s.case_name == case]
    members = [flat_npz_to_params(_member_file(run_dir, case, i))
               for i in range(n_members)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    vol = np.ascontiguousarray(np.moveaxis(sample.data, 0, -1))
    return np.asarray(predict_volume(model, stacked, jnp.asarray(vol))), vol


def test_port_run_tta_matches_jax_run(workspace):  # noqa: F811
    root, raw, results = workspace
    run_dir = _jax_prepare_and_run(root)
    jax_summary = json.loads((run_dir / "summary_Ts.json").read_text())

    from dg_tta_tpu_torch.cli.main import main as port_cli
    from dg_tta_tpu_torch.data.nifti import read_nifti

    run_no = int(run_dir.name.rsplit("-", 1)[-1])
    summaries = port_cli(["run_tta", *ARGS, "--run_no", str(run_no),
                          "--device", "cpu"])
    port_summary = json.loads((run_dir / "summary_Ts.json").read_text())
    assert summaries["Ts"]["mean"].keys() == port_summary["mean"].keys()
    assert set(port_summary["mean"]) == set(jax_summary["mean"]) == \
        {"0", "1", "2"}
    for lbl, m in jax_summary["mean"].items():
        a, b = m["Dice"], port_summary["mean"][lbl]["Dice"]
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-3, (lbl, a, b)
    timings = json.loads((run_dir / "timings.json").read_text())
    assert timings["device"] == "cpu" and "inference" in timings["phases"]
    for case in ("caseA", "caseB"):
        path = run_dir / "tta_outputTs" / f"{case}.nii.gz"
        pred, _ = read_nifti(path)
        assert pred.shape == (1, 22, 20, 24)
        assert set(np.unique(pred)).issubset({0.0, 1.0, 2.0})

    # logits of both predictors from the same member files
    from dg_tta_tpu_torch.infer.sliding_window import predict_volume
    from dg_tta_tpu_torch.tta.driver import (load_pretrained_bundle,
                                             load_state_dict_file)
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    ref, vol = _jax_logits(run_dir, raw, "caseA", 2)
    plan = TTAPlan.load(run_dir / "tta_plan.json")
    model, _, _, _ = load_pretrained_bundle(plan.pretrained_weights_filepath,
                                            device="cpu")
    nets = [model.build_network(load_state_dict_file(
        _member_file(run_dir, "caseA", i)), device="cpu")
        for i in range(2)]
    got = predict_volume(model, nets, torch.from_numpy(vol))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_port_prepare_tta_writes_the_jax_plan(workspace):  # noqa: F811
    root, _, _ = workspace
    from dg_tta_tpu.cli.main import main as jax_cli
    from dg_tta_tpu_torch.cli.main import main as port_cli

    plan_dir = root / PLAN_DIR
    jax_cli(["prepare_tta", *ARGS])
    jax_files = {p.name: p.read_text() for p in plan_dir.iterdir()}
    port_cli(["prepare_tta", *ARGS])
    port_files = {p.name: p.read_text() for p in plan_dir.iterdir()}
    assert jax_files.keys() == port_files.keys()
    for name in ("tta_plan.json", "Dataset901_MiniSrc_label_mapping.json",
                 "Dataset902_MiniTgt_label_mapping.json"):
        assert json.loads(port_files[name]) == json.loads(jax_files[name])
    assert "import torch" in port_files["modifier_functions.py"]
    assert "jax" not in port_files["modifier_functions.py"]


def test_label_mapping_matches_jax():
    from dg_tta_tpu.core import labels as jl
    from dg_tta_tpu_torch.core import labels as tl

    src = {"background": 0, "liver": 1, "spleen": [2, 5], "kidney": 3}
    tgt = {"background": 0, "spleen": 1, "liver": 2}
    mapping = tl.generate_label_mapping(src, tgt)
    assert mapping == jl.generate_label_mapping(src, tgt)
    opt = ["background", "liver", "spleen"]
    for kind in ("pretrain_labels", "tta_labels"):
        idx = tl.get_map_idxs(mapping, opt, kind)
        np.testing.assert_array_equal(idx, jl.get_map_idxs(mapping, opt, kind))
        lab = np.random.default_rng(0).integers(0, 6, size=(5, 6, 7)).astype(
            np.int32)
        np.testing.assert_array_equal(
            tl.map_label_argmaxed(lab, idx),
            np.asarray(jl.map_label_argmaxed(jnp.asarray(lab), idx)))


def test_port_run_tta_adapts_then_resumes(workspace):  # noqa: F811
    """The port's run_tta adapts every member from scratch on the CPU,
    saves them in the JAX package's format, and a second run of the same
    run number skips adaptation."""
    from dg_tta_tpu.models.convert import flat_npz_to_params
    from dg_tta_tpu_torch.cli.main import main as port_cli

    root, _, _ = workspace
    port_cli(["prepare_tta", *ARGS])
    plan_path = root / PLAN_DIR / "tta_plan.json"
    plan = json.loads(plan_path.read_text())
    plan.update(epochs=2, patches_to_be_accumulated=1, ensemble_count=2)
    plan_path.write_text(json.dumps(plan))

    summaries = port_cli(["run_tta", *ARGS, "--device", "cpu"])
    (run_dir,) = list((root / RESULTS_DIR).iterdir())
    timings = json.loads((run_dir / "timings.json").read_text())
    assert timings["device"] == "cpu"
    assert {"adaptation", "inference"} <= set(timings["phases"])
    assert "Ts" in summaries
    members = {}
    for case in ("caseA", "caseB"):
        for i in range(2):
            path = _member_file(run_dir, case, i)
            members[path] = path.read_bytes()
            # the JAX package loads the port's members
            tree = flat_npz_to_params(path)
            assert all(np.isfinite(np.asarray(a)).all()
                       for a in jax.tree.leaves(tree))
            res = json.loads((path.parent / f"{case}__ensemble_idx_{i}"
                              "_tta_results.json").read_text())
            assert len(res["losses"]) == 2 and len(res["eval_dices"]) == 2
            assert np.isfinite(res["losses"]).all()

    run_no = int(run_dir.name.rsplit("-", 1)[-1])
    port_cli(["run_tta", *ARGS, "--run_no", str(run_no), "--device", "cpu"])
    timings = json.loads((run_dir / "timings.json").read_text())
    assert "adaptation" not in timings["phases"]
    assert "inference" in timings["phases"]
    for path, data in members.items():
        assert path.read_bytes() == data


def test_port_run_tta_deformable_with_exact_warp_grad(workspace,  # noqa: F811
                                                      monkeypatch):
    """A deformable plan with DGTTA_EXACT_WARP_GRAD=1 runs through the
    port's CLI unchanged: `tta/driver.py` hands the flag to the engine,
    whose unwarps then take the exact adjoint (`warp_flat_op`), and the run
    writes its members and its phases as any other."""
    from dg_tta_tpu_torch.cli.main import main as port_cli
    from dg_tta_tpu_torch.tta import engine

    root, _, _ = workspace
    port_cli(["prepare_tta", *ARGS])
    plan_path = root / PLAN_DIR / "tta_plan.json"
    plan = json.loads(plan_path.read_text())
    plan.update(epochs=2, patches_to_be_accumulated=1, ensemble_count=1,
                spatial_aug_type="deformable")
    plan_path.write_text(json.dumps(plan))
    calls = []

    def counted(*args, **kw):
        calls.append(args[2])
        return warp_flat_op(*args, **kw)

    warp_flat_op = engine.warp_flat_op
    monkeypatch.setattr(engine, "warp_flat_op", counted)
    monkeypatch.setenv("DGTTA_EXACT_WARP_GRAD", "1")
    summaries = port_cli(["run_tta", *ARGS, "--device", "cpu"])
    (run_dir,) = list((root / RESULTS_DIR).iterdir())
    timings = json.loads((run_dir / "timings.json").read_text())
    assert {"adaptation", "inference"} <= set(timings["phases"])
    assert "Ts" in summaries
    # two cases x two epochs x one patch x two branches
    assert len(calls) == 8
    assert all(isinstance(g, tuple) and len(g) == 3 for g in calls)
    for case in ("caseA", "caseB"):
        res = json.loads((run_dir / "tta_outputTs" / f"{case}__ensemble_idx_"
                          "0_tta_results.json").read_text())
        assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
