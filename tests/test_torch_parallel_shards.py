"""The port's sharded streams, windows and data-parallel pretraining step
(dg_tta_tpu_torch/parallel/) on the CPU, in one launch of two gloo ranks
(`parallel/dryrun.jobs_rank`), against their one-process runs and the
JAX package's on the 8-device virtual CPU mesh.  The tolerances and the
one-thread rule are tests/test_torch_parallel.py's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.infer import sliding_window as jsw
from dg_tta_tpu.parallel.mesh import make_mesh
from dg_tta_tpu_torch.models.convert import params_from_jax
from dg_tta_tpu_torch.ops.gin import GinDraws
from dg_tta_tpu_torch.parallel import dryrun
from dg_tta_tpu_torch.parallel.mesh import launch
from dg_tta_tpu_torch.parallel.tta import Stream
from dg_tta_tpu_torch.train import pretrain
from dg_tta_tpu_torch.tta.draws import Recorded, TorchDraws
from dg_tta_tpu_torch.tta.engine import make_tta_functions
from dg_tta_tpu_torch.tta.plan import TTAPlan
from tests import test_torch_train as ttrain
from tests.test_torch_engine import (IDX3, VOL_SHAPE, port_model,
                                     synth_labels, synth_volume)
from tests.test_torch_parallel import RANKS
from tests.test_torch_parallel import \
    _one_thread_and_a_timeout  # noqa: F401  (the module fixture)
from tests.test_torch_sliding_window import MODEL, JAX_MODEL, _members


# ------------------------------- (b), (c), (d): one launch of two ranks


def _stream_job():
    rng = np.random.default_rng(1)
    streams = []
    for s in range(4):
        vol = torch.from_numpy(synth_volume(rng)[None])
        streams.append(Stream(TorchDraws(seed=0, sample_index=s), 0, vol,
                              [list(map(float, VOL_SHAPE))],
                              torch.from_numpy(synth_labels()[None])))
    plan = TTAPlan(epochs=2, patches_to_be_accumulated=1, lr=1e-3,
                   ensemble_count=1, start_tta_at_epoch=1)
    state = port_model().build_network(device="cpu").state_dict()
    return dryrun.StreamJob(port_model(), plan, state, streams, IDX3)


def _predict_jobs():
    nets, stacked = _members([3, 4])
    vol = synth_volume(np.random.default_rng(2))
    gin = dryrun.PredictJob(MODEL, [n.state_dict() for n in nets],
                            torch.from_numpy(vol), bucket_multiple=4)
    mind_model = port_model("nnUNetTrainer_MIND")
    mind = dryrun.PredictJob(
        mind_model, [dryrun.seeded_state(mind_model, s) for s in (5, 6)],
        torch.from_numpy(vol), draws=TorchDraws(seed=1), bucket_multiple=4)
    return gin, stacked, vol, mind


def _picklable_step_draws(key, jcfg, imgs_shape, gin):
    """tests/test_torch_train.py's `_step_draws` of the JAX step on `key`,
    with the noise as `Recorded` tensors (a rank cannot run JAX)."""
    values, (layers, alphas), noise = ttrain._jax_step_values(
        key, jcfg, tuple(imgs_shape))
    da = tuple(dataclasses.replace(
        ttrain.sample_draws(v),
        noise=Recorded(torch.from_numpy(np.array(v["noise"]))))
        for v in values)
    layers, alphas = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                  (layers, alphas))
    return pretrain.StepDraws(
        da=da, gin=GinDraws(layers=tuple(tuple(kw) for kw in layers),
                            alphas=alphas) if gin else None,
        mind_noise=Recorded(torch.from_numpy(np.array(noise))))


TRAINERS = ("nnUNetTrainer_GIN", "nnUNetTrainer_GIN_MIND")


def _step_jobs():
    """Per trainer: a `StepJob` of one step at a global batch of 4 on JAX's
    draws, and the JAX step's loss and parameters (before and after)."""
    out = {}
    imgs, segs = ttrain._batch(7, shape=(4, *ttrain.PATCH))
    for trainer in TRAINERS:
        jm, tm = ttrain._models(trainer)
        jcfg, cfg = ttrain._da_cfgs(trainer)
        params = ttrain._params(tm, 0)
        before = jax.tree.map(np.asarray, params)
        tx, jstep = ttrain.jpre.make_train_step(jm, jcfg)
        key = jax.random.PRNGKey(10)
        new, _, loss = jstep(jax.tree.map(jnp.array, params),
                             tx.init(params), key, jnp.asarray(imgs),
                             jnp.asarray(segs), jnp.float32(1e-2))
        job = dryrun.StepJob(
            tm, params_from_jax(before), imgs, segs,
            [_picklable_step_draws(key, jcfg, imgs.shape,
                                   tm.uses_gin_internal)], [1e-2], cfg)
        out[trainer] = (job, float(loss), before,
                        jax.tree.map(np.asarray, new))
    return out


@pytest.fixture(scope="module")
def launched():
    """Streams, windows (a GIN and a MIND model) and the data-parallel
    steps (each trainer, and GIN_MIND with a local batch Dice) in one
    launch of two CPU ranks; every rank's results."""
    stream = _stream_job()
    gin, stacked, vol, mind = _predict_jobs()
    steps = _step_jobs()
    mind_step = steps["nnUNetTrainer_GIN_MIND"][0]
    jobs = [(dryrun.stream_rank, stream), (dryrun.predict_rank, gin),
            (dryrun.predict_rank, mind)]
    jobs += [(dryrun.dp_step_rank, steps[t][0]) for t in TRAINERS]
    jobs += [(dryrun.dp_step_rank,
              dataclasses.replace(mind_step, local_dice=True))]
    results = launch(dryrun.jobs_rank, RANKS, "cpu", "gloo", args=(jobs,))
    return dict(stream=stream, gin=gin, stacked=stacked, vol=vol, mind=mind,
                steps=steps, results=results)


def test_stream_run_over_ranks_matches_the_serial_runs(launched):
    job = launched["stream"]
    got = launched["results"][0][0]
    assert launched["results"][1][0] is None     # rank 1 returns nothing
    fns = make_tta_functions(job.model, job.plan, IDX3, IDX3)
    net0 = job.model.build_network(job.state, "cpu")
    losses = []
    for (member, state, lm, dm), s in zip(got, job.streams):
        ref_net, ref_l, ref_d = fns.member_run(net0, s.draw_source, s.member,
                                               s.vols, s.shapes, s.labels)
        assert member == s.member
        np.testing.assert_allclose(lm, ref_l, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dm, ref_d, rtol=1e-5, atol=1e-6)
        for k, v in ref_net.state_dict().items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        losses.append(lm)
    # distinct volumes, distinct losses (tests/test_parallel.py:175-176)
    assert len(set(np.asarray(losses)[:, 0].round(8).tolist())) > 1


def test_window_sharded_predict_matches_serial_and_jax(launched):
    res = launched["results"][0][1]
    assert res["close"], res
    got = res["output"].numpy()
    ref = jsw.predict_volume(JAX_MODEL, launched["stacked"],
                             jnp.asarray(launched["vol"]),
                             key=jax.random.PRNGKey(7), bucket_multiple=4,
                             mesh=make_mesh(8))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    from dg_tta_tpu_torch.infer.sliding_window import predict_volume
    job = launched["gin"]
    nets = [job.model.build_network(s, "cpu") for s in job.states]
    np.testing.assert_allclose(
        got, predict_volume(job.model, nets, job.vol,
                            bucket_multiple=4).numpy(),
        rtol=1e-4, atol=1e-5)


def test_window_sharded_predict_keeps_each_windows_mind_noise(launched):
    """A MIND model: window w's noise through member m is the unsharded
    run's (the draw source is asked by the window's index in the grid), so
    the sharded logits equal the unsharded ones, which another seed's
    noise moves."""
    from dg_tta_tpu_torch.infer.sliding_window import predict_volume

    res = launched["results"][0][2]
    assert res["close"] and res["max_abs_err"] <= 1e-5 + 1e-4 * res[
        "ref_max_abs"], res
    job = launched["mind"]
    nets = [job.model.build_network(s, "cpu") for s in job.states]
    other = predict_volume(job.model, nets, job.vol, draws=TorchDraws(seed=2),
                           bucket_multiple=4)
    assert float((other - res["output"]).abs().max()) > 1e-3


def _step_results(launched, i):
    results = [r[3 + i] for r in launched["results"]]
    (losses, state, _), others = results[0], results[1:]
    for _, s, _ in others:        # the replicas stay equal
        assert all(torch.equal(a, b) for a, b in zip(s.values(),
                                                     state.values()))
    return losses, state


@pytest.mark.parametrize("i,trainer", list(enumerate(TRAINERS)))
def test_data_parallel_step_matches_one_process_and_jax(launched, i,
                                                        trainer):
    job, ref_loss, before, after = launched["steps"][trainer]
    losses, state = _step_results(launched, i)
    one_losses, one = dryrun.one_process_steps(job, "cpu")
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5, atol=1e-6)
    for k, v in one.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # against the JAX step (test_train_step_matches_jax's tolerances)
    assert abs(losses[0] - ref_loss) <= 1e-5 * abs(ref_loss)
    update_rtol = 2e-2 if "MIND" in trainer else 1e-3
    got = ttrain._leaves(state)
    moved = 0
    for g, r, o in zip(got, jax.tree.leaves(after), jax.tree.leaves(before)):
        if np.any(o):
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max())
        du, dr = g - o, r - o
        assert np.linalg.norm(du - dr) <= update_rtol * np.linalg.norm(dr)
        moved += bool(np.any(dr))
    assert moved >= len(got) // 2


def test_a_local_batch_dice_breaks_the_data_parallel_step(launched):
    """The step with each rank's batch Dice of its own rows (the
    cross-rank sums of tp, fp and fn left out) runs and gives a plausible
    loss, but misses the one-process step by far more than the
    tolerances above: the comparison sees the fault."""
    job = launched["steps"]["nnUNetTrainer_GIN_MIND"][0]
    good, _ = _step_results(launched, 1)
    losses, state = _step_results(launched, 2)
    one_losses, one = dryrun.one_process_steps(job, "cpu")
    assert np.isfinite(losses[0])
    assert abs(losses[0] - one_losses[0]) > 100 * (
        1e-6 + 1e-5 * abs(one_losses[0]))
    assert abs(good[0] - one_losses[0]) <= 1e-6 + 1e-5 * abs(one_losses[0])
    off = [k for k, v in one.items()
           if not np.allclose(state[k].numpy(), v.numpy(), rtol=1e-4,
                              atol=1e-6)]
    assert off
