"""The port's several-process paths (dg_tta_tpu_torch/parallel/) on the
CPU, over gloo, against their one-process runs and against the JAX
package's sharded paths on the 8-device virtual CPU mesh.

The ranks run torch on one thread (`parallel/mesh.CPU_RANK_THREADS`),
and so does this module, so a sharded run and its one-process run
execute the same operations in the same order.  Most sharded runs share
one launch of two ranks (tests/test_torch_parallel_shards.py); every
launch is bounded by `DGTTA_RANK_TIMEOUT_S`.

Tolerances:
* `tta_one_volume(ensemble_chunk=4)` over two ranks against the one-rank
  run on the same draws: losses, Dices and every parameter rtol 1e-5 /
  atol 1e-6 (whether they are bit-equal is printed); on JAX's draws,
  against the JAX `tta_one_volume(..., ensemble_chunk=4)` on the mesh:
  tests/test_torch_engine.py's trajectory tolerances;
* `sharded_stream_run` over four streams: 1e-5 / 1e-6, as members;
* window-sharded `predict_volume`: rtol 1e-4 / atol 1e-5 against the
  unsharded call and the JAX call on the mesh
  (tests/test_parallel.py:179-195);
* the data-parallel step at a global batch of 4 over two ranks: against
  the one-process step, loss rtol 1e-5 / atol 1e-6 and parameters rtol
  1e-4 / atol 1e-6 (tests/test_parallel.py:109-140); against the JAX
  step, tests/test_torch_train.py::test_train_step_matches_jax's.
"""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dg_tta_tpu.tta.engine import tta_one_volume as jax_tta_one_volume
from dg_tta_tpu.tta.plan import TTAPlan as JaxPlan
from dg_tta_tpu_torch.parallel import dryrun
from dg_tta_tpu_torch.parallel.mesh import launch, ranks_for, shard
from dg_tta_tpu_torch.parallel.tta import member_chunks
from dg_tta_tpu_torch.ops.gin import GinDraws
from dg_tta_tpu_torch.train import pretrain
from dg_tta_tpu_torch.tta.draws import RecordedDraws, TorchDraws
from dg_tta_tpu_torch.tta.engine import tta_one_volume
from dg_tta_tpu_torch.tta.plan import TTAPlan
from tests.test_torch_engine import (IDX3, VOL_SHAPE, JaxDraws, _biased,
                                     _check_trajectory, jax_model,
                                     port_model, port_net, synth_labels,
                                     synth_volume)

RANKS = 2
PLAN_KW = dict(epochs=3, patches_to_be_accumulated=2, lr=1e-3,
               ensemble_count=4, start_tta_at_epoch=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_a_timeout():
    """One torch thread here, as in the CPU ranks, and a bound on every
    launch; both restored after."""
    n = torch.get_num_threads()
    old = os.environ.get("DGTTA_RANK_TIMEOUT_S")
    torch.set_num_threads(1)
    os.environ["DGTTA_RANK_TIMEOUT_S"] = "300"
    yield
    torch.set_num_threads(n)
    if old is None:
        del os.environ["DGTTA_RANK_TIMEOUT_S"]
    else:
        os.environ["DGTTA_RANK_TIMEOUT_S"] = old


def test_ranks_for_shard_and_chunks_follow_the_jax_engine():
    for chunk in range(1, 9):
        for n_dev in range(1, 9):
            # dg_tta_tpu/tta/engine.py:642-647
            jax_n = max(d for d in range(1, min(n_dev, chunk) + 1)
                        if chunk % d == 0)
            assert ranks_for(chunk, n_dev) == jax_n
    assert [shard(range(8), r, 4) for r in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert [shard(range(5), r, 2) for r in range(2)] == [[0, 1, 2], [3, 4]]
    assert sum((shard(range(7), r, 3) for r in range(3)), []) == list(
        range(7))
    # chunks the ranks do not divide run on one rank
    assert member_chunks([0, 1, 2, 3, 4], 3, 3) == [([0, 1, 2], 3),
                                                    ([3, 4], 1)]
    assert member_chunks([1, 2], None, 4) == [([1, 2], 2)]
    assert member_chunks([0, 1, 2], 3, 1) == [([0, 1, 2], 1)]
    assert member_chunks([0, 1, 2], 1, 8) == [([0], 1), ([1], 1), ([2], 1)]


def test_launch_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="NCCL"):
        launch(dryrun.jobs_rank, 2, "cpu", "nccl", args=([],))
    with pytest.raises(ValueError, match="backend"):
        launch(dryrun.jobs_rank, 2, "cpu", "mpi", args=([],))
    with pytest.raises(ValueError, match="ranks"):
        launch(dryrun.jobs_rank, 0, "cpu", "gloo", args=([],))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launch(dryrun.jobs_rank, 2, "cuda", "gloo", args=([],))


def test_a_launch_past_its_timeout_is_killed():
    """Half a second is less than a rank takes to import torch: the launch
    kills its ranks and raises."""
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="killed"):
        launch(dryrun.jobs_rank, 2, "cpu", "gloo", args=([],),
               timeout_s=0.5)
    assert time.perf_counter() - t0 < 60


def test_a_failing_rank_fails_the_launch_with_its_traceback():
    """Draws that the ranks cannot find: each rank raises a KeyError in
    its first member, and the launch raises it, with the traceback, long
    before its timeout; the engine does not run the members here
    instead."""
    model = port_model()
    vols = torch.from_numpy(synth_volume(np.random.default_rng(0))[None])
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as err:
        tta_one_volume(model, TTAPlan(epochs=1, patches_to_be_accumulated=1,
                                      ensemble_count=2),
                       model.build_network(device="cpu"), vols,
                       [list(map(float, VOL_SHAPE))], IDX3, IDX3,
                       RecordedDraws({}, {}), ensemble_chunk=2,
                       num_devices=2)
    assert time.perf_counter() - t0 < 120
    text = str(err.value)
    assert "rank 0 of 2 failed" in text or "rank 1 of 2 failed" in text
    assert "KeyError" in text and "Traceback" in text


def test_step_draws_rows_are_the_batch_rows():
    """A rank's share of a step's draws: its samples' augmentation and GIN
    nets, and its rows of the MIND noise drawn for the whole batch."""
    cfg = pretrain.DAConfig(p_noise=1.0)
    d = pretrain.PretrainDraws(3).step(0, 1, 4, cfg, gin=True)
    part = d.rows(2, 4)
    assert part.da == d.da[2:4]
    shape = (2, 8, 8, 8, 12)
    full = d.mind_noise((4, *shape[1:]), torch.device("cpu"))
    assert torch.equal(part.mind_noise(shape, torch.device("cpu")),
                       full[2:4])
    whole = GinDraws(layers=d.gin.layers, alphas=d.gin.alphas)
    for (k, s), (kp, sp) in zip(whole.layers, part.gin.layers):
        cout = k.shape[0] // 4
        assert torch.equal(kp, k[2 * cout:4 * cout])
        assert torch.equal(sp, s[2 * cout:4 * cout])
    assert torch.equal(part.gin.alphas, d.gin.alphas[2:4])


# ------------------------------------------------ (a) members over ranks


@pytest.fixture(scope="module")
def member_setup():
    rng = np.random.default_rng(0)
    # nonzero conv biases, so that their weight decay shows
    params = _biased(jax.jit(jax_model().init_params)(
        jax.random.PRNGKey(0)), 7)
    vols = synth_volume(rng)[None]
    shapes = np.asarray([VOL_SHAPE], np.float32)
    return params, vols, shapes, synth_labels()[None]


def _same_nets(a, b, rtol, atol):
    bit = True
    for na, nb in zip(a, b):
        for (k, x), y in zip(na.state_dict().items(),
                             nb.state_dict().values()):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                       atol=atol, err_msg=k)
            bit &= torch.equal(x, y)
    return bit


def test_members_over_ranks_match_the_serial_run(member_setup):
    params, vols, shapes, labels = member_setup
    plan = TTAPlan(**PLAN_KW)
    args = (port_model(), plan, port_net(params), torch.from_numpy(vols),
            shapes, IDX3, IDX3, TorchDraws(seed=3))
    kw = dict(labels_padded=torch.from_numpy(labels))
    ref = tta_one_volume(*args, **kw)
    logged, saved = [], []
    got = tta_one_volume(
        *args, ensemble_chunk=4, num_devices=RANKS,
        log_fn=lambda *a: logged.append(a),
        save_member_fn=lambda m, net, lm, dm: saved.append(m), **kw)
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == (3, 4)
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
    bit = _same_nets(got[0], ref[0], 1e-5, 1e-6)
    print(f"members over {RANKS} ranks bit-equal to the serial run: {bit}")
    # the parent logs and saves each member, in member order
    assert saved == [0, 1, 2, 3]
    assert [(m, ep) for m, ep, *_ in logged] == [
        (m, ep) for m in range(4) for ep in range(3)]
    assert not torch.allclose(got[0][0].encoder.stages[0][0].convs[0]
                              .conv.weight,
                              got[0][1].encoder.stages[0][0].convs[0]
                              .conv.weight)


def test_members_over_ranks_match_the_jax_sharded_run(member_setup):
    """On JAX's draws (`JaxDraws`, recorded here and handed to the ranks as
    tensors): the JAX engine shards the chunk of 4 over 4 of the mesh's 8
    devices, the port over its 2 ranks."""
    params, vols, shapes, labels = member_setup
    key = jax.random.PRNGKey(1)
    assert len(jax.devices()) >= 8
    ref = jax_tta_one_volume(jax_model(), JaxPlan(**PLAN_KW), params,
                             jnp.asarray(vols), jnp.asarray(shapes), IDX3,
                             IDX3, key, labels_padded=jnp.asarray(labels),
                             ensemble_chunk=4)
    draws = RecordedDraws.record(
        JaxDraws(key, n_acc=PLAN_KW["patches_to_be_accumulated"]),
        range(4), PLAN_KW["epochs"], PLAN_KW["patches_to_be_accumulated"],
        eval_reps=1, n_vols=1, batch=1)
    got = tta_one_volume(port_model(), TTAPlan(**PLAN_KW), port_net(params),
                         torch.from_numpy(vols), shapes, IDX3, IDX3, draws,
                         labels_padded=torch.from_numpy(labels),
                         ensemble_chunk=4, num_devices=RANKS)
    _check_trajectory(PLAN_KW, params, ref, got)
