"""Ranks in place of a device mesh (the port of `dg_tta_tpu/parallel/mesh.py`).

The JAX package runs one program over a mesh of devices; here each device
gets a process of its own, a rank of a `torch.distributed` process group:

* `make_mesh(n)` -> `launch(fn, n, ...)`: n processes started with the
  `spawn` method, rank r on `cuda:r` (or the CPU), meeting at a file in a
  fresh temporary directory (no network port), each calling
  `fn(rank, ranks, device, *args)`; `ranks_for(chunk, n_devices)` is the
  size the JAX engine gives its mesh for a chunk of members;
* `shard_ensemble_axis(x, mesh)` -> `shard(items, rank, ranks)`: the
  contiguous block of a leading axis that a rank holds;
* `replicate(x, mesh)` -> every rank builds the same state from the same
  arguments, and `broadcast_state` copies rank 0's where it must be
  shared (the parameters of data-parallel pretraining);
* XLA's inserted all-reduces -> `all_reduce_sum`, a differentiable sum
  over the ranks (its gradient is the sum of the ranks' gradients).

The backend is the caller's: "nccl" for one card per rank, "gloo" for
CPU ranks and for more ranks than cards (they share the cards in turn).
Nothing switches it: a rank that fails, or a collective that times out,
fails the launch, which kills the other ranks and raises with the
failing rank's traceback.  The ranks use only
`all_reduce`, `broadcast` and `barrier` on tensors and object collectives
on CPU data, so one code path serves both backends.

`DGTTA_RANK_TIMEOUT_S` (default one day) bounds a launch that its caller
gives no timeout: the process group's collectives and the parent's wait
for the ranks.  Where `DGTTA_RANK_STATS_DIR` names a directory, each
rank that finishes writes `rank<r>_<pid>.json` there: its device, the
seconds its job took, its peak device memory (CUDA) and its kernels'
launch counts (`kernels/counts.read_counts`), so a caller can hold a
sharded run's launches, summed over its ranks, to a prediction.
"""

import datetime
import json
import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 24 * 3600.0
# intra-op threads of a CPU rank: several ranks (and test workers) share
# the machine's cores
CPU_RANK_THREADS = 1


def rank_timeout_s() -> float:
    """The timeout of a launch whose caller gives none:
    `DGTTA_RANK_TIMEOUT_S`, or one day."""
    return float(os.environ.get("DGTTA_RANK_TIMEOUT_S", DEFAULT_TIMEOUT_S))


def default_backend(device_type: str) -> str:
    """"nccl" for CUDA ranks, "gloo" for CPU ranks."""
    return "gloo" if device_type == "cpu" else "nccl"


def visible_devices(device_type: str) -> int:
    """The devices a run of `device_type` can spread over: the visible
    GPUs (`CUDA_VISIBLE_DEVICES` restricts them) for "cuda", 1 for the
    CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def ranks_for(chunk: int, n_devices: int) -> int:
    """The largest divisor of `chunk` that is <= `n_devices` (the mesh
    size of `dg_tta_tpu/tta/engine.py`'s sharded branch)."""
    return max(d for d in range(1, max(1, min(n_devices, chunk)) + 1)
               if chunk % d == 0)


def shard(items, rank: int, ranks: int) -> list:
    """Rank `rank`'s contiguous block of `items`: equal blocks in order
    where `ranks` divides their number (as `P("data")` splits a leading
    axis), else the first len % ranks blocks one item longer."""
    items = list(items)
    base, extra = divmod(len(items), ranks)
    lo = rank * base + min(rank, extra)
    return items[lo:lo + base + (rank < extra)]


def launch(fn, ranks: int, device_type: str = "cuda", backend: str = "nccl",
           args=(), timeout_s=None) -> list:
    """Run `fn(rank, ranks, device, *args)` in `ranks` new processes joined
    in one process group; returns their return values in rank order.

    `fn` must be a module-level function of an importable module and
    `args` and the return values picklable (they pass through files in the
    launch's temporary directory, never shared memory).  `device_type`:
    "cuda" (rank r on cuda:r, and past the visible cards round again,
    which NCCL refuses) or "cpu".  CUDA ranks find every kernel built
    (`kernels/build.build_all` runs here first) and the memory this
    process's allocator caches released.  Rank r sets its device
    before the group forms, and a CPU rank runs torch on
    `CPU_RANK_THREADS` threads.
    `timeout_s` (default `rank_timeout_s()`) is the process group's
    timeout and the parent's wait: on overrun the ranks are killed and
    `TimeoutError` raised.  A rank that exits with an error kills the
    others and raises `RuntimeError` with its traceback."""
    ranks = int(ranks)
    if ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    timeout_s = rank_timeout_s() if timeout_s is None else float(timeout_s)
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs CUDA ranks only; CPU ranks take gloo")
    elif device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{ranks} ranks on cuda requested but "
                               "torch.cuda.is_available() is False")
        n = torch.cuda.device_count()
        if backend == "nccl" and ranks > n:
            raise ValueError(f"NCCL needs a card per rank: {ranks} ranks, "
                             f"{n} cards visible; share cards over gloo")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type != "cpu":
        from dg_tta_tpu_torch.kernels.build import build_all
        build_all()
        # this process's cached blocks would stay reserved on a card its
        # ranks share
        torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dgtta_ranks_") as tmp:
        tmp = Path(tmp)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, name=f"dgtta-rank-{r}",
                             args=(r, ranks, device_type, backend, str(tmp),
                                   timeout_s))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        try:
            failed = _wait(procs, time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=60)
        if failed is None:
            name = getattr(fn, "__name__", fn)
            raise TimeoutError(f"{ranks} ranks of {name} did not finish "
                               f"within {timeout_s:g} s; killed")
        if failed:
            raise RuntimeError("\n".join(_failure(tmp, r, procs[r].exitcode,
                                                  ranks) for r in failed))
        out = []
        for r in range(ranks):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def _wait(procs, deadline):
    """Wait until every process has exited 0 (returns []), one has exited
    otherwise (returns the ranks that have, in rank order), or `deadline`
    passes (returns None)."""
    while True:
        failed = [r for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)]
        if failed:
            return failed
        alive = [p for p in procs if p.exitcode is None]
        if not alive:
            return []
        left = deadline - time.monotonic()
        if left <= 0:
            return None
        multiprocessing.connection.wait([p.sentinel for p in alive],
                                        timeout=min(left, 1.0))


def _failure(tmp: Path, rank: int, code, ranks: int) -> str:
    err = tmp / f"rank{rank}.err"
    tb = err.read_text() if err.is_file() else "(no traceback: the process " \
                                               "died without one)"
    return f"rank {rank} of {ranks} failed (exit code {code}):\n{tb}"


def _bind(rank: int, device_type: str) -> torch.device:
    if device_type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
        return torch.device("cpu")
    index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _rank_main(rank, ranks, device_type, backend, tmp, timeout_s):
    """A rank's process: bind the device, join the group, run the job,
    write its result (or its traceback) into the launch's directory."""
    tmp = Path(tmp)
    try:
        with open(tmp / "job.pkl", "rb") as f:
            fn, args = pickle.load(f)
        device = _bind(rank, device_type)
        # one host: the ranks meet over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        extra = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=f"file://{tmp / 'store'}", rank=rank,
            world_size=ranks,
            timeout=datetime.timedelta(seconds=timeout_s), **extra)
        t0 = time.perf_counter()
        out = fn(rank, ranks, device, *args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        dist.destroy_process_group()
        stats_dir = os.environ.get("DGTTA_RANK_STATS_DIR")
        if stats_dir:
            from dg_tta_tpu_torch.kernels.counts import read_counts
            (Path(stats_dir) / f"rank{rank}_{os.getpid()}.json").write_text(
                json.dumps({
                    "rank": rank, "ranks": ranks, "device": str(device),
                    "seconds": seconds, "launches": read_counts(),
                    "peak_bytes": (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else None)}))
        part = tmp / f"rank{rank}.pkl.part"
        with open(part, "wb") as f:
            pickle.dump(out, f)
        os.replace(part, tmp / f"rank{rank}.pkl")
    except BaseException:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        # no teardown: the other ranks may sit in a collective with this one
        os._exit(1)


# elements per collective of `all_reduce_pieces`: 256 MiB of f32
ALL_REDUCE_PIECE = 1 << 26


def all_reduce_pieces(t: torch.Tensor, group=None):
    """Sum a contiguous tensor over the ranks in place, `ALL_REDUCE_PIECE`
    elements at a time, so that no one collective stages more than that
    (gloo copies CUDA tensors through host memory)."""
    flat = t.view(-1)
    for part in flat.split(ALL_REDUCE_PIECE):
        dist.all_reduce(part, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum of `x` over the ranks; its backward sums the incoming
    gradient over the ranks, so each rank's `x` gets the gradient of the
    sum of every rank's loss (nnUNet's AllGatherGrad logic)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group` (the default
    group for None)."""
    return _AllReduceSum.apply(x, group)


def broadcast_state(module: torch.nn.Module, src: int = 0, group=None):
    """Copy rank `src`'s parameters and buffers into every rank's
    `module`, in place."""
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src, group=group)
