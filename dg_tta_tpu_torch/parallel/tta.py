"""Ensemble members and (sample x member) streams spread over ranks (the
port of `dg_tta_tpu/parallel/tta.py`).

Members, and samples across volumes, are independent adaptation streams:
no collective touches their networks.  The JAX package shards a stacked
ensemble axis over its mesh, and its epoch-level builders
(`make_sharded_ensemble_train`, `_eval`, `_fwd`) hand the stacked
parameters and optimizer state back to the host between epochs.  Here a
rank keeps its members' networks and optimizers in its own memory for the
whole adaptation, so the unit of work is a whole member's run
(`TTAFunctions.member_run`: every epoch's training or warm-up, and its
evaluation), and those builders fold into the two below:

* `sharded_member_run` (`make_sharded_member_run`): the members of one
  chunk on the same volumes, a contiguous block of them per rank, side by
  side where a rank holds more than one (`TTAFunctions.run`);
* `sharded_stream_run` (`make_sharded_stream_train` and
  `make_sharded_stream_eval`): S streams, each a member on its own
  volumes, a contiguous block of them per rank.

Both are collectives: every rank of the process group calls them with the
same arguments, and rank 0 gets each member's weights (CPU copies),
losses and Dices in order, gathered by `torch.distributed.gather_object`.
"""

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from dg_tta_tpu_torch.parallel.mesh import ranks_for, shard


def member_chunks(members, chunk: Optional[int], n_devices: int) -> list:
    """[(member ids, ranks)]: `members` in chunks of `chunk` (None: one
    chunk of all), each over `ranks_for(chunk, n_devices)` ranks where
    those divide it, else over 1 rank, one member after another (the JAX
    engine's mesh choice, `dg_tta_tpu/tta/engine.py:636-652`)."""
    members = list(members)
    if not members:
        return []
    chunk = min(int(chunk or len(members)), len(members))
    if chunk < 1:
        raise ValueError(f"ensemble_chunk must be >= 1, got {chunk}")
    size = ranks_for(chunk, n_devices) if n_devices > 1 else 1
    return [(ids, size if len(ids) % size == 0 else 1)
            for ids in (members[i:i + chunk]
                        for i in range(0, len(members), chunk))]


def _state_cpu(net) -> dict:
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def _gather(done: list, n: int) -> Optional[list]:
    """Rank 0: the n results of every rank's `done` [(index, ...)] in
    index order; the other ranks: None."""
    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(done, parts, dst=0)
    if parts is None:
        return None
    by_index = {r[0]: r[1:] for part in parts for r in part}
    if sorted(by_index) != list(range(n)):
        raise RuntimeError(f"gathered results {sorted(by_index)} of {n}")
    return [by_index[i] for i in range(n)]


def sharded_member_run(fns, net0, draw_source, ids, vols, shapes,
                       labels=None, ranks: Optional[int] = None,
                       log_fn=None, save_member_fn=None,
                       return_nets: bool = True) -> Optional[list]:
    """Adapt the members `ids` of one chunk, `ranks` ranks (default all)
    taking a contiguous block each; the other ranks of the group take
    none.  Each rank runs its block through `fns.run(net0, draw_source,
    block, vols, shapes, labels, log_fn)` (side by side where it holds
    more than one member), then `save_member_fn(m, net, losses, dices)`
    for each of them in order.  Returns, on
    rank 0, [(member, state_dict on the CPU or None without
    `return_nets`, losses (epochs,), dices (epochs,))] in `ids` order;
    None on the other ranks."""
    ids = list(ids)
    world = dist.get_world_size()
    ranks = world if ranks is None else int(ranks)
    if not 1 <= ranks <= world or len(ids) % ranks:
        raise ValueError(f"{len(ids)} members over {ranks} of {world} ranks")
    rank = dist.get_rank()
    done = []
    if rank < ranks:
        block = shard(list(enumerate(ids)), rank, ranks)
        runs = fns.run(net0, draw_source, [m for _, m in block], vols, shapes,
                       labels, log_fn)
        for (i, m), (net, lm, dm) in zip(block, runs):
            if save_member_fn is not None:
                save_member_fn(m, net, lm, dm)
            done.append((i, m, _state_cpu(net) if return_nets else None, lm,
                         dm))
        del runs
    return _gather(done, len(ids))


@dataclasses.dataclass(frozen=True)
class Stream:
    """One adaptation stream: member `member` of `draw_source` on its own
    bucket-padded `vols` (N, D, H, W, C), true `shapes` (N, 3) and
    optional `labels` (N, D, H, W, 1), moved to the rank's device when its
    rank runs it."""

    draw_source: Any
    member: int
    vols: torch.Tensor
    shapes: Any
    labels: Optional[torch.Tensor] = None


def sharded_stream_run(fns, net0, streams, device) -> Optional[list]:
    """Adapt `net0` once per `Stream`, every rank taking a contiguous block
    of the streams, on `device`.  Returns, on rank 0, [(member, state_dict
    on the CPU, losses, dices)] in stream order; None on the other
    ranks."""
    streams = list(streams)
    done = []
    for i, s in shard(list(enumerate(streams)), dist.get_rank(),
                      dist.get_world_size()):
        labels = None if s.labels is None else s.labels.to(device)
        net, lm, dm = fns.member_run(net0, s.draw_source, s.member,
                                     s.vols.to(device), s.shapes, labels)
        done.append((i, s.member, _state_cpu(net), lm, dm))
        del net
    return _gather(done, len(streams))
