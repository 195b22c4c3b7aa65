"""KungFu's data plane over torch.distributed.

The port's counterpart of kf_benchmarks_tpu/parallel/kungfu.py. The JAX
package issues these collectives inside its shard_mapped step over the
'replica' mesh axis; here each rank is a process and each function is a
collective over the default process group, in place on a list of tensors
(every rank passes its tensors in the same order):

  allreduce_mean   all_reduce SUM, then / world size (sync-SGD)
  broadcast        rank ``root``'s values to every rank, bit for bit
  pair_average     one send/receive of the whole list per step with the
                   step's gossip partner, then (x + y) / 2 (async_sgd)
  sync_average     allreduce_mean of the weights (sma)
  run_barrier      the exit barrier: on the coordination service under the
                   kfrun launcher (KFCOORD_* set), else dist.barrier

``current_cluster_size`` and ``current_rank`` answer for the process group
(1 and 0 without one).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.distributed as dist

from kf_benchmarks_tpu_torch.parallel import mesh


def current_cluster_size() -> int:
  return mesh.world_size()


def current_rank() -> int:
  return mesh.rank()


def run_barrier() -> None:
  """Every rank waits for the others (the reference's exit barrier,
  tf_cnn_benchmarks.py:58-60). Under the kfrun launcher each of the
  KFCOORD_WORLD workers joins the coordinator and enters its ``kf_exit``
  barrier; otherwise the process group's barrier (none without one)."""
  host = os.environ.get("KFCOORD_HOST")
  port = os.environ.get("KFCOORD_PORT")
  world = os.environ.get("KFCOORD_WORLD")
  if host and port and world:
    from kf_benchmarks_tpu_torch.parallel import coordination
    with coordination.CoordinatorClient(host=host,
                                        port=int(port)) as client:
      client.join(os.environ.get("KFCOORD_NAME", f"proc-{os.getpid()}"))
      client.barrier("kf_exit", int(world))
    return
  if mesh.is_distributed():
    dist.barrier()


def allreduce_mean(tensors: Sequence[torch.Tensor]) -> None:
  """Each tensor <- the mean of its values over the ranks, one all_reduce
  per tensor."""
  n = mesh.world_size()
  for t in tensors:
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    t.div_(n)


def broadcast(tensors: Sequence[torch.Tensor], root: int = 0) -> None:
  """Each tensor <- rank ``root``'s, in its own dtype (bools ride uint8)."""
  for t in tensors:
    if t.dtype == torch.bool:
      wire = t.to(torch.uint8)
      dist.broadcast(wire, src=root)
      t.copy_(wire.bool())
    else:
      dist.broadcast(t, src=root)


# World size at or below which the gossip schedule is the full 1..n-1
# rotation; above it the hypercube offsets (one send a step either way).
GOSSIP_SWITCH_MAX_N = 8


def gossip_offsets(n: int) -> List[int]:
  """The partner offsets of the gossip schedule at world size n: 1..n-1 up
  to GOSSIP_SWITCH_MAX_N, the powers of two below n above it (every
  residue is a subset sum of them, so all ranks mix in ceil(log2 n)
  steps)."""
  if n <= GOSSIP_SWITCH_MAX_N:
    return list(range(1, n))
  return [1 << k for k in range((n - 1).bit_length())]


def gossip_shift(step: int, n: int) -> int:
  """The partner offset at ``step``: rank i receives from (i - shift) mod
  n and sends to (i + shift) mod n."""
  if n <= 1:
    return 0
  offsets = gossip_offsets(n)
  return offsets[int(step) % len(offsets)]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
  return torch.cat([t.reshape(-1) for t in tensors])


def pair_average(tensors: Sequence[torch.Tensor], step: int) -> None:
  """One gossip round: each tensor <- (x + y) / 2 with y the partner's
  value, the partner given by ``gossip_shift(step, n)``. The gossip matrix
  (I + P)/2, P a cyclic permutation, is doubly stochastic, so the mean over
  the ranks is kept (to rounding). The whole list travels as one flat
  buffer: one send and one receive a step. A world of one returns as it
  is."""
  n = mesh.world_size()
  if n == 1 or not tensors:
    return
  shift = gossip_shift(step, n)
  me = mesh.rank()
  send = _flat(tensors)
  recv = torch.empty_like(send)
  reqs = dist.batch_isend_irecv([
      dist.P2POp(dist.isend, send, (me + shift) % n),
      dist.P2POp(dist.irecv, recv, (me - shift) % n)])
  for req in reqs:
    req.wait()
  offset = 0
  for t in tensors:
    y = recv[offset:offset + t.numel()].view_as(t)
    t.copy_(0.5 * (t + y))
    offset += t.numel()


def sync_average(tensors: Sequence[torch.Tensor]) -> None:
  """Synchronous model averaging (SMA): the mean of the weights."""
  allreduce_mean(tensors)
