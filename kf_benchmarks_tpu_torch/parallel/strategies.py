"""Parallelism strategies: the --variable_update modes as hooks of the step.

The port's counterpart of kf_benchmarks_tpu/parallel/strategies.py. Each
rank is a process; the training step (train_step.TrainStep) calls a
strategy's hooks on its module, in place, at the JAX package's points:

  reduce_gradients  the gradients, after backward and before the update
  pre_update        the weights before the optimizer step (sma)
  post_update       the weights after it (pair averaging)
  sync_batch_stats  the batch-norm running averages after the step
  broadcast_init    the weights once after the build, from rank 0

Every hook takes a list of tensors in the module's order, which is the
same on every rank. ``sequential_apply`` (the async parameter server with a
stateful optimizer) tells the step to gather every rank's gradient and
apply them one by one, in rank order, through its one optimizer state.

Mapping from --variable_update:
  independent            no reduction
  replicated, horovod    all-reduce mean of the gradients (per tensor, or
                         the flag-selected reducer of ops/allreduce.py)
  parameter_server       as replicated; with --cross_replica_sync=false the
                         async parameter server (gradient SUM for sgd,
                         sequential_apply otherwise)
  collective_all_reduce, distributed_all_reduce
                         the --all_reduce_spec planner
  kungfu                 --kungfu_option: sync_sgd, async_sgd, sma
  --shard_optimizer_state the sharded family (replicated and
                         parameter_server): ZeRO / FSDP, whose gradient
                         reduction, apply and gather are the step's own
                         (ops/sharded.py)
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from kf_benchmarks_tpu_torch.ops import allreduce
from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh

Tensors = List[torch.Tensor]


def _assign(dst: Tensors, src: Tensors) -> None:
  for d, s in zip(dst, src):
    d.copy_(s)


class Strategy:
  """Base: one replica's semantics, no traffic between ranks."""

  name = "independent"
  # Whether gradients are averaged over the ranks (the effective batch of
  # the learning rate is then the global batch).
  cross_replica = False
  sequential_apply = False
  sharded_state = False

  def __init__(self, params=None):
    self.params = params

  def reduce_gradients(self, grads: Tensors) -> None:
    pass

  def pre_update(self, weights: Tensors, step: int) -> None:
    pass

  def post_update(self, weights: Tensors, step: int) -> None:
    pass

  def sync_batch_stats(self, stats: Tensors) -> None:
    """Independent modes keep rank-local running statistics."""

  def step_classes(self) -> int:
    """How many host-side step behaviours the hooks have, by global step
    modulo this count: a captured step replays the class it was captured
    at (train_step.TrainChunk keeps one graph a class)."""
    return 1

  def broadcast_init(self, weights: Tensors) -> None:
    """Every rank builds the same weights from the seed: nothing to do
    but for the strategies whose ranks may start apart."""


class IndependentStrategy(Strategy):
  name = "independent"


class ReplicatedStrategy(Strategy):
  """All-reduce averaged gradients and running statistics. ``reducer`` is
  the flag-selected path of ops/allreduce.build_reducer; None is one
  all-reduce mean per tensor."""

  name = "replicated"
  cross_replica = True

  def __init__(self, params=None, reducer: Optional[allreduce.Reducer] = None):
    super().__init__(params)
    self.reducer = reducer

  def reduce_gradients(self, grads: Tensors) -> None:
    if self.reducer is not None:
      _assign(grads, self.reducer(grads))
    else:
      kungfu.allreduce_mean(grads)

  def sync_batch_stats(self, stats: Tensors) -> None:
    kungfu.allreduce_mean(stats)


class ParameterServerStrategy(ReplicatedStrategy):
  name = "parameter_server"


class AsyncParameterServerStrategy(ReplicatedStrategy):
  """--cross_replica_sync=false: every rank's unaveraged gradient lands on
  the one shared weight copy. For plain SGD the n applications collapse
  into one by the gradient SUM; a stateful optimizer sets
  ``sequential_apply`` and the step applies the gathered gradients one at a
  time in rank order, so every rank computes the same weights."""

  name = "parameter_server(async)"
  cross_replica = False

  def __init__(self, params=None, reducer=None):
    super().__init__(params, reducer=reducer)
    self.sequential_apply = bool(
        params is not None and params.optimizer != "sgd")

  def reduce_gradients(self, grads: Tensors) -> None:
    if self.sequential_apply:
      return
    if self.reducer is not None:
      n = mesh.world_size()
      _assign(grads, [g * n for g in self.reducer(grads)])
      return
    for g in grads:
      dist.all_reduce(g, op=dist.ReduceOp.SUM)


class ShardedOptimizerStrategy(ReplicatedStrategy):
  """ZeRO / FSDP sharded optimizer state (--shard_optimizer_state [+
  --shard_params]): the port's rendering of the reference's central
  variable placement (variable_mgr.py:201-243), where the "server" is the
  1/n state shard each rank owns. A marker: the reduce-scatter, the shard
  apply and the gather live in the train step and ops/sharded.py. The
  batch-norm statistics stay replicated (the inherited mean)."""

  name = "parameter_server(sharded)"
  sharded_state = True

  def reduce_gradients(self, grads: Tensors) -> None:
    raise NotImplementedError(
        "sharded-state gradient reduction is the step's reduce-scatter "
        "(train_step.py + ops/sharded.py), not a strategy hook")


class CollectiveAllReduceStrategy(ReplicatedStrategy):
  """The --all_reduce_spec planner's reduction."""

  name = "collective_all_reduce"


class KungFuStrategy(Strategy):
  """KungFu's optimizer wrappers, by --kungfu_option:

    sync_sgd   SynchronousSGDOptimizer: all-reduce mean of the gradients
               (and of the running statistics)
    async_sgd  PairAveragingOptimizer: a local step, then pair averaging of
               the weights on the gossip schedule (kungfu.gossip_shift)
    sma        SynchronousAveragingOptimizer: the weights averaged, then a
               local step
  """

  name = "kungfu"

  def __init__(self, params=None, option: str = "sync_sgd"):
    super().__init__(params)
    if option not in ("sync_sgd", "async_sgd", "sma"):
      raise ValueError(f"Invalid kungfu_option {option!r}")
    self.option = option
    self.cross_replica = option == "sync_sgd"

  def reduce_gradients(self, grads: Tensors) -> None:
    if self.option == "sync_sgd":
      kungfu.allreduce_mean(grads)

  def pre_update(self, weights: Tensors, step: int) -> None:
    if self.option == "sma":
      kungfu.sync_average(weights)

  def post_update(self, weights: Tensors, step: int) -> None:
    if self.option == "async_sgd":
      kungfu.pair_average(weights, step)

  def sync_batch_stats(self, stats: Tensors) -> None:
    if self.option == "sync_sgd":
      kungfu.allreduce_mean(stats)

  def step_classes(self) -> int:
    # Pair averaging's partner cycles through the gossip offsets.
    if self.option != "async_sgd":
      return 1
    return max(1, len(kungfu.gossip_offsets(mesh.world_size())))

  def broadcast_init(self, weights: Tensors) -> None:
    kungfu.broadcast(weights, root=0)


def get_strategy(params) -> Strategy:
  """The strategy of --variable_update (and its companion flags)."""
  vu = params.variable_update
  if params.shard_optimizer_state:
    # validation.py admits it only in the synchronous replicated /
    # parameter_server family, which the sharded strategy subsumes.
    return ShardedOptimizerStrategy(params)
  if vu == "independent":
    return IndependentStrategy(params)
  if vu == "kungfu":
    return KungFuStrategy(params, option=params.kungfu_option)
  reducer = allreduce.build_reducer(params)
  if vu == "replicated":
    return ReplicatedStrategy(params, reducer=reducer)
  if vu == "parameter_server":
    if not params.cross_replica_sync:
      return AsyncParameterServerStrategy(params, reducer=reducer)
    return ParameterServerStrategy(params, reducer=reducer)
  if vu in ("collective_all_reduce", "distributed_all_reduce"):
    return CollectiveAllReduceStrategy(params, reducer=reducer)
  if vu == "horovod":
    s = ReplicatedStrategy(params, reducer=reducer)
    s.name = "horovod"
    return s
  raise ValueError(f"--variable_update={vu} is not ported yet")
