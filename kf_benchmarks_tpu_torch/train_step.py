"""The training step of one rank.

The port's counterpart of kf_benchmarks_tpu/train_step.py: forward in the
compute dtype (explicit casts, as flax's ``dtype=``; no autocast), softmax
cross-entropy plus ``weight_decay * l2_loss`` over the non-BN parameters,
backward, the optimizer step at this step's learning rate, and the
batch-norm running averages, which the forward updates in place (flax's
``mutable=["batch_stats"]``).

In a process group the step calls its strategy's hooks
(parallel/strategies.py) where the JAX package's step does: the gradients
of the total loss are reduced after backward, the weights go through
``pre_update`` before the optimizer step and ``post_update`` after it, the
running averages through ``sync_batch_stats``, and the reported losses are
the mean over the ranks. Without a process group, or without a strategy,
it is the single-device step. With ``track_noise_scale`` and a world of at
least 2, the step also returns the gradient noise scale's per-step
estimates ``noise_scale_g2`` / ``noise_scale_s``, measured on the ranks'
gradients before the strategy reduces them (elastic.noise_scale_stats;
train_step.py:629-640 and :918-919 of the JAX package).

Loss scaling (train_step.py:263-279, :627-628, :668-683, :759-787 of the
JAX package): the total loss is multiplied by the scale before backward
and the gradients divided by it after. With the auto loss scale, a step
whose reduced gradients hold a non-finite value (one decision for every
rank: a MAX all-reduce of the flag) applies no update -- the weights, the
optimizer's state and the batch-norm running averages stay as they were
before the step -- halves the scale (not below 1) and zeroes the count of
clean steps; after ``inc_loss_scale_every_n`` clean steps the scale
doubles. The global step advances either way; the learning rate follows
the count of applied updates, as optax's schedule count does. All of it
is decided on the device, as in the JAX package: the update runs, and a
non-finite flag selects the state copied before the step back
(``torch.where``), so the step queues no host read.

Gradient accumulation (``num_grad_accum`` M > 1; train_step.py:510-615 of
the JAX package): the batch is split into M microbatches, each runs
forward and backward (batch-norm statistics per microbatch, the running
averages advancing M times), the gradients accumulate in f32 and are
divided by M once; the losses and accuracies reported are the means over
the microbatches. One reduction, one loss-scale decision and one
optimizer apply follow.

Sharded state (``sharding``, ops/sharded.py; train_step.py:185-262,
:410-480 and :640-725 of the JAX package): under --shard_optimizer_state
(ZeRO) the optimizer steps on this rank's flat shards; the gradients reach
them by reduce-scatter of the mean after the backward, and the updated
shards are all-gathered into the module's parameters. Under --shard_params
(FSDP) the shards are the parameters' only storage: the forward reads
them gathered bucket by bucket, and the gather's backward reduce-scatters
the gradients onto them; nothing is gathered after the update. With M > 1
the whole tree is gathered once and the accumulated gradient scattered
after the microbatches. The finite check runs on the shards (the same MAX
all-reduce), and a skipped step keeps the shards and their optimizer
state. Weight decay over a scanned block stack under FSDP is the
shard-local sum of squares plus one all-reduce: the exact value,
reassociated (the JAX package's ``_l2_loss_mixed``).

Overlapped reduction (``overlap``, ops/overlap.py): the gradients are
reduced bucket by bucket by hooks inside the backward, and the strategy's
post-hoc reduction is skipped; with M > 1 the hooks stand down and the
reduction is post hoc on the accumulated gradients.

Health stats (``health_stats``, --health_stats; train_step.py:309-321 and
:799-845 of the JAX package): the step also returns ``health``, the
telemetry.HEALTH_KEYS vector, computed on the device from the applied
gradients, the weights before the update and the optimizer's update
(optimizers.py notes its square sum during the apply). Each rank sums
the squares of a 1/n slice of every tensor, and those partials ride the
one all-reduce that already averages the losses: the step issues as many
collectives as without them. Not under sharded state or the sequential
apply, where no full update exists on one rank.

Stale modes (train_step.py:285-286, :391-397, :423-427, :687-699,
:763-770, :818-820 and :921-924 of the JAX package). ``staged_vars``
(--staged_vars): the forward, the backward and the L2 term read a staged
copy of the weights, which starts as the initial weights and after each
step takes that step's weights from before its update; the gradients
apply to the live weights, and the batch-norm averages stay live.
``relaxed`` (--variable_consistency=relaxed): the step applies the reduced
gradients banked by the previous step (zeros at the first) and banks its
own; under the auto loss scale a non-finite fresh gradient is not banked
(the old bank stays), the weights and the optimizer's state are not rolled
back (the bank holds finite gradients only, so the applied update always
lands) and the health stats' ``suppressed`` is 0. The staged copy and the
bank are device tensors of the step, written in place, so a captured step
carries them from replay to replay.

``TrainChunk`` runs up to K steps a dispatch (--steps_per_dispatch): on a
CUDA device the step captured as a CUDA graph and replayed.

``EvalStep`` is the forward-only and evaluation step (train_step.py:
1068-1105): the module in eval mode (batch norm from its running
averages, which it leaves untouched) under ``torch.no_grad``, top-1,
top-5 and the loss averaged over the ranks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import telemetry
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.ops import graphs
from kf_benchmarks_tpu_torch.ops import overlap as overlap_lib
from kf_benchmarks_tpu_torch.ops import sharded as sharded_lib
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.utils import log as log_util


def is_batch_norm_param(name: str) -> bool:
  """The JAX package's L2 filter (train_step.py:71-76): a parameter is
  excluded from weight decay when any component of its path contains
  "bn" or "batchnorm". Port names keep the flax layer names' ``_bn``, so
  the same test splits the same parameters (the Dense bias is decayed)."""
  return any("bn" in part.lower() or "batchnorm" in part.lower()
             for part in name.split("."))


def l2_loss(module: nn.Module, single_op: bool = False) -> torch.Tensor:
  """0.5 * sum of squares over the non-BN parameters, in f32
  (tf.nn.l2_loss semantics, train_step.py:78-94). ``single_op``
  (--single_l2_loss_op) concatenates them first. bf16 parameters
  (--fp16_vars) accumulate in f32 too, as the JAX package's
  ``astype(float32)`` does, without an f32 copy of any (``_sum_squares``;
  numerically the same value, so ``single_op`` is moot there)."""
  return _l2([p for name, p in module.named_parameters()
              if not is_batch_norm_param(name)], single_op)


class _SumSquares(torch.autograd.Function):
  """sum(leaf^2) of a 16-bit leaf in f32, with no f32 copy of the leaf on
  the card (telemetry.square_sums); the backward is 2 g leaf in the
  leaf's dtype, rounded once -- the JAX package's
  ``sum(square(leaf.astype(float32)))``, differentiated."""

  @staticmethod
  def forward(ctx, leaf):
    ctx.save_for_backward(leaf)
    return telemetry.square_sums([leaf])[0]

  @staticmethod
  def backward(ctx, g):
    (leaf,) = ctx.saved_tensors
    return leaf * (2.0 * g)


def _sum_squares(leaf: torch.Tensor) -> torch.Tensor:
  if leaf.dtype in (torch.float32, torch.float64):
    return torch.sum(torch.square(leaf))
  return _SumSquares.apply(leaf)


def _l2(leaves: List[torch.Tensor], single_op: bool) -> torch.Tensor:
  if not leaves:
    return torch.zeros(())
  if single_op and all(leaf.dtype in (torch.float32, torch.float64)
                       for leaf in leaves):
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    return 0.5 * torch.sum(flat * flat)
  return 0.5 * torch.stack([_sum_squares(leaf) for leaf in leaves]).sum()


def l2_loss_mixed(module: nn.Module, sharding, single_op: bool = False
                  ) -> torch.Tensor:
  """``l2_loss`` under FSDP for a module whose block stack is gathered
  block by block (train_step.py:96-125 of the JAX package): the gathered
  leaves keep the exact formula; the block stack's shards sum their
  squares on this rank and one all-reduce adds the ranks' sums (the pad
  adds nothing) -- the exact value, reassociated."""
  in_blocks = {i for b in sharding.block_buckets for i in b}
  full = [p for i, (name, p) in enumerate(module.named_parameters())
          if i not in in_blocks and not is_batch_norm_param(name)]
  shards = [sharding.shards[i] for i in sorted(in_blocks)
            if not is_batch_norm_param(sharding.names[i])]
  local = 0.5 * torch.stack([_sum_squares(s) for s in shards]).sum()
  return _l2(full, single_op) + sharded_lib.AllReduceSum.apply(local)


def batch_stats(module: nn.Module) -> List[torch.Tensor]:
  """The batch-norm running averages (mean, var of every batch norm), in
  module order: the JAX package's ``batch_stats`` collection."""
  return [b for m in module.modules()
          if isinstance(m, builder.CompactBatchNorm) for b in (m.mean, m.var)]


def loss_scale_settings(params) -> Tuple[float, bool]:
  """(initial loss scale, auto loss scale) as the JAX package resolves
  them for bfloat16 (train_step.py:263-279): --fp16_loss_scale when given
  under --use_fp16, else 1, as bfloat16 needs none. The port computes in
  bfloat16 or f32, never float16, so the model's float16 default
  (``Model.get_fp16_loss_scale``) is never the scale."""
  scale = 1.0
  if params.use_fp16 and params.fp16_loss_scale is not None:
    scale = float(params.fp16_loss_scale)
  return scale, bool(params.use_fp16 and params.fp16_enable_auto_loss_scale)


def _mean_over_ranks(values: List[torch.Tensor]) -> List[torch.Tensor]:
  """Each scalar's mean over the ranks (itself without a process group),
  by one all-reduce."""
  return list(_mean_vec_over_ranks(
      torch.stack([v.float() for v in values])).unbind())


def _mean_vec_over_ranks(vec: torch.Tensor) -> torch.Tensor:
  """An f32 vector's elementwise mean over the ranks, by one all-reduce."""
  if mesh.is_distributed():
    dist.all_reduce(vec, op=dist.ReduceOp.SUM)
    vec = vec / mesh.world_size()
  return vec


def tree_map(fn, tree):
  """``fn`` of each tensor of ``tree``: a tensor, or a tuple of trees (the
  labels of a detection model: boxes, classes, matched counts)."""
  if isinstance(tree, tuple):
    return tuple(tree_map(fn, t) for t in tree)
  return fn(tree)


def tree_copy_(dst, src) -> None:
  """Each tensor of the tree ``dst`` <- its counterpart in ``src``."""
  if isinstance(dst, tuple):
    for d, s in zip(dst, src):
      tree_copy_(d, s)
  else:
    dst.copy_(src)


def _microbatches(tree, m: int) -> list:
  """The tree cut into ``m`` trees along the batch axis."""
  if isinstance(tree, tuple):
    return list(zip(*[_microbatches(t, m) for t in tree]))
  return list(tree.chunk(m))


def _select_(finite: torch.Tensor, tensors: List[torch.Tensor],
             before: List[torch.Tensor]) -> None:
  """Each tensor <- itself where ``finite``, else its value ``before``:
  the skipped update, chosen on the device."""
  for t, old in zip(tensors, before):
    t.copy_(torch.where(finite, t, old))


class TrainStep:
  """One training step over a fixed module/optimizer pair.

  A call takes the model's inputs (NHWC images, or token ids) and int64
  labels on the module's device and returns the step's metrics as 0-d
  tensors on that device (reading one synchronises with the device; the
  caller decides when): the losses, the rate the update used, with
  ``print_accuracy`` also top-1 and top-5, and with a loss scale the scale
  after the step. ``run`` is the device work of a call alone: it reads the
  host's step count and changes no host state, so ``TrainChunk`` captures
  it as a CUDA graph.

  The state beside the weights and the optimizer's lives on the device:
  the update count (the rate's schedule reads it there), the loss scale
  and its count of clean steps. ``global_step`` counts the steps taken, on
  the host (it advances on every step). ``update_count``, ``loss_scale``
  and ``loss_scale_normal_steps`` read (and set) the device state.
  """

  def __init__(self, model, module: nn.Module,
               optimizer: torch.optim.Optimizer,
               lr_fn: Callable, weight_decay: float,
               strategy=None, track_noise_scale: bool = False,
               gradient_clip: Optional[float] = None,
               loss_scale: float = 1.0, auto_loss_scale: bool = False,
               inc_loss_scale_every_n: int = 1000,
               print_accuracy: bool = False, single_l2_loss_op: bool = False,
               num_grad_accum: int = 1,
               sharding: Optional[sharded_lib.ShardedState] = None,
               overlap: Optional[overlap_lib.OverlapSpec] = None,
               health_stats: bool = False, staged_vars: bool = False,
               relaxed: bool = False):
    self.model = model
    self.module = module
    self.optimizer = optimizer
    self.lr_fn = lr_fn
    self.weight_decay = weight_decay
    self.strategy = strategy
    self.track_noise_scale = track_noise_scale
    self.gradient_clip = gradient_clip
    self.auto_loss_scale = auto_loss_scale
    self.use_loss_scale = auto_loss_scale or loss_scale != 1.0
    self.inc_loss_scale_every_n = inc_loss_scale_every_n
    self.print_accuracy = print_accuracy
    self.single_l2_loss_op = single_l2_loss_op
    self.num_grad_accum = max(1, int(num_grad_accum))
    self.sharding = sharding
    # The in-backward reduction's hooks (ops/overlap.py); they stand down
    # under accumulation, where the reduction is post hoc.
    self._reducer = (overlap_lib.reducer_for(module, overlap)
                     if overlap is not None and self.num_grad_accum == 1
                     else None)
    if sharding is not None and sharding.block_buckets and weight_decay:
      log_util.log_fn(
          "shard_params: weight decay over the scanned parameter stack "
          "['blocks'] reduces shard-locally + one all-reduce (full blocks "
          "exist only one at a time inside the forward): exact L2 value, "
          "reassociated -- total_loss is not bit-identical to the "
          "replicated-param L2 on this model (pass --weight_decay=0 for "
          "bit-exact A/Bs)")
    device = next(module.parameters()).device
    # The count of steps taken on the device: the networks' dropout and
    # drop-path draws read it (builder.SeededDropout), so a captured step
    # draws a step's own values at each replay.
    self._step = torch.zeros((), dtype=torch.int64, device=device)
    self._global_step = 0
    self._rng_nets = [m for m in module.modules()
                      if isinstance(m, builder.SeededDropout)]
    for net in self._rng_nets:
      net.rng_step = self._step
      net.rng_replica = mesh.rank() if mesh.is_distributed() else 0
    self._update_count = torch.zeros((), dtype=torch.int64, device=device)
    self._loss_scale = torch.tensor(loss_scale, dtype=torch.float32,
                                    device=device)
    self._normal_steps = torch.zeros((), dtype=torch.int64, device=device)
    # The optimizer reads its rate from this tensor; each step writes the
    # schedule's rate at the update count into it.
    self._lr = torch.zeros((), dtype=torch.float32, device=device)
    optimizers.init_state(self.optimizer)
    self._kept = None  # the auto loss scale's copies of the state
    weights = [p.detach() for p in module.parameters()]
    # --staged_vars: the weights the forward reads (the initial weights at
    # first; checkpoint.reseed_staged after a restore), and the live weights'
    # place while it does.
    self.staged = ([w.clone() for w in weights] if staged_vars else None)
    self._live = ([torch.empty_like(w) for w in weights] if staged_vars
                  else None)
    # --variable_consistency=relaxed: the gradients the next step applies.
    self._bank = ([torch.zeros_like(w) for w in weights] if relaxed
                  else None)
    self._swap = None
    # The health stats (JAX train_step.py:309-321): not where no full
    # update exists on one rank.
    self.health = bool(health_stats and sharding is None and not (
        strategy is not None and strategy.sequential_apply))
    # This rank's slice (index, of num) of every tensor the stats read:
    # the ranks split the reads when the partials meet in the metrics
    # all-reduce.
    self._health_split = ((mesh.rank(), mesh.world_size())
                          if strategy is not None and mesh.is_distributed()
                          else (0, 1))
    self._health_parts = None
    if self.health:
      optimizer.track_update(*self._health_split)

  @property
  def global_step(self) -> int:
    """The count of steps taken (its device copy follows a set)."""
    return self._global_step

  @global_step.setter
  def global_step(self, value: int) -> None:
    self._global_step = int(value)
    self._step.fill_(self._global_step)

  def note_step(self) -> None:
    """The host's count of one more step that ``run`` took (``run``
    advances the device's)."""
    self._global_step += 1

  @property
  def update_count(self) -> int:
    return int(self._update_count)

  @update_count.setter
  def update_count(self, value: int) -> None:
    self._update_count.fill_(int(value))

  @property
  def loss_scale(self) -> float:
    return float(self._loss_scale)

  @loss_scale.setter
  def loss_scale(self, value: float) -> None:
    self._loss_scale.fill_(float(value))

  @property
  def loss_scale_normal_steps(self) -> int:
    return int(self._normal_steps)

  @loss_scale_normal_steps.setter
  def loss_scale_normal_steps(self, value: int) -> None:
    self._normal_steps.fill_(int(value))

  def counters(self) -> Dict[str, object]:
    """The state beside the weights and the optimizer's that a checkpoint
    carries."""
    return {"update_count": self.update_count,
            "loss_scale": self.loss_scale,
            "loss_scale_normal_steps": self.loss_scale_normal_steps}

  def restore_counters(self, snapshot: Dict) -> None:
    """``counters()`` back from a snapshot; one written before they were
    kept restores the update count as its step and the initial scale."""
    self.update_count = int(snapshot.get("update_count", self.global_step))
    self.loss_scale = float(snapshot.get("loss_scale", self.loss_scale))
    self.loss_scale_normal_steps = int(
        snapshot.get("loss_scale_normal_steps", 0))

  def step_class(self) -> int:
    """Which of the strategy's host-side step behaviours this step has
    (the pair-averaging partner; 0 for every other strategy): a graph
    captured at one class replays only that class."""
    strategy = self.strategy if mesh.is_distributed() else None
    if strategy is None:
      return 0
    return self.global_step % strategy.step_classes()

  def __call__(self, images: torch.Tensor,
               labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    metrics = self.run(images, labels)
    self.note_step()
    return metrics

  def _state_tensors(self) -> List[torch.Tensor]:
    """What a skipped step keeps: the weights (this rank's shards under
    sharded state), the optimizer's state and the batch-norm running
    averages; under relaxed consistency the averages and the gradient bank
    (the applied update lands either way)."""
    if self._bank is not None:
      return batch_stats(self.module) + self._bank
    weights = [p for g in self.optimizer.param_groups for p in g["params"]]
    opt_state = [v for p in weights for v in self.optimizer.state[p].values()
                 if isinstance(v, torch.Tensor)]
    return ([p.detach() for p in weights] + opt_state +
            batch_stats(self.module))

  def full_params(self):
    """A context in which the module's parameters read as their full
    values (gathered from the shards under FSDP)."""
    if self.sharding is None:
      return contextlib.nullcontext()
    return self.sharding.full_params(self.module)

  def full_weights(self) -> List[torch.Tensor]:
    """Copies of the module's full parameters, in module order."""
    with self.full_params():
      return [p.detach().clone() for p in self.module.parameters()]

  def _l2_loss(self) -> torch.Tensor:
    if self.sharding is not None and self.sharding.block_buckets:
      return l2_loss_mixed(self.module, self.sharding, self.single_l2_loss_op)
    return l2_loss(self.module, self.single_l2_loss_op)

  def run(self, images: torch.Tensor,
          labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    self.module.train()
    # (Again at every step: a restored optimizer state_dict brings its own
    # rate and may lack the state.)
    for group in self.optimizer.param_groups:
      group["lr"] = self._lr
    optimizers.init_state(self.optimizer)
    kept = None
    if self.auto_loss_scale:
      # The forward updates the running averages in place and the update
      # the weights and the optimizer's state; a skipped step selects these
      # copies back.
      state = self._state_tensors()
      if self._kept is None or len(self._kept) != len(state):
        self._kept = [torch.empty_like(t) for t in state]
      kept = self._kept
      torch._foreach_copy_(kept, state)
    self.optimizer.zero_grad(set_to_none=True)
    self.module.zero_grad(set_to_none=True)
    strategy = self.strategy if mesh.is_distributed() else None
    if self._reducer is not None and strategy is not None:
      self._reducer.begin()
    weights = None
    if self.staged is not None:
      # The forward and the backward read the staged copy.
      weights = [p.detach() for p in self.module.parameters()]
      torch._foreach_copy_(self._live, weights)
      torch._foreach_copy_(weights, self.staged)
    m = self.num_grad_accum
    sums = None
    acc_keys = []
    parts = (zip(images.chunk(m), _microbatches(labels, m)) if m > 1
             else [(images, labels)])
    with (self.sharding.step_params(self.module) if self.sharding is not None
          else contextlib.nullcontext()):
      for i, (x, y) in enumerate(parts):
        for net in self._rng_nets:
          net.rng_microbatch = i
        logits = self.module(x)
        base_loss = self.model.loss_function(logits, y)
        total_loss = base_loss
        if self.weight_decay:
          total_loss = total_loss + self.weight_decay * self._l2_loss()
        if self.use_loss_scale:
          (total_loss * self._loss_scale).backward()
        else:
          total_loss.backward()
        values = [base_loss.detach(), total_loss.detach()]
        if self.print_accuracy:
          with torch.no_grad():
            acc = self.model.accuracy_function(logits, y)
          acc_keys = [k for k in ("top_1_accuracy", "top_5_accuracy")
                      if k in acc]
          values += [acc[k] for k in acc_keys]
        del logits
        sums = (values if sums is None
                else [a + b for a, b in zip(sums, values)])
    if weights is not None:
      # The live weights back for the update; the next step reads this
      # step's weights from before it.
      torch._foreach_copy_(weights, self._live)
      torch._foreach_copy_(self.staged, self._live)
    if m > 1:
      # The means over the microbatches (JAX train_step.py:510-615).
      sums = [v / m for v in sums]
    metrics = {}
    with torch.no_grad():
      rate = self.lr_fn(self._update_count.float())
      if isinstance(rate, torch.Tensor):
        self._lr.copy_(rate)
      else:
        self._lr.fill_(float(rate))
      finite = self._update(strategy, metrics, images.shape[0])
      health_vec = None
      if self.health:
        grad_sq, param_sq = self._health_parts
        self._health_parts = None
        upd_sq = self.optimizer.update_sq
        health_vec = telemetry.pack_partials(
            grad_sq, param_sq.new_zeros(()) if upd_sq is None else upd_sq,
            param_sq, self._health_split[1])
      if finite is None:
        self._update_count.add_(1)
      else:
        _select_(finite, self._state_tensors(), kept)
        # Under relaxed consistency the optimizer's count advances with its
        # state, which no skip rolls back.
        self._update_count.add_(1 if self._bank is not None
                                else finite.long())
        self._next_loss_scale(finite)
      if self.sharding is not None:
        self.sharding.after_update()
      self._step.add_(1)
      # The health partials ride the losses' all-reduce: one collective
      # either way (JAX train_step.py:799-845).
      vec = torch.stack([v.float() for v in sums])
      if health_vec is not None:
        vec = torch.cat([vec, health_vec])
      if strategy is not None:
        vec = _mean_vec_over_ranks(vec)
      metrics.update(zip(["base_loss", "total_loss"] + acc_keys,
                         vec[:len(sums)].unbind()))
      metrics["learning_rate"] = self._lr.clone()
      if self.use_loss_scale:
        metrics["loss_scale"] = self._loss_scale.clone()
      if health_vec is not None:
        skipped = (torch.zeros((), device=vec.device) if finite is None
                   else 1.0 - finite.float())
        suppressed = (torch.zeros_like(skipped) if self._bank is not None
                      else skipped)
        metrics["health"] = telemetry.health_finalize(
            vec[len(sums):], self._loss_scale, skipped, suppressed)
    return metrics

  def _update(self, strategy, metrics, batch_size) -> Optional[torch.Tensor]:
    """Average the accumulated gradients, unscale, reduce and apply them
    with the strategy's hooks (none without a process group). With the
    auto loss scale, returns the device flag of finite gradients (the
    caller keeps the old state where it is false); else None. Under
    sharded state the gradients and the apply are the shards'; under the
    overlapped reduction the hooks have reduced the gradients."""
    if self.sharding is not None:
      grads = self.sharding.reduce_gradients(
          self.num_grad_accum,
          self._loss_scale if self.use_loss_scale else None)
      finite = (self._all_finite(grads, strategy is not None)
                if self.auto_loss_scale else None)
      self._apply(grads)
      if strategy is not None:
        strategy.sync_batch_stats(batch_stats(self.module))
      return finite
    reduced = self._reducer is not None and self._reducer.active
    if reduced:
      self._reducer.finish()
    step = self.global_step
    params = [p for p in self.module.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    if self.num_grad_accum > 1:
      torch._foreach_div_(grads, float(self.num_grad_accum))
    if self.use_loss_scale:
      torch._foreach_div_(grads, self._loss_scale)
    if (strategy is not None and self.track_noise_scale and
        mesh.world_size() > 1):
      metrics["noise_scale_g2"], metrics["noise_scale_s"] = \
          elastic.noise_scale_stats(grads, batch_size)
    if strategy is not None and not reduced:
      strategy.reduce_gradients(grads)
    finite = None
    if self.auto_loss_scale:
      finite = self._all_finite(grads, strategy is not None)
    if self._bank is not None:
      self._apply_bank(params, grads)
    weights = [p.detach() for p in params]
    if self.health:
      # The applied gradients (before the clip, which is the optimizer's
      # in optax) and the weights before the in-place update.
      self._health_parts = (
          telemetry.sumsq_partials(grads, *self._health_split),
          telemetry.sumsq_partials(weights, *self._health_split).sum())
    if strategy is not None:
      strategy.pre_update(weights, step)
    if strategy is not None and strategy.sequential_apply:
      self._sequential_apply(params)
    else:
      self._apply(grads)
    if strategy is not None:
      strategy.post_update(weights, step)
      strategy.sync_batch_stats(batch_stats(self.module))
    return finite

  def _apply_bank(self, params, grads: List[torch.Tensor]) -> None:
    """Relaxed consistency: the gradients <- the bank, the bank <- the
    fresh gradients, by device copies (a captured step replays them on the
    same buffers). A non-finite fresh gradient's banking is undone with the
    skipped step (``_state_tensors``)."""
    with_grad = {id(p) for p in params}
    bank = [b for p, b in zip(self.module.parameters(), self._bank)
            if id(p) in with_grad]
    if self._swap is None or len(self._swap) != len(bank):
      self._swap = [torch.empty_like(b) for b in bank]
    torch._foreach_copy_(self._swap, bank)
    torch._foreach_copy_(bank, grads)
    torch._foreach_copy_(grads, self._swap)

  def _apply(self, grads: List[torch.Tensor]) -> None:
    if self.gradient_clip is not None:
      optimizers.clip_gradients_(grads, self.gradient_clip)
    self.optimizer.step()

  @staticmethod
  def _all_finite(grads: List[torch.Tensor],
                  across_ranks: bool) -> torch.Tensor:
    """The device flag: every gradient element finite, on every rank."""
    found = torch.zeros(1, device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.ones(1, device=found.device))
    if across_ranks:
      dist.all_reduce(found, op=dist.ReduceOp.MAX)
    return found[0] == 0

  def _next_loss_scale(self, finite: torch.Tensor) -> None:
    """The JAX package's state machine (train_step.py:759-787), on the
    device in its f32 arithmetic (a doubling past the f32 range is inf,
    and stays inf)."""
    normal = torch.where(finite, self._normal_steps + 1,
                         torch.zeros_like(self._normal_steps))
    double = finite & (normal >= self.inc_loss_scale_every_n)
    scale = self._loss_scale
    self._loss_scale.copy_(torch.where(
        finite, torch.where(double, scale * 2.0, scale),
        torch.clamp(scale / 2.0, min=1.0)))
    self._normal_steps.copy_(torch.where(double, torch.zeros_like(normal),
                                         normal))

  def _sequential_apply(self, params: List[torch.nn.Parameter]) -> None:
    """Every rank's gradient applied in rank order through this rank's
    optimizer state (the async parameter server with a stateful optimizer):
    one all-gather of the flat gradients, then n optimizer steps at this
    step's rate. Each application sees the round's update count in the
    optimizer's state (Adam's bias correction), as the JAX package's
    _sync_schedule_counts makes optax's counts: each count is copied on
    the device before the first application and copied back before each
    later one, so nothing is read to the host and a captured step replays
    the counts of the step it runs."""
    n = mesh.world_size()
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    gathered = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(gathered, flat)
    counts = [(st["step"], st["step"].clone())
              for st in (self.optimizer.state.get(p, {}) for p in params)
              if "step" in st]
    for r in range(n):
      offset = r * flat.numel()
      for p in params:
        p.grad.copy_(gathered[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()
      if r:
        for count, before in counts:
          count.copy_(before)
      self._apply([p.grad for p in params])


class TrainChunk:
  """Up to K training steps a dispatch (--steps_per_dispatch): the port's
  counterpart of the JAX package's ``train_chunk`` (train_step.py:
  1036-1064), K steps of one program.

  A call runs ``d`` (1 <= d <= K) steps of ``step`` and returns each metric
  as a (d, *shape) tensor in step order (the health vector's rows are
  (d, 5)). The steps read one resident batch (the synthetic input), or,
  with ``offset``, a staged (S, B, ...) chunk of real data: step j reads
  slot ``offset + j``, so a short dispatch reads fewer slots. On the CPU,
  where the
  caller has asked for the CPU, the d steps run one after another. On a
  CUDA device the first call runs its first step eagerly on a side stream
  (which builds and loads every kernel, makes the optimizer's state and
  lets cuBLAS and cuDNN pick their algorithms), then captures ``step.run``
  as a CUDA graph and replays it for the others: a dispatch of d steps is d
  graph launches and no other host work. Step j's metrics land in a row of
  a device (K, width) buffer through a device row counter, so the host reads
  them once a dispatch; a call returns copies of its rows, which later
  dispatches do not overwrite. The graph reads the inputs, the rate, the
  loss scale and the counters from fixed device tensors: the chunk's own
  copies of the first batch, into which each later call copies its batch,
  or, from a staged chunk, each replay's slot before that replay (the
  caller's tensors are never written). A strategy whose
  step has host-side classes (pair averaging's partner) has one graph per
  class, sharing one memory pool. There is no eager path on the card: a
  capture or replay failure raises.
  """

  def __init__(self, step: TrainStep, k: int):
    if k < 1:
      raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    self.step = step
    self.k = k
    self.keys: Optional[Tuple[str, ...]] = None
    self._shapes: Dict[str, Tuple[int, ...]] = {}
    self._graphs: Dict[int, graphs.Graph] = {}
    self._inputs = None
    self._rows = None       # (K, width) f32 metrics, one row a step
    self._row = None        # (1,) int64: the row the next replay writes
    self._next_row = 0      # its host mirror

  @property
  def captured(self) -> bool:
    """Whether a call replays graphs (the first call on a card captures
    them; on the CPU there are none)."""
    return bool(self._graphs)

  def __call__(self, images: torch.Tensor, labels: torch.Tensor,
               d: int, offset: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    if not 1 <= d <= self.k:
      raise ValueError(f"a dispatch runs 1..{self.k} steps, got {d}")
    if offset is not None and not 0 <= offset <= images.shape[0] - d:
      raise ValueError(f"slots {offset}..{offset + d - 1} of a chunk of "
                       f"{images.shape[0]}")

    def batch(j):
      if offset is None:
        return images, labels
      return images[offset + j], tree_map(lambda t: t[offset + j], labels)

    if images.device.type != "cuda":
      rows = [self.step(*batch(j)) for j in range(d)]
      return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
    first = None
    j0 = 0
    if self._inputs is None:
      first = graphs.on_side_stream(lambda: self.step(*batch(0)))
      self.keys = tuple(first)
      self._shapes = {key: tuple(first[key].shape) for key in self.keys}
      self._inputs = tree_map(torch.clone, batch(0))
      dev = images.device
      width = sum(first[key].numel() for key in self.keys)
      self._rows = torch.zeros(self.k, width, dtype=torch.float32,
                               device=dev)
      self._row = torch.zeros(1, dtype=torch.int64, device=dev)
      j0 = 1
    elif offset is None:
      tree_copy_(self._inputs, (images, labels))
    d -= j0
    if self._next_row + d > self.k:
      self._row.zero_()
      self._next_row = 0
    start = self._next_row
    for j in range(j0, j0 + d):
      if offset is not None:
        tree_copy_(self._inputs, batch(j))
      self._graph(self.step.step_class()).replay()
      self.step.note_step()
    self._next_row += d
    out, off = {}, 0
    for key in self.keys:
      shape = self._shapes[key]
      size = math.prod(shape)
      out[key] = self._rows[start:start + d, off:off + size].reshape(
          (d,) + shape).clone()
      off += size
    if first is not None:
      out = {key: torch.cat([first[key].float().reshape(
          (1,) + self._shapes[key]), out[key]]) for key in self.keys}
    return out

  def _graph(self, cls: int) -> graphs.Graph:
    if cls not in self._graphs:
      images, labels = self._inputs
      pool = (self._graphs[min(self._graphs)].pool() if self._graphs
              else None)

      def body():
        m = self.step.run(images, labels)
        if tuple(m) != self.keys:
          raise RuntimeError(f"the captured step's metrics {tuple(m)} are "
                             f"not the eager step's {self.keys}")
        vec = torch.cat([m[key].float().reshape(-1) for key in self.keys])
        self._rows.index_copy_(0, self._row, vec.unsqueeze(0))
        self._row.add_(1)

      self._graphs[cls] = graphs.Graph(body, pool=pool)
    return self._graphs[cls]


class EvalStep:
  """The forward-only / evaluation step: the module in eval mode under
  ``torch.no_grad``; returns top-1, top-5 and the loss (as ``base_loss``
  and ``total_loss``), each the mean over the ranks, as tensors on the
  module's device. The module is back in training mode afterwards."""

  def __init__(self, model, module: nn.Module,
               full_params: Optional[Callable] = None):
    self.model = model
    self.module = module
    # A context in which the module's parameters read whole (the train
    # step's ``full_params`` under FSDP), or None.
    self.full_params = full_params or contextlib.nullcontext

  @torch.no_grad()
  def __call__(self, images: torch.Tensor,
               labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    self.module.eval()
    try:
      with self.full_params():
        logits = self.module(images)
      acc = self.model.accuracy_function(logits, labels)
      loss = self.model.loss_function(logits, labels)
    finally:
      self.module.train()
    top1, top5, loss = _mean_over_ranks(
        [acc["top_1_accuracy"], acc["top_5_accuracy"], loss])
    return {"top_1_accuracy": top1, "top_5_accuracy": top5,
            "base_loss": loss, "total_loss": loss}
