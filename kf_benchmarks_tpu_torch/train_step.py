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
the count of applied updates, as optax's schedule count does. The finite
check reads one flag on the host, so an auto-scaled step waits for its
backward before it queues the update.

``EvalStep`` is the forward-only and evaluation step (train_step.py:
1068-1105): the module in eval mode (batch norm from its running
averages, which it leaves untouched) under ``torch.no_grad``, top-1,
top-5 and the loss averaged over the ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.ops.conv_bn import accum
from kf_benchmarks_tpu_torch.parallel import mesh


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
  (--single_l2_loss_op) concatenates them first."""
  leaves = [accum(p) for name, p in module.named_parameters()
            if not is_batch_norm_param(name)]
  if not leaves:
    return torch.zeros(())
  if single_op:
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    return 0.5 * torch.sum(flat * flat)
  return 0.5 * torch.stack([torch.sum(torch.square(leaf))
                            for leaf in leaves]).sum()


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


def _f32(x: float) -> float:
  """``x`` rounded to f32."""
  return torch.tensor(x, dtype=torch.float32).item()


def _mean_over_ranks(values: List[torch.Tensor]) -> List[torch.Tensor]:
  """Each scalar's mean over the ranks (itself without a process group),
  by one all-reduce."""
  vec = torch.stack([v.float() for v in values])
  if mesh.is_distributed():
    dist.all_reduce(vec, op=dist.ReduceOp.SUM)
    vec = vec / mesh.world_size()
  return list(vec.unbind())


class TrainStep:
  """One training step over a fixed module/optimizer pair.

  A call takes the model's inputs (NHWC images, or token ids) and int64
  labels on the module's device and returns the step's losses as tensors
  on that device (reading them synchronises with the device; the caller
  decides when) and its rate; with ``print_accuracy`` also top-1 and
  top-5, and with a loss scale the scale after the step. ``global_step``
  counts the steps taken, ``update_count`` the updates applied (fewer
  when the auto loss scale skipped some), ``loss_scale`` and
  ``loss_scale_normal_steps`` are the loss-scale state.
  """

  def __init__(self, model, module: nn.Module,
               optimizer: torch.optim.Optimizer,
               lr_fn: Callable[[int], float], weight_decay: float,
               strategy=None, track_noise_scale: bool = False,
               gradient_clip: Optional[float] = None,
               loss_scale: float = 1.0, auto_loss_scale: bool = False,
               inc_loss_scale_every_n: int = 1000,
               print_accuracy: bool = False, single_l2_loss_op: bool = False):
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
    self.global_step = 0
    self.update_count = 0
    self.loss_scale = _f32(loss_scale)
    self.loss_scale_normal_steps = 0

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

  def __call__(self, images: torch.Tensor,
               labels: torch.Tensor) -> Dict[str, object]:
    self.module.train()
    stats_before = None
    if self.auto_loss_scale:
      # The forward updates the running averages in place; a skipped step
      # puts these back.
      stats_before = [b.clone() for b in batch_stats(self.module)]
    logits = self.module(images)
    base_loss = self.model.loss_function(logits, labels)
    total_loss = base_loss
    if self.weight_decay:
      total_loss = total_loss + self.weight_decay * l2_loss(
          self.module, self.single_l2_loss_op)
    self.optimizer.zero_grad(set_to_none=True)
    if self.use_loss_scale:
      (total_loss * self.loss_scale).backward()
    else:
      total_loss.backward()
    metrics = {}
    if self.print_accuracy:
      with torch.no_grad():
        metrics.update(self.model.accuracy_function(logits, labels))
    lr = self.lr_fn(self.update_count)
    for group in self.optimizer.param_groups:
      group["lr"] = lr
    strategy = self.strategy if mesh.is_distributed() else None
    with torch.no_grad():
      applied = self._update(strategy, metrics, images.shape[0])
    if applied:
      self.update_count += 1
    elif stats_before is not None:
      with torch.no_grad():
        for b, old in zip(batch_stats(self.module), stats_before):
          b.copy_(old)
    if self.auto_loss_scale:
      self._next_loss_scale(applied)
    self.global_step += 1
    scalars = [base_loss.detach(), total_loss.detach()]
    acc_keys = [k for k in ("top_1_accuracy", "top_5_accuracy")
                if k in metrics]
    scalars += [metrics[k] for k in acc_keys]
    if strategy is not None:
      scalars = _mean_over_ranks(scalars)
    metrics.update(zip(["base_loss", "total_loss"] + acc_keys, scalars))
    metrics["learning_rate"] = lr
    if self.use_loss_scale:
      metrics["loss_scale"] = self.loss_scale
    return metrics

  def _update(self, strategy, metrics, batch_size) -> bool:
    """Unscale, reduce and apply the gradients with the strategy's hooks
    (none without a process group); False when the auto loss scale found
    a non-finite gradient and applied nothing."""
    step = self.global_step
    params = [p for p in self.module.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    if self.use_loss_scale:
      torch._foreach_div_(grads, self.loss_scale)
    if (strategy is not None and self.track_noise_scale and
        mesh.world_size() > 1):
      metrics["noise_scale_g2"], metrics["noise_scale_s"] = \
          elastic.noise_scale_stats(grads, batch_size)
    if strategy is not None:
      strategy.reduce_gradients(grads)
    if self.auto_loss_scale and not self._all_finite(grads,
                                                      strategy is not None):
      return False
    weights = [p.detach() for p in params]
    if strategy is not None:
      strategy.pre_update(weights, step)
    if strategy is not None and strategy.sequential_apply:
      self._sequential_apply(params)
    else:
      self._apply(grads)
    if strategy is not None:
      strategy.post_update(weights, step)
      strategy.sync_batch_stats(batch_stats(self.module))
    return True

  def _apply(self, grads: List[torch.Tensor]) -> None:
    if self.gradient_clip is not None:
      optimizers.clip_gradients_(grads, self.gradient_clip)
    self.optimizer.step()

  @staticmethod
  def _all_finite(grads: List[torch.Tensor], across_ranks: bool) -> bool:
    """Whether every gradient element is finite, on every rank."""
    found = torch.zeros(1, device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.ones(1, device=found.device))
    if across_ranks:
      dist.all_reduce(found, op=dist.ReduceOp.MAX)
    return not bool(found.item())

  def _next_loss_scale(self, finite: bool) -> None:
    """The JAX package's state machine, in its f32 arithmetic (a doubling
    past the f32 range is inf, and stays inf)."""
    if not finite:
      self.loss_scale = _f32(max(self.loss_scale / 2.0, 1.0))
      self.loss_scale_normal_steps = 0
      return
    self.loss_scale_normal_steps += 1
    if self.loss_scale_normal_steps >= self.inc_loss_scale_every_n:
      self.loss_scale = _f32(self.loss_scale * 2.0)
      self.loss_scale_normal_steps = 0

  def _sequential_apply(self, params: List[torch.nn.Parameter]) -> None:
    """Every rank's gradient applied in rank order through this rank's
    optimizer state (the async parameter server with a stateful optimizer):
    one all-gather of the flat gradients, then n optimizer steps at this
    step's rate. Each application sees the round's update count in the
    optimizer's state (Adam's bias correction), as the JAX package's
    _sync_schedule_counts makes optax's counts."""
    n = mesh.world_size()
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    gathered = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(gathered, flat)
    counts = {p: float(self.optimizer.state[p]["step"])
              if "step" in self.optimizer.state.get(p, {}) else 0.0
              for p in params}
    for r in range(n):
      offset = r * flat.numel()
      for p in params:
        p.grad.copy_(gathered[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()
        if r and "step" in self.optimizer.state.get(p, {}):
          self.optimizer.state[p]["step"].fill_(counts[p])
      self._apply([p.grad for p in params])


class EvalStep:
  """The forward-only / evaluation step: the module in eval mode under
  ``torch.no_grad``; returns top-1, top-5 and the loss (as ``base_loss``
  and ``total_loss``), each the mean over the ranks, as tensors on the
  module's device. The module is back in training mode afterwards."""

  def __init__(self, model, module: nn.Module):
    self.model = model
    self.module = module

  @torch.no_grad()
  def __call__(self, images: torch.Tensor,
               labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    self.module.eval()
    try:
      logits = self.module(images)
      acc = self.model.accuracy_function(logits, labels)
      loss = self.model.loss_function(logits, labels)
    finally:
      self.module.train()
    top1, top5, loss = _mean_over_ranks(
        [acc["top_1_accuracy"], acc["top_5_accuracy"], loss])
    return {"top_1_accuracy": top1, "top_5_accuracy": top5,
            "base_loss": loss, "total_loss": loss}
