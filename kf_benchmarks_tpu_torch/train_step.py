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
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist
import torch.nn as nn

from kf_benchmarks_tpu_torch import elastic
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


def l2_loss(module: nn.Module) -> torch.Tensor:
  """0.5 * sum of squares over the non-BN parameters, in f32
  (tf.nn.l2_loss semantics, train_step.py:78-94)."""
  terms = [torch.sum(torch.square(accum(p)))
           for name, p in module.named_parameters()
           if not is_batch_norm_param(name)]
  if not terms:
    return torch.zeros(())
  return 0.5 * torch.stack(terms).sum()


def batch_stats(module: nn.Module) -> List[torch.Tensor]:
  """The batch-norm running averages (mean, var of every batch norm), in
  module order: the JAX package's ``batch_stats`` collection."""
  return [b for m in module.modules()
          if isinstance(m, builder.CompactBatchNorm) for b in (m.mean, m.var)]


class TrainStep:
  """One training step over a fixed module/optimizer pair.

  A call takes the model's inputs (NHWC images, or token ids) and int64
  labels on the module's device and returns the step's losses as tensors
  on that device (reading them synchronises with the device; the caller
  decides when) and its rate.
  """

  def __init__(self, model, module: nn.Module,
               optimizer: torch.optim.Optimizer,
               lr_fn: Callable[[int], float], weight_decay: float,
               strategy=None, track_noise_scale: bool = False):
    self.model = model
    self.module = module
    self.optimizer = optimizer
    self.lr_fn = lr_fn
    self.weight_decay = weight_decay
    self.strategy = strategy
    self.track_noise_scale = track_noise_scale
    self.global_step = 0

  def __call__(self, images: torch.Tensor,
               labels: torch.Tensor) -> Dict[str, object]:
    self.module.train()
    logits = self.module(images)
    base_loss = self.model.loss_function(logits, labels)
    total_loss = base_loss
    if self.weight_decay:
      total_loss = total_loss + self.weight_decay * l2_loss(self.module)
    self.optimizer.zero_grad(set_to_none=True)
    total_loss.backward()
    lr = self.lr_fn(self.global_step)
    for group in self.optimizer.param_groups:
      group["lr"] = lr
    strategy = self.strategy if mesh.is_distributed() else None
    metrics = {}
    if strategy is None:
      self.optimizer.step()
    else:
      base_loss, total_loss = self._data_parallel_update(
          strategy, base_loss.detach(), total_loss.detach(), metrics,
          images.shape[0])
    self.global_step += 1
    metrics.update({"base_loss": base_loss.detach(),
                    "total_loss": total_loss.detach(),
                    "learning_rate": lr})
    return metrics

  @torch.no_grad()
  def _data_parallel_update(self, strategy, base_loss, total_loss, metrics,
                            batch_size):
    """The update with the strategy's hooks; returns the losses' mean over
    the ranks (and puts the noise-scale estimates into ``metrics``)."""
    step = self.global_step
    params = [p for p in self.module.parameters() if p.grad is not None]
    weights = [p.detach() for p in params]
    if self.track_noise_scale and mesh.world_size() > 1:
      metrics["noise_scale_g2"], metrics["noise_scale_s"] = \
          elastic.noise_scale_stats([p.grad for p in params], batch_size)
    strategy.reduce_gradients([p.grad for p in params])
    strategy.pre_update(weights, step)
    if strategy.sequential_apply:
      self._sequential_apply(params)
    else:
      self.optimizer.step()
    strategy.post_update(weights, step)
    strategy.sync_batch_stats(batch_stats(self.module))
    losses = torch.stack([base_loss.float(), total_loss.float()])
    dist.all_reduce(losses, op=dist.ReduceOp.SUM)
    losses = losses / mesh.world_size()
    return losses[0], losses[1]

  def _sequential_apply(self, params: List[torch.nn.Parameter]) -> None:
    """Every rank's gradient applied in rank order through this rank's
    optimizer state (the async parameter server with a stateful optimizer):
    one all-gather of the flat gradients, then n optimizer steps at this
    step's rate."""
    n = mesh.world_size()
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    gathered = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(gathered, flat)
    for r in range(n):
      offset = r * flat.numel()
      for p in params:
        p.grad.copy_(gathered[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()
      self.optimizer.step()
