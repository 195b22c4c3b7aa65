"""The single-replica training step.

The port's counterpart of kf_benchmarks_tpu/train_step.py for one device:
forward in the compute dtype (explicit casts, as flax's ``dtype=``; no
autocast), softmax cross-entropy plus ``weight_decay * l2_loss`` over the
non-BN parameters, backward, the optimizer step at this step's learning
rate, and the batch-norm running averages, which the forward updates in
place (flax's ``mutable=["batch_stats"]``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from kf_benchmarks_tpu_torch.ops.conv_bn import accum


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


class TrainStep:
  """One training step over a fixed module/optimizer pair.

  A call takes the model's inputs (NHWC images, or token ids) and int64
  labels on the module's device and returns the step's losses as tensors
  on that device (reading them synchronises with the device; the caller
  decides when) and its rate.
  """

  def __init__(self, model, module: nn.Module,
               optimizer: torch.optim.Optimizer,
               lr_fn: Callable[[int], float], weight_decay: float):
    self.model = model
    self.module = module
    self.optimizer = optimizer
    self.lr_fn = lr_fn
    self.weight_decay = weight_decay
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
    self.optimizer.step()
    self.global_step += 1
    return {"base_loss": base_loss.detach(),
            "total_loss": total_loss.detach(),
            "learning_rate": lr}
