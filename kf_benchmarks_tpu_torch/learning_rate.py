"""Learning-rate policy: the port's counterpart of the JAX package's
learning_rate.py (ref: benchmark_cnn.py:1067-1169).

Priority: a piecewise 'LR0;E1;LR1;...' schedule, then
--init_learning_rate with exponential decay and a floor, then the model's
own schedule; linear warmup over --num_learning_rate_warmup_epochs on top.
Each is a function of the step with a host form (an int step, Python
floats) and a device form (a 0-d f32 tensor step, the JAX package's f32
arithmetic on the device). Epochs count batches at the effective
batch: the per-device batch, times the number of ranks when the strategy
averages gradients over them (kf_benchmarks_tpu/benchmark.py:536-546).
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch


def effective_batch_size(batch_size: int, num_replicas: int,
                         cross_replica: bool) -> int:
  return batch_size * (num_replicas if cross_replica else 1)


def parse_piecewise_schedule(schedule_str: str
                             ) -> Tuple[List[float], List[int]]:
  """Parse 'LR0;E1;LR1;...;En;LRn' (ref: benchmark_cnn.py:1067-1101) into
  (values, epoch boundaries): LR and epoch tokens alternate, and the epochs
  are strictly increasing positive ints."""
  pieces = schedule_str.split(";")
  if len(pieces) % 2 == 0:
    raise ValueError("--piecewise_learning_rate_schedule must have an odd "
                     "number of components")
  values, boundaries = [], []
  for i, piece in enumerate(pieces):
    if i % 2 == 0:
      try:
        values.append(float(piece))
      except ValueError:
        raise ValueError(f"Invalid learning rate: {piece!r}")
    else:
      try:
        boundaries.append(int(piece))
      except ValueError:
        raise ValueError(f"Invalid epoch: {piece!r}")
  if any(b <= a for a, b in zip(boundaries, boundaries[1:])) or (
      boundaries and boundaries[0] <= 0):
    raise ValueError("Epochs must be positive and increasing")
  return values, boundaries


def where(cond, a, b):
  """``a if cond else b``: a host bool picks, a tensor condition selects
  on its device (the device form of a schedule)."""
  if isinstance(cond, torch.Tensor):
    return torch.where(cond, a, b)
  return a if cond else b


def make_learning_rate_fn(params, model, batch_size: int,
                          num_examples_per_epoch: int
                          ) -> Callable[[Any], Any]:
  """The rate of each step (ref: benchmark_cnn.py:1104-1169).
  ``batch_size`` is the effective batch (``effective_batch_size``).

  The returned function has two forms. Given an int it is the host form:
  a Python float (logging, tests). Given a 0-d f32 tensor of the update
  count it is the device form: the rate as a 0-d f32 tensor on that
  tensor's device, computed there in f32 as the JAX package's optax
  schedule computes it from its count inside the program. The train step
  reads only the device form, so an eager step and its captured graph
  replay read the same rate."""
  num_batches_per_epoch = num_examples_per_epoch / float(batch_size)

  if params.piecewise_learning_rate_schedule:
    values, boundaries = parse_piecewise_schedule(
        params.piecewise_learning_rate_schedule)

    def lr_fn(step):
      lr = values[0]
      for epoch, v in zip(boundaries, values[1:]):
        lr = where(step >= epoch * num_batches_per_epoch, v, lr)
      return lr
  elif params.init_learning_rate is not None:
    init_lr = params.init_learning_rate

    def lr_fn(step):
      lr = init_lr
      if params.num_epochs_per_decay and params.learning_rate_decay_factor:
        decay_steps = params.num_epochs_per_decay * num_batches_per_epoch
        if isinstance(step, torch.Tensor):
          lr = init_lr * torch.pow(params.learning_rate_decay_factor,
                                   torch.floor(step / decay_steps))
          if params.minimum_learning_rate:
            lr = torch.clamp(lr, min=params.minimum_learning_rate)
        else:
          lr = init_lr * params.learning_rate_decay_factor ** math.floor(
              step / decay_steps)
          if params.minimum_learning_rate:
            lr = max(lr, params.minimum_learning_rate)
      return lr
  else:

    def lr_fn(step):
      return model.get_learning_rate(step, batch_size)

  if params.num_learning_rate_warmup_epochs:
    warmup_steps = (params.num_learning_rate_warmup_epochs *
                    num_batches_per_epoch)
    base_fn = lr_fn

    def lr_fn(step):  # noqa: F811
      lr = base_fn(step)
      return where(step < warmup_steps, lr * step / max(warmup_steps, 1.0),
                   lr)

  def rate(step):
    lr = lr_fn(step)
    if not isinstance(step, torch.Tensor):
      return float(lr)
    if isinstance(lr, torch.Tensor):
      return lr.to(torch.float32)
    # A constant: a fill on the device (no host-to-device copy, which a
    # CUDA graph capture refuses).
    return torch.full((), lr, dtype=torch.float32, device=step.device)

  return rate
