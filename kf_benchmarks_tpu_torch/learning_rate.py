"""Learning-rate policy: the model-default path of the JAX package's
learning_rate.py (make_learning_rate_fn, last branch).

This slice runs neither a piecewise schedule, an explicit initial rate nor
extra warmup flags, so the rate is the model's own schedule of the global
step, at the effective batch size: the per-device batch, times the number
of ranks when the strategy averages gradients over them
(kf_benchmarks_tpu/benchmark.py:536-546).
"""

from __future__ import annotations

from typing import Callable


def effective_batch_size(batch_size: int, num_replicas: int,
                         cross_replica: bool) -> int:
  return batch_size * (num_replicas if cross_replica else 1)


def make_learning_rate_fn(model, batch_size: int) -> Callable[[int], float]:
  def lr_fn(step: int) -> float:
    return float(model.get_learning_rate(step, batch_size))
  return lr_fn
