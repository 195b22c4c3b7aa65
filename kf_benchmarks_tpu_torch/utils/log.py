"""Logging and per-step performance statistics.

The port's own copy of kf_benchmarks_tpu/utils/log.py:14-66: the step line
and the total line are byte-for-byte the JAX package's (and the reference
tf_cnn_benchmarks'), so the same log scrapers read both.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist


def log_fn(string: str) -> None:
  """Prints on rank 0 of the process group (or without one); the other
  ranks of a data-parallel run print nothing."""
  if dist.is_available() and dist.is_initialized() and dist.get_rank():
    return
  print(string, flush=True)


def get_perf_timing(batch_size: int, step_train_times: Sequence[float],
                    scale: float = 1.0):
  """images/sec mean, uncertainty and jitter of the per-step speeds.

  uncertainty = std(speeds)/sqrt(n); jitter = median absolute deviation.
  """
  times = list(step_train_times)
  if not times:
    return 0.0, 0.0, 0.0
  speeds = [batch_size / t * scale for t in times]
  n = len(speeds)
  speed_mean = scale * batch_size / (sum(times) / n)
  if n <= 1:
    return speed_mean, 0.0, 0.0
  mean_of_speeds = sum(speeds) / n
  variance = sum((s - mean_of_speeds) ** 2 for s in speeds) / n
  speed_uncertainty = math.sqrt(variance) / math.sqrt(n)
  med = sorted(speeds)[n // 2]
  speed_jitter = sorted(abs(s - med) for s in speeds)[n // 2]
  return speed_mean, speed_uncertainty, speed_jitter


def format_step_line(step: int, batch_size: int,
                     step_train_times: Sequence[float], loss: float,
                     top_1: float = None, top_5: float = None,
                     lr: float = None) -> str:
  speed_mean, speed_uncertainty, speed_jitter = get_perf_timing(
      batch_size, step_train_times)
  log_str = (f"{step}\timages/sec: {speed_mean:.1f} "
             f"+/- {speed_uncertainty:.1f} (jitter = {speed_jitter:.1f})\t"
             f"{loss:.3f}")
  if top_1 is not None:
    log_str += f"\t{top_1:.3f}\t{top_5:.3f}"
  if lr is not None:
    log_str += f"\t{lr:.5f}"
  return log_str


def format_total_line(images_per_sec: float) -> str:
  return "total images/sec: %.2f" % images_per_sec
