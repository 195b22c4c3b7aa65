"""Elastic scaling and the adaptive batch size (KungFu's north-star
features).

The port's counterpart of kf_benchmarks_tpu/elastic.py:

* ``noise_scale_stats`` measures the gradient noise scale in the training
  step from each rank's gradients (the small-batch estimate) against
  their mean over the ranks (the large-batch estimate), as all-reduce
  means over the process group; host-side EMAs turn the per-step
  estimates into the "simple noise scale" B_simple of McCandlish et al.,
  "An Empirical Model of Large-Batch Training" (arXiv:1812.06162).
* ``AdaptiveBatchPolicy`` proposes a per-device batch size tracking
  B_simple with hysteresis (power-of-two jumps in a bounded range).
* ``ElasticController`` watches the coordination service
  (parallel/coordination.py) for resize requests; ``plan_resize`` decides
  between a rebuild in the running processes and a checkpoint-restart
  through kfrun. A process of the port drives one card, so any change of
  world size is a restart; a change of the per-device batch alone is
  rebuilt in-process (benchmark.py).

``NoiseScaleEMA``, ``AdaptiveBatchPolicy``, ``ScheduledController`` and
``plan_resize`` are the JAX package's, unchanged.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import torch

from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh


# -- in-step measurement (called from train_step on the ranks' gradients) ----

def noise_scale_stats(local_grads: List[torch.Tensor],
                      batch_size_per_replica: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-step (g2, s) estimates from this rank's gradients against their
  mean over the ranks (every rank calls it, in the same order).

  With B_small = per-replica batch and B_big = global batch, the unbiased
  pair (arXiv:1812.06162 appendix A):
      g2 = (B_big*|G_big|^2 - B_small*E|G_small|^2) / (B_big - B_small)
      s  = (E|G_small|^2 - |G_big|^2) / (1/B_small - 1/B_big)
  and B_simple = s / g2 (host-side, after EMA smoothing). E|G_small|^2 is
  the all-reduce mean of each rank's squared norm, G_big the all-reduce
  mean of the gradients (on copies: the step's own reduction is the
  strategy's). Needs a world of at least 2.
  """
  n = mesh.world_size()
  sq = lambda ts: torch.stack([torch.sum(torch.square(t.float()))
                               for t in ts]).sum()
  mean_grads = [g.detach().clone() for g in local_grads]
  kungfu.allreduce_mean(mean_grads)
  local_sq = sq(local_grads).reshape(1)
  kungfu.allreduce_mean([local_sq])
  local_sq = local_sq[0]                             # E|G_small|^2
  mean_sq = sq(mean_grads)                           # |G_big|^2
  b_small = float(batch_size_per_replica)
  b_big = b_small * n
  g2 = (b_big * mean_sq - b_small * local_sq) / (b_big - b_small)
  s = (local_sq - mean_sq) / (1.0 / b_small - 1.0 / b_big)
  return g2, s


# -- host-side smoothing -----------------------------------------------------

class NoiseScaleEMA:
  """EMA of the (g2, s) pair; B_simple = s_ema / g2_ema.

  Separate EMAs of numerator and denominator (not of the ratio) per
  arXiv:1812.06162 appendix A.3 -- the per-step ratio is wildly noisy.
  """

  def __init__(self, decay: float = 0.9):
    self.decay = decay
    self._g2 = None
    self._s = None

  def update(self, g2: float, s: float) -> None:
    if not (math.isfinite(g2) and math.isfinite(s)):
      return
    if self._g2 is None:
      self._g2, self._s = float(g2), float(s)
    else:
      d = self.decay
      self._g2 = d * self._g2 + (1 - d) * float(g2)
      self._s = d * self._s + (1 - d) * float(s)

  @property
  def b_simple(self) -> Optional[float]:
    if self._g2 is None or self._g2 <= 0:
      return None
    return max(self._s / self._g2, 0.0)


class AdaptiveBatchPolicy:
  """Propose a per-device batch size tracking the noise scale.

  KungFu's adaptive-batch policy grows the global batch as the gradient
  noise scale grows during training; here the proposal is
  B_simple / num_devices snapped to the nearest power of two within
  [min_batch, max_batch], with 2x hysteresis so the step is only
  rebuilt on material changes.
  """

  def __init__(self, min_batch: int, max_batch: int):
    if min_batch < 1 or max_batch < min_batch:
      raise ValueError(f"invalid batch bounds [{min_batch}, {max_batch}]")
    self.min_batch = min_batch
    self.max_batch = max_batch

  def propose(self, current: int, b_simple: Optional[float],
              num_devices: int) -> int:
    if not b_simple or b_simple <= 0:
      return current
    target = max(b_simple / max(num_devices, 1), 1.0)
    # Snap to a power of two in bounds.
    snapped = 1 << max(round(math.log2(target)), 0)
    snapped = min(max(snapped, self.min_batch), self.max_batch)
    # Hysteresis: only move on >= 2x difference, and one octave at a time.
    if snapped >= current * 2:
      return current * 2
    if snapped * 2 <= current:
      return max(current // 2, self.min_batch)
    return current


# -- elastic membership ------------------------------------------------------

class ElasticController:
  """Polls the coordination service for resize requests.

  One client per process; ``poll()`` returns the new target device count
  when a new RESIZE was issued, else None. Targets are clamped to the
  process's device count, which in the port is 1: every change of world
  size is a checkpoint-restart through kfrun (``plan_resize``).
  """

  def __init__(self, client, max_devices: int):
    self._client = client
    self._max_devices = max_devices
    self._last_target: Optional[int] = None
    # The UNCLAMPED size of the last resize poll() surfaced: the
    # benchmark uses it to decide whether the target fits this process
    # set or needs a checkpoint-restart with a new process count.
    self.last_raw_target: Optional[int] = None

  @classmethod
  def from_env(cls, max_devices: int) -> Optional["ElasticController"]:
    host = os.environ.get("KFCOORD_HOST")
    port = os.environ.get("KFCOORD_PORT")
    if not (host and port):
      return None
    from kf_benchmarks_tpu_torch.parallel import coordination
    try:
      client = coordination.CoordinatorClient(host=host, port=int(port),
                                              timeout_ms=2000)
    except RuntimeError:
      return None  # coordinator gone; run without elastic polling
    return cls(client, max_devices)

  def poll(self) -> Optional[int]:
    """Non-blocking: the new target device count if a RESIZE was issued
    since the last poll (including any issued before this controller
    started), else None."""
    try:
      target = self._client.try_target_size()
    except Exception:
      return None
    if target is None or target == self._last_target:
      return None
    self._last_target = target
    self.last_raw_target = target
    return max(1, min(target, self._max_devices))

  def restart_barrier(self, name: str, count: int) -> None:
    """Rendezvous before a checkpoint-restart resize: guarantees the
    chief's snapshot is on disk (the chief enters after writing) before
    any worker exits for re-exec."""
    self._client.barrier(name, count)

  def generation(self) -> int:
    return self._client.current_generation()

  # -- scheduled-restart agreement ------------------------------------------
  #
  # Workers poll the coordinator at the same STEP cadence but at
  # different WALL times, so a RESIZE can land between two workers'
  # polls of the same step -- an immediate restart would split-brain
  # (observed: one worker restarted, its sibling ran to completion).
  # Agreement: the first worker to see the target SCHEDULES the restart
  # at a future step in the coordinator's kv store; every worker adopts
  # the schedule at its own polls, so all restart at the same step.

  def scheduled_restart(self):
    """(step, target_np) of the pending scheduled restart, else None."""
    try:
      gen = self._client.current_generation()
      val = self._client.kv_tryget(f"kf_restart_sched_{gen}")
    except Exception:
      return None
    if not val:
      return None
    step_s, _, np_s = val.decode().partition(":")
    return int(step_s), int(np_s)

  def schedule_restart(self, step: int, target_np: int) -> None:
    try:
      gen = self._client.current_generation()
      self._client.kv_put(f"kf_restart_sched_{gen}",
                          f"{step}:{target_np}".encode())
    except Exception as e:
      # poll() is one-shot per target (dedup on _last_target), so a
      # swallowed failure here would drop the resize silently. Reset the
      # dedup so the next poll re-sees the target and retries the put.
      import sys
      print(f"elastic: scheduling restart failed ({e}); will retry on "
            "the next poll", file=sys.stderr, flush=True)
      self._last_target = None

  def close(self) -> None:
    close = getattr(self._client, "close", None)
    if close:
      close()


def plan_resize(raw_target: int, procs: int, capacity: int,
                max_procs: int):
  """Classify a RESIZE target under the kfrun launcher.

  ``raw_target`` is the GLOBAL device count the coordinator was asked
  for; ``procs`` the live process count; ``capacity`` the per-process
  device capacity (locally attached devices); ``max_procs`` the
  provisioned host-list length (1 when no distributed world can form).

  Returns ("reshape", per_process_devices) whenever the target is
  EXACTLY satisfiable by the current process set (divisible by procs
  and within per-process capacity) -- an in-process rebuild is cheaper
  than a restart, so it wins whenever it hits the requested size.
  Otherwise ("restart", required_procs): a live process group cannot
  change its size, so the job must checkpoint + re-exec at the fewest
  processes that cover the target (a non-divisible target restarts too:
  the smaller process set can then hit it exactly in-mesh). Clamped to
  the provisioned hosts; if clamping lands back on the current count,
  the best-effort answer is a rounded-down in-mesh reshape.
  """
  capacity = max(1, capacity)
  procs = max(1, procs)
  if (raw_target % procs == 0 and
      procs <= raw_target <= procs * capacity):
    return "reshape", raw_target // procs
  required = min(max(1, -(-raw_target // capacity)), max(1, max_procs))
  if required == procs:
    return "reshape", min(max(1, raw_target // procs), capacity)
  return "restart", required


class ScheduledController:
  """Deterministic resize schedule {step: num_devices} -- the test/AB
  harness analog of coordinator-driven resizes."""

  def __init__(self, schedule: dict):
    self.schedule = dict(schedule)

  def poll_at(self, step: int) -> Optional[int]:
    return self.schedule.pop(step, None)
