"""Lag-N pipelined metrics fetching with real per-step wall times.

The port's counterpart of kf_benchmarks_tpu/utils/pipeline.py. Blocking on
each step's loss makes the host wait for the device at every step, so the
next step's launches queue only after the card has gone idle. This module
keeps the queue full and still gives honest per-step statistics:

* Each dispatched step's metrics enter a lag-``N`` ring; their
  device-to-host copy is queued at once (one copy of all of them into
  pinned host memory, behind the step on the same stream, with an event
  after it), so the transfer runs as soon as the step completes.
* ``N`` dispatches later the value is read (by then the copy has landed,
  so the read does not stall the dispatch queue), and the wall-clock
  interval between consecutive reads is recorded. At steady state the
  loop is paced by step completion, so these arrival intervals are the
  real per-step device times (ref: benchmark_cnn.py:786-884, :887-902).
* Host-side pauses that are not step work (checkpoint saves, mid-train
  eval) are kept out of the next interval by ``note_aux_time``.

Multi-step dispatches (--steps_per_dispatch=K): one ``push`` carries the
dispatch's per-step metrics stacked along a leading axis (``count=K``).
The ring and the lag count DISPATCHES; resolution unstacks the K rows on
the host, so every printed value is still its step's own. Timing is
honest at dispatch granularity only: the host sees one arrival per
dispatch, so each of its steps is attributed interval / K.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class CompletedStep:
  """A resolved step: its 1-based index, host metrics, and wall interval.

  ``chunk_len``/``chunk_interval`` carry the dispatch this step arrived
  in: (1, interval) for single-step dispatches; for a K-step dispatch
  every member reports its size and full wall interval (its own
  ``interval`` is the 1/K share). ``chunk_end`` is True on the dispatch's
  last step, so per-dispatch consumers count each dispatch once.
  """

  __slots__ = ("index", "metrics", "interval", "chunk_len",
               "chunk_interval", "chunk_end")

  def __init__(self, index: int, metrics: Dict[str, Any], interval: float,
               chunk_len: int = 1, chunk_interval: Optional[float] = None,
               chunk_end: bool = True):
    self.index = index
    self.metrics = metrics
    self.interval = interval
    self.chunk_len = chunk_len
    self.chunk_interval = (interval if chunk_interval is None
                           else chunk_interval)
    self.chunk_end = chunk_end


class _InFlight:
  """A dispatch's metrics on their way to the host: the CUDA tensors as
  one flat pinned copy with the event that marks its arrival, the rest as
  given."""

  def __init__(self, metrics: Dict[str, Any]):
    self.layout: List[Tuple[str, Tuple[int, ...]]] = []
    self.rest: Dict[str, Any] = {}
    self.host = self.event = None
    device = []
    for key, value in metrics.items():
      if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        device.append(value.detach().float().reshape(-1))
        self.layout.append((key, tuple(value.shape)))
      else:
        self.rest[key] = value
    if device:
      flat = torch.cat(device)
      self.host = torch.empty(flat.shape, dtype=torch.float32,
                              pin_memory=True)
      self.host.copy_(flat, non_blocking=True)
      self.event = torch.cuda.Event()
      self.event.record()

  def get(self) -> Dict[str, Any]:
    """The metrics on the host as numpy values, waiting for the copy."""
    out = {}
    if self.event is not None:
      self.event.synchronize()
      flat = self.host.numpy()
      offset = 0
      for key, shape in self.layout:
        n = int(np.prod(shape)) if shape else 1
        out[key] = flat[offset:offset + n].reshape(shape)
        offset += n
    for key, value in self.rest.items():
      if isinstance(value, torch.Tensor):
        value = value.detach().numpy()
      out[key] = value
    return out


class MetricsPipeline:
  """Keeps ``lag`` dispatches in flight; resolves older ones without
  stalling.

  Usage:
    pipe = MetricsPipeline(lag=2)
    for i in range(num_batches):
      metrics = step(...)
      for done in pipe.push(i + 1, metrics):
        handle(done)            # done.interval is a real per-step time
    for done in pipe.flush():
      handle(done)

  A dispatch covering steps ``index-count+1 .. index`` pushes its stacked
  metrics once with ``count=K``; resolution yields K CompletedSteps in
  step order. ``metrics`` is a flat dict of tensors (on the card or the
  CPU), numpy values or numbers.
  """

  def __init__(self, lag: int = 2):
    self.lag = max(0, lag)
    self._ring: "collections.deque[Tuple[int, _InFlight, int]]" = \
        collections.deque()
    self._last_time: Optional[float] = None
    self._aux_time = 0.0

  def reset_clock(self) -> None:
    """Restart interval timing (after a drain, reshape, or loop start)."""
    self._last_time = time.time()
    self._aux_time = 0.0

  def note_aux_time(self, seconds: float) -> None:
    """Exclude ``seconds`` of non-step host work from the next interval."""
    self._aux_time += max(0.0, seconds)

  def _resolve(self, index: int, pending: _InFlight,
               count: int) -> List[CompletedStep]:
    host = pending.get()
    now = time.time()
    if self._last_time is None:
      self._last_time = now
      interval = 0.0
    else:
      interval = max(1e-9, now - self._last_time - self._aux_time)
    self._last_time = now
    self._aux_time = 0.0
    if count <= 1:
      return [CompletedStep(index, host, interval)]
    per = interval / count

    def pick(j):
      # Row j of every leaf with the per-step leading axis; a leaf
      # without it (a metric that is not per step) passes through.
      out = {}
      for key, value in host.items():
        arr = np.asarray(value)
        out[key] = arr[j] if arr.ndim and arr.shape[0] == count else value
      return out

    return [CompletedStep(index - count + 1 + j, pick(j), per,
                          chunk_len=count, chunk_interval=interval,
                          chunk_end=(j == count - 1))
            for j in range(count)]

  def push(self, index: int, metrics: Dict[str, Any],
           count: int = 1) -> List[CompletedStep]:
    """Add a just-dispatched step (or K-step dispatch ending at
    ``index``); return any steps whose dispatch left the ring."""
    self._ring.append((index, _InFlight(metrics), count))
    done = []
    while len(self._ring) > self.lag:
      done.extend(self._resolve(*self._ring.popleft()))
    return done

  def flush(self) -> List[CompletedStep]:
    """Resolve everything in flight (end of loop or forced sync point)."""
    done = []
    while self._ring:
      done.extend(self._resolve(*self._ring.popleft()))
    return done

  def __len__(self) -> int:
    return len(self._ring)
