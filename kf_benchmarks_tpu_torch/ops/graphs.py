"""CUDA-graph capture and replay of the port's programs, with true kernel
launch counts.

A hand-written kernel's wrapper adds one to its count in Python where it
enqueues the kernel (``LAUNCHES`` in ops/conv_bn.py and
ops/flash_attention.py). Under capture the wrapper runs once and the card
runs nothing; under replay the wrapper does not run at all. ``Graph`` takes
the launches its capture recorded off the counts, keeps them as the
graph's own, and adds them back at every replay, so the counts stay the
launches the card ran on every path.

Every first-use step of a kernel (the nvcc build, the ctypes load, the
attribute calls of its first launch) and of the libraries (cuBLAS handles
and workspaces, cuDNN plans) has to happen before a capture:
``on_side_stream`` runs the eager warm-up call the way PyTorch's
whole-network capture recipe does, on a side stream that the current
stream then waits for.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from kf_benchmarks_tpu_torch.ops import conv_bn
from kf_benchmarks_tpu_torch.ops import flash_attention

_COUNTERS = (conv_bn.LAUNCHES, flash_attention.LAUNCHES)


def on_side_stream(fn: Callable):
  """``fn()`` on a fresh side stream, ordered after the current stream's
  work and before its later work."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    out = fn()
  torch.cuda.current_stream().wait_stream(side)
  return out


class Graph:
  """``fn``'s work captured once into a CUDA graph; ``replay()`` runs it.
  ``outputs`` is what ``fn`` returned at capture: tensors at fixed
  addresses that every replay rewrites. ``launches`` is the count of each
  hand-written kernel in one replay. A failed capture raises."""

  def __init__(self, fn: Callable, pool=None):
    before = [dict(c) for c in _COUNTERS]
    self.graph = torch.cuda.CUDAGraph()
    try:
      # Thread-local: the input feed's thread (data/device_feed.py) copies
      # and allocates on its own stream while the step is captured, and
      # only this thread's calls may end the capture.
      with torch.cuda.graph(self.graph, pool=pool,
                            capture_error_mode="thread_local"):
        self.outputs = fn()
    finally:
      # The capture enqueued nothing: its counts move to the graph.
      self.launches: List[Dict[str, int]] = []
      for counter, old in zip(_COUNTERS, before):
        delta = {k: counter[k] - old.get(k, 0) for k in counter}
        for k, v in delta.items():
          counter[k] -= v
        self.launches.append({k: v for k, v in delta.items() if v})

  def pool(self):
    return self.graph.pool()

  def replay(self) -> None:
    self.graph.replay()
    for counter, delta in zip(_COUNTERS, self.launches):
      for k, v in delta.items():
        counter[k] += v
