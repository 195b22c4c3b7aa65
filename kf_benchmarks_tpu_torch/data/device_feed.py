"""Prefetching host -> device input feed: the port's counterpart of the JAX
package's data/device_feed.py (:37-214).

A background thread pulls host batches from the preprocessor's iterator and
moves them onto the device ahead of the step loop, so the host's decode and
the copy overlap the previous step's compute (the reference's StagingArea /
MultiDeviceIterator chain, ref: benchmark_cnn.py:2572-2600,
preprocessing.py:368-399).

On a CUDA device the thread fills one of a ring of **pinned** host buffers,
copies it ``non_blocking`` on a dedicated H2D stream, applies the
preprocessor's normalisation and the cast to the compute dtype on that
stream (data/preprocessing.py: the host yields uint8, so a quarter of the
float32 bytes cross PCIe) and records an event there. ``__next__`` makes the
consumer's current stream wait on that event and ``record_stream``s the
tensors it hands out, so the allocator keeps them until the consumer's work
is done. A pinned buffer is refilled only after its copy's event has
completed. On the CPU, where the caller asked for it, the same class runs
without streams or pinning.

Chunk mode (--steps_per_dispatch=K): ``chunk=K`` stages K host batches at a
time, stacked on a new leading axis, as one (K, batch, ...) transfer; the
queue then counts chunks (``prefetch`` stays in batches and is rounded up to
whole chunks). A stream that ends mid-chunk yields a final short chunk.

``stats()`` has the JAX feeder's keys: whether the prefetch hides the host's
work behind the step (``feed_stall_fraction`` ~0) or the loop is input-bound
(~1). The feed spans and the wait samples go to the active run trace
(tracing.py), and each fetch's count, queue depth and wait to the active
metric registry (metrics.py), which the /metrics endpoint serves live.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from kf_benchmarks_tpu_torch import metrics as metrics_lib
from kf_benchmarks_tpu_torch import tracing
from kf_benchmarks_tpu_torch.data import preprocessing


def normalize(images: torch.Tensor, kind: Optional[str],
              dtype: torch.dtype) -> torch.Tensor:
  """A preprocessor's NORMALIZATION on a tensor, then the cast of a float
  batch to the compute dtype: the values the JAX package computes on the
  host (preprocessing.normalized_image, ``x - CHANNEL_MEANS``, and
  benchmark.py ``_cast_images``)."""
  if kind == "unit":
    images = images.to(torch.float32).mul_(1.0 / 127.5).sub_(1.0)
  elif kind == "channel_means":
    images = images.to(torch.float32).sub_(torch.as_tensor(
        preprocessing.CHANNEL_MEANS, device=images.device))
  elif kind == "coco":
    # SSD's normalize_image: x / 255, then ImageNet's mean and std.
    images = images.to(torch.float32).div_(255.0).sub_(torch.as_tensor(
        preprocessing.COCO_MEAN, device=images.device)).div_(
            torch.as_tensor(preprocessing.COCO_STD, device=images.device))
  elif kind is not None:
    raise ValueError(f"unknown normalization {kind!r}")
  if images.dtype == torch.float32 and dtype != torch.float32:
    images = images.to(dtype)
  return images


def _stack(items):
  """``np.stack`` of a list of equal trees (arrays, or tuples of them)."""
  if isinstance(items[0], tuple):
    return tuple(_stack(list(parts)) for parts in zip(*items))
  return np.stack(items)


class DeviceFeeder:
  """Prefetching device-transfer iterator (depth-``prefetch`` pipeline)
  of (images, labels) on ``device``: labels int64, images normalised as
  ``normalization`` says and in ``dtype``.

  Every ``__next__`` records the consumer's blocked wait and the queue
  depth it found; ``stats()`` reports them (JAX device_feed.py:196-214)."""

  def __init__(self, host_iterator: Iterator, device: torch.device,
               prefetch: int = 2, chunk: int = 1,
               normalization: Optional[str] = "unit",
               dtype: torch.dtype = torch.float32):
    self._host_iterator = host_iterator
    self._device = torch.device(device)
    self._cuda = self._device.type == "cuda"
    self._normalization = normalization
    self._dtype = dtype
    self._chunk = max(1, chunk)
    self.prefetch_batches = max(1, prefetch)
    depth = max(1, -(-self.prefetch_batches // self._chunk))
    self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
    self._stop = threading.Event()
    self._error: Optional[BaseException] = None
    self._wait_s = 0.0
    self._fetches = 0
    self._depth_sum = 0
    self._depth_max = 0
    self._window_start: Optional[float] = None
    self._window_end: Optional[float] = None
    if self._cuda:
      self._stream = torch.cuda.Stream(device=self._device)
      # A ring of pinned slots, one more than the queue holds plus the one
      # in flight; each slot's last copy event guards its refill.
      self._slots: List[Optional[List[torch.Tensor]]] = [None] * (depth + 2)
      self._slot_events: List[Optional[torch.cuda.Event]] = (
          [None] * (depth + 2))
      self._next_slot = 0
    self._thread = threading.Thread(target=self._worker, daemon=True,
                                    name="device-feeder")
    self._thread.start()

  def _pull(self, it):
    """Next host item: one batch, or a chunk of up to ``chunk`` batches
    stacked on a new leading axis. None at stream end."""
    if self._chunk == 1:
      try:
        return next(it)
      except StopIteration:
        return None
    batches = []
    while len(batches) < self._chunk and not self._stop.is_set():
      try:
        batches.append(next(it))
      except StopIteration:
        break
    if not batches:
      return None
    return _stack(batches)

  def _to_device(self, batch):
    images, labels = batch
    images = np.ascontiguousarray(images)
    # The labels: one array, or a tuple of them (SSD's targets); integer
    # arrays as int64, float arrays as they are.
    label_arrays = [np.ascontiguousarray(
        x.astype(np.int64) if np.issubdtype(x.dtype, np.integer) else x)
                    for x in (labels if isinstance(labels, tuple)
                              else (labels,))]

    def tree(tensors):
      return tuple(tensors) if isinstance(labels, tuple) else tensors[0]

    if not self._cuda:
      return (normalize(torch.from_numpy(images), self._normalization,
                        self._dtype),
              tree([torch.from_numpy(x) for x in label_arrays]))
    s = self._next_slot
    self._next_slot = (s + 1) % len(self._slots)
    event = self._slot_events[s]
    if event is not None:
      event.synchronize()  # the slot's previous copy has left it
    pinned = self._slots[s]
    host = []
    for i, arr in enumerate([images] + label_arrays):
      buf = pinned[i] if pinned is not None else None
      dtype = torch.from_numpy(arr).dtype
      if buf is None or buf.dtype != dtype or buf.numel() < arr.size:
        buf = torch.empty(arr.size, dtype=dtype, pin_memory=True)
      view = buf[:arr.size].view(arr.shape)
      view.numpy()[...] = arr
      host.append((buf, view))
    self._slots[s] = [buf for buf, _ in host]
    with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
      dev_images = host[0][1].to(self._device, non_blocking=True)
      dev_labels = tree([view.to(self._device, non_blocking=True)
                         for _, view in host[1:]])
      dev_images = normalize(dev_images, self._normalization, self._dtype)
      event = torch.cuda.Event()
      event.record(self._stream)
    self._slot_events[s] = event
    return dev_images, dev_labels, event

  def _worker(self) -> None:
    try:
      it = iter(self._host_iterator)
      # Check the stop flag BEFORE pulling: pulling is where the host
      # preprocessing work happens.
      while not self._stop.is_set():
        trace = tracing.active()
        t0 = trace.now()
        batch = self._pull(it)
        if batch is None:
          break
        trace.add_span("feed", "fetch", t0, trace.now() - t0,
                       {"chunk": self._chunk})
        t1 = trace.now()
        device_batch = self._to_device(batch)
        trace.add_span("feed", "h2d", t1, trace.now() - t1)
        while not self._stop.is_set():
          try:
            self._queue.put(device_batch, timeout=0.5)
            break
          except queue.Full:
            continue
      if not self._stop.is_set():
        self._queue.put(None)
    except BaseException as e:  # surfaced on the consumer side
      self._error = e

  def __iter__(self):
    return self

  def __next__(self):
    t0 = time.monotonic()
    trace = tracing.active()
    t0_trace = trace.now()
    if self._window_start is None:
      self._window_start = t0
    depth = self._queue.qsize()
    # Poll with a timeout so a worker error is surfaced even when the
    # queue is full at error time and the sentinel could not be enqueued.
    while True:
      try:
        item = self._queue.get(timeout=0.5)
        break
      except queue.Empty:
        if self._error is not None:
          raise self._error
        if not self._thread.is_alive():
          raise StopIteration
    if item is None:
      # End-of-stream sentinel: not a delivered batch.
      if self._error is not None:
        raise self._error
      raise StopIteration
    if self._cuda:
      images, labels, event = item
      consumer = torch.cuda.current_stream(self._device)
      consumer.wait_event(event)
      images.record_stream(consumer)
      for t in (labels if isinstance(labels, tuple) else (labels,)):
        t.record_stream(consumer)
      item = (images, labels)
    now = time.monotonic()
    waited = now - t0
    self._wait_s += waited
    self._window_end = now
    self._fetches += 1
    trace.add_span("feed", "wait", t0_trace, trace.now() - t0_trace,
                   {"queue_depth": depth * self._chunk})
    trace.add_sample("feed_wait", waited)
    # The live lanes (a no-op sink without a registry session).
    registry = metrics_lib.active()
    registry.inc("fetches")
    registry.set("queue_depth", depth * self._chunk)
    registry.observe("feed_wait_s", waited)
    # Queue depth in BATCH units (the queue holds chunks when chunk > 1).
    self._depth_sum += depth * self._chunk
    self._depth_max = max(self._depth_max, depth * self._chunk)
    return item

  def stats(self) -> dict:
    """Consumer-side feed stats: total blocked wait, the wall window
    spanning the fetches, the stall fraction (wait / window), and queue
    depth at fetch time (mean/max). The first fetch's wait covers the
    pipeline's warm fill and is counted."""
    window = ((self._window_end - self._window_start)
              if self._fetches and self._window_end is not None else 0.0)
    return {
        "fetches": self._fetches,
        "consumer_wait_s": self._wait_s,
        "window_s": window,
        "feed_stall_fraction": (self._wait_s / window if window > 0
                                else None),
        "queue_depth_mean": (self._depth_sum / self._fetches
                             if self._fetches else None),
        "queue_depth_max": self._depth_max,
        "prefetch_batches": self.prefetch_batches,
    }

  def stop(self) -> None:
    """Stops the worker, joins it and closes the host iterator, so the
    preprocessor's pool shuts down now rather than at garbage collection."""
    self._stop.set()
    while self._thread.is_alive():
      try:
        while True:
          self._queue.get_nowait()
      except queue.Empty:
        pass
      self._thread.join(timeout=0.1)
    close = getattr(self._host_iterator, "close", None)
    if close is not None:
      close()
