"""The port's DeviceFeeder (data/device_feed.py), on the CPU, against the
contract of the JAX package's data/device_feed.py.

* Order is kept; chunks stack K batches on a new axis and the stream's end
  gives a short last chunk; stats() has the JAX feeder's keys with values in
  range; a worker error surfaces on the consumer side; stop() joins the
  worker and closes the host iterator.
* The normalisation on the device is the JAX package's host normalisation,
  bitwise: ``x * (1/127.5) - 1`` and ``x - CHANNEL_MEANS`` in f32, and the
  bf16 cast of ``_cast_images``; float batches pass through.
* feeder_prefetch is the JAX package's.
* On a card (``cuda``-marked, skipped here): the pinned, stream-ordered path
  gives the CPU path's tensors, and its buffers are refilled only after
  their copies.
"""

import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import benchmark as jax_benchmark
from kf_benchmarks_tpu.data import preprocessing as jax_pre
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch.data import device_feed
from kf_benchmarks_tpu_torch.data import preprocessing as pre

KEYS = {"fetches", "consumer_wait_s", "window_s", "feed_stall_fraction",
        "queue_depth_mean", "queue_depth_max", "prefetch_batches"}


def _batches(n, b=2, size=4, seed=0):
  rng = np.random.default_rng(seed)
  return [(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
           np.arange(i * b, (i + 1) * b, dtype=np.int32)) for i in range(n)]


class Closing:
  """A host iterator that records its close()."""

  def __init__(self, items, fail_at=None):
    self.items = list(items)
    self.fail_at = fail_at
    self.closed = False
    self.pulled = 0

  def __iter__(self):
    return self

  def __next__(self):
    if self.fail_at is not None and self.pulled == self.fail_at:
      raise RuntimeError("decode failed in the worker")
    if self.pulled >= len(self.items):
      raise StopIteration
    self.pulled += 1
    return self.items[self.pulled - 1]

  def close(self):
    self.closed = True


def test_order_is_kept_and_the_stream_ends():
  host = _batches(7)
  feeder = device_feed.DeviceFeeder(iter(host), "cpu", prefetch=3)
  got = list(feeder)
  assert len(got) == 7
  for (images, labels), (hi, hl) in zip(got, host):
    np.testing.assert_array_equal(
        images.numpy(), jax_pre.normalized_image(hi))
    assert labels.dtype == torch.int64
    np.testing.assert_array_equal(labels.numpy(), hl)
  feeder.stop()


@pytest.mark.parametrize("n,k", [(8, 4), (9, 4), (3, 4), (5, 1)])
def test_chunks_stack_with_a_short_last_chunk(n, k):
  host = _batches(n)
  feeder = device_feed.DeviceFeeder(iter(host), "cpu", prefetch=2, chunk=k)
  chunks = list(feeder)
  sizes = [c[0].shape[0] for c in chunks] if k > 1 else [1] * len(chunks)
  assert sum(sizes) == n
  assert sizes[:-1] == [k] * (len(sizes) - 1) and 1 <= sizes[-1] <= k
  if k > 1:
    flat = torch.cat([c[1] for c in chunks]).reshape(-1)
    np.testing.assert_array_equal(flat.numpy(), np.arange(2 * n))
    assert chunks[0][0].shape == (sizes[0], 2, 4, 4, 3)
  # prefetch stays in batches, rounded up to whole chunks in the queue.
  assert feeder.stats()["prefetch_batches"] == 2
  assert feeder._queue.maxsize == max(1, -(-2 // k))


def test_stats_keys_and_ranges():
  def slow():
    for b in _batches(6):
      time.sleep(0.02)
      yield b
  feeder = device_feed.DeviceFeeder(slow(), "cpu", prefetch=2)
  empty = feeder.stats()
  assert set(empty) == KEYS and empty["fetches"] == 0
  assert empty["feed_stall_fraction"] is None
  for _ in range(6):
    next(feeder)
    time.sleep(0.01)
  s = feeder.stats()
  assert set(s) == KEYS
  assert s["fetches"] == 6
  assert 0 < s["consumer_wait_s"] <= s["window_s"] + 0.1
  assert 0.0 <= s["feed_stall_fraction"] <= 1.0
  assert 0 <= s["queue_depth_mean"] <= s["queue_depth_max"] <= 2
  feeder.stop()


def test_a_worker_error_surfaces_on_the_consumer_side():
  host = Closing(_batches(5), fail_at=2)
  feeder = device_feed.DeviceFeeder(host, "cpu", prefetch=1)
  next(feeder)
  next(feeder)
  with pytest.raises(RuntimeError, match="decode failed in the worker"):
    next(feeder)
  feeder.stop()
  assert host.closed


def test_stop_joins_the_worker_and_closes_the_iterator():
  host = Closing(_batches(50))
  feeder = device_feed.DeviceFeeder(host, "cpu", prefetch=2)
  next(feeder)
  feeder.stop()
  assert not feeder._thread.is_alive()
  assert host.closed
  # Stopped early: the worker did not run the stream to its end.
  assert host.pulled < 50
  assert not any(t.name == "device-feeder" and t.is_alive()
                 for t in threading.enumerate() if t is feeder._thread)


def test_generator_cleanup_runs_at_stop():
  done = []

  def gen():
    try:
      for b in _batches(100):
        yield b
    finally:
      done.append(True)
  feeder = device_feed.DeviceFeeder(gen(), "cpu")
  next(feeder)
  feeder.stop()
  assert done == [True]


def test_normalisation_is_the_jax_host_normalisation_bitwise():
  rng = np.random.default_rng(1)
  images = rng.integers(0, 256, (3, 17, 19, 3), dtype=np.uint8)
  unit = device_feed.normalize(torch.from_numpy(images), "unit",
                               torch.float32)
  np.testing.assert_array_equal(unit.numpy(),
                                jax_pre.normalized_image(images))
  np.testing.assert_array_equal(unit.numpy(),
                                pre.normalized_image(images))
  means = device_feed.normalize(torch.from_numpy(images), "channel_means",
                                torch.float32)
  np.testing.assert_array_equal(
      means.numpy(), images.astype(np.float32) -
      jax_pre.OfficialImagenetPreprocessor.CHANNEL_MEANS)
  # bf16: the JAX package casts the f32 host batch (_cast_images).
  bf16 = device_feed.normalize(torch.from_numpy(images), "unit",
                               torch.bfloat16)
  cast = jax_benchmark.BenchmarkCNN._cast_images(
      SimpleNamespace(compute_dtype=jnp.bfloat16),
      iter([(jax_pre.normalized_image(images), np.zeros(3, np.int32))]))
  ref = next(cast)[0].astype(np.float32)
  assert bf16.dtype == torch.bfloat16
  np.testing.assert_array_equal(bf16.float().numpy(), ref)
  floats = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
  same = device_feed.normalize(torch.from_numpy(floats), None, torch.float32)
  np.testing.assert_array_equal(same.numpy(), floats)


@pytest.mark.parametrize("flags", [
    {}, {"input_prefetch_depth": 5}, {"batch_group_size": 4},
    {"datasets_prefetch_buffer_size": 3, "batch_group_size": 2}])
def test_feeder_prefetch_is_the_jax_rule(flags):
  from kf_benchmarks_tpu import params as jax_params  # noqa: PLC0415
  assert benchmark.feeder_prefetch(params_lib.make_params(**flags)) == \
      jax_benchmark.feeder_prefetch(jax_params.make_params(**flags))


@pytest.mark.cuda
def test_pinned_stream_path_matches_the_cpu_path():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (the pinned H2D stream path)")
  host = _batches(12, b=4, size=32, seed=3)
  for k in (1, 4):
    cpu = list(device_feed.DeviceFeeder(iter(host), "cpu", chunk=k,
                                        dtype=torch.bfloat16))
    feeder = device_feed.DeviceFeeder(iter(host), "cuda", chunk=k,
                                      prefetch=2, dtype=torch.bfloat16)
    gpu = []
    for images, labels in feeder:
      # Work queued behind the batch on the consumer's stream.
      gpu.append((images.float().cpu(), labels.cpu()))
    for (ci, cl), (gi, gl) in zip(cpu, gpu):
      torch.testing.assert_close(gi, ci.float(), rtol=0, atol=0)
      assert torch.equal(gl, cl)
    assert len(gpu) == len(cpu)
    feeder.stop()
