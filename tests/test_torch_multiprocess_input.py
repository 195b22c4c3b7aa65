"""--input_preprocessor=multiprocess: the port's process pool
(data/preprocessing.py ``MultiprocessImagePreprocessor``) against the JAX
package's, on the same generated records, seed and two worker processes.

* Train and eval batches, normalised as the device feed normalises them:
  bitwise the JAX pool's, batch 0 bitwise the port's own serial decode.
* A record larger than its 256 KiB staging slot travels inline in the task
  message, with the same batches.
* A worker killed with SIGKILL makes the next batch raise within seconds.
* The workers' import set: the preprocessing module imports no torch in a
  fresh interpreter, and a spawned worker of a parent that holds torch maps
  no libtorch (the parent's ``__main__`` is not re-imported).
* The worker count: the JAX package's for the same flags, capped at the
  cores by default; an explicit count above the cores is honoured with a
  warning.
* The CLI trains through the pool and logs its workers.
"""

import itertools
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.data import datasets as jax_datasets
from kf_benchmarks_tpu.data import preprocessing as jax_pre
from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch.data import datasets
from kf_benchmarks_tpu_torch.data import device_feed
from kf_benchmarks_tpu_torch.data import preprocessing as pre
from kf_benchmarks_tpu_torch.data import tfrecord_image_generator
from kf_benchmarks_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
  path = tmp_path_factory.mktemp("mp") / "imagenet"
  tfrecord_image_generator.write_textured_records(
      str(path), num_train=24, num_validation=12, num_distinct=6,
      num_train_shards=4, num_validation_shards=2, height=120, width=160,
      quality=85)
  return str(path)


def _kw(train, **extra):
  kw = dict(batch_size=4, output_shape=(48, 48, 3), train=train,
            distortions=True, resize_method="round_robin", seed=11,
            shift_ratio=0.5, num_threads=2)
  kw.update(extra)
  return kw


def _unit(images):
  return device_feed.normalize(torch.from_numpy(np.ascontiguousarray(
      images)), "unit", torch.float32).numpy()


def _pairs(records, train, n, port_extra=None, jax_extra=None):
  subset = "train" if train else "validation"
  got = pre.MultiprocessImagePreprocessor(
      num_processes=2, **_kw(train, **(port_extra or {}))).minibatches(
          datasets.ImagenetDataset(records), subset)
  ref = jax_pre.MultiprocessImagePreprocessor(
      num_processes=2, **_kw(train, **(jax_extra or {}))).minibatches(
          jax_datasets.ImagenetDataset(records), subset)
  try:
    # The pool's batches are views of its ring: keep copies.
    return [((gi.copy(), gl.copy()), r)
            for (gi, gl), r in itertools.islice(zip(got, ref), n)]
  finally:
    got.close()
    ref.close()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batches_are_the_jax_pools_bitwise(records, train):
  pairs = _pairs(records, train, 5)
  # Train replays forever; the 12 validation records make three batches.
  assert len(pairs) == (5 if train else 3)
  for (gi, gl), (ri, rl) in pairs:
    assert gi.dtype == np.uint8 and gi.shape == (4, 48, 48, 3)
    np.testing.assert_array_equal(_unit(gi), ri)
    np.testing.assert_array_equal(gl, rl)


def test_batch_zero_is_the_serial_decode(records):
  kw = _kw(True)
  got = pre.MultiprocessImagePreprocessor(num_processes=2, **kw)
  it = got.minibatches(datasets.ImagenetDataset(records), "train")
  first = [a.copy() for a in next(it)]
  it.close()
  kw["num_threads"] = 1
  serial = next(pre.RecordInputImagePreprocessor(**kw).minibatches(
      datasets.ImagenetDataset(records), "train"))
  np.testing.assert_array_equal(first[0], serial[0])
  np.testing.assert_array_equal(first[1], serial[1])
  assert got.dispatch_calls >= 1 and got.dispatch_seconds > 0


def test_an_oversized_record_travels_inline(records):
  """A 12 KiB staging slot: each batch's records overflow it, the later
  ones ride the task message."""
  small = {"input_bytes_per_image": 3 << 10}
  pairs = _pairs(records, True, 3, small, small)
  assert len(pairs) == 3
  for (gi, gl), (ri, rl) in pairs:
    np.testing.assert_array_equal(_unit(gi), ri)
    np.testing.assert_array_equal(gl, rl)
  # The same images as with the whole records staged.
  staged = _pairs(records, True, 3)
  for ((gi, _), _), ((si, _), _) in zip(pairs, staged):
    np.testing.assert_array_equal(gi, si)


def test_batches_are_views_valid_for_num_buffers_less_one_more(records):
  """Views of the ring: a batch holds until the consumer has asked for
  num_buffers - 1 more, then its slot is reused."""
  kw = _kw(True)
  it = pre.MultiprocessImagePreprocessor(
      num_processes=2, num_buffers=3, **kw).minibatches(
          datasets.ImagenetDataset(records), "train")
  try:
    first = next(it)
    kept = [a.copy() for a in first]
    assert not first[0].flags.owndata
    next(it)
    np.testing.assert_array_equal(first[0], kept[0])
    fourth = [next(it) for _ in range(2)][-1]
    assert np.shares_memory(first[0], fourth[0])
  finally:
    it.close()


def test_more_workers_than_cores_lose_no_image(records):
  """Workers writing disjoint slots of one shared ring, more of them than
  cores: every image lands where one worker alone puts it."""
  cores = len(os.sched_getaffinity(0))
  kw = _kw(True, batch_size=2 * (cores + 1))
  many = pre.MultiprocessImagePreprocessor(num_processes=cores + 1, **kw)
  one = pre.MultiprocessImagePreprocessor(num_processes=1, **kw)
  a = many.minibatches(datasets.ImagenetDataset(records), "train")
  b = one.minibatches(datasets.ImagenetDataset(records), "train")
  try:
    t0 = time.monotonic()
    for _ in range(3):
      (ai, al), (bi, bl) = next(a), next(b)
      ai, al = ai.copy(), al.copy()
      np.testing.assert_array_equal(ai, bi)
      np.testing.assert_array_equal(al, bl)
    assert time.monotonic() - t0 < 120
  finally:
    a.close()
    b.close()
  assert not _workers()


def _workers():
  import multiprocessing  # noqa: PLC0415
  return [p for p in multiprocessing.active_children()
          if p.name.startswith("decode-worker")]


def test_a_killed_worker_makes_the_next_batch_raise(records):
  it = pre.MultiprocessImagePreprocessor(
      num_processes=2, **_kw(True)).minibatches(
          datasets.ImagenetDataset(records), "train")
  next(it)
  workers = _workers()
  assert len(workers) == 2
  os.kill(workers[0].pid, signal.SIGKILL)
  workers[0].join(10)
  t0 = time.monotonic()
  with pytest.raises(RuntimeError, match="decode worker"):
    for _ in range(3):
      next(it)
  assert time.monotonic() - t0 < 5.0
  it.close()
  assert not _workers()


def test_workers_import_no_torch(records):
  code = ("import sys; import kf_benchmarks_tpu_torch.data.preprocessing; "
          "print(sorted(m for m in sys.modules if m == 'torch' or "
          "m.startswith('torch.')))")
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120, check=True).stdout
  assert out.strip() == "[]"
  # A live worker of this process (which holds torch, and whose __main__
  # is pytest's) maps no libtorch.
  it = pre.MultiprocessImagePreprocessor(
      num_processes=1, **_kw(True)).minibatches(
          datasets.ImagenetDataset(records), "train")
  try:
    next(it)
    (worker,) = _workers()
    with open(f"/proc/{worker.pid}/maps") as f:
      maps = f.read()
    assert "libtorch" not in maps
    # ... and does map the codec the parent built.
    assert _build.build_host_library("jpeg") in maps
  finally:
    it.close()


def test_worker_count_follows_the_jax_package(capsys):
  cores = len(os.sched_getaffinity(0))
  for threads in (1, 2, cores + 3):
    kw = _kw(True, num_threads=threads)
    assert pre.MultiprocessImagePreprocessor(**kw).num_processes == \
        jax_pre.MultiprocessImagePreprocessor(**kw).num_processes == \
        min(threads, cores)
  capsys.readouterr()
  got = pre.MultiprocessImagePreprocessor(num_processes=cores + 1,
                                          **_kw(True))
  assert got.num_processes == cores + 1
  assert "oversubscribed" in capsys.readouterr().out


def test_the_map_returns_the_pool():
  assert pre.get_preprocessor("imagenet", "multiprocess") is \
      pre.MultiprocessImagePreprocessor
  with pytest.raises(ValueError, match="imagenet dataset"):
    pre.get_preprocessor("cifar10", "multiprocess")


def test_cli_trains_through_the_pool(records, capsys):
  """The trivial model at batch 2 on the CPU, two workers: the feed's and
  the pool's lines, and no worker left behind."""
  rc = cli.main(["--model=trivial", "--device=cpu", "--batch_size=2",
                 "--num_batches=3", "--num_warmup_batches=1",
                 f"--data_dir={records}", "--data_name=imagenet",
                 "--input_preprocessor=multiprocess",
                 "--datasets_num_private_threads=2"])
  out = capsys.readouterr().out
  assert rc == 0, out
  assert "Decode pool: 2 worker processes" in out
  assert "Input feed: stall" in out
  assert not _workers()
