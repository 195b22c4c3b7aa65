"""Host-side input preprocessing: the port's counterpart of the JAX
package's data/preprocessing.py (:71-380, :606-660, :940-1002).

The same record streams, crops, resizes, flips and colour jitter, drawn
from the same ``random.Random`` streams (seeded ``seed + 7919 * i`` per
batch position; the process pool's ``seed + 7919 * i + 104729 * batch``),
so that the port's images are the JAX package's own. The
JAX package decodes and transforms with PIL; the port uses its own JPEG codec
(data/jpeg.py) and PIL-equivalent operations (data/image_ops.py), which give
PIL's results to the bit, so it runs where there is no PIL.

One difference of form: the host side yields **uint8** HWC batches, as PIL
hands them to ``np.asarray``, and each preprocessor names the normalisation
that the JAX package applies on the host (``NORMALIZATION``: ``"unit"`` for
``x * (1 / 127.5) - 1``, ``"channel_means"`` for the official variant's
``x - CHANNEL_MEANS``, ``"coco"`` for SSD's ``(x / 255 - mean) / std``,
None for batches that pass through as they are).
data/device_feed.py applies it once the batch is on its device, which
quarters the bytes that cross PCIe; the values are the ones the JAX package
computes on the host.

``--input_preprocessor=multiprocess`` (``MultiprocessImagePreprocessor``)
decodes in spawned worker processes, out of the GIL's way. This module is
what a worker imports: it and its imports (the codec, the image operations,
the record and Example readers, numpy) must never import torch, which would
cost each worker seconds and hundreds of MiB and touch CUDA; the one torch
import, the logger's, is made lazily in the pool's constructor, in the
parent.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import os
import pickle
import queue as queue_lib
import random
import sys
import time
import types
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from kf_benchmarks_tpu_torch.data import example as example_lib
from kf_benchmarks_tpu_torch.data import image_ops
from kf_benchmarks_tpu_torch.data import jpeg
from kf_benchmarks_tpu_torch.data import tfrecord
from kf_benchmarks_tpu_torch.models import ssd_constants
from kf_benchmarks_tpu_torch.models import ssd_dataloader

# (ref: preprocessing.py:75-97 _RESIZE_METHOD_MAP + round_robin)
_RESIZE_METHODS = ("nearest", "bilinear", "bicubic", "area")
_METHOD_IDS = {"nearest": image_ops.NEAREST, "bilinear": image_ops.BILINEAR,
               "bicubic": image_ops.BICUBIC, "area": image_ops.BOX}

# The official variant's means, in [0, 255] (the official CHANNEL_MEANS).
CHANNEL_MEANS = np.asarray([123.68, 116.779, 103.939], np.float32)
# SSD's normalisation of [0, 1] pixels (ssd_constants).
COCO_MEAN = np.asarray(ssd_constants.NORMALIZATION_MEAN, np.float32)
COCO_STD = np.asarray(ssd_constants.NORMALIZATION_STD, np.float32)


def get_image_resize_method(resize_method: str, batch_position: int = 0):
  """Round-robin per batch position (ref: preprocessing.py:85-127)."""
  if resize_method != "round_robin":
    return _METHOD_IDS[resize_method]
  return _METHOD_IDS[_RESIZE_METHODS[batch_position % len(_RESIZE_METHODS)]]


def normalized_image(images: np.ndarray) -> np.ndarray:
  """[0, 255] -> [-1, 1] (ref: preprocessing.py:130-133)."""
  return images.astype(np.float32) * (1.0 / 127.5) - 1.0


# -- Example proto parsing (ref: preprocessing.py:27-81) ---------------------

def parse_example_proto(record: bytes):
  """Returns (image_buffer, label, bbox[N,4] ymin,xmin,ymax,xmax)."""
  feats = example_lib.parse_example(record)
  image_buffer = feats["image/encoded"][0]
  label = int(np.asarray(feats["image/class/label"])[0])
  def _coords(key):
    v = feats.get(key)
    return np.asarray(v, np.float32) if v is not None and len(v) else (
        np.zeros((0,), np.float32))
  xmin, ymin = _coords("image/object/bbox/xmin"), _coords(
      "image/object/bbox/ymin")
  xmax, ymax = _coords("image/object/bbox/xmax"), _coords(
      "image/object/bbox/ymax")
  bbox = np.stack([ymin, xmin, ymax, xmax], axis=-1) if len(xmin) else (
      np.zeros((0, 4), np.float32))
  return image_buffer, label, bbox


# -- crop sampling (tf.image.sample_distorted_bounding_box semantics) --------

def sample_distorted_bounding_box(
    rng: random.Random, height: int, width: int, bboxes: np.ndarray,
    min_object_covered: float = 0.1,
    aspect_ratio_range: Tuple[float, float] = (0.75, 1.33),
    area_range: Tuple[float, float] = (0.05, 1.0),
    max_attempts: int = 100) -> Tuple[int, int, int, int]:
  """Sample a crop window (y, x, h, w); whole image on failure (ref:
  preprocessing.py:219-247 train_image's distorted crop)."""
  img_area = float(height * width)
  for _ in range(max_attempts):
    aspect = rng.uniform(*aspect_ratio_range)
    area = rng.uniform(*area_range) * img_area
    # h * w = area; w / h = aspect  =>  h = sqrt(area / aspect)
    h = int(round((area / aspect) ** 0.5))
    w = int(round(h * aspect))
    if h <= 0 or w <= 0 or h > height or w > width:
      continue
    y = rng.randint(0, height - h)
    x = rng.randint(0, width - w)
    if len(bboxes):
      # min_object_covered: the crop must cover >= the fraction of at
      # least one object box.
      covered = False
      for ymin, xmin, ymax, xmax in bboxes:
        by0, bx0 = ymin * height, xmin * width
        by1, bx1 = ymax * height, xmax * width
        barea = max(by1 - by0, 0.0) * max(bx1 - bx0, 0.0)
        if barea <= 0:
          continue
        iy = max(0.0, min(by1, y + h) - max(by0, y))
        ix = max(0.0, min(bx1, x + w) - max(bx0, x))
        if iy * ix >= min_object_covered * barea:
          covered = True
          break
      if not covered:
        continue
    return y, x, h, w
  return 0, 0, height, width


# -- color distortion (ref: distort_color, preprocessing.py:268-308) ---------

def distort_color(img: np.ndarray, batch_position: int,
                  rng: random.Random) -> np.ndarray:
  """Brightness/saturation/contrast jitter, order by batch position
  (ref fast-mode orderings; hue omitted as in the reference's fast path)."""
  def brightness(i):
    # max_delta = 32/255 in [0,1] space == factor jitter around 1.
    return image_ops.brightness(
        i, 1.0 + rng.uniform(-32.0 / 255.0, 32.0 / 255.0))
  def saturation(i):
    return image_ops.color(i, rng.uniform(0.5, 1.5))
  def contrast(i):
    return image_ops.contrast(i, rng.uniform(0.5, 1.5))
  if batch_position % 2 == 0:
    ops = (brightness, saturation, contrast)
  else:
    ops = (brightness, contrast, saturation)
  for op in ops:
    img = op(img)
  return img


def _draft_decode(image_buffer: bytes, need_w: float,
                  need_h: float) -> np.ndarray:
  """DCT-domain reduced-scale decode: the scale PIL's ``draft`` picks when
  the consumer needs only ``need_w x need_h`` of the full frame (1/2, 1/4
  or 1/8; the reference's fuse_decode_and_crop analog, ref:
  preprocessing.py:192-265). Callers rescale full-frame coordinates by the
  returned image's size ratio."""
  iw, ih, _ = jpeg.info(image_buffer)
  scale = jpeg.draft_scale((iw, ih),
                           (max(1, int(need_w)), max(1, int(need_h))))
  return jpeg.decode(image_buffer, scale)


def train_image(image_buffer: bytes, height: int, width: int,
                bbox: np.ndarray, batch_position: int,
                resize_method: str, distortions: bool,
                rng: random.Random) -> np.ndarray:
  """Distorted-crop training path -> uint8 HWC (ref: train_image,
  preprocessing.py:192-265)."""
  iw, ih, _ = jpeg.info(image_buffer)
  # The crop is sampled in FULL-frame coordinates (the rng stream is
  # independent of the decode scale), then the decode runs at the
  # smallest DCT scale that still covers the target resolution inside
  # the crop, and the coordinates are mapped onto the decoded frame.
  y, x, h, w = sample_distorted_bounding_box(rng, ih, iw, bbox)
  img = _draft_decode(image_buffer, iw * width / max(w, 1),
                      ih * height / max(h, 1))
  sx, sy = img.shape[1] / iw, img.shape[0] / ih
  # fuse_decode_and_crop analog: crop before the (expensive) resize.
  img = image_ops.crop(img, (int(x * sx), int(y * sy),
                             max(int(x * sx) + 1, int((x + w) * sx)),
                             max(int(y * sy) + 1, int((y + h) * sy))))
  method = get_image_resize_method(resize_method, batch_position)
  img = image_ops.resize(img, (width, height), method)
  if rng.random() < 0.5:
    img = image_ops.flip_left_right(img)
  if distortions:
    img = distort_color(img, batch_position, rng)
  return np.ascontiguousarray(img)


def eval_image(image_buffer: bytes, height: int, width: int,
               batch_position: int, resize_method: str) -> np.ndarray:
  """Central-crop-87.5% eval path -> uint8 HWC (ref: eval_image,
  preprocessing.py:137-190)."""
  # 87.5% central crop resized to HxW only needs ~H/0.875 of the frame.
  img = _draft_decode(image_buffer, width / 0.875, height / 0.875)
  ih, iw = img.shape[:2]
  ch, cw = int(ih * 0.875), int(iw * 0.875)
  y, x = (ih - ch) // 2, (iw - cw) // 2
  img = image_ops.crop(img, (x, y, x + cw, y + ch))
  method = get_image_resize_method(resize_method, batch_position)
  return image_ops.resize(img, (width, height), method)


# -- preprocessors -----------------------------------------------------------

class InputPreprocessor:
  """Base preprocessor (ref: preprocessing.py:311-548). Yields numpy
  (images[batch, H, W, C], labels[int32]) with the images as
  ``NORMALIZATION`` says."""

  NORMALIZATION: Optional[str] = "unit"

  def __init__(self, batch_size: int, output_shape: Sequence[int],
               train: bool = True, distortions: bool = False,
               resize_method: str = "bilinear", seed: int = 301,
               shift_ratio: float = 0.0, num_threads: int = 8,
               repeat_cached_sample: bool = False,
               use_caching: bool = False):
    self.batch_size = batch_size
    self.height, self.width, self.depth = output_shape
    self.train = train
    self.distortions = distortions
    self.resize_method = resize_method
    self.seed = seed
    self.shift_ratio = shift_ratio
    self.num_threads = max(1, num_threads)
    # --datasets_repeat_cached_sample: serve the first record forever to
    # emulate memory-speed IO (ref: preprocessing create_dataset
    # take(1).cache().repeat(), :879-882).
    self.repeat_cached_sample = repeat_cached_sample
    # --datasets_use_caching: hold the raw records in memory after the
    # first pass (ref: ds.cache(), :254-258).
    self.use_caching = use_caching

  def minibatches(self, dataset, subset: str) -> Iterator[
      Tuple[np.ndarray, np.ndarray]]:
    raise NotImplementedError

  def _record_stream(self, dataset, subset: str) -> Iterator[bytes]:
    """Shared TFRecord shard stream: shift_ratio de-overlap (ref:
    RecordInput shift_ratio, preprocessing.py:601-617), shard-order
    shuffle + endless replay for training, ONE pass for eval (consumers
    handle exhaustion -- see BenchmarkCNN._eval_once)."""
    shards = tfrecord.list_shards(dataset.data_dir, subset)
    shift = int(len(shards) * self.shift_ratio) % max(len(shards), 1)
    shards = shards[shift:] + shards[:shift]
    if self.repeat_cached_sample:
      first = next(iter(tfrecord.read_records(shards[0])), None)
      if first is None:
        raise ValueError(
            f"datasets_repeat_cached_sample: first shard {shards[0]} "
            "contains no records")
      while True:
        yield first
    rng = random.Random(self.seed)
    cache = [] if self.use_caching else None
    first_pass = True
    while True:
      if cache is not None and not first_pass:
        order2 = list(cache)
        if self.train:
          rng.shuffle(order2)
        yield from order2
        continue
      order = list(shards)
      if self.train:
        rng.shuffle(order)
      for path in order:
        for record in tfrecord.read_records(path):
          if cache is not None:
            cache.append(record)
          yield record
      first_pass = False
      if not self.train:
        break

  def supports_datasets(self) -> bool:
    return True


class RecordInputImagePreprocessor(InputPreprocessor):
  """TFRecord image classification pipeline
  (ref: preprocessing.py:551-632)."""

  def _preprocess_one(self, record: bytes, batch_position: int,
                      rng: random.Random) -> Tuple[np.ndarray, int]:
    image_buffer, label, bbox = parse_example_proto(record)
    if self.train:
      img = train_image(image_buffer, self.height, self.width, bbox,
                        batch_position, self.resize_method,
                        self.distortions, rng)
    else:
      img = eval_image(image_buffer, self.height, self.width,
                       batch_position, self.resize_method)
    return img, label

  def minibatches(self, dataset, subset: str):
    stream = self._record_stream(dataset, subset)
    rngs = [random.Random(self.seed + 7919 * i)
            for i in range(self.batch_size)]
    # The codec's calls release the GIL, so the pool decodes in parallel.
    pool = (concurrent.futures.ThreadPoolExecutor(self.num_threads)
            if self.num_threads > 1 else None)
    try:
      while True:
        records = list(itertools.islice(stream, self.batch_size))
        if len(records) < self.batch_size:
          return  # eval stream exhausted (train replays forever)
        images = np.empty((self.batch_size, self.height, self.width,
                           self.depth), np.uint8)
        labels = np.empty(self.batch_size, np.int32)

        def one(i, rec):
          images[i], labels[i] = self._preprocess_one(rec, i, rngs[i])

        if pool is None:
          for i, rec in enumerate(records):
            one(i, rec)
        else:
          for f in [pool.submit(one, i, rec)
                    for i, rec in enumerate(records)]:
            f.result()
        yield images, labels
    finally:
      if pool is not None:
        pool.shutdown(wait=False)


def _mp_decode_worker(task_q, done_q, shm_name, buf_shape, in_shm_name,
                      in_shape, pre_bytes):
  """Decode worker of MultiprocessImagePreprocessor (the JAX package's
  _mp_decode_worker, data/preprocessing.py:383-423), in a SPAWNED process:
  takes one task per contiguous batch slice -- (buffer, batch index,
  entries), each entry locating a record's bytes in the shared input ring
  or carrying them inline when they overflowed its staging slot --, decodes
  with the pickled preprocessor's single-image path, writes each uint8
  image straight into its final slot of the shared output ring and posts
  ONE done message for the slice."""
  from multiprocessing import shared_memory  # noqa: PLC0415
  pre = pickle.loads(pre_bytes)
  shm = shared_memory.SharedMemory(name=shm_name)
  in_shm = shared_memory.SharedMemory(name=in_shm_name)
  ring = np.ndarray(buf_shape, np.uint8, buffer=shm.buf)
  in_ring = np.ndarray(in_shape, np.uint8, buffer=in_shm.buf)
  try:
    while True:
      task = task_q.get()
      if task is None:
        return
      buf, batch_idx, entries = task
      labels = []
      err = None
      for pos, off, length, inline in entries:
        record = (inline if inline is not None
                  else bytes(in_ring[buf, off:off + length]))
        # Deterministic per-(position, batch) stream: a worker holds no
        # state across batches, so the stream is derived, not advanced.
        rng = random.Random(pre.seed + 7919 * pos + 104729 * batch_idx)
        try:
          ring[buf, pos], label = pre._preprocess_one(record, pos, rng)
          labels.append((pos, int(label)))
        except Exception as e:  # noqa: BLE001 -- raised in the parent
          err = (pos, repr(e))
          break
      # One message a slice; the count covers the whole slice even on an
      # error (the parent raises before it uses the batch).
      done_q.put((buf, len(entries), labels, err))
  finally:
    del ring, in_ring
    shm.close()
    in_shm.close()


@contextlib.contextmanager
def _bare_main():
  """Hides the parent's ``__main__`` while workers are spawned: a spawned
  child re-imports the parent's main module (the CLI, which imports torch)
  unless that module names neither a spec nor a file. The swap lasts the
  ``Process.start`` calls; the trainer's thread meanwhile runs the step,
  which reads nothing of ``__main__``."""
  main = sys.modules["__main__"]
  sys.modules["__main__"] = types.ModuleType("__main__")
  try:
    yield
  finally:
    sys.modules["__main__"] = main


class MultiprocessImagePreprocessor(RecordInputImagePreprocessor):
  """Process-parallel TFRecord image pipeline (the JAX package's
  MultiprocessImagePreprocessor, data/preprocessing.py:426-604): decode
  worker PROCESSES, so decode scales past the one core that the GIL-bound
  parts of the thread pool leave it.

  * Workers are spawned, never forked: the parent holds CUDA state. They
    import this module and nothing of torch; the codec's libraries are
    built by the parent (under ops/_build.py's lock) and loaded by each.
  * Each worker writes each image into its final slot of a shared-memory
    output ring of ``num_buffers`` (at least 2) global batches, uint8 HWC
    as the thread pool yields them (data/device_feed.py normalises on the
    device). The raw records are staged in a shared input ring of
    ``input_bytes_per_image`` (256 KiB) a slot; a record larger than its
    slot travels inline in the task message.
  * One task and one done message per contiguous slice of a batch, never
    one per image. Batches are dispatched one ahead, so the workers decode
    batch k+1 while the consumer holds batch k; ``dispatch_seconds`` /
    ``dispatch_calls`` total the parent's staging and enqueueing.
  * Position i of batch b draws from ``random.Random(seed + 7919 * i +
    104729 * b)``: with the same records and seed, the batches are the JAX
    pool's, and batch 0 is the thread pool's.
  * ``num_threads`` is the worker count, capped by default at the cores
    this process may run on; an explicit ``num_processes`` is honoured,
    with a warning when it oversubscribes them.
  * A worker that dies (killed, or crashed in a decode) makes the next
    batch raise within about half a second, never hang.
  * Each batch is a view of its ring slot (images and labels), valid
    until the consumer asks for ``num_buffers - 1`` more batches: the
    DeviceFeeder copies it into pinned memory at once (a chunk of K
    batches within K + 2 buffers), so that copy out of the ring is the
    only host copy. A consumer that keeps batches copies them.
  """

  def __init__(self, *args, num_processes: Optional[int] = None,
               num_buffers: int = 3,
               input_bytes_per_image: int = 256 << 10, **kwargs):
    super().__init__(*args, **kwargs)
    cores = len(os.sched_getaffinity(0))
    if num_processes:
      self.num_processes = max(1, num_processes)
      if self.num_processes > cores:
        from kf_benchmarks_tpu_torch.utils import log as log_util  # noqa: PLC0415
        log_util.log_fn(
            f"Decode pool oversubscribed: {self.num_processes} workers "
            f"on {cores} available core(s); workers beyond the cores only "
            "contend for them")
    else:
      self.num_processes = min(self.num_threads, cores)
    self.num_buffers = max(2, num_buffers)
    self.input_bytes_per_image = max(1, int(input_bytes_per_image))
    self.dispatch_seconds = 0.0
    self.dispatch_calls = 0

  def minibatches(self, dataset, subset: str):
    import multiprocessing  # noqa: PLC0415
    from multiprocessing import shared_memory  # noqa: PLC0415
    jpeg.library()  # built here once; each worker loads the build
    image_ops.library()
    ctx = multiprocessing.get_context("spawn")
    stream = self._record_stream(dataset, subset)
    shape = (self.num_buffers, self.batch_size, self.height, self.width,
             self.depth)
    shm = shared_memory.SharedMemory(create=True, size=int(np.prod(shape)))
    ring = np.ndarray(shape, np.uint8, buffer=shm.buf)
    in_shape = (self.num_buffers,
                self.batch_size * self.input_bytes_per_image)
    in_shm = shared_memory.SharedMemory(create=True,
                                        size=int(np.prod(in_shape)))
    in_ring = np.ndarray(in_shape, np.uint8, buffer=in_shm.buf)
    task_q = ctx.Queue()
    done_q = ctx.Queue()
    pre_bytes = pickle.dumps(self)
    workers = [
        ctx.Process(target=_mp_decode_worker,
                    args=(task_q, done_q, shm.name, shape, in_shm.name,
                          in_shape, pre_bytes),
                    daemon=True, name=f"decode-worker-{i}")
        for i in range(self.num_processes)]
    with _bare_main():
      for w in workers:
        w.start()
    remaining = [0] * self.num_buffers
    labels_buf = [np.empty(self.batch_size, np.int32)
                  for _ in range(self.num_buffers)]

    def dispatch(batch_idx: int) -> bool:
      records = list(itertools.islice(stream, self.batch_size))
      if len(records) < self.batch_size:
        return False
      t0 = time.perf_counter()
      buf = batch_idx % self.num_buffers
      remaining[buf] = self.batch_size
      cap = in_shape[1]
      off = 0
      entries = []
      for pos, rec in enumerate(records):
        if off + len(rec) <= cap:
          in_ring[buf, off:off + len(rec)] = np.frombuffer(rec, np.uint8)
          entries.append((pos, off, len(rec), None))
          off += len(rec)
        else:
          entries.append((pos, 0, 0, rec))
      per = -(-self.batch_size // self.num_processes)
      for start in range(0, self.batch_size, per):
        task_q.put((buf, batch_idx, entries[start:start + per]))
      self.dispatch_seconds += time.perf_counter() - t0
      self.dispatch_calls += 1
      return True

    def collect(buf: int) -> None:
      while remaining[buf] > 0:
        # A worker killed hard never posts its slice: poll liveness before
        # each wait, so the trainer raises instead of hanging (or running
        # on with fewer workers than it was given).
        dead = [w for w in workers if not w.is_alive()]
        if dead:
          raise RuntimeError(
              f"{len(dead)} decode worker(s) died (exit codes "
              f"{[w.exitcode for w in dead]}) with {remaining[buf]} "
              "images outstanding")
        try:
          b, count, labels, err = done_q.get(timeout=0.5)
        except queue_lib.Empty:
          continue
        if err is not None:
          raise RuntimeError(f"decode worker failed at buffer {b} "
                             f"position {err[0]}: {err[1]}")
        for pos, label in labels:
          labels_buf[b][pos] = label
        remaining[b] -= count

    try:
      if not dispatch(0):
        return
      batch_idx = 0
      while True:
        has_next = dispatch(batch_idx + 1)
        buf = batch_idx % self.num_buffers
        collect(buf)
        yield ring[buf], labels_buf[buf]
        if not has_next:
          return
        batch_idx += 1
    finally:
      # A worker that died may have held a queue's lock: then the others
      # are killed, not asked to finish.
      abandoned = any(not w.is_alive() for w in workers)
      if not abandoned:
        for _ in workers:
          task_q.put(None)
      # Drain the done queue while the workers exit: a worker blocked on
      # flushing its last done message would never join.
      deadline = time.monotonic() + (0.0 if abandoned else 5.0)
      for w in workers:
        while w.is_alive() and time.monotonic() < deadline:
          try:
            while True:
              done_q.get_nowait()
          except queue_lib.Empty:
            pass
          w.join(timeout=0.1)
        if w.is_alive():
          w.kill()
          w.join()
      task_q.close()
      done_q.close()
      if abandoned:
        task_q.cancel_join_thread()
      else:
        task_q.join_thread()
      del ring, in_ring
      for m in (shm, in_shm):
        try:
          m.close()
        except BufferError:
          pass  # a consumer still holds a view; the mapping goes with it
        m.unlink()


class OfficialImagenetPreprocessor(RecordInputImagePreprocessor):
  """The official-models ImageNet preprocessing variant
  (ref: preprocessing.py:635-652 ImagenetPreprocessor).

  Differences from the default pipeline: eval resizes preserving aspect
  ratio so the short side is 256 then takes a central HxW crop (instead
  of the 87.5% crop), train never color-distorts, and normalization
  subtracts the ImageNet channel means in [0,255] space with no std
  scaling (the official CHANNEL_MEANS convention)."""

  NORMALIZATION = "channel_means"
  CHANNEL_MEANS = CHANNEL_MEANS
  RESIZE_MIN = 256

  def _preprocess_one(self, record: bytes, batch_position: int,
                      rng: random.Random):
    image_buffer, label, bbox = parse_example_proto(record)
    if self.train:
      # Same crop/flip pipeline as the default path, bilinear, no color
      # distortion (the official preprocess_image train path).
      arr = train_image(image_buffer, self.height, self.width, bbox,
                        batch_position, "bilinear", distortions=False,
                        rng=rng)
    else:
      img = jpeg.decode(image_buffer)
      ih, iw = img.shape[:2]
      scale = self.RESIZE_MIN / min(iw, ih)
      img = image_ops.resize(img, (max(int(iw * scale), self.width),
                                   max(int(ih * scale), self.height)),
                             image_ops.BILINEAR)
      ih, iw = img.shape[:2]
      x, y = (iw - self.width) // 2, (ih - self.height) // 2
      arr = image_ops.crop(img, (x, y, x + self.width, y + self.height))
    return arr, label


class Cifar10ImagePreprocessor(InputPreprocessor):
  """In-memory numpy CIFAR-10 pipeline (ref: preprocessing.py:653-741;
  pickle loading ref: datasets.py:140-189)."""

  def _read_data_files(self, dataset, subset: str) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    if subset == "train":
      names = [f"data_batch_{i}" for i in range(1, 6)]
    else:
      names = ["test_batch"]
    images, labels = [], []
    base = dataset.data_dir
    sub = os.path.join(base, "cifar-10-batches-py")
    if os.path.isdir(sub):
      base = sub
    for name in names:
      with open(os.path.join(base, name), "rb") as f:
        batch = pickle.load(f, encoding="bytes")
      images.append(np.asarray(batch[b"data"], np.uint8))
      labels.append(np.asarray(batch[b"labels"], np.int32))
    # stored CHW row-major; reshape+transpose to HWC
    data = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data, np.concatenate(labels)

  def _distort(self, image: np.ndarray, rng: random.Random) -> np.ndarray:
    padded = np.zeros((self.height + 8, self.width + 8, self.depth),
                      image.dtype)
    padded[4:4 + self.height, 4:4 + self.width] = image
    y = rng.randint(0, 8)
    x = rng.randint(0, 8)
    out = padded[y:y + self.height, x:x + self.width]
    if rng.random() < 0.5:
      out = out[:, ::-1]
    return out

  def minibatches(self, dataset, subset: str):
    all_images, all_labels = self._read_data_files(dataset, subset)
    n = len(all_images)
    rng = random.Random(self.seed)
    nprng = np.random.RandomState(self.seed)
    while True:
      idx = nprng.randint(0, n, size=self.batch_size) if self.train else None
      if idx is None:
        # sequential epochs for eval
        for start in range(0, n - self.batch_size + 1, self.batch_size):
          sel = np.arange(start, start + self.batch_size)
          yield all_images[sel], all_labels[sel].astype(np.int32)
        continue
      imgs = all_images[idx]
      if self.train and self.distortions:
        imgs = np.stack([self._distort(im, rng) for im in imgs])
      yield np.ascontiguousarray(imgs), all_labels[idx].astype(np.int32)


class COCOPreprocessor(InputPreprocessor):
  """SSD's COCO detection pipeline (the JAX package's
  data/preprocessing.py:662-874): the IoU-biased crop, the resize to
  300x300, the flip, the optional colour jitter and the anchor-space label
  encoding, from the same ``np.random.RandomState`` streams (seeded
  ``seed + 7919 * i`` per batch position).

  Train batches: (images, (encoded boxes [N, 8732, 4], classes [N, 8732],
  matched anchors [N])). Eval batches: (images, (boxes [N, 200, 4],
  classes [N, 200, 1], source ids [N], raw shapes [N, 3])), the boxes
  trimmed or zero-padded to MAX_NUM_EVAL_BOXES and the last batch
  partial. The images are uint8; ``NORMALIZATION`` "coco" is the JAX
  package's ``(x / 255 - mean) / std``, applied on the device. Boxes are
  (ymin, xmin, ymax, xmax), normalised, throughout."""

  NORMALIZATION = "coco"

  @staticmethod
  def parse_coco_example(record: bytes):
    """COCO Example -> (image bytes, boxes ltrb [N, 4], classes [N] in
    1..80, source id). Raw 90-class COCO ids map through CLASS_MAP."""
    feats = example_lib.parse_example(record)
    image_buffer = feats["image/encoded"][0]

    def _coords(key):
      v = feats.get(key)
      return (np.asarray(v, np.float32) if v is not None and len(v)
              else np.zeros((0,), np.float32))

    ymin, xmin = _coords("image/object/bbox/ymin"), _coords(
        "image/object/bbox/xmin")
    ymax, xmax = _coords("image/object/bbox/ymax"), _coords(
        "image/object/bbox/xmax")
    boxes = (np.stack([ymin, xmin, ymax, xmax], axis=-1) if len(ymin)
             else np.zeros((0, 4), np.float32))
    raw = feats.get("image/object/class/label")
    raw = np.asarray(raw, np.int64) if raw is not None else np.zeros(
        (0,), np.int64)
    class_map = np.asarray(ssd_constants.CLASS_MAP, np.int32)
    classes = np.where((raw >= 0) & (raw < len(class_map)),
                       class_map[np.clip(raw, 0, len(class_map) - 1)],
                       -1).astype(np.int32)
    keep = classes > 0
    sid = feats.get("image/source_id")
    if sid is not None and len(sid):
      s = sid[0]
      source_id = int(s) if not isinstance(s, bytes) else int(
          s.decode() or 0)
    else:
      source_id = 0
    return image_buffer, boxes[keep], classes[keep], source_id

  @staticmethod
  def _ssd_crop(rng: np.random.RandomState, boxes: np.ndarray):
    """(crop ltrb, box mask): per pass, the whole image with probability
    P_NO_CROP_PER_PASS, else the highest-index of NUM_CROP_PASSES
    candidate rects whose IoU with every box clears a drawn threshold and
    which hold a box centre; 100 passes, then the whole image."""
    whole = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    all_mask = np.ones((len(boxes),), bool)
    for _ in range(100):
      if rng.uniform() < ssd_constants.P_NO_CROP_PER_PASS:
        return whole, all_mask
      n = ssd_constants.NUM_CROP_PASSES
      h = rng.uniform(0.3, 1.0, size=n)
      w = rng.uniform(0.3, 1.0, size=n)
      top = rng.uniform(0, 1, size=n) * (1 - h)
      left = rng.uniform(0, 1, size=n) * (1 - w)
      rects = np.stack([top, left, top + h, left + w], axis=1)
      min_iou = ssd_constants.CROP_MIN_IOU_CHOICES[
          rng.randint(len(ssd_constants.CROP_MIN_IOU_CHOICES))]
      ious = ssd_dataloader.calc_iou_matrix(rects.astype(np.float32), boxes)
      yc = 0.5 * (boxes[:, 0] + boxes[:, 2])
      xc = 0.5 * (boxes[:, 1] + boxes[:, 3])
      centers_in = ((yc[None, :] > rects[:, 0:1]) &
                    (yc[None, :] < rects[:, 2:3]) &
                    (xc[None, :] > rects[:, 1:2]) &
                    (xc[None, :] < rects[:, 3:4]))
      valid_aspect = (h / w < 2) & (w / h < 2)
      valid = (valid_aspect & np.all(ious > min_iou, axis=1) &
               np.any(centers_in, axis=1))
      if np.any(valid):
        i = int(np.max(np.nonzero(valid)[0]))
        return rects[i].astype(np.float32), centers_in[i]
    return whole, all_mask

  @staticmethod
  def _color_jitter(img: np.ndarray, rng: np.random.RandomState
                    ) -> np.ndarray:
    """Brightness 0.125, contrast 0.5, saturation 0.5, then a hue shift of
    up to 0.05 of the circle on PIL's HSV plane."""
    img = image_ops.brightness(img, 1.0 + rng.uniform(-0.125, 0.125))
    img = image_ops.contrast(img, rng.uniform(0.5, 1.5))
    img = image_ops.color(img, rng.uniform(0.5, 1.5))
    hsv = image_ops.rgb_to_hsv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] +
                   int(rng.uniform(-0.05, 0.05) * 255)) % 256
    return image_ops.hsv_to_rgb(hsv.astype(np.uint8))

  def _preprocess_train(self, parsed, rng: np.random.RandomState):
    image_buffer, boxes, classes, _ = parsed
    img = jpeg.decode(image_buffer)
    crop, mask = self._ssd_crop(rng, boxes)
    ih, iw = img.shape[:2]
    y0, x0, y1, x1 = crop
    img = image_ops.crop(img, (int(x0 * iw), int(y0 * ih),
                               max(int(x1 * iw), int(x0 * iw) + 1),
                               max(int(y1 * ih), int(y0 * ih) + 1)))
    img = image_ops.resize(img, (self.width, self.height), image_ops.BILINEAR)
    boxes, classes = boxes[mask], classes[mask]
    # The surviving boxes clipped to the crop, in its coordinates.
    ch, cw = max(y1 - y0, 1e-6), max(x1 - x0, 1e-6)
    boxes = np.stack([
        (np.clip(boxes[:, 0], y0, y1) - y0) / ch,
        (np.clip(boxes[:, 1], x0, x1) - x0) / cw,
        (np.clip(boxes[:, 2], y0, y1) - y0) / ch,
        (np.clip(boxes[:, 3], x0, x1) - x0) / cw,
    ], axis=1) if len(boxes) else boxes
    if rng.uniform() < 0.5:  # the flip, image and boxes
      img = image_ops.flip_left_right(img)
      if len(boxes):
        boxes = np.stack([boxes[:, 0], 1.0 - boxes[:, 3],
                          boxes[:, 2], 1.0 - boxes[:, 1]], axis=1)
    if self.distortions:
      img = self._color_jitter(img, rng)
    encoded, enc_classes, num_matched = ssd_dataloader.encode_labels(
        boxes.astype(np.float32), classes)
    return img, encoded, enc_classes, np.float32(num_matched)

  def _preprocess_eval(self, parsed):
    image_buffer, boxes, classes, source_id = parsed
    img = jpeg.decode(image_buffer)
    ih, iw = img.shape[:2]
    img = image_ops.resize(img, (self.width, self.height), image_ops.BILINEAR)
    m = ssd_constants.MAX_NUM_EVAL_BOXES

    def trim_and_pad(arr, width):
      arr = arr[:m]
      out = np.zeros((m, width), np.float32)
      if len(arr):
        out[:len(arr)] = arr.reshape(len(arr), width)
      return out

    return (img, trim_and_pad(boxes, 4),
            trim_and_pad(classes.astype(np.float32), 1),
            np.int32(source_id), np.asarray([ih, iw, 3], np.int32))

  def minibatches(self, dataset, subset: str):
    stream = self._record_stream(dataset, subset)
    pool = concurrent.futures.ThreadPoolExecutor(self.num_threads)
    rngs = [np.random.RandomState(self.seed + 7919 * i)
            for i in range(self.batch_size)]
    try:
      exhausted = False
      while not exhausted:
        batch_parsed = []
        for record in stream:
          parsed = self.parse_coco_example(record)
          # Training skips examples without boxes; eval keeps them (every
          # validation image counts in the mAP's recall).
          if self.train and not len(parsed[1]):
            continue
          batch_parsed.append(parsed)
          if len(batch_parsed) == self.batch_size:
            break
        if len(batch_parsed) < self.batch_size:
          exhausted = True  # eval: the final partial batch still goes
          if not batch_parsed:
            return
        if self.train:
          results = [f.result() for f in [
              pool.submit(self._preprocess_train, parsed, rngs[i])
              for i, parsed in enumerate(batch_parsed)]]
          yield (np.stack([r[0] for r in results]),
                 (np.stack([r[1] for r in results]),
                  np.stack([r[2] for r in results]),
                  np.asarray([r[3] for r in results], np.float32)))
        else:
          results = [f.result() for f in [
              pool.submit(self._preprocess_eval, parsed)
              for parsed in batch_parsed]]
          yield (np.stack([r[0] for r in results]),
                 (np.stack([r[1] for r in results]),
                  np.stack([r[2] for r in results]),
                  np.asarray([r[3] for r in results], np.int32),
                  np.stack([r[4] for r in results])))
    finally:
      pool.shutdown(wait=False)


class LibrispeechPreprocessor(InputPreprocessor):
  """The LibriSpeech pipeline (the JAX package's data/preprocessing.py:
  877-954): SequenceExample records of precomputed spectrogram frames
  (sequence feature ``features``, [T, 161] f32) with context ``labels``
  (varlen int64), ``input_length`` and ``label_length``. Every utterance
  pads with zeros to the model's ``max_time_steps`` frames and
  ``max_label_length`` labels (``output_shape`` carries (max_time_steps,
  bins, 1); the benchmark sets ``max_label_length`` from the model); an
  over-long one is truncated and its lengths clamped.

  Batches: (spectrogram [n, max_T, bins, 1] f32, (labels [n, max_labels],
  input_lengths [n], label_lengths [n])), int32; the spectrogram is not
  normalised (``NORMALIZATION`` None) and the feeder casts it to the
  compute dtype on the device. Training streams replay endlessly; eval
  makes one pass and drops a last partial batch, as the JAX package's."""

  NORMALIZATION = None

  def __init__(self, *args, max_label_length: int = 576, **kwargs):
    super().__init__(*args, **kwargs)
    self.max_time_steps = self.height
    self.num_feature_bins = self.width
    self.max_label_length = max_label_length

  def _parse_utterance(self, record: bytes):
    context, seqs = example_lib.parse_sequence_example(record)
    frames = seqs.get("features", [])
    feats = (np.stack([np.asarray(f, np.float32) for f in frames])
             if frames else np.zeros((0, self.num_feature_bins),
                                     np.float32))
    labels = np.asarray(context.get("labels", []), np.int64)
    t = min(len(feats), self.max_time_steps)
    n = min(len(labels), self.max_label_length)
    spec = np.zeros((self.max_time_steps, self.num_feature_bins, 1),
                    np.float32)
    spec[:t, :, 0] = feats[:t, :self.num_feature_bins]
    lab = np.zeros((self.max_label_length,), np.int32)
    lab[:n] = labels[:n]
    return spec, lab, np.int32(t), np.int32(n)

  def minibatches(self, dataset, subset: str):
    stream = self._record_stream(dataset, subset)
    pool = concurrent.futures.ThreadPoolExecutor(self.num_threads)
    try:
      while True:
        records = list(itertools.islice(stream, self.batch_size))
        if len(records) < self.batch_size:
          return
        results = list(pool.map(self._parse_utterance, records))
        yield (np.stack([r[0] for r in results]),
               (np.stack([r[1] for r in results]),
                np.asarray([r[2] for r in results], np.int32),
                np.asarray([r[3] for r in results], np.int32)))
    finally:
      pool.shutdown(wait=False)


class TestImagePreprocessor(InputPreprocessor):
  """Injects fake numpy data as "real" input (ref:
  preprocessing.py:896-975). ``set_fake_data`` then iterate. The batches
  pass through as they are, as in the JAX package (float32, no
  normalisation)."""

  NORMALIZATION = None

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self.fake_images: Optional[np.ndarray] = None
    self.fake_labels: Optional[np.ndarray] = None
    self.expected_subset: Optional[str] = None

  def set_fake_data(self, images: np.ndarray, labels: np.ndarray) -> None:
    self.fake_images = np.asarray(images)
    self.fake_labels = np.asarray(labels)

  def minibatches(self, dataset, subset: str):
    del dataset
    if self.expected_subset is not None:
      assert subset == self.expected_subset, (subset, self.expected_subset)
    assert self.fake_images is not None, "call set_fake_data first"
    n = len(self.fake_images)
    pos = 0
    while True:
      sel = [(pos + i) % n for i in range(self.batch_size)]
      pos = (pos + self.batch_size) % n
      yield (self.fake_images[sel].astype(np.float32),
             self.fake_labels[sel].astype(np.int32))


_PREPROCESSORS = {
    "imagenet": RecordInputImagePreprocessor,
    "cifar10": Cifar10ImagePreprocessor,
    "coco": COCOPreprocessor,
    "librispeech": LibrispeechPreprocessor,
    "test": TestImagePreprocessor,
}


def get_preprocessor(dataset_name: str, kind: str = "default"):
  """Name -> preprocessor class (ref: datasets.py:208-229 maps)."""
  if kind == "test":
    return TestImagePreprocessor
  if kind == "official_models_imagenet":
    if dataset_name != "imagenet":
      raise ValueError("official_models_imagenet preprocessing applies "
                       f"to the imagenet dataset, not {dataset_name!r}")
    return OfficialImagenetPreprocessor
  if kind == "multiprocess":
    if dataset_name != "imagenet":
      raise ValueError("multiprocess preprocessing applies to the "
                       f"imagenet dataset, not {dataset_name!r}")
    return MultiprocessImagePreprocessor
  if kind != "default":
    raise ValueError(f"Unknown input preprocessor {kind!r}; expected "
                     "'default', 'official_models_imagenet', "
                     "'multiprocess', or 'test'")
  if dataset_name not in _PREPROCESSORS:
    raise NotImplementedError(
        f"No input preprocessor for dataset {dataset_name!r}")
  return _PREPROCESSORS[dataset_name]
