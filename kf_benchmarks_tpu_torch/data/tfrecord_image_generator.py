"""TFRecord fixture writers: ImageNet-style Example protos (JPEG bytes,
label, bounding box) for input-path tests and smoke runs.

``write_color_square_records`` is the port's copy of the JAX package's
data/tfrecord_image_generator.py (solid coloured squares); it encodes with
the port's own codec (data/jpeg.py) instead of PIL, so it runs where there
is no PIL. ``write_textured_records`` writes photo-sized images (ImageNet's
typical 500x375) with smooth gradients, edges and noise, so that the JPEG
blocks carry non-trivial AC coefficients and a decode costs what a real
photograph's does.
"""

from __future__ import annotations

import os

import numpy as np

from kf_benchmarks_tpu_torch.data import example as example_lib
from kf_benchmarks_tpu_torch.data import jpeg
from kf_benchmarks_tpu_torch.data import tfrecord


def _jpeg_bytes(rgb, size: int = 64) -> bytes:
  arr = np.zeros((size, size, 3), np.uint8)
  arr[:, :] = rgb
  return jpeg.encode(arr, quality=95)


def _example(image_bytes: bytes, label: int, box=(0.1, 0.1, 0.9, 0.9)):
  ymin, xmin, ymax, xmax = box
  return example_lib.encode_example({
      "image/encoded": image_bytes,
      "image/class/label": np.array([label], np.int64),
      "image/object/bbox/xmin": np.array([xmin], np.float32),
      "image/object/bbox/ymin": np.array([ymin], np.float32),
      "image/object/bbox/xmax": np.array([xmax], np.float32),
      "image/object/bbox/ymax": np.array([ymax], np.float32),
  })


def write_color_square_records(
    data_dir: str, num_train_shards: int = 2, num_validation_shards: int = 1,
    examples_per_shard: int = 8, num_classes: int = 10,
    image_size: int = 64) -> None:
  os.makedirs(data_dir, exist_ok=True)
  rng = np.random.RandomState(0)
  for subset, num_shards in (("train", num_train_shards),
                             ("validation", num_validation_shards)):
    for shard in range(num_shards):
      path = os.path.join(
          data_dir, f"{subset}-{shard:05d}-of-{num_shards:05d}")
      with tfrecord.TFRecordWriter(path) as w:
        for _ in range(examples_per_shard):
          label = int(rng.randint(1, num_classes + 1))
          rgb = tuple(int(c) for c in rng.randint(0, 256, size=3))
          w.write(_example(_jpeg_bytes(rgb, image_size), label))


def textured_image(rng: np.random.RandomState, height: int = 375,
                   width: int = 500) -> np.ndarray:
  """A uint8 (height, width, 3) image: smooth triangle waves per channel,
  a checkerboard of hard edges at a random pitch, a disc, and noise. Integer
  arithmetic only, so that a seed gives the same image on every machine."""
  y, x = np.mgrid[0:height, 0:width].astype(np.int64)
  img = np.empty((height, width, 3), np.int64)
  for c in range(3):
    px, py = rng.randint(40, 400, 2)
    ox, oy = rng.randint(0, 400, 2)
    tx = np.abs(((x + ox) % px) * 2 - px) * 255 // px
    ty = np.abs(((y + oy) % py) * 2 - py) * 255 // py
    img[..., c] = (tx + ty) // 2
  cx, cy = rng.randint(16, 80, 2)
  checker = ((x // cx + y // cy) % 2) == 0
  img[checker] += rng.randint(-60, 61, 3)
  dy, dx, r = rng.randint(0, height), rng.randint(0, width), rng.randint(
      20, 120)
  img[(y - dy) ** 2 + (x - dx) ** 2 < r * r] = rng.randint(0, 256, 3)
  amp = rng.randint(10, 31)
  img += rng.randint(-amp, amp + 1, img.shape)
  return np.clip(img, 0, 255).astype(np.uint8)


def write_textured_records(
    data_dir: str, num_train: int = 1024, num_validation: int = 256,
    num_distinct: int = 64, num_train_shards: int = 8,
    num_validation_shards: int = 2, height: int = 375, width: int = 500,
    quality: int = 90, num_classes: int = 1000, seed: int = 0) -> None:
  """``num_train`` / ``num_validation`` records over ``num_distinct``
  textured JPEGs (cycled), labels in [1, num_classes] and one random box
  each, in ``<subset>-%05d-of-%05d`` shards."""
  os.makedirs(data_dir, exist_ok=True)
  rng = np.random.RandomState(seed)
  images = [jpeg.encode(textured_image(rng, height, width), quality=quality)
            for _ in range(num_distinct)]
  k = 0
  for subset, count, num_shards in (
      ("train", num_train, num_train_shards),
      ("validation", num_validation, num_validation_shards)):
    per_shard = -(-count // num_shards)
    for shard in range(num_shards):
      path = tfrecord.shard_path(data_dir, subset, shard, num_shards)
      with tfrecord.TFRecordWriter(path) as w:
        for _ in range(min(per_shard, count - shard * per_shard)):
          label = int(rng.randint(1, num_classes + 1))
          y0, x0 = rng.uniform(0.0, 0.4, 2)
          y1, x1 = rng.uniform(0.6, 1.0, 2)
          w.write(_example(images[k % num_distinct], label,
                           (float(y0), float(x0), float(y1), float(x1))))
          k += 1
