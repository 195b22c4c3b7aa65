"""JPEG directory -> TFRecord shard converter: the port's copy of the JAX
package's data/get_tf_record.py.

The analog of the reference's data-fetch utilities
(ref: scripts/tf_cnn_benchmarks/get_tf_record.py -- JPEG dir to
TFRecord). It consumes an already-downloaded ImageNet-layout directory and
copies each file's bytes into its record, so it needs no codec.

Expected layout (the standard ImageNet raw layout):

    <root>/train/<wnid>/*.JPEG
    <root>/validation/<wnid>/*.JPEG

Labels are 1-based indices of the sorted wnid directory names (the
ImageNet convention the reference's parser expects: label 0 = background,
ref: preprocessing.py:27-81). Output shards are named
``<subset>-%05d-of-%05d`` so datasets.create_dataset / tfrecord
.list_shards find them.

Usage:
    python -m kf_benchmarks_tpu_torch.data.get_tf_record \
        --input_dir /data/imagenet-raw --output_dir /data/imagenet-tf \
        --train_shards 128 --validation_shards 16
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

from kf_benchmarks_tpu_torch.data import example as example_lib
from kf_benchmarks_tpu_torch.data import tfrecord

_IMAGE_EXTS = (".jpeg", ".jpg", ".JPEG", ".JPG")


def _list_images(subset_dir: str) -> Tuple[List[Tuple[str, int]],
                                           List[str]]:
  """[(path, 1-based label)] plus the sorted wnid list."""
  wnids = sorted(d for d in os.listdir(subset_dir)
                 if os.path.isdir(os.path.join(subset_dir, d)))
  files = []
  for label, wnid in enumerate(wnids, start=1):
    d = os.path.join(subset_dir, wnid)
    for name in sorted(os.listdir(d)):
      if name.endswith(_IMAGE_EXTS):
        files.append((os.path.join(d, name), label))
  return files, wnids


def convert_subset(input_dir: str, output_dir: str, subset: str,
                   num_shards: int, shuffle_seed: int = 0) -> int:
  """Convert one subset; returns the number of examples written."""
  subset_dir = os.path.join(input_dir, subset)
  if not os.path.isdir(subset_dir):
    raise ValueError(f"No {subset}/ directory under {input_dir}")
  files, _ = _list_images(subset_dir)
  if not files:
    raise ValueError(f"No JPEG files under {subset_dir}")
  order = np.random.RandomState(shuffle_seed).permutation(len(files))
  os.makedirs(output_dir, exist_ok=True)
  per_shard = -(-len(files) // num_shards)  # ceil
  written = 0
  for shard in range(num_shards):
    path = tfrecord.shard_path(output_dir, subset, shard, num_shards)
    with tfrecord.TFRecordWriter(path) as w:
      for idx in order[shard * per_shard:(shard + 1) * per_shard]:
        fpath, label = files[idx]
        with open(fpath, "rb") as f:
          image_bytes = f.read()
        w.write(example_lib.encode_example({
            "image/encoded": image_bytes,
            "image/class/label": np.asarray([label], np.int64),
            "image/filename": os.path.basename(fpath).encode(),
        }))
        written += 1
  return written


def main(argv=None):
  parser = argparse.ArgumentParser(
      description="Convert an ImageNet-layout JPEG directory to "
                  "TFRecord shards")
  parser.add_argument("--input_dir", required=True)
  parser.add_argument("--output_dir", required=True)
  parser.add_argument("--train_shards", type=int, default=128)
  parser.add_argument("--validation_shards", type=int, default=16)
  args = parser.parse_args(argv)
  for subset, shards in (("train", args.train_shards),
                         ("validation", args.validation_shards)):
    n = convert_subset(args.input_dir, args.output_dir, subset, shards)
    print(f"{subset}: wrote {n} examples in {shards} shards")


if __name__ == "__main__":
  main()
