"""Generated COCO records and their annotation file: the port's twin of
kf_benchmarks_tpu/data/coco_record_generator.py.

Writes object-detection TF Examples (``image/encoded``, the
``image/object/bbox/*`` boxes, ``image/object/class/label`` with raw
90-class COCO ids, ``image/source_id``: the fields COCOPreprocessor
parses) in ``train-00000-of-00001`` and ``validation-00000-of-00001``, and
a COCO ``instances`` json of the validation images at
``ssd_constants.ANNOTATION_FILE``, so the mAP evaluator scores real ground
truth. Images are solid-colour squares with one bright rectangle a box,
from one ``np.random.RandomState`` in the JAX generator's order of draws:
the records are the JAX generator's field for field, and the images its
pixel for pixel (the port encodes with its own codec, data/jpeg.py, where
the JAX package uses PIL; the two decode to the same pixels).

Run: ``python -m kf_benchmarks_tpu_torch.data.coco_record_generator DIR
[--num_train N] [--num_validation N]``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np

from kf_benchmarks_tpu_torch.data import example as example_lib
from kf_benchmarks_tpu_torch.data import jpeg
from kf_benchmarks_tpu_torch.data import tfrecord
from kf_benchmarks_tpu_torch.models import ssd_constants


def image_with_boxes(rng: np.random.RandomState, size: int,
                     boxes: np.ndarray) -> np.ndarray:
  """The (size, size, 3) uint8 picture: a dark solid colour, a bright
  solid rectangle on each box."""
  arr = np.full((size, size, 3), rng.randint(0, 64, size=3), np.uint8)
  for ymin, xmin, ymax, xmax in boxes:
    y0, x0 = int(ymin * size), int(xmin * size)
    y1, x1 = max(int(ymax * size), y0 + 1), max(int(xmax * size), x0 + 1)
    arr[y0:y1, x0:x1] = rng.randint(192, 256, size=3)
  return arr


def random_boxes(rng: np.random.RandomState, n: int) -> np.ndarray:
  """[n, 4] normalised (ymin, xmin, ymax, xmax), well inside the image."""
  y0 = rng.uniform(0.05, 0.5, size=n)
  x0 = rng.uniform(0.05, 0.5, size=n)
  h = rng.uniform(0.2, 0.45, size=n)
  w = rng.uniform(0.2, 0.45, size=n)
  return np.stack([y0, x0, np.minimum(y0 + h, 0.95),
                   np.minimum(x0 + w, 0.95)], axis=1).astype(np.float32)


def write_fake_coco(data_dir: str, num_train: int = 16,
                    num_validation: int = 8, image_size: int = 300,
                    max_boxes: int = 3, seed: int = 0) -> str:
  """Writes the train and validation shards and the annotation json;
  returns the json's path."""
  os.makedirs(data_dir, exist_ok=True)
  rng = np.random.RandomState(seed)
  images_json: List[dict] = []
  annotations_json: List[dict] = []
  ann_id = 1
  next_source_id = 1
  for subset, count in (("train", num_train),
                        ("validation", num_validation)):
    path = os.path.join(data_dir, f"{subset}-00000-of-00001")
    with tfrecord.TFRecordWriter(path) as w:
      for _ in range(count):
        source_id = next_source_id
        next_source_id += 1
        n = int(rng.randint(1, max_boxes + 1))
        boxes = random_boxes(rng, n)
        raw_classes = np.asarray(
            [ssd_constants.CLASS_INV_MAP[int(rng.randint(1, 81))]
             for _ in range(n)], np.int64)
        picture = image_with_boxes(rng, image_size, boxes)
        w.write(example_lib.encode_example({
            "image/encoded": jpeg.encode(picture, quality=95),
            "image/source_id": str(source_id).encode(),
            "image/object/bbox/ymin": boxes[:, 0],
            "image/object/bbox/xmin": boxes[:, 1],
            "image/object/bbox/ymax": boxes[:, 2],
            "image/object/bbox/xmax": boxes[:, 3],
            "image/object/class/label": raw_classes,
        }))
        if subset == "validation":
          images_json.append({"id": source_id, "height": image_size,
                              "width": image_size})
          for b, cls in zip(boxes, raw_classes):
            x, y = float(b[1]) * image_size, float(b[0]) * image_size
            bw = float(b[3] - b[1]) * image_size
            bh = float(b[2] - b[0]) * image_size
            annotations_json.append({
                "id": ann_id, "image_id": source_id,
                "category_id": int(cls), "bbox": [x, y, bw, bh],
                "area": bw * bh, "iscrowd": 0,
            })
            ann_id += 1
  ann_path = os.path.join(data_dir, ssd_constants.ANNOTATION_FILE)
  os.makedirs(os.path.dirname(ann_path), exist_ok=True)
  with open(ann_path, "w") as f:
    json.dump({
        "images": images_json,
        "annotations": annotations_json,
        "categories": [{"id": int(c)} for c in
                       ssd_constants.CLASS_INV_MAP[1:]],
    }, f)
  return ann_path


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("data_dir")
  ap.add_argument("--num_train", type=int, default=16)
  ap.add_argument("--num_validation", type=int, default=8)
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args(argv)
  print(write_fake_coco(args.data_dir, args.num_train, args.num_validation,
                        seed=args.seed))
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
