"""The COCO path of the port against the JAX package's, on the CPU:

* the record generator (data/coco_record_generator.py): from one seed the
  annotation json is the JAX generator's and every record's fields are its
  own, the JPEG bytes aside (the port encodes with its own codec): their
  pixels are equal (PIL's decode of the JAX file, the port's of its own);
* the COCO preprocessor: train batches (with and without the colour
  jitter) and eval batches from the JAX generator's records, bitwise: the
  images after the normalisation (the port's on the tensor, as the device
  feed applies it), the encoded boxes, classes and matched counts, the
  eval padding, source ids and raw shapes;
* PIL's HSV conversion both ways over the whole RGB cube (the jitter's hue
  shift);
* the numpy mAP: 1 on perfect detections, 0 on wrong ones, and the JAX
  package's value on the same random predictions, through
  ``maybe_compute_map`` end to end;
* ``--backbone_model_path``: SSD300 warm-starts from a checkpoint of the
  port (the variables whose names and shapes match), raises when nothing
  matches, and is skipped on resume.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from kf_benchmarks_tpu import coco_metric as jax_coco
from kf_benchmarks_tpu.data import coco_record_generator as jax_gen
from kf_benchmarks_tpu.data import example as jax_example
from kf_benchmarks_tpu.data import preprocessing as jax_pre
from kf_benchmarks_tpu.data import tfrecord as jax_tfrecord
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import coco_metric
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch.data import coco_record_generator as port_gen
from kf_benchmarks_tpu_torch.data import datasets
from kf_benchmarks_tpu_torch.data import device_feed
from kf_benchmarks_tpu_torch.data import example as port_example
from kf_benchmarks_tpu_torch.data import image_ops
from kf_benchmarks_tpu_torch.data import jpeg
from kf_benchmarks_tpu_torch.data import preprocessing as port_pre
from kf_benchmarks_tpu_torch.data import tfrecord as port_tfrecord

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
  root = tmp_path_factory.mktemp("coco")
  jax_dir, port_dir = str(root / "jax"), str(root / "port")
  jax_gen.write_fake_coco(jax_dir, num_train=12, num_validation=5, seed=3)
  port_gen.write_fake_coco(port_dir, num_train=12, num_validation=5, seed=3)
  return jax_dir, port_dir


def test_generator_is_the_jax_packages(records):
  jax_dir, port_dir = records
  ann = "annotations/instances_val2017.json"
  with open(os.path.join(jax_dir, ann)) as f, \
      open(os.path.join(port_dir, ann)) as g:
    assert json.load(f) == json.load(g)
  for subset in ("train", "validation"):
    name = f"{subset}-00000-of-00001"
    a = list(jax_tfrecord.read_records(os.path.join(jax_dir, name)))
    b = list(port_tfrecord.read_records(os.path.join(port_dir, name)))
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
      fa, fb = jax_example.parse_example(ra), port_example.parse_example(rb)
      assert sorted(fa) == sorted(fb)
      for key in fa:
        if key == "image/encoded":
          continue
        np.testing.assert_array_equal(np.asarray(fa[key]),
                                      np.asarray(fb[key]))
      pil = np.asarray(Image.open(io.BytesIO(
          fa["image/encoded"][0])).convert("RGB"))
      np.testing.assert_array_equal(jpeg.decode(fb["image/encoded"][0]), pil)


def _pair(kind, train, distortions, batch=4):
  kw = dict(batch_size=batch, output_shape=(300, 300, 3), train=train,
            distortions=distortions, resize_method="bilinear", seed=11,
            num_threads=2)
  return jax_pre.COCOPreprocessor(**kw), port_pre.COCOPreprocessor(**kw)


def _normalized(images):
  return device_feed.normalize(torch.from_numpy(images), "coco",
                               torch.float32).numpy()


@pytest.mark.parametrize("distortions", [False, True])
def test_train_batches_are_bitwise_the_jax_packages(records, distortions):
  jax_dir, _ = records
  jpre, ppre = _pair("train", True, distortions)
  jds = datasets.create_dataset(jax_dir, "coco")
  ja, pa = jpre.minibatches(jds, "train"), ppre.minibatches(jds, "train")
  for _ in range(3):
    (jimg, jlab), (pimg, plab) = next(ja), next(pa)
    assert pimg.dtype == np.uint8
    np.testing.assert_array_equal(_normalized(pimg), jimg)
    for x, y in zip(plab, jlab):
      assert x.dtype == y.dtype
      np.testing.assert_array_equal(x, y)
  ja.close()
  pa.close()


def test_eval_batches_are_bitwise_the_jax_packages(records):
  jax_dir, _ = records
  jpre, ppre = _pair("eval", False, False, batch=2)
  jds = datasets.create_dataset(jax_dir, "coco")
  jb = list(jpre.minibatches(jds, "validation"))
  pb = list(ppre.minibatches(jds, "validation"))
  assert [len(b[0]) for b in pb] == [2, 2, 1]  # the last batch partial
  for (jimg, jlab), (pimg, plab) in zip(jb, pb):
    np.testing.assert_array_equal(_normalized(pimg), jimg)
    for x, y in zip(plab, jlab):
      np.testing.assert_array_equal(x, y)
    assert plab[0].shape[1:] == (200, 4) and plab[1].shape[1:] == (200, 1)


def test_hsv_conversions_are_pils():
  c = np.arange(256, dtype=np.uint8)
  cube = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(
      4096, 4096, 3)
  np.testing.assert_array_equal(image_ops.rgb_to_hsv(cube), np.asarray(
      Image.fromarray(cube).convert("HSV")))
  np.testing.assert_array_equal(image_ops.hsv_to_rgb(cube), np.asarray(
      Image.fromarray(cube, "HSV").convert("RGB")))


def _gt(path):
  with open(os.path.join(path, "annotations/instances_val2017.json")) as f:
    return json.load(f)


def test_numpy_map_perfect_wrong_and_the_jax_packages(records):
  jax_dir, _ = records
  gt = _gt(jax_dir)
  perfect = [[a["image_id"], *a["bbox"], 1.0, a["category_id"]]
             for a in gt["annotations"]]
  assert coco_metric.compute_map_numpy(gt, perfect)["COCO/AP"] == 1.0
  wrong_class = [r[:6] + [1 if r[6] != 1 else 2] for r in perfect]
  far = [[r[0], r[1] + 150.0, r[2] + 150.0, r[3] * 0.1, r[4] * 0.1, r[5],
          r[6]] for r in perfect]
  for rows in (wrong_class, far):
    assert coco_metric.compute_map_numpy(gt, rows) == {"COCO/AP": 0.0,
                                                       "COCO/AP50": 0.0}
  rng = np.random.default_rng(4)
  noisy = [[r[0], *(np.asarray(r[1:5]) + rng.normal(0, 8, 4)).tolist(),
            float(rng.uniform()), r[6]] for r in perfect for _ in range(3)]
  noisy += [[a["image_id"], *rng.uniform(0, 200, 4).tolist(),
             float(rng.uniform()), int(rng.choice([1, 2, 3]))]
            for a in gt["annotations"]]
  got = coco_metric.compute_map_numpy(gt, noisy)
  assert got == jax_coco.compute_map_numpy(gt, noisy)
  assert 0.0 < got["COCO/AP"] < 1.0
  # End to end from per-image predictions: NMS, the top-200 cut, the pixel
  # rows, the numpy evaluator.
  preds = []
  for img in gt["images"]:
    boxes = rng.uniform(0, 1, (8732, 4)).astype(np.float32)
    boxes = np.sort(boxes.reshape(8732, 2, 2), 1).reshape(8732, 4)
    scores = rng.dirichlet(np.ones(81) * 0.05, 8732).astype(np.float32)
    preds.append({"source_id": img["id"], "pred_boxes": boxes[:, [0, 2, 1, 3]],
                  "pred_scores": scores, "raw_shape": np.array([300, 300, 3])})

  class P:
    data_dir = jax_dir

  a = coco_metric.maybe_compute_map({"predictions": preds}, P())
  b = jax_coco.maybe_compute_map({"predictions": preds}, P())
  assert a["coco_evaluator"] == b["coco_evaluator"] == "numpy"
  assert a["COCO/AP"] == b["COCO/AP"] and a["COCO/AP50"] == b["COCO/AP50"]

  class Q:
    data_dir = None

  assert "coco_map_note" in coco_metric.maybe_compute_map({}, Q())


def _ssd_params(**kw):
  return port_params.make_params(model="ssd300", data_name="coco",
                                 device="cpu", batch_size=1, num_batches=1,
                                 num_warmup_batches=0, **kw)


def test_backbone_warm_start(tmp_path):
  # A checkpoint of another SSD300 init, one entry's shape changed.
  src = benchmark.BenchmarkCNN(_ssd_params(tf_random_seed=7))
  module, step, _, _ = src.build()
  snap = checkpoint.savable_state(module, step.optimizer, 0)
  odd = "conv0.weight"
  snap["model"][odd] = torch.zeros(3, 3)
  path = str(tmp_path / "backbone.pt")
  torch.save(snap, path)
  bench = benchmark.BenchmarkCNN(_ssd_params(backbone_model_path=path))
  warm, _, _, _ = bench.build()
  state = warm.state_dict()
  loaded = 0
  for key, t in module.state_dict().items():
    if key == odd:
      assert not torch.equal(state[key], t)  # shape mismatch: kept
    else:
      torch.testing.assert_close(state[key], t, rtol=0, atol=0)
      loaded += 1
  assert loaded == len(state) - 1
  # A checkpoint whose names match nothing raises.
  torch.save({"model": {"nothing.weight": torch.zeros(1)}},
             str(tmp_path / "none.pt"))
  with pytest.raises(ValueError, match="matched no variables"):
    benchmark.BenchmarkCNN(_ssd_params(
        backbone_model_path=str(tmp_path / "none.pt"))).build()
  # On resume the train dir's checkpoint wins: the warm start is skipped.
  train_dir = str(tmp_path / "run")
  first = benchmark.BenchmarkCNN(_ssd_params(train_dir=train_dir))
  first.run()
  resumed = benchmark.BenchmarkCNN(_ssd_params(
      train_dir=train_dir, backbone_model_path=str(tmp_path / "none.pt")))
  again, _, _, _ = resumed.build()
  torch.testing.assert_close(again.state_dict()["conv0.weight"],
                             first.final["module"].state_dict()[
                                 "conv0.weight"], rtol=0, atol=0)
