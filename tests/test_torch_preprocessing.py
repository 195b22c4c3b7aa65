"""The port's preprocessing (data/preprocessing.py, data/image_ops.py)
against the JAX package's data/preprocessing.py and PIL.

* The PIL operations on uint8 arrays: resize with NEAREST, BILINEAR,
  BICUBIC and BOX at random sizes up and down, ``convert("L")``, the
  Brightness, Color and Contrast enhancers on both sides of factor 1, and
  crops inside and outside the frame: bitwise PIL's.
* ``train_image`` (every --resize_method, distortions on and off, several
  batch positions and seeds, a 512x384 source at 64 px, where the draft
  decode runs at 1/4 or 1/8, and at 224 px), ``eval_image`` and the official
  variant against the JAX package's on the same JPEG bytes and the same
  ``random.Random`` streams. Normalised, without colour distortion within
  1/127.5 (and 0.1/127.5 on average), with it within 2/127.5; the port's
  codec and operations are bitwise PIL's, so the images are equal here.
* CIFAR-10's ``_distort`` and minibatches, and whole record-input
  minibatches with 1, 4 and 32 threads, against the JAX preprocessors.
* The record streams, record for record: shift_ratio rotation, the train
  shuffle and replay, the one-pass eval stream, use_caching and
  repeat_cached_sample.
* The refusals of preprocessors the port does not run yet.
"""

import io
import pickle
import random
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from PIL import ImageEnhance

from kf_benchmarks_tpu.data import datasets as jax_datasets
from kf_benchmarks_tpu.data import preprocessing as jax_pre
from kf_benchmarks_tpu_torch.data import datasets
from kf_benchmarks_tpu_torch.data import device_feed
from kf_benchmarks_tpu_torch.data import image_ops
from kf_benchmarks_tpu_torch.data import preprocessing as pre
from kf_benchmarks_tpu_torch.data import tfrecord_image_generator

METHODS = ["nearest", "bilinear", "bicubic", "area", "round_robin"]
PIL_FILTERS = [(image_ops.NEAREST, Image.NEAREST),
               (image_ops.BILINEAR, Image.BILINEAR),
               (image_ops.BICUBIC, Image.BICUBIC),
               (image_ops.BOX, Image.BOX)]


def _jpeg(width, height, seed=0, quality=90):
  img = tfrecord_image_generator.textured_image(
      np.random.RandomState(seed), height, width)
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, "JPEG", quality=quality)
  return buf.getvalue()


def _normalize(images, kind):
  """A preprocessor's NORMALIZATION as the feed applies it, in f32."""
  return device_feed.normalize(torch.from_numpy(np.ascontiguousarray(
      images)), kind, torch.float32).numpy()


# -- the PIL operations ------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_resize_matches_pil(seed):
  rng = np.random.default_rng(seed)
  for _ in range(6):
    h, w, oh, ow = (int(v) for v in rng.integers(1, 260, 4))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pil = Image.fromarray(img)
    for ours, theirs in PIL_FILTERS:
      np.testing.assert_array_equal(
          image_ops.resize(img, (ow, oh), ours),
          np.asarray(pil.resize((ow, oh), theirs)),
          err_msg=f"{w}x{h} -> {ow}x{oh}, filter {theirs}")


@pytest.mark.parametrize("seed", range(3))
def test_enhancers_grayscale_and_crop_match_pil(seed):
  rng = np.random.default_rng(seed)
  img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
  pil = Image.fromarray(img)
  np.testing.assert_array_equal(image_ops.grayscale(img),
                                np.asarray(pil.convert("L")))
  for factor in [0.0, 0.37, 0.5, 1.0, 1.1, 1.5, 2.3]:
    for ours, theirs in ((image_ops.brightness, ImageEnhance.Brightness),
                         (image_ops.color, ImageEnhance.Color),
                         (image_ops.contrast, ImageEnhance.Contrast)):
      np.testing.assert_array_equal(
          ours(img, factor), np.asarray(theirs(pil).enhance(factor)),
          err_msg=f"{theirs.__name__} {factor}")
  for box in [(0, 0, 53, 37), (5, 7, 20, 30), (-4, -2, 10, 12),
              (40, 30, 70, 45), (3, 3, 3, 9)]:
    np.testing.assert_array_equal(image_ops.crop(img, box),
                                  np.asarray(pil.crop(box)))
  np.testing.assert_array_equal(
      image_ops.flip_left_right(img),
      np.asarray(pil.transpose(Image.FLIP_LEFT_RIGHT)))


# -- single images against the JAX package ----------------------------------

BBOX = np.array([[0.1, 0.2, 0.8, 0.9]], np.float32)


def _check_images(got_uint8, ref_f32, distortions):
  got = pre.normalized_image(got_uint8)
  ref = jax_pre.normalized_image(ref_f32)
  diff = np.abs(got - ref)
  if distortions:
    assert diff.max() <= 2 / 127.5
  else:
    assert diff.max() <= 1 / 127.5 and diff.mean() <= 0.1 / 127.5
  print(f"max |diff| {diff.max() * 127.5:.3f}/127.5, bitwise share "
        f"{np.mean(diff == 0):.4f}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("distortions", [False, True])
def test_train_image_matches_jax(method, distortions):
  data = _jpeg(512, 384, seed=3)
  for pos in range(4):
    for seed in range(3):
      for size in (64, 224):
        ref = jax_pre.train_image(data, size, size, BBOX, pos, method,
                                  distortions, random.Random(seed * 7 + pos))
        got = pre.train_image(data, size, size, BBOX, pos, method,
                              distortions, random.Random(seed * 7 + pos))
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        _check_images(got, ref, distortions)


@pytest.mark.parametrize("method", METHODS)
def test_eval_image_matches_jax(method):
  for w, h in ((512, 384), (333, 211)):
    data = _jpeg(w, h, seed=4)
    for pos in range(4):
      for size in (64, 224):
        _check_images(pre.eval_image(data, size, size, pos, method),
                      jax_pre.eval_image(data, size, size, pos, method),
                      False)


def test_train_image_without_boxes_and_on_grayscale_matches_jax():
  img = tfrecord_image_generator.textured_image(np.random.RandomState(8),
                                                211, 333)
  buf = io.BytesIO()
  Image.fromarray(img[..., 0]).save(buf, "JPEG")
  for data in (_jpeg(333, 211, seed=8), buf.getvalue()):
    for seed in range(4):
      ref = jax_pre.train_image(data, 64, 64, np.zeros((0, 4), np.float32),
                                seed, "bilinear", True, random.Random(seed))
      got = pre.train_image(data, 64, 64, np.zeros((0, 4), np.float32),
                            seed, "bilinear", True, random.Random(seed))
      _check_images(got, ref, True)


def _record(data, label=7):
  from kf_benchmarks_tpu_torch.data import example  # noqa: PLC0415
  return example.encode_example({
      "image/encoded": [data],
      "image/class/label": np.array([label], np.int64),
      "image/object/bbox/xmin": np.array([0.2], np.float32),
      "image/object/bbox/ymin": np.array([0.1], np.float32),
      "image/object/bbox/xmax": np.array([0.9], np.float32),
      "image/object/bbox/ymax": np.array([0.8], np.float32)})


@pytest.mark.parametrize("train", [True, False])
def test_official_variant_matches_jax(train):
  record = _record(_jpeg(500, 375, seed=9), label=42)
  kw = dict(batch_size=4, output_shape=(64, 64, 3), train=train)
  ours = pre.OfficialImagenetPreprocessor(**kw)
  theirs = jax_pre.OfficialImagenetPreprocessor(**kw)
  for pos in range(4):
    got, label = ours._preprocess_one(record, pos, random.Random(pos))
    ref, ref_label = theirs._preprocess_one(record, pos, random.Random(pos))
    assert label == ref_label == 42
    np.testing.assert_array_equal(_normalize(got, ours.NORMALIZATION),
                                  ref)


def test_parse_example_proto_matches_jax():
  record = _record(b"\xff\xd8bytes", label=5)
  got, ref = pre.parse_example_proto(record), jax_pre.parse_example_proto(
      record)
  assert got[0] == ref[0] and got[1] == ref[1] == 5
  np.testing.assert_array_equal(got[2], ref[2])


def test_sample_distorted_bounding_box_matches_jax():
  for seed in range(50):
    for bbox in (BBOX, np.zeros((0, 4), np.float32)):
      assert pre.sample_distorted_bounding_box(
          random.Random(seed), 375, 500, bbox) == \
          jax_pre.sample_distorted_bounding_box(random.Random(seed), 375,
                                                500, bbox)


# -- whole minibatches -------------------------------------------------------

def _write_records(path, n_train=24, n_val=10):
  tfrecord_image_generator.write_textured_records(
      str(path), num_train=n_train, num_validation=n_val, num_distinct=6,
      num_train_shards=4, num_validation_shards=2, height=120, width=160,
      quality=85)
  return str(path)


@pytest.mark.parametrize("threads", [1, 4, 32])
@pytest.mark.parametrize("train", [True, False])
def test_minibatches_match_jax(tmp_path, threads, train):
  """32 threads, more than the cores, with a short switch interval: the
  pool's writes into the batch arrays lose nothing."""
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-5 if threads > 4 else interval)
  try:
    _minibatches_match_jax(tmp_path, threads, train)
  finally:
    sys.setswitchinterval(interval)


def _minibatches_match_jax(tmp_path, threads, train):
  data_dir = _write_records(tmp_path / "imagenet")
  kw = dict(batch_size=4, output_shape=(48, 48, 3), train=train,
            distortions=True, resize_method="round_robin", seed=11,
            shift_ratio=0.5, num_threads=threads)
  got = pre.RecordInputImagePreprocessor(**kw).minibatches(
      datasets.ImagenetDataset(data_dir), "train" if train else "validation")
  ref = jax_pre.RecordInputImagePreprocessor(**kw).minibatches(
      jax_datasets.ImagenetDataset(data_dir),
      "train" if train else "validation")
  n = 0
  for (gi, gl), (ri, rl) in zip(got, ref):
    assert gi.dtype == np.uint8
    np.testing.assert_array_equal(_normalize(gi, "unit"), ri)
    np.testing.assert_array_equal(gl, rl)
    n += 1
    if n == 8:
      break
  # Train replays forever; the 10 validation records make two batches.
  assert n == (8 if train else 2)


def _cifar_dir(tmp_path):
  rng = np.random.default_rng(0)
  d = tmp_path / "cifar10"
  d.mkdir()
  for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
    with open(d / name, "wb") as f:
      pickle.dump({b"data": rng.integers(0, 256, (6, 3072), dtype=np.uint8),
                   b"labels": list(rng.integers(0, 10, 6))}, f)
  return str(d)


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_matches_jax(tmp_path, train):
  data_dir = _cifar_dir(tmp_path)
  kw = dict(batch_size=4, output_shape=(32, 32, 3), train=train,
            distortions=True, seed=5)
  ours = pre.Cifar10ImagePreprocessor(**kw)
  theirs = jax_pre.Cifar10ImagePreprocessor(**kw)
  img = np.random.default_rng(1).integers(0, 256, (32, 32, 3),
                                          dtype=np.uint8)
  for seed in range(10):
    np.testing.assert_array_equal(ours._distort(img, random.Random(seed)),
                                  theirs._distort(img, random.Random(seed)))
  got = ours.minibatches(datasets.Cifar10Dataset(data_dir),
                         "train" if train else "validation")
  ref = theirs.minibatches(jax_datasets.Cifar10Dataset(data_dir),
                           "train" if train else "validation")
  for _ in range(5):
    (gi, gl), (ri, rl) = next(got), next(ref)
    np.testing.assert_array_equal(_normalize(gi, "unit"), ri)
    np.testing.assert_array_equal(gl, rl)


def test_test_preprocessor_passes_batches_through():
  images = np.random.default_rng(0).normal(size=(5, 8, 8, 3))
  labels = np.arange(5)
  for lib in (pre, jax_pre):
    p = lib.TestImagePreprocessor(batch_size=3, output_shape=(8, 8, 3))
    p.set_fake_data(images, labels)
    it = p.minibatches(None, "train")
    if lib is pre:
      got = [next(it) for _ in range(3)]
      assert pre.TestImagePreprocessor.NORMALIZATION is None
    else:
      ref = [next(it) for _ in range(3)]
  for (gi, gl), (ri, rl) in zip(got, ref):
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gl, rl)


# -- record streams ----------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(train=True, shift_ratio=0.0),
    dict(train=True, shift_ratio=0.5),
    dict(train=True, shift_ratio=0.75, use_caching=True),
    dict(train=False, shift_ratio=0.25),
    dict(train=False, use_caching=True),
    dict(train=True, repeat_cached_sample=True),
    dict(train=False, repeat_cached_sample=True, shift_ratio=0.5)],
    ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_record_streams_match_jax(tmp_path, case):
  data_dir = _write_records(tmp_path / "imagenet", n_train=12, n_val=8)
  kw = dict(batch_size=2, output_shape=(8, 8, 3), seed=3, **case)
  subset = "train" if case["train"] else "validation"
  got = pre.InputPreprocessor(**kw)._record_stream(
      datasets.ImagenetDataset(data_dir), subset)
  ref = jax_pre.InputPreprocessor(**kw)._record_stream(
      jax_datasets.ImagenetDataset(data_dir), subset)
  limit = 40
  got_list = [r for _, r in zip(range(limit), got)]
  ref_list = [r for _, r in zip(range(limit), ref)]
  assert got_list == ref_list
  endless = case["train"] or case.get("repeat_cached_sample")
  assert len(got_list) == (limit if endless else 8)


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("name,kind,message", [
    pytest.param("librispeech", "default", None,
                 id="librispeech-default-7"),
    pytest.param("librispeech", "official_models_imagenet",
                 "official_models_imagenet preprocessing applies to the "
                 "imagenet dataset, not 'librispeech'",
                 id="librispeech-official_models_imagenet-7b"),
    pytest.param("librispeech", "multiprocess",
                 "multiprocess preprocessing applies to the imagenet "
                 "dataset, not 'librispeech'",
                 id="librispeech-multiprocess-7b")])
def test_unported_preprocessors_are_refused(name, kind, message):
  """The LibriSpeech preprocessor runs; the image-only kinds refuse it with
  the JAX package's messages."""
  if message is None:
    assert pre.get_preprocessor(name, kind) is pre.LibrispeechPreprocessor
    assert jax_pre.get_preprocessor(name, kind).__name__ == \
        "LibrispeechPreprocessor"
    return
  for module in (pre, jax_pre):
    with pytest.raises(ValueError, match=message):
      module.get_preprocessor(name, kind)


def test_preprocessor_map_matches_jax_where_ported():
  assert pre.get_preprocessor("imagenet") is pre.RecordInputImagePreprocessor
  assert pre.get_preprocessor("cifar10") is pre.Cifar10ImagePreprocessor
  assert pre.get_preprocessor("coco") is pre.COCOPreprocessor
  with pytest.raises(ValueError, match="applies to the imagenet dataset"):
    pre.get_preprocessor("coco", "multiprocess")
  assert pre.get_preprocessor("imagenet", "official_models_imagenet") is \
      pre.OfficialImagenetPreprocessor
  assert pre.get_preprocessor("cifar10", "test") is pre.TestImagePreprocessor
  for args in (("cifar10", "official_models_imagenet"),
               ("imagenet", "nonsense")):
    with pytest.raises(ValueError) as ref:
      jax_pre.get_preprocessor(*args)
    with pytest.raises(ValueError) as got:
      pre.get_preprocessor(*args)
    assert str(got.value) == str(ref.value)
