"""The port's record codec and dataset registry against the JAX package's
(kf_benchmarks_tpu_torch/data/tfrecord.py, example.py, datasets.py,
get_tf_record.py, tfrecord_image_generator.py).

* TFRecord: the port's writer gives the JAX writer's bytes, each side reads
  the other's files, and CRC32C has its known vector.
* tf.Example and SequenceExample: byte-identical encodings, each side parses
  the other's.
* The registry: the same classes, sniffing, "synthetic" alias and epoch
  sizes; the port's module-level epoch count keeps ImageNet's numbers.
* get_tf_record: the same shards from one JPEG directory.
* The colour-square generator's records parse with the JAX parser, and PIL
  decodes their JPEGs.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from kf_benchmarks_tpu.data import datasets as jax_datasets
from kf_benchmarks_tpu.data import example as jax_example
from kf_benchmarks_tpu.data import get_tf_record as jax_get_tf_record
from kf_benchmarks_tpu.data import tfrecord as jax_tfrecord
from kf_benchmarks_tpu_torch.data import datasets
from kf_benchmarks_tpu_torch.data import example
from kf_benchmarks_tpu_torch.data import get_tf_record
from kf_benchmarks_tpu_torch.data import tfrecord
from kf_benchmarks_tpu_torch.data import tfrecord_image_generator


def _records(n=5, seed=0):
  rng = np.random.default_rng(seed)
  return [rng.integers(0, 256, int(rng.integers(0, 3000)),
                       dtype=np.uint8).tobytes() for _ in range(n)]


def test_crc32c_known_vector_and_the_jax_mask():
  assert tfrecord.crc32c(b"123456789") == 0xE3069283
  for data in [b"", b"a", bytes(range(256)) * 3] + _records(3):
    assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)
    assert tfrecord.masked_crc32c(data) == jax_tfrecord.masked_crc32c(data)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfrecord_files_match_and_read_back_both_ways(tmp_path, writer):
  records = _records(6)
  paths = {}
  for name, lib in (("port", tfrecord), ("jax", jax_tfrecord)):
    paths[name] = str(tmp_path / f"{name}.tfrecord")
    with lib.TFRecordWriter(paths[name]) as w:
      for r in records:
        w.write(r)
  with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
    assert a.read() == b.read()
  for reader in (tfrecord, jax_tfrecord):
    assert list(reader.read_records(paths[writer], verify=True)) == records


def test_tfrecord_verify_catches_a_flipped_byte(tmp_path):
  path = str(tmp_path / "r")
  with tfrecord.TFRecordWriter(path) as w:
    w.write(b"payload bytes")
  data = bytearray(open(path, "rb").read())
  data[14] ^= 1
  open(path, "wb").write(bytes(data))
  with pytest.raises(IOError, match="Corrupt TFRecord payload CRC"):
    list(tfrecord.read_records(path, verify=True))


def test_shard_naming_and_listing(tmp_path):
  for i in range(3):
    open(tfrecord.shard_path(str(tmp_path), "train", i, 3), "wb").close()
  open(tfrecord.shard_path(str(tmp_path), "validation", 0, 1), "wb").close()
  assert tfrecord.shard_path("d", "train", 2, 16) == \
      jax_tfrecord.shard_path("d", "train", 2, 16)
  for subset in ("train", "validation"):
    assert tfrecord.list_shards(str(tmp_path), subset) == \
        jax_tfrecord.list_shards(str(tmp_path), subset)
  (tmp_path / "nothing").mkdir()
  with pytest.raises(ValueError, match="No TFRecord shards"):
    tfrecord.list_shards(str(tmp_path / "nothing"), "train")


FEATURES = {
    "image/encoded": [b"\xff\xd8jpeg bytes", b""],
    "image/class/label": np.array([7, -3, 2**40], np.int64),
    "image/object/bbox/xmin": np.array([0.25, 0.5], np.float32),
    "image/filename": [b"n01440764_10026.JPEG"],
    "empty/floats": np.zeros((0,), np.float32),
}


def _same_features(a, b):
  assert sorted(a) == sorted(b)
  for k in a:
    if isinstance(a[k], np.ndarray):
      np.testing.assert_array_equal(a[k], b[k])
      assert a[k].dtype == np.asarray(b[k]).dtype
    else:
      assert list(a[k]) == list(b[k])


def test_example_encodings_are_identical_and_parse_both_ways():
  port = example.encode_example(FEATURES)
  assert port == jax_example.encode_example(FEATURES)
  _same_features(example.parse_example(port),
                 jax_example.parse_example(port))
  _same_features(example.parse_example(port), {
      k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
      for k, v in FEATURES.items()})


def test_sequence_example_round_trips_both_ways():
  context = {"labels": np.array([3, 1, 4], np.int64),
             "input_length": np.array([2], np.int64)}
  seqs = {"features": [np.array([0.5, 1.5], np.float32),
                       np.array([2.5, -1.0], np.float32)]}
  port = example.encode_sequence_example(context, seqs)
  assert port == jax_example.encode_sequence_example(context, seqs)
  for parse in (example.parse_sequence_example,
                jax_example.parse_sequence_example):
    ctx, sq = parse(port)
    np.testing.assert_array_equal(ctx["labels"], context["labels"])
    assert len(sq["features"]) == 2
    np.testing.assert_array_equal(np.asarray(sq["features"][1]),
                                  seqs["features"][1])


@pytest.mark.parametrize("data_dir,data_name", [
    (None, None), (None, "synthetic"), ("/data/imagenet-tf", None),
    ("/x/CIFAR10_batches", None), ("/x/coco2017", None),
    ("/x/librispeech", None), ("/x/records", "imagenet"),
    ("/x/records", None), ("/x/records", "mnist")])
def test_create_dataset_matches_jax(data_dir, data_name):
  try:
    ref = jax_datasets.create_dataset(data_dir, data_name)
  except ValueError as e:
    with pytest.raises(ValueError) as got:
      datasets.create_dataset(data_dir, data_name)
    assert str(got.value) == str(e)
    return
  got = datasets.create_dataset(data_dir, data_name)
  assert (got.name, got.data_dir, got.num_classes) == (
      ref.name, ref.data_dir, ref.num_classes)
  assert got.use_synthetic_gpu_inputs() == ref.use_synthetic_gpu_inputs()
  for subset in ("train", "validation"):
    assert got.num_examples_per_epoch(subset) == \
        ref.num_examples_per_epoch(subset)


def test_module_epoch_counts_are_imagenets():
  assert datasets.num_examples_per_epoch("train") == 1281167
  assert datasets.num_examples_per_epoch("validation") == 50000
  with pytest.raises(ValueError, match="Invalid data subset"):
    datasets.num_examples_per_epoch("test")


def test_get_tf_record_writes_the_jax_converters_shards(tmp_path):
  rng = np.random.default_rng(3)
  for subset in ("train", "validation"):
    for wnid in ("n01", "n02"):
      d = tmp_path / "raw" / subset / wnid
      d.mkdir(parents=True)
      for i in range(3):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
                        ).save(buf, "JPEG")
        (d / f"img{i}.JPEG").write_bytes(buf.getvalue())
  for lib, out in ((get_tf_record, "port"), (jax_get_tf_record, "jax")):
    lib.main(["--input_dir", str(tmp_path / "raw"), "--output_dir",
              str(tmp_path / out), "--train_shards", "2",
              "--validation_shards", "1"])
  names = sorted(os.listdir(tmp_path / "jax"))
  assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
  for name in names:
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()


def test_color_square_records_parse_with_the_jax_codec(tmp_path):
  tfrecord_image_generator.write_color_square_records(
      str(tmp_path), num_train_shards=2, num_validation_shards=1,
      examples_per_shard=3, image_size=16)
  shards = jax_tfrecord.list_shards(str(tmp_path), "train")
  assert len(shards) == 2
  for record in jax_tfrecord.read_records(shards[0], verify=True):
    feats = jax_example.parse_example(record)
    img = np.asarray(Image.open(io.BytesIO(feats["image/encoded"][0])))
    assert img.shape == (16, 16, 3)
    # A solid square: JPEG keeps it flat.
    assert np.ptp(img.reshape(-1, 3), axis=0).max() <= 2
    assert 1 <= int(feats["image/class/label"][0]) <= 10
