"""The LibriSpeech path in the port (data/librispeech_record_generator.py,
data/preprocessing.py ``LibrispeechPreprocessor``, the speech label slot
of benchmark.py) against the JAX package's, on the CPU: the twins of
tests/test_librispeech_pipeline.py.

* The generator writes the JAX generator's files byte for byte at the same
  seed.
* The preprocessor's batches are the JAX preprocessor's, array for array:
  padded to the static (frames, bins, 1) and label slots, over-long
  utterances truncated with their lengths clamped, training and eval.
* One BenchmarkCNN step of the small DeepSpeech2 (hidden 32, one RNN
  layer, 64 frames, 16 labels) on generated records, at rate 0 so the
  weights stay the step's own: its loss is the JAX package's loss of the
  same weights on the JAX preprocessor's first batch, within 1e-6 (the
  utterances of 30-50 frames keep 7-12 CTC frames for 5-12 labels, so the
  batch holds impossible rows and the loss is optax's ~1e5 path).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.data import datasets as jax_datasets
from kf_benchmarks_tpu.data import librispeech_record_generator as jax_gen
from kf_benchmarks_tpu.data import preprocessing as jax_pre
from kf_benchmarks_tpu.models import deepspeech as jax_ds
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch.data import datasets
from kf_benchmarks_tpu_torch.data import librispeech_record_generator as gen
from kf_benchmarks_tpu_torch.data import preprocessing
from kf_benchmarks_tpu_torch.models import deepspeech
from kf_benchmarks_tpu_torch.models import model_config

torch.set_num_threads(2)

GEN = dict(num_train=6, num_validation=4, min_frames=30, max_frames=50,
           max_label_len=12)


@pytest.fixture(scope="module")
def libri_dir(tmp_path_factory):
  d = str(tmp_path_factory.mktemp("librispeech"))
  gen.write_fake_librispeech(d, **GEN)
  return d


@pytest.mark.parametrize("seed,kw", [(0, GEN), (7, {})])
def test_generator_writes_the_jax_generators_bytes(tmp_path, seed, kw):
  ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
  gen.write_fake_librispeech(ours, seed=seed, **kw)
  jax_gen.write_fake_librispeech(theirs, seed=seed, **kw)
  names = sorted(os.listdir(theirs))
  assert names == sorted(os.listdir(ours)) == [
      "train-00000-of-00001", "validation-00000-of-00001"]
  for name in names:
    with open(os.path.join(ours, name), "rb") as a, \
        open(os.path.join(theirs, name), "rb") as b:
      assert a.read() == b.read(), name


def _batches(module, dataset, subset, shape, max_labels, limit):
  pre = module.LibrispeechPreprocessor(
      batch_size=2, output_shape=shape, train=subset == "train",
      distortions=False, resize_method="bilinear", seed=3, shift_ratio=0.0,
      num_threads=2, max_label_length=max_labels)
  it = pre.minibatches(dataset, subset)
  return [b for _, b in zip(range(limit), it)]


@pytest.mark.parametrize("subset,shape,max_labels", [
    ("train", (64, 161, 1), 16),    # padded
    ("train", (20, 161, 1), 4),     # every utterance truncated
    ("validation", (64, 161, 1), 16)])
def test_preprocessor_batches_are_the_jax_preprocessors(
    libri_dir, subset, shape, max_labels):
  got = _batches(preprocessing, datasets.LibrispeechDataset(libri_dir),
                 subset, shape, max_labels, 4)
  ref = _batches(jax_pre, jax_datasets.LibrispeechDataset(libri_dir),
                 subset, shape, max_labels, 4)
  # Training repeats endlessly; eval makes one pass of whole batches.
  assert len(got) == len(ref) == (4 if subset == "train" else 2)
  for (spec, labels), (rspec, rlabels) in zip(got, ref):
    assert spec.shape == (2,) + shape and spec.dtype == np.float32
    np.testing.assert_array_equal(spec, rspec)
    for a, b in zip(labels, rlabels):
      assert a.dtype == b.dtype == np.int32
      np.testing.assert_array_equal(a, b)
    labels_, input_lengths, label_lengths = labels
    assert labels_.shape == (2, max_labels)
    assert np.all(input_lengths > 0) and np.all(input_lengths <= shape[0])
    assert np.all(label_lengths > 0) and np.all(label_lengths <= max_labels)
    if shape[0] == 20:
      assert np.all(input_lengths == 20)
    for b in range(2):
      assert np.all(spec[b, input_lengths[b]:] == 0.0)
      assert np.all(labels_[b, label_lengths[b]:] == 0)
  assert preprocessing.LibrispeechPreprocessor.NORMALIZATION is None


def _small(model):
  model.max_time_steps = 64
  model.max_label_length = 16
  model.rnn_hidden_size = 32
  model.num_rnn_layers = 1
  return model


def test_benchmark_step_on_records_matches_jax_loss(libri_dir, monkeypatch):
  monkeypatch.setitem(
      model_config._SPEECH_MODELS, "deepspeech2",
      lambda params=None: _small(deepspeech.DeepSpeech2Model(params=params)))
  p = params_lib.make_params(
      model="deepspeech2", data_dir=libri_dir, data_name="librispeech",
      batch_size=2, num_batches=1, num_warmup_batches=0, device="cpu",
      init_learning_rate=0.0, weight_decay=0.0, display_every=1)
  bench = benchmark.BenchmarkCNN(p)
  assert bench.model.max_label_length == 16
  stats = bench.run()
  assert len(stats["losses"]) == 1
  loss = stats["losses"][0]
  assert loss > 1e4  # optax's path for the impossible rows
  module = bench.final["module"]
  variables = convert.state_dict_to_flax(module.state_dict(), module)
  # The JAX package's loss of the same weights (rate 0) on its
  # preprocessor's first batch (the one shard's first two records; the
  # running averages do not enter a training-mode forward).
  (spec, labels), = _batches(
      jax_pre, jax_datasets.LibrispeechDataset(libri_dir), "train",
      (64, 161, 1), 16, 1)
  jm = _small(jax_ds.DeepSpeech2Model())
  jm.set_batch_size(2)
  (logits, _), _ = jm.make_module(nclass=29, phase_train=True).apply(
      variables, jnp.asarray(spec), mutable=["batch_stats"])
  ref = float(jm.loss_function(BuildNetworkResult(logits=(logits, None)),
                               tuple(jnp.asarray(t) for t in labels)))
  np.testing.assert_allclose(loss, ref, rtol=1e-6)


@pytest.mark.parametrize("records,flags", [
    (False, []),
    (True, ["--staged_vars", "--variable_update=parameter_server"])])
def test_cli_trains_deepspeech2(libri_dir, monkeypatch, capsys, records,
                                flags):
  """``--model=deepspeech2`` through the port's CLI on the synthetic batch,
  and on generated records under --staged_vars (the small network, as
  above)."""
  from kf_benchmarks_tpu_torch import cli  # noqa: PLC0415
  monkeypatch.setitem(
      model_config._SPEECH_MODELS, "deepspeech2",
      lambda params=None: _small(deepspeech.DeepSpeech2Model(params=params)))
  data = ([f"--data_dir={libri_dir}"] if records
          else ["--data_name=librispeech"])
  assert cli.main(["--model=deepspeech2", "--device=cpu", "--batch_size=2",
                   "--num_batches=2", "--num_warmup_batches=0"] + data +
                  flags) == 0
  out = capsys.readouterr().out
  assert "Model:       deepspeech2" in out and "total images/sec" in out
