"""The real-data input path whole, on the CPU: the port's BenchmarkCNN with
--data_dir on TFRecords that the test writes (the port's generator), held
against the JAX package's BenchmarkCNN and preprocessors on the same
records.

* The step receives the JAX preprocessor's batches after normalisation:
  bitwise the JAX host batch for the same records, in f32, and in bf16
  after the JAX package's ``_cast_images``.
* Per-step losses within the port's f32 parity tolerance for the ResNet
  (1e-2 relative, tests/test_torch_dispatch.py) of the JAX BenchmarkCNN on
  the same records, the weights carried across by convert.py (the small
  (1, 1, 1, 1) ResNet-50 at 32 px, batch 4).
* K = 4 losses are bitwise K = 1 over the same stream, with a warmup that
  is not a multiple of K and a mid-training eval; --forward_only reads the
  train subset with eval-mode preprocessing.
* --eval reads a one-pass validation stream and stops at its end.
* A checkpoint resume reopens the stream at the saved incarnation.
* At 2 gloo ranks each rank reads the stream the JAX preprocessor gives for
  (seed + rank, shift rank / 2), and trains on it.
* The CLI of the acceptance criterion trains full-size ResNet-50 on the
  records without importing PIL.
"""

import os
import re
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import benchmark as jax_benchmark
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu.data import datasets as jax_datasets
from kf_benchmarks_tpu.data import preprocessing as jax_pre
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.data import preprocessing as pre
from kf_benchmarks_tpu_torch.data import tfrecord_image_generator
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import resnet_model

import torch_input_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET_RTOL = 1e-2
LAYERS = (1, 1, 1, 1)
SIZE = 32
STEP_LINE = re.compile(r"^(\d+)\timages/sec: .*\t([-0-9.naninf]+)$")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
  d = tmp_path_factory.mktemp("rec") / "imagenet"
  tfrecord_image_generator.write_textured_records(
      str(d), num_train=32, num_validation=10, num_distinct=8,
      num_train_shards=4, num_validation_shards=2, height=150, width=200,
      quality=90)
  return str(d)


def _flags(records, **kw):
  return {**dict(model="resnet50", device="cpu", batch_size=4,
                data_dir=records, data_name="imagenet", display_every=1),
          **kw}


@pytest.fixture
def small_resnet(monkeypatch):
  """The port's resnet50 at (1, 1, 1, 1) and 32 px; ``variables`` (flax,
  nclass 1001), when set, are loaded into every module made."""
  state = SimpleNamespace(variables=None)

  class Small(resnet_model.ResnetModel):

    def __init__(self, params=None):
      super().__init__("resnet50", LAYERS, params=params)
      self.image_size = SIZE

    def make_module(self, nclass, dtype=torch.float32, generator=None):
      m = super().make_module(nclass, dtype, generator)
      if state.variables is not None:
        m.load_state_dict(convert.flax_to_state_dict(state.variables, m))
      return m

  monkeypatch.setitem(model_config._MODELS, "resnet50", Small)
  return state


def _jax_pre(records, subset="train", seed=1234, shift=0.0, train=True,
             batch=4):
  return jax_pre.RecordInputImagePreprocessor(
      batch_size=batch, output_shape=(SIZE, SIZE, 3), train=train,
      seed=seed, shift_ratio=shift, num_threads=16).minibatches(
          jax_datasets.ImagenetDataset(records), subset)


# -- the batches the step receives --------------------------------------------

@pytest.mark.parametrize("use_fp16", [False, True])
def test_the_step_receives_the_jax_host_batches(records, small_resnet,
                                                use_fp16):
  bench = benchmark.BenchmarkCNN(params_lib.make_params(
      **_flags(records, use_fp16=use_fp16)))
  next_batch = bench._open_input("train")
  got = [next_batch() for _ in range(5)]
  bench._stop_input()
  host = _jax_pre(records)
  if use_fp16:
    host = jax_benchmark.BenchmarkCNN._cast_images(
        SimpleNamespace(compute_dtype=jnp.bfloat16), host)
  for images, labels in got:
    ref_images, ref_labels = next(host)
    assert images.dtype == (torch.bfloat16 if use_fp16 else torch.float32)
    np.testing.assert_array_equal(images.float().numpy(),
                                  np.asarray(ref_images, np.float32))
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
  host.close()


# -- training against the JAX BenchmarkCNN ------------------------------------

def _jax_losses(flags, variables, capsys):
  model = jax_resnet.ResnetModel("resnet50", LAYERS)
  model.image_size = SIZE
  bench = jax_benchmark.BenchmarkCNN(jax_params.make_params(**flags),
                                     model=model)
  build = bench._build

  def build_from_variables():
    init_state, *rest = build()

    def init(rng, x):
      state = init_state(rng, x)
      put = lambda a, v: jnp.asarray(v, a.dtype)[None]  # noqa: E731
      return state.replace(
          params=jax.tree.map(put, state.params, variables["params"]),
          batch_stats=jax.tree.map(put, state.batch_stats,
                                   variables["batch_stats"]))
    return (init, *rest)

  bench._build = build_from_variables
  capsys.readouterr()
  bench.run()
  out = capsys.readouterr().out
  return [float(m.group(2)) for m in map(STEP_LINE.match, out.splitlines())
          if m]


def test_losses_match_the_jax_benchmark(records, small_resnet, capsys):
  model = jax_resnet.ResnetModel("resnet50", LAYERS)
  module = model.make_module(nclass=1001, phase_train=True)
  variables = jax.device_get(module.init(
      jax.random.PRNGKey(0), jnp.zeros((4, SIZE, SIZE, 3), jnp.float32)))
  flags = _flags(records, num_batches=4, num_warmup_batches=1,
                 distortions=True, resize_method="round_robin")
  ref = _jax_losses(flags, variables, capsys)
  small_resnet.variables = variables
  got = benchmark.BenchmarkCNN(params_lib.make_params(**flags)).run()
  assert len(ref) == 4 and len(got["losses"]) == 4
  # The JAX step lines print the loss to 3 decimals.
  np.testing.assert_allclose(got["losses"], ref, rtol=RESNET_RTOL,
                             atol=1e-3)
  assert got["feed_stats"]["fetches"] == 1 + 4 + 1
  assert 0.0 <= got["feed_stall_fraction"] <= 1.0


@pytest.mark.parametrize("warmup,eval_every", [(3, 4), (4, None)])
def test_k4_losses_are_bitwise_k1(records, small_resnet, warmup, eval_every):
  runs = {}
  for k in (1, 4):
    runs[k] = benchmark.BenchmarkCNN(params_lib.make_params(**_flags(
        records, num_batches=8, num_warmup_batches=warmup,
        steps_per_dispatch=k, eval_during_training_every_n_steps=eval_every,
        display_every=100))).run()
  assert runs[4]["losses"] == runs[1]["losses"]
  assert len(runs[1]["losses"]) == 8
  assert runs[4]["eval_results"] == runs[1]["eval_results"]
  assert [e["step"] for e in runs[1]["eval_results"]] == (
      [4, 8] if eval_every else [])
  if warmup % 4 == 0:
    # Aligned with the staged chunks: two whole-chunk dispatches.
    assert runs[4]["num_dispatches"] == 2


def test_forward_only_reads_train_records_in_eval_mode(records, small_resnet,
                                                       monkeypatch):
  seen = []
  init = pre.RecordInputImagePreprocessor.__init__

  def spy(self, *a, **kw):
    init(self, *a, **kw)
    seen.append((self.train, self.seed))
  monkeypatch.setattr(pre.RecordInputImagePreprocessor, "__init__", spy)
  stats = benchmark.BenchmarkCNN(params_lib.make_params(**_flags(
      records, forward_only=True, num_batches=3,
      num_warmup_batches=1))).run()
  assert seen == [(False, 1234)]
  assert len(stats["losses"]) == 3 and np.isfinite(stats["losses"]).all()


# -- evaluation ---------------------------------------------------------------

def test_eval_is_one_pass_and_stops_at_the_end(records, small_resnet,
                                               capsys):
  stats = benchmark.BenchmarkCNN(params_lib.make_params(**_flags(
      records, eval=True, num_eval_batches=5))).run()
  # 10 validation records make two batches of 4; the rest is not a batch.
  assert stats["num_eval_batches"] == 2
  assert "[8 examples]" in capsys.readouterr().out
  stats = benchmark.BenchmarkCNN(params_lib.make_params(**_flags(
      records, eval=True, num_eval_batches=1))).run()
  assert stats["num_eval_batches"] == 1


# -- checkpoint resume --------------------------------------------------------

def test_resume_reopens_the_stream_at_its_incarnation(records, small_resnet,
                                                      monkeypatch, tmp_path,
                                                      capsys):
  flags = _flags(records, num_batches=2, num_warmup_batches=0,
                 train_dir=str(tmp_path))
  first = benchmark.BenchmarkCNN(params_lib.make_params(**flags))
  first.run()
  # An adaptive-batch rebuild writes its seam checkpoint one incarnation on.
  first._save_checkpoint(first.final["module"], first.final["step"],
                         incarnation_bump=1)
  seen = []
  init = pre.RecordInputImagePreprocessor.__init__

  def spy(self, *a, **kw):
    init(self, *a, **kw)
    seen.append(self.seed)
  monkeypatch.setattr(pre.RecordInputImagePreprocessor, "__init__", spy)
  capsys.readouterr()
  stats = benchmark.BenchmarkCNN(params_lib.make_params(**flags)).run()
  assert seen == [1234 + 7919]
  assert "Resumed input stream at incarnation 1" in capsys.readouterr().out
  assert stats["global_step"] == 4


# -- data parallel ------------------------------------------------------------

def test_two_gloo_ranks_read_their_shifted_streams(records, tmp_path):
  params = params_lib.make_params(
      model="trivial", device="cpu", num_devices=2, batch_size=2,
      data_dir=records, num_batches=2, num_warmup_batches=0,
      display_every=100)
  got = torch_input_ranks.run_world(2, params, tmp_path, 3)
  for rank in range(2):
    host = jax_pre.RecordInputImagePreprocessor(
        batch_size=2, output_shape=(227, 227, 3), seed=1234 + rank,
        shift_ratio=rank / 2, num_threads=4).minibatches(
            jax_datasets.ImagenetDataset(records), "train")
    for j in range(3):
      ref_images, ref_labels = next(host)
      np.testing.assert_array_equal(got[rank]["images"][j], ref_images)
      np.testing.assert_array_equal(got[rank]["labels"][j], ref_labels)
    host.close()
  assert not np.array_equal(got[0]["images"], got[1]["images"])
  # The losses are the mean over the ranks, the same on both.
  np.testing.assert_array_equal(got[0]["losses"], got[1]["losses"])
  assert len(got[0]["losses"]) == 2 and np.isfinite(got[0]["losses"]).all()


# -- flags ------------------------------------------------------------------

@pytest.mark.parametrize("flags,match", [
    (dict(use_datasets=False), "--use_datasets=false is unsupported"),
    # LibriSpeech holds DeepSpeech2 alone, and its records take the
    # default preprocessor only: the JAX package's messages.
    pytest.param(dict(data_dir="/x/librispeech2017"),
                 "Invalid model name 'resnet50' for dataset 'librispeech'",
                 id="flags1-ROADMAP Queue 1 item 7"),
    pytest.param(dict(data_dir="/x/records", data_name="librispeech"),
                 "Invalid model name 'resnet50' for dataset 'librispeech'",
                 id="flags2-ROADMAP Queue 1 item 7"),
    pytest.param(dict(data_dir="/x/librispeech", model="deepspeech2",
                      input_preprocessor="multiprocess"),
                 "multiprocess preprocessing applies to the imagenet "
                 "dataset, not 'librispeech'",
                 id="flags3-ROADMAP Queue 1 item 7b"),
    (dict(data_dir="/x/imagenet", input_preprocessor="bogus"),
     "Unknown input preprocessor"),
    (dict(data_dir="/x/records"), "Could not identify name of dataset"),
    (dict(data_dir="/x/imagenet", model="transformer_lm"),
     "transformer_lm reads its seeded token stream")])
def test_input_flag_refusals(flags, match):
  with pytest.raises(validation.ParamError, match=match):
    validation.validate_cross_flags(params_lib.make_params(
        **{"model": "resnet50", **flags}))


def test_parity_flags_log_a_note_and_synthetic_images_win(records,
                                                          small_resnet,
                                                          capsys):
  stats = benchmark.BenchmarkCNN(params_lib.make_params(**_flags(
      records, use_synthetic_gpu_images=True, fuse_decode_and_crop=False,
      use_multi_device_iterator=False, num_batches=1,
      num_warmup_batches=0))).run()
  out = capsys.readouterr().out
  assert "Dataset:     imagenet (synthetic)" in out
  for name in ("fuse_decode_and_crop", "use_multi_device_iterator"):
    assert (f"Note: --{name} is accepted for reference-CLI parity but has "
            "no effect in the port") in out
  assert stats["feed_stats"] is None and stats["feed_stall_fraction"] is None


# -- the CLI ------------------------------------------------------------------

def test_cli_trains_resnet50_on_the_records_without_pil(records):
  script = (
      "import sys\n"
      f"sys.path.insert(0, {REPO!r})\n"
      "from kf_benchmarks_tpu_torch import cli\n"
      f"rc = cli.main(['--model=resnet50', '--data_dir={records}', "
      "'--data_name=imagenet', '--batch_size=2', '--num_batches=2', "
      "'--num_warmup_batches=1', '--device=cpu'])\n"
      "bad = sorted(m for m in sys.modules if m == 'PIL' or "
      "m.startswith(('PIL.', 'jax', 'kf_benchmarks_tpu.')))\n"
      "print('loaded:', bad)\n"
      "sys.exit(rc or bool(bad))\n")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                        text=True, cwd=REPO, env=env, timeout=240)
  assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
  assert f"Dataset:     imagenet ({records})" in proc.stdout
  assert "total images/sec: " in proc.stdout
  assert "loaded: []" in proc.stdout
