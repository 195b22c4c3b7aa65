"""The port's evaluation and forward-only paths against the JAX package's,
on the CPU in f32.

* ``EvalStep`` (the module in eval mode under ``torch.no_grad``): logits,
  top-1, top-5 and loss against the JAX eval module (``phase_train=False``)
  after two JAX training steps moved the weights and batch-norm averages,
  for the small ResNet-50 v1.5 (``(1, 2, 1, 1)``; its two fused units on
  their plain path) and the small LM; the averages bitwise untouched.
* The early stop: the trivial model trains on one fixed batch (one label)
  from one init in both frameworks' BenchmarkCNN, evaluating every 2
  steps, and both stop at the first eval whose top-1 reaches 1.0.
* ``--forward_only`` and ``--eval`` through the CLI, at one rank and at
  two (gloo); ``--eval --train_dir`` scores the newest readable
  checkpoint with the weights alone and stops after 10 stale polls.
* ``compute_eval_step_set`` and the epoch-to-batch conversions against
  the JAX functions over a grid of flags; every new validation rule with
  the JAX package's message.
* The gloo world-2 eval against the world-1 eval of the same weights.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import benchmark as jax_benchmark
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.models import trivial_model as jax_trivial
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import train_step
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import resnet_model
from kf_benchmarks_tpu_torch.models import trivial_model

import test_torch_transformer_lm as lmt
import torch_dp_worker
import torch_parity as tp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_LINE = re.compile(r"^(\d+)\timages/sec: \d+\.\d \+/- \d+\.\d "
                       r"\(jitter = \d+\.\d\)\t\d+\.\d{3}\t\d\.\d{3}\t"
                       r"\d\.\d{3}$")
ACCURACY_LINE = re.compile(r"^Accuracy @ 1 = (\d\.\d{4}) Accuracy @ 5 = "
                           r"(\d\.\d{4}) \[(\d+) examples\]$")


def _close(got, ref, rtol, what):
  ref = np.asarray(ref)
  np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                             atol=rtol * np.abs(ref).max(), err_msg=what)


def test_resnet_eval_matches_jax():
  train_x, train_y = tp.batch(2, 64, seed=31)
  images, labels = tp.batch(6, 64, seed=32)
  jmodel, variables = tp.jax_model_and_variables(train_x, seed=31)
  module = jmodel.make_module(nclass=tp.NCLASS, phase_train=True)

  def loss_of(out):
    return jmodel.loss_function(BuildNetworkResult(logits=out),
                                jnp.asarray(train_y))

  @jax.jit
  def train(params, bs):
    # One SGD step; the batch-norm averages move with it.
    def loss_fn(params):
      out, upd = module.apply({"params": params, "batch_stats": bs},
                              jnp.asarray(train_x), mutable=["batch_stats"])
      return loss_of(out), upd["batch_stats"]
    (_, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return jax.tree.map(lambda p, g: p - 0.05 * g, params, grads), new_bs

  params, bs = variables["params"], variables["batch_stats"]
  for _ in range(2):
    params, bs = train(params, bs)
  trained = jax.device_get({"params": params, "batch_stats": bs})
  assert not np.allclose(
      tp.flat_flax(trained["batch_stats"])[("conv_stem_bn", "mean")],
      tp.flat_flax(variables["batch_stats"])[("conv_stem_bn", "mean")])
  eval_module = jmodel.make_module(nclass=tp.NCLASS, phase_train=False)
  logits, aux = eval_module.apply(trained, jnp.asarray(images))
  result = BuildNetworkResult(logits=(logits, aux))
  ref_acc = jmodel.accuracy_function(result, jnp.asarray(labels))
  ref_loss = float(jmodel.loss_function(result, jnp.asarray(labels)))

  pmodel, pmodule = tp.port_module(trained)
  assert any(block.fused for block in pmodule.blocks)
  before = {k: b.clone() for k, b in pmodule.named_buffers()}
  x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
  metrics = train_step.EvalStep(pmodel, pmodule)(x, y)
  assert pmodule.training
  for k, b in pmodule.named_buffers():
    assert torch.equal(b, before[k]), k
  pmodule.eval()
  with torch.no_grad():
    got_logits = pmodule(x)
  pmodule.train()
  _close(got_logits.numpy(), logits, 1e-4, "logits")
  for k in ("top_1_accuracy", "top_5_accuracy"):
    assert float(metrics[k]) == float(ref_acc[k]), k
  np.testing.assert_allclose(float(metrics["base_loss"]), ref_loss,
                             rtol=1e-5)
  assert float(metrics["total_loss"]) == float(metrics["base_loss"])


def test_lm_eval_matches_jax():
  tokens, labels = lmt._batch(2, seed=41)
  jmodule = lmt._jax_module("tiled", True, True)
  variables = jax.device_get(jmodule.init(jax.random.PRNGKey(41),
                                          jnp.asarray(tokens)))
  jm, pm = lmt._models()

  @jax.jit
  def train(params):
    def loss_fn(params):
      out = jmodule.apply({"params": params}, jnp.asarray(tokens))
      return jm.loss_function(BuildNetworkResult(logits=out),
                              jnp.asarray(labels))
    grads = jax.grad(loss_fn)(params)
    return jax.tree.map(lambda p, g: p - 0.5 * g, params, grads)

  params = variables["params"]
  for _ in range(2):
    params = train(params)
  trained = {"params": jax.device_get(params)}
  eval_tokens, eval_labels = lmt._batch(2, seed=42)
  out = jmodule.apply(trained, jnp.asarray(eval_tokens))
  result = BuildNetworkResult(logits=out)
  ref_acc = jm.accuracy_function(result, jnp.asarray(eval_labels))
  ref_loss = float(jm.loss_function(result, jnp.asarray(eval_labels)))
  module = lmt._port_module("tiled", True, True, trained)
  metrics = train_step.EvalStep(pm, module)(
      torch.from_numpy(eval_tokens), torch.from_numpy(eval_labels).long())
  for k in ("top_1_accuracy", "top_5_accuracy"):
    np.testing.assert_allclose(float(metrics[k]), float(ref_acc[k]),
                               atol=1.0 / eval_labels.size, err_msg=k)
  np.testing.assert_allclose(float(metrics["base_loss"]), ref_loss,
                             rtol=1e-5)
  module.eval()
  with torch.no_grad():
    hidden = module(torch.from_numpy(eval_tokens))[0].hidden
  _close(hidden.numpy(), out[0].hidden, 1e-5, "hidden")


def test_eval_under_no_grad_saves_no_graph_and_restores_train_mode():
  """The fused unit's autograd Function runs under the eval step's grad
  mode: no graph is kept, the output needs no grad, and an exception in
  the forward still leaves the module in training mode."""
  images, labels = tp.batch(2, 64, seed=5)
  _, variables = tp.jax_model_and_variables(images)
  model, module = tp.port_module(variables)
  x = torch.from_numpy(images)
  module.eval()
  with torch.no_grad():
    out = module(x)
  module.train()
  assert not out.requires_grad and out.grad_fn is None
  step = train_step.EvalStep(model, module)
  with pytest.raises(RuntimeError):
    step(x[..., :2], torch.from_numpy(labels).long())
  assert module.training


# -- the early stop --------------------------------------------------------

def _stop_batch():
  rng = np.random.default_rng(0)
  images = (np.clip(rng.normal(size=(2, 227, 227, 3)), -2, 2) * 60.0 +
            127.0).astype(np.float32)
  # One label: the 1-unit bottleneck of the trivial model cannot tell two
  # images apart, but it can learn their class.
  labels = np.full(2, int(rng.integers(0, 1001)), np.int32)
  return images, labels


STOP_FLAGS = dict(model="trivial", device="cpu", batch_size=2,
                  num_batches=30, num_warmup_batches=0, display_every=100,
                  init_learning_rate=1e-8,
                  eval_during_training_every_n_steps=2,
                  stop_at_top_1_accuracy=1.0)


def _port_stop_run(monkeypatch, images, labels, variables, **flags):
  class Fixed(trivial_model.TrivialModel):

    def make_module(self, nclass, dtype=torch.float32, generator=None):
      m = super().make_module(nclass, dtype, generator)
      m.load_state_dict(convert.flax_to_state_dict(variables, m))
      return m

    def get_synthetic_inputs(self, generator, nclass, device):
      return torch.from_numpy(images), torch.from_numpy(labels).long()

  monkeypatch.setitem(model_config._MODELS, "trivial", Fixed)
  return benchmark.BenchmarkCNN(params_lib.make_params(
      **{**STOP_FLAGS, **flags})).run()


def test_early_stop_at_the_same_step_as_jax(monkeypatch, capsys):
  images, labels = _stop_batch()
  jmodel_module = jax_trivial.TrivialModel().make_module(nclass=1001,
                                                         phase_train=True)
  variables = jax.device_get(jmodel_module.init(jax.random.PRNGKey(0),
                                                jnp.asarray(images)))

  class JaxFixed(jax_trivial.TrivialModel):

    def get_synthetic_inputs(self, rng, nclass):
      return jnp.asarray(images), jnp.asarray(labels)

  bench = jax_benchmark.BenchmarkCNN(jax_params.make_params(**STOP_FLAGS),
                                     model=JaxFixed())
  build = bench._build

  def build_from_variables():
    init_state, *rest = build()

    def init(rng, x):
      state = init_state(rng, x)
      return state.replace(params=jax.tree.map(
          lambda a, v: jnp.asarray(v, a.dtype)[None], state.params,
          variables["params"]))
    return (init, *rest)

  bench._build = build_from_variables
  ref = bench.run()
  jax_out = capsys.readouterr().out
  got = _port_stop_run(monkeypatch, images, labels, variables)
  port_out = capsys.readouterr().out
  assert ref["stopped_early"] and got["stopped_early"]
  assert got["num_steps"] == ref["num_steps"]
  evals = got["eval_results"]
  assert [e["step"] for e in evals] == list(range(2, got["num_steps"] + 1,
                                                  2))
  # The first eval at the threshold stopped the run, after at least one
  # below it.
  assert [e["top_1_accuracy"] >= 1.0 for e in evals] == \
      [False] * (len(evals) - 1) + [True]
  assert len(evals) >= 3
  for out in (jax_out, port_out):
    lines = [m for m in map(ACCURACY_LINE.match, out.splitlines()) if m]
    assert len(lines) == len(evals)
    assert float(lines[-1].group(1)) == 1.0
  assert "Stopping early at top-1 accuracy 1.0000 >= 1.0" in port_out
  # --stop_at_top_1_accuracy=0 is off, as in the JAX package.
  full = _port_stop_run(monkeypatch, images, labels, variables,
                        num_batches=12, stop_at_top_1_accuracy=0.0)
  assert not full["stopped_early"] and full["num_steps"] == 12


# -- the CLI ---------------------------------------------------------------

def test_forward_only_cli_prints_step_lines_and_banner(capsys):
  rc = cli.main(["--model=trivial", "--forward_only", "--device=cpu",
                 "--batch_size=2", "--num_batches=4", "--display_every=2",
                 "--num_warmup_batches=1", "--print_training_accuracy"])
  assert rc == 0
  out = capsys.readouterr().out.splitlines()
  assert "Mode:        forward-only" in out
  assert "Step\tImg/sec\ttotal_loss\ttop_1_accuracy\ttop_5_accuracy" in out
  assert [int(m.group(1)) for m in map(STEP_LINE.match, out) if m] == [2, 4]
  assert sum(line.startswith("total images/sec: ") for line in out) == 1


def _small_resnet(params=None):
  model = resnet_model.ResnetModel("resnet50", (1, 1, 1, 1), params=params)
  model.image_size = 32
  return model


def test_eval_train_dir_scores_newest_checkpoint(monkeypatch, tmp_path,
                                                 capsys):
  """Training with checkpoints at steps 2 and 4; --eval with a different
  --optimizer (the weights alone are restored) scores step 4 once, then
  polls 10 times in vain and returns. A torn newest file is skipped."""
  monkeypatch.setitem(model_config._MODELS, "resnet50", _small_resnet)
  common = dict(model="resnet50", device="cpu", batch_size=2,
                train_dir=str(tmp_path), display_every=100)
  benchmark.BenchmarkCNN(params_lib.make_params(
      optimizer="momentum", num_batches=4, num_warmup_batches=0,
      save_model_steps=2, **common)).run()
  sleeps = []
  monkeypatch.setattr(benchmark.time, "sleep", sleeps.append)
  capsys.readouterr()
  eval_params = params_lib.make_params(eval=True, optimizer="adam",
                                       eval_interval_secs=5,
                                       num_eval_batches=3, **common)
  bench = benchmark.BenchmarkCNN(eval_params)
  res = bench.run()
  out = capsys.readouterr().out
  assert res["global_step"] == 4 and res["num_eval_batches"] == 3
  assert "Evaluating checkpoint at global step 4" in out
  assert "Mode:        evaluation" in out
  m = [m for m in map(ACCURACY_LINE.match, out.splitlines()) if m]
  assert len(m) == 1 and int(m[0].group(3)) == 6
  assert sleeps == [5] * 10
  # The scores are the eval step's on the checkpoint's weights and the
  # run's batch.
  module, gen = bench._make_module()
  images, labels = bench._synthetic_batch(gen)
  init = {k: v.clone() for k, v in module.state_dict().items()}
  init_loss = float(train_step.EvalStep(bench.model, module)(
      images, labels)["base_loss"])
  snap, _, _ = checkpoint.load_latest_checkpoint(str(tmp_path))
  checkpoint.restore_model(module, snap)
  # The weights and every batch-norm average are the checkpoint's, not
  # the seeded init's.
  moved = {k for k, v in module.state_dict().items()
           if not torch.equal(v, init[k])}
  assert {k for k, _ in module.named_buffers()} < moved
  want = train_step.EvalStep(bench.model, module)(images, labels)
  assert res["top_1_accuracy"] == float(want["top_1_accuracy"])
  assert res["top_5_accuracy"] == float(want["top_5_accuracy"])
  assert res["base_loss"] == pytest.approx(float(want["base_loss"]),
                                           rel=1e-6)
  assert res["base_loss"] != pytest.approx(init_loss, rel=1e-3)
  assert "Eval loss = %.6f [6 examples]" % res["base_loss"] in out
  # A torn newest checkpoint: step 2 is scored instead.
  newest = tmp_path / "model.ckpt-4.pt"
  newest.write_bytes(newest.read_bytes()[:500])
  res = benchmark.BenchmarkCNN(eval_params._replace(
      eval_interval_secs=0)).run()
  out = capsys.readouterr().out
  assert res["global_step"] == 2
  assert "skipping torn/corrupt checkpoint model.ckpt-4.pt" in out


def test_forward_only_restores_weights_and_saves_nothing(monkeypatch,
                                                         tmp_path, capsys):
  """--forward_only with --train_dir starts from the newest checkpoint's
  weights (an optimizer other than the trainer's needs no matching
  state) and writes no checkpoint."""
  monkeypatch.setitem(model_config._MODELS, "resnet50", _small_resnet)
  common = dict(model="resnet50", device="cpu", batch_size=2,
                train_dir=str(tmp_path), display_every=100,
                num_warmup_batches=0)
  benchmark.BenchmarkCNN(params_lib.make_params(
      optimizer="momentum", num_batches=2, **common)).run()
  files = sorted(os.listdir(tmp_path))
  capsys.readouterr()
  stats = benchmark.BenchmarkCNN(params_lib.make_params(
      forward_only=True, optimizer="lars", num_batches=3, **common)).run()
  out = capsys.readouterr().out
  assert "Restored checkpoint at global step 2" in out
  assert sorted(os.listdir(tmp_path)) == files
  assert stats["num_steps"] == 3 and stats["global_step"] is None


def test_eval_without_train_dir_is_one_pass(capsys):
  res = benchmark.BenchmarkCNN(params_lib.make_params(
      model="trivial", device="cpu", batch_size=2, eval=True,
      num_batches=3)).run()
  out = capsys.readouterr().out.splitlines()
  m = [m for m in map(ACCURACY_LINE.match, out) if m]
  assert len(m) == 1 and int(m[0].group(3)) == 6
  assert res["num_eval_batches"] == 3 and "global_step" not in res


@pytest.mark.parametrize("mode", ["--forward_only", "--eval"])
def test_two_rank_cli_runs(mode, tmp_path):
  """--forward_only and --eval at two gloo ranks through the CLI's spawn:
  rank 0 alone prints."""
  env = {**os.environ, "OMP_NUM_THREADS": "2",
         "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
  proc = subprocess.run(
      [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli", mode,
       "--model=trivial", "--device=cpu", "--num_devices=2",
       "--batch_size=2", "--num_batches=2", "--num_warmup_batches=0",
       "--display_every=1"], capture_output=True, text=True, timeout=120,
      cwd=str(tmp_path), env=env)
  assert proc.returncode == 0, proc.stderr[-3000:]
  out = proc.stdout.splitlines()
  assert "Batch size:  4 global" in out
  if mode == "--eval":
    m = [m for m in map(ACCURACY_LINE.match, out) if m]
    assert len(m) == 1 and int(m[0].group(3)) == 8
  else:
    assert [int(m.group(1)) for m in map(STEP_LINE.match, out) if m] == \
        [1, 2]
    assert sum(line.startswith("total images/sec: ") for line in out) == 1


def test_world_2_eval_matches_world_1(tmp_path):
  """Each gloo rank evaluates its own batch; both report the mean over
  the ranks, which is the mean of the two world-1 evals."""
  images, _ = tp.batch(2, 64, seed=7)
  _, variables = tp.jax_model_and_variables(images, seed=7)
  batches = torch_dp_worker.batches(2, 3, 64, seed=50)
  ranks = torch_dp_worker.run_world(
      2, [{"name": "eval", "model": "resnet", "variables": variables,
           "batches": batches}], tmp_path)
  model, module = tp.port_module(variables)
  step = train_step.EvalStep(model, module)
  single = [step(torch.from_numpy(x), torch.from_numpy(y).long())
            for x, y in batches]
  for key in ("top_1_accuracy", "top_5_accuracy", "base_loss"):
    want = (float(single[0][key]) + float(single[1][key])) / 2
    got = [r["eval"][key] for r in ranks]
    assert got[0] == got[1], key
    np.testing.assert_allclose(got[0], want, rtol=1e-6, err_msg=key)


# -- schedules and conversions -----------------------------------------------

GRID = [
    dict(eval_during_training_every_n_epochs=0.5),
    dict(eval_during_training_every_n_epochs=1.0),
    dict(eval_during_training_every_n_epochs=0.3),
    dict(eval_during_training_at_specified_steps=["3", "10", "40"]),
    dict(eval_during_training_at_specified_epochs=["0.5", "2", "2.25"]),
    dict(eval_during_training_every_n_steps=4),
]


@pytest.mark.parametrize("start", [(0, 0), (5, 5 * 256), (7, 2000)])
@pytest.mark.parametrize("flags", GRID)
def test_eval_step_set_matches_jax(flags, start):
  for batch, examples, batches in ((256, 2560, 40), (1000, 5000, 25),
                                   (96, 1000, 33)):
    ref = jax_benchmark.compute_eval_step_set(
        jax_params.make_params(**flags), batch, examples, batches, *start)
    got = benchmark.compute_eval_step_set(
        params_lib.make_params(**flags), batch, examples, batches, *start)
    assert got == ref, (batch, examples, batches)


@pytest.mark.parametrize("flags", [
    dict(eval_during_training_at_specified_steps=["3", "x"]),
    dict(eval_during_training_at_specified_epochs=["1", "two"])])
def test_eval_step_set_errors_match_jax(flags):
  with pytest.raises(jax_validation.ParamError) as ref:
    jax_benchmark.compute_eval_step_set(jax_params.make_params(**flags), 8,
                                        100, 10)
  with pytest.raises(validation.ParamError) as got:
    benchmark.compute_eval_step_set(params_lib.make_params(**flags), 8, 100,
                                    10)
  assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("flags", [
    dict(num_epochs=0.001), dict(num_epochs=0.0137, num_eval_epochs=0.01),
    dict(num_batches=7, num_eval_epochs=1.0), dict(num_eval_batches=9),
    dict()])
def test_epoch_conversions_match_jax(flags, world, monkeypatch):
  for batch in (32, 256):
    ref = jax_benchmark.BenchmarkCNN(jax_params.make_params(
        model="trivial", device="cpu", num_devices=world, batch_size=batch,
        **flags))
    monkeypatch.setattr(benchmark.mesh, "world_size", lambda: world)
    got = benchmark.BenchmarkCNN(params_lib.make_params(
        model="trivial", device="cpu", batch_size=batch, **flags))
    assert got.world_size == world
    assert got.num_batches == ref.num_batches
    assert (got._num_eval_batches_from_epochs() ==
            ref._num_eval_batches_from_epochs())


# -- validation ---------------------------------------------------------------

RULES = [
    dict(eval=True, forward_only=True),
    dict(eval=True, job_name="worker"),
    dict(num_batches=5, num_epochs=1.0),
    dict(num_epochs=-1.0),
    dict(num_epochs=0.0),
    dict(num_eval_batches=3, num_eval_epochs=1.0),
    dict(num_eval_batches=0),
    dict(num_eval_epochs=-0.5),
    dict(fp16_enable_auto_loss_scale=True),
    dict(use_fp16=True, fp16_enable_auto_loss_scale=True,
         variable_update="collective_all_reduce"),
    dict(learning_rate_decay_factor=0.5),
    dict(num_epochs_per_decay=2.0),
    dict(learning_rate_decay_factor=0.5, num_epochs_per_decay=2.0),
    dict(minimum_learning_rate=0.01),
    dict(piecewise_learning_rate_schedule="0.1;1;0.01",
         init_learning_rate=0.1),
    dict(piecewise_learning_rate_schedule="0.1;1;0.01",
         num_learning_rate_warmup_epochs=1.0),
    dict(forward_only=True, variable_update="distributed_all_reduce",
         all_reduce_spec="psum"),
    dict(forward_only=True, variable_update="collective_all_reduce"),
    dict(forward_only=True, job_name="controller"),
    dict(eval_during_training_every_n_steps=2,
         eval_during_training_every_n_epochs=1.0),
    dict(eval_during_training_every_n_steps=2, eval=True),
    dict(eval_during_training_every_n_steps=2, forward_only=True),
    dict(eval_during_training_at_specified_steps=["4"], job_name="worker"),
    dict(stop_at_top_1_accuracy=0.5),
]


@pytest.mark.parametrize("flags", RULES)
def test_validation_rule_matches_jax(flags):
  with pytest.raises(jax_validation.ParamError) as ref:
    jax_validation.validate_cross_flags(
        jax_params.make_params(device="cpu", **flags))
  with pytest.raises(validation.ParamError) as got:
    validation.validate_cross_flags(
        params_lib.make_params(device="cpu", **flags))
  assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("flags", [
    dict(eval=True, elastic=True), dict(forward_only=True,
                                        adaptive_batch_size=True),
    dict(eval=True, track_grad_noise_scale=True)])
def test_training_only_flags_refused_in_eval_modes(flags):
  with pytest.raises(validation.ParamError, match="training only"):
    validation.validate_cross_flags(
        params_lib.make_params(device="cpu", **flags))


def test_valid_mode_flags_pass():
  for flags in (dict(eval=True), dict(forward_only=True),
                dict(eval_during_training_every_n_steps=2,
                     stop_at_top_1_accuracy=0.5),
                dict(init_learning_rate=0.1, learning_rate_decay_factor=0.5,
                     num_epochs_per_decay=2.0, minimum_learning_rate=0.01),
                dict(use_fp16=True, fp16_enable_auto_loss_scale=True)):
    validation.validate_cross_flags(
        params_lib.make_params(device="cpu", **flags))
