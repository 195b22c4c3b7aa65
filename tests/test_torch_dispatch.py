"""--steps_per_dispatch in the port (train_step.TrainChunk, the dispatch
planner of benchmark.py, utils/pipeline.py), on the CPU.

* Within the port, bitwise: a TrainChunk at K = 2 and 4, dispatched with a
  tail shorter than K, and under the auto loss scale from a scale that
  overflows, against the same number of single TrainStep calls from one
  init -- every metric of every step, the weights, the batch-norm
  averages, the optimizer's state and the counters. BenchmarkCNN's
  per-step losses at K = 1, 2 and 4 on the small ResNet-50 and the small
  LM, with a warmup that is not a multiple of K.
* Against the JAX package (f32 on the CPU): the port's K-step dispatches
  against the JAX ``train_chunk`` on the small transformer_lm (vocab 128,
  d 32, 2 layers: the losses within 1e-5 relative, the LM parity tests'
  forward tolerance), and against the JAX step taken as many times on the
  (1, 2, 1, 1) ResNet-50 at 64 px (within 1e-2 relative, the ResNet
  tolerance of tests/test_torch_train_step.py: batch-4 steps in f32 are
  chaotic). The JAX ``train_chunk`` of a batch-norm model does not compile
  on the installed jax (its scan carry's varying axes do not match, the
  JAX package's standing CPU failures), and the JAX package pins that
  chunk bitwise to its single steps where it compiles.
* The planner: ``dispatch_len`` never lets a dispatch cross a step-keyed
  event, and a K = 4 run saves and evaluates at the steps of the K = 1
  run with the same losses.
* validation.py's K rules, with the JAX package's messages.
* The async parameter server with a stateful optimizer (Adam, whose step
  counts its sequential apply now keeps on the device, and momentum): at
  two gloo ranks, four steps as one K = 4 dispatch are bitwise four single
  steps.
* The lag-N pipeline: the cases of the JAX package's tests/test_pipeline.py
  and tests/test_steps_per_dispatch.py:54-105, on the port's pipeline.
"""

import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import learning_rate as jax_lr
from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.models import transformer_lm as jax_lm
from kf_benchmarks_tpu.parallel import strategies as jax_strategies
from kf_benchmarks_tpu.parallel.mesh import build_mesh
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet
from kf_benchmarks_tpu_torch.models import transformer_lm as port_lm
from kf_benchmarks_tpu_torch.utils import log as log_util
from kf_benchmarks_tpu_torch.utils.pipeline import MetricsPipeline

import torch_dp_modes as dp_modes
import torch_dp_worker as dp_worker
import torch_parity as tp

torch.set_num_threads(2)

BATCH = 4
WEIGHT_DECAY = 1e-3
# An epoch of 5 steps at batch 4: the warmup rate changes at every step.
EXAMPLES = 20
FLAGS = dict(optimizer="momentum", init_learning_rate=0.01,
             num_learning_rate_warmup_epochs=1.0, weight_decay=WEIGHT_DECAY)
AUTO = dict(use_fp16=True, fp16_enable_auto_loss_scale=True,
            fp16_loss_scale=2.0 ** 127, fp16_inc_loss_scale_every_n=2)
# The small LM of tests/test_torch_transformer_lm.py.
VOCAB, D, LAYERS, HEADS, DFF, T, BLOCK = 128, 32, 2, 4, 64, 64, 16
LOSS_CHUNK = 16
LM_RTOL = 1e-5
RESNET_RTOL = 1e-2


def _dispatches(k, steps):
  """K-step dispatches and a shorter tail: the planner's pattern."""
  out = [k] * (steps // k)
  if steps % k:
    out.append(steps % k)
  return out


# -- the port's step against its own chunk, bitwise ----------------------------

def _port_resnet_step(variables, flags, num_grad_accum=1):
  model, module = tp.port_module(variables)
  p = port_params.make_params(device="cpu", **flags)
  scale, auto = port_train_step.loss_scale_settings(p)
  step = port_train_step.TrainStep(
      model, module, port_optimizers.get_optimizer(p, module.parameters()),
      port_lr.make_learning_rate_fn(p, model, BATCH, EXAMPLES),
      p.weight_decay, loss_scale=scale, auto_loss_scale=auto,
      inc_loss_scale_every_n=p.fp16_inc_loss_scale_every_n,
      num_grad_accum=num_grad_accum)
  return module, step


def _state(module, step):
  opt = step.optimizer
  return ([q.detach().clone() for q in module.parameters()] +
          [b.clone() for b in port_train_step.batch_stats(module)] +
          [v.clone() for q in module.parameters()
           for v in opt.state[q].values()],
          step.counters(), step.global_step)


def run_singles_and_chunk(k, steps, flags, num_grad_accum=1, seed=5):
  """(single-step metrics, chunk metrics, single state, chunk state) of
  ``steps`` steps from one init: TrainStep called ``steps`` times, and a
  TrainChunk of K dispatched as the planner would."""
  images, labels = tp.batch(BATCH, 64, seed=seed)
  _, variables = tp.jax_model_and_variables(images, seed=seed)
  x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
  module, step = _port_resnet_step(variables, flags, num_grad_accum)
  singles = [step(x, y) for _ in range(steps)]
  single_metrics = {key: torch.stack([m[key] for m in singles])
                    for key in singles[0]}
  single_state = _state(module, step)
  module, step = _port_resnet_step(variables, flags, num_grad_accum)
  chunk = port_train_step.TrainChunk(step, k)
  parts = [chunk(x, y, d) for d in _dispatches(k, steps)]
  chunk_metrics = {key: torch.cat([m[key] for m in parts])
                   for key in parts[0]}
  return single_metrics, chunk_metrics, single_state, _state(module, step)


def _assert_bitwise(a, b):
  assert set(a) == set(b)
  for key in a:
    assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("k,steps", [(2, 5), (4, 7)])
def test_chunk_is_bitwise_the_single_steps(k, steps):
  singles, chunked, s_state, c_state = run_singles_and_chunk(k, steps, FLAGS)
  _assert_bitwise(singles, chunked)
  assert len(chunked["total_loss"]) == steps
  assert len(set(chunked["learning_rate"].tolist())) > 1  # it moved
  assert all(torch.equal(u, v) for u, v in zip(s_state[0], c_state[0]))
  assert s_state[1:] == c_state[1:]


@pytest.mark.parametrize("k", [2, 4])
def test_chunk_under_the_auto_loss_scale_is_bitwise(k):
  """From 2^127 the first steps overflow and are skipped on the device;
  the chunk skips the same steps with the same state."""
  singles, chunked, s_state, c_state = run_singles_and_chunk(
      k, 7, {**FLAGS, **AUTO})
  _assert_bitwise(singles, chunked)
  scales = chunked["loss_scale"].tolist()
  assert scales[:3] == [2.0 ** 126, 2.0 ** 125, 2.0 ** 124]
  assert all(torch.equal(u, v) for u, v in zip(s_state[0], c_state[0]))
  assert s_state[1] == c_state[1] and s_state[1]["update_count"] < 7


# -- against the JAX package ---------------------------------------------------

def _jax_steps(model, module, variables, flags, feed, dispatches, k,
               examples):
  """Per-step total losses and final params of the JAX package's step
  (``dispatches`` of 1) or train_chunk (K)."""
  p = jax_params.make_params(device="cpu", num_devices=1,
                             steps_per_dispatch=k, **flags)
  lr_fn = jax_lr.make_learning_rate_fn(p, model, BATCH, examples)
  tx = jax_optimizers.get_optimizer(p, lr_fn)
  init_state, step, _, broadcast_init, chunk = jax_train_step.make_step_fns(
      model, module, module, jax_strategies.get_strategy(p), tx, lr_fn, p,
      build_mesh(1, "cpu"))
  stack = lambda tree: jax.tree.map(lambda x: jnp.asarray(x)[None], tree)
  x, y = (jnp.asarray(a) for a in feed)
  state = init_state(jax.random.PRNGKey(0), x[:1])
  state = state.replace(params=broadcast_init(stack(variables["params"])))
  if "batch_stats" in variables:
    state = state.replace(batch_stats=stack(variables["batch_stats"]))
  losses = []
  for d in dispatches:
    if d > 1:
      state, m = chunk(state, x[None], y[None])
      losses += [float(v) for v in np.asarray(m["total_loss"]).reshape(-1)]
    else:
      state, m = step(state, x, y)
      losses.append(float(m["total_loss"]))
  return losses, jax.device_get(state.params)


def _lm_setup(seed=3):
  rng = np.random.default_rng(seed)
  tokens = rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32)
  labels = np.roll(tokens, -1, axis=1)
  module = jax_lm._TransformerLMModule(
      vocab=VOCAB, d_model=D, n_layers=LAYERS, n_heads=HEADS, d_ff=DFF,
      attn_block=BLOCK, attn_q_block=BLOCK, max_len=T, attn_impl="flash",
      scan_layers=True, fused_head=True)
  variables = jax.device_get(module.init(jax.random.PRNGKey(seed),
                                         jnp.asarray(tokens)))
  return tokens, labels, module, variables


def _port_lm_chunk(variables, flags, k, dispatches, feed, num_grad_accum=1):
  pm = port_lm.TransformerLMModel()
  pm.LOSS_CHUNK = LOSS_CHUNK
  module = port_lm.TransformerLM(VOCAB, D, LAYERS, HEADS, DFF, BLOCK, BLOCK,
                                 "flash", True, True, T, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  p = port_params.make_params(device="cpu", **flags)
  step = port_train_step.TrainStep(
      pm, module, port_optimizers.get_optimizer(p, module.parameters()),
      port_lr.make_learning_rate_fn(p, pm, BATCH, 40), p.weight_decay,
      num_grad_accum=num_grad_accum)
  chunk = port_train_step.TrainChunk(step, k)
  x, y = (torch.from_numpy(a) for a in feed)
  losses = torch.cat([chunk(x, y, d)["total_loss"] for d in dispatches])
  return losses.tolist(), module


def _check_params(module, ref_params, rtol):
  """The port's parameters against the JAX package's, as one vector."""
  ref = convert._flatten({"params": ref_params})
  got, want = [], []
  for key, q in module.named_parameters():
    path, kind, index = convert.flax_source(key, q, module)
    r = np.asarray(ref[path])[0]
    r = r if index is None else r[index]
    got.append(convert.to_flax_layout(q.detach().numpy(), kind).ravel())
    want.append(np.asarray(r).ravel())
  g, w = np.concatenate(got), np.concatenate(want)
  assert np.linalg.norm(g - w) <= rtol * np.linalg.norm(w)


@pytest.mark.parametrize("k", [2, 4])
def test_lm_chunk_matches_jax_train_chunk(k):
  tokens, labels, module, variables = _lm_setup()
  jm = jax_lm.TransformerLMModel()
  jm.LOSS_CHUNK = LOSS_CHUNK
  flags = dict(model="transformer_lm", optimizer="momentum",
               init_learning_rate=0.05, num_learning_rate_warmup_epochs=1.0,
               weight_decay=WEIGHT_DECAY)
  dispatches = _dispatches(k, 2 * k + 1)
  ref, ref_params = _jax_steps(jm, module, variables, flags,
                               (tokens, labels), dispatches, k, 40)
  got, port_module = _port_lm_chunk(variables, flags, k, dispatches,
                                    (tokens, labels))
  np.testing.assert_allclose(got, ref, rtol=LM_RTOL)
  assert got[-1] < got[0]
  _check_params(port_module, ref_params, LM_RTOL)


def test_resnet_chunk_matches_the_jax_steps():
  images, labels = tp.batch(BATCH, 64, seed=5)
  model, variables = tp.jax_model_and_variables(images, seed=5)
  jmodule = model.make_module(nclass=tp.NCLASS, phase_train=True)
  ref, ref_params = _jax_steps(model, jmodule, variables, FLAGS,
                               (images, labels), [1] * 5, 1, EXAMPLES)
  _, chunked, _, _ = run_singles_and_chunk(4, 5, FLAGS)
  np.testing.assert_allclose(chunked["total_loss"].numpy(), ref,
                             rtol=RESNET_RTOL)


# -- BenchmarkCNN at K = 1, 2, 4 ----------------------------------------------

def _small_resnet(params=None):
  model = port_resnet.ResnetModel("resnet50", (1, 1, 1, 1), params=params)
  model.image_size = 32
  return model


def _bench(monkeypatch, **flags):
  """BenchmarkCNN on the small ResNet-50 (or, with model=transformer_lm,
  the small LM); (stats, log lines)."""
  monkeypatch.setitem(model_config._MODELS, "resnet50", _small_resnet)
  for name, value in (("VOCAB", VOCAB), ("SEQ_LEN", T), ("D_MODEL", D),
                      ("N_LAYERS", LAYERS), ("N_HEADS", HEADS),
                      ("D_FF", DFF)):
    monkeypatch.setattr(port_lm, name, value)
  lines = []
  monkeypatch.setattr(benchmark, "log_fn", lines.append)
  p = port_params.make_params(**{
      "model": "resnet50", "device": "cpu", "batch_size": BATCH,
      "optimizer": "momentum", "num_batches": 7, "num_warmup_batches": 3,
      "display_every": 1, **flags})
  return benchmark.BenchmarkCNN(p).run(), lines


@pytest.mark.parametrize("model", ["resnet50", "transformer_lm"])
def test_benchmark_losses_bitwise_at_k_1_2_4(monkeypatch, model):
  runs = {k: _bench(monkeypatch, model=model, steps_per_dispatch=k,
                    attn_block=BLOCK if model == "transformer_lm" else None)
          for k in (1, 2, 4)}
  losses = {k: stats["losses"] for k, (stats, _) in runs.items()}
  assert len(losses[1]) == 7 and losses[1] == losses[2] == losses[4]
  for k, (stats, lines) in runs.items():
    assert stats["steps_per_dispatch"] == k
    assert stats["global_step"] == 10
    steps = [line for line in lines if re.match(r"^\d+\timages/sec", line)]
    assert [int(line.split("\t")[0]) for line in steps] == list(range(1, 8))
    assert stats["compile_s"] > 0 and stats["dispatch_overhead_s"] > 0
  # Timed dispatches: 7 singles; 3 of 2 and one; one of 4 and 3 singles.
  assert [runs[k][0]["num_dispatches"] for k in (1, 2, 4)] == [7, 4, 4]


def test_k_is_clamped_to_the_run(monkeypatch):
  stats, _ = _bench(monkeypatch, steps_per_dispatch=16, num_batches=3)
  assert stats["steps_per_dispatch"] == 3 and stats["num_steps"] == 3


# -- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_dispatch_len_never_crosses_an_event(k):
  rng = np.random.default_rng(k)
  events = set(rng.choice(np.arange(1, 60), 12, replace=False).tolist())
  due = lambda s: s in events
  done = 0
  while done < 50:
    n = benchmark.dispatch_len(k, done, 50, due)
    assert 1 <= n <= min(k, 50 - done)
    assert not any(due(done + d) for d in range(1, n))
    if n < min(k, 50 - done):
      assert due(done + n)
    done += n
  assert done == 50


def test_saves_and_evals_land_on_their_steps(monkeypatch, tmp_path):
  saved = {}
  for k in (1, 4):
    steps = saved.setdefault(k, [])
    monkeypatch.setattr(
        benchmark.BenchmarkCNN, "_save_checkpoint",
        lambda self, module, step, incarnation_bump=0, steps=steps:
        steps.append(step.global_step))
    stats, lines = _bench(monkeypatch, steps_per_dispatch=k, num_batches=10,
                          train_dir=str(tmp_path / str(k)),
                          save_model_steps=3,
                          eval_during_training_every_n_steps=5)
    saved[k] = (steps, [e["step"] for e in stats["eval_results"]],
                stats["losses"])
  assert saved[1] == saved[4]
  # Warmup's 3 steps count toward the global step: saves after timed
  # steps 3, 6 and 9, and the final one.
  assert saved[4][0] == [6, 9, 12, 13] and saved[4][1] == [5, 10]


# -- validation ----------------------------------------------------------------

@pytest.mark.parametrize("flags", [dict(eval=True), dict(forward_only=True)])
def test_k_is_training_only_with_the_jax_message(flags):
  with pytest.raises(validation.ParamError) as got:
    validation.validate_cross_flags(port_params.make_params(
        steps_per_dispatch=4, **flags))
  with pytest.raises(jax_validation.ParamError) as want:
    jax_validation.validate_cross_flags(jax_params.make_params(
        steps_per_dispatch=4, **flags))
  assert str(got.value) == str(want.value)


def test_k_rules_of_the_port():
  with pytest.raises(ValueError):
    port_params.make_params(steps_per_dispatch=0)  # lower_bound=1
  for kw in (dict(steps_per_dispatch=8),
             dict(steps_per_dispatch=2, variable_update="parameter_server",
                  cross_replica_sync=False, optimizer="sgd"),
             # The sequential apply keeps the optimizer's counts on the
             # device, so a captured step replays them.
             dict(steps_per_dispatch=2, variable_update="parameter_server",
                  cross_replica_sync=False, optimizer="adam"),
             dict(steps_per_dispatch=4, num_grad_accum=2, batch_size=8),
             dict(steps_per_dispatch=4, use_fp16=True,
                  fp16_enable_auto_loss_scale=True)):
    validation.validate_cross_flags(port_params.make_params(device="cpu",
                                                            **kw))


_ASYNC_PS = {}


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_async_ps_chunk_is_bitwise_the_single_steps(optimizer,
                                                   tmp_path_factory):
  if not _ASYNC_PS:
    flags = dict(variable_update="parameter_server",
                 cross_replica_sync=False)
    cases = [dp_modes.case(f"{opt}_k{k}", "trivial", 2,
                           {**flags, "optimizer": opt}, steps=4, k=k)
             for opt in ("adam", "momentum") for k in (1, 4)]
    _ASYNC_PS.update(enumerate(dp_worker.run_world(
        2, cases, tmp_path_factory.mktemp("async_ps"))))
  for res in _ASYNC_PS.values():
    chunk, single = res[f"{optimizer}_k4"], res[f"{optimizer}_k1"]
    assert chunk["losses"] == single["losses"]
    assert torch.equal(chunk["weights"][-1], single["weights"][-1])
  singles = [r[f"{optimizer}_k1"] for r in _ASYNC_PS.values()]
  assert torch.equal(singles[0]["weights"][-1], singles[1]["weights"][-1])
  assert singles[0]["losses"][-1][0] < singles[0]["losses"][0][0]


# -- the lag-N pipeline (tests/test_pipeline.py, test_steps_per_dispatch.py) ---

def _drive(durations, lag=2, as_tensor=False):
  pipe = MetricsPipeline(lag=lag)
  pipe.reset_clock()
  done = []
  for i, d in enumerate(durations):
    time.sleep(d)
    loss = torch.tensor(float(i)) if as_tensor else float(i)
    done.extend(pipe.push(i + 1, {"total_loss": loss}))
  steady = [d.interval for d in done]
  done.extend(pipe.flush())
  return done, steady


@pytest.mark.parametrize("as_tensor", [False, True])
def test_completed_steps_cover_all_pushes_in_order(as_tensor):
  done, _ = _drive([0.001] * 7, lag=2, as_tensor=as_tensor)
  assert [d.index for d in done] == [1, 2, 3, 4, 5, 6, 7]
  assert [float(d.metrics["total_loss"]) for d in done] == \
      [float(i) for i in range(7)]


def test_uneven_steps_make_nonzero_jitter():
  _, intervals = _drive([0.005, 0.045] * 6)
  speed, uncertainty, jitter = log_util.get_perf_timing(64, intervals)
  assert speed > 0 and uncertainty > 0.0 and jitter > 0.0


def test_even_steps_make_small_jitter():
  _, intervals = _drive([0.030] * 10)
  speed, _, jitter = log_util.get_perf_timing(64, intervals[1:])
  assert jitter < 0.25 * speed


def test_aux_time_excluded_from_next_interval():
  pipe = MetricsPipeline(lag=0)
  pipe.reset_clock()
  pipe.push(1, {"loss": 1.0})
  time.sleep(0.05)
  pipe.note_aux_time(0.05)
  done = pipe.push(2, {"loss": 2.0})
  assert len(done) == 1 and done[0].interval < 0.04


def test_lag_keeps_at_most_lag_in_flight():
  pipe = MetricsPipeline(lag=3)
  pipe.reset_clock()
  resolved = []
  for i in range(5):
    resolved.extend(pipe.push(i + 1, {"loss": 0.0}))
  assert len(pipe) == 3
  assert [d.index for d in resolved] == [1, 2]
  assert [d.index for d in pipe.flush()] == [3, 4, 5]


def test_step_line_jitter_renders_nonzero():
  _, intervals = _drive([0.005, 0.045] * 5)
  line = log_util.format_step_line(10, 256, intervals, 1.234)
  m = re.search(r"jitter = ([\d.]+)", line)
  assert m and float(m.group(1)) > 0.0, line


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pipeline_chunk_push_unstacks_per_step(as_tensor):
  pipe = MetricsPipeline(lag=0)
  pipe.reset_clock()
  time.sleep(0.02)
  stacked = {"total_loss": np.arange(4, dtype=np.float32),
             "scalar_not_per_step": np.float32(7.0)}
  if as_tensor:
    stacked = {k: torch.from_numpy(np.asarray(v)) for k, v in stacked.items()}
  done = pipe.push(4, stacked, count=4)
  assert [d.index for d in done] == [1, 2, 3, 4]
  assert [float(d.metrics["total_loss"]) for d in done] == [0, 1, 2, 3]
  assert all(float(d.metrics["scalar_not_per_step"]) == 7.0 for d in done)
  assert all(d.chunk_len == 4 for d in done)
  assert len({d.chunk_interval for d in done}) == 1
  for d in done:
    assert d.interval == pytest.approx(d.chunk_interval / 4)
  assert [d.chunk_end for d in done] == [False, False, False, True]
  assert done[0].chunk_interval >= 0.015


def test_pipeline_chunk_lag_counts_dispatches():
  pipe = MetricsPipeline(lag=2)
  pipe.reset_clock()
  resolved = []
  for c in range(4):
    resolved.extend(
        pipe.push(3 * (c + 1), {"loss": np.arange(3.0)}, count=3))
  assert len(pipe) == 2
  assert [d.index for d in resolved] == [1, 2, 3, 4, 5, 6]
  assert [d.index for d in pipe.flush()] == [7, 8, 9, 10, 11, 12]


def test_pipeline_mixed_single_and_chunk_pushes():
  pipe = MetricsPipeline(lag=0)
  pipe.reset_clock()
  out = pipe.push(1, {"loss": np.float32(0.5)})
  out += pipe.push(4, {"loss": np.arange(3.0)}, count=3)
  out += pipe.push(5, {"loss": np.float32(4.0)})
  assert [d.index for d in out] == [1, 2, 3, 4, 5]
  assert [d.chunk_len for d in out] == [1, 3, 3, 3, 1]
  assert all(d.chunk_end for d in out if d.chunk_len == 1)
