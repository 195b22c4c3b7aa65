"""The port's training-health telemetry (kf_benchmarks_tpu_torch/
telemetry.py) on the CPU.

* The health vector against the JAX package's ``health_finalize(
  health_partials(...))`` on the same gradients, updates and parameters:
  grad_norm and update_ratio within 1e-5 relative, nonfinite_leaves,
  loss_scale and skipped exact -- as functions (with a NaN leaf and a
  skipped step among the cases), and on what one port train step applied
  (a clean step and one the auto loss scale skips).
* Inside the port, held against itself (the JAX package's own test of the
  collective count fails on this jax, so it is no oracle): at gloo world 2
  the vector equals world 1's within 1e-6 (both ranks on one batch, so
  the reduced gradients are world 1's); a step issues as many
  ``dist.all_reduce`` calls with the stats on as off, and its losses and
  weights are bitwise those of the stats-off step; K = 4 is bitwise four
  single steps.
* The flight recorder's files, dumps and triggers and the watchdog's
  never-kill rule, with the JAX package's tests/test_telemetry.py as the
  guide; the benchmark's session end to end (one recorder row a step).

The rank functions are spawned by torch.multiprocessing, which imports
this module in every rank: JAX is imported only inside the tests that
compare with it.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import metrics as metrics_lib
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import telemetry
from kf_benchmarks_tpu_torch import train_step
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import trivial_model
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.parallel import strategies

torch.set_num_threads(2)

# Leaves of the function-level cases: a conv kernel, a prime length, a
# matrix and a one-element leaf (the < n tail of the 1/n split).
SHAPES = ((4, 3, 3, 2), (7,), (5, 6), (1,))
NCLASS, BATCH, LR, WD = 10, 2, 0.01, 4e-5
RTOL = 1e-5


def _trees(seed, bad_leaf=None, bad=np.nan):
  rng = np.random.default_rng(seed)
  grads = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
  params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
  updates = [(rng.normal(size=s) * 1e-3).astype(np.float32) for s in SHAPES]
  if bad_leaf is not None:
    grads[bad_leaf].flat[1 % grads[bad_leaf].size] = bad
  return grads, params, updates


def _jax_health(grads, params, updates, loss_scale, skipped, suppressed):
  """The JAX package's vector: health_partials under a one-element named
  axis (its pmean is the identity), then health_finalize."""
  import jax
  import jax.numpy as jnp
  from kf_benchmarks_tpu import telemetry as jax_telemetry
  lead = lambda xs: [jnp.asarray(x)[None] for x in xs]
  parts = jax.vmap(
      lambda g, p, u: jax_telemetry.health_partials(g, p, u, "d"),
      axis_name="d")(lead(grads), lead(params), lead(updates))[0]
  return np.asarray(jax_telemetry.health_finalize(
      parts, jnp.float32(loss_scale), jnp.float32(skipped),
      jnp.float32(suppressed)))


def _port_health(grads, params, updates, loss_scale, skipped, suppressed):
  t = lambda xs: [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
  upd = telemetry.sumsq_partials(t(updates), 0, 1).sum()
  # What the train step runs (train_step.py TrainStep._update / .run).
  parts = telemetry.pack_partials(
      telemetry.sumsq_partials(t(grads), 0, 1), upd,
      telemetry.sumsq_partials(t(params), 0, 1).sum(), 1)
  return telemetry.health_finalize(parts, loss_scale, skipped,
                                   suppressed).numpy()


def _assert_health_close(got, ref):
  """grad_norm and update_ratio within RTOL relative (NaN where the other
  is NaN), the rest exact."""
  got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
  np.testing.assert_allclose(got[:2], ref[:2], rtol=RTOL, equal_nan=True)
  assert got[2:].tolist() == ref[2:].tolist(), (got, ref)


@pytest.mark.parametrize("case", ["clean", "nan_leaf", "inf_leaf",
                                  "skipped"])
def test_health_vector_matches_jax(case):
  bad = {"clean": (None, np.nan), "nan_leaf": (1, np.nan),
         "inf_leaf": (3, np.inf), "skipped": (0, np.inf)}[case]
  grads, params, updates = _trees(7, *bad)
  scale, skip = (32.0, 1.0) if case == "skipped" else (1.0, 0.0)
  if case == "skipped":
    updates[0].flat[0] = np.inf  # the would-be update of a skipped step
  ref = _jax_health(grads, params, updates, scale, skip, skip)
  got = _port_health(grads, params, updates, scale, skip, skip)
  _assert_health_close(got, ref)
  assert got[2] == (0 if case == "clean" else 1)
  if case == "skipped":
    assert got[1] == 0.0 and got[4] == 1.0 and got[3] == 32.0


@pytest.mark.parametrize("num", [2, 3, 4])
def test_row_split_matches_jax(num):
  """Rank i's partial square sum of each leaf is the JAX package's
  ``_sharded_sumsq`` of rank i (row i of (num, size // num), the tail on
  rank 0), and the ranks' partials add up to the whole sum."""
  import jax.numpy as jnp
  from kf_benchmarks_tpu import telemetry as jax_telemetry
  grads, _, _ = _trees(3)
  leaves = [torch.from_numpy(g) for g in grads]
  whole = telemetry.sumsq_partials(leaves, 0, 1).numpy()
  total = np.zeros_like(whole)
  for i in range(num):
    got = telemetry.sumsq_partials(leaves, i, num).numpy()
    ref = [float(jax_telemetry._sharded_sumsq(jnp.asarray(g), i, num))
           for g in grads]
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    total += got
  np.testing.assert_allclose(total, whole, rtol=1e-6)


def test_channels_last_leaf_is_read_in_place():
  """A channels_last weight (the ResNet's convs) is split in memory order
  without a copy, to the same square sum."""
  w = torch.randn(8, 4, 3, 3).to(memory_format=torch.channels_last)
  flat = telemetry._flat(w)
  assert flat.data_ptr() == w.data_ptr() and flat.numel() == w.numel()
  np.testing.assert_allclose(
      float(telemetry.sumsq_partials([w], 0, 1)[0]),
      float((w.double() ** 2).sum()), rtol=1e-6)


# -- one port train step, its applied values held in JAX --------------------------

def _trivial_step(health=True, auto_scale=False, scale=1.0, seed=0,
                  strategy=None):
  model = trivial_model.TrivialModel()
  g = torch.Generator().manual_seed(seed)
  module = model.make_module(NCLASS, torch.float32, generator=g)
  p = params_lib.make_params(device="cpu", optimizer="sgd")
  opt = optimizers.get_optimizer(p, module.parameters())
  return train_step.TrainStep(
      model, module, opt, lambda c: LR, WD, strategy=strategy,
      loss_scale=scale, auto_loss_scale=auto_scale, health_stats=health)


def _batch(seed=1):
  rng = np.random.default_rng(seed)
  images = np.clip(rng.normal(size=(BATCH, 227, 227, 3)), -2, 2) * 60 + 127
  return (torch.from_numpy(images.astype(np.float32)),
          torch.from_numpy(rng.integers(0, NCLASS, BATCH)).long())


@pytest.mark.parametrize("skipped", [False, True], ids=["clean", "skipped"])
def test_step_health_matches_jax_on_what_it_applied(skipped):
  """One SGD step: the gradients it applied (left in ``.grad``), the
  weights before it, and its update -lr * g, fed to the JAX functions.
  The skipped case starts at an infinite loss scale: non-finite
  gradients, the update suppressed, the weights kept, the scale halved
  (and still infinite)."""
  step = _trivial_step(auto_scale=skipped,
                       scale=float("inf") if skipped else 1.0)
  before = [q.detach().numpy().copy() for q in step.module.parameters()]
  x, y = _batch()
  health = step(x, y)["health"].numpy()
  grads = [q.grad.numpy().copy() for q in step.module.parameters()]
  updates = [g * np.float32(-LR) for g in grads]
  scale = np.float32(np.inf) if skipped else 1.0
  ref = _jax_health(grads, before, updates, scale, float(skipped),
                    float(skipped))
  _assert_health_close(health, ref)
  if skipped:
    assert health[2] > 0 and health[1] == 0.0 and health[4] == 1.0
    after = [q.detach().numpy() for q in step.module.parameters()]
    assert all(np.array_equal(a, b) for a, b in zip(after, before))
  else:
    assert health[1] > 0 and health[2] == 0 and health[4] == 0


def test_chunk_of_four_is_bitwise_four_single_steps():
  x, y = _batch()
  single = _trivial_step()
  rows = [single(x, y)["health"] for _ in range(4)]
  chunked = train_step.TrainChunk(_trivial_step(), 4)(x, y, 4)["health"]
  assert chunked.shape == (4, len(telemetry.HEALTH_KEYS))
  assert torch.equal(chunked, torch.stack(rows))


def test_stats_change_no_loss_and_no_weight():
  x, y = _batch()
  on, off = _trivial_step(True), _trivial_step(False)
  for _ in range(2):
    m_on, m_off = on(x, y), off(x, y)
    assert torch.equal(m_on["total_loss"], m_off["total_loss"])
  for a, b in zip(on.module.parameters(), off.module.parameters()):
    assert torch.equal(a, b)


@pytest.mark.parametrize("opt", ["momentum", "rmsprop", "adam", "lars"])
def test_optimizers_note_their_update(opt):
  """Each optimizer's ``update_sq`` is the square sum of the change it
  made to the weights (f64 weights, so the difference of two weights
  rounds far below the limit: LARS moves them by 1e-4 relative)."""
  torch.manual_seed(0)
  w = [torch.nn.Parameter(torch.randn(5, 3, dtype=torch.float64)),
       torch.nn.Parameter(torch.randn(4, dtype=torch.float64))]
  p = params_lib.make_params(device="cpu", optimizer=opt)
  o = optimizers.get_optimizer(p, w)
  o.track_update(0, 1)
  for group in o.param_groups:
    group["lr"] = torch.tensor(0.1, dtype=torch.float64)
  for _ in range(2):
    before = [q.detach().clone() for q in w]
    for q in w:
      q.grad = torch.randn_like(q)
    o.step()
    moved = sum(float(((q.detach() - b).double() ** 2).sum())
                for q, b in zip(w, before))
    np.testing.assert_allclose(float(o.update_sq), moved, rtol=1e-5)


# -- world 2 against world 1, and the collective count ---------------------------

def _count_all_reduce(fn):
  calls = [0]
  real = dist.all_reduce

  def counting(*a, **k):
    calls[0] += 1
    return real(*a, **k)

  dist.all_reduce = counting
  try:
    out = fn()
  finally:
    dist.all_reduce = real
  return out, calls[0]


def _world_rank(rank, world, tmp_dir):
  torch.set_num_threads(1)
  mesh.init_process_group("cpu", world, rank,
                          "file://" + os.path.join(tmp_dir, "store"))
  try:
    x, y = _batch()
    out = {}
    for health in (False, True):
      strategy = strategies.get_strategy(params_lib.make_params(
          device="cpu", num_devices=world))
      step = _trivial_step(health=health, strategy=strategy)
      m, calls = _count_all_reduce(lambda: step(x, y))
      out[health] = {"calls": calls, "metrics": m,
                     "weights": [q.detach().clone()
                                 for q in step.module.parameters()]}
  finally:
    mesh.destroy_process_group()
  torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))


def test_world_two_equals_world_one_with_no_extra_collective(tmp_path):
  mp.spawn(_world_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
  ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
  x, y = _batch()
  one = _trivial_step()(x, y)["health"].numpy()
  for r in ranks:
    assert r[True]["calls"] == r[False]["calls"] >= 1, (
        r[True]["calls"], r[False]["calls"])
    assert torch.equal(r[True]["metrics"]["total_loss"],
                       r[False]["metrics"]["total_loss"])
    for a, b in zip(r[True]["weights"], r[False]["weights"]):
      assert torch.equal(a, b)
    np.testing.assert_allclose(r[True]["metrics"]["health"].numpy(), one,
                               rtol=1e-6)
  assert torch.equal(ranks[0][True]["metrics"]["health"],
                     ranks[1][True]["metrics"]["health"])


# -- resolve and validation ------------------------------------------------------

def test_resolve_and_validation_follow_the_jax_package(tmp_path):
  """resolve_health_stats and the --health_stats refusals give the JAX
  package's decisions, notes and messages."""
  from kf_benchmarks_tpu import params as jax_params
  from kf_benchmarks_tpu import telemetry as jax_telemetry
  from kf_benchmarks_tpu import validation as jax_validation
  train_dir = str(tmp_path)
  for kw in [{}, dict(train_dir=train_dir), dict(health_stats=False,
                                                 train_dir=train_dir),
             dict(health_stats=True),
             dict(variable_update="kungfu", kungfu_option="async_sgd",
                  train_dir=train_dir),
             dict(variable_update="independent", train_dir=train_dir),
             dict(shard_optimizer_state=True, train_dir=train_dir),
             dict(forward_only=True, train_dir=train_dir)]:
    port = telemetry.resolve_health_stats(
        params_lib.make_params(device="cpu", **kw))
    ref = jax_telemetry.resolve_health_stats(jax_params.make_params(**kw))
    assert port == ref, kw
  for kw in [dict(health_stats=True, forward_only=True),
             dict(health_stats=True, variable_update="independent"),
             dict(health_stats=True, variable_update="kungfu",
                  kungfu_option="sma"),
             dict(health_stats=True, variable_update="parameter_server",
                  cross_replica_sync=False)]:
    with pytest.raises(validation.ParamError) as got:
      validation.validate_cross_flags(params_lib.make_params(device="cpu",
                                                             **kw))
    with pytest.raises(jax_validation.ParamError) as ref:
      jax_validation.validate_cross_flags(jax_params.make_params(**kw))
    assert str(got.value) == str(ref.value)


def test_health_keys_are_the_jax_package_s():
  from kf_benchmarks_tpu import metrics as jax_metrics
  assert metrics_lib.HEALTH_KEYS == jax_metrics.HEALTH_KEYS
  assert metrics_lib.HEALTH_SUMMARY_KEYS == jax_metrics.HEALTH_SUMMARY_KEYS
  assert metrics_lib.health_key("grad_norm") == \
      jax_metrics.health_key("grad_norm")


# -- flight recorder ---------------------------------------------------------------

def _health_vec(grad_norm=1.0, ratio=1e-3, nonfinite=0.0, loss_scale=1.0,
                skipped=0.0):
  return np.asarray([grad_norm, ratio, nonfinite, loss_scale, skipped],
                    np.float32)


def test_flight_recorder_window_file_holds_newest_tail(tmp_path):
  path = str(tmp_path / "missing_dir" / "flight_recorder.jsonl")
  rec = telemetry.FlightRecorder(path=path, window=16, log_fn=lambda s: None,
                                 run_id="run-x")
  for i in range(100):
    rec.record(step=i + 1, loss=1.0, health=_health_vec())
  rows = [json.loads(l) for l in open(path)]
  assert [r["step"] for r in rows] == list(range(85, 101))
  assert rows[-1]["health/grad_norm"] == 1.0 and rows[-1]["rank"] == 0
  assert rows[-1]["run_id"] == "run-x"
  assert not os.path.exists(str(tmp_path / "missing_dir" /
                                "flight_recorder.dump.jsonl"))
  s = rec.summary()
  assert (s["records"], s["nonfinite_steps"], s["anomaly_dumps"]) == \
      (16, 0, 0)


def test_flight_recorder_nonfinite_dump_is_edge_triggered(tmp_path):
  logs = []
  rec = telemetry.FlightRecorder(path=str(tmp_path / "fr.jsonl"), window=8,
                                 log_fn=logs.append)
  for i in range(5):
    rec.record(step=i + 1, loss=1.0, health=_health_vec())
  rec.record(step=6, loss=float("nan"), health=_health_vec(nonfinite=3.0))
  rows = [json.loads(l)
          for l in open(str(tmp_path / "flight_recorder.dump.jsonl"))]
  assert "non-finite" in rows[0]["flight_recorder_dump"]
  assert [r["step"] for r in rows[1:]
          if r.get("health/nonfinite_leaves", 0) > 0] == [6]
  assert any("flight recorder: non-finite" in l for l in logs)
  rec.record(step=7, loss=float("nan"), health=_health_vec(nonfinite=3.0))
  assert rec.summary()["anomaly_dumps"] == 1
  assert rec.summary()["nonfinite_steps"] == 2
  rec.record(step=8, loss=1.0, health=_health_vec())
  rec.record(step=9, loss=float("inf"), health=_health_vec(nonfinite=1.0))
  assert rec.summary()["anomaly_dumps"] == 2


def test_flight_recorder_sigma_spike_and_halving_streak(tmp_path):
  logs = []
  rec = telemetry.FlightRecorder(path=str(tmp_path / "fr.jsonl"), window=32,
                                 sigma=6.0, log_fn=logs.append)
  for i in range(16):
    rec.record(step=i + 1, loss=1.0,
               health=_health_vec(grad_norm=1.0 + 0.01 * (i % 4)))
  rec.record(step=17, loss=1.0, health=_health_vec(grad_norm=1.05))
  assert not any("spike" in l for l in logs)
  rec.record(step=18, loss=1.0, health=_health_vec(grad_norm=50.0))
  assert sum("grad-norm spike" in l for l in logs) == 1
  assert rec.summary()["max_grad_norm"] == 50.0
  logs.clear()
  streak = telemetry.FlightRecorder(log_fn=logs.append)
  scale = 1024.0
  streak.record(step=1, loss=1.0, health=_health_vec(loss_scale=scale))
  for i in range(2, 6):
    scale /= 2
    streak.record(step=i, loss=1.0,
                  health=_health_vec(loss_scale=scale, skipped=1.0))
  assert sum("loss-scale collapse" in l for l in logs) == 1
  assert streak.summary()["loss_scale_final"] == scale


def test_flight_recorder_signal_dump_chains_the_previous_handler(tmp_path):
  rec = telemetry.FlightRecorder(path=str(tmp_path / "fr.jsonl"), window=8,
                                 log_fn=lambda s: None)
  rec.record(step=1, loss=1.0, health=_health_vec())
  before = signal.getsignal(signal.SIGINT)
  rec.install_signal_handlers()
  with pytest.raises(KeyboardInterrupt):
    signal.raise_signal(signal.SIGINT)
  rows = [json.loads(l)
          for l in open(str(tmp_path / "flight_recorder.dump.jsonl"))]
  assert rows[0]["flight_recorder_dump"] == "signal SIGINT"
  assert rows[1]["step"] == 1
  rec.close()
  assert signal.getsignal(signal.SIGINT) == before


def test_aggregate_rank_windows(tmp_path):
  for rank in (0, 1, 2):
    with open(telemetry.flight_recorder_path(str(tmp_path), rank), "w") as f:
      for step in (rank + 1, rank + 4):
        f.write(json.dumps({"step": step, "rank": rank}) + "\n")
  with open(str(tmp_path / "flight_recorder.dump.jsonl"), "w") as f:
    f.write(json.dumps({"flight_recorder_dump": "x"}) + "\n")
  merged = telemetry.aggregate_rank_windows(str(tmp_path))
  assert [(r["step"], r["rank"]) for r in merged] == \
      [(1, 0), (2, 1), (3, 2), (4, 0), (5, 1), (6, 2)]


# -- stall watchdog -----------------------------------------------------------------

def test_watchdog_patient_before_the_first_dispatch():
  logs = []
  wd = telemetry.StallWatchdog(factor=3.0, patience_s=10.0, min_stall_s=0.0,
                               log_fn=logs.append, time_fn=lambda: 0.0)
  wd._check(11.0)
  wd._check(12.0)
  assert wd.stalls == 0
  assert sum("staying patient" in l for l in logs) == 1
  wd._check(25.0)
  assert sum("staying patient" in l for l in logs) == 2


def test_watchdog_diagnoses_once_an_episode_and_never_kills():
  logs = []
  rec = telemetry.FlightRecorder(log_fn=logs.append)
  rec.record(step=7, loss=1.25, health=_health_vec())
  t = [0.0]
  wd = telemetry.StallWatchdog(factor=3.0, min_stall_s=0.0,
                               log_fn=logs.append, recorder=rec,
                               time_fn=lambda: t[0])
  wd.beat(0.1)
  wd._check(0.2)
  assert wd.stalls == 0
  wd._check(1.0)
  wd._check(2.0)
  assert wd.stalls == 1
  diag = [l for l in logs if "stall watchdog:" in l]
  assert any("NOT killing the process" in l for l in diag)
  assert any('"step": 7' in l for l in diag)
  t[0] = 2.0
  wd.beat(0.1)
  wd._check(3.5)
  assert wd.stalls == 2
  assert not any("SIGKILL" in l or "terminat" in l for l in diag)


def test_watchdog_thread_stalls_and_survives_a_failing_check():
  logs = []
  wd = telemetry.StallWatchdog(factor=2.0, poll_s=0.01, min_stall_s=0.05,
                               log_fn=logs.append)
  wd.start()
  wd.beat(0.01)
  time.sleep(0.5)
  wd.stop()
  assert wd.stalls >= 1
  calls = []

  def boom(now):
    calls.append(now)
    if len(calls) == 1:
      raise OSError("sink down")

  wd2 = telemetry.StallWatchdog(factor=2.0, poll_s=0.01, log_fn=logs.append)
  wd2._check = boom
  wd2.start()
  deadline = time.time() + 5.0
  while len(calls) < 3 and time.time() < deadline:
    time.sleep(0.01)
  wd2.stop()
  assert len(calls) >= 3 and any("check failed" in l for l in logs)
  off = telemetry.StallWatchdog(factor=0.0)
  off.start()
  assert off._thread is None and not off.enabled


# -- the benchmark's session --------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_benchmark_writes_one_row_a_step_and_the_run_end_dump(tmp_path, k):
  """The trivial model through BenchmarkCNN with --train_dir (auto-on): one
  recorder row per timed step (global steps 2..9 after one warmup step),
  each with the health keys, and the run-end dump; the stats carry the
  summary. At K = 4 the rows and losses are those of K = 1."""
  train_dir = str(tmp_path / "run")
  logs = []
  orig = benchmark.log_fn
  benchmark.log_fn = logs.append
  try:
    stats = benchmark.BenchmarkCNN(params_lib.make_params(
        model="trivial", device="cpu", batch_size=2, num_batches=8,
        num_warmup_batches=1, steps_per_dispatch=k,
        train_dir=train_dir)).run()
  finally:
    benchmark.log_fn = orig
  rows = [json.loads(l)
          for l in open(os.path.join(train_dir, "flight_recorder.jsonl"))]
  assert [r["step"] for r in rows] == list(range(2, 10))
  assert all(metrics_lib.health_key(key) in r for r in rows
             for key in telemetry.HEALTH_KEYS)
  assert [r["loss"] for r in rows] == stats["losses"]
  dump = [json.loads(l) for l in
          open(os.path.join(train_dir, "flight_recorder.dump.jsonl"))]
  assert dump[0]["flight_recorder_dump"] == "run end"
  assert sum("flight recorder: run end" in l for l in logs) == 1
  assert stats["health"]["records"] == 8
  assert stats["health"]["max_grad_norm"] == max(
      r["health/grad_norm"] for r in rows)
  assert stats["health_stats"] is True
