"""The port's launcher, cluster wiring, coordination service and elastic
resize, on the CPU: elastic.py against the JAX package's, the adaptive
batch size and kfrun's checkpoint-restart over gloo (replicated, and the
ZeRO rescale of sharded optimizer state), and BASELINE config 4
(Inception-v3, KungFu pair averaging) at two ranks.

The rank functions below are spawned by torch.multiprocessing, which
imports this module in every rank: JAX is imported only inside the tests
that compare with it.
"""

import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch import cluster
from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import kfrun
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch.parallel import coordination
from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every subprocess wait of this file ends within this many seconds.
WAIT_S = 120

# Two ranks' gradients (two tensors each) for the noise-scale estimate.
_GRAD_SHAPES = ((3, 4), (5,))


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _grads(rank):
  rng = np.random.default_rng(100 + rank)
  return [rng.normal(size=s).astype(np.float32) for s in _GRAD_SHAPES]


def _spawn(fn, world, tmp_dir, *args):
  """Runs fn(rank, world, tmp_dir, *args) in ``world`` gloo ranks (a file
  store in tmp_dir); returns what each rank saved."""
  mp.spawn(_rank_main, args=(fn, world, str(tmp_dir)) + args, nprocs=world,
           join=True)
  return [torch.load(os.path.join(str(tmp_dir), f"rank{r}.pt"),
                     weights_only=False) for r in range(world)]


def _rank_main(rank, fn, world, tmp_dir, *args):
  torch.set_num_threads(1)
  mesh.init_process_group("cpu", world, rank,
                          "file://" + os.path.join(tmp_dir, "store"))
  try:
    out = fn(rank, world, tmp_dir, *args)
  finally:
    mesh.destroy_process_group()
  torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))


def _noise_rank(rank, world, tmp_dir, batch):
  g2, s = elastic.noise_scale_stats(
      [torch.from_numpy(g) for g in _grads(rank)], batch)
  return float(g2), float(s)


def test_noise_scale_stats_matches_jax(tmp_path):
  """noise_scale_stats at gloo world 2 against the JAX package's on a
  2-device virtual mesh, from the same per-rank gradients: (g2, s) equal
  to 1e-5 relative (f32 sums of squares in other orders), and the same on
  both ranks."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import Mesh, PartitionSpec as P
  from kf_benchmarks_tpu import elastic as jax_elastic
  got = _spawn(_noise_rank, 2, tmp_path, 4)
  assert got[0] == got[1]
  jmesh = Mesh(np.asarray(jax.devices()[:2]), ("replica",))

  def body(a, b):
    return jax_elastic.noise_scale_stats({"a": a, "b": b}, "replica",
                                         batch_size_per_replica=4)

  fn = jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=P("replica"),
                             out_specs=P()))
  stacked = [np.stack([_grads(r)[i] for r in range(2)])
             for i in range(len(_GRAD_SHAPES))]
  g2, s = fn(jnp.asarray(stacked[0]), jnp.asarray(stacked[1]))
  np.testing.assert_allclose(got[0], (float(g2), float(s)), rtol=1e-5)


def test_host_side_policies_match_jax():
  """NoiseScaleEMA, AdaptiveBatchPolicy and plan_resize give the JAX
  package's answers on the same inputs (exactly: the same float
  arithmetic)."""
  from kf_benchmarks_tpu import elastic as jax_elastic
  rng = np.random.default_rng(0)
  ema, jema = elastic.NoiseScaleEMA(0.8), jax_elastic.NoiseScaleEMA(0.8)
  for g2, s in list(rng.uniform(0.1, 10, (20, 2))) + [(float("nan"), 1.0),
                                                       (-1.0, 2.0)]:
    ema.update(float(g2), float(s))
    jema.update(float(g2), float(s))
    assert ema.b_simple == jema.b_simple
  policy = elastic.AdaptiveBatchPolicy(2, 64)
  jpolicy = jax_elastic.AdaptiveBatchPolicy(2, 64)
  for current in (2, 4, 8, 16, 64):
    for b_simple in (None, 0.0, 1.0, 3.0, 7.9, 33.0, 500.0, 4096.0):
      for n in (1, 2, 4):
        assert policy.propose(current, b_simple, n) == \
            jpolicy.propose(current, b_simple, n)
  for raw in range(1, 10):
    for procs in (1, 2, 3):
      for capacity in (1, 2, 4):
        for max_procs in (1, 2, 4, 8):
          assert elastic.plan_resize(raw, procs, capacity, max_procs) == \
              jax_elastic.plan_resize(raw, procs, capacity, max_procs)
  with pytest.raises(ValueError):
    elastic.AdaptiveBatchPolicy(4, 2)
  sched = elastic.ScheduledController({4: 2})
  assert sched.poll_at(2) is None and sched.poll_at(4) == 2
  assert sched.poll_at(4) is None


class _BigNoise(elastic.NoiseScaleEMA):
  """A noise scale forced large; counts the step estimates it is fed."""
  updates = 0

  def update(self, g2, s):
    type(self).updates += 1
    super().update(g2, s)

  @property
  def b_simple(self):
    return 4096.0


def _adaptive_rank(rank, world, tmp_dir):
  """BenchmarkCNN on the trivial model at per-device batch 4 with a noise
  scale forced large: the policy grows the batch one octave at the first
  poll. Records the state just before and just after the rebuild."""
  from test_torch_checkpoint import state_differences
  elastic.NoiseScaleEMA = _BigNoise
  seen = {}
  orig = benchmark.BenchmarkCNN._rebuild

  def rebuild(self, module, step, batch):
    before = checkpoint.savable_state(module, step.optimizer,
                                      step.global_step)
    out = orig(self, module, step, batch)
    after = checkpoint.savable_state(out[0], out[1].optimizer,
                                     out[1].global_step)
    seen["diff"] = state_differences(before, after)
    seen["batch_shape"] = tuple(out[2].shape)
    seen["momentum_buffers"] = len(after["optimizer"]["state"])
    return out

  benchmark.BenchmarkCNN._rebuild = rebuild
  p = params_lib.make_params(
      model="trivial", device="cpu", num_devices=world, batch_size=4,
      num_batches=8, num_warmup_batches=0, optimizer="momentum",
      variable_update="kungfu", adaptive_batch_size=True,
      adaptive_batch_min=2, adaptive_batch_max=64,
      elastic_check_every_n_steps=4)
  bench = benchmark.BenchmarkCNN(p)
  stats = bench.run()
  return {"stats": stats, "batch": bench.batch_size,
          "noise_updates": _BigNoise.updates, **seen}


def test_adaptive_batch_changes_batch_size(tmp_path):
  """The port's twin of tests/test_elastic.py::
  test_adaptive_batch_changes_batch_size, at gloo world 2: the noise-scale
  metrics flow, the step and the synthetic batch are rebuilt at per-device
  batch 8, and the weights, running averages, momentum buffers and step
  carry across the rebuild bit for bit."""
  for out in _spawn(_adaptive_rank, 2, tmp_path):
    stats = out["stats"]
    assert stats["reshape_events"], "expected an adaptive-batch reshape"
    assert stats["reshape_events"][0]["batch_size_per_device"] == 8
    assert stats["reshape_events"][0]["step"] == 4
    assert out["batch"] == 8 and stats["batch_size_per_device"] == 8
    assert out["batch_shape"][0] == 8
    assert out["diff"] == [] and out["momentum_buffers"] > 0
    assert stats["global_step"] == 8
    assert stats["grad_noise_scale"] == 4096.0
    assert out["noise_updates"] == 8  # one (g2, s) estimate a step


def test_kfcoord_source_is_the_native_one():
  with open(os.path.join(REPO, "native", "kfcoord.cc"), "rb") as f:
    native = f.read()
  with open(os.path.join(REPO, "kf_benchmarks_tpu_torch", "csrc",
                         "kfcoord.cc"), "rb") as f:
    assert f.read() == native


def test_run_barrier_rides_the_coordinator(monkeypatch):
  """With KFCOORD_* set, run_barrier joins the coordinator and waits in
  its kf_exit barrier for KFCOORD_WORLD workers; here the second is a
  thread that enters later."""
  with coordination.CoordinatorServer() as server:
    monkeypatch.setenv("KFCOORD_HOST", "127.0.0.1")
    monkeypatch.setenv("KFCOORD_PORT", str(server.port))
    monkeypatch.setenv("KFCOORD_WORLD", "2")
    monkeypatch.setenv("KFCOORD_NAME", "worker-0")

    def late():
      time.sleep(0.5)
      with coordination.CoordinatorClient(port=server.port) as c:
        c.join("worker-1")
        c.barrier("kf_exit", 2)

    t = threading.Thread(target=late)
    t0 = time.time()
    t.start()
    kungfu.run_barrier()
    assert time.time() - t0 >= 0.5
    t.join(timeout=WAIT_S)
    with coordination.CoordinatorClient(port=server.port) as c:
      assert c.cluster_size() == 2


def test_cluster_manager_rules(monkeypatch):
  """ps / controller roles and --ps_hosts are refused with the JAX
  package's messages; --worker_hosts is cut to KFCOORD_WORLD; the rank
  comes from KFCOORD_RANK_HINT."""
  for job in ("ps", "controller"):
    with pytest.raises(ValueError, match="has no TPU analog"):
      cluster.get_cluster_manager(params_lib.make_params(
          device="cpu", job_name=job))
  with pytest.raises(ValueError, match="ps_hosts set"):
    cluster.get_cluster_manager(params_lib.make_params(
        device="cpu", worker_hosts="a:1", ps_hosts="b:2"))
  assert cluster.get_cluster_manager(params_lib.make_params(
      device="cpu")) is None
  monkeypatch.setenv("KFCOORD_WORLD", "1")
  monkeypatch.setenv("KFCOORD_RANK_HINT", "0")
  manager = cluster.get_cluster_manager(params_lib.make_params(
      device="cpu", worker_hosts="127.0.0.1:1,127.0.0.1:2,127.0.0.1:3"))
  assert manager.worker_hosts == ["127.0.0.1:1"] and manager.rank == 0
  assert not mesh.is_distributed()
  assert cluster.process_rank() == 0
  monkeypatch.setenv("KFCOORD_RANK_HINT", "3")
  assert cluster.process_rank() == 3


def test_validation_takes_the_ported_flags():
  from kf_benchmarks_tpu_torch import validation
  validation.validate_cross_flags(params_lib.make_params(
      device="cpu", model="resnet152", train_dir="/tmp/x",
      save_model_steps=3, max_ckpts_to_keep=2, elastic=True,
      elastic_check_every_n_steps=5, track_grad_noise_scale=True,
      adaptive_batch_size=True, adaptive_batch_min=2,
      adaptive_batch_max=8, worker_hosts="127.0.0.1:1,127.0.0.1:2",
      task_index=1, sync_on_finish=True, variable_update="kungfu"))
  for flags, match in (
      (dict(save_model_steps=1, save_model_secs=1), "At most one of"),
      (dict(adaptive_batch_size=True, adaptive_batch_min=8,
            adaptive_batch_max=2), "search interval is empty"),
      (dict(variable_update="kungfu", job_name="worker"),
       "incompatible with --variable_update=kungfu"),
      (dict(worker_hosts="a:1", num_devices=2), "one rank driving"),
      (dict(elastic_check_every_n_steps=0), "below lower bound")):
    with pytest.raises(ValueError, match=match):
      validation.validate_cross_flags(params_lib.make_params(
          device="cpu", **flags))


@pytest.mark.parametrize("sync_on_finish", [False, True])
def test_exit_barrier_follows_sync_on_finish(monkeypatch, sync_on_finish):
  """As in the JAX package, the exit barrier runs only with
  --sync_on_finish."""
  calls = []
  monkeypatch.setattr(kungfu, "run_barrier", lambda: calls.append(1))
  benchmark.BenchmarkCNN(params_lib.make_params(
      model="trivial", device="cpu", batch_size=2, num_batches=1,
      num_warmup_batches=0, sync_on_finish=sync_on_finish)).run()
  assert calls == ([1] if sync_on_finish else [])


def _env():
  # One thread a worker: the workers share the host with other tests.
  return {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
          "OMP_NUM_THREADS": "1"}


def test_kfrun_spawns_workers_that_meet_at_the_barrier(tmp_path):
  """Two workers with KFCOORD_* env, logs named as kungfu-run names them;
  worker 0 leaves the exit barrier only after worker 1 enters it. Worker 0
  writes a marker file just before it enters; worker 1 waits for the
  marker and then sleeps one second, so worker 0 waits that second
  whichever process starts first."""
  marker = str(tmp_path / "rank0_at_barrier")
  script = ("import os, time; from kf_benchmarks_tpu_torch.parallel import "
            "kungfu; r = int(os.environ['KFCOORD_RANK_HINT']); "
            f"m = {marker!r}\n"
            "if r:\n"
            "  while not os.path.exists(m): time.sleep(0.01)\n"
            "  time.sleep(1.0)\n"
            "else:\n"
            "  open(m, 'w').close()\n"
            "t = time.time(); kungfu.run_barrier(); print('rank', r, 'of', "
            "os.environ['KFCOORD_WORLD'], 'waited', time.time() - t)")
  code = kfrun.launch(2, [sys.executable, "-c", script],
                      logdir=str(tmp_path), extra_env=_env())
  assert code == 0
  for i in range(2):
    with open(tmp_path / f"127.0.0.1.{10000 + i}.stdout.log") as f:
      out = f.read()
    assert f"rank {i} of 2 waited" in out, out
    assert os.path.exists(tmp_path / f"127.0.0.1.{10000 + i}.stderr.log")
  waited = float(open(tmp_path / "127.0.0.1.10000.stdout.log").read()
                 .split("waited")[1])
  assert waited >= 0.5


def test_kfrun_propagates_a_worker_failure(tmp_path):
  """Worker 1 exits 3 while worker 0 waits at the barrier: the launch
  ends with 3 and worker 0 is torn down."""
  script = ("import os, sys; from kf_benchmarks_tpu_torch.parallel import "
            "kungfu\nif os.environ['KFCOORD_RANK_HINT'] == '1': "
            "sys.exit(3)\nkungfu.run_barrier()")
  t0 = time.time()
  code = kfrun.launch(2, [sys.executable, "-c", script],
                      logdir=str(tmp_path), extra_env=_env())
  assert code == 3
  assert time.time() - t0 < WAIT_S


def test_kfrun_checkpoint_restart_2_to_1(tmp_path):
  """A RESIZE to one worker while two train (trivial model, kungfu
  sync_sgd over gloo): both checkpoint at the scheduled step and exit 42,
  kfrun relaunches one worker, which resumes at a later global step and
  finishes and passes the coordinator's exit barrier (--sync_on_finish);
  the launch exits 0. The appended log of worker 0 holds both
  generations."""
  coord_port = _free_port()
  train_dir = tmp_path / "train"
  logdir = tmp_path / "logs"
  logdir.mkdir()
  cmd = [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
         "--model=trivial", "--device=cpu", "--variable_update=kungfu",
         "--batch_size=2", "--num_batches=20", "--num_warmup_batches=1",
         "--display_every=1", "--elastic", "--elastic_check_every_n_steps=2",
         "--sync_on_finish", f"--train_dir={train_dir}",
         f"--worker_hosts=127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}"]
  result = {}
  t = threading.Thread(target=lambda: result.update(code=kfrun.launch(
      2, cmd, logdir=str(logdir), base_port=coord_port, extra_env=_env())))
  t.start()
  log = logdir / "127.0.0.1.10000.stdout.log"
  try:
    deadline = time.time() + WAIT_S
    while not log.exists() and time.time() < deadline:
      time.sleep(0.05)
    with coordination.CoordinatorClient(port=coord_port) as client:
      client.resize(1)
  finally:
    t.join(timeout=WAIT_S)
  assert not t.is_alive(), "kfrun did not finish"
  text = log.read_text()
  assert result.get("code") == 0, text
  assert re.search(r"Elastic restart at step 6: workers 2 -> 1", text), text
  restores = [int(s) for s in
              re.findall(r"Restored checkpoint at global step (\d+)", text)]
  # 1 warmup + 6 timed steps before the restart.
  assert restores == [7], text
  assert re.findall(r"Num devices: (\d+)", text) == ["2", "1"], text
  assert "total images/sec" in text.split("Restored checkpoint")[1]
  assert checkpoint.latest_checkpoint(str(train_dir))[1] == 7 + 1 + 20


def test_kfrun_zero_rescale_2_to_1(tmp_path):
  """The elastic ZeRO rescale through kfrun: two workers train the
  trivial model under --shard_optimizer_state (Nesterov momentum, each
  rank's momentum a 1/2 shard), a RESIZE to one worker checkpoints the
  (2, k) shard stacks at the scheduled step, and the relaunched worker
  resumes them re-sliced to (1, k) (checkpoint._reshard) and finishes:
  the checkpoints on either side of the restart hold (2, k) and (1, k)
  stacks (tests/test_torch_sharded.py holds the re-slice bitwise)."""
  coord_port = _free_port()
  train_dir = tmp_path / "train"
  logdir = tmp_path / "logs"
  logdir.mkdir()
  cmd = [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
         "--model=trivial", "--device=cpu", "--variable_update=replicated",
         "--shard_optimizer_state", "--optimizer=momentum",
         "--batch_size=2", "--num_batches=20", "--num_warmup_batches=1",
         "--display_every=1", "--elastic", "--elastic_check_every_n_steps=2",
         "--save_model_steps=40", "--max_ckpts_to_keep=0",
         "--sync_on_finish", f"--train_dir={train_dir}",
         f"--worker_hosts=127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}"]
  result = {}
  t = threading.Thread(target=lambda: result.update(code=kfrun.launch(
      2, cmd, logdir=str(logdir), base_port=coord_port, extra_env=_env())))
  t.start()
  log = logdir / "127.0.0.1.10000.stdout.log"
  try:
    deadline = time.time() + WAIT_S
    while not log.exists() and time.time() < deadline:
      time.sleep(0.05)
    with coordination.CoordinatorClient(port=coord_port) as client:
      client.resize(1)
  finally:
    t.join(timeout=WAIT_S)
  assert not t.is_alive(), "kfrun did not finish"
  text = log.read_text()
  assert result.get("code") == 0, text
  assert re.search(r"Elastic restart at step 6: workers 2 -> 1", text), text
  assert re.findall(r"Restored checkpoint at global step (\d+)", text) == \
      ["7"], text
  saved = checkpoint.load_checkpoint(str(train_dir / "model.ckpt-7.pt"))
  final = checkpoint.load_checkpoint(str(train_dir / "model.ckpt-28.pt"))
  for snap, n in ((saved, 2), (final, 1)):
    assert snap["opt_state_layout"] == "sharded"
    assert {v.shape[0] for st in snap["optimizer"]["state"].values()
            for v in st.values()} == {n}
  assert checkpoint.latest_checkpoint(str(train_dir))[1] == 7 + 1 + 20


def test_baseline_config_4_inception_pair_averaging_at_two_ranks(
    monkeypatch):
  """BASELINE config 4's command -- Inception-v3, --variable_update=kungfu
  --kungfu_option=async_sgd (pair averaging) -- at two gloo ranks on the
  CPU, batch 1, two steps (one warmup step), two threads in all."""
  monkeypatch.setenv("OMP_NUM_THREADS", "2")
  assert cli.main(["--model=inception3", "--variable_update=kungfu",
                   "--kungfu_option=async_sgd", "--device=cpu",
                   "--num_devices=2", "--batch_size=1", "--num_batches=2",
                   "--num_warmup_batches=1"]) == 0


def test_kfrun_cli_passes_the_restart_code_through(tmp_path, monkeypatch):
  """cli.main returns kfrun's RESTART_EXIT_CODE when the run checkpointed
  for a restart, and ``python -m ...kfrun`` exits with a worker's code."""
  monkeypatch.setattr(benchmark.BenchmarkCNN, "run",
                      lambda self: {"restart_for_resize": 1})
  for extra in ([], ["--worker_hosts=127.0.0.1:1"]):
    assert cli.main(["--model=trivial", "--device=cpu"] + extra) == \
        kfrun.RESTART_EXIT_CODE == 42
  out = subprocess.run(
      [sys.executable, "-m", "kf_benchmarks_tpu_torch.kfrun", "-np", "1",
       "--logdir", str(tmp_path), "--", sys.executable, "-c",
       "import sys; sys.exit(5)"], env={**os.environ, **_env()},
      capture_output=True, text=True, timeout=WAIT_S)
  assert out.returncode == 5, out.stderr
