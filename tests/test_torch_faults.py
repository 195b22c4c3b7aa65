"""The port's fault injection (kf_benchmarks_tpu_torch/faults.py) and the
recovery path (kfrun --restart-on-failure) on the CPU.

* ``parse_schedule`` agrees with the JAX package's on valid schedules and
  refuses the malformed ones of tests/test_faults.py with the same
  messages; the --fault_schedule rules carry the JAX package's messages.
* The injector: its rank filter, the one-shot marker written before a
  fault fires (read by the next generation), corrupt_ckpt's truncation of
  the newest checkpoint.
* In the benchmark: drop_msg delays a pending restart by one poll and
  never loses it; heartbeat_delay starves the watchdog, which diagnoses
  and never kills; sigterm leaves the flight recorder's post-mortem and
  the process ends by its SIGTERM.
* kfrun: --restart-on-failure relaunches a generation whose worker died
  at the same world size, never resurrects 0 or 130, keeps one KF_RUN_ID
  for the job, and reports a dead worker's own code, not the SIGTERM of
  the teardown. A kill and rejoin of the trivial model with
  ``corrupt_ckpt@6,kill@7`` (and with both at step 7, where the rejoin
  skips the torn newest file) ends bitwise equal to an uninterrupted run
  of as many steps.
"""

import json
import os
import re
import signal
import subprocess
import sys

import pytest
import torch

from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import faults
from kf_benchmarks_tpu_torch import kfrun
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import validation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120

VALID = ["kill@10:rank=1,sigterm@6,heartbeat_delay@5:secs=2.5,drop_msg@8,"
         "corrupt_ckpt@4", "", "corrupt_ckpt@6,kill@7", " kill@3 , ",
         "heartbeat_delay@2"]
# tests/test_faults.py:56's malformed schedules.
MALFORMED = ["explode@4", "kill@x", "kill@0", "kill", "kill@4:rank=one",
             "kill@4:depth=2"]


def _env():
  return {**os.environ,
          "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
          "OMP_NUM_THREADS": "1"}


@pytest.mark.parametrize("spec", VALID)
def test_parse_schedule_agrees_with_jax(spec):
  from kf_benchmarks_tpu import faults as jax_faults
  assert [tuple(f) for f in faults.parse_schedule(spec)] == \
      [tuple(f) for f in jax_faults.parse_schedule(spec)]
  assert [f.describe() for f in faults.parse_schedule(spec)] == \
      [f.describe() for f in jax_faults.parse_schedule(spec)]


@pytest.mark.parametrize("bad", MALFORMED)
def test_parse_schedule_refuses_what_jax_refuses(bad):
  from kf_benchmarks_tpu import faults as jax_faults
  with pytest.raises(faults.FaultScheduleError) as got:
    faults.parse_schedule(bad)
  with pytest.raises(jax_faults.FaultScheduleError) as ref:
    jax_faults.parse_schedule(bad)
  assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(fault_schedule="explode@4"),
    dict(fault_schedule="corrupt_ckpt@4"),
    dict(fault_schedule="kill@4:rank=1"),
    dict(fault_schedule="drop_msg@4", train_dir="/tmp/d"),
    dict(fault_schedule="heartbeat_delay@4"),
    dict(fault_schedule="heartbeat_delay@4", train_dir="/tmp/d",
         stall_watchdog_factor=0.0),
    dict(fault_schedule="kill@4", forward_only=True, train_dir="/tmp/d"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_fault_rules_carry_the_jax_message(kw):
  from kf_benchmarks_tpu import params as jax_params
  from kf_benchmarks_tpu import validation as jax_validation
  with pytest.raises(validation.ParamError) as got:
    validation.validate_cross_flags(params_lib.make_params(device="cpu",
                                                           **kw))
  with pytest.raises(jax_validation.ParamError) as ref:
    jax_validation.validate_cross_flags(jax_params.make_params(**kw))
  assert str(got.value) == str(ref.value)


def test_rank_filter_and_one_shot_across_generations(tmp_path):
  sched = faults.parse_schedule("kill@10:rank=1,drop_msg@3,"
                                "heartbeat_delay@5:secs=0")
  inj0 = faults.FaultInjector(sched, rank=0, state_dir=str(tmp_path))
  inj1 = faults.FaultInjector(sched, rank=1)
  assert inj0.due(3) and not inj0.due(10)
  assert [f.kind for f in inj1.peek_due(10)] == ["kill"]
  fired = inj0.fire_due(3)
  assert fired.dropped_message and [f.kind for f in fired.fired] == [
      "drop_msg"]
  assert os.path.exists(tmp_path / "faults_fired.rank0.json")
  again = faults.FaultInjector(sched, rank=0, state_dir=str(tmp_path))
  assert not again.due(3) and again.due(5)
  assert again.fire_due(3).fired == []


def test_corrupt_ckpt_truncates_the_newest_checkpoint(tmp_path):
  (tmp_path / "model.ckpt-2.pt").write_bytes(b"x" * 100)
  (tmp_path / "model.ckpt-4.pt").write_bytes(b"y" * 100)
  faults.FaultInjector(faults.parse_schedule("corrupt_ckpt@4")).fire_due(
      4, train_dir=str(tmp_path))
  assert (tmp_path / "model.ckpt-4.pt").stat().st_size == 50
  assert (tmp_path / "model.ckpt-2.pt").stat().st_size == 100


# -- in the benchmark --------------------------------------------------------------

class _PendingResize:
  """A coordinator with one RESIZE pending: poll() consumes it; the
  scheduled-restart key lives here."""

  def __init__(self, target):
    self.target = target
    self.last_raw_target = None
    self.sched = None

  def poll(self):
    t, self.target = self.target, None
    self.last_raw_target = t or self.last_raw_target
    return None if t is None else 1

  def scheduled_restart(self):
    return self.sched

  def schedule_restart(self, step, target_np):
    self.sched = (step, target_np)

  def restart_barrier(self, name, count):
    pass

  def generation(self):
    return 0

  def close(self):
    pass


def _bench(monkeypatch, controller=None, **kw):
  logs = []
  monkeypatch.setattr(benchmark, "log_fn", logs.append)
  if controller is not None:
    monkeypatch.setattr(elastic.ElasticController, "from_env",
                        classmethod(lambda cls, max_devices: controller))
  flags = dict(model="trivial", device="cpu", batch_size=2,
               num_warmup_batches=0, display_every=1)
  flags.update(kw)
  stats = benchmark.BenchmarkCNN(params_lib.make_params(**flags)).run()
  return logs, stats


@pytest.mark.parametrize("schedule,restart_at", [(None, 12),
                                                 ("drop_msg@3", 16)],
                         ids=["no_drop", "drop_msg"])
def test_drop_msg_delays_a_restart_by_one_poll(monkeypatch, tmp_path,
                                               schedule, restart_at):
  """A RESIZE to 2 workers is pending from the start; polls run every 4
  steps and a restart is scheduled two polls after the poll that sees
  it. The dropped poll (step 4, after a fault at step 3) moves the
  restart from step 12 to 16: delayed, not lost."""
  extra = {"fault_schedule": schedule} if schedule else {}
  logs, stats = _bench(
      monkeypatch, _PendingResize(2), num_batches=20, elastic=True,
      elastic_check_every_n_steps=4, train_dir=str(tmp_path / "run"),
      worker_hosts=["127.0.0.1:1", "127.0.0.1:2"], **extra)
  assert stats["restart_for_resize"] == 2
  assert any(f"Elastic restart at step {restart_at}: workers 1 -> 2" in l
             for l in logs), logs
  dropped = [l for l in logs if "fault drop_msg" in l]
  assert dropped == (["fault drop_msg: coordination poll at step 4 "
                      "dropped; a pending resize stays pending"]
                     if schedule else [])


@pytest.mark.parametrize("world,flags", [
    (1, dict(hierarchical_copy=True)),
    (2, dict(hierarchical_copy=True)),
    (32, dict(variable_update="parameter_server", cross_replica_sync=False,
              optimizer="momentum")),
    (33, dict(variable_update="parameter_server", cross_replica_sync=False,
              optimizer="momentum")),
])
def test_rules_count_kfrun_workers_as_jax_counts_devices(world, flags):
  """The rules that count devices (--hierarchical_copy's two, the async
  parameter_server cap) read a --worker_hosts job of ``world`` kfrun
  workers, each at --num_devices=1, as the JAX package reads
  --num_devices=world (its one mesh spans every worker): the same verdict
  and the same message, spawned ranks or workers."""
  from kf_benchmarks_tpu import params as jax_params
  from kf_benchmarks_tpu import validation as jax_validation

  def verdict(check, error, params):
    try:
      check(params)
    except error as e:
      return str(e)
    return None

  want = verdict(jax_validation.validate_cross_flags,
                 jax_validation.ParamError,
                 jax_params.make_params(num_devices=world, **flags))
  hosts = ["127.0.0.1:%d" % (1000 + i) for i in range(world)]
  for port in (params_lib.make_params(device="cpu", num_devices=world,
                                      **flags),
               params_lib.make_params(device="cpu", worker_hosts=hosts,
                                      **flags)):
    assert verdict(validation.validate_cross_flags, validation.ParamError,
                   port) == want
  assert (want is None) == (world in (2, 32))


@pytest.mark.parametrize("hierarchical", [False, True])
def test_a_target_the_flags_refuse_is_refused_at_poll_time(
    monkeypatch, tmp_path, hierarchical):
  """benchmark.refuse_restart_target holds a polled target to the startup rules at
  that world. A ZeRO world of any size is admitted (the shard stacks
  re-slice exactly); a --hierarchical_copy job of two workers is refused
  a restart at one (it needs two) -- in the run, at the poll, which logs
  it and keeps the world. The job's two workers are this process with
  its world size set to 2 (no process group: the strategy's hooks stand
  down)."""
  zero = params_lib.make_params(device="cpu", shard_optimizer_state=True,
                                elastic=True)
  assert benchmark.refuse_restart_target(zero, 1) is None
  assert benchmark.refuse_restart_target(zero, 7) is None
  logs = []
  monkeypatch.setattr(benchmark, "log_fn", logs.append)
  controller = _PendingResize(1)
  monkeypatch.setattr(elastic.ElasticController, "from_env",
                      classmethod(lambda cls, max_devices: controller))
  bench = benchmark.BenchmarkCNN(params_lib.make_params(
      model="trivial", device="cpu", batch_size=2, num_warmup_batches=0,
      num_batches=16, elastic=True, elastic_check_every_n_steps=4,
      train_dir=str(tmp_path / "run"), hierarchical_copy=hierarchical,
      worker_hosts=["127.0.0.1:1", "127.0.0.1:2"]))
  bench.world_size = 2
  stats = bench.run()
  if hierarchical:
    assert stats["restart_for_resize"] is None
    assert any("Elastic restart to 1 worker(s) rejected" in l and
               "requires more than one device" in l for l in logs), logs
  else:
    assert stats["restart_for_resize"] == 1
    assert not any("rejected" in l for l in logs)


def test_heartbeat_delay_starves_the_watchdog_which_never_kills(
    monkeypatch, tmp_path):
  """A 6 s heartbeat gap (past the watchdog's 5 s floor): a diagnostic,
  a counted stall, the fault's row in the recorder, and the run ends."""
  train_dir = str(tmp_path / "run")
  logs, stats = _bench(monkeypatch, num_batches=8, train_dir=train_dir,
                       stall_watchdog_factor=0.1,
                       fault_schedule="heartbeat_delay@4:secs=6")
  assert any("fault injected: heartbeat_delay 6s at step 4" in l
             for l in logs)
  assert any("stall watchdog: no dispatch completed for" in l and
             "NOT killing" in l for l in logs), logs
  assert stats["num_steps"] == 8
  assert stats["health"]["watchdog_stalls"] >= 1
  with open(os.path.join(train_dir, "flight_recorder.jsonl")) as f:
    rows = [json.loads(l) for l in f if l.strip()]
  assert any(r.get("fault_event", "").startswith("heartbeat_delay")
             for r in rows), rows


def _cli(train_dir, *extra, num_batches=9):
  return [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
          "--model=trivial", "--device=cpu", "--batch_size=2",
          f"--num_batches={num_batches}", "--num_warmup_batches=0",
          "--display_every=1", "--optimizer=momentum",
          f"--train_dir={train_dir}", *extra]


def test_sigterm_leaves_a_postmortem_and_its_own_status(tmp_path):
  train_dir = str(tmp_path / "run")
  proc = subprocess.run(_cli(train_dir, "--fault_schedule=sigterm@3"),
                        env=_env(), capture_output=True, text=True,
                        timeout=WAIT_S)
  assert proc.returncode == -signal.SIGTERM, (proc.returncode, proc.stderr)
  with open(os.path.join(train_dir, "flight_recorder.dump.jsonl")) as f:
    rows = [json.loads(l) for l in f if l.strip()]
  assert rows[0]["flight_recorder_dump"] == "signal SIGTERM"
  assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3]
  assert rows[-1].get("fault_event") == "sigterm at step 3"


# -- kfrun ---------------------------------------------------------------------------

def _script(tmp_path, body):
  path = tmp_path / "worker.py"
  path.write_text("import os, signal, sys, time\n" + body)
  return [sys.executable, str(path)]


def test_restart_on_failure_relaunches_at_the_same_size(tmp_path):
  """Generation 1's worker 1 exits 9; the job is relaunched at np 2 and
  generation 2 exits 0. Every worker of both generations saw one
  KF_RUN_ID."""
  cmd = _script(tmp_path, f"""
d = {str(tmp_path)!r}
r = os.environ["KFCOORD_RANK_HINT"]
with open(os.path.join(d, "ids"), "a") as f:
  f.write(os.environ["KF_RUN_ID"] + " " + os.environ["KFCOORD_WORLD"] + "\\n")
mark = os.path.join(d, "failed_once")
if r == "1" and not os.path.exists(mark):
  open(mark, "w").close()
  sys.exit(9)
""")
  assert kfrun.launch(2, cmd, logdir=str(tmp_path), extra_env=_env(),
                      restart_on_failure=True) == 0
  lines = (tmp_path / "ids").read_text().split()
  ids, worlds = set(lines[0::2]), lines[1::2]
  assert len(ids) == 1 and len(worlds) == 4 and set(worlds) == {"2"}


@pytest.mark.parametrize("code", [0, 130])
def test_restart_on_failure_never_resurrects_0_or_130(tmp_path, code):
  cmd = _script(tmp_path, f"""
with open({str(tmp_path / 'runs')!r}, "a") as f:
  f.write("x")
sys.exit({code})
""")
  assert kfrun.launch(1, cmd, logdir=str(tmp_path), extra_env=_env(),
                      restart_on_failure=True) == code
  assert (tmp_path / "runs").read_text() == "x"


def test_teardown_sigterm_never_hides_the_dead_worker_s_code(tmp_path):
  """Worker 1 SIGKILLs itself while worker 0 sleeps: kfrun tears worker 0
  down with SIGTERM and reports 9; a worker that dies of its own SIGTERM
  reports 15."""
  for sig, want in ((signal.SIGKILL, 9), (signal.SIGTERM, 15)):
    cmd = _script(tmp_path, f"""
if os.environ["KFCOORD_RANK_HINT"] == "1":
  os.kill(os.getpid(), {int(sig)})
time.sleep(60)
""")
    assert kfrun.launch(2, cmd, logdir=str(tmp_path),
                        extra_env=_env()) == want


def _final_state(train_dir):
  snap, _, step = checkpoint.load_latest_checkpoint(train_dir)
  return step, snap


def _assert_states_equal(a, b):
  assert a["step"] == b["step"]
  for k, v in a["model"].items():
    assert torch.equal(v, b["model"][k]), k
  for i, st in a["optimizer"]["state"].items():
    for k, v in st.items():
      assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


@pytest.mark.parametrize("schedule,resume_at", [
    ("corrupt_ckpt@6,kill@7", 6), ("corrupt_ckpt@7,kill@7", 4)],
    ids=["corrupt6_kill7", "corrupt7_kill7"])
def test_kill_and_rejoin_through_kfrun_is_bitwise_uninterrupted(
    tmp_path, schedule, resume_at):
  """The trivial model, Nesterov momentum, a checkpoint every 2 steps, 9
  steps a generation. Faults fire before the boundary's own save, so
  corrupt_ckpt@6 tears step 4's checkpoint and step 6's is written, and
  the kill at 7 rejoins from step 6; with both at step 7 the torn file
  is step 6's, which the rejoin skips for step 4's. The rejoined
  generation takes 9 more steps: its last checkpoint is bitwise that of
  an uninterrupted run of resume_at + 9 steps."""
  run = str(tmp_path / "run")
  logdir = tmp_path / "logs"
  logdir.mkdir()
  code = kfrun.launch(1, _cli(run, "--save_model_steps=2",
                              f"--fault_schedule={schedule}"),
                      logdir=str(logdir), extra_env=_env(),
                      restart_on_failure=True)
  out = (logdir / "127.0.0.1.10000.stdout.log").read_text()
  assert code == 0, out
  assert re.findall(r"Restored checkpoint at global step (\d+)", out) == \
      [str(resume_at)], out
  if resume_at == 4:
    assert "skipping torn/corrupt checkpoint model.ckpt-6.pt" in out, out
  ref = str(tmp_path / "ref")
  proc = subprocess.run(_cli(ref, num_batches=resume_at + 9), env=_env(),
                        capture_output=True, text=True, timeout=WAIT_S)
  assert proc.returncode == 0, proc.stderr
  (step, got), (ref_step, want) = _final_state(run), _final_state(ref)
  assert step == ref_step == resume_at + 9
  _assert_states_equal(got, want)
