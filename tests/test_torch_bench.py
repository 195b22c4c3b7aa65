"""The port's entry points for data-parallel runs and the one-line bench,
on the CPU.

* ``bench_torch.py --device=cpu --model=trivial`` prints one JSON line
  with bench.py's four keys and its ``health`` record (and without a card
  and without ``--device=cpu`` it exits non-zero: no CPU fallback).
* The CLI at ``--device=cpu --num_devices=4`` spawns four gloo ranks and
  only rank 0 prints: one banner, one total line, the global batch and
  rate; a failing rank makes it exit non-zero.
* Validation accepts ``--num_devices > 1`` for every ported strategy,
  the sharded optimizer state and the overlapped reduction among them
  (which the CLI runs at two gloo ranks), refuses --shard_params and
  --reduce_bucket_mb without the mode they need with the JAX package's
  messages, refuses the unported flags naming their ROADMAP item (in
  make_params and in the CLI's parser, which do not define them), and
  refuses more ranks than cards on the card.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import validation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=120):
  env = dict(os.environ, PYTHONPATH=REPO)
  return subprocess.run([sys.executable] + args, capture_output=True,
                        text=True, cwd=REPO, env=env, timeout=timeout)


def test_bench_torch_prints_one_json_line():
  proc = _run([os.path.join(REPO, "bench_torch.py"), "--device=cpu",
               "--model=trivial", "--batch_size=2", "--num_batches=2",
               "--num_warmup_batches=1"])
  assert proc.returncode == 0, proc.stderr
  lines = proc.stdout.strip().splitlines()
  assert len(lines) == 1, proc.stdout
  record = json.loads(lines[0])
  assert {"metric", "value", "unit", "vs_baseline"} <= set(record)
  assert record["unit"] == "images/sec" and record["value"] > 0
  assert record["vs_baseline"] == pytest.approx(record["value"] / 416.43,
                                                abs=1e-3)
  assert record["world_size"] == 1
  assert "total images/sec" in proc.stderr


@pytest.mark.parametrize("sharded", [False, True])
def test_bench_torch_records_health(tmp_path, sharded):
  """The line's "health" is bench.py's record, always asked for: its
  max_grad_norm is the largest in-step grad norm of the same run (read
  from the flight recorder of that run made in this process with a
  --train_dir), no step non-finite, the loss scale 1 (f32 on the CPU), no
  stall. Under --shard_optimizer_state the stats resolve off and it is
  None."""
  flags = dict(model="trivial", batch_size=2, num_batches=3,
               num_warmup_batches=1)
  argv = [os.path.join(REPO, "bench_torch.py"), "--device=cpu"] + [
      "--%s=%s" % kv for kv in flags.items()]
  proc = _run(argv + (["--shard_optimizer_state"] if sharded else []))
  assert proc.returncode == 0, proc.stderr
  health = json.loads(proc.stdout.strip().splitlines()[-1])["health"]
  if sharded:
    assert health is None
    return
  from kf_benchmarks_tpu_torch import benchmark
  train_dir = str(tmp_path / "run")
  benchmark.BenchmarkCNN(params_lib.make_params(
      device="cpu", optimizer="momentum", variable_update="replicated",
      train_dir=train_dir, **flags)).run()
  rows = [json.loads(l) for l in
          open(os.path.join(train_dir, "flight_recorder.jsonl"))]
  assert len(rows) == 3
  assert health == {
      "max_grad_norm": round(max(r["health/grad_norm"] for r in rows), 4),
      "nonfinite_steps": 0, "loss_scale_final": 1.0, "watchdog_stalls": 0}
  assert health["max_grad_norm"] > 0


def test_bench_torch_has_no_cpu_fallback():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default run would start")
  proc = _run([os.path.join(REPO, "bench_torch.py")])
  assert proc.returncode != 0
  assert proc.stdout == ""
  assert "no CUDA device" in proc.stderr


def test_cli_four_gloo_ranks_print_one_banner():
  proc = _run(["-m", "kf_benchmarks_tpu_torch.cli", "--device=cpu",
               "--num_devices=4", "--variable_update=kungfu",
               "--kungfu_option=async_sgd", "--model=trivial",
               "--batch_size=2", "--num_batches=2", "--num_warmup_batches=1",
               "--display_every=1"])
  assert proc.returncode == 0, proc.stderr
  out = proc.stdout
  assert out.count("Model:       trivial") == 1, out
  assert out.count("total images/sec") == 1, out
  assert "Batch size:  8 global" in out and "Num devices: 4 (cpu" in out
  assert "KungFu:      async_sgd" in out


def test_cli_fails_when_a_rank_fails(monkeypatch, capsys):
  import torch.multiprocessing as mp

  def spawn(*args, **kwargs):
    raise mp.ProcessRaisedException("rank 1 raised", 1, 123)

  monkeypatch.setattr(mp, "spawn", spawn)
  rc = cli.main(["--device=cpu", "--num_devices=2", "--model=trivial"])
  assert rc != 0
  assert "a rank failed" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    dict(variable_update="independent"),
    dict(variable_update="replicated"),
    dict(variable_update="parameter_server"),
    dict(variable_update="parameter_server", cross_replica_sync=False),
    dict(variable_update="collective_all_reduce"),
    dict(variable_update="distributed_all_reduce", all_reduce_spec="psum"),
    dict(variable_update="horovod"),
    dict(variable_update="kungfu", kungfu_option="sync_sgd"),
    dict(variable_update="kungfu", kungfu_option="async_sgd"),
    dict(variable_update="kungfu", kungfu_option="sma"),
    dict(variable_update="replicated", gradient_repacking=4),
    dict(variable_update="replicated", agg_small_grads_max_bytes=1024),
    dict(variable_update="replicated", hierarchical_copy=True),
    dict(variable_update="replicated", all_reduce_spec="psum:32k:rsag",
         compact_gradient_transfer_f32=True),
    dict(shard_optimizer_state=True),
    dict(variable_update="parameter_server", shard_optimizer_state=True,
         shard_params=True, reduce_bucket_mb=25),
    dict(overlap_gradient_reduction=True),
    dict(variable_update="horovod", overlap_gradient_reduction=True,
         reduce_bucket_mb=25),
])
def test_validation_accepts_every_ported_strategy(flags):
  validation.validate_cross_flags(params_lib.make_params(
      device="cpu", num_devices=4, **flags))


@pytest.mark.parametrize("flags,match", [
    (dict(fp16_vars=True), "--fp16_vars requires --use_fp16"),
    (dict(shard_params=True), "requires --shard_optimizer_state"),
    (dict(reduce_bucket_mb=25), "requires --overlap_gradient_reduction"),
    (dict(variable_update="distributed_replicated"), "requires --job_name"),
    (dict(variable_update="distributed_all_reduce"),
     "requires --all_reduce_spec"),
    (dict(all_reduce_spec="psum:32k"), "--all_reduce_spec"),
    (dict(gradient_repacking=2, all_reduce_spec="psum"),
     "--gradient_repacking cannot be combined with --all_reduce_spec"),
    (dict(gradient_repacking=2, agg_small_grads_max_bytes=10),
     "--agg_small_grads_max_bytes"),
    (dict(hierarchical_copy=True, all_reduce_spec="psum"),
     "--hierarchical_copy cannot be combined"),
    (dict(hierarchical_copy=True, num_devices=1),
     "requires more than one device"),
    (dict(compact_gradient_transfer_f32=True), "no effect"),
    (dict(compact_gradient_transfer_f32=True,
          compact_gradient_transfer=False, gradient_repacking=2),
     "requires --compact_gradient_transfer"),
    (dict(variable_update="parameter_server", cross_replica_sync=False,
          optimizer="momentum", num_devices=33), "capped at 32"),
])
def test_validation_refuses_with_reason(flags, match):
  kw = dict(device="cpu", num_devices=4)
  kw.update(flags)
  with pytest.raises(validation.ParamError, match=match):
    validation.validate_cross_flags(params_lib.make_params(**kw))


def test_more_ranks_than_cards_is_refused():
  """NCCL takes one rank per card: two ranks on a host with fewer cards
  is a ParamError (never a shared card, never a gloo fallback)."""
  if torch.cuda.device_count() >= 2:
    pytest.skip("this host has two cards")
  with pytest.raises(validation.ParamError, match="one rank per card"):
    validation.validate_cross_flags(params_lib.make_params(
        device="gpu", num_devices=2, use_fp16=True, model="resnet50"))
  rc = cli.main(["--device=gpu", "--num_devices=2"])
  assert rc != 0


@pytest.mark.parametrize("argv,match", [
    (["--fp16_vars"], "--fp16_vars requires --use_fp16"),
    (["--mesh_shape=2x1"], "Queue 1 item 8"),
    (["--shard_params=true"], "requires --shard_optimizer_state"),
    (["--reduce_bucket_mb=25"], "requires --overlap_gradient_reduction"),
])
def test_cli_refuses_unported_flag_naming_roadmap(argv, match, capsys):
  """The port does not define --mesh_shape; the CLI's parser names its
  ROADMAP item instead of calling it unknown. --fp16_vars without
  --use_fp16, and --shard_params and --reduce_bucket_mb alone, are
  refused with the JAX package's messages."""
  assert cli.main(["--device=cpu", "--model=trivial"] + argv) == 1
  assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--shard_optimizer_state"],
    ["--shard_optimizer_state", "--shard_params", "--reduce_bucket_mb=1"],
    ["--overlap_gradient_reduction", "--reduce_bucket_mb=1"],
])
def test_cli_runs_the_sharding_and_overlap_flags(argv):
  proc = _run(["-m", "kf_benchmarks_tpu_torch.cli", "--device=cpu",
               "--num_devices=2", "--model=trivial", "--batch_size=2",
               "--num_batches=2", "--num_warmup_batches=1",
               "--optimizer=momentum"] + argv)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.count("total images/sec") == 1, proc.stdout
  assert "Num devices: 2 (cpu" in proc.stdout


def test_cli_rejects_an_unknown_flag():
  with pytest.raises(SystemExit) as e:
    cli.parse_params(["--device=cpu", "--no_such_flag=1"])
  assert e.value.code == 2
