"""The port's all-reduce microbenchmark (kf_benchmarks_tpu_torch/
all_reduce_benchmark.py) on the CPU.

* ``get_var_shapes`` equals the JAX package's (the flax leaves' order and
  layout): 6 tensors for the trivial model, 161 for ResNet-50.
* The spec grammar parses as the JAX package's.
* Numerics: gloo worlds of 2 and 4 (tests/torch_allreduce_ranks.py, one
  spawn a world), each rank on its own seeded tensors, through the
  per-tensor mean and a packed spec, one reduction and a chain of three:
  every rank's result is numpy's mean of the ranks' inputs (the chain's
  1e-6 steps added), f32 at rtol 1e-6 of the terms' magnitudes (the sum
  order differs), bf16 at its rounding (each rank's
  tensor rounded to bf16, the sum rounded at most once a rank: 2^-7 of the
  ranks' magnitudes a step).
* The benchmark and the sweep at world 1 (gloo): their stats, the
  markdown rows, the world-1 note and ONE JSON line with the
  reduce_scatter / all_gather rows; the CLI at --num_devices=2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import all_reduce_benchmark as jax_arb
from kf_benchmarks_tpu.models import model_config as jax_model_config
from kf_benchmarks_tpu.ops import allreduce as jax_allreduce
from kf_benchmarks_tpu_torch import all_reduce_benchmark as arb
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.ops import allreduce
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.utils import log as log_util

import torch_allreduce_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,count", [("trivial", 6), ("resnet50", 161),
                                        ("lenet", 8)])
def test_var_shapes_match_the_jax_package(name, count):
  ours = arb.get_var_shapes(model_config.get_model_config(
      name, params_lib.make_params(), "imagenet"))
  theirs = jax_arb.get_var_shapes(jax_model_config.get_model_config(
      name, "imagenet"))
  assert ours == theirs and len(ours) == count


@pytest.mark.parametrize("spec", ["psum", "rsag#4", "psum:32k:rsag",
                                  "pscpu:32k:xring", "hier#2",
                                  "psgpu:1m:pscpu/pscpu"])
def test_spec_parses_like_the_jax_package(spec):
  assert [tuple(t) for t in allreduce.parse_all_reduce_spec(spec)] == [
      tuple(t) for t in jax_allreduce.parse_all_reduce_spec(spec)]


CASES = [("f32_per_tensor", None, torch.float32, 1),
         ("f32_packed", "psum:256:rsag", torch.float32, 1),
         ("f32_chain", None, torch.float32, 3),
         ("bf16_per_tensor", None, torch.bfloat16, 1),
         ("bf16_packed", "psum:256:rsag", torch.bfloat16, 1)]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_means_equal_numpys(world, tmp_path):
  results = ranks.run_world(world, CASES, tmp_path)
  inputs = [ranks.rank_tensors(r) for r in range(world)]
  for name, _, dtype, iters in CASES:
    for i in range(len(ranks.SHAPES)):
      if dtype == torch.bfloat16:
        xs = [torch.from_numpy(inputs[r][i]).bfloat16().float().numpy()
              for r in range(world)]
        want = np.mean(xs, axis=0)
        tol = 2.0 ** -7 * np.sum(np.abs(xs), axis=0) + 1e-6
      else:
        xs = [inputs[r][i] for r in range(world)]
        want = np.mean(xs, axis=0) + 1e-6 * (iters - 1)
        # rtol 1e-6 of the terms (the sum order differs), and the chain's
        # f32 additions of 1e-6.
        tol = 1e-6 * np.mean(np.abs(xs), axis=0) + 1e-7 * iters
      for r in range(world):
        got = results[r][name][i]
        assert np.all(np.abs(got - want) <= tol), (name, i, r)
      # Every rank holds the same result.
      for r in range(1, world):
        np.testing.assert_array_equal(results[r][name][i],
                                      results[0][name][i])


@pytest.fixture
def world_one(tmp_path):
  mesh.init_process_group("cpu", 1, 0, "file://" + str(tmp_path / "store"))
  logs = []
  orig = log_util.log_fn
  log_util.log_fn = logs.append
  try:
    yield logs
  finally:
    log_util.log_fn = orig
    mesh.destroy_process_group()


def test_benchmark_at_world_one(world_one):
  stats = arb.run_benchmark(params_lib.make_params(
      model="trivial", device="cpu", num_batches=2, num_warmup_batches=1,
      all_reduce_spec="psum:32k:rsag"), iters_per_step=2)
  assert stats["num_tensors"] == 6 and stats["world"] == 1
  assert stats["average_time_per_step"] > 0
  assert stats["bytes_per_replica"] == 4 * sum(
      int(np.prod(s)) for s in arb.get_var_shapes(
          model_config.get_model_config("trivial", params_lib.make_params(),
                                        "imagenet")))
  assert any("not a wire between devices" in line for line in world_one)


def test_sweep_rows_and_one_json_line(world_one, capsys):
  rows = arb.run_sweep(params_lib.make_params(
      device="cpu", num_batches=2, num_warmup_batches=1), 2,
      "psum,rsag,reduce_scatter,all_gather", "1k,4k")
  assert len(rows) == 8
  assert {r["spec"] for r in rows} == {"psum", "rsag", "reduce_scatter",
                                       "all_gather"}
  assert all(r["n"] == 1 and r["step_ms"] > 0 and r["all_reduce_ms"] >= 0
             for r in rows)
  assert sum(1 for line in world_one if line.startswith("| 1 |")) == 8
  lines = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
  assert len(lines) == 1
  record = json.loads(lines[0])
  assert record["metric"] == "all_reduce_sweep" and record["world"] == 1
  assert len(record["rows"]) == 8
  with pytest.raises(ValueError):
    arb.vector_step("bogus")


def test_cli_sweep_at_two_gloo_ranks():
  proc = subprocess.run(
      [sys.executable, "-m", "kf_benchmarks_tpu_torch.all_reduce_benchmark",
       "--device=cpu", "--num_devices=2", "--sweep",
       "--sweep_specs=psum,reduce_scatter", "--sweep_sizes=1k",
       "--num_batches=2", "--iters_per_step=2"],
      capture_output=True, text=True, cwd=REPO, timeout=300,
      env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr[-2000:]
  (line,) = [x for x in proc.stdout.splitlines() if x.startswith("{")]
  record = json.loads(line)
  assert record["world"] == 2 and [r["n"] for r in record["rows"]] == [2, 2]
