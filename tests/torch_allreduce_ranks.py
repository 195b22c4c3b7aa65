"""Rank processes of tests/test_torch_all_reduce_benchmark.py (gloo on the
CPU). ``run_world(world, cases, tmp_dir)`` spawns ``world`` ranks in one
gloo group through a file store in ``tmp_dir``; each runs every case --
``all_reduce_benchmark.chained_reduce`` of its own seeded tensors through
the reduction of a spec (None: the per-tensor mean) at a wire dtype --
and returns each rank's results as numpy arrays (bf16 results as f32).
This module imports no JAX, so the ranks start without it."""

import os

import numpy as np
import torch
import torch.multiprocessing as mp

from kf_benchmarks_tpu_torch import all_reduce_benchmark as arb
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch.parallel import mesh

SHAPES = ((31, 3), (2,), (1000,), (17, 5, 4), (64,))


def rank_tensors(rank):
  rng = np.random.default_rng(100 + rank)
  return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _rank(rank, world, cases, tmp_dir):
  torch.set_num_threads(1)
  mesh.init_process_group("cpu", world, rank,
                          "file://" + os.path.join(tmp_dir, "store"))
  try:
    out = {}
    for name, spec, dtype, iters in cases:
      reduce = arb.make_reduce(params_lib.make_params(
          device="cpu", all_reduce_spec=spec))
      xs = [torch.from_numpy(a).to(dtype) for a in rank_tensors(rank)]
      ys = arb.chained_reduce(xs, iters, reduce)
      out[name] = [y.float().numpy() for y in ys]
  finally:
    mesh.destroy_process_group()
  torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))


def run_world(world, cases, tmp_dir):
  mp.spawn(_rank, args=(world, cases, str(tmp_dir)), nprocs=world, join=True)
  return [torch.load(os.path.join(str(tmp_dir), f"rank{r}.pt"),
                     weights_only=False) for r in range(world)]
