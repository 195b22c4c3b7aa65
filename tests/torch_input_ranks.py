"""Rank processes of the real-data data-parallel test (gloo on the CPU).

``run_world(world, params, tmp_dir, n)`` spawns ``world`` ranks of one gloo
group; each builds the port's BenchmarkCNN on ``params``, records the first
``n`` batches of its own training stream (images as the step receives them,
and labels), then trains ``params.num_batches`` steps, and returns per rank
the batches and the run's losses. This module imports no JAX.
"""

import os

import numpy as np
import torch
import torch.multiprocessing as mp

from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch.parallel import mesh


def _rank(rank, world, params, tmp_dir, n):
  torch.set_num_threads(1)
  mesh.init_process_group("cpu", world, rank,
                          "file://" + os.path.join(tmp_dir, "store"))
  try:
    bench = benchmark.BenchmarkCNN(params)
    next_batch = bench._open_input("train")
    batches = [next_batch() for _ in range(n)]
    bench._stop_input()
    stats = bench.run()
    np.savez(os.path.join(tmp_dir, f"rank{rank}.npz"),
             images=np.stack([b[0].numpy() for b in batches]),
             labels=np.stack([b[1].numpy() for b in batches]),
             losses=np.asarray(stats["losses"]))
  finally:
    mesh.destroy_process_group()


def run_world(world, params, tmp_dir, n):
  mp.spawn(_rank, args=(world, params, str(tmp_dir), n), nprocs=world,
           join=True)
  return [dict(np.load(os.path.join(str(tmp_dir), f"rank{r}.npz")))
          for r in range(world)]
