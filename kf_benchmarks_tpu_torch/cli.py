"""CLI entry point of the port (the counterpart of kf_benchmarks_tpu/cli.py).

    python -m kf_benchmarks_tpu_torch.cli --model=resnet50 --batch_size=256 \\
        --use_fp16 --optimizer=momentum --num_batches=100

Runs on the CUDA card by default and fails when there is none;
``--device=cpu`` runs the kernels' plain PyTorch versions on the CPU.

``--num_devices=N`` (N > 1) spawns N rank processes
(torch.multiprocessing) that join one process group on this host: NCCL
with rank r on ``cuda:r`` (N may not exceed the cards present), gloo on the
CPU with ``--device=cpu``. Rank 0 prints; a rank that raises makes the
command exit non-zero. ``--forward_only`` and ``--eval`` take the same
spawn: each rank evaluates its own copy of the batch and the accuracies
and losses are the mean over the ranks.

``--worker_hosts=h0:p0,h1:p1,...`` runs this process as one worker of a
job that kfrun (or another launcher) started once per worker: it joins the
job's process group through cluster.py instead of spawning ranks. A run
that checkpointed for an elastic restart exits with kfrun's
RESTART_EXIT_CODE (42), which kfrun takes as the request to relaunch the
job at its new size:

    python -m kf_benchmarks_tpu_torch.kfrun -np 2 -- \
        python -m kf_benchmarks_tpu_torch.cli --model=trivial \
        --device=cpu --variable_update=kungfu --elastic \
        --train_dir=/tmp/run --worker_hosts=127.0.0.1:29500,127.0.0.1:29501
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from kf_benchmarks_tpu_torch import flags
from kf_benchmarks_tpu_torch import params as params_lib


def parse_params(argv: Optional[Sequence[str]] = None):
  parser = argparse.ArgumentParser(
      prog="python -m kf_benchmarks_tpu_torch.cli",
      description="CNN and transformer_lm training, inference and "
      "evaluation benchmark on NVIDIA H100s (PyTorch + hand-written CUDA "
      "kernels).")
  flags.add_to_parser(parser)
  ns, unknown = parser.parse_known_args(argv)
  if unknown:
    from kf_benchmarks_tpu_torch import validation
    for arg in unknown:
      if arg.startswith("--"):
        validation.refuse_unported_flag(arg[2:].split("=", 1)[0])
    parser.error(f"unrecognized arguments: {' '.join(unknown)}")
  overrides = {k: v for k, v in vars(ns).items() if v is not None}
  return params_lib.make_params(**overrides)


def rank_main(rank: int, params, init_method: str):
  """One rank of a data-parallel run: join the group, run, leave."""
  import torch
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch.parallel import mesh
  if params.device == "cpu":
    # The ranks share this process's thread budget (the host's cores, or
    # OMP_NUM_THREADS).
    torch.set_num_threads(max(1, torch.get_num_threads() //
                              params.num_devices))
  mesh.init_process_group(params.device, params.num_devices, rank,
                          init_method)
  try:
    return benchmark.BenchmarkCNN(params).run()
  finally:
    mesh.destroy_process_group()


def cluster_main(params) -> int:
  """One worker of a multi-process job: join through the cluster manager,
  run, leave; kfrun's restart code after a checkpoint-restart."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import cluster
  from kf_benchmarks_tpu_torch import kfrun
  manager = cluster.get_cluster_manager(params)
  if params.device == "cpu":
    import torch
    # The workers share the host's thread budget (its cores, or
    # OMP_NUM_THREADS).
    torch.set_num_threads(max(1, torch.get_num_threads() //
                              manager.num_workers()))
  try:
    stats = benchmark.BenchmarkCNN(params).run()
  finally:
    manager.shutdown()
  if stats.get("restart_for_resize"):
    return kfrun.RESTART_EXIT_CODE
  return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import validation
  try:
    params = parse_params(argv)
    validation.validate_cross_flags(params)
    if params.worker_hosts or params.job_name:
      return cluster_main(params)
    if params.num_devices == 1:
      bench = benchmark.BenchmarkCNN(params)
  except ValueError as e:  # ParamError included: a flag outside the slice
    print(f"error: {e}", file=sys.stderr, flush=True)
    return 1
  if params.num_devices == 1:
    stats = bench.run()
    if stats.get("restart_for_resize"):
      from kf_benchmarks_tpu_torch import kfrun
      return kfrun.RESTART_EXIT_CODE
    return 0
  import torch.multiprocessing as mp
  from kf_benchmarks_tpu_torch.parallel import mesh
  try:
    mp.spawn(rank_main, args=(params, mesh.local_init_method()),
             nprocs=params.num_devices, join=True)
  except Exception as e:  # a rank raised or died
    print(f"error: a rank failed: {e}", file=sys.stderr, flush=True)
    return 1
  return 0


if __name__ == "__main__":
  sys.exit(main())
