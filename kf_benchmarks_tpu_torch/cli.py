"""CLI entry point of the port (the counterpart of kf_benchmarks_tpu/cli.py).

    python -m kf_benchmarks_tpu_torch.cli --model=resnet50 --batch_size=256 \\
        --use_fp16 --optimizer=momentum --num_batches=100

Runs on the CUDA card by default and fails when there is none;
``--device=cpu`` runs the kernels' plain PyTorch versions on the CPU.

``--num_devices=N`` (N > 1) spawns N rank processes
(torch.multiprocessing) that join one process group on this host: NCCL
with rank r on ``cuda:r`` (N may not exceed the cards present), gloo on the
CPU with ``--device=cpu``. Rank 0 prints; a rank that raises makes the
command exit non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from kf_benchmarks_tpu_torch import flags
from kf_benchmarks_tpu_torch import params as params_lib


def parse_params(argv: Optional[Sequence[str]] = None):
  parser = argparse.ArgumentParser(
      prog="python -m kf_benchmarks_tpu_torch.cli",
      description="ResNet-50 training benchmark on NVIDIA H100s "
      "(PyTorch + hand-written CUDA kernels).")
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
    # The ranks share this host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // params.num_devices))
  mesh.init_process_group(params.device, params.num_devices, rank,
                          init_method)
  try:
    return benchmark.BenchmarkCNN(params).run()
  finally:
    mesh.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> int:
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import validation
  try:
    params = parse_params(argv)
    validation.validate_cross_flags(params)
    if params.num_devices == 1:
      bench = benchmark.BenchmarkCNN(params)
  except ValueError as e:  # ParamError included: a flag outside the slice
    print(f"error: {e}", file=sys.stderr, flush=True)
    return 1
  if params.num_devices == 1:
    bench.run()
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
