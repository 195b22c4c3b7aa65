#!/usr/bin/env python
"""Headline benchmark of the PyTorch/CUDA port: ResNet-50 synthetic ImageNet
training images/sec on one card.

    python3 bench_torch.py

runs the port's BenchmarkCNN (kf_benchmarks_tpu_torch/benchmark.py) on
ResNet-50 v1.5 at batch 256, bf16 over f32 parameters (--use_fp16),
Nesterov momentum and --variable_update=replicated on one CUDA card, and
prints ONE JSON line with the keys of the JAX package's bench.py:
{"metric", "value", "unit", "vs_baseline"}, plus "device" (the card's
name and power limit as nvidia-smi reports them), "world_size",
"steps_per_dispatch", "num_grad_accum", "shard_optimizer_state",
"shard_params", "overlap_gradient_reduction", and, as bench.py has them,
"compile_s" (host time of the first dispatch call: kernel builds, and at
--steps_per_dispatch > 1 the CUDA-graph capture) and "dispatch_overhead_s"
(mean host time of a timed dispatch call).

vs_baseline = value / 416.43, bench.py's anchor: the reference's best
committed single-GPU number, ResNet-50 on synthetic ImageNet at batch 200
on an NVIDIA GeForce RTX 3090 (BASELINE.md).

There is no CPU fallback: without a CUDA device the run exits non-zero.
``--device=cpu`` (with a small ``--model=trivial`` run) exists only so the
bench can be tested without a card.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_IMAGES_PER_SEC = 416.43


def device_name(device: str) -> str:
  if device == "cpu":
    return "cpu"
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--model", default="resnet50_v1.5")
  ap.add_argument("--batch_size", type=int, default=256)
  ap.add_argument("--num_batches", type=int, default=100)
  ap.add_argument("--num_warmup_batches", type=int, default=10)
  ap.add_argument("--steps_per_dispatch", type=int, default=1)
  ap.add_argument("--num_grad_accum", type=int, default=1)
  ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
  # The sharded state and the overlapped reduction (one card: no process
  # group, so the collectives are skipped and the step's own sharded path
  # runs at world 1).
  ap.add_argument("--shard_optimizer_state", action="store_true")
  ap.add_argument("--shard_params", action="store_true")
  ap.add_argument("--overlap_gradient_reduction", action="store_true")
  ap.add_argument("--reduce_bucket_mb", type=int, default=None)
  args = ap.parse_args(argv)

  import torch
  if args.device == "gpu" and not torch.cuda.is_available():
    print("bench_torch: no CUDA device (torch.cuda.is_available() is "
          "False); the bench has no CPU fallback", file=sys.stderr,
          flush=True)
    return 1
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import params as params_lib
  # stdout carries the one JSON line; the run's banner and step lines go
  # to stderr.
  benchmark.log_fn = lambda s: print(s, file=sys.stderr, flush=True)
  params = params_lib.make_params(
      model=args.model, batch_size=args.batch_size,
      num_batches=args.num_batches,
      num_warmup_batches=args.num_warmup_batches, device=args.device,
      use_fp16=args.device == "gpu", optimizer="momentum",
      variable_update="replicated",
      steps_per_dispatch=args.steps_per_dispatch,
      num_grad_accum=args.num_grad_accum,
      shard_optimizer_state=args.shard_optimizer_state,
      shard_params=args.shard_params,
      overlap_gradient_reduction=args.overlap_gradient_reduction,
      reduce_bucket_mb=args.reduce_bucket_mb)
  stats = benchmark.BenchmarkCNN(params).run()
  value = stats["images_per_sec"]
  print(json.dumps({
      "metric": "%s_synthetic_images_per_sec" % (
          "resnet50" if args.model.startswith("resnet50") else args.model),
      "value": round(value, 2),
      "unit": "images/sec",
      "vs_baseline": round(value / BASELINE_IMAGES_PER_SEC, 3),
      "device": device_name(args.device),
      "world_size": stats["num_workers"],
      "steps_per_dispatch": stats["steps_per_dispatch"],
      "num_grad_accum": stats["num_grad_accum"],
      "shard_optimizer_state": params.shard_optimizer_state,
      "shard_params": params.shard_params,
      "overlap_gradient_reduction": params.overlap_gradient_reduction,
      "compile_s": (round(stats["compile_s"], 3)
                    if stats["compile_s"] is not None else None),
      "dispatch_overhead_s": (round(stats["dispatch_overhead_s"], 6)
                              if stats["dispatch_overhead_s"] is not None
                              else None),
  }), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
