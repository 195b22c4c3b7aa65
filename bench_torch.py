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
(mean host time of a timed dispatch call), "health": the run's health
summary as bench.py records it (max_grad_norm, nonfinite_steps,
loss_scale_final, watchdog_stalls), and bench.py's "latency_percentiles"
(chunk wall p50/p90/p99 and feed wait p99, seconds), "compile_ledger"
(program shapes and their first calls' seconds), "git_rev" and
"platform" (``gpu`` or ``cpu``). As in bench.py the in-step health stats
are always asked for (the bench writes no --train_dir, so they would
otherwise resolve off); "health" is None where they resolve off all the
same: under --shard_optimizer_state, whose apply never holds the whole
update.

vs_baseline = value / 416.43, bench.py's anchor: the reference's best
committed single-GPU number, ResNet-50 on synthetic ImageNet at batch 200
on an NVIDIA GeForce RTX 3090 (BASELINE.md).

With ``--run_store_dir D`` the line is also appended to the run store in D
(kf_benchmarks_tpu_torch/metrics.py RunStore; nothing is stored without it),
and ``--check-regression`` judges it against the trailing median of the
store's records of the same config fingerprint: a verdict line on stderr
and exit code 1 on a regression (``record_and_check``, the twin of
bench.py's).

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
  ap.add_argument("--run_store_dir", default=None,
                  help="directory of the append-only run-record store "
                       "(kf_benchmarks_tpu_torch/metrics.py RunStore); "
                       "unset = no record")
  ap.add_argument("--check-regression", action="store_true",
                  dest="check_regression",
                  help="judge this run against the trailing median of "
                       "same-fingerprint records in --run_store_dir "
                       "(metrics.py check_regression); a verdict line on "
                       "stderr, exit code 1 on a regression")
  args = ap.parse_args(argv)
  if args.check_regression and not args.run_store_dir:
    ap.error("--check-regression needs --run_store_dir")

  import torch
  if args.device == "gpu" and not torch.cuda.is_available():
    print("bench_torch: no CUDA device (torch.cuda.is_available() is "
          "False); the bench has no CPU fallback", file=sys.stderr,
          flush=True)
    return 1
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
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
      reduce_bucket_mb=args.reduce_bucket_mb,
      # Explicit --health_stats is refused with the sharded state
      # (validation.py); there the stats resolve off and "health" is None.
      health_stats=None if args.shard_optimizer_state else True)
  stats = benchmark.BenchmarkCNN(params).run()
  value = stats["images_per_sec"]
  health = stats.get("health")
  if health:
    mgn = health.get("max_grad_norm")
    health = {
        "max_grad_norm": round(mgn, 4) if mgn is not None else None,
        "nonfinite_steps": health.get("nonfinite_steps"),
        "loss_scale_final": health.get("loss_scale_final"),
        "watchdog_stalls": health.get("watchdog_stalls"),
    }
  lat = stats.get("latency_percentiles") or {}

  def _r6(v):
    return round(v, 6) if v is not None else None

  ledger = stats.get("compile_ledger") or {}
  record = {
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
      "health": health or None,
      "latency_percentiles": {
          "chunk_wall_p50": _r6(lat.get("chunk_wall_p50")),
          "chunk_wall_p90": _r6(lat.get("chunk_wall_p90")),
          "chunk_wall_p99": _r6(lat.get("chunk_wall_p99")),
          "feed_wait_p99": _r6(lat.get("feed_wait_p99")),
      },
      "compile_ledger": {"shapes": ledger.get("shapes", 0),
                         "total_compile_s": ledger.get("total_compile_s")},
      "tuned_config": stats.get("tuned_config"),
      "git_rev": metrics_lib.git_revision(),
      "platform": "gpu" if args.device == "gpu" else "cpu",
  }
  print(json.dumps(record), flush=True)
  if not args.run_store_dir:
    return 0
  return record_and_check(
      record, args.run_store_dir, args.check_regression,
      run_id=stats.get("run_id"),
      fingerprint=metrics_lib.bench_fingerprint(params),
      device_name=record["device"])


def record_and_check(record, store_dir, check_regression, run_id=None,
                     fingerprint=None, device_name=None) -> int:
  """Append the run's record to the store in ``store_dir``; under
  ``check_regression`` judge it against the trailing same-fingerprint
  median and return the exit code (1 = regression). The verdict's polarity
  is the metric schema's (metrics.metric_direction). History is read
  before the append, so a run never judges itself."""
  import torch
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  from kf_benchmarks_tpu_torch import tracing
  store = metrics_lib.RunStore(store_dir)
  try:
    rec = metrics_lib.run_record(
        metric=record["metric"], value=record["value"], unit=record["unit"],
        fingerprint=fingerprint or "bench",
        run_id=run_id or tracing.resolve_run_id(),
        platform=record["platform"], git_rev=record.get("git_rev"),
        torch_version=torch.__version__, device_name=device_name,
        snapshot=metrics_lib.flatten_stats(record))
    history = store.records()
    rec = store.append(rec)
    if rec.get("baseline"):
      print("run store: first card record for fingerprint "
            f"{rec['fingerprint'][:16]} promoted to baseline",
            file=sys.stderr, flush=True)
  except (OSError, ValueError) as e:
    print(f"run store append failed (non-fatal): {e}", file=sys.stderr,
          flush=True)
    return 0
  if not check_regression:
    return 0
  verdict = metrics_lib.check_regression(
      history, rec,
      higher_is_better=metrics_lib.metric_direction(rec["metric"]))
  print(metrics_lib.verdict_line(verdict), file=sys.stderr, flush=True)
  return 1 if verdict["status"] == "regression" else 0


if __name__ == "__main__":
  sys.exit(main())
