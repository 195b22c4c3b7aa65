"""Serving bench: a seeded request trace through the serving engine, one JSON
line.

    KF_TRANSFORMER_LM_ATTN=flash python -m kf_benchmarks_tpu_torch.serving.bench \\
        --use_fp16
    python -m kf_benchmarks_tpu_torch.serving.bench --device=cpu

The port's counterpart of the JAX package's ``bench.py --serving``
(bench.py:288-440), with its decode-cost variants (--serving_quantize,
--serving_kv_page_size, --serving_speculative_k with
--serving_draft_layers; bench.py:318-333) and its ``--metrics_port`` (the
engine's registry served at /metrics and its state at /healthz for the
replay), without the run store. On
the card (the default ``--device=gpu``, which fails without one; there is
no CPU fallback) it serves the zoo transformer_lm at full size, 128
requests at 16 requests/s with 32 new tokens each; ``--device=cpu`` serves a
scaled-down LM (24 requests at 8/s, 8 new tokens) so the line stays
seconds-cheap. ``--use_fp16`` computes and caches in bf16 over f32
parameters; the attention is ``KF_TRANSFORMER_LM_ATTN`` (``tiled`` or
``flash``, models/transformer_lm.py). The engine prepares every program of
its ladder (``warm``) before the replay, so TTFT measures the system.

Before serving a quantized spec the bench runs the INT8 gate
(decode.py ``quantize_agreement``) on the first 8 prompts of the seeded
workload; below the bar it serves the dense arm instead and says so on
stderr (bench.py:362-381). On random-init weights the gate is meant to
fail: their argmax margins are razor-thin.

The JSON line carries the JAX line's keys: metric, value, unit, retries,
compile_ledger, decode_variant (the variants of the arm served),
quantize_gate (when one ran), every non-None ``serving/*`` stat, the
per-tenant block, git_rev and platform (``gpu`` or ``cpu``), plus the
device's name.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, Optional, Sequence

import torch

from kf_benchmarks_tpu_torch import flags
from kf_benchmarks_tpu_torch import metrics as metrics_lib
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import tracing
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import transformer_lm
from kf_benchmarks_tpu_torch.serving import decode as decode_lib
from kf_benchmarks_tpu_torch.serving import engine as engine_lib
from kf_benchmarks_tpu_torch.serving.decode import LMSpec


def parse_params(argv: Optional[Sequence[str]] = None):
  parser = argparse.ArgumentParser(
      prog="python -m kf_benchmarks_tpu_torch.serving.bench",
      description="transformer_lm serving bench on an NVIDIA H100 "
      "(PyTorch + hand-written CUDA kernels).")
  flags.add_to_parser(parser)
  ns = parser.parse_args(argv)
  overrides = {k: v for k, v in vars(ns).items() if v is not None}
  overrides.setdefault("model", "transformer_lm")
  return params_lib.make_params(**overrides)


def _round(v):
  return round(v, 6) if isinstance(v, float) else v


def run(params) -> Dict[str, Any]:
  """Serve the seeded workload and return the JSON record."""
  if params.model != "transformer_lm":
    raise validation.ParamError(
        f"the serving bench serves transformer_lm, got --model="
        f"{params.model}")
  validation.validate_cross_flags(params)
  on_gpu = params.device == "gpu"
  dtype = torch.bfloat16 if params.use_fp16 else torch.float32
  impl = transformer_lm.attn_impl()
  # Decode-cost variants, absent when off so a variant-free spec's
  # fingerprint is the one it always was.
  variant_kw = {}
  if params.serving_quantize:
    variant_kw["quantize"] = params.serving_quantize
  if params.serving_kv_page_size:
    variant_kw["kv_page_size"] = params.serving_kv_page_size
  if params.serving_speculative_k:
    variant_kw["speculative_k"] = params.serving_speculative_k
    variant_kw["draft_n_layers"] = params.serving_draft_layers
  if on_gpu:
    spec = LMSpec(attn_impl=impl, dtype=dtype, **variant_kw)
    n_req, rate, max_new = 128, 16.0, 32
  else:
    spec = LMSpec(vocab=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                  max_len=128, attn_block=32, attn_impl=impl, dtype=dtype,
                  **variant_kw)
    n_req, rate, max_new = 24, 8.0, 8
  ladder_kw = ({"bucket_ladder": validation.parse_bucket_ladder(
      params.serving_bucket_ladder)} if params.serving_bucket_ladder else {})
  cfg = engine_lib.EngineConfig(
      spec=spec, **ladder_kw,
      batching=params.serving_batching or "continuous",
      max_new_tokens=params.serving_max_new_tokens or max_new,
      max_queue_depth=params.serving_queue_depth or 64,
      ttft_slo_s=(params.serving_ttft_slo_ms / 1e3
                  if params.serving_ttft_slo_ms is not None else None),
      tenant_tokens_per_s=params.serving_tenant_tokens_per_s)
  n_req = params.serving_requests or n_req
  rate = params.serving_rate or rate
  n_tenants = params.serving_tenants or 1
  tenants = (tuple(f"tenant{i}" for i in range(n_tenants))
             if n_tenants > 1 else ("default",))
  workload = engine_lib.poisson_workload(
      n_req, rate, spec, seed=0, max_new_tokens=cfg.max_new_tokens,
      tenants=tenants)

  device = "cuda" if on_gpu else "cpu"
  variables = decode_lib.init_variables(spec, seed=0)
  quantize_gate = None
  if spec.quantize:
    # The INT8 gate on a probe slice of the same seeded workload: below
    # the bar the dense arm is served, and the line says why.
    probe = [req.prompt for _, req in workload[:8]]
    quantize_gate = decode_lib.quantize_agreement(
        spec, variables, probe, max_new_tokens=min(8, cfg.max_new_tokens),
        device=device)
    if not quantize_gate["passed"]:
      print(f"serving bench: int8 gate FAILED (agreement "
            f"{quantize_gate['agreement']:.4f} < "
            f"{decode_lib.QUANTIZE_AGREEMENT_BAR}) -- serving the dense arm "
            "instead", file=sys.stderr, flush=True)
      spec = dataclasses.replace(spec, quantize=None)
      cfg = dataclasses.replace(cfg, spec=spec)

  trace = tracing.activate(tracing.RunTrace())
  registry = metrics_lib.activate(metrics_lib.MetricRegistry())
  server = None
  try:
    engine = engine_lib.ServingEngine(cfg, variables=variables, device=device)
    if params.metrics_port:
      # The serving registry, served live for the replay (bench.py:91).
      server = metrics_lib.MetricsServer(registry, params.metrics_port,
                                         healthz_fn=engine.healthz)
      print(f"serving /metrics + /healthz on 127.0.0.1:{server.port}",
            file=sys.stderr, flush=True)
    n_warm = engine.warm()
    print(f"serving bench: {n_warm} program(s) prepared across ladder "
          f"{cfg.bucket_ladder}", file=sys.stderr, flush=True)
    engine.replay(workload)
    stats = engine.stats()
  finally:
    if server is not None:
      server.close()
    tracing.deactivate()
    metrics_lib.deactivate()
  ledger = trace.compile_ledger()
  record = {
      "metric": "serving_tokens_per_sec",
      "value": round(stats.get("serving/tokens_per_sec") or 0.0, 2),
      "unit": "tokens/sec",
      "retries": 0,
      "compile_ledger": {"shapes": ledger["shapes"],
                         "total_compile_s": ledger["total_compile_s"]},
      "decode_variant": {"quantize": spec.quantize,
                         "paged_kv": spec.kv_page_size or None,
                         "speculative_k": spec.speculative_k or None,
                         "model_shards": spec.model_shards or None},
  }
  if quantize_gate is not None:
    record["quantize_gate"] = {
        "agreement": round(quantize_gate["agreement"], 6),
        "max_logit_delta": round(quantize_gate["max_logit_delta"], 6),
        "passed": quantize_gate["passed"]}
  record.update({k: _round(v) for k, v in stats.items()
                 if v is not None and k != "serving_tenants"})
  tenant_block = {t: {k: _round(v) for k, v in block.items()
                      if v is not None}
                  for t, block in (stats.get("serving_tenants") or {}).items()}
  if tenant_block:
    record["serving_tenants"] = tenant_block
  record["git_rev"] = metrics_lib.git_revision()
  record["platform"] = "gpu" if on_gpu else "cpu"
  record["device"] = (torch.cuda.get_device_name(0) if on_gpu else "cpu")
  return record


def main(argv: Optional[Sequence[str]] = None) -> int:
  try:
    params = parse_params(argv)
    record = run(params)
  except ValueError as e:  # ParamError included
    print(f"error: {e}", file=sys.stderr, flush=True)
    return 1
  print(json.dumps(record), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
