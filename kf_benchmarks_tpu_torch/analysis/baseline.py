"""Program-shape fingerprints: the key of the compile ledger and the run
store.

The port's copy of the fingerprint part of kf_benchmarks_tpu/analysis/
baseline.py (:76-183): ``PROGRAM_SHAPE_EXCLUDE``, ``fingerprint_key``,
``_canonical_value``, ``config_fingerprint_key`` and
``base_fingerprint_key``, applied to the port's Params. The key carries
the torch version where the JAX package's carries the jax version: a new
torch may choose other kernels (cuDNN plans, its own), as a new XLA
recompiles. The contract goldens of that module are not ported.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict

# Param fields that do not shape the step program: artifact sinks,
# cadences, and host-side observability and launcher knobs. Left out of
# the fingerprint so the compile ledger and the run store are not split
# by paths and cadences that change every run.
PROGRAM_SHAPE_EXCLUDE = frozenset({
    "train_dir", "data_dir", "eval_dir", "benchmark_log_dir",
    "benchmark_test_id", "trace_file", "trace_events_file",
    "tfprof_file", "graph_file", "partitioned_graph_file_prefix",
    "aot_save_path", "aot_load_path", "backbone_model_path",
    "use_chrome_trace_format", "display_every", "save_model_secs",
    "save_model_steps", "save_summaries_steps", "summary_verbosity",
    "max_ckpts_to_keep", "eval_interval_secs",
    "flight_recorder_window", "health_grad_norm_sigma",
    "stall_watchdog_factor", "fault_schedule",
    "elastic_check_every_n_steps", "sync_on_finish",
    "metrics_port", "run_store_dir",
    # The tuned table's path is plumbing; the knobs it applies key
    # through their own fields.
    "autotuned_config",
})

# The program-shaping knobs a tuned table sets (in the fingerprint;
# stripped from the base key).
TUNED_KNOBS = (
    "steps_per_dispatch",
    "num_grad_accum",
    "reduce_bucket_mb",
    "input_prefetch_depth",
    "attn_block",
    "partitioner",
)

# Run-length counters: in the full fingerprint, out of the base key.
_RUN_LENGTH_FIELDS = ("num_batches", "num_warmup_batches", "num_epochs")


def fingerprint_key(payload: Dict[str, Any]) -> str:
  """Short stable key of a canonical-JSON payload (sha256 hex, 16
  chars)."""
  canon = json.dumps(payload, sort_keys=True, default=str)
  return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:16]


def _canonical_value(v):
  """An integral float keys as its int: the CLI's parser gives float
  flags as 0.0 where ``make_params`` keeps 0, and both shape the same
  program. Bools pass through."""
  if isinstance(v, float) and not isinstance(v, bool) and \
      v.is_integer():
    return int(v)
  return v


def program_shape(config: Dict[str, Any]) -> Dict[str, Any]:
  """The fields of ``config`` that shape the program: None values and
  PROGRAM_SHAPE_EXCLUDE out, integral floats as ints."""
  return {k: _canonical_value(v) for k, v in config.items()
          if v is not None and k not in PROGRAM_SHAPE_EXCLUDE}


def config_fingerprint_key(config: Dict[str, Any],
                           program: str = "train_step") -> str:
  """The program-shape key a compile episode is ledgered under: the
  program-shaping fields of the full ``params._asdict()``, the program
  name and the torch version."""
  import torch
  return fingerprint_key({"config": program_shape(config),
                          "program": program, "torch": torch.__version__})


def base_fingerprint_key(config: Dict[str, Any],
                         program: str = "train_step") -> str:
  """:func:`config_fingerprint_key` without the tuned knobs and the
  run-length counters: the key a default run, a tuned run and the table
  entry that tuned it share."""
  stripped = {k: v for k, v in config.items()
              if k not in TUNED_KNOBS and k not in _RUN_LENGTH_FIELDS}
  return config_fingerprint_key(stripped, program)
