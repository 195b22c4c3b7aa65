"""Program-shape fingerprints: the key of the compile ledger and the run
store.

The port's copy of the fingerprint part of kf_benchmarks_tpu/analysis/
baseline.py (:76-183): ``PROGRAM_SHAPE_EXCLUDE``, ``fingerprint_key``,
``_canonical_value``, ``config_fingerprint_key`` and
``base_fingerprint_key``, applied to the port's Params. The key carries
the torch version where the JAX package's carries the jax version: a new
torch may choose other kernels (cuDNN plans, its own), as a new XLA
recompiles.

And the golden half (:145-249 there): ``contract_fingerprint``,
``diff_fingerprints`` and the golden files of the port's contracts
(analysis/contracts.py), kept in ``analysis/golden_contracts/``.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import Counter
from typing import Any, Dict, List, Tuple

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


# -- golden program contracts --------------------------------------------------

# The port's goldens: one per JAX golden name that the port runs
# (contracts.GOLDEN_CONFIGS and SERVING_GOLDEN_CONFIGS), written by
# ``python -m kf_benchmarks_tpu_torch.analysis audit --write-goldens``.
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden_contracts")


def contract_fingerprint(contract) -> Dict[str, Any]:
  """The stable, golden-worthy subset of a contracts.ProgramContract:
  the collective inventory by (kind, dtype, rank, placement), the ordered
  schedule, the host transfers, the optimizer's apply, the in-place state
  and the wire dtypes. Byte counts of buffers stay out (the rules bound
  them against the config instead)."""
  inventory = Counter(
      (c.kind, c.dtype, "scalar" if c.scalar else "tensor", c.placement)
      for c in contract.collectives)
  train = contract.program.startswith("train")
  grad_wires = sorted({c.dtype for c in contract.gradient_collectives()})
  wires = {}
  if contract.aux.get("sharded_state"):
    for c in contract.collectives:
      if not c.scalar and c.kind in ("all-reduce", "reduce-scatter",
                                     "all-gather"):
        wires.setdefault(c.kind, set()).add(c.dtype)
  return {
      "config": dict(contract.config),
      "program": contract.program,
      "collectives": sorted(
          ({"kind": k, "dtype": d, "rank": r, "placement": p, "count": n}
           for (k, d, r, p), n in inventory.items()),
          key=lambda e: json.dumps(e, sort_keys=True)),
      "collective_schedule": contract.collective_schedule(),
      "gradient_collectives": len(contract.gradient_collectives()),
      "in_loop_collectives": len(contract.in_loop_collectives()),
      "in_backward_collectives": len(contract.in_backward_collectives()),
      "host_transfers": list(contract.host_transfers),
      "optimizer_apply_present": contract.optimizer_apply_present,
      "optimizer_apply_in_loop": contract.optimizer_apply_in_loop,
      "optimizer_applies": contract.optimizer_applies,
      "state_in_place": contract.state_in_place,
      "requested_grad_wires": grad_wires if train else None,
      "requested_collective_wires": ({k: sorted(v) for k, v in
                                      sorted(wires.items())}
                                     if contract.aux.get("sharded_state")
                                     else None),
  }


def diff_fingerprints(golden: Dict[str, Any], current: Dict[str, Any]
                      ) -> List[Tuple[str, Any, Any]]:
  """Field-level diff [(field, golden, current)]: the inventory per row,
  the ordered schedule at its first divergence (and its length)."""
  diffs = []
  for key in sorted(set(golden) | set(current)):
    g, c = golden.get(key), current.get(key)
    if key == "collective_schedule":
      g_rows, c_rows = list(g or []), list(c or [])
      if g_rows == c_rows:
        continue
      if len(g_rows) != len(c_rows):
        diffs.append(("collective_schedule.length", len(g_rows),
                      len(c_rows)))
      for i, (gr, cr) in enumerate(zip(g_rows, c_rows)):
        if gr != cr:
          diffs.append((f"collective_schedule[{i}]", gr, cr))
          break
    elif key == "collectives":
      def rows(entries):
        return {json.dumps({k: v for k, v in e.items() if k != "count"},
                           sort_keys=True): e.get("count")
                for e in (entries or [])}
      g_rows, c_rows = rows(g), rows(c)
      for row in sorted(set(g_rows) | set(c_rows)):
        if g_rows.get(row) != c_rows.get(row):
          diffs.append((f"collectives[{row}].count", g_rows.get(row),
                        c_rows.get(row)))
    elif g != c:
      diffs.append((key, g, c))
  return diffs


def golden_path(name: str) -> str:
  return os.path.join(GOLDEN_DIR, f"{name}.json")


def load_golden(name: str) -> Dict[str, Any]:
  with open(golden_path(name), encoding="utf-8") as f:
    return json.load(f)


def write_golden(name: str, contract) -> str:
  os.makedirs(GOLDEN_DIR, exist_ok=True)
  path = golden_path(name)
  with open(path, "w", encoding="utf-8") as f:
    json.dump(contract_fingerprint(contract), f, indent=2, sort_keys=True)
    f.write("\n")
  return path


def check_against_golden(name: str, contract) -> List[Tuple[str, Any, Any]]:
  """Diff a traced contract against its golden; a missing golden is a
  whole-file diff."""
  path = golden_path(name)
  if not os.path.exists(path):
    return [("<golden file>", "missing", path)]
  return diff_fingerprints(load_golden(name), contract_fingerprint(contract))
