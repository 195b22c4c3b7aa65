"""Contract-driven autotuner: search the program-shaping knobs with the
contract as the oracle, confirm with short measured probes.

The port's counterpart of kf_benchmarks_tpu/analysis/autotune.py, per
(model, batch, world) on the card:

1. **Enumerate** a deterministic, seeded grid over the tuned knobs
   (``analysis/baseline.TUNED_KNOBS``: --steps_per_dispatch,
   --num_grad_accum, --reduce_bucket_mb, --input_prefetch_depth,
   --attn_block), through the port's own validation, so the grid never
   proposes a combination the CLI would refuse.
2. **Prune statically**: every surviving candidate's step is traced on
   fake tensors (``contracts.trace_contract``: nothing runs) and
   rejected when its contract breaks the memory and collective bounds --
   the peak of live tensor bytes against the card's memory, the
   collective and bucket caps -- before any probe runs. A pruned
   candidate executes 0 steps.
3. **Rank** the survivors by a cost model over the contract's FLOPs,
   collective bytes and count, live bytes and the host cost of a
   dispatch (paid a microbatch, shared by its K steps), at the H100's
   published rates.
4. **Probe** the default and the top-k with the differential pair of
   windows: one warm dispatch first (it builds the kernels and captures
   the CUDA graph of K > 1), then an n-dispatch and a 2n-dispatch window
   with ``torch.cuda.synchronize`` at each boundary, differenced so the
   constant costs cancel; twice, so the probe knows its own spread. Each
   candidate's graphs are freed before the next.

The winner is the default unless a candidate beats the default's measured
rate by more than the probes' own spread: on the card the run-to-run
spread is larger than most knobs' effect.

Output: a versioned table of the port's own schema (``torch_version``,
the card's name and power limit in every entry), keyed on
``baseline.base_fingerprint_key``, which ``--autotuned_config=PATH``
applies at startup with a logged provenance line. A table of the JAX
package (its rows name ``jax_version`` and were tuned on a TPU) is
refused with a message.

``warm`` builds every kernel the table's configurations route to into the
kernels' build directory (ops/_build.py) ahead of a run. A CUDA graph is
not persisted: each process captures its own at its first dispatch.
"""

from __future__ import annotations

import collections
import gc
import itertools
import json
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kf_benchmarks_tpu_torch.analysis import baseline
from kf_benchmarks_tpu_torch.analysis.baseline import TUNED_KNOBS

TABLE_SCHEMA = "kf_benchmarks_tpu_torch.tuned_configs"
TABLE_SCHEMA_VERSION = 1
TABLE_FILENAME = "tuned_configs_torch.json"

# Knobs that do not shape the traced step (the host-side feed depth; a
# K-step dispatch replays the same step): left out of the static key, so
# candidates differing only in them share one trace.
NON_PROGRAM_KNOBS = ("steps_per_dispatch", "input_prefetch_depth")

# Static-prune defaults. The HBM budget is the card's total memory less
# this reserve (the CUDA context, cuBLAS / cuDNN workspaces, the graphs'
# pools); without a card it is an explicit argument.
HBM_RESERVE_BYTES = 4 * 2**30
DEFAULT_MAX_COLLECTIVES = 256
DEFAULT_MAX_STEP_BUCKETS = 64

# Cost-model constants: the NVIDIA H100 SXM data sheet (dense rates, at
# its 700 W limit), as PERF.md's bounds use them. The model only ranks;
# the probe decides.
COST_PEAK_FLOPS = 989e12           # bf16 tensor-core peak
COST_HBM_BYTES_PER_S = 3.35e12     # HBM3
COST_LINK_BYTES_PER_S = 4.5e11     # NVLink 4: 450 GB/s a direction
COST_COLLECTIVE_LATENCY_S = 1e-5   # one NCCL call's launch, order of it
# The host time of one dispatch is the port's own dispatch_overhead_s
# (benchmark.py's stat): the probe of the default candidate
# measures it before the others are ranked; a dry run takes it as an
# argument and leaves the term out without one.


class AutotuneError(ValueError):
  """A tuned-config table problem (missing or invalid file, bad entry)."""


def hbm_budget_bytes(device=None) -> Optional[int]:
  """The card's memory less HBM_RESERVE_BYTES, or None without a card."""
  import torch
  if not torch.cuda.is_available():
    return None
  index = torch.device(device or "cuda").index or 0
  total = torch.cuda.get_device_properties(index).total_memory
  return int(total) - HBM_RESERVE_BYTES


# -- candidate grid --------------------------------------------------------------

def default_axes(base_params) -> "collections.OrderedDict[str, tuple]":
  """The per-knob candidate values of a base config (``None`` is the
  knob's default); an axis appears only where the base config consumes
  it."""
  axes: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
  axes["steps_per_dispatch"] = (1, 2, 4, 8)
  axes["num_grad_accum"] = (1, 2, 4)
  if bool(getattr(base_params, "overlap_gradient_reduction", False)) or \
      bool(getattr(base_params, "shard_params", False)):
    axes["reduce_bucket_mb"] = (None, 1, 4, 16)
  if getattr(base_params, "model", None) == "transformer_lm":
    axes["attn_block"] = (None, 256, 512, 1024)
  if getattr(base_params, "data_dir", None):
    axes["input_prefetch_depth"] = (None, 2, 4)
  return axes


def _canon(knobs: Dict[str, Any]) -> str:
  return json.dumps(knobs, sort_keys=True)


def merged_overrides(base: Dict[str, Any],
                     knobs: Dict[str, Any]) -> Dict[str, Any]:
  """Base overrides plus a candidate's knobs; a ``None`` knob is the flag
  default and removes any base override of it."""
  out = dict(base)
  for k, v in knobs.items():
    if v is None:
      out.pop(k, None)
    else:
      out[k] = v
  return out


def enumerate_candidates(axes: Dict[str, tuple],
                         defaults: Dict[str, Any],
                         seed: int = 0,
                         max_candidates: int = 24
                         ) -> List[Dict[str, Any]]:
  """The cross product of ``axes``, subsampled with ``seed`` to
  ``max_candidates``, the default candidate always present and first
  (the JAX package's enumeration, kept exact)."""
  default_cand = collections.OrderedDict(
      (k, defaults.get(k)) for k in axes)
  seen = {_canon(default_cand)}
  grid: List[Dict[str, Any]] = []
  for combo in itertools.product(*(axes[k] for k in axes)):
    cand = collections.OrderedDict(zip(axes, combo))
    c = _canon(cand)
    if c in seen:
      continue
    seen.add(c)
    grid.append(cand)
  if len(grid) + 1 > max_candidates:
    rng = random.Random(seed)
    keep = sorted(rng.sample(range(len(grid)),
                             max(0, max_candidates - 1)))
    grid = [grid[i] for i in keep]
  return [default_cand] + grid


# -- the static oracle: prune and rank ----------------------------------------------

def _live_bytes(contract) -> int:
  return max(int(contract.peak_live_bytes or 0),
             int(contract.largest_tensor_bytes or 0))


def prune_reasons(contract, *,
                  hbm_budget_bytes: Optional[int] = None,
                  max_collectives: int = DEFAULT_MAX_COLLECTIVES,
                  max_step_buckets: int = DEFAULT_MAX_STEP_BUCKETS
                  ) -> List[str]:
  """The bounds a candidate's contract must meet before it may run;
  reasons (empty = survives)."""
  out = []
  live = _live_bytes(contract)
  if hbm_budget_bytes and live > hbm_budget_bytes:
    out.append(f"peak live tensor bytes {live} exceed the HBM budget "
               f"{hbm_budget_bytes} B")
  n = len(contract.collectives)
  if max_collectives and n > max_collectives:
    out.append(f"{n} collectives exceed the per-step cap {max_collectives}")
  for aux_key, what in (("overlap_step_buckets", "overlap bucket"),
                        ("fsdp_step_gathers", "FSDP gather bucket")):
    planned = contract.aux.get(aux_key)
    if planned is not None and max_step_buckets and \
        int(planned) > max_step_buckets:
      out.append(f"{planned} planned {what}s exceed the cap "
                 f"{max_step_buckets} (each bucket's launch would eat the "
                 "overlap)")
  return out


def candidate_cost(contract, overrides: Dict[str, Any],
                   dispatch_overhead_s: float = 0.0) -> float:
  """A deterministic per-step cost estimate from the contract: monotone
  in collective bytes and count and in live bytes, decreasing in K. The
  host term is the measured host time of a one-step dispatch, paid once
  a microbatch (each launches the step's kernels again) and shared by the
  K steps of a dispatch. It ranks only."""
  k = int(overrides.get("steps_per_dispatch") or 1)
  m = int(overrides.get("num_grad_accum") or 1)
  flops = float(contract.aux.get("flops") or 0.0)
  coll_bytes = sum(c.nbytes for c in contract.collectives)
  return (flops / COST_PEAK_FLOPS
          + coll_bytes / COST_LINK_BYTES_PER_S
          + len(contract.collectives) * COST_COLLECTIVE_LATENCY_S
          + _live_bytes(contract) / COST_HBM_BYTES_PER_S
          + dispatch_overhead_s * m / max(k, 1))


def static_overrides(merged: Dict[str, Any]) -> Dict[str, Any]:
  """The candidate's program-shaping projection (NON_PROGRAM_KNOBS
  dropped): what the oracle traces, and its memo key."""
  return {k: v for k, v in merged.items() if k not in NON_PROGRAM_KNOBS}


def make_tracer(world: int = 1) -> Callable:
  """The oracle: ``tracer(overrides, program)`` traces the step on fake
  tensors at ``world`` ranks (a world of 1 has no process group, as a
  single-card run has none), with its FLOPs counted, memoized."""
  from kf_benchmarks_tpu_torch.analysis import contracts
  memo: Dict[str, Any] = {}

  def tracer(overrides, program="train_step"):
    key = repr(sorted(overrides.items())) + program
    if key not in memo:
      memo[key] = contracts.trace_contract(dict(overrides), world=world,
                                           program=program,
                                           count_flops=True)
    return memo[key]

  return tracer


# -- the measured probe ----------------------------------------------------------------

def measure_candidate(overrides: Dict[str, Any], probe_dispatches: int = 4,
                      repeats: int = 2,
                      probe_steps: Optional[int] = None) -> Dict[str, float]:
  """One candidate on the card: the run's own build (BenchmarkCNN), one
  warm dispatch (kernel builds, first-use set-up, the K > 1 graph's
  capture), then ``repeats`` differential pairs of an n-dispatch and a
  2n-dispatch window, ``torch.cuda.synchronize`` at every boundary.
  Returns ``images_per_sec`` (the pairs' mean), ``spread`` ((max - min) /
  mean of the pairs' rates) and ``dispatch_s`` (the mean host time of a
  timed dispatch call: benchmark.py's dispatch_overhead_s).
  ``probe_steps`` sizes the short window in steps instead (n =
  probe_steps // K dispatches, at least one), so every K probes the same
  work. The candidate's graphs and memory are freed before it returns."""
  import torch
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import params as params_lib

  merged = dict(overrides)
  k = int(merged.get("steps_per_dispatch") or 1)
  n = max(1, int(probe_steps) // k if probe_steps else
          int(probe_dispatches))
  merged.setdefault("num_batches", max(100, (1 + 3 * n * repeats) * k))
  merged.setdefault("num_warmup_batches", 0)
  bench = benchmark.BenchmarkCNN(params_lib.make_params(**merged))
  module, step, images, labels = bench.build()
  chunk = bench._make_chunk(step)
  device = bench.device
  calls: List[float] = []

  def sync():
    if device.type == "cuda":
      torch.cuda.synchronize(device)

  def dispatch():
    t0 = time.perf_counter()
    if chunk is not None:
      chunk(images, labels, k)
    else:
      step(images, labels)
    calls.append(time.perf_counter() - t0)

  try:
    dispatch()  # warm: builds, first-use set-up, the graph's capture
    sync()
    calls.clear()

    def window(m: int) -> float:
      sync()
      t0 = time.perf_counter()
      for _ in range(m):
        dispatch()
      sync()
      return time.perf_counter() - t0

    rates = []
    for _ in range(max(1, int(repeats))):
      t_short = window(n)
      t_long = window(2 * n)
      rates.append(n * k * bench.batch_size * bench.world_size
                   / max(t_long - t_short, 1e-9))
    mean = sum(rates) / len(rates)
    return {"images_per_sec": mean,
            "spread": (max(rates) - min(rates)) / mean,
            "dispatch_s": sum(calls) / len(calls)}
  finally:
    del chunk, step, module, images, labels
    gc.collect()
    if device.type == "cuda":
      torch.cuda.empty_cache()


def _measured(value) -> Dict[str, Optional[float]]:
  """A measure_fn's answer as a dict: a bare rate has spread 0 and no
  dispatch time."""
  if isinstance(value, dict):
    return {"images_per_sec": float(value["images_per_sec"]),
            "spread": float(value.get("spread") or 0.0),
            "dispatch_s": value.get("dispatch_s")}
  return {"images_per_sec": float(value), "spread": 0.0, "dispatch_s": None}


# -- the search -------------------------------------------------------------------------

def autotune_config(base: Dict[str, Any], *,
                    seed: int = 0,
                    axes: Optional[Dict[str, tuple]] = None,
                    hbm_budget: Optional[int] = None,
                    max_collectives: int = DEFAULT_MAX_COLLECTIVES,
                    max_step_buckets: int = DEFAULT_MAX_STEP_BUCKETS,
                    top_k: int = 3,
                    max_candidates: int = 24,
                    probe_dispatches: int = 4,
                    probe_steps: Optional[int] = None,
                    dispatch_overhead_s: Optional[float] = None,
                    tracer: Optional[Callable] = None,
                    measure_fn: Optional[Callable] = None,
                    dry_run: bool = False,
                    card: Optional[Dict[str, Any]] = None,
                    log: Callable[[str], None] = print
                    ) -> Tuple[str, Dict[str, Any]]:
  """prune -> rank -> probe for one base config; ``(table key, entry)``.

  ``tracer(overrides, program)`` and ``measure_fn(overrides)`` (a rate,
  or measure_candidate's dict) are injectable: the tests drive them and
  count the probes. ``dispatch_overhead_s`` is the cost model's host time
  a dispatch; without it the default's probe measures it (a dry run then
  leaves the term out). ``dry_run`` stops after the static stages
  (nothing runs) and records the cost model's favourite. ``card`` is the
  probed card's ``{"name", "power_limit"}``."""
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch import validation

  base = dict(base)
  base.setdefault("device", "gpu")
  base_params = params_lib.make_params(**base)
  base_dict = base_params._asdict()
  key = baseline.base_fingerprint_key(base_dict, "train_step")
  axes = collections.OrderedDict(axes if axes is not None
                                 else default_axes(base_params))
  defaults = {k: base_dict.get(k) for k in axes}
  candidates = enumerate_candidates(axes, defaults, seed=seed,
                                    max_candidates=max_candidates)
  world = int(base.get("num_devices") or 1)
  tracer = tracer or make_tracer(world)
  measure_fn = measure_fn or (lambda m: measure_candidate(
      m, probe_dispatches, probe_steps=probe_steps))
  name = base_params.model

  n_invalid = n_pruned = 0
  survivors: List[Tuple[int, Dict[str, Any], Dict[str, Any], Any]] = []
  default_cand = candidates[0]
  default_pruned = False
  for i, cand in enumerate(candidates):
    m = merged_overrides(base, cand)
    try:
      p = params_lib.make_params(**m)
      validation.validate_cross_flags(p)
      validation.check_grad_accum_divides(
          int(p.num_grad_accum or 1), int(p.batch_size or 0) or
          _model_batch(p), p.model)
      contract = tracer(static_overrides(m), "train_step")
    except (validation.ParamError, ValueError) as e:
      n_invalid += 1
      log(f"autotune[{name}]: candidate {_canon(cand)} invalid: {e}")
      continue
    reasons = prune_reasons(contract, hbm_budget_bytes=hbm_budget,
                            max_collectives=max_collectives,
                            max_step_buckets=max_step_buckets)
    if reasons:
      n_pruned += 1
      default_pruned |= i == 0
      log(f"autotune[{name}]: candidate {_canon(cand)} pruned "
          f"statically: {'; '.join(reasons)}")
      continue
    survivors.append((i, cand, m, contract))

  entry: Dict[str, Any] = {
      "model": name,
      "program": "train_step",
      "base_config": {k: v for k, v in base.items() if k not in TUNED_KNOBS},
      "default": dict(defaults),
      "candidates": len(candidates),
      "invalid": n_invalid,
      "pruned": n_pruned,
      "seed": seed,
      "dry_run": bool(dry_run),
      "hbm_budget_bytes": hbm_budget,
      "torch_version": _torch_version(),
      "device_name": (card or {}).get("name"),
      "power_limit": (card or {}).get("power_limit"),
  }
  if default_pruned:
    log(f"autotune[{name}]: the base config breaks the static bounds; no "
        "probe runs, the table keeps the defaults")
    entry.update(tuned=dict(defaults), probed=0, probes=[],
                 default_images_per_sec=None, tuned_images_per_sec=None,
                 probe_spread=None, dispatch_overhead_s=dispatch_overhead_s,
                 note="base config pruned by the static oracle")
    return key, entry

  def ranked(overhead):
    costs = [(candidate_cost(contract, m, overhead or 0.0), cand)
             for _, cand, m, contract in survivors]
    costs.sort(key=lambda t: (t[0], _canon(t[1])))
    return [cand for _, cand in costs]

  if dry_run:
    order = ranked(dispatch_overhead_s)
    entry.update(tuned=dict(order[0] if order else default_cand), probed=0,
                 probes=[], default_images_per_sec=None,
                 tuned_images_per_sec=None, probe_spread=None,
                 dispatch_overhead_s=dispatch_overhead_s)
    return key, entry

  def probe_one(cand):
    got = _measured(measure_fn(merged_overrides(base, cand)))
    log(f"autotune[{name}]: probe {_canon(cand)} -> "
        f"{got['images_per_sec']:.1f} images/s (spread "
        f"{100 * got['spread']:.1f}%)")
    return cand, got

  # The default first: its probe measures the dispatch overhead the cost
  # model ranks the others with. Then the cost-ranked top-k.
  measured = [probe_one(default_cand)]
  overhead = (dispatch_overhead_s if dispatch_overhead_s is not None
              else measured[0][1]["dispatch_s"])
  seen = {_canon(default_cand)}
  for cand in ranked(overhead):
    if len(measured) >= top_k + 1:
      break
    if _canon(cand) not in seen:
      seen.add(_canon(cand))
      measured.append(probe_one(cand))
  # A candidate wins only by more than the probes' own spread: ties and
  # noise keep the default.
  spread = max(got["spread"] for _, got in measured)
  d_ips = measured[0][1]["images_per_sec"]
  best_cand, best_ips = default_cand, d_ips
  for cand, got in measured[1:]:
    ips = got["images_per_sec"]
    if ips > d_ips * (1.0 + spread) and ips > best_ips:
      best_cand, best_ips = cand, ips
  entry.update(
      tuned=dict(best_cand), probed=len(measured),
      probes=[{"knobs": dict(c), "images_per_sec": round(
          got["images_per_sec"], 2), "spread": round(got["spread"], 4)}
              for c, got in measured],
      default_images_per_sec=round(d_ips, 2),
      tuned_images_per_sec=round(best_ips, 2),
      probe_spread=round(spread, 4),
      dispatch_overhead_s=(None if overhead is None
                           else round(float(overhead), 6)))
  return key, entry


def _model_batch(p) -> int:
  from kf_benchmarks_tpu_torch.models import model_config
  return model_config.get_model_config(p.model, p).get_batch_size()


def _torch_version() -> str:
  import torch
  return torch.__version__


def new_table(seed: int = 0) -> Dict[str, Any]:
  return {"schema": TABLE_SCHEMA, "schema_version": TABLE_SCHEMA_VERSION,
          "seed": seed, "torch_version": _torch_version(), "entries": {}}


def autotune_configs(bases: List[Dict[str, Any]], *,
                     out: Optional[str] = None, seed: int = 0,
                     log: Callable[[str], None] = print,
                     **kwargs) -> Dict[str, Any]:
  """Search each base config in turn; return (and with ``out`` write)
  the table."""
  table = new_table(seed)
  for base in bases:
    key, entry = autotune_config(dict(base), seed=seed, log=log, **kwargs)
    table["entries"][key] = entry
    log(f"autotune[{entry['model']}]: entry {key} tuned="
        f"{_canon(entry['tuned'])} default={entry['default_images_per_sec']}"
        f" tuned_ips={entry['tuned_images_per_sec']}")
  if out:
    write_table(table, out)
    log(f"tuned-config table written: {out} ({len(table['entries'])} "
        f"entr{'y' if len(table['entries']) == 1 else 'ies'})")
  return table


# -- table I/O and validation ----------------------------------------------------------

def write_table(table: Dict[str, Any], path: str) -> str:
  """Atomic, canonical write: the same seed, contracts and measurements
  give a byte-identical file."""
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  tmp = path + ".tmp"
  with open(tmp, "w", encoding="utf-8") as f:
    json.dump(table, f, indent=2, sort_keys=True)
    f.write("\n")
  os.replace(tmp, path)
  return path


def load_table(path: str) -> Dict[str, Any]:
  """The table at ``path``; AutotuneError for an unreadable file, one
  that is not the port's schema (the JAX package's table names
  ``jax_version`` and was tuned on a TPU), or one without entries."""
  try:
    with open(path, encoding="utf-8") as f:
      table = json.load(f)
  except OSError as e:
    raise AutotuneError(f"tuned-config table unreadable: {path}: {e}")
  except ValueError as e:
    raise AutotuneError(f"tuned-config table is not valid JSON: {path}: "
                        f"{e}")
  if not isinstance(table, dict):
    raise AutotuneError(f"tuned-config table is not an object: {path}")
  if table.get("schema") != TABLE_SCHEMA:
    jax_rows = "jax_version" in table or any(
        isinstance(e, dict) and "jax_version" in e
        for e in (table.get("entries") or {}).values())
    what = ("a table of the JAX package (its rows name jax_version and "
            "were tuned for a TPU)" if jax_rows else
            f"not a table of the port (schema {table.get('schema')!r})")
    raise AutotuneError(
        f"{path} is {what}; --autotuned_config reads only the port's "
        f"tables (schema {TABLE_SCHEMA!r}), written by `python -m "
        "kf_benchmarks_tpu_torch.analysis autotune` on the card")
  if not isinstance(table.get("entries"), dict):
    raise AutotuneError(f"tuned-config table has no entries object: {path}")
  return table


def validate_table(table: Dict[str, Any], *, rederive: bool = True
                   ) -> Tuple[List[str], List[str]]:
  """(problems, warnings) of a table, the JAX package's verdicts: a
  schema out of range, a knob outside the registry, a non-integer knob, a
  tuned rate below the entry's own default rate and (``rederive``) a key
  that its base config no longer derives are problems; an entry recorded
  under another torch version is a warning."""
  problems: List[str] = []
  warnings: List[str] = []
  ver = table.get("schema_version")
  if not isinstance(ver, int) or not 1 <= ver <= TABLE_SCHEMA_VERSION:
    problems.append(f"schema_version {ver!r} outside "
                    f"[1, {TABLE_SCHEMA_VERSION}]")
  entries = table.get("entries")
  if not isinstance(entries, dict):
    return problems + ["entries missing or not an object"], warnings
  current = _torch_version()
  for key in sorted(entries):
    entry = entries[key]
    where = f"entry {key[:16]}"
    if not isinstance(entry, dict):
      problems.append(f"{where}: not an object")
      continue
    tuned = entry.get("tuned")
    if not isinstance(tuned, dict):
      problems.append(f"{where}: tuned knobs missing")
      tuned = {}
    for k, v in sorted(tuned.items()):
      if k not in TUNED_KNOBS:
        problems.append(f"{where}: tuned knob {k!r} is not in the knob "
                        f"registry {list(TUNED_KNOBS)}")
      elif k == "partitioner":
        if v is not None and v not in ("manual", "gspmd"):
          problems.append(f"{where}: tuned value partitioner={v!r} is not "
                          "'manual', 'gspmd', or null")
      elif v is not None and (isinstance(v, bool) or not isinstance(v, int)):
        problems.append(f"{where}: tuned value {k}={v!r} is not an integer "
                        "or null")
    d_ips = entry.get("default_images_per_sec")
    t_ips = entry.get("tuned_images_per_sec")
    if d_ips is not None and t_ips is not None and t_ips < d_ips:
      problems.append(f"{where}: tuned_images_per_sec {t_ips} < the entry's "
                      f"own default measurement {d_ips} -- the search must "
                      "never emit a measured regression over its own bar")
    if entry.get("torch_version") and entry["torch_version"] != current:
      warnings.append(f"{where}: recorded under torch "
                      f"{entry['torch_version']} (current {current}); the "
                      "tuning may be stale -- regenerate on the new runtime")
    if rederive:
      base_cfg = entry.get("base_config")
      if not isinstance(base_cfg, dict):
        problems.append(f"{where}: base_config missing")
        continue
      try:
        from kf_benchmarks_tpu_torch import params as params_lib
        derived = baseline.base_fingerprint_key(
            params_lib.make_params(**base_cfg)._asdict(),
            entry.get("program", "train_step"))
      except Exception as e:  # noqa: BLE001 -- any build failure is one
        problems.append(f"{where}: base_config does not build: {e}")
        continue
      if derived != key:
        problems.append(f"{where}: fingerprint does not re-derive (got "
                        f"{derived[:16]}): a program-shaping flag changed "
                        "underneath the table -- regenerate it with "
                        "`python -m kf_benchmarks_tpu_torch.analysis "
                        "autotune`")
  return problems, warnings


# -- startup application ---------------------------------------------------------------

def lookup_entry(path: str, params) -> Tuple[str, Optional[Dict[str, Any]]]:
  """(base key, entry or None) of resolved Params in the table at
  ``path``."""
  table = load_table(path)
  key = baseline.base_fingerprint_key(params._asdict(), "train_step")
  entry = table["entries"].get(key)
  return key, entry if isinstance(entry, dict) else None


def apply_tuned_config(params, log_fn: Callable[[str], None] = print):
  """--autotuned_config at startup: the entry of the run's base
  fingerprint replaces the tuned knobs, with one provenance line either
  way. ``(params, provenance)``: provenance is ``{path, entry}`` (entry
  None when the table had no row), None without the flag."""
  path = getattr(params, "autotuned_config", None)
  if not path:
    return params, None
  from kf_benchmarks_tpu_torch import validation
  if params.eval or params.forward_only:
    raise validation.ParamError(validation.AUTOTUNED_EVAL_MESSAGE)
  try:
    key, entry = lookup_entry(path, params)
  except AutotuneError as e:
    raise validation.ParamError(str(e))
  if entry is None:
    log_fn(f"autotuned config: no entry for base fingerprint {key} in "
           f"{path}; running with the flag values")
    return params, {"path": path, "entry": None}
  tuned = {k: v for k, v in (entry.get("tuned") or {}).items()
           if k in TUNED_KNOBS and k in params._fields}
  params = params._replace(**tuned)
  applied = ", ".join(f"{k}={tuned[k]}" for k in sorted(tuned))
  log_fn(f"autotuned config: applied {applied} from {path} (entry {key}, "
         f"model {entry.get('model')}, measured "
         f"{entry.get('tuned_images_per_sec')} vs default "
         f"{entry.get('default_images_per_sec')} images/s on "
         f"{entry.get('device_name')}, {entry.get('power_limit')})")
  return params, {"path": path, "entry": key}


# -- warming -------------------------------------------------------------------------------

# The kernels' custom ops (torch.ops.kf_torch.*) by the library that
# holds each (ops/_build.py names).
KERNEL_LIBRARIES = {
    "conv3x3_same": "conv3x3_same",
    "bn_relu_conv3x3_stats": "bn_relu_conv3x3_stats",
    "flash_attention_fwd": "flash_attention_fwd",
    "flash_attention_bwd_dkv": "flash_attention_bwd",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "flash_decode": "flash_decode",
}


def kernels_of(overrides: Dict[str, Any],
               tracer: Optional[Callable] = None) -> List[str]:
  """The kernel libraries a config's step routes to on the card: the
  kernels' custom ops its traced step calls (contracts.ProgramContract
  ``kernel_calls``)."""
  contract = (tracer or make_tracer())(static_overrides(overrides),
                                       "train_step")
  return sorted({KERNEL_LIBRARIES.get(op, op) for op in
                 contract.kernel_calls})


def warm(table_path: str, log: Callable[[str], None] = print
         ) -> Dict[str, Any]:
  """Build every kernel the table's configurations route to into the
  kernels' build directory (ops/_build.py ``build_all``: one nvcc per
  source, all started together). A CUDA graph is not persisted: each
  process captures its own at its first dispatch."""
  from kf_benchmarks_tpu_torch.ops import _build
  table = load_table(table_path)
  tracer = make_tracer()
  wanted = set()
  for key in sorted(table["entries"]):
    entry = table["entries"][key]
    wanted.update(kernels_of(merged_overrides(
        dict(entry.get("base_config") or {}), entry.get("tuned") or {}),
        tracer))
  log("warm: a CUDA graph is not persisted; each run captures its own at "
      "its first dispatch")
  if not wanted:
    log("warm: the table's configurations route to no hand-written kernel")
    return {"kernels": [], "build_dir": None}
  out_dir = _build.build_all()
  log(f"warm: built {sorted(wanted)} into {out_dir}")
  return {"kernels": sorted(wanted), "build_dir": out_dir}
