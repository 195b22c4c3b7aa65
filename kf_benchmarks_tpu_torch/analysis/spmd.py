"""Static SPMD divergence analyzer: the collective schedules two ranks must
agree on, checked before any multi-card job runs.

The port's counterpart of kf_benchmarks_tpu/analysis/spmd.py. A
cross-rank collective mismatch hangs a job silently: one rank issues a
collective the others never reach. The audit checks collective
*inventories* (multisets); two programs with equal inventories can still
deadlock each other when their *schedules* -- the order the ranks meet
in -- differ. Two legs, both on the fake process group, nothing runs:

* **Ordered schedules** (:func:`schedule_drift`): every golden pins its
  ``collective_schedule`` (contracts.Collective.schedule_entry rows in
  issue order). A schedule that drifts while the inventory still matches
  fails with the exact regen command.
* **Cross-world-size agreement** (:func:`world_size_verdict`): every
  sharded golden config is traced at world sizes {2, 4, 8}
  (checkpoint.py ``_reshard`` re-slices the shards at any n', so each is
  a reachable elastic size), and the schedules must agree modulo the
  group's size and the order of scalar reductions
  (:func:`schedule_diffs`: the tensor exchange compares as a sequence,
  the scalar metric reductions as a multiset). ``benign_arity`` is the
  expected verdict, ``bug`` (the order changed with the world size) the
  only failing one; ``documented`` is kept for the GSPMD twins of ROADMAP
  item 8.

The third leg of the JAX package, the rank-divergence lint, lives in its
analysis/lint.py and waits with it (ROADMAP).
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

from kf_benchmarks_tpu_torch.analysis.contracts import (
    GOLDEN_CONFIGS, N_REPLICAS, ProgramContract)

# The command the schedule-drift failure names.
REGEN_COMMAND = ("python -m kf_benchmarks_tpu_torch.analysis audit "
                 "--write-goldens")

# The elastic world sizes the agreement leg traces.
WORLD_SIZES = (2, 4, 8)


def schedule_key(entry: Dict[str, Any]) -> Tuple[str, str, str, str]:
  """The arity-free identity of one schedule row: everything two ranks
  must agree on for the collective to rendezvous. Group sizes are
  excluded -- they widen with the world size by construction -- and the
  index is the row's list position."""
  return (entry["kind"], entry["dtype"], entry["rank"],
          entry["placement"])


def normalize_schedule(schedule: List[Dict[str, Any]]
                       ) -> List[Tuple[str, str, str, str]]:
  """A schedule modulo replica-group arity (see :func:`schedule_key`)."""
  return [schedule_key(e) for e in schedule]


def schedule_diffs(ref: List[Dict[str, Any]],
                   other: List[Dict[str, Any]]) -> List[str]:
  """Human-readable divergences of two schedules modulo group arity AND
  modulo the order of scalar reductions; empty when they agree. The JAX
  package's comparison, kept exact: tensor collectives compare as a
  sequence, scalar ones as a multiset (XLA prints independent scalar
  reductions in a topology-dependent textual order). A process group of
  torch.distributed matches collectives by issue order, scalar ones
  included, so the port's verdicts also apply
  :func:`order_diffs`."""
  na, nb = normalize_schedule(ref), normalize_schedule(other)
  ta = [r for r in na if r[2] == "tensor"]
  tb = [r for r in nb if r[2] == "tensor"]
  sa = Counter(r for r in na if r[2] == "scalar")
  sb = Counter(r for r in nb if r[2] == "scalar")
  if ta == tb and sa == sb:
    return []
  out = []
  if ta != tb:
    if len(ta) != len(tb):
      out.append(f"tensor-collective sequence length {len(ta)} vs "
                 f"{len(tb)}")
    for i, (a, b) in enumerate(zip(ta, tb)):
      if a != b:
        out.append(f"first tensor-sequence divergence at position {i}: "
                   f"{'/'.join(a)} vs {'/'.join(b)}")
        break
    else:
      i = min(len(ta), len(tb))
      longer = ta if len(ta) > len(tb) else tb
      if i < len(longer):
        out.append(f"first tensor-sequence divergence at position {i}: "
                   f"trailing {'/'.join(longer[i])} on one side only")
  for row in sorted(set(sa) | set(sb)):
    if sa[row] != sb[row]:
      out.append(f"scalar collective {'/'.join(row)} count "
                 f"{sa[row]} vs {sb[row]}")
  return out


def order_diffs(ref: List[Dict[str, Any]],
                other: List[Dict[str, Any]]) -> List[str]:
  """The strict comparison torch.distributed needs: the whole schedule,
  scalar reductions in place, modulo the group's size. Empty when the
  two agree; else where they first differ."""
  na, nb = normalize_schedule(ref), normalize_schedule(other)
  if na == nb:
    return []
  for i, (a, b) in enumerate(zip(na, nb)):
    if a != b:
      return [f"issue order differs at position {i}: {'/'.join(a)} vs "
              f"{'/'.join(b)} (a process group matches collectives by "
              "issue order)"]
  return [f"schedule length {len(na)} vs {len(nb)}"]


# -- leg (a): ordered-schedule drift vs the golden ----------------------------

def schedule_drift(name: str, contract: ProgramContract) -> List[str]:
  """Schedule drift the inventory diff cannot see: the golden's
  unordered collective inventory still matches, but the ORDERED
  ``collective_schedule`` differs (a reorder, or a same-row swap
  between loop bodies). Returns failure messages naming the exact
  regen command; empty when the schedule holds, when the golden is
  missing (the whole-file diff owns that), or when the inventory
  itself drifted (the field-level golden diff owns that)."""
  from kf_benchmarks_tpu_torch.analysis import baseline

  if not os.path.exists(baseline.golden_path(name)):
    return []
  golden = baseline.load_golden(name)
  current = baseline.contract_fingerprint(contract)
  if golden.get("collectives") != current.get("collectives"):
    return []
  g_sched = golden.get("collective_schedule")
  if g_sched is None:
    return [f"golden '{name}' predates the collective_schedule field -- "
            f"regenerate the goldens: {REGEN_COMMAND}"]
  c_sched = current["collective_schedule"]
  if g_sched == c_sched:
    return []
  where = schedule_diffs(g_sched, c_sched) or ["group arity changed at "
                                               "a fixed topology"]
  for i, (g, c) in enumerate(zip(g_sched, c_sched)):
    if g != c:
      where.append(f"golden[{i}]={g} current[{i}]={c}")
      break
  return [("ordered collective schedule drifted while the inventory "
           f"matched ({'; '.join(where)}) -- an inventory-equal reorder "
           "can still deadlock ranks cross-host; if the change is "
           f"intentional, regenerate: {REGEN_COMMAND}")]


# -- leg (b): cross-world-size agreement --------------------------------------

def sharded_world_size_configs(
    configs: Optional[Dict[str, Dict[str, Any]]] = None
    ) -> Dict[str, Dict[str, Any]]:
  """The golden configs the agreement leg binds on: every sharded
  train config (--shard_optimizer_state; the elastic/multi-host
  family _reshard re-addresses)."""
  configs = GOLDEN_CONFIGS if configs is None else configs
  return {name: dict(cfg) for name, cfg in configs.items()
          if cfg.get("shard_optimizer_state")}


def world_size_verdict(name: str, overrides: Dict[str, Any],
                       tracer: Callable,
                       sizes: Tuple[int, ...] = WORLD_SIZES
                       ) -> Dict[str, Any]:
  """Trace ``overrides`` at every world size; compare the schedules
  modulo group arity against the config's own (golden) size; classify
  (see module docstring). ``tracer(overrides, program)`` is the
  audit's memoized tracer, so the golden size costs nothing extra."""
  own = int(overrides.get("num_devices", N_REPLICAS))
  all_sizes = sorted(set(int(s) for s in sizes) | {own})
  schedules: Dict[int, List[Dict[str, Any]]] = {}
  for s in all_sizes:
    cfg = dict(overrides)
    if s != own:
      cfg["num_devices"] = s
    schedules[s] = tracer(cfg, "train_step").collective_schedule()
  ref = schedules[own]
  diffs: List[Dict[str, Any]] = []
  arity_differs = False
  for s in all_sizes:
    if s == own:
      continue
    d = schedule_diffs(ref, schedules[s]) or order_diffs(ref, schedules[s])
    if d:
      diffs.append({"size": s, "diffs": d})
    elif ([e["group_sizes"] for e in ref] !=
          [e["group_sizes"] for e in schedules[s]]):
      arity_differs = True
  gspmd = overrides.get("partitioner") == "gspmd"
  note = ""
  if diffs and gspmd:
    classification = "documented"
    note = ("GSPMD re-plans the exchange per topology (sharding "
            "divisibility changes with n) -- the documented "
            "reassociation class; tabled, not failed")
  elif diffs:
    classification = "bug"
  elif arity_differs:
    classification = "benign_arity"
  else:
    classification = "agree"
  return {
      "config": name,
      "sizes": all_sizes,
      "golden_size": own,
      "schedule_lengths": {str(s): len(schedules[s]) for s in all_sizes},
      "classification": classification,
      "diffs": diffs,
      "note": note,
  }


def world_size_violations(verdict: Dict[str, Any]) -> List[str]:
  """The failing messages of one verdict: only the ``bug`` class -- a
  step whose meeting order changed with the world size deadlocks."""
  if verdict["classification"] != "bug":
    return []
  out = []
  for d in verdict["diffs"]:
    out.append(
        f"collective schedule at world size {d['size']} diverges from "
        f"the golden size {verdict['golden_size']} "
        f"({'; '.join(d['diffs'])}) -- ranks restarted at different "
        "world sizes would not meet (the multi-card deadlock class); "
        "the schedule must be invariant modulo the group's size")
  return out


def audit_world_sizes(configs: Dict[str, Dict[str, Any]],
                      tracer: Callable,
                      sizes: Tuple[int, ...] = WORLD_SIZES
                      ) -> Dict[str, Any]:
  """Run the agreement leg over ``configs``; returns the report block
  the CLI embeds under ``spmd.world_size`` (per-config verdicts +
  the flat failing messages)."""
  verdicts, violations = {}, []
  for name, overrides in configs.items():
    verdict = world_size_verdict(name, overrides, tracer, sizes)
    verdicts[name] = verdict
    for msg in world_size_violations(verdict):
      violations.append({"config": name, "message": msg})
  return {"verdicts": verdicts, "violations": violations}
