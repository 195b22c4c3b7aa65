"""CLI: ``python -m kf_benchmarks_tpu_torch.analysis [audit|autotune|warm|all]``.

The port's counterpart of kf_benchmarks_tpu/analysis/__main__.py, with its
exit-status rules: nonzero on any rule violation, golden diff, schedule
drift, world-size divergence or tuned-table problem (a table recorded
under another torch version is a warning only).

``audit`` traces every golden config on the fake process group (world 8,
fake tensors: nothing runs, no card needed), runs every rule, diffs each
contract against its golden in ``analysis/golden_contracts/``, checks the
ordered schedules (analysis/spmd.py) and validates the tuned table named
by ``--table``. ``--write-goldens`` rewrites the goldens instead.

``autotune`` runs the search (analysis/autotune.py) for the named models
and writes a table; it probes on the card, and ``--dry-run`` stops after
the static stages (the CPU rehearsal). ``warm`` builds every kernel a
table's configurations route to. ``lint`` (the JAX package's AST pass
with its rank-divergence leg) is not ported: it exits 2 naming its
ROADMAP item. ``all`` is ``audit``.

    python -m kf_benchmarks_tpu_torch.analysis audit [--configs a,b] [--json F]
    python -m kf_benchmarks_tpu_torch.analysis audit --write-goldens
    python -m kf_benchmarks_tpu_torch.analysis autotune --models resnet50 \\
        --batch_size 256 --use_fp16 --out tuned_configs_torch.json
    python -m kf_benchmarks_tpu_torch.analysis warm --table T
"""

from __future__ import annotations

import argparse
import json
import sys

LINT_ITEM = "ROADMAP Queue 1 item 14"


def run_tuned_table_audit(args) -> int:
  """Validate the table ``--table`` names (problems fail, warnings do
  not)."""
  from kf_benchmarks_tpu_torch.analysis import autotune
  if not getattr(args, "table", None):
    return 0
  try:
    table = autotune.load_table(args.table)
  except autotune.AutotuneError as e:
    print(f"TUNED-TABLE PROBLEM [{args.table}] {e}")
    return 1
  problems, warnings = autotune.validate_table(table)
  for p in problems:
    print(f"TUNED-TABLE PROBLEM [{args.table}] {p}")
  for w in warnings:
    print(f"tuned-table warning [{args.table}] {w}")
  print(f"tuned-table audit: {len(problems)} problem(s), {len(warnings)} "
        "warning(s)")
  return 1 if problems else 0


def run_audit(args) -> int:
  from kf_benchmarks_tpu_torch.analysis import audit, baseline, contracts
  from kf_benchmarks_tpu_torch.analysis import spmd

  known = dict(contracts.GOLDEN_CONFIGS)
  known.update(contracts.SERVING_GOLDEN_CONFIGS)
  names = args.configs.split(",") if args.configs else list(known)
  unknown = [n for n in names if n not in known]
  if unknown:
    print(f"unknown golden config(s): {unknown}; have {list(known)}")
    return 2
  tracer = audit.make_memo_tracer()
  configs = {n: known[n] for n in names}
  report = audit.audit_configs(configs, tracer=tracer)

  def contract_of(name):
    return tracer(dict(known[name]), audit.program_of(known[name]))

  diff_total = 0
  for name in names:
    if args.write_goldens:
      print(f"golden written: {baseline.write_golden(name, contract_of(name))}")
      continue
    diffs = baseline.check_against_golden(name, contract_of(name))
    report["configs"][name]["golden_diffs"] = [
        {"field": f, "golden": g, "current": c} for f, g, c in diffs]
    diff_total += len(diffs)
    for f, g, c in diffs:
      print(f"GOLDEN DIFF [{name}] {f}: golden={g!r} current={c!r}")

  spmd_total = 0
  if not args.write_goldens:
    drift = []
    for name in names:
      for msg in spmd.schedule_drift(name, contract_of(name)):
        drift.append({"config": name, "message": msg})
        print(f"SPMD SCHEDULE DRIFT [{name}] {msg}")
    train = {n: c for n, c in configs.items()
             if n in contracts.GOLDEN_CONFIGS}
    ws = spmd.audit_world_sizes(spmd.sharded_world_size_configs(train),
                                tracer)
    for name, verdict in sorted(ws["verdicts"].items()):
      print(f"spmd world-size [{name}] sizes={verdict['sizes']}: "
            f"{verdict['classification']}")
    for v in ws["violations"]:
      print(f"SPMD DIVERGENCE [{v['config']}] {v['message']}")
    report["spmd"] = {"schedule_drift": drift, "world_size": ws}
    spmd_total = len(drift) + len(ws["violations"])
    print(f"spmd audit: {len(drift)} schedule drift(s), "
          f"{len(ws['violations'])} world-size divergence(s) across "
          f"{len(ws['verdicts'])} sharded config(s)")

  from kf_benchmarks_tpu_torch import observability
  for name, entry in report["configs"].items():
    if name in contracts.GOLDEN_CONFIGS:
      print(f"audit [{name}]: "
            f"{observability.overlap_fraction_line(contract_of(name))}")
    for v in entry["violations"]:
      print(f"CONTRACT VIOLATION [{name}] [{v['rule']}] {v['message']}")
    status = ("OK" if not entry["violations"]
              and not entry.get("golden_diffs") else "FAIL")
    print(f"audit [{name}]: {status} ({entry['collectives']} collectives, "
          f"{entry['gradient_collectives']} gradient, "
          f"{entry['in_backward_collectives']} in-backward, "
          f"{entry['in_loop_collectives']} per-microbatch)")
  if args.json:
    with open(args.json, "w", encoding="utf-8") as f:
      json.dump(report, f, indent=2, sort_keys=True)
    print(f"report written: {args.json}")
  print(f"program-contract audit: {report['violations']} violation(s), "
        f"{diff_total} golden diff(s) across {len(names)} config(s)")
  if args.write_goldens:
    return 1 if report["violations"] else 0
  rc_tables = run_tuned_table_audit(args)
  return 1 if (report["violations"] or diff_total or spmd_total
               or rc_tables) else 0


def run_autotune(args) -> int:
  from kf_benchmarks_tpu_torch.analysis import autotune
  models = [m for m in (args.models or "").split(",") if m]
  if not models:
    print("autotune: pass --models model[,model...]")
    return 2
  bases = []
  for model in models:
    base = {"model": model, "device": args.device}
    if args.batch_size:
      base["batch_size"] = args.batch_size
    if args.use_fp16:
      base["use_fp16"] = True
    bases.append(base)
  card = None
  budget = args.hbm_budget_bytes
  if not args.dry_run:
    card = card_info()
    budget = budget or autotune.hbm_budget_bytes()
  table = autotune.autotune_configs(
      bases, out=args.out, seed=args.seed, top_k=args.top_k,
      max_candidates=args.max_candidates,
      probe_dispatches=args.probe_dispatches, dry_run=args.dry_run,
      hbm_budget=budget, card=card)
  problems, _ = autotune.validate_table(table)
  for p in problems:
    print(f"TUNED-TABLE PROBLEM {p}")
  return 1 if problems else 0


def card_info():
  """The card's name and power limit as nvidia-smi prints them (None
  where it cannot say)."""
  import subprocess
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()
  except (OSError, subprocess.SubprocessError):
    return None
  if not out:
    return None
  name, _, limit = out[0].partition(",")
  return {"name": name.strip(), "power_limit": limit.strip()}


def run_warm(args) -> int:
  from kf_benchmarks_tpu_torch.analysis import autotune
  if not args.table:
    print("warm: pass --table (a tuned-config table of the port)")
    return 2
  summary = autotune.warm(args.table)
  print(f"warm: {len(summary['kernels'])} kernel librar"
        f"{'y' if len(summary['kernels']) == 1 else 'ies'} built -> "
        f"{summary['build_dir']}")
  return 0


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
      prog="python -m kf_benchmarks_tpu_torch.analysis", description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument("mode", nargs="?", default="all",
                      choices=("all", "lint", "audit", "autotune", "warm"))
  parser.add_argument("--configs", default=None,
                      help="comma-separated golden-config names "
                           "(default: all)")
  parser.add_argument("--json", default=None,
                      help="write the audit report as JSON to this path")
  parser.add_argument("--write-goldens", action="store_true",
                      help="rewrite analysis/golden_contracts/*.json from "
                           "the current tree instead of diffing")
  parser.add_argument("--models", default=None,
                      help="autotune: comma-separated model names")
  parser.add_argument("--batch_size", type=int, default=None,
                      help="autotune: per-device batch for every model")
  parser.add_argument("--use_fp16", action="store_true",
                      help="autotune: bf16 compute")
  parser.add_argument("--device", default="gpu", choices=("gpu", "cpu"),
                      help="autotune: where the probes run")
  parser.add_argument("--out", default=None,
                      help="autotune: tuned-table output path")
  parser.add_argument("--seed", type=int, default=0,
                      help="autotune: candidate-subsample seed")
  parser.add_argument("--top_k", type=int, default=3,
                      help="autotune: cost-ranked survivors to probe")
  parser.add_argument("--max_candidates", type=int, default=24,
                      help="autotune: seeded grid-subsample bound")
  parser.add_argument("--probe_dispatches", type=int, default=4,
                      help="autotune: differential probe window size")
  parser.add_argument("--hbm_budget_bytes", type=int, default=None,
                      help="autotune: memory budget (default: the card's "
                           "memory less a reserve)")
  parser.add_argument("--dry-run", action="store_true", dest="dry_run",
                      help="autotune: static stages only (trace, prune, "
                           "rank); nothing runs")
  parser.add_argument("--table", default=None,
                      help="tuned-config table (warm's input; the audit "
                           "validates it)")
  args = parser.parse_args(argv)
  if args.mode == "lint":
    print("lint: the JAX package's analysis/lint.py (its AST rules and the "
          f"rank-divergence leg) is not ported yet ({LINT_ITEM})")
    return 2
  if args.mode == "autotune":
    return run_autotune(args)
  if args.mode == "warm":
    return run_warm(args)
  return run_audit(args)


if __name__ == "__main__":
  sys.exit(main())
