"""The port's autotuner (kf_benchmarks_tpu_torch/analysis/autotune.py) and
--autotuned_config.

* ``enumerate_candidates``: the same grid and canonical keys as the JAX
  package's for the same axes and seed.
* ``validate_table``: the same verdicts as the JAX package's on the same
  entries (each package's own table schema).
* The search: a statically pruned candidate executes 0 steps; a pruned
  default probes nothing; a candidate within the probes' spread of the
  default does not win; two runs with an injected measure are
  byte-identical; the real fake-tensor oracle on the trivial model, and
  the kernels ResNet-50 routes to.
* --autotuned_config: a port table applies its knobs with the provenance
  in the stats and the run record (a CPU run of the trivial model); the
  JAX package's tuned_configs.json is refused with a message; --eval and
  --forward_only are refused; no entry keeps the flags; the CLI's dry run
  writes a valid table.
"""

import collections
import copy
import json
import os
import subprocess
import sys

import pytest

from kf_benchmarks_tpu.analysis import autotune as jax_autotune
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.analysis import autotune
from kf_benchmarks_tpu_torch.analysis import baseline
from kf_benchmarks_tpu_torch.analysis import contracts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(model="trivial", batch_size=4, device="cpu")


@pytest.mark.parametrize("axes,defaults,seed,max_candidates", [
    ((("steps_per_dispatch", (1, 2, 4, 8)), ("num_grad_accum", (1, 2, 4))),
     {"steps_per_dispatch": 1, "num_grad_accum": 1}, 0, 24),
    ((("steps_per_dispatch", (1, 2, 4, 8)), ("num_grad_accum", (1, 2, 4)),
      ("input_prefetch_depth", (None, 2, 4))),
     {"steps_per_dispatch": 1, "num_grad_accum": 1}, 0, 12),
    ((("steps_per_dispatch", (1, 2, 4, 8)), ("num_grad_accum", (1, 2)),
      ("reduce_bucket_mb", (None, 1, 4, 16))),
     {"steps_per_dispatch": 2, "num_grad_accum": 1}, 7, 6),
    ((("attn_block", (None, 256, 512, 1024)),),
     {"attn_block": 512}, 3, 24),
])
def test_candidates_match_the_jax_package(axes, defaults, seed,
                                          max_candidates):
  axes = collections.OrderedDict(axes)
  ours = autotune.enumerate_candidates(axes, defaults, seed, max_candidates)
  theirs = jax_autotune.enumerate_candidates(axes, defaults, seed,
                                             max_candidates)
  assert [list(c.items()) for c in ours] == [list(c.items())
                                             for c in theirs]
  assert [autotune._canon(c) for c in ours] == [jax_autotune._canon(c)
                                                for c in theirs]


def _entry(**kw):
  entry = {"model": "trivial", "program": "train_step",
           "base_config": {}, "tuned": {"steps_per_dispatch": 4},
           "default_images_per_sec": 10.0, "tuned_images_per_sec": 12.0}
  entry.update(kw)
  return entry


# (case, entry changes, table changes): each package's validator on its
# own table of the same content.
TABLE_CASES = [
    ("clean", {}, {}),
    ("unknown_knob", {"tuned": {"not_a_knob": 3}}, {}),
    ("non_integer", {"tuned": {"steps_per_dispatch": 2.5}}, {}),
    ("bool_knob", {"tuned": {"num_grad_accum": True}}, {}),
    ("bad_partitioner", {"tuned": {"partitioner": "auto"}}, {}),
    ("regression", {"tuned_images_per_sec": 9.0}, {}),
    ("tuned_missing", {"tuned": None}, {}),
    ("schema_version", {}, {"schema_version": 9}),
    ("stale_version", {"version": "0.0.1"}, {}),
]


@pytest.mark.parametrize("case,entry_kw,table_kw", TABLE_CASES,
                         ids=[c[0] for c in TABLE_CASES])
def test_validate_table_verdicts_match_the_jax_package(case, entry_kw,
                                                       table_kw):
  verdicts = []
  for mod, version_key in ((autotune, "torch_version"),
                           (jax_autotune, "jax_version")):
    kw = dict(entry_kw)
    if "version" in kw:
      kw[version_key] = kw.pop("version")
    table = {"schema": autotune.TABLE_SCHEMA, "schema_version": 1,
             "entries": {"k": _entry(**kw)}}
    table.update(table_kw)
    problems, warnings = mod.validate_table(table, rederive=False)
    verdicts.append((len(problems), len(warnings)))
  assert verdicts[0] == verdicts[1]
  assert verdicts[0] == ((0, 0) if case == "clean" else
                         (0, 1) if case == "stale_version" else
                         (verdicts[0][0], 0))


def _contract(peak=0, collectives=0, flops=1e9):
  return contracts.ProgramContract(
      config={}, program="train_step",
      collectives=[contracts.Collective(kind="all-reduce", dtype="f32",
                                        elems=1 << 20, placement="top_level",
                                        group_size=8, index=i)
                   for i in range(collectives)],
      host_transfers=[], optimizer_applies=1, optimizer_apply_in_loop=False,
      state_in_place=True, in_place_tensors=1, largest_tensor_bytes=0,
      largest_tensor_type="", peak_live_bytes=peak, aux={"flops": flops})


def _seeded_tracer(overrides, program):
  """M = 4 is the over-budget class; the rest fit."""
  accum = int(overrides.get("num_grad_accum") or 1)
  return _contract(peak=10 ** 13 if accum == 4 else 10 ** 6)


def _measure(merged):
  k = int(merged.get("steps_per_dispatch") or 1)
  m = int(merged.get("num_grad_accum") or 1)
  return {"images_per_sec": 100.0 + 10 * k - m, "spread": 0.01,
          "dispatch_s": 0.01}


def test_pruned_candidates_execute_zero_steps():
  executed = []

  def counting(merged):
    executed.append(dict(merged))
    return _measure(merged)

  key, entry = autotune.autotune_config(
      dict(BASE), tracer=_seeded_tracer, measure_fn=counting,
      hbm_budget=10 ** 9, log=lambda s: None)
  assert entry["candidates"] == 12 and entry["pruned"] == 4
  assert executed and all(int(m.get("num_grad_accum") or 1) != 4
                          for m in executed)
  assert entry["probed"] == len(executed) == 4
  assert entry["tuned"] == {"steps_per_dispatch": 8, "num_grad_accum": 1}
  assert entry["tuned_images_per_sec"] >= entry["default_images_per_sec"]
  assert key == baseline.base_fingerprint_key(
      params_lib.make_params(**BASE)._asdict())


def test_pruned_default_probes_nothing():
  def must_not_run(merged):
    raise AssertionError("a pruned config ran")

  _, entry = autotune.autotune_config(
      dict(BASE), tracer=lambda o, p: _contract(peak=10 ** 13),
      measure_fn=must_not_run, hbm_budget=10 ** 9, log=lambda s: None)
  assert entry["probed"] == 0 and entry["pruned"] == entry["candidates"]
  assert entry["tuned"] == entry["default"]


def test_a_win_inside_the_spread_keeps_the_default():
  def noisy(merged):
    k = int(merged.get("steps_per_dispatch") or 1)
    return {"images_per_sec": 100.0 + k * 0.1, "spread": 0.05,
            "dispatch_s": 0.0}

  _, entry = autotune.autotune_config(
      dict(BASE), tracer=_seeded_tracer, measure_fn=noisy,
      hbm_budget=10 ** 9, log=lambda s: None)
  assert entry["probed"] > 1
  assert entry["tuned"] == entry["default"]
  assert entry["tuned_images_per_sec"] == entry["default_images_per_sec"]


def test_search_is_byte_identical_across_runs(tmp_path):
  paths = [str(tmp_path / f"t{i}.json") for i in (0, 1)]
  for path in paths:
    autotune.autotune_configs(
        [dict(BASE)], seed=7, max_candidates=6, tracer=_seeded_tracer,
        measure_fn=_measure, hbm_budget=10 ** 9, log=lambda s: None,
        out=path)
  with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
    assert a.read() == b.read()


def test_the_fake_tensor_oracle_ranks_the_trivial_model():
  """The real oracle: every candidate traced on fake tensors (K and the
  prefetch depth share a trace), nothing run; the dry run records the
  cost model's favourite, a K > 1 once a dispatch costs host time."""
  tracer = autotune.make_tracer(world=1)
  base = dict(BASE, batch_size=2)
  key, entry = autotune.autotune_config(
      base, tracer=tracer, dry_run=True, dispatch_overhead_s=0.01,
      hbm_budget=10 ** 10, log=lambda s: None)
  assert entry["invalid"] == 4  # a batch of 2 does not split into M = 4
  assert entry["pruned"] == 0 and entry["probed"] == 0
  assert entry["tuned"]["steps_per_dispatch"] == 8
  contract = tracer(base, "train_step")
  assert contract.aux["flops"] > 0 and contract.collectives == []


def test_resnet50_routes_to_the_conv_kernels():
  assert autotune.kernels_of(dict(model="resnet50", batch_size=2,
                                  use_fp16=True)) == [
      "bn_relu_conv3x3_stats", "conv3x3_same"]
  assert autotune.kernels_of(dict(BASE)) == []


# -- --autotuned_config ------------------------------------------------------------

def _port_table(tmp_path, tuned):
  table = autotune.new_table()
  p = params_lib.make_params(**BASE)
  key = baseline.base_fingerprint_key(p._asdict())
  table["entries"][key] = _entry(
      base_config=dict(BASE), tuned=tuned, torch_version=None)
  path = str(tmp_path / autotune.TABLE_FILENAME)
  autotune.write_table(table, path)
  return path, key


def test_a_port_table_applies_its_knobs_with_provenance(tmp_path):
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  path, key = _port_table(tmp_path, {"steps_per_dispatch": 2,
                                     "num_grad_accum": 2})
  store = str(tmp_path / "store")
  p = params_lib.make_params(**BASE, autotuned_config=path, num_batches=2,
                             num_warmup_batches=0, run_store_dir=store)
  bench = benchmark.BenchmarkCNN(p)
  assert (bench.params.steps_per_dispatch, bench.params.num_grad_accum) == (
      2, 2)
  assert bench.num_grad_accum == 2
  stats = bench.run()
  assert stats["tuned_config"] == {"path": path, "entry": key}
  (record,) = metrics_lib.RunStore(store).records()
  assert record["snapshot"]["tuned_config_path"] == path
  assert record["snapshot"]["tuned_config_entry"] == key
  assert not metrics_lib.validate_record(record)


def test_no_entry_keeps_the_flags(tmp_path):
  path, _ = _port_table(tmp_path, {"steps_per_dispatch": 2})
  lines = []
  p = params_lib.make_params(**dict(BASE, batch_size=8),
                             autotuned_config=path)
  applied, prov = autotune.apply_tuned_config(p, log_fn=lines.append)
  assert applied == p and prov == {"path": path, "entry": None}
  assert "no entry" in lines[0]


def test_the_jax_packages_table_is_refused():
  path = os.path.join(REPO, "tuned_configs.json")
  with open(path) as f:
    assert "jax_version" in json.load(f)
  p = params_lib.make_params(**BASE, autotuned_config=path)
  with pytest.raises(validation.ParamError,
                     match="table of the JAX package.*jax_version"):
    autotune.apply_tuned_config(p, log_fn=lambda s: None)


@pytest.mark.parametrize("mode", ["eval", "forward_only"])
def test_autotuned_config_is_refused_outside_training(tmp_path, mode):
  path, _ = _port_table(tmp_path, {"steps_per_dispatch": 2})
  p = params_lib.make_params(**BASE, autotuned_config=path, **{mode: True})
  with pytest.raises(validation.ParamError,
                     match="--eval or --forward_only") as port_err:
    validation.validate_cross_flags(p)
  from kf_benchmarks_tpu import params as jax_params
  from kf_benchmarks_tpu import validation as jax_validation
  with pytest.raises(jax_validation.ParamError) as jax_err:
    jax_validation.validate_cross_flags(jax_params.make_params(
        model="trivial", device="cpu", autotuned_config=path,
        **{mode: True}))
  assert str(port_err.value) == str(jax_err.value)


def test_the_cli_dry_run_writes_a_valid_table(tmp_path):
  out = str(tmp_path / "t.json")
  proc = subprocess.run(
      [sys.executable, "-m", "kf_benchmarks_tpu_torch.analysis", "autotune",
       "--models", "trivial", "--batch_size", "4", "--device", "cpu",
       "--dry-run", "--max_candidates", "4", "--out", out],
      capture_output=True, text=True, cwd=REPO, timeout=300,
      env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stdout + proc.stderr
  table = autotune.load_table(out)
  assert autotune.validate_table(table) == ([], [])
  (entry,) = table["entries"].values()
  assert entry["dry_run"] and entry["probed"] == 0
  assert copy.deepcopy(entry["base_config"]) == {"model": "trivial",
                                                  "device": "cpu",
                                                  "batch_size": 4}
