"""The run store's backfill, schema audit and fleet report
(kf_benchmarks_tpu_torch/metrics.py), and the overlap line
(observability.py).

* ``bench_rows`` reads both committed shapes (the harness's wrapper, raw
  JSONL) as the JAX package's does.
* ``backfill`` ingests the repo's TPU-era BENCH_*.json tagged with their
  platform (tpu, or cpu for the _CPU_FALLBACK probes), idempotently, under
  keys no card run shares; the sentinel never holds an H100 run against a
  TPU row, and the fleet report keeps them in separate sections.
* ``schema_audit`` is clean on this tree and catches an unregistered
  emitted key; the HTML report is self-contained.
* ``collective_overlap_stats`` reads a contract's in-backward share.
"""

import os

import pytest

from kf_benchmarks_tpu import metrics as jax_metrics
from kf_benchmarks_tpu_torch import metrics
from kf_benchmarks_tpu_torch import observability
from kf_benchmarks_tpu_torch.analysis import contracts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_rows_read_both_shapes_like_the_jax_package(tmp_path):
  wrapper = os.path.join(REPO, "BENCH_r01.json")
  assert metrics.bench_rows(wrapper) == jax_metrics.bench_rows(wrapper)
  jsonl = tmp_path / "BENCH_x.json"
  jsonl.write_text('{"metric": "a", "value": 1}\nnot json\n'
                   '{"metric": "b", "value": 2}\n')
  assert metrics.bench_rows(str(jsonl)) == jax_metrics.bench_rows(
      str(jsonl))
  assert len(metrics.bench_rows(str(jsonl))) == 2


def _gpu_record(value, t, run_id, metric="resnet50_synthetic_images_per_sec",
                fingerprint=None):
  return metrics.run_record(
      metric=metric, value=value, unit="images/sec",
      fingerprint=fingerprint or "f" * 16, run_id=run_id, platform="gpu",
      torch_version="2.11.0", device_name="NVIDIA H100 80GB HBM3",
      t_wall=t)


def test_backfill_keeps_tpu_rows_apart_from_h100_runs(tmp_path, capsys):
  store_dir = str(tmp_path / "store")
  ingested, skipped = metrics.backfill(REPO, store_dir, log=lambda s: None)
  names = sorted(n for n in os.listdir(REPO)
                 if n.startswith("BENCH_") and n.endswith(".json"))
  assert ingested == len(names) and skipped == 0
  # Idempotent.
  assert metrics.backfill(REPO, store_dir, log=lambda s: None) == (
      0, len(names))
  store = metrics.RunStore(store_dir)
  recs = store.records()
  for rec in recs:
    assert not metrics.validate_record(rec)
    assert rec["baseline"] is False
    assert rec["platform"] == ("cpu" if rec["fallback"] else "tpu")
  tpu = [r for r in recs if r["platform"] == "tpu"]
  assert tpu and {r["metric"] for r in tpu} == {
      "resnet50_synthetic_images_per_sec"}
  # An H100 run of the same metric name: its own fingerprint, its own
  # baseline, and no verdict against the TPU row.
  for i, v in enumerate((1440.0, 1445.0, 1450.0)):
    store.append(_gpu_record(v, 1e9 + i, f"gpu{i}"))
  recs = store.records()
  gpu = [r for r in recs if r["platform"] == "gpu"]
  assert gpu[0]["baseline"] and not gpu[1]["baseline"]
  assert {r["fingerprint"] for r in gpu}.isdisjoint(
      {r["fingerprint"] for r in tpu})
  # Even under one fingerprint the sentinel compares within a platform.
  tpu_like = dict(tpu[0], fingerprint=gpu[0]["fingerprint"], run_id="t")
  verdict = metrics.check_regression([tpu_like] + gpu[:2], gpu[2])
  assert verdict["n"] == 2 and verdict["status"] == "no_history"
  rows = metrics.fleet_rows(recs)
  assert {(r["platform"], r["n"]) for r in rows if not r["fallback"]} == {
      ("tpu", 1), ("gpu", 3)}
  html = metrics.fleet_report_html(rows)
  assert html.index("Card runs (gpu)") < html.index("Backfilled TPU-era")
  assert html.index("Backfilled TPU-era") < html.index("_CPU_FALLBACK")
  assert "<script" not in html and "http" not in html.split("<body>")[1]
  assert metrics.main(["report", "--run_store_dir", store_dir, "--html",
                       str(tmp_path / "r.html")]) == 0
  out = capsys.readouterr().out
  assert "fleet report written" in out and "tpu" in out
  assert (tmp_path / "r.html").read_text() == html


def test_schema_audit_is_clean_and_catches_an_unregistered_key(tmp_path):
  assert metrics.schema_audit(REPO) == []
  bench = tmp_path / "bench_torch.py"
  bench.write_text('record = {"metric": "m", "value": 1, '
                   '"not_a_metric_key": 2}\n')
  for name in ("BENCH_r01.json",):
    (tmp_path / name).write_text(open(os.path.join(REPO, name)).read())
  problems = metrics.schema_audit(str(tmp_path))
  assert any("'not_a_metric_key'" in p for p in problems)
  (tmp_path / "BENCH_r09.json").write_text('{"metric": "m", "value": 1, '
                                           '"odd_field": 3}')
  assert any("'odd_field'" in p for p in metrics.schema_audit(
      str(tmp_path)))
  assert metrics.main(["audit", "--repo_dir", REPO]) == 0


def test_bench_params_kwargs_build_the_bench_config():
  from kf_benchmarks_tpu_torch import params as params_lib
  p = params_lib.make_params(**metrics.bench_params_kwargs())
  assert (p.model, p.batch_size, p.use_fp16, p.device) == (
      "resnet50", 256, True, "gpu")


def test_overlap_stats_read_the_in_backward_share():
  def coll(placement, elems):
    return contracts.Collective(kind="all-reduce", dtype="f32", elems=elems,
                                placement=placement, group_size=8)
  contract = contracts.ProgramContract(
      config={}, program="train_step",
      collectives=[coll("in_backward", 3 << 20), coll("top_level", 1 << 20)],
      host_transfers=[], optimizer_applies=1, optimizer_apply_in_loop=False,
      state_in_place=True, in_place_tensors=1, largest_tensor_bytes=0,
      largest_tensor_type="", peak_live_bytes=0)
  stats = observability.collective_overlap_stats(contract)
  assert stats["num_collectives"] == 2
  assert stats["overlap_fraction"] == pytest.approx(0.75)
  assert stats["comm_s"] == pytest.approx(
      (4 << 20) * 4 / observability.H100_LINK_BYTES_PER_S)
  assert "75.0% issued inside the backward" in \
      observability.overlap_fraction_line(contract)
  contract.collectives = []
  assert "no collectives" in observability.overlap_fraction_line(contract)
