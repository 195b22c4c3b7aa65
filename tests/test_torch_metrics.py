"""The port's metric fabric (kf_benchmarks_tpu_torch/metrics.py) and its
fingerprints (analysis/baseline.py) against the JAX package's.

Tolerance: none -- every comparison is equality:

* the Prometheus text of one scripted registry session (gauges, counters,
  labeled series, histograms, info keys), ``validate_prometheus_text`` on
  it and on broken payloads, ``flatten_stats`` / ``publish_stats`` of one
  stats dict;
* ``run_record`` (less the version key and the card's name),
  ``validate_record`` on good and broken records, ``check_regression`` /
  ``verdict_line`` / ``metric_direction`` / ``snapshot_check`` on the same
  synthetic histories, ``fleet_rows`` / ``format_fleet_report`` on the
  same store;
* the fingerprint of one params dict restricted to the flags both
  packages have (the port keys on the torch version where the JAX package
  keys on jax's).

Then the port's own behaviour: ``MetricsServer`` serves /metrics and
/healthz on 127.0.0.1, the store promotes a card's first record, and the
``report`` subcommand prints the trend table.
"""

import json
import urllib.request

import pytest
import torch

from kf_benchmarks_tpu import metrics as jax_metrics
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu.analysis import baseline as jax_baseline
from kf_benchmarks_tpu_torch import metrics as port_metrics
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch.analysis import baseline as port_baseline

MODULES = (jax_metrics, port_metrics)


def test_port_schema_is_a_subset_of_the_jax_schema():
  for key, spec in port_metrics.SCHEMA.items():
    jspec = jax_metrics.SCHEMA[key]
    assert (spec.kind, spec.unit, spec.labels, spec.higher_is_better) == \
        (jspec.kind, jspec.unit, jspec.labels, jspec.higher_is_better), key
    # The help text too, but for the platform's values (gpu | cpu).
    assert spec.help == jspec.help or key == "platform", key
  for key in ("images_per_sec", "compile_s", "dispatch_overhead_s",
              "run_id", "chunk_wall_p99", "health/grad_norm", "step",
              "chunk_wall_s", "feed_wait_s", "compile_ledger/shapes"):
    assert key in port_metrics.SCHEMA, key


def _session(mod):
  reg = mod.MetricRegistry()
  reg.set("images_per_sec", 1445.5)
  reg.set("loss", float("nan"))
  reg.set("step_images_per_sec", float("inf"))
  reg.inc("step", 3)
  reg.inc("step")
  reg.set("health/grad_norm", 1.25)
  reg.set("run_id", 'run-"1"')
  reg.set("platform", "gpu")
  reg.inc("serving/requests", 2, labels={"tenant": "a"})
  reg.inc("serving/shed", 1, labels={"tenant": "b", "shed_reason": "queue"})
  for v in (0.0004, 0.03, 0.2, 7.0, 100.0):
    reg.observe("chunk_wall_s", v)
    reg.observe("serving/ttft_s", v / 2, labels={"tenant": "a"})
  reg.observe("serving/accept_len", 3.0)
  return reg


def test_prometheus_text_and_validation_match():
  regs = [_session(mod) for mod in MODULES]
  texts = [r.render() for r in regs]
  assert texts[0] == texts[1]
  assert json.dumps(regs[0].snapshot(), sort_keys=True) == \
      json.dumps(regs[1].snapshot(), sort_keys=True)
  assert port_metrics.validate_prometheus_text(texts[1]) == []
  broken = [
      texts[1] + "not a sample\n",
      texts[1].replace('le="+Inf"} 5', 'le="+Inf"} 4'),
      "# TYPE kf_x histogram\nkf_x_bucket 1\n",
      "# TYPE kf_x histogram\nkf_x_bucket{le=\"1\"} 2\n"
      "kf_x_bucket{le=\"2\"} 1\n",
      "# TYPE kf_x wrong\n",
      'kf_x{a="1",} 1\n',
  ]
  for text in broken:
    got = port_metrics.validate_prometheus_text(text)
    assert got and got == jax_metrics.validate_prometheus_text(text), text


def test_flatten_and_publish_stats_match():
  stats = {"images_per_sec": 100.0, "num_steps": 12, "num_workers": 1,
           "compile_s": 1.5, "dispatch_overhead_s": None, "run_id": "r",
           "health": {"grad_norm": 2.0, "records": 12},
           "latency_percentiles": {"chunk_wall_p50": 0.1,
                                   "feed_wait_p99": None},
           "compile_ledger": {"shapes": 2, "total_compile_s": 3.0},
           "stopped_early": False, "losses": [1.0, 2.0],
           "serving_tenants": {"a": {"serving/tokens_per_sec": 5.0,
                                     "serving/shed": {"queue": 2}}}}
  flat = [mod.flatten_stats(stats) for mod in MODULES]
  assert flat[0] == flat[1]
  regs = [mod.MetricRegistry() for mod in MODULES]
  for mod, reg in zip(MODULES, regs):
    mod.publish_stats(reg, stats)
  assert regs[0].render() == regs[1].render()


def _record(mod, value, t, run_id, fp="f" * 16, **kw):
  version_key = ("jax_version" if mod is jax_metrics else "torch_version")
  return mod.run_record(metric="images_per_sec", value=value,
                        unit="images/sec", fingerprint=fp, run_id=run_id,
                        platform="cpu", git_rev="abc1234",
                        snapshot={"images_per_sec": value,
                                  "health/grad_norm": 1.0},
                        t_wall=t, **{version_key: "v"}, **kw)


def test_run_record_and_validation_match():
  jrec, prec = (_record(mod, 10.0, 5.0, "r") for mod in MODULES)
  assert prec.pop("torch_version") == jrec.pop("jax_version") == "v"
  assert prec.pop("device_name") is None
  assert prec == jrec
  assert port_metrics.validate_record(prec) == []
  broken = [None, dict(prec, schema_version=2), dict(prec, value=True),
            dict(prec, value=float("nan"), metric=""),
            dict(prec, fallback=1, snapshot=[]),
            dict(prec, snapshot={"nope": 1.0, "loss": [1]}),
            dict(prec, snapshot={'serving/requests{bucket="1"}': 1.0,
                                 "images_per_sec{": 2.0})]
  for rec in broken:
    got = port_metrics.validate_record(rec)
    assert got and got == jax_metrics.validate_record(rec), rec


@pytest.mark.parametrize("values,fresh,direction", [
    ([100.0, 101.0, 99.0, 100.5, 98.0], 80.0, True),   # a 20% drop
    ([100.0, 103.0, 97.0, 104.0, 96.0], 95.0, True),   # noise
    ([100.0, 100.0], 50.0, True),                      # too little history
    ([0.10, 0.11, 0.09, 0.10], 0.13, False),           # latency up
    ([0.10, 0.11, 0.09, 0.10], 0.05, False),           # latency down
])
def test_regression_verdicts_match(values, fresh, direction):
  out = []
  for mod in MODULES:
    history = [_record(mod, v, float(i), f"r{i}") for i, v in
               enumerate(values)]
    history.append(_record(mod, 1.0, 99.0, "other", fp="0" * 16))
    rec = _record(mod, fresh, 100.0, "fresh")
    verdict = mod.check_regression(history, rec, higher_is_better=direction)
    out.append((verdict, mod.verdict_line(verdict),
                mod.snapshot_check(history, rec, "health/grad_norm"),
                mod.snapshot_check(history, rec, "absent")))
  assert out[0] == out[1]


def test_metric_direction_matches():
  for key in list(port_metrics.SCHEMA) + [
      "serving/ttft_p99{tenant=\"a\"}", "chunk_wall_s/count", "x_per_sec",
      "top_5_accuracy", "some_latency", "custom"]:
    assert port_metrics.metric_direction(key) == \
        jax_metrics.metric_direction(key), key


def test_fleet_report_matches(tmp_path):
  texts = []
  for mod in MODULES:
    records = [_record(mod, v, float(i), f"r{i}")
               for i, v in enumerate([10.0, 11.0, 10.5, 7.0])]
    records.append(_record(mod, 3.0, 9.0, "x", fp="1" * 16))
    rows = mod.fleet_rows(records)
    texts.append(mod.format_fleet_report(rows))
    assert [r["verdict"] for r in rows] == ["no_history", "regression"]
  assert texts[0] == texts[1]


def test_fingerprint_of_the_shared_flags_matches():
  shared = [k for k in port_params.Params._fields
            if k in jax_params.Params._fields]
  assert len(shared) > 120
  port = port_params.make_params(model="resnet50", batch_size=32,
                                 steps_per_dispatch=8, trace_file="/x",
                                 metrics_port=9000)._asdict()
  config = {k: port[k] for k in shared}
  assert port_baseline.PROGRAM_SHAPE_EXCLUDE == \
      jax_baseline.PROGRAM_SHAPE_EXCLUDE
  assert port_baseline.TUNED_KNOBS == jax_baseline.TUNED_KNOBS
  for program in ("train_step", "train_chunk", "bench"):
    shape = {k: jax_baseline._canonical_value(v) for k, v in config.items()
             if v is not None and k not in jax_baseline.PROGRAM_SHAPE_EXCLUDE}
    want = jax_baseline.fingerprint_key(
        {"config": shape, "program": program, "torch": torch.__version__})
    assert port_baseline.config_fingerprint_key(config, program) == want
  # Sinks do not move the key; a program-shaping flag does.
  key = port_baseline.config_fingerprint_key(port)
  assert port_baseline.config_fingerprint_key(
      dict(port, trace_file=None, run_store_dir="/y")) == key
  assert port_baseline.config_fingerprint_key(
      dict(port, batch_size=64)) != key
  assert port_baseline.config_fingerprint_key(
      dict(port, batch_size=32.0)) == key
  assert port_baseline.base_fingerprint_key(port) == \
      port_baseline.base_fingerprint_key(dict(port, steps_per_dispatch=1,
                                              num_batches=7))


def test_metrics_server_serves_metrics_and_healthz():
  reg = _session(port_metrics)
  server = port_metrics.MetricsServer(reg, 0,
                                      healthz_fn=lambda: {"status": "ok"})
  try:
    base = f"http://127.0.0.1:{server.port}"
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
      text = r.read().decode()
      assert r.headers["Content-Type"].startswith("text/plain")
    assert text == reg.render()
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
      assert json.loads(r.read()) == {"status": "ok"}
    with pytest.raises(urllib.error.HTTPError):
      urllib.request.urlopen(base + "/nope", timeout=10)
  finally:
    server.close()
  assert port_metrics.resolve_port(9000, 3) == 9003


def test_store_promotes_a_cards_first_record_and_reports(tmp_path, capsys):
  store = port_metrics.RunStore(str(tmp_path))
  cpu = store.append(_record(port_metrics, 5.0, 1.0, "a"))
  assert not cpu["baseline"]
  gpu = [store.append(dict(_record(port_metrics, v, 2.0 + i, f"g{i}"),
                           platform="gpu")) for i, v in enumerate([9, 8])]
  assert [r["baseline"] for r in gpu] == [True, False]
  with open(store.path, "a") as f:
    f.write("{torn\n")
  assert len(store.records()) == 3
  with pytest.raises(ValueError, match="invalid run record"):
    store.append(dict(_record(port_metrics, 1.0, 3.0, "z"), value="x"))
  assert port_metrics.main(["report", "--run_store_dir",
                            str(tmp_path)]) == 0
  out = capsys.readouterr().out
  assert "images_per_sec" in out and "1 trend row(s) over 3 record(s)" in out
  port_metrics.main(["report", "--run_store_dir", str(tmp_path / "none")])
  assert "no matching run records" in capsys.readouterr().out
