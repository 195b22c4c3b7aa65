"""The port's run trace (kf_benchmarks_tpu_torch/tracing.py) against the JAX
package's tracing.py.

One scripted span sequence on injected clocks goes through each package's
RunTrace: the Chrome payload, the raw-span JSONL form, a restart
generation extending its file, the rank-0 merge of two ranks, the
standalone merge, the persisted compile ledger and the run-end lines are
byte-equal (tolerance: none). ``validate_chrome_trace`` gives the same
problems on the same good and broken payloads, and the ledger's query
functions the same answers.
"""

import json
import os

import pytest

from kf_benchmarks_tpu import tracing as jax_tracing
from kf_benchmarks_tpu_torch import tracing as port_tracing

MODULES = {"jax": jax_tracing, "port": port_tracing}


class Clock:
  """A monotonic clock that advances 0.125 s a read."""

  def __init__(self, t0: float):
    self.t = t0

  def __call__(self) -> float:
    self.t += 0.125
    return self.t


def _script(mod, path, rank=0, num_ranks=1, chrome=True, run_id="run-x",
            offset=0.0):
  """One RunTrace through the same spans, instants, samples and compile
  episodes."""
  trace = mod.RunTrace(path=path, rank=rank, num_ranks=num_ranks,
                       run_id=run_id, chrome_format=chrome,
                       time_fn=Clock(100.0 + offset),
                       wall_fn=lambda: 1.7e9 + offset)
  with trace.span("run", "warmup", steps=2):
    trace.add_span("dispatch", "train_step", trace.now(), 0.01,
                   {"step": 0, "first_call": True})
  trace.note_compile("abcdef0123456789", "train_step", 2.5, model="trivial",
                     cache_hit=False)
  trace.note_compile("0123456789abcdef", "eval_step", 0.25)
  for i in range(5):
    trace.add_sample("chunk_wall", 0.1 + 0.01 * i)
    trace.add_sample("feed_wait", 0.001 * i)
    trace.add_span("device", "step", trace.now(), 0.1, {"steps": 1})
  trace.instant("faults", "kill@3", step=3, kind="kill")
  with trace.span("checkpoint", "save") as args:
    args["incarnation_bump"] = 0
  trace.add_sample("checkpoint_save", 0.5)
  return trace


def _read(path):
  with open(path, "rb") as f:
    return f.read()


def test_constants_match():
  for name in ("SUBSYSTEMS", "SAMPLE_KEYS", "QUANTILES", "LEDGER_FILENAME"):
    assert getattr(port_tracing, name) == getattr(jax_tracing, name), name


@pytest.mark.parametrize("chrome", [True, False])
def test_export_and_restart_generation_byte_equal(tmp_path, chrome):
  files = {}
  for name, mod in MODULES.items():
    path = str(tmp_path / name / "events.json")
    assert _script(mod, path, chrome=chrome).export() == path
    first = _read(path)
    # A second generation of the same run id extends the file.
    _script(mod, path, chrome=chrome, offset=10.0).export()
    files[name] = (first, _read(path))
  assert files["port"] == files["jax"]
  if chrome:
    payload = json.loads(files["port"][1])
    assert port_tracing.validate_chrome_trace(payload) == []
    assert len(payload["traceEvents"]) > len(json.loads(files["port"][0])[
        "traceEvents"])


def test_rank_merge_and_standalone_merge_byte_equal(tmp_path):
  files = {}
  for name, mod in MODULES.items():
    path = str(tmp_path / name / "events.json")
    _script(mod, path, rank=1, num_ranks=2, offset=0.5).export()
    assert _script(mod, path, rank=0, num_ranks=2).export(
        merge_wait_s=1.0) == path
    merged = _read(path)
    assert mod.rank_path(path, 1) == path[:-len(".json")] + ".rank1.json"
    assert mod.merge_rank_files(path, 2) == path
    files[name] = (merged, _read(path))
  assert files["port"] == files["jax"]
  pids = {e["pid"] for e in json.loads(files["port"][0])["traceEvents"]}
  assert pids == {0, 1}


def test_ledger_file_lines_and_queries_match(tmp_path):
  out = {}
  for name, mod in MODULES.items():
    d = str(tmp_path / name)
    trace = _script(mod, None)
    trace.write_ledger(d)
    trace.write_ledger(d)  # a second run of the same shapes counts up
    ledger = mod.read_ledger(d)
    out[name] = (_read(os.path.join(d, mod.LEDGER_FILENAME)),
                 trace.ledger_lines(), trace.latency_lines(),
                 trace.percentile_fields(), trace.compile_ledger(),
                 sorted(mod.ledger_keys(ledger)),
                 sorted(mod.ledger_programs(ledger)),
                 mod.read_ledger(str(tmp_path / "absent")))
  assert out["port"] == out["jax"]
  assert out["port"][6] == ["eval_step", "train_step"]


def test_validate_chrome_trace_matches_on_broken_payloads():
  good = {"traceEvents": [
      {"ph": "M", "name": "process_name", "pid": 0, "tid": 0},
      {"ph": "X", "name": "a", "pid": 0, "tid": 1, "ts": 1.0, "dur": 2.0},
      {"ph": "i", "name": "b", "pid": 0, "tid": 2, "ts": 3.0}]}
  broken = [
      [], {}, {"traceEvents": 3},
      {"traceEvents": [{"ph": "B", "name": "a", "pid": 0, "tid": 0}]},
      {"traceEvents": [{"ph": "X", "name": "", "pid": "0", "tid": 0,
                        "ts": -1, "dur": None}]},
      {"traceEvents": ["x", {"ph": "i", "name": "a", "pid": 0, "tid": 0}]},
  ]
  assert port_tracing.validate_chrome_trace(good) == []
  for obj in broken:
    got = port_tracing.validate_chrome_trace(obj)
    assert got and got == jax_tracing.validate_chrome_trace(obj), obj


def test_kept_spans_without_a_path():
  """The serving engine's form: spans kept in memory, no export path."""
  trace = port_tracing.RunTrace(keep_spans=True)
  with trace.span("serving", "request", tenant="a"):
    pass
  assert [(s["sub"], s["name"]) for s in trace.spans] == [
      ("serving", "request")]
  assert trace.export() is None
  assert port_tracing.RunTrace().add_span("run", "x", 0.0, 1.0) == 0
