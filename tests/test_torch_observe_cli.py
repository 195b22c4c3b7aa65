"""The observability slice as a whole, on the CPU.

* The same small training config (the trivial model on one fixed batch,
  from one init) through the JAX package's BenchmarkCNN and the port's,
  with every flag of the slice on: the span names on each lane of the
  --trace_events_file timeline (the profiler's marker named by its
  profiler), the names of the metric.log rows, the keys of every scalar
  summary event and the files each dump writes are the same, and the step
  losses agree within 1e-5 relative (the f32 trivial model: the two
  frameworks' convolutions differ in summation order).
* The twin pins, torch against torch: with every flag on and with all off,
  the losses and the final weights are bitwise equal at K = 1 and at K = 8
  (the CPU runs eager chunks); the flags-on run's /metrics endpoint serves
  valid Prometheus text with the live lanes during the run, and its
  /healthz answers.
* The flags: the slice's 14 with the JAX package's defaults (but
  --eval_dir, which the port leaves unset), its refusals and messages;
  --autotuned_config refused outside training; kfrun's endpoint list.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import benchmark as jax_benchmark
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.models import trivial_model as jax_trivial
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import flags
from kf_benchmarks_tpu_torch import metrics as metrics_lib
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import trivial_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_FLAGS = ("trace_file", "trace_events_file", "use_chrome_trace_format",
               "tfprof_file", "graph_file", "partitioned_graph_file_prefix",
               "run_store_dir", "benchmark_log_dir", "benchmark_test_id",
               "eval_dir", "save_summaries_steps", "summary_verbosity",
               "compilation_cache_dir", "metrics_port")


def _free_port() -> int:
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    return sock.getsockname()[1]


def _sinks(root, **extra):
  f = lambda name: os.path.join(root, name)
  return dict(trace_file=f("trace/step.json"), tfprof_file=f("tfprof.json"),
              graph_file=f("graph.txt"), partitioned_graph_file_prefix=f(
                  "partitioned"), trace_events_file=f("events.json"),
              benchmark_log_dir=f("log"), benchmark_test_id="t",
              summary_verbosity=1, save_summaries_steps=1,
              train_dir=f("train"), run_store_dir=f("store"),
              compilation_cache_dir=f("cache"), **extra)


def _lanes(path):
  with open(path) as f:
    events = json.load(f)["traceEvents"]
  lanes = {}
  for e in events:
    if e["ph"] != "M":
      name = "profiler_trace" if e["cat"] == "profiler" else e["name"]
      lanes.setdefault(e["cat"], set()).add(name)
  return lanes


def _jsonl(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def test_jax_and_port_runs_with_every_flag_on_match(tmp_path, monkeypatch):
  rng = np.random.default_rng(0)
  images = (np.clip(rng.normal(size=(2, 227, 227, 3)), -2, 2) * 60.0 +
            127.0).astype(np.float32)
  labels = rng.integers(0, 1001, size=2).astype(np.int32)
  variables = jax.device_get(jax_trivial.TrivialModel().make_module(
      nclass=1001, phase_train=True).init(jax.random.PRNGKey(0),
                                          jnp.asarray(images)))
  base = dict(model="trivial", device="cpu", batch_size=2, num_batches=4,
              num_warmup_batches=2, display_every=1, init_learning_rate=0.01,
              health_stats=False)

  class JaxFixed(jax_trivial.TrivialModel):

    def get_synthetic_inputs(self, rng, nclass):
      return jnp.asarray(images), jnp.asarray(labels)

  jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
  bench = jax_benchmark.BenchmarkCNN(
      jax_params.make_params(**base, **_sinks(jroot)), model=JaxFixed())
  build = bench._build

  def build_from_variables():
    init_state, *rest = build()

    def init(rng, x):
      state = init_state(rng, x)
      return state.replace(params=jax.tree.map(
          lambda a, v: jnp.asarray(v, a.dtype)[None], state.params,
          variables["params"]))
    return (init, *rest)

  bench._build = build_from_variables
  bench.run()

  class Fixed(trivial_model.TrivialModel):

    def make_module(self, nclass, dtype=torch.float32, generator=None):
      m = super().make_module(nclass, dtype, generator)
      m.load_state_dict(convert.flax_to_state_dict(variables, m))
      return m

    def get_synthetic_inputs(self, generator, nclass, device):
      return torch.from_numpy(images), torch.from_numpy(labels).long()

  monkeypatch.setitem(model_config._MODELS, "trivial", Fixed)
  stats = benchmark.BenchmarkCNN(params_lib.make_params(
      **base, **_sinks(proot))).run()
  assert _lanes(os.path.join(proot, "events.json")) == \
      _lanes(os.path.join(jroot, "events.json"))
  rows = {root: _jsonl(os.path.join(root, "log", "metric.log"))
          for root in (jroot, proot)}
  assert [r["name"] for r in rows[proot]] == [r["name"] for r in rows[jroot]]
  losses = {root: [r["value"] for r in rows[root]
                   if r["name"] == "total_loss"] for root in rows}
  assert len(losses[proot]) == 4
  np.testing.assert_allclose(losses[proot], losses[jroot], rtol=1e-5)
  np.testing.assert_allclose(stats["losses"], losses[jroot], rtol=1e-5)
  summaries = {root: [(e["step"], sorted(e["scalars"])) for e in _jsonl(
      os.path.join(root, "train", "events.jsonl"))] for root in rows}
  assert summaries[proot] == summaries[jroot]
  for name in ("graph.txt", "partitioned.txt", "tfprof.json",
               "tfprof.json.ops.txt", "tfprof.json.measured_ops.txt",
               "train/compile_ledger.json", "store/run_store.jsonl",
               "log/benchmark_run.log"):
    for root in rows:
      assert os.path.getsize(os.path.join(root, name)) > 0, (root, name)
  record = _jsonl(os.path.join(proot, "store", "run_store.jsonl"))[0]
  assert metrics_lib.validate_record(record) == []
  assert record["platform"] == "cpu" and record["torch_version"]


def _scrape(port, stop, out):
  while not stop.is_set():
    try:
      with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=2) as r:
        text = r.read().decode()
      if "\nkf_step " in "\n" + text:
        out["metrics"] = text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=2) as r:
          out["healthz"] = json.loads(r.read())
        return
    except OSError:
      pass
    stop.wait(0.01)


@pytest.mark.parametrize("k", [1, 8])
def test_flags_on_and_off_are_bitwise_equal(tmp_path, k):
  base = dict(model="resnet20", data_name="cifar10", device="cpu",
              batch_size=2, num_batches=2 * k, num_warmup_batches=2 * k,
              display_every=1, steps_per_dispatch=k, optimizer="momentum",
              health_stats=False)
  runs = {}
  for arm in ("off", "on"):
    port = _free_port()
    extra = (_sinks(str(tmp_path), metrics_port=port) if arm == "on"
             else {})
    scraped, stop = {}, threading.Event()
    scraper = threading.Thread(target=_scrape, args=(port, stop, scraped),
                               daemon=True)
    if arm == "on":
      scraper.start()
    bench = benchmark.BenchmarkCNN(params_lib.make_params(**base, **extra))
    try:
      stats = bench.run()
    finally:
      stop.set()
    if arm == "on":
      scraper.join(timeout=10)
    runs[arm] = (stats, [p.detach().clone()
                         for p in bench.final["module"].parameters()],
                 scraped)
  (off, w_off, _), (on, w_on, scraped) = runs["off"], runs["on"]
  assert on["losses"] == off["losses"] and len(on["losses"]) == 2 * k
  assert all(torch.equal(a, b) for a, b in zip(w_on, w_off))
  # The traced dispatch: the last warmup one, outside the timed window.
  assert on["traced_dispatch"]["index"] == (2 * k - 1 if k == 1 else 1)
  assert not on["traced_dispatch"]["timed"]
  assert off["traced_dispatch"] is None and on["step_flops"] > 0
  assert metrics_lib.validate_prometheus_text(scraped["metrics"]) == []
  assert scraped["healthz"]["status"] == "ok"
  assert on["compile_ledger"]["entries"][0]["program"] == (
      "train_step" if k == 1 else "train_chunk")


def test_slice_flags_defaults_and_refusals():
  for name in SLICE_FLAGS:
    spec, jspec = flags.param_specs[name], jax_params.flags.param_specs[name]
    assert spec.flag_type == jspec.flag_type, name
    if name != "eval_dir":
      assert spec.default_value == jspec.default_value, name
    assert spec.description
  assert params_lib.make_params().eval_dir is None
  for bad in (dict(summary_verbosity=4), dict(metrics_port=70000),
              dict(metrics_port=0)):
    with pytest.raises(ValueError, match="bound"):
      params_lib.make_params(**bad)
  # --autotuned_config is ported (analysis/autotune.py); outside training
  # it is refused with the JAX package's message (a case below).
  assert params_lib.make_params(
      autotuned_config="tuned.json").autotuned_config == "tuned.json"
  cases = [dict(trace_events_file="/t.json", eval=True),
           dict(autotuned_config="tuned.json", forward_only=True),
           dict(metrics_port=9000, forward_only=True),
           dict(run_store_dir="/s", eval=True),
           dict(summary_verbosity=2, shard_params=True,
                shard_optimizer_state=True, num_devices=2,
                variable_update="replicated", optimizer="momentum")]
  for kw in cases:
    flags_kw = dict(model="resnet50", device="cpu", **kw)
    with pytest.raises(jax_validation.ParamError) as jerr:
      jax_validation.validate_cross_flags(jax_params.make_params(**flags_kw))
    with pytest.raises(validation.ParamError) as perr:
      validation.validate_cross_flags(params_lib.make_params(**flags_kw))
    # The port's profiler and bench are named as the port's.
    want = str(jerr.value).replace("jax.profiler", "torch.profiler").replace(
        "bench/serving records come from bench.py",
        "bench records come from bench_torch.py")
    assert str(perr.value) == want, kw


def test_kfrun_prints_the_jobs_endpoint_list(tmp_path):
  proc = subprocess.run(
      [sys.executable, "-m", "kf_benchmarks_tpu_torch.kfrun", "-np", "2",
       "--logdir", str(tmp_path), "--", sys.executable, "-c", "pass",
       "--metrics_port=9100"], capture_output=True, text=True, cwd=REPO,
      timeout=120)
  assert proc.returncode == 0, proc.stderr
  assert ("kfrun: metrics endpoints: http://127.0.0.1:9100/metrics, "
          "http://127.0.0.1:9101/metrics") in proc.stderr


def test_eval_writes_summaries_and_logger_rows(tmp_path):
  """--eval (JAX benchmark.py:2083-2100): the pass's scalars in
  --eval_dir's events.jsonl and the three eval rows in metric.log."""
  stats = benchmark.BenchmarkCNN(params_lib.make_params(
      model="trivial", device="cpu", batch_size=2, num_batches=1, eval=True,
      eval_dir=str(tmp_path / "eval"),
      benchmark_log_dir=str(tmp_path / "log"))).run()
  events = _jsonl(str(tmp_path / "eval" / "events.jsonl"))
  assert events == [{"step": 0, "scalars": {
      "eval_top_1_accuracy": stats["top_1_accuracy"],
      "eval_top_5_accuracy": stats["top_5_accuracy"],
      "eval_images_per_sec": stats["eval_images_per_sec"]}}]
  assert [r["name"] for r in _jsonl(str(tmp_path / "log" / "metric.log"))] \
      == ["eval_top_1_accuracy", "eval_top_5_accuracy",
          "eval_images_per_sec"]


def test_a_taken_port_and_the_build_cache_dir(tmp_path, capsys):
  """A --metrics_port another socket holds is logged and the run goes on
  (JAX benchmark.py:808-823); --compilation_cache_dir moves the kernels'
  build root for the run, and no flag puts it back at build/kernels."""
  from kf_benchmarks_tpu_torch.ops import _build
  with socket.socket() as held:
    held.bind(("127.0.0.1", 0))
    held.listen(1)
    port = held.getsockname()[1]
    stats = benchmark.BenchmarkCNN(params_lib.make_params(
        model="trivial", device="cpu", batch_size=2, num_batches=2,
        num_warmup_batches=1, metrics_port=port,
        compilation_cache_dir=str(tmp_path / "cache"))).run()
    assert _build.build_root() == str(tmp_path / "cache")
  assert stats["num_steps"] == 2
  out = capsys.readouterr().out
  assert f"metrics endpoint: bind to port {port} failed" in out
  assert f"Kernel build cache: {tmp_path / 'cache'}" in out
  # The CPU loads no library: never a cache hit.
  assert [e["cache_hit"] for e in stats["compile_ledger"]["entries"]] == [
      False]
  benchmark.BenchmarkCNN(params_lib.make_params(
      model="trivial", device="cpu", batch_size=2, num_batches=1,
      num_warmup_batches=0)).run()
  assert _build.build_root() == _build.BUILD_ROOT
