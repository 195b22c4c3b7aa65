"""Metric registry, the live ``/metrics`` endpoint, the run store and its
regression sentinel.

The port's own copy of kf_benchmarks_tpu/metrics.py (stdlib only, nothing
imported from the JAX package):

* ``SCHEMA`` -- the registered metric keys (kind, unit, label names,
  direction) of what the port emits: the training run's stats, the live
  training lanes, the health vector, the latency percentiles and the
  compile ledger, the DeviceFeeder's lanes, the serving engine's keys and
  the bench line's, as the JAX package registers them;
* ``MetricRegistry`` -- ``set`` / ``inc`` / ``observe`` on registered keys
  only, with labels from each key's declared set; histograms keep
  cumulative bins; ``render`` is the Prometheus text exposition (0.0.4)
  that ``validate_prometheus_text`` checks;
* ``activate`` / ``deactivate`` / ``active`` -- the process's registry, or
  a no-op sink; ``flatten_stats`` / ``publish_stats`` -- a run's stats
  onto registered keys;
* ``MetricsServer`` -- ``/metrics`` and ``/healthz`` on 127.0.0.1 from a
  daemon thread (``--metrics_port``; port + rank under kfrun,
  ``resolve_port``);
* ``SLOMonitor`` -- the serving engine's multi-window burn-rate monitor;
* ``run_record`` / ``validate_record`` / ``RunStore`` -- one
  schema-versioned JSON line a run in an append-only store
  (``--run_store_dir``; bench_torch.py's own ``--run_store_dir``): the
  config fingerprint (analysis/baseline.py), git revision, torch version,
  the card's name, platform (``gpu`` or ``cpu``) and the flat metric
  snapshot; the first card record of a fingerprint becomes its baseline.
  There is no default store: nothing is written unless a directory is
  named, so the port's records never share a file with the JAX package's;
* ``check_regression`` / ``verdict_line`` / ``metric_direction`` /
  ``snapshot_check`` -- the MAD-based sentinel over same-fingerprint
  history; ``fleet_rows`` / ``format_fleet_report`` and ``python -m
  kf_benchmarks_tpu_torch.metrics report --run_store_dir D`` -- the
  per-fingerprint trend table.

The JAX package's ``backfill`` of its ``BENCH_*.json`` history, its schema
audit and its HTML report are not ported.
"""

from __future__ import annotations

import collections
import http.server
import json
import math
import os
import re
import socketserver
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from kf_benchmarks_tpu_torch import tracing as _tracing

# The in-step health vector's key order (telemetry.health_finalize builds
# it; telemetry.py re-exports this tuple).
HEALTH_KEYS = ("grad_norm", "update_ratio", "nonfinite_leaves",
               "loss_scale", "skipped")
# Run-end health summary keys (FlightRecorder.summary + watchdog).
HEALTH_SUMMARY_KEYS = ("records", "max_grad_norm", "nonfinite_steps",
                       "loss_scale_final", "anomaly_dumps",
                       "watchdog_stalls")


def health_key(name: str) -> str:
  """The ``health/<key>`` namespace: the one place that prefix is built
  (flight-recorder rows and the summary scalars share it)."""
  return "health/" + name


# The registered label names; a SCHEMA entry declares which of these its
# series may carry.
LABEL_NAMES = ("tenant", "bucket", "shed_reason")


class MetricSpec(NamedTuple):
  name: str
  kind: str    # "counter" | "gauge" | "histogram" | "info"
  unit: str
  help: str
  labels: Tuple[str, ...] = ()
  # True = bigger is healthier, False = smaller is, None = not gated.
  higher_is_better: Optional[bool] = None


SCHEMA: "collections.OrderedDict[str, MetricSpec]" = \
    collections.OrderedDict()


def _register(name: str, kind: str, unit: str, help_: str,
              labels: Tuple[str, ...] = (),
              higher_is_better: Optional[bool] = None) -> None:
  if name in SCHEMA:
    raise ValueError(f"duplicate metric key: {name}")
  for lab in labels:
    if lab not in LABEL_NAMES:
      raise ValueError(f"unregistered label name {lab!r} on {name!r}: "
                       f"LABEL_NAMES is {LABEL_NAMES}")
  SCHEMA[name] = MetricSpec(name, kind, unit, help_, tuple(labels),
                            higher_is_better)


def _counter(name, unit, help_, labels=()):
  _register(name, "counter", unit, help_, labels)


def _gauge(name, unit, help_, labels=(), higher_is_better=None):
  _register(name, "gauge", unit, help_, labels, higher_is_better)


def _hist(name, unit, help_, labels=(), higher_is_better=None):
  _register(name, "histogram", unit, help_, labels, higher_is_better)


def _info(name, help_):
  _register(name, "info", "", help_)


# Benchmark run stats (benchmark.py _train, the eval passes).
_gauge("images_per_sec", "images/s",
       "Timed-loop throughput (the headline metric)",
       higher_is_better=True)
_gauge("average_wall_time", "s", "Mean wall time per step",
       higher_is_better=False)
_gauge("last_average_loss", "1", "Loss of the last completed step")
_counter("num_steps", "steps", "Timed steps completed")
_counter("num_chunks", "chunks", "Timed K-step dispatches completed")
_gauge("num_workers", "processes", "Cooperating worker processes")
_gauge("steps_per_dispatch", "steps", "K of the chunked dispatch")
_gauge("compile_s", "s",
       "Wall of the first dispatch (blocks on trace+compile)", higher_is_better=False)
_gauge("dispatch_overhead_s", "s",
       "Mean host time per timed dispatch call (jit call + RTT)", higher_is_better=False)
_gauge("grad_noise_scale", "1", "EMA-smoothed B_simple estimate")
_gauge("opt_state_bytes_per_device", "bytes",
       "Per-device optimizer-state HBM")
_gauge("param_bytes_per_device", "bytes", "Per-device parameter HBM")
_gauge("feed_stall_fraction", "1",
       "Fraction of the consume window blocked on the host feed", higher_is_better=False)
_gauge("eval_images_per_sec", "images/s", "Eval-loop throughput", higher_is_better=True)
_gauge("top_1_accuracy", "1", "Eval top-1 accuracy",
       higher_is_better=True)
_gauge("top_5_accuracy", "1", "Eval top-5 accuracy",
       higher_is_better=True)

# Live training-loop gauges (the /metrics endpoint's per-step surface).
_counter("step", "steps", "Last completed global step")
_gauge("loss", "1", "Loss at the last completed step")
_gauge("learning_rate", "1", "Learning rate at the last completed step")
_gauge("step_images_per_sec", "images/s",
       "Throughput over the last display window",
       higher_is_better=True)

# Telemetry (telemetry.py): in-step health vector + run-end summary,
# all under the health/ namespace (health_key).
_gauge("health/grad_norm", "1", "Global gradient norm (in-step)")
_gauge("health/update_ratio", "1",
       "Update/param norm ratio (in-step)")
_gauge("health/nonfinite_leaves", "leaves",
       "Non-finite gradient leaves (in-step)")
_gauge("health/loss_scale", "1", "Loss scale (in-step)")
_gauge("health/skipped", "1", "Step skipped by the loss-scale machine")
_counter("health/records", "records", "Flight-recorder rows retained")
_gauge("health/max_grad_norm", "1", "Max global grad norm seen")
_counter("health/nonfinite_steps", "steps",
         "Steps with a non-finite training signal")
_gauge("health/loss_scale_final", "1", "Final loss scale")
_counter("health/anomaly_dumps", "dumps",
         "Flight-recorder anomaly episodes dumped")
_counter("health/watchdog_stalls", "stalls",
         "Stall-watchdog diagnostic episodes")

# Tracing (tracing.py): streaming latency percentiles over
# tracing.SAMPLE_KEYS x tracing.QUANTILES, and the compile-ledger
# aggregates.
_gauge("chunk_wall_p50", "s", "Chunk wall p50",
       higher_is_better=False)
_gauge("chunk_wall_p90", "s", "Chunk wall p90",
       higher_is_better=False)
_gauge("chunk_wall_p99", "s", "Chunk wall p99",
       higher_is_better=False)
_gauge("feed_wait_p50", "s", "Feed wait p50",
       higher_is_better=False)
_gauge("feed_wait_p90", "s", "Feed wait p90",
       higher_is_better=False)
_gauge("feed_wait_p99", "s", "Feed wait p99",
       higher_is_better=False)
_gauge("checkpoint_save_p50", "s", "Checkpoint save p50",
       higher_is_better=False)
_gauge("checkpoint_save_p90", "s", "Checkpoint save p90",
       higher_is_better=False)
_gauge("checkpoint_save_p99", "s", "Checkpoint save p99",
       higher_is_better=False)
# Cumulative-histogram twins of the tracing SAMPLE_KEYS: the /metrics
# exposition's le-bucket histograms (feed_wait's is feed_wait_s below).
_hist("chunk_wall_s", "s", "Chunk wall distribution",
      higher_is_better=False)
_hist("checkpoint_save_s", "s", "Checkpoint save distribution", higher_is_better=False)
_counter("compile_ledger/shapes", "programs",
         "Distinct program shapes compiled")
_counter("compile_ledger/total_compile_s", "s",
         "Total compile wall seconds")

# Serving engine (serving/engine.py), as registered by the JAX package.
_T = ("tenant",)
_counter("serving/requests", "requests", "Requests submitted", _T)
_counter("serving/completed", "requests", "Requests served to completion",
         _T)
_counter("serving/shed", "requests",
         "Requests shed by admission control (rejected + expired)",
         ("tenant", "shed_reason"))
_counter("serving/decode_steps", "steps", "Decode steps dispatched",
         ("bucket",))
_gauge("serving/shed_fraction", "1", "Shed fraction of all arrivals", _T,
       False)
_gauge("serving/queue_depth", "requests",
       "Admission queue depth (mean at tick time)", (), False)
_gauge("serving/batch_fill_fraction", "1",
       "Mean active-slot fraction of the decode bucket", (), True)
_gauge("serving/active", "requests", "In-flight requests decoding")
_gauge("serving/decode_bucket", "requests",
       "Current bucket-ladder decode batch width")
_gauge("serving/tokens_per_sec", "tokens/s",
       "Generated-token throughput over the serve window", _T, True)
for _q in (50, 90, 99):
  _gauge(f"serving/ttft_p{_q}", "s", f"Time-to-first-token p{_q}", _T,
         False)
  _gauge(f"serving/token_latency_p{_q}", "s",
         f"Per-token decode latency p{_q}", _T, False)
_hist("serving/ttft_s", "s", "Time-to-first-token distribution", _T, False)
_hist("serving/token_latency_s", "s",
      "Per-token decode latency distribution", _T, False)
_hist("serving/accept_len", "tokens",
      "Accepted speculative prefix length distribution", (), True)
for _obj, _label in (("ttft", "TTFT-deadline"), ("shed", "Shed-fraction")):
  for _win in ("fast", "slow"):
    _gauge(f"serving/slo_{_obj}_burn_{_win}", "x_budget",
           f"{_label} objective burn rate ({_win} window)", _T, False)
_gauge("serving/slo_alerts", "episodes",
       "SLO alert episodes currently firing", _T, False)
# Decode-cost variants (paged KV, speculative decoding): not ported yet;
# registered so the engine's stats keep the JAX package's key set (their
# values are None, which flatten_stats drops).
_gauge("serving/kv_pages_in_use", "pages",
       "Peak KV pool pages allocated to live requests")
_gauge("serving/kv_page_fraction", "1",
       "Peak allocated fraction of the KV page pool")
_counter("serving/spec_rounds", "rounds",
         "Speculative draft-propose/target-verify rounds")
_counter("serving/draft_tokens", "tokens",
         "Draft-model proposal tokens offered to the verifier")
_counter("serving/accepted_tokens", "tokens",
         "Draft proposals accepted by the target verifier")
for _q in (50, 90, 99):
  _gauge(f"serving/accept_len_p{_q}", "tokens",
         f"Accepted speculative prefix length p{_q}", (), True)


# DeviceFeeder (data/device_feed.py): run-end stats + live lanes.
_counter("fetches", "batches", "Batches delivered to the consumer")
_gauge("consumer_wait_s", "s", "Total consumer blocked-wait time", higher_is_better=False)
_gauge("window_s", "s", "Wall window spanning the fetches")
_gauge("queue_depth", "batches", "Prefetch queue depth at last fetch")
_gauge("queue_depth_mean", "batches", "Mean queue depth at fetch time")
_gauge("queue_depth_max", "batches", "Max queue depth at fetch time")
_gauge("prefetch_batches", "batches", "Configured prefetch depth")
_hist("feed_wait_s", "s", "Per-fetch consumer blocked-wait")

# bench_torch.py's one-line JSON (fields not covered above).
_gauge("vs_baseline", "1",
       "Headline value over the reference's committed baseline", higher_is_better=True)
_info("run_id", "Run id shared with trace + flight recorder")
_info("git_rev", "Git revision the run was built from")
_info("platform", "Execution platform (gpu | cpu)")
_info("metric", "Headline metric name")
_info("unit", "Headline metric unit")
# Tuned-config provenance (--autotuned_config, analysis/autotune.py):
# flatten_stats expands the stats' ``tuned_config`` onto these, so a
# record says which table row shaped its run.
_info("tuned_config_path", "Tuned-config table the run applied")
_info("tuned_config_entry", "Matched tuned-table entry fingerprint")

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


# Stats / bench-record keys that are bookkeeping, not metrics: the schema
# audit accepts them from the emitters without registration.
NON_METRIC_KEYS = frozenset({
    "state", "stopped_early", "restart_for_resize", "reshape_events",
    "aot_load_path", "value", "entries", "health", "latency_percentiles",
    "compile_ledger", "tuned_config", "decode_variant", "quantize_gate",
    "serving_tenants", "losses", "feed_stats", "traced_dispatch",
    "checkpoint_save_s", "vs_baseline",
    # The port's run identity and counts (the schema is the JAX
    # package's; these ride the stats and the bench line, not /metrics).
    "device", "world_size", "kernel_launches", "steps_run",
    "eval_results", "global_step", "batch_size_per_device",
    "num_grad_accum", "num_dispatches", "health_stats", "step_flops",
    "checkpoint_restore_s", "shard_optimizer_state", "shard_params",
    "overlap_gradient_reduction",
})


def prometheus_name(key: str) -> str:
  return "kf_" + _PROM_NAME_RE.sub("_", key)


# -- labeled keys --------------------------------------------------------------

_LABELED_KEY_RE = re.compile(r"^([^{}]+)\{(.*)\}$")
_LABEL_ITEM_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
  return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def labeled_key(name: str, labels: Optional[Dict[str, Any]]) -> str:
  """Canonical flat key ``name{a="x",b="y"}`` (label names sorted) of a
  series; the bare name when ``labels`` is empty."""
  if not labels:
    return name
  body = ",".join(f'{k}="{_escape_label(str(v))}"'
                  for k, v in sorted(labels.items()))
  return f"{name}{{{body}}}"


def parse_labeled_key(key: str) -> Tuple[str, Dict[str, str]]:
  """(base name, labels) of a flat key; ValueError on a malformed block."""
  if "{" not in key:
    return key, {}
  m = _LABELED_KEY_RE.match(key)
  if not m:
    raise ValueError(f"malformed labeled metric key {key!r}")
  body = m.group(2)
  items = _LABEL_ITEM_RE.findall(body)
  if ",".join(f'{k}="{v}"' for k, v in items) != body:
    raise ValueError(f"malformed labeled metric key {key!r}")
  return m.group(1), {k: _unescape_label(v) for k, v in items}


# -- registry -----------------------------------------------------------------

# Cumulative-histogram bucket boundaries (le is inclusive; +Inf is
# implicit as the overflow bin). Seconds-scale latencies by default; a
# token-count histogram (unit "tokens") gets integer-ish bounds.
HIST_BUCKETS_SECONDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
HIST_BUCKETS_TOKENS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def hist_buckets(spec: MetricSpec) -> Tuple[float, ...]:
  return (HIST_BUCKETS_TOKENS if spec.unit == "tokens"
          else HIST_BUCKETS_SECONDS)


class MetricRegistry:
  """Typed, thread-safe value store over the SCHEMA.

  Producers set/inc/observe registered keys only: an unknown key raises.
  Labeled series pass ``labels={name: value}`` with names declared on
  the key's SCHEMA entry; an undeclared label name raises as an
  unregistered key does. Host-side only, cheap enough to update at every
  completed step.
  """

  def __init__(self):
    self._lock = threading.Lock()
    # Flat (possibly labeled) key -> value; histogram rows are
    # [count, sum, per-bin counts] over hist_buckets + the +Inf bin --
    # bounded memory by construction, no sample decimation needed.
    self._values: Dict[str, float] = {}
    self._info: Dict[str, str] = {}
    self._hists: Dict[str, list] = {}

  @staticmethod
  def _spec(name: str) -> MetricSpec:
    spec = SCHEMA.get(name)
    if spec is None:
      raise ValueError(f"unregistered metric key {name!r}: register it in "
                       "kf_benchmarks_tpu_torch/metrics.py SCHEMA")
    return spec

  @staticmethod
  def _key(spec: MetricSpec, labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
      return spec.name
    for lab in labels:
      if lab not in spec.labels:
        raise ValueError(f"unregistered label name {lab!r} on metric "
                         f"{spec.name!r}: its SCHEMA entry declares "
                         f"{spec.labels!r}")
    return labeled_key(spec.name, labels)

  def set(self, name: str, value,
          labels: Optional[Dict[str, Any]] = None) -> None:
    spec = self._spec(name)
    key = self._key(spec, labels)
    with self._lock:
      if spec.kind == "info":
        if labels:
          raise ValueError(f"{name} is info-kind; it renders as a "
                           "kf_run_info label and takes no labels")
        self._info[key] = str(value)
      elif spec.kind == "histogram":
        raise ValueError(f"{name} is a histogram; use observe()")
      else:
        self._values[key] = float(value)

  def inc(self, name: str, delta: float = 1.0,
          labels: Optional[Dict[str, Any]] = None) -> None:
    spec = self._spec(name)
    if spec.kind != "counter":
      raise ValueError(f"{name} is a {spec.kind}; inc() is counter-only")
    key = self._key(spec, labels)
    with self._lock:
      self._values[key] = self._values.get(key, 0.0) + float(delta)

  def observe(self, name: str, value: float,
              labels: Optional[Dict[str, Any]] = None) -> None:
    spec = self._spec(name)
    if spec.kind != "histogram":
      raise ValueError(f"{name} is a {spec.kind}; observe() is "
                       "histogram-only")
    key = self._key(spec, labels)
    bounds = hist_buckets(spec)
    v = float(value)
    with self._lock:
      row = self._hists.setdefault(key, [0, 0.0,
                                         [0] * (len(bounds) + 1)])
      row[0] += 1
      row[1] += v
      i = 0
      while i < len(bounds) and v > bounds[i]:
        i += 1
      row[2][i] += 1

  def snapshot(self) -> Dict[str, Any]:
    """Flat {key: value} of every set scalar/info value (labeled series
    under their canonical ``name{...}`` keys); histograms surface as
    <key>/count and <key>/sum for the run record."""
    with self._lock:
      out: Dict[str, Any] = dict(self._values)
      out.update(self._info)
      hists = {k: (row[0], row[1]) for k, row in self._hists.items()}
    for k, (count, total) in hists.items():
      base, labels = parse_labeled_key(k)
      out[labeled_key(base + "/count", labels)] = count
      out[labeled_key(base + "/sum", labels)] = total
    return out

  def render(self) -> str:
    """Prometheus text exposition format (version 0.0.4), straight
    from the registry: labeled series group under one HELP/TYPE block
    per metric, histogram-kind metrics render as true cumulative
    histograms (``_bucket{le=...}`` + ``_sum`` + ``_count``), and
    info-kind values collapse into one ``kf_run_info`` labeled gauge
    (the Prometheus info-metric idiom)."""
    with self._lock:
      values = dict(self._values)
      info = dict(self._info)
      hists = {k: (row[0], row[1], list(row[2]))
               for k, row in self._hists.items()}
    lines: List[str] = []

    def _suffix(labels: Dict[str, str], extra: str = "") -> str:
      body = ",".join(f'{_PROM_NAME_RE.sub("_", k)}='
                      f'"{_escape_label(v)}"'
                      for k, v in sorted(labels.items()))
      if extra:
        body = f"{body},{extra}" if body else extra
      return "{%s}" % body if body else ""

    by_base: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for key, value in values.items():
      base, labels = parse_labeled_key(key)
      by_base.setdefault(base, []).append((labels, value))
    for base in sorted(by_base):
      spec = SCHEMA[base]
      prom = prometheus_name(base)
      lines.append(f"# HELP {prom} {spec.help} [{spec.unit}]")
      lines.append(f"# TYPE {prom} {spec.kind}")
      for labels, value in sorted(by_base[base],
                                  key=lambda p: sorted(p[0].items())):
        lines.append(f"{prom}{_suffix(labels)} {_fmt_value(value)}")
    hist_by_base: Dict[str, List[Tuple[Dict[str, str], tuple]]] = {}
    for key, row in hists.items():
      base, labels = parse_labeled_key(key)
      hist_by_base.setdefault(base, []).append((labels, row))
    for base in sorted(hist_by_base):
      spec = SCHEMA[base]
      prom = prometheus_name(base)
      bounds = hist_buckets(spec)
      lines.append(f"# HELP {prom} {spec.help} [{spec.unit}]")
      lines.append(f"# TYPE {prom} histogram")
      for labels, (count, total, bins) in sorted(
          hist_by_base[base], key=lambda p: sorted(p[0].items())):
        running = 0
        for bound, n in zip(bounds, bins):
          running += n
          le = _suffix(labels, f'le="{_fmt_value(bound)}"')
          lines.append(f"{prom}_bucket{le} {running}")
        le = _suffix(labels, 'le="+Inf"')
        lines.append(f"{prom}_bucket{le} {count}")
        lines.append(f"{prom}_sum{_suffix(labels)} {_fmt_value(total)}")
        lines.append(f"{prom}_count{_suffix(labels)} {count}")
    if info:
      labels = ",".join(
          f'{_PROM_NAME_RE.sub("_", k)}="{_escape_label(v)}"'
          for k, v in sorted(info.items()))
      lines.append("# HELP kf_run_info Run identity labels")
      lines.append("# TYPE kf_run_info gauge")
      lines.append("kf_run_info{%s} 1" % labels)
    return "\n".join(lines) + "\n"


def _fmt_value(v: float) -> str:
  if math.isnan(v):
    return "NaN"
  if math.isinf(v):
    return "+Inf" if v > 0 else "-Inf"
  return format(float(v), ".10g")


def _escape_label(v: str) -> str:
  return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
      "\n", "\\n")


_PROM_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? "
    r"(NaN|[+-]Inf|[-+0-9.eE]+)$")
_PROM_LABEL_ITEM_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_prom_labels(body: Optional[str]):
  """{...} label body -> dict, or None on malformed body."""
  if not body:
    return {}
  inner = body[1:-1]
  items = _PROM_LABEL_ITEM_RE.findall(inner)
  if ",".join(f'{k}="{v}"' for k, v in items) != inner:
    return None
  return dict(items)


def validate_prometheus_text(text: str) -> List[str]:
  """Structural check of a Prometheus text-format payload; returns
  problem strings (empty = valid). Beyond line grammar this checks the
  cumulative-histogram contract promtool enforces: every
  ``<name>_bucket`` series needs an ``le`` label, each (family,
  labels) series needs a ``+Inf`` bucket with monotone non-decreasing
  cumulative counts, and ``<name>_count`` must equal the ``+Inf``
  bucket."""
  problems = []
  # (family, frozen non-le labels) -> [(le, count)], and _count values.
  # Only families DECLARED "# TYPE <fam> histogram" get the histogram
  # suffix treatment -- a plain gauge whose name happens to end in
  # _bucket (serving/decode_bucket) must not trip the grammar.
  hist_families = set()
  buckets: Dict[Tuple[str, frozenset], List[Tuple[str, float]]] = {}
  counts: Dict[Tuple[str, frozenset], float] = {}
  for i, line in enumerate(text.splitlines()):
    if not line.strip():
      continue
    if line.startswith("# TYPE "):
      parts = line.split()
      if len(parts) != 4 or parts[3] not in (
          "counter", "gauge", "summary", "histogram", "untyped"):
        problems.append(f"line {i}: bad TYPE line {line!r}")
      elif parts[3] == "histogram":
        hist_families.add(parts[2])
      continue
    if line.startswith("#"):
      continue
    m = _PROM_LINE_RE.match(line)
    if not m:
      problems.append(f"line {i}: not a metric sample: {line!r}")
      continue
    name, body, value = m.group(1), m.group(2), m.group(3)
    labels = _parse_prom_labels(body)
    if labels is None:
      problems.append(f"line {i}: malformed label body: {line!r}")
      continue
    if name.endswith("_bucket") and name[:-len("_bucket")] in \
        hist_families:
      le = labels.pop("le", None)
      if le is None:
        problems.append(f"line {i}: _bucket sample without le label: "
                        f"{line!r}")
        continue
      series = (name[:-len("_bucket")], frozenset(labels.items()))
      buckets.setdefault(series, []).append((le, float(value)))
    elif name.endswith("_count") and name[:-len("_count")] in \
        hist_families:
      counts[(name[:-len("_count")], frozenset(labels.items()))] = \
          float(value)
  for series, rows in buckets.items():
    fam = series[0]
    les = [le for le, _ in rows]
    if "+Inf" not in les:
      problems.append(f"histogram {fam}: series missing +Inf bucket")
    vals = [n for _, n in rows]
    if any(b < a for a, b in zip(vals, vals[1:])):
      problems.append(f"histogram {fam}: bucket counts not cumulative "
                      f"monotone: {vals}")
    if "+Inf" in les and series in counts:
      inf = dict(rows)["+Inf"]
      if counts[series] != inf:
        problems.append(f"histogram {fam}: _count {counts[series]} != "
                        f"+Inf bucket {inf}")
  return problems


# -- stats flattening (run stats / bench JSON -> registered keys) -------------

def flatten_stats(stats: Dict[str, Any]) -> Dict[str, Any]:
  """One flat {registered key: value} view of a benchmark stats dict or
  a bench JSON record: nested health / latency_percentiles /
  compile_ledger containers expand onto their registered keys,
  bookkeeping keys (NON_METRIC_KEYS) and unset values drop out.
  The serving engine's per-tenant block (``serving_tenants``) expands
  onto labeled keys (``name{tenant="..."}``; shed counts additionally
  carry ``shed_reason``)."""
  out: Dict[str, Any] = {}
  for key, value in (stats or {}).items():
    if value is None:
      continue
    if key == "serving_tenants" and isinstance(value, dict):
      for tenant, block in value.items():
        if not isinstance(block, dict):
          continue
        for tk, tv in block.items():
          if tv is None:
            continue
          if tk == "serving/shed" and isinstance(tv, dict):
            for reason, n in tv.items():
              out[labeled_key("serving/shed",
                              {"tenant": tenant,
                               "shed_reason": reason})] = float(n)
            continue
          if tk in SCHEMA and isinstance(tv, (int, float)) \
              and not isinstance(tv, bool):
            out[labeled_key(tk, {"tenant": tenant})] = float(tv)
      continue
    if key == "health" and isinstance(value, dict):
      for hk, hv in value.items():
        name = health_key(hk)
        if name in SCHEMA and isinstance(hv, (int, float)):
          out[name] = float(hv)
      continue
    if key == "latency_percentiles" and isinstance(value, dict):
      for lk, lv in value.items():
        if lk in SCHEMA and lv is not None:
          out[lk] = float(lv)
      continue
    if key == "tuned_config" and isinstance(value, dict):
      if value.get("path"):
        out["tuned_config_path"] = str(value["path"])
      if value.get("entry"):
        out["tuned_config_entry"] = str(value["entry"])
      continue
    if key == "compile_ledger" and isinstance(value, dict):
      for ck in ("shapes", "total_compile_s"):
        if value.get(ck) is not None:
          out["compile_ledger/" + ck] = float(value[ck])
      continue
    spec = SCHEMA.get(key)
    if spec is None:
      continue
    if spec.kind == "info":
      out[key] = str(value)
    elif isinstance(value, bool):
      out[key] = float(value)
    elif isinstance(value, (int, float)):
      out[key] = float(value)
  return out


def publish_stats(registry, stats: Dict[str, Any]) -> None:
  """Render a stats dict into a registry (the run-end publication the
  /metrics endpoint serves after the loop completes)."""
  for key, value in flatten_stats(stats).items():
    base, labels = parse_labeled_key(key)
    if SCHEMA[base].kind == "histogram":
      continue
    registry.set(base, value, labels=labels or None)


# -- active-registry (the tracing.py pattern) ---------------------------------

class _NullRegistry:
  """No-op sink with the MetricRegistry surface, so deep producers
  (DeviceFeeder's consumer path) publish unconditionally."""

  def set(self, *a, **k) -> None:
    pass

  def inc(self, *a, **k) -> None:
    pass

  def observe(self, *a, **k) -> None:
    pass

  def snapshot(self) -> Dict[str, Any]:
    return {}

  def render(self) -> str:
    return "\n"


NULL_REGISTRY = _NullRegistry()
_active: Any = None


def activate(registry: MetricRegistry) -> MetricRegistry:
  global _active
  _active = registry
  return registry


def deactivate() -> None:
  global _active
  _active = None


def active():
  """The process's active MetricRegistry, or the no-op sink."""
  return _active if _active is not None else NULL_REGISTRY


# -- live endpoint ------------------------------------------------------------

def resolve_port(base_port: int, rank: int = 0) -> int:
  """Per-rank port under kfrun: rank r serves base + r (every worker of
  a single-host job gets its own scrape target)."""
  return int(base_port) + int(rank)


class _Handler(http.server.BaseHTTPRequestHandler):
  server_version = "kf-metrics/1"

  def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
    path = self.path.split("?", 1)[0]
    if path == "/metrics":
      body = self.server.registry.render().encode("utf-8")
      ctype = "text/plain; version=0.0.4; charset=utf-8"
    elif path == "/healthz":
      try:
        payload = self.server.healthz_fn()
      except Exception as e:  # a health probe must answer, not raise
        payload = {"status": "error", "error": repr(e)}
      body = (json.dumps(payload) + "\n").encode("utf-8")
      ctype = "application/json"
    else:
      self.send_error(404, "unknown path (serving /metrics, /healthz)")
      return
    self.send_response(200)
    self.send_header("Content-Type", ctype)
    self.send_header("Content-Length", str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def log_message(self, *args) -> None:
    pass  # scrapes must never interleave into the run's stdout


class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
  daemon_threads = True
  # Scrape targets restart with the run; a lingering TIME_WAIT socket
  # must not fail the next run's bind.
  allow_reuse_address = True


class MetricsServer:
  """Opt-in scrape endpoint on a daemon thread.

  Binds eagerly (a bad port fails fast at session start, not at first
  scrape); ``port=0`` binds an ephemeral port -- ``self.port`` is
  always the real bound port. Host-side only: the handler reads the
  registry under its lock and touches no device.
  """

  def __init__(self, registry, port: int, host: str = "127.0.0.1",
               healthz_fn: Optional[Callable[[], Dict[str, Any]]] = None):
    self._httpd = _Server((host, int(port)), _Handler)
    self._httpd.registry = registry
    self._httpd.healthz_fn = healthz_fn or (lambda: {"status": "ok"})
    self.host = host
    self.port = int(self._httpd.server_address[1])
    self._thread = threading.Thread(
        target=self._httpd.serve_forever, name="kf-metrics-endpoint",
        daemon=True)
    self._thread.start()

  def close(self) -> None:
    self._httpd.shutdown()
    self._httpd.server_close()
    self._thread.join(timeout=5.0)


# -- SLO burn-rate monitor -----------------------------------------------------

SLO_OBJECTIVES = ("ttft_deadline", "shed_fraction")


class SLOMonitor:
  """Multi-window error-budget burn-rate monitor: per (objective, tenant)
  stream of good/bad events, burn = bad fraction / error budget over a fast
  and a slow sliding window; an alert fires when BOTH windows burn at or
  above the threshold. Alerts are data (edge-triggered ``firing`` /
  ``resolved`` records in ``self.alerts``, and on ``recorder.note_event``
  when a recorder is attached), never exceptions."""

  def __init__(self, objectives: Optional[Dict[str, float]] = None,
               fast_window_s: float = 15.0, slow_window_s: float = 60.0,
               burn_threshold: float = 2.0,
               time_fn: Callable[[], float] = time.monotonic,
               recorder=None):
    objectives = dict(objectives if objectives is not None
                      else {o: 0.99 for o in SLO_OBJECTIVES})
    for obj, target in objectives.items():
      if obj not in SLO_OBJECTIVES:
        raise ValueError(f"unknown SLO objective {obj!r}: "
                         f"SLO_OBJECTIVES is {SLO_OBJECTIVES}")
      if not 0.0 < float(target) < 1.0:
        raise ValueError(f"SLO target for {obj!r} must be in (0, 1), "
                         f"got {target!r}")
    self.objectives = {k: float(v) for k, v in objectives.items()}
    self.fast_window_s = float(fast_window_s)
    self.slow_window_s = float(slow_window_s)
    self.burn_threshold = float(burn_threshold)
    self._time = time_fn
    self._recorder = recorder
    self._lock = threading.Lock()
    self._events: Dict[Tuple[str, str], "collections.deque"] = {}
    self._firing: Dict[Tuple[str, str], bool] = {}
    self.alerts: List[Dict[str, Any]] = []

  def observe(self, objective: str, tenant: str, good: bool,
              t: Optional[float] = None) -> None:
    if objective not in self.objectives:
      raise ValueError(f"unknown SLO objective {objective!r}: this "
                       f"monitor tracks {sorted(self.objectives)}")
    t = self._time() if t is None else float(t)
    key = (objective, str(tenant))
    with self._lock:
      q = self._events.setdefault(key, collections.deque())
      q.append((t, bool(good)))
      self._prune(q, t)
      self._evaluate(key, t)

  def _prune(self, q, t: float) -> None:
    horizon = t - self.slow_window_s
    while q and q[0][0] < horizon:
      q.popleft()

  def _burns(self, objective: str, rows, t: float
             ) -> Dict[str, Optional[float]]:
    budget = max(1.0 - self.objectives[objective], 1e-9)
    out: Dict[str, Optional[float]] = {}
    for name, win in (("fast", self.fast_window_s),
                      ("slow", self.slow_window_s)):
      inside = [good for (et, good) in rows if et >= t - win]
      out[name] = None if not inside else \
          (sum(1 for g in inside if not g) / len(inside)) / budget
    return out

  def burn(self, objective: str, tenant: str,
           t: Optional[float] = None) -> Dict[str, Optional[float]]:
    """{"fast": burn, "slow": burn}; None where the window is empty."""
    t = self._time() if t is None else float(t)
    with self._lock:
      rows = list(self._events.get((objective, str(tenant))) or ())
    return self._burns(objective, rows, t)

  def _evaluate(self, key: Tuple[str, str], t: float) -> None:
    # The caller holds the lock.
    objective, tenant = key
    burns = self._burns(objective, list(self._events.get(key) or ()), t)
    hot = (burns["fast"] is not None and burns["slow"] is not None
           and burns["fast"] >= self.burn_threshold
           and burns["slow"] >= self.burn_threshold)
    if hot == self._firing.get(key, False):
      return
    self._firing[key] = hot
    rec = {"slo_alert": objective, "tenant": tenant,
           "state": "firing" if hot else "resolved",
           "burn_fast": burns["fast"], "burn_slow": burns["slow"],
           "threshold": self.burn_threshold,
           "budget": max(1.0 - self.objectives[objective], 1e-9), "t": t}
    self.alerts.append(rec)
    if self._recorder is not None:
      self._recorder.note_event(dict(rec))

  def firing(self, t: Optional[float] = None) -> List[Tuple[str, str]]:
    """Currently firing (objective, tenant) streams, re-evaluated at t."""
    t = self._time() if t is None else float(t)
    with self._lock:
      for key, q in self._events.items():
        self._prune(q, t)
        self._evaluate(key, t)
      return sorted(k for k, hot in self._firing.items() if hot)

  def state(self, t: Optional[float] = None) -> Dict[str, Any]:
    """Per-objective per-tenant burn rates, the episode count, and status
    "burning" iff any stream fires."""
    t = self._time() if t is None else float(t)
    hot = self.firing(t)
    objectives: Dict[str, Any] = {}
    with self._lock:
      keys = sorted(self._events)
    for objective, tenant in keys:
      burns = self.burn(objective, tenant, t)
      objectives.setdefault(objective, {})[tenant] = {
          "burn_fast": burns["fast"], "burn_slow": burns["slow"],
          "firing": (objective, tenant) in hot}
    return {"status": "burning" if hot else "ok",
            "threshold": self.burn_threshold, "objectives": objectives,
            "alerts": len(self.alerts)}


# -- run-record store ---------------------------------------------------------

RECORD_SCHEMA_VERSION = 1
STORE_FILENAME = "run_store.jsonl"


def run_record(*, metric: str, value: float, unit: str,
               fingerprint: str, run_id: str, platform: str,
               fallback: bool = False, git_rev: Optional[str] = None,
               torch_version: Optional[str] = None,
               device_name: Optional[str] = None,
               snapshot: Optional[Dict[str, Any]] = None,
               t_wall: Optional[float] = None) -> Dict[str, Any]:
  """One schema-versioned run record. ``fingerprint`` is the program
  identity (analysis/baseline.config_fingerprint_key) the sentinel
  compares within; ``platform`` is ``gpu`` or ``cpu``; ``device_name``
  the card's (``torch.cuda.get_device_name``); ``fallback`` marks a
  probe that must never enter a card's baseline (the port has no CPU
  fallback: its runs record False); ``snapshot`` is the flat registered
  metric view (flatten_stats / MetricRegistry.snapshot)."""
  return {
      "schema_version": RECORD_SCHEMA_VERSION,
      "t_wall": round(float(time.time() if t_wall is None else t_wall),
                      3),
      "run_id": str(run_id),
      "fingerprint": str(fingerprint),
      "metric": str(metric),
      "value": float(value),
      "unit": str(unit),
      "platform": str(platform),
      "fallback": bool(fallback),
      "baseline": False,
      "git_rev": git_rev,
      "torch_version": torch_version,
      "device_name": device_name,
      "snapshot": dict(snapshot or {}),
  }


def validate_record(rec) -> List[str]:
  """Problem strings (empty = valid) for one store record."""
  problems = []
  if not isinstance(rec, dict):
    return ["record is not an object"]
  ver = rec.get("schema_version")
  if not isinstance(ver, int) or not 1 <= ver <= RECORD_SCHEMA_VERSION:
    problems.append(f"schema_version {ver!r} outside "
                    f"[1, {RECORD_SCHEMA_VERSION}]")
  for field in ("run_id", "fingerprint", "metric", "unit", "platform"):
    v = rec.get(field)
    if not isinstance(v, str) or not v:
      problems.append(f"{field} missing or not a non-empty string")
  v = rec.get("value")
  if not isinstance(v, (int, float)) or isinstance(v, bool) or \
      not math.isfinite(v):
    problems.append(f"value {v!r} is not a finite number")
  if not isinstance(rec.get("t_wall"), (int, float)):
    problems.append("t_wall missing or not a number")
  for field in ("fallback", "baseline"):
    if not isinstance(rec.get(field), bool):
      problems.append(f"{field} missing or not a bool")
  snap = rec.get("snapshot")
  if not isinstance(snap, dict):
    problems.append("snapshot missing or not an object")
  else:
    for k, sv in snap.items():
      try:
        base, labels = parse_labeled_key(k)
      except ValueError:
        problems.append(f"snapshot key {k!r} is a malformed labeled key")
        continue
      base = base.split("/count")[0].split("/sum")[0]
      spec = SCHEMA.get(base)
      if spec is None:
        problems.append(f"snapshot key {k!r} not in the metric schema")
        continue
      bad = [lab for lab in labels if lab not in spec.labels]
      if bad:
        problems.append(f"snapshot key {k!r} carries undeclared label "
                        f"names {bad} (declared: {list(spec.labels)})")
      elif not isinstance(sv, (int, float, str)):
        problems.append(f"snapshot value for {k!r} is {type(sv).__name__}")
  return problems


class RunStore:
  """Append-only JSONL store of run records.

  One line per run; torn/foreign lines are skipped on read (the store
  rides ordinary filesystems and a crashed writer must not poison the
  history). ``append`` validates and promotes the first card record
  (platform ``gpu``) of a fingerprint to baseline.
  """

  def __init__(self, store_dir: str, filename: str = STORE_FILENAME):
    self.dir = str(store_dir)
    self.path = os.path.join(self.dir, filename)

  def records(self) -> List[Dict[str, Any]]:
    out = []
    try:
      with open(self.path, encoding="utf-8") as f:
        for line in f:
          line = line.strip()
          if not line:
            continue
          try:
            rec = json.loads(line)
          except ValueError:
            continue
          if isinstance(rec, dict) and "metric" in rec:
            out.append(rec)
    except OSError:
      pass
    return out

  def query(self, fingerprint: Optional[str] = None,
            metric: Optional[str] = None,
            fallback: Optional[bool] = None) -> List[Dict[str, Any]]:
    rows = self.records()
    if fingerprint is not None:
      rows = [r for r in rows if r.get("fingerprint") == fingerprint]
    if metric is not None:
      rows = [r for r in rows if r.get("metric") == metric]
    if fallback is not None:
      rows = [r for r in rows if bool(r.get("fallback")) == fallback]
    rows.sort(key=lambda r: r.get("t_wall", 0.0))
    return rows

  def has_run(self, run_id: str, metric: str) -> bool:
    return any(r.get("run_id") == run_id and r.get("metric") == metric
               for r in self.records())

  def append(self, rec: Dict[str, Any]) -> Dict[str, Any]:
    problems = validate_record(rec)
    if problems:
      raise ValueError("invalid run record: " + "; ".join(problems))
    if rec["platform"] == "gpu" and not rec["fallback"] and \
        not rec["baseline"]:
      # Baseline self-promotion: the first card record of a fingerprint
      # becomes its baseline; CPU runs are never eligible.
      prior = [r for r in self.records()
               if r.get("fingerprint") == rec["fingerprint"]
               and r.get("baseline")]
      if not prior:
        rec = dict(rec, baseline=True)
    os.makedirs(self.dir, exist_ok=True)
    with open(self.path, "a", encoding="utf-8") as f:
      f.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec

  @staticmethod
  def merge(paths: List[str]) -> List[Dict[str, Any]]:
    """Union of several store files, deduped on (run_id, metric,
    t_wall) -- the cross-host merge for stores synced from more than
    one machine."""
    seen = set()
    out = []
    for path in paths:
      for rec in RunStore(os.path.dirname(path) or ".",
                          os.path.basename(path)).records():
        key = (rec.get("run_id"), rec.get("metric"), rec.get("t_wall"))
        if key in seen:
          continue
        seen.add(key)
        out.append(rec)
    out.sort(key=lambda r: r.get("t_wall", 0.0))
    return out


# -- regression sentinel ------------------------------------------------------

# Consistent MAD->sigma factor for normal noise.
MAD_SIGMA = 1.4826
# Defaults tuned to the acceptance bar: a seeded 20% throughput drop
# flags against any realistic history, +-5% run-to-run noise stays
# quiet (uniform +-5% noise has MAD ~2.5%, so the MAD leg of the bar
# sits at ~15%; a noise-free history floors the bar at rel_floor).
SENTINEL_WINDOW = 8
SENTINEL_MAD_FACTOR = 4.0
SENTINEL_REL_FLOOR = 0.08
SENTINEL_MIN_HISTORY = 3


def check_regression(history: List[Dict[str, Any]],
                     fresh: Dict[str, Any],
                     window: int = SENTINEL_WINDOW,
                     mad_factor: float = SENTINEL_MAD_FACTOR,
                     rel_floor: float = SENTINEL_REL_FLOOR,
                     min_history: int = SENTINEL_MIN_HISTORY,
                     higher_is_better: bool = True) -> Dict[str, Any]:
  """Compare ``fresh`` against the trailing median of comparable
  history with a noise-aware bar.

  Comparable = same fingerprint, same metric name, same fallback
  status, same platform (an H100 run is never held against a backfilled
  TPU row), excluding the fresh run itself. The bar is
  ``max(mad_factor * 1.4826 * MAD, rel_floor * |median|)``: the MAD leg
  adapts to the config's measured run-to-run noise, the relative floor
  keeps a noise-free history from flagging epsilon jitter.
  """
  rows = [r for r in history
          if r.get("fingerprint") == fresh.get("fingerprint")
          and r.get("metric") == fresh.get("metric")
          and bool(r.get("fallback")) == bool(fresh.get("fallback"))
          and r.get("platform") == fresh.get("platform")
          and r.get("run_id") != fresh.get("run_id")]
  rows.sort(key=lambda r: r.get("t_wall", 0.0))
  tail = rows[-max(1, int(window)):]
  value = float(fresh.get("value", float("nan")))
  base = {
      "metric": fresh.get("metric"),
      "fingerprint": fresh.get("fingerprint"),
      "value": value,
      "n": len(tail),
      "window": int(window),
  }
  if len(tail) < min_history:
    return dict(base, status="no_history", median=None, bar=None)
  vals = [float(r["value"]) for r in tail]
  med = _tracing.percentile(vals, 50)
  mad = _tracing.percentile([abs(v - med) for v in vals], 50)
  bar = max(mad_factor * MAD_SIGMA * mad, rel_floor * abs(med))
  delta = (med - value) if higher_is_better else (value - med)
  status = "regression" if delta > bar else "ok"
  return dict(base, status=status, median=med, bar=bar)


def verdict_line(verdict: Dict[str, Any]) -> str:
  """One whole self-identifying verdict line (never inside the bench
  JSON line)."""
  metric = verdict.get("metric")
  fp = (verdict.get("fingerprint") or "")[:16]
  if verdict["status"] == "no_history":
    return (f"regression check: NO HISTORY for {metric} "
            f"(fingerprint {fp}, {verdict['n']} comparable record(s)); "
            "recorded as history for future runs")
  word = "REGRESSION" if verdict["status"] == "regression" else "OK"
  return ("regression check: %s %s value=%.3f median=%.3f bar=%.3f "
          "(n=%d, fingerprint %s)" % (
              word, metric, verdict["value"], verdict["median"],
              verdict["bar"], verdict["n"], fp))


# Direction fallback for keys whose SCHEMA entry predates (or lacks)
# higher_is_better -- substring heuristics, first match wins.
_DIRECTION_HINTS = (
    ("per_sec", True),
    ("accuracy", True),
    ("ttft", False),
    ("latency", False),
    ("shed", False),
    ("wall", False),
)


def metric_direction(name: str) -> bool:
  """higher_is_better for a (possibly labeled) metric key: the SCHEMA
  field when set, else a name heuristic, else True (the pre-label
  sentinel default, so old throughput records keep their polarity)."""
  base, _ = parse_labeled_key(name)
  base = base.split("/count")[0].split("/sum")[0]
  spec = SCHEMA.get(base)
  if spec is not None and spec.higher_is_better is not None:
    return spec.higher_is_better
  for needle, better in _DIRECTION_HINTS:
    if needle in base:
      return better
  return True


def snapshot_check(history: List[Dict[str, Any]],
                   fresh: Dict[str, Any],
                   key: str) -> Optional[Dict[str, Any]]:
  """Direction-aware sentinel over a SNAPSHOT key instead of the
  headline metric: synthesizes per-key rows from the stored snapshots
  and runs check_regression with the key's SCHEMA direction. Returns
  None when the fresh record has no such snapshot key (the variant is
  off)."""
  if key not in (fresh.get("snapshot") or {}):
    return None

  def _row(rec):
    snap = rec.get("snapshot") or {}
    if key not in snap or not isinstance(snap[key], (int, float)):
      return None
    return {
        "fingerprint": rec.get("fingerprint"),
        "metric": key,
        "fallback": rec.get("fallback"),
        "run_id": rec.get("run_id"),
        "t_wall": rec.get("t_wall", 0.0),
        "value": float(snap[key]),
    }

  hist_rows = [r for r in map(_row, history) if r is not None]
  fresh_row = _row(fresh)
  return check_regression(hist_rows, fresh_row,
                          higher_is_better=metric_direction(key))


# -- bench identity -----------------------------------------------------------

def bench_fingerprint(params) -> str:
  """Config fingerprint of a bench_torch.py run (program name "bench"),
  over its resolved Params."""
  from kf_benchmarks_tpu_torch.analysis import baseline as baseline_lib
  return baseline_lib.config_fingerprint_key(params._asdict(), "bench")


def git_revision(repo_dir: Optional[str] = None) -> Optional[str]:
  """Short git revision of ``repo_dir`` (default: this checkout), or
  None when git or its metadata is not there: a missing rev must never
  fail a run."""
  import subprocess
  cwd = repo_dir or os.path.dirname(os.path.dirname(
      os.path.abspath(__file__)))
  try:
    out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         capture_output=True, text=True, cwd=cwd,
                         timeout=10)
  except (OSError, subprocess.SubprocessError):
    return None
  rev = (out.stdout or "").strip()
  return rev if out.returncode == 0 and rev else None


# -- backfill of the TPU-era bench history ------------------------------------------

# The platform of the committed BENCH_*.json rows: the JAX package's
# bench.py on a TPU (its _CPU_FALLBACK rows ran on the host's CPU).
BACKFILL_PLATFORM = "tpu"


def bench_params_kwargs() -> Dict[str, Any]:
  """The headline bench config of bench_torch.py (ResNet-50, batch 256,
  bf16, momentum, the health stats on): one copy, so a record and a
  fresh bench run key the same fingerprint."""
  return dict(model="resnet50", batch_size=256, device="gpu",
              num_devices=1, variable_update="replicated", use_fp16=True,
              optimizer="momentum", display_every=10, health_stats=True)


def bench_rows(path: str) -> List[Dict[str, Any]]:
  """The bench record(s) in one ``BENCH_*.json``: the harness's wrapper
  (one object whose ``parsed`` holds bench.py's line) or raw JSONL (one
  record a line). Anything else yields nothing."""
  try:
    text = open(path, encoding="utf-8").read()
  except OSError:
    return []
  try:
    obj = json.loads(text)
  except ValueError:
    obj = None
  if isinstance(obj, dict):
    row = obj.get("parsed") if isinstance(obj.get("parsed"), dict) else obj
    return [row] if "metric" in row else []
  out = []
  for line in text.splitlines():
    try:
      row = json.loads(line)
    except ValueError:
      continue
    if isinstance(row, dict) and "metric" in row:
      out.append(row)
  return out


def _backfill_ordinal(name: str, line: int) -> int:
  """A backfilled row's t_wall: the file name's first 16 bytes as a
  big-endian integer (monotone in name order, stable under later
  insertions), far below any wall clock so history sorts first."""
  prefix = name.encode("utf-8", "replace")[:16].ljust(16, b"\0")
  return int.from_bytes(prefix, "big") * 4096 + int(line) - 2 ** 141


def backfill_fingerprint(metric: str, platform: str) -> str:
  """The key a backfilled row trends under: its platform and metric name.
  No port run keys a ``{"source": ...}`` payload, so a TPU row never
  shares a fingerprint with an H100 run."""
  from kf_benchmarks_tpu_torch.analysis import baseline as baseline_lib
  return baseline_lib.fingerprint_key({"source": "BENCH_*.json",
                                       "platform": platform,
                                       "metric": metric})


def backfill(repo_dir: str, store_dir: Optional[str] = None,
             pattern: str = r"BENCH_.*\.json$",
             log: Callable[[str], None] = print) -> Tuple[int, int]:
  """The committed ``BENCH_*.json`` history into the run store, each row
  tagged with the platform it ran on (``tpu``; a ``_CPU_FALLBACK`` row
  ``cpu`` and ``fallback``), never baseline. Idempotent (a row already
  in the store by run id and metric is skipped). (ingested, skipped)."""
  store = RunStore(store_dir or repo_dir)
  rx = re.compile(pattern)
  ingested = skipped = 0
  for name in sorted(n for n in os.listdir(repo_dir) if rx.match(n)):
    rows = bench_rows(os.path.join(repo_dir, name))
    if not rows:
      log(f"backfill: no bench record in {name}; skipped")
      continue
    stem = os.path.splitext(name)[0]
    for i, row in enumerate(rows):
      if row.get("value") is None:
        skipped += 1
        continue
      metric = str(row["metric"])
      fallback = "_CPU_FALLBACK" in metric
      platform = "cpu" if fallback else BACKFILL_PLATFORM
      run_id = f"backfill-{stem}" + (f"-{i + 1}" if len(rows) > 1 else "")
      if store.has_run(run_id, metric):
        skipped += 1
        continue
      rec = run_record(
          metric=metric, value=float(row["value"]),
          unit=str(row.get("unit") or "1"),
          fingerprint=backfill_fingerprint(metric, platform),
          run_id=run_id, platform=platform, fallback=fallback,
          git_rev=row.get("git_rev"), snapshot=flatten_stats(row))
      rec["t_wall"] = _backfill_ordinal(name, i)
      store.append(rec)
      ingested += 1
      log(f"backfill: {name} -> {metric} = {row['value']} [{platform}"
          + (", fallback]" if fallback else "]"))
  log(f"backfill: {ingested} record(s) ingested, {skipped} skipped -> "
      f"{store.path}")
  return ingested, skipped


# -- schema audit -------------------------------------------------------------------

def _ast_emitted_keys(path: str) -> List[Tuple[str, int]]:
  """Literal keys of the metric-emitting dicts of a source file: a dict
  literal with an ``images_per_sec`` key (the stats) or both ``metric``
  and ``value`` (the bench record), and ``record["..."] =``
  assignments."""
  import ast
  try:
    tree = ast.parse(open(path, encoding="utf-8").read())
  except (OSError, SyntaxError):
    return []
  out = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Dict):
      keys = [k.value for k in node.keys
              if isinstance(k, ast.Constant) and isinstance(k.value, str)]
      if "images_per_sec" in keys or {"metric", "value"} <= set(keys):
        out.extend((k, node.lineno) for k in keys)
    elif (isinstance(node, ast.Assign) and len(node.targets) == 1
          and isinstance(node.targets[0], ast.Subscript)
          and isinstance(node.targets[0].value, ast.Name)
          and node.targets[0].value.id == "record"
          and isinstance(node.targets[0].slice, ast.Constant)
          and isinstance(node.targets[0].slice.value, str)):
      out.append((node.targets[0].slice.value, node.lineno))
  return out


def schema_audit(repo_dir: str, store_dir: Optional[str] = None
                 ) -> List[str]:
  """The metric schema against what the port emits: distinct Prometheus
  names, every health and tracing key registered with its histogram twin,
  declared labels and directions, every literal key of the stats and the
  bench record registered or bookkeeping (NON_METRIC_KEYS), every
  BENCH_*.json row flattening onto registered keys, the store's records
  valid (``store_dir``), and a fully populated registry rendering valid
  Prometheus text. Problem strings (empty = clean)."""
  problems: List[str] = []
  prom: Dict[str, str] = {}
  for name in SCHEMA:
    p = prometheus_name(name)
    if p in prom:
      problems.append(f"schema: {name!r} and {prom[p]!r} both render as {p}")
    prom[p] = name
  for k in HEALTH_KEYS + HEALTH_SUMMARY_KEYS:
    if health_key(k) not in SCHEMA:
      problems.append(f"schema: telemetry key {health_key(k)!r} is not "
                      "registered")
  for key in _tracing.SAMPLE_KEYS:
    for q in _tracing.QUANTILES:
      if f"{key}_p{q}" not in SCHEMA:
        problems.append(f"schema: tracing percentile field "
                        f"{key}_p{q!r} is not registered")
    twins = [key, key + "_s"]
    if not any(SCHEMA.get(t) is not None and SCHEMA[t].kind == "histogram"
               for t in twins):
      problems.append(f"schema: tracing sample key {key!r} has no "
                      f"histogram twin (looked for {twins})")
  needs_direction = re.compile(r"_p(50|90|99)$")
  for name, spec in SCHEMA.items():
    for lab in spec.labels:
      if lab not in LABEL_NAMES:
        problems.append(f"schema: {name!r} declares label {lab!r} outside "
                        f"LABEL_NAMES {LABEL_NAMES}")
    if spec.kind == "gauge" and spec.higher_is_better is None and (
        needs_direction.search(name) or "per_sec" in name
        or "shed_fraction" in name or "_burn_" in name):
      problems.append(f"schema: sentinel-judged gauge {name!r} has no "
                      "higher_is_better direction")
  for rel in ("kf_benchmarks_tpu_torch/benchmark.py", "bench_torch.py"):
    for key, lineno in _ast_emitted_keys(os.path.join(repo_dir, rel)):
      if key not in SCHEMA and key not in NON_METRIC_KEYS:
        problems.append(f"{rel}:{lineno}: emitted key {key!r} is neither "
                        "registered nor in NON_METRIC_KEYS")
  for name in sorted(os.listdir(repo_dir)):
    if not re.match(r"BENCH_.*\.json$", name):
      continue
    rows = bench_rows(os.path.join(repo_dir, name))
    if not rows:
      problems.append(f"{name}: no bench record found")
    for row in rows:
      for key, value in row.items():
        if key in NON_METRIC_KEYS or value is None or key in SCHEMA:
          continue
        problems.append(f"{name}: bench key {key!r} is not in the metric "
                        "schema")
  if store_dir:
    store = RunStore(store_dir)
    for i, rec in enumerate(store.records()):
      problems.extend(f"{store.path}: record {i}: {p}"
                      for p in validate_record(rec))
  reg = MetricRegistry()
  for name, spec in SCHEMA.items():
    labeled = {spec.labels[0]: "t0"} if spec.labels else None
    if spec.kind == "info":
      reg.set(name, "x")
    elif spec.kind == "histogram":
      reg.observe(name, 0.5)
      if labeled:
        reg.observe(name, 0.5, labels=labeled)
    elif spec.kind == "counter":
      reg.inc(name)
      if labeled:
        reg.inc(name, labels=labeled)
    else:
      reg.set(name, 1.5)
      if labeled:
        reg.set(name, 1.5, labels=labeled)
  problems.extend("prometheus render: " + p
                  for p in validate_prometheus_text(reg.render()))
  return problems


# -- fleet report ----------------------------------------------------------------

def fleet_rows(records: List[Dict[str, Any]],
               fingerprint: Optional[str] = None,
               metric: Optional[str] = None,
               platform: Optional[str] = None,
               fallback: str = "all") -> List[Dict[str, Any]]:
  """Group store records into per-(fingerprint, metric) trend rows with
  a direction-aware verdict on the LATEST record vs its own trailing
  history. ``fingerprint`` is a prefix filter (verdict lines only print
  16 chars); ``fallback`` is "all" | "only" | "none"."""
  rows = []
  for rec in records:
    if validate_record(rec):
      continue
    if fingerprint and not rec["fingerprint"].startswith(fingerprint):
      continue
    if metric and rec["metric"] != metric:
      continue
    if platform and rec["platform"] != platform:
      continue
    if fallback == "only" and not rec["fallback"]:
      continue
    if fallback == "none" and rec["fallback"]:
      continue
    rows.append(rec)
  groups: Dict[Tuple[str, str, bool], List[Dict[str, Any]]] = {}
  for rec in rows:
    groups.setdefault(
        (rec["fingerprint"], rec["metric"], rec["fallback"]),
        []).append(rec)
  out = []
  for (fp, met, fb), rs in sorted(groups.items()):
    rs.sort(key=lambda r: r.get("t_wall", 0.0))
    values = [float(r["value"]) for r in rs]
    direction = metric_direction(met)
    verdict = check_regression(rs[:-1], rs[-1],
                               higher_is_better=direction)
    out.append({
        "fingerprint": fp,
        "metric": met,
        "unit": rs[-1].get("unit"),
        "platform": rs[-1].get("platform"),
        "fallback": fb,
        "n": len(rs),
        "values": values,
        "first": values[0],
        "last": values[-1],
        "median": _tracing.percentile(values, 50),
        "direction": direction,
        "verdict": verdict["status"],
        "records": rs,
    })
  return out


def format_fleet_report(rows: List[Dict[str, Any]]) -> str:
  """Aligned per-fingerprint trend table, the report CLI's output. Empty
  input says how to fill the store instead of printing a bare header."""
  if not rows:
    return ("fleet report: no matching run records. Populate the "
            "store first: a training run with --run_store_dir, or "
            "bench_torch.py --run_store_dir.\n")
  header = ("FINGERPRINT", "METRIC", "N", "FIRST", "LAST", "MEDIAN",
            "BETTER", "VERDICT", "FLAGS")
  table = [header]
  for r in rows:
    flags = []
    if r["fallback"]:
      flags.append("_CPU_FALLBACK")
    if r["platform"]:
      flags.append(str(r["platform"]))
    table.append((
        r["fingerprint"][:16],
        r["metric"],
        str(r["n"]),
        "%.3f" % r["first"],
        "%.3f" % r["last"],
        "%.3f" % r["median"],
        "higher" if r["direction"] else "lower",
        r["verdict"],
        ",".join(flags),
    ))
  widths = [max(len(row[i]) for row in table)
            for i in range(len(header))]
  lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
           for row in table]
  lines.append("fleet report: %d trend row(s) over %d record(s)" % (
      len(rows), sum(r["n"] for r in rows)))
  return "\n".join(lines) + "\n"


def _svg_sparkline(series: List[float], w: int = 220, h: int = 48) -> str:
  """A self-contained inline-SVG sparkline (no script, no external
  asset)."""
  pad = 4.0
  if not series:
    return f'<svg width="{w}" height="{h}"></svg>'
  lo, hi = min(series), max(series)
  span = (hi - lo) or 1.0

  def xy(i, v):
    x = pad + (w - 2 * pad) * (i / max(1, len(series) - 1))
    y = pad + (h - 2 * pad) * (1.0 - (v - lo) / span)
    return f"{x:.1f},{y:.1f}"

  if len(series) == 1:
    x, y = xy(0, series[0]).split(",")
    body = f'<circle cx="{x}" cy="{y}" r="3" fill="#36c"/>'
  else:
    pts = " ".join(xy(i, v) for i, v in enumerate(series))
    body = (f'<polyline points="{pts}" fill="none" stroke="#36c" '
            'stroke-width="1.5"/>')
  return f'<svg width="{w}" height="{h}" viewBox="0 0 {w} {h}">{body}</svg>'


_SERVING_CURVE_KEYS = ("serving/ttft_p50", "serving/ttft_p90",
                       "serving/ttft_p99")
_CURVE_COLORS = ("#2a9d5c", "#e0a426", "#d0453e")


def fleet_report_html(rows: List[Dict[str, Any]]) -> str:
  """One self-contained HTML page of ``fleet_rows``: a sparkline a trend
  row and the serving TTFT curves where the snapshots carry them, in one
  section per platform (the card's runs first, then backfilled TPU-era
  rows, then CPU fallback probes, greyed), so no trend mixes machines."""
  import html as _html

  def row_html(r):
    cells = [
        f"<td><code>{_html.escape(r['fingerprint'][:16])}</code></td>",
        f"<td>{_html.escape(r['metric'])}</td>",
        f"<td>{r['n']}</td>",
        f"<td>{r['last']:.3f} {_html.escape(str(r['unit'] or ''))}</td>",
        f"<td>{'higher' if r['direction'] else 'lower'}</td>",
        f"<td class=\"v-{_html.escape(r['verdict'])}\">"
        f"{_html.escape(r['verdict'])}</td>",
        f"<td>{_svg_sparkline(r['values'])}</td>",
    ]
    curves = []
    for key, color in zip(_SERVING_CURVE_KEYS, _CURVE_COLORS):
      series = [float(rec["snapshot"][key]) for rec in r["records"]
                if isinstance((rec.get("snapshot") or {}).get(key),
                              (int, float))]
      if series:
        curves.append(_svg_sparkline(series).replace("#36c", color))
    cells.append("<td>" + "".join(curves) + "</td>")
    return "<tr>" + "".join(cells) + "</tr>"

  head = ("<tr><th>fingerprint</th><th>metric</th><th>n</th><th>last</th>"
          "<th>better</th><th>verdict</th><th>trend</th>"
          "<th>serving ttft p50/p90/p99</th></tr>")
  groups = [
      ("Card runs (gpu)", "",
       [r for r in rows if r["platform"] == "gpu" and not r["fallback"]]),
      ("CPU runs", "",
       [r for r in rows if r["platform"] == "cpu" and not r["fallback"]]),
      (f"Backfilled {BACKFILL_PLATFORM.upper()}-era rows (another machine; "
       "never compared with a card run)", "other",
       [r for r in rows if r["platform"] not in ("gpu", "cpu")
        and not r["fallback"]]),
      ("_CPU_FALLBACK probes (never baseline)", "fallback",
       [r for r in rows if r["fallback"]]),
  ]
  sections = []
  for title, css, group in groups:
    if group:
      sections.append(f'<div class="{css}"><h2>{_html.escape(title)}</h2>'
                      f"<table>{head}"
                      + "".join(row_html(r) for r in group)
                      + "</table></div>")
  if not sections:
    sections.append("<p>No matching run records. Fill the store: a "
                    "training run with <code>--run_store_dir</code>, or "
                    "<code>python -m kf_benchmarks_tpu_torch.metrics "
                    "backfill</code></p>")
  return (
      "<!doctype html><html><head><meta charset=\"utf-8\">"
      "<title>kf_benchmarks_tpu_torch fleet report</title><style>"
      "body{font-family:sans-serif;margin:24px}"
      "table{border-collapse:collapse}"
      "td,th{border:1px solid #ccc;padding:4px 8px;text-align:left}"
      ".v-regression{color:#b00;font-weight:bold}"
      ".v-ok{color:#080}.v-no_history{color:#888}"
      ".other{opacity:0.8;margin-top:24px}"
      ".fallback{opacity:0.55;filter:grayscale(1);margin-top:24px}"
      "</style></head><body><h1>kf_benchmarks_tpu_torch fleet report</h1>"
      + "".join(sections) + "</body></html>\n")


# -- CLI ----------------------------------------------------------------------

def main(argv=None) -> int:
  import argparse
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  parser = argparse.ArgumentParser(
      prog="python -m kf_benchmarks_tpu_torch.metrics",
      description="run-record store tools: backfill the BENCH_*.json "
                  "history, audit the metric schema, render the cross-run "
                  "fleet report")
  sub = parser.add_subparsers(dest="cmd", required=True)
  p_back = sub.add_parser("backfill", help="ingest the committed "
                          "BENCH_*.json history, tagged with its platform")
  p_back.add_argument("--repo_dir", default=repo)
  p_back.add_argument("--run_store_dir", required=True)
  p_aud = sub.add_parser("audit", help="the metric-schema audit")
  p_aud.add_argument("--repo_dir", default=repo)
  p_aud.add_argument("--run_store_dir", default=None)
  p_rep = sub.add_parser(
      "report", help="per-fingerprint trend table from the run store")
  p_rep.add_argument("--run_store_dir", required=True,
                     help="the store's directory (a training run's or "
                          "bench_torch.py's --run_store_dir)")
  p_rep.add_argument("--fingerprint", default=None,
                     help="fingerprint prefix filter")
  p_rep.add_argument("--metric", default=None)
  p_rep.add_argument("--platform", default=None)
  p_rep.add_argument("--fallback", default="all",
                     choices=("all", "only", "none"),
                     help="fallback probes: include, only, or drop")
  p_rep.add_argument("--html", default=None,
                     help="also write the self-contained HTML report here")
  args = parser.parse_args(argv)
  if args.cmd == "backfill":
    backfill(args.repo_dir, args.run_store_dir)
    return 0
  if args.cmd == "audit":
    problems = schema_audit(args.repo_dir, args.run_store_dir)
    for p in problems:
      print(f"METRICS SCHEMA PROBLEM {p}")
    print(f"metrics schema audit: {len(problems)} problem(s)")
    return 1 if problems else 0
  rows = fleet_rows(RunStore(args.run_store_dir).records(),
                    fingerprint=args.fingerprint, metric=args.metric,
                    platform=args.platform, fallback=args.fallback)
  print(format_fleet_report(rows), end="")
  if args.html:
    os.makedirs(os.path.dirname(args.html) or ".", exist_ok=True)
    with open(args.html, "w", encoding="utf-8") as f:
      f.write(fleet_report_html(rows))
    print(f"fleet report written: {args.html}")
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
