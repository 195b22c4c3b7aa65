"""Metric registry: the serving engine's typed metric keys and SLO monitor.

The port's own copy of the part of kf_benchmarks_tpu/metrics.py that the
serving engine and the training telemetry use (stdlib only, nothing imported from the JAX package):

* ``SCHEMA`` -- the registered metric keys, here the ``serving/*`` entries
  (kind, unit, label names, direction), as the JAX package registers them;
* ``MetricRegistry`` -- ``set`` / ``inc`` / ``observe`` on registered keys
  only, with labels from each key's declared set; histograms keep
  cumulative bins;
* ``activate`` / ``deactivate`` / ``active`` -- the process's registry, or
  a no-op sink;
* ``flatten_stats`` / ``labeled_key`` / ``parse_labeled_key`` -- the flat
  ``name{label="value"}`` form of labeled series;
* ``SLOMonitor`` -- the multi-window error-budget burn-rate monitor;
* ``HEALTH_KEYS`` / ``HEALTH_SUMMARY_KEYS`` / ``health_key`` -- the
  training-health vector's keys and their ``health/`` namespace
  (telemetry.py).

The Prometheus exposition, the ``/metrics`` endpoint (``MetricsServer``),
the run store and the regression sentinel are not ported yet.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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
  kind: str    # "counter" | "gauge" | "histogram"
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


# -- labeled keys --------------------------------------------------------------

_LABELED_KEY_RE = re.compile(r"^([^{}]+)\{(.*)\}$")
_LABEL_ITEM_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _escape_label(v: str) -> str:
  return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


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


# -- registry ------------------------------------------------------------------

HIST_BUCKETS_SECONDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
HIST_BUCKETS_TOKENS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def hist_buckets(spec: MetricSpec) -> Tuple[float, ...]:
  return (HIST_BUCKETS_TOKENS if spec.unit == "tokens"
          else HIST_BUCKETS_SECONDS)


class MetricRegistry:
  """Typed, thread-safe value store over SCHEMA: an unregistered key or an
  undeclared label name raises."""

  def __init__(self):
    self._lock = threading.Lock()
    self._values: Dict[str, float] = {}
    # Histogram rows: [count, sum, per-bin counts (+Inf bin last)].
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
    for lab in labels or ():
      if lab not in spec.labels:
        raise ValueError(f"unregistered label name {lab!r} on metric "
                         f"{spec.name!r}: its SCHEMA entry declares "
                         f"{spec.labels!r}")
    return labeled_key(spec.name, labels)

  def set(self, name: str, value,
          labels: Optional[Dict[str, Any]] = None) -> None:
    spec = self._spec(name)
    if spec.kind == "histogram":
      raise ValueError(f"{name} is a histogram; use observe()")
    key = self._key(spec, labels)
    with self._lock:
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
      row = self._hists.setdefault(key, [0, 0.0, [0] * (len(bounds) + 1)])
      row[0] += 1
      row[1] += v
      i = 0
      while i < len(bounds) and v > bounds[i]:
        i += 1
      row[2][i] += 1

  def snapshot(self) -> Dict[str, Any]:
    """Flat {key: value} of every scalar series; histograms as
    ``<key>/count`` and ``<key>/sum``."""
    with self._lock:
      out: Dict[str, Any] = dict(self._values)
      hists = {k: (row[0], row[1]) for k, row in self._hists.items()}
    for k, (count, total) in hists.items():
      base, labels = parse_labeled_key(k)
      out[labeled_key(base + "/count", labels)] = count
      out[labeled_key(base + "/sum", labels)] = total
    return out


def flatten_stats(stats: Dict[str, Any]) -> Dict[str, Any]:
  """One flat {registered key: value} view of the serving engine's stats:
  the per-tenant block (``serving_tenants``) expands onto tenant-labeled
  keys (sheds additionally carry ``shed_reason``); None values and keys
  outside SCHEMA drop out."""
  out: Dict[str, Any] = {}
  for key, value in (stats or {}).items():
    if value is None:
      continue
    if key == "serving_tenants" and isinstance(value, dict):
      for tenant, block in value.items():
        for tk, tv in block.items():
          if tv is None:
            continue
          if tk == "serving/shed" and isinstance(tv, dict):
            for reason, n in tv.items():
              out[labeled_key("serving/shed", {
                  "tenant": tenant, "shed_reason": reason})] = float(n)
          elif tk in SCHEMA and isinstance(tv, (int, float)) and \
              not isinstance(tv, bool):
            out[labeled_key(tk, {"tenant": tenant})] = float(tv)
      continue
    if key in SCHEMA and isinstance(value, (int, float)):
      out[key] = float(value)
  return out


class _NullRegistry:
  """No-op sink with MetricRegistry's surface."""

  def set(self, *a, **k) -> None:
    pass

  def inc(self, *a, **k) -> None:
    pass

  def observe(self, *a, **k) -> None:
    pass

  def snapshot(self) -> Dict[str, Any]:
    return {}


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
