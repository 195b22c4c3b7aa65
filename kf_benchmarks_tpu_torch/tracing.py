"""Run tracing: host-side spans, latency samples and the compile ledger.

The port's own copy of the part of kf_benchmarks_tpu/tracing.py that the
serving engine uses (stdlib only, nothing imported from the JAX package):
``RunTrace`` with ``span`` / ``add_span`` / ``instant`` (the timeline),
``add_sample`` / ``percentiles`` (streaming latency samples),
``note_compile`` / ``compile_ledger`` (here: the time each prepared serving
callable took on its first, warming run) and ``now``; the active-trace
registry (``activate``, ``deactivate``, ``active``); ``percentile``; and
``resolve_run_id``, the job's run id (``KF_RUN_ID`` from kfrun).
The Chrome-trace export, the persisted ledger and the multi-rank merge are
not ported yet.

Spans are host-clock intervals: device work is asynchronous, so a span
around a device call measures only the enqueue unless the code inside it
fetches a value (the serving engine's token fetch does).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional


def resolve_run_id(wall_fn=time.time) -> str:
  """One run id shared by the flight recorder's rows and the trace.

  Under kfrun every worker inherits KF_RUN_ID from the launcher, so all
  ranks and restart generations of one job share a single id; a
  standalone process mints a wall-clock/pid-derived one."""
  env = os.environ.get("KF_RUN_ID")
  if env:
    return env
  return f"run-{int(wall_fn() * 1000.0):x}-{os.getpid():x}"


def percentile(values, q: float) -> Optional[float]:
  """Linear-interpolated percentile (numpy's default convention) in plain
  python; None on an empty sample set."""
  vs = sorted(float(v) for v in values)
  if not vs:
    return None
  if len(vs) == 1:
    return vs[0]
  pos = (len(vs) - 1) * (q / 100.0)
  lo = int(pos)
  hi = min(lo + 1, len(vs) - 1)
  frac = pos - lo
  return vs[lo] * (1.0 - frac) + vs[hi] * frac


class RunTrace:
  """One process's span timeline, latency samples and compile ledger.

  ``keep_spans=False`` keeps samples and the ledger but not the span list
  (the JAX package retains spans only when it has an export path).
  ``time_fn`` is injectable so tests drive a fake clock. Thread-safe."""

  def __init__(self, keep_spans: bool = False, time_fn=time.monotonic):
    self._time = time_fn
    self._lock = threading.Lock()
    self._keep_spans = keep_spans
    self.spans: List[Dict[str, Any]] = []
    self._next_id = 1
    self._samples: Dict[str, List[float]] = {}
    self._ledger: List[Dict[str, Any]] = []

  def now(self) -> float:
    """This trace's clock (callers attributing spans retrospectively read
    time here, so fake-clock tests stay consistent)."""
    return self._time()

  def add_span(self, subsystem: str, name: str, t0: float, dur_s: float,
               args: Optional[Dict[str, Any]] = None) -> int:
    """Record a completed span (``t0`` from ``now()``); its id, or 0 when
    spans are not kept."""
    return self._emit("X", subsystem, name, float(t0),
                      max(0.0, float(dur_s)), dict(args or {}))

  def instant(self, subsystem: str, name: str, **args) -> int:
    """A zero-duration marker event."""
    return self._emit("i", subsystem, name, self._time(), 0.0, dict(args))

  def _emit(self, ph: str, subsystem: str, name: str, t0: float,
            dur_s: float, args: Dict[str, Any]) -> int:
    with self._lock:
      if not self._keep_spans:
        return 0
      sid = self._next_id
      self._next_id += 1
      self.spans.append({"id": sid, "ph": ph, "sub": subsystem,
                         "name": name, "t0": t0, "dur": dur_s,
                         "args": args})
    return sid

  @contextlib.contextmanager
  def span(self, subsystem: str, name: str, **args):
    """Context-manager span; yields its (mutable) args dict."""
    t0 = self._time()
    live_args = dict(args)
    try:
      yield live_args
    finally:
      self.add_span(subsystem, name, t0, self._time() - t0, live_args)

  def add_sample(self, key: str, seconds: float) -> None:
    with self._lock:
      self._samples.setdefault(key, []).append(float(seconds))

  def percentiles(self) -> Dict[str, Dict[str, float]]:
    """{key: {p50, p90, p99, n}} over every sampled key."""
    with self._lock:
      samples = {k: list(v) for k, v in self._samples.items()}
    return {key: {"p50": percentile(vs, 50), "p90": percentile(vs, 90),
                  "p99": percentile(vs, 99), "n": len(vs)}
            for key, vs in sorted(samples.items())}

  def note_compile(self, key: str, program: str, wall_s: float,
                   **meta) -> None:
    """Record one preparation episode of the program shape ``key``
    (a fingerprint), with the wall seconds of its first run."""
    entry = {"key": key, "program": program,
             "wall_s": round(float(wall_s), 6)}
    entry.update(meta)
    with self._lock:
      self._ledger.append(entry)
    self.add_span("compile", program, self._time() - float(wall_s),
                  float(wall_s), {"fingerprint": key, **meta})

  def compile_ledger(self) -> Dict[str, Any]:
    """Distinct program shapes, total seconds and the entries."""
    with self._lock:
      entries = list(self._ledger)
    return {
        "shapes": len({e["key"] for e in entries}),
        "total_compile_s": round(sum(e["wall_s"] for e in entries), 6),
        "entries": entries,
    }


class _NullTrace:
  """No-op sink with RunTrace's emission surface."""

  def now(self) -> float:
    return 0.0

  def add_span(self, *a, **k) -> int:
    return 0

  def instant(self, *a, **k) -> int:
    return 0

  @contextlib.contextmanager
  def span(self, *a, **k):
    yield {}

  def add_sample(self, *a, **k) -> None:
    pass

  def percentiles(self) -> Dict[str, Any]:
    return {}

  def note_compile(self, *a, **k) -> None:
    pass

  def compile_ledger(self) -> Dict[str, Any]:
    return {"shapes": 0, "total_compile_s": 0.0, "entries": []}


NULL_TRACE = _NullTrace()
_active: Any = None


def activate(trace: RunTrace) -> RunTrace:
  global _active
  _active = trace
  return trace


def deactivate() -> None:
  global _active
  _active = None


def active():
  """The process's active RunTrace, or the no-op sink."""
  return _active if _active is not None else NULL_TRACE
