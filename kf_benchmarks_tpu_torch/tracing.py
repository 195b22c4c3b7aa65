"""Run tracing: the whole-run host-side span timeline, its Chrome-trace
export and multi-rank merge, the compile ledger, streaming latency
percentiles.

The port's own copy of kf_benchmarks_tpu/tracing.py (stdlib only, nothing
imported from the JAX package). Every wall-clock boundary a training run
crosses -- the DeviceFeeder's fetches and waits, each dispatch's issue and
its completion, first calls of a program, checkpoint save and restore,
mid-training eval, elastic seams, fault injections -- is one span or
instant event, and the serving engine's requests ride the "serving" lane.
``export`` writes them as Chrome trace-event JSON (``--trace_events_file``;
Perfetto and chrome://tracing load it) with ``pid`` = rank and ``tid`` =
subsystem, or as raw span JSONL under ``--use_chrome_trace_format=false``;
rank 0 merges every rank's file at exit, and a restarted generation of one
run id extends its file. The torch.profiler capture of ``--trace_file``
(observability.maybe_trace_step) is the device-level picture of one
dispatch; it drops a marker span here so the two line up.

Tracing is host-only: a step with it on launches the same kernels as a
step with it off, and its losses are bitwise the same.

Spans are host-clock intervals measured with ``time.monotonic`` and
anchored to the wall clock once, at construction, so ranks merge onto one
axis. Device work is asynchronous: a dispatch span brackets the call
alone, and each dispatch's device span is its metrics-pipeline arrival
interval (utils/pipeline.py), with the host issue time in its args.

On the same spans:

* **compile ledger** -- the wall seconds of each program's first call (the
  port's one-time costs: kernel loads, cuDNN's plans, a CUDA-graph
  capture), keyed on ``analysis/baseline.config_fingerprint_key``,
  persisted and merged into ``train_dir/compile_ledger.json`` and printed
  as a table at run end;
* **latency percentiles** -- p50/p90/p99 of chunk wall, feed wait and
  checkpoint save (and the serving engine's TTFT, token latency and
  accepted prefix), printed at run end and carried in the run's stats.

``RunTrace(keep_spans=True)`` keeps the span list without an export path
(the serving engine's callers read ``spans``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# Subsystem lanes (Chrome tid; one timeline row per subsystem under
# each rank's pid). Order fixes the tid numbering so merged multi-rank
# timelines line up row-for-row. "serving" is the request engine's lane
# (serving/engine.py: enqueue/shed instants, prefill/decode-step spans,
# whole-request spans).
SUBSYSTEMS = ("run", "compile", "dispatch", "device", "feed",
              "checkpoint", "eval", "elastic", "faults", "profiler",
              "serving")

# Canonical latency-sample keys (the percentile lines / stats fields).
# The serving/* entries come from the request engine: TTFT per request,
# decode-step wall per emitted token, and the accepted speculative
# prefix length per slot per verify round (serving/engine.py).
SAMPLE_KEYS = ("chunk_wall", "feed_wait", "checkpoint_save",
               "serving/ttft", "serving/token_latency",
               "serving/accept_len")

# Reported quantiles. Every ``<key>_p<q>`` stats field is SAMPLE_KEYS x
# QUANTILES; the metric registry (metrics.py) registers each rendered
# key literally.
QUANTILES = (50, 90, 99)

# The persisted per-train_dir compile ledger (write_ledger /
# read_ledger below).
LEDGER_FILENAME = "compile_ledger.json"


def resolve_run_id(wall_fn=time.time) -> str:
  """One run id shared by the trace and the flight recorder.

  Under kfrun every worker inherits KF_RUN_ID from the launcher, so all
  ranks of one job share a single id (the merge invariant); standalone
  processes mint a wall-clock/pid-derived one."""
  env = os.environ.get("KF_RUN_ID")
  if env:
    return env
  return f"run-{int(wall_fn() * 1000.0):x}-{os.getpid():x}"


def percentile(values, q: float) -> Optional[float]:
  """Linear-interpolated percentile (numpy's default convention) in
  pure deterministic python; None on an empty sample set."""
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


def _event_sort_key(e):
  """Metadata rows first, then epoch order: the one event ordering
  every export and merge path shares."""
  return (e.get("ph") != "M", e.get("ts", 0.0))


def _payload(events, run_id: str, **extra_meta) -> Dict[str, Any]:
  """The one Chrome trace-event JSON payload shape (its format name is
  the JAX package's: the two packages' files are one format)."""
  meta: Dict[str, Any] = {"run_id": run_id,
                          "format": "kf_benchmarks_tpu run trace"}
  meta.update(extra_meta)
  return {"traceEvents": events, "displayTimeUnit": "ms",
          "metadata": meta}


def rank_path(path: str, rank: int) -> str:
  """Per-rank span-file path: rank 0 owns the canonical ``path`` (and
  the merged timeline); other ranks write rank-suffixed siblings the
  rank-0 exit merge collects -- the flight_recorder_path convention."""
  if rank == 0:
    return path
  base, ext = os.path.splitext(path)
  return f"{base}.rank{rank}{ext or '.json'}"


def validate_chrome_trace(obj) -> List[str]:
  """Structural check of a Chrome trace-event JSON object; returns
  problem strings (empty = valid). The schema contract the export tests
  pin (the Trace Event Format: ph/ts/dur/pid/tid/name fields)."""
  problems = []
  if not isinstance(obj, dict):
    return ["top level is not an object"]
  events = obj.get("traceEvents")
  if not isinstance(events, list):
    return ["traceEvents missing or not a list"]
  for i, e in enumerate(events):
    if not isinstance(e, dict):
      problems.append(f"event {i} is not an object")
      continue
    ph = e.get("ph")
    if ph not in ("M", "X", "i"):
      problems.append(f"event {i}: unknown ph {ph!r}")
      continue
    if not isinstance(e.get("name"), str) or not e["name"]:
      problems.append(f"event {i}: missing name")
    if not isinstance(e.get("pid"), int) or not isinstance(
        e.get("tid"), int):
      problems.append(f"event {i}: pid/tid must be ints")
    if ph in ("X", "i"):
      ts = e.get("ts")
      if not isinstance(ts, (int, float)) or ts < 0:
        problems.append(f"event {i}: bad ts {ts!r}")
    if ph == "X":
      dur = e.get("dur")
      if not isinstance(dur, (int, float)) or dur < 0:
        problems.append(f"event {i}: bad dur {dur!r}")
  return problems


class RunTrace:
  """One process's span timeline + latency samples + compile ledger.

  Host-side only and always cheap: with no ``path`` the span list is
  not retained (samples and the ledger still are, so percentile lines
  and bench JSON fields work without ``--trace_events_file``). All
  methods are thread-safe (the DeviceFeeder worker emits feed spans
  from its own thread). ``time_fn``/``wall_fn`` are injectable so the
  unit tests drive a deterministic clock.
  """

  MAX_SPANS = 200_000  # bound memory on very long runs; drops counted
  # Per-key latency-sample bound: at the cap the list decimates 2:1 and
  # the key's stride doubles (keep every 2^k-th sample), so a multi-day
  # run's feed_wait stream stays bounded while the percentile estimate
  # keeps its shape; reported n stays the TRUE observation count.
  MAX_SAMPLES = 16_384

  def __init__(self, path: Optional[str] = None, rank: int = 0,
               num_ranks: int = 1, run_id: Optional[str] = None,
               chrome_format: bool = True, time_fn=time.monotonic,
               wall_fn=time.time, log_fn=None,
               keep_spans: Optional[bool] = None):
    self.path = path
    self.rank = int(rank)
    self.num_ranks = max(1, int(num_ranks))
    self.chrome_format = bool(chrome_format)
    self.run_id = run_id or resolve_run_id(wall_fn=wall_fn)
    self._time = time_fn
    self._wall = wall_fn
    self._log = log_fn or (lambda s: None)
    self._lock = threading.Lock()
    # Wall anchor: spans are monotonic-clocked; export maps them onto
    # the epoch axis via this one (wall, mono) pair so ranks merge onto
    # a comparable timeline.
    self._anchor_mono = self._time()
    self._anchor_wall = self._wall()
    self._keep_spans = (path is not None if keep_spans is None
                        else bool(keep_spans))
    self.spans: List[Dict[str, Any]] = []
    self._dropped = 0
    self._next_id = 1
    self._tids: Dict[str, int] = {s: i for i, s in enumerate(SUBSYSTEMS)}
    self._samples: Dict[str, List[float]] = {}
    self._sample_counts: Dict[str, int] = {}
    self._sample_strides: Dict[str, int] = {}
    self._ledger: List[Dict[str, Any]] = []

  # -- clock ------------------------------------------------------------------

  def now(self) -> float:
    """This session's monotonic clock (the injectable one -- callers
    attributing spans retrospectively must read time here, not
    time.monotonic, or fake-clock tests skew)."""
    return self._time()

  def _tid(self, subsystem: str) -> int:
    if subsystem not in self._tids:
      self._tids[subsystem] = len(self._tids)
    return self._tids[subsystem]

  # -- span emission (the ONE place trace records are built) ------------------

  def add_span(self, subsystem: str, name: str, t0: float, dur_s: float,
               args: Optional[Dict[str, Any]] = None) -> int:
    """Record a completed span retrospectively (``t0`` from ``now()``);
    returns its id, or 0 when the span was NOT retained (no export
    path, or the MAX_SPANS cap dropped it) -- so a cross-link consumer
    (the flight recorder's span_id) never references a span absent
    from the exported timeline. The retrospective form exists for
    durations measured elsewhere -- the pipeline's chunk arrival
    intervals, the feeder's consumer wait -- where wrapping a ``with``
    block around the measured region is not possible."""
    return self._emit("X", subsystem, name, float(t0),
                      max(0.0, float(dur_s)), dict(args or {}))

  def instant(self, subsystem: str, name: str, **args) -> int:
    """A zero-duration marker event (fault injections, profiler-capture
    markers); returns its id, or 0 when not retained."""
    return self._emit("i", subsystem, name, self._time(), 0.0,
                      dict(args))

  def _emit(self, ph: str, subsystem: str, name: str, t0: float,
            dur_s: float, args: Dict[str, Any]) -> int:
    with self._lock:
      if not self._keep_spans:
        return 0
      if len(self.spans) >= self.MAX_SPANS:
        self._dropped += 1
        return 0
      sid = self._next_id
      self._next_id += 1
      self.spans.append({
          "id": sid, "ph": ph, "sub": subsystem,
          "tid": self._tid(subsystem), "name": name,
          "t0": t0, "dur": dur_s, "args": args,
      })
    return sid

  @contextlib.contextmanager
  def span(self, subsystem: str, name: str, **args):
    """Context manager form; yields the (mutable) args dict so callers
    can attach results discovered inside the span (e.g. the elastic
    generation number)."""
    t0 = self._time()
    live_args = dict(args)
    try:
      yield live_args
    finally:
      self.add_span(subsystem, name, t0, self._time() - t0, live_args)

  # -- latency samples --------------------------------------------------------

  def add_sample(self, key: str, seconds: float) -> None:
    with self._lock:
      self._sample_counts[key] = self._sample_counts.get(key, 0) + 1
      stride = self._sample_strides.setdefault(key, 1)
      if (self._sample_counts[key] - 1) % stride:
        return  # decimated-out observation (still counted above)
      vs = self._samples.setdefault(key, [])
      vs.append(float(seconds))
      if len(vs) >= self.MAX_SAMPLES:
        # Deterministic 2:1 decimation + stride doubling: memory stays
        # bounded on arbitrarily long runs, the retained subsample
        # keeps the distribution's shape for the percentile estimate.
        self._samples[key] = vs[::2]
        self._sample_strides[key] = stride * 2

  def percentiles(self) -> Dict[str, Dict[str, float]]:
    """{key: {p50, p90, p99, n}} over every sampled latency key; n is
    the TRUE observation count (the retained subsample may be a
    strided decimation on very long runs, see add_sample)."""
    with self._lock:
      samples = {k: list(v) for k, v in self._samples.items()}
      counts = dict(self._sample_counts)
    out = {}
    for key in sorted(samples):
      vs = samples[key]
      out[key] = {"p50": percentile(vs, 50), "p90": percentile(vs, 90),
                  "p99": percentile(vs, 99),
                  "n": counts.get(key, len(vs))}
    return out

  def percentile_fields(self) -> Dict[str, Optional[float]]:
    """Flat ``<key>_p<q>`` seconds fields for the benchmark stats dict
    (bench.py forwards the chunk_wall/feed_wait subset into its JSON
    line)."""
    out: Dict[str, Optional[float]] = {}
    for key, row in self.percentiles().items():
      for q in QUANTILES:
        out[f"{key}_p{q}"] = row[f"p{q}"]
    return out

  def latency_lines(self) -> List[str]:
    """Run-end percentile report, one WHOLE line per sampled key (the
    scrape-guard contract: never interleaves inside step lines)."""
    lines = []
    for key, row in self.percentiles().items():
      lines.append(
          "latency percentiles: %s p50=%.3fms p90=%.3fms p99=%.3fms "
          "(n=%d)" % (key, 1e3 * row["p50"], 1e3 * row["p90"],
                      1e3 * row["p99"], row["n"]))
    return lines

  # -- compile ledger ---------------------------------------------------------

  def note_compile(self, key: str, program: str, wall_s: float,
                   **meta) -> None:
    """Record one compile episode. ``key`` is the program-shape
    fingerprint (analysis/baseline.config_fingerprint_key); ``wall_s``
    the host time of the program's first call (kernel loads, cuDNN's
    plans, a CUDA-graph capture: benchmark.py's compile_s)."""
    entry = {"key": key, "program": program,
             "wall_s": round(float(wall_s), 6)}
    entry.update(meta)
    with self._lock:
      self._ledger.append(entry)
    self.add_span("compile", program, self._time() - float(wall_s),
                  float(wall_s), {"fingerprint": key, **meta})

  def compile_ledger(self) -> Dict[str, Any]:
    """This run's ledger summary: distinct program shapes + total
    compile seconds (the bench.py JSON fields)."""
    with self._lock:
      entries = list(self._ledger)
    return {
        "shapes": len({e["key"] for e in entries}),
        "total_compile_s": round(sum(e["wall_s"] for e in entries), 6),
        "entries": entries,
    }

  def ledger_lines(self) -> List[str]:
    """The run-end compile-ledger table, every row a whole
    self-identifying line (scrape-guard contract)."""
    ledger = self.compile_ledger()
    if not ledger["entries"]:
      return []
    lines = ["compile ledger: %d program shape(s), total compile %.2f s"
             % (ledger["shapes"], ledger["total_compile_s"])]
    lines.append("compile ledger: fingerprint        wall_s  program")
    for e in ledger["entries"]:
      extra = "".join(
          f"  {k}={e[k]}" for k in sorted(e)
          if k not in ("key", "program", "wall_s"))
      lines.append("compile ledger: %-16s %8.3f  %s%s" % (
          e["key"][:16], e["wall_s"], e["program"], extra))
    return lines

  def write_ledger(self, train_dir: str) -> Optional[str]:
    """Persist/merge the ledger to ``train_dir/compile_ledger.json``.

    Merged by fingerprint key across runs (compiles count up; best/last
    walls kept), so the file accumulates the per-shape history of
    first calls. Returns the path, or None when nothing compiled / the
    write failed."""
    ledger = self.compile_ledger()
    if not ledger["entries"]:
      return None
    path = os.path.join(train_dir, LEDGER_FILENAME)
    entries: Dict[str, Any] = {}
    try:
      with open(path, encoding="utf-8") as f:
        prior = json.load(f)
      if isinstance(prior, dict) and isinstance(prior.get("entries"),
                                                dict):
        entries = prior["entries"]
    except (OSError, ValueError):
      entries = {}
    for e in ledger["entries"]:
      row = entries.setdefault(e["key"], {
          "program": e["program"], "compiles": 0,
          "min_wall_s": e["wall_s"]})
      row["compiles"] = int(row.get("compiles", 0)) + 1
      row["last_wall_s"] = e["wall_s"]
      row["min_wall_s"] = min(float(row.get("min_wall_s", e["wall_s"])),
                              e["wall_s"])
      for k, v in e.items():
        if k not in ("key", "wall_s"):
          row.setdefault(k, v)
      if "cache_hit" in e:
        # Last value wins: the shape's FIRST run legitimately misses
        # and every later run should read as the hit it was.
        row["cache_hit"] = e["cache_hit"]
    payload = {"run_id": self.run_id, "entries": entries}
    try:
      os.makedirs(train_dir, exist_ok=True)
      tmp = path + ".tmp"
      with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
      os.replace(tmp, path)
    except OSError as e:
      self._log(f"compile ledger write failed (non-fatal): {e}")
      return None
    return path

  # -- export -----------------------------------------------------------------

  def _epoch_us(self, t_mono: float) -> float:
    return (self._anchor_wall + (t_mono - self._anchor_mono)) * 1e6

  def chrome_events(self) -> List[Dict[str, Any]]:
    """This rank's spans as Chrome trace events (metadata + X/i)."""
    with self._lock:
      spans = list(self.spans)
      tids = dict(self._tids)
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": self.rank, "tid": 0,
        "args": {"name": f"rank {self.rank}"},
    }]
    used = {s["tid"] for s in spans}
    for sub, tid in sorted(tids.items(), key=lambda kv: kv[1]):
      if tid in used:
        events.append({"ph": "M", "name": "thread_name",
                       "pid": self.rank, "tid": tid,
                       "args": {"name": sub}})
    for s in spans:
      e = {"ph": s["ph"], "name": s["name"], "cat": s["sub"],
           "pid": self.rank, "tid": s["tid"],
           "ts": round(self._epoch_us(s["t0"]), 3),
           "args": {"span_id": s["id"], **s["args"]}}
      if s["ph"] == "X":
        e["dur"] = round(s["dur"] * 1e6, 3)
      else:
        e["s"] = "t"  # instant scope: thread
      events.append(e)
    return events

  def _prior_events(self, path: str) -> List[Dict[str, Any]]:
    """THIS rank's events from an earlier generation's file at
    ``path``: a kfrun checkpoint-restart re-execs the same command with
    the same KF_RUN_ID, and the relaunched generation must EXTEND the
    job's timeline, not truncate it. Foreign run ids (a fresh job
    reusing the path) and unreadable files carry nothing over -- those
    overwrite. Filtered to this rank's pid (rank 0's canonical file may
    be a prior MERGE holding every rank; sibling ranks re-contribute
    their own history through their own rank files) and to non-metadata
    events (metadata regenerates)."""
    try:
      with open(path, encoding="utf-8") as f:
        data = json.load(f)
    except (OSError, ValueError):
      return []
    if not isinstance(data, dict) or \
        data.get("metadata", {}).get("run_id") != self.run_id:
      return []
    return [e for e in data.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") != "M"
            and e.get("pid") == self.rank]

  def export(self, merge_wait_s: float = 10.0) -> Optional[str]:
    """Write this rank's span file; rank 0 additionally merges every
    rank's file into one coherent timeline at ``path``.

    Rank files: rank 0 owns ``path`` itself, rank r writes
    ``rank_path(path, r)``. The rank-0 merge waits (bounded, host-side
    file polling -- no process is ever signaled) for sibling files
    because ranks reach run end at slightly different wall times; files
    still missing at the deadline are skipped with a logged note, and
    the per-rank files remain on disk either way. A same-run-id file
    already at the rank path (an earlier restart generation) is
    extended, not truncated."""
    if not self.path:
      return None
    my_path = rank_path(self.path, self.rank)
    my_events: List[Dict[str, Any]] = []
    try:
      os.makedirs(os.path.dirname(my_path) or ".", exist_ok=True)
      # Atomic tmp + os.replace (the write_ledger pattern): the rank-0
      # merge polls for sibling FILES, so a non-atomic write would be
      # seen (and dropped as unreadable) the instant open() creates it.
      tmp = my_path + ".tmp"
      if self.chrome_format:
        my_events = self._prior_events(my_path) + self.chrome_events()
        my_events.sort(key=_event_sort_key)
        with open(tmp, "w", encoding="utf-8") as f:
          json.dump(_payload(my_events, self.run_id,
                             dropped_spans=self._dropped), f)
      else:
        # --use_chrome_trace_format=false: the raw span records, one
        # JSON line each (the flight-recorder-style schema), for
        # consumers that want the unconverted timeline. Same-run-id
        # files extend (restart generations); others are overwritten.
        prior_lines: List[str] = []
        try:
          with open(my_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
          if lines and json.loads(lines[0]).get("run_id") == self.run_id:
            prior_lines = lines
        except (OSError, ValueError):
          pass
        with open(tmp, "w", encoding="utf-8") as f:
          if prior_lines:
            f.write("\n".join(prior_lines) + "\n")
          else:
            f.write(json.dumps({"run_id": self.run_id,
                                "rank": self.rank,
                                "anchor_wall": self._anchor_wall,
                                "anchor_mono": self._anchor_mono})
                    + "\n")
          with self._lock:
            for s in self.spans:
              f.write(json.dumps(s) + "\n")
      os.replace(tmp, my_path)
    except OSError as e:
      self._log(f"trace export failed (non-fatal): {e}")
      return None
    if self.rank != 0 or self.num_ranks <= 1 or not self.chrome_format:
      return my_path
    return self._merge_ranks(my_events, merge_wait_s) or my_path

  def _merge_ranks(self, my_events: List[Dict[str, Any]],
                   wait_s: float) -> Optional[str]:
    """Rank-0 exit merge: one timeline with pid=rank per process.
    ``my_events`` is rank 0's just-exported event list (including any
    prior-generation carry-over)."""
    expected = [rank_path(self.path, r) for r in range(1, self.num_ranks)]
    deadline = time.monotonic() + max(0.0, wait_s)
    while (any(not os.path.exists(p) for p in expected) and
           time.monotonic() < deadline):
      time.sleep(0.1)
    events = list(my_events)
    missing = []
    for p in expected:
      try:
        with open(p, encoding="utf-8") as f:
          data = json.load(f)
        if data.get("metadata", {}).get("run_id") != self.run_id:
          # A stale sibling from a previous job at the same path must
          # not fold foreign epoch-anchored events into THIS run's
          # timeline (same foreign-run-id rule as _prior_events).
          missing.append(p + " (foreign run id)")
          continue
        events.extend(e for e in data.get("traceEvents", [])
                      if isinstance(e, dict))
      except (OSError, ValueError):
        missing.append(p)
    if missing:
      self._log("trace merge: %d rank file(s) missing/unreadable/"
                "foreign at exit (%s); merged what arrived" % (
                    len(missing), ", ".join(missing)))
    events.sort(key=_event_sort_key)
    try:
      with open(self.path, "w", encoding="utf-8") as f:
        json.dump(_payload(events, self.run_id,
                           dropped_spans=self._dropped), f)
    except OSError as e:
      self._log(f"trace merge write failed (non-fatal): {e}")
      return None
    return self.path


# -- compile-ledger query API -------------------------------------------------
# Read side of the persisted ledger (write_ledger above): benchmark.py
# reads the prior keys for the cache_hit column. Pure stdlib.

def read_ledger(train_dir: str) -> Dict[str, Any]:
  """The persisted compile ledger at ``train_dir/compile_ledger.json``
  ({"entries": {}} when absent/unreadable/foreign-shaped -- a missing
  ledger must read as empty history, never raise)."""
  path = os.path.join(train_dir, LEDGER_FILENAME)
  try:
    with open(path, encoding="utf-8") as f:
      data = json.load(f)
  except (OSError, ValueError):
    return {"entries": {}}
  if not isinstance(data, dict) or not isinstance(data.get("entries"),
                                                  dict):
    return {"entries": {}}
  return data


def ledger_keys(ledger: Dict[str, Any]) -> set:
  """The program-shape fingerprint keys a ledger has seen."""
  return set((ledger or {}).get("entries") or {})


def ledger_programs(ledger: Dict[str, Any]) -> set:
  """The program labels (train_step / train_chunk / eval_step ...) a
  ledger predicts a job of this train_dir will compile."""
  out = set()
  for row in ((ledger or {}).get("entries") or {}).values():
    if isinstance(row, dict) and row.get("program"):
      out.add(str(row["program"]))
  return out


def merge_rank_files(path: str, num_ranks: int,
                     run_id: str = "") -> Optional[str]:
  """Standalone merge of already-written per-rank Chrome files (for
  post-hoc tooling/tests when rank 0's exit merge raced a slow rank)."""
  events: List[Dict[str, Any]] = []
  found = 0
  for r in range(num_ranks):
    p = rank_path(path, r)
    try:
      with open(p, encoding="utf-8") as f:
        data = json.load(f)
    except (OSError, ValueError):
      continue
    found += 1
    events.extend(e for e in data.get("traceEvents", [])
                  if isinstance(e, dict))
    run_id = run_id or data.get("metadata", {}).get("run_id", "")
  if not found:
    return None
  events.sort(key=_event_sort_key)
  with open(path, "w", encoding="utf-8") as f:
    json.dump(_payload(events, run_id, merged_ranks=found), f)
  return path


# -- active-session registry --------------------------------------------------
# Deep call sites (DeviceFeeder's worker thread, checkpoint saves, fault
# firing) emit through the active session instead of threading a handle
# through every signature; with no session active they hit the no-op
# sink below, which keeps the untraced hot path allocation-free.

class _NullTrace:
  """No-op sink with the RunTrace emission AND reporting surface (so
  code paths that never installed a session -- direct _train_loop test
  callers -- report empty rather than crash)."""

  rank = 0
  run_id = ""
  path = None

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

  def note_compile(self, *a, **k) -> None:
    pass

  def percentiles(self) -> Dict[str, Any]:
    return {}

  def percentile_fields(self) -> Dict[str, Any]:
    return {}

  def latency_lines(self) -> List[str]:
    return []

  def compile_ledger(self) -> Dict[str, Any]:
    return {"shapes": 0, "total_compile_s": 0.0, "entries": []}

  def ledger_lines(self) -> List[str]:
    return []

  def write_ledger(self, train_dir: str) -> None:
    return None

  def export(self, *a, **k) -> None:
    return None


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
