"""Runtime training-health telemetry: in-step device stats, flight
recorder, stall watchdog.

The port's copy of kf_benchmarks_tpu/telemetry.py (nothing imported from
the JAX package). Three cooperating pieces:

* In-step health stats: ``sumsq_partials`` / ``pack_partials`` /
  ``health_finalize`` build
  the compact f32 vector (global grad norm, update/param norm ratio,
  non-finite leaf count, loss scale, skip flag) that train_step.py
  computes on the device inside the step -- each rank reduces a 1/n
  slice of every leaf and the partial sums, pre-scaled by n, ride the
  step's existing metrics all-reduce, so the health-on step issues NO
  extra collective and no replicated full-tree pass. Inside a captured
  K-step graph the vector is one more row of the graph's metrics buffer
  and reaches the host only through the lag-N metrics pipeline, as the
  losses do. Gated by ``--health_stats`` (``resolve_health_stats``;
  default auto = on for replica-synchronous training with a
  ``--train_dir`` sink).
* Flight recorder: a bounded ring of per-step JSON records continuously
  rewritten to ``train_dir/flight_recorder.jsonl`` (the file always
  holds the newest window), with the full window and a diagnosis line
  appended to ``flight_recorder.dump.jsonl`` on an anomaly (non-finite
  grads or loss, a grad-norm spike beyond ``--health_grad_norm_sigma``,
  a loss-scale halving streak), on SIGTERM/SIGINT, and at run end.
* Stall watchdog: a daemon thread fed heartbeats when the metrics
  pipeline resolves completed work (never from ``torch.cuda.
  synchronize``). Before the first completed dispatch it is patient
  (kernel builds and graph captures run long; log-only). Mid-run, silence
  beyond ``factor`` x the trailing mean dispatch wall emits one diagnostic
  per stall episode, and it never kills, signals or interrupts the
  process.
"""

from __future__ import annotations

import collections
import json
import math
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from kf_benchmarks_tpu_torch import metrics as metrics_lib
from kf_benchmarks_tpu_torch.utils import log as log_util


# Order of the in-step health vector (metrics.py holds the one copy).
HEALTH_KEYS = metrics_lib.HEALTH_KEYS


# -- in-step stats (device side) -----------------------------------------------

def _flat(leaf: torch.Tensor) -> torch.Tensor:
  """The leaf's elements as a flat view in memory order (a channels_last
  weight's too, without a copy): a square sum does not depend on the
  order of its terms' partition, only on which rank owns each."""
  if leaf.is_contiguous():
    return leaf.view(-1)
  if leaf.dim() == 4 and leaf.is_contiguous(
      memory_format=torch.channels_last):
    return leaf.permute(0, 2, 3, 1).reshape(-1)
  return leaf.reshape(-1)


def sumsq_partials(leaves: Sequence[torch.Tensor], index: int,
                   num: int) -> torch.Tensor:
  """This rank's partial square sum of each leaf, as one (L,) f32 tensor:
  row ``index`` of the flat leaf reshaped (num, size // num), plus the
  < num-element tail on rank 0 (the JAX package's ``_sharded_sumsq``).
  Each rank touches ~1/num of every leaf, so the stats cost one tree read
  in all across the ranks. A leaf holding a NaN or an inf, or one whose
  f32 square sum overflows, reads non-finite (``square_sums``)."""
  if not leaves:
    return torch.zeros(1, dtype=torch.float32)
  rows, tails = [], []
  for leaf in leaves:
    flat = _flat(leaf)
    k = flat.numel() // num
    rows.append(flat[index * k:(index + 1) * k])
    tails.append(flat[num * k:] if index == 0 else flat[:0])
  # f32 accumulation (f64 for f64 leaves, which f32 may not narrow).
  dt = (torch.float64 if any(t.dtype == torch.float64 for t in leaves)
        else torch.float32)
  parts = square_sums(rows, dt)
  if index == 0 and any(t.numel() for t in tails):
    parts = parts + square_sums(tails, dt)
  return parts.float()


def square_sums(tensors: Sequence[torch.Tensor],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """The square sum of each tensor in ``dtype`` (f32, or f64), as one
  (L,) tensor. On the card: squared norms of ``torch._foreach_norm``, a
  few fused launches that read each tensor once and upcast in registers
  (no f32 copy of a bf16 tensor). On the CPU, whose norm kernel sums
  sequentially (1e-4 relative off at 2.4 M elements), the sums of the
  squares of upcast copies, which it sums pairwise."""
  if tensors and tensors[0].device.type == "cuda":
    norms = torch.stack(torch._foreach_norm(list(tensors), 2, dtype=dtype))
    return norms * norms
  return torch.stack([torch.sum(torch.square(t.to(dtype)))
                      for t in tensors])


def pack_partials(grad_sq: torch.Tensor, update_sq: torch.Tensor,
                  param_sq: torch.Tensor, num: int) -> torch.Tensor:
  """This rank's partial sums for the health stats, as one f32 vector
  ``[grad_sq (L,), update_sq, param_sq] * num``: pre-scaled by the rank
  count, so the caller's one metrics all-reduce (a MEAN) yields global
  SUMS (the layout of the JAX package's ``health_partials``).

  ``grad_sq`` is ``sumsq_partials`` of the APPLIED (reduced, unscaled)
  gradients, kept per leaf so the non-finite LEAF count survives the
  reduction; ``param_sq`` the summed ``sumsq_partials`` of the weights
  before the update; ``update_sq`` this rank's partial square sum of the
  optimizer's update (optimizers.py accumulates it during the apply: the
  port's optimizers update in place and never form the update tree)."""
  vec = torch.cat([grad_sq.float(), update_sq.float().reshape(1),
                   param_sq.float().reshape(1)])
  return vec * float(num)


def health_finalize(totals: torch.Tensor, loss_scale, skipped,
                    update_suppressed) -> torch.Tensor:
  """The HEALTH_KEYS vector from the reduced ``pack_partials``.

  A leaf counts as non-finite when its global square sum is;
  ``update_ratio`` is |update| / |params| (0 on a step whose apply the
  auto loss scale skipped: its would-be update is not the weights')."""
  totals = totals.float()
  grad_sq = totals[:-2]
  upd_sq, param_sq = totals[-2], totals[-1]
  grad_norm = torch.sqrt(grad_sq.sum())
  nonfinite = (1.0 - torch.isfinite(grad_sq).float()).sum()
  suppressed = torch.as_tensor(update_suppressed, dtype=torch.float32,
                               device=totals.device)
  ratio = torch.where(
      suppressed > 0, torch.zeros_like(upd_sq),
      torch.sqrt(upd_sq) / torch.clamp(torch.sqrt(param_sq), min=1e-12))
  return torch.stack([
      grad_norm, ratio, nonfinite,
      torch.as_tensor(loss_scale, dtype=torch.float32,
                      device=totals.device).reshape(()),
      torch.as_tensor(skipped, dtype=torch.float32,
                      device=totals.device).reshape(())])


def health_scalars(metrics) -> Dict[str, float]:
  """A metrics dict's health vector as named ``health/<key>`` scalars:
  the schema of the flight recorder's rows."""
  vec = metrics.get("health") if isinstance(metrics, dict) else None
  if vec is None:
    return {}
  arr = np.asarray(vec, np.float32).ravel()
  if arr.size != len(HEALTH_KEYS):
    return {}
  return {metrics_lib.health_key(k): float(v)
          for k, v in zip(HEALTH_KEYS, arr)}


# variable_update modes whose gradient reduction leaves every rank holding
# the SAME applied gradients: the precondition for the in-step stats being
# global values rather than rank-local ones.
_SYNC_REPLICATED_UPDATES = (
    "replicated", "distributed_replicated", "parameter_server",
    "collective_all_reduce", "distributed_all_reduce", "horovod")


def resolve_health_stats(params, strategy=None):
  """Resolve ``--health_stats`` (None = auto) -> (enabled, note).

  Auto turns the stats ON for training runs that (a) reduce gradients
  replica-synchronously (``strategy.cross_replica``; replicated family /
  kungfu sync_sgd) and (b) have a telemetry sink (``--train_dir`` for the
  flight-recorder files, ``--benchmark_log_dir`` for the health metric
  row). Gossip/async modes auto-off with a one-line
  note (their per-rank gradients diverge, so a "global" norm would be
  rank-local); sink-less runs auto-off quietly. Explicit ``--health_stats``
  always engages (the window stays in memory and anomalies still dump to
  the log); explicit True with an incompatible mode is refused up front
  in validation.validate_cross_flags."""
  v = getattr(params, "health_stats", None)
  if v is False:
    return False, None
  if getattr(params, "eval", False) or getattr(params, "forward_only",
                                               False):
    return False, None
  if (getattr(params, "shard_optimizer_state", False) or
      (strategy is not None and getattr(strategy, "sharded_state",
                                        False))):
    # The sharded apply runs on 1/n flat shards (ops/sharded.py): the
    # full update the stats read never exists on one rank.
    if getattr(params, "train_dir", None) or getattr(
        params, "benchmark_log_dir", None):
      return False, (
          "health_stats: --shard_optimizer_state applies the optimizer "
          "on per-device state shards; the full-tree in-step stats are "
          "disabled (elastic/fault-injected runs with a train_dir keep "
          "their flight-recorder/watchdog session regardless)")
    return False, None
  if strategy is not None:
    cross = bool(getattr(strategy, "cross_replica", False))
  else:
    cross = (
        (params.variable_update in _SYNC_REPLICATED_UPDATES and
         bool(getattr(params, "cross_replica_sync", True))) or
        (params.variable_update == "kungfu" and
         getattr(params, "kungfu_option", None) == "sync_sgd"))
  if not cross:
    return False, (
        "health_stats: --variable_update=%s keeps per-replica gradient "
        "trees (no replica-synchronous reduction); in-step health stats "
        "disabled -- pass --health_stats with a replicated-family mode "
        "to enable them" % params.variable_update)
  if v is None and not (getattr(params, "train_dir", None) or
                        getattr(params, "benchmark_log_dir", None)):
    return False, None
  return True, None


def flight_recorder_path(train_dir: Optional[str], rank: int = 0
                         ) -> Optional[str]:
  """Per-rank window path: rank 0 owns ``flight_recorder.jsonl``; other
  ranks write rank-suffixed files that rank 0 merges at exit
  (``aggregate_rank_windows``)."""
  if not train_dir:
    return None
  name = ("flight_recorder.jsonl" if rank == 0
          else f"flight_recorder.rank{rank}.jsonl")
  return os.path.join(train_dir, name)


def aggregate_rank_windows(train_dir: str) -> List[dict]:
  """Every rank's window under ``train_dir`` merged into one step-ordered
  record list (rank breaks ties), for rank 0's exit aggregation."""
  records = []
  try:
    names = sorted(os.listdir(train_dir))
  except OSError:
    return records
  for name in names:
    if not (name.startswith("flight_recorder") and
            name.endswith(".jsonl") and ".dump." not in name and
            name != "flight_recorder.all.jsonl"):
      continue
    try:
      with open(os.path.join(train_dir, name)) as f:
        for line in f:
          line = line.strip()
          if line:
            records.append(json.loads(line))
    except (OSError, ValueError):
      continue
  records.sort(key=lambda r: (r.get("step", 0), r.get("rank", 0)))
  return records


# -- flight recorder (host side) -----------------------------------------------

class FlightRecorder:
  """Bounded ring of per-step records with anomaly-triggered dumps.

  ``record()`` is called once per completed step with that step's
  metrics; the newest ``window`` records are continuously rewritten to
  ``path`` (atomic replace, so a reader never sees a torn window), and
  anomalies append the window and a diagnosis record to
  ``<dir>/flight_recorder.dump.jsonl`` (append mode: a clean-exit dump
  never clobbers the mid-run post-mortem that mattered).
  """

  # Consecutive loss-scale halvings (or skipped updates, once the scale
  # sits at its floor of 1) that count as a collapse streak.
  HALVING_STREAK = 3

  def __init__(self, path: Optional[str] = None, window: int = 64,
               sigma: float = 6.0, rank: int = 0, log_fn=None,
               min_history: int = 8, run_id: Optional[str] = None):
    self.path = path
    # Shared with every rank and restart generation of the job
    # (tracing.resolve_run_id).
    self.run_id = run_id
    self.dump_path = (os.path.join(os.path.dirname(path),
                                   "flight_recorder.dump.jsonl")
                      if path else None)
    if path:
      # The window must reach the disk from step 1 (it exists to survive
      # a mid-run death), before the first checkpoint makes train_dir.
      try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
      except OSError:
        pass  # unwritable sink: record() keeps the in-memory window
    self.window = max(1, int(window))
    self.sigma = float(sigma)
    self.rank = int(rank)
    self._log = log_fn or log_util.log_fn
    self._min_history = max(2, int(min_history))
    self._records: "collections.deque[dict]" = collections.deque(
        maxlen=self.window)
    self._prev_scale: Optional[float] = None
    self._halvings = 0
    self._skip_streak = 0
    self._in_anomaly = False
    self._old_handlers: Dict[int, Any] = {}
    # Summary counters (bench_torch.py's health record).
    self._max_grad_norm: Optional[float] = None
    self._nonfinite_steps = 0
    self._anomaly_dumps = 0
    self._last_scale: Optional[float] = None

  # -- recording ----------------------------------------------------------------

  def _stamp(self, rec: Dict[str, Any]) -> Dict[str, Any]:
    """Wall and monotonic timestamps (and the run id) on every row."""
    rec["t_wall"] = round(time.time(), 3)
    rec["t_mono"] = round(time.monotonic(), 6)
    if self.run_id:
      rec["run_id"] = self.run_id
    return rec

  def record(self, step: int, loss: Optional[float] = None, lr=None,
             health=None, wall_ms: Optional[float] = None,
             chunk_len: int = 1, rtt_ms: Optional[float] = None) -> dict:
    """Append one per-step record; judge it against the TRAILING window
    (not against itself); rewrite the window file."""
    rec: Dict[str, Any] = self._stamp({"step": int(step),
                                       "rank": self.rank})
    if loss is not None:
      rec["loss"] = float(loss)
    if lr is not None:
      rec["lr"] = float(lr)
    if wall_ms is not None:
      rec["wall_ms"] = round(float(wall_ms), 3)
    if chunk_len != 1:
      rec["chunk_len"] = int(chunk_len)
    if rtt_ms is not None:
      rec["rtt_ms"] = round(float(rtt_ms), 3)
    rec.update(health_scalars({"health": health}))

    reasons = self._detect_anomalies(rec)
    self._records.append(rec)
    self._update_summary(rec)
    self._write_window()
    if reasons:
      if not self._in_anomaly:
        # Edge-triggered: one dump per anomaly episode.
        self._anomaly_dumps += 1
        self.dump("; ".join(reasons))
      self._in_anomaly = True
    else:
      self._in_anomaly = False
    return rec

  def _detect_anomalies(self, rec: dict) -> List[str]:
    reasons = []
    step = rec["step"]
    loss = rec.get("loss")
    nonfinite = rec.get("health/nonfinite_leaves", 0.0)
    gn = rec.get("health/grad_norm")
    if (nonfinite and nonfinite > 0) or (
        loss is not None and not math.isfinite(loss)) or (
        gn is not None and not math.isfinite(gn)):
      reasons.append(
          f"non-finite training signal at step {step} "
          f"(nonfinite_leaves={nonfinite:.0f}, loss={loss})")
    if gn is not None and math.isfinite(gn):
      trail = [r["health/grad_norm"] for r in self._records
               if math.isfinite(r.get("health/grad_norm", float("nan")))]
      if len(trail) >= self._min_history:
        mean = sum(trail) / len(trail)
        std = math.sqrt(sum((t - mean) ** 2 for t in trail) / len(trail))
        if std > 0 and gn > mean + self.sigma * std:
          reasons.append(
              f"grad-norm spike at step {step}: {gn:.3e} > trailing "
              f"mean {mean:.3e} + {self.sigma:g} sigma ({std:.3e})")
    scale = rec.get("health/loss_scale")
    skipped = rec.get("health/skipped", 0.0)
    if scale is not None:
      if self._prev_scale is not None and scale < self._prev_scale:
        self._halvings += 1
      elif self._prev_scale is not None and scale >= self._prev_scale:
        self._halvings = 0
      self._prev_scale = scale
      # The scale floors at 1 (train_step.py), so sustained overflow stops
      # halving but keeps skipping: both signals count.
      self._skip_streak = self._skip_streak + 1 if skipped else 0
      if max(self._halvings, self._skip_streak) == self.HALVING_STREAK:
        kind = ("halvings" if self._halvings >= self.HALVING_STREAK
                else "skipped updates")
        reasons.append(
            f"loss-scale collapse at step {step}: "
            f"{self.HALVING_STREAK} consecutive {kind} (scale now "
            f"{scale:g})")
    return reasons

  def _update_summary(self, rec: dict) -> None:
    gn = rec.get("health/grad_norm")
    if gn is not None and math.isfinite(gn):
      self._max_grad_norm = (gn if self._max_grad_norm is None
                             else max(self._max_grad_norm, gn))
    loss = rec.get("loss")
    if (rec.get("health/nonfinite_leaves", 0.0) > 0 or
        (loss is not None and not math.isfinite(loss))):
      self._nonfinite_steps += 1
    if rec.get("health/loss_scale") is not None:
      self._last_scale = rec["health/loss_scale"]

  def _write_window(self) -> None:
    if not self.path:
      return
    tmp = self.path + ".tmp"
    try:
      with open(tmp, "w") as f:
        for r in self._records:
          f.write(json.dumps(r) + "\n")
      os.replace(tmp, self.path)
    except OSError:
      pass  # a failed telemetry write must never take down the run

  def tail(self, n: int = 3) -> List[dict]:
    return list(self._records)[-n:]

  def note_event(self, event: Dict[str, Any]) -> dict:
    """A non-step event record (elastic resize, injected fault) in the
    ring and the window file; events bypass anomaly detection."""
    rec = self._stamp({"rank": self.rank})
    rec.update(event)
    self._records.append(rec)
    self._write_window()
    return rec

  # -- dumps --------------------------------------------------------------------

  def dump(self, reason: str) -> None:
    """Append the window and a diagnosis record to the dump file and log
    one whole diagnosis line (never inside a step line)."""
    diagnosis = {
        "flight_recorder_dump": reason,
        "rank": self.rank,
        "records": len(self._records),
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    where = "window retained in memory (no --train_dir)"
    if self.dump_path:
      try:
        with open(self.dump_path, "a") as f:
          f.write(json.dumps(diagnosis) + "\n")
          for r in self._records:
            f.write(json.dumps(r) + "\n")
        where = (f"{len(self._records)}-record window dumped to "
                 f"{self.dump_path}")
      except OSError as e:
        where = f"dump write failed ({e})"
    self._log(f"flight recorder: {reason} -- {where}")

  # -- signal handlers ----------------------------------------------------------

  def install_signal_handlers(self) -> None:
    """Dump the window on SIGTERM/SIGINT, then chain to the previous
    handler, so ctrl-C still interrupts and a SIGTERM still terminates
    with its own status: the recorder adds a post-mortem, it never
    swallows the signal."""
    for signum in (signal.SIGTERM, signal.SIGINT):
      try:
        self._old_handlers[signum] = signal.signal(
            signum, self._handle_signal)
      except ValueError:
        pass  # not the main thread: the recorder works without handlers

  def _handle_signal(self, signum, frame) -> None:
    self.dump(f"signal {signal.Signals(signum).name}")
    old = self._old_handlers.get(signum)
    signal.signal(signum, old if old is not None else signal.SIG_DFL)
    signal.raise_signal(signum)

  def close(self) -> None:
    """Restore the installed signal handlers."""
    for signum, old in self._old_handlers.items():
      try:
        if signal.getsignal(signum) == self._handle_signal:
          signal.signal(signum, old)
      except ValueError:
        pass
    self._old_handlers.clear()

  def summary(self) -> Dict[str, Any]:
    return {
        "records": len(self._records),
        "max_grad_norm": self._max_grad_norm,
        "nonfinite_steps": self._nonfinite_steps,
        "loss_scale_final": self._last_scale,
        "anomaly_dumps": self._anomaly_dumps,
    }


# -- stall watchdog -------------------------------------------------------------

class StallWatchdog:
  """Daemon thread that watches the heartbeats of completed dispatches.

  Two regimes, split on whether any dispatch has completed:

  * Before the first (kernel builds, graph captures): patient. It logs a
    reassurance line every ``patience_s`` and does nothing else.
  * Mid-run: silence longer than ``factor`` x the trailing mean dispatch
    wall (floored at ``min_stall_s``) emits ONE diagnostic per stall
    episode -- the last flight-recorder rows -- and counts it. It never
    kills, signals or interrupts the process.

  Heartbeats come from the metrics pipeline resolving real completed
  work (benchmark.py), never from a device synchronize.
  """

  TRAILING_WINDOW = 16

  def __init__(self, factor: float = 10.0, poll_s: float = 1.0,
               patience_s: float = 600.0, min_stall_s: float = 5.0,
               log_fn=None, recorder: Optional[FlightRecorder] = None,
               time_fn=time.monotonic):
    self.factor = float(factor)
    self.poll_s = float(poll_s)
    self.patience_s = float(patience_s)
    self.min_stall_s = float(min_stall_s)
    self._log = log_fn or log_util.log_fn
    self._recorder = recorder
    self._time = time_fn
    self._lock = threading.Lock()
    self._walls: "collections.deque[float]" = collections.deque(
        maxlen=self.TRAILING_WINDOW)
    self._last_beat = self._time()
    self._beats = 0
    self._stalls = 0
    self._stalled = False
    self._last_patient_log: Optional[float] = None
    self._stop_event = threading.Event()
    self._thread: Optional[threading.Thread] = None

  @property
  def enabled(self) -> bool:
    return self.factor > 0

  @property
  def stalls(self) -> int:
    return self._stalls

  def start(self) -> None:
    if not self.enabled or self._thread is not None:
      return
    with self._lock:
      self._last_beat = self._time()
    self._thread = threading.Thread(
        target=self._run, name="kf-stall-watchdog", daemon=True)
    self._thread.start()

  def beat(self, wall_s: Optional[float] = None) -> None:
    """Mark a completed dispatch; ``wall_s`` (its wall interval) feeds the
    trailing-mean stall threshold."""
    with self._lock:
      self._last_beat = self._time()
      self._beats += 1
      self._stalled = False
      if wall_s is not None and wall_s > 0:
        self._walls.append(float(wall_s))

  def stop(self) -> None:
    self._stop_event.set()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
      self._thread = None

  def _run(self) -> None:
    while not self._stop_event.wait(self.poll_s):
      try:
        self._check(self._time())
      except Exception as e:
        # A failed evaluation must neither take down the run nor retire
        # the thread.
        try:
          self._log(f"stall watchdog: check failed ({e!r}); continuing")
        except Exception:
          pass

  def _check(self, now: float) -> None:
    """One evaluation at host time ``now`` (apart from the thread loop, so
    tests can drive it with a fake clock)."""
    with self._lock:
      idle = now - self._last_beat
      beats = self._beats
      walls = list(self._walls)
      stalled = self._stalled
    if beats == 0:
      if idle > self.patience_s and (
          self._last_patient_log is None or
          now - self._last_patient_log > self.patience_s):
        self._last_patient_log = now
        self._log(
            "stall watchdog: no dispatch completed yet after "
            f"{idle / 60.0:.1f} min -- kernel builds and graph captures "
            "run long before the first; staying patient")
      return
    trailing = sum(walls) / len(walls) if walls else None
    threshold = max(self.factor * trailing if trailing else 0.0,
                    self.min_stall_s)
    if idle > threshold and not stalled:
      with self._lock:
        self._stalls += 1
        self._stalled = True
      self._emit_diagnostic(idle, trailing)
    elif idle <= threshold and stalled:
      with self._lock:
        self._stalled = False

  def _emit_diagnostic(self, idle: float, trailing: Optional[float]
                       ) -> None:
    trail_txt = (f"{idle / trailing:.1f}x the {trailing:.2f}s trailing "
                 "mean dispatch wall" if trailing
                 else "no trailing mean yet")
    self._log(
        f"stall watchdog: no dispatch completed for {idle:.1f}s "
        f"({trail_txt}); diagnosing only -- NOT killing the process")
    if self._recorder is not None:
      for rec in self._recorder.tail(3):
        self._log("stall watchdog: last record: " + json.dumps(rec))


# -- session (benchmark.py's one wiring point) -----------------------------------

class TelemetrySession:
  """Flight recorder and stall watchdog bundled for one training run."""

  @classmethod
  def create(cls, params, rank: int = 0, log_fn=None, num_ranks: int = 1,
             run_id: Optional[str] = None) -> Optional["TelemetrySession"]:
    """None unless the run's resolved --health_stats is on, or the run is
    elastic or fault-injected with a train_dir sink: a preemption must
    leave a post-mortem window and its event rows even when the in-step
    stats are off (--shard_optimizer_state turns them off). The recorder
    and watchdog are host-side only and change no device work."""
    wants = bool(getattr(params, "health_stats", None)) or (
        bool(getattr(params, "train_dir", None)) and
        (bool(getattr(params, "elastic", False)) or
         bool(getattr(params, "fault_schedule", None))))
    if not wants:
      return None
    return cls(params, rank=rank, log_fn=log_fn, num_ranks=num_ranks,
               run_id=run_id)

  def __init__(self, params, rank: int = 0, log_fn=None,
               num_ranks: int = 1, run_id: Optional[str] = None):
    self.train_dir = getattr(params, "train_dir", None)
    self.rank = int(rank)
    self.num_ranks = max(1, int(num_ranks))
    self.recorder = FlightRecorder(
        path=flight_recorder_path(self.train_dir, self.rank),
        window=int(getattr(params, "flight_recorder_window", None) or 64),
        sigma=float(getattr(params, "health_grad_norm_sigma", None)
                    or 6.0),
        rank=self.rank, log_fn=log_fn, run_id=run_id)
    self.recorder.install_signal_handlers()
    self.watchdog = StallWatchdog(
        factor=float(getattr(params, "stall_watchdog_factor", None)
                     or 0.0),
        log_fn=log_fn, recorder=self.recorder)
    self.watchdog.start()
    self._closed = False

  def beat(self, wall_s: Optional[float] = None) -> None:
    self.watchdog.beat(wall_s)

  def record(self, **kwargs) -> None:
    self.recorder.record(**kwargs)

  def elastic_event(self, generation: int, old_world: int, new_world: int,
                    step: int) -> None:
    """One recorder row per resize: the window shows the generation, the
    old and new world and the step instead of an unexplained seam."""
    self.recorder.note_event({
        "elastic_event": f"{old_world}->{new_world}",
        "generation": int(generation),
        "step": int(step),
    })

  def fault_event(self, description: str, step: int) -> None:
    self.recorder.note_event({"fault_event": description,
                              "step": int(step)})

  def summary(self) -> Dict[str, Any]:
    s = self.recorder.summary()
    s["watchdog_stalls"] = self.watchdog.stalls
    return s

  def healthz(self) -> Dict[str, Any]:
    """This session's half of the /healthz payload (metrics.py serves
    it): "stalled" while the watchdog is inside a stall episode, the
    health summary, and the last recorded step."""
    payload = {"status": "stalled" if self.watchdog._stalled else "ok"}
    payload.update(self.summary())
    last = self.recorder.tail(1)
    if last:
      payload["last_step"] = last[0].get("step")
    return payload

  def close(self, reason: str = "run end") -> None:
    if self._closed:
      return
    self._closed = True
    self.watchdog.stop()
    self.recorder.dump(reason)
    if self.rank == 0 and self.num_ranks > 1 and self.train_dir:
      # Rank 0 merges every rank's window (a shared train_dir) into one
      # step-ordered file beside the per-rank ones.
      merged = aggregate_rank_windows(self.train_dir)
      if merged:
        try:
          path = os.path.join(self.train_dir, "flight_recorder.all.jsonl")
          with open(path, "w") as f:
            for r in merged:
              f.write(json.dumps(r) + "\n")
        except OSError:
          pass
    self.recorder.close()
