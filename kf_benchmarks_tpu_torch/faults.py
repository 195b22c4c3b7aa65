"""Deterministic fault injection for preemption-safe training.

The port's own copy of kf_benchmarks_tpu/faults.py (stdlib only, nothing
imported from the JAX package). Every failure mode the elastic path must
survive -- a preempted (SIGKILL'd) worker, a graceful SIGTERM preemption
notice, a stalled heartbeat, a dropped coordination message, a checkpoint
torn mid-write -- is a named, step-keyed, reproducible event, so
kill/rejoin survival is a test, not an anecdote.

Schedule grammar (``--fault_schedule``)::

    spec    := entry (',' entry)*
    entry   := kind '@' step (':' key '=' value)*
    kind    := kill | sigterm | heartbeat_delay | drop_msg | corrupt_ckpt
    keys    := rank=<int>   -- fire on this process rank only
               secs=<float> -- heartbeat_delay sleep length (default 3)

Examples::

    --fault_schedule=kill@10:rank=1          SIGKILL rank 1 after step 10
    --fault_schedule=sigterm@6               graceful preemption at step 6
    --fault_schedule=corrupt_ckpt@6,kill@7   torn newest checkpoint, then a
                                             kill: the rejoin resumes from
                                             the checkpoint before it

Semantics (enforced by the injector):

* Faults fire at the dispatch boundary after the named step completes
  (benchmark.py shortens K-step dispatches so none crosses a fault step,
  as it does for checkpoints, eval and elastic polls).
* Each entry fires ONCE per run, across checkpoint-restart generations
  too: fired entries are recorded in ``<train_dir>/faults_fired.rank<r>
  .json`` before the fault fires, so a kill at step 10 does not re-kill
  the rejoined worker when it replays past step 10.
* ``kill``/``sigterm`` deliver the real signal to this process
  (``os.kill``): SIGKILL is the preemption the process never sees;
  SIGTERM runs the flight recorder's chained handler (telemetry.py).
* ``heartbeat_delay`` sleeps on the host between dispatches, starving the
  stall watchdog's heartbeat: the watchdog must diagnose and never kill.
* ``drop_msg`` suppresses the NEXT coordination-service poll (sticky
  across boundaries when the fault step is not itself a poll step): a
  pending RESIZE must re-surface at the following poll.
* ``corrupt_ckpt`` truncates the newest checkpoint file (a torn write):
  the restore (``checkpoint.load_latest_checkpoint``) skips it with a
  logged warning and resumes from the previous one.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import List, NamedTuple, Optional


FAULT_KINDS = ("kill", "sigterm", "heartbeat_delay", "drop_msg",
               "corrupt_ckpt")


class FaultScheduleError(ValueError):
  """Malformed --fault_schedule (validation.py wraps it in ParamError)."""


class Fault(NamedTuple):
  index: int            # position in the schedule (the one-shot key)
  kind: str
  step: int
  rank: Optional[int]   # None = every rank
  secs: float           # heartbeat_delay length

  def describe(self) -> str:
    where = f" (rank {self.rank})" if self.rank is not None else ""
    extra = f" {self.secs:g}s" if self.kind == "heartbeat_delay" else ""
    return f"{self.kind}{extra} at step {self.step}{where}"


def parse_schedule(spec: str) -> List[Fault]:
  """``--fault_schedule`` string -> [Fault, ...]; FaultScheduleError on
  any malformed entry (validation refuses the run up front)."""
  faults = []
  for i, raw in enumerate(t for t in (spec or "").split(",") if t.strip()):
    entry = raw.strip()
    kind, at, rest = entry.partition("@")
    if not at or kind not in FAULT_KINDS:
      raise FaultScheduleError(
          f"--fault_schedule entry {entry!r}: expected "
          f"<kind>@<step>[:key=value...] with kind in {FAULT_KINDS}")
    parts = rest.split(":")
    try:
      step = int(parts[0])
    except ValueError:
      raise FaultScheduleError(
          f"--fault_schedule entry {entry!r}: step {parts[0]!r} is not "
          "an integer")
    if step < 1:
      raise FaultScheduleError(
          f"--fault_schedule entry {entry!r}: steps are 1-based (the "
          "fault fires after the named step completes)")
    rank, secs = None, 3.0
    for kv in parts[1:]:
      key, eq, value = kv.partition("=")
      try:
        if key == "rank" and eq:
          rank = int(value)
        elif key == "secs" and eq:
          secs = float(value)
        else:
          raise ValueError
      except ValueError:
        raise FaultScheduleError(
            f"--fault_schedule entry {entry!r}: unknown or malformed "
            f"modifier {kv!r} (known: rank=<int>, secs=<float>)")
    faults.append(Fault(index=i, kind=kind, step=step, rank=rank,
                        secs=secs))
  return faults


def _fired_path(state_dir: str, rank: int) -> str:
  return os.path.join(state_dir, f"faults_fired.rank{rank}.json")


class FiredFaults(NamedTuple):
  """What one dispatch boundary's injection did (benchmark.py applies the
  flag the injector cannot apply itself)."""
  fired: List[Fault]
  dropped_message: bool   # suppress the next coordination poll


class FaultInjector:
  """One process's schedule: the rank filter, the one-shot markers, and
  the firing of every kind that does not need the training loop's
  cooperation (drop_msg is returned as a flag instead: the injector
  cannot reach into the elastic poll)."""

  def __init__(self, faults: List[Fault], rank: int = 0,
               state_dir: Optional[str] = None, log_fn=None):
    self.rank = int(rank)
    self.state_dir = state_dir
    self._log = log_fn or (lambda s: None)
    self._faults = [f for f in faults
                    if f.rank is None or f.rank == self.rank]
    self._fired = self._load_fired()

  @classmethod
  def from_params(cls, params, rank: int = 0, log_fn=None
                  ) -> Optional["FaultInjector"]:
    spec = getattr(params, "fault_schedule", None)
    if not spec:
      return None
    return cls(parse_schedule(spec), rank=rank,
               state_dir=getattr(params, "train_dir", None), log_fn=log_fn)

  # -- one-shot persistence ---------------------------------------------------

  def _load_fired(self) -> set:
    if not self.state_dir:
      return set()
    try:
      with open(_fired_path(self.state_dir, self.rank)) as f:
        return set(json.load(f))
    except (OSError, ValueError):
      return set()

  def _mark_fired(self, fault: Fault) -> None:
    """Persisted BEFORE the fault fires: a kill must not re-fire when the
    rejoined worker replays past its step."""
    self._fired.add(fault.index)
    if not self.state_dir:
      return
    try:
      os.makedirs(self.state_dir, exist_ok=True)
      path = _fired_path(self.state_dir, self.rank)
      with open(path + ".tmp", "w") as f:
        json.dump(sorted(self._fired), f)
      os.replace(path + ".tmp", path)
    except OSError:
      pass  # unwritable sink: the in-memory one-shot still holds

  # -- scheduling -------------------------------------------------------------

  def peek_due(self, step: int) -> List[Fault]:
    """The faults that WILL fire at this boundary, without firing them
    (the flight-recorder row must land before a kill does)."""
    return [f for f in self._faults
            if f.step == step and f.index not in self._fired]

  def due(self, step: int) -> bool:
    return bool(self.peek_due(step))

  # -- firing -----------------------------------------------------------------

  def fire_due(self, step: int, train_dir: Optional[str] = None
               ) -> FiredFaults:
    """Fire every due fault at this boundary. ``kill`` does not return
    and ``sigterm`` ends the process through its handlers (the signal is
    the point); the others report what the caller must still apply."""
    from kf_benchmarks_tpu_torch import tracing
    trace = tracing.active()
    fired: List[Fault] = []
    dropped = False
    for fault in self._faults:
      if fault.step != step or fault.index in self._fired:
        continue
      self._mark_fired(fault)
      fired.append(fault)
      # An instant on the faults track before firing: the survivable
      # kinds land in this rank's timeline; the durable record of a kill
      # is the flight-recorder row benchmark.py writes before this call.
      trace.instant("faults", fault.describe(), step=step, kind=fault.kind)
      self._log(f"fault injected: {fault.describe()}")
      if fault.kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)  # never returns
      elif fault.kind == "sigterm":
        # Through the real delivery path, so the chained telemetry
        # handlers run exactly as on an operator's preemption notice.
        os.kill(os.getpid(), signal.SIGTERM)
      elif fault.kind == "heartbeat_delay":
        time.sleep(fault.secs)
      elif fault.kind == "drop_msg":
        dropped = True
      elif fault.kind == "corrupt_ckpt":
        self._corrupt_newest_checkpoint(train_dir or self.state_dir)
    return FiredFaults(fired=fired, dropped_message=dropped)

  def _corrupt_newest_checkpoint(self, train_dir: Optional[str]) -> None:
    """Truncate the newest checkpoint to half its size: the torn-write
    state a preemption mid-save would leave without the atomic
    tmp+replace protocol (checkpoint.py); a resume must skip it."""
    if not train_dir:
      self._log("fault corrupt_ckpt: no train_dir; nothing to corrupt")
      return
    from kf_benchmarks_tpu_torch import checkpoint
    ckpts = checkpoint.all_checkpoints(train_dir)
    if not ckpts:
      self._log("fault corrupt_ckpt: no checkpoint on disk yet")
      return
    _, fname = ckpts[-1]
    path = os.path.join(train_dir, fname)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
      f.truncate(max(1, size // 2))
    self._log(f"fault corrupt_ckpt: truncated {fname} "
              f"{size} -> {max(1, size // 2)} bytes")
