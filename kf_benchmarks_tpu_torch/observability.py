"""Profiling, program dumps, the benchmark logger and the summaries.

The port's counterpart of kf_benchmarks_tpu/observability.py, on
torch.profiler and torch.utils.flop_counter (ref: benchmark_cnn.py):

  --trace_file    a Chrome trace of one step (ref :270-275, :806-817): the
                  torch.profiler capture of one designated dispatch, written
                  to the file --trace_file names (the JAX package's
                  jax.profiler writes a run directory beside it instead).
                  On a card the capture asks for the CUDA and CPU
                  activities and synchronizes inside the profiler, so the
                  trace spans the device work; on the CPU it asks for the
                  CPU activity alone. A marker span on the run trace
                  (tracing.py) shows where in the host timeline it ran.
  --tfprof_file   the tfprof profile (ref :276-289, :1208-1228): one step's
                  FLOPs by op and by module (FlopCounterMode over fake
                  tensors, so nothing runs and no state moves, with the
                  kernels' custom ops counted by their own formulas), the
                  card's memory, a static per-op ranking at the H100's
                  peaks (.ops.txt) and, with --trace_file, the measured
                  per-op table of the traced dispatch (.measured_ops.txt).
  --graph_file    the program text (ref :2142-2148): the torch.export
                  program of the step's training-mode forward and loss,
                  the kernels as torch.ops.kf_torch.* nodes.
  --partitioned_graph_file_prefix  this rank's plan (ref :293-296): the
                  strategy, the reductions a step and each leaf's shard,
                  to <prefix>.txt.
  --benchmark_log_dir  the model garden's BenchmarkFileLogger JSON
                  (ref :1594-1608, :847-854, :1694-1724): benchmark_run.log
                  and one metric.log line a metric.
  --summary_verbosity / --save_summaries_steps  the summary tiers 0-3 (ref
                  :586-593, :2811-2846) as a JSONL event stream under
                  train_dir.

The peaks are the NVIDIA H100 80GB HBM3's at 700 W (spec sheet, dense):
989 TFLOP/s bf16 and 3.35 TB/s.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kf_benchmarks_tpu_torch import metrics as metrics_lib

H100_NAME = "NVIDIA H100 80GB HBM3"
H100_PEAK_FLOPS = 989e12
H100_PEAK_BYTES_PER_S = 3.35e12
# NVLink 4 of the SXM part: 900 GB/s both ways, 450 GB/s a direction.
H100_LINK_BYTES_PER_S = 4.5e11


# -- one-dispatch trace (ref: benchmark_cnn.py:270-275) ---------------------

def trace_dir_of(trace_file: Optional[str]) -> str:
  """The directory the --trace_file capture lands in."""
  return os.path.dirname(trace_file or "") or "."


def list_profile_runs(trace_file: Optional[str]) -> List[tuple]:
  """The captures already at ``trace_file``: its (path, mtime_ns, size),
  or nothing. Taken before a capture, it lets the readback tell this run's
  trace from a stale one an earlier run left at the same path."""
  try:
    st = os.stat(trace_file)
  except (OSError, TypeError):
    return []
  return [(trace_file, st.st_mtime_ns, st.st_size)]


@contextlib.contextmanager
def maybe_trace_step(trace_file: Optional[str], step: int,
                     trace_at_step: int = 0, device=None):
  """torch.profiler around exactly one designated dispatch (``step ==
  trace_at_step``), its Chrome trace written to ``trace_file``. Yields
  whether this dispatch is traced."""
  if not (trace_file and step == trace_at_step):
    yield False
    return
  from torch.profiler import ProfilerActivity, profile
  from kf_benchmarks_tpu_torch import tracing
  cuda = device is not None and torch.device(device).type == "cuda"
  # CPU alone off the card: asking a CPU-only build for the CUDA activity
  # can hang.
  activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda
                else [ProfilerActivity.CPU])
  os.makedirs(trace_dir_of(trace_file), exist_ok=True)
  with tracing.active().span("profiler", "torch_profiler_trace", step=step,
                             trace_file=trace_file):
    with profile(activities=activities) as prof:
      yield True
      if cuda:
        # The dispatch is asynchronous: the trace must span its kernels.
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(trace_file)


# -- FLOPs and bytes of one step (ref: tfprof, benchmark_cnn.py:276-289) ----

class _OpBytes(torch.utils._python_dispatch.TorchDispatchMode):
  """Calls and tensor bytes (inputs read once, outputs written once) by op,
  the bytes half of the static roofline."""

  def __init__(self):
    super().__init__()
    self.rows: Dict[str, Dict[str, int]] = {}

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    if func.is_view:
      return out  # a view moves no bytes
    name = str(func.overloadpacket)
    row = self.rows.setdefault(name, {"count": 0, "bytes": 0})
    row["count"] += 1
    for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
      if isinstance(t, torch.Tensor):
        row["bytes"] += t.numel() * t.element_size()
    return out


def step_costs(step, images, labels, training: bool = True
               ) -> Dict[str, Any]:
  """One step's forward, loss and (``training``) backward counted on fake
  tensors: FLOPs by op and by module (FlopCounterMode), calls and bytes by
  op. Nothing runs on the device, no kernel is launched and no weight or
  running average moves. The optimizer's update, elementwise, counts no
  FLOPs. ``step`` is a train_step.TrainStep, or an EvalStep with
  ``training`` False (the module in eval mode, no gradient)."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  from torch.utils.flop_counter import FlopCounterMode
  module, model = step.module, step.model
  fake = FakeTensorMode()
  full = getattr(step, "full_params", contextlib.nullcontext)
  with full():
    params = {k: fake.from_tensor(v.detach()).requires_grad_(v.requires_grad)
              for k, v in module.named_parameters()}
    buffers = {k: fake.from_tensor(v) for k, v in module.named_buffers()}
    x = fake.from_tensor(images)
    y = torch.utils._pytree.tree_map(fake.from_tensor, labels)
    trainable = [v for v in params.values() if v.requires_grad]
    counter = FlopCounterMode(display=False)
    op_bytes = _OpBytes()
    was_training = module.training
    module.train(training)
    try:
      with fake, counter, op_bytes, torch.set_grad_enabled(training):
        logits = torch.func.functional_call(module, {**params, **buffers},
                                            (x,))
        loss = model.loss_function(logits, y)
        if training:
          torch.autograd.grad(loss, trainable, allow_unused=True)
    finally:
      module.train(was_training)
  counts = counter.get_flop_counts()
  by_op = {str(op): int(n) for op, n in counts.get("Global", {}).items()}
  by_module = {name: int(sum(ops.values()))
               for name, ops in counts.items() if name != "Global"}
  return {"flops": int(counter.get_total_flops()), "flops_by_op": by_op,
          "flops_by_module": by_module, "ops": op_bytes.rows}


def memory_report(step, device) -> Dict[str, int]:
  """The card's peak allocation so far and the parameters' and optimizer
  state's bytes (this rank's shards under sharded state; the module's
  parameters and no state for an EvalStep)."""
  optimizer = getattr(step, "optimizer", None)
  if optimizer is None:
    weights, opt = list(step.module.parameters()), []
  else:
    weights = [p for g in optimizer.param_groups for p in g["params"]]
    opt = [v for p in weights for v in optimizer.state[p].values()
           if isinstance(v, torch.Tensor)]
  report = {
      "param_bytes": sum(p.numel() * p.element_size() for p in weights),
      "opt_state_bytes": sum(t.numel() * t.element_size() for t in opt),
  }
  if torch.device(device).type == "cuda":
    report["max_memory_allocated"] = int(
        torch.cuda.max_memory_allocated(device))
  return report


def dump_cost_analysis(step, images, labels, path: str, device="cpu",
                       training: bool = True) -> Dict[str, Any]:
  """The tfprof analog (ref: benchmark_cnn.py:276-289): ``step_costs``
  and ``memory_report`` written to ``path`` as JSON, and returned. A
  model whose forward the fake pass cannot run records the error."""
  report: Dict[str, Any] = {}
  try:
    costs = step_costs(step, images, labels, training)
    report.update({k: costs[k] for k in ("flops", "flops_by_op",
                                         "flops_by_module")})
    report["op_bytes"] = {k: v["bytes"] for k, v in costs["ops"].items()}
    report["op_calls"] = {k: v["count"] for k, v in costs["ops"].items()}
  except Exception as e:  # the model's own forward may defeat fake tensors
    report["flop_count_error"] = repr(e)
  report["memory"] = memory_report(step, device)
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "w") as f:
    json.dump(report, f, indent=2, sort_keys=True)
  return report


# -- the static per-op table (ref: benchmark_cnn.py:1208-1228 tfprof) -------

PER_OP_TABLE_HEADER = ("rank  est_time_us  %total        flops"
                       "        bytes  op")


def per_op_costs(report: Dict[str, Any]) -> List[Dict[str, Any]]:
  """Rows {name, count, flops, bytes, est_time_s} of a cost report, the
  time the roofline at the H100's peaks."""
  rows = []
  for name, nbytes in (report.get("op_bytes") or {}).items():
    flops = float((report.get("flops_by_op") or {}).get(name, 0))
    rows.append({"name": name,
                 "count": int((report.get("op_calls") or {}).get(name, 0)),
                 "flops": flops, "bytes": float(nbytes),
                 "est_time_s": max(flops / H100_PEAK_FLOPS,
                                   nbytes / H100_PEAK_BYTES_PER_S)})
  return rows


def mfu_line(total_flops: float, step_time_s: float,
             peak_flops: float = H100_PEAK_FLOPS,
             source: str = "roofline-estimated") -> str:
  """Model-FLOP utilization: achieved FLOP/s over the card's dense bf16
  peak. With the roofline estimate as the step time it is the ceiling the
  program admits; with a measured step time, the achieved MFU."""
  if step_time_s <= 0:
    return "MFU: n/a (no step time)"
  achieved = total_flops / step_time_s
  return (f"MFU: {100.0 * achieved / peak_flops:.1f}% "
          f"({achieved / 1e12:.2f} TFLOP/s {source} over "
          f"{peak_flops / 1e12:.0f} TFLOP/s bf16 peak, {H100_NAME}; "
          f"{total_flops:.3e} flops/step)")


def dispatch_overhead_line(est_step_s: float, steps_per_dispatch: int,
                           host_s: float) -> str:
  """The host axis no per-op row carries: each dispatch's host time
  (``host_s``, the run's measured dispatch_overhead_s) against the device
  work of its K steps at the roofline."""
  k = max(1, int(steps_per_dispatch))
  per_dispatch_s = est_step_s * k
  frac = host_s / max(per_dispatch_s + host_s, 1e-12)
  return (f"dispatch overhead: {host_s * 1e3:.3f} ms host time/dispatch "
          f"over {k} step(s)/dispatch "
          f"({per_dispatch_s * 1e6:.1f} us est device work/dispatch) "
          f"-> {100.0 * frac:.1f}% of dispatch wall at the roofline")


def collective_overlap_stats(contract) -> Dict[str, Any]:
  """The comm/compute overlap axis of a traced step (analysis/contracts.py
  ProgramContract): a collective a hook issues inside the backward
  (--overlap_gradient_reduction's buckets, the FSDP gather's backward)
  can run beside the rest of the backward's compute; one issued after it
  trails the compute. {num_collectives, comm_s, comm_in_backward_s,
  overlap_fraction}, the times each collective's bytes at the H100's
  NVLink rate (a ranking; the overlap measured across cards waits for a
  multi-card host)."""
  comm_s = in_bwd_s = 0.0
  for c in contract.collectives:
    est = c.nbytes / H100_LINK_BYTES_PER_S
    comm_s += est
    if c.in_backward:
      in_bwd_s += est
  return {
      "num_collectives": len(contract.collectives),
      "comm_s": comm_s,
      "comm_in_backward_s": in_bwd_s,
      "overlap_fraction": in_bwd_s / comm_s if comm_s else 0.0,
  }


def overlap_fraction_line(contract) -> str:
  """One line for the comm/compute overlap axis: how much of the step's
  collective time is issued inside the backward against trailing it."""
  stats = collective_overlap_stats(contract)
  if not stats["num_collectives"]:
    return ("comm/compute overlap: no collectives in the step (one rank, "
            "or an unreduced mode)")
  return (f"comm/compute overlap: {stats['num_collectives']} collectives, "
          f"~{stats['comm_s'] * 1e6:.1f} us est comm at NVLink's "
          f"{H100_LINK_BYTES_PER_S / 1e9:.0f} GB/s; "
          f"{100.0 * stats['overlap_fraction']:.1f}% issued inside the "
          "backward (overlappable with compute), "
          f"{(stats['comm_s'] - stats['comm_in_backward_s']) * 1e6:.1f} us "
          "trailing it")


def hbm_breakdown_line(mem: Dict[str, int]) -> str:
  """One memory line of a cost report's ``memory``."""
  mib = 1024.0 * 1024.0
  peak = mem.get("max_memory_allocated")
  return ("memory: parameters %.1f MiB + optimizer state %.1f MiB; peak "
          "allocated %s" % (
              mem.get("param_bytes", 0) / mib,
              mem.get("opt_state_bytes", 0) / mib,
              "%.1f MiB" % (peak / mib) if peak is not None
              else "n/a (not on a card)"))


def per_op_table(report: Dict[str, Any], top_n: int = 20) -> str:
  """The tfprof top-op table analog (ref: benchmark_cnn.py:1208-1228):
  the ``top_n`` ops of one step by roofline-estimated time at the H100's
  peaks, and the roofline MFU line."""
  rows = per_op_costs(report)
  rows.sort(key=lambda r: r["est_time_s"], reverse=True)
  total = sum(r["est_time_s"] for r in rows) or 1.0
  lines = [f"Top {top_n} ops by estimated accelerator time (static "
           f"roofline of one step at the {H100_NAME}'s peaks)",
           PER_OP_TABLE_HEADER]
  for rank, r in enumerate(rows[:top_n], 1):
    lines.append(
        f"{rank:4d}  {r['est_time_s'] * 1e6:11.1f}  "
        f"{100.0 * r['est_time_s'] / total:5.1f}%  {r['flops']:11.3e}  "
        f"{r['bytes']:11.3e}  {r['name']} x{r['count']}")
  lines.append(mfu_line(float(report.get("flops", 0)), total))
  return "\n".join(lines)


def dump_per_op_profile(report: Dict[str, Any], path: str,
                        top_n: int = 20) -> str:
  """Write the static per-op table next to the cost JSON; return it."""
  table = per_op_table(report, top_n=top_n)
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "w") as f:
    f.write(table + "\n")
  return table


# -- program dumps (ref: --graph_file, --partitioned_graph_file_prefix) -----

class _ForwardLoss(torch.nn.Module):
  """The step's training-mode forward and loss as one module."""

  def __init__(self, module, model):
    super().__init__()
    self.module = module
    self.model = model

  def forward(self, images, labels):
    return self.model.loss_function(self.module(images), labels)


def program_text(step, images, labels, training: bool = True) -> str:
  """The torch.export program of the step's forward and loss, in
  training mode (or eval mode), the kernels' custom ops as nodes.
  Exporting traces on fake tensors: nothing runs and no state moves."""
  module = step.module
  was_training = module.training
  module.train(training)
  try:
    with step.full_params() if hasattr(step, "full_params") else \
        contextlib.nullcontext():
      program = torch.export.export(_ForwardLoss(module, step.model),
                                    (images, labels))
  finally:
    module.train(was_training)
  return str(program)


def dump_program_text(step, images, labels, path: str,
                      training: bool = True) -> str:
  """``program_text`` written to ``path``; returned."""
  text = program_text(step, images, labels, training)
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "w") as f:
    f.write(text)
  return text


def plan_text(step, strategy, rank: int, world: int) -> str:
  """This rank's plan of a training step: the strategy, each leaf's
  gradient reduction (per tensor, a packed bucket of --all_reduce_spec, an
  overlapped bucket, a reduce-scatter into shards, or none) and its shard
  under sharded state."""
  module = step.module
  named = list(module.named_parameters())
  sharding = getattr(step, "sharding", None)
  reducer = getattr(step, "_reducer", None)
  packed = getattr(strategy, "reducer", None)
  bucket_of = {}
  if reducer is not None:
    # Buckets hold indices into module.parameters().
    for b, members in enumerate(reducer.buckets):
      for i in members:
        bucket_of[i] = b
  shards = {}
  if sharding is not None:
    for name, shard in zip(sharding.names, sharding.shards):
      shards[name] = shard.numel()
  lines = [
      "partitioned plan: rank %d of %d, strategy %s (cross_replica=%s, "
      "sharded_state=%s), num_grad_accum %d" % (
          rank, world, getattr(strategy, "name", type(strategy).__name__),
          bool(getattr(strategy, "cross_replica", False)),
          sharding is not None, getattr(step, "num_grad_accum", 1)),
      "collectives run: %s" % (
          "yes" if world > 1 else "none (world 1: no process group)"),
      "leaf\tshape\tdtype\telements\treduction\tshard elements",
  ]
  for i, (name, p) in enumerate(named):
    if not getattr(strategy, "cross_replica", False):
      how = "none (per-replica gradients)"
    elif sharding is not None:
      how = "reduce-scatter into the (n, k) shard stack"
    elif i in bucket_of:
      how = f"overlapped bucket {bucket_of[i]}"
    elif packed is not None:
      how = f"packed by {type(packed).__name__}"
    else:
      how = "all-reduce mean, per tensor"
    lines.append("%s\t%s\t%s\t%d\t%s\t%s" % (
        name, tuple(p.shape), str(p.dtype).replace("torch.", ""),
        p.numel(), how, shards.get(name, "-")))
  return "\n".join(lines) + "\n"


def dump_partitioned_text(step, strategy, rank: int, world: int,
                          path: str) -> str:
  """``plan_text`` written to ``path``; returned."""
  text = plan_text(step, strategy, rank, world)
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "w") as f:
    f.write(text)
  return text


def chunk_timing_rows(steps_per_dispatch: int, chunk_intervals,
                      global_batch: int, max_rows: int = 8):
  """Per-chunk timing rows of the chunked dispatch (--steps_per_dispatch):
  the last ``max_rows`` dispatches' wall intervals and a summary line."""
  k = max(1, int(steps_per_dispatch))
  times = list(chunk_intervals)
  if not times:
    return []
  mean = sum(times) / len(times)
  lines = [
      "dispatch chunks (K=%d): %d dispatches, mean %.1f ms/chunk "
      "(%.2f ms/step, %.1f img/s), min %.1f ms, max %.1f ms" % (
          k, len(times), mean * 1e3, mean / k * 1e3,
          k * global_batch / max(mean, 1e-9),
          min(times) * 1e3, max(times) * 1e3),
      "chunk  wall_ms  img/s",
  ]
  first = max(0, len(times) - max_rows)
  if first:
    lines.append(f"  ... ({first} earlier chunks elided)")
  for idx in range(first, len(times)):
    t = times[idx]
    lines.append("%5d  %7.1f  %.1f" % (
        idx + 1, t * 1e3, k * global_batch / max(t, 1e-9)))
  return lines


# -- the MEASURED per-op table from the captured trace -----------------------
# The reference's tfprof read measured accelerator time out of RunMetadata
# (ref: benchmark_cnn.py:1208-1228). Here the torch.profiler Chrome trace of
# --trace_file is read back: on a card its "kernel" events (device time,
# replays of a CUDA graph included), on the CPU its "cpu_op" events (self
# time: a nested op's time is its parent's no longer).

def load_trace_op_events(trace_file: str, exclude=()):
  """(kind, events): the kernel events of the trace at ``trace_file``, or
  its cpu_op events when it has none, each with ``self_us``; ("", []) when
  the file is absent, unreadable or one of ``exclude`` (a capture that was
  there before this run)."""
  if set(list_profile_runs(trace_file)) & set(exclude) or \
      not list_profile_runs(trace_file):
    return "", []
  try:
    with open(trace_file) as f:
      data = json.load(f)
  except (OSError, ValueError):
    return "", []
  events = [e for e in data.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") == "X"]
  kernels = [e for e in events if e.get("cat") == "kernel"]
  if kernels:
    for e in kernels:
      e["self_us"] = float(e.get("dur", 0.0))
    return "kernel", kernels
  ops = [e for e in events if e.get("cat") == "cpu_op"]
  _self_times(ops)
  return "cpu_op", ops


def _self_times(events) -> None:
  """Each event's duration less its children's on the same thread."""
  by_thread: Dict[Any, list] = {}
  for e in events:
    e["self_us"] = float(e.get("dur", 0.0))
    by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
  for evs in by_thread.values():
    evs.sort(key=lambda e: (float(e.get("ts", 0.0)),
                            -float(e.get("dur", 0.0))))
    stack = []
    for e in evs:
      t0 = float(e.get("ts", 0.0))
      while stack and float(stack[-1].get("ts", 0.0)) + \
          float(stack[-1].get("dur", 0.0)) <= t0:
        stack.pop()
      if stack:
        stack[-1]["self_us"] -= float(e.get("dur", 0.0))
      stack.append(e)


def measured_op_costs(events):
  """Op events -> rows {name, module, total_us, count, avg_us}, keyed by
  (module, name): the module is the CUDA stream of a kernel (the feeder's
  copies and the step's work may share a kernel's name), "" otherwise."""
  agg: Dict[Any, Dict[str, Any]] = {}
  for e in events:
    args = e.get("args") or {}
    module = (f"stream {args['stream']}"
              if e.get("cat") == "kernel" and "stream" in args else "")
    name = e["name"]
    row = agg.setdefault((module, name),
                         {"name": name, "total_us": 0.0, "count": 0,
                          "module": module})
    row["total_us"] += float(e.get("self_us", e.get("dur", 0.0)))
    row["count"] += 1
  rows = list(agg.values())
  for r in rows:
    r["avg_us"] = r["total_us"] / max(r["count"], 1)
  return rows


MEASURED_OP_TABLE_HEADER = ("rank     total_us  %total  count       avg_us"
                            "  op")


def format_measured_table(rows, title: str, top_n: int = 20) -> str:
  """The measured table's text: ``title``, the header, the ``top_n`` rows
  by total time (op names qualified by their module only when the rows
  hold more than one)."""
  rows = sorted(rows, key=lambda r: r["total_us"], reverse=True)
  total = sum(r["total_us"] for r in rows) or 1.0
  multi_module = len({r["module"] for r in rows}) > 1
  lines = [title, MEASURED_OP_TABLE_HEADER]
  for rank, r in enumerate(rows[:top_n], 1):
    name = (f"{r['name']} [{r['module']}]" if multi_module else r["name"])
    lines.append(
        f"{rank:4d}  {r['total_us']:11.1f}  "
        f"{100.0 * r['total_us'] / total:5.1f}%"
        f"  {r['count']:5d}  {r['avg_us']:11.2f}  {name}")
  return "\n".join(lines)


def measured_per_op_table(trace_file: str, top_n: int = 20,
                          exclude=()) -> Optional[str]:
  """The measured half of the tfprof analog: the ``top_n`` ops of the
  captured dispatch by measured time (kernel time on a card, CPU self
  time otherwise; the title says which). None when the trace holds no op
  event."""
  kind, events = load_trace_op_events(trace_file, exclude=exclude)
  rows = measured_op_costs(events)
  if not rows:
    return None
  what = ("kernel time on the card" if kind == "kernel"
          else "CPU self time of the ops")
  return format_measured_table(
      rows, f"Top {top_n} ops by MEASURED {what} (torch.profiler trace of "
      "the designated dispatch)", top_n)


def dump_measured_op_profile(trace_file: str, path: str, top_n: int = 20,
                             exclude=()) -> Optional[str]:
  """Write the measured table and return it; None when the trace held no
  op event, in which case a table an earlier run left at ``path`` is
  removed too."""
  table = measured_per_op_table(trace_file, top_n=top_n, exclude=exclude)
  if table is None:
    try:
      os.unlink(path)
    except FileNotFoundError:
      pass
    return None
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "w") as f:
    f.write(table + "\n")
  return table


# -- benchmark logger (ref: benchmark_cnn.py:1594-1608) ---------------------

class BenchmarkLogger:
  """The model garden's BenchmarkFileLogger JSON: benchmark_run.log, one
  object of run metadata (ref _log_benchmark_run :1694-1724), and
  metric.log, one JSON line a metric {name, value, unit, global_step,
  timestamp, extras} (ref :847-854, :1915-1922). ``platform`` is ``gpu``
  or ``cpu``."""

  def __init__(self, log_dir: str, platform: str = "gpu"):
    self.log_dir = log_dir
    self.platform = platform
    os.makedirs(log_dir, exist_ok=True)
    self._metric_path = os.path.join(log_dir, "metric.log")

  def log_run_info(self, params, model_name: str, dataset_name: str,
                   num_devices: int, batch_size: int) -> None:
    info = {
        "model_name": model_name,
        "dataset": {"name": dataset_name},
        # (ref: --benchmark_test_id in the run info, :344-348)
        **({"test_id": params.benchmark_test_id}
           if getattr(params, "benchmark_test_id", None) else {}),
        "machine_config": {"num_devices": num_devices,
                           "platform": self.platform},
        "batch_size": batch_size,
        "run_date": time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime()),
        "run_parameters": [
            {"name": k, "value": str(v)}
            for k, v in sorted(params._asdict().items())
            if v is not None],
    }
    with open(os.path.join(self.log_dir, "benchmark_run.log"), "w") as f:
      json.dump(info, f, indent=2)

  def log_metric(self, name: str, value, unit: Optional[str] = None,
                 global_step: Optional[int] = None,
                 extras: Optional[dict] = None) -> None:
    value = float(value)
    if not math.isfinite(value):
      # A diverged run leaves a record, not a gap: a null value, flagged.
      extras = dict(extras or {})
      extras["non_finite"] = repr(value)
      value = None
    record = {
        "name": name,
        "value": value,
        "unit": unit,
        "global_step": global_step,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "extras": [{"name": k, "value": str(v)}
                   for k, v in sorted((extras or {}).items())],
    }
    with open(self._metric_path, "a") as f:
      f.write(json.dumps(record) + "\n")
    # Registered names also reach the live registry (/metrics).
    if value is not None:
      if name in metrics_lib.SCHEMA:
        metrics_lib.active().set(name, value)
      elif metrics_lib.health_key(name) in metrics_lib.SCHEMA:
        metrics_lib.active().set(metrics_lib.health_key(name), value)


# -- summary writer (ref: benchmark_cnn.py:586-593, 2811-2846) --------------

class SummaryWriter:
  """Tiered JSONL event stream, ``events.jsonl`` under a directory. Tier
  1: scalars (loss, rate, images/sec). Tier 2: and parameter histograms
  (the first MAX_TIER2_LEAVES). Tier 3: every parameter's."""

  MAX_TIER2_LEAVES = 16

  def __init__(self, train_dir: str, verbosity: int):
    self.verbosity = verbosity
    self.path = os.path.join(train_dir, "events.jsonl")
    os.makedirs(train_dir, exist_ok=True)

  def _write(self, record: dict) -> None:
    with open(self.path, "a") as f:
      f.write(json.dumps(record) + "\n")

  def write_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
    if self.verbosity < 1:
      return
    clean = {}
    for k, v in scalars.items():
      v = float(v)
      if math.isfinite(v):
        clean[k] = v
    self._write({"step": step, "scalars": clean})

  def write_histograms(self, step: int, named, prefix: str) -> None:
    """``named``: (name, tensor) pairs, a module's ``named_parameters()``
    for one; the names' dots become slashes (``params/conv1/weight``)."""
    if self.verbosity < 2:
      return
    cap = self.MAX_TIER2_LEAVES if self.verbosity < 3 else None
    hists = {}
    for name, leaf in named:
      if cap is not None and len(hists) >= cap:
        break
      if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().float().cpu().numpy()
      arr = np.asarray(leaf, np.float32)
      if arr.size == 0:
        continue
      counts, edges = np.histogram(arr.ravel(), bins=20)
      hists["/".join([prefix] + name.split("."))] = {
          "counts": counts.tolist(), "min": float(edges[0]),
          "max": float(edges[-1]), "mean": float(arr.mean()),
          "std": float(arr.std())}
    self._write({"step": step, "histograms": hists})
