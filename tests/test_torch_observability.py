"""The port's observability (kf_benchmarks_tpu_torch/observability.py)
against the JAX package's, and the kernels' FLOP formulas.

* The measured per-op table: one list of op executions, written as each
  package's profiler writes it (the JAX package's jax.profiler run
  directory with ``hlo_op`` events, torch.profiler's Chrome trace with
  ``kernel`` events), gives the same table but for the title line, which
  names what was ranked (tolerance: none). A trace that was already at the
  path before the capture is never read.
* ``BenchmarkLogger``'s and ``SummaryWriter``'s files from the same calls
  are equal but for the timestamps and the platform; ``chunk_timing_rows``
  is equal (tolerance: none).
* The FLOP formulas of the kernels' custom ops: a small ResNet-50 step
  counted with the fused unit equals the same step with the unit routed to
  ``F.conv2d`` (exact integers), and the flash ops count what their plain
  versions count, the causal mask's admissible pairs only.
* On the CPU: ``maybe_trace_step`` captures the CPU activity alone, the
  cost report and the program text (the custom ops as nodes) of a small
  ResNet, and this rank's plan.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from kf_benchmarks_tpu import observability as jax_obs
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import observability as obs
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import tracing
from kf_benchmarks_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

OPS = [("fusion.3", 120.5), ("convolution.1", 900.25), ("fusion.3", 119.5),
       ("copy.7", 3.0), ("dot.2", 410.0), ("convolution.1", 899.75)] + \
    [(f"fusion.{i}", float(i)) for i in range(10, 40)]


def _jax_trace_dir(root):
  run = os.path.join(root, "plugins", "profile", "2026_01_01_00_00_00")
  os.makedirs(run)
  events = [{"ph": "X", "name": n, "ts": i, "dur": d, "pid": 1, "tid": 1,
             "args": {"hlo_op": n, "hlo_module": "jit_step"}}
            for i, (n, d) in enumerate(OPS)]
  with gzip.open(os.path.join(run, "host.trace.json.gz"), "wt") as f:
    json.dump({"traceEvents": events}, f)
  return root


def _torch_trace(path, stream=7, extra=()):
  events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * i,
             "dur": d, "pid": 0, "tid": stream, "args": {"stream": stream}}
            for i, (n, d) in enumerate(OPS)]
  events += [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
              "dur": 5.0, "pid": 0, "tid": 1}] + list(extra)
  with open(path, "w") as f:
    json.dump({"traceEvents": events}, f)
  return path


def test_measured_table_matches_the_jax_table(tmp_path):
  want = jax_obs.measured_per_op_table(_jax_trace_dir(str(tmp_path / "j")))
  got = obs.measured_per_op_table(_torch_trace(str(tmp_path / "t.json")))
  assert got.splitlines()[1:] == want.splitlines()[1:]
  assert "kernel time on the card" in got.splitlines()[0]
  for top_n in (3, 50):
    assert obs.measured_per_op_table(
        str(tmp_path / "t.json"), top_n=top_n).splitlines()[1:] == \
        jax_obs.measured_per_op_table(
            str(tmp_path / "j"), top_n=top_n).splitlines()[1:]


def test_measured_table_streams_cpu_ops_and_stale_traces(tmp_path):
  # Two streams: op names carry their stream.
  path = _torch_trace(str(tmp_path / "t.json"), extra=[
      {"ph": "X", "cat": "kernel", "name": "copy.7", "ts": 5.0, "dur": 1.0,
       "pid": 0, "tid": 9, "args": {"stream": 9}}])
  table = obs.measured_per_op_table(path, top_n=50)
  assert "copy.7 [stream 9]" in table and "copy.7 [stream 7]" in table
  # CPU ops rank by self time: a parent's time less its children's.
  cpu = str(tmp_path / "cpu.json")
  with open(cpu, "w") as f:
    json.dump({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 0.0,
         "dur": 10.0, "pid": 0, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0,
         "dur": 7.0, "pid": 0, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 12.0,
         "dur": 2.0, "pid": 0, "tid": 1}]}, f)
  kind, events = obs.load_trace_op_events(cpu)
  rows = {r["name"]: r for r in obs.measured_op_costs(events)}
  assert kind == "cpu_op"
  assert rows["aten::linear"]["total_us"] == 3.0
  assert rows["aten::mm"]["total_us"] == 9.0 and rows["aten::mm"][
      "count"] == 2
  assert "CPU self time" in obs.measured_per_op_table(cpu)
  # A trace already at the path before this run's capture is not read.
  stale = obs.list_profile_runs(cpu)
  assert obs.measured_per_op_table(cpu, exclude=stale) is None
  out = str(tmp_path / "table.txt")
  with open(out, "w") as f:
    f.write("an earlier run's table\n")
  assert obs.dump_measured_op_profile(cpu, out, exclude=stale) is None
  assert not os.path.exists(out)
  assert obs.dump_measured_op_profile(cpu, out).startswith("Top 20")


def _strip(path, keys=("timestamp", "run_date")):
  rows = []
  with open(path) as f:
    text = f.read()
  try:
    objs = [json.loads(text)]
  except ValueError:
    objs = [json.loads(line) for line in text.splitlines()]
  for obj in objs:
    for key in keys:
      obj.pop(key, None)
    obj.get("machine_config", {}).pop("platform", None)
    rows.append(obj)
  return rows


def test_logger_and_summary_files_match(tmp_path):
  params = params_lib.make_params(model="resnet50", benchmark_test_id="t1")
  rng = np.random.default_rng(0)
  kernel = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
  bias = rng.normal(size=(8,)).astype(np.float32)
  for name, mod, kw in (("jax", jax_obs, {}), ("port", obs,
                                                {"platform": "gpu"})):
    d = str(tmp_path / name)
    logger = mod.BenchmarkLogger(os.path.join(d, "log"), **kw)
    logger.log_run_info(params, "resnet50", "imagenet", 1, 32)
    logger.log_metric("current_examples_per_sec", 12.5,
                      unit="examples/sec", global_step=3)
    logger.log_metric("total_loss", float("nan"), global_step=4,
                      extras={"k": 2})
    for verbosity in (1, 2, 3):
      writer = mod.SummaryWriter(os.path.join(d, f"sum{verbosity}"),
                                 verbosity)
      writer.write_scalars(5, {"loss": 1.5, "bad": float("inf"),
                               "health/grad_norm": np.float32(2.0)})
      if mod is jax_obs:
        writer.write_histograms(5, {"conv1": {"kernel": kernel},
                                    "dense": {"bias": bias}}, "params")
      else:
        writer.write_histograms(5, [("conv1.kernel", torch.from_numpy(
            kernel)), ("dense.bias", bias)], "params")
  for rel in ("log/benchmark_run.log", "log/metric.log",
              "sum1/events.jsonl", "sum2/events.jsonl", "sum3/events.jsonl"):
    assert _strip(str(tmp_path / "port" / rel)) == \
        _strip(str(tmp_path / "jax" / rel)), rel
  assert obs.chunk_timing_rows(8, [0.5 + 0.01 * i for i in range(12)], 256) \
      == jax_obs.chunk_timing_rows(8, [0.5 + 0.01 * i for i in range(12)],
                                   256)


def _resnet(model="resnet50", **kw):
  bench = benchmark.BenchmarkCNN(params_lib.make_params(
      model=model, batch_size=2, device="cpu", num_batches=1, **kw))
  return bench.build()


def test_fused_step_counts_the_flops_of_the_routed_off_step():
  module, step, images, labels = _resnet()
  fused = obs.step_costs(step, images, labels)
  blocks = [m for m in module.modules() if getattr(m, "fused", False)]
  assert len(blocks) == 13
  for m in blocks:
    m.fused = False
  plain = obs.step_costs(step, images, labels)
  assert fused["flops"] == plain["flops"] > 0
  ops = fused["flops_by_op"]
  assert ops["kf_torch.bn_relu_conv3x3_stats"] == \
      ops["kf_torch.conv3x3_same"] > 0
  # Counting ran on fake tensors: no weight and no running average moved.
  before = [t.clone() for t in module.state_dict().values()]
  obs.step_costs(step, images, labels)
  assert all(torch.equal(a, b) for a, b in
             zip(before, module.state_dict().values()))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_formulas_count_the_plain_products(causal):
  g = torch.Generator().manual_seed(0)
  q, k, v = (torch.randn(2, 96, 2, 64, generator=g) for _ in range(3))
  with FlopCounterMode(display=False) as counter:
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    di = (o * o).sum(-1).transpose(1, 2).contiguous()
    fa.flash_attention_bwd_dkv(q, k, v, o, lse, di, causal)
    fa.flash_attention_bwd_dq(q, k, v, o, lse, di, causal)
    fa.flash_decode(q[:, :1], k, v, torch.tensor([5, 90], dtype=torch.int32))
  got = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
  with FlopCounterMode(display=False) as plain:
    fa.flash_attention_fwd_plain(q, k, v, False)
  full = plain.get_total_flops()  # 4 B H L^2 D: S = Q K^T and P V
  pairs, all_pairs = fa.admissible_pairs(96, 96, causal), 96 * 96
  assert got["kf_torch.flash_attention_fwd"] * all_pairs == full * pairs
  assert got["kf_torch.flash_attention_bwd_dkv"] * all_pairs == \
      2 * full * pairs
  assert 2 * got["kf_torch.flash_attention_bwd_dq"] * all_pairs == \
      3 * full * pairs
  assert got["kf_torch.flash_decode"] == full / 96
  assert fa.admissible_pairs(4, 6, True) == 10
  assert fa.admissible_pairs(6, 4, True) == 18


def test_cpu_trace_cost_report_program_text_and_plan(tmp_path):
  module, step, images, labels = _resnet("resnet20", data_name="cifar10",
                                         optimizer="momentum")
  # The profiler on the CPU: the CPU activity alone, a marker span.
  trace = tracing.activate(tracing.RunTrace(keep_spans=True))
  try:
    path = str(tmp_path / "p" / "trace.json")
    with obs.maybe_trace_step(path, 1, 0) as traced:
      assert not traced
    with obs.maybe_trace_step(path, 0, 0, device="cpu") as traced:
      assert traced
      step(images, labels)
  finally:
    tracing.deactivate()
  assert [s["name"] for s in trace.spans] == ["torch_profiler_trace"]
  kind, events = obs.load_trace_op_events(path)
  assert kind == "cpu_op" and events
  report = obs.dump_cost_analysis(step, images, labels,
                                  str(tmp_path / "tfprof.json"))
  with open(tmp_path / "tfprof.json") as f:
    assert json.load(f)["flops"] == report["flops"] > 0
  assert report["memory"]["opt_state_bytes"] > 0
  assert "max_memory_allocated" not in report["memory"]
  table = obs.per_op_table(report)
  assert table.splitlines()[1] == obs.PER_OP_TABLE_HEADER
  assert "MFU:" in table.splitlines()[-1] and "H100" in table
  text = obs.dump_program_text(step, images, labels,
                               str(tmp_path / "graph.txt"))
  # The builder network lists its fused units by name.
  fused = sum(len(m.fused) for m in module.modules()
              if isinstance(getattr(m, "fused", None), list))
  assert fused == 3
  assert text.count("torch.ops.kf_torch.bn_relu_conv3x3_stats.default(") \
      == fused
  plan = obs.plan_text(step, step.strategy, 0, 1)
  lines = plan.splitlines()
  assert lines[0].startswith("partitioned plan: rank 0 of 1")
  assert len(lines) == 3 + len(list(module.parameters()))
