"""Benchmark runtime: build -> warmup -> timed loop -> report.

The port's counterpart of the training path of kf_benchmarks_tpu/
benchmark.py (BenchmarkCNN, :340-910): the same banner, the reference's
step lines (``N\\timages/sec: ... loss``) every --display_every steps and
the ``total images/sec`` line, and a stats dict. The runtime is the same
for every model: for transformer_lm an "image" is one sequence, as in the
JAX package (tokens/sec = images/sec x the sequence length).

Data parallel: one BenchmarkCNN per rank process, in a process group that
the caller made (cli.py spawns the ranks, or joins kfrun's workers through
cluster.py). Every rank builds the same
weights and the same synthetic per-device batch from --tf_random_seed (the
JAX package tiles one per-device batch to every replica), the strategy's
``broadcast_init`` runs after the build, rank 0 alone prints, and the rate
is the global one: per-rank images times the world size over rank 0's
window. Every rank meets the others at a barrier before it returns.

Checkpoints and elastic resize (checkpoint.py, elastic.py; JAX
benchmark.py:948-1120, :1238-1260, :1531-1870): with --train_dir the build
resumes from the newest readable checkpoint there and the run then takes
--num_batches more steps, saving every --save_model_steps steps (or
--save_model_secs seconds) and at the end. Every
--elastic_check_every_n_steps steps the loop polls the coordination service
(--elastic, under kfrun) and the adaptive-batch policy: a new world size
is scheduled as a checkpoint-restart (checkpoint, restart barrier, then
``restart_for_resize`` in the stats, which cli.py turns into kfrun's exit
code 42); a new per-device batch is rebuilt in this process -- module,
step and synthetic batch at the new batch, the state carried across
through the checkpoint's state-dict path. Warmup steps train, as in the
JAX package, so they count toward the global step.

Modes (JAX benchmark.py:694-701, :1149-1158, :2049-2211): --forward_only
runs the same timed loop with the evaluation step (the module in eval
mode, no gradient, no optimizer) and saves nothing; --eval scores the
synthetic batch (or one pass of the validation records) once, or, with --train_dir, every new checkpoint there
(weights and batch-norm averages only) each --eval_interval_secs until 10
polls find nothing new, and prints ``Accuracy @ 1 = ... Accuracy @ 5 =
... [N examples]``. Training evaluates the training batch after the steps
the --eval_during_training_* flags name and stops at the first such step
whose top-1 reaches --stop_at_top_1_accuracy; like checkpoints, the eval
time stays out of the step times. --num_epochs and --num_eval_epochs
count ImageNet epochs at the global batch (data/datasets.py).

Dispatch (--steps_per_dispatch=K, --num_grad_accum=M): the timed loop
runs dispatches of up to K steps (train_step.TrainChunk: on the card one
CUDA-graph replay a step), shortened so that none crosses a step-keyed
save, eval or elastic check (``dispatch_len``); M splits each step's batch
into microbatches inside the step.

Telemetry and faults (telemetry.py, faults.py; JAX benchmark.py:419-440,
:876-891, :1419-1470, :1549, :1628-1690, :1925-1984): --health_stats
(resolved once against the strategy, auto = on with a --train_dir) makes
the step return its health vector; a TelemetrySession (the flight recorder
and the stall watchdog) spans the build and the loop whenever the stats
are on, or the run is elastic or fault-injected with a --train_dir. Every
step the metrics pipeline resolves writes one recorder row, and every
resolved dispatch is a heartbeat (the pipeline's read of real completed
work, never a device synchronize). --fault_schedule's steps are events of
the dispatch planner, and each fault fires at the dispatch boundary after
its step, after its recorder row. The run-end ``health`` summary goes into
the stats. Under --shard_optimizer_state --elastic a restart at another
world size resumes the sharded checkpoint re-sliced (checkpoint.py
``_reshard``); a target the flags do not run at is refused when it is
polled (``refuse_restart_target``).

Sharded state and the overlapped reduction (--shard_optimizer_state,
--shard_params, --overlap_gradient_reduction): ``build`` makes this rank's
shards (ops/sharded.py) before the optimizer, which steps on them, and
hands them and the bucket spec (ops/overlap.py) to the train step; the
checkpoints hold the shard stacks, and mid-training eval reads the
weights gathered.

The frozen forward (aot.py; JAX benchmark.py:699-775, :1160-1184):
--forward_only --aot_save_path exports the built module's eval forward,
weights folded in, at --trt_mode's precision (FP16 and INT8 compute in
bf16; INT8 stores per-channel int8 weights) before the timed loop, which
then runs as usual; --forward_only --aot_load_path loads such a program in
this process (its sidecar's mode checked against --trt_mode first) and
times it on a uniform random batch, with the forward-only step and total
lines; on the card the loaded program is captured once as a CUDA graph
and replayed (ops/graphs.py), the counterpart of calling the JAX
package's compiled export: the host then launches one graph a step
instead of walking the program's ~1600 nodes.

Real data (--data_dir; data/): each rank opens its own stream of the
dataset's preprocessor (seed --tf_random_seed + rank + 7919 x the input
incarnation, shift_ratio rank / world) through a DeviceFeeder
(``_open_input``), after the build, so that a resumed run or an in-process
rebuild reopens it at its incarnation. Every step reads the next batch:
at K = 1 one batch, at K > 1 the next slot of the feeder's staged K-batch
chunk (``RealInput``), and a K-step dispatch runs only over a whole chunk.
--eval reads the validation shards once and stops at their end; the
stats carry the feeder's ``stats()`` and its feed_stall_fraction.

Observability (tracing.py, observability.py, metrics.py; JAX
benchmark.py:775-910, :1186-1375, :1895-2100): every training run has a
run trace (spans with --trace_events_file), a metric registry (served live
with --metrics_port) and the kernels' build directory
(--compilation_cache_dir). After the build come the benchmark logger, the
summary writer and the dumps (--graph_file, --tfprof_file,
--partitioned_graph_file_prefix: fake-tensor passes, no launch); every
dispatch goes through ``run_dispatch`` (its span, compile_s, the compile
ledger's first call, and the one --trace_file profile: the last warmup
dispatch, a replay at K > 1); each resolved dispatch feeds the live lanes,
its device span and the chunk-wall samples. At run end: the measured
per-op table, the MFU line, the latency and ledger lines, the stats'
percentiles and ledger, their publication and (rank 0, --run_store_dir)
the run record. The eval passes write --eval_dir's summaries and the
logger's eval rows.

Timing: the device runs asynchronously. The warmup ends in a
``torch.cuda.synchronize()``; in the timed loop each dispatch's metrics are
read two dispatches later through utils/pipeline.py, whose read-arrival
intervals are the step times (a K-step dispatch's interval split K ways).
``compile_s`` is the host time of the first dispatch call and
``dispatch_overhead_s`` the mean host time of a timed one.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import faults as faults_lib
from kf_benchmarks_tpu_torch import learning_rate
from kf_benchmarks_tpu_torch import metrics as metrics_lib
from kf_benchmarks_tpu_torch import observability
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import telemetry
from kf_benchmarks_tpu_torch import tracing
from kf_benchmarks_tpu_torch import train_step as train_step_lib
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.analysis import audit
from kf_benchmarks_tpu_torch.analysis import autotune
from kf_benchmarks_tpu_torch.analysis import baseline
from kf_benchmarks_tpu_torch.data import datasets
from kf_benchmarks_tpu_torch.data import device_feed
from kf_benchmarks_tpu_torch.data import preprocessing
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model as model_lib
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.ops import _build
from kf_benchmarks_tpu_torch.ops import conv_bn
from kf_benchmarks_tpu_torch.ops import flash_attention
from kf_benchmarks_tpu_torch.ops import graphs
from kf_benchmarks_tpu_torch.ops import overlap
from kf_benchmarks_tpu_torch.ops import sharded
from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.parallel import strategies
from kf_benchmarks_tpu_torch.utils import log as log_util
from kf_benchmarks_tpu_torch.utils import pipeline as pipeline_lib

log_fn = log_util.log_fn


def kernel_launches() -> Dict[str, int]:
  """Launch counts of every hand-written kernel, by name."""
  return {**conv_bn.LAUNCHES, **flash_attention.LAUNCHES}


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def compute_eval_step_set(params, global_batch_size: int,
                          num_train_examples: int, num_batches: int,
                          start_step: int = 0, start_examples: int = 0):
  """Training steps after which mid-training eval runs, from the
  epoch-based and explicit-list schedules (the JAX package's
  benchmark.py:102-153; the every-n-steps cadence is checked in the loop).
  ``start_step``/``start_examples`` re-anchor the epoch-to-step mapping
  after an adaptive-batch rebuild changes the global batch mid-run."""
  steps = set()

  def epoch_to_step(e):
    remaining = int(e * num_train_examples) - start_examples
    return (start_step +
            (remaining + global_batch_size - 1) // global_batch_size)

  if params.eval_during_training_every_n_epochs:
    n = float(params.eval_during_training_every_n_epochs)
    num_epochs = ((start_examples +
                   (num_batches - start_step) * global_batch_size) /
                  max(num_train_examples, 1))
    # The run's last epoch boundary is included when it lands on one.
    epochs = [e for e in np.arange(n, num_epochs + 1e-9, n)
              if e * num_train_examples > start_examples]
    steps |= {epoch_to_step(e) for e in epochs}
  if params.eval_during_training_at_specified_steps:
    try:
      steps |= set(
          map(int, params.eval_during_training_at_specified_steps))
    except ValueError:
      raise validation.ParamError(
          "eval_during_training_at_specified_steps value of "
          f"{params.eval_during_training_at_specified_steps} cannot be "
          "converted to a list of integers (ref :1457-1463)")
  if params.eval_during_training_at_specified_epochs:
    try:
      epochs = [float(e)
                for e in params.eval_during_training_at_specified_epochs]
    except ValueError:
      raise validation.ParamError(
          "eval_during_training_at_specified_epochs value of "
          f"{params.eval_during_training_at_specified_epochs} cannot be "
          "converted to a list of floats (ref :1465-1476)")
    steps |= {epoch_to_step(e) for e in epochs
              if e * num_train_examples > start_examples}
  return steps


def dispatch_len(k: int, done_steps: int, num_batches: int,
                 event_due) -> int:
  """Length of the next dispatch: up to K steps, stopping at the run's end
  and BEFORE any step-keyed event strictly inside the window, so
  checkpoints, eval and elastic checks keep exact K = 1 step semantics
  (the JAX package's _dispatch_len, benchmark.py:1553-1565)."""
  n = min(k, num_batches - done_steps)
  for d in range(1, n):
    if event_due(done_steps + d):
      return d
  return n


def feeder_prefetch(params) -> int:
  """Host->device prefetch depth in batches: --input_prefetch_depth when
  set, else the deeper of --datasets_prefetch_buffer_size and
  --batch_group_size (the JAX package's feeder_prefetch,
  benchmark.py:155-165)."""
  if params.input_prefetch_depth:
    return int(params.input_prefetch_depth)
  return max(params.datasets_prefetch_buffer_size or 1,
             params.batch_group_size or 1)


class RealInput:
  """The train loop's cursor over the real-data stream: one batch a step
  (K = 1), or the slots of the feeder's staged (k, B, ...) chunks (K > 1),
  so that every step reads the next batch of one stream at every K. The
  current batch is the one the next step reads (mid-training eval scores
  it, as the JAX package does)."""

  def __init__(self, next_fn, chunked: bool):
    self._next = next_fn
    self.chunked = chunked
    self.images, self.labels = next_fn()
    self.cursor = 0

  def whole_chunk(self, k: int) -> bool:
    """Whether the next ``k`` steps are one whole staged chunk."""
    return (self.chunked and self.cursor == 0 and
            self.images.shape[0] == k)

  def current(self):
    if not self.chunked:
      return self.images, self.labels
    return self.images[self.cursor], train_step_lib.tree_map(
        lambda t: t[self.cursor], self.labels)

  def advance(self, n: int) -> None:
    if not self.chunked:
      self.images, self.labels = self._next()
      return
    self.cursor += n
    if self.cursor >= self.images.shape[0]:
      self.images, self.labels = self._next()
      self.cursor = 0


def accuracy_line(top1: float, top5: float, examples: int) -> str:
  return "Accuracy @ 1 = %.4f Accuracy @ 5 = %.4f [%d examples]" % (
      top1, top5, examples)


def refuse_restart_target(params, world: int) -> Optional[str]:
  """Why the run's flags do not run at ``world`` workers, or None: the
  startup cross-flag rules (validation.py) at the polled target, with the
  worker list cut to it (JAX benchmark.py:1778-1795). A target is known
  only when it is polled, so this is where a restart is refused: under
  --shard_optimizer_state every world re-slices the saved shard stacks
  exactly (checkpoint._reshard), and the rules that can refuse are the
  ones that count workers (--hierarchical_copy needs two)."""
  hosts = list(params.worker_hosts or [])
  check = (params._replace(worker_hosts=hosts[:world]) if hosts
           else params._replace(num_devices=world))
  try:
    validation.validate_cross_flags(check)
  except validation.ParamError as e:
    return str(e)
  return None


class BenchmarkCNN:
  """Benchmark runner for one validated Params."""

  def __init__(self, params):
    params_lib.validate_params(params)
    validation.validate_cross_flags(params)
    # --autotuned_config: the table's knobs over the flag values, before
    # anything reads them (JAX benchmark.py:281-290); the provenance goes
    # into the stats and the run record.
    params, self.tuned_provenance = autotune.apply_tuned_config(
        params, log_fn=lambda s: log_fn(s))
    if self.tuned_provenance is not None:
      validation.validate_cross_flags(params)
    if params.adaptive_batch_size and not params.track_grad_noise_scale:
      # The adaptive-batch policy keys on the measured noise scale.
      params = params._replace(track_grad_noise_scale=True)
    self.world_size = mesh.world_size()
    self.device = mesh.rank_device(params.device, mesh.local_rank())
    self.strategy = strategies.get_strategy(params)
    # --health_stats resolved once against the strategy, so the step and
    # the recorder see one decision (JAX benchmark.py:419-427).
    health, self.health_note = telemetry.resolve_health_stats(
        params, self.strategy)
    params = params._replace(health_stats=health)
    self.params = params
    self.run_id = tracing.resolve_run_id()
    # The faults fire at dispatch boundaries; the planner keeps a K-step
    # dispatch from crossing one (JAX benchmark.py:434-440).
    self.faults = faults_lib.FaultInjector.from_params(
        params, rank=mesh.rank(), log_fn=lambda s: log_fn(s))
    # --use_synthetic_gpu_images keeps the synthetic batch even with a
    # --data_dir (JAX benchmark.py:373-378). The dataset picks the model
    # map and the classes: ImageNet's 1001, CIFAR-10's 10.
    self.dataset = datasets.create_dataset(
        None if params.use_synthetic_gpu_images else params.data_dir,
        params.data_name)
    self.nclass = self.dataset.num_classes
    self.synthetic = self.dataset.use_synthetic_gpu_inputs()
    self._feeder = None
    self.preprocessor = None  # the real-data input stream's, once opened
    self.model = model_config.get_model_config(params.model, params,
                                               self.dataset.name)
    if params.batch_size:
      self.model.set_batch_size(params.batch_size)
    self.batch_size = self.model.get_batch_size()
    self.num_batches = self._get_num_batches()
    self.num_grad_accum = int(params.num_grad_accum or 1)
    validation.check_grad_accum_divides(self.num_grad_accum, self.batch_size,
                                        self.model.get_name())
    # K steps a dispatch, no more than the run (JAX benchmark.py:445-451).
    self.steps_per_dispatch = max(1, min(int(params.steps_per_dispatch or 1),
                                         self.num_batches))
    self.eval_step_set = compute_eval_step_set(
        params, self.batch_size * self.world_size,
        datasets.num_examples_per_epoch("train"), self.num_batches)
    self.num_warmup_batches = (params.num_warmup_batches
                               if params.num_warmup_batches is not None
                               else 10)
    self.display_every = params.display_every
    self.compute_dtype = torch.bfloat16 if params.use_fp16 else torch.float32
    # --fp16_vars stores the parameters (and so the optimizer state) in the
    # compute dtype, bf16 (JAX benchmark.py:461-467).
    self.param_dtype = (self.compute_dtype if params.fp16_vars
                        else torch.float32)
    # The synthetic batch's generation: 0 at start, +1 at each in-process
    # rebuild, carried by the checkpoints.
    self.input_incarnation = 0
    self.checkpoint_save_s = []
    self._saved = None  # (global step, incarnation) last written
    self.checkpoint_restore_s = None

  def _get_num_batches(self) -> int:
    """--num_batches, or --num_epochs of ImageNet at the global batch, or
    100 (the JAX package's _get_num_batches, benchmark.py:469-478)."""
    p = self.params
    if p.num_batches is not None:
      return p.num_batches
    if p.num_epochs is not None:
      per_epoch = datasets.num_examples_per_epoch("train")
      return int(math.ceil(p.num_epochs * per_epoch /
                           (self.batch_size * self.world_size)))
    return 100

  def _num_eval_batches_from_epochs(self) -> Optional[int]:
    """--num_eval_epochs of the ImageNet validation set at the global
    batch (benchmark.py:480-490 of the JAX package)."""
    p = self.params
    if p.num_eval_epochs is None:
      return None
    per_epoch = datasets.num_examples_per_epoch("validation")
    return int(math.ceil(p.num_eval_epochs * per_epoch /
                         (self.batch_size * self.world_size)))

  def print_info(self) -> None:
    p = self.params
    device_name = (torch.cuda.get_device_name(self.device)
                   if self.device.type == "cuda" else "cpu")
    log_fn("TensorFlow:   n/a (kf_benchmarks_tpu_torch, PyTorch %s)" %
           torch.__version__)
    log_fn("Model:       %s" % self.model.get_name())
    log_fn("Dataset:     %s (%s)" % (
        (self.model.data_name, "synthetic") if self.synthetic else
        (self.dataset.name, self.dataset.data_dir)))
    log_fn("Mode:        %s" % ("forward-only" if p.forward_only else
                                   "evaluation" if p.eval else "training"))
    log_fn("Batch size:  %d global" % (self.batch_size * self.world_size))
    log_fn("             %d per device" % self.batch_size)
    log_fn("Num batches: %d" % self.num_batches)
    log_fn("Num devices: %d (%s: %s)" % (self.world_size, p.device,
                                         device_name))
    log_fn("Data format: %s" % p.data_format)
    log_fn("Precision:   %s (params: %s)" % (
        str(self.compute_dtype).replace("torch.", ""),
        str(self.param_dtype).replace("torch.", "")))
    log_fn("Optimizer:   %s" % p.optimizer)
    log_fn("Variables:   %s" % p.variable_update)
    if p.variable_update == "kungfu":
      log_fn("KungFu:      %s" % p.kungfu_option)
    log_fn("==========")
    for note in validation.noop_parity_notes(p):
      log_fn(note)

  def _make_module(self):
    """(module, generator): the model's module made on the rank's device
    from --tf_random_seed, and the generator it drew from, which the
    synthetic batch continues."""
    gen = torch.Generator(device=self.device).manual_seed(
        self.params.tf_random_seed)
    with torch.device(self.device):
      module = model_lib.cast_params(
          self.model.make_module(self.nclass, self.compute_dtype,
                                 generator=gen), self.param_dtype)
    if isinstance(module, builder.SeededDropout):
      # NASNet's drop-path schedule runs over the resolved run length (JAX
      # benchmark.py:552, train_step.py:339-346).
      module.total_steps = self.num_batches
    return module, gen

  def _synthetic_batch(self, gen: torch.Generator):
    """The synthetic batch of the current input incarnation: incarnation
    0 continues ``gen``, incarnation k > 0 comes from a generator seeded
    --tf_random_seed + 7919 k (the JAX package folds k into its data
    key)."""
    if self.input_incarnation:
      gen = torch.Generator(device=self.device).manual_seed(
          self.params.tf_random_seed + 7919 * self.input_incarnation)
    return self.model.get_synthetic_inputs(gen, self.nclass, self.device)

  def build(self, snapshot: Optional[Dict] = None):
    """(module, step, images, labels), all made from --tf_random_seed on
    the rank's device, the same on every rank. The step is the train step,
    or under --forward_only the evaluation step (no optimizer). The state
    then comes from ``snapshot`` (a checkpoint.savable_state) if one is
    given, else from --train_dir's newest readable checkpoint if there is
    one (the global step, the weights and batch-norm averages, the
    optimizer's buffers, the train step's counters, the input
    incarnation; the weights and averages alone under --forward_only); in
    a process group the weights then go through the strategy's
    ``broadcast_init``."""
    p = self.params
    module, gen = self._make_module()
    t_restore = None
    if snapshot is None and p.train_dir:
      t_restore = time.time()
      try:
        snapshot, _, _ = checkpoint.load_latest_checkpoint(p.train_dir)
        self.input_incarnation = int(snapshot.get("input_incarnation", 0))
        load_s = time.time() - t_restore
      except checkpoint.CheckpointNotFoundException:
        t_restore = None
    if p.backbone_model_path and snapshot is None:
      self._load_backbone(module)
    if p.forward_only:
      step = train_step_lib.EvalStep(self.model, module)
    else:
      # Under --shard_optimizer_state the optimizer steps on this rank's
      # shards (and under --shard_params they become the weights' storage).
      sharding = sharded.build(p, module, self.num_grad_accum)
      opt = optimizers.get_optimizer(
          p, module.parameters() if sharding is None else sharding.shards)
      lr_fn = learning_rate.make_learning_rate_fn(
          p, self.model, learning_rate.effective_batch_size(
              self.batch_size, self.world_size, self.strategy.cross_replica),
          datasets.num_examples_per_epoch("train"))
      loss_scale, auto_loss_scale = train_step_lib.loss_scale_settings(p)
      step = train_step_lib.TrainStep(
          self.model, module, opt, lr_fn, p.weight_decay,
          strategy=self.strategy, track_noise_scale=p.track_grad_noise_scale,
          gradient_clip=p.gradient_clip, loss_scale=loss_scale,
          auto_loss_scale=auto_loss_scale,
          inc_loss_scale_every_n=p.fp16_inc_loss_scale_every_n,
          print_accuracy=p.print_training_accuracy,
          single_l2_loss_op=p.single_l2_loss_op,
          num_grad_accum=self.num_grad_accum, sharding=sharding,
          overlap=overlap.build(p), health_stats=bool(p.health_stats),
          staged_vars=p.staged_vars,
          relaxed=p.variable_consistency == "relaxed")
    restored_step = None
    if t_restore is not None:
      t_restore = time.time() - load_s  # the load and the restore alone
    if snapshot is not None:
      if p.forward_only:
        restored_step = checkpoint.restore_model(module, snapshot)
      else:
        step.global_step = restored_step = checkpoint.restore_state(
            module, step.optimizer, snapshot, step.sharding)
        # The resumed shards re-verified against this world (a ZeRO
        # rescale re-slices them; JAX benchmark.py's seam check).
        problems = audit.check_resumed_state(step, self.world_size)
        if problems:
          raise RuntimeError("resumed state breaks its contract: "
                             + "; ".join(problems))
        checkpoint.reseed_staged(step.staged, module)
        step.restore_counters(snapshot)
      _sync(self.device)
    if t_restore is not None:
      self.checkpoint_restore_s = time.time() - t_restore
      trace = tracing.active()
      trace.add_span("checkpoint", "restore",
                     trace.now() - self.checkpoint_restore_s,
                     self.checkpoint_restore_s,
                     {"global_step": restored_step})
      log_fn(f"Restored checkpoint at global step {restored_step} in "
             f"{self.checkpoint_restore_s:.3f} s")
      if self.input_incarnation:
        log_fn(f"Resumed input stream at incarnation "
               f"{self.input_incarnation}")
    images, labels = (self._synthetic_batch(gen) if self.synthetic
                      else (None, None))
    if mesh.is_distributed():
      with torch.no_grad():
        self.strategy.broadcast_init(
            [q.detach() for q in module.parameters()])
    return module, step, images, labels

  def _load_backbone(self, module) -> None:
    """--backbone_model_path: the matching variables of a checkpoint of
    the port, before training (skipped on resume, whose state is further
    trained; JAX benchmark.py:1115-1127)."""
    path = self.params.backbone_model_path
    n = checkpoint.restore_backbone(module, path)
    if not n:
      raise ValueError(f"--backbone_model_path={path} matched no variables "
                       "of this model (wrong checkpoint?)")
    log_fn(f"Loaded {n} backbone tensors from {path}")

  def _save_checkpoint(self, module, step, incarnation_bump: int = 0
                       ) -> None:
    """The one checkpoint write: rank 0's state at the step's global step,
    with the input incarnation a resumed run must reopen at
    (``incarnation_bump`` 1 at an in-process rebuild, whose resume point is
    the new batch). A state already written is not written again (a
    --save_model_steps save on the last step, then the final one)."""
    key = (step.global_step, self.input_incarnation + incarnation_bump)
    if key == self._saved:
      return
    self._saved = key
    _sync(self.device)
    t0 = time.time()
    checkpoint.save_checkpoint(
        self.params.train_dir,
        checkpoint.savable_state(module, step.optimizer, step.global_step,
                                 self.input_incarnation + incarnation_bump,
                                 step.counters(), step.sharding),
        self.params.max_ckpts_to_keep)
    dur = time.time() - t0
    self.checkpoint_save_s.append(dur)
    # The one place a save's wall enters the run trace and the registry.
    trace = tracing.active()
    trace.add_span("checkpoint", "save", trace.now() - dur, dur,
                   {"incarnation_bump": incarnation_bump})
    trace.add_sample("checkpoint_save", dur)
    metrics_lib.active().observe("checkpoint_save_s", dur)
    log_fn(f"Saved checkpoint at global step {step.global_step} in "
           f"{self.checkpoint_save_s[-1]:.3f} s")

  # -- the real-data input stream ------------------------------------------

  def _open_input(self, subset: str, chunk: int = 1):
    """``next`` of a fresh input stream, closing the previous one: the
    preprocessor of --data_dir's dataset through a DeviceFeeder (the JAX
    package's _input_iterator / _make_feeder, benchmark.py:576-668). Each
    rank reads its own stream: seed --tf_random_seed + rank + 7919 x the
    input incarnation, shift_ratio rank / world (JAX :620-646). Training
    streams stage ``chunk`` batches a fetch; --eval and --forward_only read
    with eval-mode preprocessing (JAX :626)."""
    p = self.params
    self._stop_input()
    cls = self.dataset.get_input_preprocessor(p.input_preprocessor)
    # The process pool yields views of its ring, which the feeder copies
    # into pinned memory at once: a chunk's K batches within K + 2 buffers.
    pool = ({"num_buffers": chunk + 2}
            if issubclass(cls, preprocessing.MultiprocessImagePreprocessor)
            else {})
    pre = cls(
        batch_size=self.batch_size,
        output_shape=tuple(self.model.get_input_shapes(subset)[0][1:]),
        train=(subset == "train") and not (p.eval or p.forward_only),
        distortions=bool(p.distortions),
        resize_method=p.resize_method,
        seed=((p.tf_random_seed or 301) + mesh.rank() +
              7919 * self.input_incarnation),
        shift_ratio=mesh.rank() / max(self.world_size, 1),
        num_threads=(p.datasets_num_private_threads or p.num_intra_threads
                     or p.input_preprocessing_parallelism or 8),
        repeat_cached_sample=bool(p.datasets_repeat_cached_sample),
        use_caching=bool(p.datasets_use_caching), **pool)
    if hasattr(pre, "max_label_length"):
      # Speech: the labels pad to the model's static label slot (JAX
      # benchmark.py:643-646).
      pre.max_label_length = getattr(self.model, "max_label_length",
                                     pre.max_label_length)
    self.preprocessor = pre
    self._feeder = device_feed.DeviceFeeder(
        pre.minibatches(self.dataset, subset), self.device,
        prefetch=max(feeder_prefetch(p), chunk), chunk=chunk,
        normalization=pre.NORMALIZATION, dtype=self.compute_dtype)
    return self._feeder.__next__

  def _stop_input(self) -> None:
    if self._feeder is not None:
      self._feeder.stop()

  def _open_train_input(self) -> Optional[RealInput]:
    """The train loop's real-data cursor (None for the synthetic batch),
    at the current incarnation."""
    if self.synthetic:
      return None
    chunked = self.steps_per_dispatch > 1 and not self.params.forward_only
    return RealInput(self._open_input(
        "train", self.steps_per_dispatch if chunked else 1), chunked)

  def _rebuild(self, module, step, batch_per_device: int):
    """An adaptive-batch change in this process (the JAX package's
    _reshape_topology, :948-1010): the state goes through the
    checkpoint's state-dict form into a module, step and synthetic batch
    built at the new per-device batch (the next input incarnation)."""
    snapshot = checkpoint.savable_state(module, step.optimizer,
                                        step.global_step,
                                        self.input_incarnation,
                                        step.counters(), step.sharding)
    self.input_incarnation += 1
    self.batch_size = batch_per_device
    self.model.set_batch_size(batch_per_device)
    return self.build(snapshot=snapshot)

  def run(self) -> Dict[str, Any]:
    self.print_info()
    if self.params.eval:
      return self._run_eval()
    if self.params.forward_only and self.params.aot_load_path:
      return self._benchmark_aot_serving()
    return self._benchmark_train()

  # -- the frozen forward --------------------------------------------------

  def _export_forward(self, module) -> None:
    """--aot_save_path: the built module's frozen forward, at --trt_mode's
    precision (JAX benchmark.py:1160-1184)."""
    from kf_benchmarks_tpu_torch import aot
    p = self.params
    trt_mode = (p.trt_mode or "").upper()
    export_dtype = {"FP32": torch.float32, "FP16": torch.bfloat16,
                    "INT8": torch.bfloat16}.get(trt_mode, self.compute_dtype)
    nbytes = aot.export_forward(
        self.model, module.state_dict(), self.batch_size, p.aot_save_path,
        nclass=self.nclass, dtype=export_dtype, quantize=trt_mode == "INT8",
        fingerprint=baseline.config_fingerprint_key(p._asdict(),
                                                    "aot_forward"),
        device=self.device)
    log_fn(f"Exported frozen forward program to {p.aot_save_path} "
           f"({nbytes} bytes"
           + (f", {trt_mode} serving precision" if trt_mode else "") + ")")

  def _benchmark_aot_serving(self) -> Dict[str, Any]:
    """Time a frozen forward program loaded in this process (JAX
    benchmark.py:699-775): the load checks the sidecar's mode against
    --trt_mode and the program's input against the batch, then warmup and
    the timed loop, read through the lag-2 metrics pipeline. On the card
    the program runs as one CUDA graph capture replayed each step. The
    program returns logits only, so the loss column carries the mean
    logit."""
    from kf_benchmarks_tpu_torch import aot
    p = self.params
    shape = tuple(self.model.get_input_shapes("eval")[0])
    trt_mode = (p.trt_mode or "").upper()
    launches_before = kernel_launches()
    serving_fn = aot.load_forward(
        p.aot_load_path, expect_batch=self.batch_size, expect_shape=shape,
        expect_quantize="int8" if trt_mode == "INT8" else None,
        device=self.device)
    log_fn(f"Loaded frozen forward program from {p.aot_load_path}")
    gen = torch.Generator(device=self.device).manual_seed(
        p.tf_random_seed or 0)
    images = torch.rand(shape, generator=gen, device=self.device)
    log_fn("Running warm up")
    t0 = time.time()
    with torch.no_grad():
      step = lambda: serving_fn(images)
      warm = lambda: [step() for _ in range(max(self.num_warmup_batches, 1))]
      if self.device.type == "cuda":
        # The warmup runs on a side stream, as a capture wants its first
        # uses (kernel loads, workspaces) made there.
        graphs.on_side_stream(warm)
        graph = graphs.Graph(step)
        log_fn("Captured the loaded program as a CUDA graph")

        def step():
          graph.replay()
          return graph.outputs
      else:
        warm()
      _sync(self.device)
      log_fn("Warmup (load + %d steps): %.1f s" %
             (max(self.num_warmup_batches, 1), time.time() - t0))
      log_fn("Step\tImg/sec\ttotal_loss")
      step_times = []
      last_display_len = 0
      pipe = pipeline_lib.MetricsPipeline(lag=2)

      def handle(done):
        nonlocal last_display_len
        step_times.append(done.interval)
        i1 = done.index
        if i1 % self.display_every == 0 or i1 == self.num_batches:
          log_fn(log_util.format_step_line(
              i1, self.batch_size, step_times[last_display_len:],
              float(done.metrics["mean_logit"])))
          last_display_len = len(step_times)

      loop_start = time.time()
      pipe.reset_clock()
      for i in range(self.num_batches):
        out = step()
        for done in pipe.push(i + 1, {"mean_logit": out.float().mean()}):
          handle(done)
      for done in pipe.flush():
        handle(done)
    total_time = time.time() - loop_start
    images_per_sec = (self.num_batches * self.batch_size /
                      max(total_time, 1e-9))
    log_fn("-" * 64)
    log_fn(log_util.format_total_line(images_per_sec))
    log_fn("-" * 64)
    launches = {k: v - launches_before[k]
                for k, v in kernel_launches().items()}
    if any(launches.values()):
      log_fn("Kernel launches: " + ", ".join(
          f"{k} {v}" for k, v in launches.items() if v))
    return {
        "num_workers": 1,
        "num_steps": self.num_batches,
        "average_wall_time": total_time / max(self.num_batches, 1),
        "images_per_sec": images_per_sec,
        "aot_load_path": p.aot_load_path,
        "device": str(self.device),
        "kernel_launches": launches,
        "steps_run": max(self.num_warmup_batches, 1) + self.num_batches,
        "last_average_loss": float(out.float().mean()),
    }

  # -- evaluation ---------------------------------------------------------

  def _eval_once(self, eval_step, images, labels, next_batch=None,
                 global_step: int = 0) -> Dict[str, Any]:
    """--num_eval_batches (or --num_eval_epochs, else --num_batches)
    evaluations, averaged (the JAX package's _eval_once,
    benchmark.py:2049-2083): of the synthetic batch, or of the batches of
    a one-pass validation stream (``next_batch``), which stops at its end;
    the mean loss is logged beside the accuracies."""
    p = self.params
    num_eval = (p.num_eval_batches or self._num_eval_batches_from_epochs()
                or self.num_batches)
    launches_before = kernel_launches()
    start = time.time()
    accs = []
    for i in range(num_eval):
      accs.append(eval_step(images, labels))
      if next_batch is not None and i + 1 < num_eval:
        try:
          images, labels = next_batch()
        except StopIteration:
          break
    top1 = sum(float(a["top_1_accuracy"]) for a in accs) / len(accs)
    top5 = sum(float(a["top_5_accuracy"]) for a in accs) / len(accs)
    loss = sum(float(a["base_loss"]) for a in accs) / len(accs)
    elapsed = time.time() - start
    examples = len(accs) * self.batch_size * self.world_size
    log_fn(accuracy_line(top1, top5, examples))
    log_fn("Eval loss = %.6f [%d examples]" % (loss, examples))
    launches = {k: v - launches_before[k]
                for k, v in kernel_launches().items()}
    if any(launches.values()):
      log_fn("Kernel launches: " + ", ".join(
          f"{k} {v}" for k, v in launches.items() if v))
    eval_ips = examples / max(elapsed, 1e-9)
    if p.eval and p.eval_dir:
      # The eval summary stream (ref: --eval_dir, benchmark_cnn.py:585-586,
      # :1770-1772).
      observability.SummaryWriter(p.eval_dir, 1).write_scalars(
          global_step, {"eval_top_1_accuracy": top1,
                        "eval_top_5_accuracy": top5,
                        "eval_images_per_sec": eval_ips})
    if p.benchmark_log_dir:
      # The eval rows (ref: benchmark_cnn.py:1915-1922), at the scored
      # checkpoint's step.
      logger = observability.BenchmarkLogger(p.benchmark_log_dir,
                                             self._platform())
      logger.log_metric("eval_top_1_accuracy", top1, global_step=global_step)
      logger.log_metric("eval_top_5_accuracy", top5, global_step=global_step)
      logger.log_metric("eval_images_per_sec", eval_ips, unit="examples/sec",
                        global_step=global_step)
    return {"top_1_accuracy": top1, "top_5_accuracy": top5,
            "base_loss": loss,
            "eval_images_per_sec": eval_ips,
            "num_eval_batches": len(accs), "kernel_launches": launches}

  def _run_eval(self) -> Dict[str, Any]:
    """Evaluation (JAX benchmark.py:2085-2131): without --train_dir one
    pass over the seeded model; with it, every new checkpoint there in
    turn, until 10 polls in a row find none (one poll when
    --eval_interval_secs is 0). Every rank reads the same files and
    evaluates its own copy of the batch; the accuracies are the mean
    over the ranks."""
    module, gen = self._make_module()
    if (hasattr(self.model, "evaluate_real_data") and
        not self.synthetic):
      return self._eval_detection(module)
    images, labels = (self._synthetic_batch(gen) if self.synthetic
                      else (None, None))
    eval_step = train_step_lib.EvalStep(self.model, module)
    if not self.params.train_dir:
      return self._eval_pass(eval_step, images, labels)
    return self._eval_poll_loop(module, eval_step, images, labels)

  def _eval_detection(self, module) -> Dict[str, Any]:
    """A detection model's evaluation on records (JAX benchmark.py:
    2121-2136): the newest checkpoint of --train_dir if there is one, then
    the model's own pass over the validation records, which accumulates
    its predictions per image and scores them (COCO mAP)."""
    p = self.params
    if p.train_dir:
      try:
        snapshot, _, _ = checkpoint.load_latest_checkpoint(p.train_dir)
        checkpoint.restore_model(module, snapshot)
      except checkpoint.CheckpointNotFoundException:
        pass
    start = time.time()
    results = self.model.evaluate_real_data(
        module, p, self.dataset, self.device, self.compute_dtype,
        num_batches=p.num_eval_batches)
    n = results.get("num_eval_images", 0)
    results["eval_images_per_sec"] = n / max(time.time() - start, 1e-9)
    if "COCO/AP" not in results:
      log_fn("COCO mAP: not computed (%s) [%d examples]" % (
          results.get("coco_map_note", "no note"), n))
    else:
      log_fn("COCO mAP = %.4f, AP50 = %.4f (%s evaluator) [%d examples]" % (
          results["COCO/AP"], results["COCO/AP50"],
          results.get("coco_evaluator"), n))
    return results

  def _eval_pass(self, eval_step, images, labels,
                 global_step: int = 0) -> Dict[str, Any]:
    """One scoring: the synthetic batch, or a fresh one-pass validation
    stream, so that every checkpoint is scored on the same data (JAX
    benchmark.py:2133-2149)."""
    if self.synthetic:
      return self._eval_once(eval_step, images, labels,
                             global_step=global_step)
    next_batch = self._open_input("validation")
    try:
      try:
        images, labels = next_batch()
      except StopIteration:
        log_fn("Validation stream yielded no batches (fewer examples "
               "than the batch size?)")
        return {"top_1_accuracy": 0.0, "top_5_accuracy": 0.0,
                "base_loss": float("nan"), "eval_images_per_sec": 0.0,
                "num_eval_batches": 0, "kernel_launches": {}}
      return self._eval_once(eval_step, images, labels, next_batch,
                             global_step=global_step)
    finally:
      self._stop_input()

  def _eval_poll_loop(self, module, eval_step, images, labels):
    """The JAX package's _eval_poll_loop (benchmark.py:2151-2211): a
    checkpoint newer than the last one scored is restored (weights and
    averages only) and scored; a torn newest file is skipped; after 10
    stale polls, or after one poll without --eval_interval_secs, the last
    results are returned (None if nothing was scored)."""
    p = self.params
    last_evaluated_step = -1
    results = None
    stale_polls = 0
    max_stale_polls = 10
    while True:
      try:
        _, ckpt_step = checkpoint.latest_checkpoint(p.train_dir)
      except checkpoint.CheckpointNotFoundException:
        if not p.eval_interval_secs:
          raise
        stale_polls += 1
        if stale_polls >= max_stale_polls:
          return results
        time.sleep(p.eval_interval_secs)
        continue
      if ckpt_step > last_evaluated_step:
        try:
          snapshot, _, ckpt_step = checkpoint.load_latest_checkpoint(
              p.train_dir)
        except checkpoint.CheckpointNotFoundException:
          snapshot = None
        if snapshot is None or ckpt_step <= last_evaluated_step:
          # Pruned between the listing and the read, or torn with nothing
          # newer behind it: not there yet.
          stale_polls += 1
          if stale_polls >= max_stale_polls:
            return results
          time.sleep(p.eval_interval_secs or 1)
          continue
        checkpoint.restore_model(module, snapshot)
        log_fn(f"Evaluating checkpoint at global step {ckpt_step}")
        results = self._eval_pass(eval_step, images, labels, ckpt_step)
        results["global_step"] = ckpt_step
        last_evaluated_step = ckpt_step
        stale_polls = 0
      else:
        stale_polls += 1
      if not p.eval_interval_secs or stale_polls >= max_stale_polls:
        return results
      time.sleep(p.eval_interval_secs)

  def _elastic_setup(self):
    """(noise EMA, adaptive-batch policy, resize controller), each None
    when its flag is off (JAX benchmark.py:1238-1260)."""
    p = self.params
    noise_ema = elastic.NoiseScaleEMA() if p.track_grad_noise_scale else None
    if noise_ema is not None and self.world_size < 2:
      # The estimator contrasts each rank's gradients with their mean over
      # the ranks; with one rank there is no contrast.
      log_fn("track_grad_noise_scale: needs >= 2 devices, no estimates "
             "will be produced (adaptive_batch_size will hold steady)")
    batch_policy = (elastic.AdaptiveBatchPolicy(p.adaptive_batch_min,
                                                p.adaptive_batch_max)
                    if p.adaptive_batch_size else None)
    controller = None
    if p.elastic:
      # One card a process: the controller clamps every target to 1.
      controller = elastic.ElasticController.from_env(max_devices=1)
      if controller is None:
        log_fn("elastic: no coordination service in env (KFCOORD_*); "
               "resize polling disabled")
    return noise_ema, batch_policy, controller

  def _restart_target(self, controller, i: int) -> Optional[int]:
    """Polls the coordinator after timed step ``i``; the world size the
    job agreed to restart at once step ``i`` reaches the scheduled step,
    else None (JAX benchmark.py:1677-1735). A process drives one card, so
    a RESIZE to another world size is always a checkpoint-restart: the
    first worker to see it schedules the restart two polls ahead in the
    coordinator's store, so every worker restarts at the same step."""
    p = self.params
    if controller.poll() is not None:
      action, value = elastic.plan_resize(
          controller.last_raw_target, procs=self.world_size, capacity=1,
          max_procs=len(p.worker_hosts or []) or 1)
      refusal = (refuse_restart_target(p, value) if action == "restart"
                 else None)
      if refusal:
        # The target is only known now: it is refused here, with the
        # reason, and the world stays (JAX benchmark.py:1770-1795).
        log_fn(f"Elastic restart to {value} worker(s) rejected: "
               f"{refusal}; keeping the current world")
      elif action == "restart" and controller.scheduled_restart() is None:
        controller.schedule_restart(i + 2 * p.elastic_check_every_n_steps,
                                    value)
    sched = controller.scheduled_restart()
    # A schedule whose target is this world is already satisfied (a stale
    # key from before the re-exec).
    if sched is not None and sched[1] != self.world_size and i >= sched[0]:
      return sched[1]
    return None

  def _make_chunk(self, step):
    """The K-step dispatch of ``step`` (None at K = 1, and for the
    forward-only step)."""
    if self.steps_per_dispatch == 1 or self.params.forward_only:
      return None
    return train_step_lib.TrainChunk(step, self.steps_per_dispatch)

  def _benchmark_train(self) -> Dict[str, Any]:
    """The training run inside its sessions (JAX benchmark.py:775-910): the
    run trace (always: its percentiles and ledger ride the stats; spans
    are kept and exported with --trace_events_file), the metric registry
    (always) and its endpoint (--metrics_port, port + rank), the kernels'
    build directory (--compilation_cache_dir) and the telemetry session
    (the flight recorder and watchdog span the build, the warmup and the
    loop). A raise anywhere still tears them down and exports the
    trace."""
    p = self.params
    if self.health_note:
      log_fn(self.health_note)
    rank = mesh.rank()
    # Under kfrun the launcher's world counts every worker of the job.
    world = int(os.environ.get("KFCOORD_WORLD") or 0) or self.world_size
    self._trace = tracing.activate(tracing.RunTrace(
        path=p.trace_events_file, rank=rank, num_ranks=world,
        run_id=self.run_id, chrome_format=bool(p.use_chrome_trace_format),
        log_fn=lambda s: log_fn(s)))
    self._registry = metrics_lib.activate(metrics_lib.MetricRegistry())
    self._registry.set("run_id", self.run_id)
    self._metrics_server = None
    if p.metrics_port:
      port = metrics_lib.resolve_port(p.metrics_port, rank)
      try:
        self._metrics_server = metrics_lib.MetricsServer(
            self._registry, port, healthz_fn=self._healthz_payload)
        log_fn("metrics endpoint: http://127.0.0.1:%d/metrics"
               % self._metrics_server.port)
      except (OSError, OverflowError) as e:
        # A taken port must not cost the run (OverflowError: port + rank
        # past 65535).
        log_fn(f"metrics endpoint: bind to port {port} failed ({e}); "
               "serving disabled for this run")
    # Set (or cleared) before the first launch builds or loads a kernel.
    _build.set_build_root(p.compilation_cache_dir)
    if p.compilation_cache_dir:
      log_fn(f"Kernel build cache: {p.compilation_cache_dir}")
    self._telemetry = None
    try:
      self._telemetry = telemetry.TelemetrySession.create(
          p, rank=rank, log_fn=lambda s: log_fn(s), num_ranks=world,
          run_id=self.run_id)
      return self._train(self._telemetry)
    finally:
      self._stop_input()
      if self._telemetry is not None:
        self._telemetry.close()
        self._telemetry = None
      # The endpoint down, then the sessions, then the export (the
      # per-rank file and rank 0's merge).
      if self._metrics_server is not None:
        self._metrics_server.close()
        self._metrics_server = None
      metrics_lib.deactivate()
      tracing.deactivate()
      try:
        self._trace.export()
      except Exception as e:  # an export failure must not eat the run
        log_fn(f"trace export failed (non-fatal): {e!r}")

  def _healthz_payload(self) -> Dict[str, Any]:
    """The /healthz body (the endpoint's thread calls it): the telemetry
    session's watchdog and recorder state when one is live, a liveness
    ack otherwise."""
    payload: Dict[str, Any] = {"status": "ok", "run_id": self.run_id}
    tele = getattr(self, "_telemetry", None)
    if tele is not None:
      payload.update(tele.healthz())
    return payload

  def _platform(self) -> str:
    return "gpu" if self.device.type == "cuda" else "cpu"

  def _observability_sinks(self, step, images, labels):
    """(benchmark logger, summary writer), each None when its flags are
    off, after the dumps of --graph_file, --tfprof_file and
    --partitioned_graph_file_prefix (JAX benchmark.py:1186-1235). The
    dumps trace and count on fake tensors: nothing runs on the card and no
    state moves."""
    p = self.params
    bench_logger = None
    if p.benchmark_log_dir:
      bench_logger = observability.BenchmarkLogger(p.benchmark_log_dir,
                                                    self._platform())
      bench_logger.log_run_info(p, self.model.get_name(), self.dataset.name,
                                self.world_size, self.batch_size)
    summary_writer = None
    if p.train_dir and p.save_summaries_steps and p.summary_verbosity:
      summary_writer = observability.SummaryWriter(p.train_dir,
                                                   p.summary_verbosity)
    training = not p.forward_only
    if p.graph_file:
      observability.dump_program_text(step, images, labels, p.graph_file,
                                      training=training)
      log_fn(f"Wrote program text to {p.graph_file}")
    if p.tfprof_file:
      report = observability.dump_cost_analysis(
          step, images, labels, p.tfprof_file, device=self.device,
          training=training)
      log_fn(f"Wrote cost analysis to {p.tfprof_file}")
      if "flop_count_error" in report:
        log_fn(f"FLOP count failed: {report['flop_count_error']}")
      else:
        self._step_flops = report["flops"]
        table = observability.dump_per_op_profile(
            report, p.tfprof_file + ".ops.txt")
        for line in table.splitlines():
          log_fn(line)
      log_fn(observability.hbm_breakdown_line(report["memory"]))
    if p.partitioned_graph_file_prefix and training:
      path = p.partitioned_graph_file_prefix + ".txt"
      observability.dump_partitioned_text(step, self.strategy, mesh.rank(),
                                          self.world_size, path)
      log_fn(f"Wrote partitioned plan to {path}")
    return bench_logger, summary_writer

  def _train(self, tele) -> Dict[str, Any]:
    p = self.params
    K = self.steps_per_dispatch
    launches_before = kernel_launches()
    t0 = time.time()
    module, step, images, labels = self.build()
    if p.forward_only and p.aot_save_path:
      self._export_forward(module)
    chunk = self._make_chunk(step)
    # Real data: the stream opens at the incarnation the build resumed.
    real = self._open_train_input()
    noise_ema, batch_policy, controller = self._elastic_setup()
    if (self.num_grad_accum > 1 and
        train_step_lib.batch_stats(module)):
      log_fn(f"Note: --num_grad_accum={self.num_grad_accum} with a "
             "batch-norm model: BN statistics are per-microbatch "
             f"(batch/{self.num_grad_accum}) and running stats update "
             f"{self.num_grad_accum}x per step; not numerically "
             "equivalent to the monolithic step (BN-free models are)")

    trace = tracing.active()
    self._step_flops = None
    bench_logger, summary_writer = self._observability_sinks(
        step, *((images, labels) if real is None else real.current()))

    # Host time of each dispatch call (the call alone, no wait for the
    # device): the first is compile_s -- kernel builds, and under K > 1 the
    # eager warm-up step and the graph capture; the timed ones average to
    # dispatch_overhead_s (JAX benchmark.py:1267-1320, :1965-1975).
    dispatch_stats = {"compile_s": None, "call_times": []}
    # Each program's first call is its compile episode in the ledger,
    # keyed on the program-shape fingerprint (analysis/baseline.py).
    compiled = set()
    label = ("eval_step" if p.forward_only else
             "train_chunk" if chunk is not None else "train_step")
    # --trace_file profiles one dispatch (JAX benchmark.py:1298-1327): the
    # last warmup dispatch, where it is a replay. A chunk's first call
    # captures its graphs (and runs an eager step): with fewer than two
    # warmup dispatches the first timed replay is traced instead.
    q, r = divmod(self.num_warmup_batches, K)
    if chunk is None:
      trace_at = max(q + r - 1, 0)
    else:
      trace_at = q + r - 1 if q + r >= 2 else 1
    traced = {}
    # Each rank profiles into its own file (rank 0's is --trace_file).
    self._trace_path = (tracing.rank_path(p.trace_file, mesh.rank())
                        if p.trace_file else None)
    # What lies at that path already is an earlier run's, never this one's.
    self._stale_traces = observability.list_profile_runs(self._trace_path)
    dispatch_count = [0]
    # Each timed dispatch's issue time, in dispatch order: the device span
    # of a dispatch resolving in handle() carries its own.
    issue_walls = []

    def note_compile(name: str, wall_s: float) -> None:
      compiled.add(name)
      trace.note_compile(
          baseline.config_fingerprint_key(p._asdict(), name), name, wall_s,
          model=self.model.get_name(), num_devices=self.world_size,
          # The kernels were loaded from --compilation_cache_dir, none
          # built in this process.
          cache_hit=bool(p.compilation_cache_dir and
                         _build.loaded_from_cache()))

    def run_dispatch(n: int, timed: bool = False) -> Dict[str, Any]:
      """One dispatch: its issue span, compile_s, the ledger's first
      call, and the one traced dispatch."""
      idx = dispatch_count[0]
      dispatch_count[0] += 1
      replay = chunk is not None and chunk.captured
      with observability.maybe_trace_step(self._trace_path, idx, trace_at,
                                          device=self.device) as traced_now:
        t0 = trace.now()
        metrics, dt = dispatch(n)
        first = label not in compiled
        trace.add_span("dispatch", label, t0, trace.now() - t0,
                       {"step": idx, "first_call": first})
        if first:
          note_compile(label, dt)
        if traced_now:
          traced.update(index=idx, label=label, replay=replay, timed=timed,
                        steps=n)
      if timed:
        issue_walls.append(dt)
      return metrics

    def dispatch(n: int):
      t_call = time.monotonic()
      if chunk is not None:
        if real is None:
          metrics = chunk(images, labels, n)
        else:
          # Real data: the steps read consecutive slots of the staged chunk.
          metrics = chunk(real.images, real.labels, n, offset=real.cursor)
          real.advance(n)
        if n == 1:
          metrics = {k: v[0] for k, v in metrics.items()}
      elif real is None:
        metrics = step(images, labels)
      else:
        metrics = step(*real.current())
        real.advance(1)
      dt = time.monotonic() - t_call
      if dispatch_stats["compile_s"] is None:
        dispatch_stats["compile_s"] = dt
      dispatch_stats["call_times"].append(dt)
      return metrics, dt

    log_fn("Running warm up")
    t0_warm = trace.now()
    # Exactly num_warmup_batches warmup steps at every K: q whole K-step
    # dispatches, then r single steps, so the warmed-up state is the K = 1
    # loop's (JAX benchmark.py:1330-1360).
    for _ in range(q):
      run_dispatch(K)  # on real data a whole staged chunk each
    for _ in range(r):
      run_dispatch(1)
    _sync(self.device)
    trace.add_span("run", "warmup", t0_warm, trace.now() - t0_warm,
                   {"steps": self.num_warmup_batches})
    log_fn("Build + warmup (%d steps): %.1f s" %
           (self.num_warmup_batches, time.time() - t0))
    header = "Step\tImg/sec\ttotal_loss"
    if p.print_training_accuracy:
      header += "\ttop_1_accuracy\ttop_5_accuracy"
    log_fn(header)

    step_train_times = []
    last_display_len = 0
    loss = float("nan")
    images_processed = 0
    aux_time = 0.0
    restart_requested = None
    stopped_early = False
    eval_results = []
    reshape_events = []
    num_dispatches = 0
    losses = []
    chunk_times = []  # the wall of each K-step dispatch
    # The device span of the dispatch resolving in handle(): opened at its
    # first step, closed at its last.
    dispatch_span = {"id": None}

    def handle(done) -> None:
      nonlocal loss, last_display_len
      step_train_times.append(done.interval)
      m = done.metrics
      loss = float(m["total_loss"])
      losses.append(loss)
      # The live lanes the /metrics scrape serves while the run trains.
      registry = metrics_lib.active()
      registry.set("step", start_step + done.index)
      registry.set("loss", loss)
      if "learning_rate" in m:
        registry.set("learning_rate", float(m["learning_rate"]))
      health = telemetry.health_scalars(m)
      for name, value in health.items():
        registry.set(name, value)
      if dispatch_span["id"] is None:
        # The dispatch's device completion is its pipeline arrival
        # interval; its own host issue time rides in the args.
        issue_s = issue_walls.pop(0) if issue_walls else None
        dispatch_span["id"] = trace.add_span(
            "device", "chunk" if done.chunk_len > 1 else "step",
            trace.now() - done.chunk_interval, done.chunk_interval,
            {"steps": done.chunk_len,
             "end_step": start_step + done.index + done.chunk_len - 1
             if not done.chunk_end else start_step + done.index,
             "issue_ms": (round(issue_s * 1e3, 3)
                          if issue_s is not None else None)})
      if done.chunk_end:
        trace.add_sample("chunk_wall", done.chunk_interval)
        registry.observe("chunk_wall_s", done.chunk_interval)
        if done.chunk_len > 1:
          chunk_times.append(done.chunk_interval)
        dispatch_span["id"] = None
      if tele is not None:
        # One recorder row a step; one heartbeat a resolved dispatch, with
        # its wall interval (JAX benchmark.py:1459-1476).
        call_times = dispatch_stats["call_times"]
        tele.record(step=start_step + done.index, loss=loss,
                    lr=m.get("learning_rate"), health=m.get("health"),
                    wall_ms=done.interval * 1e3, chunk_len=done.chunk_len,
                    rtt_ms=call_times[-1] * 1e3 if call_times else None)
        if done.chunk_end:
          tele.beat(done.chunk_interval)
      if noise_ema is not None and "noise_scale_g2" in m:
        noise_ema.update(float(m["noise_scale_g2"]),
                         float(m["noise_scale_s"]))
      i1 = done.index
      if i1 % self.display_every == 0 or i1 == self.num_batches:
        top1 = top5 = None
        if "top_1_accuracy" in m:
          top1 = float(m["top_1_accuracy"])
          top5 = float(m["top_5_accuracy"])
        window = step_train_times[last_display_len:]
        log_fn(log_util.format_step_line(
            i1, self.batch_size * self.world_size, window, loss, top1, top5))
        rate = (self.batch_size * self.world_size /
                max(sum(window) / max(len(window), 1), 1e-9))
        registry.set("step_images_per_sec", rate)
        if bench_logger is not None:
          # Per-step metric rows (ref: benchmark_cnn.py:847-854).
          bench_logger.log_metric("current_examples_per_sec", rate,
                                  unit="examples/sec",
                                  global_step=start_step + i1)
          bench_logger.log_metric("total_loss", loss,
                                  global_step=start_step + i1)
        last_display_len = len(step_train_times)
      if summary_writer is not None and i1 % p.save_summaries_steps == 0:
        scalars = {k: v for k, v in m.items() if np.ndim(v) == 0}
        scalars.update(health)
        summary_writer.write_scalars(start_step + i1, scalars)
        if summary_writer.verbosity >= 2:
          summary_writer.write_histograms(
              start_step + i1, module.named_parameters(), "params")

    # Step-keyed schedule predicates: the same functions feed the dispatch
    # planner and the due flags after each dispatch, so a dispatch never
    # crosses a scheduled step (JAX benchmark.py:1527-1565). The
    # seconds-based checkpoint cadence is checked at dispatch boundaries.
    def save_steps_due(s: int) -> bool:
      return bool(p.train_dir and not p.forward_only and
                  p.save_model_steps and s % p.save_model_steps == 0)

    def eval_due_at(s: int) -> bool:
      return bool((p.eval_during_training_every_n_steps and
                   s % p.eval_during_training_every_n_steps == 0) or
                  s in self.eval_step_set)

    def elastic_due_at(s: int) -> bool:
      return bool((controller is not None or batch_policy is not None)
                  and s % p.elastic_check_every_n_steps == 0 and
                  s < self.num_batches)

    def fault_due(s: int) -> bool:
      return self.faults is not None and self.faults.due(s)

    def event_due(s: int) -> bool:
      return (save_steps_due(s) or eval_due_at(s) or elastic_due_at(s) or
              fault_due(s))

    # Lag-2 pipelined metric reads (utils/pipeline.py): every step's
    # values are read two dispatches later, so the host never waits for
    # the step it just queued.
    pipe = pipeline_lib.MetricsPipeline(lag=2)
    # The global step before the first timed step: the recorder's rows
    # carry global steps (the forward-only step has none).
    start_step = 0 if p.forward_only else step.global_step
    drop_next_poll = False
    dispatch_stats["call_times"].clear()
    issue_walls.clear()
    loop_start = time.time()
    last_save = loop_start
    pipe.reset_clock()
    i = 0
    while i < self.num_batches:
      n = dispatch_len(K, i, self.num_batches, event_due)
      # A whole K-step dispatch; on real data only over one whole staged
      # chunk (JAX benchmark.py:1590-1592).
      if (chunk is not None and n == K and
          (real is None or real.whole_chunk(K))):
        metrics = run_dispatch(K, timed=True)
        i += K
        images_processed += K * self.batch_size * self.world_size
        num_dispatches += 1
        for done in pipe.push(i, metrics, count=K):
          handle(done)
      else:
        # The short remainder before an event, or the end, runs as single
        # steps (one-step dispatches under K > 1).
        for _ in range(n):
          metrics = run_dispatch(1, timed=True)
          i += 1
          images_processed += self.batch_size * self.world_size
          num_dispatches += 1
          for done in pipe.push(i, metrics):
            handle(done)
      now = time.time()
      save_due = save_steps_due(i) or bool(
          p.train_dir and not p.forward_only and p.save_model_secs and
          now - last_save >= p.save_model_secs)
      eval_due = eval_due_at(i)
      elastic_due = elastic_due_at(i)
      faults_due = fault_due(i)
      if not (save_due or eval_due or elastic_due or faults_due):
        continue
      # A sync point: everything in flight is read, and the checkpoint,
      # eval and resize time is kept out of the step times.
      for done in pipe.flush():
        handle(done)
      aux_start = time.time()
      if faults_due:
        # Faults fire first at the boundary (a preemption does not wait
        # for the checkpoint cadence): corrupt_ckpt tears the newest
        # snapshot already on disk, before this boundary's own save; the
        # recorder's row lands before a kill (JAX benchmark.py:1628-1650).
        if tele is not None:
          for f in self.faults.peek_due(i):
            tele.fault_event(f.describe(), start_step + i)
        fired = self.faults.fire_due(i, train_dir=p.train_dir)
        if fired.dropped_message:
          drop_next_poll = True
      if save_due:
        self._save_checkpoint(module, step)
        last_save = time.time()
      if eval_due:
        # Mid-training eval and the early stop (JAX benchmark.py:
        # 1655-1672; ref: benchmark_cnn.py:2310-2324).
        t_eval = trace.now()
        acc = train_step_lib.EvalStep(
            self.model, module, full_params=step.full_params)(
                *(real.current() if real is not None else (images, labels)))
        if "eval_step" not in compiled:
          note_compile("eval_step", trace.now() - t_eval)
        top1 = float(acc["top_1_accuracy"])
        trace.add_span("eval", "mid_train_eval", t_eval,
                       trace.now() - t_eval, {"step": i})
        top5 = float(acc["top_5_accuracy"])
        eval_results.append({"step": i, "top_1_accuracy": top1,
                             "top_5_accuracy": top5})
        log_fn(accuracy_line(top1, top5, self.batch_size * self.world_size))
        if p.stop_at_top_1_accuracy and top1 >= p.stop_at_top_1_accuracy:
          log_fn(f"Stopping early at top-1 accuracy {top1:.4f} "
                 f">= {p.stop_at_top_1_accuracy}")
          stopped_early = True
          aux_time += time.time() - aux_start
          break
      if elastic_due:
        restart_np = None
        if controller is not None and drop_next_poll:
          # The injected drop_msg: this poll is the lost message. The
          # poll's dedup never advanced, so a pending RESIZE surfaces at
          # the next poll instead of vanishing.
          drop_next_poll = False
          log_fn(f"fault drop_msg: coordination poll at step {i} "
                 "dropped; a pending resize stays pending")
        elif controller is not None:
          restart_np = self._restart_target(controller, i)
        if restart_np is not None:
          if not p.train_dir:
            log_fn("Elastic restart to %d worker(s) requested but "
                   "--train_dir is unset; cannot checkpoint-restart, "
                   "ignoring" % restart_np)
          else:
            self._save_checkpoint(module, step)
            log_fn("Elastic restart at step %d: workers %d -> %d "
                   "(checkpoint + re-exec under the launcher)" % (
                       i, self.world_size, restart_np))
            # Every worker reaches this at the same step; the barrier
            # holds the exits until rank 0's checkpoint is on disk (rank
            # 0 enters after writing).
            try:
              controller.restart_barrier(
                  f"kf_restart_{controller.generation()}", self.world_size)
            except Exception as e:  # noqa: BLE001
              log_fn(f"restart barrier failed ({e}); exiting anyway")
            if tele is not None:
              tele.elastic_event(controller.generation(), self.world_size,
                                 restart_np, step.global_step)
            trace.instant("elastic", "checkpoint_restart", step=i,
                          workers=restart_np)
            restart_requested = restart_np
            break
        if batch_policy is not None and noise_ema is not None:
          proposed = batch_policy.propose(self.batch_size,
                                          noise_ema.b_simple,
                                          self.world_size)
          if proposed != self.batch_size:
            event = {"step": i, "num_devices": self.world_size,
                     "batch_size_per_device": proposed,
                     "b_simple": noise_ema.b_simple}
            log_fn("Elastic reshape at step %d: devices %d -> %d, "
                   "per-device batch %d -> %d" % (
                       i, self.world_size, self.world_size,
                       self.batch_size, proposed))
            if p.train_dir:
              # On disk before the rebuild: a run preempted during it
              # resumes at this seam, with the new batch.
              self._save_checkpoint(module, step, incarnation_bump=1)
            with trace.span("elastic", "rebuild", step=i,
                            batch_size_per_device=proposed):
              module, step, images, labels = self._rebuild(module, step,
                                                           proposed)
            chunk = self._make_chunk(step)
            real = self._open_train_input()
            # Epoch-based eval schedules count examples: re-anchored at
            # the new global batch.
            self.eval_step_set = compute_eval_step_set(
                p, self.batch_size * self.world_size,
                datasets.num_examples_per_epoch("train"), self.num_batches,
                start_step=i, start_examples=images_processed)
            reshape_events.append(event)
      _sync(self.device)
      aux = time.time() - aux_start
      aux_time += aux
      pipe.note_aux_time(aux)
    for done in pipe.flush():
      handle(done)
    total_time = time.time() - loop_start - aux_time
    trace.add_span("run", "timed_loop", trace.now() - total_time,
                   total_time, {"steps": len(step_train_times)})
    if p.train_dir and not p.forward_only and restart_requested is None:
      # Final checkpoint (ref: benchmark_cnn.py:2374-2378).
      self._save_checkpoint(module, step)
    # What the run left, for a caller that inspects it.
    self.final = {"module": module, "step": step, "chunk": chunk,
                  "images": images, "labels": labels}
    num_steps = len(step_train_times)
    images_per_sec = images_processed / total_time
    log_fn("-" * 64)
    log_fn(log_util.format_total_line(images_per_sec))
    log_fn("-" * 64)
    if chunk_times:
      for line in observability.chunk_timing_rows(
          K, chunk_times, self.batch_size * self.world_size):
        log_fn(line)
    launches = {k: v - launches_before[k]
                for k, v in kernel_launches().items()}
    if any(launches.values()):
      log_fn("Kernel launches: " + ", ".join(
          f"{k} {v}" for k, v in launches.items() if v))
    self._profile_lines(num_steps, total_time, dispatch_stats, traced)
    if bench_logger is not None:
      # The final throughput rows (ref: _log_benchmark_run).
      bench_logger.log_metric("average_examples_per_sec", images_per_sec,
                              unit="examples/sec",
                              global_step=start_step + num_steps)
      if chunk_times:
        bench_logger.log_metric(
            "chunk_wall_time_mean", sum(chunk_times) / len(chunk_times),
            unit="seconds", global_step=start_step + num_steps,
            extras={"steps_per_dispatch": K,
                    "num_chunks": len(chunk_times)})
    feed_stats = self._feeder.stats() if self._feeder is not None else None
    if feed_stats is not None and feed_stats["fetches"]:
      stall = feed_stats["feed_stall_fraction"]
      log_fn("Input feed: stall %s of wall (%.1f ms wait / %d fetches, "
             "queue depth %.1f mean / %d max, prefetch %d)" % (
                 "%.1f%%" % (100.0 * stall) if stall is not None else "n/a",
                 1e3 * feed_stats["consumer_wait_s"], feed_stats["fetches"],
                 feed_stats["queue_depth_mean"],
                 feed_stats["queue_depth_max"],
                 feed_stats["prefetch_batches"]))
      pre = self.preprocessor
      if isinstance(pre, preprocessing.MultiprocessImagePreprocessor):
        log_fn("Decode pool: %d worker processes, dispatch %.3f ms a "
               "batch (%d batches)" % (
                   pre.num_processes,
                   1e3 * pre.dispatch_seconds / max(pre.dispatch_calls, 1),
                   pre.dispatch_calls))
    if controller is not None:
      controller.close()
    # The run-health summary (None without a telemetry session): what
    # bench_torch.py's health record carries beside the rate.
    health_summary = tele.summary() if tele is not None else None
    if bench_logger is not None and health_summary and \
        health_summary.get("max_grad_norm") is not None:
      bench_logger.log_metric(
          "max_grad_norm", health_summary["max_grad_norm"],
          global_step=start_step + num_steps,
          extras={"nonfinite_steps": health_summary["nonfinite_steps"],
                  "watchdog_stalls": health_summary["watchdog_stalls"]})
    # The latency percentiles and the compile ledger, after the final
    # save so the counts match the stats; the ledger persists into
    # train_dir.
    for line in trace.latency_lines() + trace.ledger_lines():
      log_fn(line)
    if p.train_dir:
      trace.write_ledger(p.train_dir)
    if p.sync_on_finish and restart_requested is None:
      # --sync_on_finish is launch-wide (one command line for every
      # worker), so every rank meets this barrier or none does.
      kungfu.run_barrier()
    call_times = dispatch_stats["call_times"]
    memory = (observability.memory_report(step, self.device)
              if not p.forward_only else {})
    stats = {
        "num_workers": self.world_size,
        "num_steps": num_steps,
        "average_wall_time": total_time / max(num_steps, 1),
        "images_per_sec": images_per_sec,
        "last_average_loss": loss,
        "losses": losses,
        "stopped_early": stopped_early,
        "eval_results": eval_results,
        "device": str(self.device),
        "kernel_launches": launches,
        "steps_run": self.num_warmup_batches + num_steps,
        "global_step": None if p.forward_only else step.global_step,
        "batch_size_per_device": self.batch_size,
        "grad_noise_scale": noise_ema.b_simple if noise_ema else None,
        "reshape_events": reshape_events,
        "restart_for_resize": restart_requested,
        "checkpoint_save_s": list(self.checkpoint_save_s),
        "checkpoint_restore_s": self.checkpoint_restore_s,
        "steps_per_dispatch": K,
        "num_grad_accum": self.num_grad_accum,
        "num_dispatches": num_dispatches,
        "compile_s": dispatch_stats["compile_s"],
        "dispatch_overhead_s": (sum(call_times) / len(call_times)
                                if call_times else None),
        "health": health_summary,
        "health_stats": bool(p.health_stats),
        # The input feed (None for the resident synthetic batch): the JAX
        # package's feed_stall_fraction key and the feeder's whole stats.
        "feed_stall_fraction": (feed_stats["feed_stall_fraction"]
                                if feed_stats else None),
        "feed_stats": feed_stats,
        "num_chunks": len(chunk_times),
        "opt_state_bytes_per_device": memory.get("opt_state_bytes"),
        "param_bytes_per_device": memory.get("param_bytes"),
        # The run trace's aggregates: <key>_p50/p90/p99 seconds and the
        # compile ledger (bench_torch.py forwards both).
        "latency_percentiles": trace.percentile_fields() or None,
        "compile_ledger": trace.compile_ledger(),
        # The tuned table's path and matched entry (None without
        # --autotuned_config; entry None when the table had no row).
        "tuned_config": self.tuned_provenance,
        "run_id": self.run_id,
        # Which dispatch --trace_file profiled (None without it), and one
        # step's FLOPs (--tfprof_file).
        "traced_dispatch": dict(traced) or None,
        "step_flops": self._step_flops,
    }
    # The final publication the endpoint serves until teardown, and the
    # run record (rank 0: the record describes the job).
    metrics_lib.publish_stats(metrics_lib.active(), stats)
    if p.run_store_dir and mesh.rank() == 0:
      self._append_run_record(stats)
    return stats

  def _profile_lines(self, num_steps, total_time, dispatch_stats,
                     traced) -> None:
    """--tfprof_file's run-end lines: the measured MFU and the dispatch
    overhead against the counted FLOPs, and with --trace_file the measured
    per-op table of the traced dispatch (JAX benchmark.py:1895-1924).
    Best-effort: a profile failure must not cost a finished run its
    checkpoint."""
    p = self.params
    if not p.tfprof_file:
      return
    if self._step_flops and num_steps:
      step_s = total_time / num_steps
      log_fn(observability.mfu_line(self._step_flops, step_s,
                                    source="measured"))
      call_times = dispatch_stats["call_times"]
      if call_times:
        log_fn(observability.dispatch_overhead_line(
            self._step_flops / observability.H100_PEAK_FLOPS,
            self.steps_per_dispatch, sum(call_times) / len(call_times)))
    measured_path = p.tfprof_file + ".measured_ops.txt"
    try:
      if p.trace_file and traced:
        table = observability.dump_measured_op_profile(
            self._trace_path, measured_path, exclude=self._stale_traces)
        for line in (table or "").splitlines():
          log_fn(line)
      elif os.path.exists(measured_path):
        os.unlink(measured_path)
    except Exception as e:  # noqa: BLE001
      log_fn(f"measured per-op profile failed (non-fatal): {e!r}")

  def _append_run_record(self, stats) -> None:
    """One record of this run in --run_store_dir's store."""
    p = self.params
    try:
      record = metrics_lib.run_record(
          metric="images_per_sec", value=stats["images_per_sec"],
          unit="images/sec",
          fingerprint=baseline.config_fingerprint_key(p._asdict(), "train"),
          run_id=self.run_id, platform=self._platform(),
          git_rev=metrics_lib.git_revision(),
          torch_version=torch.__version__,
          device_name=(torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
          snapshot=metrics_lib.flatten_stats(stats))
      store = metrics_lib.RunStore(p.run_store_dir)
      store.append(record)
      log_fn("run record appended: %s" % store.path)
    except (OSError, ValueError) as e:
      log_fn(f"run record append failed (non-fatal): {e}")
