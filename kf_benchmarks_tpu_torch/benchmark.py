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
synthetic batch once, or, with --train_dir, every new checkpoint there
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

Sharded state and the overlapped reduction (--shard_optimizer_state,
--shard_params, --overlap_gradient_reduction): ``build`` makes this rank's
shards (ops/sharded.py) before the optimizer, which steps on them, and
hands them and the bucket spec (ops/overlap.py) to the train step; the
checkpoints hold the shard stacks, and mid-training eval reads the
weights gathered.

Timing: the device runs asynchronously. The warmup ends in a
``torch.cuda.synchronize()``; in the timed loop each dispatch's metrics are
read two dispatches later through utils/pipeline.py, whose read-arrival
intervals are the step times (a K-step dispatch's interval split K ways).
``compile_s`` is the host time of the first dispatch call and
``dispatch_overhead_s`` the mean host time of a timed one.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import learning_rate
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import train_step as train_step_lib
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.data import datasets
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.ops import conv_bn
from kf_benchmarks_tpu_torch.ops import flash_attention
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


def accuracy_line(top1: float, top5: float, examples: int) -> str:
  return "Accuracy @ 1 = %.4f Accuracy @ 5 = %.4f [%d examples]" % (
      top1, top5, examples)


class BenchmarkCNN:
  """Benchmark runner for one validated Params."""

  def __init__(self, params):
    params_lib.validate_params(params)
    validation.validate_cross_flags(params)
    if params.adaptive_batch_size and not params.track_grad_noise_scale:
      # The adaptive-batch policy keys on the measured noise scale.
      params = params._replace(track_grad_noise_scale=True)
    self.params = params
    self.world_size = mesh.world_size()
    self.device = mesh.rank_device(params.device, mesh.local_rank())
    self.strategy = strategies.get_strategy(params)
    self.nclass = model_config.IMAGENET_NUM_CLASSES
    self.model = model_config.get_model_config(params.model, params)
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
    log_fn("Dataset:     %s (synthetic)" % self.model.data_name)
    log_fn("Mode:        %s" % ("forward-only" if p.forward_only else
                                   "evaluation" if p.eval else "training"))
    log_fn("Batch size:  %d global" % (self.batch_size * self.world_size))
    log_fn("             %d per device" % self.batch_size)
    log_fn("Num batches: %d" % self.num_batches)
    log_fn("Num devices: %d (%s: %s)" % (self.world_size, p.device,
                                         device_name))
    log_fn("Data format: %s" % p.data_format)
    log_fn("Precision:   %s (params: float32)" %
           str(self.compute_dtype).replace("torch.", ""))
    log_fn("Optimizer:   %s" % p.optimizer)
    log_fn("Variables:   %s" % p.variable_update)
    if p.variable_update == "kungfu":
      log_fn("KungFu:      %s" % p.kungfu_option)
    log_fn("==========")

  def _make_module(self):
    """(module, generator): the model's module made on the rank's device
    from --tf_random_seed, and the generator it drew from, which the
    synthetic batch continues."""
    gen = torch.Generator(device=self.device).manual_seed(
        self.params.tf_random_seed)
    with torch.device(self.device):
      module = self.model.make_module(self.nclass, self.compute_dtype,
                                      generator=gen)
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
          overlap=overlap.build(p))
    t_restore = None
    if snapshot is None and p.train_dir:
      t_restore = time.time()
      try:
        snapshot, _, _ = checkpoint.load_latest_checkpoint(p.train_dir)
        self.input_incarnation = int(snapshot.get("input_incarnation", 0))
      except checkpoint.CheckpointNotFoundException:
        t_restore = None
    restored_step = None
    if snapshot is not None:
      if p.forward_only:
        restored_step = checkpoint.restore_model(module, snapshot)
      else:
        step.global_step = restored_step = checkpoint.restore_state(
            module, step.optimizer, snapshot, step.sharding)
        step.restore_counters(snapshot)
      _sync(self.device)
    if t_restore is not None:
      self.checkpoint_restore_s = time.time() - t_restore
      log_fn(f"Restored checkpoint at global step {restored_step} in "
             f"{self.checkpoint_restore_s:.3f} s")
      if self.input_incarnation:
        log_fn(f"Resumed input stream at incarnation "
               f"{self.input_incarnation}")
    images, labels = self._synthetic_batch(gen)
    if mesh.is_distributed():
      with torch.no_grad():
        self.strategy.broadcast_init(
            [q.detach() for q in module.parameters()])
    return module, step, images, labels

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
    self.checkpoint_save_s.append(time.time() - t0)
    log_fn(f"Saved checkpoint at global step {step.global_step} in "
           f"{self.checkpoint_save_s[-1]:.3f} s")

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
    return self._benchmark_train()

  # -- evaluation ---------------------------------------------------------

  def _eval_once(self, eval_step, images, labels) -> Dict[str, Any]:
    """--num_eval_batches (or --num_eval_epochs, else --num_batches)
    evaluations of the batch, averaged (the JAX package's _eval_once,
    benchmark.py:2049-2083); the mean loss is logged beside the
    accuracies."""
    p = self.params
    num_eval = (p.num_eval_batches or self._num_eval_batches_from_epochs()
                or self.num_batches)
    launches_before = kernel_launches()
    start = time.time()
    accs = [eval_step(images, labels) for _ in range(num_eval)]
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
    return {"top_1_accuracy": top1, "top_5_accuracy": top5,
            "base_loss": loss,
            "eval_images_per_sec": examples / max(elapsed, 1e-9),
            "num_eval_batches": len(accs), "kernel_launches": launches}

  def _run_eval(self) -> Dict[str, Any]:
    """Evaluation (JAX benchmark.py:2085-2131): without --train_dir one
    pass over the seeded model; with it, every new checkpoint there in
    turn, until 10 polls in a row find none (one poll when
    --eval_interval_secs is 0). Every rank reads the same files and
    evaluates its own copy of the batch; the accuracies are the mean
    over the ranks."""
    module, gen = self._make_module()
    images, labels = self._synthetic_batch(gen)
    eval_step = train_step_lib.EvalStep(self.model, module)
    if not self.params.train_dir:
      return self._eval_once(eval_step, images, labels)
    return self._eval_poll_loop(module, eval_step, images, labels)

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
        results = self._eval_once(eval_step, images, labels)
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
      if action == "restart" and controller.scheduled_restart() is None:
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
    p = self.params
    K = self.steps_per_dispatch
    launches_before = kernel_launches()
    t0 = time.time()
    module, step, images, labels = self.build()
    chunk = self._make_chunk(step)
    noise_ema, batch_policy, controller = self._elastic_setup()
    if (self.num_grad_accum > 1 and
        train_step_lib.batch_stats(module)):
      log_fn(f"Note: --num_grad_accum={self.num_grad_accum} with a "
             "batch-norm model: BN statistics are per-microbatch "
             f"(batch/{self.num_grad_accum}) and running stats update "
             f"{self.num_grad_accum}x per step; not numerically "
             "equivalent to the monolithic step (BN-free models are)")

    # Host time of each dispatch call (the call alone, no wait for the
    # device): the first is compile_s -- kernel builds, and under K > 1 the
    # eager warm-up step and the graph capture; the timed ones average to
    # dispatch_overhead_s (JAX benchmark.py:1267-1320, :1965-1975).
    dispatch_stats = {"compile_s": None, "call_times": []}

    def run_dispatch(n: int) -> Dict[str, Any]:
      t_call = time.monotonic()
      if chunk is not None:
        metrics = chunk(images, labels, n)
        if n == 1:
          metrics = {k: v[0] for k, v in metrics.items()}
      else:
        metrics = step(images, labels)
      dt = time.monotonic() - t_call
      if dispatch_stats["compile_s"] is None:
        dispatch_stats["compile_s"] = dt
      dispatch_stats["call_times"].append(dt)
      return metrics

    log_fn("Running warm up")
    # Exactly num_warmup_batches warmup steps at every K: q whole K-step
    # dispatches, then r single steps, so the warmed-up state is the K = 1
    # loop's (JAX benchmark.py:1330-1360).
    q, r = divmod(self.num_warmup_batches, K)
    for _ in range(q):
      run_dispatch(K)
    for _ in range(r):
      run_dispatch(1)
    _sync(self.device)
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

    def handle(done) -> None:
      nonlocal loss, last_display_len
      step_train_times.append(done.interval)
      m = done.metrics
      loss = float(m["total_loss"])
      losses.append(loss)
      if noise_ema is not None and "noise_scale_g2" in m:
        noise_ema.update(float(m["noise_scale_g2"]),
                         float(m["noise_scale_s"]))
      i1 = done.index
      if i1 % self.display_every == 0 or i1 == self.num_batches:
        top1 = top5 = None
        if "top_1_accuracy" in m:
          top1 = float(m["top_1_accuracy"])
          top5 = float(m["top_5_accuracy"])
        log_fn(log_util.format_step_line(
            i1, self.batch_size * self.world_size,
            step_train_times[last_display_len:], loss, top1, top5))
        last_display_len = len(step_train_times)

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

    def event_due(s: int) -> bool:
      return save_steps_due(s) or eval_due_at(s) or elastic_due_at(s)

    # Lag-2 pipelined metric reads (utils/pipeline.py): every step's
    # values are read two dispatches later, so the host never waits for
    # the step it just queued.
    pipe = pipeline_lib.MetricsPipeline(lag=2)
    dispatch_stats["call_times"].clear()
    loop_start = time.time()
    last_save = loop_start
    pipe.reset_clock()
    i = 0
    while i < self.num_batches:
      n = dispatch_len(K, i, self.num_batches, event_due)
      if chunk is not None and n == K:
        metrics = run_dispatch(K)
        i += K
        images_processed += K * self.batch_size * self.world_size
        num_dispatches += 1
        for done in pipe.push(i, metrics, count=K):
          handle(done)
      else:
        # The short remainder before an event, or the end, runs as single
        # steps (one-step dispatches under K > 1).
        for _ in range(n):
          metrics = run_dispatch(1)
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
      if not (save_due or eval_due or elastic_due):
        continue
      # A sync point: everything in flight is read, and the checkpoint,
      # eval and resize time is kept out of the step times.
      for done in pipe.flush():
        handle(done)
      aux_start = time.time()
      if save_due:
        self._save_checkpoint(module, step)
        last_save = time.time()
      if eval_due:
        # Mid-training eval and the early stop (JAX benchmark.py:
        # 1655-1672; ref: benchmark_cnn.py:2310-2324).
        acc = train_step_lib.EvalStep(
            self.model, module, full_params=step.full_params)(images, labels)
        top1 = float(acc["top_1_accuracy"])
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
        restart_np = (self._restart_target(controller, i)
                      if controller is not None else None)
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
            module, step, images, labels = self._rebuild(module, step,
                                                         proposed)
            chunk = self._make_chunk(step)
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
    launches = {k: v - launches_before[k]
                for k, v in kernel_launches().items()}
    if any(launches.values()):
      log_fn("Kernel launches: " + ", ".join(
          f"{k} {v}" for k, v in launches.items() if v))
    if controller is not None:
      controller.close()
    if p.sync_on_finish and restart_requested is None:
      # --sync_on_finish is launch-wide (one command line for every
      # worker), so every rank meets this barrier or none does.
      kungfu.run_barrier()
    call_times = dispatch_stats["call_times"]
    return {
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
    }
