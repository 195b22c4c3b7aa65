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

Timing: the device runs asynchronously, so every timing boundary is a
``torch.cuda.synchronize()``: one before the timed loop, and the read of
each step's loss, which waits for that step to finish. A step's time is
the host interval between two such boundaries.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import learning_rate
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import train_step as train_step_lib
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.ops import conv_bn
from kf_benchmarks_tpu_torch.ops import flash_attention
from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.parallel import strategies
from kf_benchmarks_tpu_torch.utils import log as log_util

log_fn = log_util.log_fn


def kernel_launches() -> Dict[str, int]:
  """Launch counts of every hand-written kernel, by name."""
  return {**conv_bn.LAUNCHES, **flash_attention.LAUNCHES}


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


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
    self.num_batches = params.num_batches or 100
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

  def print_info(self) -> None:
    p = self.params
    device_name = (torch.cuda.get_device_name(self.device)
                   if self.device.type == "cuda" else "cpu")
    log_fn("TensorFlow:   n/a (kf_benchmarks_tpu_torch, PyTorch %s)" %
           torch.__version__)
    log_fn("Model:       %s" % self.model.get_name())
    log_fn("Dataset:     %s (synthetic)" % self.model.data_name)
    log_fn("Mode:        training")
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

  def build(self, snapshot: Optional[Dict] = None):
    """(module, train step, images, labels), all made from --tf_random_seed
    on the rank's device, the same on every rank. The state then comes
    from ``snapshot`` (a checkpoint.savable_state) if one is given, else
    from --train_dir's newest readable checkpoint if there is one (the
    global step, the weights and batch-norm averages, the optimizer's
    buffers, the input incarnation); in a process group the weights then
    go through the strategy's ``broadcast_init``. The synthetic batch of
    incarnation k > 0 comes from a generator seeded --tf_random_seed +
    7919 k (the JAX package folds k into its data key)."""
    p = self.params
    gen = torch.Generator(device=self.device).manual_seed(p.tf_random_seed)
    with torch.device(self.device):
      module = self.model.make_module(self.nclass, self.compute_dtype,
                                      generator=gen)
    opt = optimizers.get_optimizer(p, module.parameters())
    lr_fn = learning_rate.make_learning_rate_fn(
        self.model, learning_rate.effective_batch_size(
            self.batch_size, self.world_size, self.strategy.cross_replica))
    step = train_step_lib.TrainStep(
        self.model, module, opt, lr_fn, p.weight_decay,
        strategy=self.strategy, track_noise_scale=p.track_grad_noise_scale)
    t_restore = None
    if snapshot is None and p.train_dir:
      t_restore = time.time()
      try:
        snapshot, _, _ = checkpoint.load_latest_checkpoint(p.train_dir)
        self.input_incarnation = int(snapshot.get("input_incarnation", 0))
      except checkpoint.CheckpointNotFoundException:
        t_restore = None
    if snapshot is not None:
      step.global_step = checkpoint.restore_state(module, opt, snapshot)
      _sync(self.device)
    if t_restore is not None:
      self.checkpoint_restore_s = time.time() - t_restore
      log_fn(f"Restored checkpoint at global step {step.global_step} in "
             f"{self.checkpoint_restore_s:.3f} s")
      if self.input_incarnation:
        log_fn(f"Resumed input stream at incarnation "
               f"{self.input_incarnation}")
    if self.input_incarnation:
      gen = torch.Generator(device=self.device).manual_seed(
          p.tf_random_seed + 7919 * self.input_incarnation)
    images, labels = self.model.get_synthetic_inputs(gen, self.nclass,
                                                     self.device)
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
                                 self.input_incarnation + incarnation_bump),
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
                                        self.input_incarnation)
    self.input_incarnation += 1
    self.batch_size = batch_per_device
    self.model.set_batch_size(batch_per_device)
    return self.build(snapshot=snapshot)

  def run(self) -> Dict[str, Any]:
    self.print_info()
    return self._benchmark_train()

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

  def _benchmark_train(self) -> Dict[str, Any]:
    p = self.params
    launches_before = kernel_launches()
    t0 = time.time()
    module, step, images, labels = self.build()
    noise_ema, batch_policy, controller = self._elastic_setup()
    log_fn("Running warm up")
    for _ in range(self.num_warmup_batches):
      step(images, labels)
    _sync(self.device)
    log_fn("Build + warmup (%d steps): %.1f s" %
           (self.num_warmup_batches, time.time() - t0))
    log_fn("Step\tImg/sec\ttotal_loss")

    step_train_times = []
    last_display_len = 0
    loss = float("nan")
    images_processed = 0
    aux_time = 0.0
    restart_requested = None
    reshape_events = []
    loop_start = time.time()
    last = last_save = loop_start
    for i in range(self.num_batches):
      metrics = step(images, labels)
      loss = float(metrics["total_loss"])  # waits for the step
      now = time.time()
      step_train_times.append(now - last)
      last = now
      images_processed += self.batch_size * self.world_size
      if noise_ema is not None and "noise_scale_g2" in metrics:
        noise_ema.update(float(metrics["noise_scale_g2"]),
                         float(metrics["noise_scale_s"]))
      i1 = i + 1
      if i1 % self.display_every == 0 or i1 == self.num_batches:
        log_fn(log_util.format_step_line(
            i1, self.batch_size * self.world_size,
            step_train_times[last_display_len:], loss))
        last_display_len = len(step_train_times)
      save_due = bool(p.train_dir and (
          (p.save_model_steps and i1 % p.save_model_steps == 0) or
          (p.save_model_secs and now - last_save >= p.save_model_secs)))
      elastic_due = bool((controller is not None or batch_policy is not None)
                         and i1 % p.elastic_check_every_n_steps == 0 and
                         i1 < self.num_batches)
      if not (save_due or elastic_due):
        continue
      # Checkpoint and resize time stays out of the step times.
      aux_start = time.time()
      if save_due:
        self._save_checkpoint(module, step)
        last_save = time.time()
      if elastic_due:
        restart_np = (self._restart_target(controller, i1)
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
                       i1, self.world_size, restart_np))
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
            event = {"step": i1, "num_devices": self.world_size,
                     "batch_size_per_device": proposed,
                     "b_simple": noise_ema.b_simple}
            log_fn("Elastic reshape at step %d: devices %d -> %d, "
                   "per-device batch %d -> %d" % (
                       i1, self.world_size, self.world_size,
                       self.batch_size, proposed))
            if p.train_dir:
              # On disk before the rebuild: a run preempted during it
              # resumes at this seam, with the new batch.
              self._save_checkpoint(module, step, incarnation_bump=1)
            module, step, images, labels = self._rebuild(module, step,
                                                         proposed)
            reshape_events.append(event)
      _sync(self.device)
      aux = time.time() - aux_start
      aux_time += aux
      last += aux
    total_time = time.time() - loop_start - aux_time
    if p.train_dir and restart_requested is None:
      # Final checkpoint (ref: benchmark_cnn.py:2374-2378).
      self._save_checkpoint(module, step)
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
    return {
        "num_workers": self.world_size,
        "num_steps": num_steps,
        "average_wall_time": total_time / max(num_steps, 1),
        "images_per_sec": images_per_sec,
        "last_average_loss": loss,
        "device": str(self.device),
        "kernel_launches": launches,
        "steps_run": self.num_warmup_batches + num_steps,
        "global_step": step.global_step,
        "batch_size_per_device": self.batch_size,
        "grad_noise_scale": noise_ema.b_simple if noise_ema else None,
        "reshape_events": reshape_events,
        "restart_for_resize": restart_requested,
        "checkpoint_save_s": list(self.checkpoint_save_s),
        "checkpoint_restore_s": self.checkpoint_restore_s,
    }
