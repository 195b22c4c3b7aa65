"""Benchmark runtime: build -> warmup -> timed loop -> report.

The port's counterpart of the training path of kf_benchmarks_tpu/
benchmark.py (BenchmarkCNN, :340-910): the same banner, the reference's
step lines (``N\\timages/sec: ... loss``) every --display_every steps and
the ``total images/sec`` line, and a stats dict. The runtime is the same
for every model: for transformer_lm an "image" is one sequence, as in the
JAX package (tokens/sec = images/sec x the sequence length).

Data parallel: one BenchmarkCNN per rank process, in a process group that
the caller made (cli.py spawns the ranks). Every rank builds the same
weights and the same synthetic per-device batch from --tf_random_seed (the
JAX package tiles one per-device batch to every replica), the strategy's
``broadcast_init`` runs after the build, rank 0 alone prints, and the rate
is the global one: per-rank images times the world size over rank 0's
window. Every rank meets the others at a barrier before it returns.

Timing: the device runs asynchronously, so every timing boundary is a
``torch.cuda.synchronize()``: one before the timed loop, and the read of
each step's loss, which waits for that step to finish. A step's time is
the host interval between two such boundaries.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

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
    self.params = params
    self.world_size = mesh.world_size()
    self.device = mesh.rank_device(params.device, mesh.rank())
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

  def build(self):
    """(module, train step, images, labels), all made from --tf_random_seed
    on the rank's device, the same on every rank; in a process group the
    weights then go through the strategy's ``broadcast_init``."""
    p = self.params
    gen = torch.Generator(device=self.device).manual_seed(p.tf_random_seed)
    with torch.device(self.device):
      module = self.model.make_module(self.nclass, self.compute_dtype,
                                      generator=gen)
    opt = optimizers.get_optimizer(p, module.parameters())
    lr_fn = learning_rate.make_learning_rate_fn(
        self.model, learning_rate.effective_batch_size(
            self.batch_size, self.world_size, self.strategy.cross_replica))
    step = train_step_lib.TrainStep(self.model, module, opt, lr_fn,
                                    p.weight_decay, strategy=self.strategy)
    images, labels = self.model.get_synthetic_inputs(gen, self.nclass,
                                                     self.device)
    if mesh.is_distributed():
      with torch.no_grad():
        self.strategy.broadcast_init(
            [q.detach() for q in module.parameters()])
    return module, step, images, labels

  def run(self) -> Dict[str, Any]:
    self.print_info()
    return self._benchmark_train()

  def _benchmark_train(self) -> Dict[str, Any]:
    launches_before = kernel_launches()
    t0 = time.time()
    _, step, images, labels = self.build()
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
    loop_start = time.time()
    last = loop_start
    for i in range(self.num_batches):
      metrics = step(images, labels)
      loss = float(metrics["total_loss"])  # waits for the step
      now = time.time()
      step_train_times.append(now - last)
      last = now
      i1 = i + 1
      if i1 % self.display_every == 0 or i1 == self.num_batches:
        log_fn(log_util.format_step_line(
            i1, self.batch_size * self.world_size,
            step_train_times[last_display_len:], loss))
        last_display_len = len(step_train_times)
    total_time = time.time() - loop_start
    images_per_sec = (self.num_batches * self.batch_size * self.world_size /
                      total_time)
    log_fn("-" * 64)
    log_fn(log_util.format_total_line(images_per_sec))
    log_fn("-" * 64)
    kungfu.run_barrier()
    return {
        "num_workers": self.world_size,
        "num_steps": self.num_batches,
        "average_wall_time": total_time / self.num_batches,
        "images_per_sec": images_per_sec,
        "last_average_loss": loss,
        "device": str(self.device),
        "kernel_launches": {k: v - launches_before[k]
                            for k, v in kernel_launches().items()},
        "steps_run": self.num_warmup_batches + self.num_batches,
    }
