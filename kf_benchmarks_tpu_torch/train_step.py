"""The training step of one rank.

The port's counterpart of kf_benchmarks_tpu/train_step.py: forward in the
compute dtype (explicit casts, as flax's ``dtype=``; no autocast), softmax
cross-entropy plus ``weight_decay * l2_loss`` over the non-BN parameters,
backward, the optimizer step at this step's learning rate, and the
batch-norm running averages, which the forward updates in place (flax's
``mutable=["batch_stats"]``).

In a process group the step calls its strategy's hooks
(parallel/strategies.py) where the JAX package's step does: the gradients
of the total loss are reduced after backward, the weights go through
``pre_update`` before the optimizer step and ``post_update`` after it, the
running averages through ``sync_batch_stats``, and the reported losses are
the mean over the ranks. Without a process group, or without a strategy,
it is the single-device step. With ``track_noise_scale`` and a world of at
least 2, the step also returns the gradient noise scale's per-step
estimates ``noise_scale_g2`` / ``noise_scale_s``, measured on the ranks'
gradients before the strategy reduces them (elastic.noise_scale_stats;
train_step.py:629-640 and :918-919 of the JAX package).

Loss scaling (train_step.py:263-279, :627-628, :668-683, :759-787 of the
JAX package): the total loss is multiplied by the scale before backward
and the gradients divided by it after. With the auto loss scale, a step
whose reduced gradients hold a non-finite value (one decision for every
rank: a MAX all-reduce of the flag) applies no update -- the weights, the
optimizer's state and the batch-norm running averages stay as they were
before the step -- halves the scale (not below 1) and zeroes the count of
clean steps; after ``inc_loss_scale_every_n`` clean steps the scale
doubles. The global step advances either way; the learning rate follows
the count of applied updates, as optax's schedule count does. All of it
is decided on the device, as in the JAX package: the update runs, and a
non-finite flag selects the state copied before the step back
(``torch.where``), so the step queues no host read.

Gradient accumulation (``num_grad_accum`` M > 1; train_step.py:510-615 of
the JAX package): the batch is split into M microbatches, each runs
forward and backward (batch-norm statistics per microbatch, the running
averages advancing M times), the gradients accumulate in f32 and are
divided by M once; the losses and accuracies reported are the means over
the microbatches. One reduction, one loss-scale decision and one
optimizer apply follow.

``TrainChunk`` runs up to K steps a dispatch (--steps_per_dispatch): on a
CUDA device the step captured as a CUDA graph and replayed.

``EvalStep`` is the forward-only and evaluation step (train_step.py:
1068-1105): the module in eval mode (batch norm from its running
averages, which it leaves untouched) under ``torch.no_grad``, top-1,
top-5 and the loss averaged over the ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from kf_benchmarks_tpu_torch import elastic
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.ops import graphs
from kf_benchmarks_tpu_torch.ops.conv_bn import accum
from kf_benchmarks_tpu_torch.parallel import mesh


def is_batch_norm_param(name: str) -> bool:
  """The JAX package's L2 filter (train_step.py:71-76): a parameter is
  excluded from weight decay when any component of its path contains
  "bn" or "batchnorm". Port names keep the flax layer names' ``_bn``, so
  the same test splits the same parameters (the Dense bias is decayed)."""
  return any("bn" in part.lower() or "batchnorm" in part.lower()
             for part in name.split("."))


def l2_loss(module: nn.Module, single_op: bool = False) -> torch.Tensor:
  """0.5 * sum of squares over the non-BN parameters, in f32
  (tf.nn.l2_loss semantics, train_step.py:78-94). ``single_op``
  (--single_l2_loss_op) concatenates them first."""
  leaves = [accum(p) for name, p in module.named_parameters()
            if not is_batch_norm_param(name)]
  if not leaves:
    return torch.zeros(())
  if single_op:
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    return 0.5 * torch.sum(flat * flat)
  return 0.5 * torch.stack([torch.sum(torch.square(leaf))
                            for leaf in leaves]).sum()


def batch_stats(module: nn.Module) -> List[torch.Tensor]:
  """The batch-norm running averages (mean, var of every batch norm), in
  module order: the JAX package's ``batch_stats`` collection."""
  return [b for m in module.modules()
          if isinstance(m, builder.CompactBatchNorm) for b in (m.mean, m.var)]


def loss_scale_settings(params) -> Tuple[float, bool]:
  """(initial loss scale, auto loss scale) as the JAX package resolves
  them for bfloat16 (train_step.py:263-279): --fp16_loss_scale when given
  under --use_fp16, else 1, as bfloat16 needs none. The port computes in
  bfloat16 or f32, never float16, so the model's float16 default
  (``Model.get_fp16_loss_scale``) is never the scale."""
  scale = 1.0
  if params.use_fp16 and params.fp16_loss_scale is not None:
    scale = float(params.fp16_loss_scale)
  return scale, bool(params.use_fp16 and params.fp16_enable_auto_loss_scale)


def _mean_over_ranks(values: List[torch.Tensor]) -> List[torch.Tensor]:
  """Each scalar's mean over the ranks (itself without a process group),
  by one all-reduce."""
  vec = torch.stack([v.float() for v in values])
  if mesh.is_distributed():
    dist.all_reduce(vec, op=dist.ReduceOp.SUM)
    vec = vec / mesh.world_size()
  return list(vec.unbind())


def _select_(finite: torch.Tensor, tensors: List[torch.Tensor],
             before: List[torch.Tensor]) -> None:
  """Each tensor <- itself where ``finite``, else its value ``before``:
  the skipped update, chosen on the device."""
  for t, old in zip(tensors, before):
    t.copy_(torch.where(finite, t, old))


class TrainStep:
  """One training step over a fixed module/optimizer pair.

  A call takes the model's inputs (NHWC images, or token ids) and int64
  labels on the module's device and returns the step's metrics as 0-d
  tensors on that device (reading one synchronises with the device; the
  caller decides when): the losses, the rate the update used, with
  ``print_accuracy`` also top-1 and top-5, and with a loss scale the scale
  after the step. ``run`` is the device work of a call alone: it reads the
  host's step count and changes no host state, so ``TrainChunk`` captures
  it as a CUDA graph.

  The state beside the weights and the optimizer's lives on the device:
  the update count (the rate's schedule reads it there), the loss scale
  and its count of clean steps. ``global_step`` counts the steps taken, on
  the host (it advances on every step). ``update_count``, ``loss_scale``
  and ``loss_scale_normal_steps`` read (and set) the device state.
  """

  def __init__(self, model, module: nn.Module,
               optimizer: torch.optim.Optimizer,
               lr_fn: Callable, weight_decay: float,
               strategy=None, track_noise_scale: bool = False,
               gradient_clip: Optional[float] = None,
               loss_scale: float = 1.0, auto_loss_scale: bool = False,
               inc_loss_scale_every_n: int = 1000,
               print_accuracy: bool = False, single_l2_loss_op: bool = False,
               num_grad_accum: int = 1):
    self.model = model
    self.module = module
    self.optimizer = optimizer
    self.lr_fn = lr_fn
    self.weight_decay = weight_decay
    self.strategy = strategy
    self.track_noise_scale = track_noise_scale
    self.gradient_clip = gradient_clip
    self.auto_loss_scale = auto_loss_scale
    self.use_loss_scale = auto_loss_scale or loss_scale != 1.0
    self.inc_loss_scale_every_n = inc_loss_scale_every_n
    self.print_accuracy = print_accuracy
    self.single_l2_loss_op = single_l2_loss_op
    self.num_grad_accum = max(1, int(num_grad_accum))
    self.global_step = 0
    device = next(module.parameters()).device
    self._update_count = torch.zeros((), dtype=torch.int64, device=device)
    self._loss_scale = torch.tensor(loss_scale, dtype=torch.float32,
                                    device=device)
    self._normal_steps = torch.zeros((), dtype=torch.int64, device=device)
    # The optimizer reads its rate from this tensor; each step writes the
    # schedule's rate at the update count into it.
    self._lr = torch.zeros((), dtype=torch.float32, device=device)
    optimizers.init_state(self.optimizer)
    self._kept = None  # the auto loss scale's copies of the state

  @property
  def update_count(self) -> int:
    return int(self._update_count)

  @update_count.setter
  def update_count(self, value: int) -> None:
    self._update_count.fill_(int(value))

  @property
  def loss_scale(self) -> float:
    return float(self._loss_scale)

  @loss_scale.setter
  def loss_scale(self, value: float) -> None:
    self._loss_scale.fill_(float(value))

  @property
  def loss_scale_normal_steps(self) -> int:
    return int(self._normal_steps)

  @loss_scale_normal_steps.setter
  def loss_scale_normal_steps(self, value: int) -> None:
    self._normal_steps.fill_(int(value))

  def counters(self) -> Dict[str, object]:
    """The state beside the weights and the optimizer's that a checkpoint
    carries."""
    return {"update_count": self.update_count,
            "loss_scale": self.loss_scale,
            "loss_scale_normal_steps": self.loss_scale_normal_steps}

  def restore_counters(self, snapshot: Dict) -> None:
    """``counters()`` back from a snapshot; one written before they were
    kept restores the update count as its step and the initial scale."""
    self.update_count = int(snapshot.get("update_count", self.global_step))
    self.loss_scale = float(snapshot.get("loss_scale", self.loss_scale))
    self.loss_scale_normal_steps = int(
        snapshot.get("loss_scale_normal_steps", 0))

  def step_class(self) -> int:
    """Which of the strategy's host-side step behaviours this step has
    (the pair-averaging partner; 0 for every other strategy): a graph
    captured at one class replays only that class."""
    strategy = self.strategy if mesh.is_distributed() else None
    if strategy is None:
      return 0
    return self.global_step % strategy.step_classes()

  def __call__(self, images: torch.Tensor,
               labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    metrics = self.run(images, labels)
    self.global_step += 1
    return metrics

  def _state_tensors(self) -> List[torch.Tensor]:
    """What a skipped step keeps: the weights, the optimizer's state and
    the batch-norm running averages."""
    opt_state = [v for p in self.module.parameters()
                 for v in self.optimizer.state[p].values()
                 if isinstance(v, torch.Tensor)]
    return ([p.detach() for p in self.module.parameters()] + opt_state +
            batch_stats(self.module))

  def run(self, images: torch.Tensor,
          labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    self.module.train()
    # (Again at every step: a restored optimizer state_dict brings its own
    # rate and may lack the state.)
    for group in self.optimizer.param_groups:
      group["lr"] = self._lr
    optimizers.init_state(self.optimizer)
    kept = None
    if self.auto_loss_scale:
      # The forward updates the running averages in place and the update
      # the weights and the optimizer's state; a skipped step selects these
      # copies back.
      state = self._state_tensors()
      if self._kept is None or len(self._kept) != len(state):
        self._kept = [torch.empty_like(t) for t in state]
      kept = self._kept
      torch._foreach_copy_(kept, state)
    self.optimizer.zero_grad(set_to_none=True)
    m = self.num_grad_accum
    sums = None
    acc_keys = []
    parts = (zip(images.chunk(m), labels.chunk(m)) if m > 1
             else [(images, labels)])
    for x, y in parts:
      logits = self.module(x)
      base_loss = self.model.loss_function(logits, y)
      total_loss = base_loss
      if self.weight_decay:
        total_loss = total_loss + self.weight_decay * l2_loss(
            self.module, self.single_l2_loss_op)
      if self.use_loss_scale:
        (total_loss * self._loss_scale).backward()
      else:
        total_loss.backward()
      values = [base_loss.detach(), total_loss.detach()]
      if self.print_accuracy:
        with torch.no_grad():
          acc = self.model.accuracy_function(logits, y)
        acc_keys = [k for k in ("top_1_accuracy", "top_5_accuracy")
                    if k in acc]
        values += [acc[k] for k in acc_keys]
      del logits
      sums = values if sums is None else [a + b for a, b in zip(sums, values)]
    if m > 1:
      # The means over the microbatches (JAX train_step.py:510-615).
      sums = [v / m for v in sums]
    metrics = {}
    with torch.no_grad():
      rate = self.lr_fn(self._update_count.float())
      if isinstance(rate, torch.Tensor):
        self._lr.copy_(rate)
      else:
        self._lr.fill_(float(rate))
      strategy = self.strategy if mesh.is_distributed() else None
      finite = self._update(strategy, metrics, images.shape[0])
      if finite is None:
        self._update_count.add_(1)
      else:
        _select_(finite, self._state_tensors(), kept)
        self._update_count.add_(finite.long())
        self._next_loss_scale(finite)
      if strategy is not None:
        sums = _mean_over_ranks(sums)
      metrics.update(zip(["base_loss", "total_loss"] + acc_keys, sums))
      metrics["learning_rate"] = self._lr.clone()
      if self.use_loss_scale:
        metrics["loss_scale"] = self._loss_scale.clone()
    return metrics

  def _update(self, strategy, metrics, batch_size) -> Optional[torch.Tensor]:
    """Average the accumulated gradients, unscale, reduce and apply them
    with the strategy's hooks (none without a process group). With the
    auto loss scale, returns the device flag of finite gradients (the
    caller keeps the old state where it is false); else None."""
    step = self.global_step
    params = [p for p in self.module.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    if self.num_grad_accum > 1:
      torch._foreach_div_(grads, float(self.num_grad_accum))
    if self.use_loss_scale:
      torch._foreach_div_(grads, self._loss_scale)
    if (strategy is not None and self.track_noise_scale and
        mesh.world_size() > 1):
      metrics["noise_scale_g2"], metrics["noise_scale_s"] = \
          elastic.noise_scale_stats(grads, batch_size)
    if strategy is not None:
      strategy.reduce_gradients(grads)
    finite = None
    if self.auto_loss_scale:
      finite = self._all_finite(grads, strategy is not None)
    weights = [p.detach() for p in params]
    if strategy is not None:
      strategy.pre_update(weights, step)
    if strategy is not None and strategy.sequential_apply:
      self._sequential_apply(params)
    else:
      self._apply(grads)
    if strategy is not None:
      strategy.post_update(weights, step)
      strategy.sync_batch_stats(batch_stats(self.module))
    return finite

  def _apply(self, grads: List[torch.Tensor]) -> None:
    if self.gradient_clip is not None:
      optimizers.clip_gradients_(grads, self.gradient_clip)
    self.optimizer.step()

  @staticmethod
  def _all_finite(grads: List[torch.Tensor],
                  across_ranks: bool) -> torch.Tensor:
    """The device flag: every gradient element finite, on every rank."""
    found = torch.zeros(1, device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.ones(1, device=found.device))
    if across_ranks:
      dist.all_reduce(found, op=dist.ReduceOp.MAX)
    return found[0] == 0

  def _next_loss_scale(self, finite: torch.Tensor) -> None:
    """The JAX package's state machine (train_step.py:759-787), on the
    device in its f32 arithmetic (a doubling past the f32 range is inf,
    and stays inf)."""
    normal = torch.where(finite, self._normal_steps + 1,
                         torch.zeros_like(self._normal_steps))
    double = finite & (normal >= self.inc_loss_scale_every_n)
    scale = self._loss_scale
    self._loss_scale.copy_(torch.where(
        finite, torch.where(double, scale * 2.0, scale),
        torch.clamp(scale / 2.0, min=1.0)))
    self._normal_steps.copy_(torch.where(double, torch.zeros_like(normal),
                                         normal))

  def _sequential_apply(self, params: List[torch.nn.Parameter]) -> None:
    """Every rank's gradient applied in rank order through this rank's
    optimizer state (the async parameter server with a stateful optimizer):
    one all-gather of the flat gradients, then n optimizer steps at this
    step's rate. Each application sees the round's update count in the
    optimizer's state (Adam's bias correction), as the JAX package's
    _sync_schedule_counts makes optax's counts. It reads those counts on
    the host, so validation.py keeps it out of captured steps."""
    n = mesh.world_size()
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    gathered = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(gathered, flat)
    counts = {p: float(self.optimizer.state[p]["step"])
              if "step" in self.optimizer.state.get(p, {}) else 0.0
              for p in params}
    for r in range(n):
      offset = r * flat.numel()
      for p in params:
        p.grad.copy_(gathered[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()
        if r and "step" in self.optimizer.state.get(p, {}):
          self.optimizer.state[p]["step"].fill_(counts[p])
      self._apply([p.grad for p in params])


class TrainChunk:
  """Up to K training steps a dispatch (--steps_per_dispatch): the port's
  counterpart of the JAX package's ``train_chunk`` (train_step.py:
  1036-1064), K steps of one program.

  A call runs ``d`` (1 <= d <= K) steps of ``step`` on one batch and
  returns each metric as a (d,) tensor in step order. On the CPU, where the
  caller has asked for the CPU, the d steps run one after another. On a
  CUDA device the first call runs its first step eagerly on a side stream
  (which builds and loads every kernel, makes the optimizer's state and
  lets cuBLAS and cuDNN pick their algorithms), then captures ``step.run``
  as a CUDA graph and replays it for the others: a dispatch of d steps is d
  graph launches and no other host work. Step j's metrics land in a row of
  a device (K, n) buffer through a device row counter, so the host reads
  them once a dispatch; a call returns copies of its rows, which later
  dispatches do not overwrite. The graph reads the inputs, the rate, the
  loss scale and the counters from fixed device tensors: the chunk's own
  copies of the first batch, into which each later call copies its batch
  (the caller's tensors are never written). A strategy whose
  step has host-side classes (pair averaging's partner) has one graph per
  class, sharing one memory pool. There is no eager path on the card: a
  capture or replay failure raises.
  """

  def __init__(self, step: TrainStep, k: int):
    if k < 1:
      raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    self.step = step
    self.k = k
    self.keys: Optional[Tuple[str, ...]] = None
    self._graphs: Dict[int, graphs.Graph] = {}
    self._inputs = None
    self._rows = None       # (K, n) f32 metrics, one row a step
    self._row = None        # (1,) int64: the row the next replay writes
    self._next_row = 0      # its host mirror

  def __call__(self, images: torch.Tensor, labels: torch.Tensor,
               d: int) -> Dict[str, torch.Tensor]:
    if not 1 <= d <= self.k:
      raise ValueError(f"a dispatch runs 1..{self.k} steps, got {d}")
    if images.device.type != "cuda":
      rows = [self.step(images, labels) for _ in range(d)]
      return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
    first = None
    if self._inputs is None:
      first = graphs.on_side_stream(lambda: self.step(images, labels))
      self.keys = tuple(first)
      self._inputs = (images.clone(), labels.clone())
      dev = images.device
      self._rows = torch.zeros(self.k, len(self.keys), dtype=torch.float32,
                               device=dev)
      self._row = torch.zeros(1, dtype=torch.int64, device=dev)
      d -= 1
    else:
      self._inputs[0].copy_(images)
      self._inputs[1].copy_(labels)
    if self._next_row + d > self.k:
      self._row.zero_()
      self._next_row = 0
    start = self._next_row
    for _ in range(d):
      self._graph(self.step.step_class()).replay()
      self.step.global_step += 1
    self._next_row += d
    out = {key: self._rows[start:start + d, j].clone()
           for j, key in enumerate(self.keys)}
    if first is not None:
      out = {key: torch.cat([first[key].float().reshape(1), out[key]])
             for key in self.keys}
    return out

  def _graph(self, cls: int) -> graphs.Graph:
    if cls not in self._graphs:
      images, labels = self._inputs
      pool = (self._graphs[min(self._graphs)].pool() if self._graphs
              else None)

      def body():
        m = self.step.run(images, labels)
        if tuple(m) != self.keys:
          raise RuntimeError(f"the captured step's metrics {tuple(m)} are "
                             f"not the eager step's {self.keys}")
        vec = torch.stack([m[key].float().reshape(()) for key in self.keys])
        self._rows.index_copy_(0, self._row, vec.unsqueeze(0))
        self._row.add_(1)

      self._graphs[cls] = graphs.Graph(body, pool=pool)
    return self._graphs[cls]


class EvalStep:
  """The forward-only / evaluation step: the module in eval mode under
  ``torch.no_grad``; returns top-1, top-5 and the loss (as ``base_loss``
  and ``total_loss``), each the mean over the ranks, as tensors on the
  module's device. The module is back in training mode afterwards."""

  def __init__(self, model, module: nn.Module):
    self.model = model
    self.module = module

  @torch.no_grad()
  def __call__(self, images: torch.Tensor,
               labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    self.module.eval()
    try:
      logits = self.module(images)
      acc = self.model.accuracy_function(logits, labels)
      loss = self.model.loss_function(logits, labels)
    finally:
      self.module.train()
    top1, top5, loss = _mean_over_ranks(
        [acc["top_1_accuracy"], acc["top_5_accuracy"], loss])
    return {"top_1_accuracy": top1, "top_5_accuracy": top5,
            "base_loss": loss, "total_loss": loss}
