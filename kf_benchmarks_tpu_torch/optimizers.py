"""Optimizer construction: sgd, Nesterov momentum, rmsprop, adam and lars,
each with the update rule the JAX package builds with optax
(kf_benchmarks_tpu/optimizers.py:17-38). Every one reads its rate from a
device tensor and keeps its counters on the device: a step queues no host
read, and a CUDA graph of it replays the rate of each step it runs.

* ``sgd`` / ``momentum``: ``SGD`` below, on ``torch._foreach`` ops
  (``torch.optim.SGD`` reads a tensor rate back to the host),
  ``optax.sgd(lr, momentum=m, nesterov=True)``: the trace
  t = g + m*t_prev (t_0 = 0), the update -lr*(g + m*t) (-lr*g without
  momentum).
* ``adam``: ``torch.optim.Adam``, which is ``optax.adam`` (bias-corrected,
  eps outside the square root) up to rounding. On the card it is
  capturable: it reads the rate tensor and keeps its count on the device.
  On the CPU it takes the single-tensor path, the one that reads a rate
  tensor without being capturable (which needs a CUDA parameter).
* ``rmsprop``: ``RMSprop`` below. optax's rmsprop (>= 0.2) puts eps inside
  the square root, g*rsqrt(nu + eps), and applies its momentum after the
  learning rate, t = m*t + lr*g*rsqrt(nu + eps); ``torch.optim.RMSprop``
  does neither, which with the reference's eps of 1.0 and a varying rate
  is another optimizer.
* ``lars``: ``LARS`` below, ``optax.lars(lr, momentum=m)``: a trust ratio
  0.001*|w|/|g| on every tensor (1 where either norm is 0), then the
  learning rate, then a (non-Nesterov) trace. torch.optim has none.

Each keeps its state as optax initialises it (zeros, count 0);
``init_state`` makes it before the first step, so a step that the auto
loss scale skips can keep it as it was. ``--gradient_clip`` is
``optax.clip``: every gradient element clamped to [-c, c] before the
optimizer (``clip_gradients_``, which the train step calls before each
optimizer step), not a global-norm clip. Weight decay is not the
optimizer's: the loss carries it (train_step.py). The train step sets
each group's ``lr`` to its 0-d f32 rate tensor.

The state follows the parameters' dtype, as optax's ``zeros_like(params)``
does: under --fp16_vars the momentum, RMSProp and Adam buffers are bf16
(Adam's count stays f32).

The health stats (telemetry.py) read the square sum of the update, which
these optimizers never keep: they add it to the weights in place. With
``track_update(index, num)`` set, each step also leaves this rank's
partial square sum of its update (row ``index`` of ``num``, as
telemetry.sumsq_partials splits a leaf) in ``update_sq``, computed from
the update as the step forms it (Adam's from its moments after the step).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from kf_benchmarks_tpu_torch import telemetry

# optax.lars's trust coefficient (its default, which the JAX package keeps).
LARS_TRUST_COEFFICIENT = 0.001


def get_optimizer(params, parameters, learning_rate: float = 0.0):
  opt = params.optimizer
  if opt == "sgd":
    return SGD(parameters, lr=learning_rate)
  if opt == "momentum":
    return SGD(parameters, lr=learning_rate, momentum=params.momentum,
               nesterov=True)
  if opt == "rmsprop":
    return RMSprop(parameters, lr=learning_rate, decay=params.rmsprop_decay,
                   momentum=params.rmsprop_momentum,
                   eps=params.rmsprop_epsilon)
  if opt == "adam":
    return Adam(parameters, lr=learning_rate,
                betas=(params.adam_beta1, params.adam_beta2),
                eps=params.adam_epsilon)
  if opt == "lars":
    return LARS(parameters, lr=learning_rate, momentum=params.momentum)
  raise ValueError(f"Optimizer {opt!r} not supported")


def init_state(optimizer: torch.optim.Optimizer) -> None:
  """Every parameter's optimizer state at its initial value, where it is
  not there yet (a new optimizer, or one restored from a snapshot taken
  before its first step)."""
  for group in optimizer.param_groups:
    for p in group["params"]:
      if not optimizer.state[p]:
        optimizer.state[p].update(optimizer.initial_state(p, group))


@torch.no_grad()
def clip_gradients_(grads: List[torch.Tensor], clip: float) -> None:
  """optax.clip(clip): each element of each gradient into [-clip, clip],
  in place."""
  if grads:
    torch._foreach_clamp_min_(grads, -clip)
    torch._foreach_clamp_max_(grads, clip)


def _with_grads(group):
  return [p for p in group["params"] if p.grad is not None]


class _UpdateSquares:
  """``track_update`` / ``update_sq``: the update's partial square sum,
  noted by the step that forms the update."""

  _update_split: Optional[Tuple[int, int]] = None
  update_sq: Optional[torch.Tensor] = None

  def track_update(self, index: int, num: int) -> None:
    """Every later step leaves this rank's partial square sum of its
    update (row ``index`` of ``num``) in ``update_sq``."""
    self._update_split = (int(index), int(num))

  def _note_update(self, upd: List[torch.Tensor]) -> None:
    if self._update_split is None:
      return
    part = telemetry.sumsq_partials(upd, *self._update_split).sum()
    self.update_sq = part if self.update_sq is None else \
        self.update_sq + part


class _Optimizer(_UpdateSquares, torch.optim.Optimizer):
  """The port's optimizers: ``initial_state`` is optax's init of one
  parameter's state."""

  def initial_state(self, p, group) -> Dict[str, torch.Tensor]:
    raise NotImplementedError

  def states(self, params, group) -> List[Dict[str, torch.Tensor]]:
    """The state of each of ``params`` (of ``group``), made at its initial
    value where it is not there yet."""
    init_state(self)
    return [self.state[p] for p in params]


class SGD(_Optimizer):
  """optax.sgd(lr, momentum=m, nesterov): without momentum u = -lr*g;
  with it the trace t = g + m*t (t_0 = 0) and u = -lr*(g + m*t) under
  Nesterov, -lr*t without."""

  def __init__(self, params, lr=0.0, momentum: float = 0.0,
               nesterov: bool = False):
    super().__init__(params, dict(lr=lr, momentum=momentum,
                                  nesterov=nesterov))

  def initial_state(self, p, group):
    if not group["momentum"]:
      return {}
    return {"momentum_buffer": torch.zeros_like(p)}

  @torch.no_grad()
  def step(self, closure=None):
    assert closure is None
    self.update_sq = None
    for group in self.param_groups:
      params = _with_grads(group)
      if not params:
        continue
      grads = [p.grad for p in params]
      state = self.states(params, group)
      upd = grads
      m = group["momentum"]
      if m:
        trace = [st["momentum_buffer"] for st in state]
        torch._foreach_mul_(trace, m)
        torch._foreach_add_(trace, grads)
        if group["nesterov"]:
          upd = torch._foreach_mul(trace, m)
          torch._foreach_add_(upd, grads)
        else:
          upd = trace
      upd = torch._foreach_mul(upd, -group["lr"])
      self._note_update(upd)
      torch._foreach_add_(params, upd)


class Adam(_UpdateSquares, torch.optim.Adam):
  """torch.optim.Adam, capturable where its parameters are on the card;
  ``initial_state`` is the state its first step would make. Its update,
  for ``update_sq``, is formed again from the moments after the step:
  -lr/(1-b1^t) * m / (sqrt(v)/sqrt(1-b2^t) + eps)."""

  def __init__(self, params, lr=0.0, betas=(0.9, 0.999), eps: float = 1e-8):
    params = list(params)
    on_card = any(p.is_cuda for p in params)
    super().__init__(params, lr=lr, betas=tuple(betas), eps=eps,
                     capturable=on_card, foreach=on_card)

  def initial_state(self, p, group):
    del group
    return {"step": torch.zeros((), dtype=torch.float32, device=p.device),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}

  @torch.no_grad()
  def step(self, closure=None):
    out = super().step(closure)
    self.update_sq = None
    if self._update_split is None:
      return out
    for group in self.param_groups:
      params = _with_grads(group)
      if not params:
        continue
      beta1, beta2 = group["betas"]
      st = [self.state[p] for p in params]
      # The bias corrections in f64: 1 - beta2^t cancels most of its f32
      # bits at small t.
      t = st[0]["step"].double()
      bc1 = 1.0 - torch.pow(beta1, t)
      bc2_sqrt = torch.sqrt(1.0 - torch.pow(beta2, t))
      denom = torch._foreach_sqrt([s["exp_avg_sq"] for s in st])
      torch._foreach_div_(denom, bc2_sqrt.to(denom[0].dtype))
      torch._foreach_add_(denom, group["eps"])
      upd = torch._foreach_div([s["exp_avg"] for s in st], denom)
      torch._foreach_mul_(upd, (-group["lr"] / bc1).to(upd[0].dtype))
      self._note_update(upd)
    return out


class RMSprop(_Optimizer):
  """optax.rmsprop(lr, decay, eps, momentum) (eps_in_sqrt, initial scale
  0, not centered): nu = decay*nu + (1-decay)*g^2, u = -lr*g*rsqrt(nu+eps),
  then a trace t = u + m*t (none when m is 0) added to the weights."""

  def __init__(self, params, lr: float = 0.0, decay: float = 0.9,
               momentum: float = 0.0, eps: float = 1.0):
    super().__init__(params, dict(lr=lr, decay=decay, momentum=momentum,
                                  eps=eps))

  def initial_state(self, p, group):
    st = {"nu": torch.zeros_like(p)}
    if group["momentum"]:
      st["trace"] = torch.zeros_like(p)
    return st

  @torch.no_grad()
  def step(self, closure=None):
    assert closure is None
    self.update_sq = None
    for group in self.param_groups:
      params = _with_grads(group)
      if not params:
        continue
      grads = [p.grad for p in params]
      state = self.states(params, group)
      nu = [st["nu"] for st in state]
      decay = group["decay"]
      # optax: (1 - decay) * g**2 + decay * nu.
      sq = torch._foreach_mul(grads, grads)
      torch._foreach_mul_(sq, 1.0 - decay)
      torch._foreach_mul_(nu, decay)
      torch._foreach_add_(nu, sq)
      upd = torch._foreach_add(nu, group["eps"])
      torch._foreach_rsqrt_(upd)
      torch._foreach_mul_(upd, grads)
      torch._foreach_mul_(upd, -group["lr"])
      if group["momentum"]:
        trace = [st["trace"] for st in state]
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, upd)
        upd = trace
      self._note_update(upd)
      torch._foreach_add_(params, upd)


class LARS(_Optimizer):
  """optax.lars(lr, momentum=m) at its defaults (no weight decay, trust
  coefficient 0.001, eps 0, every tensor trust-scaled, not Nesterov):
  u = -lr * g * tc*|w|/|g| (the ratio 1 where |w| or |g| is 0), then the
  trace t = u + m*t added to the weights."""

  def __init__(self, params, lr: float = 0.0, momentum: float = 0.9):
    super().__init__(params, dict(lr=lr, momentum=momentum))

  def initial_state(self, p, group):
    return {"trace": torch.zeros_like(p)}

  @torch.no_grad()
  def step(self, closure=None):
    assert closure is None
    self.update_sq = None
    for group in self.param_groups:
      params = _with_grads(group)
      if not params:
        continue
      grads = [p.grad for p in params]
      w_norm = torch.stack(torch._foreach_norm(params))
      g_norm = torch.stack(torch._foreach_norm(grads))
      ratio = LARS_TRUST_COEFFICIENT * w_norm / g_norm
      ratio = torch.where((w_norm == 0) | (g_norm == 0),
                          torch.ones_like(ratio), ratio)
      upd = torch._foreach_mul(grads, list(ratio.unbind()))
      torch._foreach_mul_(upd, -group["lr"])
      trace = [st["trace"] for st in self.states(params, group)]
      torch._foreach_mul_(trace, group["momentum"])
      torch._foreach_add_(trace, upd)
      self._note_update(trace)
      torch._foreach_add_(params, trace)
