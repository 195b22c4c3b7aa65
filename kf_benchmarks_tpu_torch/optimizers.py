"""Optimizer construction: sgd, Nesterov momentum, rmsprop, adam and lars,
each with the update rule the JAX package builds with optax
(kf_benchmarks_tpu/optimizers.py:17-38).

* ``sgd`` / ``momentum``: ``torch.optim.SGD``. ``optax.sgd(lr, momentum=m,
  nesterov=True)`` keeps the trace t = g + m*t_prev (t_0 = 0) and steps by
  -lr*(g + m*t); torch's SGD(momentum=m, nesterov=True, dampening=0) keeps
  buf = m*buf + g (buf_1 = g) and steps by -lr*(g + m*buf): the same
  sequence.
* ``adam``: ``torch.optim.Adam``, which is ``optax.adam`` (bias-corrected,
  eps outside the square root) up to rounding.
* ``rmsprop``: ``RMSprop`` below. optax's rmsprop (>= 0.2) puts eps inside
  the square root, g*rsqrt(nu + eps), and applies its momentum after the
  learning rate, t = m*t + lr*g*rsqrt(nu + eps); ``torch.optim.RMSprop``
  does neither, which with the reference's eps of 1.0 and a varying rate
  is another optimizer.
* ``lars``: ``LARS`` below, ``optax.lars(lr, momentum=m)``: a trust ratio
  0.001*|w|/|g| on every tensor (1 where either norm is 0), then the
  learning rate, then a (non-Nesterov) trace. torch.optim has none.

``--gradient_clip`` is ``optax.clip``: every gradient element clamped to
[-c, c] before the optimizer (``clip_gradients_``, which the train step
calls before each optimizer step), not a global-norm clip. Weight decay is
not the optimizer's: the loss carries it (train_step.py). The rate is set
on the param groups by the train step before each update.
"""

from __future__ import annotations

from typing import List

import torch

# optax.lars's trust coefficient (its default, which the JAX package keeps).
LARS_TRUST_COEFFICIENT = 0.001


def get_optimizer(params, parameters, learning_rate: float = 0.0):
  opt = params.optimizer
  if opt == "sgd":
    return torch.optim.SGD(parameters, lr=learning_rate)
  if opt == "momentum":
    return torch.optim.SGD(parameters, lr=learning_rate,
                           momentum=params.momentum, nesterov=True,
                           dampening=0.0)
  if opt == "rmsprop":
    return RMSprop(parameters, lr=learning_rate, decay=params.rmsprop_decay,
                   momentum=params.rmsprop_momentum,
                   eps=params.rmsprop_epsilon)
  if opt == "adam":
    return torch.optim.Adam(parameters, lr=learning_rate,
                            betas=(params.adam_beta1, params.adam_beta2),
                            eps=params.adam_epsilon)
  if opt == "lars":
    return LARS(parameters, lr=learning_rate, momentum=params.momentum)
  raise ValueError(f"Optimizer {opt!r} not supported")


@torch.no_grad()
def clip_gradients_(grads: List[torch.Tensor], clip: float) -> None:
  """optax.clip(clip): each element of each gradient into [-clip, clip],
  in place."""
  if grads:
    torch._foreach_clamp_min_(grads, -clip)
    torch._foreach_clamp_max_(grads, clip)


def _with_grads(group):
  return [p for p in group["params"] if p.grad is not None]


class RMSprop(torch.optim.Optimizer):
  """optax.rmsprop(lr, decay, eps, momentum) (eps_in_sqrt, initial scale
  0, not centered): nu = decay*nu + (1-decay)*g^2, u = -lr*g*rsqrt(nu+eps),
  then a trace t = u + m*t (none when m is 0) added to the weights."""

  def __init__(self, params, lr: float = 0.0, decay: float = 0.9,
               momentum: float = 0.0, eps: float = 1.0):
    super().__init__(params, dict(lr=lr, decay=decay, momentum=momentum,
                                  eps=eps))

  @torch.no_grad()
  def step(self, closure=None):
    assert closure is None
    for group in self.param_groups:
      params = _with_grads(group)
      if not params:
        continue
      grads = [p.grad for p in params]
      state = [self.state[p] for p in params]
      for p, st in zip(params, state):
        if not st:
          st["nu"] = torch.zeros_like(p)
          if group["momentum"]:
            st["trace"] = torch.zeros_like(p)
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
      torch._foreach_add_(params, upd)


class LARS(torch.optim.Optimizer):
  """optax.lars(lr, momentum=m) at its defaults (no weight decay, trust
  coefficient 0.001, eps 0, every tensor trust-scaled, not Nesterov):
  u = -lr * g * tc*|w|/|g| (the ratio 1 where |w| or |g| is 0), then the
  trace t = u + m*t added to the weights."""

  def __init__(self, params, lr: float = 0.0, momentum: float = 0.9):
    super().__init__(params, dict(lr=lr, momentum=momentum))

  @torch.no_grad()
  def step(self, closure=None):
    assert closure is None
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
      trace = []
      for p in params:
        st = self.state[p]
        if not st:
          st["trace"] = torch.zeros_like(p)
        trace.append(st["trace"])
      torch._foreach_mul_(trace, group["momentum"])
      torch._foreach_add_(trace, upd)
      torch._foreach_add_(params, trace)
