"""The port's optimizers (kf_benchmarks_tpu_torch/optimizers.py) against the
JAX package's optax optimizers, through five training steps.

Each case trains the trivial model (batch 2 at 227 px) or the small
ResNet-50 v1.5 (``(1, 2, 1, 1)``, batch 2 at 64 px) from one converted flax
init on one numpy batch: the port's ``TrainStep`` (softmax cross-entropy
plus weight decay, the optimizer of ``--optimizer``, ``--gradient_clip``)
against ``kf_benchmarks_tpu.optimizers.get_optimizer`` +
``optax.apply_updates`` on the JAX package's loss, both at a rate that
changes from step to step: a linear warmup over the first epoch, or a
piecewise schedule that drops after it (an epoch of 3 to 5 steps).

Tolerances (those of tests/test_torch_train_step.py): the trivial model has
no batch norm, so f32 rounding alone separates the frameworks -- losses
within rtol 1e-5, every parameter within 1e-5 of its largest element and
its total update within 1e-4 of the JAX update's norm (plus 4 f32 ulps of
the parameter's norm, for updates that small). The rates keep the five
steps gentle: the JAX package's f32 forward already differs from the
port's by 2.7e-6 in the first loss (the port's f32 agrees with its own f64
to 3e-8), and large steps through the model's one-unit ReLU bottleneck
amplify that. Five ResNet steps at batch 2 are
chaotic in f32 (batch norm over two samples amplifies rounding), so there
the losses and the parameters (as one vector) are held within 1e-2; and
each step's update is held apart from that chaos: the port's clip and
optimizer, fed the JAX step's weights and gradients, must give its update
within 1e-5 of its norm (plus 4 f32 ulps of the weights' norm, which the
update must pass tenfold).

Planted faults, each in a copy of the port run in a subprocess, must fail
the trivial-model check: rmsprop's eps outside the square root (torch's
RMSprop), rmsprop's momentum applied before the rate (torch's order), and
a global-norm clip in place of the elementwise one.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kf_benchmarks_tpu import learning_rate as jax_lr
from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.models import trivial_model as jax_trivial
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet
from kf_benchmarks_tpu_torch.models import trivial_model as port_trivial

import torch_parity as tp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT_DECAY = 1e-3
STEPS = 5
BATCH = 2
# Base rates: the trivial MLP sees raw pixel values (0..255), so plain SGD
# steps must be tiny there; the adaptive optimizers and LARS scale their
# own steps.
RATES = {
    "trivial": {"sgd": 1e-8, "momentum": 1e-8, "rmsprop": 1e-6,
                "adam": 3e-7, "lars": 0.2},
    "resnet": {"sgd": 0.01, "momentum": 0.01, "rmsprop": 1e-3,
               "adam": 1e-3, "lars": 1.0},
}
# Clip magnitudes that bind: the trivial model's gradients reach 1e3, the
# ResNet's 1e-1 at this size.
CLIPS = {"trivial": 1.0, "resnet": 0.01}
# (flags, examples per epoch): warmup over one epoch of 5 steps; a
# piecewise drop to a quarter after one epoch of 3 steps.
SCHEDULES = {
    "warmup": (lambda lr: dict(init_learning_rate=lr,
                               num_learning_rate_warmup_epochs=1.0), 10),
    "piecewise": (lambda lr: dict(
        piecewise_learning_rate_schedule=f"{lr};1;{lr / 4}"), 6),
}


def _models(name):
  if name == "trivial":
    return jax_trivial.TrivialModel(), port_trivial.TrivialModel()
  return (jax_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS),
          port_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS))


def _flags(name, optimizer, schedule, clip):
  make, examples = SCHEDULES[schedule]
  flags = dict(optimizer=optimizer, **make(RATES[name][optimizer]))
  if clip:
    flags["gradient_clip"] = CLIPS[name]
  return flags, examples


def _jax_run(model, variables, images, labels, flags, examples):
  module = model.make_module(nclass=tp.NCLASS, phase_train=True)
  p = jax_params.make_params(**flags)
  lr_fn = jax_lr.make_learning_rate_fn(p, model, BATCH, examples)
  tx = jax_optimizers.get_optimizer(p, lr_fn)

  def loss_fn(params, bs):
    (logits, aux), upd = module.apply({"params": params, "batch_stats": bs},
                                      jnp.asarray(images),
                                      mutable=["batch_stats"])
    base = model.loss_function(BuildNetworkResult(logits=(logits, aux)),
                               jnp.asarray(labels))
    return (base + WEIGHT_DECAY * jax_train_step.l2_loss(params),
            upd["batch_stats"])

  @jax.jit
  def step(params, bs, opt_state):
    (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, bs)
    updates, opt_state = tx.update(grads, opt_state, params)
    return (optax.apply_updates(params, updates), new_bs, opt_state, loss,
            grads)

  params, bs = variables["params"], variables.get("batch_stats", {})
  opt_state = tx.init(params)
  losses, trajectory = [], []
  for _ in range(STEPS):
    before = (params, bs)
    params, bs, opt_state, loss, grads = step(params, bs, opt_state)
    trajectory.append(jax.device_get(before + (grads, params)))
    losses.append(float(loss))
  return losses, tp.flat_flax(jax.device_get(params)), trajectory


def _port_run(model, variables, images, labels, flags, examples):
  module = model.make_module(tp.NCLASS, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  p = port_params.make_params(device="cpu", **flags)
  opt = port_optimizers.get_optimizer(p, module.parameters())
  lr_fn = port_lr.make_learning_rate_fn(p, model, BATCH, examples)
  step = port_train_step.TrainStep(model, module, opt, lr_fn, WEIGHT_DECAY,
                                   gradient_clip=p.gradient_clip)
  x = torch.from_numpy(images)
  y = torch.from_numpy(labels).long()
  rates, losses = [], []
  for _ in range(STEPS):
    m = step(x, y)
    losses.append(float(m["total_loss"]))
    rates.append(float(m["learning_rate"]))
  assert len(set(rates)) > 1  # the rate did change
  params = {}
  for key, q in module.named_parameters():
    _, layer, leaf, kind = convert.leaf_of(key, q)
    params[(layer, leaf)] = convert.to_flax_layout(q.detach().numpy(), kind)
  return losses, params


def _flax_layout(module, of):
  """{(layer, leaf): numpy} of ``of(parameter)`` for every parameter of
  the port's ``module``, in flax layout."""
  out = {}
  for key, q in module.named_parameters():
    _, layer, leaf, kind = convert.leaf_of(key, q)
    out[(layer, leaf)] = convert.to_flax_layout(of(q).detach().numpy(), kind)
  return out


def forced_update_errors(model, trajectory, flags, examples):
  """{what: (error, limit)} of each step's update by the port's optimizer,
  fed the JAX step's weights and gradients: the two calls of the port's
  TrainStep after the gradient (``clip_gradients_`` under
  --gradient_clip, then the optimizer's step at the step's rate), from the
  port's own optimizer state. The same inputs leave f32 rounding alone
  between the frameworks: each update within 1e-5 of the JAX update's
  norm, plus 4 f32 ulps of the weights' norm."""
  module = model.make_module(tp.NCLASS, torch.float32)
  p = port_params.make_params(device="cpu", **flags)
  opt = port_optimizers.get_optimizer(p, module.parameters())
  lr_fn = port_lr.make_learning_rate_fn(p, model, BATCH, examples)
  out = {}
  for k, (params, bs, grads, after) in enumerate(trajectory):
    module.load_state_dict(convert.flax_to_state_dict(
        {"params": params, "batch_stats": bs}, module))
    grad_sd = convert.flax_to_state_dict(
        {"params": grads, "batch_stats": bs}, module)
    for key, q in module.named_parameters():
      q.grad = grad_sd[key].clone()
    if p.gradient_clip is not None:
      port_optimizers.clip_gradients_(
          [q.grad for q in module.parameters()], p.gradient_clip)
    for group in opt.param_groups:
      group["lr"] = lr_fn(k)
    opt.step()
    got = _flax_layout(module, lambda q: q)
    w0, w1 = tp.flat_flax(params), tp.flat_flax(after)
    keys = sorted(w0)
    d_ref = np.concatenate([(w1[key] - w0[key]).ravel() for key in keys])
    d_got = np.concatenate([(got[key] - w0[key]).ravel() for key in keys])
    floor = 4 * 2.0 ** -24 * float(np.linalg.norm(
        np.concatenate([w1[key].ravel() for key in keys])))
    if lr_fn(k):
      # The update is well above the floor: no step passes by moving
      # too little to see.
      assert np.linalg.norm(d_ref) >= 10 * floor, k
    out[f"step {k} update"] = (float(np.linalg.norm(d_got - d_ref)),
                               1e-5 * float(np.linalg.norm(d_ref)) + floor)
  return out


def parity_errors(name, optimizer, schedule, clip, seed=12):
  """{what: (error, limit)} of the port's five steps against the JAX
  package's; an empty dict of failures is ``{k: v for k, v in ...
  if v[0] > v[1]}``."""
  jmodel, pmodel = _models(name)
  size = 227 if name == "trivial" else 64
  images, labels = tp.batch(BATCH, size, seed=seed)
  module = jmodel.make_module(nclass=tp.NCLASS, phase_train=True)
  variables = jax.device_get(
      module.init(jax.random.PRNGKey(seed), jnp.asarray(images)))
  init = tp.flat_flax(variables["params"])
  flags, examples = _flags(name, optimizer, schedule, clip)
  jax_losses, jax_p, trajectory = _jax_run(jmodel, variables, images,
                                           labels, flags, examples)
  port_losses, port_p = _port_run(pmodel, variables, images, labels, flags,
                                  examples)
  assert set(port_p) == set(jax_p) == set(init)
  loss_err = float(np.max(np.abs(np.subtract(port_losses, jax_losses)) /
                          np.abs(jax_losses)))
  out = {}
  if name == "trivial":
    out["losses"] = (loss_err, 1e-5)
    for key, p0 in init.items():
      ref = jax_p[key]
      out[f"{key} value"] = (float(np.max(np.abs(port_p[key] - ref)) /
                                   np.max(np.abs(ref))), 1e-5)
      d_ref = ref - p0
      assert np.linalg.norm(d_ref) > 0, key  # every layer trained
      # Within 1e-4 of the update, or 4 f32 ulps of the values where the
      # update is that small (torch_parity.check_rank_against_replica).
      out[f"{key} update"] = (
          float(np.linalg.norm(port_p[key] - p0 - d_ref)),
          1e-4 * float(np.linalg.norm(d_ref)) +
          4 * 2.0 ** -24 * float(np.linalg.norm(ref)))
  else:
    out["losses"] = (loss_err, 1e-2)
    keys = sorted(init)
    got = np.concatenate([port_p[k].ravel() for k in keys])
    ref = np.concatenate([jax_p[k].ravel() for k in keys])
    out["parameters"] = (float(np.linalg.norm(got - ref) /
                               np.linalg.norm(ref)), 1e-2)
    out.update(forced_update_errors(pmodel, trajectory, flags, examples))
  return out


def _failures(errors):
  return {k: v for k, v in errors.items() if not v[0] <= v[1]}


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("optimizer",
                         ["sgd", "momentum", "rmsprop", "adam", "lars"])
def test_trivial_model_matches_optax(optimizer, schedule, clip):
  assert _failures(parity_errors("trivial", optimizer, schedule, clip)) == {}


@pytest.mark.parametrize("optimizer,schedule,clip", [
    ("rmsprop", "warmup", False), ("rmsprop", "piecewise", True),
    ("adam", "piecewise", False), ("adam", "warmup", True),
    ("lars", "warmup", False), ("lars", "piecewise", True)])
def test_resnet_matches_optax(optimizer, schedule, clip):
  assert _failures(parity_errors("resnet", optimizer, schedule, clip)) == {}


def test_lars_trust_ratio_is_one_at_zero_norms():
  """A zero tensor (a zero-initialised bias) and a zero gradient step at
  ratio 1, as optax's safe trust ratio does."""
  w = [torch.nn.Parameter(torch.zeros(3)),
       torch.nn.Parameter(torch.ones(2))]
  w[0].grad = torch.tensor([1.0, -2.0, 0.5])
  w[1].grad = torch.zeros(2)
  opt = port_optimizers.LARS(w, lr=0.1, momentum=0.9)
  opt.step()
  tx = optax.lars(0.1, momentum=0.9)
  params = [jnp.zeros(3), jnp.ones(2)]
  upd, _ = tx.update([jnp.asarray(q.grad.numpy()) for q in w],
                     tx.init(params), params)
  for q, p0, u in zip(w, params, upd):
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(p0 + u),
                               rtol=1e-6)
  np.testing.assert_allclose(w[0].detach().numpy(), [-0.1, 0.2, -0.05],
                             rtol=1e-6)


PLANTS = {
    "rmsprop_eps_outside_sqrt": (
        "optimizers.py",
        "      upd = torch._foreach_add(nu, group[\"eps\"])\n"
        "      torch._foreach_rsqrt_(upd)\n",
        "      upd = torch._foreach_sqrt(nu)\n"
        "      torch._foreach_add_(upd, group[\"eps\"])\n"
        "      torch._foreach_reciprocal_(upd)\n",
        ("rmsprop", "warmup", False)),
    "rmsprop_momentum_before_rate": (
        "optimizers.py",
        "      torch._foreach_mul_(upd, -group[\"lr\"])\n"
        "      if group[\"momentum\"]:\n"
        "        trace = [st[\"trace\"] for st in state]\n"
        "        torch._foreach_mul_(trace, group[\"momentum\"])\n"
        "        torch._foreach_add_(trace, upd)\n"
        "        upd = trace\n",
        "      if group[\"momentum\"]:\n"
        "        trace = [st[\"trace\"] for st in state]\n"
        "        torch._foreach_mul_(trace, group[\"momentum\"])\n"
        "        torch._foreach_add_(trace, upd)\n"
        "        upd = [t.clone() for t in trace]\n"
        "      torch._foreach_mul_(upd, -group[\"lr\"])\n",
        ("rmsprop", "warmup", False)),
    "global_norm_clip": (
        "optimizers.py",
        "    torch._foreach_clamp_min_(grads, -clip)\n"
        "    torch._foreach_clamp_max_(grads, clip)\n",
        "    norm = torch.stack(torch._foreach_norm(grads)).norm()\n"
        "    torch._foreach_mul_(grads, torch.clamp(clip / norm, max=1.0))\n",
        ("sgd", "piecewise", True)),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_planted_fault_fails(plant, tmp_path):
  fname, old, new, case = PLANTS[plant]
  copy = tmp_path / "copy"
  shutil.copytree(os.path.join(REPO, "kf_benchmarks_tpu_torch"),
                  copy / "kf_benchmarks_tpu_torch",
                  ignore=shutil.ignore_patterns("__pycache__", "csrc"))
  src = copy / "kf_benchmarks_tpu_torch" / fname
  text = src.read_text()
  assert text.count(old) == 1, plant
  src.write_text(text.replace(old, new))
  # The unplanted case passes (test_trivial_model_matches_optax).
  code = ("import sys; sys.path[:0] = sys.argv[1:4]; "
          "import test_torch_optimizers as t; "
          f"print('FAILED', sorted(t._failures(t.parity_errors('trivial', "
          f"*{case!r}))))")
  out = subprocess.run(
      [sys.executable, "-c", code, str(copy), os.path.join(REPO, "tests"),
       REPO],
      capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
      env={**os.environ, "OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"})
  assert out.returncode == 0, out.stderr[-3000:]
  line = [x for x in out.stdout.splitlines() if x.startswith("FAILED")][-1]
  assert line != "FAILED []", plant
