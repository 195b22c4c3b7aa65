"""The step's stale modes in the port (train_step.TrainStep, --staged_vars
and --variable_consistency=relaxed) against the JAX package's
train_step.make_step_fns, on the CPU in f32.

The small ResNet-50 v1.5 (``(1, 2, 1, 1)``, batch 2 at 64 px, batch norm
on batch statistics) starts from one converted flax init and takes four
steps of one numpy batch, momentum at a fixed rate with weight decay:

* --staged_vars under parameter_server: the forward, the backward and the
  L2 term read the staged copy, the update lands on the live weights.
* --variable_consistency=relaxed under replicated: each step applies the
  previous step's gradients (zeros at the first) and banks its own.
* relaxed under the auto loss scale from 2^127: the first steps overflow
  f32, their gradients are not banked and nothing rolls back.

Held: every step's loss within 1e-4 relative, and after the last step,
each as one vector, the weights and the staged copy within 1e-2 of their
update from the init, the batch-norm averages within 1e-4, and the
momentum buffers and the bank within 3e-2 of the JAX package's. The
bounds are the repo's for this ResNet in f32 (tests/test_torch_grad_accum.py:
one step's update differs by 1.2e-2 between the frameworks, from the JAX
package's f32 gradients of the batch-norm stem); the momentum and the bank
are gradients, the update a rate times them. The strong step (the port's)
lands more than a tenth of the update away, so a mode left out fails.

Within the port, K = 8 steps of a TrainChunk are bitwise 8 single steps in
each mode (the CPU runs them one after another; the card replays the
captured step, phase dispatch of chip_smoke.py), every refusal carries
the JAX package's message, and a checkpoint round trip reseeds the staged
copy from the restored weights and starts the bank at zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import learning_rate as jax_lr
from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.parallel import strategies as jax_strategies
from kf_benchmarks_tpu.parallel.mesh import build_mesh
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch import validation

import torch_parity as tp

torch.set_num_threads(2)

STEPS = 4
BATCH = 2
WEIGHT_DECAY = 1e-3
EXAMPLES = 1000
BASE = dict(optimizer="momentum", init_learning_rate=0.002,
            weight_decay=WEIGHT_DECAY)
# (flags, steps): relaxed under the auto loss scale from 2^127 skips its
# first three steps (tests/test_torch_loss_scale.py) and banks from the
# fourth, so it runs six.
MODES = {
    "staged": (dict(variable_update="parameter_server", staged_vars=True),
               STEPS),
    "relaxed": (dict(variable_update="replicated",
                     variable_consistency="relaxed"), STEPS),
    "relaxed_auto": (dict(variable_update="replicated",
                          variable_consistency="relaxed", use_fp16=True,
                          fp16_enable_auto_loss_scale=True,
                          fp16_loss_scale=2.0 ** 127,
                          fp16_inc_loss_scale_every_n=2), 6),
    "strong": (dict(variable_update="replicated"), STEPS),
}


@functools.lru_cache(maxsize=None)
def _setup(seed=5):
  """The numpy batch and the converted flax init, shared by the tests."""
  images, labels = tp.batch(BATCH, 64, seed=seed)
  model, variables = tp.jax_model_and_variables(images, seed=seed)
  return images, labels, model, variables


def _vec(tree):
  flat = convert._flatten(tree)
  return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                         for k in sorted(flat)])


def _jax_run(flags, steps, model, variables, images, labels):
  """(losses, {what: flax tree}) after ``steps`` steps of the JAX step."""
  module = model.make_module(nclass=tp.NCLASS, phase_train=True)
  p = jax_params.make_params(device="cpu", num_devices=1, **BASE, **flags)
  lr_fn = jax_lr.make_learning_rate_fn(p, model, BATCH, EXAMPLES)
  tx = jax_optimizers.get_optimizer(p, lr_fn)
  init_state, step, _, broadcast_init, _ = jax_train_step.make_step_fns(
      model, module, module, jax_strategies.get_strategy(p), tx, lr_fn, p,
      build_mesh(1, "cpu"))
  stack = lambda tree: jax.tree.map(lambda x: jnp.asarray(x)[None], tree)
  state = init_state(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
  params = broadcast_init(stack(variables["params"]))
  buffers = dict(state.buffers)
  if "staged_params" in buffers:
    buffers["staged_params"] = jax.tree.map(jnp.copy, params)
  state = state.replace(params=params,
                        batch_stats=stack(variables["batch_stats"]),
                        buffers=buffers)
  losses = []
  for _ in range(steps):
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels))
    losses.append(float(np.asarray(metrics["total_loss"]).ravel()[0]))
  one = lambda tree: convert.replica_variables(jax.device_get(tree), 0)
  out = {"params": one(state.params),
         "batch_stats": one(state.batch_stats),
         "momentum": {}}
  for path, leaf in jax.tree_util.tree_flatten_with_path(
      jax.device_get(state.opt_state))[0]:
    if getattr(path[1], "name", None) == "trace":
      out["momentum"][tuple(k.key for k in path[2:])] = np.asarray(leaf)[0]
  for key in ("staged_params", "deferred_grads"):
    if key in state.buffers:
      out[key] = one(state.buffers[key])
  return losses, out


def _port_step(flags, variables):
  model, module = tp.port_module(variables)
  p = port_params.make_params(device="cpu", **BASE, **flags)
  opt = port_optimizers.get_optimizer(p, module.parameters())
  scale, auto = port_train_step.loss_scale_settings(p)
  step = port_train_step.TrainStep(
      model, module, opt, port_lr.make_learning_rate_fn(
          p, model, BATCH, EXAMPLES), WEIGHT_DECAY,
      loss_scale=scale, auto_loss_scale=auto,
      inc_loss_scale_every_n=p.fp16_inc_loss_scale_every_n,
      staged_vars=p.staged_vars,
      relaxed=p.variable_consistency == "relaxed")
  return module, opt, step


def _flax(module, tensors):
  """A list of tensors in module-parameter order, as a flax tree."""
  names = [k for k, _ in module.named_parameters()]
  state = dict(module.state_dict())
  state.update(zip(names, tensors))
  return convert.state_dict_to_flax(state, module)["params"]


def _port_run(flags, steps, variables, images, labels):
  module, opt, step = _port_step(flags, variables)
  x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
  losses = [float(step(x, y)["total_loss"]) for _ in range(steps)]
  state = convert.state_dict_to_flax(module.state_dict(), module)
  out = {"params": state["params"], "batch_stats": state["batch_stats"],
         "momentum": _flax(module, [opt.state[p]["momentum_buffer"]
                                    for p in module.parameters()])}
  if step.staged is not None:
    out["staged_params"] = _flax(module, step.staged)
  if step._bank is not None:
    out["deferred_grads"] = _flax(module, step._bank)
  return losses, out


def _close(got, ref, tol, scale=None):
  got, ref = _vec(got), _vec(ref)
  scale = np.linalg.norm(ref) if scale is None else scale
  assert got.shape == ref.shape
  return np.linalg.norm(got - ref) <= tol * scale


@pytest.mark.parametrize("mode", ["staged", "relaxed", "relaxed_auto"])
def test_stale_mode_matches_jax(mode):
  images, labels, model, variables = _setup()
  flags, steps = MODES[mode]
  jax_losses, ref = _jax_run(flags, steps, model, variables, images, labels)
  losses, got = _port_run(flags, steps, variables, images, labels)
  np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
  assert set(got) == set(ref)
  init = variables["params"]
  update = np.linalg.norm(_vec(ref["params"]) - _vec(init))
  assert update > 0
  assert _close(got["params"], ref["params"], 1e-2, update)
  assert _close(got["batch_stats"], ref["batch_stats"], 1e-4)
  assert _close(got["momentum"], ref["momentum"], 3e-2)
  if mode == "staged":
    staged_update = np.linalg.norm(_vec(ref["staged_params"]) - _vec(init))
    assert _close(got["staged_params"], ref["staged_params"], 1e-2,
                  staged_update)
  else:
    assert np.linalg.norm(_vec(ref["deferred_grads"])) > 0
    assert _close(got["deferred_grads"], ref["deferred_grads"], 3e-2)
  # The mode shows: the strong step's weights lie far from these.
  _, strong = _port_run(*MODES["strong"], variables, images, labels)
  assert np.linalg.norm(_vec(strong["params"]) - _vec(ref["params"])) > \
      0.1 * update


@pytest.mark.parametrize("flags", [
    dict(staged_vars=True, variable_update="replicated"),
    dict(staged_vars=True, variable_update="parameter_server",
         use_fp16=True, fp16_enable_auto_loss_scale=True),
    dict(staged_vars=True, variable_update="parameter_server",
         eval_during_training_every_n_steps=10),
    dict(variable_consistency="relaxed", variable_update="kungfu"),
    dict(variable_consistency="relaxed", variable_update="independent"),
    dict(staged_vars=True, variable_update="parameter_server",
         shard_optimizer_state=True),
    dict(variable_consistency="relaxed", shard_optimizer_state=True),
    dict(staged_vars=True, variable_update="parameter_server",
         num_grad_accum=2),
])
def test_refusals_carry_the_jax_message(flags):
  got = []
  for params_lib, valid in ((port_params, validation),
                            (jax_params, jax_validation)):
    with pytest.raises(valid.ParamError) as err:
      valid.validate_cross_flags(params_lib.make_params(device="cpu",
                                                        **flags))
    got.append(str(err.value))
  assert got[0] == got[1]


@pytest.mark.parametrize("mode", ["staged", "relaxed_auto"])
def test_chunk_of_eight_is_eight_single_steps(mode):
  """TrainChunk at K = 8 against 8 calls of the step, from one init: the
  metrics, the weights, the staged copy or the bank bitwise equal."""
  images, labels, _, variables = _setup()
  x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
  runs = []
  for k in (1, 8):
    module, _, step = _port_step(MODES[mode][0], variables)
    if k == 1:
      losses = torch.stack([step(x, y)["total_loss"] for _ in range(8)])
    else:
      losses = port_train_step.TrainChunk(step, 8)(x, y, 8)["total_loss"]
    state = (step.staged if step.staged is not None else step._bank)
    runs.append((losses, [q.detach().clone() for q in module.parameters()],
                 [t.clone() for t in state]))
  (l1, p1, s1), (l8, p8, s8) = runs
  assert torch.equal(l1, l8) and len(set(l1.tolist())) > 1
  assert all(torch.equal(a, b) for a, b in zip(p1 + s1, p8 + s8))


@pytest.mark.parametrize("mode", ["staged", "relaxed"])
def test_restore_reseeds_the_staged_copy_and_zeroes_the_bank(mode):
  """A checkpoint round trip through BenchmarkCNN.build: the restored
  step's staged copy is the restored weights (not the fresh init), and
  its bank starts at zero (the bank is not saved, as in the JAX
  package)."""
  from kf_benchmarks_tpu_torch import benchmark  # noqa: PLC0415
  p = port_params.make_params(model="trivial", device="cpu", batch_size=2,
                              num_batches=2, **MODES[mode][0])
  bench = benchmark.BenchmarkCNN(p)
  module, step, images, labels = bench.build()
  for _ in range(2):
    step(images, labels)
  snapshot = checkpoint.savable_state(module, step.optimizer,
                                      step.global_step, 0, step.counters())
  fresh = [q.detach().clone() for q in bench.build()[0].parameters()]
  module2, step2, _, _ = benchmark.BenchmarkCNN(p).build(snapshot=snapshot)
  weights = [q.detach() for q in module2.parameters()]
  assert step2.global_step == 2
  assert all(torch.equal(a, b) for a, b in
             zip(weights, [q.detach() for q in module.parameters()]))
  assert not all(torch.equal(a, b) for a, b in zip(weights, fresh))
  if mode == "staged":
    assert all(torch.equal(a, b) for a, b in zip(step2.staged, weights))
  else:
    assert any(torch.count_nonzero(b) for b in step._bank)
    assert not any(torch.count_nonzero(b) for b in step2._bank)
