"""Shared set-up of the port's parity tests: one ResNet built in both
frameworks from one flax init and fed one numpy batch."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.parallel import strategies as jax_strategies
from kf_benchmarks_tpu.parallel.mesh import build_mesh
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet

# Small-size ResNet-50 v1.5: full widths, one to two blocks per stage
# (two stride-1 conv_b units: stage 2's first block and stage 3's second).
LAYER_COUNTS = (1, 2, 1, 1)
NCLASS = 10
# Weight decay of the data-parallel parity runs (tests/torch_dp_worker.py
# uses the same).
DP_WEIGHT_DECAY = 1e-3


def batch(n, size, seed=0):
  """Synthetic images in the model's input range and labels, numpy."""
  rng = np.random.default_rng(seed)
  images = (np.clip(rng.normal(size=(n, size, size, 3)), -2, 2) * 60.0 +
            127.0).astype(np.float32)
  labels = rng.integers(0, NCLASS, n).astype(np.int32)
  return images, labels


def jax_model_and_variables(images, seed=0):
  model = jax_resnet.ResnetModel("resnet50_v1.5", LAYER_COUNTS)
  module = model.make_module(nclass=NCLASS, phase_train=True)
  variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(images))
  return model, jax.device_get(variables)


def port_module(variables):
  """The port's network (f32, CPU) holding the flax variables."""
  model = port_resnet.ResnetModel("resnet50_v1.5", LAYER_COUNTS)
  module = model.make_module(NCLASS, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  return model, module


def port_grads_in_flax_layout(module):
  """{(layer, leaf): numpy grad} of every parameter, in flax layout."""
  out = {}
  for key, p in module.named_parameters():
    _, layer, leaf, kind = convert.leaf_of(key, p)
    out[(layer, leaf)] = convert.to_flax_layout(p.grad.numpy(), kind)
  return out


def port_batch_stats(module):
  out = {}
  for key, b in module.named_buffers():
    _, layer, leaf, _ = convert.leaf_of(key, b)
    out[(layer, leaf)] = b.numpy()
  return out


def flat_flax(tree):
  """{(layer, leaf): numpy} of a two-level flax collection."""
  return {(layer, leaf): np.asarray(v)
          for layer, leaves in tree.items() for leaf, v in leaves.items()}


def jax_dp_run(world, flags, variables, batches, steps, lr,
               model_and_module, stacked=False):
  """(losses, per-replica final flax params, per-replica batch stats) of
  the JAX package's data-parallel step on a ``world``-device CPU mesh,
  every replica from ``variables`` (or, with ``stacked``, replica r from
  their row r)."""
  model, module = model_and_module
  p = jax_params.make_params(device="cpu", num_devices=world,
                             weight_decay=DP_WEIGHT_DECAY, **flags)
  mesh = build_mesh(world, "cpu")
  strategy = jax_strategies.get_strategy(p)
  tx = jax_optimizers.get_optimizer(p, lr)
  init_state, step, _, broadcast_init, _ = jax_train_step.make_step_fns(
      model, module, module, strategy, tx, lambda s: jnp.float32(lr), p,
      mesh)
  images = np.concatenate([b[0] for b in batches])
  labels = np.concatenate([b[1] for b in batches])
  state = init_state(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
  stack = lambda tree: jax.tree.map(
      lambda x: jnp.asarray(x) if stacked else jnp.broadcast_to(
          jnp.asarray(x)[None], (world,) + np.shape(x)), tree)
  state = state.replace(
      params=broadcast_init(stack(variables["params"])),
      batch_stats=stack(variables.get("batch_stats", {})))
  losses = []
  for _ in range(steps):
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels))
    losses.append((float(metrics["base_loss"]),
                   float(metrics["total_loss"])))
  params = jax.device_get(state.params)
  stats = jax.device_get(state.batch_stats)
  return (losses,
          [convert.replica_variables(params, r) for r in range(world)],
          [convert.replica_variables(stats, r) for r in range(world)])


def check_rank_against_replica(got, ref, init, what):
  """A rank's final weights (flax layout) against the JAX replica's."""
  assert set(got) == set(ref), what
  for key in ref:
    np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-7,
                               err_msg=f"{what} {key}")
    d_ref = ref[key] - init[key]
    err = np.linalg.norm(got[key] - init[key] - d_ref)
    limit = (1e-3 * np.linalg.norm(d_ref) +
             4 * 2.0 ** -24 * np.linalg.norm(ref[key]))
    assert err <= limit, (what, key, err, limit)
