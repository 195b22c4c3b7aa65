"""Shared set-up of the parity tests of the sharded optimizer state, the
sharded parameters and the overlapped reduction (tests/test_torch_sharded.py,
test_torch_fsdp.py, test_torch_overlap.py).

Three models, each built in both frameworks from one flax init, each rank
on its own numpy batch:

* the trivial model: standard-normal 227x227 images, 2 a rank, rate 3e-6,
  three steps (tests/test_torch_strategies.py's set-up);
* the small ResNet-50 v1.5 of tests/torch_parity.py, (1, 2, 1, 1) blocks at
  full width, 64x64 images, 2 a rank, rate 1e-4, two steps, the init and
  batches of tests/test_torch_strategies_resnet.py (a third step amplifies
  f32 rounding chaotically at batch 2, as that file notes);
* the two-layer transformer LM of tests/torch_dp_worker.py (``SmallLM``),
  2 sequences of 64 tokens a rank, rate 0.05, three steps.

Every run is Nesterov momentum at weight decay 1e-3. The JAX side is the
JAX package's REPLICATED step on a virtual CPU mesh of the same size
(tests/torch_parity.py ``jax_dp_run``); its own sharded, FSDP and
overlapped steps are not ground truth, because some of their own tests
fail on this jax. Tolerances: the trivial model and the LM at
test_torch_strategies.py's (losses rtol 1e-5; every rank's final weights
rtol 1e-5 and each rank's update within 1e-3 relative plus four f32 ulps,
``check_rank_against_replica``); the ResNet at
test_torch_strategies_resnet.py's at 2 ranks (losses rtol 1e-5, each
tensor's update within 3e-2 and the model's within 1e-2 relative,
batch-norm averages at 1e-5 of their largest value). At 4 ranks the port's
own replicated step is further from the JAX package's: 2.46e-5 relative
in the second step's base loss, 2.14e-2 in the model's update and 3.1e-5
of the largest value in the batch-norm averages (batch norm over two
samples amplifies f32 rounding; the overlapped step is at 2.44e-5 and
2.14e-2), so there the limits are 1e-4, 3e-2 and 1e-4 (``RESNET_LIMITS``).
At 2 ranks every mode is bitwise the port's replicated step. A wrong
reduction moves all of these by O(1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.models import transformer_lm as jax_lm
from kf_benchmarks_tpu.models import trivial_model as jax_trivial

import torch_dp_worker as worker
import torch_parity as tp

MODELS = ("trivial", "resnet", "lm")
WORLDS = (2, 4)
LR = {"trivial": 3e-6, "resnet": 1e-4, "lm": 0.05}
STEPS = {"trivial": 3, "resnet": 2, "lm": 3}
SEED = 31
RESNET_SIZE = 64
# The ResNet's init and batches are test_torch_strategies_resnet.py's.
RESNET_SEED = 5
FLAGS = dict(optimizer="momentum", momentum=0.9)
# The ResNet's limits by world: loss rtol, the model's update, batch-norm
# averages (relative to their largest value).
RESNET_LIMITS = {2: (1e-5, 1e-2, 1e-5), 4: (1e-4, 3e-2, 1e-4)}


def jax_model(model):
  if model == "trivial":
    m = jax_trivial.TrivialModel()
    return m, m.make_module(nclass=worker.NCLASS, phase_train=True)
  if model == "resnet":
    m = jax_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS)
    return m, m.make_module(nclass=worker.NCLASS, phase_train=True)
  m = jax_lm.TransformerLMModel()
  m.LOSS_CHUNK = worker.LM_LOSS_CHUNK
  return m, jax_lm._TransformerLMModule(
      vocab=worker.LM_VOCAB, d_model=worker.LM_D, n_layers=worker.LM_LAYERS,
      n_heads=worker.LM_HEADS, d_ff=worker.LM_DFF,
      attn_block=worker.LM_BLOCK, attn_q_block=worker.LM_BLOCK,
      max_len=worker.LM_T, attn_impl="flash", scan_layers=True,
      fused_head=True)


def batches(model, world):
  """One numpy (inputs, labels) batch per rank."""
  if model == "trivial":
    return worker.batches(world, 2, 227, seed=SEED * 10 + world,
                          pixels=False)
  if model == "resnet":
    return worker.batches(world, 2, RESNET_SIZE, seed=RESNET_SEED)
  out = []
  for r in range(world):
    rng = np.random.default_rng(SEED * 10 + world + r)
    tokens = rng.integers(0, worker.LM_VOCAB,
                          (2, worker.LM_T)).astype(np.int32)
    out.append((tokens, np.roll(tokens, -1, axis=1)))
  return out


@functools.lru_cache(maxsize=None)
def variables(model):
  _, module = jax_model(model)
  sample = jnp.asarray(batches(model, 1)[0][0][:1])
  seed = RESNET_SEED if model == "resnet" else SEED
  return jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed),
                                             sample))


def case(name, model, world, flags, **extra):
  """A tests/torch_dp_worker.py training case of ``model`` at ``world``
  ranks under ``flags`` (on top of FLAGS); ``extra`` adds or replaces
  case keys."""
  out = dict(name=name, model=model, params={**FLAGS, **flags},
             lr=LR[model], steps=STEPS[model], variables=variables(model),
             batches=batches(model, world))
  out.update(extra)
  return out


@functools.lru_cache(maxsize=None)
def jax_replicated(world, model):
  """(losses, per-replica final params, per-replica batch stats) of the
  JAX package's replicated step."""
  return tp.jax_dp_run(world, {**FLAGS, "variable_update": "replicated"},
                       variables(model), batches(model, world),
                       STEPS[model], LR[model], jax_model(model))


def _flat(tree):
  """{path: numpy} of a flax collection, with each layer of the scanned
  block stack as its own (path..., layer) entry (the keys of
  torch_dp_worker.flax_layout)."""
  out = {}
  for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
    key = tuple(p.key for p in path)
    v = np.asarray(v)
    if key[0] == "blocks":
      out.update({key + (i,): v[i] for i in range(v.shape[0])})
    else:
      out[key] = v
  return out


def check_matches_jax(model, world, results, name):
  """Every rank's run of case ``name`` against the JAX replicated step,
  at the model's tolerance (module notes)."""
  jax_losses, jax_params_r, jax_stats_r = jax_replicated(world, model)
  init = _flat(variables(model)["params"])
  for rank, res in enumerate(results):
    got = res[name]
    what = f"{name} world {world} rank {rank}"
    loss_rtol, model_rtol, stats_rtol = (
        RESNET_LIMITS[world] if model == "resnet" else (1e-5, None, None))
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=loss_rtol,
                               err_msg=f"{what} losses")
    final = {k: v for k, v in got["final"].items() if k in init}
    ref = _flat(jax_params_r[rank])
    if model != "resnet":
      tp.check_rank_against_replica(final, ref, init, what)
      continue
    assert set(ref) == set(init) == set(final), what
    keys = sorted(init)
    update = lambda t, k: t[k] - init[k]
    for key in keys:
      d_ref = update(ref, key)
      err = np.linalg.norm(update(final, key) - d_ref)
      assert err <= 3e-2 * np.linalg.norm(d_ref), (what, key)
    whole = lambda t: np.concatenate([update(t, k).ravel() for k in keys])
    d_ref = whole(ref)
    assert (np.linalg.norm(whole(final) - d_ref) <=
            model_rtol * np.linalg.norm(d_ref)), what
    for key, r in _flat(jax_stats_r[rank]).items():
      np.testing.assert_allclose(got["final"][key], r, rtol=1e-5,
                                 atol=stats_rtol * np.abs(r).max(),
                                 err_msg=f"{what} {key}")


def check_bitwise(results, name, ref_name):
  """Case ``name`` bitwise equal to case ``ref_name`` on every rank: the
  losses of every step and the weights after every dispatch."""
  for rank, res in enumerate(results):
    got, ref = res[name], res[ref_name]
    assert got["losses"] == ref["losses"], (name, rank)
    assert len(got["weights"]) == len(ref["weights"]), (name, rank)
    for i, (a, b) in enumerate(zip(got["weights"], ref["weights"])):
      assert torch.equal(a, b), (name, rank, i)


def shard_bytes(model, world, copies=1):
  """Sum over the model's parameters of ceil(size / n) f32 elements, times
  ``copies``: the bytes of one sharded tensor set on one rank."""
  module = worker.port_model(model).make_module(worker.NCLASS,
                                                torch.float32)
  return copies * sum(-(-p.numel() // world) * 4
                      for p in module.parameters())


def full_bytes(model):
  module = worker.port_model(model).make_module(worker.NCLASS,
                                                torch.float32)
  return sum(p.numel() * 4 for p in module.parameters())
