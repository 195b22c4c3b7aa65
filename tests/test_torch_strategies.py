"""The port's data-parallel strategies against the JAX package's, on the CPU.

One gloo world of 2 ranks and one of 4 (tests/torch_dp_worker.py, spawned
once each for the whole file) run every ported --variable_update on the
trivial model for three steps, from one flax init, each rank on its own
numpy batch. The JAX side is the JAX package's ``make_step_fns`` on a
virtual CPU mesh of the same size, fed the same weights and the ranks'
batches as its replicas' shards. Held at f32: the per-step losses (the mean
over the ranks) at rtol 1e-5, every rank's final weights at rtol 1e-5 and
each rank's update (final minus initial weights) within 1e-3 of the JAX
replica's, relative to its norm, plus four f32 ulps of the weights' norm:
the updates of some layers here are 1e-8..1e-4 of their weights, where f32
rounding of the weights alone moves the update by up to its whole size. A
strategy fault (a missing mean, a wrong gossip partner) moves the losses,
and every update well above the weights' rounding, by O(1). The sum orders
of gloo and XLA differ, so this is a tolerance, not bit identity.

Pinned torch against torch, from the same runs: replicated ranks hold
bitwise-equal weights after every step, independent ranks diverge,
``broadcast_init`` gives every rank rank 0's bits, and ``pair_average``
keeps the mean over the ranks to f32 rounding while it moves every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import trivial_model as jax_trivial
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch.parallel import kungfu

import torch_dp_worker as worker
import torch_parity as tp

STEPS = 3
# Standard-normal images: on raw pixel values the trivial MLP's
# 154587-wide first layer drives the loss to ~60 and its one-unit ReLU
# bottleneck dies within a step at any rate that moves it, which leaves
# nothing to compare. At 3e-6 on unit-scale inputs all three steps train.
LR = 3e-6
SEED = 21

# (case name, flags): every ported --variable_update, the async parameter
# server with and without optimizer state (momentum buffers; Adam's moments
# and count), and the spec planner.
CASES = (
    ("independent", dict(variable_update="independent")),
    ("replicated", dict(variable_update="replicated")),
    ("parameter_server", dict(variable_update="parameter_server")),
    ("async_ps_momentum", dict(variable_update="parameter_server",
                               cross_replica_sync=False)),
    ("async_ps_sgd", dict(variable_update="parameter_server",
                          cross_replica_sync=False, optimizer="sgd")),
    # Each of a round's n Adam applications sees the round's update count
    # (optax's bias correction under the JAX package's
    # _sync_schedule_counts).
    ("async_ps_adam", dict(variable_update="parameter_server",
                           cross_replica_sync=False, optimizer="adam")),
    ("collective_all_reduce", dict(variable_update="collective_all_reduce")),
    ("distributed_all_reduce", dict(variable_update="distributed_all_reduce",
                                    all_reduce_spec="psum:32k:rsag#2")),
    ("horovod", dict(variable_update="horovod")),
    ("kungfu_sync_sgd", dict(variable_update="kungfu",
                             kungfu_option="sync_sgd")),
    ("kungfu_async_sgd", dict(variable_update="kungfu",
                              kungfu_option="async_sgd")),
    ("kungfu_sma", dict(variable_update="kungfu", kungfu_option="sma")),
)
WORLDS = (2, 4)


def _flags(flags):
  return {"optimizer": "momentum", "momentum": 0.9, **flags}


def _jax_model():
  model = jax_trivial.TrivialModel()
  return model, model.make_module(nclass=worker.NCLASS, phase_train=True)


def _init_variables():
  _, module = _jax_model()
  sample = jnp.zeros((1, 227, 227, 3), jnp.float32)
  return jax.device_get(module.init(jax.random.PRNGKey(SEED), sample))


_VARIABLES = _init_variables()
_RESULTS = {}


def _batches(world):
  return worker.batches(world, 2, 227, seed=SEED * 10 + world, pixels=False)


def _stacked(world):
  """Replica r's start: the init scaled by 1 + r/100, so every rank starts
  from its own weights (convert.replica_state_dict)."""
  return jax.tree.map(
      lambda x: np.stack([x * (1 + r / 100) for r in range(world)]),
      _VARIABLES)


def torch_results(world, tmp_path_factory):
  """Every case at ``world`` ranks, from one spawn. The first test of a
  world pays for it, so the torch-only tests come first in the file and
  the JAX compiles fall on the later ones."""
  if world not in _RESULTS:
    cases = [dict(name=name, model="trivial", params=_flags(flags), lr=LR,
                  steps=STEPS, variables=_VARIABLES,
                  batches=_batches(world)) for name, flags in CASES]
    cases.append(dict(name="independent_from_replicas", model="trivial",
                      params=_flags(dict(variable_update="independent")),
                      lr=LR, steps=STEPS, stacked=_stacked(world),
                      batches=_batches(world)))
    cases.append(dict(name="broadcast_init", variables=_VARIABLES))
    cases.append(dict(name="pair_average", steps=2 * world))
    _RESULTS[world] = worker.run_world(
        world, cases, tmp_path_factory.mktemp(f"world{world}"))
  return _RESULTS[world]


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_ranks_bitwise_equal_every_step(world, tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  for name in ("replicated", "kungfu_sync_sgd", "parameter_server",
               "async_ps_momentum", "async_ps_sgd", "collective_all_reduce",
               "distributed_all_reduce", "horovod"):
    for step in range(STEPS):
      ref = results[0][name]["weights"][step]
      for rank in range(1, world):
        assert torch.equal(results[rank][name]["weights"][step], ref), \
            (name, step, rank)


@pytest.mark.parametrize("world", WORLDS)
def test_independent_and_gossip_ranks_diverge(world, tmp_path_factory):
  """Each rank steps on its own batch. At two ranks one pair average makes
  both ranks equal, so async_sgd diverges only from four ranks on."""
  results = torch_results(world, tmp_path_factory)
  names = ["independent", "kungfu_sma"]
  if world > 2:
    names.append("kungfu_async_sgd")
  for name in names:
    final = [r[name]["weights"][-1] for r in results]
    for rank in range(1, world):
      assert not torch.equal(final[rank], final[0]), (name, rank)


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_init_gives_rank0_bits(world, tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  rank0 = results[0]["broadcast_init"]["before"]
  for rank, res in enumerate(results):
    assert torch.equal(res["broadcast_init"]["after"], rank0), rank
    if rank:
      assert not torch.equal(res["broadcast_init"]["before"], rank0)


@pytest.mark.parametrize("world", WORLDS)
def test_pair_average_keeps_the_mean(world, tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  hist = np.stack([np.stack([h.numpy() for h in r["pair_average"]["history"]])
                   for r in results])  # [rank, step, value]
  mean0 = hist[:, 0].astype(np.float64).mean(0)
  scale = np.abs(hist[:, 0]).max()
  for step in range(1, hist.shape[1]):
    # Each round: x_i <- (x_i + x_{i-shift}) / 2, bit for bit as in f32.
    shift = kungfu.gossip_shift(step - 1, world)
    prev = hist[:, step - 1]
    want = (np.float32(0.5) * (prev + np.roll(prev, shift, axis=0)))
    np.testing.assert_array_equal(hist[:, step], want)
    if step == 1:
      assert not np.array_equal(hist[:, step], prev)
    mean = hist[:, step].astype(np.float64).mean(0)
    assert np.abs(mean - mean0).max() <= 4 * step * 2.0 ** -24 * scale


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,flags", CASES, ids=[c[0] for c in CASES])
def test_strategy_matches_jax(world, name, flags, tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  jax_losses, jax_params_r, _ = tp.jax_dp_run(
      world, _flags(flags), _VARIABLES, _batches(world), STEPS, LR,
      _jax_model())
  init = tp.flat_flax(_VARIABLES["params"])
  for rank, res in enumerate(results):
    got = res[name]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5,
                               err_msg=f"{name} rank {rank} losses")
    final = {k: v for k, v in got["final"].items() if k in init}
    tp.check_rank_against_replica(final, tp.flat_flax(jax_params_r[rank]),
                                  init, f"{name} world {world} rank {rank}")
  assert results[0][name]["losses"][-1][0] < results[0][name]["losses"][0][0]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_start_from_their_jax_replicas(world, tmp_path_factory):
  """Rank r starts from row r of a replica-stacked JAX state (every row
  different) and ends where the JAX package's replica r ends."""
  results = torch_results(world, tmp_path_factory)
  stacked = _stacked(world)
  jax_losses, jax_params_r, _ = tp.jax_dp_run(
      world, _flags(dict(variable_update="independent")), stacked,
      _batches(world), STEPS, LR, _jax_model(), stacked=True)
  for rank, res in enumerate(results):
    got = res["independent_from_replicas"]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5)
    init = tp.flat_flax(convert.replica_variables(stacked, rank)["params"])
    final = {k: v for k, v in got["final"].items() if k in init}
    tp.check_rank_against_replica(final, tp.flat_flax(jax_params_r[rank]),
                                  init, f"world {world} rank {rank}")


def test_gossip_schedule_matches_jax():
  from kf_benchmarks_tpu.parallel import kungfu as jax_kungfu
  for n in (1, 2, 3, 4, 8, 9, 16, 33):
    for step in range(3 * n):
      assert kungfu.gossip_shift(step, n) == int(
          jax_kungfu.gossip_shift(step, n)), (n, step)
    if n > 1:
      assert kungfu.gossip_offsets(n) == jax_kungfu._gossip_offsets(n)
