"""The port's synchronous data-parallel step on the small ResNet-50 against
the JAX package's, on the CPU.

Two gloo ranks (tests/torch_dp_worker.py, spawned once for the file) run
``replicated`` and ``kungfu --kungfu_option=sync_sgd`` on the full-width
(1, 2, 1, 1) ResNet-50 v1.5 of tests/torch_parity.py, whose two stride-1
conv_b units run as the fused unit, for two steps from one flax init,
each rank on its own batch of 2 at 64x64; the JAX side is the JAX
package's ``make_step_fns`` on a 2-device CPU mesh. Held: the per-step
losses at rtol 1e-5 and every rank's batch-norm running averages (averaged
over the ranks after each step) at 1e-5 of their largest value against the
JAX replica's; every rank's weight update (final minus initial weights)
within 3e-2 of the JAX replica's per tensor and 1e-2 over the whole model,
in relative L2 norm; and both ranks bitwise equal after every step. The
update limits are those of the single-device gradients
(tests/test_torch_resnet.py: max(1e-3, 3x the port's own f32-vs-f64
distance), which reaches ~1e-2 in the blocks where batch norm cancels most
of the gradient); the worst tensor here is at 7.3e-3 and the model at
3.8e-3. A wrong reduction (a missing mean, local gradients) moves them by
O(1).

Two steps: the second step's loss is the first after a reduced update and
matches to ~2e-6. A third step amplifies f32 rounding chaotically at batch
2 (batch norm over two samples; tests/test_torch_train_step.py measures the
same on one device): its loss moves by ~3e-4 in either framework's own
f32-vs-f64 runs, so it would hold rounding, not the strategy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import resnet_model as jax_resnet

import torch_dp_worker as worker
import torch_parity as tp

WORLD = 2
SIZE = 64
SEED = 5
LR = 1e-4
STEPS = 2
CASES = (
    ("replicated", dict(variable_update="replicated")),
    ("kungfu_sync_sgd", dict(variable_update="kungfu",
                             kungfu_option="sync_sgd")),
)
_RESULTS = {}


def _flags(flags):
  return {"optimizer": "momentum", "momentum": 0.9, **flags}


def _jax_model():
  model = jax_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS)
  return model, model.make_module(nclass=tp.NCLASS, phase_train=True)


def _batches():
  return worker.batches(WORLD, 2, SIZE, seed=SEED)


def _variables():
  _, module = _jax_model()
  # Jitted: flax's op-by-op init of this net takes ~14 s on the CPU.
  return jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(SEED),
                                             jnp.asarray(_batches()[0][0])))


def torch_results(tmp_path_factory):
  if not _RESULTS:
    variables = _variables()
    cases = [dict(name=name, model="resnet", params=_flags(flags), lr=LR,
                  steps=STEPS, variables=variables, batches=_batches())
             for name, flags in CASES]
    _RESULTS["variables"] = variables
    _RESULTS["ranks"] = worker.run_world(WORLD, cases,
                                         tmp_path_factory.mktemp("resnet"))
  return _RESULTS["variables"], _RESULTS["ranks"]


def test_resnet_ranks_bitwise_equal_every_step(tmp_path_factory):
  """Torch against torch, first in the file so that it pays for the spawn
  and the JAX compiles fall on the tests below."""
  _, results = torch_results(tmp_path_factory)
  for name, _ in CASES:
    for step in range(STEPS):
      assert torch.equal(results[0][name]["weights"][step],
                         results[1][name]["weights"][step]), (name, step)


@pytest.mark.parametrize("name,flags", CASES, ids=[c[0] for c in CASES])
def test_resnet_strategy_matches_jax(name, flags, tmp_path_factory):
  variables, results = torch_results(tmp_path_factory)
  jax_losses, jax_params_r, jax_stats_r = tp.jax_dp_run(
      WORLD, _flags(flags), variables, _batches(), STEPS, LR, _jax_model())
  init = tp.flat_flax(variables["params"])
  for rank, res in enumerate(results):
    got = res[name]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5,
                               err_msg=f"{name} rank {rank} losses")
    ref = tp.flat_flax(jax_params_r[rank])
    assert set(ref) == set(init)
    keys = sorted(init)
    update = lambda t, k: t[k] - init[k]
    for key in keys:
      d_ref = update(ref, key)
      err = np.linalg.norm(update(got["final"], key) - d_ref)
      assert err <= 3e-2 * np.linalg.norm(d_ref), (name, rank, key)
    whole = lambda t: np.concatenate([update(t, k).ravel() for k in keys])
    d_ref = whole(ref)
    assert (np.linalg.norm(whole(got["final"]) - d_ref) <=
            1e-2 * np.linalg.norm(d_ref)), (name, rank)
    ref_stats = tp.flat_flax(jax_stats_r[rank])
    assert set(ref_stats) == set(got["final"]) - set(init)
    for key, r in ref_stats.items():
      np.testing.assert_allclose(got["final"][key], r, rtol=1e-5,
                                 atol=1e-5 * np.abs(r).max(),
                                 err_msg=f"{name} rank {rank} {key}")
