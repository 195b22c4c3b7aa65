"""The port's learning-rate policy (kf_benchmarks_tpu_torch/learning_rate.py)
against the JAX package's make_learning_rate_fn, at every step of a run
that crosses every boundary, for each branch of the policy and for 1 and 4
workers.

The epoch is cut to 1,000 examples so that decay, warmup and piecewise
boundaries fall within a few hundred steps. The JAX package evaluates the
rate in f32 and the port in Python floats: the rates agree to f32
rounding, and no step of these schedules lies within f32 rounding of a
boundary.
"""

import numpy as np
import pytest

from kf_benchmarks_tpu import learning_rate as jax_lr
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet

EXAMPLES = 1000
BATCH = 8

BRANCHES = {
    "model_default": {},
    "model_default_warmup": dict(num_learning_rate_warmup_epochs=1.5),
    "init": dict(init_learning_rate=0.3),
    "init_warmup": dict(init_learning_rate=0.3,
                        num_learning_rate_warmup_epochs=0.5),
    "decay": dict(init_learning_rate=0.4, num_epochs_per_decay=0.5,
                  learning_rate_decay_factor=0.5),
    "decay_floor": dict(init_learning_rate=0.4, num_epochs_per_decay=0.25,
                        learning_rate_decay_factor=0.3,
                        minimum_learning_rate=0.01,
                        num_learning_rate_warmup_epochs=0.3),
    "piecewise": dict(piecewise_learning_rate_schedule="0.5;1;0.1;2;0.01"),
    "piecewise_one": dict(piecewise_learning_rate_schedule="0.25"),
}


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_every_step_matches_jax(branch, workers):
  flags = BRANCHES[branch]
  # The model default is ResNet-50's schedule, which scales with the batch
  # and warms up over its own epochs.
  jm = jax_resnet.ResnetModel("resnet50_v1.5", (3, 4, 6, 3))
  pm = port_resnet.ResnetModel("resnet50_v1.5", (3, 4, 6, 3))
  ref_fn = jax_lr.make_learning_rate_fn(
      jax_params.make_params(**flags), jm, BATCH, EXAMPLES, workers)
  # The port passes the effective batch: the per-rank batch times the
  # ranks.
  got_fn = port_lr.make_learning_rate_fn(
      port_params.make_params(**flags), pm,
      port_lr.effective_batch_size(BATCH, workers, True), EXAMPLES)
  steps_per_epoch = EXAMPLES / (BATCH * workers)
  last = int(3 * steps_per_epoch) + 2
  ref = np.array([float(ref_fn(s)) for s in range(last)])
  got = np.array([got_fn(s) for s in range(last)])
  np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
  assert len(set(np.round(got, 9))) > 1 or branch in ("init",
                                                      "piecewise_one")


def test_model_default_counts_the_effective_batch():
  """At 4 ranks of a strategy that averages over them the model's
  schedule sees the global batch (its rate scales with it); at 4 ranks
  that each train alone, the per-rank batch."""
  assert port_lr.effective_batch_size(BATCH, 4, True) == 4 * BATCH
  assert port_lr.effective_batch_size(BATCH, 4, False) == BATCH
  jm = jax_resnet.ResnetModel("resnet50_v1.5", (3, 4, 6, 3))
  pm = port_resnet.ResnetModel("resnet50_v1.5", (3, 4, 6, 3))
  ref = jax_lr.make_learning_rate_fn(jax_params.make_params(), jm, BATCH,
                                     1281167, 4)
  got = port_lr.make_learning_rate_fn(
      port_params.make_params(), pm,
      port_lr.effective_batch_size(BATCH, 4, True), 1281167)
  for s in (0, 10, 5000, 200000):
    assert got(s) == pytest.approx(float(ref(s)), rel=1e-6)


@pytest.mark.parametrize("bad", ["0.1;1", "x;1;0.1", "0.1;one;0.2",
                                 "0.1;2;0.2;2;0.3", "0.1;0;0.2",
                                 "0.1;-1;0.2", "0.1;1.5;0.2"])
def test_bad_piecewise_strings_raise_as_in_jax(bad):
  with pytest.raises(ValueError) as ref:
    jax_lr.parse_piecewise_schedule(bad)
  with pytest.raises(ValueError) as got:
    port_lr.parse_piecewise_schedule(bad)
  assert str(got.value) == str(ref.value)


def test_piecewise_parse_matches_jax():
  values, bounds = jax_lr.parse_piecewise_schedule("1;3;0.5;10;0.25")
  got_v, got_b = port_lr.parse_piecewise_schedule("1;3;0.5;10;0.25")
  assert got_v == list(values) and got_b == list(bounds)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_device_form_is_the_jax_rate(branch, workers):
  """The device form (a 0-d f32 count in, a 0-d f32 rate out, which the
  train step and its CUDA-graph replay read) is the JAX package's f32 rate
  bitwise at every step, and within two f32 ulps of the host form, which
  evaluates the same formulas in Python floats."""
  import torch
  flags = BRANCHES[branch]
  jm = jax_resnet.ResnetModel("resnet50_v1.5", (3, 4, 6, 3))
  pm = port_resnet.ResnetModel("resnet50_v1.5", (3, 4, 6, 3))
  ref_fn = jax_lr.make_learning_rate_fn(
      jax_params.make_params(**flags), jm, BATCH, EXAMPLES, workers)
  got_fn = port_lr.make_learning_rate_fn(
      port_params.make_params(**flags), pm,
      port_lr.effective_batch_size(BATCH, workers, True), EXAMPLES)
  last = int(3 * EXAMPLES / (BATCH * workers)) + 2
  ref = np.array([np.float32(ref_fn(s)) for s in range(last)])
  device = []
  for s in range(last):
    rate = got_fn(torch.tensor(float(s)))
    assert rate.dtype == torch.float32 and rate.shape == ()
    device.append(rate.item())
  device = np.array(device, np.float32)
  host = np.array([got_fn(s) for s in range(last)], np.float32)
  np.testing.assert_array_equal(device, ref)
  assert np.all(np.abs(device - host) <= 2 * np.spacing(np.abs(host)))
