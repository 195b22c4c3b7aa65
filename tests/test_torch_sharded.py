"""The port's ZeRO sharded optimizer state (--shard_optimizer_state,
ops/sharded.py) against the JAX package's, on the CPU.

* The layout: ``stacked_shards`` gives arrays equal to the JAX package's
  on scalar, prime-sized and 4-D leaves at n = 1, 2, 3, 4 and 8.
* The step: one gloo world of 2 ranks and one of 4 (tests/torch_dp_worker.py,
  spawned once each for the file) run the sharded step and the port's
  replicated step on the three models of tests/torch_dp_modes.py. Held
  against the JAX package's replicated step at the module's tolerances;
  torch against torch, bitwise equal to the port's replicated step at 2
  ranks (the reduce-scatter's two-term sums commute), also at
  --steps_per_dispatch=4 (the trivial model and the LM) and
  --num_grad_accum=2. Each rank holds
  sum(ceil(size / n)) f32 elements of momentum between steps, and the whole
  parameters.
* Checkpoints (the two-layer LM under Adam, whose count is a 0-d state
  value): a world-2 checkpoint resumes bitwise equal to an uninterrupted
  run; restored at world 4 its optimizer state, desharded, is bitwise the
  world-2 state; a restore across layouts raises the JAX package's
  message.
* Validation: the exclusions refuse with the JAX package's messages, and
  the port's two (--elastic, --save_model_secs) with their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import checkpoint as jax_checkpoint
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.ops import sharded as jax_sharded
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.ops import sharded

import torch_dp_modes as modes
import torch_dp_worker as worker

ZERO = dict(shard_optimizer_state=True)
VARIANTS = {"": {}, "_k4": dict(k=4, steps=4),
            "_m2": dict(params_extra=dict(num_grad_accum=2))}
# (model, variant) pairs held bitwise at two ranks: every model at K = 1
# and M = 2, and K = 4 on the trivial model and the LM (the ResNet's four
# steps are the costliest CPU work of the file).
BITWISE = [(m, s) for m in modes.MODELS for s in VARIANTS
           if not (m == "resnet" and s == "_k4")]
ADAM = dict(optimizer="adam")
LEAVES = {"scalar": (), "prime": (7,), "prime_2d": (13, 3),
          "conv": (3, 3, 2, 5)}
_RESULTS = {}


def _mode_cases(world, mode_flags, mode):
  cases = []
  variants = VARIANTS if world == 2 else {"": {}}
  for model in modes.MODELS:
    for suffix, extra in variants.items():
      if (model, suffix) not in BITWISE:
        continue
      extra = dict(extra)
      flags = extra.pop("params_extra", {})
      for name, mf in (("replicated", {}), (mode, mode_flags)):
        c = modes.case(f"{model}_{name}{suffix}", model, world,
                       {**mf, **flags})
        c.update(extra)
        cases.append(c)
  return cases


def _ckpt_cases(world, path):
  """The LM under Adam: at world 2 four uninterrupted steps, and two saved
  then two resumed; at world 4 the world-2 checkpoint restored."""
  lm = lambda name, **kw: modes.case(name, "lm", world, {**ZERO, **ADAM},
                                     **kw)
  if world == 2:
    return [lm("ckpt_full", steps=4),
            lm("ckpt_half", steps=2, save=path, snapshot=True),
            lm("ckpt_resume", steps=2, restore=path)]
  return [lm("ckpt_world4", steps=0, restore=path, snapshot=True)]


def torch_results(world, tmp_path_factory):
  if "ckpt" not in _RESULTS:
    _RESULTS["ckpt"] = str(tmp_path_factory.mktemp("zero_ckpt") /
                           "model.ckpt-2.pt")
  if world == 4:
    torch_results(2, tmp_path_factory)
  if world not in _RESULTS:
    cases = (_mode_cases(world, ZERO, "zero") +
             _ckpt_cases(world, _RESULTS["ckpt"]))
    _RESULTS[world] = worker.run_world(
        world, cases, tmp_path_factory.mktemp(f"zero{world}"))
  return _RESULTS[world]


# -- torch against torch (first: they pay for the spawns) ----------------------

@pytest.mark.parametrize("model,suffix", BITWISE,
                         ids=[m + (s or "_k1") for m, s in BITWISE])
def test_zero_bitwise_the_replicated_step_at_two_ranks(model, suffix,
                                                      tmp_path_factory):
  results = torch_results(2, tmp_path_factory)
  modes.check_bitwise(results, f"{model}_zero{suffix}",
                      f"{model}_replicated{suffix}")


@pytest.mark.parametrize("world", modes.WORLDS)
def test_zero_holds_one_shard_of_the_optimizer_state(world,
                                                     tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  for model in modes.MODELS:
    for res in results:
      got = res[f"{model}_zero"]
      assert got["opt_bytes"] == modes.shard_bytes(model, world), model
      assert got["param_bytes"] == modes.full_bytes(model), model
      ref = res[f"{model}_replicated"]
      assert ref["opt_bytes"] == modes.full_bytes(model), model
    for res in results[1:]:
      assert torch.equal(res[f"{model}_zero"]["weights"][-1],
                         results[0][f"{model}_zero"]["weights"][-1])


def _optimizer_state(snapshot, model="lm"):
  """{(param index, key): the desharded value} of a sharded snapshot."""
  module = worker.port_model(model).make_module(worker.NCLASS)
  sizes = [p.numel() for p in module.parameters()]
  out = {}
  for i, st in snapshot["optimizer"]["state"].items():
    for key, stack in st.items():
      out[(i, key)] = (stack[0] if stack.dim() == 1
                       else stack.reshape(-1)[:sizes[i]])
  return out


def test_checkpoint_resumes_bitwise(tmp_path_factory):
  results = torch_results(2, tmp_path_factory)
  for res in results:
    full, resumed = res["ckpt_full"], res["ckpt_resume"]
    assert resumed["losses"] == full["losses"][2:]
    assert torch.equal(resumed["weights"][-1], full["weights"][-1])
  snap = results[0]["ckpt_half"]["snapshot"]
  assert snap["opt_state_layout"] == "sharded"
  assert "params_layout" not in snap
  state = snap["optimizer"]["state"][0]
  assert state["exp_avg"].shape[0] == 2 and state["step"].shape == (2,)
  assert state["step"].tolist() == [2.0, 2.0]


def test_checkpoint_reslices_onto_four_ranks(tmp_path_factory):
  """Restored at world 4 (each rank's rows re-sliced from the (2, k)
  stacks), the state desharded is bitwise the world-2 state."""
  two = torch_results(2, tmp_path_factory)[0]["ckpt_half"]["snapshot"]
  four = torch_results(4, tmp_path_factory)[0]["ckpt_world4"]["snapshot"]
  assert four["optimizer"]["state"][0]["exp_avg"].shape[0] == 4
  a, b = _optimizer_state(two), _optimizer_state(four)
  assert a.keys() == b.keys()
  for key in a:
    assert torch.equal(a[key], b[key]), key
  for name, v in two["model"].items():
    assert torch.equal(four["model"][name], v), name


def _one_rank_step(model, flags):
  module = worker.port_model(model).make_module(worker.NCLASS)
  p = port_params.make_params(device="cpu", **{**modes.FLAGS, **flags})
  return module, worker.make_step(worker.port_model(model), module, p, 0.01)


@pytest.mark.parametrize("saved,run", [
    (ZERO, {}), ({}, ZERO),
    (dict(shard_optimizer_state=True, shard_params=True), ZERO),
    (ZERO, dict(shard_optimizer_state=True, shard_params=True))],
    ids=["zero_into_replicated", "replicated_into_zero",
         "fsdp_into_zero", "zero_into_fsdp"])
def test_cross_layout_restore_raises_the_jax_message(saved, run):
  module, step = _one_rank_step("trivial", saved)
  snap = checkpoint.savable_state(module, step.optimizer, 0,
                                  sharding=step.sharding)
  module, step = _one_rank_step("trivial", run)
  with pytest.raises(ValueError) as got:
    checkpoint.restore_state(module, step.optimizer, snap, step.sharding)
  marks = {k: snap[k] for k in ("opt_state_layout", "params_layout")
           if k in snap}
  with pytest.raises(ValueError) as want:
    jax_checkpoint.restore_state(
        None, marks, sharded_opt_state=bool(run),
        sharded_params=bool(run.get("shard_params")))
  assert str(got.value) == str(want.value)


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("model", modes.MODELS)
@pytest.mark.parametrize("world", modes.WORLDS)
def test_zero_matches_the_jax_replicated_step(world, model,
                                              tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  modes.check_matches_jax(model, world, results, f"{model}_zero")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_stacked_shards_equal_the_jax_layout(leaf, n):
  x = np.random.default_rng(n).normal(size=LEAVES[leaf]).astype(np.float32)
  got = sharded.stacked_shards({(leaf,): torch.from_numpy(x)}, n)
  want = jax_sharded.stacked_shards({leaf: jnp.asarray(x)}, n)
  assert np.array_equal(got[(leaf,)].numpy(), np.asarray(want[leaf]))
  assert sharded.shard_len(x.size, n) == jax_sharded.shard_len(x.size, n)
  rows = sharded.local_shards([torch.from_numpy(x)] * n, 0, n)
  assert np.array_equal(rows[0].numpy(), np.asarray(want[leaf])[0])


def test_reshard_is_exact_both_ways():
  """(2, k) -> (4, k') -> (2, k): only zero pad is cut or added."""
  x = torch.arange(1, 12, dtype=torch.float32)
  two = sharded.stacked_shards({("x",): x}, 2)[("x",)]
  four = checkpoint._reshard(two, 4, 3)
  assert torch.equal(four, sharded.stacked_shards({("x",): x}, 4)[("x",)])
  assert torch.equal(checkpoint._reshard(four, 2, 6), two)
  assert torch.equal(checkpoint._reshard(torch.tensor([3.0, 3.0]), 4, 1),
                     torch.full((4,), 3.0))


# -- validation ----------------------------------------------------------------

def _jax_error(kw):
  with pytest.raises(jax_validation.ParamError) as e:
    jax_validation.validate_cross_flags(jax_params.make_params(**kw))
  return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(eval=True), dict(forward_only=True),
    dict(variable_update="independent"), dict(variable_update="kungfu"),
    dict(variable_update="horovod"),
    dict(variable_update="parameter_server", cross_replica_sync=False),
    dict(worker_hosts=["h0:1", "h1:1"]), dict(optimizer="lars"),
    dict(adaptive_batch_size=True), dict(track_grad_noise_scale=True),
    dict(overlap_gradient_reduction=True), dict(all_reduce_spec="psum"),
    dict(gradient_repacking=2), dict(agg_small_grads_max_bytes=64),
    dict(hierarchical_copy=True, num_devices=8),
], ids=lambda kw: "-".join(f"{k}" for k in kw))
def test_refusals_carry_the_jax_message(kw):
  kw = {**ZERO, **kw}
  with pytest.raises(validation.ParamError) as got:
    validation.validate_cross_flags(port_params.make_params(**kw))
  assert str(got.value) == _jax_error(kw)


@pytest.mark.parametrize("kw,match", [
    (dict(elastic=True), "Queue 1 item 6d"),
    (dict(save_model_secs=60), "--save_model_steps"),
])
def test_refusals_of_the_port(kw, match):
  with pytest.raises(validation.ParamError, match=match):
    validation.validate_cross_flags(port_params.make_params(**ZERO, **kw))


@pytest.mark.parametrize("kw", [
    {}, dict(variable_update="parameter_server"), dict(optimizer="adam"),
    dict(optimizer="rmsprop"), dict(steps_per_dispatch=4),
    dict(num_grad_accum=2, batch_size=4), dict(save_model_steps=5),
    dict(use_fp16=True, fp16_enable_auto_loss_scale=True),
])
def test_compositions_are_admitted_as_in_jax(kw):
  kw = {**ZERO, **kw}
  validation.validate_cross_flags(port_params.make_params(device="cpu",
                                                          **kw))
  jax_validation.validate_cross_flags(jax_params.make_params(**kw))
