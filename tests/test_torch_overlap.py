"""The port's overlapped gradient reduction (--overlap_gradient_reduction,
ops/overlap.py) against the JAX package's, on the CPU.

* Validation: every rule of the flag and of --reduce_bucket_mb refuses
  with the JAX package's message (the cases its
  tests/test_overlap_reduction.py:52-99 pins), and the compositions it
  admits are admitted.
* The bucket plan: ``plan_buckets`` / ``fsdp_plan_buckets`` over the port's
  parameters give the JAX package's index lists over the flax tree, on the
  trivial model, the small ResNet and the two-layer LM, at several bounds,
  with and without the scanned block stack excluded.
* The step: one gloo world of 2 ranks and one of 4 (tests/torch_dp_worker.py,
  spawned once each for the file) run the overlapped step and the port's
  replicated step on the three models of tests/torch_dp_modes.py. Held
  against the JAX package's replicated step at the module's tolerances at
  2 and 4 ranks; torch against torch, bitwise equal to the port's
  replicated step at 2 ranks (a two-term sum commutes, and at the f32 wire
  each element meets the per-tensor mean's ops), also at
  --steps_per_dispatch=4 (the trivial model and the LM) and
  --num_grad_accum=2. At 4 ranks gloo's packed
  all-reduce adds in another order than its per-tensor one, so there only
  the tolerance holds.
"""

import jax
import numpy as np
import pytest

from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.ops import overlap as jax_overlap
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.ops import overlap

import torch_dp_modes as modes
import torch_dp_worker as worker

OVERLAP = dict(overlap_gradient_reduction=True)
VARIANTS = {"": {}, "_k4": dict(k=4, steps=4),
            "_m2": dict(params_extra=dict(num_grad_accum=2))}
# (model, variant) pairs held bitwise at two ranks: every model at K = 1
# and M = 2, and K = 4 on the trivial model and the LM (the ResNet's four
# steps are the costliest CPU work of the file).
BITWISE = [(m, s) for m in modes.MODELS for s in VARIANTS
           if not (m == "resnet" and s == "_k4")]
_RESULTS = {}


def _cases(world):
  cases = []
  variants = VARIANTS if world == 2 else {"": {}}
  for model in modes.MODELS:
    for suffix, extra in variants.items():
      if (model, suffix) not in BITWISE:
        continue
      extra = dict(extra)
      flags = extra.pop("params_extra", {})
      for mode, mode_flags in (("replicated", {}), ("overlap", OVERLAP)):
        c = modes.case(f"{model}_{mode}{suffix}", model, world,
                       {**mode_flags, **flags})
        c.update(extra)
        cases.append(c)
  return cases


def torch_results(world, tmp_path_factory):
  if world not in _RESULTS:
    _RESULTS[world] = worker.run_world(
        world, _cases(world), tmp_path_factory.mktemp(f"overlap{world}"))
  return _RESULTS[world]


# -- torch against torch (first: they pay for the spawns) ----------------------

@pytest.mark.parametrize("model,suffix", BITWISE,
                         ids=[m + (s or "_k1") for m, s in BITWISE])
def test_overlap_bitwise_the_replicated_step_at_two_ranks(
    model, suffix, tmp_path_factory):
  results = torch_results(2, tmp_path_factory)
  modes.check_bitwise(results, f"{model}_overlap{suffix}",
                      f"{model}_replicated{suffix}")


@pytest.mark.parametrize("world", modes.WORLDS)
def test_overlap_ranks_equal_and_buckets_planned(world, tmp_path_factory):
  """Every rank holds the same weights after every step, and the hooks
  ran the plan's buckets: the builder-layer buckets, plus one a block for
  the LM's scanned stack."""
  results = torch_results(world, tmp_path_factory)
  for model in modes.MODELS:
    name = f"{model}_overlap"
    for res in results[1:]:
      for a, b in zip(res[name]["weights"], results[0][name]["weights"]):
        assert np.array_equal(a.numpy(), b.numpy()), (name, world)
    module = worker.port_model(model).make_module(worker.NCLASS)
    reducer = overlap.reducer_for(module, overlap.OverlapSpec(
        overlap.DEFAULT_BUCKET_MB << 20, None))
    assert results[0][name]["buckets"] == len(reducer.buckets) > 0
    if model == "lm":
      assert reducer.buckets[-worker.LM_LAYERS:] == overlap.block_buckets(
          module)
    covered = sorted(i for b in reducer.buckets for i in b)
    assert covered == list(range(len(list(module.parameters()))))


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("model", modes.MODELS)
@pytest.mark.parametrize("world", modes.WORLDS)
def test_overlap_matches_the_jax_replicated_step(world, model,
                                                tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  modes.check_matches_jax(model, world, results, f"{model}_overlap")


@pytest.mark.parametrize("bucket_bytes", [1, 1 << 16, 4 << 20, 1 << 30])
@pytest.mark.parametrize("model", modes.MODELS)
def test_plan_buckets_equal_the_jax_plan(model, bucket_bytes):
  module = worker.port_model(model).make_module(worker.NCLASS)
  leaves = overlap.module_leaves(module)
  tree = modes.variables(model)["params"]
  flat = jax.tree_util.tree_flatten_with_path(tree)[0]
  assert [path for path, _, _ in leaves] == [
      tuple(p.key for p in path) for path, _ in flat]
  sizes = [(path, nbytes) for path, _, nbytes in leaves]
  for exclude in ((), ("blocks",)):
    want = jax_overlap.plan_buckets(tree, bucket_bytes,
                                    exclude_prefixes=exclude)
    assert overlap.plan_buckets(sizes, bucket_bytes, exclude) == want
    assert overlap.fsdp_plan_buckets(sizes, bucket_bytes, exclude) == \
        jax_overlap.fsdp_plan_buckets(tree, bucket_bytes,
                                      exclude_prefixes=exclude)


# -- validation ----------------------------------------------------------------

def _jax_error(kw):
  with pytest.raises(jax_validation.ParamError) as e:
    jax_validation.validate_cross_flags(jax_params.make_params(**kw))
  return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(overlap_gradient_reduction=True, variable_update="independent"),
    dict(overlap_gradient_reduction=True, variable_update="kungfu"),
    dict(overlap_gradient_reduction=True, variable_update="parameter_server",
         cross_replica_sync=False),
    dict(overlap_gradient_reduction=True, all_reduce_spec="psum"),
    dict(overlap_gradient_reduction=True, gradient_repacking=4),
    dict(overlap_gradient_reduction=True, agg_small_grads_max_bytes=1024),
    dict(overlap_gradient_reduction=True, hierarchical_copy=True,
         num_devices=8),
    dict(overlap_gradient_reduction=True, track_grad_noise_scale=True),
    dict(reduce_bucket_mb=4),
    dict(compact_gradient_transfer_f32=True),
], ids=["independent", "kungfu", "async_ps", "spec", "repacking",
        "small_grads", "hierarchical", "noise_scale", "bucket_alone",
        "f32_wire_alone"])
def test_refusals_carry_the_jax_message(kw):
  with pytest.raises(validation.ParamError) as got:
    validation.validate_cross_flags(port_params.make_params(**kw))
  assert str(got.value) == _jax_error(kw)


@pytest.mark.parametrize("kw", [
    dict(overlap_gradient_reduction=True),
    dict(overlap_gradient_reduction=True, reduce_bucket_mb=4),
    dict(overlap_gradient_reduction=True, num_grad_accum=2, batch_size=4),
    dict(overlap_gradient_reduction=True, steps_per_dispatch=4),
    dict(overlap_gradient_reduction=True, variable_update="horovod"),
    dict(overlap_gradient_reduction=True, compact_gradient_transfer_f32=True),
])
def test_compositions_are_admitted_as_in_jax(kw):
  validation.validate_cross_flags(port_params.make_params(device="cpu",
                                                          **kw))
  jax_validation.validate_cross_flags(jax_params.make_params(**kw))


def test_build_resolves_the_bucket_and_the_wire():
  assert overlap.build(port_params.make_params()) is None
  spec = overlap.build(port_params.make_params(
      overlap_gradient_reduction=True))
  assert spec.bucket_bytes == 4 << 20 and spec.compact_dtype is None
  spec = overlap.build(port_params.make_params(
      overlap_gradient_reduction=True, reduce_bucket_mb=25, use_fp16=True))
  jspec = jax_overlap.build(jax_params.make_params(
      overlap_gradient_reduction=True, reduce_bucket_mb=25, use_fp16=True))
  assert spec.bucket_bytes == jspec.bucket_bytes == 25 << 20
  assert str(spec.compact_dtype) == "torch.bfloat16"
  assert np.dtype(jspec.compact_dtype).name == "bfloat16"
