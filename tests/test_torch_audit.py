"""The port's rule engine (kf_benchmarks_tpu_torch/analysis/audit.py).

Mutation self-tests, as the JAX package's tests/test_program_audit.py:352
runs them: a golden contract traced clean, one violation seeded into a
copy, and exactly the intended rule fires -- an extra collective in the
backward, an f32 wire where bf16 was asked for, an f32 (B, T, V) buffer,
and one seed for each other rule that owns a property. Then the
one-owner meta-rule, the ZeRO bound's twin, and ``check_resumed_state``
on a sharded step built for one world and resumed at another.
"""

import copy

import pytest

from kf_benchmarks_tpu_torch.analysis import audit
from kf_benchmarks_tpu_torch.analysis import contracts

CONFIGS = {**contracts.GOLDEN_CONFIGS, **contracts.SERVING_GOLDEN_CONFIGS}


@pytest.fixture(scope="module")
def tracer():
  return audit.make_memo_tracer()


def _extra_backward_collective(c):
  c.collectives.append(contracts.Collective(
      kind="all-reduce", dtype="f32", elems=4096, placement="in_backward",
      group_size=8, index=len(c.collectives)))


def _f32_wire(c):
  for x in c.collectives:
    if x.is_gradient_traffic():
      x.dtype = "f32"


def _btv_buffer(c):
  c.largest_tensor_bytes = c.aux["btv_bytes"]
  c.largest_tensor_type = "f32[8,2048,32768]"


def _microbatch_gradient(c):
  grads = c.gradient_collectives()
  grads[0].placement = "per_microbatch"


def _host_read(c):
  c.host_transfers = ["_local_scalar_dense"]


def _lost_in_place(c):
  c.state_in_place = False


def _two_applies(c):
  c.optimizer_applies = 2


def _partial_group(c):
  c.collectives[0].group_size = 4


def _full_gradient_all_reduce(c):
  c.collectives.append(contracts.Collective(
      kind="all-reduce", dtype="f32", elems=1 << 20, placement="top_level",
      group_size=8, index=len(c.collectives)))


def _whole_tree_gather(c):
  c.collectives.append(contracts.Collective(
      kind="all-gather", dtype="f32",
      elems=c.aux["fsdp_param_full_bytes"] // 4, placement="top_level",
      group_size=8, index=len(c.collectives)))


def _ring_sized_buffer(c):
  c.largest_tensor_bytes = c.aux["kv_ring_bytes"]
  c.largest_tensor_type = "f32[6,4,2048,8,64]"


def _logits_buffer(c):
  c.largest_tensor_bytes = c.aux["vocab_logits_bytes"]
  c.largest_tensor_type = "f32[4,2048,32768]"


# (seed, golden config, mutation, the one rule that must fire)
MUTATIONS = [
    ("extra_backward_collective", "base", _extra_backward_collective,
     "overlap-in-backward"),
    ("f32_wire_for_bf16", "overlap_bf16_wire", _f32_wire, "wire-dtype"),
    ("btv_buffer", "lm_base", _btv_buffer, "no-btv-buffer"),
    ("gradient_per_microbatch", "accum4_packed", _microbatch_gradient,
     "accum-one-collective"),
    ("host_read", "base", _host_read, "no-host-transfer"),
    ("state_not_in_place", "sharded_base", _lost_in_place, "state-in-place"),
    ("two_applies", "base", _two_applies, "single-optimizer-apply"),
    ("partial_group", "base", _partial_group, "full-mesh-replica-groups"),
    ("sharded_full_all_reduce", "sharded_base", _full_gradient_all_reduce,
     "sharded-collectives"),
    ("fsdp_whole_tree_gather", "fsdp_base", _whole_tree_gather,
     "fsdp-residency"),
    ("decode_cache_copied", "serving_decode", _lost_in_place,
     "serving-bounded-decode"),
    ("paged_densified", "serving_decode_paged", _ring_sized_buffer,
     "serving-paged-kv"),
    ("verify_full_logits", "serving_verify", _logits_buffer,
     "serving-verify-bounded"),
]


@pytest.mark.parametrize("seed,config,mutate,expected", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_mutation_caught_by_exactly_the_intended_rule(
    seed, config, mutate, expected, tracer):
  overrides = CONFIGS[config]
  contract = copy.deepcopy(tracer(dict(overrides),
                                  audit.program_of(overrides)))
  assert not audit.audit_contract(contract, tracer)  # clean before the seed
  mutate(contract)
  violations = audit.audit_contract(contract, tracer)
  fired = {v.rule for v in violations}
  assert fired == {expected}, (seed, [v.as_dict() for v in violations])


def test_one_owner_names_both_claimants(tracer, monkeypatch):
  contract = tracer(dict(CONFIGS["base"]), "train_step")
  assert audit.rule_one_owner(contract, None) == []
  monkeypatch.setattr(audit, "OWNERSHIP", audit.OWNERSHIP + [
      ("no-host-transfer", "state-in-place", lambda c: True)])
  (msg,) = audit.rule_one_owner(contract, None)
  assert "'state-in-place'" in msg and "no-host-transfer" in msg
  assert "state-in-place" in msg.split("rules on this program:")[1]


def test_sharded_opt_bytes_twin_drops_the_sharding_flags():
  """The ZeRO bound compares against the replicated twin: the twin's
  config has neither --shard_optimizer_state nor --shard_params, and the
  bound bites when the per-rank state is the replicated state's."""
  contract = contracts.ProgramContract(
      config=dict(model="trivial", optimizer="momentum",
                  shard_optimizer_state=True, shard_params=True),
      program="train_step", collectives=[], host_transfers=[],
      optimizer_applies=1, optimizer_apply_in_loop=False,
      state_in_place=True, in_place_tensors=1, largest_tensor_bytes=0,
      largest_tensor_type="", peak_live_bytes=0,
      aux={"opt_state_bytes_per_device": 100_000, "num_devices": 8})
  seen = []

  def stub(cfg, program):
    seen.append(dict(cfg))
    twin = copy.deepcopy(contract)
    twin.aux["opt_state_bytes_per_device"] = 800_000
    return twin

  assert audit.rule_sharded_opt_bytes(contract, stub) == []
  assert seen and not {"shard_optimizer_state", "shard_params"} & set(seen[0])
  contract.aux["opt_state_bytes_per_device"] = 800_000
  assert audit.rule_sharded_opt_bytes(contract, stub)


def test_check_resumed_state_at_another_world():
  """A ZeRO step built for 2 ranks holds its state's contract at 2 and
  fails it at 4 (a rescale that left the shards at the old count)."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  with contracts.fake_world(2):
    _, _, step, _, _ = contracts.build_fake_bench(
        dict(model="trivial", batch_size=2, optimizer="momentum",
             shard_optimizer_state=True), 2)
    with FakeTensorMode(allow_non_fake_inputs=True):
      from kf_benchmarks_tpu_torch import optimizers
      optimizers.init_state(step.optimizer)
    assert audit.check_resumed_state(step, 2) == []
    problems = audit.check_resumed_state(step, 4)
  assert problems and "built for 2 ranks, resumed at 4" in problems[0]
  assert any("not the (" in p for p in problems)
