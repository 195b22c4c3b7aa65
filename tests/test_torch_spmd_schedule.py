"""The port's SPMD schedule checks (kf_benchmarks_tpu_torch/analysis/
spmd.py).

* ``schedule_diffs`` against the JAX package's own on the same rows: the
  same messages, exactly (the tensor sequence strict, the scalar
  reductions a multiset, the group's size ignored); ``order_diffs``, the
  port's strict comparison (a process group meets by issue order).
* Schedule drift against a written golden: an inventory-equal reorder
  fails naming the regen command; an inventory drift stands down.
* ``world_size_verdict`` for every sharded golden at worlds 2, 4 and 8 on
  the fake process group: each ``benign_arity``; a fake tracer's reorder
  is a ``bug``.
"""

import json

import pytest

from kf_benchmarks_tpu.analysis import spmd as jax_spmd
from kf_benchmarks_tpu_torch.analysis import audit
from kf_benchmarks_tpu_torch.analysis import baseline
from kf_benchmarks_tpu_torch.analysis import contracts
from kf_benchmarks_tpu_torch.analysis import spmd


def row(kind="all-reduce", rank="tensor", placement="top_level", group=8,
        dtype="f32"):
  return {"index": 0, "kind": kind, "dtype": dtype, "rank": rank,
          "placement": placement, "group_sizes": [group]}


RS, AG = row("reduce-scatter"), row("all-gather")
SC = row(rank="scalar")
CASES = [
    ("equal", [RS, AG], [RS, AG]),
    ("arity", [RS, AG], [row("reduce-scatter", group=2),
                         row("all-gather", group=2)]),
    ("reorder", [RS, AG], [AG, RS]),
    ("length", [RS, AG], [RS]),
    ("trailing", [RS], [RS, AG]),
    ("scalar_moves", [SC, RS, AG], [RS, SC, AG]),
    ("scalar_lost", [SC, RS, AG], [RS, AG]),
    ("wire", [RS], [row("reduce-scatter", dtype="bf16")]),
    ("placement", [RS], [row("reduce-scatter", placement="in_backward")]),
]


@pytest.mark.parametrize("name,a,b", CASES, ids=[c[0] for c in CASES])
def test_schedule_diffs_match_the_jax_package(name, a, b):
  assert spmd.schedule_diffs(a, b) == jax_spmd.schedule_diffs(a, b)
  assert spmd.normalize_schedule(a) == jax_spmd.normalize_schedule(a)


def test_order_diffs_hold_scalar_reductions_in_place():
  assert spmd.schedule_diffs([SC, RS, AG], [RS, SC, AG]) == []
  (msg,) = spmd.order_diffs([SC, RS, AG], [RS, SC, AG])
  assert "position 0" in msg and "issue order" in msg
  assert spmd.order_diffs([RS, AG], [row("reduce-scatter", group=2),
                                     row("all-gather", group=2)]) == []


def _contract(kinds):
  return contracts.ProgramContract(
      config={}, program="train_step",
      collectives=[contracts.Collective(kind=k, dtype="f32", elems=1 << 20,
                                        placement="top_level", group_size=8,
                                        index=i)
                   for i, k in enumerate(kinds)],
      host_transfers=[], optimizer_applies=1, optimizer_apply_in_loop=False,
      state_in_place=True, in_place_tensors=1, largest_tensor_bytes=0,
      largest_tensor_type="", peak_live_bytes=0)


@pytest.fixture
def golden_dir(tmp_path, monkeypatch):
  monkeypatch.setattr(baseline, "GOLDEN_DIR", str(tmp_path))
  return tmp_path


def test_schedule_drift_fires_on_inventory_equal_reorder(golden_dir):
  baseline.write_golden("seeded", _contract(["reduce-scatter",
                                              "all-gather"]))
  (msg,) = spmd.schedule_drift("seeded", _contract(["all-gather",
                                                     "reduce-scatter"]))
  assert spmd.REGEN_COMMAND in msg and "inventory matched" in msg
  assert spmd.schedule_drift("seeded", _contract(["reduce-scatter"])) == []
  assert spmd.schedule_drift("never-written", _contract([])) == []


def test_schedule_drift_names_regen_for_a_pre_field_golden(golden_dir):
  path = baseline.write_golden("seeded", _contract(["all-gather"]))
  fp = json.load(open(path))
  del fp["collective_schedule"]
  with open(path, "w") as f:
    json.dump(fp, f)
  (msg,) = spmd.schedule_drift("seeded", _contract(["all-gather"]))
  assert spmd.REGEN_COMMAND in msg


def test_world_size_reorder_is_a_bug():
  def tracer(cfg, program="train_step"):
    n = int(cfg.get("num_devices", 8))
    kinds = ["reduce-scatter", "all-gather"]
    return _contract(kinds if n == 8 else kinds[::-1])
  verdict = spmd.world_size_verdict("x", {}, tracer)
  assert verdict["classification"] == "bug"
  assert len(spmd.world_size_violations(verdict)) == 2


def test_sharded_world_size_configs_are_the_sharded_goldens():
  assert set(spmd.sharded_world_size_configs()) == {
      "sharded_base", "sharded_accum", "lm_sharded", "sharded_rescale",
      "fsdp_base", "fsdp_lm"}


@pytest.fixture(scope="module")
def tracer():
  return audit.make_memo_tracer()


@pytest.mark.parametrize("name", sorted(spmd.sharded_world_size_configs()))
def test_sharded_golden_schedule_agrees_at_worlds_2_4_8(name, tracer):
  verdict = spmd.world_size_verdict(
      name, contracts.GOLDEN_CONFIGS[name], tracer)
  assert verdict["sizes"] == [2, 4, 8]
  assert verdict["classification"] == "benign_arity", verdict["diffs"]
  assert len(set(verdict["schedule_lengths"].values())) == 1
