"""The port's program contracts (kf_benchmarks_tpu_torch/analysis/
contracts.py) against the JAX package's checked-in goldens.

* The recorder on small hand-made steps in a fake process group: a
  collective issued by a gradient hook is placed ``in_backward``, one in
  the forward of a later microbatch ``per_microbatch`` (counted), one
  after the loop ``top_level``; a host read is recorded; the rank follows
  the whole vector's elements; the group's size is read from the op.
* Every golden of the port (19) traced in a fake world of 8 on fake
  tensors: its fingerprint equals the port's golden file, every rule of
  analysis/audit.py passes, and the properties a rule owns agree exactly
  with the JAX package's golden file of the same name
  (tests/golden_contracts/<name>.json, read as data). OWNED_DIFFERENCES
  lists the two owned properties that differ, with the reason;
  INVENTORY_DIFFERENCES gives the reason each raw inventory differs.
* The twin properties: the health, trace and metrics goldens against
  base, in both packages' files.
"""

import json
import os

import pytest
import torch
import torch.distributed as dist

from kf_benchmarks_tpu_torch.analysis import audit
from kf_benchmarks_tpu_torch.analysis import baseline
from kf_benchmarks_tpu_torch.analysis import contracts

JAX_GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "golden_contracts")
NAMES = list(contracts.GOLDEN_CONFIGS) + list(
    contracts.SERVING_GOLDEN_CONFIGS)
CONFIGS = {**contracts.GOLDEN_CONFIGS, **contracts.SERVING_GOLDEN_CONFIGS}


@pytest.fixture(scope="module")
def tracer():
  return audit.make_memo_tracer()


def _trace(tracer, name):
  return tracer(dict(CONFIGS[name]), audit.program_of(CONFIGS[name]))


def jax_golden(name):
  with open(os.path.join(JAX_GOLDEN_DIR, f"{name}.json")) as f:
    return json.load(f)


# -- the recorder on hand-made steps ---------------------------------------------

class _Net(torch.nn.Module):

  def __init__(self):
    super().__init__()
    self.w = torch.nn.Parameter(torch.ones(256))

  def forward(self, x):
    return (self.w * x).sum()


def test_recorder_places_hook_collectives_in_the_backward():
  with contracts.fake_world(2):
    net = _Net()
    net.w.register_hook(lambda g: (dist.all_reduce(g), g)[1])
    rec = contracts.Recorder()
    with rec:
      net(torch.ones(256)).backward()
      dist.all_reduce(torch.zeros(3))
  kinds = [(c.kind, c.placement, c.scalar, c.group_size)
           for c in rec.collectives]
  assert kinds == [("all-reduce", "in_backward", False, 2),
                   ("all-reduce", "top_level", True, 2)]


def test_recorder_counts_the_microbatch_loop():
  """Under M = 2 a collective in the second microbatch's backward is
  per-microbatch; one after the loop is top-level (the loop ends with the
  last microbatch's backward)."""
  with contracts.fake_world(4):
    net = _Net()
    net.w.register_hook(lambda g: (dist.all_reduce(g), g)[1])
    rec = contracts.Recorder(microbatches=2)
    h = net.register_forward_pre_hook(rec.note_forward)
    with rec:
      for _ in range(2):
        net(torch.ones(256)).backward()
      out = torch.empty(4 * 256)
      dist.all_gather_into_tensor(out, net.w.detach().clone())
    h.remove()
  assert [(c.kind, c.placement, c.microbatch) for c in rec.collectives] == [
      ("all-reduce", "per_microbatch", 1), ("all-reduce", "per_microbatch", 2),
      ("all-gather", "top_level", 2)]
  assert rec.collectives[-1].elems == 1024
  assert rec.collectives[-1].group_size == 4


def test_recorder_notes_host_reads_and_in_place_state():
  """A host read inside a traced step is recorded (and answered with no
  value); the state tensors written in place are counted."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  with FakeTensorMode():
    net = _Net()
    state = [net.w]

    def step():
      loss = net(torch.ones(256))
      if loss.item() > 0:  # a host read
        pass
      with torch.no_grad():
        net.w.add_(1.0)

    c = contracts.trace_call(step, net, state, ())
  assert c.host_transfers == ["_local_scalar_dense"]
  assert c.state_in_place and c.in_place_tensors == 1
  assert c.largest_tensor_bytes == 1024 and c.collectives == []
  assert audit.rule_no_host_transfer(c, None)


def test_fake_world_refuses_a_live_group():
  with contracts.fake_world(2):
    with pytest.raises(RuntimeError, match="already initialized"):
      with contracts.fake_world(2):
        pass
  assert not dist.is_initialized()


# -- the goldens -----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_golden_matches_the_ports_golden_file(name, tracer):
  assert baseline.check_against_golden(name, _trace(tracer, name)) == []


@pytest.mark.parametrize("name", NAMES)
def test_golden_passes_every_rule(name, tracer):
  violations = audit.audit_contract(_trace(tracer, name), tracer)
  assert not violations, [v.as_dict() for v in violations]


def owned(fp, side):
  """The properties a rule owns, read from a golden fingerprint of either
  package (``side`` "jax" or "port"): the JAX package's ``in_loop`` (a
  scan body) is the port's ``per_microbatch`` for the accumulation rule
  and ``in_backward`` for the FSDP gathers; its ``state_donated`` is the
  port's ``state_in_place``."""
  rows = fp["collective_schedule"]
  cfg = fp["config"]
  out = {
      "single-optimizer-apply": [fp["optimizer_apply_present"],
                                 fp["optimizer_apply_in_loop"]],
      "no-host-transfer": fp["host_transfers"],
      "state-in-place": fp["state_in_place" if side == "port"
                           else "state_donated"],
      "full-mesh-replica-groups": sorted({g for r in rows
                                          for g in r["group_sizes"]}),
  }
  if fp["program"] != "train_step":
    out["no-collectives"] = len(rows)
    return out
  out["wire-dtype"] = fp["requested_grad_wires"]
  loop = "in_loop" if side == "jax" else "per_microbatch"
  if int(cfg.get("num_grad_accum", 1)) > 1:
    out["accum-one-collective"] = sum(
        1 for r in rows if r["placement"] == loop
        and r["kind"] == "all-reduce" and r["rank"] == "tensor")
    if cfg.get("agg_small_grads_max_bytes"):
      out["accum-packed"] = fp["gradient_collectives"]
  if cfg.get("overlap_gradient_reduction"):
    out["overlap-in-backward"] = fp["gradient_collectives"]
  if cfg.get("shard_optimizer_state"):
    kinds = {(r["kind"], r["rank"]) for r in rows}
    out["sharded-collectives"] = [
        ("reduce-scatter", "tensor") in kinds,
        ("all-gather", "tensor") in kinds, fp["gradient_collectives"],
        fp["requested_collective_wires"]]
  if cfg.get("shard_params"):
    ag = [r for r in rows if r["kind"] == "all-gather"
          and r["rank"] == "tensor"]
    inner = "in_loop" if side == "jax" else "in_backward"
    out["fsdp-residency"] = [any(r["placement"] == inner for r in ag),
                             sum(r["placement"] == "top_level" for r in ag)]
  return out


# (golden, owned property): (JAX value, port value, why they differ).
OWNED_DIFFERENCES = {
    ("lm_overlap", "overlap-in-backward"): (
        5, 10,
        "the JAX package scans the 6 blocks and reduces each block's "
        "gradients by one collective inside the backward scan (1 in the "
        "program, run 6 times) beside 4 step buckets; the port keeps each "
        "block's tensors apart and issues one bucket collective a block "
        "(6) beside the same 4"),
    ("fsdp_lm", "fsdp-residency"): (
        [True, 4], [True, 10],
        "the JAX package's per-block gather sits in the forward scan (1 in "
        "the program, run 6 times); the port gathers each of the 6 blocks "
        "in its forward beside the 4 step buckets (10 outside the "
        "backward), and both re-gather each block in the backward"),
}

# Why each raw inventory (kind, dtype, rank, placement, count) differs from
# the JAX package's golden (the serving goldens carry no collective in
# either package and agree).
INVENTORY_DIFFERENCES = {
    "base": "rank: the trivial model's 1-element bias gradient is a "
            "tensor in XLA (it has a dimension) and scalar in the port "
            "(under 128 elements); the port packs base_loss and "
            "total_loss into one 2-element all-reduce where the JAX step "
            "issues two 0-d ones",
    "accum4_packed": "the losses' one packed all-reduce against two",
    "overlap": "placement: the port's bucket hooks run inside autograd's "
               "backward (in_backward), the JAX trivial model has no scan "
               "(top_level); the losses' one all-reduce against two",
    "overlap_bf16_wire": "as overlap; the port's wire is the bf16 the "
                         "program sends, the JAX golden's the compiled "
                         "CPU dump's f32 (its requested wire is bf16)",
    "health": "the JAX step packs the losses and the health partials "
              "into one 10-float vector (a tensor); the port packs them "
              "into one vector of 10 (scalar: under 128 elements), and "
              "the 1-element bias as in base",
    "lm_base": "the JAX package stacks the 6 blocks' tensors into 16 "
               "scanned leaves, the port reduces 71 tensors; the losses' "
               "one all-reduce against two",
    "lm_overlap": "see OWNED_DIFFERENCES; the losses' one all-reduce",
    "sharded_base": "the 1-element bias's scatter and gather are scalar "
                    "in the port; the losses' one all-reduce",
    "sharded_accum": "as sharded_base",
    "lm_sharded": "71 tensors scattered and gathered against 16 leaves; "
                  "the losses' one all-reduce",
    "sharded_rescale": "as sharded_base",
    "fsdp_base": "placement: the port's gather backward reduce-scatters "
                 "inside autograd's backward (in_backward); the losses' "
                 "one all-reduce",
    "fsdp_lm": "see OWNED_DIFFERENCES; the port's bucket scatters run in "
               "the backward, and its block L2 is one all-reduce beside "
               "the losses' one (the JAX step's four)",
    "traced": "as base",
    "metrics_on": "as base",
}


@pytest.mark.parametrize("name", NAMES)
def test_rule_owned_properties_agree_with_the_jax_golden(name, tracer):
  jax_fp = jax_golden(name)
  port_fp = baseline.contract_fingerprint(_trace(tracer, name))
  assert port_fp["config"] == jax_fp["config"]
  j, p = owned(jax_fp, "jax"), owned(port_fp, "port")
  assert set(j) == set(p)
  for prop in j:
    if (name, prop) in OWNED_DIFFERENCES:
      jv, pv, _ = OWNED_DIFFERENCES[(name, prop)]
      assert (j[prop], p[prop]) == (jv, pv), prop
    else:
      assert j[prop] == p[prop], (prop, j[prop], p[prop])

  def inventory(fp):
    return sorted(tuple(e[k] for k in ("kind", "dtype", "rank",
                                        "placement", "count"))
                  for e in fp["collectives"])
  # The table names exactly the goldens whose raw inventories differ.
  assert (inventory(jax_fp) != inventory(port_fp)) == (
      name in INVENTORY_DIFFERENCES)


@pytest.mark.parametrize("twin", ["health", "traced", "metrics_on"])
def test_twin_properties_hold_in_both_packages(twin, tracer):
  """health adds no collective over base; traced and metrics_on are base,
  field for field but the config, in the JAX package's files as in the
  port's."""
  for side, load in (("jax", jax_golden), ("port", baseline.load_golden)):
    on, off = load(twin), load("base")
    if twin == "health":
      assert len(on["collective_schedule"]) <= len(
          off["collective_schedule"]), side
    else:
      on, off = dict(on), dict(off)
      on.pop("config")
      off.pop("config")
      assert on == off, side
