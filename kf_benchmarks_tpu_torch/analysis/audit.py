"""Rule engine: check every earned program contract against a config.

The port's counterpart of kf_benchmarks_tpu/analysis/audit.py. Each rule
encodes one guarantee a slice earned and a test pinned for the configs it
covered; here the same invariant is checked for any config (the golden
lattice of ``contracts.GOLDEN_CONFIGS``, or what the CLI is pointed at).
A rule is ``check(contract, tracer) -> [message]``; ``audit_contract``
runs them all and returns machine-readable violations. ``tracer`` lets
the paired rules trace a twin config (health on and off, trace on and
off) through the same memo.

Where the port's program differs from XLA's, the rule says what it checks
instead:

* placement: XLA's ``in_loop`` (a while body) is the port's
  ``per_microbatch`` (the Python microbatch loop of --num_grad_accum,
  counted) for the accumulation rule, and ``in_backward`` (issued by a
  hook while autograd runs) for the overlap rule;
* ``state-donated`` becomes ``state-in-place``: the step writes the
  weights and the optimizer's state into the tensors it holds, so a CUDA
  graph replays it and no second copy exists;
* ``full-mesh-replica-groups`` holds every collective to the world group;
* the GSPMD twin (``partitioner-twin``) and ``packed-no-overhead`` wait
  for ROADMAP item 8 (``--partitioner``, ``--packed_sequences``).

Mutation self-tests (tests/test_torch_audit.py) seed violations -- an
extra collective in the backward, an f32 wire where bf16 was asked for, a
(B, T, V) buffer -- and assert exactly the intended rule fires.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from kf_benchmarks_tpu_torch.analysis.contracts import ProgramContract

TRAIN_PROGRAMS = ("train_step",)


@dataclasses.dataclass
class Violation:
  rule: str
  message: str

  def as_dict(self):
    return {"rule": self.rule, "message": self.message}


def _cfg(contract: ProgramContract, name: str, default=None):
  return contract.config.get(name, default)


def _accum(contract) -> int:
  return int(_cfg(contract, "num_grad_accum", 1) or 1)


def _overlap(contract) -> bool:
  return bool(_cfg(contract, "overlap_gradient_reduction", False))


def _sharded(contract) -> bool:
  return bool(_cfg(contract, "shard_optimizer_state", False))


def _fsdp(contract) -> bool:
  return bool(_cfg(contract, "shard_params", False))


def _train(contract) -> bool:
  return contract.program in TRAIN_PROGRAMS


def _replicated_sync(contract) -> bool:
  vu = _cfg(contract, "variable_update", "replicated")
  sync = bool(_cfg(contract, "cross_replica_sync", True))
  return vu in ("replicated", "distributed_replicated", "parameter_server",
                "collective_all_reduce", "distributed_all_reduce",
                "horovod") and sync


def _twin_diffs(contract, tracer, drop) -> List[tuple]:
  """Field diffs of ``contract`` against its twin without the ``drop``
  flags (the config field differs by construction)."""
  from kf_benchmarks_tpu_torch.analysis import baseline as baseline_lib
  twin_cfg = {k: v for k, v in contract.config.items() if k not in drop}
  twin = tracer(twin_cfg, contract.program)
  on = baseline_lib.contract_fingerprint(contract)
  off = baseline_lib.contract_fingerprint(twin)
  on.pop("config", None)
  off.pop("config", None)
  return baseline_lib.diff_fingerprints(off, on)


# -- the earned contracts ------------------------------------------------------

def rule_accum_one_collective(contract, tracer):
  """--num_grad_accum pays ONE gradient reduction a step, never inside the
  microbatch loop; with a packing reducer the count is literally one."""
  if _accum(contract) <= 1 or not _train(contract):
    return []
  out = []
  grads = contract.gradient_collectives()
  in_loop = [c for c in grads if c.in_loop]
  if in_loop:
    out.append(f"{len(in_loop)} gradient collective(s) inside the "
               "microbatch loop -- reduction must be per STEP, not per "
               "microbatch")
  packed = (int(_cfg(contract, "agg_small_grads_max_bytes", 0) or 0) > 0
            or int(_cfg(contract, "gradient_repacking", 0) or 0) > 0)
  if packed and len(grads) != 1:
    out.append(f"expected exactly ONE packed gradient all-reduce per "
               f"accumulated step, found {len(grads)}")
  return out


def rule_overlap_in_backward(contract, tracer):
  """In-backward collectives iff --overlap_gradient_reduction engages.

  Engaged (M = 1): every gradient bucket is reduced by a hook inside the
  backward, one collective per planned bucket, and no gradient all-reduce
  follows the backward (the post-hoc reduction stands down). Off: no
  collective may issue inside the backward (replicated family; the
  accumulation loop and FSDP's gathers have their own owners)."""
  if not _train(contract):
    return []
  engaged = _overlap(contract) and _accum(contract) == 1
  in_bwd = contract.in_backward_collectives()
  if not engaged:
    if not _replicated_sync(contract) or _accum(contract) > 1 or \
        _fsdp(contract):
      return []
    if in_bwd:
      return [f"{len(in_bwd)} collective(s) issued inside the backward "
              "with the in-backward hooks off -- a collective leaked into "
              "autograd's pass"]
    return []
  out = []
  bwd_grads = [c for c in contract.gradient_collectives() if c.in_backward]
  expected = contract.aux.get("overlap_step_buckets")
  if expected is not None and len(bwd_grads) != expected:
    out.append(f"in-backward gradient collectives {len(bwd_grads)} != "
               f"planned bucket count {expected}")
  after = [c for c in contract.gradient_collectives()
           if c.placement == "top_level"]
  if after:
    out.append(f"{len(after)} gradient all-reduce(s) after the backward "
               "with the overlap engaged -- the post-hoc reduction runs "
               "beside the buckets' own")
  return out


def rule_no_btv_buffer(contract, tracer):
  """The fused-head LM materializes no (B, T, V) logits tensor anywhere
  in the step."""
  btv = contract.aux.get("btv_bytes")
  if btv is None:
    return []
  if contract.largest_tensor_bytes >= btv:
    return [f"largest step buffer {contract.largest_tensor_type} "
            f"({contract.largest_tensor_bytes} B) >= the (B, T, V) "
            f"logits tensor ({btv} B) the fused head exists to avoid"]
  return []


def rule_trace_twin(contract, tracer):
  """Run tracing (--trace_events_file) is HOST-ONLY: the trace-on step
  must be structurally identical to the trace-off twin (the whole
  fingerprint: collectives, wires, in-place state, the optimizer's apply,
  host transfers)."""
  if not _cfg(contract, "trace_events_file") or tracer is None:
    return []
  return [f"trace-on step differs from the trace-off twin at {field}: "
          f"{off!r} (off) vs {on!r} (on) -- tracing must stay host-only"
          for field, off, on in _twin_diffs(contract, tracer,
                                            ("trace_events_file",))]


def rule_metrics_twin(contract, tracer):
  """The metrics fabric (--metrics_port, --run_store_dir) is HOST-ONLY:
  the metrics-on step must be structurally identical to its twin."""
  if not (_cfg(contract, "metrics_port") or _cfg(contract, "run_store_dir")) \
      or tracer is None:
    return []
  return [f"metrics-on step differs from the metrics-off twin at {field}: "
          f"{off!r} (off) vs {on!r} (on) -- the metrics fabric must stay "
          "host-only"
          for field, off, on in _twin_diffs(contract, tracer,
                                            ("metrics_port",
                                             "run_store_dir"))]


def rule_health_no_extra_collective(contract, tracer):
  """The health-on step carries NO additional collective (the partials
  ride the losses' all-reduce)."""
  if not contract.aux.get("health_stats") or tracer is None:
    return []
  twin_cfg = dict(contract.config)
  twin_cfg["health_stats"] = False
  twin = tracer(twin_cfg, contract.program)
  n_on, n_off = len(contract.collectives), len(twin.collectives)
  if n_on > n_off:
    return [f"health stats added collectives: {n_on} vs {n_off} with "
            "stats off"]
  return []


def rule_wire_dtype(contract, tracer):
  """Gradients ride a 16-bit wire iff a packed path compacts it
  (allreduce.compact_wire_dtype: --use_fp16, or
  --compact_gradient_transfer_f32, on the overlap's buckets and the packed
  reducers); otherwise each gradient travels in its own dtype."""
  grads = contract.gradient_collectives()
  expected = contract.aux.get("expected_grad_wire")
  if not grads or expected is None:
    return []
  wire = {c.dtype for c in grads}
  if wire != {expected}:
    return [f"gradient wire {expected} expected but found wire dtypes "
            f"{sorted(wire)}"]
  return []


def rule_sharded_collectives(contract, tracer):
  """A --shard_optimizer_state step meets its gradients in reduce-scatter
  and returns parameters by all-gather (or, under FSDP, gathers them in
  the forward): NO full-gradient all-reduce, every exchange on the whole
  world, and the f32 wire unless compacted."""
  if not _sharded(contract) or not _train(contract):
    return []
  out = []
  rs = [c for c in contract.collectives
        if c.kind == "reduce-scatter" and not c.scalar]
  ag = [c for c in contract.collectives
        if c.kind == "all-gather" and not c.scalar]
  if not rs:
    out.append("no reduce-scatter in the sharded step -- the gradient "
               "exchange fell back to something else")
  if not ag:
    out.append("no all-gather in the sharded step -- updated parameters "
               "are not being re-assembled from the shards")
  grads = contract.gradient_collectives()
  if grads:
    out.append(f"{len(grads)} full-gradient all-reduce(s) in a sharded "
               "step -- the reduce-scatter path is being duplicated (or "
               "replaced) by the replicated exchange")
  n = contract.aux.get("num_devices")
  bad = [c for c in rs + ag if n and c.group_size != n]
  if bad:
    out.append(f"{len(bad)} sharded exchange(s) on a group of "
               f"{bad[0].group_size} ranks, not the {n}-rank world")
  expected = contract.aux.get("expected_grad_wire")
  wires = {c.dtype for c in rs + ag}
  if expected == "f32" and wires and wires != {"f32"}:
    out.append(f"f32 wire expected on the sharded exchange but found "
               f"{sorted(wires)}")
  return out


def rule_sharded_opt_bytes(contract, tracer):
  """Per-rank optimizer-state bytes under --shard_optimizer_state are
  ~|state|/n of the replicated twin's (slack for the zero pad)."""
  if not _sharded(contract) or tracer is None:
    return []
  per_rank = contract.aux.get("opt_state_bytes_per_device")
  n = contract.aux.get("num_devices")
  if per_rank is None or not n:
    return []
  twin_cfg = {k: v for k, v in contract.config.items()
              if k not in ("shard_optimizer_state", "shard_params")}
  full = tracer(twin_cfg, contract.program).aux.get(
      "opt_state_bytes_per_device")
  if full is None:
    return []
  bound = int(full / n * 1.05) + 4096
  if per_rank > bound:
    return [f"per-rank optimizer state {per_rank} B exceeds the ZeRO bound "
            f"~|state|/n = {full}/{n} B (+pad slack {bound} B) -- state is "
            "leaking back to replicated"]
  return []


def rule_fsdp_residency(contract, tracer):
  """A --shard_params step never materializes the whole parameter tree.

  (a) A model with a stacked block (the transformer's) re-gathers each
  block inside the backward (the block's checkpoint region recomputes
  it), so no whole stack is saved; (b) the gathers outside the backward
  number no more than the planned step buckets plus one per block; (c) no
  gather reaches half the tree, floored at the largest planned bucket.
  Under --num_grad_accum the in-step gathers stand down by design (one
  whole-tree gather a step), so only (c)'s whole-tree bound is lifted."""
  if not _fsdp(contract) or not _train(contract):
    return []
  out = []
  ags = [c for c in contract.collectives
         if c.kind == "all-gather" and not c.scalar]
  bwd = [c for c in ags if c.in_backward]
  fwd = [c for c in ags if not c.in_backward]
  if not contract.aux.get("fsdp_engaged", True):
    return out
  if contract.aux.get("fsdp_scan_prefixes") and not bwd:
    out.append("stacked FSDP model but no all-gather inside the backward "
               "-- the per-block gather left the checkpoint region (the "
               "whole stack is saved)")
  planned = contract.aux.get("fsdp_step_gathers")
  if planned is not None:
    planned += int(contract.aux.get("fsdp_block_gathers") or 0)
    if len(fwd) > planned:
      out.append(f"{len(fwd)} all-gather(s) outside the backward vs "
                 f"{planned} planned bucket and block gather(s) -- a "
                 "whole-tree re-assembly leaked into the step")
  full_bytes = contract.aux.get("fsdp_param_full_bytes")
  if full_bytes:
    planned_max = contract.aux.get("fsdp_max_gather_bytes") or 0
    bound = max(full_bytes // 2, planned_max + 1)
    big = [c for c in ags if c.nbytes >= bound]
    if big:
      out.append(f"{len(big)} all-gather(s) re-assemble {big[0].nbytes} B "
                 f">= the residency bound {bound} B (full tree "
                 f"{full_bytes} B, largest planned bucket {planned_max} B) "
                 "-- parameters leaked back to replicated residency")
  return out


def rule_serving_bounded_decode(contract, tracer):
  """The serving decode step is a bounded, cache-resident program: its
  batch is a bucket-ladder member, it updates its caches, positions and
  tokens in place (what its CUDA graph replays), and no buffer exceeds
  one KV ring (nor reaches the (B, T, V) logits)."""
  if contract.program != "serving_decode":
    return []
  out = []
  ladder = contract.aux.get("bucket_ladder") or []
  bucket = contract.aux.get("decode_batch")
  if ladder and bucket not in ladder:
    out.append(f"decode batch {bucket} is not a bucket-ladder member "
               f"{ladder} -- an off-ladder shape breaks the bounded "
               "program set")
  if not contract.state_in_place:
    out.append("KV caches not updated in place -- the decode step must "
               "write its cache, positions and tokens where they are")
  if "kv_pool_bytes" in contract.aux:
    return out  # serving-paged-kv owns the buffer bound of paged decode
  btv = contract.aux.get("vocab_logits_bytes")
  ring = contract.aux.get("kv_ring_bytes")
  if ring and contract.largest_tensor_bytes > ring:
    if btv and btv > ring and contract.largest_tensor_bytes >= btv:
      out.append(f"largest decode buffer {contract.largest_tensor_type} "
                 f"({contract.largest_tensor_bytes} B) reaches the (B, T, "
                 f"V) logits tensor ({btv} B) -- the per-token step "
                 "materialized a full-sequence product")
    else:
      out.append(f"largest decode buffer {contract.largest_tensor_type} "
                 f"({contract.largest_tensor_bytes} B) exceeds one KV ring "
                 f"({ring} B), the largest legitimate tensor of the step")
  elif btv and not ring and contract.largest_tensor_bytes >= btv:
    out.append(f"largest decode buffer {contract.largest_tensor_type} "
               f"({contract.largest_tensor_bytes} B) reaches the (B, T, V) "
               f"logits tensor ({btv} B)")
  return out


def rule_serving_paged_kv(contract, tracer):
  """The paged-KV decode step's memory bound: the page pool sits strictly
  under the dense ring it replaces, and no buffer reaches that ring."""
  if contract.program != "serving_decode":
    return []
  pool = contract.aux.get("kv_pool_bytes")
  if not pool:
    return []
  out = []
  ring = contract.aux.get("kv_ring_bytes")
  if ring and pool >= ring:
    out.append(f"paged KV pool ({pool} B) reaches the dense ring slab it "
               f"replaces ({ring} B)")
  if ring and contract.largest_tensor_bytes >= ring:
    out.append(f"largest paged-decode buffer "
               f"{contract.largest_tensor_type} "
               f"({contract.largest_tensor_bytes} B) reaches the dense KV "
               f"slab ({ring} B) -- a densification leak")
  return out


def rule_serving_verify_bounded(contract, tracer):
  """The speculative verify program: a ladder batch, and no buffer
  reaching the full (B, T, V) logits (its argmax runs (B, chunk, V) at a
  time)."""
  if contract.program != "serving_verify":
    return []
  out = []
  ladder = contract.aux.get("bucket_ladder") or []
  bucket = contract.aux.get("decode_batch")
  if ladder and bucket not in ladder:
    out.append(f"verify batch {bucket} is not a bucket-ladder member "
               f"{ladder}")
  btv = contract.aux.get("vocab_logits_bytes")
  if btv and contract.largest_tensor_bytes >= btv:
    out.append(f"largest verify buffer {contract.largest_tensor_type} "
               f"({contract.largest_tensor_bytes} B) reaches the (B, T, V) "
               f"logits tensor ({btv} B) -- the chunked argmax must never "
               "materialize the full logits")
  return out


# -- program-shape invariants (every config) -----------------------------------

def rule_no_host_transfer(contract, tracer):
  """The step stays on the device: a host read inside it (an ``.item()``,
  a copy to the CPU) stalls the launch queue and breaks graph capture."""
  if contract.host_transfers:
    return [f"host transfer(s) in the step: {contract.host_transfers}"]
  return []


def rule_state_in_place(contract, tracer):
  """The port's counterpart of the donated TrainState: the step writes the
  weights and the optimizer's state into the tensors it holds (no second
  copy; a CUDA graph replays the same storages)."""
  if not _train(contract):
    return []  # serving-bounded-decode owns the decode step's caches
  if not contract.state_in_place:
    return [f"the step did not update its state in place: "
            f"{contract.in_place_tensors} state tensor(s) written in "
            "place, and every weight and optimizer-state tensor must be"]
  return []


def rule_single_optimizer_apply(contract, tracer):
  """Exactly one optimizer apply a step, after any microbatch loop (the
  async parameter server's sequential apply is the documented
  exception)."""
  if not _train(contract) or contract.aux.get("sequential_apply"):
    return []
  if not contract.optimizer_apply_present:
    return ["no optimizer apply in the step"]
  out = []
  if contract.optimizer_applies != 1:
    out.append(f"{contract.optimizer_applies} optimizer applies in one "
               "step -- the update must run once")
  if contract.optimizer_apply_in_loop:
    out.append("optimizer apply inside the microbatch loop or the "
               "backward -- the update must run once per step, after them")
  return out


def rule_full_mesh_replica_groups(contract, tracer):
  """Every collective of a replicated-family step runs on the whole world:
  a smaller group is a silent partial reduction."""
  if not _replicated_sync(contract) or not _train(contract):
    return []
  n = contract.aux.get("num_devices")
  if not n:
    return []
  bad = [c for c in contract.collectives if c.group_size != n]
  if bad:
    return [f"{len(bad)} collective(s) on a group of {bad[0].group_size} "
            f"ranks, not the {n}-rank world"]
  return []


# -- one owner per property ------------------------------------------------------

# (owning rule, property, binds(contract)): the rule that owns checking a
# property on the contracts where ``binds`` holds. A property claimed by
# two rules on one program fails rule_one_owner with both names, so the
# mutation self-tests stay unambiguous about which rule must fire.
OWNERSHIP = [
    ("accum-one-collective", "in-loop-gradient-exchange",
     lambda c: _train(c) and _accum(c) > 1),
    ("overlap-in-backward", "in-loop-gradient-exchange",
     lambda c: _train(c) and _accum(c) == 1 and _replicated_sync(c)
     and not _fsdp(c)),
    ("fsdp-residency", "param-gather-residency",
     lambda c: _train(c) and _fsdp(c)),
    ("serving-bounded-decode", "decode-buffer-bound",
     lambda c: c.program == "serving_decode"
     and "kv_pool_bytes" not in c.aux),
    ("serving-paged-kv", "decode-buffer-bound",
     lambda c: c.program == "serving_decode" and "kv_pool_bytes" in c.aux),
    ("state-in-place", "state-in-place", _train),
    ("serving-bounded-decode", "state-in-place",
     lambda c: c.program == "serving_decode"),
]


def rule_one_owner(contract, tracer):
  """No property may be claimed by two rules on one program (OWNERSHIP)."""
  by_property: Dict[str, set] = {}
  for rule_id, prop, binds in OWNERSHIP:
    if binds(contract):
      by_property.setdefault(prop, set()).add(rule_id)
  return [f"property '{prop}' is claimed by {len(owners)} rules on this "
          f"program: {sorted(owners)} -- exactly one rule may own a seeded "
          "violation; tighten the OWNERSHIP predicates"
          for prop, owners in sorted(by_property.items()) if len(owners) > 1]


# -- resume-time re-verification -------------------------------------------------

def check_resumed_state(step, world: int) -> List[str]:
  """Structural re-verification of a train step's state just restored at
  ``world`` ranks (a ZeRO rescale resumes a checkpoint re-sliced,
  checkpoint.py ``_reshard``): every shard is the (ceil(size / n),) row of
  its parameter, and every optimizer-state tensor of a shard has the
  shard's shape. Shape reads only. Returns problem strings."""
  from kf_benchmarks_tpu_torch.ops import sharded as sharded_lib
  problems = []
  sharding = getattr(step, "sharding", None)
  if sharding is None:
    return problems
  n = int(world)
  if sharding.n != n:
    problems.append(f"sharded state built for {sharding.n} ranks, resumed "
                    f"at {n}")
  for name, shape, shard in zip(sharding.names, sharding.shapes,
                                sharding.shards):
    want = sharded_lib.shard_len(max(1, shape.numel()), n)
    if tuple(shard.shape) != (want,):
      problems.append(f"shard of {name} has shape {tuple(shard.shape)}, "
                      f"not the ({want},) row of a {n}-rank world")
      break
  for shard in sharding.shards:
    for key, v in step.optimizer.state.get(shard, {}).items():
      if hasattr(v, "shape") and v.dim() > 0 and v.shape != shard.shape:
        problems.append(f"optimizer state {key!r} has shape "
                        f"{tuple(v.shape)}, not its shard's "
                        f"{tuple(shard.shape)} -- the rescale left it at "
                        "the old shard count")
        return problems
  return problems


RULES: Dict[str, Callable] = {
    "trace-twin": rule_trace_twin,
    "metrics-twin": rule_metrics_twin,
    "accum-one-collective": rule_accum_one_collective,
    "overlap-in-backward": rule_overlap_in_backward,
    "no-btv-buffer": rule_no_btv_buffer,
    "health-no-extra-collective": rule_health_no_extra_collective,
    "wire-dtype": rule_wire_dtype,
    "sharded-collectives": rule_sharded_collectives,
    "sharded-opt-bytes": rule_sharded_opt_bytes,
    "fsdp-residency": rule_fsdp_residency,
    "serving-bounded-decode": rule_serving_bounded_decode,
    "serving-paged-kv": rule_serving_paged_kv,
    "serving-verify-bounded": rule_serving_verify_bounded,
    "no-host-transfer": rule_no_host_transfer,
    "state-in-place": rule_state_in_place,
    "single-optimizer-apply": rule_single_optimizer_apply,
    "full-mesh-replica-groups": rule_full_mesh_replica_groups,
    "one-owner": rule_one_owner,
}


def audit_contract(contract: ProgramContract,
                   tracer: Optional[Callable] = None,
                   rules: Optional[Dict[str, Callable]] = None
                   ) -> List[Violation]:
  """Every rule over one contract; ``tracer(overrides, program)`` serves
  the paired rules (None skips them)."""
  out = []
  for rule_id, rule in (rules or RULES).items():
    for msg in rule(contract, tracer):
      out.append(Violation(rule=rule_id, message=msg))
  return out


def make_memo_tracer() -> Callable:
  """A memoizing ``tracer(overrides, program) -> ProgramContract``: a
  config traced once serves the audit, the golden diff and the paired
  rules' twins."""
  from kf_benchmarks_tpu_torch.analysis import contracts as contracts_lib
  memo: Dict[str, ProgramContract] = {}

  def tracer(overrides, program="train_step"):
    key = repr(sorted(overrides.items())) + program
    if key not in memo:
      if program.startswith("serving"):
        memo[key] = contracts_lib.trace_serving_contract(dict(overrides),
                                                         program)
      else:
        memo[key] = contracts_lib.trace_contract(dict(overrides),
                                                 program=program)
    return memo[key]

  return tracer


def program_of(overrides: Dict[str, Any]) -> str:
  """The program a golden config traces: a serving config names its own
  (or is the decode step); a train config the train step."""
  if "bucket" in overrides or "program" in overrides:
    return overrides.get("program", "serving_decode")
  return "train_step"


def audit_configs(configs: Dict[str, Dict[str, Any]],
                  tracer: Optional[Callable] = None) -> Dict[str, Any]:
  """Trace and audit each named config; the machine-readable report the
  CLI writes as JSON."""
  tracer = tracer or make_memo_tracer()
  report = {"configs": {}, "violations": 0}
  for name, overrides in configs.items():
    contract = tracer(dict(overrides), program_of(overrides))
    violations = audit_contract(contract, tracer)
    report["configs"][name] = {
        "config": dict(overrides),
        "violations": [v.as_dict() for v in violations],
        "collectives": len(contract.collectives),
        "in_loop_collectives": len(contract.in_loop_collectives()),
        "in_backward_collectives": len(contract.in_backward_collectives()),
        "gradient_collectives": len(contract.gradient_collectives()),
    }
    report["violations"] += len(violations)
  return report
