"""Program contracts: trace a config's train step on fake tensors, never
run it.

The port's counterpart of kf_benchmarks_tpu/analysis/contracts.py. The
JAX package lowers the step over an abstract 8-device mesh and reads the
compiled HLO; the port builds the step exactly as ``BenchmarkCNN.build``
does, inside a process group of ``torch.distributed``'s fake backend
(``FakeStore``, world 8: every collective returns at once and moves
nothing) and a ``FakeTensorMode`` (no storage, no kernel runs; the
kernels' custom ops answer through their fake impls), then calls the
step once under a dispatch mode that records:

* every ``c10d`` op: its kind, wire dtype, result elements and group size,
  in issue order;
* its placement, read from autograd and counted, never inferred:
  ``in_backward`` when autograd's engine runs
  (``torch._C._current_graph_task_id() >= 0``: the overlap's bucket
  hooks, the FSDP gather's backward), ``per_microbatch`` when it is
  issued inside the microbatch loop of --num_grad_accum (the module's
  forward calls are counted, and the loop ends with the backward of the
  last one), ``top_level`` otherwise (the FSDP gathers in forward hooks
  land here: they run before the backward);
* its rank: ``scalar`` below :data:`GRAD_MIN_ELEMS` elements of the whole
  vector (the losses, the health partials and the finite flag ride such
  vectors), ``tensor`` above;
* host transfers inside the step (``aten._local_scalar_dense``: an
  ``.item()``, a ``bool()`` of a tensor; a copy between the CPU and a
  card);
* the optimizer's apply (its step hooks) and where it ran;
* the largest tensor and the peak of live tensor bytes;
* whether the step updated the weights and the optimizer's state in
  place: the port's guarantee where XLA's is a donated state.

Nothing executes, so a full-size LM traces in seconds on a CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

# A collective below this element count is a packed metric vector (the
# losses, the health partials, the finite flag), not gradient traffic.
GRAD_MIN_ELEMS = 128

N_REPLICAS = 8  # the fake world every golden traces at

_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "broadcast_": "broadcast",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "barrier": "barrier",
}
# Ops whose first argument is the result (the gathers and scatters write
# into it); for the rest the first tensor is both.
_OUT_FIRST = ("_allgather_base_", "_reduce_scatter_base_",
              "alltoall_base_")

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
           torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
           torch.bool: "pred"}
_ITEMSIZE = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
             "f32": 4, "s32": 4, "f64": 8, "s64": 8}

def dtype_name(dtype: torch.dtype) -> str:
  return _DTYPES.get(dtype, str(dtype).replace("torch.", ""))


@dataclasses.dataclass
class Collective:
  """One collective the step issued."""
  kind: str        # all-reduce | all-gather | reduce-scatter | ...
  dtype: str       # wire dtype
  elems: int       # result elements
  placement: str   # top_level | in_backward | per_microbatch
  group_size: int  # ranks of its process group
  index: int = -1  # issue order
  microbatch: int = 0  # forward calls made when it was issued
  # Elements of the whole vector (a scatter's input, a gather's result):
  # the rank reads it, so a rank does not change with the world size.
  full_elems: int = 0

  @property
  def scalar(self) -> bool:
    return max(self.elems, self.full_elems) < GRAD_MIN_ELEMS

  @property
  def in_loop(self) -> bool:
    """Inside the microbatch loop (the JAX package's scanned body)."""
    return self.placement == "per_microbatch"

  @property
  def in_backward(self) -> bool:
    return self.placement == "in_backward"

  @property
  def nbytes(self) -> int:
    return self.elems * _ITEMSIZE.get(self.dtype, 4)

  def is_gradient_traffic(self) -> bool:
    return self.kind == "all-reduce" and not self.scalar

  def schedule_entry(self) -> Dict[str, Any]:
    """The golden row of the ordered schedule: what two ranks must agree
    on to meet (kind, wire dtype, rank, placement) and the group's size."""
    return {"index": self.index, "kind": self.kind, "dtype": self.dtype,
            "rank": "scalar" if self.scalar else "tensor",
            "placement": self.placement,
            "group_sizes": [self.group_size] if self.group_size else []}


@dataclasses.dataclass
class ProgramContract:
  """What one traced step did."""
  config: Dict[str, Any]          # the param overrides that produced it
  program: str                    # train_step | serving_decode | ...
  collectives: List[Collective]
  host_transfers: List[str]       # ops that read a value to the host
  optimizer_applies: int          # optimizer.step calls in the step
  optimizer_apply_in_loop: bool   # ... inside the microbatch loop
  state_in_place: bool            # weights and optimizer state kept
  in_place_tensors: int           # state tensors written in place
  largest_tensor_bytes: int
  largest_tensor_type: str        # e.g. "f32[4096,1001]"
  peak_live_bytes: int
  # Calls of the hand-written kernels' custom ops (torch.ops.kf_torch.*)
  # by name: the kernels the step routes to on a card.
  kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
  aux: Dict[str, Any] = dataclasses.field(default_factory=dict)

  @property
  def optimizer_apply_present(self) -> bool:
    return self.optimizer_applies > 0

  def gradient_collectives(self) -> List[Collective]:
    return [c for c in self.collectives if c.is_gradient_traffic()]

  def in_loop_collectives(self) -> List[Collective]:
    return [c for c in self.collectives if c.in_loop]

  def in_backward_collectives(self) -> List[Collective]:
    return [c for c in self.collectives if c.in_backward]

  def collective_schedule(self) -> List[Dict[str, Any]]:
    """The ORDERED schedule, one row a collective in issue order: two
    ranks whose inventories agree can still deadlock when these differ."""
    return [c.schedule_entry() for c in self.collectives]


# -- the recording mode --------------------------------------------------------

def _type_str(t: torch.Tensor) -> str:
  return f"{dtype_name(t.dtype)}[{','.join(str(d) for d in t.shape)}]"


def _nbytes(t: torch.Tensor) -> int:
  return t.numel() * t.element_size()


def _group_size(args) -> int:
  """The size of the process group among a c10d op's arguments."""
  for a in args:
    if isinstance(a, torch.ScriptObject):
      try:
        return int(dist.ProcessGroup.unbox(a).size())
      except RuntimeError:  # another custom class (the ReduceOp)
        continue
  return 0


def storage_key(t: torch.Tensor) -> int:
  """One key for every view of one storage (fake tensors included)."""
  return t.untyped_storage()._cdata


def _written(func, args, kwargs) -> List[torch.Tensor]:
  """The tensors an op writes in place (its schema's mutable arguments)."""
  out = []
  schema = func._schema
  for i, arg in enumerate(schema.arguments):
    if arg.alias_info is None or not arg.alias_info.is_write:
      continue
    v = args[i] if i < len(args) else kwargs.get(arg.name)
    out.extend(t for t in torch.utils._pytree.tree_leaves(v)
               if isinstance(t, torch.Tensor))
  return out


def _no_value(t: torch.Tensor):
  """The answer to a host read of a fake tensor, which holds no value."""
  if t.dtype == torch.bool:
    return False
  return 0.0 if t.dtype.is_floating_point else 0


class _AnswerHostReads(TorchDispatchMode):
  """Answers host reads (the build's initializers read a few) and records
  nothing."""

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if func is torch.ops.aten._local_scalar_dense.default:
      return _no_value(args[0])
    return func(*args, **(kwargs or {}))


class Recorder(TorchDispatchMode):
  """Records the collectives, host transfers, buffers and live bytes of
  the ops it sees (see the module docstring). ``microbatches`` and the
  forward count place a collective in the --num_grad_accum loop."""

  def __init__(self, microbatches: int = 1, base_bytes: int = 0):
    super().__init__()
    self.microbatches = max(1, int(microbatches))
    self.forwards = 0
    self.loop_done = self.microbatches == 1
    self._saw_backward = False
    self.collectives: List[Collective] = []
    self.host_transfers: List[str] = []
    self.largest = (0, "")
    self.written = set()  # storage keys written in place
    self.kernel_calls: Dict[str, int] = {}  # kf_torch custom ops
    self.live = int(base_bytes)
    self.peak = int(base_bytes)

  # Placement state ---------------------------------------------------------
  def note_forward(self, *_):
    self.forwards += 1
    self._saw_backward = False

  def placement(self) -> str:
    in_bwd = torch._C._current_graph_task_id() >= 0
    if not self.loop_done:
      if in_bwd and self.forwards >= self.microbatches:
        self._saw_backward = True
      elif (not in_bwd and self._saw_backward
            and self.forwards >= self.microbatches):
        self.loop_done = True
    if not self.loop_done and self.forwards >= 1:
      return "per_microbatch"
    return "in_backward" if in_bwd else "top_level"

  def _free(self, nbytes: int) -> None:
    self.live -= nbytes

  def _note_tensors(self, out, inputs) -> None:
    ids = {id(t) for t in inputs}
    for t in torch.utils._pytree.tree_leaves(out):
      if not isinstance(t, torch.Tensor) or id(t) in ids:
        continue
      n = _nbytes(t)
      if n > self.largest[0]:
        self.largest = (n, _type_str(t))
      self.live += n
      self.peak = max(self.peak, self.live)
      weakref.finalize(t, self._free, n)

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    where = self.placement()
    name = func.__name__.split(".")[0]
    if func.namespace == "kf_torch":
      self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
    if func.namespace == "c10d":
      kind = _KINDS.get(name)
      if kind is not None:
        tensors = [t for t in torch.utils._pytree.tree_leaves(args)
                   if isinstance(t, torch.Tensor)]
        if tensors:
          res = tensors[0]
          wire = tensors[1] if (name in _OUT_FIRST
                                and len(tensors) > 1) else res
          self.collectives.append(Collective(
              kind=kind, dtype=dtype_name(wire.dtype), elems=res.numel(),
              placement=where, group_size=_group_size(args),
              index=len(self.collectives), microbatch=self.forwards,
              full_elems=max(t.numel() for t in tensors)))
      return func(*args, **kwargs)
    if func is torch.ops.aten._local_scalar_dense.default:
      self.host_transfers.append("_local_scalar_dense")
      return _no_value(args[0])
    if func in (torch.ops.aten._to_copy.default,
                torch.ops.aten.copy_.default):
      src = args[1] if func is torch.ops.aten.copy_.default else args[0]
      dst_dev = (args[0].device if func is torch.ops.aten.copy_.default
                 else kwargs.get("device", src.device))
      if isinstance(src, torch.Tensor) and dst_dev is not None and \
          torch.device(dst_dev).type != src.device.type:
        self.host_transfers.append(
            f"copy {src.device.type}->{torch.device(dst_dev).type}")
    if func._schema.is_mutable:
      self.written.update(storage_key(t) for t in _written(func, args,
                                                           kwargs))
    out = func(*args, **kwargs)
    if not func.is_view:
      self._note_tensors(out, torch.utils._pytree.tree_leaves(
          (args, kwargs)))
    return out


# -- the fake world ------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int = N_REPLICAS):
  """A process group of ``world`` fake ranks (this process rank 0) for the
  block: collectives return at once and move nothing. Refuses to replace a
  real group. A world of 1 makes none."""
  if int(world) == 1:
    # A single card's run makes no process group, so its trace has none.
    yield
    return
  from torch.testing._internal.distributed.fake_pg import FakeStore
  if dist.is_initialized():
    raise RuntimeError("a process group is already initialized; the "
                       "contract traces in a fake world of its own")
  dist.init_process_group("fake", store=FakeStore(), rank=0,
                          world_size=int(world))
  try:
    yield
  finally:
    dist.destroy_process_group()


def _state_tensors(step) -> List[torch.Tensor]:
  """The weights the optimizer owns and its state tensors."""
  opt = step.optimizer
  weights = [p for g in opt.param_groups for p in g["params"]]
  state = [v for p in weights for v in opt.state.get(p, {}).values()
           if isinstance(v, torch.Tensor) and v.dim() > 0]
  return weights + state


def trace_call(fn, module, state: List[torch.Tensor], inputs,
               microbatches: int = 1, optimizer=None,
               config: Optional[dict] = None, program: str = "train_step",
               aux: Optional[dict] = None,
               count_flops: bool = False) -> ProgramContract:
  """One call of ``fn`` (built on fake tensors) under the recorder.
  ``module``'s forward calls are counted for the microbatch placement;
  ``state`` are the tensors the program must update in place (the
  weights and the optimizer's state, or a decode step's caches);
  ``optimizer``'s step hooks count its applies."""
  base_tensors = list(state) + list(module.buffers()) + [
      t for t in torch.utils._pytree.tree_leaves(inputs)
      if isinstance(t, torch.Tensor)]
  rec = Recorder(microbatches,
                 base_bytes=sum(_nbytes(t) for t in base_tensors))
  for t in base_tensors + list(module.parameters()):
    if _nbytes(t) > rec.largest[0]:
      rec.largest = (_nbytes(t), _type_str(t))
  applies = []
  hooks = [module.register_forward_pre_hook(rec.note_forward)]
  if optimizer is not None:
    hooks.append(optimizer.register_step_pre_hook(
        lambda *_: applies.append(rec.placement())))
  try:
    with warnings.catch_warnings():
      # torch.distributed's deprecation notes of the *_tensor collectives.
      warnings.simplefilter("ignore", FutureWarning)
      if count_flops:
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        with counter, rec:
          fn()
      else:
        with rec:
          fn()
  finally:
    for h in hooks:
      h.remove()
  aux = dict(aux or {})
  if count_flops:
    aux["flops"] = float(counter.get_total_flops())
  written = sum(1 for t in state if storage_key(t) in rec.written)
  return ProgramContract(
      config=dict(config or {}), program=program,
      collectives=rec.collectives,
      host_transfers=sorted(set(rec.host_transfers)),
      optimizer_applies=len(applies),
      optimizer_apply_in_loop=any(p != "top_level" for p in applies),
      state_in_place=bool(state) and written == len(state),
      in_place_tensors=written,
      largest_tensor_bytes=rec.largest[0],
      largest_tensor_type=rec.largest[1],
      peak_live_bytes=rec.peak, kernel_calls=dict(rec.kernel_calls),
      aux=aux)


def trace_step(step, images, labels, microbatches: int = 1,
               config: Optional[dict] = None, program: str = "train_step",
               aux: Optional[dict] = None,
               count_flops: bool = False) -> ProgramContract:
  """One call of a built (fake) TrainStep under the recorder; its state
  is kept in place when the optimizer still owns the same weight and
  state tensors after the step and every one of them was written."""
  before = _state_tensors(step)
  contract = trace_call(lambda: step.run(images, labels), step.module,
                        before, (images, labels), microbatches,
                        step.optimizer, config, program, aux, count_flops)
  after = _state_tensors(step)
  if len(after) != len(before) or any(a is not b
                                      for a, b in zip(after, before)):
    contract.state_in_place = False
  return contract


# -- config -> contract --------------------------------------------------------

@contextlib.contextmanager
def _set_data_conversion():
  """``Module.to(memory_format=...)`` swaps a fake parameter for its
  converted copy, which the weak reference FakeTensorMode keeps on it
  forbids; inside the build a fake parameter takes the converted value by
  ``.data =``, as a real one does."""
  from torch._subclasses.fake_tensor import FakeTensor
  swap = torch.utils.swap_tensors

  def set_data(t1, t2):
    if not isinstance(t1, FakeTensor):
      return swap(t1, t2)
    with torch.no_grad():
      t1.data = t2.data

  torch.utils.swap_tensors = set_data
  try:
    yield
  finally:
    torch.utils.swap_tensors = swap


def build_fake_bench(overrides: Dict[str, Any], world: int):
  """(bench, module, step, images, labels): ``BenchmarkCNN(params).build()``
  on fake tensors. Call inside :func:`fake_world`."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import params as params_lib
  kw = dict(num_batches=2)
  kw.update(overrides)
  kw.update(device="cpu", num_devices=int(world))
  p = params_lib.make_params(**kw)
  with FakeTensorMode(allow_non_fake_inputs=True), _AnswerHostReads(), \
      _set_data_conversion():
    bench = benchmark.BenchmarkCNN(p)
    module, step, images, labels = bench.build()
  return bench, module, step, images, labels


def trace_contract(overrides: Dict[str, Any], world: int = N_REPLICAS,
                   program: str = "train_step",
                   count_flops: bool = False) -> ProgramContract:
  """Build the step for ``overrides`` as BenchmarkCNN does, in a fake
  world of ``world`` ranks (``num_devices`` in ``overrides`` wins) on fake
  tensors, and record one call, with its FLOPs when ``count_flops``
  (FlopCounterMode, the kernels' custom ops by their own formulas). The
  eager step: a K-step chunk is K copies of it (graph capture off)."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  if program != "train_step":
    raise ValueError(f"unknown train program {program!r}; the port traces "
                     "the eager train_step (a K-step chunk is K copies)")
  world = int(overrides.get("num_devices", world))
  with fake_world(world):
    bench, module, step, images, labels = build_fake_bench(overrides, world)
    aux = step_aux(bench, module, step, images)
    with FakeTensorMode(allow_non_fake_inputs=True):
      contract = trace_step(step, images, labels, bench.num_grad_accum,
                            config=overrides, program=program, aux=aux,
                            count_flops=count_flops)
  return contract


def step_aux(bench, module, step, images) -> Dict[str, Any]:
  """The bounds the rules check a contract against, read from the built
  step (never from the trace itself)."""
  from kf_benchmarks_tpu_torch.ops import overlap as overlap_lib
  p = bench.params
  n = int(bench.world_size)
  aux: Dict[str, Any] = {
      "model": bench.model.get_name(),
      "num_devices": n,
      "num_data_replicas": n,
      "per_device_batch": int(images.shape[0]),
      "health_stats": bool(getattr(step, "health", False)),
      "strategy": getattr(bench.strategy, "name", None),
      "sequential_apply": bool(getattr(bench.strategy, "sequential_apply",
                                       False)),
  }
  # The gradient wire the flags ask for: the packed paths (the overlap's
  # buckets, the spec planner, repacking, small-gradient packs, the
  # hierarchical copy) compact it (allreduce.compact_wire_dtype); the
  # per-tensor and the sharded exchanges send each gradient as it is.
  from kf_benchmarks_tpu_torch.ops import allreduce
  compact = allreduce.compact_wire_dtype(p)
  packs = (getattr(step, "_reducer", None) is not None
           or bool(p.all_reduce_spec) or bool(p.gradient_repacking)
           or p.agg_small_grads_max_bytes > 0 or bool(p.hierarchical_copy))
  aux["expected_grad_wire"] = dtype_name(
      compact if compact is not None and packs and step.sharding is None
      else bench.param_dtype)
  opt = step.optimizer
  weights = [q for g in opt.param_groups for q in g["params"]]
  aux["opt_state_bytes_per_device"] = sum(
      _nbytes(v) for q in weights for v in opt.state.get(q, {}).values()
      if isinstance(v, torch.Tensor))
  sharding = step.sharding
  if sharding is not None:
    aux["sharded_state"] = True
  if sharding is not None and sharding.shard_params:
    aux["fsdp_params"] = True
    aux["fsdp_engaged"] = bool(sharding.in_step)
    aux["fsdp_scan_prefixes"] = list(getattr(module, "stacked_prefixes",
                                             ()) or ())
    sizes = [math.prod(s) for s in sharding.shapes]
    itemsize = {id(q): q.element_size() for q in sharding.shards}
    isz = [itemsize[id(s)] for s in sharding.shards]
    aux["fsdp_param_full_bytes"] = sum(z * b for z, b in zip(sizes, isz))
    aux["fsdp_step_gathers"] = len(sharding.buckets)
    aux["fsdp_block_gathers"] = len(sharding.block_buckets)

    def gather_bytes(idx):
      return sum(n * (-(-sizes[i] // n)) * isz[i] for i in idx)
    aux["fsdp_max_gather_bytes"] = max(
        [gather_bytes(b) for b in sharding.buckets + sharding.block_buckets]
        or [0])
  if bench.model.get_name() == "transformer_lm":
    from kf_benchmarks_tpu_torch.models import transformer_lm as lm
    itemsize = torch.finfo(bench.compute_dtype).bits // 8
    aux["btv_bytes"] = int(images.shape[0]) * lm.SEQ_LEN * lm.VOCAB * itemsize
  reducer = getattr(step, "_reducer", None)
  if reducer is not None:
    aux["overlap_step_buckets"] = len(reducer.buckets)
    aux["overlap_module_prefixes"] = list(
        getattr(module, "stacked_prefixes", ()) or ())
  return aux


# -- the golden lattice --------------------------------------------------------

# The JAX package's golden names that the port runs (its gspmd_* twins and
# lm_packed wait for ROADMAP item 8, serving_decode_tp for item 11), with
# the same make_params overrides on the cpu / 8-rank / trivial defaults.
GOLDEN_CONFIGS: "OrderedDict[str, Dict[str, Any]]" = OrderedDict([
    ("base", dict(model="trivial", batch_size=4)),
    ("accum4_packed", dict(model="trivial", batch_size=4, num_grad_accum=4,
                           agg_small_grads_max_bytes=1 << 30,
                           agg_small_grads_max_group=1000)),
    ("overlap", dict(model="trivial", batch_size=4,
                     overlap_gradient_reduction=True)),
    ("overlap_bf16_wire", dict(model="trivial", batch_size=4,
                               overlap_gradient_reduction=True,
                               compact_gradient_transfer_f32=True)),
    ("health", dict(model="trivial", batch_size=4, health_stats=True)),
    ("lm_base", dict(model="transformer_lm", batch_size=8)),
    ("lm_overlap", dict(model="transformer_lm", batch_size=8,
                        overlap_gradient_reduction=True)),
    ("sharded_base", dict(model="trivial", batch_size=4,
                          optimizer="momentum",
                          shard_optimizer_state=True)),
    ("sharded_accum", dict(model="trivial", batch_size=4,
                           num_grad_accum=4, optimizer="momentum",
                           shard_optimizer_state=True)),
    ("lm_sharded", dict(model="transformer_lm", batch_size=8,
                        optimizer="momentum",
                        shard_optimizer_state=True)),
    ("sharded_rescale", dict(model="trivial", batch_size=4,
                             num_devices=4, optimizer="momentum",
                             shard_optimizer_state=True)),
    ("fsdp_base", dict(model="trivial", batch_size=4,
                       optimizer="momentum",
                       shard_optimizer_state=True, shard_params=True)),
    ("fsdp_lm", dict(model="transformer_lm", batch_size=8,
                     optimizer="momentum",
                     shard_optimizer_state=True, shard_params=True)),
    ("traced", dict(model="trivial", batch_size=4,
                    trace_events_file="trace_events.json")),
    ("metrics_on", dict(model="trivial", batch_size=4,
                        metrics_port=9309, run_store_dir="run_store")),
])


# -- serving programs ----------------------------------------------------------

# The engine's programs at the zoo transformer_lm's dims: overrides are
# serving/decode.LMSpec fields plus the bucket; a ``program`` key routes
# the trace (the decode step, or the speculative target's verify).
SERVING_GOLDEN_CONFIGS: "OrderedDict[str, Dict[str, Any]]" = OrderedDict([
    ("serving_decode", dict(bucket=4)),
    ("serving_decode_int8", dict(bucket=4, quantize="int8")),
    ("serving_decode_paged", dict(bucket=4, kv_page_size=128)),
    ("serving_verify", dict(bucket=4, speculative_k=4, draft_n_layers=2,
                            program="serving_verify")),
])


def trace_serving_contract(overrides: Dict[str, Any],
                           program: str = "serving_decode"
                           ) -> ProgramContract:
  """The engine's decode step (or verify program) for an LMSpec override
  dict, built as serving/engine.py builds it, on fake tensors; one call
  recorded. The decode step must update its caches, positions and tokens
  in place (what a CUDA graph replays); the verify program owns no
  state."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  from kf_benchmarks_tpu_torch.serving import engine as engine_lib
  kw = dict(overrides)
  program = kw.pop("program", program)
  bucket = int(kw.pop("bucket", 4))
  names = {f.name for f in dataclasses.fields(decode_lib.LMSpec)}
  unknown = sorted(set(kw) - names)
  if unknown:
    raise ValueError(f"unknown LMSpec override(s) {unknown}; have "
                     f"{sorted(names)}")
  spec = decode_lib.LMSpec(**kw)
  itemsize = torch.finfo(spec.dtype).bits // 8
  aux: Dict[str, Any] = {
      "bucket_ladder": list(engine_lib.DEFAULT_BUCKET_LADDER),
      "decode_batch": bucket,
      "kv_ring_bytes": (spec.n_layers * bucket * spec.max_len *
                        spec.n_heads * spec.head_dim * itemsize),
      "vocab_logits_bytes": bucket * spec.max_len * spec.vocab * itemsize,
  }
  with FakeTensorMode(allow_non_fake_inputs=True):
    with _AnswerHostReads():
      variables = decode_lib.prepare_variables(
          spec, decode_lib.init_variables(spec))
    if program == "serving_verify":
      aux["verify_chunk"] = decode_lib.verify_chunk(spec)
      aux["verify_logits_bytes"] = (bucket * decode_lib.verify_chunk(spec)
                                    * spec.vocab * itemsize)
      with _AnswerHostReads():
        module = _served_module(spec, variables)
        rows = torch.zeros((bucket, spec.max_len), dtype=torch.int32)
      verify = decode_lib.verify_fn(spec)
      return trace_call(lambda: verify(module, rows), _root(module), [],
                        rows, config=overrides, program=program, aux=aux)
    with _AnswerHostReads():
      module = _served_module(spec, variables)
      cache = decode_lib.init_cache(spec, bucket, "cpu")
      active = torch.zeros(bucket, dtype=torch.bool)
    step = decode_lib.decode_fn(spec)
    args = [cache.k, cache.v, cache.pos, cache.tok]
    if spec.kv_page_size:
      aux["kv_page_size"] = spec.kv_page_size
      aux["kv_pool_bytes"] = (
          spec.n_layers * decode_lib.kv_pool_pages(spec, bucket) *
          spec.kv_page_size * spec.n_heads * spec.head_dim * itemsize)
      args.append(torch.zeros((bucket, spec.pages_per_slot),
                              dtype=torch.int32))
    outs = []
    contract = trace_call(lambda: outs.extend(step(module, *args, active)),
                          _root(module), list(cache), args + [active],
                          config=overrides, program=program, aux=aux)
  # The step returns the very tensors it updated (tok, k, v, pos).
  if [id(t) for t in outs] != [id(cache.tok), id(cache.k), id(cache.v),
                               id(cache.pos)]:
    contract.state_in_place = False
  return contract


def _served_module(spec, variables):
  """decode.load_module on the CPU; a quantized state's skeleton module is
  made on the meta device outside the fake mode (its parameters are never
  read), as load_module moves it there."""
  from kf_benchmarks_tpu_torch import quantization
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  if not quantization.has_quantized_leaves(variables):
    return decode_lib.load_module(spec, variables, "cpu")
  with torch._C._DisableTorchDispatch(), torch.device("meta"):
    skeleton = decode_lib.forward_module(spec).eval()
  return decode_lib.QuantizedLM(spec, skeleton, variables)


def _root(module) -> torch.nn.Module:
  """The nn.Module of a served module (a QuantizedLM wraps one)."""
  return (module if isinstance(module, torch.nn.Module)
          else module._forward.module)
