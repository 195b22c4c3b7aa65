"""Rank processes of the port's data-parallel tests (gloo on the CPU).

``run_world(world, cases, tmp_dir)`` spawns ``world`` ranks that join one
gloo group through a file store in ``tmp_dir`` and run every case in
order, each from the same flax variables and each rank on its own numpy
batch, and returns what each rank recorded: per case the losses of every
step (the mean over the ranks, as the step reports them), the weights after
every step and the final batch-norm running averages, all in flax layout.
This module imports no JAX, so the ranks start without it.

A case is a dict: ``name``, ``model`` ("trivial", "resnet" or "lm", the
two-layer transformer LM of ``SmallLM``), ``params`` (overrides of the
port's Params: the strategy, and --shard_optimizer_state, --shard_params,
--overlap_gradient_reduction, --num_grad_accum), ``lr``, ``steps``,
``variables`` (numpy flax variables, or ``stacked`` ones with a leading
replica axis for one start per rank) and ``batches`` (one (images, labels)
per rank). Optional: ``k`` runs the steps as dispatches of K through
TrainChunk, ``weight_decay`` replaces WEIGHT_DECAY, ``restore`` names a
checkpoint file to resume from before the steps, ``save`` one to write
after them, and ``snapshot`` returns the savable_state after them (a
collective under sharded state, so every rank takes it). Besides the
losses and weights, a training case records the bytes of the optimizer
state and of the parameters this rank holds after its steps (its shards'
under sharded state) and the number of buckets of the overlapped
reduction or the FSDP gather.
``{"name": "eval", "model": ..., "variables": ..., "batches": ...}`` runs
the eval step once on each rank's batch. Three extra cases check the
collectives themselves: ``{"name":
"broadcast_init", "variables": ...}``, ``{"name": "pair_average",
"steps": k}`` and ``{"name": "reducers", "tensors": [per-rank lists of
numpy arrays], "reducers": [(label, kind, kwargs, bf16 wire)]}``, which
runs each reducer of ops/allreduce.py on the rank's tensors.
"""

import os

import numpy as np
import torch
import torch.multiprocessing as mp

from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import train_step
from kf_benchmarks_tpu_torch.models import model as model_lib
from kf_benchmarks_tpu_torch.models import resnet_model
from kf_benchmarks_tpu_torch.models import transformer_lm
from kf_benchmarks_tpu_torch.models import trivial_model
from kf_benchmarks_tpu_torch.ops import allreduce
from kf_benchmarks_tpu_torch.ops import overlap
from kf_benchmarks_tpu_torch.ops import sharded
from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.parallel import strategies

RESNET_LAYER_COUNTS = (1, 2, 1, 1)
NCLASS = 10
WEIGHT_DECAY = 1e-3
# The two-layer LM of the data-parallel tests (the dispatch tests' size).
LM_VOCAB, LM_D, LM_LAYERS, LM_HEADS, LM_DFF, LM_T, LM_BLOCK = (
    128, 32, 2, 4, 64, 64, 16)
LM_LOSS_CHUNK = 16


class SmallLM(transformer_lm.TransformerLMModel):
  """transformer_lm at the tests' size, flash attention (its plain
  version on the CPU), the scan layout."""

  LOSS_CHUNK = LM_LOSS_CHUNK

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    del nclass
    return transformer_lm.TransformerLM(
        LM_VOCAB, LM_D, LM_LAYERS, LM_HEADS, LM_DFF, LM_BLOCK, LM_BLOCK,
        "flash", True, True, LM_T, dtype, generator)


def port_model(name):
  if name == "trivial":
    return trivial_model.TrivialModel()
  if name == "lm":
    return SmallLM()
  return resnet_model.ResnetModel("resnet50_v1.5", RESNET_LAYER_COUNTS)


def make_step(model, module, p, lr, weight_decay=WEIGHT_DECAY):
  """The train step of ``p`` as benchmark.BenchmarkCNN.build makes it:
  the strategy, this rank's shards under --shard_optimizer_state (the
  optimizer steps on them) and the overlap spec."""
  sharding = sharded.build(p, module, p.num_grad_accum)
  opt = optimizers.get_optimizer(
      p, module.parameters() if sharding is None else sharding.shards)
  return train_step.TrainStep(
      model, module, opt, lambda s: lr, weight_decay,
      strategy=strategies.get_strategy(p), num_grad_accum=p.num_grad_accum,
      sharding=sharding, overlap=overlap.build(p))


def held_bytes(step):
  """(optimizer-state bytes, parameter bytes) this rank holds."""
  nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
  opt = [v for st in step.optimizer.state.values() for v in st.values()
         if isinstance(v, torch.Tensor)]
  params = list(step.module.parameters())
  if step.sharding is not None and step.sharding.shard_params:
    params += step.sharding.shards
  return nbytes(opt), nbytes(params)


def num_buckets(step):
  if step._reducer is not None:
    return len(step._reducer.buckets)
  if step.sharding is not None:
    return len(step.sharding.buckets) + len(step.sharding.block_buckets)
  return 0


def flax_layout(module):
  """{flax path: numpy} of the module's parameters and buffers: the path
  within its collection, (layer, leaf) for a CNN, and for a layer of the
  transformer's scanned block stack that path and the layer's index."""
  out = {}
  for key, t in module.state_dict().items():
    path, kind, index = convert.flax_source(key, t, module)
    name = path[1:] if index is None else path[1:] + (index,)
    out[name] = convert.to_flax_layout(
        t.detach().float().numpy().copy(), kind)
  return out


def _train_case(case, rank, world):
  model = port_model(case["model"])
  wd = case.get("weight_decay", WEIGHT_DECAY)
  p = params_lib.make_params(device="cpu", num_devices=world,
                             weight_decay=wd, **case["params"])
  # --fp16_vars: bf16 compute over bf16 parameters (the f32 init rounded).
  module = model.make_module(
      NCLASS, torch.bfloat16 if p.fp16_vars else torch.float32)
  if "stacked" in case:
    state = convert.replica_state_dict(case["stacked"], rank, module)
  else:
    state = convert.flax_to_state_dict(case["variables"], module)
  module.load_state_dict(state)
  if p.fp16_vars:
    model_lib.cast_params(module, torch.bfloat16)
  step = make_step(model, module, p, case["lr"], wd)
  with torch.no_grad():
    step.strategy.broadcast_init([q.detach() for q in module.parameters()])
  if "restore" in case:
    snap = checkpoint.load_checkpoint(case["restore"])
    step.global_step = checkpoint.restore_state(module, step.optimizer, snap,
                                                step.sharding)
    step.restore_counters(snap)
  images, labels = case["batches"][rank]
  x = torch.from_numpy(images)
  y = torch.from_numpy(labels).long()
  losses, weights = [], []
  k = case.get("k", 1)
  chunk = train_step.TrainChunk(step, k) if k > 1 else None
  done = 0
  while done < case["steps"]:
    d = min(k, case["steps"] - done)
    if chunk is None:
      m = {key: v.reshape(1) for key, v in step(x, y).items()}
    else:
      m = chunk(x, y, d)
    losses += list(zip(m["base_loss"].tolist(), m["total_loss"].tolist()))
    weights.append(torch.cat([q.reshape(-1) for q in step.full_weights()]))
    done += d
  opt_bytes, param_bytes = held_bytes(step)
  with step.full_params():
    final = flax_layout(module)
  out = {"losses": losses, "weights": weights, "final": final,
         "opt_bytes": opt_bytes, "param_bytes": param_bytes,
         "buckets": num_buckets(step),
         "shard_dtypes": sorted({str(t.dtype) for t in step.sharding.shards})
                         if step.sharding is not None else []}
  if "save" in case or case.get("snapshot"):
    snap = checkpoint.savable_state(module, step.optimizer, step.global_step,
                                    counters=step.counters(),
                                    sharding=step.sharding)
    if case.get("snapshot"):
      out["snapshot"] = snap
    if "save" in case:
      if rank == 0:
        torch.save(snap, case["save"])
      # A later case may restore it on any rank.
      kungfu.run_barrier()
  return out


def _broadcast_case(case, rank):
  """Rank r starts from the weights plus r; broadcast_init must leave
  every rank with rank 0's bits."""
  module = port_model("trivial").make_module(NCLASS, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(case["variables"],
                                                    module))
  weights = [q.detach() for q in module.parameters()]
  with torch.no_grad():
    for w in weights:
      w.add_(float(rank))
    before = torch.cat([w.reshape(-1).clone() for w in weights])
    strategies.KungFuStrategy(option="async_sgd").broadcast_init(weights)
  return {"before": before,
          "after": torch.cat([w.reshape(-1).clone() for w in weights])}


def _pair_average_case(case, rank):
  """Per-rank random tensors through ``steps`` gossip rounds."""
  gen = torch.Generator().manual_seed(100 + rank)
  tensors = [torch.randn(5, 3, generator=gen) * (rank + 1),
             torch.randn(7, generator=gen)]
  history = [torch.cat([t.reshape(-1).clone() for t in tensors])]
  for step in range(case["steps"]):
    kungfu.pair_average(tensors, step)
    history.append(torch.cat([t.reshape(-1).clone() for t in tensors]))
  return {"history": history}


def _eval_case(case, rank):
  """The eval step on the rank's batch: its metrics (the mean over the
  ranks)."""
  model = port_model(case["model"])
  module = model.make_module(NCLASS, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(case["variables"],
                                                    module))
  images, labels = case["batches"][rank]
  metrics = train_step.EvalStep(model, module)(
      torch.from_numpy(images), torch.from_numpy(labels).long())
  return {k: float(v) for k, v in metrics.items()}


def make_reducer(kind, kwargs, compact):
  """A reducer of ops/allreduce.py by kind: "planner" (kwargs: spec and
  optionally agg_max_bytes/agg_max_group), "pack_small", "repack" or
  "hier"."""
  wire = torch.bfloat16 if compact else None
  if kind == "planner":
    kw = dict(kwargs)
    spec = allreduce.parse_all_reduce_spec(kw.pop("spec"))
    return allreduce.CollectivePlanner(spec, compact_dtype=wire, **kw).reduce
  if kind == "pack_small":
    return lambda t: allreduce.pack_small_reduce(
        t, kwargs["max_bytes"], kwargs["max_group"], wire)
  if kind == "repack":
    return lambda t: allreduce.repack_reduce(t, kwargs["chunks"], wire)
  if kind == "hier":
    return lambda t: allreduce.hier_reduce(t, compact_dtype=wire)
  raise ValueError(kind)


def _reducers_case(case, rank, world):
  tensors = [torch.from_numpy(a) for a in case["tensors"][rank]]
  out = {}
  for label, kind, kwargs, compact in case["reducers"]:
    reduced = make_reducer(kind, kwargs, compact)(tensors)
    out[label] = [r.numpy().copy() for r in reduced]
  return out


def _rank(rank, world, cases, tmp_dir):
  torch.set_num_threads(1)
  mesh.init_process_group("cpu", world, rank,
                          "file://" + os.path.join(tmp_dir, "store"))
  try:
    out = {}
    for case in cases:
      if case["name"] == "broadcast_init":
        out[case["name"]] = _broadcast_case(case, rank)
      elif case["name"] == "pair_average":
        out[case["name"]] = _pair_average_case(case, rank)
      elif case["name"] == "reducers":
        out[case["name"]] = _reducers_case(case, rank, world)
      elif case["name"] == "eval":
        out[case["name"]] = _eval_case(case, rank)
      else:
        out[case["name"]] = _train_case(case, rank, world)
    kungfu.run_barrier()
  finally:
    mesh.destroy_process_group()
  torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))


def run_world(world, cases, tmp_dir):
  """Every rank's results, a list indexed by rank."""
  mp.spawn(_rank, args=(world, cases, str(tmp_dir)), nprocs=world,
           join=True)
  return [torch.load(os.path.join(str(tmp_dir), f"rank{r}.pt"),
                     weights_only=False) for r in range(world)]


def batches(world, n, size, seed, pixels=True):
  """One numpy (images, labels) batch per rank, each from its own seed:
  images in the synthetic pixel range, or standard normal."""
  out = []
  for r in range(world):
    rng = np.random.default_rng(seed + r)
    images = rng.normal(size=(n, size, size, 3))
    if pixels:
      images = np.clip(images, -2, 2) * 60.0 + 127.0
    images = images.astype(np.float32)
    out.append((images, rng.integers(0, NCLASS, n).astype(np.int32)))
  return out
