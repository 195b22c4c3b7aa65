"""Rank processes of the port's data-parallel tests (gloo on the CPU).

``run_world(world, cases, tmp_dir)`` spawns ``world`` ranks that join one
gloo group through a file store in ``tmp_dir`` and run every case in
order, each from the same flax variables and each rank on its own numpy
batch, and returns what each rank recorded: per case the losses of every
step (the mean over the ranks, as the step reports them), the weights after
every step and the final batch-norm running averages, all in flax layout.
This module imports no JAX, so the ranks start without it.

A case is a dict: ``name``, ``model`` ("trivial" or "resnet"), ``params``
(overrides of the port's Params), ``lr``, ``steps``, ``variables`` (numpy
flax variables, or ``stacked`` ones with a leading replica axis for one
start per rank) and ``batches`` (one (images, labels) per rank).
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

from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import train_step
from kf_benchmarks_tpu_torch.models import resnet_model
from kf_benchmarks_tpu_torch.models import trivial_model
from kf_benchmarks_tpu_torch.ops import allreduce
from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.parallel import strategies

RESNET_LAYER_COUNTS = (1, 2, 1, 1)
NCLASS = 10
WEIGHT_DECAY = 1e-3


def port_model(name):
  if name == "trivial":
    return trivial_model.TrivialModel()
  return resnet_model.ResnetModel("resnet50_v1.5", RESNET_LAYER_COUNTS)


def flax_layout(module):
  """{(layer, leaf): numpy} of the module's parameters and buffers."""
  out = {}
  for key, t in module.state_dict().items():
    _, layer, leaf, kind = convert.leaf_of(key, t)
    out[(layer, leaf)] = convert.to_flax_layout(t.detach().numpy().copy(),
                                                kind)
  return out


def _train_case(case, rank, world):
  model = port_model(case["model"])
  module = model.make_module(NCLASS, torch.float32)
  if "stacked" in case:
    state = convert.replica_state_dict(case["stacked"], rank, module)
  else:
    state = convert.flax_to_state_dict(case["variables"], module)
  module.load_state_dict(state)
  p = params_lib.make_params(device="cpu", num_devices=world,
                             weight_decay=WEIGHT_DECAY, **case["params"])
  strategy = strategies.get_strategy(p)
  opt = optimizers.get_optimizer(p, module.parameters())
  step = train_step.TrainStep(model, module, opt, lambda s: case["lr"],
                              WEIGHT_DECAY, strategy=strategy)
  with torch.no_grad():
    strategy.broadcast_init([q.detach() for q in module.parameters()])
  images, labels = case["batches"][rank]
  x = torch.from_numpy(images)
  y = torch.from_numpy(labels).long()
  losses, weights = [], []
  for _ in range(case["steps"]):
    m = step(x, y)
    losses.append((float(m["base_loss"]), float(m["total_loss"])))
    weights.append(torch.cat([q.detach().reshape(-1).clone()
                              for q in module.parameters()]))
  return {"losses": losses, "weights": weights, "final": flax_layout(module)}


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
