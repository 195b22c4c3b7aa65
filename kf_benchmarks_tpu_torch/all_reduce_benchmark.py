"""All-reduce microbenchmark: model-shaped gradients through the port's
reducers, over NCCL on the card and gloo on the CPU.

The port's counterpart of kf_benchmarks_tpu/all_reduce_benchmark.py (ref:
scripts/tf_cnn_benchmarks/all_reduce_benchmark.py:60-180): random tensors
of the model's trainable-variable shapes (``get_var_shapes``, the JAX
package's flax leaf order), ``--iters_per_step`` chained reductions a step
(each iteration reads the previous one's result, perturbed, so none is a
fixpoint), timed steps and the mean time of one reduction. The reduction
is the one a step of the port issues: the --all_reduce_spec planner,
repacking, small-gradient packs or the per-tensor all-reduce mean
(ops/allreduce.py build_reducer).

``--sweep`` prints the (world, algorithm, packed size) table from one
command, the JAX package's rows and its one JSON line: each cell times a
k-iteration and a 2k-iteration chain of one packed vector and differences
them, so the per-step host cost cancels. ``reduce_scatter`` and
``all_gather`` time the sharded path's exchange (ops/sharded.py) beside
the all-reduce rows. The world is the process group's: a run makes a group
of one rank unless ``--num_devices=N`` spawns N (gloo with
``--device=cpu``). At world 1 a row times NCCL's own call on one card --
its launch and a local copy -- not a wire, and the output says so
(``wire_note``).

    python -m kf_benchmarks_tpu_torch.all_reduce_benchmark --model=resnet50 \\
        --num_batches=10 --all_reduce_spec=psum
    python -m kf_benchmarks_tpu_torch.all_reduce_benchmark --sweep \\
        --sweep_specs=psum,reduce_scatter,all_gather --sweep_sizes=256k,4m
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kf_benchmarks_tpu_torch.ops import allreduce
from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.utils import log as log_util

def wire_note() -> str:
  """What a world-1 row times: the backend's own call, not a wire."""
  backend = dist.get_backend() if dist.is_initialized() else "no group"
  what = ("NCCL's launch and a local copy on one card"
          if backend == "nccl" else f"{backend}'s call in one process")
  return f"world 1: each row times {what}, not a wire between devices"


def get_var_shapes(model, nclass: int = 1001) -> List[Tuple[int, ...]]:
  """The model's trainable-variable shapes in the JAX package's order and
  layout (flax's params leaves, sorted paths; a stacked block leaf as
  (L, ...)): the module made on the meta device, each parameter mapped to
  its flax leaf (convert.flax_source)."""
  from kf_benchmarks_tpu_torch import convert
  with torch.device("meta"):
    module = model.make_module(nclass, torch.float32)
  leaves: Dict[Tuple[str, ...], Dict[Optional[int], Tuple[int, ...]]] = {}
  for name, p in module.named_parameters():
    path, kind, index = convert.flax_source(name, p, module)
    shape = tuple(p.shape)
    if kind == "conv":
      shape = (shape[2], shape[3], shape[1], shape[0])
    elif kind == "dense":
      shape = (shape[1], shape[0])
    leaves.setdefault(path, {})[index] = shape
  out = []
  for path in sorted(leaves):
    layers = leaves[path]
    if None in layers:
      out.append(layers[None])
    else:
      out.append((len(layers),) + layers[min(layers)])
  return out


def make_reduce(params) -> Callable[[List[torch.Tensor]], List[torch.Tensor]]:
  """The reduction a train step of ``params`` issues: the flag-selected
  reducer of ops/allreduce.py, or the per-tensor all-reduce mean."""
  reducer = allreduce.build_reducer(params)
  if reducer is not None:
    return lambda ts: list(reducer(ts))

  def per_tensor(ts):
    kungfu.allreduce_mean(ts)
    return ts
  return per_tensor


def chained_reduce(tensors: List[torch.Tensor], iters: int,
                   reduce: Callable) -> List[torch.Tensor]:
  """``iters`` reductions in a chain: each reads the previous result plus
  1e-6, so none reduces an already-averaged fixpoint (the JAX package's
  build_all_reduce_step)."""
  for i in range(iters):
    tensors = reduce(tensors)
    if i + 1 < iters:
      tensors = [t + torch.tensor(1e-6, dtype=t.dtype, device=t.device)
                 for t in tensors]
  return tensors


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def _device_of(params) -> torch.device:
  return mesh.rank_device(params.device, mesh.local_rank())


def run_benchmark(params, iters_per_step: int = 5) -> Dict[str, float]:
  """Model-shaped tensors through ``iters_per_step`` chained reductions a
  step; the mean step time and the mean time of one reduction (ref:
  all_reduce_benchmark.py:155-180)."""
  from kf_benchmarks_tpu_torch.data import datasets
  from kf_benchmarks_tpu_torch.models import model_config
  dataset = datasets.create_dataset(params.data_dir, params.data_name)
  model = model_config.get_model_config(params.model, params, dataset.name)
  shapes = get_var_shapes(model, nclass=dataset.num_classes)
  device = _device_of(params)
  dtype = torch.bfloat16 if params.use_fp16 else torch.float32
  rng = np.random.RandomState(mesh.rank())
  tensors = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
      device=device, dtype=dtype) for s in shapes]
  reduce = make_reduce(params)
  n = mesh.world_size()
  num_bytes = sum(int(np.prod(s)) for s in shapes) * tensors[0].element_size()
  log_util.log_fn(
      f"All-reduce benchmark: {len(shapes)} tensors, "
      f"{num_bytes / 1e6:.2f} MB/replica, {n} replicas, "
      f"{iters_per_step} iters/step")
  if n == 1:
    log_util.log_fn(f"All-reduce benchmark: {wire_note()}")
  num_steps = params.num_batches or 10
  warmup = 2 if params.num_warmup_batches is None else params.num_warmup_batches
  for _ in range(max(warmup, 1)):
    out = chained_reduce([t.clone() for t in tensors], iters_per_step, reduce)
  _sync(device)
  start = time.perf_counter()
  for _ in range(num_steps):
    out = chained_reduce(out, iters_per_step, reduce)
  _sync(device)
  elapsed = time.perf_counter() - start
  avg_step = elapsed / num_steps
  avg_all_reduce = avg_step / iters_per_step
  log_util.log_fn(f"Average time per step: {avg_step:.6f} sec")
  log_util.log_fn(f"Average all-reduce time: {avg_all_reduce:.6f} sec")
  return {
      "average_time_per_step": avg_step,
      "average_all_reduce_time": avg_all_reduce,
      "num_tensors": len(shapes),
      "bytes_per_replica": num_bytes,
      "world": n,
  }


def vector_step(spec_name: str, compact: Optional[torch.dtype] = None
                ) -> Callable[[torch.Tensor], torch.Tensor]:
  """One link of a sweep chain on a packed vector: the spec's all-reduce
  mean (allreduce._reduce_packed: every algorithm of the grammar is one
  all_reduce in the port), or a raw reduce-scatter or all-gather whose
  first result element is folded back into the vector (the chain's data
  dependency, the JAX package's build_primitive_step)."""
  n = mesh.world_size()
  if spec_name == "reduce_scatter":
    def rs(vec):
      pad = (-vec.numel()) % n
      flat = torch.nn.functional.pad(vec, (0, pad)) if pad else vec
      out = flat.new_empty(flat.numel() // n)
      dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM)
      return vec + out[0] * 1e-6
    return rs
  if spec_name == "all_gather":
    def ag(vec):
      shard = vec[:max(1, vec.numel() // n)].contiguous()
      out = shard.new_empty(n * shard.numel())
      dist.all_gather_into_tensor(out, shard)
      return vec + out[0] * 1e-6
    return ag
  allreduce._parse_alg(spec_name)  # the grammar's check of the name
  return lambda vec: allreduce._reduce_packed(vec, compact) + 1e-6


def run_sweep(params, iters_per_step: int = 5,
              sweep_specs: str = "psum,rsag,hier,reduce_scatter,all_gather",
              sweep_sizes: str = "256k,4m") -> List[Dict[str, float]]:
  """The (world, spec, size) table at this process group's world, each
  cell's per-reduction time the difference of a 2k- and a k-iteration
  chain over k (constant costs cancel; clamped at 0). Markdown rows
  through the logger and ONE JSON line on stdout."""
  device = _device_of(params)
  n = mesh.world_size()
  num_steps = params.num_batches or 10
  warmup = params.num_warmup_batches
  warmup = 2 if warmup is None else max(warmup, 1)
  sizes = [allreduce._parse_limit(s.strip())
           for s in sweep_sizes.split(",") if s.strip()]
  specs = [s.strip() for s in sweep_specs.split(",") if s.strip()]
  dtype = torch.bfloat16 if params.use_fp16 else torch.float32
  itemsize = torch.finfo(dtype).bits // 8
  log_util.log_fn(f"All-reduce sweep: spec x size at world {n}, "
                  f"{iters_per_step} iters/step, {num_steps} timed steps")
  if n == 1:
    log_util.log_fn(f"All-reduce sweep: {wire_note()}")
  log_util.log_fn("| n | spec | size | step ms | per-all-reduce ms |")
  log_util.log_fn("|---|---|---|---|---|")
  rng = np.random.RandomState(mesh.rank())

  def timed(link, vec, iters):
    for _ in range(warmup):
      out = vec
      for _ in range(iters):
        out = link(out)
    _sync(device)
    start = time.perf_counter()
    for _ in range(num_steps):
      for _ in range(iters):
        out = link(out)
    _sync(device)
    return (time.perf_counter() - start) / num_steps

  rows = []
  for spec_name in specs:
    link = vector_step(spec_name)
    for size in sizes:
      elems = max(size // itemsize, n)
      vec = torch.from_numpy(rng.normal(size=elems).astype(np.float32)).to(
          device=device, dtype=dtype)
      step_s = timed(link, vec, iters_per_step)
      step2_s = timed(link, vec, 2 * iters_per_step)
      per_reduce_s = max(step2_s - step_s, 0.0) / iters_per_step
      rows.append({"n": n, "spec": spec_name, "bytes": int(size),
                   "step_ms": round(step_s * 1e3, 3),
                   "all_reduce_ms": round(per_reduce_s * 1e3, 3)})
      log_util.log_fn("| %d | %s | %s | %.3f | %.3f |" % (
          n, spec_name, _fmt_bytes(size), step_s * 1e3, per_reduce_s * 1e3))
  if mesh.rank() == 0:
    print(json.dumps({"metric": "all_reduce_sweep",
                      "iters_per_step": iters_per_step,
                      "num_steps": num_steps,
                      "dtype": str(dtype).replace("torch.", ""),
                      "world": n, "wire": "nccl-local" if (
                          n == 1 and device.type == "cuda") else None,
                      "rows": rows}), flush=True)
  return rows


def _fmt_bytes(size: int) -> str:
  if size % (1024 * 1024) == 0:
    return f"{size // (1024 * 1024)}m"
  if size % 1024 == 0:
    return f"{size // 1024}k"
  return str(size)


# -- the command line ---------------------------------------------------------------

def parse_args(argv: Optional[Sequence[str]] = None):
  """(params, the benchmark's own arguments)."""
  from kf_benchmarks_tpu_torch import flags
  from kf_benchmarks_tpu_torch import params as params_lib
  parser = argparse.ArgumentParser(
      prog="python -m kf_benchmarks_tpu_torch.all_reduce_benchmark",
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  flags.add_to_parser(parser)
  parser.add_argument("--iters_per_step", type=int, default=5,
                      help="Chained reductions a timed step (ref: "
                      "all_reduce_benchmark.py flag of the same name).")
  parser.add_argument("--sweep", action="store_true",
                      help="Print the (world, spec, size) table instead of "
                      "the model-shaped run.")
  parser.add_argument("--sweep_specs",
                      default="psum,rsag,hier,reduce_scatter,all_gather",
                      help="Comma-separated algorithms of --sweep (spec "
                      "grammar alg[#shards]; 'reduce_scatter' and "
                      "'all_gather' time the raw collective).")
  parser.add_argument("--sweep_sizes", default="256k,4m",
                      help="Comma-separated packed-vector byte sizes of "
                      "--sweep (<int>[kKmM]).")
  ns = parser.parse_args(argv)
  own = {k: getattr(ns, k) for k in ("iters_per_step", "sweep",
                                     "sweep_specs", "sweep_sizes")}
  overrides = {k: v for k, v in vars(ns).items()
               if v is not None and k not in own}
  return params_lib.make_params(**overrides), own


def _run(params, own) -> None:
  if own["sweep"]:
    run_sweep(params, own["iters_per_step"], own["sweep_specs"],
              own["sweep_sizes"])
  else:
    run_benchmark(params, own["iters_per_step"])


def _rank_main(rank: int, world: int, init_method: str, params, own) -> None:
  # torch.distributed's deprecation notes of the *_tensor collectives.
  warnings.filterwarnings("ignore", category=FutureWarning)
  backend = "nccl" if params.device == "gpu" else "gloo"
  if backend == "nccl":
    torch.cuda.set_device(rank)
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=world)
  try:
    if rank:
      log_util.log_fn = lambda *_: None
    _run(params, own)
  finally:
    dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> int:
  params, own = parse_args(argv)
  if params.device == "gpu" and not torch.cuda.is_available():
    print("all_reduce_benchmark: no CUDA device (pass --device=cpu for "
          "gloo on the CPU)", file=sys.stderr)
    return 1
  world = int(params.num_devices or 1)
  if world > 1:
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(world, mesh.local_init_method(), params, own),
             nprocs=world, join=True)
  else:
    _rank_main(0, 1, mesh.local_init_method(), params, own)
  return 0


if __name__ == "__main__":
  sys.exit(main())
