"""Overlapped gradient reduction and the FSDP parameter gather: bucketed
collectives issued inside the backward.

The port's counterpart of kf_benchmarks_tpu/ops/overlap.py. The post-hoc
reduction of the train step reduces the whole gradient set after the
backward; --overlap_gradient_reduction reduces it bucket by bucket while
the backward still runs, the pipelining the reference's chunked
batch_allreduce and --gradient_repacking exist for (ref:
batch_allreduce.py:391-481):

* **Buckets.** Parameters group at builder-layer granularity (the
  top-level key of their flax path, ops/sharded.py ``top_level_key``), in
  the JAX package's tree-flatten order, and groups merge into buckets of
  at most --reduce_bucket_mb (allreduce.plan_size_buckets; a layer larger
  than the bound keeps its own bucket). The transformer's scanned block
  stack (``stacked_prefixes``) is left out and gets one bucket per block
  (``block_buckets``, the JAX package's ``scan_block_hook``).
* **The reduction hook** (``BucketReducer``). Each parameter carries a
  ``register_post_accumulate_grad_hook``; when a bucket's last gradient
  lands, the bucket is packed (allreduce.pack_tensors) and all-reduced as
  ONE collective with ``async_op=True``, on the 16-bit wire of
  ``compact_wire_dtype`` where it is set. The step waits on every bucket
  before the finite check and the apply, divides by n and unpacks. At the
  f32 wire each element meets the same ops as the per-tensor all-reduce
  mean, so the result is bitwise the post-hoc reduction.
* **The FSDP gather** (``GatherParams``, --shard_params). Forward: the
  bucket's flat shards concatenated and all-gathered as ONE collective,
  the (n, K) rows split back into the full parameters. Backward: the full
  gradients packed into the (n, K) row matrix and reduce-scattered as ONE
  collective, then / n: per element ops/sharded.py ``fsdp_scatter_mean``.
  The gathered parameters are ordinary temporaries that the autograd
  graph owns. ``fsdp_block_gatherer`` gathers one transformer block at a
  time inside the block's checkpoint region, so the recompute of the
  backward gathers it again and the gathered block is never saved.

Composition (validation.py refuses the rest): under --num_grad_accum the
hooks stand down and the reduction is post hoc on the accumulated
gradients; under --steps_per_dispatch the hooks' collectives are part of
the captured step.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.ops import allreduce
from kf_benchmarks_tpu_torch.ops import sharded
from kf_benchmarks_tpu_torch.parallel import mesh

# Default bucket bound. The reference's --gradient_repacking=8 on a
# ~100 MB ResNet-50 gradient vector works out to ~12 MB chunks; 4 MB keeps
# several buckets in flight on the smaller zoo members too.
DEFAULT_BUCKET_MB = 4


class OverlapSpec(NamedTuple):
  """Resolved --overlap_gradient_reduction configuration."""
  bucket_bytes: int
  compact_dtype: Optional[torch.dtype]  # 16-bit wire format, or None


def bucket_bytes(params) -> int:
  """--reduce_bucket_mb in bytes (DEFAULT_BUCKET_MB when unset)."""
  return int(params.reduce_bucket_mb or DEFAULT_BUCKET_MB) * 1024 * 1024


def build(params) -> Optional[OverlapSpec]:
  """The overlap spec of the flags, or None when the mode is off (the
  train step disengages the hooks under --num_grad_accum)."""
  if not params.overlap_gradient_reduction:
    return None
  return OverlapSpec(bucket_bytes=bucket_bytes(params),
                     compact_dtype=allreduce.compact_wire_dtype(params))


# -- bucket planning -----------------------------------------------------------

def module_leaves(module: nn.Module
                  ) -> List[Tuple[sharded.Path, List[int], int]]:
  """The module's parameters as the JAX package's flax ``params`` leaves,
  in its tree-flatten order (sorted paths): (path, indices of the
  module's parameters that make the leaf -- every layer of a scanned one
  -- , bytes)."""
  from kf_benchmarks_tpu_torch import convert
  leaves = {}
  for i, (name, p) in enumerate(module.named_parameters()):
    path, _, _ = convert.flax_source(name, p, module)
    idx, nbytes = leaves.get(path[1:], ([], 0))
    leaves[path[1:]] = (idx + [i], nbytes + p.numel() * p.element_size())
  return [(path, idx, nbytes)
          for path, (idx, nbytes) in sorted(leaves.items())]


def plan_buckets(leaves: Sequence[Tuple[sharded.Path, int]],
                 bucket_bytes: int,
                 exclude_prefixes: Tuple[str, ...] = ()):
  """Group the (path, bytes) leaves, in flatten order, into size-bounded
  buckets: leaves of one top-level key stay together, adjacent keys merge
  while a bucket stays within ``bucket_bytes`` (plan_size_buckets), and
  leaves under ``exclude_prefixes`` (a stack the module gathers or
  reduces block by block) are left out. Returns (buckets, excluded): lists
  of leaf indices."""
  groups = []  # [key, [leaf indices], bytes] in flatten order
  excluded = []
  for idx, (path, nbytes) in enumerate(leaves):
    key = sharded.top_level_key(path)
    if key in exclude_prefixes:
      excluded.append(idx)
      continue
    if groups and groups[-1][0] == key:
      groups[-1][1].append(idx)
      groups[-1][2] += nbytes
    else:
      groups.append([key, [idx], nbytes])
  merged = allreduce.plan_size_buckets([g[2] for g in groups], bucket_bytes)
  buckets = [[i for g in span for i in groups[g][1]] for span in merged]
  return buckets, excluded


# The FSDP gather buckets: the same scheduler over the full-shape leaves
# (the JAX package reads their sizes from its template; the port's leaves
# carry them).
fsdp_plan_buckets = plan_buckets


def module_buckets(module: nn.Module, bucket_bytes: int,
                   exclude_prefixes: Tuple[str, ...] = ()):
  """``plan_buckets`` over ``module``'s parameters: (buckets, excluded) as
  lists of indices into ``module.parameters()``."""
  leaves = module_leaves(module)
  buckets, excluded = plan_buckets([(path, nbytes)
                                    for path, _, nbytes in leaves],
                                   bucket_bytes, exclude_prefixes)
  params = lambda idx: [i for j in idx for i in leaves[j][1]]
  return [params(b) for b in buckets], params(excluded)


def block_buckets(module: nn.Module) -> List[List[int]]:
  """One bucket per block of the transformer's block stack: the indices
  into ``module.parameters()`` of each ``blocks.<l>``'s parameters."""
  names = [name for name, _ in module.named_parameters()]
  return [[i for i, name in enumerate(names)
           if name.startswith(f"blocks.{layer}.")]
          for layer in range(len(module.blocks))]


# -- the in-backward reduction -------------------------------------------------

class BucketReducer:
  """The bucketed in-backward mean of ``params``' gradients (see the module
  notes). ``begin()`` arms the hooks for one backward; ``finish()`` waits
  on every bucket's collective and writes the means into the gradients.
  Unarmed, the hooks do nothing."""

  def __init__(self, params: Sequence[torch.Tensor],
               buckets: Sequence[Sequence[int]],
               compact_dtype: Optional[torch.dtype] = None):
    self.params = list(params)
    self.buckets = [list(b) for b in buckets]
    self.compact_dtype = compact_dtype
    self.active = False
    self._left: List[int] = []
    self._pending = []
    for b, idx in enumerate(self.buckets):
      for i in idx:
        self.params[i].register_post_accumulate_grad_hook(
            lambda _, b=b: self._landed(b))

  def begin(self) -> None:
    self.active = True
    self._left = [len(b) for b in self.buckets]
    self._pending = []

  def _landed(self, b: int) -> None:
    if not self.active:
      return
    self._left[b] -= 1
    if self._left[b] == 0:
      vec, meta = allreduce.pack_tensors(
          [self.params[i].grad for i in self.buckets[b]])
      wire = vec.to(self.compact_dtype or vec.dtype, copy=True)
      work = dist.all_reduce(wire, op=dist.ReduceOp.SUM, async_op=True)
      self._pending.append((b, work, wire, meta, vec.dtype))

  def finish(self) -> None:
    self.active = False
    missing = [b for b, left in enumerate(self._left) if left]
    if missing:
      raise RuntimeError(
          f"overlap_gradient_reduction: buckets {missing} did not receive "
          "every gradient in the backward (a parameter outside the loss)")
    n = mesh.world_size()
    for b, work, wire, meta, dtype in self._pending:
      work.wait()
      wire.div_(n)
      for i, g in zip(self.buckets[b],
                      allreduce.unpack_tensors(wire.to(dtype), meta)):
        self.params[i].grad.copy_(g)
    self._pending = []


def reducer_for(module: nn.Module, spec: OverlapSpec) -> BucketReducer:
  """The module's BucketReducer: builder-layer buckets, and one bucket
  per block of a scanned block stack."""
  prefixes = getattr(module, "stacked_prefixes", ())
  buckets, _ = module_buckets(module, spec.bucket_bytes, prefixes)
  if prefixes:
    buckets += block_buckets(module)
  return BucketReducer(list(module.parameters()), buckets,
                       spec.compact_dtype)


# -- the FSDP gather -----------------------------------------------------------

class GatherParams(torch.autograd.Function):
  """``apply(spec, *shards)``: a bucket's flat (k_i,) shards -> its full
  parameters (of the (shape, stride) pairs of ``spec``) by ONE all-gather;
  the backward reduce-scatters the bucket's full gradients as ONE
  collective, then / n, onto the shards."""

  @staticmethod
  def forward(ctx, spec, *shards):
    ctx.shapes = [shape for shape, _ in spec]
    n = mesh.world_size()
    vec = torch.cat([s.detach().reshape(-1) for s in shards])
    if mesh.is_distributed():
      full = vec.new_empty(n * vec.numel())
      dist.all_gather_into_tensor(full, vec)
    else:
      full = vec
    mat = full.view(n, -1)
    outs, off = [], 0
    for s, (shape, stride) in zip(shards, spec):
      k = s.numel()
      outs.append(sharded.restride(
          mat[:, off:off + k].reshape(-1)[:shape.numel()], shape, stride))
      off += k
    return tuple(outs)

  @staticmethod
  def backward(ctx, *cotangents):
    n = mesh.world_size()
    cols, ks = [], []
    for cot, shape in zip(cotangents, ctx.shapes):
      k = sharded.shard_len(shape.numel(), n)
      cols.append(F.pad(cot.reshape(-1), (0, n * k - shape.numel()))
                  .view(n, k))
      ks.append(k)
    mat = torch.cat(cols, dim=1)
    if mesh.is_distributed():
      row = mat.new_empty(mat.shape[1])
      dist.reduce_scatter_tensor(row, mat.reshape(-1),
                                 op=dist.ReduceOp.SUM)
      row.div_(n)
    else:
      row = mat.reshape(-1)
    return (None,) + tuple(row.split(ks))


def fsdp_block_gatherer(module: nn.Module, state, buckets):
  """The transformer's ``block_hook`` under FSDP: ``hook(l, x, seg)`` runs
  block l on the parameters of ONE packed gather of its shards
  (``state``: the ShardedState; ``buckets[l]``: its parameter indices).
  The module calls it inside the block's checkpoint region."""
  def hook(layer, x, seg):
    idx = buckets[layer]
    full = GatherParams.apply(state.gather_spec(idx),
                              *[state.shards[i] for i in idx])
    prefix = f"blocks.{layer}."
    named = {state.names[i][len(prefix):]: t for i, t in zip(idx, full)}
    block = module.blocks[layer]
    with sharded.swapped_params(block, named):
      return block(x, seg)
  return hook
