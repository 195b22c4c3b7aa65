"""All-reduce spec parsing, gradient packing and the reduction planner.

The port's counterpart of kf_benchmarks_tpu/ops/allreduce.py, over
torch.distributed instead of the shard_mapped 'replica' axis. The spec
grammar is the JAX package's (and the reference's):

    spec        := alg_spec (":" limit ":" alg_spec)*
    alg_spec    := alg ("#" shards)?
    alg         := "psum" | "rsag" | "hier" | the reference's aliases
    limit       := <int>[kKmM]?   (tensors under the limit use the
                                   preceding alg)

The spec's ranges, the small-gradient packs and the repacked chunks decide
which tensors travel together; every pack is then reduced by one
all_reduce mean (kungfu.allreduce_mean). ``rsag#k`` and ``hier#g`` parse
as in the JAX package and run as that same all_reduce: NCCL chooses its
own ring or tree inside it, and all ranks of the port share one host, so
there is no host boundary for a two-level ring to exploit. A separate
algorithm comes back when a multi-card workload shows it faster.

A reducer takes the list of gradients of one rank (the same order on every
rank) and returns the list of reduced tensors; the packed paths concatenate
tensors into flat vectors and, under ``compact_wire_dtype``, send them as
bf16.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from kf_benchmarks_tpu_torch.parallel import kungfu
from kf_benchmarks_tpu_torch.utils import log as log_util

Reducer = Callable[[Sequence[torch.Tensor]], List[torch.Tensor]]


class AllReduceSpecTuple(NamedTuple):
  alg: str
  shards: int
  limit: Optional[int]  # exclusive upper byte bound; None = unbounded


ALGS = ("psum", "rsag", "hier")
_ALIASES = {
    "nccl": "psum",
    "collective": "psum",
    "pscpu": "psum",
    "psgpu": "psum",
    "xring": "rsag",
    "nccl/xring": "hier",
    "nccl/rechd": "hier",
    "nccl/pscpu": "hier",
    "pscpu/pscpu": "hier",
}


def _parse_limit(limit_str: str) -> int:
  m = re.fullmatch(r"(\d+)([kKmM]?)", limit_str)
  if not m:
    raise ValueError(f"Invalid all-reduce spec limit {limit_str!r}")
  val = int(m.group(1))
  suffix = m.group(2).lower()
  if suffix == "k":
    val *= 1024
  elif suffix == "m":
    val *= 1024 * 1024
  return val


def _parse_alg(alg_str: str) -> AllReduceSpecTuple:
  if "#" in alg_str:
    alg, _, shards_str = alg_str.partition("#")
    try:
      shards = int(shards_str)
    except ValueError:
      raise ValueError(f"Invalid all-reduce spec shards {alg_str!r}")
  else:
    alg, shards = alg_str, 1
  alg = _ALIASES.get(alg, alg)
  if alg not in ALGS:
    raise ValueError(
        f"Invalid all-reduce algorithm {alg_str!r}; the algorithms are "
        f"{ALGS} (reference aliases {sorted(_ALIASES)} accepted)")
  return AllReduceSpecTuple(alg=alg, shards=shards, limit=None)


def parse_all_reduce_spec(spec: str) -> List[AllReduceSpecTuple]:
  """The spec's range-limited tuples, small to large; each ``limit`` is
  the exclusive upper byte bound of its tuple (None for the last)."""
  parts = spec.split(":")
  if len(parts) % 2 == 0:
    raise ValueError(f"Spec must alternate alg:limit:alg...: {spec!r}")
  tuples = []
  for i, part in enumerate(parts):
    if i % 2 == 0:
      tuples.append(_parse_alg(part))
    else:
      limit = _parse_limit(part)
      prev = tuples[-1]
      if prev.limit is not None:
        raise ValueError(f"Duplicate limit in spec {spec!r}")
      tuples[-1] = prev._replace(limit=limit)
      if len(tuples) >= 2 and tuples[-2].limit is not None and \
          limit <= tuples[-2].limit:
        raise ValueError(f"Limits must be increasing in spec {spec!r}")
  if tuples[-1].limit is not None:
    raise ValueError(f"Last algorithm in spec must be unbounded: {spec!r}")
  return tuples


def plan_size_buckets(sizes: Sequence[int], bucket_bytes: int
                      ) -> List[List[int]]:
  """Greedy bucketing of an ordered size list: consecutive items share a
  bucket until the next would pass ``bucket_bytes``; an item larger than
  the bound alone keeps its own. Index lists covering range(len(sizes))."""
  buckets = []
  cur, cur_bytes = [], 0
  for i, size in enumerate(sizes):
    if cur and cur_bytes + size > bucket_bytes:
      buckets.append(cur)
      cur, cur_bytes = [], 0
    cur.append(i)
    cur_bytes += size
  if cur:
    buckets.append(cur)
  return buckets


_compact_f32_noted = False


def compact_wire_dtype(params) -> Optional[torch.dtype]:
  """bf16 when the packed paths compact their wire: under --use_fp16 with
  --compact_gradient_transfer (the default), or for f32 training under
  --compact_gradient_transfer_f32 (noted once a process); else None."""
  if not params.compact_gradient_transfer:
    return None
  if params.use_fp16:
    return torch.bfloat16
  if params.compact_gradient_transfer_f32:
    global _compact_f32_noted
    if not _compact_f32_noted:
      _compact_f32_noted = True
      log_util.log_fn(
          "compact_gradient_transfer_f32: f32 gradients ride the "
          "all-reduce wire at bfloat16 (8 mantissa bits) -- halves "
          "reduction bytes; NOT bit-identical to the f32 wire path")
    return torch.bfloat16
  return None


class PackMeta(NamedTuple):
  shapes: tuple
  dtypes: tuple
  sizes: tuple
  pad: int


def pack_tensors(tensors: Sequence[torch.Tensor], multiple_of: int = 1):
  """(flat vector, PackMeta): the tensors raveled and concatenated in their
  common dtype, zero-padded to a multiple of ``multiple_of``."""
  shapes = tuple(tuple(t.shape) for t in tensors)
  dtypes = tuple(t.dtype for t in tensors)
  sizes = tuple(t.numel() for t in tensors)
  if tensors:
    common = dtypes[0]
    for d in dtypes[1:]:
      common = torch.promote_types(common, d)
    vec = torch.cat([t.reshape(-1).to(common) for t in tensors])
  else:
    vec = torch.zeros(0)
  pad = (-vec.numel()) % multiple_of
  if pad:
    vec = torch.cat([vec, vec.new_zeros(pad)])
  return vec, PackMeta(shapes, dtypes, sizes, pad)


def unpack_tensors(vec: torch.Tensor, meta: PackMeta) -> List[torch.Tensor]:
  """The inverse of pack_tensors."""
  out = []
  offset = 0
  for shape, dtype, size in zip(meta.shapes, meta.dtypes, meta.sizes):
    out.append(vec[offset:offset + size].reshape(shape).to(dtype))
    offset += size
  return out


# -- the reduction -------------------------------------------------------------

def _reduce_packed(vec: torch.Tensor,
                   compact_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
  """The mean over the ranks of one packed vector, sent as
  ``compact_dtype`` when one is given. Every algorithm of the spec lands
  here: one all_reduce, in which NCCL chooses its own ring or tree."""
  wire = vec.to(compact_dtype or vec.dtype, copy=True,
                memory_format=torch.contiguous_format)
  kungfu.allreduce_mean([wire])
  return wire.to(vec.dtype)


def _nbytes(t: torch.Tensor) -> int:
  return t.numel() * t.element_size()


class CollectivePlanner:
  """Spec-driven reduction with small-tensor packing: the tensors are
  bucketed by byte size over the spec's ranges, and each bucket packed into
  one flat vector (its tensors under ``agg_max_bytes`` in packs of at most
  ``agg_max_group``, when set) and reduced."""

  def __init__(self, spec_tuples: Sequence[AllReduceSpecTuple],
               agg_max_bytes: int = 0,
               agg_max_group: Optional[int] = None,
               compact_dtype: Optional[torch.dtype] = None):
    self.spec_tuples = list(spec_tuples)
    self.agg_max_bytes = agg_max_bytes
    self.agg_max_group = agg_max_group
    self.compact_dtype = compact_dtype

  def _bucket_of(self, nbytes: int) -> int:
    for i, t in enumerate(self.spec_tuples):
      if t.limit is None or nbytes < t.limit:
        return i
    return len(self.spec_tuples) - 1

  def reduce(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    buckets: Dict[int, List[int]] = {}
    for idx, t in enumerate(tensors):
      buckets.setdefault(self._bucket_of(_nbytes(t)), []).append(idx)
    reduced: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for _, idxs in sorted(buckets.items()):
      if self.agg_max_bytes > 0:
        small = [i for i in idxs if _nbytes(tensors[i]) < self.agg_max_bytes]
        rest = [i for i in idxs if i not in small]
        group = max(1, self.agg_max_group or len(small) or 1)
        chunks = [small[s:s + group] for s in range(0, len(small), group)]
        if rest:
          chunks.append(rest)
      else:
        chunks = [idxs]
      for chunk in chunks:
        vec, meta = pack_tensors([tensors[i] for i in chunk])
        vec = _reduce_packed(vec, self.compact_dtype)
        for i, t in zip(chunk, unpack_tensors(vec, meta)):
          reduced[i] = t
    return reduced


def pack_small_reduce(tensors: Sequence[torch.Tensor], max_bytes: int,
                      max_group: int,
                      compact_dtype: Optional[torch.dtype] = None
                      ) -> List[torch.Tensor]:
  """Small-gradient aggregation without a spec: tensors under
  ``max_bytes`` all-reduce in packs of at most ``max_group``, the others
  one by one."""
  reduced: List[Optional[torch.Tensor]] = [None] * len(tensors)
  small = [i for i, t in enumerate(tensors) if _nbytes(t) < max_bytes]
  for i, t in enumerate(tensors):
    if i not in small:
      reduced[i] = _reduce_packed(t, compact_dtype)
  group = max(1, max_group)
  for start in range(0, len(small), group):
    chunk = small[start:start + group]
    vec, meta = pack_tensors([tensors[i] for i in chunk])
    vec = _reduce_packed(vec, compact_dtype)
    for i, t in zip(chunk, unpack_tensors(vec, meta)):
      reduced[i] = t
  return reduced


def repack_reduce(tensors: Sequence[torch.Tensor], num_chunks: int,
                  compact_dtype: Optional[torch.dtype] = None
                  ) -> List[torch.Tensor]:
  """--gradient_repacking: all tensors concatenated into one vector,
  re-split into ``num_chunks`` even chunks, each all-reduced."""
  vec, meta = pack_tensors(tensors)
  num_chunks = max(1, int(num_chunks))
  chunk = -(-vec.numel() // num_chunks)
  size = vec.numel()
  pad = chunk * num_chunks - size
  if pad:
    vec = torch.cat([vec, vec.new_zeros(pad)])
  parts = [_reduce_packed(part, compact_dtype)
           for part in vec.split(chunk)]
  return unpack_tensors(torch.cat(parts)[:size], meta)


def hier_reduce(tensors: Sequence[torch.Tensor],
                compact_dtype: Optional[torch.dtype] = None
                ) -> List[torch.Tensor]:
  """--hierarchical_copy: each tensor reduced on its own, on the
  ``compact_dtype`` wire."""
  return [_reduce_packed(t, compact_dtype) for t in tensors]


def _note_alg(source: str) -> None:
  log_util.log_fn(
      f"{source}: rsag and hier run as psum's one all_reduce in the port "
      "(every rank shares one host)")


def build_reducer(params) -> Optional[Reducer]:
  """The flag-selected reducer of the replicated-family strategies, or
  None for the per-tensor all-reduce mean. Precedence: spec, then
  repacking, then small-gradient aggregation, then hierarchical copy."""
  compact = compact_wire_dtype(params)
  if params.all_reduce_spec:
    return build_planner(params).reduce
  if params.gradient_repacking:
    return lambda g: repack_reduce(g, params.gradient_repacking, compact)
  if params.agg_small_grads_max_bytes > 0:
    return lambda g: pack_small_reduce(
        g, params.agg_small_grads_max_bytes,
        params.agg_small_grads_max_group, compact)
  if params.hierarchical_copy:
    _note_alg("--hierarchical_copy")
    return lambda g: hier_reduce(g, compact_dtype=compact)
  return None


def build_planner(params) -> Optional[CollectivePlanner]:
  """The planner of --all_reduce_spec, or None without one."""
  if not params.all_reduce_spec:
    return None
  tuples = parse_all_reduce_spec(params.all_reduce_spec)
  if any(t.alg != "psum" for t in tuples):
    _note_alg(f"--all_reduce_spec={params.all_reduce_spec}")
  return CollectivePlanner(tuples,
                           agg_max_bytes=params.agg_small_grads_max_bytes,
                           agg_max_group=params.agg_small_grads_max_group,
                           compact_dtype=compact_wire_dtype(params))
