"""ZeRO sharded optimizer state and FSDP sharded parameters.

The port's counterpart of kf_benchmarks_tpu/ops/sharded.py, over
torch.distributed: each rank owns a flat 1/n shard of the optimizer state
(--shard_optimizer_state, Rajbhandari et al., ZeRO) and, with
--shard_params, of the parameters too (ZeRO-3 / FSDP). It is the port's
rendering of the reference's central variable placement (the parameter
server's copy of the variables and optimizer slots, variable_mgr.py:
201-243): the gradients meet in a reduce-scatter instead of the
all-reduce, the optimizer applies on the shard, and the parameters come
back by all-gather.

Layout contract (the JAX package's, unchanged; the checkpoints and the
parity tests key on it):

* A leaf of ``size`` elements pads with zeros to ``n * k`` where
  ``k = ceil(size / n)`` and ``n`` is the world size; flat block ``i``
  belongs to rank ``i``. The model axis of the JAX package's 2-D mesh is
  1 in the port (no --mesh_shape yet), so the shard index is the rank.
* The gradient mean is one reduce-scatter of the padded flat gradient,
  then ``/ n``: each element meets the same n contributions as the
  replicated all-reduce's SUM, so at two ranks (a two-term sum commutes)
  it is bitwise the replicated mean.
* Optimizer updates on the zero-padded tail are harmless: its gradients
  are exactly zero, every elementwise optimizer maps (g=0, state=0) to 0,
  and the tail is cut at gather time.

FSDP stacks a scanned leaf ``(L, *s)`` per layer, ``(n, L, k)`` with
``k = ceil(prod(s) / n)`` (``fsdp_stacked_shards``). The port keeps each
layer of the transformer's block stack as its own tensors
(``blocks.<l>.*``), so layer l's rows of that stack are the (n, k) shards
of blocks.<l>'s tensors, and at run time every tensor is one leaf.

``ShardedState`` holds one rank's shards of one module and runs the step's
side of the contract (train_step.TrainStep calls it): the scatter of the
gradients, the gather of the parameters after the apply (ZeRO) or inside
the forward and backward (FSDP, ops/overlap.py ``GatherParams``), and the
checkpoint rows.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.parallel import mesh

Path = Tuple[str, ...]


def shard_len(size: int, num_shards: int) -> int:
  """Per-rank flat shard length: ceil(size / num_shards)."""
  return -(-size // num_shards)


def _pad_flat(x: torch.Tensor, num_shards: int):
  k = shard_len(x.numel(), num_shards)
  return F.pad(x.reshape(-1), (0, num_shards * k - x.numel())), k


def stacked_shards(tree: Dict[Path, torch.Tensor],
                   num_shards: int) -> Dict[Path, torch.Tensor]:
  """Each leaf flattened, zero-padded and reshaped ``(n, k)``: row ``i``
  is rank ``i``'s shard (the layout of the sharded optimizer state)."""
  out = {}
  for path, x in tree.items():
    flat, k = _pad_flat(x, num_shards)
    out[path] = flat.reshape(num_shards, k)
  return out


def top_level_key(path: Path) -> str:
  """The top-level key of a flax path (builder-layer / scanned-stack
  granularity): the bucketing key of ops/overlap.py and the scanned-prefix
  test of the FSDP layout. The port's paths are the flax names of its
  parameters (convert.flax_source), so the same leaves share a key as in
  the JAX package's tree."""
  return path[0] if path else ""


def fsdp_stacked_shards(tree: Dict[Path, torch.Tensor], num_shards: int,
                        scanned_prefixes: Sequence[str] = ()
                        ) -> Dict[Path, torch.Tensor]:
  """Full parameter tree -> the FSDP shard stacks: ``(n, k)`` for a plain
  leaf, ``(n, L, k)`` for a leaf under ``scanned_prefixes`` (the (n, k)
  stacking of each of its L layers, shard row leading)."""
  out = {}
  for path, x in tree.items():
    if top_level_key(path) not in scanned_prefixes:
      flat, k = _pad_flat(x, num_shards)
      out[path] = flat.reshape(num_shards, k)
      continue
    if x.dim() < 1:
      raise ValueError(
          "scanned-prefix FSDP leaves need a leading layer axis; got a "
          f"scalar leaf of shape {tuple(x.shape)}")
    n_layers = x.shape[0]
    size = x.numel() // n_layers
    k = shard_len(size, num_shards)
    flat = F.pad(x.reshape(n_layers, size), (0, num_shards * k - size))
    out[path] = flat.reshape(n_layers, num_shards, k).transpose(0, 1)
  return out


def local_shards(tensors: Sequence[torch.Tensor], rank: int,
                 num_shards: int) -> List[torch.Tensor]:
  """Full (rank-identical) tensors -> this rank's flat shards, by slice:
  no collective, every rank holds the whole value."""
  out = []
  for x in tensors:
    flat, k = _pad_flat(x.detach(), num_shards)
    out.append(flat[rank * k:(rank + 1) * k].clone())
  return out


def scatter_mean(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """Full local gradients -> this rank's flat shards of their mean over
  the ranks: per gradient, one reduce-scatter (SUM) of the padded flat
  vector, then / n. Without a process group, the flat gradients."""
  n = mesh.world_size()
  out = []
  for g in grads:
    flat, k = _pad_flat(g, n)
    if mesh.is_distributed():
      shard = flat.new_empty(k)
      dist.reduce_scatter_tensor(shard, flat, op=dist.ReduceOp.SUM)
      shard.div_(n)
    else:
      shard = flat.clone()
    out.append(shard)
  return out


def restride(flat: torch.Tensor, shape: torch.Size,
             stride: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
  """A flat (logical row-major) vector as a tensor of ``shape``, laid out
  with ``stride`` when one is given (a convolution's channels_last
  weight), so what reads it reduces in the same order as over the
  parameter itself."""
  x = flat.view(shape)
  if stride is None or x.stride() == tuple(stride):
    return x
  return torch.empty_strided(shape, stride, dtype=x.dtype,
                             device=x.device).copy_(x)


def gather_tree(shards: Sequence[torch.Tensor], shapes: Sequence[torch.Size],
                strides: Optional[Sequence[Tuple[int, ...]]] = None
                ) -> List[torch.Tensor]:
  """Flat shards -> the full tensors: per shard one all-gather (rank
  order is the shard order), the pad cut, the shape (and ``strides``)
  restored."""
  n = mesh.world_size()
  out = []
  for i, (s, shape) in enumerate(zip(shards, shapes)):
    if mesh.is_distributed():
      full = s.new_empty(n * s.numel())
      dist.all_gather_into_tensor(full, s.detach().contiguous())
    else:
      full = s.detach()
    out.append(restride(full[:shape.numel()], shape,
                        strides[i] if strides else None))
  return out


# The FSDP forms of the gather and the scatter: the port stores every
# layer of a scanned stack as its own tensors, so the per-layer rows of
# the JAX package's (n, L, k) layout are per-tensor (n, k) rows here and
# the two families coincide.
fsdp_gather_full = gather_tree
fsdp_scatter_mean = scatter_mean


class AllReduceSum(torch.autograd.Function):
  """The sum over the ranks of a tensor each rank computed from its own
  shards; the backward passes the gradient through unchanged (every
  rank's loss holds the sum, so each shard's gradient is its own
  term's)."""

  @staticmethod
  def forward(ctx, x):
    out = x.clone()
    if mesh.is_distributed():
      dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out

  @staticmethod
  def backward(ctx, grad):
    return grad


@contextlib.contextmanager
def swapped_params(module: nn.Module, tensors: Dict[str, torch.Tensor]):
  """Inside the block, each named parameter of ``module`` reads as the
  given tensor (an ordinary temporary, which autograd may own); the
  module's own parameters are put back after. Nothing is resized, so this
  is safe inside a CUDA-graph capture."""
  saved = []
  try:
    for name, t in tensors.items():
      owner, _, attr = name.rpartition(".")
      sub = module.get_submodule(owner) if owner else module
      saved.append((sub, attr, sub._parameters[attr]))
      sub._parameters[attr] = t
    yield
  finally:
    for sub, attr, p in reversed(saved):
      sub._parameters[attr] = p


def build(params, module: nn.Module,
          num_grad_accum: int = 1) -> Optional["ShardedState"]:
  """This rank's ShardedState of ``module`` under --shard_optimizer_state
  (FSDP with --shard_params, gathering in the step at M = 1), else None.
  Make it before the optimizer, which steps on its shards."""
  if not params.shard_optimizer_state:
    return None
  from kf_benchmarks_tpu_torch.ops import overlap
  return ShardedState(module, shard_params=params.shard_params,
                      bucket_bytes=overlap.bucket_bytes(params),
                      in_step=num_grad_accum == 1)


class ShardedState:
  """One rank's ZeRO state over ``module``: ``shards[i]`` is this rank's
  flat (k_i,) row of the module's i-th parameter (module order), a leaf
  tensor the optimizer owns. With ``shard_params`` (FSDP) the shards are
  the parameters' only storage: the module's parameters become empty
  placeholders, and the step reads the full values through
  ``step_params`` / ``full_params``.

  ``in_step`` (FSDP at --num_grad_accum 1): the step gathers the
  parameters bucket by bucket inside its forward, and, for a module with
  a scanned block stack (the transformer's ``blocks``), block by block
  inside each block's checkpoint region, so its backward reduce-scatters
  the gradients onto the shards (ops/overlap.py). Otherwise (M > 1) the
  whole tree is gathered once before the microbatches and the accumulated
  gradient is scattered after them, as the JAX package does.
  """

  def __init__(self, module: nn.Module, shard_params: bool = False,
               bucket_bytes: int = 0, in_step: bool = True):
    from kf_benchmarks_tpu_torch.ops import overlap
    self.n = mesh.world_size()
    self.rank = mesh.rank()
    self.shard_params = shard_params
    self.in_step = shard_params and in_step
    named = list(module.named_parameters())
    self.names = [name for name, _ in named]
    self.shapes = [p.shape for _, p in named]
    self.strides = [p.stride() for _, p in named]
    self.params = [p for _, p in named]
    self.shards = [s.requires_grad_(True) for s in
                   local_shards(self.params, self.rank, self.n)]
    self._full: Optional[List[torch.Tensor]] = None
    self.buckets: List[List[int]] = []
    self.block_buckets: List[List[int]] = []
    if self.in_step:
      prefixes = getattr(module, "stacked_prefixes", ())
      self.buckets, _ = overlap.module_buckets(module, bucket_bytes,
                                               prefixes)
      if prefixes:
        self.block_buckets = overlap.block_buckets(module)
        module.block_hook = overlap.fsdp_block_gatherer(
            module, self, self.block_buckets)
    if shard_params:
      with torch.no_grad():
        for p in self.params:
          p.data = p.data.new_empty(0)

  def gather_spec(self, idx: Sequence[int]):
    """What ``overlap.GatherParams`` needs of the parameters ``idx``:
    their shapes and strides."""
    return tuple((self.shapes[i], self.strides[i]) for i in idx)

  @contextlib.contextmanager
  def step_params(self, module: nn.Module):
    """The parameters the step's forward and backward read (FSDP; a
    no-op under ZeRO alone, whose module holds them whole)."""
    if not self.shard_params:
      yield
      return
    from kf_benchmarks_tpu_torch.ops import overlap
    if self.in_step:
      full = {}
      for bucket in self.buckets:
        outs = overlap.GatherParams.apply(
            self.gather_spec(bucket), *[self.shards[i] for i in bucket])
        full.update((self.names[i], t) for i, t in zip(bucket, outs))
    else:
      self._full = [
          t.clone(memory_format=torch.preserve_format).requires_grad_(True)
          for t in fsdp_gather_full(self.shards, self.shapes, self.strides)]
      full = dict(zip(self.names, self._full))
    with swapped_params(module, full):
      yield

  @contextlib.contextmanager
  def full_params(self, module: nn.Module):
    """The whole parameter tree gathered, without autograd (evaluation);
    a no-op under ZeRO alone."""
    if not self.shard_params:
      yield
      return
    with torch.no_grad():
      full = dict(zip(self.names, gather_tree(self.shards, self.shapes,
                                              self.strides)))
    with swapped_params(module, full):
      yield

  def reduce_gradients(self, num_grad_accum: int,
                       loss_scale: Optional[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """This rank's shards of the step's mean gradient, divided by M and
    the loss scale, as ``shards[i].grad`` (returned too): under ZeRO and
    the accumulated FSDP step a scatter_mean of the full gradients; under
    FSDP in the step the gather's backward already scattered them."""
    if self.in_step:
      grads = [s.grad if s.grad is not None else torch.zeros_like(s)
               for s in self.shards]
    else:
      full = self._full if self.shard_params else self.params
      grads = [p.grad if p.grad is not None else torch.zeros_like(p)
               for p in full]
    if num_grad_accum > 1:
      torch._foreach_div_(grads, float(num_grad_accum))
    if loss_scale is not None:
      torch._foreach_div_(grads, loss_scale)
    if not self.in_step:
      grads = scatter_mean(grads)
      self._full = None
    for s, g in zip(self.shards, grads):
      s.grad = g
    return grads

  @torch.no_grad()
  def after_update(self) -> None:
    """ZeRO: the updated shards all-gathered into the module's
    parameters for the next forward. FSDP keeps only its shards."""
    if self.shard_params:
      return
    for p, full in zip(self.params, gather_tree(self.shards, self.shapes)):
      p.copy_(full)

  @torch.no_grad()
  def reslice(self) -> None:
    """The shards taken again from the module's (whole, restored)
    parameters (ZeRO alone)."""
    for s, x in zip(self.shards, local_shards(self.params, self.rank,
                                              self.n)):
      s.copy_(x)

  # -- checkpoint rows ----------------------------------------------------

  def stacks(self, rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's copy of each of this rank's ``rows`` (f32 tensors
    whose shape is the same on every rank), gathered by one all-gather:
    each (k,) row becomes the (n, k) stack, each 0-d value the (n,)
    stack, on the CPU."""
    if any(r.dtype != torch.float32 for r in rows):
      raise ValueError("sharded checkpoint rows must be float32, got "
                       f"{sorted({str(r.dtype) for r in rows})}")
    vec = torch.cat([r.detach().reshape(-1) for r in rows]) if rows \
        else torch.zeros(0)
    if mesh.is_distributed():
      full = vec.new_empty(self.n * vec.numel())
      dist.all_gather_into_tensor(full, vec.contiguous())
    else:
      full = vec
    mat = full.reshape(self.n, -1).cpu()
    out, off = [], 0
    for r in rows:
      out.append(mat[:, off:off + r.numel()].reshape(
          (self.n,) + tuple(r.shape)).clone())
      off += r.numel()
    return out
