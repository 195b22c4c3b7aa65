"""Checkpoint save/restore.

The port's counterpart of kf_benchmarks_tpu/checkpoint.py:1-250 (the
reference's Saver: benchmark_cnn.py:905-924 load, :2304-2309 periodic
save, :2374-2378 final save; variable_mgr.py:358-365 the v0-only rule).

Rank 0 writes its copy (the "v0" rule: every data-parallel strategy keeps
the ranks' weights equal, or, for the gossip and independent ones, rank 0's
are the run's). A snapshot holds the module's state_dict (parameters and
the batch-norm running averages), the optimizer's state_dict (its momentum
or moment buffers), the global step, the input incarnation and the train
step's counters (the updates applied, the loss scale and its count of
clean steps; JAX checkpoint.py:101-102), as CPU tensors and numbers.

Format: one ``model.ckpt-<step>.pt`` per step (``torch.save``), written to
a temporary name and moved into place with ``os.replace``, plus a
``checkpoint`` index JSON naming the newest by its relative name, so a
directory can be moved. Pruning keeps ``max_ckpts_to_keep`` files. A file
that does not load (a copy cut short, a truncated disk) is skipped with a
warning at restore; if no file loads, ``CheckpointNotFoundException``.

Sharded state (JAX checkpoint.py:71-115, :266-360, :418-526): under
--shard_optimizer_state the optimizer state's rows are per-rank 1/n
shards, not copies, so the snapshot holds the FULL ``(n, k)`` stacks (a
0-d state value, Adam's count, as ``(n,)``), gathered for rank 0 by one
all-gather of every rank's rows, and is marked ``opt_state_layout:
sharded``. Under --shard_params the parameters' entries are ``(n, k)``
stacks too (``params_layout: sharded``); the batch-norm averages stay
whole. A restore re-slices the stacks onto the live world size
(``_reshard``: both are the zero-padded row-major flatten of the same
tensor, so only zero pad is ever cut or added) and refuses a snapshot of
the other layout with the JAX package's messages; the weights-only
restore of evaluation deshards an FSDP snapshot (``_deshard_params``).
The port keeps each transformer block's tensors as their own entries, so
every stack is 2-D; the JAX package's ``_restack`` (the replica
broadcast) has no counterpart, the module holds one copy.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from kf_benchmarks_tpu_torch.parallel import mesh
from kf_benchmarks_tpu_torch.utils import log as log_util


class CheckpointNotFoundException(Exception):
  """(ref: benchmark_cnn.py:905-910)"""


_CKPT_RE = re.compile(r"model\.ckpt-(\d+)\.pt$")


def _index_path(train_dir: str) -> str:
  return os.path.join(train_dir, "checkpoint")


def is_chief() -> bool:
  """Checkpoint writes are rank 0's."""
  return mesh.rank() == 0


def _to_cpu(tree):
  if isinstance(tree, torch.Tensor):
    return tree.detach().to("cpu", copy=True)
  if isinstance(tree, dict):
    return {k: _to_cpu(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_to_cpu(v) for v in tree)
  return tree


def savable_state(module: nn.Module, optimizer: torch.optim.Optimizer,
                  global_step: int, input_incarnation: int = 0,
                  counters: Optional[Dict] = None, sharding=None) -> Dict:
  """A host-side snapshot of this rank's training state; ``counters``
  (the train step's ``counters()``: update count and loss-scale state)
  go in beside the step. With ``sharding`` (the train step's
  ops/sharded.ShardedState) the optimizer state, and under FSDP the
  parameters, are the stacks of every rank's rows: a collective, which
  every rank calls."""
  snap = {"step": int(global_step),
          "model": _to_cpu(module.state_dict()),
          "optimizer": _to_cpu(optimizer.state_dict()),
          "input_incarnation": int(input_incarnation),
          **(counters or {})}
  if sharding is None:
    return snap
  opt = optimizer.state_dict()
  keys = [(i, name) for i in sorted(opt["state"])
          for name, v in sorted(opt["state"][i].items())
          if isinstance(v, torch.Tensor)]
  rows = [opt["state"][i][name] for i, name in keys]
  if sharding.shard_params:
    rows = list(sharding.shards) + rows
  stacks = sharding.stacks(rows)
  if sharding.shard_params:
    snap["model"].update(zip(sharding.names, stacks[:len(sharding.names)]))
    stacks = stacks[len(sharding.names):]
    snap["params_layout"] = "sharded"
  for (i, name), stack in zip(keys, stacks):
    snap["optimizer"]["state"][i][name] = stack
  snap["opt_state_layout"] = "sharded"
  return snap


def save_checkpoint(train_dir: str, snapshot: Dict,
                    max_to_keep: int = 5) -> str:
  """Write ``snapshot`` (``savable_state``) as ``model.ckpt-<step>.pt``
  and point the index at it; prune beyond ``max_to_keep`` (ref:
  --max_ckpts_to_keep, benchmark_cnn.py:606-608). A no-op on ranks other
  than 0."""
  if not is_chief():
    return ""
  os.makedirs(train_dir, exist_ok=True)
  fname = f"model.ckpt-{snapshot['step']}.pt"
  path = os.path.join(train_dir, fname)
  torch.save(snapshot, path + ".tmp")
  os.replace(path + ".tmp", path)
  with open(_index_path(train_dir) + ".tmp", "w") as f:
    json.dump({"latest": fname}, f)
  os.replace(_index_path(train_dir) + ".tmp", _index_path(train_dir))
  _prune(train_dir, max_to_keep)
  return path


def _prune(train_dir: str, max_to_keep: int) -> None:
  if not max_to_keep:
    return
  for _, fname in all_checkpoints(train_dir)[:-max_to_keep]:
    try:
      os.remove(os.path.join(train_dir, fname))
    except OSError:
      pass


def all_checkpoints(train_dir: str):
  """Sorted (step, filename) list."""
  out = []
  try:
    for fname in os.listdir(train_dir):
      m = _CKPT_RE.match(fname)
      if m:
        out.append((int(m.group(1)), fname))
  except FileNotFoundError:
    pass
  return sorted(out)


def _candidates(train_dir: str):
  """(step, fname) newest first: the index's target and every file the
  directory holds (a missing or stale index orphans no checkpoint)."""
  candidates = set(all_checkpoints(train_dir))
  try:
    with open(_index_path(train_dir)) as f:
      fname = json.load(f)["latest"]
    m = _CKPT_RE.match(fname)
    if m and os.path.exists(os.path.join(train_dir, fname)):
      candidates.add((int(m.group(1)), fname))
  except (FileNotFoundError, json.JSONDecodeError, KeyError):
    pass
  return sorted(candidates, reverse=True)


def latest_checkpoint(train_dir: str) -> Tuple[str, int]:
  """(path, step) of the newest checkpoint, by name (no file is read;
  ref: benchmark_cnn.py:911-924)."""
  candidates = _candidates(train_dir)
  if not candidates:
    raise CheckpointNotFoundException(
        f"No checkpoint found in {train_dir}")
  step, fname = candidates[0]
  return os.path.join(train_dir, fname), step


def load_checkpoint(path: str) -> Dict:
  return torch.load(path, map_location="cpu", weights_only=True)


def load_latest_checkpoint(train_dir: str):
  """(snapshot, path, step) of the newest checkpoint that loads; a file
  that does not is skipped with a logged warning. Raises
  CheckpointNotFoundException."""
  candidates = _candidates(train_dir)
  skipped = 0
  for step, fname in candidates:
    path = os.path.join(train_dir, fname)
    try:
      return load_checkpoint(path), path, step
    except Exception:  # noqa: BLE001 -- any unreadable file is skipped
      skipped += 1
      log_util.log_fn(
          f"Warning: skipping torn/corrupt checkpoint {fname} "
          "(unreadable); resuming from the previous snapshot")
  if not candidates:
    raise CheckpointNotFoundException(
        f"No checkpoint found in {train_dir}")
  raise CheckpointNotFoundException(
      f"No readable checkpoint in {train_dir} "
      f"({skipped} corrupt file(s) skipped)")


def restore_backbone(module: nn.Module, path: str) -> int:
  """A warm start from a checkpoint of the port at ``path``: each of the
  module's variables (parameters and batch-norm averages) whose name and
  shape the checkpoint's model has is copied in (the JAX package's
  ``restore_backbone``, checkpoint.py:374-415 there: an SSD300
  checkpoint, or any whose layers share the backbone's names). Returns
  the count of variables loaded."""
  model = load_checkpoint(path).get("model", {})
  restored = 0
  with torch.no_grad():
    for name, t in module.state_dict().items():
      src = model.get(name)
      if src is not None and tuple(src.shape) == tuple(t.shape):
        t.copy_(src)
        restored += 1
  return restored


def restore_state(module: nn.Module, optimizer: torch.optim.Optimizer,
                  snapshot: Dict, sharding=None) -> int:
  """Loads a snapshot into the module (strictly: every key, every shape)
  and the optimizer; returns the snapshot's global step. The tensors land
  on the module's own device. With ``sharding`` the snapshot must be
  sharded too; its stacks are re-sliced onto the live world size and
  this rank's rows land in the shards and the optimizer state."""
  snap_sharded = snapshot.get("opt_state_layout") == "sharded"
  if snap_sharded != (sharding is not None):
    run = "sharded" if sharding is not None else "replicated"
    raise ValueError(
        f"checkpoint opt_state layout is "
        f"{'sharded' if snap_sharded else 'replicated'} but the run's "
        f"is {run}: --shard_optimizer_state checkpoints only resume "
        "sharded runs of the same topology (pass restore_opt_state=False "
        "to warm-start model variables only)")
  snap_fsdp = snapshot.get("params_layout") == "sharded"
  run_fsdp = sharding is not None and sharding.shard_params
  if snap_fsdp != run_fsdp:
    raise ValueError(
        f"checkpoint params layout is "
        f"{'sharded (FSDP)' if snap_fsdp else 'replicated'} but the "
        f"run's is {'sharded (FSDP)' if run_fsdp else 'replicated'}"
        ": --shard_params checkpoints only resume --shard_params runs "
        "(and vice versa) -- re-run with the matching flag (eval "
        "restores, restore_opt_state=False, de-shard automatically)")
  if sharding is None:
    module.load_state_dict(snapshot["model"])
    optimizer.load_state_dict(snapshot["optimizer"])
    return int(snapshot["step"])
  model = snapshot["model"]
  if run_fsdp:
    if set(model) != set(module.state_dict()):
      raise KeyError(f"checkpoint entries {sorted(set(model))} are not the "
                     f"module's {sorted(module.state_dict())}")
    with torch.no_grad():
      for name, s in zip(sharding.names, sharding.shards):
        s.copy_(_reshard(model[name], sharding.n, s.numel())[sharding.rank])
      for name, b in module.named_buffers():
        b.copy_(model[name])
  else:
    module.load_state_dict(model)
    sharding.reslice()
  opt = dict(snapshot["optimizer"])
  opt["state"] = {
      i: {name: (_reshard(v, sharding.n, sharding.shards[i].numel())
                 [sharding.rank] if isinstance(v, torch.Tensor) else v)
          for name, v in st.items()}
      for i, st in snapshot["optimizer"]["state"].items()}
  optimizer.load_state_dict(opt)
  return int(snapshot["step"])


def reseed_staged(staged: Optional[List[torch.Tensor]],
                  module: nn.Module) -> None:
  """The train step's --staged_vars copy (in module order; None without
  the flag) <- the module's weights, after a restore, so the first resumed
  forward does not read the fresh init (the JAX package's
  ``_reseed_staged``, checkpoint.py:255-263). The relaxed-consistency
  bank is not saved and restarts at zero, as there."""
  if staged is not None:
    with torch.no_grad():
      torch._foreach_copy_(staged, [p.detach() for p in module.parameters()])


def _reshard(stack: torch.Tensor, n: int, k: int) -> torch.Tensor:
  """A saved stack onto ``n`` ranks of ``k``-element shards: an ``(m, j)``
  row stack flattens back to its zero-padded vector, is cut (only pad is
  ever cut: ``n * ceil(size / n) >= size``) or zero-padded to ``n * k``
  and reshaped ``(n, k)``; an ``(m,)`` stack of a 0-d value (identical on
  every rank) becomes ``(n,)`` of its row 0. Exact: no value is
  recomputed, only re-addressed."""
  if stack.dim() == 1:
    return stack[:1].expand(n).clone()
  if stack.dim() != 2:
    raise ValueError(
        f"sharded state leaf shape {tuple(stack.shape)} cannot be "
        f"resliced onto live {(n, k)}: only stacked (n, k) shard rows and "
        "(n,) per-shard scalars have a defined cross-topology layout "
        "(ops/sharded.py)")
  flat = stack.reshape(-1)
  if n * k <= flat.numel():
    flat = flat[:n * k]
  else:
    flat = torch.cat([flat, flat.new_zeros(n * k - flat.numel())])
  return flat.reshape(n, k)


def _deshard_params(module: nn.Module, model: Dict) -> Dict:
  """An FSDP snapshot's entries with each parameter's ``(n, k)`` stack
  re-assembled to the module's full shape (concat the rows, cut the pad,
  restore the shape); the batch-norm averages as they are."""
  out = dict(model)
  for name, p in module.named_parameters():
    h = model[name]
    if h.dim() != 2:
      raise ValueError(
          f"FSDP param leaf shape {tuple(h.shape)} cannot de-shard onto "
          f"the full shape {tuple(p.shape)}: only (n, k) stacks have a "
          "defined layout (ops/sharded.py)")
    out[name] = h.reshape(-1)[:p.numel()].reshape(p.shape)
  return out


def restore_model(module: nn.Module, snapshot: Dict) -> int:
  """The model-only restore of evaluation (the JAX package's
  ``restore_opt_state=False``, benchmark.py:2200-2201): the weights and
  batch-norm averages alone, so the evaluating process's optimizer flags
  need not match the trainer's; an FSDP snapshot is desharded. Returns
  the snapshot's global step."""
  model = snapshot["model"]
  if snapshot.get("params_layout") == "sharded":
    model = _deshard_params(module, model)
  module.load_state_dict(model)
  return int(snapshot["step"])
