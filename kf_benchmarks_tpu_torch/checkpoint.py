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

The sharded layouts of the JAX package (``_reshard``, ``_deshard_params``,
``_restack``) wait for the sharded optimizer state (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

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
                  counters: Optional[Dict] = None) -> Dict:
  """A host-side snapshot of this rank's training state; ``counters``
  (the train step's ``counters()``: update count and loss-scale state)
  go in beside the step."""
  return {"step": int(global_step),
          "model": _to_cpu(module.state_dict()),
          "optimizer": _to_cpu(optimizer.state_dict()),
          "input_incarnation": int(input_incarnation),
          **(counters or {})}


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


def restore_state(module: nn.Module, optimizer: torch.optim.Optimizer,
                  snapshot: Dict) -> int:
  """Loads a snapshot into the module (strictly: every key, every shape)
  and the optimizer; returns the snapshot's global step. The tensors land
  on the module's own device."""
  module.load_state_dict(snapshot["model"])
  optimizer.load_state_dict(snapshot["optimizer"])
  return int(snapshot["step"])


def restore_model(module: nn.Module, snapshot: Dict) -> int:
  """The model-only restore of evaluation (the JAX package's
  ``restore_opt_state=False``, benchmark.py:2200-2201): the weights and
  batch-norm averages alone, so the evaluating process's optimizer flags
  need not match the trainer's. Returns the snapshot's global step."""
  module.load_state_dict(snapshot["model"])
  return int(snapshot["step"])
