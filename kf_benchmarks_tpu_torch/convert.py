"""Weight bridge: flax ``{params, batch_stats}`` -> the port's state_dict.

The JAX package keeps every layer of a CNN at the top level of its flax
variable tree under the ConvNetBuilder's layer name (``conv_stem``, ``resnet_v10_a``,
``resnet_v10_a_bn``, ``affine0``, ...). The port nests the bottleneck
layers (``resnet_v1<k>_<part>``, or ``resnet_v2<k>_<part>`` in ResNet v2
with its ``_preact_bn``, -> ``blocks.<k>.<part>``; the module's
``block_prefix`` says which) and keeps the other names: ResNet v2's
``final_bn``, and Inception's ``conv<n>`` / ``conv<n>_bn`` in the JAX
builder's counter order (builder.GraphNet registers them under those
names). Leaves:

  conv   ``kernel`` HWIO       -> ``weight`` OIHW
  dense  ``kernel`` (in, out)  -> ``weight`` (out, in); ``bias`` as is
  BN     params ``scale`` (absent in a batch norm without scale, as
         Inception's) / ``bias``, batch_stats ``mean``/``var`` as is

The transformer LM's tree is nested (``lm_leaf_of``): ``embed/embedding``,
``pos_embedding``, ``ln_f``, ``lm_head`` (kept (d_model, vocab)) and the
blocks, either as the scanned ``blocks/<sub>/<leaf>`` stack with a leading
layer axis or as the loop layout's ``block_<i>/<sub>/<leaf>``, both onto the
port's ``blocks.<i>.<sub>``. LayerNorm ``scale``/``bias`` become
``weight``/``bias``; Dense kernels are transposed as above.

``replica_state_dict`` does the same for one replica of the JAX package's
data-parallel state, whose leaves carry a leading replica axis (every
replica's copy of the weights and batch statistics): replica r becomes rank
r's state_dict, so a rank can start from any replica of a run whose
replicas diverged (independent, kungfu async_sgd or sma).

``flax_to_state_dict`` maps every flax leaf (every layer of a stacked one)
exactly once onto every entry of the module's state_dict, and raises on any
leaf left over or missing. The inputs are numpy arrays (``jax.device_get``
of the flax tree), so this module needs no JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from kf_benchmarks_tpu_torch.models import transformer_lm

_PORT_BLOCK = re.compile(r"^blocks\.(\d+)\.(\w+)$")

# (collection, flax layer name, leaf name, layout kind)
FlaxLeaf = Tuple[str, str, str, str]
# (flax path, layout kind, layer index into a stacked leaf or None)
FlaxSource = Tuple[Tuple[str, ...], str, Optional[int]]


def flax_layer_name(port_name: str, block_prefix: str = "resnet_v1") -> str:
  m = _PORT_BLOCK.match(port_name)
  return f"{block_prefix}{m.group(1)}_{m.group(2)}" if m else port_name


def leaf_of(key: str, tensor: torch.Tensor,
            block_prefix: str = "resnet_v1") -> FlaxLeaf:
  """The flax leaf a state_dict entry comes from (``block_prefix``: the
  flax name of the module's bottlenecks, ``resnet_v1`` or ``resnet_v2``)."""
  layer, attr = key.rsplit(".", 1)
  flax_name = flax_layer_name(layer, block_prefix)
  if attr in ("mean", "var"):
    return "batch_stats", flax_name, attr, "copy"
  if attr == "weight":
    return "params", flax_name, "kernel", "conv" if tensor.dim() == 4 \
        else "dense"
  return "params", flax_name, attr, "copy"


def to_port_layout(value: np.ndarray, kind: str) -> np.ndarray:
  if kind == "conv":
    return np.transpose(value, (3, 2, 0, 1))
  if kind == "dense":
    return np.transpose(value, (1, 0))
  return value


def to_flax_layout(value: np.ndarray, kind: str) -> np.ndarray:
  if kind == "conv":
    return np.transpose(value, (2, 3, 1, 0))
  if kind == "dense":
    return np.transpose(value, (1, 0))
  return value


def lm_leaf_of(key: str, scanned: bool) -> FlaxSource:
  """The flax leaf a transformer LM state_dict entry comes from."""
  parts = key.split(".")
  if parts[0] == "embed":
    return ("params", "embed", "embedding"), "copy", None
  if parts[0] in ("pos_embedding", "lm_head"):
    return ("params", parts[0]), "copy", None
  index = None
  if parts[0] == "blocks":
    i = int(parts[1])
    prefix = ("params", "blocks") if scanned else ("params", f"block_{i}")
    index = i if scanned else None
    parts = parts[2:]
  else:
    prefix = ("params",)
  sub, attr = parts
  if sub.startswith("ln"):  # LayerNorm: scale / bias
    return prefix + (sub, "scale" if attr == "weight" else "bias"), "copy", \
        index
  if attr == "weight":  # Dense
    return prefix + (sub, "kernel"), "dense", index
  return prefix + (sub, attr), "copy", index


def flax_source(key: str, tensor: torch.Tensor,
                module: nn.Module) -> FlaxSource:
  """The flax leaf (and layer, for a stacked one) of a state_dict entry."""
  if isinstance(module, transformer_lm.TransformerLM):
    return lm_leaf_of(key, module.scan_layers)
  collection, layer, leaf, kind = leaf_of(
      key, tensor, getattr(module, "block_prefix", "resnet_v1"))
  return (collection, layer, leaf), kind, None


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
  flat = {}
  for name, value in tree.items():
    if isinstance(value, Mapping):
      flat.update(_flatten(value, prefix + (name,)))
    else:
      flat[prefix + (name,)] = np.asarray(value)
  return flat


def flax_to_state_dict(variables: Mapping, module: nn.Module
                       ) -> Dict[str, torch.Tensor]:
  """The module's state_dict filled from the flax variables."""
  flat = _flatten(variables)
  used = set()
  out = {}
  for key, ref in module.state_dict().items():
    path, kind, index = flax_source(key, ref, module)
    name = "/".join(path) + ("" if index is None else f"[{index}]")
    if path not in flat or (index is not None and
                            index >= flat[path].shape[0]):
      raise KeyError(f"{key}: no flax leaf {name}")
    if (path, index) in used:
      raise KeyError(f"{key}: flax leaf {name} mapped twice")
    used.add((path, index))
    value = flat[path] if index is None else flat[path][index]
    value = to_port_layout(value, kind)
    if tuple(value.shape) != tuple(ref.shape):
      raise ValueError(f"{key}: flax {name} has shape {value.shape} in the "
                       f"port's layout, want {tuple(ref.shape)}")
    out[key] = torch.from_numpy(np.array(value)).to(ref.dtype)
  left = []
  for path, value in flat.items():
    layers = {i for p, i in used if p == path}
    if not layers:
      left.append("/".join(path))
    elif layers != {None} and layers != set(range(value.shape[0])):
      left.append(f"{'/'.join(path)} layers "
                  f"{sorted(set(range(value.shape[0])) - layers)}")
  if left:
    raise KeyError(f"flax leaves with no place in the port: {sorted(left)}")
  return out


def replica_variables(stacked: Mapping, replica: int) -> Dict:
  """The variables of one replica: every leaf of a replica-stacked tree
  (leading axis = replica) taken at ``replica``."""
  out = {}
  for name, value in stacked.items():
    if isinstance(value, Mapping):
      out[name] = replica_variables(value, replica)
    else:
      out[name] = np.asarray(value)[replica]
  return out


def replica_state_dict(stacked: Mapping, replica: int, module: nn.Module
                       ) -> Dict[str, torch.Tensor]:
  """Rank ``replica``'s state_dict from the replica-stacked flax
  variables."""
  return flax_to_state_dict(replica_variables(stacked, replica), module)
