"""Weight-only INT8 post-training quantization of the port's state dicts.

The port's counterpart of kf_benchmarks_tpu/quantization.py (:1-130), the
``--trt_mode=INT8`` export (aot.py) and ``--serving_quantize=int8``
(serving/decode.py) both read:

* each large float weight is stored as symmetric per-output-channel int8,
  ``q = clip(round(w / scale), -127, 127)`` with ``scale = max(absmax,
  1e-12) / 127`` in f32 over the output channel; ``torch.round`` rounds
  half to even, as ``jnp.round`` does, and the absmax of a bf16 weight
  (--fp16_vars) is taken in f32, as the JAX package upcasts;
* dequantization (``q * scale`` in f32, then the compute dtype) runs
  inside the exported forward or the serving step, so what is stored and
  read from device memory is 1 byte a weight;
* biases, norm parameters and every weight under ``MIN_QUANT_ELEMS``
  elements stay float.

The JAX package quantizes the leaves of its flax tree, and the port keeps
the same leaves in its own layout (convert.py), so the rule is applied to
the flax view of each weight: ``sources(key, tensor)`` (convert.py
``flax_source`` / ``lm_leaf_of``) names the flax leaf an entry comes from.
Entries that come from one stacked leaf are quantized together, as one
leaf: the JAX LM keeps its blocks as one scanned stack with leaves
``(L, in, out)``, and ``_scale_axes`` reduces over every axis but the last,
so each stacked weight gets one scale per output feature SHARED by all L
layers (inherited JAX behaviour: the port's per-layer ``blocks.<i>``
tensors are grouped back into that stack before the absmax). A stacked
bias such as ``blocks/mlp_up/bias`` (L, d_ff) is a 2-D leaf too and is
quantized once it reaches ``MIN_QUANT_ELEMS`` elements.

A quantized entry is a ``QTensor``: the int8 ``q`` in the port's layout and
the f32 ``scale`` with the reduced axes kept (size 1), so ``q * scale``
broadcasts in that layout. The depthwise rule of ``_scale_axes`` is kept
on the flax view: a TF-layout depthwise kernel (h, w, in, multiplier)
gets one scale per (in, multiplier) output channel, and the port's grouped
depthwise layout (in*mult, 1, h, w) (the flax depthwise layout (h, w, 1,
in*mult) under convert.py's conv transpose) one per output channel, which
are the same scales.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

# Entries smaller than this stay float: biases, norm scales and other
# vectors are bandwidth-irrelevant and precision-critical.
MIN_QUANT_ELEMS = 4096

# A 4-D kernel whose trailing axis is at most this wide (and narrower than
# its in-features axis) is treated as a TF-layout depthwise kernel
# (h, w, in, multiplier): real multipliers are 1-8, output-feature axes
# are channel-scale wide.
DEPTHWISE_MULTIPLIER_MAX = 8

# (flax path, layout kind, layer index into a stacked leaf or None), as
# convert.flax_source gives it.
Source = Tuple[Tuple[str, ...], str, Optional[int]]


class QTensor(NamedTuple):
  """One quantized entry: int8 ``q`` in the port's layout and f32
  ``scale``, broadcastable to ``q``."""
  q: torch.Tensor
  scale: torch.Tensor


def is_quantized(x) -> bool:
  return isinstance(x, QTensor)


def _scale_axes(shape) -> Tuple[int, ...]:
  """Axes of a flax-layout leaf that the per-channel absmax reduces over:
  every axis but the output channels (the JAX package's ``_scale_axes``).
  Output features are last in dense (in, out), conv (h, w, in, out) and
  the flax depthwise (h, w, 1, in*mult) layouts; a TF-layout depthwise
  kernel (h, w, in, multiplier) spreads them over the last two axes and
  reduces over the spatial ones only."""
  if (len(shape) == 4 and shape[3] <= DEPTHWISE_MULTIPLIER_MAX
      and shape[3] < shape[2]):
    return (0, 1)
  return tuple(range(len(shape) - 1))


def flax_view(t: torch.Tensor, kind: str) -> torch.Tensor:
  """A port-layout tensor in its flax layout (convert.to_flax_layout on a
  tensor, without a copy)."""
  if kind == "conv":
    return t.permute(2, 3, 1, 0)
  if kind == "dense":
    return t.t()
  return t


def port_view(t: torch.Tensor, kind: str) -> torch.Tensor:
  """A flax-layout tensor in the port's layout (convert.to_port_layout)."""
  if kind == "conv":
    return t.permute(3, 2, 0, 1)
  if kind == "dense":
    return t.t()
  return t


def _quantize_leaf(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """(q int8, scale f32 keepdim) of one flax-layout leaf, the JAX
  package's arithmetic."""
  wf = w.float()
  absmax = wf.abs().amax(dim=_scale_axes(w.shape), keepdim=True)
  scale = torch.clamp(absmax, min=1e-12) / 127.0
  q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
  return q, scale


def quantize_variables(variables: Dict[str, torch.Tensor],
                       sources: Optional[Callable[[str, torch.Tensor],
                                                  Source]] = None,
                       min_elems: int = MIN_QUANT_ELEMS
                       ) -> Dict[str, object]:
  """Float weights -> ``QTensor`` entries, the others unchanged.

  ``sources(key, tensor)`` gives the flax leaf of each entry (convert.py
  ``flax_source``); without it every entry is its own leaf in its own
  layout. Entries of one stacked leaf are quantized together (one scale
  per output channel over all their layers). A leaf that is not float,
  has fewer than 2 axes or fewer than ``min_elems`` elements passes
  through."""
  groups: Dict[Tuple[str, ...], list] = {}
  for key, t in variables.items():
    if not torch.is_tensor(t):
      continue
    path, kind, index = ((key,), "copy", None) if sources is None \
        else sources(key, t)
    groups.setdefault(path, []).append((index, key, kind))
  out = dict(variables)
  for members in groups.values():
    members.sort(key=lambda m: -1 if m[0] is None else m[0])
    stacked = members[0][0] is not None
    views = [flax_view(variables[key], kind) for _, key, kind in members]
    if not all(v.is_floating_point() for v in views):
      continue
    w = torch.stack(views) if stacked else views[0]
    if w.dim() < 2 or w.numel() < min_elems:
      continue
    q, scale = _quantize_leaf(w)
    for i, (_, key, kind) in enumerate(members):
      qi, si = (q[i], scale[0]) if stacked else (q, scale)
      out[key] = QTensor(port_view(qi, kind).contiguous(),
                         port_view(si, kind).contiguous())
  return out


def dequantize(x: QTensor, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
  """``q * scale`` computed in f32 and rounded once to ``dtype``: the JAX
  package's ``(q.astype(f32) * scale).astype(dtype)``, bitwise, as one
  pass that reads the int8 weights and writes ``dtype`` (int8 times the
  f32 scale promotes to f32, and the product is cast as it is stored)."""
  out = torch.empty(x.q.shape, dtype=dtype, device=x.q.device)
  return torch.mul(x.q, x.scale, out=out)


def dequantize_variables(qvars: Dict[str, object],
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
  """Inverse of ``quantize_variables``: ``QTensor`` entries rebuilt as
  ``q * scale`` in ``dtype``; float entries pass through. Usable inside a
  captured or exported program."""
  return {k: dequantize(v, dtype) if is_quantized(v) else v
          for k, v in qvars.items()}


def has_quantized_leaves(variables) -> bool:
  """True if any entry is a ``QTensor``: the idempotence check of
  serving's ``prepare_variables`` (int8 entries quantized again would be
  read as tiny float weights)."""
  return any(is_quantized(v) for v in variables.values())


def quantized_fraction(qvars) -> float:
  """Fraction of parameter elements stored as int8."""
  q_elems = total = 0
  for v in qvars.values():
    if is_quantized(v):
      q_elems += v.q.numel()
      total += v.q.numel()
    elif torch.is_tensor(v):
      total += v.numel()
  return q_elems / max(total, 1)


def to_device(qvars: Dict[str, object], device) -> Dict[str, object]:
  """Every entry (both halves of a ``QTensor``) on ``device``."""
  return {k: QTensor(v.q.to(device), v.scale.to(device))
          if is_quantized(v) else v.to(device) for k, v in qvars.items()}
