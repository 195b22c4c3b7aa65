"""Export of the frozen forward (serving) program: the TensorRT-path analog.

The port's counterpart of kf_benchmarks_tpu/aot.py (:1-216). The
reference's forward-only mode freezes the variables into constants and can
convert the graph with TensorRT (ref: scripts/tf_cnn_benchmarks/
benchmark_cnn.py:2405-2525 _preprocess_graph, --trt_mode :615-620). Here
``torch.export`` traces the eval-mode forward of the port's model over its
weights (``FrozenForward``: the weights are the exported program's
constants, the images its one input), and ``torch.export.save`` writes the
program; a later process loads it with ``load_forward`` and calls it
without the model's Python.

The kernels on the path stay kernels in the program: each kernel entry is
a ``torch.library.custom_op`` (ops/conv_bn.py, ops/flash_attention.py) with
a fake for its shapes, so the trace records the op (``kf_torch::...``)
instead of the plain decomposition, and the loaded program runs the
kernel on the card (its CUDA implementation, where the launch counts
tick) and the plain version on the CPU. ``load_forward`` imports those
modules before ``torch.export.load``, so the ops are registered.

Under ``quantize`` (--trt_mode=INT8) the program holds the int8 ``q`` and
f32 scale of each large weight (quantization.py) and dequantizes them to
f32 inside, as the JAX package's program does, so the artifact carries 1
byte a quantized weight.

Every export carries a JSON signature sidecar (``<path>.sig.json``) with
the JAX package's keys and meanings: input shape and dtype, batch size,
classes, compute dtype, the quantize mode and paged-KV geometry, and the
exporting run's fingerprint (serving/engine.py ``config_fingerprint_key``).
Dtypes carry torch's names (``float32``, ``bfloat16``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.export.passes
import torch.nn as nn

from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import quantization

SIGNATURE_SUFFIX = ".sig.json"
SIGNATURE_VERSION = 1


def _dtype_name(dtype: torch.dtype) -> str:
  return str(dtype).replace("torch.", "")


def signature_path(path: str) -> str:
  return path + SIGNATURE_SUFFIX


def _write_signature(path: str, image_shape, dtype, *, quantize: bool,
                     nclass: int, fingerprint: Optional[str],
                     kv_page_size: Optional[int] = None) -> None:
  sig = {
      "version": SIGNATURE_VERSION,
      "input_shape": [int(d) for d in image_shape],
      "input_dtype": _dtype_name(torch.float32),
      "batch_size": int(image_shape[0]),
      "nclass": int(nclass),
      "dtype": _dtype_name(dtype),
      "quantize": bool(quantize),
      # The serving-mode identity a loader diffs BEFORE deserialising.
      "quantize_mode": "int8" if quantize else None,
      "kv_page_size": int(kv_page_size) if kv_page_size else None,
      "fingerprint": fingerprint,
  }
  with open(signature_path(path), "w", encoding="utf-8") as f:
    json.dump(sig, f, indent=2, sort_keys=True)
    f.write("\n")


def read_signature(path: str) -> Optional[Dict[str, Any]]:
  """The export's signature sidecar, or None when absent or unreadable
  (an artifact without one stays loadable)."""
  try:
    with open(signature_path(path), encoding="utf-8") as f:
      sig = json.load(f)
  except (OSError, ValueError):
    return None
  return sig if isinstance(sig, dict) else None


def sibling_batch_sizes(path: str) -> List[int]:
  """Batch sizes of every export signature in ``path``'s directory: the
  available bucket list a mis-sized load reports."""
  out = []
  directory = os.path.dirname(path) or "."
  try:
    names = os.listdir(directory)
  except OSError:
    return out
  for name in sorted(names):
    if not name.endswith(SIGNATURE_SUFFIX):
      continue
    sig = read_signature(os.path.join(directory,
                                      name[:-len(SIGNATURE_SUFFIX)]))
    if sig and isinstance(sig.get("batch_size"), int):
      out.append(sig["batch_size"])
  return sorted(set(out))


class FrozenForward(nn.Module):
  """The eval-mode forward of ``module`` over ``state`` (a float state_dict
  or quantization.py's quantized one): the weights are this module's
  buffers, so ``torch.export`` folds them into the program as constants,
  and the images are the one input. ``module`` lends its structure only:
  it is kept on the meta device, outside the module tree, and every
  parameter and buffer it reads comes from ``state`` (QTensor entries
  dequantized to f32 inside the forward)."""

  def __init__(self, module: nn.Module, state: Dict[str, Any], device):
    super().__init__()
    object.__setattr__(self, "_module", module.to("meta").eval())
    # Each constant gets contiguous storage of its own, which the program's
    # serialisation keeps whole (a channels_last conv weight or a view of a
    # shared buffer it would rebuild from its storage).
    own = lambda t: t.detach().to(device).clone(
        memory_format=torch.contiguous_format)
    self._keys = []
    for i, (key, value) in enumerate(state.items()):
      if quantization.is_quantized(value):
        self.register_buffer(f"q{i}", own(value.q))
        self.register_buffer(f"s{i}", own(value.scale))
      else:
        self.register_buffer(f"w{i}", own(value))
      self._keys.append((key, i, quantization.is_quantized(value)))

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    weights = {}
    for key, i, quantized in self._keys:
      weights[key] = (quantization.dequantize(quantization.QTensor(
          getattr(self, f"q{i}"), getattr(self, f"s{i}")), torch.float32)
                      if quantized else getattr(self, f"w{i}"))
    return torch.func.functional_call(self._module, weights, (images,))


def export_forward(model, variables: Dict[str, torch.Tensor],
                   batch_size: int, path: str, nclass: int = 1001,
                   dtype: torch.dtype = torch.float32,
                   quantize: bool = False,
                   fingerprint: Optional[str] = None,
                   kv_page_size: Optional[int] = None,
                   device="cpu") -> int:
  """Export the frozen forward of ``model`` (a models/model.py Model) over
  ``variables`` (its module's f32 state_dict) at ``batch_size`` to
  ``path``; returns the artifact's byte size.

  The program computes in ``dtype`` on ``device`` (where it is traced and
  where it will run). ``quantize`` stores the large weights as int8 and
  per-channel scales and dequantizes inside (the TRT INT8 analog).
  ``fingerprint`` (the exporting run's config fingerprint) and
  ``kv_page_size`` go into the signature sidecar."""
  model.set_batch_size(batch_size)
  module = model.make_module(nclass, dtype)
  state = dict(variables)
  if quantize:
    state = quantization.quantize_variables(
        state, lambda key, t: convert.flax_source(key, t, module))
  frozen = FrozenForward(module, state, device)
  image_shape = tuple(model.get_input_shapes("eval")[0])
  example = torch.zeros(image_shape, dtype=torch.float32, device=device)
  with torch.no_grad():
    program = torch.export.export(frozen, (example,))
  # The program keeps its example input, which save would write beside the
  # weights (a batch of 256 images is 154 MB): the artifact is the weights
  # and the graph only.
  program.example_inputs = None
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  torch.export.save(program, path)
  _write_signature(path, image_shape, dtype, quantize=quantize,
                   nclass=nclass, fingerprint=fingerprint,
                   kv_page_size=kv_page_size)
  return os.path.getsize(path)


def program_input(program) -> torch.Tensor:
  """The (fake) tensor of an exported program's one user input."""
  names = set(program.graph_signature.user_inputs)
  node = next(n for n in program.graph.nodes
              if n.op == "placeholder" and n.name in names)
  return node.meta["val"]


_UNSET = object()


def load_forward(path: str, expect_batch: Optional[int] = None,
                 expect_shape: Optional[tuple] = None,
                 expect_quantize=_UNSET, expect_kv_page_size=_UNSET,
                 device=None) -> Callable:
  """Load an exported forward program as a callable images -> logits.

  ``expect_quantize`` (None or "int8") and ``expect_kv_page_size`` (None
  or int) state the caller's serving mode; when passed, they are diffed
  against the signature sidecar BEFORE the program is deserialised, and a
  mismatch raises with the sidecar diff and the exporting fingerprint.
  Artifacts without a sidecar skip the mode check. ``expect_batch`` /
  ``expect_shape`` are checked against the program's input spec, and a
  mismatch names the exported signature, the request and every sibling
  export's batch size. ``device`` (default: the device the program was
  exported on) moves the program's constants and device arguments."""
  sig = read_signature(path)
  mode_checks = []
  if expect_quantize is not _UNSET:
    mode_checks.append(("quantize_mode", expect_quantize))
  if expect_kv_page_size is not _UNSET:
    want_page = int(expect_kv_page_size) if expect_kv_page_size else None
    mode_checks.append(("kv_page_size", want_page))
  if mode_checks and sig is not None:
    def _got(key):
      if key == "quantize_mode" and key not in sig:
        # Sidecars that recorded only the quantize bool.
        return "int8" if sig.get("quantize") else None
      return sig.get(key)
    diffs = [f"{key}: sidecar={_got(key)!r}, requested={want!r}"
             for key, want in mode_checks if _got(key) != want]
    if diffs:
      raise ValueError(
          f"AOT export {path} was produced for a different serving "
          "mode -- " + "; ".join(diffs)
          + (f" (exporting fingerprint {sig.get('fingerprint')})" if
             sig.get("fingerprint") else "")
          + ". Re-export with the matching mode (e.g. --trt_mode=INT8 "
          "pairs with --serving_quantize=int8) or point the engine at "
          "the matching artifact.")
  # The kernels' custom ops must be registered before the program that
  # calls them is deserialised.
  from kf_benchmarks_tpu_torch.ops import conv_bn  # noqa: F401
  from kf_benchmarks_tpu_torch.ops import flash_attention  # noqa: F401
  program = torch.export.load(path)
  spec = program_input(program)
  if expect_batch is not None or expect_shape is not None:
    got = tuple(int(d) for d in spec.shape)
    want = tuple(int(d) for d in expect_shape) if expect_shape else None
    batch_ok = expect_batch is None or (got and got[0] == int(expect_batch))
    shape_ok = want is None or got == want
    if not (batch_ok and shape_ok):
      buckets = sibling_batch_sizes(path)
      sig = read_signature(path) or {}
      raise ValueError(
          f"AOT export {path} serves input {got} "
          f"(batch {got[0] if got else '?'}"
          + (f", fingerprint {sig.get('fingerprint')}" if
             sig.get("fingerprint") else "") + ")"
          + f"; requested batch {expect_batch}"
          + (f" shape {want}" if want else "")
          + (f". Available exported batch size(s) here: {buckets}"
             if buckets else "")
          + ". Re-export with --aot_save_path at the serving batch "
          "size (the bucket ladder bounds the executable set).")
  if device is not None and torch.device(device).type != spec.device.type:
    program = torch.export.passes.move_to_device_pass(program,
                                                      torch.device(device))
  return program.module()
