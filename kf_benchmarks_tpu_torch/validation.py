"""Cross-flag validation: reject every configuration the port does not run.

The port's counterpart of kf_benchmarks_tpu/validation.py. The port runs
ResNet-50 (and the trivial model) and transformer_lm training on synthetic
data on one device, and the transformer_lm serving bench; anything else
fails here with the reason, before any work starts.
"""

from __future__ import annotations

import torch

from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import transformer_lm


class ParamError(ValueError):
  """A flag value or combination the port does not run."""


def parse_bucket_ladder(ladder: str):
  """'1,4,16,64' -> (1, 4, 16, 64): strictly ascending positive ints
  (ParamError otherwise)."""
  parts = [s.strip() for s in str(ladder).split(",") if s.strip()]
  try:
    buckets = tuple(int(v) for v in parts)
  except ValueError:
    buckets = ()
  if not buckets or any(b < 1 for b in buckets) or \
      list(buckets) != sorted(set(buckets)):
    raise ParamError(
        f"--serving_bucket_ladder={ladder!r}: expected strictly ascending "
        "positive integers (e.g. '1,4,16,64'); the ladder bounds the "
        "serving engine's program set")
  return buckets


def validate_cross_flags(params) -> None:
  if params.model not in model_config.list_models():
    raise ParamError(
        f"--model={params.model} is not ported yet; the port runs "
        f"{', '.join(model_config.list_models())}")
  if params.num_devices != 1:
    raise ParamError(
        f"--num_devices={params.num_devices}: the port runs one device; "
        "data-parallel training is not ported yet")
  if params.attn_block:
    if params.model != "transformer_lm":
      raise ParamError(
          "--attn_block sizes the transformer_lm attention tiling "
          f"(parallel/sequence.py); got --model={params.model}, which has "
          "no attention blocks to tile")
    if transformer_lm.SEQ_LEN % params.attn_block:
      raise ParamError(
          f"--attn_block={params.attn_block} must divide the transformer_lm "
          f"sequence length {transformer_lm.SEQ_LEN} (blockwise_attention "
          "tiles the K/V axis in whole blocks)")
  if params.serving_bucket_ladder is not None:
    parse_bucket_ladder(params.serving_bucket_ladder)
  if params.serving_batching not in (None, "continuous", "static"):
    raise ParamError(
        f"--serving_batching={params.serving_batching!r}: expected "
        "'continuous' or 'static'")
  if params.device == "gpu":
    if not torch.cuda.is_available():
      raise ParamError(
          "--device=gpu but no CUDA device is available "
          "(torch.cuda.is_available() is False); pass --device=cpu to run "
          "the plain PyTorch versions on the CPU")
    kernels = model_config.get_model_config(params.model,
                                            params).bf16_kernels()
    if kernels and not params.use_fp16:
      raise ParamError(
          f"--device=gpu needs --use_fp16 for --model={params.model}: "
          f"{kernels} have no f32 variant yet")
