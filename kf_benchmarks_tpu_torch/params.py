"""The parameters the port reads so far, and the Params object.

A subset of kf_benchmarks_tpu/params.py (ref: benchmark_cnn.py:114-636):
ResNet-50 and transformer_lm training on synthetic data on one card. Names,
defaults and meanings follow the JAX package, except ``device``, which
defaults to the card. validation.py rejects every value outside the port.
"""

from __future__ import annotations

import collections

from kf_benchmarks_tpu_torch import flags

flags.DEFINE_string("model", "trivial", "Name of the model to run.")
flags.DEFINE_integer("batch_size", 0, "Per-device batch size (0 = model "
                     "default).", lower_bound=0)
flags.DEFINE_integer("num_batches", None,
                     "Number of timed batches to run (None = 100).",
                     lower_bound=1)
flags.DEFINE_integer("num_warmup_batches", None,
                     "Number of warmup batches before timing (None = 10).",
                     lower_bound=0)
flags.DEFINE_enum("device", "gpu", ("gpu", "cpu"),
                  "Device to run on: the CUDA card (default; fails without "
                  "one) or the CPU, where the kernels' plain versions run.")
flags.DEFINE_integer("num_devices", 1, "Number of devices (this slice: 1).",
                     lower_bound=1)
flags.DEFINE_enum("variable_update", "replicated",
                  ("replicated", "independent"),
                  "Parallelism strategy; on one device both are plain "
                  "single-replica training.")
flags.DEFINE_boolean("use_fp16", False,
                     "bf16 activations and gradients over f32 parameters.")
flags.DEFINE_enum("optimizer", "sgd", ("sgd", "momentum"),
                  "sgd, or momentum (Nesterov, as optax.sgd(nesterov=True)).")
flags.DEFINE_float("momentum", 0.9, "Momentum.")
flags.DEFINE_float("weight_decay", 4e-5, "L2 weight decay over the non-BN "
                   "parameters.")
flags.DEFINE_integer("display_every", 10, "Print step stats every N steps.",
                     lower_bound=1)
flags.DEFINE_enum("data_format", "NHWC", ("NHWC",),
                  "Tensor layout at the model's boundary (NHWC only; "
                  "convolutions run channels_last).")
flags.DEFINE_integer("attn_block", None,
                     "Attention K/V block size of the transformer_lm "
                     "family's tiled attention (parallel/sequence.py "
                     "blockwise_attention; the q-block is matched to it). "
                     "None = the model default (models/transformer_lm."
                     "ATTN_BLOCK). Must divide the model's sequence length "
                     "(validation.py). The flash kernels choose their own "
                     "tile.", lower_bound=8)
flags.DEFINE_integer("tf_random_seed", 1234, "Seed of the weights and of "
                     "the synthetic batch.")

Params = collections.namedtuple("Params", list(flags.param_specs.keys()))


def validate_params(params) -> None:
  """Per-field bounds and enum validation."""
  for name, spec in flags.param_specs.items():
    flags.check_value(spec, getattr(params, name))


def make_params(**kwargs) -> Params:
  """Params from the defaults and ``kwargs`` overrides."""
  values = {name: spec.default_value
            for name, spec in flags.param_specs.items()}
  for k, v in kwargs.items():
    if k not in flags.param_specs:
      raise ValueError(f"Unknown param: {k} (this port slice reads only "
                       f"{', '.join(flags.param_specs)})")
    values[k] = flags.canonicalize_value(flags.param_specs[k], v)
  params = Params(**values)
  validate_params(params)
  return params
