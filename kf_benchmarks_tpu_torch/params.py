"""The parameters the port reads so far, and the Params object.

A subset of kf_benchmarks_tpu/params.py (ref: benchmark_cnn.py:114-636):
ResNet-50 and transformer_lm training on synthetic data on one card, and
the transformer_lm serving bench (serving/bench.py). Names, defaults and
meanings follow the JAX package (the serving bench's ``--serving_requests``,
``--serving_rate`` and ``--serving_tenants`` are arguments of the JAX
package's bench.py), except ``device``, which defaults to the card.
validation.py rejects every value outside the port.
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
# Serving engine (serving/engine.py, serving/bench.py). None = the engine's
# or the bench's own default.
flags.DEFINE_integer("serving_requests", None,
                     "Requests in the serving bench's seeded workload "
                     "(None = 128).", lower_bound=1)
flags.DEFINE_float("serving_rate", None,
                   "Offered load of the serving bench in requests/s "
                   "(exponential inter-arrivals; None = 16).",
                   lower_bound=0.0)
flags.DEFINE_integer("serving_tenants", None,
                     "Tenants of the serving bench's workload, round-robin "
                     "(None = one, 'default').", lower_bound=1)
flags.DEFINE_string("serving_bucket_ladder", None,
                    "Comma-separated ascending batch buckets the serving "
                    "engine prepares its decode and prefill programs at "
                    "(e.g. '1,4,16,64'); the ladder bounds the program "
                    "set. None = the engine default (1,4,16,64,256).")
flags.DEFINE_string("serving_batching", None,
                    "Serving batch policy: 'continuous' (freed decode "
                    "slots refill from the queue every step) or 'static' "
                    "(admit a wave, decode it to completion, then admit "
                    "again). None = continuous.")
flags.DEFINE_integer("serving_max_new_tokens", None,
                     "Default per-request generation cap of the serving "
                     "engine. None = the bench default (32).",
                     lower_bound=1)
flags.DEFINE_integer("serving_queue_depth", None,
                     "Admission queue bound: a submit beyond it is rejected "
                     "(a shed result, never an exception). None = the "
                     "engine default (64).", lower_bound=1)
flags.DEFINE_float("serving_ttft_slo_ms", None,
                   "TTFT objective in ms: a queued request older than this "
                   "at coalesce time is expired instead of prefilled. None "
                   "= no deadline.", lower_bound=0.0)
flags.DEFINE_float("serving_tenant_tokens_per_s", None,
                   "Per-tenant token budget (prompt + generated tokens "
                   "charged at submit against a token bucket); an "
                   "over-budget request is rejected. None = unmetered.",
                   lower_bound=0.0)

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
