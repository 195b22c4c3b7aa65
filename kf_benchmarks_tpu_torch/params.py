"""The parameters the port reads so far, and the Params object.

A subset of kf_benchmarks_tpu/params.py (ref: benchmark_cnn.py:114-636):
the CNN zoo of models/model_config.py and transformer_lm training on
synthetic data, on one card or data-parallel over torch.distributed
(spawned ranks, or kfrun workers joined through --worker_hosts), with
checkpoints, elastic resize and the adaptive batch size, and the
transformer_lm serving bench (serving/bench.py). Names, defaults and
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
flags.DEFINE_integer("num_devices", 1,
                     "Number of devices: one rank process each "
                     "(torch.distributed; NCCL on the card, one rank per "
                     "card; gloo with --device=cpu).", lower_bound=1)
flags.DEFINE_enum("variable_update", "replicated",
                  ("independent", "parameter_server", "replicated",
                   "distributed_replicated", "distributed_all_reduce",
                   "collective_all_reduce", "horovod", "kungfu"),
                  "Parallelism strategy (parallel/strategies.py); "
                  "distributed_replicated (parameter-server hosts) is not "
                  "ported (validation.py).")
flags.DEFINE_enum("kungfu_option", "sync_sgd",
                  ("sync_sgd", "async_sgd", "sma"),
                  "KungFu optimizer wrapper: sync_sgd (all-reduce mean of "
                  "the gradients), async_sgd (pair averaging of the "
                  "weights after a local step), sma (all-reduce mean of "
                  "the weights before a local step).")
flags.DEFINE_string("all_reduce_spec", None,
                    "All-reduce algorithm spec, alg#shards:limit:alg...: "
                    "the size ranges pick which gradients are packed "
                    "together; psum, rsag and hier (and the reference's "
                    "aliases) parse as in the JAX package and each pack is "
                    "reduced by one all_reduce (ops/allreduce.py).")
flags.DEFINE_integer("agg_small_grads_max_bytes", 0,
                     "Pack gradients smaller than this into one tensor "
                     "before the all-reduce (0 = off).", lower_bound=0)
flags.DEFINE_integer("agg_small_grads_max_group", 10,
                     "Max number of small gradients per pack.",
                     lower_bound=1)
flags.DEFINE_integer("gradient_repacking", 0,
                     "Re-split the concatenated gradient vector into this "
                     "many evenly-sized chunks for reduction (0 = off; "
                     "exclusive with --all_reduce_spec).", lower_bound=0)
flags.DEFINE_boolean("compact_gradient_transfer", True,
                     "Compact gradients to a 16-bit wire format (bf16) for "
                     "the packed all-reduce paths when --use_fp16 is on; "
                     "the default per-leaf all-reduce has no wire format "
                     "to compact.")
flags.DEFINE_boolean("compact_gradient_transfer_f32", False,
                     "Engage the bf16 all-reduce wire format for f32 "
                     "training too (halves reduction bytes; not "
                     "bit-identical to the f32 wire). Requires "
                     "--compact_gradient_transfer and a packed reduction "
                     "path.")
flags.DEFINE_boolean("hierarchical_copy", False,
                     "Hierarchical copy: each gradient reduced on its own "
                     "(on the bf16 wire under --use_fp16), by one "
                     "all_reduce in the port.")
flags.DEFINE_boolean("cross_replica_sync", True,
                     "Synchronous data-parallel updates; false with "
                     "parameter_server is the async parameter server.")
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
# Checkpoints (checkpoint.py; ref :585-608).
flags.DEFINE_string("train_dir", None,
                    "Checkpoint directory (ref :585-588): the run resumes "
                    "from its newest readable checkpoint and saves there.")
flags.DEFINE_integer("save_model_secs", 0,
                     "Checkpoint cadence in seconds (ref :598-601).")
flags.DEFINE_integer("save_model_steps", 0,
                     "Checkpoint cadence in steps (ref :602-605).")
flags.DEFINE_integer("max_ckpts_to_keep", 5,
                     "Max checkpoints kept (ref :606-608).")
# Elastic resize and the adaptive batch size (elastic.py).
flags.DEFINE_boolean("track_grad_noise_scale", False,
                     "Measure the gradient noise scale in the train step "
                     "(each rank's gradients against their mean over the "
                     "ranks) and report the EMA-smoothed B_simple -- the "
                     "statistic KungFu's adaptation policies monitor. Needs "
                     "a world of at least 2.")
flags.DEFINE_boolean("elastic", False,
                     "Enable elastic resize: watch the coordination "
                     "service (KFCOORD_* env, set by kfrun) for target-size "
                     "changes; a new world size is a checkpoint-restart "
                     "through kfrun (one card a process).")
flags.DEFINE_integer("elastic_check_every_n_steps", 10,
                     "How often the train loop polls for elastic resize / "
                     "adaptive-batch decisions.", lower_bound=1)
flags.DEFINE_boolean("adaptive_batch_size", False,
                     "Adapt the per-device batch size to the measured "
                     "gradient noise scale (implies "
                     "track_grad_noise_scale; KungFu adaptive batch "
                     "policy analog).")
flags.DEFINE_integer("adaptive_batch_min", 1,
                     "Lower bound for the adaptive per-device batch size.",
                     lower_bound=1)
flags.DEFINE_integer("adaptive_batch_max", 1024,
                     "Upper bound for the adaptive per-device batch size.",
                     lower_bound=1)
# Cluster wiring (cluster.py; ref :567-583).
flags.DEFINE_enum("job_name", "", ("ps", "worker", "controller", ""),
                  "Job role for multi-process runs (ref :571-573); every "
                  "process of the port is a worker.")
flags.DEFINE_list("ps_hosts", [], "Parameter-server hosts (ref :574); "
                  "refused (cluster.py).")
flags.DEFINE_list("worker_hosts", [],
                  "Worker hosts (ref :575), host:port each: one rank a "
                  "process, joined at tcp://<worker_hosts[0]>; under kfrun "
                  "truncated to KFCOORD_WORLD.")
flags.DEFINE_integer("task_index", 0, "Task index (ref :577): this "
                     "process's rank unless kfrun's KFCOORD_RANK_HINT "
                     "gives it.")
flags.DEFINE_boolean("sync_on_finish", False,
                     "Barrier across workers at exit (ref :567-569): "
                     "parallel/kungfu.py run_barrier, the coordinator's "
                     "kf_exit barrier under kfrun.")
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
      from kf_benchmarks_tpu_torch import validation
      validation.refuse_unported_flag(k)
      raise ValueError(f"Unknown param: {k} (this port slice reads only "
                       f"{', '.join(flags.param_specs)})")
    values[k] = flags.canonicalize_value(flags.param_specs[k], v)
  params = Params(**values)
  validate_params(params)
  return params
