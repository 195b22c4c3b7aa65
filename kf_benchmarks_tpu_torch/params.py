"""The parameters the port reads so far, and the Params object.

A subset of kf_benchmarks_tpu/params.py (ref: benchmark_cnn.py:114-636):
the CNN zoo of models/model_config.py and transformer_lm training,
forward-only inference and evaluation on synthetic data, with the JAX
package's optimizers, learning-rate policy and loss scaling, on one card or
data-parallel over torch.distributed (spawned ranks, or kfrun workers
joined through --worker_hosts; optionally with sharded optimizer state,
sharded parameters or the overlapped reduction), with
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
flags.DEFINE_float("num_epochs", None,
                   "Number of epochs to run (mutually exclusive with "
                   "num_batches; ref :140-144).")
flags.DEFINE_integer("num_warmup_batches", None,
                     "Number of warmup batches before timing (None = 10).",
                     lower_bound=0)
flags.DEFINE_integer("steps_per_dispatch", 1,
                     "Multi-step training dispatch: K train steps a "
                     "dispatch, so the host's launch work and the metric "
                     "fetch are paid once per K steps. On a CUDA device "
                     "the step is captured as a CUDA graph and replayed "
                     "(train_step.TrainChunk); on the CPU the K steps run "
                     "one after another. Per-step losses are unchanged; "
                     "step times are honest at dispatch granularity "
                     "(utils/pipeline.py). 1 = one dispatch per step.",
                     lower_bound=1)
flags.DEFINE_integer("num_grad_accum", 1,
                     "Gradient accumulation: split each per-device batch "
                     "into M microbatches, run forward and backward on "
                     "each and accumulate the gradients in f32 before ONE "
                     "gradient reduction, ONE loss-scale decision and ONE "
                     "optimizer apply. Activation memory shrinks to "
                     "batch/M; the per-device batch must be divisible by "
                     "M. Batch-norm models: the statistics are per "
                     "microbatch and the running averages advance M times "
                     "a step, not numerically the M=1 step (a note is "
                     "logged). Composes with --steps_per_dispatch. 1 = the "
                     "monolithic step.", lower_bound=1)
# Step modes: evaluation, forward-only, mid-training eval (ref :119-175).
flags.DEFINE_boolean("eval", False, "Run evaluation instead of training "
                     "(ref :119).")
flags.DEFINE_integer("eval_interval_secs", 0,
                     "How often eval polls for new checkpoints (ref "
                     ":147-151).")
flags.DEFINE_integer("num_eval_batches", None,
                     "Number of eval batches (ref :152-155).")
flags.DEFINE_float("num_eval_epochs", None,
                   "Number of eval epochs (ref :156-160).")
flags.DEFINE_integer("eval_during_training_every_n_steps", None,
                     "Mid-training eval cadence in steps (ref :161-166).")
flags.DEFINE_float("eval_during_training_every_n_epochs", None,
                   "Mid-training eval cadence in epochs (ref :140-143).")
flags.DEFINE_list("eval_during_training_at_specified_steps", [],
                  "Explicit training steps after which to run eval "
                  "(ref :144-147).")
flags.DEFINE_list("eval_during_training_at_specified_epochs", [],
                  "Explicit training epochs after which to run eval "
                  "(ref :148-152).")
flags.DEFINE_float("stop_at_top_1_accuracy", None,
                   "Stop training early once this top-1 is reached "
                   "(ref :167-172).")
flags.DEFINE_boolean("forward_only", False,
                     "Only run forward pass (ref :124-126).")
flags.DEFINE_boolean("print_training_accuracy", False,
                     "Compute and print top-1/top-5 during training "
                     "(ref :127-129).")
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
flags.DEFINE_boolean("shard_optimizer_state", False,
                     "ZeRO-shard the optimizer state over the ranks "
                     "(Rajbhandari et al.): gradients meet in a "
                     "reduce-scatter of the mean (bitwise the replicated "
                     "all-reduce mean at two ranks), the optimizer applies "
                     "on each rank's 1/n flat state shard only, and the "
                     "updated params all-gather for the next forward -- "
                     "per-rank optimizer memory drops to ~|state|/n (the "
                     "port's rendering of the reference's central variable "
                     "placement, variable_mgr.py:201-243; ops/sharded.py). "
                     "Synchronous replicated/parameter_server family only; "
                     "composes with --steps_per_dispatch and "
                     "--num_grad_accum; exclusions in validation.py.")
flags.DEFINE_boolean("shard_params", False,
                     "Full FSDP (ZeRO-3, Rajbhandari et al.): params live "
                     "as 1/n flat shards between steps (the same (n, k) "
                     "layout as the sharded optimizer state) and the step "
                     "re-assembles them per builder-layer bucket / per "
                     "transformer block INSIDE the forward/backward with "
                     "one packed all-gather each (ops/overlap.py "
                     "GatherParams; the bucket bound is --reduce_bucket_mb, "
                     "default 4 MiB), so between steps per-rank param "
                     "memory is |params|/n and the sharded path's trailing "
                     "all-gather is gone. Gradients arrive reduce-scattered "
                     "by the gather's backward (per element the post-hoc "
                     "scatter). Requires --shard_optimizer_state "
                     "(elementwise-optimizer family, same exclusions; "
                     "validation.py); under --num_grad_accum the in-step "
                     "gathers disengage (one whole-tree gather per step, "
                     "like the overlap hooks' accumulation rule).")
flags.DEFINE_boolean("overlap_gradient_reduction", False,
                     "Overlap gradient communication with backward "
                     "compute: size-bounded gradient buckets "
                     "(--reduce_bucket_mb) each reduce as one collective "
                     "issued IN the backward pass (post-accumulate-grad "
                     "hooks at layer boundaries; per block for the "
                     "transformer's scanned block stack), so layer L's "
                     "all-reduce runs while layer L-1's backward is still "
                     "computing -- the pipelining the reference's chunked "
                     "batch_allreduce/--gradient_repacking existed for "
                     "(ref: batch_allreduce.py:391-481). f32 wire "
                     "gradients stay bit-identical to the post-hoc path "
                     "(ops/overlap.py). Replicated-family "
                     "--variable_update only; under --num_grad_accum the "
                     "reduction stays post-hoc on the accumulated "
                     "gradients; exclusive with the "
                     "spec/repacking/small-grad/hierarchical reducers "
                     "(validation.py).")
flags.DEFINE_integer("reduce_bucket_mb", None,
                     "Gradient-reduction bucket bound in MiB for "
                     "--overlap_gradient_reduction, and the gather bucket "
                     "bound of --shard_params (default 4): leaves group at "
                     "builder-layer granularity and merge into buckets of "
                     "at most this size, one collective per bucket "
                     "(ops/overlap.py; the granularity lever the "
                     "reference's --gradient_repacking chunk count turned, "
                     "ref :499-502).", lower_bound=1)
flags.DEFINE_boolean("hierarchical_copy", False,
                     "Hierarchical copy: each gradient reduced on its own "
                     "(on the bf16 wire under --use_fp16), by one "
                     "all_reduce in the port.")
flags.DEFINE_boolean("cross_replica_sync", True,
                     "Synchronous data-parallel updates; false with "
                     "parameter_server is the async parameter server.")
flags.DEFINE_boolean("use_fp16", False,
                     "bf16 activations and gradients over f32 parameters.")
flags.DEFINE_float("fp16_loss_scale", None,
                   "Loss scale; None = model default. bfloat16 does not "
                   "need loss scaling so the default is 1 (ref :471-480).")
flags.DEFINE_boolean("fp16_enable_auto_loss_scale", False,
                     "Auto loss-scaling state machine (ref :486-490).")
flags.DEFINE_integer("fp16_inc_loss_scale_every_n", 1000,
                     "Double loss scale after N clean steps (ref :491-495).")
flags.DEFINE_enum("optimizer", "sgd", ("sgd", "momentum", "rmsprop", "adam",
                                       "lars"),
                  "Optimizer (ref :414-417), each as the JAX package builds "
                  "it with optax: momentum is Nesterov, lars is "
                  "optax.lars (optimizers.py).")
flags.DEFINE_float("init_learning_rate", None,
                   "Initial LR; None = model default (ref :418-422).")
flags.DEFINE_string("piecewise_learning_rate_schedule", None,
                    "Schedule 'LR0;E1;LR1;...;En;LRn' (ref :423-429).")
flags.DEFINE_float("num_epochs_per_decay", 0,
                   "Epochs between LR decays (ref :430-434).")
flags.DEFINE_float("learning_rate_decay_factor", 0,
                   "Exponential decay factor (ref :435-440).")
flags.DEFINE_float("num_learning_rate_warmup_epochs", 0,
                   "Linear LR warmup epochs (ref :441-444).")
flags.DEFINE_float("minimum_learning_rate", 0,
                   "LR floor (requires decay flags; ref :445-449).")
flags.DEFINE_float("momentum", 0.9, "Momentum (ref :450).")
flags.DEFINE_float("rmsprop_decay", 0.9, "RMSProp decay (ref :451-452).")
flags.DEFINE_float("rmsprop_momentum", 0.9,
                   "RMSProp momentum (ref :453-454).")
flags.DEFINE_float("rmsprop_epsilon", 1.0, "RMSProp epsilon (ref :455-456).")
flags.DEFINE_float("adam_beta1", 0.9, "Adam beta1 (ref :457-458).")
flags.DEFINE_float("adam_beta2", 0.999, "Adam beta2 (ref :459-460).")
flags.DEFINE_float("adam_epsilon", 1e-8, "Adam epsilon (ref :461-462).")
flags.DEFINE_float("weight_decay", 4e-5, "L2 weight decay over the non-BN "
                   "parameters.")
flags.DEFINE_boolean("single_l2_loss_op", False,
                     "Compute L2 loss on concatenated weights instead of "
                     "per-tensor (ref :499-502 single_l2_loss_op).")
flags.DEFINE_float("gradient_clip", None, "Gradient clip magnitude "
                   "(ref :412-413): each gradient element clamped to "
                   "[-c, c] before the optimizer (optax.clip).")
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
