"""The parameters the port reads so far, and the Params object.

A subset of kf_benchmarks_tpu/params.py (ref: benchmark_cnn.py:114-636):
the CNN zoo of models/model_config.py and transformer_lm training,
forward-only inference and evaluation on synthetic data or on TFRecord
ImageNet shards (--data_dir; data/), with the JAX
package's optimizers, learning-rate policy and loss scaling, on one card or
data-parallel over torch.distributed (spawned ranks, or kfrun workers
joined through --worker_hosts; optionally with sharded optimizer state,
sharded parameters or the overlapped reduction), in f32 or bf16
parameters (--fp16_vars), with checkpoints, elastic resize and the
adaptive batch size, training-health telemetry and fault injection, the
trace export, profiles, program dumps, the /metrics endpoint, the run store
and the benchmark logger, and the transformer_lm serving bench (serving/bench.py) with its INT8, paged-KV
and speculative variants, and the frozen forward export (aot.py). Names,
defaults and meanings follow the JAX package (the serving bench's
``--serving_requests``,
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
flags.DEFINE_string("autotuned_config", None,
                    "Path to a tuned-config table of the port "
                    "(analysis/autotune.py, written by `python -m "
                    "kf_benchmarks_tpu_torch.analysis autotune` on the "
                    "card). At startup the entry matching this run's base "
                    "fingerprint (analysis/baseline.base_fingerprint_key "
                    "-- the config sans the tuned knobs) is applied over "
                    "the flag values of --steps_per_dispatch, "
                    "--num_grad_accum, --reduce_bucket_mb, "
                    "--input_prefetch_depth and --attn_block, with a "
                    "logged provenance line; no matching entry logs a "
                    "note and runs with the flag values. A table of the "
                    "JAX package is refused. Training runs only "
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
flags.DEFINE_enum("variable_consistency", "strong", ("strong", "relaxed"),
                  "relaxed applies one-step-stale gradients (double-"
                  "buffered in the step carry; ref :242, "
                  "batch_allreduce.py:353-388 deferred StagingArea "
                  "gradients).")
flags.DEFINE_boolean("staged_vars", False,
                     "Forward/backward read one-step-stale weights while "
                     "updates land on the live ones (ref :406, "
                     "variable_mgr.py:246-274 StagedVariableGetter).")
flags.DEFINE_boolean("use_fp16", False,
                     "bf16 activations and gradients over f32 parameters.")
flags.DEFINE_boolean("fp16_vars", False,
                     "Keep variables in reduced precision too (ref "
                     ":481-485). The port computes in bfloat16 only, so its "
                     "16-bit variables are bfloat16 (the JAX package's TPU "
                     "choice): the parameters and the optimizer state "
                     "follow them; batch-norm scale and offset are used as "
                     "f32 and the running averages stay f32. Requires "
                     "--use_fp16.")
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
# Observability (tracing.py, observability.py, metrics.py; ref :270-296,
# :585-597, :1594-1608).
flags.DEFINE_string("trace_file", None,
                    "Profiler trace output path (ref :270-275): the "
                    "torch.profiler Chrome trace of one dispatch (the last "
                    "warmup dispatch, a CUDA-graph replay under "
                    "--steps_per_dispatch, else the first that is one), "
                    "written to this file; the JAX package's jax.profiler "
                    "writes a run directory beside it instead. On the CPU "
                    "the capture takes the CPU activity alone.")
flags.DEFINE_string("trace_events_file", None,
                    "Whole-run host-side span timeline (tracing.py; the "
                    "run-wide successor of the reference's one-step "
                    "timeline, ref :806-817): DeviceFeeder fetches/waits, "
                    "dispatch issue + per-chunk device completion, "
                    "first calls of a program, checkpoint save/restore, "
                    "eval, elastic seams and fault injections, exported as "
                    "Chrome trace-event JSON (loads in Perfetto / "
                    "chrome://tracing; pid=rank, tid=subsystem; "
                    "--use_chrome_trace_format=false writes the raw span "
                    "JSONL instead). Host-only: the step launches the same "
                    "kernels and its losses are bitwise those of a run "
                    "without it. Per-rank files under kfrun, rank 0 merges "
                    "at exit. Independent of the torch.profiler "
                    "--trace_file capture. Training runs only "
                    "(validation.py).")
flags.DEFINE_boolean("use_chrome_trace_format", True,
                     "Export --trace_events_file as Chrome trace-event "
                     "JSON (the reference's timeline.Timeline toggle, "
                     "ref :271-275, wired to the run-trace exporter in "
                     "tracing.py); false writes the raw span records as "
                     "JSONL instead. The torch.profiler --trace_file "
                     "capture is unaffected (it writes its own format).")
flags.DEFINE_string("tfprof_file", None,
                    "Per-op profile output (ref tfprof_file :276-289): one "
                    "step's FLOPs by op and by module (FlopCounterMode, the "
                    "kernels counted by their own formulas) and the card's "
                    "memory as JSON, the static per-op table at the H100's "
                    "peaks in <file>.ops.txt and, with --trace_file, the "
                    "measured per-op table of the traced dispatch in "
                    "<file>.measured_ops.txt.")
flags.DEFINE_string("graph_file", None,
                    "Dump the program text to this path (ref :2142-2148 "
                    "GraphDef dump): the torch.export program of the "
                    "step's training-mode forward and loss, the kernels as "
                    "torch.ops.kf_torch.* nodes.")
flags.DEFINE_string("partitioned_graph_file_prefix", None,
                    "Dump this rank's plan to <prefix>.txt (ref :293-296 "
                    "per-device GraphDef dumps): the strategy, each leaf's "
                    "gradient reduction a step and its shard under sharded "
                    "state (the JAX package writes the compiled "
                    "per-device program).")
flags.DEFINE_string("run_store_dir", None,
                    "Append one schema-versioned run record (config "
                    "fingerprint, git rev, torch version, the card's name, "
                    "platform, full metric snapshot) to the append-only "
                    "JSONL run store in this directory at run end "
                    "(metrics.py RunStore; rank 0 only) -- the cross-run "
                    "history the regression sentinel (bench_torch.py "
                    "--check-regression) compares against. Unset = no "
                    "record; nothing defaults to the repository root. "
                    "Training runs only (validation.py).")
flags.DEFINE_string("benchmark_log_dir", None,
                    "Structured JSON benchmark-log directory "
                    "(ref :1594-1608).")
flags.DEFINE_string("benchmark_test_id", None,
                    "Test id attached to the benchmark-log run info "
                    "(wired; ref :344-348).")
flags.DEFINE_string("eval_dir", None,
                    "Directory for eval summaries (ref :585-586): --eval "
                    "writes each pass's top-1, top-5 and images/sec as "
                    "scalars to events.jsonl there. The JAX package "
                    "defaults it to /tmp/tf_cnn_benchmarks/eval; the port "
                    "writes none unless it is given, so a run writes only "
                    "where it is told to.")
flags.DEFINE_integer("save_summaries_steps", 0,
                     "Summary cadence, 0 = off (ref :594-597).")
flags.DEFINE_integer("summary_verbosity", 0,
                     "0-3: none / scalars / grad histograms / everything "
                     "(ref :589-593).", lower_bound=0, upper_bound=3)
flags.DEFINE_string("compilation_cache_dir", None,
                    "Build directory of the hand-written kernels (ops/"
                    "_build.py; default build/kernels in the checkout): a "
                    "second run with the same directory builds nothing, "
                    "and the compile ledger's cache_hit column "
                    "(tracing.py) records the runs that loaded every "
                    "library from it. CUDA-graph captures and cuDNN's "
                    "plans are per process and are made anew each run. "
                    "The JAX package's XLA cache has no counterpart.")
flags.DEFINE_integer("metrics_port", None,
                     "Serve a live scrape endpoint from the metric "
                     "registry (metrics.py) on this port: /metrics in "
                     "Prometheus text format, /healthz from watchdog + "
                     "flight-recorder state. Under kfrun each rank "
                     "binds port + rank, so every worker of a "
                     "single-host job gets its own scrape target. "
                     "Host-side only: the step launches the same kernels "
                     "as without it. Unset = no socket is ever bound. "
                     "Training runs and the serving bench only "
                     "(validation.py). No reference analog -- its "
                     "results ship post-hoc (BenchmarkLogger / BigQuery "
                     "upload, ref: benchmark_cnn.py:1594-1608).",
                     lower_bound=1, upper_bound=65535)
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
flags.DEFINE_string("fault_schedule", None,
                    "Deterministic fault injection (faults.py): "
                    "comma-separated <kind>@<step>[:rank=R][:secs=S] "
                    "entries with kind in kill | sigterm | "
                    "heartbeat_delay | drop_msg | corrupt_ckpt; each "
                    "fires ONCE at the dispatch boundary after the "
                    "named step (one-shot across checkpoint-restart "
                    "generations via train_dir markers). The "
                    "reproducible-preemption harness behind the "
                    "kill/rejoin tests; no reference analog.")
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
# Training-health telemetry (telemetry.py).
flags.DEFINE_boolean("health_stats", None,
                     "In-step training-health stats (telemetry.py): the "
                     "train step additionally returns a compact f32 "
                     "vector (global grad norm, update/param norm ratio, "
                     "non-finite leaf count, loss scale + skip flag) "
                     "computed on the device inside the step (and inside "
                     "the captured K-step graph) and packed into the "
                     "step's existing metrics all-reduce, so it adds NO "
                     "collective; it reaches the host only through the "
                     "lag-N metrics pipeline, and feeds the flight "
                     "recorder and stall watchdog. Unset = auto: on for "
                     "training runs that reduce gradients "
                     "replica-synchronously (replicated family / kungfu "
                     "sync_sgd) AND have a telemetry sink (--train_dir); "
                     "off with a note for per-replica/gossip/async modes "
                     "and under --shard_optimizer_state, off quietly for "
                     "sink-less runs.")
flags.DEFINE_float("health_grad_norm_sigma", 6.0,
                   "Flight-recorder anomaly threshold: a step whose "
                   "global grad norm exceeds the trailing window's mean "
                   "by this many standard deviations dumps the window "
                   "(telemetry.py).", lower_bound=0.1)
flags.DEFINE_integer("flight_recorder_window", 64,
                     "Per-step records the flight recorder retains (and "
                     "continuously rewrites to train_dir/"
                     "flight_recorder.jsonl); the post-mortem window "
                     "dumped on anomaly/signal/exit (telemetry.py).",
                     lower_bound=4)
flags.DEFINE_float("stall_watchdog_factor", 10.0,
                   "Mid-run stall threshold: silence beyond this factor "
                   "times the trailing mean dispatch wall emits a "
                   "watchdog diagnostic (never a kill). 0 disables the "
                   "watchdog thread; the first dispatch is always exempt "
                   "(patient, log-only) (telemetry.py).", lower_bound=0)
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
flags.DEFINE_enum("serving_quantize", None, ("int8",),
                  "Weight-only quantization of the served model: 'int8' "
                  "stores per-output-channel {int8, f32 scale} weights "
                  "(quantization.py) dequantized inside every serving "
                  "program -- the counterpart of the reference's "
                  "--trt_mode=INT8 (ref :615-620). The serving bench "
                  "gates it on greedy agreement with the float weights "
                  "and serves the dense arm, saying so, when the gate "
                  "fails. None = float weights.")
flags.DEFINE_integer("serving_kv_page_size", None,
                     "Paged KV cache: replace the dense per-slot (T_max) "
                     "ring slab with a shared fixed-size page pool and "
                     "per-request page tables at this page size "
                     "(tokens/page; must divide the context length). "
                     "None = the dense ring slab.", lower_bound=1)
flags.DEFINE_integer("serving_speculative_k", None,
                     "Speculative decoding: a shallow draft proposes k "
                     "tokens per target dispatch; the target verifies all "
                     "k in ONE prefill-shaped call (greedy output stays "
                     "token-identical to plain greedy). Requires "
                     "--serving_draft_layers.", lower_bound=2)
flags.DEFINE_integer("serving_draft_layers", None,
                     "Depth of the speculative draft model (the served "
                     "transformer_lm truncated; must be < its layer "
                     "count). Only meaningful with "
                     "--serving_speculative_k.", lower_bound=1)

# The frozen forward export (aot.py; ref: _preprocess_graph :2405-2525,
# --trt_mode :615-620).
flags.DEFINE_string("aot_save_path", None,
                    "Forward-only mode: export the frozen forward program "
                    "(torch.export, weights folded in as constants) to "
                    "this path with a signature sidecar -- the "
                    "serving-graph/TensorRT analog (ref trt_mode :615-620, "
                    "_preprocess_graph :2405-2525).")
flags.DEFINE_string("aot_load_path", None,
                    "Forward-only mode: load a frozen forward program "
                    "exported via --aot_save_path and benchmark ITS "
                    "images/sec -- the serving benchmark on the frozen "
                    "artifact.")
flags.DEFINE_string("trt_mode", "",
                    "Precision of the frozen serving export (the TensorRT-"
                    "conversion analog, ref :615-620): FP32, FP16 (bf16 "
                    "compute on the card), or INT8 (weight-only "
                    "post-training quantization, quantization.py, bf16 "
                    "compute). Requires --forward_only with "
                    "--aot_save_path; empty keeps the run's compute dtype.")
flags.DEFINE_boolean("freeze_when_forward_only", False,
                     "Accepted for parity: freezing IS the export "
                     "(--aot_save_path folds the weights into constants; "
                     "ref :155-157).")
flags.DEFINE_integer("trt_max_workspace_size_bytes", 4 << 30,
                     "No-op in the port (TensorRT knob, ref :619-620).")

# The input path (data/; ref :186-272).
flags.DEFINE_string("data_dir", None,
                    "Path to dataset; synthetic data if empty (ref :186-190).")
flags.DEFINE_string("data_name", None,
                    "Dataset name, sniffed from data_dir if empty "
                    "(ref :191-194).")
flags.DEFINE_string("backbone_model_path", None,
                    "Warm-start checkpoint of the port (SSD300's backbone; "
                    "ref :613-614): the variables whose names and shapes "
                    "match are loaded before training; skipped on resume.")
flags.DEFINE_boolean("distortions", False,
                     "Enable full image distortions (ref :199-202; reference "
                     "default True, flipped off here: synthetic-first).")
flags.DEFINE_enum("resize_method", "bilinear",
                  ("round_robin", "nearest", "bilinear", "bicubic", "area"),
                  "Eval/train resize method (ref :195-198).")
flags.DEFINE_string("input_preprocessor", "default",
                    "Name of the input preprocessor to use "
                    "(ref: benchmark_cnn.py:179-182).")
flags.DEFINE_integer("input_prefetch_depth", None,
                     "Host->device prefetch depth of the DeviceFeeder in "
                     "batches (the StagingArea/MultiDeviceIterator buffer "
                     "depth analog, ref: benchmark_cnn.py:2572-2600, "
                     "preprocessing.py:368-399). None = derived: "
                     "max(--datasets_prefetch_buffer_size, "
                     "--batch_group_size). feed_stall_fraction in the "
                     "benchmark stats shows whether the depth hides host "
                     "preprocessing behind device compute.", lower_bound=1)
flags.DEFINE_integer("batch_group_size", 1,
                     "Number of batches the input feeder keeps in flight "
                     "ahead of the step loop (ref :134-136; wired to the "
                     "DeviceFeeder prefetch depth).", lower_bound=1)
flags.DEFINE_integer("datasets_prefetch_buffer_size", 2,
                     "Device prefetch depth (ref datasets_* :243-269).")
flags.DEFINE_integer("datasets_num_private_threads", None,
                     "Private threadpool for input pipeline (ref :248-253).")
flags.DEFINE_integer("num_intra_threads", None,
                     "Host compute threads (ref :203-208).")
flags.DEFINE_integer("input_preprocessing_parallelism", 16,
                     "Parallel parse/augment calls (ref map parallelism).")
flags.DEFINE_boolean("datasets_use_caching", False,
                     "Cache the input dataset in memory (ref :254-258).")
flags.DEFINE_boolean("datasets_repeat_cached_sample", False,
                     "Repeat the first input sample forever to emulate "
                     "memory-speed IO (wired into the record stream; "
                     "ref :259-263).")
flags.DEFINE_boolean("use_synthetic_gpu_images", False,
                     "Synthetic inputs even with a --data_dir (the "
                     "reference's switch; synthetic is data_dir=None).")
flags.DEFINE_boolean("use_datasets", True,
                     "Must stay true: the port has one host input pipeline; "
                     "the reference's legacy RecordInput path has no "
                     "counterpart and false is rejected (ref :215-217).")
flags.DEFINE_boolean("fuse_decode_and_crop", True,
                     "No-op: the host pipeline always crops before the "
                     "expensive resize (ref :227-230).")
flags.DEFINE_boolean("distort_color_in_yiq", True,
                     "No-op: color jitter runs as PIL's enhancers do, not "
                     "the YIQ rotation (ref :231-234).")
flags.DEFINE_boolean("datasets_use_prefetch", True,
                     "No-op: the DeviceFeeder always prefetches "
                     "(ref :243-247).")
flags.DEFINE_integer("datasets_parallel_interleave_cycle_length", None,
                     "No-op: shard reads interleave via the thread pool "
                     "(ref :264-266).")
flags.DEFINE_boolean("datasets_sloppy_parallel_interleave", False,
                     "No-op (tf.data interleave knob, ref :267-269).")
flags.DEFINE_integer("datasets_parallel_interleave_prefetch", None,
                     "No-op (tf.data interleave knob, ref :270-272).")
flags.DEFINE_boolean("use_multi_device_iterator", True,
                     "No-op: the DeviceFeeder is the MultiDeviceIterator "
                     "analog (ref :254-258).")
flags.DEFINE_integer("multi_device_iterator_max_buffer_size", 1,
                     "No-op (MultiDeviceIterator knob, ref :259-261).")


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
