"""Cross-flag validation: reject every configuration the port does not run.

The port's counterpart of kf_benchmarks_tpu/validation.py. The port runs
the CNN zoo of models/model_config.py and transformer_lm -- training,
forward-only inference and evaluation -- on synthetic data, on one device
or data-parallel over torch.distributed, and the transformer_lm serving
bench; anything else fails here with the reason, before any work starts.
The rules of the flags the port shares with the JAX package are the JAX
package's (validation.py:209-217, :371-480, :606-741, :817-900), with its
messages.
"""

from __future__ import annotations

import torch

from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import transformer_lm
from kf_benchmarks_tpu_torch.ops import allreduce
from kf_benchmarks_tpu_torch.parallel import mesh

# Async parameter server with a stateful optimizer: n sequential optimizer
# applications a step (train_step.TrainStep._sequential_apply).
ASYNC_PS_SEQUENTIAL_MAX_DEVICES = 32

# Flags of the JAX package the port does not define yet: naming one is an
# error that names the ROADMAP item porting it (make_params and the CLI's
# parser ask here before they call the flag unknown).
_UNPORTED_FLAGS = {
    "fp16_vars": ("16-bit parameters", "6b"),
    "mesh_shape": ("the named 2-D device mesh", "8"),
}


class ParamError(ValueError):
  """A flag value or combination the port does not run."""


def refuse_unported_flag(name: str) -> None:
  """ParamError for a flag of the JAX package the port has not ported."""
  if name in _UNPORTED_FLAGS:
    what, item = _UNPORTED_FLAGS[name]
    raise ParamError(f"--{name} ({what}) is not ported yet (ROADMAP Queue "
                     f"1 item {item})")


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
  validate_mode_flags(params)
  validate_sharded_flags(params)
  validate_optimizer_flags(params)
  validate_data_parallel_flags(params)
  validate_elastic_flags(params)
  validate_dispatch_flags(params)
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
    count_error = mesh.device_count_error(params.device, params.num_devices)
    if count_error:
      raise ParamError(count_error)
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


def eval_during_training_enabled(params) -> bool:
  """Any of the four mid-training eval schedules set
  (ref: benchmark_cnn.py:1317-1327)."""
  return any(map(bool, [
      params.eval_during_training_every_n_steps,
      params.eval_during_training_every_n_epochs,
      params.eval_during_training_at_specified_steps,
      params.eval_during_training_at_specified_epochs,
  ]))


def validate_mode_flags(p) -> None:
  """--eval, --forward_only, the run length and mid-training eval (the
  JAX package's rules and messages, validation.py:209-217, :606-623,
  :718-741)."""
  if p.eval:
    if p.forward_only:
      raise ParamError("--eval is incompatible with --forward_only "
                       "(ref :1269-1270)")
    if p.job_name:
      raise ParamError("--job_name is unsupported with --eval (ref :1273)")
  if p.num_batches is not None and p.num_epochs is not None:
    raise ParamError("At most one of --num_batches and --num_epochs may be "
                     "set (ref :1300-1303)")
  if p.num_epochs is not None and p.num_epochs <= 0:
    raise ParamError("--num_epochs must be positive")
  if p.num_eval_batches is not None and p.num_eval_epochs is not None:
    raise ParamError("At most one of --num_eval_batches and "
                     "--num_eval_epochs may be set (ref "
                     "get_num_batches_and_epochs, :782-800)")
  if p.num_eval_batches is not None and p.num_eval_batches <= 0:
    raise ParamError("--num_eval_batches must be positive")
  if p.num_eval_epochs is not None and p.num_eval_epochs <= 0:
    raise ParamError("--num_eval_epochs must be positive")
  if p.forward_only and p.variable_update in ("distributed_replicated",
                                              "distributed_all_reduce",
                                              "collective_all_reduce"):
    raise ParamError(f"--forward_only cannot be used with "
                     f"--variable_update={p.variable_update} (ref :1306-1310)")
  edt_flags = [p.eval_during_training_every_n_steps,
               p.eval_during_training_every_n_epochs,
               p.eval_during_training_at_specified_steps,
               p.eval_during_training_at_specified_epochs]
  if sum(map(bool, edt_flags)) > 1:
    raise ParamError("At most one --eval_during_training_* flag may be "
                     "specified (ref :1316-1325)")
  if eval_during_training_enabled(p):
    if p.eval:
      raise ParamError("eval-during-training flags are incompatible with "
                       "--eval (ref :1329-1330)")
    if p.forward_only:
      raise ParamError("eval-during-training flags are incompatible with "
                       "--forward_only (ref :1331-1332)")
    if p.job_name:
      raise ParamError("--eval_during_training_* is not supported in "
                       "distributed ps/controller mode (ref :1333-1334)")
  if p.stop_at_top_1_accuracy and not eval_during_training_enabled(p):
    # The reference allows it only with eval-during-training (ref :1339-1340).
    raise ParamError("--stop_at_top_1_accuracy requires eval-during-training "
                     "(ref :1339-1340)")
  if p.forward_only and p.job_name == "controller":
    raise ParamError("--forward_only is incompatible with controller jobs")
  if (p.eval or p.forward_only) and (p.elastic or p.adaptive_batch_size or
                                     p.track_grad_noise_scale):
    # The port's narrowing: its eval and forward-only loops run no
    # gradient to measure and poll no coordinator.
    raise ParamError(
        "--elastic, --adaptive_batch_size and --track_grad_noise_scale "
        "apply to training only; they cannot be combined with --eval or "
        "--forward_only")


def validate_optimizer_flags(p) -> None:
  """Loss scaling and the learning-rate policy (the JAX package's rules
  and messages, validation.py:647-649, :685-717)."""
  if p.fp16_enable_auto_loss_scale and not p.use_fp16:
    raise ParamError("--fp16_enable_auto_loss_scale requires --use_fp16 "
                     "(ref :1334-1336)")
  if (p.use_fp16 and p.fp16_enable_auto_loss_scale and
      p.variable_update not in ("parameter_server", "replicated",
                                "independent", "kungfu")):
    raise ParamError("Automatic loss scaling is not supported with "
                     f"--variable_update={p.variable_update} (ref :1299-1303)")
  if bool(p.learning_rate_decay_factor) != bool(p.num_epochs_per_decay):
    raise ParamError("--learning_rate_decay_factor and "
                     "--num_epochs_per_decay must be set together "
                     "(ref :1271-1277)")
  if p.learning_rate_decay_factor and p.init_learning_rate is None:
    raise ParamError("LR decay flags require --init_learning_rate "
                     "(ref :1271-1277)")
  if p.minimum_learning_rate and not (p.learning_rate_decay_factor and
                                      p.num_epochs_per_decay and
                                      p.init_learning_rate is not None):
    raise ParamError("--minimum_learning_rate requires "
                     "--init_learning_rate, --learning_rate_decay_factor "
                     "and --num_epochs_per_decay (ref :445-449, :1143-1146)")
  if p.piecewise_learning_rate_schedule and p.init_learning_rate is not None:
    raise ParamError("--piecewise_learning_rate_schedule cannot be combined "
                     "with --init_learning_rate (ref :1104-1120)")
  if (p.piecewise_learning_rate_schedule and
      (p.learning_rate_decay_factor or p.num_learning_rate_warmup_epochs)):
    raise ParamError("--piecewise_learning_rate_schedule cannot be combined "
                     "with decay/warmup flags (ref :1116-1120)")


def validate_elastic_flags(p) -> None:
  """Checkpoints, the cluster flags, elastic resize and the adaptive batch
  size (the JAX package's rules and messages, validation.py:600-604,
  :725-741)."""
  if p.save_model_secs and p.save_model_steps:
    raise ParamError("At most one of --save_model_secs and "
                     "--save_model_steps may be set (ref :1341-1344)")
  if (p.adaptive_batch_size and
      p.adaptive_batch_min > p.adaptive_batch_max):
    raise ParamError(
        f"--adaptive_batch_min={p.adaptive_batch_min} exceeds "
        f"--adaptive_batch_max={p.adaptive_batch_max}: the adaptive "
        "policy's search interval is empty")
  if p.variable_update in ("horovod", "kungfu") and p.job_name:
    raise ParamError(f"--job_name is incompatible with "
                     f"--variable_update={p.variable_update} "
                     f"(ref :1293-1297)")
  if p.worker_hosts and p.num_devices > 1:
    raise ParamError(
        f"--worker_hosts with --num_devices={p.num_devices}: a worker is "
        "one rank driving one device (cluster.py); launch one process a "
        "device (kfrun -np N) with --num_devices=1")


def validate_dispatch_flags(p) -> None:
  """--steps_per_dispatch and --num_grad_accum (the JAX package's rules and
  messages, validation.py:259-311), and the combination a captured step
  cannot hold."""
  if (p.steps_per_dispatch or 1) > 1:
    if p.eval:
      raise ParamError("--steps_per_dispatch > 1 applies to training "
                       "only; it cannot be combined with --eval")
    if p.forward_only:
      raise ParamError("--steps_per_dispatch > 1 applies to training "
                       "only; it cannot be combined with --forward_only")
  m = p.num_grad_accum or 1
  if m > 1:
    if p.eval:
      raise ParamError("--num_grad_accum > 1 applies to training only; "
                       "it cannot be combined with --eval")
    if p.forward_only:
      raise ParamError("--num_grad_accum > 1 applies to training only; "
                       "it cannot be combined with --forward_only")
    if p.batch_size and p.batch_size % m:
      raise ParamError(
          f"--num_grad_accum={m} must divide --batch_size="
          f"{p.batch_size}: the step splits each per-device batch into "
          "M equal microbatches (a ragged tail microbatch would change "
          "the gradient weighting silently)")
    if p.variable_update == "parameter_server" and not p.cross_replica_sync:
      raise ParamError(
          "--num_grad_accum > 1 cannot be combined with async "
          "parameter_server (--cross_replica_sync=false): the "
          "sequential-apply path consumes each replica's UNAVERAGED "
          "per-batch gradient (train_step.py sequential_apply); an "
          "accumulated mean-of-microbatches gradient would silently "
          "change what each of its n optimizer applications sees. Use "
          "a synchronous --variable_update with accumulation")
    if p.adaptive_batch_size:
      raise ParamError(
          "--num_grad_accum > 1 cannot be combined with "
          "--adaptive_batch_size: the policy re-picks the per-device "
          "batch mid-run and cannot guarantee divisibility by M")


def check_grad_accum_divides(num_grad_accum: int, batch_size: int,
                             model_name: str) -> None:
  """The divisibility rule against the resolved per-device batch (a model
  default is known only once the model is built; JAX benchmark.py:
  384-391)."""
  if num_grad_accum > 1 and batch_size % num_grad_accum:
    raise ParamError(
        f"--num_grad_accum={num_grad_accum} must divide the per-device "
        f"batch size {batch_size} (model default for {model_name}); pass "
        "a divisible --batch_size")


def validate_data_parallel_flags(p) -> None:
  """The --variable_update family and its reduction flags."""
  if p.variable_update == "distributed_replicated":
    if not p.job_name:
      raise ParamError("distributed_replicated requires --job_name "
                       "(ref :1311-1314)")
    raise ParamError(
        "distributed_replicated (replicas over parameter-server hosts) is "
        "not ported; run the workers with --variable_update=replicated or "
        "kungfu under kfrun")
  if p.variable_update == "distributed_all_reduce" and not p.all_reduce_spec:
    raise ParamError("distributed_all_reduce requires --all_reduce_spec "
                     "(ref :1319-1321)")
  if p.all_reduce_spec:
    try:
      allreduce.parse_all_reduce_spec(p.all_reduce_spec)
    except ValueError as e:
      raise ParamError(f"--all_reduce_spec={p.all_reduce_spec}: {e}")
  if (p.variable_update == "parameter_server" and not p.cross_replica_sync
      and p.optimizer != "sgd"
      and p.num_devices > ASYNC_PS_SEQUENTIAL_MAX_DEVICES):
    raise ParamError(
        "async parameter_server (--cross_replica_sync=false) with a "
        f"stateful optimizer ({p.optimizer}) applies num_devices "
        "optimizer updates sequentially through shared state each step; "
        f"capped at {ASYNC_PS_SEQUENTIAL_MAX_DEVICES} devices. Use "
        "--optimizer=sgd (exact single-update collapse) or a "
        "synchronous --variable_update at this scale")
  if p.hierarchical_copy and p.num_devices <= 1:
    raise ParamError("--hierarchical_copy requires more than one device "
                     "(ref :1310-1311)")
  if p.gradient_repacking and p.all_reduce_spec:
    raise ParamError(
        "--gradient_repacking cannot be combined with --all_reduce_spec "
        "(repacking re-splits the full gradient vector; the spec planner "
        "owns packing on the spec path -- ref: batch_allreduce.py:300-317)")
  if p.gradient_repacking and p.agg_small_grads_max_bytes > 0:
    raise ParamError(
        "--gradient_repacking cannot be combined with "
        "--agg_small_grads_max_bytes (both re-shape reduction granularity)")
  if p.hierarchical_copy and p.all_reduce_spec:
    raise ParamError(
        "--hierarchical_copy cannot be combined with --all_reduce_spec "
        "(use the 'hier' algorithm inside the spec instead; "
        "ref :507-513 vs :532-553)")
  if p.compact_gradient_transfer_f32:
    if not p.compact_gradient_transfer:
      raise ParamError(
          "--compact_gradient_transfer_f32 requires "
          "--compact_gradient_transfer: it widens WHEN the 16-bit wire "
          "format engages (f32 training too), it cannot engage a "
          "compaction that is switched off")
    if not (p.use_fp16 or p.all_reduce_spec or p.gradient_repacking
            or p.agg_small_grads_max_bytes > 0 or p.hierarchical_copy
            or p.overlap_gradient_reduction):
      raise ParamError(
          "--compact_gradient_transfer_f32 has no effect without a "
          "reduction path that repacks the wire: the default per-leaf "
          "pmean never re-encodes gradients (ops/allreduce.py "
          "build_reducer returns None). Select a packed path -- "
          "--overlap_gradient_reduction, --all_reduce_spec, "
          "--gradient_repacking, --agg_small_grads_max_bytes or "
          "--hierarchical_copy -- or drop the flag (a silent no-op "
          "that logs a halved-bytes note would misrecord the run)")
  if p.reduce_bucket_mb and not (p.overlap_gradient_reduction
                                 or p.shard_params):
    raise ParamError(
        "--reduce_bucket_mb sizes the in-backward collective buckets "
        "and requires --overlap_gradient_reduction (reduction buckets) "
        "or --shard_params (FSDP gather buckets); the post-hoc paths' "
        "granularity levers are --gradient_repacking / "
        "--agg_small_grads_max_bytes / --all_reduce_spec")
  if p.overlap_gradient_reduction:
    # In-backward reduction replaces the strategy's post-hoc gradient pass
    # with per-bucket means issued inside the backward; it is defined only
    # for strategies whose aggregation IS the replica mean, and it cannot
    # coexist with reducers that own reduction granularity themselves
    # (ref: batch_allreduce.py:300-317 selects exactly one algorithm).
    if p.variable_update not in ("replicated", "distributed_replicated",
                                 "parameter_server",
                                 "collective_all_reduce",
                                 "distributed_all_reduce", "horovod"):
      raise ParamError(
          "--overlap_gradient_reduction requires a replicated-family "
          f"--variable_update (got {p.variable_update!r}): "
          "independent/gossip modes have no gradient reduction to "
          "overlap")
    if p.variable_update == "parameter_server" and not p.cross_replica_sync:
      raise ParamError(
          "--overlap_gradient_reduction cannot be combined with async "
          "parameter_server (--cross_replica_sync=false): the async path "
          "consumes each replica's UNAVERAGED gradient (train_step.py "
          "sequential_apply / psum-sum collapse); in-backward pmeans "
          "would silently average them. Use a synchronous "
          "--variable_update")
    for flag, name in ((p.all_reduce_spec, "--all_reduce_spec"),
                       (p.gradient_repacking, "--gradient_repacking"),
                       (p.agg_small_grads_max_bytes > 0,
                        "--agg_small_grads_max_bytes"),
                       (p.hierarchical_copy, "--hierarchical_copy")):
      if flag:
        raise ParamError(
            f"--overlap_gradient_reduction cannot be combined with "
            f"{name}: each reducer owns the reduction granularity "
            "(ref: batch_allreduce.py:300-317 selects one algorithm); "
            "the overlap path's granularity lever is --reduce_bucket_mb")
    if p.track_grad_noise_scale:
      raise ParamError(
          "--overlap_gradient_reduction cannot be combined with "
          "--track_grad_noise_scale: the noise-scale estimator contrasts "
          "PRE-reduction per-replica gradients with their replica mean "
          "(elastic.noise_scale_stats), and in-backward reduction never "
          "materializes the pre-reduction tree. Cost of the exclusion: "
          "use the post-hoc default when monitoring noise scale")


def validate_sharded_flags(p) -> None:
  """--shard_optimizer_state and --shard_params: the JAX package's
  exclusions and messages (validation.py:371-480) for the flags the port
  defines, and the port's own two."""
  if p.shard_optimizer_state:
    # The sharded step replaces the strategy's gradient pass with
    # reduce-scatter + all-gather and applies the optimizer on 1/n flat
    # state shards (ops/sharded.py); the modes below own gradient
    # aggregation themselves, need per-replica gradients the scatter
    # never materializes, or read full state the shards no longer hold.
    if p.eval or p.forward_only:
      raise ParamError(
          "--shard_optimizer_state applies to training only (there is "
          "no optimizer state to shard in --eval/--forward_only)")
    if p.variable_update not in ("replicated", "parameter_server"):
      raise ParamError(
          "--shard_optimizer_state requires --variable_update="
          f"replicated or parameter_server (got {p.variable_update!r}): "
          "independent/gossip modes keep per-replica diverged state "
          "with no global reduction to scatter, and the distributed_* "
          "modes' multi-process worlds are not wired to the sharded "
          "checkpoint layout yet")
    if not p.cross_replica_sync:
      raise ParamError(
          "--shard_optimizer_state cannot be combined with async "
          "parameter_server (--cross_replica_sync=false): the "
          "sequential-apply path serializes each replica's UNAVERAGED "
          "gradient through one shared full state copy "
          "(train_step.py); sharded state has no such copy")
    if p.job_name or p.worker_hosts:
      raise ParamError(
          "--shard_optimizer_state is single-process for now: the "
          "checkpoint path saves the sharded optimizer state from "
          "locally-addressable rows (checkpoint.py), which a "
          "multi-host mesh cannot do chief-only without a cross-host "
          "gather leg")
    if p.optimizer == "lars":
      raise ParamError(
          "--shard_optimizer_state cannot be combined with "
          "--optimizer=lars: the LARS trust ratio needs per-LAYER "
          "param/update norms, and the flat 1/n shard cuts across "
          "layer boundaries. Every other stock optimizer updates "
          "elementwise, so the shard apply stays exact")
    if p.adaptive_batch_size or p.track_grad_noise_scale:
      raise ParamError(
          "--shard_optimizer_state cannot be combined with "
          "--adaptive_batch_size/--track_grad_noise_scale: the "
          "noise-scale estimator contrasts PRE-reduction per-replica "
          "gradients with their replica mean (elastic.py), and the "
          "scattered reduction never materializes the replica mean")
    if p.overlap_gradient_reduction:
      raise ParamError(
          "--shard_optimizer_state cannot be combined with "
          "--overlap_gradient_reduction: the in-backward hooks issue "
          "bucket pmeans (all-reduce), which is exactly the collective "
          "the sharded path replaces with reduce-scatter")
    for flag, name in ((p.all_reduce_spec, "--all_reduce_spec"),
                       (p.gradient_repacking, "--gradient_repacking"),
                       (p.agg_small_grads_max_bytes > 0,
                        "--agg_small_grads_max_bytes"),
                       (p.hierarchical_copy, "--hierarchical_copy")):
      if flag:
        raise ParamError(
            f"--shard_optimizer_state cannot be combined with {name}: "
            "each reducer owns the reduction granularity (ref: "
            "batch_allreduce.py:300-317 selects one algorithm); the "
            "sharded path's reduction IS the per-leaf reduce-scatter")
    # The port's own two.
    if p.elastic:
      raise ParamError(
          "--elastic cannot be combined with --shard_optimizer_state yet: "
          "a resize would resume the (n, k) shard rows at another world "
          "size, the shard-rescale resume of ROADMAP Queue 1 item 6d")
    if p.save_model_secs:
      raise ParamError(
          "--save_model_secs cannot be combined with "
          "--shard_optimizer_state: every rank takes part in the "
          "collective that gathers the shard rows of a checkpoint, and "
          "each rank would decide a time-based save by its own clock; "
          "use --save_model_steps")
  if p.shard_params and not p.shard_optimizer_state:
    raise ParamError(
        "--shard_params requires --shard_optimizer_state: the FSDP "
        "forward rides the sharded family's scatter/apply machinery "
        "(reduce-scatter mean, 1/n shard apply, the (n, k) "
        "checkpoint layout), and params-sharded-but-state-replicated "
        "would re-create exactly the per-device footprint ZeRO "
        "removes. Add --shard_optimizer_state (which also brings its "
        "exclusion matrix: elementwise optimizers only, synchronous "
        "replicated/parameter_server only, no --staged_vars)")
