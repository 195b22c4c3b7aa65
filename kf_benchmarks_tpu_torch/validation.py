"""Cross-flag validation: reject every configuration the port does not run.

The port's counterpart of kf_benchmarks_tpu/validation.py. The port runs
ResNet-50 (and the trivial model) and transformer_lm training on synthetic
data, on one device or data-parallel over torch.distributed, and the
transformer_lm serving bench; anything else fails here with the reason,
before any work starts. The data-parallel rules are the JAX package's
(validation.py:620-700, :817-851), with its messages.
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
    "shard_optimizer_state": "ZeRO sharded optimizer state",
    "shard_params": "FSDP sharded parameters",
    "overlap_gradient_reduction": "bucketed in-backward reduction",
    "reduce_bucket_mb": "the in-backward reduction's buckets",
}


class ParamError(ValueError):
  """A flag value or combination the port does not run."""


def refuse_unported_flag(name: str) -> None:
  """ParamError for a flag of the JAX package the port has not ported."""
  if name in _UNPORTED_FLAGS:
    raise ParamError(
        f"--{name} ({_UNPORTED_FLAGS[name]}) is not ported yet (ROADMAP "
        "Queue 1 item 6)")


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
  validate_data_parallel_flags(params)
  validate_elastic_flags(params)
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
            or p.agg_small_grads_max_bytes > 0 or p.hierarchical_copy):
      raise ParamError(
          "--compact_gradient_transfer_f32 has no effect without a "
          "reduction path that repacks the wire: the default per-leaf "
          "pmean never re-encodes gradients (ops/allreduce.py "
          "build_reducer returns None). Select a packed path -- "
          "--all_reduce_spec, --gradient_repacking, "
          "--agg_small_grads_max_bytes or --hierarchical_copy -- or drop "
          "the flag")
