"""Cross-flag validation: reject every configuration the port does not run.

The port's counterpart of kf_benchmarks_tpu/validation.py. The port runs
the CNN zoo of models/model_config.py and transformer_lm -- training,
forward-only inference (and its frozen export) and evaluation -- on
synthetic data, on one device or data-parallel over torch.distributed, and
the transformer_lm serving bench with its decode-cost variants; anything
else fails here with the reason, before any work starts. The rules of the
flags the port shares with the JAX package are the JAX package's
(validation.py:209-217, :230-256, :371-480, :561-600, :606-741, :755-805,
:817-935), with its messages.
"""

from __future__ import annotations

from typing import Optional

import torch

from kf_benchmarks_tpu_torch import faults
from kf_benchmarks_tpu_torch import flags
from kf_benchmarks_tpu_torch.data import datasets
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
    "mesh_shape": ("the named 2-D device mesh", "8"),
    "serving_model_shards": ("tensor-parallel serving across cards, on "
                             "parallel/tensor.py of item 8", "11"),
}


# The JAX package's refusal of a tuned table outside training
# (validation.py:334-345 there); autotune.apply_tuned_config re-checks.
AUTOTUNED_EVAL_MESSAGE = (
    "--autotuned_config tunes the training step's program-shaping knobs "
    "(analysis/autotune.py); it cannot be combined with --eval or "
    "--forward_only")


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


def run_dataset_name(params) -> Optional[str]:
  """The name of the run's dataset (benchmark.py's create_dataset call),
  or None where its flags do not name one (validate_input_flags says
  why)."""
  try:
    return datasets.create_dataset(
        None if params.use_synthetic_gpu_images else params.data_dir,
        params.data_name).name
  except ValueError:
    return None


def validate_cross_flags(params) -> None:
  data_name = run_dataset_name(params)
  if params.model not in model_config.list_models(data_name):
    raise ParamError(
        f"Invalid model name '{params.model}' for dataset "
        f"'{data_name or 'imagenet'}': "
        f"--model={params.model} is not a model of the "
        f"{data_name or 'imagenet'} dataset (as in the JAX package's "
        "registry); the port runs "
        f"{', '.join(model_config.list_models(data_name))}")
  validate_mode_flags(params)
  validate_sharded_flags(params)
  validate_optimizer_flags(params)
  validate_data_parallel_flags(params)
  validate_elastic_flags(params)
  validate_dispatch_flags(params)
  validate_telemetry_flags(params)
  validate_observability_flags(params)
  validate_input_flags(params)
  validate_serving_flags(params)
  validate_aot_flags(params)
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
    model = model_config.get_model_config(params.model, params, data_name)
    kernels = model.bf16_kernels()
    if kernels and not params.use_fp16:
      raise ParamError(
          f"--device=gpu needs --use_fp16 for --model={params.model}: "
          f"{kernels} have no f32 variant yet")


def validate_serving_flags(p) -> None:
  """The decode-cost variants' cross rules (the JAX package's
  validation.py:230-256, with its messages): the page size divides the
  serving context, speculative k comes with the draft depth and the draft
  depth with k. LMSpec checks the draft depth against the layer count."""
  page = p.serving_kv_page_size
  if page is not None and transformer_lm.SEQ_LEN % page:
    raise ParamError(
        f"--serving_kv_page_size={page} must divide the serving "
        f"context length ({transformer_lm.SEQ_LEN}): partial pages would "
        "break the page-table <-> ring position bijection "
        "(serving/decode.py)")
  spec_k, draft_layers = p.serving_speculative_k, p.serving_draft_layers
  if spec_k is not None and draft_layers is None:
    raise ParamError(
        f"--serving_speculative_k={spec_k} requires a draft spec: set "
        "--serving_draft_layers (< the served model's layer count; "
        "serving/decode.py draft_spec)")
  if draft_layers is not None and spec_k is None:
    raise ParamError(
        f"--serving_draft_layers={draft_layers} is inert without "
        "--serving_speculative_k (the draft only runs inside "
        "speculative rounds)")
  if draft_layers is not None and draft_layers >= transformer_lm.N_LAYERS:
    raise ParamError(
        f"--serving_draft_layers={draft_layers} must be below the served "
        f"model's layer count ({transformer_lm.N_LAYERS}): the draft is "
        "its truncation (serving/decode.py draft_spec)")


def validate_aot_flags(p) -> None:
  """--trt_mode and the AOT paths (the JAX package's
  validation.py:755-805, with its messages), and the port's refusal of
  an FP32 export on the card."""
  trt_mode = (p.trt_mode or "").upper()
  if trt_mode and trt_mode not in ("FP32", "FP16", "INT8"):
    raise ParamError(f"--trt_mode: unknown mode {p.trt_mode!r}; the "
                     "serving-export precisions are FP32, FP16, INT8 "
                     "(ref :615-620)")
  if trt_mode and not (p.aot_save_path or p.aot_load_path):
    # The JAX package asks for --aot_save_path alone, and then cannot
    # state an INT8 artifact's mode when it loads one (its loader diffs
    # --trt_mode against the sidecar); the port also takes it with
    # --aot_load_path, as the mode the artifact must have.
    raise ParamError("--trt_mode sets the precision of the frozen "
                     "serving export and requires --forward_only with "
                     "--aot_save_path (the TRT conversion analog, ref "
                     ":615-620, :2466-2486), or with --aot_load_path the "
                     "precision the loaded artifact was exported at")
  if p.aot_load_path and not p.forward_only:
    raise ParamError("--aot_load_path requires --forward_only (the "
                     "frozen artifact has no training program; ref: "
                     "TRT serving path, benchmark_cnn.py:2405-2525)")
  if p.aot_save_path and not p.forward_only:
    raise ParamError("--aot_save_path requires --forward_only (the "
                     "export freezes the inference program, the analog "
                     "of the reference's forward-only graph freeze; ref: "
                     "benchmark_cnn.py:2405-2525)")
  if p.aot_load_path and p.aot_save_path:
    raise ParamError("At most one of --aot_load_path and --aot_save_path "
                     "may be set")
  if trt_mode == "FP32" and p.device == "gpu":
    # The kernels on the exported path read bf16 only (validation's
    # --use_fp16 rule for --device=gpu).
    raise ParamError(
        "--trt_mode=FP32 exports an f32 forward, and the port's kernels "
        "have no f32 variant yet (ROADMAP Queue 2 item 2); export FP16 or "
        "INT8 (bf16 compute) on the card, or FP32 with --device=cpu")
  if (p.aot_save_path or p.aot_load_path) and \
      p.model == "transformer_lm":
    raise ParamError(
        "--aot_save_path / --aot_load_path export the image models' "
        "frozen forward (models with an images input); transformer_lm "
        "serves through the serving bench (serving/bench.py)")
  if (p.aot_save_path or p.aot_load_path) and p.num_devices > 1:
    raise ParamError(
        "--aot_save_path / --aot_load_path run on one device: the export "
        "freezes one replica's forward")


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
  """16-bit variables, loss scaling and the learning-rate policy (the JAX
  package's rules and messages, validation.py:642-649, :685-717)."""
  if p.fp16_vars and not p.use_fp16:
    raise ParamError("--fp16_vars requires --use_fp16 (ref :1330-1331)")
  if p.fp16_vars and p.gradient_repacking:
    raise ParamError("--fp16_vars cannot be used with --gradient_repacking "
                     "(ref :1284-1285)")
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


# The input layer's reference-parity flags: accepted, and a note is logged
# when one is set away from its default (the JAX package's
# _NOOP_PARITY_FLAGS, benchmark.py:171-200).
NOOP_PARITY_FLAGS = {
    "fuse_decode_and_crop": "the host pipeline always crops before "
                            "resizing",
    "distort_color_in_yiq": "color jitter runs as PIL's enhancers do",
    "datasets_use_prefetch": "the DeviceFeeder always prefetches",
    "datasets_parallel_interleave_cycle_length": "shard reads interleave "
                                                 "via the thread pool",
    "datasets_sloppy_parallel_interleave": "tf.data knob",
    "datasets_parallel_interleave_prefetch": "tf.data knob",
    "use_multi_device_iterator": "the DeviceFeeder is the "
                                 "MultiDeviceIterator analog",
    "multi_device_iterator_max_buffer_size": "MultiDeviceIterator knob",
    "freeze_when_forward_only": "freezing is the --aot_save_path export "
                                "(the weights become its constants)",
    "trt_max_workspace_size_bytes": "TensorRT knob; --trt_mode itself is "
                                    "validated",
}


def noop_parity_notes(params):
  """One note for each parity flag set away from its default."""
  return [f"Note: --{name} is accepted for reference-CLI parity but has "
          f"no effect in the port: {why}"
          for name, why in NOOP_PARITY_FLAGS.items()
          if getattr(params, name) != flags.param_specs[name].default_value]


def validate_input_flags(p) -> None:
  """The input path's refusals (the JAX package's validation.py:812-816
  and the preprocessor map): --use_datasets=false, a dataset or
  preprocessor the port does not run, a --data_dir under a model that does
  not read images."""
  if not p.use_datasets:
    raise ParamError(
        "--use_datasets=false is unsupported: the port has a single host "
        "input pipeline (the reference's legacy RecordInput path, ref "
        ":215-217/:601-617, has no counterpart)")
  if not p.data_dir or p.use_synthetic_gpu_images:
    return
  try:
    dataset = datasets.create_dataset(p.data_dir, p.data_name)
  except ValueError as e:
    raise ParamError(str(e)) from e
  if p.model == "transformer_lm":
    raise ParamError(
        "--data_dir feeds image records; transformer_lm reads its seeded "
        "token stream (a real corpus is not wired, as in the JAX package)")
  try:
    dataset.get_input_preprocessor(p.input_preprocessor)
  except ValueError as e:  # ParamError included
    raise ParamError(str(e)) from e


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
    if p.staged_vars:
      raise ParamError(
          "--num_grad_accum > 1 cannot be combined with --staged_vars: "
          "staged reads hand the forward one-step-stale weights from a "
          "single staging slot per step (variable_mgr.py:246-274); "
          "microbatches would all read the same stale copy while the "
          "accumulated update lands once, making the effective "
          "staleness M-dependent in a way the reference semantics "
          "never defined")
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


def world_size_of(p) -> int:
  """The ranks a run has: --num_devices spawned ranks, or one a worker of
  --worker_hosts. It stands for the JAX package's --num_devices in the
  rules that count devices (its validation.py:650-652, :695): there
  num_devices is the size of the one mesh that spans every worker
  (benchmark.py:393-407), while a kfrun worker of the port runs at
  --num_devices=1 (the --worker_hosts rule above), so its world is the
  worker list."""
  return max(p.num_devices, len(p.worker_hosts or []))


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
      and world_size_of(p) > ASYNC_PS_SEQUENTIAL_MAX_DEVICES):
    raise ParamError(
        "async parameter_server (--cross_replica_sync=false) with a "
        f"stateful optimizer ({p.optimizer}) applies num_devices "
        "optimizer updates sequentially through shared state each step; "
        f"capped at {ASYNC_PS_SEQUENTIAL_MAX_DEVICES} devices. Use "
        "--optimizer=sgd (exact single-update collapse) or a "
        "synchronous --variable_update at this scale")
  if p.staged_vars and p.variable_update != "parameter_server":
    raise ParamError("--staged_vars is only supported with "
                     "--variable_update=parameter_server (ref :1478-1479)")
  if p.staged_vars and p.fp16_enable_auto_loss_scale:
    raise ParamError("Automatic loss scaling is not supported with "
                     "--staged_vars (ref :1304-1305)")
  if p.staged_vars and eval_during_training_enabled(p):
    raise ParamError("--eval_during_training_* is not compatible with "
                     "--staged_vars (ref :1335-1336)")
  if p.variable_consistency == "relaxed" and p.variable_update not in (
      "replicated", "distributed_replicated", "parameter_server",
      "collective_all_reduce", "distributed_all_reduce"):
    raise ParamError(
        "--variable_consistency=relaxed requires a replicated-family "
        "--variable_update (the deferral lives in the batched all-reduce, "
        "ref: batch_allreduce.py:32-153; independent/kungfu/horovod "
        "reduce outside it)")
  if p.hierarchical_copy and world_size_of(p) <= 1:
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
    if p.job_name:
      # The JAX package refuses --worker_hosts too: its multi-host mesh
      # cannot gather the shard rows for a chief-only save. The port's
      # workers are the ranks of one process group, and the checkpoint's
      # rows meet in one all-gather over it (ShardedState.stacks), so a
      # kfrun worker set may shard (the elastic rescale's world).
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
    if p.staged_vars:
      raise ParamError(
          "--shard_optimizer_state cannot be combined with "
          "--staged_vars: staged reads keep a second full weight copy "
          "per device (variable_mgr.py:246-274), the exact footprint "
          "sharded state exists to retire")
    if p.variable_consistency == "relaxed":
      raise ParamError(
          "--shard_optimizer_state cannot be combined with "
          "--variable_consistency=relaxed: the deferred-gradient bank "
          "stores a full gradient tree per device "
          "(train_step.py buffers); banking shards instead would "
          "change the staleness semantics silently")
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
    # --elastic composes: a resize is a checkpoint-restart, and the
    # restarted world re-slices the saved (n, k) shard stacks onto its own
    # size (checkpoint.py _reshard). A target the restart cannot take is
    # refused at poll time (benchmark.py), not here: the target is only
    # known mid-run.
    if p.health_stats:
      raise ParamError(
          "--health_stats cannot be combined with "
          "--shard_optimizer_state: the in-step stats read the full "
          "per-step update tree (telemetry.py health_partials), and "
          "the sharded apply only materializes this device's 1/n "
          "update shard. Drop the flag (auto-off with a note)")
    # The port's own rule.
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
  if p.shard_params and (p.summary_verbosity or 0) >= 2:
    raise ParamError(
        "--summary_verbosity >= 2 cannot be combined with "
        "--shard_params: the tier-2 parameter histograms read the "
        "replica-0 FULL parameter tree (observability.py "
        "write_histograms), which the FSDP layout stores as 1/n "
        "flat shards -- the histograms would silently describe one "
        "shard. Use verbosity 1 (scalars) or drop --shard_params "
        "for histogram debugging")


def validate_observability_flags(p) -> None:
  """The training-only sinks (the JAX package's validation.py:765-792,
  with its messages, the profiler named as the port's), and the tuned
  table (:334-345 there)."""
  if p.autotuned_config and (p.eval or p.forward_only):
    raise ParamError(AUTOTUNED_EVAL_MESSAGE)
  if p.trace_events_file and (p.eval or p.forward_only):
    raise ParamError(
        "--trace_events_file instruments training runs only (the span "
        "timeline covers the train loop's feed/dispatch/compile/"
        "checkpoint/elastic boundaries, tracing.py); it cannot be "
        "combined with --eval or --forward_only. The torch.profiler "
        "--trace_file capture works in every mode")
  if p.metrics_port and (p.eval or p.forward_only):
    raise ParamError(
        "--metrics_port serves the training loop's metric registry "
        "(metrics.py); it cannot be combined with --eval or "
        "--forward_only")
  if p.run_store_dir and (p.eval or p.forward_only):
    raise ParamError(
        "--run_store_dir appends the TRAINING run's record to the "
        "run store (metrics.py RunStore, written at train-loop end); "
        "it cannot be combined with --eval or --forward_only. The "
        "bench records come from bench_torch.py, which owns its own "
        "store path")


def validate_telemetry_flags(p) -> None:
  """--health_stats and --fault_schedule (the JAX package's rules and
  messages, validation.py:561-600, :902-935)."""
  if p.fault_schedule:
    # Malformed schedules fail at startup, not at the named step: a
    # fault harness that silently skips its fault proves nothing.
    try:
      entries = faults.parse_schedule(p.fault_schedule)
    except faults.FaultScheduleError as e:
      raise ParamError(str(e))
    if any(f.kind == "corrupt_ckpt" for f in entries) and not p.train_dir:
      raise ParamError(
          "--fault_schedule=corrupt_ckpt@... requires --train_dir: "
          "there is no checkpoint to corrupt without one")
    if any(f.kind in ("kill", "sigterm") for f in entries) \
        and not p.train_dir:
      raise ParamError(
          "--fault_schedule kill/sigterm entries require --train_dir: "
          "the one-shot-across-generations marker lives there "
          "(faults.py) -- without it every relaunched generation "
          "re-kills itself at the same step, and there is no "
          "checkpoint to rejoin from anyway")
    if any(f.kind == "drop_msg" for f in entries) and not p.elastic:
      raise ParamError(
          "--fault_schedule=drop_msg@... requires --elastic: the fault "
          "suppresses a coordination-service poll, and without elastic "
          "polling there is no message to drop -- the injection would "
          "log success while testing nothing")
    if any(f.kind == "heartbeat_delay" for f in entries) and (
        not p.stall_watchdog_factor or
        not (p.train_dir or p.health_stats)):
      raise ParamError(
          "--fault_schedule=heartbeat_delay@... requires a live stall "
          "watchdog to starve: --stall_watchdog_factor > 0 plus a "
          "telemetry session (--train_dir, or explicit --health_stats) "
          "-- otherwise the injected silence is observed by nothing")
    if p.eval or p.forward_only:
      raise ParamError(
          "--fault_schedule applies to training runs only (the faults "
          "fire at train-dispatch boundaries); it cannot be combined "
          "with --eval or --forward_only")
  if p.health_stats:
    # Explicit --health_stats (unset = auto-resolve, telemetry.py): the
    # in-step stats read the APPLIED gradient tree and are only global
    # values when that tree is replica-identical -- i.e. when the
    # strategy reduces gradients replica-synchronously.
    if p.eval or p.forward_only:
      raise ParamError(
          "--health_stats applies to training only (the stats are "
          "computed from the step's gradient tree); it cannot be "
          "combined with --eval or --forward_only")
    if p.variable_update == "independent":
      raise ParamError(
          "--health_stats requires replica-synchronous gradient "
          "reduction: --variable_update=independent never reduces, so "
          "each replica's 'global' grad norm would be its own local "
          "one. Drop the flag (auto-off) or use a replicated-family "
          "mode")
    if p.variable_update == "kungfu" and p.kungfu_option != "sync_sgd":
      raise ParamError(
          "--health_stats cannot be combined with --kungfu_option="
          f"{p.kungfu_option}: gossip/model-averaging modes keep "
          "per-replica gradient trees (parallel/strategies.py); only "
          "sync_sgd reduces replica-synchronously")
    if p.variable_update == "parameter_server" and not p.cross_replica_sync:
      raise ParamError(
          "--health_stats cannot be combined with async "
          "parameter_server (--cross_replica_sync=false): the "
          "sequential-apply path consumes each replica's UNAVERAGED "
          "gradient (train_step.py sequential_apply), so no replica-"
          "identical reduced tree exists for the stats to read")
