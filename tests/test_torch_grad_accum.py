"""--num_grad_accum in the port (train_step.TrainStep), on the CPU.

The cases of the JAX package's tests/test_grad_accum.py:56-190, on the
port, and the port against the JAX package:

* validation: train-only, divisibility (of an explicit --batch_size and of
  a model-default batch), async parameter_server and adaptive batch, with
  the JAX package's messages, and --staged_vars (whose other rules
  tests/test_torch_stale_modes.py holds).
* One step at M = 2 and 4 against the JAX package's step at the same M,
  from one converted init and one numpy batch, plain SGD at a fixed rate
  with weight decay: the losses (the means over the microbatches) and each
  parameter's update, which is -rate times the accumulated gradient. The
  trivial MLP (no batch norm) within 1e-5 (losses) and 1e-4 (each
  parameter's update), the tolerances of tests/test_torch_train_step.py's
  f32 MLP; the small LM within 1e-5 and 1e-4; the (1, 2, 1, 1) ResNet-50,
  at batch 8, whose batch-norm statistics are per microbatch and whose
  running averages advance M times: the losses within 1e-4, the averages
  within 1e-3 and the update within 3e-2, each as one vector. The update's
  bound is the single step's own: at M = 1 the same vector differs by
  1.2e-2, from the JAX package's f32 gradients of the batch-norm
  parameters (against the port's f64 update they are off by up to 1.4e-2
  on single tensors where the port's f32 update is within 1e-5; see also
  tests/test_torch_resnet.py's docstring). The port's M = 2 update differs
  from its M = 1 update by far more than that bound, and a halved gradient
  by 0.5.
* Composition with --steps_per_dispatch: a TrainChunk at M = 2 bitwise its
  single steps, and BenchmarkCNN at M = 2 under K = 4 with a warmup and a
  run length that are not multiples of K bitwise the K = 1 run.
* Without batch norm the accumulated step is the monolithic one up to f32
  reassociation: the trivial model's per-step losses at M = 4 within 1e-5
  of M = 1; the auto loss scale and the training accuracy under
  accumulation (bf16, as --use_fp16 computes): the scale and the update
  count equal, the accuracies equal, the losses within 2^-8 (bf16's unit
  roundoff) relative.
* A planted fault -- a copy of the port that divides the accumulated
  gradient by M twice -- fails the parity check.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import learning_rate as jax_lr
from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.models import transformer_lm as jax_lm
from kf_benchmarks_tpu.models import trivial_model as jax_trivial
from kf_benchmarks_tpu.parallel import strategies as jax_strategies
from kf_benchmarks_tpu.parallel.mesh import build_mesh
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet
from kf_benchmarks_tpu_torch.models import transformer_lm as port_lm
from kf_benchmarks_tpu_torch.models import trivial_model as port_trivial

import test_torch_dispatch as td
import torch_parity as tp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
WEIGHT_DECAY = 1e-3
# Fixed rates: the trivial MLP sees raw pixel values (0..255).
RATES = {"trivial": 1e-7, "resnet": 0.1, "lm": 0.5}
# (losses, update, running averages): see the module docstring.
TOLS = {"trivial": (1e-5, 1e-4, None), "lm": (1e-5, 1e-4, None),
        "resnet": (1e-4, 3e-2, 1e-3)}


# -- validation ----------------------------------------------------------------

def _messages(flags):
  """(port message, JAX message) of the rule the flags break."""
  out = []
  for params_lib, valid in ((port_params, validation),
                            (jax_params, jax_validation)):
    with pytest.raises(valid.ParamError) as err:
      valid.validate_cross_flags(params_lib.make_params(**flags))
    out.append(str(err.value))
  return out


@pytest.mark.parametrize("flags", [
    dict(num_grad_accum=2, eval=True),
    dict(num_grad_accum=2, forward_only=True),
    dict(num_grad_accum=3, batch_size=4),
    dict(num_grad_accum=2, variable_update="parameter_server",
         cross_replica_sync=False),
    dict(num_grad_accum=2, adaptive_batch_size=True),
    dict(num_grad_accum=2, staged_vars=True,
         variable_update="parameter_server"),
])
def test_rules_refuse_with_the_jax_message(flags):
  got, want = _messages(flags)
  assert got == want


def test_model_default_batch_is_checked():
  with pytest.raises(ValueError):
    port_params.make_params(num_grad_accum=0)  # lower_bound=1
  # The trivial model's default batch is 32.
  with pytest.raises(validation.ParamError, match="divide"):
    benchmark.BenchmarkCNN(port_params.make_params(
        model="trivial", device="cpu", num_grad_accum=3))
  for kw in (dict(num_grad_accum=2, batch_size=4),
             dict(num_grad_accum=4, batch_size=8, steps_per_dispatch=4),
             dict(num_grad_accum=2, batch_size=4, use_fp16=True,
                  fp16_enable_auto_loss_scale=True)):
    validation.validate_cross_flags(port_params.make_params(device="cpu",
                                                            **kw))


# -- one step against the JAX package ------------------------------------------

def _setup(name, seed=8):
  """(JAX model, JAX module, port model, port module, variables, images,
  labels)."""
  if name == "lm":
    tokens, labels, jmodule, variables = td._lm_setup(seed)
    jmodel, pmodel = jax_lm.TransformerLMModel(), port_lm.TransformerLMModel()
    jmodel.LOSS_CHUNK = pmodel.LOSS_CHUNK = td.LOSS_CHUNK
    pmodule = port_lm.TransformerLM(td.VOCAB, td.D, td.LAYERS, td.HEADS,
                                    td.DFF, td.BLOCK, td.BLOCK, "flash", True,
                                    True, td.T, torch.float32)
    pmodule.load_state_dict(convert.flax_to_state_dict(variables, pmodule))
    return jmodel, jmodule, pmodel, pmodule, variables, tokens, labels
  if name == "trivial":
    jmodel, pmodel = jax_trivial.TrivialModel(), port_trivial.TrivialModel()
    images, labels = tp.batch(BATCH, 227, seed=seed)
  else:
    jmodel = jax_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS)
    pmodel = port_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS)
    # Batch 8: at M = 4 each microbatch's batch norm still sees 2 images.
    images, labels = tp.batch(2 * BATCH, 64, seed=seed)
  jmodule = jmodel.make_module(nclass=tp.NCLASS, phase_train=True)
  variables = jax.device_get(jmodule.init(jax.random.PRNGKey(seed),
                                          jnp.asarray(images)))
  pmodule = pmodel.make_module(tp.NCLASS, torch.float32)
  pmodule.load_state_dict(convert.flax_to_state_dict(variables, pmodule))
  return jmodel, jmodule, pmodel, pmodule, variables, images, labels


def _flags(name, m):
  return dict(optimizer="sgd", init_learning_rate=RATES[name],
              weight_decay=WEIGHT_DECAY, num_grad_accum=m,
              **({"model": "transformer_lm"} if name == "lm" else {}))


def _jax_step(jmodel, jmodule, variables, flags, images, labels):
  """(base loss, total loss, {flax path: params}, {flax path: stats}) of
  one step of the JAX package's train step."""
  p = jax_params.make_params(device="cpu", num_devices=1, **flags)
  lr_fn = jax_lr.make_learning_rate_fn(p, jmodel, len(images), 1000)
  tx = jax_optimizers.get_optimizer(p, lr_fn)
  init_state, step, _, broadcast_init, _ = jax_train_step.make_step_fns(
      jmodel, jmodule, jmodule, jax_strategies.get_strategy(p), tx, lr_fn,
      p, build_mesh(1, "cpu"))
  stack = lambda tree: jax.tree.map(lambda x: jnp.asarray(x)[None], tree)
  state = init_state(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
  state = state.replace(params=broadcast_init(stack(variables["params"])))
  if variables.get("batch_stats"):
    state = state.replace(batch_stats=stack(variables["batch_stats"]))
  state, m = step(state, jnp.asarray(images), jnp.asarray(labels))
  flat = lambda tree: {k: np.asarray(v)[0] for k, v in
                       convert._flatten(jax.device_get(tree)).items()}
  return (float(m["base_loss"]), float(m["total_loss"]),
          flat({"params": state.params}),
          flat({"batch_stats": state.batch_stats}))


def _updates(pmodule, init):
  """{parameter name: its update since ``init``}, in flax layout."""
  out = {}
  for key, q in pmodule.named_parameters():
    path, kind, index = convert.flax_source(key, q, pmodule)
    p0 = init[path] if index is None else init[path][index]
    out[key] = convert.to_flax_layout(q.detach().numpy(), kind) - p0
  return out


def _port_step(pmodel, pmodule, flags, images, labels):
  p = port_params.make_params(device="cpu", **flags)
  step = port_train_step.TrainStep(
      pmodel, pmodule, port_optimizers.get_optimizer(p, pmodule.parameters()),
      port_lr.make_learning_rate_fn(p, pmodel, len(images), 1000),
      p.weight_decay,
      num_grad_accum=p.num_grad_accum)
  m = step(torch.from_numpy(images), torch.from_numpy(labels).long())
  return float(m["base_loss"]), float(m["total_loss"])


def _rel(got, ref):
  return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def accum_errors(name, m):
  """{what: relative error} of one port step at M against the JAX
  package's step at M (the module docstring's quantities)."""
  jmodel, jmodule, pmodel, pmodule, variables, images, labels = _setup(name)
  init = {k: np.asarray(v) for k, v in convert._flatten(variables).items()}
  flags = _flags(name, m)
  ref_base, ref_total, ref_params, ref_stats = _jax_step(
      jmodel, jmodule, variables, flags, images, labels)
  base, total = _port_step(pmodel, pmodule, flags, images, labels)
  errors = {"base_loss": abs(base - ref_base) / abs(ref_base),
            "total_loss": abs(total - ref_total) / abs(ref_total)}
  got_upd = _updates(pmodule, init)
  ref_upd = {}
  for key, q in pmodule.named_parameters():
    path, _, index = convert.flax_source(key, q, pmodule)
    ref = ref_params[path] if index is None else ref_params[path][index]
    p0 = init[path] if index is None else init[path][index]
    ref_upd[key] = ref - p0
    assert np.linalg.norm(ref_upd[key]) > 0, key  # every tensor trained
  if name == "resnet":
    keys = sorted(got_upd)
    errors["update"] = _rel(np.concatenate([got_upd[k].ravel() for k in keys]),
                            np.concatenate([ref_upd[k].ravel() for k in keys]))
    got_bs, ref_bs = [], []
    for key, b in pmodule.named_buffers():
      path, _, index = convert.flax_source(key, b, pmodule)
      got_bs.append(b.numpy().ravel())
      ref_bs.append(np.asarray(ref_stats[path]).ravel())
    errors["batch_stats"] = _rel(np.concatenate(got_bs),
                                 np.concatenate(ref_bs))
  else:
    errors["update"] = max(_rel(got_upd[k], ref_upd[k]) for k in got_upd)
  return errors


def failures(name, errors):
  loss_tol, upd_tol, bs_tol = TOLS[name]
  tol = {"base_loss": loss_tol, "total_loss": loss_tol, "update": upd_tol,
         "batch_stats": bs_tol}
  return sorted(k for k, v in errors.items() if not v <= tol[k])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["trivial", "resnet", "lm"])
def test_one_step_matches_jax(name, m):
  errors = accum_errors(name, m)
  assert failures(name, errors) == [], errors


def test_resnet_microbatches_change_the_step():
  """At M = 2 the running averages (two updates from half-batch
  statistics) and the update (half-batch normalisation) differ from
  M = 1's by far more than the JAX tolerances above, which the two
  frameworks meet at each M (test_one_step_matches_jax)."""
  stats, updates = {}, {}
  for m in (1, 2):
    _, _, pmodel, pmodule, variables, images, labels = _setup("resnet")
    init = {k: np.asarray(v) for k, v in convert._flatten(variables).items()}
    _port_step(pmodel, pmodule, _flags("resnet", m), images, labels)
    stats[m] = np.concatenate([b.numpy().ravel()
                               for b in port_train_step.batch_stats(pmodule)])
    upd = _updates(pmodule, init)
    updates[m] = np.concatenate([upd[k].ravel() for k in sorted(upd)])
  assert _rel(stats[2], stats[1]) > 10 * TOLS["resnet"][2]
  assert _rel(updates[2], updates[1]) > 3 * TOLS["resnet"][1]


# -- composition with --steps_per_dispatch -------------------------------------

def test_chunk_at_m2_is_bitwise_its_single_steps():
  singles, chunked, s_state, c_state = td.run_singles_and_chunk(
      4, 6, td.FLAGS, num_grad_accum=2)
  td._assert_bitwise(singles, chunked)
  assert all(torch.equal(u, v) for u, v in zip(s_state[0], c_state[0]))


def test_composes_with_k_and_a_warmup_tail(monkeypatch):
  """M = 2 under K = 4, 6 warmup steps (one dispatch of 4 and 2 singles)
  and 11 timed ones (two of 4 and 3 singles), against M = 2 at K = 1."""
  kw = dict(num_batches=11, num_warmup_batches=6, num_grad_accum=2)
  ref, _ = td._bench(monkeypatch, steps_per_dispatch=1, **kw)
  got, _ = td._bench(monkeypatch, steps_per_dispatch=4, **kw)
  assert len(ref["losses"]) == 11 and got["losses"] == ref["losses"]
  assert got["global_step"] == ref["global_step"] == 17
  assert got["num_dispatches"] == 5 and got["num_grad_accum"] == 2


def _trivial(monkeypatch, **flags):
  lines = []
  monkeypatch.setattr(benchmark, "log_fn", lines.append)
  p = port_params.make_params(**{
      "model": "trivial", "device": "cpu", "batch_size": 8,
      "num_batches": 8, "num_warmup_batches": 1, "display_every": 1,
      **flags})
  bench = benchmark.BenchmarkCNN(p)
  stats = bench.run()
  return stats, bench.final["step"], lines


def test_trivial_losses_match_the_monolithic_step(monkeypatch):
  ref, _, _ = _trivial(monkeypatch, num_grad_accum=1)
  got, _, _ = _trivial(monkeypatch, num_grad_accum=4)
  assert len(ref["losses"]) == 8
  np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)


def test_auto_loss_scale_and_accuracy_under_accumulation(monkeypatch):
  """One finite check a step, on the accumulated gradient: the scale moves
  as at M = 1; the accuracy is the microbatches' mean."""
  kw = dict(use_fp16=True, fp16_enable_auto_loss_scale=True,
            fp16_loss_scale=2.0 ** 20, fp16_inc_loss_scale_every_n=2,
            print_training_accuracy=True)
  out = {}
  for m in (1, 2):
    stats, step, lines = _trivial(monkeypatch, num_grad_accum=m, **kw)
    columns = [line.split("\t")[2:] for line in lines
               if line[:1].isdigit() and "images/sec" in line]
    out[m] = (stats["losses"], [c[1:] for c in columns], step.loss_scale,
              step.update_count)
  assert len(out[1][1]) == 8 and out[1][1] == out[2][1]
  assert out[1][2:] == out[2][2:]
  # --use_fp16 computes in bf16, which rounds the split batch otherwise.
  np.testing.assert_allclose(out[2][0], out[1][0], rtol=2.0 ** -8)


# -- a planted fault -----------------------------------------------------------

def test_planted_fault_fails(tmp_path):
  copy = tmp_path / "copy"
  shutil.copytree(os.path.join(REPO, "kf_benchmarks_tpu_torch"),
                  copy / "kf_benchmarks_tpu_torch",
                  ignore=shutil.ignore_patterns("__pycache__", "csrc"))
  src = copy / "kf_benchmarks_tpu_torch" / "train_step.py"
  text = src.read_text()
  line = "      torch._foreach_div_(grads, float(self.num_grad_accum))\n"
  assert text.count(line) == 1
  src.write_text(text.replace(line, line + line))
  code = ("import sys; sys.path[:0] = sys.argv[1:4]; "
          "import test_torch_grad_accum as t; "
          "print('FAILED', t.failures('trivial', t.accum_errors('trivial', "
          "2)))")
  out = subprocess.run(
      [sys.executable, "-c", code, str(copy), os.path.join(REPO, "tests"),
       REPO],
      capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
      env={**os.environ, "OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"})
  assert out.returncode == 0, out.stderr[-3000:]
  line = [x for x in out.stdout.splitlines() if x.startswith("FAILED")][-1]
  assert line != "FAILED []", line
