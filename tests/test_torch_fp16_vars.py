"""--fp16_vars in the port against the JAX package, on the CPU.

The port's --fp16_vars stores the parameters, and so the optimizer state,
in bf16 (its compute dtype; the JAX package takes bf16 on the TPU and
float16 elsewhere, so its side here is built as its TPU path builds it:
every module with ``dtype=param_dtype=bfloat16``). Both frameworks start
from one flax init rounded to bf16 and train the same numpy batch with the
JAX package's own step (``make_step_fns``, replicated at world 1) and the
port's TrainStep, Nesterov momentum at weight decay 1e-3:

* the (1, 2, 1, 1) ResNet-50 v1.5 of tests/torch_parity.py (full widths,
  64x64, batch 2), two steps;
* the small LM of tests/torch_dp_worker.py (vocab 128, d_model 32, two
  layers, the scan layout, the fused head), three steps.

The limits follow tests/test_torch_bf16_parity.py: bf16 parameters round
every update into an 8-bit mantissa, at other places in the two
frameworks, so each limit is a constant times what bf16 parameters do to
the JAX package alone (its bf16-parameter run against its f32-parameter
run from the same init):

* every step's total loss within 2e-2 relative (the card's gate);
* every tensor's update (final weights minus the bf16 init) within
  UPDATE_C times the JAX package's own distance between its bf16- and
  f32-parameter updates, and the model's whole update within MODEL_C
  times it. Readings: at most 4.39x (the ResNet's classifier bias, whose
  zero init bf16 stores finely, so the JAX pair differs little there and
  the two frameworks' bf16 gradients differ more) and 2.04x in the LM per
  tensor; 0.89x ResNet and 0.26x LM for the whole model. A bf16-only
  update scale of 1.1 moves the classifier bias by 2.8e-5, about six
  times its limit;
* the port's parameters and every optimizer buffer bf16 (momentum, RMSProp
  and Adam; Adam's count f32), as optax's ``zeros_like(params)`` makes
  the JAX package's;
* the L2 loss of bf16 parameters equal to the JAX package's at its f32
  accumulation, within 1e-5 relative (f32 summation order over ten
  million squares), each within it of the f64 sum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.models import transformer_lm as jax_lm
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import train_step
from kf_benchmarks_tpu_torch.models import model as model_lib

import torch_dp_modes as modes
import torch_dp_worker as worker
import torch_parity as tp

torch.set_num_threads(2)

LOSS_TOL = 2e-2
UPDATE_C = 6.0
MODEL_C = 1.5
FLAGS = dict(optimizer="momentum", momentum=0.9, use_fp16=True)
DTYPES = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def _jax_module(model, param_dtype):
  if model == "resnet":
    m = jax_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS)
    return m, m.make_module(nclass=worker.NCLASS, phase_train=True,
                            dtype=jnp.bfloat16, param_dtype=param_dtype)
  m = jax_lm.TransformerLMModel()
  m.LOSS_CHUNK = worker.LM_LOSS_CHUNK
  return m, jax_lm._TransformerLMModule(
      vocab=worker.LM_VOCAB, d_model=worker.LM_D, n_layers=worker.LM_LAYERS,
      n_heads=worker.LM_HEADS, d_ff=worker.LM_DFF,
      attn_block=worker.LM_BLOCK, attn_q_block=worker.LM_BLOCK,
      max_len=worker.LM_T, attn_impl="flash", scan_layers=True,
      fused_head=True, dtype=jnp.bfloat16, param_dtype=param_dtype)


def _bf16_init(model):
  """The flax init with its parameters rounded to bf16 (the batch-norm
  averages stay f32), as f32 numpy: both frameworks' starting point."""
  v = modes.variables(model)
  params = jax.tree.map(
      lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
      v["params"])
  return {**v, "params": params}


def _f32(tree):
  return {k: np.asarray(v, np.float32) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _jax_run(model, dtype):
  """(total losses, final params {flax key: f32 numpy}, their dtypes as
  the JAX step left them) of the JAX package's step at world 1 with
  ``dtype`` parameters."""
  init = _bf16_init(model)
  variables = {**init, "params": jax.tree.map(
      lambda x: jnp.asarray(x, DTYPES[dtype]), init["params"])}
  losses, params, _ = tp.jax_dp_run(
      1, FLAGS, variables, modes.batches(model, 1), modes.STEPS[model],
      modes.LR[model], _jax_module(model, DTYPES[dtype]))
  flat = modes._flat(params[0])
  return ([t for _, t in losses], _f32(flat),
          {str(v.dtype) for v in flat.values()})


def _port_layout(module):
  out = {}
  for key, t in module.state_dict().items():
    if key in dict(module.named_parameters()):
      path, kind, index = convert.flax_source(key, t, module)
      name = path[1:] if index is None else path[1:] + (index,)
      out[name] = convert.to_flax_layout(t.detach().float().numpy(), kind)
  return out


def _port_run(model):
  """(total losses, final params, the module, the step) of the port's
  step with bf16 parameters (--use_fp16 --fp16_vars)."""
  pm = worker.port_model(model)
  module = pm.make_module(worker.NCLASS, torch.bfloat16)
  module.load_state_dict(convert.flax_to_state_dict(_bf16_init(model),
                                                    module))
  model_lib.cast_params(module, torch.bfloat16)
  p = params_lib.make_params(device="cpu", fp16_vars=True,
                             weight_decay=tp.DP_WEIGHT_DECAY, **FLAGS)
  step = worker.make_step(pm, module, p, modes.LR[model])
  x, y = modes.batches(model, 1)[0]
  x, y = torch.from_numpy(x), torch.from_numpy(y).long()
  losses = [float(step(x, y)["total_loss"])
            for _ in range(modes.STEPS[model])]
  return losses, _port_layout(module), module, step


@functools.lru_cache(maxsize=None)
def _runs(model):
  return ({dt: _jax_run(model, dt) for dt in DTYPES}, _port_run(model))


@pytest.mark.parametrize("dtype,want", [("bf16", "bfloat16"),
                                        ("f32", "float32")])
@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_jax_reference_keeps_its_parameter_dtype(model, dtype, want):
  """The JAX side's bf16 run is what its TPU path trains: its step leaves
  bf16 parameters (and its f32 run f32 ones)."""
  assert _jax_run(model, dtype)[2] == {want}


def _init_params(model):
  return _f32(modes._flat(_bf16_init(model)["params"]))


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_loss_and_updates_match_jax(model):
  jax_runs, (p_losses, p_final, _, _) = _runs(model)
  (j16_losses, j16, _), (_, j32, _) = jax_runs["bf16"], jax_runs["f32"]
  np.testing.assert_allclose(p_losses, j16_losses, rtol=LOSS_TOL)
  init = _init_params(model)
  assert set(p_final) == set(j16) == set(init)
  got_all = own_all = 0.0
  for key in init:
    d = lambda final: final[key].astype(np.float64) - init[key]
    got = np.linalg.norm(d(p_final) - d(j16))
    own = np.linalg.norm(d(j16) - d(j32))
    assert got <= UPDATE_C * own, (key, got, own)
    got_all += got ** 2
    own_all += own ** 2
  assert got_all ** 0.5 <= MODEL_C * own_all ** 0.5, (got_all, own_all)


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_parameters_and_momentum_are_bf16(model):
  _, (_, _, module, step) = _runs(model)
  assert {p.dtype for p in module.parameters()} == {torch.bfloat16}
  assert {b.dtype for b in module.buffers()} <= {torch.float32}
  state = [v for st in step.optimizer.state.values() for v in st.values()]
  assert state and {v.dtype for v in state} == {torch.bfloat16}


@pytest.mark.parametrize("opt,f32_keys", [
    ("rmsprop", set()), ("adam", {"step"}), ("lars", set())])
def test_every_optimizer_s_state_follows_the_parameters(opt, f32_keys):
  pm = worker.port_model("trivial")
  module = model_lib.cast_params(pm.make_module(worker.NCLASS),
                                 torch.bfloat16)
  p = params_lib.make_params(device="cpu", fp16_vars=True, use_fp16=True,
                             optimizer=opt)
  step = train_step.TrainStep(
      pm, module, optimizers.get_optimizer(p, module.parameters()),
      lambda s: 1e-3, 1e-3)
  x, y = modes.batches("trivial", 1)[0]
  step(torch.from_numpy(x), torch.from_numpy(y).long())
  for st in step.optimizer.state.values():
    assert st
    for key, v in st.items():
      want = torch.float32 if key in f32_keys else torch.bfloat16
      assert v.dtype == want, (opt, key, v.dtype)
  assert {q.dtype for q in module.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_l2_loss_of_bf16_parameters_matches_jax(model):
  init = _bf16_init(model)
  ref = float(jax_train_step.l2_loss(jax.tree.map(
      lambda x: jnp.asarray(x, jnp.bfloat16), init["params"])))
  pm = worker.port_model(model)
  module = pm.make_module(worker.NCLASS, torch.bfloat16)
  module.load_state_dict(convert.flax_to_state_dict(init, module))
  model_lib.cast_params(module, torch.bfloat16)
  got = train_step.l2_loss(module).detach()
  assert got.dtype == torch.float32
  exact = 0.5 * sum(float((q.detach().double() ** 2).sum())
                    for name, q in module.named_parameters()
                    if not train_step.is_batch_norm_param(name))
  np.testing.assert_allclose([float(got), ref], [exact, exact], rtol=1e-5)
  np.testing.assert_allclose(float(got), ref, rtol=1e-5)


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_convert_carries_bf16_flax_parameters(model):
  """flax parameters stored bf16 (``param_dtype=bfloat16``) cross the
  weight bridge exactly into the port's bf16 parameters."""
  init = _bf16_init(model)
  bf16 = {**init, "params": jax.tree.map(
      lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), init["params"])}
  pm = worker.port_model(model)
  want = pm.make_module(worker.NCLASS, torch.bfloat16)
  want.load_state_dict(convert.flax_to_state_dict(init, want))
  model_lib.cast_params(want, torch.bfloat16)
  got = model_lib.cast_params(pm.make_module(worker.NCLASS, torch.bfloat16),
                              torch.bfloat16)
  got.load_state_dict(convert.flax_to_state_dict(bf16, got))
  for (name, a), b in zip(got.named_parameters(), want.parameters()):
    assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
