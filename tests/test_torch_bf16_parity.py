"""The port's bf16 path against the JAX package's bf16 path, on the CPU.

The card runs the port in bf16 (bf16 compute over f32 parameters, as
flax's ``dtype=bfloat16`` / ``param_dtype=float32``), while the other
parity tests hold the port to the JAX package in f32 only. Here both
frameworks run the same two models in bf16 and in f32, from one converted
flax init and one numpy batch:

* the ``(1, 2, 1, 1)`` ResNet-50 v1.5 of tests/torch_parity.py (full
  widths, batch 2 at 64x64, training-phase batch norm; the port's fused
  BN-ReLU-conv3x3 units run their plain versions);
* the small LM of tests/test_torch_transformer_lm.py (vocab 128, d_model
  32, 2 layers, 4 heads, T 64, ``flash`` attention: the port's plain
  versions, the JAX package's ``full_attention``).

bf16 keeps 8 bits of mantissa, and the two frameworks round at other
places (the port folds batch norm into x*sc + sh before its fused units,
XLA fuses casts), so the two bf16 runs are not expected to agree to f32
precision. Every limit is set by what bf16 does to the JAX package alone
(its bf16 run against its own f32 run), times a constant that stands
above what this size shows, so no limit widens with a port fault:

* loss within 2e-2 relative (the card-vs-CPU gate of chip_smoke.py);
* logits: max |port bf16 - JAX bf16| within LOGIT_C times JAX's own
  max |bf16 - f32| (readings: 0.40x ResNet, 1.31x LM);
* every parameter gradient: relative L2 distance to JAX's bf16 gradient
  within GRAD_C times JAX's own bf16-vs-f32 distance (readings: at most
  0.89x ResNet, 1.69x LM);
* every parameter gradient's norm within NORM_C times that distance of
  JAX's bf16 norm: bf16 noise is mostly orthogonal to a gradient, so it
  moves norms far less than directions (readings: at most 0.22x ResNet,
  0.28x LM). This is the check that sees a scale fault where bf16 noise
  is large, as in the ResNet at batch 2;
* each framework's gradient cosines against its own f32 run agree within
  0.1 for every parameter: where bf16 rounding eats most of a gradient, it
  does so in the JAX package as in the port;
* the ResNet classifier's gradient (which chip_smoke.py holds on the card)
  to cosine >= 0.98 and norm within 5e-2.

What this resolves: a bf16-only gradient scale of 1.1 (on the logits'
cotangent) fails the norm check in both models and the distance check in
the LM, and 1.1 on the MLP branch's cotangent fails the LM. A fault local
to the ResNet's early layers stays inside the bf16 noise of a batch of 2
and passes: the fused conv_b units' weight gradients times 1.1, or those
units run in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import transformer_lm as jax_lm
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet
from kf_benchmarks_tpu_torch.models import transformer_lm as port_lm

import torch_parity as tp

torch.set_num_threads(2)

VOCAB, D, LAYERS, HEADS, DFF, T, BLOCK = 128, 32, 2, 4, 64, 64, 16
LOSS_TOL = 2e-2
LOGIT_C = 2.0
GRAD_C = 2.5
NORM_C = 0.5
COSINE_GAP = 0.1
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _resnet_jax(model, variables, images, labels, dtype):
  module = model.make_module(nclass=tp.NCLASS, phase_train=True,
                             dtype=dtype)

  def loss_fn(params):
    (logits, aux), _ = module.apply(
        {"params": params, "batch_stats": variables["batch_stats"]},
        jnp.asarray(images), mutable=["batch_stats"])
    loss = model.loss_function(BuildNetworkResult(logits=(logits, aux)),
                               jnp.asarray(labels))
    return loss, logits

  (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      variables["params"])
  return dict(loss=float(loss), logits=np.asarray(logits, np.float32),
              grads=tp.flat_flax(jax.device_get(grads)))


def _resnet_port(variables, images, labels, dtype):
  model = port_resnet.ResnetModel("resnet50_v1.5", tp.LAYER_COUNTS)
  module = model.make_module(tp.NCLASS, dtype)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  module.train()
  logits = module(torch.from_numpy(images))
  loss = model.loss_function(logits, torch.from_numpy(labels).long())
  loss.backward()
  return dict(loss=float(loss.detach()),
              logits=logits.detach().float().numpy(),
              grads=tp.port_grads_in_flax_layout(module))


def _lm_jax_module(dtype):
  return jax_lm._TransformerLMModule(
      vocab=VOCAB, d_model=D, n_layers=LAYERS, n_heads=HEADS, d_ff=DFF,
      attn_block=BLOCK, attn_q_block=BLOCK, max_len=T, attn_impl="flash",
      scan_layers=False, fused_head=False, dtype=dtype)


def _lm_models():
  jm, pm = jax_lm.TransformerLMModel(), port_lm.TransformerLMModel()
  jm.LOSS_CHUNK = pm.LOSS_CHUNK = 16
  return jm, pm


def _lm_jax(variables, tokens, labels, dtype):
  module = _lm_jax_module(dtype)
  jm, _ = _lm_models()

  def loss_fn(params):
    out = module.apply({"params": params}, jnp.asarray(tokens))
    return jm.loss_function(BuildNetworkResult(logits=out),
                            jnp.asarray(labels)), out[0]

  (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      variables["params"])
  flat = convert._flatten({"params": jax.device_get(grads)})
  return dict(loss=float(loss), logits=np.asarray(logits, np.float32),
              grads=flat)


def _lm_port(variables, tokens, labels, dtype):
  _, pm = _lm_models()
  module = port_lm.TransformerLM(VOCAB, D, LAYERS, HEADS, DFF, BLOCK, BLOCK,
                                 "flash", False, False, T, dtype)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  out = module(torch.from_numpy(tokens))
  loss = pm.loss_function(out, torch.from_numpy(labels))
  loss.backward()
  grads = {}
  for key, p in module.named_parameters():
    path, kind, index = convert.flax_source(key, p, module)
    grads[(path, index)] = convert.to_flax_layout(p.grad.float().numpy(),
                                                  kind)
  return dict(loss=float(loss.detach()),
              logits=out[0].detach().float().numpy(), grads=grads)


def _lm_jax_grads_by_port_key(run, port_keys):
  """The JAX run's gradients under the port's (flax path, layer) keys."""
  flat = run["grads"]
  return {(path, index): flat[path] if index is None else flat[path][index]
          for path, index in port_keys}


@pytest.fixture(scope="module")
def resnet_runs():
  images, labels = tp.batch(2, 64)
  model, variables = tp.jax_model_and_variables(images)
  return {dt: (_resnet_jax(model, variables, images, labels, jd),
               _resnet_port(variables, images, labels, td))
          for dt, (jd, td) in DTYPES.items()}


@pytest.fixture(scope="module")
def lm_runs():
  rng = np.random.default_rng(1)
  tokens = rng.integers(0, VOCAB, (2, T)).astype(np.int32)
  labels = np.roll(tokens, -1, axis=1)
  variables = jax.device_get(_lm_jax_module(jnp.float32).init(
      jax.random.PRNGKey(2), jnp.asarray(tokens)))
  runs = {}
  for dt, (jd, td) in DTYPES.items():
    port = _lm_port(variables, tokens, labels, td)
    jrun = _lm_jax(variables, tokens, labels, jd)
    jrun["grads"] = _lm_jax_grads_by_port_key(jrun, port["grads"])
    runs[dt] = (jrun, port)
  return runs


def _runs(request, model):
  return request.getfixturevalue(f"{model}_runs")


def _rel(a, b):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cos(a, b):
  a = np.asarray(a, np.float64).ravel()
  b = np.asarray(b, np.float64).ravel()
  return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_bf16_loss_and_logits_match_jax(model, request):
  runs = _runs(request, model)
  (j16, p16), (j32, _) = runs["bf16"], runs["f32"]
  assert abs(p16["loss"] - j16["loss"]) <= LOSS_TOL * abs(j16["loss"])
  own = np.abs(j16["logits"] - j32["logits"]).max()
  gap = np.abs(p16["logits"] - j16["logits"]).max()
  assert gap <= LOGIT_C * own, (gap, own)


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_bf16_gradients_match_jax(model, request):
  """Every parameter's bf16 gradient within GRAD_C times the distance bf16
  puts between JAX's own bf16 and f32 gradients, and its norm within
  NORM_C times that distance of JAX's bf16 norm."""
  runs = _runs(request, model)
  (j16, p16), (j32, _) = runs["bf16"], runs["f32"]
  assert set(p16["grads"]) == set(j16["grads"])
  for key, g in p16["grads"].items():
    ref = j16["grads"][key]
    assert g.shape == ref.shape, key
    own = _rel(ref, j32["grads"][key])
    assert _rel(g, ref) <= GRAD_C * own, (key, _rel(g, ref), own)
    n_rel = abs(np.linalg.norm(g) / np.linalg.norm(ref) - 1.0)
    assert n_rel <= NORM_C * own, (key, n_rel, own)


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_bf16_gradient_cosines_match_jax(model, request):
  """Each framework's bf16 gradient against its own f32 one: the cosines
  agree within COSINE_GAP for every parameter, so what bf16 rounding
  leaves of a gradient is the same in both."""
  runs = _runs(request, model)
  (j16, p16), (j32, p32) = runs["bf16"], runs["f32"]
  for key, g in p16["grads"].items():
    c_port = _cos(g, p32["grads"][key])
    c_jax = _cos(j16["grads"][key], j32["grads"][key])
    assert abs(c_port - c_jax) <= COSINE_GAP, (key, c_port, c_jax)


def test_bf16_classifier_gradient_matches_jax(resnet_runs):
  """The gate chip_smoke.py's parity phase holds on the card."""
  j16, p16 = resnet_runs["bf16"]
  for leaf in ("kernel", "bias"):
    g, ref = p16["grads"][("affine0", leaf)], j16["grads"][("affine0", leaf)]
    n_rel = abs(np.linalg.norm(g) - np.linalg.norm(ref)) / np.linalg.norm(ref)
    assert n_rel <= 5e-2 and _cos(g, ref) >= 0.98, (leaf, n_rel,
                                                    _cos(g, ref))
