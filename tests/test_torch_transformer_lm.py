"""The port's transformer_lm against the JAX package's, on the CPU in f32.

The small LM of tests/test_transformer_lm.py (vocab 128, d_model 32, 2
layers, 4 heads, d_ff 64, T 64, attention blocks of 16) built in both
frameworks from one flax init (converted by the port's weight bridge) and
fed one numpy batch: forward, loss and every parameter's gradient for each
of {tiled, flash} x {scan, loop} x {fused, dense}, a packed (B, 3, T)
batch, and three SGD steps with weight decay. On the CPU the port's
``flash`` runs the kernels' plain versions and the JAX package's runs its
``full_attention`` reference. Tolerances (f32, sums in other orders):
1e-5 relative for forwards and losses, 1e-4 of the largest magnitude for
gradients and parameter updates. Also the registry, the switches and the
validation rules, and a CLI run at the small size.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu.models import transformer_lm as jax_lm
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import transformer_lm as port_lm
from kf_benchmarks_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

VOCAB, D, LAYERS, HEADS, DFF, T, BLOCK = 128, 32, 2, 4, 64, 64, 16
LOSS_CHUNK = 16
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _batch(b, seed, packed=False):
  """Tokens (or the packed (B, 3, T) stack) and next-token labels."""
  rng = np.random.default_rng(seed)
  tokens = rng.integers(0, VOCAB, (b, T)).astype(np.int32)
  if not packed:
    return tokens, np.roll(tokens, -1, axis=1)
  seg = np.zeros((b, T), np.int32)
  pos = np.zeros((b, T), np.int32)
  for row, lengths in enumerate(([20, 30, 9], [40, 17])):
    at = 0
    for doc, n in enumerate(lengths, 1):
      seg[row, at:at + n] = doc
      pos[row, at:at + n] = np.arange(n)
      at += n
  labels = np.where(seg == np.roll(seg, -1, axis=1),
                    np.roll(tokens, -1, axis=1), 0).astype(np.int32)
  return np.stack([tokens, seg, pos], axis=1), labels


def _jax_module(impl, scan, fused):
  return jax_lm._TransformerLMModule(
      vocab=VOCAB, d_model=D, n_layers=LAYERS, n_heads=HEADS, d_ff=DFF,
      attn_block=BLOCK, attn_q_block=BLOCK, max_len=T, attn_impl=impl,
      scan_layers=scan, fused_head=fused)


def _port_module(impl, scan, fused, variables):
  module = port_lm.TransformerLM(VOCAB, D, LAYERS, HEADS, DFF, BLOCK, BLOCK,
                                 impl, scan, fused, T, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  return module


def _models():
  jm, pm = jax_lm.TransformerLMModel(), port_lm.TransformerLMModel()
  jm.LOSS_CHUNK = pm.LOSS_CHUNK = LOSS_CHUNK  # four chunks of the loss
  return jm, pm


def _flax_grads_of(module):
  """{(flax path, layer index): numpy grad} of every port parameter."""
  out = {}
  for key, p in module.named_parameters():
    path, kind, index = convert.flax_source(key, p, module)
    out[(path, index)] = convert.to_flax_layout(p.grad.numpy(), kind)
  return out


def _jax_leaf(flat, path, index):
  return flat[path] if index is None else flat[path][index]


def _close(got, ref, tol, what=""):
  ref = np.asarray(ref)
  np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                             atol=tol * np.abs(ref).max(), err_msg=what)


def _check_against_jax(impl, scan, fused, tokens, labels, seed):
  jmodule = _jax_module(impl, scan, fused)
  variables = jax.device_get(jmodule.init(jax.random.PRNGKey(seed),
                                          jnp.asarray(tokens)))
  jm, pm = _models()

  def jax_loss(params):
    out = jmodule.apply({"params": params}, jnp.asarray(tokens))
    return jm.loss_function(BuildNetworkResult(logits=out),
                            jnp.asarray(labels)), out

  (ref_loss, ref_out), ref_grads = jax.jit(
      jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
  module = _port_module(impl, scan, fused, variables)
  out = module(torch.from_numpy(tokens))
  loss = pm.loss_function(out, torch.from_numpy(labels))
  loss.backward()

  head, aux = out
  ref_head, ref_aux = ref_out
  if fused:
    _close(head.hidden.detach().numpy(), ref_head.hidden, FWD_TOL, "hidden")
  else:
    _close(head.detach().numpy(), ref_head, FWD_TOL, "logits")
  if ref_aux is None:
    assert aux is None
  else:
    np.testing.assert_array_equal(aux.numpy(), np.asarray(ref_aux))
  np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                             rtol=FWD_TOL)
  flat = convert._flatten({"params": jax.device_get(ref_grads)})
  grads = _flax_grads_of(module)
  assert len(grads) == len(list(module.parameters()))
  for (path, index), g in grads.items():
    _close(g, _jax_leaf(flat, path, index), GRAD_TOL,
           "/".join(path) + f"[{index}]")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "loop"])
@pytest.mark.parametrize("impl", ["tiled", "flash"])
def test_forward_loss_and_grads_match_jax(impl, scan, fused):
  tokens, labels = _batch(2, seed=1)
  _check_against_jax(impl, scan, fused, tokens, labels, seed=2)


@pytest.mark.parametrize("impl", ["tiled", "flash"])
def test_packed_batch_matches_jax(impl):
  """The (B, 3, T) input: segment-masked attention, per-document positions
  and the token weights of the loss."""
  tokens, labels = _batch(2, seed=3, packed=True)
  _check_against_jax(impl, True, True, tokens, labels, seed=4)


def test_flash_module_launches_no_kernel_on_the_cpu():
  tokens, labels = _batch(2, seed=5)
  jmodule = _jax_module("flash", True, True)
  variables = jax.device_get(jmodule.init(jax.random.PRNGKey(0),
                                          jnp.asarray(tokens)))
  module = _port_module("flash", True, True, variables)
  before = dict(fa.LAUNCHES)
  _, pm = _models()
  pm.loss_function(module(torch.from_numpy(tokens)),
                   torch.from_numpy(labels)).backward()
  assert fa.LAUNCHES == before


def test_three_sgd_steps_with_weight_decay_match_jax():
  tokens, labels = _batch(2, seed=6)
  jmodule = _jax_module("flash", True, True)
  variables = jax.device_get(jmodule.init(jax.random.PRNGKey(7),
                                          jnp.asarray(tokens)))
  jm, pm = _models()
  lr, wd = 0.05, 1e-3
  tx = jax_optimizers.get_optimizer(jax_params.make_params(optimizer="sgd"),
                                    lr)

  def loss_fn(params):
    out = jmodule.apply({"params": params}, jnp.asarray(tokens))
    base = jm.loss_function(BuildNetworkResult(logits=out),
                            jnp.asarray(labels))
    return base + wd * jax_train_step.l2_loss(params)

  @jax.jit
  def step(params, opt_state):
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss

  params, opt_state = variables["params"], None
  opt_state = tx.init(params)
  jax_losses = []
  for _ in range(3):
    params, opt_state, loss = step(params, opt_state)
    jax_losses.append(float(loss))

  module = _port_module("flash", True, True, variables)
  opt = port_optimizers.get_optimizer(port_params.make_params(), module.parameters())
  train = port_train_step.TrainStep(pm, module, opt, lambda s: lr, wd)
  port_losses = [float(train(torch.from_numpy(tokens),
                             torch.from_numpy(labels))["total_loss"])
                 for _ in range(3)]
  np.testing.assert_allclose(port_losses, jax_losses, rtol=FWD_TOL)
  assert port_losses[-1] < port_losses[0]
  init = convert._flatten(variables)
  final = convert._flatten({"params": jax.device_get(params)})
  for key, p in module.named_parameters():
    path, kind, index = convert.flax_source(key, p, module)
    p0 = _jax_leaf(init, path, index)
    d_ref = _jax_leaf(final, path, index) - p0
    d_got = convert.to_flax_layout(p.detach().numpy(), kind) - p0
    _close(d_got, d_ref, GRAD_TOL, key)


def test_every_parameter_is_weight_decayed_as_in_jax():
  """No LM parameter path contains "bn": L2 covers all of them, as the JAX
  filter does."""
  tokens, _ = _batch(1, seed=8)
  variables = jax.device_get(_jax_module("tiled", True, True).init(
      jax.random.PRNGKey(0), jnp.asarray(tokens)))
  module = _port_module("tiled", True, True, variables)
  assert not any(port_train_step.is_batch_norm_param(k)
                 for k, _ in module.named_parameters())
  np.testing.assert_allclose(
      float(port_train_step.l2_loss(module).detach()),
      float(jax_train_step.l2_loss(variables["params"])), rtol=FWD_TOL)


def test_registered_with_the_published_shape():
  model = model_config.get_model_config("transformer_lm")
  ref = jax_lm.TransformerLMModel()
  assert model.get_name() == "transformer_lm"
  assert model.get_input_shapes("train") == [[8, 2048], [8, 2048]] == \
      ref.get_input_shapes("train")
  assert model.get_learning_rate(0, 8) == ref.get_learning_rate(0, 8) == 0.05
  assert (port_lm.VOCAB, port_lm.SEQ_LEN, port_lm.D_MODEL, port_lm.N_LAYERS,
          port_lm.N_HEADS, port_lm.D_FF) == (
              jax_lm.VOCAB, jax_lm.SEQ_LEN, jax_lm.D_MODEL, jax_lm.N_LAYERS,
              jax_lm.N_HEADS, jax_lm.D_FF)
  gen = torch.Generator().manual_seed(0)
  tokens, labels = model.get_synthetic_inputs(gen, 0, torch.device("cpu"))
  assert tokens.shape == (8, 2048) and int(tokens.max()) < port_lm.VOCAB
  assert torch.equal(labels, torch.roll(tokens, -1, dims=1))


@pytest.mark.parametrize("name,value", [
    ("KF_TRANSFORMER_LM_ATTN", "bogus"), ("KF_TRANSFORMER_LM_HEAD", "bogus"),
    ("KF_TRANSFORMER_LM_LAYERS", "bogus")])
def test_make_module_rejects_unknown_switch_values(monkeypatch, name, value):
  monkeypatch.setenv(name, value)
  with pytest.raises(ValueError, match=name):
    port_lm.TransformerLMModel().make_module(0)


@pytest.mark.parametrize("overrides,match", [
    ({"model": "resnet50", "attn_block": 256}, "no attention blocks"),
    ({"model": "transformer_lm", "attn_block": 300}, "must divide"),
])
def test_validation_rejects_attn_block_misuse(overrides, match):
  with pytest.raises(validation.ParamError, match=match):
    validation.validate_cross_flags(
        port_params.make_params(device="cpu", **overrides))


def test_validation_flash_on_the_card_needs_bf16(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  params = port_params.make_params(model="transformer_lm", attn_block=256)
  monkeypatch.setenv("KF_TRANSFORMER_LM_ATTN", "flash")
  with pytest.raises(validation.ParamError, match="flash-attention"):
    validation.validate_cross_flags(params)
  monkeypatch.setenv("KF_TRANSFORMER_LM_ATTN", "tiled")
  validation.validate_cross_flags(params)  # plain ops run in f32


def test_cli_runs_a_small_lm_on_the_cpu(monkeypatch, capsys):
  for name, value in (("VOCAB", VOCAB), ("SEQ_LEN", T), ("D_MODEL", D),
                      ("N_LAYERS", LAYERS), ("N_HEADS", HEADS),
                      ("D_FF", DFF)):
    monkeypatch.setattr(port_lm, name, value)
  monkeypatch.setenv("KF_TRANSFORMER_LM_ATTN", "flash")
  rc = cli.main(["--model=transformer_lm", "--device=cpu", "--batch_size=2",
                 "--num_batches=2", "--num_warmup_batches=1",
                 "--display_every=1", "--attn_block=16"])
  assert rc == 0
  out = capsys.readouterr().out.splitlines()
  assert "Dataset:     token stream (synthetic)" in out
  steps = [line for line in out
           if re.match(r"^\d+\timages/sec: \d+\.\d .*\t\d+\.\d{3}$", line)]
  assert len(steps) == 2
  # Untrained: the cross-entropy is near ln(vocab).
  assert abs(float(steps[0].split("\t")[-1]) - np.log(VOCAB)) < 1.0
