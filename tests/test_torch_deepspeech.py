"""DeepSpeech2 in the port (models/deepspeech.py, ops/ctc.py) against the
JAX package's (kf_benchmarks_tpu/models/deepspeech.py), on the CPU.

The JAX tests' small network (tests/test_speech_recsys.py ``_small_ds2``:
hidden 32, 2 RNN layers, 64 frames, batch 2, 8 labels; the convolutions,
the 161 bins and the 29 classes at full size) from one flax init,
converted, on one numpy batch:

* the forward's logits (within 1e-4 of their largest) and the batch-norm
  averages it updates (within 1e-6), for the LSTM, the GRU (both
  directions and one) and the tanh RNN;
* the loss and its gradients on a batch whose second row has more labels
  than CTC frames: optax's log-epsilon path gives ~1e5 there, where
  ``F.ctc_loss`` gives inf (or 0); the loss within 1e-6 relative, each
  recurrent and dense gradient within 1e-4 of its norm. The two
  convolutions' and their batch norms' gradients agree within 1e-2 of
  their norm only, and that spread is the JAX package's: against the
  port's own gradient in f64 the port's f32 gradient lies within 1e-5,
  JAX's ~1e-3 (its CPU convolutions' f32 rounding);
* the CTC loss alone against ``optax.ctc_loss``, value and gradient, on
  rows that align and rows that cannot;
* one SGD step with weight decay through both frameworks' train steps:
  the port's parameters are the JAX tree's, one for one (no LSTM input
  bias, no GRU hidden r and z bias, no simple-cell hidden bias trains),
  and the update within 1e-3 of its norm;
* the greedy decoder, WER, CER and ``postprocess`` on the same numbers;
* the bf16 drift: the port's bf16 logits lie no further from the JAX
  package's bf16 logits than those lie from JAX's own f32 logits, times 2,
  as tests/test_torch_zoo_bf16.py holds the zoo.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kf_benchmarks_tpu import learning_rate as jax_lr
from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu.models import deepspeech as jax_ds
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu.parallel import strategies as jax_strategies
from kf_benchmarks_tpu.parallel.mesh import build_mesh
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch.models import deepspeech as port_ds
from kf_benchmarks_tpu_torch.ops import ctc

torch.set_num_threads(2)

BATCH, FRAMES, LABELS, NCLASS = 2, 64, 8, 29
# Row 0 aligns (64 frames -> 16 CTC frames for 5 labels); row 1 cannot
# (20 frames -> 5 CTC frames for 8 labels).
INPUT_LENGTHS = np.array([64, 20])
LABEL_LENGTHS = np.array([5, 8])
CONV_PATH = ("Conv_0", "Conv_1", "BatchNorm_0", "BatchNorm_1")
CELLS = [("lstm", True), ("gru", True), ("gru", False), ("rnn", True)]


def _small(model, rnn_type="lstm", bidirectional=True):
  model.set_batch_size(BATCH)
  model.max_time_steps = FRAMES
  model.max_label_length = LABELS
  model.rnn_hidden_size = 32
  model.num_rnn_layers = 2
  model.rnn_type = rnn_type
  model.is_bidirectional = bidirectional
  return model


def _batch(seed=0):
  rng = np.random.RandomState(seed)
  spec = rng.rand(BATCH, FRAMES, 161, 1).astype(np.float32)
  labels = rng.randint(1, 28, (BATCH, LABELS)).astype(np.int32)
  return spec, (labels, INPUT_LENGTHS.astype(np.int32),
                LABEL_LENGTHS.astype(np.int32))


def _torch_labels(labels):
  return tuple(torch.from_numpy(np.asarray(t)).long() for t in labels)


def _pair(rnn_type="lstm", bidirectional=True, seed=0):
  """(jax model, jax module, flax variables, port model, port module)."""
  jm = _small(jax_ds.DeepSpeech2Model(), rnn_type, bidirectional)
  pm = _small(port_ds.DeepSpeech2Model(), rnn_type, bidirectional)
  spec, _ = _batch()
  jmod = jm.make_module(nclass=NCLASS, phase_train=True)
  variables = jax.device_get(jmod.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(spec)))
  net = pm.make_module(NCLASS)
  net.load_state_dict(convert.flax_to_state_dict(variables, net))
  return jm, jmod, variables, pm, net


def _jax_forward(jm, jmod, variables, spec, labels=None):
  def loss_fn(p):
    (logits, _), upd = jmod.apply(
        {"params": p, "batch_stats": variables["batch_stats"]},
        jnp.asarray(spec), mutable=["batch_stats"])
    loss = (jm.loss_function(BuildNetworkResult(logits=(logits, None)),
                             labels) if labels is not None else 0.0)
    return loss, (logits, upd["batch_stats"])
  (loss, (logits, stats)), grads = jax.value_and_grad(
      loss_fn, has_aux=True)(variables["params"])
  return float(loss), np.asarray(logits), jax.device_get(stats), \
      jax.device_get(grads)


@functools.lru_cache(maxsize=None)
def _jax_reference(rnn_type, bidirectional):
  """(flax variables, loss, logits, batch stats, gradients) of the JAX
  package's forward and loss on ``_batch()``, shared by the tests of one
  cell."""
  jm, jmod, variables, _, _ = _pair(rnn_type, bidirectional)
  spec, labels = _batch()
  return (variables,) + _jax_forward(jm, jmod, variables, spec, labels)


def _port(rnn_type, bidirectional, variables):
  pm = _small(port_ds.DeepSpeech2Model(), rnn_type, bidirectional)
  net = pm.make_module(NCLASS)
  net.load_state_dict(convert.flax_to_state_dict(variables, net))
  return pm, net


def _flat(tree):
  return convert._flatten(tree)


def _port_grads(net):
  state = dict(net.state_dict())
  state.update({k: p.grad for k, p in net.named_parameters()})
  return _flat(convert.state_dict_to_flax(state, net)["params"])


@pytest.mark.parametrize("rnn_type,bidirectional", CELLS)
def test_forward_and_batch_stats_match_jax(rnn_type, bidirectional):
  variables, _, jlogits, jstats, _ = _jax_reference(rnn_type, bidirectional)
  _, net = _port(rnn_type, bidirectional, variables)
  spec, _ = _batch()
  net.train()
  with torch.no_grad():
    logits = net(torch.from_numpy(spec)).numpy()
  assert logits.shape == jlogits.shape == (BATCH, FRAMES // 4, NCLASS)
  assert np.abs(logits - jlogits).max() <= 1e-4 * np.abs(jlogits).max()
  stats = _flat(convert.state_dict_to_flax(net.state_dict(),
                                           net)["batch_stats"])
  ref = _flat(jstats)
  assert set(stats) == set(ref)
  for key in ref:
    np.testing.assert_allclose(stats[key], ref[key], rtol=1e-6, atol=1e-6,
                               err_msg=str(key))


@pytest.mark.parametrize("rnn_type,bidirectional", CELLS)
def test_loss_and_gradients_match_jax(rnn_type, bidirectional):
  variables, jloss, _, _, jgrads = _jax_reference(rnn_type, bidirectional)
  pm, net = _port(rnn_type, bidirectional, variables)
  spec, labels = _batch()
  net.train()
  loss = pm.loss_function(net(torch.from_numpy(spec)),
                          _torch_labels(labels))
  loss.backward()
  # The impossible row's ~1e5 dominates the mean.
  assert jloss > 1e4
  np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
  grads, ref = _port_grads(net), _flat(jgrads)
  assert set(grads) == set(ref)
  for key in ref:
    tol = 1e-2 if key[0] in CONV_PATH else 1e-4
    err = np.linalg.norm(grads[key] - ref[key])
    assert err <= tol * np.linalg.norm(ref[key]), (key, err)


def test_conv_gradient_spread_is_the_jax_packages():
  """The port's f32 conv-path gradients against its own f64 evaluation:
  within 1e-5, where the JAX package's lie ~1e-3 off."""
  variables, *_, jgrads = _jax_reference("lstm", True)
  pm, net = _port("lstm", True, variables)
  spec, labels = _batch()
  net.train()
  pm.loss_function(net(torch.from_numpy(spec)),
                   _torch_labels(labels)).backward()
  net64 = pm.make_module(NCLASS, torch.float64).double()
  net64.load_state_dict({k: v.double() for k, v in
                         convert.flax_to_state_dict(variables, net).items()})
  net64.train()
  pm.loss_function(net64(torch.from_numpy(spec).double()),
                   _torch_labels(labels)).backward()
  got, truth, ref = _port_grads(net), _port_grads(net64), _flat(jgrads)
  jax_errs = []
  for key in truth:
    if key[0] in CONV_PATH:
      scale = np.linalg.norm(truth[key])
      assert np.linalg.norm(got[key] - truth[key]) <= 1e-5 * scale, key
      jax_errs.append(np.linalg.norm(ref[key] - truth[key]) / scale)
  assert max(jax_errs) > 1e-4


def _ctc_case(seed):
  rng = np.random.RandomState(seed)
  b, t, n = 5, 12, 8
  logits = (rng.randn(b, t, NCLASS) * 2).astype(np.float32)
  labels = rng.randint(1, 28, (b, n)).astype(np.int32)
  labels[0, 2] = labels[0, 1]  # a repeat: a blank must sit between
  inputs = np.array([12, 5, 9, 12, 3])  # rows 1 and 4 cannot align
  lengths = np.array([6, 8, 3, 8, 4])
  pad_t = (np.arange(t)[None] >= inputs[:, None]).astype(np.float32)
  pad_n = (np.arange(n)[None] >= lengths[:, None]).astype(np.float32)
  return logits, pad_t, labels, pad_n


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_matches_optax_on_aligned_and_impossible_rows(seed):
  logits, pad_t, labels, pad_n = _ctc_case(seed)

  def optax_loss(x):
    return optax.ctc_loss(x, pad_t, labels, pad_n,
                          blank_id=port_ds.BLANK_INDEX)

  ref = np.asarray(optax_loss(logits))
  ref_grad = np.asarray(jax.grad(lambda x: jnp.mean(optax_loss(x)))(logits))
  x = torch.tensor(logits, requires_grad=True)
  got = ctc.ctc_loss(x, torch.from_numpy(pad_t), torch.from_numpy(labels),
                     torch.from_numpy(pad_n), port_ds.BLANK_INDEX)
  got.mean().backward()
  assert ref[1] > 9e4 and ref[4] > 9e4  # optax's log-epsilon path
  assert np.isfinite(got.detach().numpy()).all()
  torch_ref = torch.nn.functional.ctc_loss(
      torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
      torch.from_numpy(labels).long(),
      torch.from_numpy((1 - pad_t).sum(1)).long(),
      torch.from_numpy((1 - pad_n).sum(1)).long(),
      blank=port_ds.BLANK_INDEX, reduction="none")
  assert torch.isinf(torch_ref[1]) and torch.isinf(torch_ref[4])
  np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6)
  # The f32 ulp of a 1e5 loss is 2^-7: the gradient of an impossible row,
  # exp(alpha - loss), carries it; the two recursions round alike.
  np.testing.assert_allclose(x.grad.numpy(), ref_grad, atol=1e-6)


def test_one_sgd_step_with_weight_decay_matches_jax():
  jm, jmod, variables, pm, net = _pair()
  spec, labels = _batch()
  flags = dict(optimizer="sgd", init_learning_rate=0.01, weight_decay=1e-3)
  p = jax_params.make_params(device="cpu", num_devices=1, **flags)
  lr_fn = jax_lr.make_learning_rate_fn(p, jm, BATCH, 1000)
  tx = jax_optimizers.get_optimizer(p, lr_fn)
  init_state, step, _, broadcast_init, _ = jax_train_step.make_step_fns(
      jm, jmod, jmod, jax_strategies.get_strategy(p), tx, lr_fn, p,
      build_mesh(1, "cpu"))
  stack = lambda tree: jax.tree.map(lambda a: jnp.asarray(a)[None], tree)
  state = init_state(jax.random.PRNGKey(0), jnp.asarray(spec[:1]))
  state = state.replace(params=broadcast_init(stack(variables["params"])),
                        batch_stats=stack(variables["batch_stats"]))
  state, _ = step(state, jnp.asarray(spec),
                  tuple(jnp.asarray(t) for t in labels))
  ref = _flat(convert.replica_variables(jax.device_get(state.params), 0))

  pp = port_params.make_params(device="cpu", **flags)
  opt = port_optimizers.get_optimizer(pp, net.parameters())
  tstep = port_train_step.TrainStep(
      pm, net, opt, port_lr.make_learning_rate_fn(pp, pm, BATCH, 1000),
      pp.weight_decay)
  tstep(torch.from_numpy(spec), _torch_labels(labels))
  got = _flat(convert.state_dict_to_flax(net.state_dict(), net)["params"])
  init = _flat(variables["params"])
  # One parameter for each leaf of the JAX tree, no more.
  assert set(got) == set(ref) == set(init)
  assert sum(q.numel() for q in net.parameters()) == sum(
      v.size for v in init.values())
  keys = sorted(ref)
  upd = np.concatenate([(got[k] - init[k]).ravel() for k in keys])
  ref_upd = np.concatenate([(ref[k] - init[k]).ravel() for k in keys])
  assert np.linalg.norm(ref_upd) > 0
  assert np.linalg.norm(upd - ref_upd) <= 1e-3 * np.linalg.norm(ref_upd)


def test_decoder_wer_cer_and_postprocess_match_jax():
  rng = np.random.RandomState(3)
  probs = rng.rand(4, 10, NCLASS).astype(np.float32)
  probs[:, ::3, port_ds.BLANK_INDEX] += 2.0
  targets = rng.randint(0, 29, (4, 7)).astype(np.int32)
  targets[:, 2] = 1  # a space: two words
  jd, pd = jax_ds.DeepSpeechDecoder(), port_ds.DeepSpeechDecoder()
  for i in range(4):
    assert pd.decode_logits(probs[i]) == jd.decode_logits(probs[i])
    assert pd.decode(targets[i]) == jd.decode(targets[i])
    a, b = pd.decode_logits(probs[i]), pd.decode(targets[i])
    assert pd.wer(a, b) == jd.wer(a, b) and pd.cer(a, b) == jd.cer(a, b)
  results = {"deepspeech2_prob": probs, "deepspeech2_label": targets}
  ref = jax_ds.DeepSpeech2Model().postprocess(dict(results))
  got = port_ds.DeepSpeech2Model().postprocess(dict(results))
  assert got["WER"] == ref["WER"] and got["CER"] == ref["CER"]
  assert 0 < got["CER"]


def test_bf16_drift_is_bf16s_own():
  jm, _, variables, pm, net = _pair()
  spec, _ = _batch()
  logits = {}
  for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
    jmod = jm.make_module(nclass=NCLASS, phase_train=True, dtype=dt)
    (lg, _), _ = jmod.apply(variables, jnp.asarray(spec),
                            mutable=["batch_stats"])
    logits["jax_" + name] = np.asarray(lg, np.float64).ravel()
  net16 = pm.make_module(NCLASS, torch.bfloat16)
  net16.load_state_dict(net.state_dict())
  for name, module in (("f32", net), ("bf16", net16)):
    module.train()
    with torch.no_grad():
      logits["port_" + name] = module(torch.from_numpy(spec)).double() \
          .numpy().ravel()
  rel = lambda a, b: np.linalg.norm(logits[a] - logits[b]) / \
      np.linalg.norm(logits[b])
  jax_drift = rel("jax_bf16", "jax_f32")
  assert jax_drift > 0
  assert rel("port_bf16", "jax_bf16") <= 2.0 * jax_drift
  assert rel("port_bf16", "jax_f32") <= 1.25 * jax_drift
