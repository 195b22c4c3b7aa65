"""The port's chunked LM-head loss and metrics against the JAX package's.

``ops/fused_loss.py`` (loss from (hidden, kernel) one sequence chunk at a
time under torch.utils.checkpoint) against kf_benchmarks_tpu/ops/
fused_loss.py on the CPU in f32, from one set of numpy inputs, with and
without packed-sequence weights. Tolerances: 1e-5 relative for the loss,
1e-4 of the largest magnitude for gradients (sums in other orders); the
top-k fractions are counts and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.data import packing as jax_packing
from kf_benchmarks_tpu.ops import fused_loss as jax_fl
from kf_benchmarks_tpu_torch.data import packing as port_packing
from kf_benchmarks_tpu_torch.ops import fused_loss as port_fl

torch.set_num_threads(2)

B, T, D, V = 2, 48, 16, 40


def _inputs(seed):
  rng = np.random.default_rng(seed)
  hidden = rng.normal(size=(B, T, D)).astype(np.float32)
  kernel = (rng.normal(size=(D, V)) * 0.5).astype(np.float32)
  labels = rng.integers(0, V, (B, T)).astype(np.int32)
  seg = np.zeros((B, T), np.int32)
  seg[0, :20], seg[0, 20:41] = 1, 2
  seg[1, :33] = 1
  return hidden, kernel, labels, seg


def test_chunk_of_matches_jax():
  for t in (1, 7, 48, 64, 2048, 2047):
    for limit in (1, 16, 256):
      assert port_fl.chunk_of(t, limit) == jax_fl.chunk_of(t, limit)


def test_token_weights_match_jax():
  _, _, _, seg = _inputs(0)
  np.testing.assert_array_equal(
      port_packing.token_weights_from_segments(torch.from_numpy(seg)).numpy(),
      jax_packing.token_weights_from_segments(seg))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("chunk", [16, 256])
def test_loss_and_gradients_match_jax(weighted, chunk):
  hidden, kernel, labels, seg = _inputs(1)
  w = jax_packing.token_weights_from_segments(seg) if weighted else None

  def jax_loss(h, k):
    return jax_fl.fused_softmax_xent(h, k, jnp.asarray(labels),
                                     chunk_size=chunk,
                                     weights=None if w is None else
                                     jnp.asarray(w))

  ref, (gh_ref, gk_ref) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
      jnp.asarray(hidden), jnp.asarray(kernel))
  h = torch.from_numpy(hidden).requires_grad_()
  k = torch.from_numpy(kernel).requires_grad_()
  loss = port_fl.fused_softmax_xent(
      h, k, torch.from_numpy(labels), chunk_size=chunk,
      weights=None if w is None else torch.from_numpy(w))
  gh, gk = torch.autograd.grad(loss, (h, k))
  np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
  for got, want in ((gh, gh_ref), (gk, gk_ref)):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_dense_head_logits_match_the_fused_head():
  """kernel None: the loss reduces given logits chunk-wise, the JAX
  model's dense-head path; equal to the fused head on the same logits."""
  hidden, kernel, labels, _ = _inputs(2)
  logits = torch.from_numpy(hidden) @ torch.from_numpy(kernel)
  y = torch.from_numpy(labels)
  dense = port_fl.fused_softmax_xent(logits, None, y, chunk_size=16)
  fused = port_fl.fused_softmax_xent(torch.from_numpy(hidden),
                                     torch.from_numpy(kernel), y,
                                     chunk_size=16)
  np.testing.assert_allclose(float(dense), float(fused), rtol=1e-6)
  ref = jax_fl.monolithic_softmax_xent(jnp.asarray(hidden),
                                       jnp.asarray(kernel),
                                       jnp.asarray(labels), chunk_size=16)
  np.testing.assert_allclose(float(dense), float(ref), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_top_k_accuracy_matches_jax(weighted):
  hidden, kernel, labels, seg = _inputs(3)
  # Labels that are often in the top 5, so the fractions are not all 0.
  logits = hidden @ kernel
  labels = np.where(np.arange(T)[None, :] % 2 == 0, logits.argmax(-1),
                    labels).astype(np.int32)
  w = jax_packing.token_weights_from_segments(seg) if weighted else None
  ref = jax_fl.fused_top_k_accuracy(
      jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(labels),
      chunk_size=16, weights=None if w is None else jnp.asarray(w))
  got = port_fl.fused_top_k_accuracy(
      torch.from_numpy(hidden), torch.from_numpy(kernel),
      torch.from_numpy(labels), chunk_size=16,
      weights=None if w is None else torch.from_numpy(w))
  assert float(got["top_1_accuracy"]) > 0.4
  for key in ("top_1_accuracy", "top_5_accuracy"):
    np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-6)
