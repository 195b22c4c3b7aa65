"""Chunked fused LM-head cross-entropy and top-k accuracy.

The port's counterpart of kf_benchmarks_tpu/ops/fused_loss.py: the loss and
the metrics are computed from (hidden, head kernel) one sequence chunk at a
time, so no (B, T, V) logits tensor exists. Each chunk's head product, f32
log-softmax and label gather run under ``torch.utils.checkpoint``, so the
backward recomputes a chunk's logits instead of keeping every chunk's (the
JAX package's ``jax.checkpoint`` on its scan body). The per-chunk head
product is ``torch.matmul``, as the JAX package leaves it to XLA.

``weights`` (B, T) (data/packing.py ``token_weights_from_segments``) scales
each slot's log-likelihood and normalises by the real-token count; None
keeps the unweighted mean.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from kf_benchmarks_tpu_torch.ops.conv_bn import accum


class FusedLMHead(NamedTuple):
  """A model head deferred into the loss: final hidden states plus the
  unembedding kernel, in place of logits."""
  hidden: Any  # (B, T, D) final hidden states in the compute dtype
  kernel: Any  # (D, V) unembedding matrix in the parameter dtype


def chunk_of(t: int, limit: int) -> int:
  """Largest divisor of ``t`` within ``limit``."""
  return max(c for c in range(1, min(limit, t) + 1) if t % c == 0)


def _logits(hidden, kernel):
  return hidden if kernel is None else hidden @ kernel


def _chunk_log_likelihood(hidden, kernel, labels, weights):
  """Sum over one chunk of the (weighted) label log-probabilities."""
  logp = F.log_softmax(accum(_logits(hidden, kernel)), dim=-1)
  ll = logp.gather(-1, labels[..., None])[..., 0]
  if weights is not None:
    ll = ll * weights
  return ll.sum()


def fused_softmax_xent(hidden, kernel, labels, chunk_size: int = 256,
                       weights=None):
  """Mean next-token NLL from (hidden, kernel), one chunk of ``chunk_size``
  positions (or the largest divisor of T below it) at a time. The head
  product runs in hidden's dtype; the softmax in f32. ``kernel`` None: the
  dense head, ``hidden`` are the logits."""
  b, t, _ = hidden.shape
  chunk = chunk_of(t, chunk_size)
  kernel = None if kernel is None else kernel.to(hidden.dtype)
  labels = labels.long()
  acc_dtype = torch.float64 if hidden.dtype == torch.float64 else \
      torch.float32
  w = None if weights is None else weights.to(acc_dtype)
  total = None
  for i in range(0, t, chunk):
    ww = None if w is None else w[:, i:i + chunk]
    part = checkpoint.checkpoint(_chunk_log_likelihood,
                                 hidden[:, i:i + chunk], kernel,
                                 labels[:, i:i + chunk], ww,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
    total = part if total is None else total + part
  return -total / (b * t if w is None else torch.clamp(w.sum(), min=1.0))


def fused_top_k_accuracy(hidden, kernel, labels, chunk_size: int = 256,
                         weights=None):
  """top-1 / top-5 fractions from (hidden, kernel), a chunk at a time
  (``kernel`` None: ``hidden`` are the logits)."""
  b, t, _ = hidden.shape
  chunk = chunk_of(t, chunk_size)
  kernel = None if kernel is None else kernel.to(hidden.dtype)
  labels = labels.long()
  n1 = n5 = 0.0
  with torch.no_grad():
    for i in range(0, t, chunk):
      lg = _logits(hidden[:, i:i + chunk], kernel)
      yy = labels[:, i:i + chunk]
      hit1 = (lg.argmax(-1) == yy).float()
      hit5 = (lg.topk(5, dim=-1).indices == yy[..., None]).any(-1).float()
      if weights is not None:
        ww = weights[:, i:i + chunk].float()
        hit1, hit5 = hit1 * ww, hit5 * ww
      n1 = n1 + hit1.sum()
      n5 = n5 + hit5.sum()
    denom = (float(b * t) if weights is None else
             torch.clamp(weights.float().sum(), min=1.0))
  return {"top_1_accuracy": n1 / denom, "top_5_accuracy": n5 / denom}
