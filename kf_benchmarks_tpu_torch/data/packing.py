"""Packed sequences: per-token loss weights and the serving prompt packer.

The port's own copy of the parts of kf_benchmarks_tpu/data/packing.py that
its paths use: ``token_weights_from_segments`` (:56), the one derivation of
the weights the LM's loss and metrics apply to a packed (B, 3, T) batch of
[tokens, segment_ids, positions]; ``sample_document_lengths`` (:78), the
clipped-lognormal length draw; and ``pack_prompts`` (:197) with the part of
``_materialize`` (:120) it needs, which first-fit packs serving prompts into
one batch for the engine's prefill. The packer functions take and return
numpy, and give the JAX package's outputs for the same inputs. The training
packer stream (``PackedBatchStream``) and ``--packed_sequences`` are not
ported yet.

Conventions (as in the JAX package): segment ids are 1-based per row in
placement order with 0 = padding; documents are never split; positions
restart at 0 at each document start; padding sits at the row tail.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# Clipped-lognormal document-length defaults (packing.py:51-52).
DEFAULT_MEAN_FRACTION = 0.4
DEFAULT_SIGMA = 0.8


def token_weights_from_segments(segment_ids: torch.Tensor) -> torch.Tensor:
  """1.0 where a slot holds a real token whose next slot continues the same
  document (it has an in-document next-token label), else 0.0: padding
  (id 0), each document's final token and the row's last slot weigh 0.
  (..., T) integer ids -> (..., T) f32."""
  seg = segment_ids
  nxt = torch.cat([seg[..., 1:], torch.zeros_like(seg[..., :1])], dim=-1)
  return ((seg != 0) & (nxt == seg)).float()


def sample_document_lengths(rng: np.random.Generator, n: int, seq_len: int,
                            mean_fraction: float = DEFAULT_MEAN_FRACTION,
                            sigma: float = DEFAULT_SIGMA) -> np.ndarray:
  """``n`` document lengths from a lognormal with median
  ``mean_fraction * seq_len``, clipped to [1, seq_len] (clipping keeps the
  number of draws from ``rng`` fixed)."""
  mu = np.log(max(mean_fraction * seq_len, 1.0))
  lengths = np.exp(rng.normal(mu, sigma, size=n))
  return np.clip(lengths.astype(np.int64), 1, seq_len)


def _materialize_images(rows: List[List[np.ndarray]], batch_size: int,
                        seq_len: int) -> np.ndarray:
  """The (batch_size, 3, seq_len) int32 [tokens, segment_ids, positions]
  stack of packed rows (``_materialize`` without the labels)."""
  images = np.zeros((batch_size, 3, seq_len), np.int32)
  for r, docs in enumerate(rows):
    off = 0
    for s, doc in enumerate(docs, start=1):
      ln = len(doc)
      images[r, 0, off:off + ln] = doc
      images[r, 1, off:off + ln] = s
      images[r, 2, off:off + ln] = np.arange(ln)
      off += ln
  return images


def pack_prompts(prompts: Sequence[np.ndarray], seq_len: int,
                 batch_size: int
                 ) -> Tuple[np.ndarray, List[Optional[Tuple[int, int]]]]:
  """First-fit placement of serving prompts into ONE packed
  ``(batch_size, 3, seq_len)`` batch, in prompt order. Returns
  ``(images, placements)``: ``placements[i]`` is ``(row, offset)`` for
  prompt ``i``, or None when it did not fit this batch (the engine
  re-queues those). A prompt longer than ``seq_len`` raises."""
  rows: List[List[int]] = []
  placements: List[Optional[Tuple[int, int]]] = [None] * len(prompts)
  remaining: List[int] = []
  for i, doc in enumerate(prompts):
    doc = np.asarray(doc)
    if doc.ndim != 1 or doc.size < 1:
      raise ValueError("prompts must be non-empty 1-D token arrays")
    if doc.size > seq_len:
      raise ValueError(
          f"prompt of {doc.size} tokens exceeds the {seq_len}-token "
          "context; prompts are never split")
    row = next((r for r in range(len(rows))
                if remaining[r] >= doc.size), None)
    if row is None:
      if len(rows) >= batch_size:
        continue  # does not fit this batch; placement stays None
      rows.append([])
      remaining.append(seq_len)
      row = len(rows) - 1
    placements[i] = (row, seq_len - remaining[row])
    rows[row].append(i)
    remaining[row] -= doc.size
  images = _materialize_images(
      [[np.asarray(prompts[i]) for i in docs] for docs in rows], batch_size,
      seq_len)
  return images, placements
