"""Per-token loss weights of packed sequences.

The port's own copy of kf_benchmarks_tpu/data/packing.py
``token_weights_from_segments`` (:56), the one derivation of the weights
the LM's loss and metrics apply to a packed (B, 3, T) batch of
[tokens, segment_ids, positions]. The host packer stream
(``PackedBatchStream``) and the ``--packed_sequences`` flag are not ported
yet.
"""

from __future__ import annotations

import torch


def token_weights_from_segments(segment_ids: torch.Tensor) -> torch.Tensor:
  """1.0 where a slot holds a real token whose next slot continues the same
  document (it has an in-document next-token label), else 0.0: padding
  (id 0), each document's final token and the row's last slot weigh 0.
  (..., T) integer ids -> (..., T) f32."""
  seg = segment_ids
  nxt = torch.cat([seg[..., 1:], torch.zeros_like(seg[..., :1])], dim=-1)
  return ((seg != 0) & (nxt == seg)).float()
