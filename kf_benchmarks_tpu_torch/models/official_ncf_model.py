"""NCF (NeuMF; He et al., arXiv:1708.05031): the port's counterpart of
kf_benchmarks_tpu/models/official_ncf_model.py, the ml-20m sizes (138493
users, 26744 items), batch 2048, rate 0.0005.

A GMF branch (the elementwise product of 64-wide user and item
embeddings) and an MLP branch (the 128-wide user and item embeddings
concatenated, then dense layers of 256, 128 and 64 with ReLU) meet in one
dense layer to a single logit. The layers carry flax's names
(``mf_user_embedding`` ... ``mlp_item_embedding``, ``Dense_0`` ..
``Dense_3``), so convert.py maps them one to one.

The (user, item) id pair rides the images' slot as an int32 [batch, 2]
tensor. Nothing casts it: the network reads the ids as they come (the
float inputs' cast to the compute dtype would merge ids above 2^8 under
bf16), gathers the f32 embedding rows and casts the rows to the compute
dtype (flax's ``Embed(dtype=...)`` casts the table first: the same
values).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model as model_lib
from kf_benchmarks_tpu_torch.ops.conv_bn import accum

NUM_USERS_20M = 138493
NUM_ITEMS_20M = 26744
# flax's lecun_normal: a normal of variance 1 / fan_in cut at two standard
# deviations, its scale corrected for the cut.
_TRUNC_CORRECTION = 0.87962566103423978


class Embedding(nn.Module):
  """A flax ``nn.Embed``: ``embedding`` [num, features], its default
  init a normal of variance 1 / features."""

  def __init__(self, num: int, features: int,
               generator=None):
    super().__init__()
    self.embedding = nn.Parameter(torch.empty(num, features))
    with torch.no_grad():
      self.embedding.normal_(0.0, math.sqrt(1.0 / features),
                             generator=generator)

  def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(ids, self.embedding).to(dtype)


class NeuMF(nn.Module):
  """(user, item) ids [N, 2] -> f32 logits [N, 1]."""

  def __init__(self, dtype: torch.dtype, num_users: int = NUM_USERS_20M,
               num_items: int = NUM_ITEMS_20M, mf_dim: int = 64,
               model_layers=(256, 256, 128, 64), generator=None):
    super().__init__()
    self.dtype = dtype
    g = generator
    mlp_dim = model_layers[0] // 2
    self.mf_user_embedding = Embedding(num_users, mf_dim, g)
    self.mf_item_embedding = Embedding(num_items, mf_dim, g)
    self.mlp_user_embedding = Embedding(num_users, mlp_dim, g)
    self.mlp_item_embedding = Embedding(num_items, mlp_dim, g)
    width = model_layers[0]
    self.tower = []
    for i, out in enumerate(model_layers[1:]):
      self.add_module(f"Dense_{i}", self._dense(width, out, "relu", g))
      self.tower.append(f"Dense_{i}")
      width = out
    self.head = f"Dense_{len(model_layers) - 1}"
    self.add_module(self.head, self._dense(mf_dim + width, 1, None, g))

  @staticmethod
  def _dense(cin, cout, activation, g):
    return builder.Affine(cin, cout, activation, generator=g,
                          stddev=math.sqrt(1.0 / cin) / _TRUNC_CORRECTION)

  def forward(self, user_item: torch.Tensor) -> torch.Tensor:
    ids = user_item.to(torch.int64)
    users, items = ids[:, 0], ids[:, 1]
    gmf = (self.mf_user_embedding(users, self.dtype) *
           self.mf_item_embedding(items, self.dtype))
    x = torch.cat([self.mlp_user_embedding(users, self.dtype),
                   self.mlp_item_embedding(items, self.dtype)], dim=-1)
    for name in self.tower:
      x = getattr(self, name)(x)
    return accum(getattr(self, self.head)(torch.cat([gmf, x], dim=-1)))


class NcfModel(model_lib.Model):
  """(official_ncf_model.py:67-106 of the JAX package)"""

  def __init__(self, params=None):
    super().__init__("official_ncf", 2048, 0.0005, params=params)

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    del nclass
    return NeuMF(dtype, generator=generator)

  def get_input_shapes(self, subset):
    del subset
    n = self.get_batch_size()
    return [[n, 2], [n]]

  def get_synthetic_inputs(self, generator: torch.Generator, nclass: int,
                           device: torch.device):
    """Uniform user and item ids (int32) and 0/1 labels."""
    del nclass
    n = self.get_batch_size()
    users = torch.randint(0, NUM_USERS_20M, (n,), generator=generator,
                          device=device, dtype=torch.int32)
    items = torch.randint(0, NUM_ITEMS_20M, (n,), generator=generator,
                          device=device, dtype=torch.int32)
    labels = torch.randint(0, 2, (n,), generator=generator, device=device)
    return torch.stack([users, items], dim=1), labels

  def loss_function(self, logits, labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy written as the reference writes it: a softmax
    over [1, logit] (official_ncf_model.py:92-99, kept for parity)."""
    logits = accum(logits)
    two_col = torch.cat([torch.ones_like(logits), logits], dim=1)
    onehot = F.one_hot(labels.long(), 2).to(two_col.dtype)
    return torch.mean(-torch.sum(onehot * F.log_softmax(two_col, -1), -1))

  def accuracy_function(self, logits, labels: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """A logit above the ones column's 1.0 predicts 1
    (official_ncf_model.py:101-106)."""
    pred = (logits[:, 0] > 1.0).to(torch.int64)
    acc = (pred == labels.long()).float().mean()
    return {"top_1_accuracy": acc, "top_5_accuracy": torch.ones_like(acc)}


def create_ncf_model(params=None):
  return NcfModel(params=params)
