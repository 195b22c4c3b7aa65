"""Trivial MLP smoke-test model (trivial_model.py of the JAX package)."""

from __future__ import annotations

import torch
import torch.nn as nn

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model
from kf_benchmarks_tpu_torch.ops.conv_bn import accum


class TrivialNet(nn.Module):
  """Flatten -> 1-unit bottleneck -> 4096 hidden -> logits."""

  def __init__(self, image_size: int, nclass: int, dtype: torch.dtype,
               generator=None):
    super().__init__()
    self.dtype = dtype
    self.affine0 = builder.Affine(image_size * image_size * 3, 1,
                                  generator=generator)
    self.affine1 = builder.Affine(1, 4096, generator=generator)
    self.affine2 = builder.Affine(4096, nclass, activation="linear",
                                  generator=generator)

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    x = images.to(self.dtype)
    return accum(self.affine2(self.affine1(self.affine0(x))))


class TrivialModel(model.CNNModel):

  def __init__(self, params=None):
    super().__init__("trivial", 224 + 3, 32, 0.005, params=params)

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    return TrivialNet(self.image_size, nclass, dtype, generator)


class TrivialCifar10Model(TrivialModel):
  """The trivial model at CIFAR-10's 32x32 (trivial_model.py:18-27 of the
  JAX package)."""

  data_name = "cifar10"

  def __init__(self, params=None):
    super().__init__(params)
    self.image_size = 32
