"""MobileNet v2 (Sandler et al., arXiv:1801.04381): the port's counterpart
of kf_benchmarks_tpu/models/mobilenet_v2.py, 224x224 input, default batch
32, rate 0.005.

The JAX package interprets the V2 architecture table (``V2_DEF``) into flax
submodules named by flax's counters (``Conv_<i>``, ``BatchNorm_<i>``,
``Dense_0``); ``MobilenetV2`` registers its layers under the same names in
the same order, so convert.py maps the two trees one to one. An inverted
residual is a 1x1 expansion (skipped at expansion 1), a 3x3 depthwise conv
(a grouped ``F.conv2d``, groups = channels) and a linear 1x1 projection,
each followed by a batch norm with scale (decay 0.997, epsilon 1e-3), the
first two by ReLU6; a stride-1 block whose width is unchanged adds its
input. Then the spatial mean, dropout (keep 0.8, training only) and the
classifier. The depthwise convs are not 3x3 convs over all channels, so
none takes the fused BN-ReLU-conv3x3 unit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model as model_lib
from kf_benchmarks_tpu_torch.ops.conv_bn import accum


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
  """Round channel counts to a multiple of ``divisor`` without dropping
  more than 10% (mobilenet_v2.py:28-37 of the JAX package)."""
  if min_value is None:
    min_value = divisor
  new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
  if new_v < 0.9 * v:
    new_v += divisor
  return new_v


@dataclasses.dataclass(frozen=True)
class OpSpec:
  """One row of the architecture table: 'conv' is a full conv,
  'expanded_conv' an inverted-residual bottleneck with the given expansion
  factor."""
  op: str
  num_outputs: int
  stride: int = 1
  expansion: int = 6
  kernel: int = 3


# (mobilenet_v2.py:53-74 of the JAX package)
V2_DEF: Tuple[OpSpec, ...] = (
    OpSpec("conv", 32, stride=2),
    OpSpec("expanded_conv", 16, expansion=1),
    OpSpec("expanded_conv", 24, stride=2),
    OpSpec("expanded_conv", 24),
    OpSpec("expanded_conv", 32, stride=2),
    OpSpec("expanded_conv", 32),
    OpSpec("expanded_conv", 32),
    OpSpec("expanded_conv", 64, stride=2),
    OpSpec("expanded_conv", 64),
    OpSpec("expanded_conv", 64),
    OpSpec("expanded_conv", 64),
    OpSpec("expanded_conv", 96),
    OpSpec("expanded_conv", 96),
    OpSpec("expanded_conv", 96),
    OpSpec("expanded_conv", 160, stride=2),
    OpSpec("expanded_conv", 160),
    OpSpec("expanded_conv", 160),
    OpSpec("expanded_conv", 320),
    OpSpec("conv", 1280, kernel=1),
)


class MobilenetV2(builder.SeededDropout, nn.Module):
  """V2_DEF as a network: NHWC images -> f32 logits."""

  def __init__(self, nclass: int, dtype: torch.dtype,
               generator: Optional[torch.Generator] = None,
               depth_multiplier: float = 1.0,
               dropout_keep_prob: float = 0.8):
    super().__init__()
    self.dtype = dtype
    self.keep_prob = dropout_keep_prob
    self.counts = {"Conv": 0, "BatchNorm": 0}
    # (kind, layer names, residual) per row: "conv" -> (conv, bn),
    # "expanded" -> ((conv, bn) for expansion, depthwise, projection).
    self.plan = []
    g = generator
    c = 3
    for spec in V2_DEF:
      out = make_divisible(spec.num_outputs * depth_multiplier)
      if spec.op == "conv":
        self.plan.append(("conv", [self._layer(c, out, spec.kernel,
                                               spec.stride, 1, g)], False))
      else:
        expanded = c * spec.expansion
        layers = []
        if spec.expansion != 1:
          layers.append(self._layer(c, expanded, 1, 1, 1, g))
        layers.append(self._layer(expanded, expanded, spec.kernel,
                                  spec.stride, expanded, g))
        layers.append(self._layer(expanded, out, 1, 1, 1, g))
        self.plan.append(("expanded", layers,
                          spec.stride == 1 and out == c))
      c = out
    self.Dense_0 = nn.Linear(c, nclass)
    with torch.no_grad():
      std = math.sqrt(1.0 / c)
      nn.init.trunc_normal_(self.Dense_0.weight, 0.0, std, -2 * std,
                            2 * std, generator=g)
      self.Dense_0.bias.zero_()
    self.seed_dropout(g)

  def _layer(self, cin, cout, k, stride, groups, g):
    conv = f"Conv_{self.counts['Conv']}"
    bn = f"BatchNorm_{self.counts['BatchNorm']}"
    self.counts["Conv"] += 1
    self.counts["BatchNorm"] += 1
    self.add_module(conv, builder.Conv(
        cin, cout, k, stride, "SAME", generator=g, groups=groups,
        stddev=math.sqrt(groups / (k * k * cin))))
    self.add_module(bn, builder.CompactBatchNorm(cout, 0.997, 1e-3,
                                                 use_scale=True))
    return conv, bn

  def _layer_forward(self, x, layer, activation):
    conv, bn = layer
    return builder.activate(getattr(self, bn)(getattr(self, conv)(x)),
                            activation)

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    self.begin_draws()
    x = model_lib.to_model_input(images, self.dtype)
    for kind, layers, residual in self.plan:
      if kind == "conv":
        x = self._layer_forward(x, layers[0], "relu6")
        continue
      h = x
      for layer in layers[:-1]:
        h = self._layer_forward(h, layer, "relu6")
      h = self._layer_forward(h, layers[-1], None)
      x = h + x if residual else h
    x = builder.spatial_mean(x)
    if self.training and self.keep_prob < 1.0:
      x = builder.dropout(x, self.keep_prob, self.uniform(x.shape, x.device))
    w = self.Dense_0.weight.to(x.dtype)
    return accum(torch.nn.functional.linear(x, w,
                                            self.Dense_0.bias.to(x.dtype)))


class MobilenetModel(model_lib.CNNModel):
  """(mobilenet_v2.py:168-189 of the JAX package)"""

  def __init__(self, params=None, depth_multiplier: float = 1.0):
    super().__init__("mobilenet", 224, 32, 0.005, params=params)
    self.depth_multiplier = depth_multiplier

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    return MobilenetV2(nclass, dtype, generator,
                       self.depth_multiplier).to(
                           memory_format=torch.channels_last)


def create_mobilenet_model(params=None):
  return MobilenetModel(params=params)
