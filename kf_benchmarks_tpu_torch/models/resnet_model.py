"""ResNet-50/101/152, v1.5 and v2, for ImageNet, and the CIFAR-10
ResNets 20/32/44/56/110, v1 and v2.

The port's counterpart of kf_benchmarks_tpu/models/resnet_model.py (the
bottleneck at :27-78, the ImageNet network at :145-160, the per-model
batch sizes at :132-140, the learning rate at :171-184). v1.5 puts the
stride-2 of each stage's first block in its 3x3 conv; v2 (pre-activation)
does too, and runs each block as batch norm and ReLU first
(``_preact_bn``), convolutions without batch norm or bias between the
``_a_bn`` / ``_b_bn`` batch norms, an identity-or-projection shortcut added
without a ReLU, and ``final_bn`` + ReLU after the last block. The plain
names (``resnet50``, ``resnet101``, ``resnet152``) are v1.5, as in the JAX
package.

Every stride-1 ``conv_b`` (13 of ResNet-50's 16 3x3 convs, 30 of
ResNet-101's 33, 47 of ResNet-152's 50) runs, with the batch norm and ReLU
in front of it and the statistics of the batch norm behind it, as one
``FusedBnReluConv3x3`` unit (ops/conv_bn.py): on the card the hand-written
kernels K-B forward and K-A backward. In v2 that is ``relu(a_bn(a))`` in
front and ``b_bn`` behind, the same unit. Everything else -- the stem, the
stride-2 3x3s, the 1x1s and the other batch norms -- stays plain PyTorch
ops, as the JAX package leaves those to XLA.

The CIFAR-10 ResNets (:215-297 there; 32x32 input, batch 128, the rate
0.1 / 0.01 / 0.001 / 0.0002 at epochs 82, 123 and 300) are recorded
through builder.ConvNetBuilder with the JAX package's calls and names
(``conv_stem``, ``resblk<k>_a`` / ``_b`` / ``_shortcut`` with their
``_bn``, v2's ``resblk<k>_preact_bn`` and ``final_bn``, ``affine0``); so is
``bottleneck_block``, which official_resnet_model.py's networks use. A
basic block's second 3x3 conv takes the fused unit (ops/conv_bn.py) where
its channels allow, as the ImageNet bottleneck's does: in the CIFAR
ResNets that is every block of the 64-channel stage. v2's ``conv -> batch
norm -> ReLU`` before that conv (the JAX model's ``conv``,
``batch_norm(name + "_a_bn")``, relu) is recorded as one conv with its
batch norm, which has the same names and the same arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from kf_benchmarks_tpu_torch import learning_rate
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model
from kf_benchmarks_tpu_torch.ops import conv_bn

IMAGENET_NUM_TRAIN_IMAGES = 1281167

# Batch norm of every ResNet layer (resnet_model.py:155).
_BN = dict(momentum=0.9, epsilon=1e-5, use_scale=True)

# Per-model default batch sizes (resnet_model.py:132-140).
DEFAULT_BATCH_SIZES = {
    "resnet50": 64, "resnet101": 32, "resnet152": 32,
    "resnet50_v1.5": 64, "resnet101_v1.5": 32,
    "resnet50_v2": 64, "resnet101_v2": 32, "resnet152_v2": 32,
}


class Bottleneck(nn.Module):
  """Bottleneck: 1x1 -> 3x3 (stride here) -> 1x1, projection shortcut when
  the shape changes. v1.5: each conv followed by batch norm, ReLU after
  the add. v2: ``preact_bn`` + ReLU first, feeding the body and a
  projection shortcut; no batch norm after ``c`` or on the shortcut, no
  ReLU after the add."""

  def __init__(self, in_size: int, depth: int, depth_bottleneck: int,
               stride: int, generator: Optional[torch.Generator] = None,
               version: str = "v1.5"):
    super().__init__()
    g = generator
    self.v2 = version == "v2"
    if self.v2:
      self.preact_bn = builder.CompactBatchNorm(in_size, **_BN)
    if in_size != depth or stride != 1:
      self.shortcut = builder.Conv(in_size, depth, 1, stride, "SAME_RESNET",
                                   generator=g)
      self.shortcut_bn = (None if self.v2 else
                          builder.CompactBatchNorm(depth, **_BN))
    else:
      self.shortcut = self.shortcut_bn = None
    self.a = builder.Conv(in_size, depth_bottleneck, 1, 1, generator=g)
    self.a_bn = builder.CompactBatchNorm(depth_bottleneck, **_BN)
    self.b = builder.Conv(depth_bottleneck, depth_bottleneck, 3, stride,
                          "SAME_RESNET", generator=g)
    self.b_bn = builder.CompactBatchNorm(depth_bottleneck, **_BN)
    self.c = builder.Conv(depth_bottleneck, depth, 1, 1, generator=g)
    self.c_bn = None if self.v2 else builder.CompactBatchNorm(depth, **_BN)
    self.fused = builder.fusable_conv3x3(depth_bottleneck, depth_bottleneck,
                                         3, stride, "SAME_RESNET")

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    shortcut = x
    body = torch.relu(self.preact_bn(x)) if self.v2 else x
    if self.shortcut is not None:
      shortcut = self.shortcut(body)
      if self.shortcut_bn is not None:
        shortcut = self.shortcut_bn(shortcut)
    a = self.a(body)
    if self.fused:
      # relu(a_bn(a)) -> conv_b -> b_bn's statistics, in one unit.
      sc, sh = self.a_bn.scale_shift(a)
      # OIHW [CO,C,3,3] -> the K-major [CO,3,3,C] the unit reads.
      w_k = self.b.weight.to(a.dtype).permute(0, 2, 3, 1).contiguous()
      y, sums = conv_bn.fused_bn_relu_conv3x3(builder.nhwc(a), sc, sh, w_k)
      b = torch.relu(self.b_bn(builder.nchw(y), sums=sums))
    else:
      b = torch.relu(self.b_bn(self.b(torch.relu(self.a_bn(a)))))
    c = self.c(b)
    if self.v2:
      return c + shortcut
    return torch.relu(self.c_bn(c) + shortcut)


class ResNet(nn.Module):
  """NHWC images -> f32 logits. ``block_prefix`` is the flax name of the
  blocks (``resnet_v1<k>_...`` or ``resnet_v2<k>_...``; convert.py)."""

  def __init__(self, layer_counts, nclass: int, dtype: torch.dtype,
               generator: Optional[torch.Generator] = None,
               version: str = "v1.5"):
    super().__init__()
    self.dtype = dtype
    self.v2 = version == "v2"
    self.block_prefix = "resnet_v2" if self.v2 else "resnet_v1"
    g = generator
    self.conv_stem = builder.Conv(3, 64, 7, 2, "SAME_RESNET", generator=g)
    # v2's stem is conv + ReLU, no batch norm (resnet_model.py:147-149).
    self.conv_stem_bn = (None if self.v2 else
                         builder.CompactBatchNorm(64, **_BN))
    blocks = []
    in_size = 64
    for i, (count, depth_bottleneck, depth) in enumerate(
        zip(layer_counts, (64, 128, 256, 512), (256, 512, 1024, 2048))):
      for j in range(count):
        stride = 2 if (j == 0 and i > 0) else 1
        blocks.append(Bottleneck(in_size, depth, depth_bottleneck, stride,
                                 generator=g, version=version))
        in_size = depth
    self.blocks = nn.ModuleList(blocks)
    if self.v2:
      self.final_bn = builder.CompactBatchNorm(in_size, **_BN)
    self.affine0 = builder.Affine(in_size, nclass, activation="linear",
                                  generator=g)

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    x = model.to_model_input(images, self.dtype)
    x = self.conv_stem(x)
    if self.conv_stem_bn is not None:
      x = self.conv_stem_bn(x)
    x = builder.mpool_same(torch.relu(x), 3, 2)
    for block in self.blocks:
      x = block(x)
    if self.v2:
      x = torch.relu(self.final_bn(x))
    return conv_bn.accum(self.affine0(builder.spatial_mean(x)))


class ResnetModel(model.CNNModel):
  """ImageNet ResNet v1.5 or v2 (from the name: "v2" in it is v2, every
  other name v1.5, as in the JAX package)."""

  def __init__(self, model_name: str, layer_counts, params=None):
    # Base rate 0.1 (resnet_model.py:132-140).
    super().__init__(model_name, 224,
                     DEFAULT_BATCH_SIZES.get(model_name, 32), 0.1,
                     layer_counts=layer_counts, params=params)
    self.version = "v2" if "v2" in model_name else "v1.5"

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    """The network, its convolutions in channels_last memory."""
    return ResNet(self.layer_counts, nclass, dtype, generator,
                  self.version).to(memory_format=torch.channels_last)

  def bf16_kernels(self) -> str:
    return ("the fused BN-ReLU-conv3x3 kernel (csrc/bn_relu_conv3x3_stats.cu) "
            "and the conv3x3 kernel")

  def get_learning_rate(self, global_step, batch_size):
    return imagenet_learning_rate(global_step, batch_size)


def imagenet_learning_rate(global_step, batch_size):
  """0.1 scaled by batch/256, piecewise at epochs 30/60/80/90, after a
  linear warmup from 0 over 5 epochs. A tensor step gives the device form
  (learning_rate.make_learning_rate_fn)."""
  num_batches_per_epoch = IMAGENET_NUM_TRAIN_IMAGES / float(batch_size)
  rescaled_lr = 0.1 * batch_size / 256.0
  step = (global_step.float() if isinstance(global_step, torch.Tensor)
          else float(global_step))
  lr = rescaled_lr
  for epoch, factor in zip((30, 60, 80, 90), (0.1, 0.01, 0.001, 1e-4)):
    lr = learning_rate.where(step >= epoch * num_batches_per_epoch,
                             rescaled_lr * factor, lr)
  warmup_steps = int(5 * num_batches_per_epoch)
  return learning_rate.where(step < warmup_steps,
                             rescaled_lr * step / max(warmup_steps, 1), lr)


def piecewise_learning_rate(global_step, boundaries, values):
  """``values[i]`` from step ``boundaries[i - 1]`` on (``values[0]``
  before the first); a tensor step gives the device form."""
  step = (global_step.float() if isinstance(global_step, torch.Tensor)
          else float(global_step))
  lr = values[0]
  for b, v in zip(boundaries, values[1:]):
    lr = learning_rate.where(step >= b, v, lr)
  if isinstance(step, torch.Tensor) and not isinstance(lr, torch.Tensor):
    lr = torch.full_like(step, lr)
  return lr


def create_resnet50_model(params=None):
  return ResnetModel("resnet50", (3, 4, 6, 3), params=params)


def create_resnet50_v15_model(params=None):
  return ResnetModel("resnet50_v1.5", (3, 4, 6, 3), params=params)


def create_resnet50_v2_model(params=None):
  return ResnetModel("resnet50_v2", (3, 4, 6, 3), params=params)


def create_resnet101_model(params=None):
  return ResnetModel("resnet101", (3, 4, 23, 3), params=params)


def create_resnet101_v2_model(params=None):
  return ResnetModel("resnet101_v2", (3, 4, 23, 3), params=params)


def create_resnet152_model(params=None):
  return ResnetModel("resnet152", (3, 8, 36, 3), params=params)


def create_resnet152_v2_model(params=None):
  return ResnetModel("resnet152_v2", (3, 8, 36, 3), params=params)


# -- the builder-recorded ResNets (the JAX package's blocks, :27-121) --------

def bottleneck_block(cnn, depth: int, depth_bottleneck: int, stride: int,
                     version: str):
  """Bottleneck unit (resnet_model.py:27-78 of the JAX package): 1x1,
  3x3, 1x1 and a shortcut; v1 strides the first 1x1, v1.5 and v2 the
  3x3."""
  input_layer, in_size = cnn.top, cnn.top_size
  v2 = version == "v2"
  name = cnn._name("resnet_v2" if v2 else "resnet_v1")
  preact = (cnn.relu(cnn.batch_norm(name=name + "_preact_bn")) if v2
            else input_layer)
  if in_size != depth or stride != 1:
    shortcut = cnn.conv(depth, 1, 1, stride, stride, mode="SAME_RESNET",
                        input_layer=preact, use_batch_norm=not v2,
                        activation=None, bias=None, name=name + "_shortcut")
  else:
    shortcut = input_layer
  s1, s3 = (stride, 1) if version == "v1" else (1, stride)
  cnn.conv(depth_bottleneck, 1, 1, s1, s1, input_layer=preact,
           use_batch_norm=True, activation="relu", bias=None,
           name=name + "_a")
  cnn.conv(depth_bottleneck, 3, 3, s3, s3, mode="SAME_RESNET",
           use_batch_norm=True, activation="relu", bias=None,
           name=name + "_b")
  cnn.conv(depth, 1, 1, 1, 1, use_batch_norm=not v2, activation=None,
           bias=None, name=name + "_c")
  cnn.add(cnn.top, shortcut)
  if not v2:
    cnn.relu()


def residual_block(cnn, depth: int, stride: int, version: str):
  """Two-3x3 unit (resnet_model.py:81-121 of the JAX package)."""
  input_layer, in_size = cnn.top, cnn.top_size
  v2 = version == "v2"
  name = cnn._name("resblk")
  body_in = (cnn.relu(cnn.batch_norm(name=name + "_preact_bn")) if v2
             else input_layer)
  if in_size != depth or stride != 1:
    shortcut = cnn.conv(depth, 1, 1, stride, stride, mode="SAME_RESNET",
                        input_layer=body_in, use_batch_norm=not v2,
                        activation=None, bias=None, name=name + "_shortcut")
  else:
    shortcut = input_layer
  cnn.conv(depth, 3, 3, stride, stride, mode="SAME_RESNET",
           input_layer=body_in, use_batch_norm=True, activation="relu",
           bias=None, name=name + "_a")
  cnn.conv(depth, 3, 3, 1, 1, use_batch_norm=not v2, activation=None,
           bias=None, name=name + "_b")
  cnn.add(cnn.top, shortcut)
  if not v2:
    cnn.relu()


# The batch norm of every ResNet layer (resnet_model.py:155).
BN_CONFIG = {"decay": 0.9, "epsilon": 1e-5, "scale": True}
CIFAR10_NUM_TRAIN_IMAGES = 50000


class ResnetCifar10Model(builder.BuilderModel):
  """CIFAR-10 ResNet-N (resnet_model.py:215-258 of the JAX package): a
  3x3 stem to 16 channels, three stages of (N - 2) / 6 basic blocks at
  16, 32 and 64 channels, v1 or v2 from the name."""

  data_name = "cifar10"

  def __init__(self, model_name: str, layer_counts, params=None):
    self.version = "v2" if "v2" in model_name else "v1"
    super().__init__(model_name, 32, 128, 0.1, layer_counts=layer_counts,
                     params=params)

  def add_inference(self, cnn):
    v2 = self.version == "v2"
    cnn.use_batch_norm = not v2
    cnn.batch_norm_config = dict(BN_CONFIG)
    cnn.conv(16, 3, 3, 1, 1, use_batch_norm=not v2,
             activation=None if v2 else "relu", bias=None,
             name="conv_stem")
    for i, depth in enumerate((16, 32, 64)):
      for j in range(self.layer_counts[i]):
        residual_block(cnn, depth, 2 if (j == 0 and i > 0) else 1,
                       self.version)
    if v2:
      cnn.relu(cnn.batch_norm(name="final_bn"))
    cnn.spatial_mean()

  def get_learning_rate(self, global_step, batch_size):
    """0.1, 0.01, 0.001, 0.0002 at epochs 82, 123, 300
    (resnet_model.py:249-258)."""
    per_epoch = CIFAR10_NUM_TRAIN_IMAGES // batch_size
    return piecewise_learning_rate(
        global_step, [per_epoch * e for e in (82, 123, 300)],
        [0.1, 0.01, 0.001, 0.0002])


def _cifar(name: str, depth: int):
  n = (depth - 2) // 6
  return lambda params=None: ResnetCifar10Model(name, (n, n, n), params)


create_resnet20_cifar_model = _cifar("resnet20", 20)
create_resnet20_v2_cifar_model = _cifar("resnet20_v2", 20)
create_resnet32_cifar_model = _cifar("resnet32", 32)
create_resnet32_v2_cifar_model = _cifar("resnet32_v2", 32)
create_resnet44_cifar_model = _cifar("resnet44", 44)
create_resnet44_v2_cifar_model = _cifar("resnet44_v2", 44)
create_resnet56_cifar_model = _cifar("resnet56", 56)
create_resnet56_v2_cifar_model = _cifar("resnet56_v2", 56)
create_resnet110_cifar_model = _cifar("resnet110", 110)
create_resnet110_v2_cifar_model = _cifar("resnet110_v2", 110)
