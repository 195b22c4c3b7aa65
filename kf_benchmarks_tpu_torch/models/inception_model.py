"""Inception-v3 for ImageNet.

The port's counterpart of Inceptionv3Model in
kf_benchmarks_tpu/models/inception_model.py:11-90 (Szegedy et al.,
"Rethinking the Inception Architecture for Computer Vision",
arXiv:1512.00567): 299x299 input, default batch 32, base rate 0.005. The
network is recorded through builder.ConvNetBuilder with the JAX package's
calls in the same order, so its layers carry the JAX builder's names
(``conv0`` ... ``conv93`` with ``conv<n>_bn``, ``affine0``). Every conv is
conv -> batch norm without scale (decay 0.999, epsilon 0.001) -> ReLU.

Two 3x3 convs take the fused BN-ReLU-conv3x3 unit (builder.GraphNet):
the 448 -> 384 at 8x8 of column 4 in ``mixed_9`` and ``mixed_10``
(inception_v3_e), each fed by the batch norm and ReLU of the 1x1 conv
before it. Every other 3x3 fails the unit's channel rule (C % 64 and CO
% 64) or is a stride-2 VALID conv.

The registry builds the network without the auxiliary head (the JAX
registry's default, ``auxiliary=False``).
"""

from __future__ import annotations

import torch

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model


def _inception_v3_a(cnn, n):
  cols = [[("conv", 64, 1, 1)],
          [("conv", 48, 1, 1), ("conv", 64, 5, 5)],
          [("conv", 64, 1, 1), ("conv", 96, 3, 3), ("conv", 96, 3, 3)],
          [("apool", 3, 3, 1, 1, "SAME"), ("conv", n, 1, 1)]]
  cnn.inception_module("incept_v3_a", cols)


def _inception_v3_b(cnn):
  cols = [[("conv", 384, 3, 3, 2, 2, "VALID")],
          [("conv", 64, 1, 1),
           ("conv", 96, 3, 3),
           ("conv", 96, 3, 3, 2, 2, "VALID")],
          [("mpool", 3, 3, 2, 2, "VALID")]]
  cnn.inception_module("incept_v3_b", cols)


def _inception_v3_c(cnn, n):
  cols = [[("conv", 192, 1, 1)],
          [("conv", n, 1, 1), ("conv", n, 1, 7), ("conv", 192, 7, 1)],
          [("conv", n, 1, 1), ("conv", n, 7, 1), ("conv", n, 1, 7),
           ("conv", n, 7, 1), ("conv", 192, 1, 7)],
          [("apool", 3, 3, 1, 1, "SAME"), ("conv", 192, 1, 1)]]
  cnn.inception_module("incept_v3_c", cols)


def _inception_v3_d(cnn):
  cols = [[("conv", 192, 1, 1), ("conv", 320, 3, 3, 2, 2, "VALID")],
          [("conv", 192, 1, 1), ("conv", 192, 1, 7), ("conv", 192, 7, 1),
           ("conv", 192, 3, 3, 2, 2, "VALID")],
          [("mpool", 3, 3, 2, 2, "VALID")]]
  cnn.inception_module("incept_v3_d", cols)


def _inception_v3_e(cnn, pooltype):
  cols = [[("conv", 320, 1, 1)],
          [("conv", 384, 1, 1), ("conv", 384, 1, 3)],
          [("share",), ("conv", 384, 3, 1)],
          [("conv", 448, 1, 1), ("conv", 384, 3, 3), ("conv", 384, 1, 3)],
          [("share",), ("share",), ("conv", 384, 3, 1)],
          [("mpool" if pooltype == "max" else "apool", 3, 3, 1, 1, "SAME"),
           ("conv", 192, 1, 1)]]
  cnn.inception_module("incept_v3_e", cols)


def add_inference(cnn) -> None:
  """The JAX Inceptionv3Model.add_inference without the auxiliary head."""
  cnn.use_batch_norm = True
  cnn.conv(32, 3, 3, 2, 2, mode="VALID")   # 299 x 299 x 3
  cnn.conv(32, 3, 3, 1, 1, mode="VALID")   # 149 x 149 x 32
  cnn.conv(64, 3, 3, 1, 1, mode="SAME")    # 147 x 147 x 64
  cnn.mpool(3, 3, 2, 2, mode="VALID")      # 147 x 147 x 64
  cnn.conv(80, 1, 1, 1, 1, mode="VALID")   # 73 x 73 x 80
  cnn.conv(192, 3, 3, 1, 1, mode="VALID")  # 71 x 71 x 192
  cnn.mpool(3, 3, 2, 2, "VALID")           # 35 x 35 x 192
  _inception_v3_a(cnn, 32)                 # mixed
  _inception_v3_a(cnn, 64)                 # mixed_1
  _inception_v3_a(cnn, 64)                 # mixed_2
  _inception_v3_b(cnn)                     # mixed_3
  _inception_v3_c(cnn, 128)                # mixed_4
  _inception_v3_c(cnn, 160)                # mixed_5
  _inception_v3_c(cnn, 160)                # mixed_6
  _inception_v3_c(cnn, 192)                # mixed_7
  _inception_v3_d(cnn)                     # mixed_8
  _inception_v3_e(cnn, "avg")              # mixed_9
  _inception_v3_e(cnn, "max")              # mixed_10
  cnn.apool(8, 8, 1, 1, "VALID")
  cnn.flatten()                            # reshape [-1, 2048]


class Inceptionv3Model(model.CNNModel):
  """Inception-v3 without the auxiliary head."""

  def __init__(self, params=None):
    super().__init__("inception3", 299, 32, 0.005, params=params)

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    """The network, its convolutions in channels_last memory."""
    net = builder.GraphNet(dtype)
    cnn = builder.ConvNetBuilder(net, self.image_size, self.depth,
                                 generator=generator)
    add_inference(cnn)
    cnn.affine(nclass, activation="linear")
    return cnn.finish().to(memory_format=torch.channels_last)

  def bf16_kernels(self) -> str:
    return ("the fused BN-ReLU-conv3x3 kernel (csrc/bn_relu_conv3x3_stats.cu) "
            "and the conv3x3 kernel")
