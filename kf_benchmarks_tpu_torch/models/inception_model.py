"""Inception-v3 and Inception-v4 for ImageNet.

The port's counterpart of kf_benchmarks_tpu/models/inception_model.py
(Szegedy et al., "Rethinking the Inception Architecture for Computer
Vision", arXiv:1512.00567, and "Inception-v4, Inception-ResNet and the
Impact of Residual Connections on Learning", arXiv:1602.07261): 299x299
input, default batch 32, base rate 0.005. The networks are recorded
through builder.ConvNetBuilder with the JAX package's calls in the same
order, so their layers carry the JAX builder's names (``conv0`` ...
``conv93`` with ``conv<n>_bn``, ``affine0``). Every conv is conv -> batch
norm without scale (decay 0.999, epsilon 0.001) -> ReLU.

Two 3x3 convs take the fused BN-ReLU-conv3x3 unit (builder.GraphNet):
the 448 -> 384 at 8x8 of column 4 in ``mixed_9`` and ``mixed_10``
(inception_v3_e), each fed by the batch norm and ReLU of the 1x1 conv
before it. Every other 3x3 fails the unit's channel rule (C % 64 and CO
% 64) or is a stride-2 VALID conv.

Inception-v3's auxiliary head (``auxiliary=True``, a constructor option as
in the JAX package, :60-88 there; the registry builds without it) reads
``mixed_7``: 5x5/3 average pool, 1x1 conv to 128, 5x5 VALID conv to 768,
its own affine layer; the loss adds 0.4 of its cross-entropy.

Inception-v4 has no conv that the fused unit takes: its stride-1 3x3s run
64 -> 96, 96 -> 96 and 192 -> 224, which fail the channel rule.
"""

from __future__ import annotations

from kf_benchmarks_tpu_torch.models import builder


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


def _inception_v3_aux(cnn):
  assert cnn.aux_top is None
  cnn.aux_top = cnn.top
  with cnn.switch_to_aux_top_layer():
    cnn.apool(5, 5, 3, 3, mode="VALID")
    cnn.conv(128, 1, 1, mode="SAME")
    cnn.conv(768, 5, 5, mode="VALID", stddev=0.01)
    cnn.reshape([-1, 768])


class Inceptionv3Model(builder.BuilderModel):
  """Inception-v3, with the auxiliary head when ``auxiliary``."""

  def __init__(self, params=None, auxiliary=False):
    self._auxiliary = auxiliary
    super().__init__("inception3", 299, 32, 0.005, params=params)

  def add_inference(self, cnn):
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
    if self._auxiliary:
      _inception_v3_aux(cnn)                 # auxiliary head logits
    _inception_v3_d(cnn)                     # mixed_8
    _inception_v3_e(cnn, "avg")              # mixed_9
    _inception_v3_e(cnn, "max")              # mixed_10
    cnn.apool(8, 8, 1, 1, "VALID")
    cnn.reshape([-1, 2048])


# Inception-v4's stem and reduction modules (inception_model.py:93-138 of
# the JAX package).
def inception_v4_sa(cnn):
  cols = [[("mpool", 3, 3, 2, 2, "VALID")],
          [("conv", 96, 3, 3, 2, 2, "VALID")]]
  cnn.inception_module("incept_v4_sa", cols)


def inception_v4_sb(cnn):
  cols = [[("conv", 64, 1, 1), ("conv", 96, 3, 3, 1, 1, "VALID")],
          [("conv", 64, 1, 1), ("conv", 64, 7, 1), ("conv", 64, 1, 7),
           ("conv", 96, 3, 3, 1, 1, "VALID")]]
  cnn.inception_module("incept_v4_sb", cols)


def inception_v4_sc(cnn):
  cols = [[("conv", 192, 3, 3, 2, 2, "VALID")],
          [("mpool", 3, 3, 2, 2, "VALID")]]
  cnn.inception_module("incept_v4_sc", cols)


def inception_v4_ra(cnn, k, l, m, n):
  cols = [[("mpool", 3, 3, 2, 2, "VALID")],
          [("conv", n, 3, 3, 2, 2, "VALID")],
          [("conv", k, 1, 1), ("conv", l, 3, 3),
           ("conv", m, 3, 3, 2, 2, "VALID")]]
  cnn.inception_module("incept_v4_ra", cols)


def inception_v4_rb(cnn):
  cols = [[("mpool", 3, 3, 2, 2, "VALID")],
          [("conv", 192, 1, 1), ("conv", 192, 3, 3, 2, 2, "VALID")],
          [("conv", 256, 1, 1), ("conv", 256, 1, 7), ("conv", 320, 7, 1),
           ("conv", 320, 3, 3, 2, 2, "VALID")]]
  cnn.inception_module("incept_v4_rb", cols)


def inception_v4_a(cnn):
  cols = [[("apool", 3, 3, 1, 1, "SAME"), ("conv", 96, 1, 1)],
          [("conv", 96, 1, 1)],
          [("conv", 64, 1, 1), ("conv", 96, 3, 3)],
          [("conv", 64, 1, 1), ("conv", 96, 3, 3), ("conv", 96, 3, 3)]]
  cnn.inception_module("incept_v4_a", cols)


def inception_v4_b(cnn):
  cols = [[("apool", 3, 3, 1, 1, "SAME"), ("conv", 128, 1, 1)],
          [("conv", 384, 1, 1)],
          [("conv", 192, 1, 1), ("conv", 224, 1, 7), ("conv", 256, 7, 1)],
          [("conv", 192, 1, 1), ("conv", 192, 1, 7), ("conv", 224, 7, 1),
           ("conv", 224, 1, 7), ("conv", 256, 7, 1)]]
  cnn.inception_module("incept_v4_b", cols)


def inception_v4_c(cnn):
  cols = [[("apool", 3, 3, 1, 1, "SAME"), ("conv", 256, 1, 1)],
          [("conv", 256, 1, 1)],
          [("conv", 384, 1, 1), ("conv", 256, 1, 3)],
          [("share",), ("conv", 256, 3, 1)],
          [("conv", 384, 1, 1), ("conv", 448, 1, 3), ("conv", 512, 3, 1),
           ("conv", 256, 3, 1)],
          [("share",), ("share",), ("share",), ("conv", 256, 1, 3)]]
  cnn.inception_module("incept_v4_c", cols)


class Inceptionv4Model(builder.BuilderModel):
  """Inception-v4 (inception_model.py:141-180 of the JAX package)."""

  def __init__(self, params=None):
    super().__init__("inception4", 299, 32, 0.005, params=params)

  def add_inference(self, cnn):
    cnn.use_batch_norm = True
    cnn.conv(32, 3, 3, 2, 2, mode="VALID")
    cnn.conv(32, 3, 3, 1, 1, mode="VALID")
    cnn.conv(64, 3, 3)
    inception_v4_sa(cnn)
    inception_v4_sb(cnn)
    inception_v4_sc(cnn)
    for _ in range(4):
      inception_v4_a(cnn)
    inception_v4_ra(cnn, 192, 224, 256, 384)
    for _ in range(7):
      inception_v4_b(cnn)
    inception_v4_rb(cnn)
    for _ in range(3):
      inception_v4_c(cnn)
    cnn.spatial_mean()
    cnn.dropout(0.8)
