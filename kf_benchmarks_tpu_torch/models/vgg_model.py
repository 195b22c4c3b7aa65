"""VGG-11, VGG-16 and VGG-19 (Simonyan & Zisserman, arXiv:1409.1556,
models A, D and E): the port's counterpart of
kf_benchmarks_tpu/models/vgg_model.py, 224x224 input, default batch 64,
rate 0.005.

Five blocks of 3x3 convs (64, 128, 256, 512, 512 channels) with a bias and
ReLU and no batch norm, each block ending in a 2x2 max pool, then two
4096-wide affine layers each followed by dropout (keep 0.5). No conv takes
the fused BN-ReLU-conv3x3 unit: none follows a batch norm.
"""

from __future__ import annotations

from kf_benchmarks_tpu_torch.models import builder


def _construct_vgg(cnn, num_conv_layers):
  """(vgg_model.py:11-23 of the JAX package)"""
  assert len(num_conv_layers) == 5
  for channels, count in zip((64, 128, 256, 512, 512), num_conv_layers):
    for _ in range(count):
      cnn.conv(channels, 3, 3)
    cnn.mpool(2, 2)
  cnn.reshape([-1, 512 * 7 * 7])
  cnn.affine(4096)
  cnn.dropout()
  cnn.affine(4096)
  cnn.dropout()


class _VggModel(builder.BuilderModel):
  LAYERS = None

  def __init__(self, name, params=None):
    super().__init__(name, 224, 64, 0.005, params=params)

  def add_inference(self, cnn):
    _construct_vgg(cnn, self.LAYERS)


class Vgg11Model(_VggModel):
  LAYERS = (1, 1, 2, 2, 2)

  def __init__(self, params=None):
    super().__init__("vgg11", params=params)


class Vgg16Model(_VggModel):
  LAYERS = (2, 2, 3, 3, 3)

  def __init__(self, params=None):
    super().__init__("vgg16", params=params)


class Vgg19Model(_VggModel):
  LAYERS = (2, 2, 4, 4, 4)

  def __init__(self, params=None):
    super().__init__("vgg19", params=params)
