"""DenseNet for CIFAR-10 (Huang et al., arXiv:1608.06993): the port's
counterpart of kf_benchmarks_tpu/models/densenet_model.py, 32x32 input,
default batch 64, the rate 0.1 / 0.01 / 0.001 / 0.0001 at epochs 150, 225
and 300.

A 3x3 stem to 16 channels, three dense stages of ``layer_counts`` blocks
(batch norm with scale, decay 0.9, epsilon 1e-5 -> ReLU -> 3x3 conv to
``growth_rate`` channels with a bias, concatenated onto the block's input)
with a transition (batch norm -> ReLU -> 1x1 conv with a bias and ReLU to
2 x growth_rate channels, as the JAX model's bookkeeping makes it -> 2x2
average pool) between them, then batch norm, ReLU and the spatial mean.
The batch norms are layers of their own (``batchnorm<n>``), the convs have
no batch norm of their own, so none takes the fused BN-ReLU-conv3x3 unit.
"""

from __future__ import annotations

import math

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import resnet_model

CIFAR10_NUM_TRAIN_IMAGES = 50000


class DensenetCifar10Model(builder.BuilderModel):
  """(densenet_model.py:15-79 of the JAX package)"""

  data_name = "cifar10"

  def __init__(self, model, layer_counts, growth_rate, params=None):
    self.growth_rate = growth_rate
    super().__init__(model, 32, 64, 0.1, layer_counts=layer_counts,
                     params=params)
    self.batch_norm_config = {"decay": 0.9, "epsilon": 1e-5, "scale": True}

  def dense_block(self, cnn, growth_rate):
    input_layer = cnn.top
    c = cnn.relu(cnn.batch_norm(input_layer, **self.batch_norm_config))
    c = cnn.conv(growth_rate, 3, 3, 1, 1,
                 stddev=math.sqrt(2.0 / 9 / growth_rate),
                 activation=None, input_layer=c)
    cnn.concat([input_layer, c])

  def transition_layer(self, cnn):
    # The JAX model's ``cnn.top_size`` here: the block's conv set it to
    # growth_rate and the block added growth_rate to it (the reference's
    # bookkeeping, kept there), so the 1x1 maps the stage's channels to
    # 2 x growth_rate, not to as many as it reads.
    in_size = 2 * self.growth_rate
    cnn.batch_norm(**self.batch_norm_config)
    cnn.relu()
    cnn.conv(in_size, 1, 1, 1, 1, stddev=math.sqrt(2.0 / 9 / in_size))
    cnn.apool(2, 2, 2, 2)

  def add_inference(self, cnn):
    cnn.conv(16, 3, 3, 1, 1, activation=None)
    for stage in range(3):
      if stage:
        self.transition_layer(cnn)
      for _ in range(self.layer_counts[stage]):
        self.dense_block(cnn, self.growth_rate)
    cnn.batch_norm(**self.batch_norm_config)
    cnn.relu()
    cnn.spatial_mean()

  def get_learning_rate(self, global_step, batch_size):
    """(densenet_model.py:70-79)"""
    per_epoch = int(CIFAR10_NUM_TRAIN_IMAGES / batch_size)
    return resnet_model.piecewise_learning_rate(
        global_step, [e * per_epoch for e in (150, 225, 300)],
        [0.1, 0.01, 0.001, 0.0001])


def create_densenet40_k12_model(params=None):
  return DensenetCifar10Model("densenet40_k12", (12, 12, 12), 12,
                              params=params)


def create_densenet100_k12_model(params=None):
  return DensenetCifar10Model("densenet100_k12", (32, 32, 32), 12,
                              params=params)


def create_densenet100_k24_model(params=None):
  return DensenetCifar10Model("densenet100_k24", (32, 32, 32), 24,
                              params=params)
