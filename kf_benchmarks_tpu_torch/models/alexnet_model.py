"""AlexNet (Krizhevsky et al., NeurIPS 2012) for ImageNet, and the TF
CIFAR-10 tutorial's AlexNet-like net: the port's counterpart of
kf_benchmarks_tpu/models/alexnet_model.py.

ImageNet: 227x227 input (224 + 3, for the VALID 11x11 stride-4 conv),
default batch 512, rate 0.005; convs with a bias and ReLU, no batch norm,
two 4096-wide affine layers each followed by dropout (keep 0.5).

CIFAR-10: 32x32 input, batch 128, two 5x5 convs each beside a local
response normalisation (TF's LRN, builder.lrn), two affine layers, and the
staircase rate 0.1 x 0.1^floor(epoch / 100).

No conv takes the fused BN-ReLU-conv3x3 unit: none follows a batch norm.
"""

from __future__ import annotations

import torch

from kf_benchmarks_tpu_torch.models import builder

CIFAR10_NUM_TRAIN_IMAGES = 50000


class AlexnetModel(builder.BuilderModel):
  """(alexnet_model.py:13-35 of the JAX package)"""

  def __init__(self, params=None):
    super().__init__("alexnet", 224 + 3, 512, 0.005, params=params)

  def add_inference(self, cnn):
    cnn.conv(64, 11, 11, 4, 4, "VALID")
    cnn.mpool(3, 3, 2, 2)
    cnn.conv(192, 5, 5)
    cnn.mpool(3, 3, 2, 2)
    cnn.conv(384, 3, 3)
    cnn.conv(384, 3, 3)
    cnn.conv(256, 3, 3)
    cnn.mpool(3, 3, 2, 2)
    cnn.reshape([-1, 256 * 6 * 6])
    cnn.affine(4096)
    cnn.dropout()
    cnn.affine(4096)
    cnn.dropout()


class AlexnetCifar10Model(builder.BuilderModel):
  """(alexnet_model.py:38-74 of the JAX package)"""

  data_name = "cifar10"

  def __init__(self, params=None):
    super().__init__("alexnet", 32, 128, 0.1, params=params)

  def add_inference(self, cnn):
    cnn.conv(64, 5, 5, 1, 1, "SAME", stddev=5e-2)
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    cnn.lrn(depth_radius=4, bias=1.0, alpha=0.001 / 9.0, beta=0.75)
    cnn.conv(64, 5, 5, 1, 1, "SAME", bias=0.1, stddev=5e-2)
    cnn.lrn(depth_radius=4, bias=1.0, alpha=0.001 / 9.0, beta=0.75)
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    cnn.flatten()
    cnn.affine(384, stddev=0.04, bias=0.1)
    cnn.affine(192, stddev=0.04, bias=0.1)

  def get_learning_rate(self, global_step, batch_size):
    """Staircase decay, 0.1x every 100 epochs (alexnet_model.py:63-74). A
    tensor step gives the device form."""
    decay_steps = int(100 * CIFAR10_NUM_TRAIN_IMAGES / batch_size)
    if isinstance(global_step, torch.Tensor):
      num_decays = torch.floor(global_step.float() / decay_steps)
      return self.learning_rate * torch.pow(0.1, num_decays)
    return self.learning_rate * 0.1 ** (global_step // decay_steps)
