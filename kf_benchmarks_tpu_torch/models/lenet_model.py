"""LeNet-5, the TF MNIST tutorial's variant: the port's counterpart of
kf_benchmarks_tpu/models/lenet_model.py, 28x28 input, default batch 32,
rate 0.005; its name is ``lenet5``, as there."""

from __future__ import annotations

from kf_benchmarks_tpu_torch.models import builder


class Lenet5Model(builder.BuilderModel):
  """(lenet_model.py:9-21 of the JAX package)"""

  def __init__(self, params=None):
    super().__init__("lenet5", 28, 32, 0.005, params=params)

  def add_inference(self, cnn):
    cnn.conv(32, 5, 5)
    cnn.mpool(2, 2)
    cnn.conv(64, 5, 5)
    cnn.mpool(2, 2)
    cnn.reshape([-1, 64 * 7 * 7])
    cnn.affine(512)
