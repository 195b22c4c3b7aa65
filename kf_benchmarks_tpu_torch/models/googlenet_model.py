"""GoogLeNet (Szegedy et al., arXiv:1409.4842): the port's counterpart of
kf_benchmarks_tpu/models/googlenet_model.py, 224x224 input, default batch
32, rate 0.005. Nine inception-v1 modules of four columns (1x1; 1x1 then
3x3; 1x1 then 5x5; 3x3 max pool then 1x1), convs with a bias and ReLU and
no batch norm, so none takes the fused BN-ReLU-conv3x3 unit.
"""

from __future__ import annotations

from kf_benchmarks_tpu_torch.models import builder


def inception_v1(cnn, k, l, m, n, p, q):
  cols = [[("conv", k, 1, 1)],
          [("conv", l, 1, 1), ("conv", m, 3, 3)],
          [("conv", n, 1, 1), ("conv", p, 5, 5)],
          [("mpool", 3, 3, 1, 1, "SAME"), ("conv", q, 1, 1)]]
  cnn.inception_module("incept_v1", cols)


class GooglenetModel(builder.BuilderModel):
  """(googlenet_model.py:10-42 of the JAX package)"""

  def __init__(self, params=None):
    super().__init__("googlenet", 224, 32, 0.005, params=params)

  def add_inference(self, cnn):
    cnn.conv(64, 7, 7, 2, 2)
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    cnn.conv(64, 1, 1)
    cnn.conv(192, 3, 3)
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    inception_v1(cnn, 64, 96, 128, 16, 32, 32)
    inception_v1(cnn, 128, 128, 192, 32, 96, 64)
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    inception_v1(cnn, 192, 96, 208, 16, 48, 64)
    inception_v1(cnn, 160, 112, 224, 24, 64, 64)
    inception_v1(cnn, 128, 128, 256, 24, 64, 64)
    inception_v1(cnn, 112, 144, 288, 32, 64, 64)
    inception_v1(cnn, 256, 160, 320, 32, 128, 128)
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    inception_v1(cnn, 256, 160, 320, 32, 128, 128)
    inception_v1(cnn, 384, 192, 384, 48, 128, 128)
    cnn.apool(7, 7, 1, 1, mode="VALID")
    cnn.reshape([-1, 1024])
