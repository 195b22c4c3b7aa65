"""OverFeat (Sermanet et al., arXiv:1312.6229): the port's counterpart of
kf_benchmarks_tpu/models/overfeat_model.py, 231x231 input, default batch
32, rate 0.005. Convs with a bias and ReLU, no batch norm; two affine
layers (3072, 4096) each followed by dropout (keep 0.5). No conv takes the
fused BN-ReLU-conv3x3 unit: none follows a batch norm.
"""

from __future__ import annotations

from kf_benchmarks_tpu_torch.models import builder


class OverfeatModel(builder.BuilderModel):
  """(overfeat_model.py:10-29 of the JAX package)"""

  def __init__(self, params=None):
    super().__init__("overfeat", 231, 32, 0.005, params=params)

  def add_inference(self, cnn):
    cnn.conv(96, 11, 11, 4, 4, mode="VALID")
    cnn.mpool(2, 2)
    cnn.conv(256, 5, 5, 1, 1, mode="VALID")
    cnn.mpool(2, 2)
    cnn.conv(512, 3, 3)
    cnn.conv(1024, 3, 3)
    cnn.conv(1024, 3, 3)
    cnn.mpool(2, 2)
    cnn.reshape([-1, 1024 * 6 * 6])
    cnn.affine(3072)
    cnn.dropout()
    cnn.affine(4096)
    cnn.dropout()
