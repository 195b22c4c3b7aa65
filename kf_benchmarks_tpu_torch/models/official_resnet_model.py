"""The official-models ResNets, sizes 18 to 200, versions 1 and 2: the
port's counterpart of kf_benchmarks_tpu/models/official_resnet_model.py
(224x224 input, default batch 32, the ImageNet ResNets' rate schedule and
batch norm: decay 0.9, epsilon 1e-5, with scale).

Basic blocks (two 3x3s) for 18 and 34, bottlenecks for 50 to 200, recorded
through builder.ConvNetBuilder with resnet_model.py's blocks and the JAX
package's names (``conv_stem``, ``resblk<k>_...`` or ``resnet_v1<k>_...``
/ ``resnet_v2<k>_...``). "Version 1" strides the bottleneck's 3x3 (the
v1.5 arrangement). Each block's stride-1 3x3 that follows a conv's batch
norm and ReLU takes the fused BN-ReLU-conv3x3 unit (ops/conv_bn.py): 8
in official_resnet18, 16 in 34, 13 in 50 (as resnet50), 30 in 101, 47 in
152, 63 in 200.
"""

from __future__ import annotations

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import resnet_model

# size -> (block kind, per-stage counts) (the official _get_block_sizes)
_RESNET_SIZES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


class OfficialResnetModel(builder.BuilderModel):
  """(official_resnet_model.py:29-87 of the JAX package)"""

  def __init__(self, resnet_size: int = 50, version: int = 1, params=None):
    if resnet_size not in _RESNET_SIZES:
      raise ValueError(
          f"resnet_size must be one of {sorted(_RESNET_SIZES)}, got "
          f"{resnet_size}")
    if version not in (1, 2):
      raise ValueError(f"version must be 1 or 2, got {version}")
    self.resnet_size = resnet_size
    self.block_kind, self.block_counts = _RESNET_SIZES[resnet_size]
    self.version = "v1.5" if version == 1 else "v2"
    super().__init__(f"official_resnet{resnet_size}_v{version}", 224, 32,
                     0.1, params=params)

  def add_inference(self, cnn):
    v2 = self.version == "v2"
    cnn.use_batch_norm = not v2
    cnn.batch_norm_config = dict(resnet_model.BN_CONFIG)
    cnn.conv(64, 7, 7, 2, 2, mode="SAME_RESNET", use_batch_norm=not v2,
             activation="relu", bias=None, name="conv_stem")
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    widths = (64, 128, 256, 512)
    for i, count in enumerate(self.block_counts):
      for j in range(count):
        stride = 2 if (j == 0 and i > 0) else 1
        if self.block_kind == "basic":
          resnet_model.residual_block(cnn, widths[i], stride, self.version)
        else:
          resnet_model.bottleneck_block(cnn, 4 * widths[i], widths[i],
                                        stride, self.version)
    if v2:
      cnn.relu(cnn.batch_norm(name="final_bn"))
    cnn.spatial_mean()

  def get_learning_rate(self, global_step, batch_size):
    """The ImageNet ResNets' schedule (official_resnet_model.py:79-84)."""
    return resnet_model.imagenet_learning_rate(global_step, batch_size)


def create_official_resnet18_model(params=None):
  return OfficialResnetModel(18, 1, params=params)


def create_official_resnet34_model(params=None):
  return OfficialResnetModel(34, 1, params=params)


def create_official_resnet50_model(params=None):
  return OfficialResnetModel(50, 1, params=params)


def create_official_resnet50_v2_model(params=None):
  return OfficialResnetModel(50, 2, params=params)


def create_official_resnet101_model(params=None):
  return OfficialResnetModel(101, 1, params=params)


def create_official_resnet152_model(params=None):
  return OfficialResnetModel(152, 1, params=params)


def create_official_resnet200_model(params=None):
  return OfficialResnetModel(200, 1, params=params)
