"""Model API: name, shapes, synthetic inputs, loss, accuracy, LR policy.

The port's counterpart of kf_benchmarks_tpu/models/model.py. A model
describes its network (``make_module``) and its loss; the benchmark runtime
owns parameters, optimizer and the step.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.ops.conv_bn import accum


class Model:
  """Model base (model.py:32 of the JAX package): name, batch size,
  learning rate, input shapes, synthetic inputs and the network.

  ``data_name`` names the synthetic data on the benchmark's banner.
  ``bf16_kernels()`` names the hand-written kernels the model's path
  launches that have no f32 variant yet ("" when there are none), so
  validation can refuse an f32 run on the card.
  """

  data_name = "synthetic"

  def __init__(self, name: str, batch_size: int, learning_rate: float,
               params=None):
    self.name = name
    self.batch_size = batch_size
    self.learning_rate = learning_rate
    self.params = params

  def get_name(self) -> str:
    return self.name

  def get_batch_size(self) -> int:
    return self.batch_size

  def set_batch_size(self, batch_size: int) -> None:
    self.batch_size = batch_size

  def get_fp16_loss_scale(self) -> float:
    """The loss scale of float16 compute (model.py:36, :65-66 of the JAX
    package). The port computes in bfloat16 or f32, which need none, so
    ``train_step.loss_scale_settings`` never reads it."""
    return 128.0

  def get_learning_rate(self, global_step: int, batch_size: int) -> float:
    del global_step, batch_size
    return self.learning_rate

  def bf16_kernels(self) -> str:
    return ""

  def get_input_shapes(self, subset: str) -> List[List[int]]:
    raise NotImplementedError

  def get_synthetic_inputs(self, generator: torch.Generator, nclass: int,
                           device: torch.device):
    raise NotImplementedError

  def make_module(self, nclass: int, dtype: torch.dtype = torch.float32,
                  generator: torch.Generator = None) -> nn.Module:
    raise NotImplementedError

  def loss_function(self, logits, labels: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError


class CNNModel(Model):
  """Convolutional model base (model.py:134-312 of the JAX package)."""

  data_name = "imagenet"

  def __init__(self, name: str, image_size: int, batch_size: int,
               learning_rate: float, layer_counts=None, depth: int = 3,
               params=None):
    super().__init__(name, batch_size, learning_rate, params=params)
    self.image_size = image_size
    self.layer_counts = layer_counts
    self.depth = depth

  def get_input_shapes(self, subset: str) -> List[List[int]]:
    del subset
    n = self.get_batch_size()
    return [[n, self.image_size, self.image_size, self.depth], [n]]

  def get_synthetic_inputs(self, generator: torch.Generator, nclass: int,
                           device: torch.device):
    """Truncated-normal images in [0, 255] (mean 127, std 60 before the
    cut at two standard deviations) and uniform labels, NHWC f32 and int64,
    made on ``device`` from ``generator`` (model.py:177-185). The values
    differ from jax.random's; tests feed both frameworks one numpy batch."""
    image_shape, label_shape = self.get_input_shapes("train")
    images = torch.empty(image_shape, device=device)
    nn.init.trunc_normal_(images, 0.0, 1.0, -2.0, 2.0, generator=generator)
    images = images * 60.0 + 127.0
    labels = torch.randint(0, nclass, label_shape, generator=generator,
                           device=device)
    return images, labels

  def loss_function(self, logits, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy (model.py:193-208), in f32, plus 0.4 of
    the auxiliary head's when ``logits`` is (logits, auxiliary logits)."""
    if isinstance(logits, tuple):
      main, aux = logits
      return (F.cross_entropy(accum(main), labels) +
              0.4 * F.cross_entropy(accum(aux), labels))
    return F.cross_entropy(accum(logits), labels)

  def accuracy_function(self, logits, labels: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """top-1 / top-5 fractions (of the main logits)."""
    if isinstance(logits, tuple):
      logits = logits[0]
    top1 = (logits.argmax(-1) == labels).float().mean()
    top5_pred = logits.topk(min(5, logits.shape[-1]), -1).indices
    top5 = (top5_pred == labels[:, None]).any(-1).float().mean()
    return {"top_1_accuracy": top1, "top_5_accuracy": top5}


def cast_params(module: nn.Module, param_dtype: torch.dtype) -> nn.Module:
  """Every parameter of ``module`` stored in ``param_dtype`` (--fp16_vars:
  bf16, the JAX package's ``param_dtype`` of every make_module,
  benchmark.py:461-467, :530-537), in place and in its memory format; the
  buffers -- the batch-norm running averages -- stay f32. The layers use
  such parameters as they are where they compute in bf16 (no per-call
  cast) and upcast them where they compute in f32 (batch norm's scale and
  offset, layer norm), as flax does."""
  if param_dtype != torch.float32:
    with torch.no_grad():
      for p in module.parameters():
        p.data = p.data.to(param_dtype)
  return module


def to_model_input(images_nhwc: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
  """NHWC images -> NCHW-shaped channels_last tensor in ``dtype``."""
  return images_nhwc.to(dtype).permute(0, 3, 1, 2).contiguous(
      memory_format=torch.channels_last)
