"""NASNet-A (Zoph et al., arXiv:1707.07012): the port's counterpart of
kf_benchmarks_tpu/models/nasnet_model.py -- mobile (224 px, batch 32),
large (331 px, batch 16) and CIFAR (32 px, batch 32).

The JAX package writes the network as one compact flax module whose layers
take flax's counter names in the order the forward creates them
(``Conv_<i>``, ``BatchNorm_<i>``, ``Dense_<i>``; the auxiliary head's
layers fall between two cells). ``NasnetNet`` runs the same forward once
at build time on meta tensors, creating each layer where the JAX forward
creates it (``_conv``, ``_bn``, ``_dense``), so its state_dict names are
the flax tree's and convert.py maps them one to one. Later forwards take
the layers back in the same order; an evaluation forward, which skips the
auxiliary head, steps the counters over its layers.

A cell: the previous cell's output matched to this one's width and
resolution (``_reduce_prev_layer``: the factorized reduction, two 1x1
convs over the two pixel grids, or a 1x1 conv), a 1x1 conv of the input,
then five combinations of two operations each (separable convs as ReLU,
depthwise conv, pointwise conv and batch norm, twice; 3x3 average or max
pools; identity), and the states no combination read, concatenated.

Drop path (nasnet_model.py:153-165 of the JAX package) keeps the JAX
arithmetic, ``x / keep * floor(keep + U)`` in the compute dtype with one U
per example, and its keep probability follows the cell-depth schedule and
the run's progress, ``step / total_steps``, computed on the device from
the train step's counter (builder.SeededDropout), so a captured step
replays each step's own schedule. The final dropout (keep 0.5, mobile and
large) draws from the same counter. No conv is a dense 3x3 after a batch
norm and ReLU, so none takes the fused unit.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model as model_lib
from kf_benchmarks_tpu_torch.ops.conv_bn import accum

# NASNet-A cell op tables (nasnet_model.py:36-48 of the JAX package).
NORMAL_OPERATIONS = (
    "separable_5x5_2", "separable_3x3_2", "separable_5x5_2",
    "separable_3x3_2", "avg_pool_3x3", "none", "avg_pool_3x3",
    "avg_pool_3x3", "separable_3x3_2", "none")
NORMAL_USED_HIDDENSTATES = (1, 0, 0, 0, 0, 0, 0)
NORMAL_HIDDENSTATE_INDICES = (0, 1, 1, 1, 0, 1, 1, 1, 0, 0)

REDUCTION_OPERATIONS = (
    "separable_5x5_2", "separable_7x7_2", "max_pool_3x3", "separable_7x7_2",
    "avg_pool_3x3", "separable_5x5_2", "none", "avg_pool_3x3",
    "separable_3x3_2", "max_pool_3x3")
REDUCTION_USED_HIDDENSTATES = (1, 1, 1, 0, 0, 0, 0)
REDUCTION_HIDDENSTATE_INDICES = (0, 1, 0, 1, 0, 1, 3, 2, 2, 0)

# flax's default kernel init, lecun_normal: a normal of variance 1 / fan_in
# cut at two standard deviations, its scale corrected for the cut.
_TRUNC_CORRECTION = 0.87962566103423978


def calc_reduction_layers(num_cells: int,
                          num_reduction_layers: int) -> List[int]:
  """Cell indices where reduction cells go (nasnet_model.py:51-55)."""
  return [int(float(pool_num) / (num_reduction_layers + 1) * num_cells)
          for pool_num in range(1, num_reduction_layers + 1)]


def drop_path_keep_prob(base_keep_prob: float, cell_num: int,
                        total_cells: int, progress=None):
  """Keep probability after the cell-depth schedule and, given
  ``progress`` (an f32 tensor), the ramp over the run
  (nasnet_model.py:57-68)."""
  layer_ratio = (cell_num + 1) / float(total_cells)
  keep = 1.0 - layer_ratio * (1.0 - base_keep_prob)
  if progress is not None:
    ratio = torch.clamp(progress, max=1.0)
    keep = 1.0 - ratio * (1.0 - keep)
  return keep


def _op_info(operation: str) -> Tuple[int, int]:
  """'separable_5x5_2' -> (kernel 5, 2 layers)."""
  parts = operation.split("_")
  return int(parts[1].split("x")[0]), int(parts[2])


class NasnetNet(builder.SeededDropout, nn.Module):
  """The NASNet-A network: NHWC images -> f32 logits, or (logits,
  auxiliary logits) in training with the auxiliary head."""

  def __init__(self, nclass: int, dtype: torch.dtype, image_size: int,
               num_cells: int, num_conv_filters: int,
               stem_multiplier: float, stem_type: str,
               dense_dropout_keep_prob: float = 0.5,
               drop_path_keep_prob: float = 1.0,
               filter_scaling_rate: float = 2.0,
               num_reduction_layers: int = 2,
               skip_reduction_layer_input: bool = False,
               use_aux_head: bool = True,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.nclass = nclass
    self.dtype = dtype
    self.num_cells = num_cells
    self.num_conv_filters = num_conv_filters
    self.stem_multiplier = stem_multiplier
    self.stem_type = stem_type
    self.dense_dropout_keep_prob = dense_dropout_keep_prob
    self.drop_path_keep_prob = drop_path_keep_prob
    self.filter_scaling_rate = filter_scaling_rate
    self.num_reduction_layers = num_reduction_layers
    self.skip_reduction_layer_input = skip_reduction_layer_input
    self.use_aux_head = use_aux_head
    self._generator = generator
    self._aux_layers = (0, 0, 0)  # the aux head's (convs, norms, denses)
    self._building = True
    self._run(torch.empty(1, 3, image_size, image_size, device="meta"),
              True)
    self._building = False
    self._generator = None
    self.seed_dropout(generator)

  # -- layers, made at build time in the JAX forward's order ----------------

  def _next(self, kind: str) -> str:
    name = f"{kind}_{self._counts[kind]}"
    self._counts[kind] += 1
    return name

  def _conv(self, x, features: int, kernel: int, stride: int = 1,
            padding: str = "SAME", groups: int = 1):
    name = self._next("Conv")
    if not self._building:
      return getattr(self, name)(x)
    cin = x.shape[1]
    conv = builder.Conv(cin, features, kernel, stride, padding,
                        generator=self._generator, groups=groups,
                        stddev=math.sqrt(groups / (kernel * kernel * cin)) /
                        _TRUNC_CORRECTION)
    self.add_module(name, conv)
    oh, ow = conv.out_size(x.shape[2], x.shape[3])
    return x.new_empty(x.shape[0], features, oh, ow)

  def _bn(self, x):
    name = self._next("BatchNorm")
    if not self._building:
      return getattr(self, name)(x)
    # slim's NASNet arg scope: decay 0.9997, epsilon 1e-3.
    self.add_module(name, builder.CompactBatchNorm(x.shape[1], 0.9997, 1e-3,
                                                   use_scale=True))
    return x

  def _dense(self, x):
    name = self._next("Dense")
    if not self._building:
      return getattr(self, name)(x)
    cin = x.shape[1]
    self.add_module(name, builder.Affine(
        cin, self.nclass, activation=None, generator=self._generator,
        stddev=math.sqrt(1.0 / cin) / _TRUNC_CORRECTION))
    return x.new_empty(x.shape[0], self.nclass)

  # -- operations (nasnet_model.py:110-165) ---------------------------------

  def _sep_conv_layer(self, x, features, kernel, stride):
    """Depthwise, then pointwise (slim.separable_conv2d, multiplier 1)."""
    x = self._conv(x, x.shape[1], kernel, stride, groups=x.shape[1])
    return self._conv(x, features, 1)

  def _stacked_separable_conv(self, x, operation, filter_size, stride):
    kernel, num_layers = _op_info(operation)
    for _ in range(num_layers):
      x = torch.relu(x)
      x = self._sep_conv_layer(x, filter_size, kernel, stride)
      x = self._bn(x)
      stride = 1
    return x

  @staticmethod
  def _pooling(x, operation, stride):
    kind = "apool" if operation.startswith("avg") else "mpool"
    return builder.pool(x, kind, 3, stride, "SAME")

  def _factorized_reduction(self, x, output_filters, stride):
    if stride == 1:
      return self._bn(self._conv(x, output_filters, 1))
    # A 1x1-window strided pool is the grid subsampling.
    path1 = builder.pool(x, "mpool", 1, stride, "VALID")
    path1 = self._conv(path1, output_filters // 2, 1)
    # Shifted by one pixel, the second path samples the other grid.
    path2 = F.pad(x, (0, 1, 0, 1))[:, :, 1:, 1:]
    path2 = builder.pool(path2, "mpool", 1, stride, "VALID")
    path2 = self._conv(path2, output_filters - output_filters // 2, 1)
    return self._bn(torch.cat([path1, path2], dim=1))

  def _drop_path(self, x, cell_num, total_cells):
    if (self._building or not self.training or
        self.drop_path_keep_prob >= 1.0 or cell_num < 0):
      return x
    keep = drop_path_keep_prob(self.drop_path_keep_prob, cell_num,
                               total_cells, self._progress)
    keep = torch.as_tensor(keep, device=x.device).to(x.dtype)
    noise = keep + self.uniform((x.shape[0], 1, 1, 1), x.device, x.dtype)
    return x / keep * torch.floor(noise)

  # -- cells (nasnet_model.py:169-234) --------------------------------------

  def _reduce_prev_layer(self, prev, curr, filter_size):
    if prev is None:
      return curr
    if prev.shape[3] != curr.shape[3]:
      prev = torch.relu(prev)
      prev = self._factorized_reduction(prev, filter_size, 2)
    elif prev.shape[1] != filter_size:
      prev = torch.relu(prev)
      prev = self._bn(self._conv(prev, filter_size, 1))
    return prev

  def _apply_op(self, x, operation, stride, is_from_original_input,
                filter_size, cell_num, total_cells):
    if stride > 1 and not is_from_original_input:
      stride = 1
    input_filters = x.shape[1]
    if "separable" in operation:
      x = self._stacked_separable_conv(x, operation, filter_size, stride)
    elif operation == "none":
      if stride > 1 or input_filters != filter_size:
        x = torch.relu(x)
        x = self._bn(self._conv(x, filter_size, 1, stride))
    elif "pool" in operation:
      x = self._pooling(x, operation, stride)
      if input_filters != filter_size:
        x = self._bn(self._conv(x, filter_size, 1))
    else:
      raise ValueError(f"Unimplemented operation {operation}")
    if operation != "none":
      x = self._drop_path(x, cell_num, total_cells)
    return x

  def _cell(self, x, prev, operations, used_hiddenstates,
            hiddenstate_indices, filter_size, stride, cell_num,
            total_cells):
    prev = self._reduce_prev_layer(prev, x, filter_size)
    h = self._bn(self._conv(torch.relu(x), filter_size, 1))
    states = [h, prev]
    for it in range(5):
      li, ri = hiddenstate_indices[2 * it], hiddenstate_indices[2 * it + 1]
      h1 = self._apply_op(states[li], operations[2 * it], stride, li < 2,
                          filter_size, cell_num, total_cells)
      h2 = self._apply_op(states[ri], operations[2 * it + 1], stride,
                          ri < 2, filter_size, cell_num, total_cells)
      states.append(h1 + h2)
    final_w, final_c = states[-1].shape[3], states[-1].shape[1]
    outs = []
    for idx, used in enumerate(used_hiddenstates):
      if used:
        continue
      s = states[idx]
      if s.shape[3] != final_w or s.shape[1] != final_c:
        s = self._factorized_reduction(
            s, final_c, 2 if s.shape[3] != final_w else 1)
      outs.append(s)
    return torch.cat(outs, dim=1)

  def _aux_head(self, x, run: bool):
    """The auxiliary classifier (nasnet_model.py:236-249); ``run`` False
    steps the layer counters over it."""
    if not run:
      for kind, n in zip(("Conv", "BatchNorm", "Dense"), self._aux_layers):
        self._counts[kind] += n
      return None
    start = dict(self._counts)
    x = torch.relu(x)
    x = builder.pool(x, "apool", 5, 3, "VALID")
    x = torch.relu(self._bn(self._conv(x, 128, 1)))
    x = torch.relu(self._bn(self._conv(x, 768, x.shape[2], padding="VALID")))
    x = self._dense(builder.nhwc(x).reshape(x.shape[0], -1))
    if self._building:
      self._aux_layers = tuple(self._counts[k] - start[k]
                               for k in ("Conv", "BatchNorm", "Dense"))
    return x

  # -- the network (nasnet_model.py:253-332) --------------------------------

  def forward(self, images: torch.Tensor):
    self.begin_draws()
    x = model_lib.to_model_input(images, self.dtype)
    self._progress = None
    if self.training and self.total_steps > 0:
      self._progress = (self.step_counter(x.device).to(torch.float32) /
                        self.total_steps)
    logits, aux = self._run(x, self.training)
    logits = accum(logits)
    return logits if aux is None else (logits, accum(aux))

  def _run(self, x, train: bool):
    self._counts = {"Conv": 0, "BatchNorm": 0, "Dense": 0}
    reduction_indices = calc_reduction_layers(self.num_cells,
                                              self.num_reduction_layers)
    num_stem_cells = 2 if self.stem_type == "imagenet" else 0
    total_cells = (self.num_cells + num_stem_cells +
                   self.num_reduction_layers)
    cell_outputs = [None]
    true_cell_num = 0
    if self.stem_type == "imagenet":
      x = self._bn(self._conv(x, int(32 * self.stem_multiplier), 3, 2,
                              padding="VALID"))
      cell_outputs.append(x)
      filter_scaling = 1.0 / (self.filter_scaling_rate ** num_stem_cells)
      for _ in range(num_stem_cells):
        x = self._cell(
            x, cell_outputs[-2], REDUCTION_OPERATIONS,
            REDUCTION_USED_HIDDENSTATES, REDUCTION_HIDDENSTATE_INDICES,
            int(self.num_conv_filters * filter_scaling), 2, true_cell_num,
            total_cells)
        cell_outputs.append(x)
        filter_scaling *= self.filter_scaling_rate
        true_cell_num += 1
    else:
      x = self._bn(self._conv(
          x, int(self.num_conv_filters * self.stem_multiplier), 3))
      cell_outputs.append(x)
    aux_head_cell_idx = (reduction_indices[1] - 1
                         if len(reduction_indices) >= 2 else -1)
    aux_logits = None
    filter_scaling = 1.0
    prev_layer = None
    for cell_num in range(self.num_cells):
      if self.skip_reduction_layer_input:
        prev_layer = cell_outputs[-2]
      if cell_num in reduction_indices:
        filter_scaling *= self.filter_scaling_rate
        x = self._cell(
            x, cell_outputs[-2], REDUCTION_OPERATIONS,
            REDUCTION_USED_HIDDENSTATES, REDUCTION_HIDDENSTATE_INDICES,
            int(self.num_conv_filters * filter_scaling), 2, true_cell_num,
            total_cells)
        true_cell_num += 1
        cell_outputs.append(x)
      if not self.skip_reduction_layer_input:
        prev_layer = cell_outputs[-2]
      x = self._cell(
          x, prev_layer, NORMAL_OPERATIONS, NORMAL_USED_HIDDENSTATES,
          NORMAL_HIDDENSTATE_INDICES,
          int(self.num_conv_filters * filter_scaling), 1, true_cell_num,
          total_cells)
      true_cell_num += 1
      if self.use_aux_head and cell_num == aux_head_cell_idx:
        aux_logits = self._aux_head(x, train)
      cell_outputs.append(x)
    x = builder.spatial_mean(torch.relu(x))
    if (train and not self._building and
        self.dense_dropout_keep_prob < 1.0):
      x = builder.dropout(x, self.dense_dropout_keep_prob,
                          self.uniform(x.shape, x.device))
    return self._dense(x), aux_logits


class _NasnetBase(model_lib.CNNModel):
  """The three configurations' shared network plumbing."""

  _MODULE_KW: dict = {}

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    return NasnetNet(nclass, dtype, self.image_size, generator=generator,
                     **self._MODULE_KW).to(memory_format=torch.channels_last)


class NasnetModel(_NasnetBase):
  """NASNet-A mobile (nasnet_model.py:342-351)."""

  _MODULE_KW = dict(num_cells=12, num_conv_filters=44, stem_multiplier=1.0,
                    stem_type="imagenet", dense_dropout_keep_prob=0.5,
                    drop_path_keep_prob=1.0)

  def __init__(self, params=None):
    super().__init__("nasnet", 224, 32, 0.005, params=params)


class NasnetLargeModel(_NasnetBase):
  """NASNet-A large (nasnet_model.py:354-362)."""

  _MODULE_KW = dict(num_cells=18, num_conv_filters=168, stem_multiplier=3.0,
                    stem_type="imagenet", dense_dropout_keep_prob=0.5,
                    drop_path_keep_prob=0.7, skip_reduction_layer_input=True)

  def __init__(self, params=None):
    super().__init__("nasnet", 331, 16, 0.005, params=params)


class NasnetCifarModel(_NasnetBase):
  """NASNet-A CIFAR (nasnet_model.py:365-372)."""

  _MODULE_KW = dict(num_cells=18, num_conv_filters=32, stem_multiplier=3.0,
                    stem_type="cifar", dense_dropout_keep_prob=1.0,
                    drop_path_keep_prob=0.6)

  def __init__(self, params=None):
    super().__init__("nasnet", 32, 32, 0.025, params=params)


def create_nasnet_model(params=None):
  return NasnetModel(params=params)


def create_nasnetlarge_model(params=None):
  return NasnetLargeModel(params=params)


def create_nasnet_cifar_model(params=None):
  return NasnetCifarModel(params=params)
