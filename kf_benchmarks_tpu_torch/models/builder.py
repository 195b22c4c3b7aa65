"""Layers of the CNN models: batch norm, conv, pools, spatial mean, affine,
and a ConvNetBuilder for the column-parallel (Inception) networks.

The port's counterpart of kf_benchmarks_tpu/models/builder.py. The JAX
package builds each network imperatively through a ConvNetBuilder inside one
flax module; here each layer is an ``nn.Module`` created in the model's
``__init__`` under the flax name it has in the JAX package (``conv_stem``,
``resnet_v10_a_bn``, ``affine0``, ...; see convert.py for the mapping).
``ConvNetBuilder`` records the JAX builder's imperative calls (``conv``,
``mpool``, ``apool``, ``inception_module``, ...) as a graph of such layers
on a ``GraphNet``, which replays it in ``forward``.

Layout: the models take NHWC images, as the JAX package does, and run their
convolutions on NCHW-shaped tensors in ``torch.channels_last`` memory, which
is NHWC in memory. ``nhwc(x)`` is then a free view of the same storage.

Precision follows flax's ``dtype=``/``param_dtype=`` split: parameters are
f32 and each layer casts them to the compute dtype (bf16 under --use_fp16)
where it uses them; batch statistics are accumulated in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.models import model
from kf_benchmarks_tpu_torch.ops import conv_bn
from kf_benchmarks_tpu_torch.ops.conv_bn import accum


def nhwc(x: torch.Tensor) -> torch.Tensor:
  """NCHW-shaped channels_last tensor -> its contiguous NHWC view."""
  return x.permute(0, 2, 3, 1).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
  """Contiguous NHWC tensor -> its NCHW-shaped channels_last view."""
  return x.permute(0, 3, 1, 2)


class ChannelSums(torch.autograd.Function):
  """[sum x, sum x^2] per channel of an NHWC tensor, accumulated in f32.

  Saves only x itself for the backward (an f32 copy of x for x^2 would
  double the activation memory of every batch norm under bf16).
  """

  @staticmethod
  def forward(ctx, x):
    ctx.save_for_backward(x)
    xf = accum(x.reshape(-1, x.shape[-1]))
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])

  @staticmethod
  def backward(ctx, g):
    (x,) = ctx.saved_tensors
    return (g[0] + 2.0 * accum(x) * g[1]).to(x.dtype)


def channel_sums(x_nhwc: torch.Tensor) -> torch.Tensor:
  return ChannelSums.apply(x_nhwc)


class CompactBatchNorm(nn.Module):
  """Batch norm with statistics in f32 and the normalize in the compute
  dtype (builder.py:42-108 of the JAX package), with a bias and, unless
  ``use_scale`` is False (the JAX builder's default, which Inception
  keeps), a scale.

  * Training: biased ``var = max(E[x^2] - E[x]^2, 0)`` from f32 sums, and
    the flax-convention running update ``m*ra + (1-m)*batch`` in place on
    the ``mean``/``var`` buffers. ``nn.BatchNorm2d`` would keep the
    unbiased variance instead.
  * Normalize subtract-first in the compute dtype:
    ``(x - mean) * (inv*scale) + bias``.
  * ``sums`` lets a caller hand in ``[sum x, sum x^2]`` computed elsewhere
    (the fused conv kernel's epilogue) instead of reducing x again.
  """

  def __init__(self, features: int, momentum: float, epsilon: float,
               use_scale: bool = True):
    super().__init__()
    self.features = features
    self.momentum = momentum
    self.epsilon = epsilon
    self.scale = nn.Parameter(torch.ones(features)) if use_scale else None
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer("mean", torch.zeros(features))
    self.register_buffer("var", torch.ones(features))

  def moments(self, x: torch.Tensor, sums: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) in f32: the batch's in training (updating the running
    averages), the running averages otherwise."""
    if not self.training:
      return self.mean, self.var
    if sums is None:
      sums = channel_sums(nhwc(x))
    n = x.numel() // self.features
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    with torch.no_grad():
      m = self.momentum
      self.mean.copy_(m * self.mean + (1 - m) * mean)
      self.var.copy_(m * self.var + (1 - m) * var)
    return mean, var

  def forward(self, x: torch.Tensor, sums: Optional[torch.Tensor] = None):
    mean, var = self.moments(x, sums)
    bias = accum(self.bias)
    a = self._scaled(torch.rsqrt(var + self.epsilon))
    dt = x.dtype
    shape = (1, -1, 1, 1)
    return ((x - mean.to(dt).view(shape)) * a.to(dt).view(shape) +
            bias.to(dt).view(shape))

  def scale_shift(self, x: torch.Tensor, sums: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This batch norm folded to f32 (sc, sh), y = x*sc + sh, for a
    consumer that applies it itself (the fused conv unit's prologue)."""
    mean, var = self.moments(x, sums)
    sc = self._scaled(torch.rsqrt(var + self.epsilon))
    bias = accum(self.bias)
    return sc, bias - mean * sc

  def _scaled(self, inv: torch.Tensor) -> torch.Tensor:
    return inv if self.scale is None else inv * accum(self.scale)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
  """TF ``SAME`` padding (before, after) of one spatial dim: the extra
  pixel goes after."""
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


def _pair(k: Union[int, Sequence[int]]) -> Tuple[int, int]:
  return (k, k) if isinstance(k, int) else (int(k[0]), int(k[1]))


class Conv(nn.Module):
  """2-D conv, no bias (every conv of the ported models feeds a batch
  norm).

  ``k`` and ``stride`` are an int or (height, width). ``mode`` as in the
  JAX builder (builder.py:176-226): ``SAME_RESNET`` pads k-1 in total,
  half before, with stride > 1 and is ``SAME`` with stride 1; ``SAME`` is
  TF's (pad after when the total is odd); ``VALID`` pads nothing. Weight
  OIHW f32, Glorot-uniform (the Keras default the reference inherits,
  builder.py:195).
  """

  def __init__(self, cin: int, cout: int, k, stride=1,
               mode: str = "SAME", generator: Optional[torch.Generator] = None):
    super().__init__()
    if mode not in ("SAME", "SAME_RESNET", "VALID"):
      raise ValueError(f"Invalid conv mode {mode!r}")
    self.k, self.stride, self.mode = _pair(k), _pair(stride), mode
    kh, kw = self.k
    self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
    limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
    with torch.no_grad():
      self.weight.uniform_(-limit, limit, generator=generator)

  def pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right)."""
    (kh, kw), (sh, sw) = self.k, self.stride
    if self.mode == "VALID":
      return 0, 0, 0, 0
    if self.mode == "SAME_RESNET" and (sh > 1 or sw > 1):
      ph, pw = kh - 1, kw - 1
      return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
    return same_pads(h, kh, sh) + same_pads(w, kw, sw)

  def out_size(self, h: int, w: int) -> Tuple[int, int]:
    t, b, l, r = self.pads(h, w)
    (kh, kw), (sh, sw) = self.k, self.stride
    return (h + t + b - kh) // sh + 1, (w + l + r - kw) // sw + 1

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    t, b, l, r = self.pads(x.shape[2], x.shape[3])
    w = self.weight.to(x.dtype, memory_format=torch.channels_last)
    if t == b and l == r:
      return F.conv2d(x, w, stride=self.stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.stride)


def mpool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
  """Max pool with TF ``SAME`` padding by -inf (at 112 -> 56 with k=3,
  s=2 that is (0, 1): after only, which ``max_pool2d(padding=1)`` would
  get wrong)."""
  return pool(x, "mpool", (k, k), (stride, stride), "SAME")


def pool(x: torch.Tensor, kind: str, k, stride, mode: str) -> torch.Tensor:
  """Max (``mpool``) or average (``apool``) pool in ``VALID`` or TF
  ``SAME`` mode (builder.py:228-252). SAME pads max pools with -inf and
  divides an average by the count of in-image elements of its window
  (count_include_pad=False), as the JAX builder's reduce_window of ones
  does."""
  (kh, kw), (sh, sw) = _pair(k), _pair(stride)
  if mode == "VALID":
    if kind == "mpool":
      return F.max_pool2d(x, (kh, kw), (sh, sw))
    return F.avg_pool2d(x, (kh, kw), (sh, sw))
  if mode != "SAME":
    raise ValueError(f"Invalid pool mode {mode!r}")
  t, b = same_pads(x.shape[2], kh, sh)
  l, r = same_pads(x.shape[3], kw, sw)
  if kind == "mpool":
    x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, (kh, kw), (sh, sw))
  summed = F.avg_pool2d(F.pad(x, (l, r, t, b)), (kh, kw), (sh, sw),
                        divisor_override=1)
  ones = F.pad(x.new_ones(1, 1, x.shape[2], x.shape[3]), (l, r, t, b))
  counts = F.avg_pool2d(ones, (kh, kw), (sh, sw), divisor_override=1)
  return summed / counts


def pool_out_size(h: int, w: int, k, stride, mode: str) -> Tuple[int, int]:
  (kh, kw), (sh, sw) = _pair(k), _pair(stride)
  if mode == "SAME":
    return -(-h // sh), -(-w // sw)
  return (h - kh) // sh + 1, (w - kw) // sw + 1


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
  """Global average pool over H, W (NCHW-shaped input) -> [N, C]."""
  return x.mean((2, 3))


class Affine(nn.Module):
  """Fully connected layer (builder.py:277-309, init :288-294): weight (out, in) f32 from a
  fan-in truncated normal (std sqrt(f/in), f = 2 before a relu, else 1;
  cut at two standard deviations as flax's truncated_normal), bias 0."""

  def __init__(self, cin: int, cout: int, activation: Optional[str] = "relu",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.activation = activation
    std = math.sqrt((2.0 if activation == "relu" else 1.0) / cin)
    self.weight = nn.Parameter(torch.empty(cout, cin))
    self.bias = nn.Parameter(torch.zeros(cout))
    with torch.no_grad():
      nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                            generator=generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    y = F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
    if self.activation == "relu":
      y = torch.relu(y)
    elif self.activation not in (None, "linear"):
      raise KeyError(f"Invalid activation type {self.activation!r}")
    return y


def fusable_conv3x3(cin: int, cout: int, k, stride, mode: str,
                    h: int = 1, w: int = 1) -> bool:
  """Whether a conv of this shape can run as the fused BN-ReLU-conv3x3
  unit (ops/conv_bn.py ``FusedBnReluConv3x3``): a 3x3 stride-1 SAME conv
  whose shapes both of the unit's kernels take -- K-B forward on
  x [N,h,w,cin] -> cout, K-A on the input gradient, cout -> cin. Decided
  from the shapes alone (at N = 1: the kernels' one size limit, 2^31
  pixel-channels, is far above every model of the zoo), so a module picks
  its route when it is built."""
  if _pair(k) != (3, 3) or _pair(stride) != (1, 1) or \
      mode not in ("SAME", "SAME_RESNET"):
    return False
  fwd = conv_bn.kernel_shape_error("bn_relu_conv3x3_stats", (1, h, w, cin),
                                   (cout, 3, 3, cin), 64, kmajor=True)
  bwd = conv_bn.kernel_shape_error("conv3x3_same", (1, h, w, cout),
                                   (cin, 3, 3, cout), 64, kmajor=True)
  return fwd is None and bwd is None


def _activate(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
  if activation in (None, "linear"):
    return x
  if activation == "relu":
    return torch.relu(x)
  raise KeyError(f"Invalid activation type {activation!r}")


class _Step:
  """One recorded builder call: ``kind`` reads node(s) ``src`` and writes
  node ``dst``; ``args`` holds the call's settings."""

  __slots__ = ("kind", "src", "dst", "args")

  def __init__(self, kind, src, dst, **args):
    self.kind, self.src, self.dst, self.args = kind, src, dst, args


class GraphNet(nn.Module):
  """A network recorded by ``ConvNetBuilder``: its layers are this module's
  children under their flax names (``conv0``, ``conv0_bn``, ...,
  ``affine0``), and ``forward`` replays the recorded calls on NHWC images,
  returning f32 logits.

  A conv whose input is the batch norm and ReLU of the conv before it,
  which nothing else reads, and whose shape the fused unit takes
  (``fusable_conv3x3``) runs as ``FusedBnReluConv3x3``: the producer hands
  on its raw output and the unit applies the producer's batch norm and
  ReLU in its prologue and returns the statistics of its own batch norm.
  ``fused`` names those convs; ``fuse = False`` before the first call runs
  every conv plain (the tests' reference path).
  """

  def __init__(self, dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.steps: List[_Step] = []
    self.fused: List[str] = []
    self.fuse = True

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    vals: Dict[int, object] = {0: model.to_model_input(images, self.dtype)}
    for step in self.steps:
      vals[step.dst] = getattr(self, "_" + step.kind)(step, vals)
    return accum(vals[self.steps[-1].dst])

  def _conv(self, step: _Step, vals):
    a = step.args
    name = a["name"]
    conv = getattr(self, name)
    bn = getattr(self, name + "_bn") if a["bn"] else None
    sums = None
    if self.fuse and a.get("fused_from"):
      raw, raw_sums = vals[step.src]
      sc, sh = getattr(self, a["fused_from"] + "_bn").scale_shift(
          raw, raw_sums)
      # OIHW [CO,C,3,3] -> the K-major [CO,3,3,C] the unit reads.
      w_k = conv.weight.to(raw.dtype).permute(0, 2, 3, 1).contiguous()
      y, sums = conv_bn.fused_bn_relu_conv3x3(nhwc(raw), sc, sh, w_k)
      y = nchw(y)
    else:
      y = conv(vals[step.src])
    if self.fuse and a.get("defer"):
      return y, sums
    if bn is not None:
      y = bn(y, sums=sums)
    return _activate(y, a["activation"])

  def _pool(self, step: _Step, vals):
    a = step.args
    return pool(vals[step.src], a["pool"], a["k"], a["stride"], a["mode"])

  def _concat(self, step: _Step, vals):
    return torch.cat([vals[s] for s in step.src], dim=1)

  def _mean(self, step: _Step, vals):
    return spatial_mean(vals[step.src])

  def _flatten(self, step: _Step, vals):
    x = vals[step.src]
    return nhwc(x).reshape(x.shape[0], -1) if x.dim() == 4 else x

  def _affine(self, step: _Step, vals):
    return getattr(self, step.args["name"])(vals[step.src])


class ConvNetBuilder:
  """Records the JAX builder's calls (builder.py:111-338 of the JAX
  package: conv, mpool, apool, inception_module, spatial_mean, reshape,
  affine) onto a ``GraphNet``, naming layers with the same counters, so
  the flax variable names and the port's state_dict keys coincide. Nodes
  are ints (0 = the input); ``top`` is the newest, as the JAX builder's
  ``top_layer``. Shapes (C, H, W) are tracked so each conv's route is
  picked when it is built. Call ``finish()`` after the last layer."""

  def __init__(self, net: GraphNet, image_size: int, depth: int = 3,
               generator: Optional[torch.Generator] = None):
    self.net = net
    self.generator = generator
    self.use_batch_norm = False
    # The reference batch-norm defaults (builder.py:136-137).
    self.batch_norm_config = {"decay": 0.999, "epsilon": 0.001,
                              "scale": False}
    self.counts: Dict[str, int] = {}
    self.shapes: Dict[int, Tuple[int, int, int]] = {
        0: (depth, image_size, image_size)}
    self.top = 0

  @property
  def top_size(self) -> int:
    return self.shapes[self.top][0]

  def _name(self, kind: str) -> str:
    n = self.counts.get(kind, 0)
    self.counts[kind] = n + 1
    return f"{kind}{n}"

  def _add(self, kind: str, src, shape, **args) -> int:
    dst = len(self.shapes)
    self.shapes[dst] = shape
    self.net.steps.append(_Step(kind, src, dst, **args))
    self.top = dst
    return dst

  def conv(self, num_out_channels: int, k_height: int, k_width: int,
           d_height: int = 1, d_width: int = 1, mode: str = "SAME",
           input_layer: Optional[int] = None,
           use_batch_norm: Optional[bool] = None,
           activation: Optional[str] = "relu", name: Optional[str] = None):
    src = self.top if input_layer is None else input_layer
    use_bn = self.use_batch_norm if use_batch_norm is None \
        else use_batch_norm
    if not use_bn:
      raise NotImplementedError(
          "a conv without batch norm carries a bias in the JAX builder; "
          "no ported model has one")
    name = name or self._name("conv")
    cin, h, w = self.shapes[src]
    conv = Conv(cin, num_out_channels, (k_height, k_width),
                (d_height, d_width), mode, generator=self.generator)
    self.net.add_module(name, conv)
    cfg = self.batch_norm_config
    self.net.add_module(name + "_bn", CompactBatchNorm(
        num_out_channels, cfg["decay"], cfg["epsilon"],
        use_scale=cfg["scale"]))
    oh, ow = conv.out_size(h, w)
    return self._add("conv", src, (num_out_channels, oh, ow), name=name,
                     bn=True, activation=activation,
                     fusable=fusable_conv3x3(
                         cin, num_out_channels, conv.k, conv.stride, mode,
                         h, w))

  def _pool(self, kind: str, k_height, k_width, d_height, d_width, mode,
            input_layer):
    src = self.top if input_layer is None else input_layer
    self._name(kind)  # advances the counter, as the JAX builder does
    c, h, w = self.shapes[src]
    oh, ow = pool_out_size(h, w, (k_height, k_width), (d_height, d_width),
                           mode)
    return self._add("pool", src, (c, oh, ow), pool=kind,
                     k=(k_height, k_width), stride=(d_height, d_width),
                     mode=mode)

  def mpool(self, k_height, k_width, d_height=2, d_width=2, mode="VALID",
            input_layer=None):
    return self._pool("mpool", k_height, k_width, d_height, d_width, mode,
                      input_layer)

  def apool(self, k_height, k_width, d_height=2, d_width=2, mode="VALID",
            input_layer=None):
    return self._pool("apool", k_height, k_width, d_height, d_width, mode,
                      input_layer)

  def inception_module(self, name: str, cols: Sequence[Sequence]):
    """Column-parallel spec interpreter (builder.py:306-338): each column
    is a list of (op_name, *args) over conv / mpool / apool, its first op
    reading the module's input; a ``("share",)`` entry reuses the previous
    column's layer at the same depth. The columns' last layers are
    concatenated on the channel axis."""
    del name
    start = self.top
    col_layers: List[List[int]] = []
    for c, column in enumerate(cols):
      col_layers.append([])
      for l, op_spec in enumerate(column):
        op_name, args = op_spec[0], op_spec[1:]
        kwargs = {"input_layer": start} if l == 0 else {}
        if op_name == "share":
          self.top = col_layers[c - 1][l]
        elif op_name in ("conv", "mpool", "apool"):
          getattr(self, op_name)(*args, **kwargs)
        else:
          raise KeyError(
              f"Invalid layer type for inception module: {op_name!r}")
        col_layers[c].append(self.top)
    ends = [layers[-1] for layers in col_layers]
    _, h, w = self.shapes[ends[0]]
    return self._add("concat", ends,
                     (sum(self.shapes[e][0] for e in ends), h, w))

  def spatial_mean(self):
    c, _, _ = self.shapes[self.top]
    return self._add("mean", self.top, (c, 1, 1))

  def flatten(self):
    """The JAX builder's ``reshape([-1, C*H*W])`` of an NHWC tensor."""
    c, h, w = self.shapes[self.top]
    return self._add("flatten", self.top, (c * h * w, 1, 1))

  def affine(self, num_out_channels: int, activation: Optional[str] = "relu"):
    name = self._name("affine")
    self.net.add_module(name, Affine(self.top_size, num_out_channels,
                                     activation, generator=self.generator))
    return self._add("affine", self.top, (num_out_channels, 1, 1),
                     name=name)

  def finish(self) -> GraphNet:
    """Picks the fused route: a fusable conv whose input node is written
    by a conv with batch norm and ReLU and read by nothing else."""
    readers: Dict[int, int] = {}
    for step in self.net.steps:
      for s in (step.src if isinstance(step.src, list) else [step.src]):
        readers[s] = readers.get(s, 0) + 1
    writer = {step.dst: step for step in self.net.steps}
    for step in self.net.steps:
      prod = writer.get(step.src) if step.kind == "conv" else None
      if (step.args.get("fusable") and prod is not None and
          prod.kind == "conv" and prod.args["bn"] and
          prod.args["activation"] == "relu" and readers[step.src] == 1):
        prod.args["defer"] = True
        step.args["fused_from"] = prod.args["name"]
        self.net.fused.append(step.args["name"])
    return self.net
