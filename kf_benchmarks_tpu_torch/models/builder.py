"""Layers of the CNN models: batch norm, conv, pools, spatial mean, affine,
dropout, local response normalisation, and a ConvNetBuilder on which the
zoo's networks are recorded (column-parallel Inception modules, residual
adds, dense concatenations, auxiliary heads).

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
where it uses them; batch statistics are accumulated in f32. Under
--fp16_vars the parameters are stored bf16 (models/model.py
``cast_params``): the convs and the dense layers then read them as they
are, and batch norm upcasts its scale and offset to f32 (the JAX
builder's ``.astype(float32)``, builder.py:95-99), so K-B's prologue still
takes f32 ``sc``/``sh``; the running averages stay f32.
"""

from __future__ import annotations

import contextlib
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
  * ``features_last``: the input is (..., features) contiguous (a
    sequence model's (batch, time, features)) instead of an NCHW-shaped
    tensor; the statistics reduce over every axis but the last, as flax's.
  """

  def __init__(self, features: int, momentum: float, epsilon: float,
               use_scale: bool = True, features_last: bool = False):
    super().__init__()
    self.features = features
    self.features_last = features_last
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
      sums = channel_sums(x if self.features_last else nhwc(x))
    n = x.numel() // self.features
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    # The running averages from detached moments: no autograd record, and
    # no grad-mode region for torch.export to split the program at.
    m = self.momentum
    self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
    self.var.copy_(m * self.var + (1 - m) * var.detach())
    return mean, var

  def forward(self, x: torch.Tensor, sums: Optional[torch.Tensor] = None):
    mean, var = self.moments(x, sums)
    bias = accum(self.bias)
    a = self._scaled(torch.rsqrt(var + self.epsilon))
    dt = x.dtype
    shape = (-1,) if self.features_last else (1, -1, 1, 1)
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
  """2-D conv, with a bias only where no batch norm follows it (the JAX
  builder's ``use_bias=not use_bn and bias is not None``, builder.py:206).

  ``k`` and ``stride`` are an int or (height, width). ``mode`` as in the
  JAX builder (builder.py:176-226): ``SAME_RESNET`` pads k-1 in total,
  half before, with stride > 1 and is ``SAME`` with stride 1; ``SAME`` is
  TF's (pad after when the total is odd); ``VALID`` pads nothing. Weight
  OIHW f32, Glorot-uniform (the Keras default the reference inherits,
  builder.py:195) or, given ``stddev``, a normal cut at two standard
  deviations; the bias starts at ``bias``. ``groups`` > 1 is a grouped
  (depthwise, when it equals the channels) conv, weight [CO, C/groups,
  kh, kw].
  """

  def __init__(self, cin: int, cout: int, k, stride=1,
               mode: str = "SAME", generator: Optional[torch.Generator] = None,
               bias: Optional[float] = None, stddev: Optional[float] = None,
               groups: int = 1):
    super().__init__()
    if mode not in ("SAME", "SAME_RESNET", "VALID"):
      raise ValueError(f"Invalid conv mode {mode!r}")
    self.k, self.stride, self.mode = _pair(k), _pair(stride), mode
    self.groups = groups
    kh, kw = self.k
    self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
    with torch.no_grad():
      if stddev is None:
        fan = kh * kw * cin // groups
        limit = math.sqrt(6.0 / (fan + kh * kw * cout // groups))
        self.weight.uniform_(-limit, limit, generator=generator)
      else:
        nn.init.trunc_normal_(self.weight, 0.0, stddev, -2 * stddev,
                              2 * stddev, generator=generator)
    self.bias = (None if bias is None else
                 nn.Parameter(torch.full((cout,), float(bias))))

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
    bias = None if self.bias is None else self.bias.to(x.dtype)
    if t == b and l == r:
      return F.conv2d(x, w, bias, stride=self.stride, padding=(t, l),
                      groups=self.groups)
    return F.conv2d(F.pad(x, (l, r, t, b)), w, bias, stride=self.stride,
                    groups=self.groups)


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
  fan-in truncated normal (std sqrt(f/in), f = 2 before a relu, else 1, or
  ``stddev``; cut at two standard deviations as flax's truncated_normal),
  bias ``bias``."""

  def __init__(self, cin: int, cout: int, activation: Optional[str] = "relu",
               generator: Optional[torch.Generator] = None,
               stddev: Optional[float] = None, bias: float = 0.0):
    super().__init__()
    self.activation = activation
    std = stddev if stddev is not None else math.sqrt(
        (2.0 if activation == "relu" else 1.0) / cin)
    self.weight = nn.Parameter(torch.empty(cout, cin))
    self.bias = nn.Parameter(torch.full((cout,), float(bias)))
    with torch.no_grad():
      nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                            generator=generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    y = F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
    return activate(y, self.activation)


def lrn(x: torch.Tensor, depth_radius: int, bias: float, alpha: float,
        beta: float) -> torch.Tensor:
  """TF's local response normalisation (builder.py:387-406 of the JAX
  package): ``x / (bias + alpha * sum_{c-r..c+r} x^2) ^ beta`` over the
  channels of an NCHW-shaped tensor. ``alpha`` multiplies the sum itself
  (``F.local_response_norm`` would divide it by the window first). The
  sum of squares runs in f32."""
  sq = accum(x).square().unsqueeze(1)  # [N, 1, C, H, W]
  window = 2 * depth_radius + 1
  sums = F.avg_pool3d(sq, (window, 1, 1), stride=1,
                      padding=(depth_radius, 0, 0), divisor_override=1)
  return (accum(x) / (bias + alpha * sums.squeeze(1)).pow(beta)).to(x.dtype)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
  """x * c mod 2^32 of a value in [0, 2^32) (an int64 tensor or a Python
  int) by a 32-bit constant, in two 16-bit halves so that no int64
  product overflows."""
  return ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & _M32


def _mix32(x):
  """A 32-bit integer hash (lowbias32) of a value in [0, 2^32)."""
  x = x ^ (x >> 16)
  x = _mul32(x, 0x7FEB352D)
  x = x ^ (x >> 15)
  x = _mul32(x, 0x846CA68B)
  return x ^ (x >> 16)


# The mantissa bits of a uniform draw in each dtype: a draw is a multiple of
# 2^-bits below 1, exact in that dtype (as jax.random.uniform's).
_MANTISSA_BITS = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}


def counter_uniform(shape, seed: int, step: torch.Tensor, stream: int,
                    device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """Uniforms in [0, 1) of ``shape`` and ``dtype``, a function of (seed, the step
  counter's value, stream, element) alone: a counter-based draw, so a
  step captured as a CUDA graph draws fresh values at each replay (the
  graph reads the counter the step advances on the device), as the JAX
  package's ``fold_in(fold_in(rng, step), replica)`` streams do. ``step``
  is a 0-d int64 tensor; ``stream`` (a Python int below 2^32) tells the
  draws of one step apart."""
  key = _mix32(_mix32((seed & _M32) ^ _mix32(seed >> 32 & _M32)) ^ stream)
  step_key = _mix32((step.to(device) & _M32) ^ key)
  n = math.prod(shape)
  h = _mix32(_mix32(torch.arange(n, device=device) ^ step_key) ^
             _mix32(key ^ 0x9E3779B9))
  bits = _MANTISSA_BITS[dtype]
  return ((h >> (32 - bits)).to(torch.float32) * 2.0 ** -bits).to(
      dtype).reshape(shape)


def dropout(x: torch.Tensor, keep_prob: float,
            uniform: torch.Tensor) -> torch.Tensor:
  """Inverted dropout (flax ``nn.Dropout(rate=1 - keep_prob)``): keep each
  element whose ``uniform`` draw is below ``keep_prob`` and scale the kept
  ones by 1 / keep_prob."""
  return torch.where(uniform < keep_prob, x / keep_prob,
                     torch.zeros((), dtype=x.dtype, device=x.device))


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


def activate(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
  """The JAX builder's activations (builder.py:27-38)."""
  if activation in (None, "linear"):
    return x
  if activation == "relu":
    return torch.relu(x)
  if activation == "relu6":
    return torch.clamp(x, 0.0, 6.0)
  if activation == "tanh":
    return torch.tanh(x)
  if activation == "sigmoid":
    return torch.sigmoid(x)
  raise KeyError(f"Invalid activation type {activation!r}")


class _Step:
  """One recorded builder call: ``kind`` reads node(s) ``src`` and writes
  node ``dst``; ``args`` holds the call's settings."""

  __slots__ = ("kind", "src", "dst", "args")

  def __init__(self, kind, src, dst, **args):
    self.kind, self.src, self.dst, self.args = kind, src, dst, args


class SeededDropout:
  """Mixin of a network that draws random numbers in training (dropout,
  NASNet's drop path): each draw is ``counter_uniform`` of
  ``dropout_seed`` (drawn from the build's generator, so from the run's
  seed) and of the step counter ``rng_step`` (a 0-d int64 device tensor
  the train step binds and advances; 0 when none is bound), in a stream
  of its own for the replica ``rng_replica``, the microbatch
  ``rng_microbatch`` and the draw's place in the forward. ``total_steps``
  is the run's length, which NASNet's drop-path schedule reads (0: no
  schedule over the run)."""

  dropout_seed = 0
  rng_step: Optional[torch.Tensor] = None
  rng_replica = 0
  rng_microbatch = 0
  total_steps = 0
  _draws = 0

  def seed_dropout(self, generator: Optional[torch.Generator]) -> None:
    if generator is not None:
      self.dropout_seed = int(torch.randint(
          0, 2 ** 62, (1,), generator=generator, device=generator.device))

  def begin_draws(self) -> None:
    """Called at the start of each forward: the draws restart at place 0."""
    self._draws = 0

  def step_counter(self, device: torch.device) -> torch.Tensor:
    if self.rng_step is None:
      return torch.zeros((), dtype=torch.int64, device=device)
    return self.rng_step

  def uniform(self, shape, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The next draw of this forward."""
    place = self._draws
    self._draws += 1
    stream = _mix32((_mix32(self.rng_replica) ^ self.rng_microbatch) +
                    place & _M32)
    return counter_uniform(tuple(shape), self.dropout_seed,
                           self.step_counter(device), stream, device, dtype)


class GraphNet(SeededDropout, nn.Module):
  """A network recorded by ``ConvNetBuilder``: its layers are this module's
  children under their flax names (``conv0``, ``conv0_bn``, ...,
  ``affine0``), and ``forward`` replays the recorded calls on NHWC images,
  returning f32 logits, or (logits, auxiliary logits) for a network with
  an auxiliary head.

  A conv whose input is the batch norm and ReLU of the conv before it,
  which nothing else reads, and whose shape the fused unit takes
  (``fusable_conv3x3``) runs as ``FusedBnReluConv3x3``: the producer hands
  on its raw output and the unit applies the producer's batch norm and
  ReLU in its prologue and returns the statistics of its own batch norm.
  ``fused`` names those convs; ``fuse = False`` before the first call runs
  every conv plain (the tests' reference path).

  Dropout acts in training mode only (``SeededDropout``).
  """

  def __init__(self, dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.steps: List[_Step] = []
    self.fused: List[str] = []
    self.outputs: List[int] = []
    self.fuse = True

  def forward(self, images: torch.Tensor):
    self.begin_draws()
    vals: Dict[int, object] = {0: model.to_model_input(images, self.dtype)}
    for step in self.steps:
      vals[step.dst] = getattr(self, "_" + step.kind)(step, vals)
    outs = [accum(vals[o]) for o in self.outputs]
    return outs[0] if len(outs) == 1 else tuple(outs)

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
    return activate(y, a["activation"])

  def _bn(self, step: _Step, vals):
    return getattr(self, step.args["name"])(vals[step.src])

  def _act(self, step: _Step, vals):
    return activate(vals[step.src], step.args["activation"])

  def _add(self, step: _Step, vals):
    a, b = step.src
    return vals[a] + vals[b]

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
    return getattr(self, step.args["name"])(self._flatten(step, vals))

  def _lrn(self, step: _Step, vals):
    a = step.args
    return lrn(vals[step.src], a["depth_radius"], a["bias"], a["alpha"],
               a["beta"])

  def _dropout(self, step: _Step, vals):
    x = vals[step.src]
    if not self.training or step.args["keep_prob"] >= 1.0:
      return x
    return dropout(x, step.args["keep_prob"],
                   self.uniform(x.shape, x.device))


class ConvNetBuilder:
  """Records the JAX builder's calls (builder.py:111-406 of the JAX
  package: conv, mpool, apool, reshape, affine, inception_module,
  spatial_mean, dropout, batch_norm, lrn, switch_to_aux_top_layer) onto a
  ``GraphNet``, naming layers with the same counters, so the flax variable
  names and the port's state_dict keys coincide. ``relu``, ``add`` and
  ``concat`` stand for the jnp operations the JAX models apply to
  ``top_layer`` between builder calls (the residual adds, DenseNet's
  concatenation). Nodes are ints (0 = the input); ``top`` is the newest, as
  the JAX builder's ``top_layer``. Shapes (C, H, W) are tracked so each
  conv's route is picked when it is built. Call ``finish()`` after the last
  layer."""

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
    self.aux_top: Optional[int] = None

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

  @contextlib.contextmanager
  def switch_to_aux_top_layer(self):
    """Redirects the calls onto the auxiliary head (builder.py:161-174)."""
    if self.aux_top is None:
      raise RuntimeError("aux_top_layer not set")
    self.top, self.aux_top = self.aux_top, self.top
    try:
      yield
    finally:
      self.top, self.aux_top = self.aux_top, self.top

  def _batch_norm_module(self, features: int, decay=None, scale=None,
                         epsilon=None) -> CompactBatchNorm:
    cfg = self.batch_norm_config
    return CompactBatchNorm(
        features, cfg["decay"] if decay is None else decay,
        cfg["epsilon"] if epsilon is None else epsilon,
        use_scale=cfg["scale"] if scale is None else scale)

  def conv(self, num_out_channels: int, k_height: int, k_width: int,
           d_height: int = 1, d_width: int = 1, mode: str = "SAME",
           input_layer: Optional[int] = None,
           num_channels_in: Optional[int] = None,
           use_batch_norm: Optional[bool] = None,
           stddev: Optional[float] = None,
           activation: Optional[str] = "relu", bias: Optional[float] = 0.0,
           name: Optional[str] = None):
    del num_channels_in  # read from the input's shape
    src = self.top if input_layer is None else input_layer
    use_bn = self.use_batch_norm if use_batch_norm is None \
        else use_batch_norm
    name = name or self._name("conv")
    cin, h, w = self.shapes[src]
    conv = Conv(cin, num_out_channels, (k_height, k_width),
                (d_height, d_width), mode, generator=self.generator,
                bias=None if use_bn or bias is None else bias,
                stddev=stddev)
    self.net.add_module(name, conv)
    if use_bn:
      self.net.add_module(name + "_bn",
                          self._batch_norm_module(num_out_channels))
    oh, ow = conv.out_size(h, w)
    return self._add("conv", src, (num_out_channels, oh, ow), name=name,
                     bn=use_bn, activation=activation,
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
    return self.concat([layers[-1] for layers in col_layers])

  def concat(self, layers: Sequence[int]) -> int:
    """``jnp.concatenate`` of ``layers`` on the channel axis."""
    _, h, w = self.shapes[layers[0]]
    return self._add("concat", list(layers),
                     (sum(self.shapes[e][0] for e in layers), h, w))

  def spatial_mean(self, input_layer: Optional[int] = None):
    src = self.top if input_layer is None else input_layer
    c, _, _ = self.shapes[src]
    return self._add("mean", src, (c, 1, 1))

  def reshape(self, shape, input_layer: Optional[int] = None):
    """The JAX builder's ``reshape([-1, C*H*W])`` of an NHWC tensor
    (builder.py:268-274): the models' only use, flattening before an
    affine."""
    src = self.top if input_layer is None else input_layer
    c, h, w = self.shapes[src]
    if len(shape) != 2 or shape[0] != -1 or shape[1] != c * h * w:
      raise ValueError(f"reshape to {list(shape)} of a [-1, {h}, {w}, {c}] "
                       "tensor: only the flatten is supported")
    return self._add("flatten", src, (c * h * w, 1, 1))

  def flatten(self):
    c, h, w = self.shapes[self.top]
    return self.reshape([-1, c * h * w])

  def affine(self, num_out_channels: int, input_layer: Optional[int] = None,
             num_channels_in: Optional[int] = None, bias: float = 0.0,
             stddev: Optional[float] = None,
             activation: Optional[str] = "relu", name: Optional[str] = None):
    del num_channels_in
    src = self.top if input_layer is None else input_layer
    name = name or self._name("affine")
    c, h, w = self.shapes[src]
    self.net.add_module(name, Affine(c * h * w, num_out_channels, activation,
                                     generator=self.generator,
                                     stddev=stddev, bias=bias))
    return self._add("affine", src, (num_out_channels, 1, 1), name=name)

  def dropout(self, keep_prob: float = 0.5,
              input_layer: Optional[int] = None):
    """(builder.py:349-357) Note keep_prob, not rate."""
    src = self.top if input_layer is None else input_layer
    self._name("dropout")
    return self._add("dropout", src, self.shapes[src], keep_prob=keep_prob)

  def batch_norm(self, input_layer: Optional[int] = None, decay=None,
                 scale=None, epsilon=None, name: Optional[str] = None):
    """A batch norm as a layer of its own (builder.py:359-385), with the
    builder's ``batch_norm_config`` unless overridden."""
    src = self.top if input_layer is None else input_layer
    name = name or self._name("batchnorm")
    self.net.add_module(name, self._batch_norm_module(
        self.shapes[src][0], decay, scale, epsilon))
    return self._add("bn", src, self.shapes[src], name=name)

  def lrn(self, depth_radius: int, bias: float, alpha: float, beta: float,
          input_layer: Optional[int] = None):
    """(builder.py:387-406) see ``lrn``."""
    src = self.top if input_layer is None else input_layer
    return self._add("lrn", src, self.shapes[src], depth_radius=depth_radius,
                     bias=bias, alpha=alpha, beta=beta)

  def relu(self, input_layer: Optional[int] = None):
    src = self.top if input_layer is None else input_layer
    return self._add("act", src, self.shapes[src], activation="relu")

  def add(self, a: int, b: int):
    """The residual sum ``a + b``."""
    return self._add("add", [a, b], self.shapes[a])

  def finish(self, outputs: Optional[Sequence[int]] = None) -> GraphNet:
    """Names the network's outputs (the top, by default) and picks the
    fused route: a fusable conv whose input node is written by a conv with
    batch norm and ReLU and read by nothing else."""
    self.net.outputs = list(outputs) if outputs is not None else [self.top]
    readers: Dict[int, int] = {}
    for step in self.net.steps:
      for s in (step.src if isinstance(step.src, list) else [step.src]):
        readers[s] = readers.get(s, 0) + 1
    for o in self.net.outputs:
      readers[o] = readers.get(o, 0) + 1
    writer = {step.dst: step for step in self.net.steps}
    for step in self.net.steps:
      prod = writer.get(step.src) if step.kind == "conv" else None
      if (step.args.get("fusable") and prod is not None and
          prod.kind == "conv" and prod.args["bn"] and
          prod.args["activation"] == "relu" and readers[step.src] == 1):
        prod.args["defer"] = True
        step.args["fused_from"] = prod.args["name"]
        self.net.fused.append(step.args["name"])
    if any(step.kind == "dropout" for step in self.net.steps):
      self.net.seed_dropout(self.generator)
    return self.net


FUSED_UNIT_KERNELS = (
    "the fused BN-ReLU-conv3x3 kernel (csrc/bn_relu_conv3x3_stats.cu) and "
    "the conv3x3 kernel")


class BuilderModel(model.CNNModel):
  """A CNN model whose network is recorded through ``ConvNetBuilder`` from
  ``add_inference(cnn)``, the JAX model's own method (the JAX package's
  _CNNModule, model.py:101-143): the final affine layer to ``nclass``
  unless ``skip_final_affine_layer``, and the auxiliary head's affine when
  ``add_inference`` set ``cnn.aux_top``."""

  def add_inference(self, cnn: ConvNetBuilder) -> None:
    raise NotImplementedError

  def skip_final_affine_layer(self) -> bool:
    return False

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    """The network, its convolutions in channels_last memory."""
    net = GraphNet(dtype)
    cnn = ConvNetBuilder(net, self.image_size, self.depth,
                         generator=generator)
    self.add_inference(cnn)
    outputs = [cnn.top if self.skip_final_affine_layer()
               else cnn.affine(nclass, activation="linear")]
    if cnn.aux_top is not None:
      with cnn.switch_to_aux_top_layer():
        outputs.append(cnn.affine(nclass, activation="linear"))
    return cnn.finish(outputs).to(memory_format=torch.channels_last)

  def _meta_net(self) -> GraphNet:
    """The network built on the meta device, which allocates nothing."""
    with torch.device("meta"):
      return self.make_module(2)

  def bf16_kernels(self) -> str:
    """The fused unit's kernels when some conv of the network takes them."""
    return FUSED_UNIT_KERNELS if self._meta_net().fused else ""
