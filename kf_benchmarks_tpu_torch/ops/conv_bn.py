"""The fused BN-apply -> ReLU -> 3x3 conv -> BN-statistics unit.

The counterpart of the three Pallas probes in ``experiments/``:

* ``conv3x3_same`` (K-A, ``csrc/conv3x3_same.cu`` on
  ``csrc/conv3x3_sm90.cuh``: wgmma from a TMA ring) replaces
  ``pallas_conv`` of experiments/pallas_conv_probe.py:34. The kernel
  reads K-major [CO,3,3,C] weights; ``conv3x3_same`` permutes the HWIO
  tensor, and ``conv3x3_same_kmajor`` takes that layout as it is;
* ``bn_relu_conv3x3_stats`` (K-B, ``csrc/bn_relu_conv3x3_stats.cu``)
  replaces ``pallas_unit`` of experiments/pallas_fused_chain_probe.py:128
  and experiments/pallas_stage2_probe.py:111.

Each wrapper takes NHWC activations and HWIO weights, the JAX package's
layouts. On a CPU tensor it computes its plain PyTorch version (below it);
on a CUDA tensor it launches its hand-written kernel or raises. There is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its path went through the kernels.

``FusedBnReluConv3x3`` is the autograd unit the ResNet bottleneck uses for
every stride-1 ``conv_b``: forward by K-B, input gradient by K-A, weight
gradient by ``torch.nn.grad.conv2d_weight`` (the JAX package leaves conv
weight gradients to XLA, and the probes have no backward kernel).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {"conv3x3_same": 0, "bn_relu_conv3x3_stats": 0}

# Tile height of K-B's implicit GEMM (csrc/conv3x3_igemm.cuh BM), which
# sizes its per-tile statistics partials.
_BM = 128


def accum(t: torch.Tensor) -> torch.Tensor:
  """t in its accumulation dtype: f32 for bf16 and f32 tensors, f64 for
  f64 ones (so the plain path can also be checked in double precision)."""
  return t if t.dtype == torch.float64 else t.float()


def reset_launches() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


# -- plain versions ------------------------------------------------------------

def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """3x3 SAME stride-1 conv as 9 shifted matmuls in the accumulation dtype
  (f32, or f64 for f64 inputs), result in x.dtype.

  x [N,H,W,C], w [3,3,C,CO]. Products of bf16 inputs are exact in f32, so
  on bf16 inputs this differs from the kernel only in summation order (and
  TF32, which the caller must turn off on the card).
  """
  n, h, wd, c = x.shape
  co = w.shape[-1]
  xp = F.pad(x, (0, 0, 1, 1, 1, 1))
  acc = None
  for dy in range(3):
    for dx in range(3):
      tap = accum(xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c))
      prod = tap @ accum(w[dy, dx])
      acc = prod if acc is None else acc + prod
  return acc.reshape(n, h, wd, co).to(x.dtype)


def bn_relu_conv3x3_stats_plain(x: torch.Tensor, sc: torch.Tensor,
                                sh: torch.Tensor, w: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """y = conv3x3(relu(x*sc + sh)) and [sum y, sum y^2] per channel.

  The prologue runs in f32 and is rounded to x.dtype once, the padding is
  zero after the prologue, and the statistics are f32 sums of the stored
  (x.dtype) y -- the kernel's arithmetic, in plain ops.
  """
  xn = torch.relu(accum(x) * sc + sh).to(x.dtype)
  y = conv3x3_same_plain(xn, w)
  yf = accum(y)
  stats = torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
  return y, stats


# -- kernel wrappers -----------------------------------------------------------

def kernel_shape_error(name: str, x_shape, w_shape, c_align: int,
                       kmajor: bool = False):
  """Why a kernel does not take x [N,H,W,C] and w (HWIO [3,3,C,CO], or
  the K-major [CO,3,3,C] when ``kmajor``), or None when it does. K-A's
  implicit GEMM reads 64 input channels a stage (``c_align`` 64), K-B's
  32; both tile the output channels by 64."""
  if kmajor:
    ok = len(w_shape) == 4 and tuple(w_shape[1:3]) == (3, 3)
    c, co = (w_shape[3], w_shape[0]) if ok else (None, None)
    want = "[CO,3,3,C]"
  else:
    ok = len(w_shape) == 4 and tuple(w_shape[:2]) == (3, 3)
    c, co = (w_shape[2], w_shape[3]) if ok else (None, None)
    want = "[3,3,C,CO]"
  if len(x_shape) != 4 or not ok or c != x_shape[3]:
    return (f"{name}: want x [N,H,W,C] and w {want}, got {tuple(x_shape)} "
            f"and {tuple(w_shape)}")
  if c % c_align or co % 64 or c > 512:
    return (f"{name}: the kernel needs C % {c_align} == 0, C <= 512 and "
            f"CO % 64 == 0, got C={c}, CO={co}")
  n, h, wd, _ = x_shape
  if n * h * wd * max(c, co) >= 2 ** 31:
    return f"{name}: tensor too large for 32-bit pixel indices"
  return None


# K-A's output tiles (rows BM, columns BN) that csrc/conv3x3_sm90.cuh
# instantiates.
CONV_TILES = ((128, 64), (256, 64), (128, 128), (256, 128), (128, 256))


class ConvTile(NamedTuple):
  """K-A's launch: BM x BN output tiles whose A rows are the pixels of a
  box of wb x hb pixels of nb images, on ``grid`` persistent blocks."""
  bm: int
  bn: int
  wb: int
  hb: int
  nb: int
  grid: int


@functools.lru_cache(maxsize=None)
def conv_tile(n: int, h: int, w: int, co: int, sms: int) -> ConvTile:
  """K-A's tile and box for an [n, h, w] image batch and CO outputs on
  ``sms`` SMs.

  A 64-deep stage of a tile brings its box's pixels (A) and BN weight rows
  (B) from L2 by TMA, 128 bytes a row, and runs BM x BN x 64 products.
  On an H100 a stage took about (box pixels + BN) + BM BN / 32 units of
  ~1.1 cycles (fitted to every tile at the four ResNet-50 stages, as
  ``chip_smoke.py --phases=build,conv_tiles`` times them: the transfers
  and the products overlap only in part), and tiles run in waves
  of one a persistent block. So the cost of a choice is waves x (box
  pixels + BN + BM BN / 32); ties go to the smaller tile, whose last wave
  is less ragged, then to the taller box.
  """
  best = None
  for bm, bn in CONV_TILES:
    if co % bn:
      continue
    wb = min(w, bm, 256)
    for hb in range(1, min(h, bm // wb, 256) + 1):
      nb = min(n, bm // (wb * hb), 256)
      tiles = (-(-w // wb) * -(-h // hb) * -(-n // nb)) * (co // bn)
      cost = (-(-tiles // sms) * (wb * hb * nb + bn + bm * bn / 32),
              bm * bn, -hb)
      if best is None or cost < best[0]:
        best = (cost, ConvTile(bm, bn, wb, hb, nb, min(tiles, sms)))
  if best is None:
    raise ValueError(f"conv3x3_same: no tile divides CO={co}")
  return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(name: str, x: torch.Tensor, w: torch.Tensor,
                c_align: int, kmajor: bool = False) -> None:
  if x.device.type != "cuda":
    raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, "
                     f"got {x.device}")
  if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
    raise ValueError(f"{name}: the CUDA kernel takes bf16 x and w, got "
                     f"{x.dtype} and {w.dtype} (no f32 variant yet)")
  err = kernel_shape_error(name, x.shape, w.shape, c_align, kmajor)
  if err:
    raise ValueError(err)
  if not (x.is_contiguous() and w.is_contiguous()):
    raise ValueError(f"{name}: x and w must be contiguous")
  # TMA needs 16-byte aligned bases.
  if x.data_ptr() % 16 or w.data_ptr() % 16:
    raise ValueError(f"{name}: x and w must start on 16-byte boundaries")
  if w.device != x.device:
    raise ValueError(f"{name}: x on {x.device}, w on {w.device}")


def _raise_on_error(name: str, err: int) -> None:
  if err != 0:
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def kmajor(w: torch.Tensor) -> torch.Tensor:
  """HWIO [3,3,C,CO] weights as the K-major [CO,3,3,C] array K-A reads."""
  return w.permute(3, 0, 1, 2).contiguous()


def conv3x3_same_kmajor(x: torch.Tensor, w_k: torch.Tensor) -> torch.Tensor:
  """K-A on K-major weights: y[N,H,W,CO] = conv3x3_SAME(x[N,H,W,C], w)
  with w_k[o,dy,dx,c] = w[dy,dx,c,o]."""
  if x.device.type == "cpu":
    return conv3x3_same_plain(x, w_k.permute(1, 2, 3, 0))
  _check_cuda("conv3x3_same", x, w_k, c_align=64, kmajor=True)
  n, h, wd, c = x.shape
  co = w_k.shape[0]
  lib = _build.load("conv3x3_same")
  index = x.device.index if x.device.index is not None else \
      torch.cuda.current_device()
  tile = conv_tile(n, h, wd, co, _sm_count(index))
  with torch.cuda.device(x.device):
    y = torch.empty(n, h, wd, co, dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.conv3x3_same_bf16(x.data_ptr(), w_k.data_ptr(), y.data_ptr(),
                                n, h, wd, c, co, *tile, stream)
  _raise_on_error("conv3x3_same", err)
  LAUNCHES["conv3x3_same"] += 1
  return y


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """K-A: y[N,H,W,CO] = conv3x3_SAME(x[N,H,W,C], w[3,3,C,CO])."""
  if x.device.type == "cpu":
    return conv3x3_same_plain(x, w)
  if w.dim() != 4:
    raise ValueError(f"conv3x3_same: want w [3,3,C,CO], got "
                     f"{tuple(w.shape)}")
  return conv3x3_same_kmajor(x, kmajor(w))


def bn_relu_conv3x3_stats(x: torch.Tensor, sc: torch.Tensor,
                          sh: torch.Tensor, w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K-B: (y, [sum y, sum y^2]) for y = conv3x3_SAME(relu(x*sc + sh), w).

  x [N,H,W,C] and w [3,3,C,CO] bf16 on the card; sc, sh [C] f32.
  """
  if x.device.type == "cpu":
    return bn_relu_conv3x3_stats_plain(x, sc, sh, w)
  _check_cuda("bn_relu_conv3x3_stats", x, w, c_align=32)
  n, h, wd, c = x.shape
  co = w.shape[3]
  for t, label in ((sc, "sc"), (sh, "sh")):
    if t.dtype != torch.float32 or t.shape != (c,) or \
        not t.is_contiguous() or t.device != x.device:
      raise ValueError(f"bn_relu_conv3x3_stats: {label} must be a "
                       f"contiguous f32 [{c}] tensor on {x.device}")
  lib = _build.load("bn_relu_conv3x3_stats")
  tiles = -(-(n * h * wd) // _BM)
  with torch.cuda.device(x.device):
    y = torch.empty(n, h, wd, co, dtype=torch.bfloat16, device=x.device)
    partial = torch.empty(tiles, 2, co, dtype=torch.float32, device=x.device)
    stats = torch.empty(2, co, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.bn_relu_conv3x3_stats_bf16(
        x.data_ptr(), sc.data_ptr(), sh.data_ptr(), w.data_ptr(),
        y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
        n, h, wd, c, co, stream)
  _raise_on_error("bn_relu_conv3x3_stats", err)
  LAUNCHES["bn_relu_conv3x3_stats"] += 1
  return y, stats


# -- autograd unit -------------------------------------------------------------

class FusedBnReluConv3x3(torch.autograd.Function):
  """(x_raw, sc, sh, w) -> (y_raw, stats) with
  y_raw = conv3x3_SAME(relu(x_raw*sc + sh), w), stats = [sum y, sum y^2].

  x_raw is the producer conv's raw output, sc/sh the producer's batch norm
  folded to a per-channel scale and shift (f32, built by autograd-tracked
  ops so gamma, beta and the producer's statistics receive gradients), w
  HWIO. The same Function runs on both devices: its inner calls take the
  kernels on the card and the plain versions on the CPU.
  """

  @staticmethod
  def forward(ctx, x, sc, sh, w):
    y, stats = bn_relu_conv3x3_stats(x, sc, sh, w)
    ctx.save_for_backward(x, sc, sh, w, y)
    return y, stats

  @staticmethod
  def backward(ctx, gy, gstats):
    x, sc, sh, w, y = ctx.saved_tensors
    # d/dy of (y, sum y, sum y^2): one cotangent for the conv output.
    g = accum(torch.zeros_like(y) if gy is None else gy)
    if gstats is not None:
      g = g + gstats[0] + 2.0 * accum(y) * gstats[1]
    g = g.to(x.dtype).contiguous()
    # Input gradient of the SAME conv: the same conv of g with the taps
    # flipped in space and in/out channels swapped, w'[dy,dx,o,c] =
    # w[2-dy,2-dx,c,o], made at once in the K-major layout K-A reads:
    # w'_k[c,dy,dx,o] = w'[dy,dx,o,c].
    w_tk = w.flip(0, 1).permute(2, 0, 1, 3).contiguous()
    gxn = accum(conv3x3_same_kmajor(g, w_tk))
    a = accum(x) * sc + sh
    gxn = gxn * (a > 0)
    gx = (gxn * sc).to(x.dtype)
    gsc = (gxn * accum(x)).sum((0, 1, 2))
    gsh = gxn.sum((0, 1, 2))
    xn = torch.relu(a).to(x.dtype)
    gw = torch.nn.grad.conv2d_weight(
        xn.permute(0, 3, 1, 2), (w.shape[3], w.shape[2], 3, 3),
        g.permute(0, 3, 1, 2), padding=1)
    gw = gw.permute(2, 3, 1, 0).to(w.dtype)
    return gx, gsc, gsh, gw


def fused_bn_relu_conv3x3(x, sc, sh, w):
  return FusedBnReluConv3x3.apply(x, sc, sh, w)
