"""The fused conv_b unit at bf16, one unit at its real width, against the
JAX package's BN-apply -> ReLU -> 3x3 SAME conv at bf16, on the CPU.

The whole-model bf16 test (tests/test_torch_bf16_parity.py) cannot see a
fault local to the ResNet's fused units: at batch 2 bf16 moves the JAX
package's own gradients there by 0.46-0.72 in relative L2. One unit alone
has no such noise, so here the port's ``FusedBnReluConv3x3`` (its plain
version: the CPU path of the same Function the card runs) is held at bf16
against the JAX package's own unit -- its ``CompactBatchNorm`` applying
this batch's statistics (``use_running_average`` with the batch's mean and
variance, which is what the Function sees: sc and sh are its inputs),
ReLU, and flax ``nn.Conv`` 3x3 SAME, both at ``dtype=bfloat16`` -- and the
next batch norm's statistics [sum y, sum y^2] in f32.

Compared, for the forward output y, the statistics, and the gradients of
<gy, y> + <gs, stats> for random cotangents with respect to x, w, sc and
sh: the JAX side is written in flax's (x - mean) * a + bias with
a = scale * rsqrt(var + eps), so its sc and sh gradients are
d/da + mean * d/dbias and d/dbias. Every limit comes from the JAX side
alone, as in tests/test_torch_bf16_parity.py: with d = JAX's own bf16 vs
f32 relative L2 distance for that quantity,

* relative L2 distance, port bf16 vs JAX bf16, within DIST_C * d
  (readings: at most 0.96x);
* |norm ratio - 1| within NORM_C * d (readings: at most 0.24x).

d is 2e-3..1.2e-2 for y, the statistics and dw, and 3e-2..7e-2 for dx,
dsc and dsh (ReLU masks that flip under bf16 rounding). A 1.1 scale on the
unit's weight gradient moves its distance and its norm ratio by 0.1, 8x
and more over the limits.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import builder as jax_builder
from kf_benchmarks_tpu_torch.ops import conv_bn

EPS = 1e-5
DIST_C = 2.0
NORM_C = 1.0
# (C = CO, N, H = W): ResNet-50's stage-2 and stage-3 conv_b widths.
SHAPES = ((64, 4, 16), (128, 2, 14))


def _inputs(c, n, hw, seed):
  rng = np.random.default_rng(seed)
  # A conv's raw output: per-channel offsets and spreads.
  x = (rng.normal(size=(n, hw, hw, c)) * rng.uniform(0.5, 2.0, c) +
       rng.normal(size=c)).astype(np.float32)
  gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
  beta = (rng.normal(size=c) * 0.5).astype(np.float32)
  w = (rng.normal(size=(3, 3, c, c)) * np.sqrt(2.0 / (9 * c))).astype(
      np.float32)
  gy = rng.normal(size=(n, hw, hw, c)).astype(np.float32)
  gs = (rng.normal(size=(2, c)) * [[1e-2], [1e-4]]).astype(np.float32)
  return x, gamma, beta, w, gy, gs


def _moments(x_c):
  """The batch's f32 mean and variance of x in the compute dtype."""
  xf = np.asarray(jnp.asarray(x_c).astype(jnp.float32), np.float64)
  mean = xf.mean((0, 1, 2))
  var = np.maximum((xf * xf).mean((0, 1, 2)) - mean * mean, 0.0)
  return mean.astype(np.float32), var.astype(np.float32)


def _jax_unit(x, gamma, beta, w, gy, gs, dtype):
  """{y, stats, dx, dw, dsc, dsh} of the JAX package's unit in ``dtype``."""
  x_c = jnp.asarray(x).astype(dtype)
  mean, var = _moments(x_c)
  bn = jax_builder.CompactBatchNorm(use_running_average=True,
                                    use_scale=True, epsilon=EPS, dtype=dtype)
  conv = nn.Conv(features=w.shape[-1], kernel_size=(3, 3), padding="SAME",
                 use_bias=False, dtype=dtype, param_dtype=jnp.float32)
  stats_in = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

  def unit(x_c, scale, bias, kernel):
    h = bn.apply({"params": {"scale": scale, "bias": bias},
                  "batch_stats": stats_in}, x_c)
    y = conv.apply({"params": {"kernel": kernel}}, jax.nn.relu(h))
    yf = y.astype(jnp.float32)
    return y, jnp.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])

  (y, stats), vjp = jax.vjp(unit, x_c, jnp.asarray(gamma),
                            jnp.asarray(beta), jnp.asarray(w))
  dx, dscale, dbias, dw = vjp((jnp.asarray(gy).astype(y.dtype),
                               jnp.asarray(gs)))
  inv = 1.0 / np.sqrt(var.astype(np.float64) + EPS)
  da = np.asarray(dscale, np.float64) / inv  # a = scale * inv
  dbias = np.asarray(dbias, np.float64)
  f = lambda t: np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)
  return {"y": f(y), "stats": f(stats), "dx": f(dx), "dw": f(dw),
          "dsc": da + mean * dbias, "dsh": dbias}


def _port_unit(x, gamma, beta, w, gy, gs):
  """The same quantities of the port's FusedBnReluConv3x3 at bf16."""
  x_c = torch.from_numpy(x).to(torch.bfloat16)
  mean, var = (torch.from_numpy(t) for t in _moments(jnp.asarray(x).astype(
      jnp.bfloat16)))
  sc = torch.rsqrt(var + EPS) * torch.from_numpy(gamma)
  sh = torch.from_numpy(beta) - mean * sc
  # The ResNet's conv_b: OIHW f32 parameter -> K-major bf16 [CO,3,3,C].
  w_k = torch.from_numpy(np.ascontiguousarray(
      np.transpose(w, (3, 0, 1, 2)))).to(torch.bfloat16)
  leaves = [t.clone().requires_grad_(True) for t in (x_c, sc, sh, w_k)]
  y, stats = conv_bn.FusedBnReluConv3x3.apply(*leaves)
  loss = ((y.float() * torch.from_numpy(gy).to(torch.bfloat16).float()).sum()
          + (stats * torch.from_numpy(gs)).sum())
  loss.backward()
  f = lambda t: t.detach().to(torch.float64).numpy()
  return {"y": f(y), "stats": f(stats), "dx": f(leaves[0].grad),
          "dw": np.transpose(f(leaves[3].grad), (1, 2, 3, 0)),
          "dsc": f(leaves[1].grad), "dsh": f(leaves[2].grad)}


def _rel(a, b):
  return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("c,n,hw", SHAPES, ids=[f"c{s[0]}" for s in SHAPES])
def test_fused_unit_bf16_matches_jax_unit(c, n, hw):
  args = _inputs(c, n, hw, seed=c)
  ref16 = _jax_unit(*args, jnp.bfloat16)
  ref32 = _jax_unit(*args, jnp.float32)
  got = _port_unit(*args)
  for key in ("y", "stats", "dx", "dw", "dsc", "dsh"):
    noise = _rel(ref16[key], ref32[key])
    assert 0 < noise < 0.1, (key, noise)  # bf16 rounding
    dist = _rel(got[key], ref16[key])
    ratio = np.linalg.norm(got[key]) / np.linalg.norm(ref16[key])
    assert dist <= DIST_C * noise, (key, dist, noise)
    assert abs(ratio - 1.0) <= NORM_C * noise, (key, ratio, noise)
