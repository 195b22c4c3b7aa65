"""The port's fused BN-ReLU-conv3x3 unit against the JAX package's Pallas
probes and XLA, on the CPU.

* K-B (``bn_relu_conv3x3_stats``, plain version here) and the
  ``FusedBnReluConv3x3`` forward against the probe kernel bodies
  themselves -- ``fused_kernel`` of experiments/pallas_fused_chain_probe.py
  and experiments/pallas_stage2_probe.py -- run by ``pl.pallas_call`` in
  interpret mode with the probes' own BlockSpecs, at small shapes.
* K-A (``conv3x3_same``) against ``jax.lax.conv_general_dilated(...,
  "SAME")``, the function ``xla_conv`` of experiments/pallas_conv_probe.py
  computes (that probe runs its benchmark at import, so it is not loaded).
* The Function's backward against autograd through the plain forward and
  against ``jax.grad`` of the same unit.

On the card the kernels are held against the same plain versions by
``chip_smoke.py`` and by the ``cuda``-marked test at the end.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kf_benchmarks_tpu_torch.ops import conv_bn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, C, CO = 4, 6, 6, 8, 16


def _load_probe(name):
  path = os.path.join(REPO, "experiments", name)
  spec = importlib.util.spec_from_file_location(
      f"_probe_{name[:-3]}", path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)  # main() is guarded: nothing runs
  mod.B, mod.H, mod.W, mod.C, mod.CO = B, H, W, C, CO
  mod.Hp, mod.Wp = H + 2, W + 2
  mod.ROWS = mod.Hp * mod.Wp
  mod.N_VALID = float(B * H * W)
  return mod


def _bf16(a):
  """numpy f32 holding bf16-representable values."""
  return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _unit_inputs(seed):
  rng = np.random.default_rng(seed)
  x = _bf16(rng.normal(0.3, 1.2, (B, H, W, C)))
  w = _bf16(rng.normal(0.0, (2.0 / (9 * C)) ** 0.5, (3, 3, C, CO)))
  mean = rng.normal(0.2, 0.5, C).astype(np.float32)
  var = rng.uniform(0.5, 2.0, C).astype(np.float32)
  n = float(B * H * W)
  st_in = np.stack([mean * n, (var + mean * mean) * n]).astype(np.float32)
  return x, w, st_in


def _port_scale_shift(st_in):
  """The probe's in-kernel BN parameters (no affine), as the port's caller
  passes them: sc = rsqrt(var + 1e-5), sh = -mean * sc."""
  st = torch.from_numpy(st_in)
  n = float(B * H * W)
  mean = st[0] / n
  var = st[1] / n - mean * mean
  sc = torch.rsqrt(var + 1e-5)
  return sc, -mean * sc


def _port_unit(x, w, st_in, use_function):
  sc, sh = _port_scale_shift(st_in)
  xt = torch.from_numpy(x).to(torch.bfloat16)
  wt = torch.from_numpy(w).to(torch.bfloat16)
  fn = conv_bn.fused_bn_relu_conv3x3 if use_function else \
      conv_bn.bn_relu_conv3x3_stats
  y, st = fn(xt, sc, sh, wt)
  return y.float().numpy(), st.numpy()


def _check_against_probe(y_port, st_port, y_probe, st_probe):
  # y: both are bf16 roundings of f32 sums of the same bf16 products
  # (different order), from prologues that may round one input apart: one
  # bf16 ulp of the element (2^-7 relative) plus 2^-8 of the largest output.
  scale = np.abs(y_probe).max()
  np.testing.assert_array_less(
      np.abs(y_port - y_probe), 2.0 ** -7 * np.abs(y_probe) +
      2.0 ** -8 * scale + 1e-12)
  # Statistics: the port sums the stored bf16 y, the probe the f32
  # accumulator; they differ by at most one bf16 ulp (2^-8 relative,
  # round-to-nearest) per element: sum |y| 2^-8 for the sums, twice that
  # relative for the sums of squares.
  abs_sum = np.abs(y_probe).sum((0, 1, 2))
  sq_sum = (y_probe.astype(np.float64) ** 2).sum((0, 1, 2))
  assert np.all(np.abs(st_port[0] - st_probe[0]) <= 2.0 ** -8 * abs_sum +
                1e-4)
  assert np.all(np.abs(st_port[1] - st_probe[1]) <= 2.0 ** -7 * sq_sum +
                1e-4)


@pytest.mark.parametrize("use_function", [False, True],
                         ids=["kernel_wrapper", "function"])
def test_unit_matches_stage3_probe_interpret(use_function):
  probe = _load_probe("pallas_fused_chain_probe.py")
  probe.IMGS = 2
  x, w, st_in = _unit_inputs(0)
  call = pl.pallas_call(
      probe.fused_kernel,
      grid=(B // probe.IMGS,),
      in_specs=[
          pl.BlockSpec((probe.IMGS, probe.ROWS, C), lambda b: (b, 0, 0)),
          pl.BlockSpec((9, C, CO), lambda b: (0, 0, 0)),
          pl.BlockSpec((2, C), lambda b: (0, 0)),
          pl.BlockSpec((probe.ROWS, 1), lambda b: (0, 0)),
      ],
      out_specs=[
          pl.BlockSpec((probe.IMGS, probe.ROWS, CO), lambda b: (b, 0, 0)),
          pl.BlockSpec((2, CO), lambda b: (0, 0)),
      ],
      out_shape=[
          jax.ShapeDtypeStruct((B, probe.ROWS, CO), jnp.bfloat16),
          jax.ShapeDtypeStruct((2, CO), jnp.float32),
      ],
      interpret=True)
  xh = probe.to_halo(jnp.asarray(x, jnp.bfloat16))
  w9 = jnp.asarray(w, jnp.bfloat16).reshape(9, C, CO)
  y_h, st = call(xh, w9, jnp.asarray(st_in), probe._valid_mask())
  y_probe = np.asarray(probe.from_halo(y_h, CO).astype(jnp.float32))
  y_port, st_port = _port_unit(x, w, st_in, use_function)
  _check_against_probe(y_port, st_port, y_probe, np.asarray(st))


@pytest.mark.parametrize("use_function", [False, True],
                         ids=["kernel_wrapper", "function"])
def test_unit_matches_stage2_probe_interpret(use_function):
  probe = _load_probe("pallas_stage2_probe.py")
  probe.IMGS = 1
  x, w, st_in = _unit_inputs(1)
  call = pl.pallas_call(
      probe.fused_kernel,
      grid=(B // probe.IMGS,),
      in_specs=[
          pl.BlockSpec((probe.IMGS, probe.ROWS, C), lambda b: (b, 0, 0)),
          pl.BlockSpec((4, C, 2 * CO), lambda b: (0, 0, 0)),
          pl.BlockSpec((C, CO), lambda b: (0, 0)),
          pl.BlockSpec((2, C), lambda b: (0, 0)),
          pl.BlockSpec((probe.ROWS, 1), lambda b: (0, 0)),
      ],
      out_specs=[
          pl.BlockSpec((probe.IMGS, probe.ROWS, CO), lambda b: (b, 0, 0)),
          pl.BlockSpec((2, CO), lambda b: (0, 0)),
      ],
      out_shape=[
          jax.ShapeDtypeStruct((B, probe.ROWS, CO), jnp.bfloat16),
          jax.ShapeDtypeStruct((2, CO), jnp.float32),
      ],
      interpret=True)
  xh = probe.to_halo(jnp.asarray(x, jnp.bfloat16))
  wp, ws = probe.pack_weights(jnp.asarray(w, jnp.bfloat16).reshape(9, C, CO))
  y_h, st = call(xh, wp, ws, jnp.asarray(st_in), probe._valid_mask())
  y_probe = np.asarray(probe.from_halo(y_h, CO).astype(jnp.float32))
  y_port, st_port = _port_unit(x, w, st_in, use_function)
  _check_against_probe(y_port, st_port, y_probe, np.asarray(st))


def test_unit_padding_is_zero_after_prologue():
  """relu(0*sc + sh) is not zero where sh > 0: the border must be zeroed
  after the prologue, not before it."""
  x = torch.zeros(1, 3, 3, 8)
  sc = torch.ones(8)
  sh = torch.ones(8)
  w = torch.ones(3, 3, 8, 16)
  y, _ = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w)
  # Interior pixel sees 9 taps of relu(1) = 1 over 8 channels; a corner 4.
  assert float(y[0, 1, 1, 0]) == 72.0
  assert float(y[0, 0, 0, 0]) == 32.0


@pytest.mark.parametrize("shape", [(2, 5, 7, 8, 16), (1, 4, 4, 16, 8)],
                         ids=["wide", "narrow"])
def test_conv3x3_plain_matches_xla_same_conv(shape):
  n, h, w_, c, co = shape
  rng = np.random.default_rng(2)
  x = rng.normal(size=(n, h, w_, c)).astype(np.float32)
  w = rng.normal(size=(3, 3, c, co)).astype(np.float32)
  ref = jax.lax.conv_general_dilated(
      jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
      dimension_numbers=("NHWC", "HWIO", "NHWC"),
      precision=jax.lax.Precision.HIGHEST)
  got = conv_bn.conv3x3_same(torch.from_numpy(x), torch.from_numpy(w))
  # f32 sums of 9*C products in another order.
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-5)


def _jax_unit_loss(x, sc, sh, w, gy, gs):
  xn = jnp.maximum(x * sc + sh, 0.0)
  y = jax.lax.conv_general_dilated(
      xn, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
      precision=jax.lax.Precision.HIGHEST)
  st = jnp.stack([jnp.sum(y, (0, 1, 2)), jnp.sum(y * y, (0, 1, 2))])
  return jnp.sum(y * gy) + jnp.sum(st * gs)


def _grad_inputs():
  rng = np.random.default_rng(3)
  x = rng.normal(0.2, 1.0, (B, H, W, C)).astype(np.float32)
  sc = rng.uniform(0.5, 1.5, C).astype(np.float32)
  sh = rng.normal(0.0, 0.5, C).astype(np.float32)
  w = rng.normal(0.0, 0.2, (3, 3, C, CO)).astype(np.float32)
  gy = rng.normal(size=(B, H, W, CO)).astype(np.float32)
  gs = (rng.normal(size=(2, CO)) * 0.1).astype(np.float32)
  return x, sc, sh, w, gy, gs


def _function_grads(fn, x, sc, sh, w, gy, gs):
  leaves = [torch.from_numpy(a).requires_grad_() for a in (x, sc, sh, w)]
  y, st = fn(*leaves)
  loss = (y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()
  return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("reference", ["torch_autograd", "jax_grad"])
def test_function_backward(reference):
  x, sc, sh, w, gy, gs = _grad_inputs()
  got = _function_grads(conv_bn.fused_bn_relu_conv3x3, x, sc, sh, w, gy, gs)
  if reference == "torch_autograd":
    ref = _function_grads(conv_bn.bn_relu_conv3x3_stats_plain, x, sc, sh, w,
                          gy, gs)
  else:
    ref = jax.grad(_jax_unit_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, sc, sh, w, gy, gs)))
  # f32 throughout; sums of up to B*H*W terms taken in other orders.
  for name, a, b in zip(("x", "sc", "sh", "w"), got, ref):
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-4 * np.abs(b).max(), err_msg=name)


def test_wrappers_reject_other_devices():
  x = torch.zeros(1, 4, 4, 32, device="meta")
  w = torch.zeros(3, 3, 32, 64, device="meta")
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    conv_bn.conv3x3_same(x, w)
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    conv_bn.bn_relu_conv3x3_stats(x, torch.zeros(32, device="meta"),
                                  torch.zeros(32, device="meta"), w)


@pytest.mark.parametrize("x_shape,w_shape,c_align,kmajor,error", [
    ((2, 7, 7, 64), (3, 3, 64, 128), 64, False, None),
    ((2, 7, 7, 64), (128, 3, 3, 64), 64, True, None),
    ((2, 7, 7, 32), (3, 3, 32, 64), 32, False, None),
    ((2, 7, 7, 32), (3, 3, 32, 64), 64, False, "C % 64 == 0"),
    ((2, 7, 7, 32), (64, 3, 3, 32), 64, True, "C % 64 == 0"),
    ((2, 7, 7, 64), (3, 3, 64, 96), 64, False, "CO % 64 == 0"),
    ((2, 7, 7, 1024), (3, 3, 1024, 64), 64, False, "C <= 512"),
    ((2, 7, 7, 64), (3, 3, 32, 64), 64, False, "want x"),
    ((2, 7, 7, 64), (3, 3, 64, 128), 64, True, "want x"),
    ((7, 7, 64), (3, 3, 64, 64), 64, False, "want x"),
    ((1024, 512, 512, 64), (3, 3, 64, 64), 64, False, "32-bit"),
], ids=["ka", "ka_kmajor", "kb", "ka_c32", "ka_kmajor_c32", "co96",
        "c1024", "c_mismatch", "hwio_as_kmajor", "rank3", "too_large"])
def test_kernel_shape_acceptance(x_shape, w_shape, c_align, kmajor, error):
  """The shapes the wrappers refuse before a launch: K-A's wgmma stage
  reads 64 input channels (one tap), K-B's 32."""
  got = conv_bn.kernel_shape_error("k", x_shape, w_shape, c_align, kmajor)
  if error is None:
    assert got is None
  else:
    assert got is not None and error in got


@pytest.mark.parametrize("shape,sms,want", [
    ((256, 56, 56, 64), 132, (256, 64, 56, 4, 1, 132)),
    ((256, 28, 28, 128), 132, (256, 128, 28, 4, 2, 132)),
    ((256, 14, 14, 256), 132, (128, 128, 14, 2, 4, 132)),
    ((256, 7, 7, 512), 132, (128, 256, 7, 7, 2, 132)),
    ((8, 7, 7, 512), 132, (128, 64, 7, 1, 8, 56)),   # one wave: small tiles
    ((3, 7, 7, 64), 132, (128, 64, 7, 1, 3, 7)),     # fewer tiles than SMs
    ((2, 5, 300, 64), 132, (128, 64, 128, 1, 1, 30)),  # W wider than a box
], ids=["stage2", "stage3", "stage4", "stage5", "stage5_b8", "tiny",
        "wide"])
def test_conv_tile_choice(shape, sms, want):
  """K-A's tile, A box and persistent grid for the ResNet-50 stage shapes:
  waves x (L2 rows a stage + tensor-core cycles a stage)."""
  n, h, w, co = shape
  t = conv_bn.conv_tile(n, h, w, co, sms)
  assert tuple(t) == want
  assert (t.bm, t.bn) in conv_bn.CONV_TILES and co % t.bn == 0
  # The box fits the tile's rows and the tensor map's 256-element limit,
  # and the boxes cover the batch.
  assert t.wb * t.hb * t.nb <= t.bm and max(t.wb, t.hb, t.nb) <= 256
  tiles = (-(-w // t.wb) * -(-h // t.hb) * -(-n // t.nb)) * (co // t.bn)
  assert t.grid == min(tiles, sms)


def test_conv_tile_needs_a_dividing_tile():
  with pytest.raises(ValueError, match="no tile divides"):
    conv_bn.conv_tile(4, 5, 50, 96, 132)


def test_kmajor_entry_matches_hwio_entry():
  """conv3x3_same_kmajor on the K-major weights is conv3x3_same on HWIO,
  and the backward's K-major flipped weights are kmajor() of the HWIO
  flip-and-swap it stands for."""
  rng = np.random.default_rng(4)
  x = torch.from_numpy(rng.normal(size=(2, 5, 6, 8)).astype(np.float32))
  w = torch.from_numpy(rng.normal(size=(3, 3, 8, 16)).astype(np.float32))
  torch.testing.assert_close(conv_bn.conv3x3_same_kmajor(x, conv_bn.kmajor(w)),
                             conv_bn.conv3x3_same(x, w), rtol=0, atol=0)
  w_t = w.flip(0, 1).transpose(2, 3)
  assert torch.equal(w.flip(0, 1).permute(2, 0, 1, 3).contiguous(),
                     conv_bn.kmajor(w_t))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
  """K-A and K-B against their plain versions on the card (chip_smoke.py
  runs the same check at the full ResNet-50 shapes)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels have no CPU mode")
  g = torch.Generator(device="cuda").manual_seed(0)
  x = torch.randn(4, 14, 14, 64, generator=g, device="cuda").bfloat16()
  w = (torch.randn(3, 3, 64, 128, generator=g, device="cuda") * 0.05
       ).bfloat16()
  sc = torch.rand(64, generator=g, device="cuda") + 0.5
  sh = torch.randn(64, generator=g, device="cuda") * 0.5
  before = dict(conv_bn.LAUNCHES)
  y = conv_bn.conv3x3_same(x, w)
  yb, st = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w)
  torch.cuda.synchronize()
  assert conv_bn.LAUNCHES["conv3x3_same"] == before["conv3x3_same"] + 1
  ref = conv_bn.conv3x3_same_plain(x, w).float()
  refb, st_ref = conv_bn.bn_relu_conv3x3_stats_plain(x, sc, sh, w)
  for out, r in ((y.float(), ref), (yb.float(), refb.float())):
    assert bool(((out - r).abs() <=
                 2 ** -7 * r.abs() + 1e-3 * r.abs().max()).all())
  torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-2)
  # K-A at a ragged M (N*H*W = 3*7*7 = 147, not a multiple of the 128-pixel
  # tile) with CO = 64 and CO = 128, on HWIO and on K-major weights, and an
  # image wider than one A box (W = 150 > 128: two boxes along W).
  for (n, h, wd), c, co in (((3, 7, 7), 64, 64), ((3, 7, 7), 128, 128),
                            ((3, 7, 7), 64, 128), ((1, 3, 150), 64, 64)):
    x = torch.randn(n, h, wd, c, generator=g, device="cuda").bfloat16()
    w = (torch.randn(3, 3, c, co, generator=g, device="cuda") * 0.05
         ).bfloat16()
    r = conv_bn.conv3x3_same_plain(x, w).float()
    for out in (conv_bn.conv3x3_same(x, w),
                conv_bn.conv3x3_same_kmajor(x, conv_bn.kmajor(w))):
      torch.cuda.synchronize()
      assert out.shape == (n, h, wd, co)
      assert bool(((out.float() - r).abs() <=
                   2 ** -7 * r.abs() + 1e-3 * r.abs().max()).all())
