"""The kernels' ``torch.library.custom_op`` entries (``torch.ops.kf_torch``).

K-A, K-B, the flash forward and the decode kernel are custom ops, so that
``torch.export`` (aot.py) records them in an exported program and a loaded
program runs the kernel on the card. On the CPU each op is its kernel's
plain version, bitwise (tolerance: none, the same function); its fake
gives the CUDA kernel's output shapes, dtypes and strides, which
``torch.library.opcheck`` holds against the CPU implementation. The
``cuda``-marked case runs each op against its plain version on the card
(tolerance: one bf16 ulp of the plain result plus 1e-3 of its largest
value, the bound chip_smoke.py holds the kernels to); it skips here.

This file does not import JAX, so the card's case can run on a machine
without it.
"""

import pytest
import torch

from kf_benchmarks_tpu_torch.ops import conv_bn
from kf_benchmarks_tpu_torch.ops import flash_attention as fa


def _cases(device="cpu", dtype=torch.float32):
  g = torch.Generator(device=device).manual_seed(0)
  r = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)
  x, w_k = r(2, 8, 8, 64), r(64, 3, 3, 64) * 0.05
  sc = torch.rand(64, generator=g, device=device) + 0.5
  sh = torch.randn(64, generator=g, device=device) * 0.5
  q, k, v = r(2, 128, 2, 64), r(2, 128, 2, 64), r(2, 128, 2, 64)
  seg = torch.ones(2, 128, dtype=torch.int32, device=device)
  qd = r(3, 1, 2, 64)
  kd, vd = r(3, 256, 2, 64), r(3, 256, 2, 64)
  pos = torch.tensor([0, 100, 300], dtype=torch.int32, device=device)
  return {
      "conv3x3_same": ((x, w_k), lambda: conv_bn.conv3x3_same_plain(
          x, w_k.permute(1, 2, 3, 0))),
      "bn_relu_conv3x3_stats": ((x, sc, sh, w_k), lambda:
                                conv_bn.bn_relu_conv3x3_stats_plain(
                                    x, sc, sh, w_k.permute(1, 2, 3, 0))),
      "flash_attention_fwd": ((q, k, v, True, 0.125, seg, seg), lambda:
                              fa.flash_attention_fwd_plain(
                                  q, k, v, True, 0.125, seg, seg)),
      "flash_decode": ((qd, kd, vd, pos, 0.125), lambda:
                       fa.flash_decode_plain(qd, kd, vd, pos, 0.125)),
  }


def _tuple(x):
  return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", ["conv3x3_same", "bn_relu_conv3x3_stats",
                                  "flash_attention_fwd", "flash_decode"])
def test_op_is_the_plain_version_on_the_cpu(name):
  args, plain = _cases()[name]
  op = getattr(torch.ops.kf_torch, name)
  for got, want in zip(_tuple(op(*args)), _tuple(plain())):
    assert torch.equal(got, want)
  before = {**conv_bn.LAUNCHES, **fa.LAUNCHES}
  op(*args)
  assert {**conv_bn.LAUNCHES, **fa.LAUNCHES} == before  # no kernel ran


@pytest.mark.parametrize("name", ["conv3x3_same", "bn_relu_conv3x3_stats",
                                  "flash_attention_fwd", "flash_decode"])
def test_op_registration_and_fake(name):
  """Schema, the fake against the CPU implementation (shapes, dtypes,
  strides) and a trace through AOT dispatch."""
  args, _ = _cases()[name]
  result = torch.library.opcheck(
      getattr(torch.ops.kf_torch, name), args,
      test_utils=("test_schema", "test_faketensor",
                  "test_aot_dispatch_dynamic"))
  assert set(result.values()) == {"SUCCESS"}, result


def test_wrappers_call_the_ops():
  """The wrappers the model and the decode path call go through the ops:
  under ``torch.export`` the ops, not their plain decompositions, are in
  the graph."""

  class M(torch.nn.Module):
    def forward(self, x, sc, sh, w_k, qd, kd, vd, pos):
      y, stats = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k)
      return (conv_bn.conv3x3_same_kmajor(y, w_k), stats,
              fa.flash_decode(qd, kd, vd, pos),
              fa.flash_attention_fwd(kd, kd, vd, True)[0])

  c = _cases()
  x, sc, sh, w_k = c["bn_relu_conv3x3_stats"][0]
  qd, kd, vd, pos, _ = c["flash_decode"][0]
  program = torch.export.export(M(), (x, sc, sh, w_k, qd, kd, vd, pos))
  targets = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
  for name in ("conv3x3_same", "bn_relu_conv3x3_stats", "flash_decode",
               "flash_attention_fwd"):
    assert f"kf_torch.{name}.default" in targets, targets
  assert not any("einsum" in t or "aten.mm" in t for t in targets), targets


@pytest.mark.cuda
def test_ops_match_plain_on_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels have no CPU mode")
  for name, (args, plain) in _cases("cuda", torch.bfloat16).items():
    before = {**conv_bn.LAUNCHES, **fa.LAUNCHES}
    out = _tuple(getattr(torch.ops.kf_torch, name)(*args))
    after = {**conv_bn.LAUNCHES, **fa.LAUNCHES}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {name: 1}
    for got, want in zip(out, _tuple(plain())):
      got, want = got.float(), want.float()
      tol = 2.0 ** -7 * want.abs() + 1e-3 * want.abs().max()
      assert bool(((got - want).abs() <= tol).all()), name
