"""The port's decode attention against the JAX package's, on the CPU.

``decode_attention`` (parallel/sequence.py) in its three dense modes --
``flash`` (here the decode kernels' plain version; the JAX package's CPU
fallback there), ``tiled`` (the ``_block_update`` online softmax) and
``exact`` (the full-sequence oracle) -- on the same numpy inputs, with
``pos`` at 0, mid-ring, T - 1 and past T (a wrapped ring). Tolerance: f32
sums in other orders, rtol 1e-5 and atol 1e-6. Then the masking contract
torch against torch: stale contents past ``pos`` (NaN, +-1e9) leave the
output bit-identical. Then the decode kernel's split plan and the plain
model of its cluster merge, and the wrapper's device rules; the kernel
itself runs on the card (the ``cuda``-marked test, and chip_smoke.py phase
decode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.parallel import sequence as jax_seq
from kf_benchmarks_tpu_torch.ops import flash_attention as fa
from kf_benchmarks_tpu_torch.parallel import sequence as port_seq

B, T, H, D = 4, 32, 2, 16
BLOCK = 8
# One slot at 0, one mid-ring, one at T - 1, one past T (wrapped).
POS = np.array([0, 13, T - 1, T + 5], np.int32)


def _inputs(seed, b=B, t=T, h=H, d=D, dtype=np.float32):
  rng = np.random.default_rng(seed)
  mk = lambda *s: rng.normal(size=s).astype(dtype)
  return mk(b, 1, h, d), mk(b, t, h, d), mk(b, t, h, d)


def _jax(q, k, v, pos, impl, exact):
  out = jax_seq.decode_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
      block=BLOCK, impl=impl, exact=exact, q_block=BLOCK)
  return np.asarray(out)


def _port(q, k, v, pos, impl, exact):
  t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
  return port_seq.decode_attention(t(q), t(k), t(v), t(pos), block=BLOCK,
                                   impl=impl, exact=exact,
                                   q_block=BLOCK).numpy()


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
@pytest.mark.parametrize("impl", ["flash", "tiled"])
def test_decode_attention_matches_jax(impl, exact):
  q, k, v = _inputs(0)
  got = _port(q, k, v, POS, impl, exact)
  assert got.shape == (B, 1, H, D) and got.dtype == np.float32
  np.testing.assert_allclose(got, _jax(q, k, v, POS, impl, exact),
                             rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["flash", "tiled"])
def test_fast_modes_agree_with_exact_past_the_wrap(impl):
  """Past the ring's length every slot takes part in both schedules."""
  q, k, v = _inputs(1)
  pos = np.array([T - 1, T, T + 3, 3 * T], np.int32)
  np.testing.assert_allclose(_port(q, k, v, pos, impl, False),
                             _port(q, k, v, pos, impl, True),
                             rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl,exact,fill", [
    ("flash", False, "nan"), ("tiled", False, "nan"),
    ("flash", False, "big"), ("tiled", False, "big"),
    ("flash", True, "big"), ("tiled", True, "big")])
def test_stale_slots_are_invisible(impl, exact, fill):
  """Whatever the slots past pos hold, the output is bit-identical to the
  clean ring's (the fast modes never let a masked slot reach P V; the exact
  mode, as in the JAX package, zeroes its probabilities, which a finite
  value survives)."""
  q, k, v = _inputs(2)
  clean = _port(q, k, v, POS, impl, exact)
  k2, v2 = k.copy(), v.copy()
  for b, p in enumerate(POS):
    if fill == "nan":
      k2[b, p + 1:] = np.nan
      v2[b, p + 1:] = np.nan
    else:
      k2[b, p + 1:] = 1e9
      v2[b, p + 1:] = -1e9
  np.testing.assert_array_equal(_port(q, k2, v2, POS, impl, exact), clean)


def test_flash_decode_on_cpu_is_its_plain_version():
  q, k, v = (torch.from_numpy(x) for x in _inputs(3))
  pos = torch.from_numpy(POS)
  assert torch.equal(fa.flash_decode(q, k, v, pos, 0.3),
                     fa.flash_decode_plain(q, k, v, pos, 0.3))
  assert torch.equal(port_seq.decode_attention(q, k, v, pos, impl="flash"),
                     fa.flash_decode_plain(q, k, v, pos))


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_partials_merge_to_the_plain_version(splits):
  """The kernel's arithmetic (its plain model): per-split partials merged
  in a fixed order give the masked softmax, in f64 to rounding; a split
  with no admitted key contributes exactly nothing."""
  q, k, v = (torch.from_numpy(x) for x in _inputs(4, t=300,
                                                  dtype=np.float64))
  pos = torch.tensor([0, 70, 299, 450], dtype=torch.int32)
  m, l, o = fa.decode_partials_plain(q, k, v, pos, 0.25, splits)
  assert m.shape == l.shape == (B, H, splits) and o.shape == (B, H, splits,
                                                              D)
  got = fa.decode_merge_plain(m, l, o, torch.float64)
  ref = fa.flash_decode_plain(q, k, v, pos, 0.25)
  torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
  empty = m == float("-inf")
  assert torch.equal(l[empty], torch.zeros_like(l[empty]))
  assert bool((o[empty] == 0).all())


def test_split_bounds_cover_the_admitted_keys():
  """Each row's splits tile [0, min(pos + 1, T)) in order, in multiples of
  DECODE_SPLIT_ALIGN (the kernel's split_range), and never pass pos."""
  t = 2048
  for pos in (0, 63, 64, 1000, t - 1, 5 * t):
    n = torch.tensor([min(pos + 1, t)])
    for splits in (1, 3, 32):
      bounds = [tuple(int(x) for x in fa.decode_split_bounds(n, splits, s))
                for s in range(splits)]
      assert bounds[0][0] == 0 and bounds[-1][1] == int(n)
      for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
      sizes = [k1 - k0 for k0, k1 in bounds if k1 > k0]
      assert all(s % fa.DECODE_SPLIT_ALIGN == 0 for s in sizes[:-1])
  assert fa.decode_plan(1, 8, 2048, 132) == 16     # the largest cluster
  assert fa.decode_plan(16, 8, 2048, 132) == 8     # <= 256 keys a block
  assert fa.decode_plan(256, 8, 2048, 132) == 8
  assert fa.decode_plan(1, 8, 100, 132) == 2       # >= 64 keys a split


def test_paged_decode_raises():
  """An impl other than tiled or flash raises on the dense and the paged
  path alike. The paged mode (a page table over (P, page, H, D) pools) is
  ported: it no longer raises, and its cases against the JAX package are
  in tests/test_torch_serving_variants.py."""
  q, k, v = (torch.from_numpy(x) for x in _inputs(5))
  table = torch.arange(B * 4, dtype=torch.int32).reshape(B, 4)
  pool_k, pool_v = (x.reshape(B * 4, T // 4, H, D) for x in (k, v))
  out = port_seq.decode_attention(q, pool_k, pool_v, torch.from_numpy(POS),
                                  page_table=table)
  assert out.shape == (B, 1, H, D) and bool(torch.isfinite(out).all())
  with pytest.raises(ValueError, match="impl"):
    port_seq.decode_attention(q, k, v, torch.from_numpy(POS), impl="ring")
  with pytest.raises(ValueError, match="impl"):
    port_seq.decode_attention(q, pool_k, pool_v, torch.from_numpy(POS),
                              impl="ring", page_table=table)


def test_decode_wrappers_reject_other_devices():
  q = torch.zeros(2, 1, 2, 64, device="meta", dtype=torch.bfloat16)
  kv = torch.zeros(2, 128, 2, 64, device="meta", dtype=torch.bfloat16)
  pos = torch.zeros(2, device="meta", dtype=torch.int32)
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fa.flash_decode(q, kv, kv, pos)
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fa.flash_decode(q, kv, kv, pos.long(), 0.5)


def test_launch_counts_name_the_one_decode_kernel():
  """One decode kernel, one count: the split partials and their merge no
  longer launch apart."""
  assert "flash_decode" in fa.LAUNCHES
  assert not {"flash_decode_partial", "flash_decode_combine"} & \
      set(fa.LAUNCHES)


@pytest.mark.parametrize("b", [1, 16, 64, 256])
def test_decode_plan_covers_each_admitted_key_once(b):
  """At the serving ring (T 2048, H 8) on 132 SMs, for pos 0, T - 1 and
  past T: the plan's splits tile each row's admitted keys [0, n) exactly
  once, in order, never reach a slot past pos, walk at most
  DECODE_BLOCK_KEYS keys a block, and fit one cluster."""
  t, h = 2048, 8
  splits = fa.decode_plan(b, h, t, 132)
  assert 1 <= splits <= fa.DECODE_MAX_SPLITS
  for p in (0, t - 1, t, 3 * t + 7):
    n = torch.full((b,), min(p + 1, t), dtype=torch.long)
    seen = torch.zeros(b, t, dtype=torch.int64)
    kpos = torch.arange(t)
    for s in range(splits):
      k0, k1 = fa.decode_split_bounds(n, splits, s)
      assert bool((k1 - k0 <= fa.DECODE_BLOCK_KEYS).all())
      seen += ((kpos[None] >= k0[:, None]) & (kpos[None] < k1[:, None])).long()
    admitted = fa.decode_admitted(torch.full((b,), p, dtype=torch.int32), t)
    assert torch.equal(seen, admitted.long())


@pytest.mark.parametrize("b", [1, 16, 64, 256])
def test_plain_merge_at_the_plan_matches_the_plain_version(b):
  """The kernel's fixed-order merge (its plain model) at the plan's split
  count against flash_decode_plain on bf16 inputs at the serving ring's
  widths (fewer slots): within one bf16 ulp + 1e-3 of max |ref|, the
  tolerance chip_smoke.py holds the kernel to."""
  t, h, d = 512, 8, 64
  q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
             for x in _inputs(6 + b, b=b, t=t, h=h, d=d))
  rng = np.random.default_rng(b)
  pos = torch.from_numpy(rng.integers(0, 2 * t, b).astype(np.int32))
  pos[-1] = t - 1
  pos[0] = 0
  splits = fa.decode_plan(b, h, t, 132)
  got = fa.decode_merge_plain(
      *fa.decode_partials_plain(q, k, v, pos, None, splits), torch.bfloat16)
  ref = fa.flash_decode_plain(q, k, v, pos).float()
  tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
  assert bool(((got.float() - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_decode_kernels_match_plain_on_card():
  """The decode kernel against its plain version on the card, through a
  strided layer view of a (L, B, T, H, D) cache as the LM passes it: one
  launch, two launches bitwise equal, NaN past pos invisible
  (chip_smoke.py phase decode runs the same checks at the serving LM's
  shapes)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels have no CPU mode")
  g = torch.Generator(device="cuda").manual_seed(0)
  b, t, h, d = 3, 700, 4, 64
  qkv = torch.randn(b, 1, 3, h, d, generator=g, device="cuda").bfloat16()
  cache = torch.randn(2, 2, b, t, h, d, generator=g, device="cuda").bfloat16()
  q, k, v = qkv[:, :, 0], cache[0, 1], cache[1, 1]
  pos = torch.tensor([0, 350, 900], dtype=torch.int32, device="cuda")
  before = dict(fa.LAUNCHES)
  o = fa.flash_decode(q, k, v, pos)
  assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
      "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
      "flash_attention_bwd_dq": 0, "flash_decode": 1}
  assert torch.equal(fa.flash_decode(q, k, v, pos), o)
  ref = fa.flash_decode_plain(q, k, v, pos)
  tol = 2 ** -7 * ref.float().abs() + 1e-3 * ref.float().abs().max()
  assert bool(((o.float() - ref.float()).abs() <= tol).all())
  stale = ~fa.decode_admitted(pos, t)
  k2, v2 = k.clone(), v.clone()
  k2[stale] = float("nan")
  v2[stale] = float("nan")
  assert torch.equal(fa.flash_decode(q, k2, v2, pos), o)
