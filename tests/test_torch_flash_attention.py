"""The port's attention against the JAX package's, on the CPU in f32.

``ops/flash_attention.py``'s plain versions (forward with lse, dK/dV, dQ)
and the ``FlashAttention`` Function -- what the CUDA kernels compute, in
plain ops -- against ``parallel/sequence.pallas_flash_attention`` of the
JAX package, which on the CPU is its ``full_attention`` reference with the
kernel's mask (sequence.py:789-795), differentiated by ``jax.grad``. Also
the port's ``full_attention`` and ``blockwise_attention`` against the JAX
package's. Inputs are numpy arrays from a seed. Tolerances (f32): 1e-5 of
the largest magnitude for forwards, 1e-4 for gradients -- the two sides sum
in other orders. The kernels themselves are held against the plain
versions on the card by the ``cuda``-marked test at the end and by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.parallel import sequence as jax_seq
from kf_benchmarks_tpu_torch.ops import flash_attention as fa
from kf_benchmarks_tpu_torch.parallel import sequence as port_seq

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(b, lq, lk, h, d, seed):
  rng = np.random.default_rng(seed)
  q = rng.normal(size=(b, lq, h, d)).astype(np.float32)
  k = rng.normal(size=(b, lk, h, d)).astype(np.float32)
  v = rng.normal(size=(b, lk, h, d)).astype(np.float32)
  g = rng.normal(size=(b, lq, h, d)).astype(np.float32)
  return q, k, v, g


def _segments(b, length, seed):
  """Contiguous documents of random length, 1-based, padding 0 at the
  tail of each row (the packer's layout)."""
  rng = np.random.default_rng(seed)
  seg = np.zeros((b, length), np.int32)
  for row in range(b):
    pos, doc = 0, 1
    while pos < length - 4:
      n = int(rng.integers(1, length // 3))
      seg[row, pos:pos + n] = doc
      pos += n
      doc += 1
  return seg


def _close(got, ref, tol, what=""):
  ref = np.asarray(ref)
  np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                             atol=tol * np.abs(ref).max(), err_msg=what)


def _lse_reference(q, k, causal, scale, seg):
  """Row log-sum-exp of the admissible scaled scores, in float64."""
  s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                k.astype(np.float64)) * scale
  lq, lk = q.shape[1], k.shape[1]
  mask = np.ones((1, 1, lq, lk), bool)
  if causal:
    mask = mask & (np.arange(lq)[:, None] >= np.arange(lk)[None, :])
  if seg is not None:
    mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
  s = np.where(mask, s, -np.inf)
  m = s.max(-1, keepdims=True)
  return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


# (causal, segment ids, Lq, Lk): segment ids serve as both q and kv ids, as
# pallas_flash_attention passes them, so those cases have Lq == Lk.
CASES = {
    "causal": (True, False, 64, 64),
    "full": (False, False, 48, 80),
    "causal_lq_ne_lk": (True, False, 40, 72),
    "causal_segments": (True, True, 64, 64),
    "full_segments": (False, True, 56, 56),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_and_lse_match_jax(case):
  causal, use_seg, lq, lk = CASES[case]
  q, k, v, _ = _inputs(2, lq, lk, 3, 16, seed=len(case))
  seg = _segments(2, lq, seed=5) if use_seg else None
  scale = 0.3
  ref = jax_seq.pallas_flash_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
      scale=scale, segment_ids=None if seg is None else jnp.asarray(seg))
  tseg = None if seg is None else torch.from_numpy(seg)
  o, lse = fa.flash_attention_fwd_plain(
      torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal,
      scale, tseg, tseg)
  _close(o.numpy(), ref, FWD_TOL, "o")
  _close(lse.numpy(), _lse_reference(q, k, causal, scale, seg), FWD_TOL,
         "lse")
  # The wrapper on a CPU tensor is the plain version.
  o2, _ = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal, scale, tseg,
                                 tseg)
  assert torch.equal(o, o2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_grad(case):
  """dQ, dK, dV of the Function (its CPU backward runs the plain dK/dV and
  dQ versions) and of the plain versions called directly, against jax.grad
  through the JAX package's flash attention."""
  causal, use_seg, lq, lk = CASES[case]
  q, k, v, g = _inputs(2, lq, lk, 3, 16, seed=10 + len(case))
  seg = _segments(2, lq, seed=6) if use_seg else None
  scale = 0.25
  jseg = None if seg is None else jnp.asarray(seg)

  def loss(q_, k_, v_):
    o = jax_seq.pallas_flash_attention(q_, k_, v_, causal=causal,
                                       scale=scale, segment_ids=jseg)
    return jnp.sum(o * jnp.asarray(g))

  ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
  tseg = None if seg is None else torch.from_numpy(seg)
  leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
  o = fa.flash_attention(*leaves, causal=causal, scale=scale, q_seg=tseg,
                         kv_seg=tseg)
  got = torch.autograd.grad((o * torch.from_numpy(g)).sum(), leaves)
  for name, a, b in zip("qkv", got, ref):
    _close(a.numpy(), b, GRAD_TOL, "d" + name)

  tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
  o, lse = fa.flash_attention_fwd_plain(tq, tk, tv, causal, scale, tseg,
                                        tseg)
  di = (o * tg).sum(-1).transpose(1, 2)
  dk, dv = fa.flash_attention_bwd_dkv_plain(tq, tk, tv, tg, lse, di, causal,
                                            scale, tseg, tseg)
  dq = fa.flash_attention_bwd_dq_plain(tq, tk, tv, tg, lse, di, causal,
                                       scale, tseg, tseg)
  for name, a, b in zip("qkv", (dq, dk, dv), ref):
    _close(a.numpy(), b, GRAD_TOL, "plain d" + name)


def test_kv_only_segment_mask_matches_masked_softmax():
  """The decode mode's structure: Lq != Lk, non-causal, q ids all 1 and kv
  ids marking the valid keys, against the masked softmax in float64."""
  q, k, v, _ = _inputs(2, 8, 40, 2, 16, seed=3)
  valid = np.arange(40)[None, :] <= np.array([[17], [33]])
  q_seg = torch.ones(2, 8, dtype=torch.int32)
  kv_seg = torch.from_numpy(valid.astype(np.int32))
  o, lse = fa.flash_attention_fwd_plain(
      torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), False,
      0.5, q_seg, kv_seg)
  s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * 0.5
  s = np.where(valid[:, None, None, :], s, -np.inf)
  m = s.max(-1, keepdims=True)
  p = np.exp(s - m)
  ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
  _close(o.numpy(), ref, FWD_TOL, "o")
  _close(lse.numpy(), (m + np.log(p.sum(-1, keepdims=True)))[..., 0],
         FWD_TOL, "lse")


def test_plain_rounds_probabilities_to_the_input_dtype():
  """On bf16 inputs the plain forward rounds P to bf16 before P V, as the
  kernel and the TPU library do: it then differs from an all-f32 softmax
  by about bf16 rounding, and from the bf16-rounded P form by f32 noise."""
  q, k, v, _ = (torch.from_numpy(x).bfloat16()
                for x in _inputs(1, 32, 32, 2, 16, seed=4))
  o, _ = fa.flash_attention_fwd_plain(q, k, v, True, 0.25)
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 0.25
  s = s.masked_fill(~fa.admissible(32, 32, True), -np.inf)
  p = torch.exp(s - s.amax(-1, keepdim=True))
  ref = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float())
  ref = ref / p.sum(-1).transpose(1, 2)[..., None]
  _close(o.float().numpy(), ref.bfloat16().float().numpy(), 2 ** -7)


@pytest.mark.parametrize("causal,use_seg", [(False, False), (True, False),
                                            (True, True)])
def test_full_attention_matches_jax(causal, use_seg):
  q, k, v, _ = _inputs(2, 32, 32, 2, 8, seed=7)
  seg = _segments(2, 32, seed=8) if use_seg else None
  ref = jax_seq.full_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
      segment_ids=None if seg is None else jnp.asarray(seg))
  got = port_seq.full_attention(
      torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
      causal=causal, segment_ids=None if seg is None else
      torch.from_numpy(seg))
  _close(got.numpy(), ref, FWD_TOL)


# (block, q block, causal, segment ids)
BLOCKWISE = [(16, None, False, False), (16, None, True, False),
             (16, 16, True, False), (8, 16, True, True),
             (16, 8, False, True)]


@pytest.mark.parametrize("block,q_block,causal,use_seg", BLOCKWISE)
def test_blockwise_attention_matches_jax(block, q_block, causal, use_seg):
  q, k, v, g = _inputs(2, 48, 48, 2, 8, seed=9)
  seg = _segments(2, 48, seed=10) if use_seg else None
  jseg = None if seg is None else jnp.asarray(seg)

  def jax_loss(q_, k_, v_):
    o = jax_seq.blockwise_attention(q_, k_, v_, block, causal=causal,
                                    q_block_size=q_block, segment_ids=jseg)
    return jnp.sum(o * jnp.asarray(g)), o

  (_, ref), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
  got = port_seq.blockwise_attention(
      *leaves, block, causal=causal, q_block_size=q_block,
      segment_ids=None if seg is None else torch.from_numpy(seg))
  _close(got.detach().numpy(), ref, FWD_TOL)
  grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), leaves)
  for name, a, b in zip("qkv", grads, ref_grads):
    _close(a.numpy(), b, GRAD_TOL, "d" + name)


def test_pallas_flash_attention_is_the_function():
  q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 2, 8, 11))
  a = port_seq.pallas_flash_attention(q, k, v, causal=True, block=512)
  b = fa.flash_attention(q, k, v, causal=True)
  assert torch.equal(a, b)


def test_wrappers_reject_other_devices():
  x = torch.zeros(1, 64, 2, 64, device="meta", dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fa.flash_attention_fwd(x, x, x, True)
  lse = torch.zeros(1, 2, 64, device="meta")
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fa.flash_attention_bwd_dkv(x, x, x, x, lse, lse, True)
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fa.flash_attention_bwd_dq(x, x, x, x, lse, lse, True)


@pytest.mark.parametrize("name", ["flash_attention_fwd",
                                  "flash_attention_bwd_dkv",
                                  "flash_attention_bwd_dq"])
@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_wrappers_refuse_a_non_positive_scale(name, scale):
  """The kernels take a positive scale only (the forward keeps the running
  max of the unscaled scores; the backward reads its lse): every wrapper
  refuses another before a launch."""
  x = torch.zeros(1, 64, 2, 64, device="meta", dtype=torch.bfloat16)
  lse = torch.zeros(1, 2, 64, device="meta")
  args = (x, x, x) if name == "flash_attention_fwd" else (x, x, x, x, lse,
                                                          lse)
  with pytest.raises(ValueError, match="positive scale"):
    getattr(fa, name)(*args, True, scale)


# (Lq, Lk, causal, q tile, key tile): the kernels' 64 x 64 tiles at equal,
# shorter and longer q, ragged lengths and the decode mode's Lq < Lk, and
# other tile sizes for the helper itself.
BACKWARD_TILES = [
    (64, 64, True, 64, 64), (64, 64, False, 64, 64),
    (100, 300, True, 64, 64), (300, 100, True, 64, 64),
    (130, 257, False, 64, 64), (1000, 1000, True, 64, 64),
    (256, 1024, False, 64, 64), (40, 200, True, 64, 64),
    (333, 333, True, 32, 16), (70, 150, True, 16, 32),
]


@pytest.mark.parametrize("lq,lk,causal,qt,kt", BACKWARD_TILES)
def test_backward_tiles_cover_every_admissible_pair(lq, lk, causal, qt, kt):
  """Each backward kernel's (q tile, key tile) visits hold every admissible
  pair, and the key tiles the dK/dV kernel visits with no q tile (written
  as zeros) hold none; at the kernels' 64 x 64 tiles the visits are
  exactly the tiles that hold an admissible pair."""
  tiles = fa.backward_tiles(lq, lk, causal, qt, kt)
  mask = fa.admissible(lq, lk, causal)
  if mask is None:
    mask = torch.ones(lq, lk, dtype=torch.bool)
  rows, cols = torch.nonzero(mask, as_tuple=True)
  needed = set(zip((rows // qt).tolist(), (cols // kt).tolist()))
  for kernel in ("dkv", "dq"):
    visits = tiles[kernel]
    assert len(visits) == len(set(visits)), kernel
    assert needed <= set(visits), kernel
    if (qt, kt) == (fa.Q_TILE, fa.KEY_TILE):
      assert set(visits) == needed, kernel
  visited_keys = {c for _, c in tiles["dkv"]}
  n_k = -(-lk // kt)
  assert tiles["zero_key_tiles"] == [c for c in range(n_k)
                                     if c not in visited_keys]
  assert not any(c in tiles["zero_key_tiles"] for _, c in needed)
  if causal and lq < lk and (qt, kt) == (fa.Q_TILE, fa.KEY_TILE):
    # The key tiles wholly past the last row: no q tile reaches them.
    assert tiles["zero_key_tiles"] == list(range(-(-lq // kt), n_k))


@pytest.mark.parametrize("shape,stride,ptr,error", [
    ((2, 64, 4, 64), (64 * 4 * 64, 4 * 64, 64, 1), 256, None),
    # qkv.unbind(2) of a packed (B, L, 3, H, D) projection, as the LM
    # passes them: position stride 3 H D.
    ((2, 64, 4, 64), (64 * 3 * 4 * 64, 3 * 4 * 64, 64, 1), 256 + 512,
     None),
    ((2, 64, 4, 64), (64 * 4 * 64, 4 * 64, 64, 1), 8, "16-byte aligned"),
    ((2, 64, 4, 64), (64, 2 * 64 * 4, 1, 4), 256, "D contiguous"),
    ((2, 64, 4, 64), (64 * 4 * 64, 4 * 64 + 4, 64, 1), 256,
     "16-byte aligned"),
    ((2, 64, 4, 64), (2 ** 40, 4 * 64, 64, 1), 256, "2^40"),
    ((64, 4, 64), (256, 64, 1), 256, "(B, L, H, D)"),
], ids=["contiguous", "packed_view", "base_8", "heads_last", "row_pad_4",
        "stride_2^40", "rank3"])
def test_qkv_layout_acceptance(shape, stride, ptr, error):
  """The q/k/v layouts the wrappers refuse before a launch: the forward
  reads them through 4-D TMA tensor maps (D, H, L, B)."""
  got = fa.qkv_layout_error("q", shape, stride, ptr)
  if error is None:
    assert got is None
  else:
    assert got is not None and error in got


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
  """The three kernels against their plain versions on the card, causal
  with segment ids and a ragged length, through strided views of one
  packed projection as the LM passes them, then at Lq != Lk, a kv-only
  mask and D = 128 (chip_smoke.py runs the same checks at the LM's
  shape)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels have no CPU mode")
  g = torch.Generator(device="cuda").manual_seed(0)
  b, t, h, d = 2, 200, 4, 64
  qkv = torch.randn(b, t, 3, h, d, generator=g, device="cuda").bfloat16()
  q, k, v = qkv.unbind(2)
  do = torch.randn(b, t, h, d, generator=g, device="cuda").bfloat16()
  seg = torch.from_numpy(_segments(b, t, seed=1)).cuda()
  before = dict(fa.LAUNCHES)
  o, lse = fa.flash_attention_fwd(q, k, v, True, 0.125, seg, seg)
  o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True, 0.125, seg,
                                                seg)
  di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
  dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, True, 0.125,
                                      seg, seg)
  dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, True, 0.125, seg, seg)
  torch.cuda.synchronize()
  assert {k_: fa.LAUNCHES[k_] - before[k_] for k_ in before} == {
      "flash_attention_fwd": 1, "flash_attention_bwd_dkv": 1,
      "flash_attention_bwd_dq": 1, "flash_decode": 0}
  tol = 2 ** -7 * o_ref.float().abs() + 1e-3 * o_ref.float().abs().max()
  assert bool(((o.float() - o_ref.float()).abs() <= tol).all())
  torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)
  dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di,
                                                    True, 0.125, seg, seg)
  dq_ref = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, True, 0.125,
                                           seg, seg)
  for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
    err = (got.float() - ref.float()).abs().max()
    assert float(err) <= 3e-2 * float(ref.float().abs().max())
  # The forward and the two backward kernels at Lq != Lk (causal top-left,
  # and a kv-only mask) and at D = 128 with a ragged length and segment ids.
  for b, lq, lk, h, d, causal, with_seg in ((2, 100, 300, 2, 64, True, False),
                                            (2, 300, 100, 2, 64, True, False),
                                            (2, 130, 257, 2, 64, False, True),
                                            (2, 200, 200, 2, 128, True, True),
                                            (1, 333, 333, 1, 128, False,
                                             False)):
    q = torch.randn(b, lq, h, d, generator=g, device="cuda").bfloat16()
    k = torch.randn(b, lk, h, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(b, lk, h, d, generator=g, device="cuda").bfloat16()
    qs = ks = None
    if with_seg:
      qs = torch.from_numpy(_segments(b, lq, seed=2)).cuda()
      ks = torch.from_numpy(_segments(b, lk, seed=2)).cuda()
      if lq != lk:  # the decode mode's mask: q ids 1, kv 1 on valid keys
        qs = torch.ones_like(qs)
        ks = (ks > 0).int()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, d ** -0.5, qs, ks)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal, d ** -0.5,
                                                  qs, ks)
    torch.cuda.synchronize()
    tol = 2 ** -7 * o_ref.float().abs() + 1e-3 * o_ref.float().abs().max()
    assert bool(((o.float() - o_ref.float()).abs() <= tol).all()), (lq, lk, d)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)
    do = torch.randn(b, lq, h, d, generator=g, device="cuda").bfloat16()
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, di, causal, d ** -0.5, qs, ks)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    dq = fa.flash_attention_bwd_dq(*args)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(*args)
    dq_ref = fa.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
      err = (got.float() - ref.float()).abs().max()
      assert float(err) <= 3e-2 * float(ref.float().abs().max()), (lq, lk, d)
    if causal and lq < lk:  # keys no row reaches: written as exact zeros
      assert not dk[:, lq:].any() and not dv[:, lq:].any()
