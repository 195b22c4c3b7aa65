"""The port's serving decode-cost variants against the JAX package's, on the
CPU in f32.

INT8 weights, the paged KV cache and speculative decoding, alone and all
three together, at the JAX variant tests' tiny LM (tests/
test_serving_variants.py TINY: vocab 97, d 32, 2 layers, 4 heads, d_ff 64,
context 32, attention blocks of 8), built in both frameworks from one flax
init (converted by convert.py) and fed the same numpy tokens and seeded
workloads. Tolerances:

* tokens, page and acceptance counts, pool sizes: exact;
* logits and K/V of the INT8 programs against the JAX programs on the same
  quantized weights: rtol 1e-5, atol 1e-5 (f32 sums taken in other orders
  by the two frameworks, as tests/test_torch_serving.py holds them);
* paged decode attention against the port's dense tiled path at block =
  page: bitwise (the same values block by block, the same op sequence);
  against the JAX paged path: 1e-5;
* ``quantize_agreement``: agreement and total exact, the logit delta to
  1e-5 of the logit scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import quantization as jax_q
from kf_benchmarks_tpu.analysis import baseline as jax_baseline
from kf_benchmarks_tpu.parallel import sequence as jax_seq
from kf_benchmarks_tpu.serving import decode as jax_decode
from kf_benchmarks_tpu.serving import engine as jax_engine
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import quantization as port_q
from kf_benchmarks_tpu_torch import tracing as port_tracing
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.parallel import sequence as port_seq
from kf_benchmarks_tpu_torch.serving import decode as port_decode
from kf_benchmarks_tpu_torch.serving import engine as port_engine

torch.set_num_threads(2)

TINY = dict(vocab=97, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_len=32, attn_block=8)
RTOL = ATOL = 1e-5
SPEC = dict(speculative_k=3, draft_n_layers=1)
ALL3 = dict(quantize="int8", kv_page_size=8, **SPEC)


def _specs(**kw):
  return (jax_decode.LMSpec(**{**TINY, **kw}),
          port_decode.LMSpec(**{**TINY, **kw}))


@pytest.fixture(scope="module")
def tiny():
  """(flax variables, the port's state of the same weights)."""
  jspec, pspec = _specs()
  variables = jax.device_get(jax_decode.init_variables(jspec, seed=0))
  state = convert.flax_to_state_dict(variables,
                                     port_decode.forward_module(pspec))
  return variables, state


def _workload(jspec, n=10, rate=50.0, seed=3, max_new=6):
  return [r for _, r in jax_engine.poisson_workload(
      n, rate, jspec, seed=seed, max_new_tokens=max_new)]


def _run_jax(kw, variables, reqs, ladder=(1, 2, 4), max_new=6):
  cfg = jax_engine.EngineConfig(spec=jax_decode.LMSpec(**{**TINY, **kw}),
                                bucket_ladder=ladder, max_new_tokens=max_new)
  eng = jax_engine.ServingEngine(cfg, variables=variables, seed=0)
  for r in reqs:
    eng.submit(dataclasses.replace(r))
  return eng, {r.rid: tuple(r.tokens) for r in eng.drain()
               if r.status == "ok"}


def _run_port(kw, state, reqs, ladder=(1, 2, 4), max_new=6):
  cfg = port_engine.EngineConfig(spec=port_decode.LMSpec(**{**TINY, **kw}),
                                 bucket_ladder=ladder,
                                 max_new_tokens=max_new)
  eng = port_engine.ServingEngine(cfg, variables=state, seed=0,
                                  device="cpu")
  for r in reqs:
    eng.submit(port_engine.Request(rid=r.rid, prompt=np.asarray(r.prompt),
                                   max_new_tokens=r.max_new_tokens,
                                   tenant=r.tenant))
  return eng, {r.rid: tuple(r.tokens) for r in eng.drain()
               if r.status == "ok"}


# -- the spec ------------------------------------------------------------------

@pytest.mark.parametrize("kw,needle", [
    (dict(quantize="fp4"), "quantize"),
    (dict(kv_page_size=7), "kv_page_size"),          # 7 does not divide 32
    (dict(speculative_k=1, draft_n_layers=1), "speculative_k"),
    (dict(speculative_k=3), "draft"),                # no draft spec
    (dict(speculative_k=3, draft_n_layers=2), "draft"),  # not < n_layers
    (dict(draft_n_layers=1), "inert"),               # draft without k
])
def test_spec_rejects_invalid_variants_as_jax_does(kw, needle):
  with pytest.raises(ValueError, match=needle) as jerr:
    jax_decode.LMSpec(**{**TINY, **kw})
  with pytest.raises(ValueError, match=needle) as perr:
    port_decode.LMSpec(**{**TINY, **kw})
  assert str(perr.value) == str(jerr.value)


def test_model_shards_is_refused_naming_its_item():
  with pytest.raises(ValueError, match="item 11"):
    port_decode.LMSpec(**TINY, model_shards=2)


def test_variant_off_config_fingerprints_as_before():
  """The variant fields are None in config() when off, and the
  fingerprint drops None fields: the variant-off key is the key of the
  config without them (the port's config before this slice), as in the
  JAX package."""
  cfg = port_decode.LMSpec(**TINY).config()
  variant_keys = ("quantize", "kv_page_size", "speculative_k",
                  "draft_n_layers", "model_shards")
  assert all(cfg[k] is None for k in variant_keys)
  stripped = {k: v for k, v in cfg.items() if k not in variant_keys}
  key = port_engine.config_fingerprint_key
  assert key({**cfg, "bucket": 4}, "sd") == key({**stripped, "bucket": 4},
                                                "sd")
  on = port_decode.LMSpec(**TINY, **ALL3).config()
  assert key({**on, "bucket": 4}, "sd") != key({**cfg, "bucket": 4}, "sd")
  jcfg = jax_decode.LMSpec(**TINY, **ALL3).config()
  assert {k: on[k] for k in variant_keys} == \
      {k: jcfg[k] for k in variant_keys}
  assert jax_baseline is not None  # the JAX package's own key drops None


# -- INT8 programs -------------------------------------------------------------

def _jax_qvars(variables):
  return jax_decode.prepare_variables(
      jax_decode.LMSpec(**TINY, quantize="int8"), variables)


def test_int8_state_is_the_jax_quantized_tree(tiny):
  variables, state = tiny
  pspec = port_decode.LMSpec(**TINY, quantize="int8")
  pq = port_decode.prepare_variables(pspec, state)
  module = port_decode.forward_module(pspec)
  want = convert.flax_to_quantized_state(_jax_qvars(variables), module)
  assert pq.keys() == want.keys()
  for key in pq:
    a, b = pq[key], want[key]
    if port_q.is_quantized(a):
      assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), key
    else:
      assert torch.equal(a, b), key
  assert port_q.quantized_fraction(pq) == \
      jax_q.quantized_fraction(_jax_qvars(variables))


def test_int8_decode_prefill_and_verify_match_jax(tiny):
  """The INT8 module's programs against the JAX programs on the JAX
  quantized tree: next tokens and verify predictions equal, decode logits
  and prefill K/V spans to 1e-5."""
  variables, state = tiny
  jspec, pspec = _specs(quantize="int8")
  jq = _jax_qvars(variables)
  module = port_decode.load_module(pspec, port_decode.prepare_variables(
      pspec, state), "cpu")
  assert isinstance(module, port_decode.QuantizedLM)
  rng = np.random.default_rng(5)
  b, t = 3, TINY["max_len"]
  tokens = rng.integers(0, TINY["vocab"], (b, t)).astype(np.int32)
  # verify: the greedy argmax at every position.
  jpreds = np.asarray(jax.jit(jax_decode.verify_fn(jspec))(
      jq, jnp.asarray(tokens)))
  ppreds = port_decode.verify_fn(pspec)(module, torch.from_numpy(tokens))
  np.testing.assert_array_equal(ppreds.numpy(), jpreds)
  # decode: one step at seeded positions over a seeded cache.
  shape = (TINY["n_layers"], b, t, TINY["n_heads"], 8)
  ck = rng.normal(size=shape).astype(np.float32)
  cv = rng.normal(size=shape).astype(np.float32)
  pos = np.array([0, 11, 31], np.int32)
  tok = tokens[:, 0].copy()
  active = np.array([True, True, False])
  jnxt, jk, jv, jpos = jax.jit(jax_decode.decode_fn(jspec))(
      jq, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
      jnp.asarray(tok), jnp.asarray(active))
  pk, pv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
  ppos, ptok = torch.from_numpy(pos.copy()), torch.from_numpy(tok.copy())
  port_decode.decode_fn(pspec)(module, pk, pv, ppos, ptok,
                               torch.from_numpy(active))
  np.testing.assert_array_equal(ptok.numpy(), np.asarray(jnxt))
  np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
  np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=RTOL,
                             atol=ATOL)
  jlogits, _ = jax_decode.decode_module(jspec).apply(
      jax_q.dequantize_variables(jq, jnp.float32), jnp.asarray(tok),
      jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos))
  plogits, _ = module.decode(torch.from_numpy(tok), torch.from_numpy(ck),
                             torch.from_numpy(cv), torch.from_numpy(pos))
  np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                             rtol=RTOL, atol=ATOL)
  # prefill: first tokens and the K/V spans of a packed wave.
  packed = np.stack([tokens[:2], np.ones((2, t), np.int32),
                     np.tile(np.arange(t, dtype=np.int32), (2, 1))], 1)
  rows = np.array([0, 1], np.int32)
  last = np.array([9, 20], np.int32)
  offs = np.zeros(2, np.int32)
  jfirst, jek, jev = jax.jit(jax_decode.prefill_fn(jspec))(
      jq, jnp.asarray(packed), jnp.asarray(rows), jnp.asarray(last),
      jnp.asarray(offs))
  pfirst, pek, pev = port_decode.prefill_fn(pspec)(
      module, torch.from_numpy(packed), torch.from_numpy(rows),
      torch.from_numpy(last), torch.from_numpy(offs))
  np.testing.assert_array_equal(pfirst.numpy(), np.asarray(jfirst))
  np.testing.assert_allclose(pek.numpy(), np.asarray(jek), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(pev.numpy(), np.asarray(jev), rtol=RTOL,
                             atol=ATOL)


def test_int8_decode_gathers_the_embedding_rows_it_reads():
  """With a quantized embedding (vocab 256 x d 32 = 8192 elements), the
  INT8 decode dequantizes only the rows of its tokens: logits and caches
  bitwise those of the module holding the whole dequantized state (f32:
  each element is q * scale either way)."""
  spec = port_decode.LMSpec(**{**TINY, "vocab": 256}, quantize="int8")
  qvars = port_decode.prepare_variables(spec, port_decode.init_variables(
      spec, seed=1))
  assert port_q.is_quantized(qvars["embed.weight"])
  qmodule = port_decode.load_module(spec, qvars, "cpu")
  dense = port_decode.load_module(
      dataclasses.replace(spec, quantize=None),
      port_q.dequantize_variables(qvars), "cpu")
  rng = np.random.default_rng(2)
  shape = (TINY["n_layers"], 3, TINY["max_len"], TINY["n_heads"], 8)
  ck = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
  cv = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
  tok = torch.tensor([5, 200, 5], dtype=torch.int32)
  pos = torch.tensor([0, 9, 31], dtype=torch.int32)
  with torch.no_grad():
    got, (gk, gv) = qmodule.decode(tok, ck.clone(), cv.clone(), pos)
    want, (wk, wv) = dense.decode(tok, ck.clone(), cv.clone(), pos)
  assert torch.equal(got, want)
  assert torch.equal(gk, wk) and torch.equal(gv, wv)


def test_quantize_agreement_matches_jax(tiny):
  """The INT8 gate on the JAX test's seeded probe: agreement and total
  exact, the max logit delta and scale to 1e-5 (relative)."""
  variables, state = tiny
  jspec, pspec = _specs(quantize="int8")
  rng = np.random.default_rng(0)
  prompts = [rng.integers(0, TINY["vocab"], size=int(rng.integers(2, 10)))
             for _ in range(8)]
  jgate = jax_decode.quantize_agreement(jspec, variables, prompts, 6)
  pgate = port_decode.quantize_agreement(pspec, state, prompts, 6)
  assert set(pgate) == set(jgate)
  assert pgate["total"] == jgate["total"] >= 30
  assert pgate["agreement"] == jgate["agreement"]
  assert pgate["passed"] is jgate["passed"]
  for key in ("max_logit_delta", "logit_scale"):
    assert abs(pgate[key] - jgate[key]) <= 1e-5 * jgate["logit_scale"], key
  with pytest.raises(ValueError, match="quantized spec"):
    port_decode.quantize_agreement(port_decode.LMSpec(**TINY), state,
                                   prompts, 4)


def test_int8_engine_tokens_equal_jax(tiny):
  variables, state = tiny
  reqs = _workload(jax_decode.LMSpec(**TINY))
  _, jtoks = _run_jax(dict(quantize="int8"), variables, reqs)
  eng, ptoks = _run_port(dict(quantize="int8"), state, reqs)
  assert ptoks == jtoks and len(ptoks) == 10
  assert isinstance(eng.module, port_decode.QuantizedLM)


# -- paged KV ------------------------------------------------------------------

def _pool_case(seed=0, b=2, h=4, dh=8, page=8, npages=4):
  rng = np.random.RandomState(seed)
  kpool = rng.randn(1 + b * npages, page, h, dh).astype(np.float32)
  vpool = rng.randn(1 + b * npages, page, h, dh).astype(np.float32)
  table = np.arange(1, 1 + b * npages, dtype=np.int32).reshape(b, npages)
  q = rng.randn(b, 1, h, dh).astype(np.float32)
  pos = np.array([13, 27], np.int32)
  return kpool, vpool, table, q, pos


def test_paged_attention_bitwise_the_dense_tiled_path():
  """The paged fast path at block = page is the dense tiled schedule on a
  ring holding the same tokens, bitwise; the exact paged path is the
  dense exact path, bitwise; both agree with the JAX paged paths (1e-5)."""
  kpool, vpool, table, q, pos = _pool_case()
  b, page, npages = 2, 8, 4
  t = page * npages
  kd, vd = kpool[table].reshape(b, t, 4, 8), vpool[table].reshape(b, t, 4, 8)
  T = torch.from_numpy
  dense = port_seq.decode_attention(T(q), T(kd), T(vd), T(pos), block=page,
                                    impl="tiled")
  paged = port_seq.decode_attention(T(q), T(kpool), T(vpool), T(pos),
                                    block=page, impl="tiled",
                                    page_table=T(table))
  assert torch.equal(dense, paged)
  # impl='flash' takes the same tiled gather (no block-table kernel).
  flash = port_seq.decode_attention(T(q), T(kpool), T(vpool), T(pos),
                                    block=page, impl="flash",
                                    page_table=T(table))
  assert torch.equal(flash, paged)
  dense_exact = port_seq.decode_attention(T(q), T(kd), T(vd), T(pos),
                                          block=page, impl="tiled",
                                          exact=True, q_block=page)
  paged_exact = port_seq.decode_attention(T(q), T(kpool), T(vpool), T(pos),
                                          block=page, impl="tiled",
                                          exact=True, page_table=T(table),
                                          q_block=page)
  assert torch.equal(dense_exact, paged_exact)
  J = jnp.asarray
  jpaged = jax_seq.decode_attention(J(q), J(kpool), J(vpool), J(pos),
                                    block=page, impl="tiled",
                                    page_table=J(table))
  np.testing.assert_allclose(paged.numpy(), np.asarray(jpaged), rtol=RTOL,
                             atol=ATOL)
  jexact = jax_seq.decode_attention(J(q), J(kpool), J(vpool), J(pos),
                                    block=page, impl="tiled", exact=True,
                                    page_table=J(table), q_block=page)
  np.testing.assert_allclose(paged_exact.numpy(), np.asarray(jexact),
                             rtol=RTOL, atol=ATOL)


def test_paged_attention_ignores_stale_and_scratch_contents():
  """Positions past pos and the scratch page may hold anything, NaN
  included: the result is bitwise the same."""
  kpool, vpool, table, q, _ = _pool_case(seed=4)
  pos = np.array([13, 20], np.int32)
  table[1, 3] = 0  # slot 1's unallocated last page names the scratch page
  T = torch.from_numpy
  ref = port_seq.decode_attention(T(q), T(kpool), T(vpool), T(pos), block=8,
                                  page_table=T(table))
  k2, v2 = kpool.copy(), vpool.copy()
  k2[0] = v2[0] = np.nan
  k2[table[0, 1], 6:] = v2[table[0, 1], 6:] = np.nan  # slot 0 pos 13
  got = port_seq.decode_attention(T(q), T(k2), T(v2), T(pos), block=8,
                                  page_table=T(table))
  assert torch.equal(ref, got)


def test_kv_pool_pages_equal_jax_and_under_the_dense_slab():
  jspec, pspec = _specs(kv_page_size=8)
  pps = pspec.pages_per_slot
  assert pps == jspec.pages_per_slot == 4
  for bucket in (1, 2, 4, 8, 256):
    assert port_decode.kv_pool_pages(pspec, bucket) == \
        jax_decode.kv_pool_pages(jspec, bucket)
    if bucket > 1:
      assert port_decode.kv_pool_pages(pspec, bucket) < bucket * pps
  assert port_decode.kv_pool_pages(pspec, 1) >= pps + 1
  cache = port_decode.init_cache(pspec, 4, "cpu", slots=5)
  assert cache.k.shape == (2, port_decode.kv_pool_pages(pspec, 4), 8, 4, 8)
  assert cache.pos.shape == (5,)


def test_paged_engine_matches_jax_dense_and_reference(tiny):
  variables, state = tiny
  reqs = _workload(jax_decode.LMSpec(**TINY))
  _, jtoks = _run_jax(dict(kv_page_size=8), variables, reqs)
  eng, ptoks = _run_port(dict(kv_page_size=8), state, reqs)
  _, dense = _run_port({}, state, reqs)
  assert ptoks == jtoks == dense and len(ptoks) == 10
  assert eng._kv_pages_peak > 0
  pspec = port_decode.LMSpec(**TINY)
  by_rid = {r.rid: r for r in reqs}
  for rid, toks in list(ptoks.items())[:3]:
    _, ref = port_decode.reference_generate(pspec, state,
                                            by_rid[rid].prompt, 6)
    assert list(toks) == ref


def test_page_allocator_never_frees_twice_and_returns_every_page(tiny):
  _, state = tiny
  pspec = jax_decode.LMSpec(**TINY, kv_page_size=8)
  eng, ok = _run_port(dict(kv_page_size=8), state,
                      _workload(pspec, n=12))
  assert ok
  free = eng._free_pages
  assert len(free) == len(set(free)), "double-freed page"
  pool = eng._ring_state().k.shape[1]
  assert sorted(free) == list(range(1, pool))  # page 0: scratch
  assert not eng._table_np.any(), "stale page-table rows after drain"
  stats = eng.stats()
  assert stats["serving/kv_pages_in_use"] == eng._kv_pages_peak > 0
  assert 0 < stats["serving/kv_page_fraction"] <= 1


def test_pool_exhaustion_sheds_through_admission(tiny):
  """Eight max-length prompts at bucket 8: the pool (half the slab plus
  one sequence) cannot take them in one wave; the rest requeue (never an
  exception), every request completes, tokens as the dense engine's."""
  variables, state = tiny
  rng = np.random.default_rng(0)
  reqs = [jax_engine.Request(rid=i, prompt=rng.integers(
      0, TINY["vocab"], size=24, dtype=np.int32)) for i in range(8)]
  eng, paged = _run_port(dict(kv_page_size=8), state, reqs, ladder=(8,))
  _, dense = _run_port({}, state, reqs, ladder=(8,))
  _, jpaged = _run_jax(dict(kv_page_size=8), variables, reqs, ladder=(8,))
  assert paged == dense == jpaged and len(paged) == 8
  assert eng._kv_pages_peak <= eng._ring_state().k.shape[1] - 1
  free = eng._free_pages
  assert len(free) == len(set(free))


# -- speculative decoding ------------------------------------------------------

def test_verify_fn_equals_the_full_forward_argmax(tiny):
  _, state = tiny
  pspec = port_decode.LMSpec(**TINY)
  tokens = torch.from_numpy(np.random.RandomState(1).randint(
      0, TINY["vocab"], (2, TINY["max_len"])).astype(np.int32))
  module = port_decode.load_module(pspec, state, "cpu")
  preds = port_decode.verify_fn(pspec)(module, tokens)
  dense = port_decode.load_module(pspec, state, "cpu", fused_head=False)
  with torch.no_grad():
    logits, _ = dense(tokens)
  assert torch.equal(preds, torch.argmax(logits, -1).to(torch.int32))
  assert TINY["max_len"] % port_decode.verify_chunk(pspec) == 0
  assert port_decode.verify_chunk(pspec) == \
      jax_decode.verify_chunk(jax_decode.LMSpec(**TINY)) == 4


def test_truncate_variables_keeps_the_first_layers(tiny):
  variables, state = tiny
  jspec, pspec = _specs(**SPEC)
  draft = port_decode.draft_spec(pspec)
  assert draft.n_layers == 1 and draft.speculative_k == 0
  cut = port_decode.truncate_variables(pspec, state)
  assert not any(k.startswith("blocks.1.") for k in cut)
  for key, value in cut.items():
    assert value is state[key]
  jcut = jax_decode.truncate_variables(jspec, variables)
  want = convert.flax_to_state_dict(jax.device_get(jcut),
                                    port_decode.forward_module(draft))
  assert cut.keys() == want.keys()
  assert all(torch.equal(cut[k], want[k]) for k in cut)
  with pytest.raises(ValueError, match="float tree"):
    port_decode.truncate_variables(pspec, port_decode.prepare_variables(
        port_decode.LMSpec(**TINY, quantize="int8"), state))


def test_speculative_engine_equals_jax_and_plain_greedy(tiny):
  """Greedy speculative output is token-identical to plain greedy decode
  (per request, against the plain engine and the reference) and to the
  JAX speculative engine, with the same rounds and acceptances."""
  variables, state = tiny
  reqs = _workload(jax_decode.LMSpec(**TINY, **SPEC))
  jeng, jtoks = _run_jax(SPEC, variables, reqs)
  eng, ptoks = _run_port(SPEC, state, reqs)
  _, plain = _run_port({}, state, reqs)
  assert ptoks == jtoks == plain and len(ptoks) == 10
  assert eng._spec_rounds == jeng._spec_rounds > 0
  assert eng._accepted_tokens == jeng._accepted_tokens
  assert eng._draft_tokens == jeng._draft_tokens
  assert 0 <= eng._accepted_tokens <= eng._draft_tokens
  by_rid = {r.rid: r for r in reqs}
  pspec = port_decode.LMSpec(**TINY)
  for rid, toks in list(ptoks.items())[:3]:
    _, ref = port_decode.reference_generate(pspec, state,
                                            by_rid[rid].prompt, 6)
    assert list(toks) == ref
  stats = eng.stats()
  assert stats["serving/spec_rounds"] == eng._spec_rounds
  assert stats["serving/accept_len_p50"] is not None


def test_speculative_tokens_hold_for_any_draft(tiny):
  """A draft of other weights (another seed's truncation, passed as
  ``draft_variables``) changes what is accepted, never what is emitted:
  every token is the target's own greedy choice."""
  _, state = tiny
  pspec = port_decode.LMSpec(**TINY, **SPEC)
  other = port_decode.truncate_variables(
      pspec, port_decode.init_variables(port_decode.LMSpec(**TINY), seed=5))
  reqs = _workload(jax_decode.LMSpec(**TINY, **SPEC), n=6)
  cfg = port_engine.EngineConfig(spec=pspec, bucket_ladder=(1, 2, 4),
                                 max_new_tokens=6)
  eng = port_engine.ServingEngine(cfg, variables=state, device="cpu",
                                  draft_variables=other)
  for r in reqs:
    eng.submit(port_engine.Request(rid=r.rid, prompt=np.asarray(r.prompt),
                                   max_new_tokens=r.max_new_tokens))
  got = {r.rid: tuple(r.tokens) for r in eng.drain() if r.status == "ok"}
  _, plain = _run_port({}, state, reqs)
  assert got == plain and len(got) == 6
  assert all(torch.equal(eng.draft_variables[k], other[k]) for k in other)


def test_speculative_accepts_when_the_draft_agrees(tiny):
  """All-zero weights: every argmax ties to token 0 for draft and target
  alike, so nearly every proposal is accepted (more than 1.2 tokens a
  round), as in the JAX package."""
  _, state = tiny
  zeros = {k: torch.zeros_like(v) for k, v in state.items()}
  reqs = _workload(jax_decode.LMSpec(**TINY, **SPEC), n=6)
  eng, out = _run_port(SPEC, zeros, reqs)
  assert out
  emitted = sum(len(t) for t in out.values())
  assert eng._accepted_tokens > 0
  assert emitted / max(eng._spec_rounds, 1) > 1.2
  assert all(t == 0 for toks in out.values() for t in toks)


def test_speculative_oversized_prompt_sheds(tiny):
  _, state = tiny
  cfg = port_engine.EngineConfig(
      spec=port_decode.LMSpec(**TINY, **SPEC), bucket_ladder=(1, 2, 4),
      max_new_tokens=6)
  eng = port_engine.ServingEngine(cfg, variables=state, device="cpu")
  too_long = np.zeros((TINY["max_len"] - 6,), np.int32)
  assert not eng.submit(port_engine.Request(rid=0, prompt=too_long))
  results = eng.drain()
  assert [r.status for r in results] == ["rejected"]
  assert results[0].shed_reason == "prompt_too_long"


def test_speculative_programs_bounded_by_the_ladder(tiny):
  """Decode, prefill and verify are each one program a bucket: at most
  3 x len(ladder) in the compile ledger on a mixed replay."""
  _, state = tiny
  trace = port_tracing.activate(port_tracing.RunTrace())
  try:
    _run_port(SPEC, state, _workload(jax_decode.LMSpec(**TINY, **SPEC),
                                     n=12, rate=200.0))
    ledger = trace.compile_ledger()
  finally:
    port_tracing.deactivate()
  kinds = {e["program"] for e in ledger["entries"]}
  assert "serving_verify" in kinds
  assert ledger["shapes"] <= 3 * 3


# -- composed, stats, flags ----------------------------------------------------

def test_all_three_composed_equal_jax(tiny):
  variables, state = tiny
  reqs = _workload(jax_decode.LMSpec(**TINY, **ALL3), n=8)
  jeng, jtoks = _run_jax(ALL3, variables, reqs)
  eng, ptoks = _run_port(ALL3, state, reqs)
  _, quant = _run_port(dict(quantize="int8"), state, reqs)
  assert ptoks == jtoks == quant and len(ptoks) == 8
  assert eng._spec_rounds == jeng._spec_rounds
  assert eng._accepted_tokens == jeng._accepted_tokens
  assert isinstance(eng.target, port_decode.QuantizedLM)
  # The one-layer draft is quantized over its own layers: at this width its
  # (1, 32, 96) qkv stack is under MIN_QUANT_ELEMS, so it stays float, as
  # the JAX draft's does.
  assert port_q.has_quantized_leaves(eng.draft_variables) == \
      jax_q.has_quantized_leaves(jeng.draft_variables) == False  # noqa: E712


def test_stats_variant_keys_are_none_when_off(tiny):
  variables, state = tiny
  reqs = _workload(jax_decode.LMSpec(**TINY), n=3)
  eng, _ = _run_port({}, state, reqs)
  jeng, _ = _run_jax({}, variables, reqs)
  stats, jstats = eng.stats(), jeng.stats()
  keys = ("serving/kv_pages_in_use", "serving/kv_page_fraction",
          "serving/spec_rounds", "serving/draft_tokens",
          "serving/accepted_tokens", "serving/accept_len_p50",
          "serving/accept_len_p90", "serving/accept_len_p99")
  for key in keys:
    assert stats[key] is None and jstats[key] is None, key
  eng, _ = _run_port(ALL3, state, _workload(
      jax_decode.LMSpec(**TINY, **ALL3), n=3))
  assert all(eng.stats()[k] is not None for k in keys)


def test_cross_flag_refusals_match_jax_wording():
  base = dict(model="transformer_lm", device="cpu", num_devices=1)
  cases = [(dict(serving_speculative_k=4), "serving_draft_layers"),
           (dict(serving_draft_layers=2), "inert"),
           (dict(serving_kv_page_size=100), "divide")]
  for kw, needle in cases:
    with pytest.raises(validation.ParamError, match=needle) as err:
      validation.validate_cross_flags(port_params.make_params(**base, **kw))
    # The JAX package's message for the same flags.
    assert err.value.args[0].startswith(f"--{next(iter(kw))}=")
  with pytest.raises(validation.ParamError, match="below the served"):
    validation.validate_cross_flags(port_params.make_params(
        **base, serving_speculative_k=4, serving_draft_layers=6))
  validation.validate_cross_flags(port_params.make_params(
      **base, serving_quantize="int8", serving_kv_page_size=128,
      serving_speculative_k=4, serving_draft_layers=2))
  with pytest.raises(ValueError, match="must be one of"):
    port_params.make_params(serving_quantize="fp4")


@pytest.mark.parametrize("flag,item", [("serving_model_shards", "item 11"),
                                       ("mesh_shape", "item 8")])
def test_unported_serving_flags_name_their_item(flag, item):
  with pytest.raises(validation.ParamError, match=item):
    port_params.make_params(**{flag: 2})
