"""The port's serving path against the JAX package's, on the CPU in f32.

The JAX serving tests' tiny LM (tests/test_serving.py TINY: vocab 97, d 32,
2 layers, 4 heads, d_ff 64, ring 16, attention blocks of 8), built in both
frameworks from one flax init (``init_variables``, converted by the port's
weight bridge) and fed the same numpy tokens:

* the KV-cache decode: teacher-forced incremental logits of the port
  against the JAX full forward and the JAX incremental decode (rtol 1e-4,
  atol 1e-5, the JAX package's own fast-mode tolerance), for the scan and
  loop layer layouts and both attention impls; the port's exact mode
  against the port's full forward;
* the packed prefill (first tokens and K/V spans) against the JAX
  ``prefill_fn`` (1e-5), and its install against the incremental build;
* ``pack_prompts`` and ``poisson_workload``: equal to the JAX outputs;
* the engine end to end on a fake clock, continuous and static: greedy
  tokens equal the port's ``reference_generate`` and the JAX engine's, and
  every decode step's logits agree with the JAX full forward's at the same
  positions; the bounded program set; admission (queue depth, TTFT expiry,
  tenant budget, prompt length); ``stats()`` with the JAX engine's keys;
* the port's tracing / metrics copies against the JAX modules', and the
  serving bench at its CPU size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import metrics as jax_metrics
from kf_benchmarks_tpu import tracing as jax_tracing
from kf_benchmarks_tpu.data import packing as jax_packing
from kf_benchmarks_tpu.serving import decode as jax_decode
from kf_benchmarks_tpu.serving import engine as jax_engine
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import metrics as port_metrics
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import tracing as port_tracing
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.data import packing as port_packing
from kf_benchmarks_tpu_torch.ops import flash_attention as fa
from kf_benchmarks_tpu_torch.serving import bench as port_bench
from kf_benchmarks_tpu_torch.serving import decode as port_decode
from kf_benchmarks_tpu_torch.serving import engine as port_engine

torch.set_num_threads(2)

TINY = dict(vocab=97, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_len=16, attn_block=8)
# The JAX package's fast-mode decode tolerance (test_serving.py:119-120).
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5


def _specs(**kw):
  return (jax_decode.LMSpec(**{**TINY, **kw}),
          port_decode.LMSpec(**{**TINY, **kw}))


def _variables(jspec, pspec, seed=0):
  """(flax variables, the port's state_dict of the same weights)."""
  variables = jax.device_get(jax_decode.init_variables(jspec, seed=seed))
  state = convert.flax_to_state_dict(variables,
                                     port_decode.forward_module(pspec))
  return variables, state


@pytest.fixture(scope="module")
def tiny():
  jspec, pspec = _specs()
  variables, state = _variables(jspec, pspec)
  tokens = np.random.default_rng(7).integers(
      0, TINY["vocab"], (2, TINY["max_len"])).astype(np.int32)
  return jspec, pspec, variables, state, tokens


def _jax_full_logits(spec, variables, tokens):
  module = jax_decode.forward_module(spec, fused_head=False)
  logits, _ = jax.jit(module.apply)(variables, jnp.asarray(tokens))
  return np.asarray(logits)


def _jax_decode_all(spec, variables, tokens):
  module = jax_decode.decode_module(spec)
  step = jax.jit(module.apply)
  b, t = tokens.shape
  cache = jax_decode.init_cache(spec, b)
  ck, cv = cache.k, cache.v
  rows = []
  for p in range(t):
    logits, (ck, cv) = step(variables, jnp.asarray(tokens[:, p]), ck, cv,
                            jnp.full((b,), p, jnp.int32))
    rows.append(np.asarray(logits[:, 0]))
  return np.stack(rows, axis=1)


def _port_decode_all(spec, state, tokens):
  """Teacher-forced incremental decode through TransformerLM.decode: the
  (B, T, V) stack of per-token logits."""
  module = port_decode.load_module(spec, state, "cpu")
  b, t = tokens.shape
  cache = port_decode.init_cache(spec, b, "cpu")
  rows = []
  with torch.no_grad():
    for p in range(t):
      logits, _ = module.decode(torch.from_numpy(tokens[:, p]), cache.k,
                                cache.v, torch.full((b,), p,
                                                    dtype=torch.int32))
      rows.append(logits[:, 0].numpy())
  return np.stack(rows, axis=1)


def _port_full_logits(spec, state, tokens):
  module = port_decode.load_module(spec, state, "cpu", fused_head=False)
  with torch.no_grad():
    logits, _ = module(torch.from_numpy(tokens))
  return logits.numpy()


# -- the KV-cache decode -------------------------------------------------------

@pytest.mark.parametrize("scan", [True, False], ids=["scan", "loop"])
@pytest.mark.parametrize("impl", ["tiled", "flash"])
def test_incremental_decode_matches_jax(impl, scan):
  jspec, pspec = _specs(attn_impl=impl, scan_layers=scan)
  variables, state = _variables(jspec, pspec, seed=0 if scan else 1)
  tokens = np.random.default_rng(3).integers(
      0, TINY["vocab"], (2, TINY["max_len"])).astype(np.int32)
  got = _port_decode_all(pspec, state, tokens)
  np.testing.assert_allclose(got, _jax_full_logits(jspec, variables, tokens),
                             rtol=DECODE_RTOL, atol=DECODE_ATOL)
  np.testing.assert_allclose(got, _jax_decode_all(jspec, variables, tokens),
                             rtol=DECODE_RTOL, atol=DECODE_ATOL)


@pytest.mark.parametrize("impl", ["tiled", "flash"])
def test_exact_decode_matches_the_port_full_forward(tiny, impl):
  """The KV-cache oracle, torch against torch: exact-mode decode at each
  prefix length against the port's full forward. Not bitwise in torch: the
  decode step's denses run (B, 1, d) products where the forward runs
  (B, T, d) ones, which torch's CPU GEMMs sum in another order (the JAX
  package's bitwise contract rests on XLA running one op graph). Measured
  gap at these shapes: 1.2e-6 absolute on logits of magnitude ~2; held to
  1e-5 relative + 2e-6 absolute."""
  _, pspec, _, state, tokens = tiny
  pspec = port_decode.LMSpec(**{**TINY, "attn_impl": impl,
                                "decode_exact": True})
  np.testing.assert_allclose(_port_decode_all(pspec, state, tokens),
                             _port_full_logits(pspec, state, tokens),
                             rtol=1e-5, atol=2e-6)


def test_stale_ring_contents_are_invisible(tiny):
  """NaN in every ring slot past pos leaves the decode logits bit-identical
  (the masked slots contribute exactly zero)."""
  _, pspec, _, state, tokens = tiny
  module = port_decode.load_module(pspec, state, "cpu")
  b = tokens.shape[0]
  cache = port_decode.init_cache(pspec, b, "cpu")
  with torch.no_grad():
    for p in range(4):
      pos = torch.full((b,), p, dtype=torch.int32)
      tok = torch.from_numpy(tokens[:, p])
      dirty_k, dirty_v = cache.k.clone(), cache.v.clone()
      dirty_k[:, :, p + 1:] = float("nan")
      dirty_v[:, :, p + 1:] = float("nan")
      dirty, _ = module.decode(tok, dirty_k, dirty_v, pos)
      clean, _ = module.decode(tok, cache.k, cache.v, pos)
      assert torch.equal(clean, dirty)


def test_ring_write_is_an_indexed_copy(tiny):
  """The decode step writes exactly one ring row per slot and layer, at
  pos % T, and leaves every other row as it was."""
  _, pspec, _, state, _ = tiny
  module = port_decode.load_module(pspec, state, "cpu")
  cache = port_decode.init_cache(pspec, 2, "cpu")
  cache.k.normal_()
  before = cache.k.clone()
  pos = torch.tensor([3, 16 + 5], dtype=torch.int32)
  with torch.no_grad():
    module.decode(torch.tensor([1, 2], dtype=torch.int32), cache.k, cache.v,
                  pos)
  changed = (cache.k != before).any(-1).any(-1)         # (L, B, T)
  want = torch.zeros_like(changed)
  want[:, 0, 3] = True
  want[:, 1, 5] = True
  assert torch.equal(changed, want)


# -- packed prefill ------------------------------------------------------------

PROMPTS = [np.array([3, 1, 4, 1, 5], np.int32),
           np.array([9, 2, 6, 5, 3, 5, 8, 9, 7], np.int32),
           np.array([2, 7, 1], np.int32)]


def _prefill_args(bucket=4):
  images, placements = port_packing.pack_prompts(PROMPTS, TINY["max_len"],
                                                 bucket)
  rows = np.zeros((bucket,), np.int32)
  offsets = np.zeros((bucket,), np.int32)
  last_pos = np.zeros((bucket,), np.int32)
  lengths = np.zeros((bucket,), np.int32)
  slots = np.full((bucket,), bucket, np.int32)
  for i, (prm, (row, off)) in enumerate(zip(PROMPTS, placements)):
    rows[i], offsets[i] = row, off
    lengths[i] = prm.size
    last_pos[i] = off + prm.size - 1
    slots[i] = i
  return images, rows, last_pos, offsets, lengths, slots


@pytest.mark.parametrize("impl", ["tiled", "flash"])
def test_prefill_matches_jax(tiny, impl):
  jspec, pspec = _specs(attn_impl=impl)
  _, _, variables, state, _ = tiny
  images, rows, last_pos, offsets, lengths, slots = _prefill_args()
  jfirst, jek, jev = jax.jit(jax_decode.prefill_fn(jspec))(
      variables, *(jnp.asarray(a) for a in (images, rows, last_pos,
                                             offsets)))
  module = port_decode.load_module(pspec, state, "cpu")
  first, ek, ev = port_decode.prefill_fn(pspec)(
      module, *(torch.from_numpy(a) for a in (images, rows, last_pos,
                                               offsets)))
  np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
  assert ek.shape == jek.shape == (4, 2, 16, 4, 8)
  np.testing.assert_allclose(ek.numpy(), np.asarray(jek), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=1e-5,
                             atol=1e-5)
  # The install: slots 0..2 take the three spans, the pad entry drops.
  cache = port_decode.install_prefill(
      port_decode.init_cache(pspec, 4, "cpu"), ek, ev, first,
      torch.from_numpy(lengths), torch.from_numpy(slots))
  jcache = jax_decode.install_prefill(
      jax_decode.init_cache(jspec, 4), jek, jev, jfirst,
      jnp.asarray(lengths), jnp.asarray(slots))
  np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
  np.testing.assert_array_equal(cache.tok.numpy(), np.asarray(jcache.tok))
  np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                             rtol=1e-5, atol=1e-5)


def test_prefill_install_matches_incremental_build(tiny):
  """The installed caches, positions and first tokens equal what stepping
  the decode program over each prompt builds (to float rounding: the
  packed forward and the one-row decode sum in other orders)."""
  _, pspec, _, state, _ = tiny
  images, rows, last_pos, offsets, lengths, slots = _prefill_args()
  module = port_decode.load_module(pspec, state, "cpu")
  first, ek, ev = port_decode.prefill_fn(pspec)(
      module, *(torch.from_numpy(a) for a in (images, rows, last_pos,
                                               offsets)))
  cache = port_decode.install_prefill(
      port_decode.init_cache(pspec, 4, "cpu"), ek, ev, first,
      torch.from_numpy(lengths), torch.from_numpy(slots))
  step = port_decode.decode_fn(pspec)
  for i, prm in enumerate(PROMPTS):
    c1 = port_decode.init_cache(pspec, 2, "cpu")
    k1, v1, p1 = c1.k, c1.v, c1.pos
    for t in prm:
      nxt, k1, v1, p1 = step(module, k1, v1, p1,
                             torch.tensor([int(t), 0], dtype=torch.int32),
                             torch.tensor([True, False]))
    n = prm.size
    assert int(cache.pos[i]) == n == int(p1[0])
    assert int(cache.tok[i]) == int(first[i]) == int(nxt[0])
    torch.testing.assert_close(cache.k[:, i, :n], k1[:, 0, :n], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(cache.v[:, i, :n], v1[:, 0, :n], rtol=1e-5,
                               atol=1e-6)


def test_pack_prompts_and_workload_equal_jax():
  for prompts, seq_len, bucket in (
      (PROMPTS, 16, 2), ([np.ones(16, np.int32)] * 3, 16, 2),
      ([np.arange(1, n + 1, dtype=np.int32) for n in (7, 3, 9, 1, 16, 4)],
       16, 4)):
    images, placements = port_packing.pack_prompts(prompts, seq_len, bucket)
    jimages, jplacements = jax_packing.pack_prompts(prompts, seq_len, bucket)
    np.testing.assert_array_equal(images, jimages)
    assert placements == jplacements
  with pytest.raises(ValueError, match="never split"):
    port_packing.pack_prompts([np.ones(17, np.int32)], 16, 1)
  rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
  np.testing.assert_array_equal(
      port_packing.sample_document_lengths(rng, 50, 2048, 0.2),
      jax_packing.sample_document_lengths(jrng, 50, 2048, 0.2))
  jspec, pspec = _specs()
  for seed, tenants in ((0, ("default",)), (4, ("a", "b", "c"))):
    got = port_engine.poisson_workload(12, 50.0, pspec, seed=seed,
                                       max_new_tokens=3, tenants=tenants)
    want = jax_engine.poisson_workload(12, 50.0, jspec, seed=seed,
                                       max_new_tokens=3, tenants=tenants)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
      np.testing.assert_array_equal(a.prompt, b.prompt)
      assert (a.rid, a.tenant, a.max_new_tokens) == (b.rid, b.tenant,
                                                     b.max_new_tokens)


# -- the engine ----------------------------------------------------------------

class FakeClock:
  """A clock that advances 1 ms at every read."""

  def __init__(self):
    self.t = 0.0

  def __call__(self):
    self.t += 1e-3
    return self.t

  def sleep(self, s):
    self.t += s


def _port_engine(state=None, ladder=(1, 2, 4), batching="continuous",
                 spec=None, clock=None, **cfg_kw):
  spec = spec or port_decode.LMSpec(**TINY)
  clock = clock or FakeClock()
  cfg = port_engine.EngineConfig(spec=spec, bucket_ladder=ladder,
                                 batching=batching, max_new_tokens=3,
                                 **cfg_kw)
  return port_engine.ServingEngine(cfg, variables=state, seed=0,
                                   time_fn=clock,
                                   sleep_fn=getattr(clock, "sleep", None),
                                   device="cpu")


def _prompts(n, rng=None, lo=2, hi=10):
  rng = rng or np.random.default_rng(0)
  return [rng.integers(0, 97, size=int(rng.integers(lo, hi)),
                       dtype=np.int32) for _ in range(n)]


@pytest.mark.parametrize("batching", ["continuous", "static"])
def test_engine_matches_reference_and_jax(tiny, batching):
  """Greedy tokens equal the port's engine-free reference and the JAX
  engine's on the same weights; every decode step's logits (recorded per
  active slot) agree with the JAX full forward's row at that slot's
  position, to 1e-5."""
  jspec, pspec, variables, state, _ = tiny
  eng = _port_engine(state, batching=batching)
  eng.warm()  # the preparing runs on dummy inputs are not recorded
  seen = []
  decode = eng.module.decode

  def recording(tokens, cache_k, cache_v, pos):
    logits, caches = decode(tokens, cache_k, cache_v, pos)
    rids = [s["req"].rid if s is not None else None for s in eng._slots]
    seen.append((rids, pos.clone(), logits[:, 0].clone()))
    return logits, caches

  eng.module.decode = recording
  prompts = _prompts(5)
  for i, prm in enumerate(prompts):
    assert eng.submit(port_engine.Request(rid=i, prompt=prm))
  results = eng.drain()
  jeng = jax_engine.ServingEngine(
      jax_engine.EngineConfig(spec=jspec, bucket_ladder=(1, 2, 4),
                              batching=batching, max_new_tokens=3),
      variables=variables)
  for i, prm in enumerate(prompts):
    assert jeng.submit(jax_engine.Request(rid=i, prompt=prm))
  jresults = jeng.drain()
  assert [r.status for r in results] == ["ok"] * 5
  seqs = {}
  for r, jr, prm in zip(results, jresults, prompts):
    _, ref = port_decode.reference_generate(pspec, state, prm, 3)
    assert r.tokens == ref == jr.tokens, f"rid {r.rid}"
    assert r.ttft_s is not None and r.total_s >= r.ttft_s >= 0
    seqs[r.rid] = np.concatenate([prm, np.asarray(r.tokens, np.int32)])
  batch = np.zeros((len(prompts), TINY["max_len"]), np.int32)
  for rid, seq in seqs.items():
    batch[rid, :seq.size] = seq
  full = _jax_full_logits(jspec, variables, batch)
  checked = 0
  for rids, pos, logits in seen:
    for i, rid in enumerate(rids):
      if rid is None:
        continue
      np.testing.assert_allclose(logits[i].numpy(),
                                 full[rid, int(pos[i])], rtol=1e-5,
                                 atol=1e-5)
      checked += 1
  assert checked == 5 * 2  # two decode steps after each first token


def test_engine_bounded_programs_on_mixed_length_replay(tiny):
  """A replay of mixed-length waves (bucket growth included) prepares at
  most len(ladder) decode and prefill callables, each noted once in the
  compile ledger."""
  trace = port_tracing.activate(port_tracing.RunTrace(keep_spans=True))
  try:
    eng = _port_engine(tiny[3], ladder=(1, 2, 4))
    rng = np.random.default_rng(1)
    rid = 0
    for wave in (1, 3, 4, 2):
      for prm in _prompts(wave, rng):
        assert eng.submit(port_engine.Request(rid=rid, prompt=prm))
        rid += 1
      results = eng.drain()
    assert all(r.status == "ok" for r in results)
    entries = trace.compile_ledger()["entries"]
    by_program = {}
    for e in entries:
      by_program.setdefault(e["program"], set()).add(e["key"])
    assert 1 <= len(by_program["serving_decode"]) <= 3
    assert 1 <= len(by_program["serving_prefill"]) <= 3
    assert len(entries) == sum(len(v) for v in by_program.values())
    assert len(eng._decode_exes) <= 3 and len(eng._prefill_exes) <= 3
    names = {(s["sub"], s["name"]) for s in trace.spans}
    assert {("serving", "prefill"), ("serving", "decode_step"),
            ("serving", "request"), ("compile", "serving_decode")} <= names
    assert trace.percentiles()["serving/ttft"]["n"] == rid
  finally:
    port_tracing.deactivate()


def test_engine_warm_and_bucket_growth(tiny):
  eng = _port_engine(tiny[3], ladder=(1, 2, 4))
  assert port_engine.bucket_for(3, (1, 2, 4)) == 4
  assert port_engine.bucket_for(9, (1, 2, 4)) == 4  # capped at the top
  assert eng.submit(port_engine.Request(rid=0, prompt=_prompts(1)[0]))
  eng.drain()
  assert eng._bucket == 1
  for i, prm in enumerate(_prompts(3), start=1):
    eng.submit(port_engine.Request(rid=i, prompt=prm))
  eng.drain()
  assert eng._bucket == 4
  eng._maybe_shrink()
  assert eng._bucket == 0 and eng._cache is None  # idle: the cache goes
  fresh = _port_engine(tiny[3], ladder=(1, 2))
  assert fresh.warm() == 4          # 2 buckets x (decode + prefill)
  assert fresh.warm() == 0


def test_static_drains_before_admitting(tiny):
  observed = {}
  for batching in ("static", "continuous"):
    eng = _port_engine(tiny[3], ladder=(2,), batching=batching)
    orig = eng._prefill_wave
    observed[batching] = []

    def wrapped(wave, eng=eng, orig=orig, name=batching):
      observed[name].append(eng._active_count())
      return orig(wave)

    eng._prefill_wave = wrapped
    prompts = _prompts(3)
    for rid, (prm, n) in enumerate(zip(prompts, (1, 6, 2))):
      eng.submit(port_engine.Request(rid=rid, prompt=prm, max_new_tokens=n))
    assert all(r.status == "ok" for r in eng.drain())
  assert all(a == 0 for a in observed["static"])
  assert any(a > 0 for a in observed["continuous"])


def test_shrink_keeps_live_slots(tiny):
  """Occupancy falling to a lower bucket compacts the live slots to the
  front (pad rows duplicate slot 0, inactive); their tokens are unchanged."""
  _, pspec, _, state, _ = tiny
  eng = _port_engine(state, ladder=(1, 2, 4))
  prompts = _prompts(4, np.random.default_rng(2))
  budgets = (1, 1, 1, 6)
  for rid, (prm, n) in enumerate(zip(prompts, budgets)):
    eng.submit(port_engine.Request(rid=rid, prompt=prm, max_new_tokens=n))
  buckets = []
  tick = eng._tick

  def spy():
    tick()
    buckets.append(eng._bucket)

  eng._tick = spy
  results = eng.drain()
  assert 4 in buckets and 1 in buckets
  for r, prm, n in zip(results, prompts, budgets):
    assert r.tokens == port_decode.reference_generate(pspec, state, prm,
                                                      n)[1]


# -- admission control ---------------------------------------------------------

def test_queue_depth_rejection(tiny):
  eng = _port_engine(tiny[3], max_queue_depth=2)
  oks = [eng.submit(port_engine.Request(rid=i, prompt=p))
         for i, p in enumerate(_prompts(4))]
  assert oks == [True, True, False, False]
  by_rid = {r.rid: r for r in eng.drain()}
  assert (by_rid[2].status, by_rid[2].shed_reason) == ("rejected",
                                                       "queue_depth")
  assert by_rid[0].status == "ok"
  stats = eng.stats()
  assert stats["serving/shed"] == 2
  assert stats["serving/shed_fraction"] == pytest.approx(0.5)


def test_ttft_deadline_expiry(tiny):
  now = [0.0]
  eng = port_engine.ServingEngine(
      port_engine.EngineConfig(spec=port_decode.LMSpec(**TINY),
                               bucket_ladder=(2,), max_new_tokens=2,
                               ttft_slo_s=0.5),
      variables=tiny[3], time_fn=lambda: now[0], sleep_fn=lambda s: None,
      device="cpu")
  eng.submit(port_engine.Request(rid=0, prompt=_prompts(1)[0]))
  eng.submit(port_engine.Request(rid=1, prompt=_prompts(1)[0],
                                 deadline_s=10.0))
  now[0] = 1.0  # past the 0.5 s default, inside rid 1's own deadline
  by_rid = {r.rid: r for r in eng.drain()}
  assert (by_rid[0].status, by_rid[0].shed_reason) == ("expired",
                                                       "ttft_deadline")
  assert by_rid[1].status == "ok"
  assert eng.slo.burn("ttft_deadline", "default", t=1.0)["fast"] == \
      pytest.approx(0.5 / 0.01)


def test_tenant_token_budget(tiny):
  eng = _port_engine(tiny[3], tenant_tokens_per_s=10.0, tenant_burst_s=1.0,
                     clock=lambda: 0.0)
  # 8 prompt + 3 generated = 11 tokens > the 10-token burst.
  assert not eng.submit(port_engine.Request(
      rid=0, prompt=np.ones(8, np.int32), tenant="a"))
  small = np.ones(4, np.int32)  # 7 tokens
  assert eng.submit(port_engine.Request(rid=1, prompt=small, tenant="a"))
  assert not eng.submit(port_engine.Request(rid=2, prompt=small, tenant="a"))
  assert eng.submit(port_engine.Request(rid=3, prompt=small, tenant="b"))
  statuses = {r.rid: r.status for r in eng.drain()}
  assert statuses == {0: "rejected", 1: "ok", 2: "rejected", 3: "ok"}
  assert eng.tenant_stats()["a"]["serving/shed"] == {"tenant_budget": 2}


def test_prompt_length_sheds(tiny):
  eng = _port_engine(tiny[3])
  assert not eng.submit(port_engine.Request(
      rid=0, prompt=np.ones(TINY["max_len"] + 1, np.int32)))
  assert not eng.submit(port_engine.Request(
      rid=1, prompt=np.zeros((0,), np.int32)))
  r0, r1 = eng.drain()
  assert (r0.status, r0.shed_reason) == ("rejected", "prompt_too_long")
  assert (r1.status, r1.shed_reason) == ("rejected", "empty_prompt")


def test_stats_keys_and_metrics_match_jax(tiny):
  """The same requests through both engines (two tenants, a queue bound
  that sheds half): stats(), the per-tenant blocks, the registry's series
  and healthz have the same keys, and the counts agree."""
  jspec, _, variables, state, _ = tiny
  prompts = _prompts(6, np.random.default_rng(4))
  out = {}
  for name, mod, mlib, make in (
      ("jax", jax_engine, jax_metrics,
       lambda: jax_engine.ServingEngine(
           jax_engine.EngineConfig(spec=jspec, bucket_ladder=(1, 2, 4),
                                   max_new_tokens=3, max_queue_depth=3),
           variables=variables)),
      ("port", port_engine, port_metrics,
       lambda: _port_engine(state, max_queue_depth=3))):
    registry = mlib.activate(mlib.MetricRegistry())
    try:
      eng = make()
      for i, prm in enumerate(prompts):
        eng.submit(mod.Request(rid=i, prompt=prm, tenant="ab"[i % 2]))
      eng.drain()
      stats = eng.stats()
      snap = registry.snapshot()
    finally:
      mlib.deactivate()
    out[name] = (stats, snap, eng.healthz())
  (stats, snap, health), (jstats, jsnap, jhealth) = out["port"], out["jax"]
  assert set(stats) == set(jstats)
  assert {t: set(b) for t, b in stats["serving_tenants"].items()} == \
      {t: set(b) for t, b in jstats["serving_tenants"].items()}
  assert set(snap) == set(jsnap)
  assert set(health) == set(jhealth)
  assert set(health["serving"]) == set(jhealth["serving"])
  for key in ("serving/requests", "serving/completed", "serving/shed",
              "serving/decode_steps", "serving/batch_fill_fraction"):
    assert stats[key] == jstats[key], key
  for key in snap:
    if "/count" in key or key.split("{")[0] in (
        "serving/requests", "serving/completed", "serving/shed",
        "serving/decode_steps"):
      assert snap[key] == jsnap[key], key


def test_tracing_and_metrics_copies_match_jax():
  rng = np.random.default_rng(0)
  for n in (1, 2, 7, 100):
    values = list(rng.exponential(size=n))
    for q in (0, 50, 90, 99, 100):
      assert port_tracing.percentile(values, q) == \
          jax_tracing.percentile(values, q)
  assert port_tracing.percentile([], 50) is None
  for key, spec in port_metrics.SCHEMA.items():
    jspec = jax_metrics.SCHEMA[key]
    assert (spec.kind, spec.unit, spec.labels, spec.higher_is_better) == \
        (jspec.kind, jspec.unit, jspec.labels, jspec.higher_is_better), key
  assert {k for k in jax_metrics.SCHEMA if k.startswith("serving/")} == \
      set(port_metrics.SCHEMA)
  key = port_metrics.labeled_key("serving/shed",
                                 {"tenant": 'a"b', "shed_reason": "x"})
  assert key == jax_metrics.labeled_key(
      "serving/shed", {"tenant": 'a"b', "shed_reason": "x"})
  assert port_metrics.parse_labeled_key(key) == \
      jax_metrics.parse_labeled_key(key)
  registry = port_metrics.MetricRegistry()
  with pytest.raises(ValueError, match="unregistered metric key"):
    registry.set("images_per_sec", 1.0)
  with pytest.raises(ValueError, match="unregistered label name"):
    registry.inc("serving/requests", labels={"bucket": "4"})
  # The burn-rate monitor: the same event stream, the same alerts.
  monitors = [mod.SLOMonitor(fast_window_s=2.0, slow_window_s=6.0,
                             time_fn=lambda: 0.0)
              for mod in (port_metrics, jax_metrics)]
  for t in range(12):
    for mon in monitors:
      mon.observe("ttft_deadline", "a", good=t % 3 == 0 or t > 8,
                  t=float(t))
  assert monitors[0].alerts == monitors[1].alerts
  assert len(monitors[0].alerts) == 2  # one firing, one resolved
  assert monitors[0].state(t=11.0) == monitors[1].state(t=11.0)


# -- the bench -----------------------------------------------------------------

def test_serving_bench_on_cpu(monkeypatch):
  """The port's bench.py --serving at its CPU size (a short replay: 8
  requests at a high rate), one JSON record with the JAX line's keys."""
  monkeypatch.setenv("KF_TRANSFORMER_LM_ATTN", "flash")
  params = port_bench.parse_params(
      ["--device=cpu", "--serving_requests=8", "--serving_rate=400",
       "--serving_max_new_tokens=2", "--serving_bucket_ladder=1,4,8"])
  record = port_bench.run(params)
  for key in ("metric", "value", "unit", "retries", "compile_ledger",
              "decode_variant", "serving/tokens_per_sec", "serving/ttft_p99",
              "serving/completed", "serving_tenants", "git_rev", "platform"):
    assert key in record, key
  assert record["platform"] == "cpu"
  assert record["serving/completed"] == 8 and record["serving/shed"] == 0
  assert record["compile_ledger"]["shapes"] == 6  # 3 buckets x 2 programs
  assert record["value"] > 0


def test_serving_bench_refuses_without_a_card():
  """No CPU fallback: the default --device=gpu raises with no card, and
  flash attention in f32 on the card is refused (no f32 kernel)."""
  with pytest.raises(validation.ParamError, match="no CUDA device"):
    port_bench.run(port_bench.parse_params([]))
  assert port_bench.main([]) == 1
  with pytest.raises(validation.ParamError, match="serving_bucket_ladder"):
    port_bench.run(port_bench.parse_params(
        ["--device=cpu", "--serving_bucket_ladder=4,2"]))
  with pytest.raises(validation.ParamError, match="serving_batching"):
    port_bench.run(port_bench.parse_params(
        ["--device=cpu", "--serving_batching=eager"]))
  assert validation.parse_bucket_ladder(" 1, 4,16 ") == (1, 4, 16)
  for bad in ("", "0,2", "2,2", "a"):
    with pytest.raises(validation.ParamError):
      validation.parse_bucket_ladder(bad)
  params = port_params.make_params(model="transformer_lm", device="cpu")
  assert params.serving_requests is None and params.serving_rate is None


def test_flash_in_f32_on_the_card_is_refused(monkeypatch):
  monkeypatch.setenv("KF_TRANSFORMER_LM_ATTN", "flash")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  params = port_params.make_params(model="transformer_lm", device="gpu")
  with pytest.raises(validation.ParamError, match="flash_decode.cu"):
    validation.validate_cross_flags(params)


def test_launch_counts_name_the_decode_kernels():
  assert "flash_decode" in fa.LAUNCHES


# -- the fixed-shape prefill gathers and install scatters ----------------------
#
# The loop versions below are the port's _spans and install_prefill before
# they became fixed-shape device programs (host lists, torch.nonzero), kept
# here as the reference the rewrite must equal.

def _loop_spans(kv, rows, offsets, t_cache):
  l_, _, t, h, dh = kv.shape
  out = kv.new_empty((len(rows), l_, t_cache, h, dh))
  for i, (row, off) in enumerate(zip(rows, offsets)):
    n = min(t - off, t_cache)
    out[i, :, :n] = kv[:, row].narrow(1, off, n)
    out[i, :, n:] = 0
  return out


def _loop_install(cache, ek, ev, first, lengths, slots):
  keep = torch.nonzero(slots < cache.k.shape[1]).flatten()
  dst = slots[keep].long()
  cache.k[:, dst] = ek[keep].transpose(0, 1).to(cache.k.dtype)
  cache.v[:, dst] = ev[keep].transpose(0, 1).to(cache.v.dtype)
  cache.pos[dst] = lengths[keep].to(torch.int32)
  cache.tok[dst] = first[keep]
  return cache


def _padded_wave(bucket=8):
  """_prefill_args at a pack bucket of 8: three requests, then padding
  entries whose rows and offsets are arbitrary (one span runs off the
  packed row's end) and whose slots are out of range."""
  images, rows, last_pos, offsets, lengths, slots = _prefill_args(bucket)
  rng = np.random.default_rng(3)
  n = len(PROMPTS)
  rows[n:] = rng.integers(0, bucket, bucket - n)
  offsets[n:] = rng.integers(0, TINY["max_len"], bucket - n)
  last_pos[n:] = offsets[n:]
  slots[n:] = 4 + rng.integers(0, 5, bucket - n)  # >= the cache's 4 rows
  return images, rows, last_pos, offsets, lengths, slots


def test_fixed_shape_spans_equal_the_loop_and_jax(tiny):
  jspec, pspec, variables, state, _ = tiny
  images, rows, last_pos, offsets, lengths, slots = _padded_wave()
  module = port_decode.load_module(pspec, state, "cpu")
  with torch.no_grad():
    _, _, (kst, vst) = module(torch.from_numpy(images), return_kv=True)
  for kv in (kst, vst):
    got = port_decode._spans(kv, torch.from_numpy(rows),
                             torch.from_numpy(offsets), pspec.max_len)
    want = _loop_spans(kv, rows.tolist(), offsets.tolist(), pspec.max_len)
    assert torch.equal(got, want)
  assert (offsets > 0).any()  # a span that runs off its row's end
  jfirst, jek, jev = jax.jit(jax_decode.prefill_fn(jspec))(
      variables, *(jnp.asarray(a) for a in (images, rows, last_pos,
                                             offsets)))
  first, ek, ev = port_decode.prefill_fn(pspec)(
      module, *(torch.from_numpy(a) for a in (images, rows, last_pos,
                                               offsets)))
  np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
  for got, ref in ((ek, jek), (ev, jev)):
    assert got.shape == ref.shape == (8, 2, 16, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_fixed_shape_install_drops_padding_as_jax_does(tiny):
  jspec, pspec, _, _, _ = tiny
  _, _, _, _, lengths, slots = _padded_wave()
  rng = np.random.default_rng(4)
  shape = (8, 2, 16, 4, 8)
  ek, ev = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
  first = rng.integers(0, TINY["vocab"], 8).astype(np.int32)
  args = [torch.from_numpy(a) for a in (ek, ev, first, lengths, slots)]

  def filled():
    cache = port_decode.init_cache(pspec, 4, "cpu")
    for t in cache:
      t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    return cache

  got = port_decode.install_prefill(filled(), *args)
  want = _loop_install(filled(), *args)
  for a, b in zip(got, want):
    assert torch.equal(a, b)
  init = filled()
  jcache = jax_decode.install_prefill(
      jax_decode.CacheState(*(jnp.asarray(t.numpy()) for t in init)),
      *(jnp.asarray(a) for a in (ek, ev, first, lengths, slots)))
  for a, b in zip(got, jcache):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  # The fourth row had no request: untouched.
  assert torch.equal(got.k[:, 3], init.k[:, 3])


def test_decode_step_updates_its_buffers_in_place(tiny):
  """decode_fn writes the sampled tokens and advanced positions into the
  bucket's own tok and pos (a captured graph's static buffers) and returns
  them; inactive slots keep theirs."""
  _, pspec, _, state, _ = tiny
  module = port_decode.load_module(pspec, state, "cpu")
  cache = port_decode.init_cache(pspec, 2, "cpu")
  cache.tok.copy_(torch.tensor([5, 9], dtype=torch.int32))
  cache.pos.copy_(torch.tensor([3, 7], dtype=torch.int32))
  active = torch.tensor([True, False])
  with torch.no_grad():
    logits, _ = module.decode(cache.tok.clone(), cache.k.clone(),
                              cache.v.clone(), cache.pos.clone())
  tok, k, v, pos = port_decode.decode_fn(pspec)(
      module, cache.k, cache.v, cache.pos, cache.tok, active)
  assert tok is cache.tok and pos is cache.pos and k is cache.k
  assert int(tok[0]) == int(logits[0, 0].argmax()) and int(tok[1]) == 9
  assert pos.tolist() == [4, 7]


def test_engine_shares_one_ring_with_a_spare_row(tiny):
  """The prepared programs work on one static ring of the top bucket plus a
  spare row: every bucket's cache is a view of its first rows, and a
  wave's padding lands in the spare row only."""
  eng = _port_engine(tiny[3], ladder=(1, 2, 4))
  for i, prm in enumerate(_prompts(3)):
    eng.submit(port_engine.Request(rid=i, prompt=prm))
  eng.drain()
  ring = eng._ring
  assert ring.k.shape[1] == 5 and eng._prefill_bufs
  for bucket, bufs in eng._prefill_bufs.items():
    assert bufs["slots"].shape == (bucket,)
  view = eng._bucket_view(2)
  assert view.k.data_ptr() == ring.k.data_ptr() and view.k.shape[1] == 2
  assert eng._graphs is False  # the CPU runs the programs eagerly


# -- one request's bf16 row against the batch width ----------------------------

# The LM's width (d 512, 8 heads, d_ff 2048) with two layers and a 4096-token
# vocabulary, in bf16: the shape at which the batch width reaches the
# rounding of the JAX package's decode on the CPU.
WIDE = dict(vocab=4096, d_model=512, n_layers=2, n_heads=8, d_ff=2048,
            max_len=16, attn_block=8)
BUCKETS = (16, 64, 256)
NEW_TOKENS = 6


def _one_request(step_fn, b, prompt, fill):
  """Slot 0 teacher-forced through ``prompt``, then NEW_TOKENS greedy
  tokens, beside b - 1 active slots of other tokens: (slot 0's tokens,
  its logits row at each prompt position)."""
  tokens, rows = [], []
  tok = np.concatenate([prompt[:1], fill[1:b]]).astype(np.int32)
  for t in range(prompt.size + NEW_TOKENS - 1):
    nxt, row = step_fn(tok, t)
    if t < prompt.size:
      rows.append(row)
    if t + 1 < prompt.size:
      tok = nxt.copy()
      tok[0] = prompt[t + 1]
    else:
      tokens.append(int(nxt[0]))
      tok = nxt
  return tokens, np.stack(rows)


def _jax_row(spec, variables, b, prompt, fill):
  module = jax_decode.decode_module(spec)
  apply = jax.jit(module.apply)
  cache = jax_decode.init_cache(spec, b)
  state = {"k": cache.k, "v": cache.v, "pos": jnp.zeros((b,), jnp.int32)}

  def step(tok, t):
    logits, (state["k"], state["v"]) = apply(
        variables, jnp.asarray(tok), state["k"], state["v"], state["pos"])
    state["pos"] = state["pos"] + 1
    logits = np.asarray(logits[:, 0].astype(jnp.float32))
    return logits.argmax(-1).astype(np.int32), logits[0]

  return _one_request(step, b, prompt, fill)


def _port_row(spec, state, b, prompt, fill):
  module = port_decode.load_module(spec, state, "cpu")
  cache = port_decode.init_cache(spec, b, "cpu")

  def step(tok, t):
    with torch.no_grad():
      logits, _ = module.decode(torch.from_numpy(tok), cache.k, cache.v,
                                torch.full((b,), t, dtype=torch.int32))
    logits = logits[:, 0].float().numpy()
    return logits.argmax(-1).astype(np.int32), logits[0]

  return _one_request(step, b, prompt, fill)


def test_bf16_decode_row_against_the_batch_width():
  """ROADMAP Queue 3 item 3: one request's greedy tokens in bf16 at buckets
  16, 64 and 256, through the JAX package's decode and the port's. A port
  fault would be a port row that depends on the batch width where the JAX
  package's does not. Here the JAX package's own row does: its logits at
  64 and 256 are not bitwise those at 16 (its CPU dot rounds by the batch
  width), so the eager-versus-captured token differences on the card are
  bf16 rounding by batch width, which the reference shares, not a port
  fault. The tokens themselves agree at every width, in both, and the
  port's logits stay within bf16 rounding (2^-6 of the largest) of the JAX
  package's at each width."""
  jspec = jax_decode.LMSpec(**WIDE, dtype=jnp.bfloat16)
  pspec = port_decode.LMSpec(**WIDE, dtype=torch.bfloat16)
  variables, state = _variables(jspec, pspec)
  rng = np.random.default_rng(1)
  prompt = rng.integers(0, WIDE["vocab"], 6).astype(np.int32)
  fill = rng.integers(0, WIDE["vocab"], max(BUCKETS)).astype(np.int32)
  jax_runs = {b: _jax_row(jspec, variables, b, prompt, fill)
              for b in BUCKETS}
  port_runs = {b: _port_row(pspec, state, b, prompt, fill) for b in BUCKETS}
  assert any(not np.array_equal(jax_runs[b][1], jax_runs[16][1])
             for b in BUCKETS[1:])
  for b in BUCKETS:
    assert port_runs[b][0] == jax_runs[b][0] == jax_runs[16][0], b
    scale = np.abs(jax_runs[b][1]).max()
    assert np.abs(port_runs[b][1] - jax_runs[b][1]).max() <= \
        2.0 ** -6 * scale, b
