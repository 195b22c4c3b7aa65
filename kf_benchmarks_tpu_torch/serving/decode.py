"""KV-cache LM decode programs for the serving engine.

The port's counterpart of kf_benchmarks_tpu/serving/decode.py on one
device, with its decode-cost variants (INT8 weights, the paged KV cache,
speculative decoding; the tensor-parallel one is not ported, ROADMAP
Queue 1 item 11). Three programs, each a plain function of the served
module that the engine prepares per bucket:

* **prefill** (``prefill_fn``) -- mixed-length prompts, first-fit packed
  into one ``(B_pack, 3, T)`` stack (data/packing.py ``pack_prompts``),
  run through the full-sequence forward with ``return_kv=True``: one pass
  gives every prompt's first greedy token (from the fused head's hidden
  states at the prompts' last positions; no (B, T, V) logits) and its
  per-layer K/V span, sliced out of its packed row.
* **decode step** (``decode_fn``) -- one token per slot through
  ``TransformerLM.decode``: write K/V into the ring at ``pos % T`` (or into
  the slot's page of the pool), attend over ``slot <= pos``, greedy-sample
  the next token.
* **verify** (``verify_fn``, speculative decoding) -- one full forward over
  (B, max_len) token rows whose greedy argmax at every position is taken
  chunk by chunk along T, so no (B, T, V) logits tensor exists.

``CacheState`` holds the ``(L, B, T, H, Dh)`` K/V rings, or with
``spec.kv_page_size`` the shared ``(L, P, page, H, Dh)`` page pools, and
the per-slot ``pos``/``tok`` vectors. Every program runs under
``torch.no_grad()``, and the caches are updated IN PLACE (the decode step's
writes, the prefill install's scatter): the counterpart of the JAX
package's buffer donation, so a step's only traffic besides the cache is
its (B,) vectors and, paged, its page table.

``variables`` are the module's ``state_dict`` (f32 parameters); a flax
variable tree of ``_TransformerLMModule`` converts with
``convert.flax_to_state_dict``. Under ``spec.quantize='int8'`` they are the
quantized state (quantization.py ``QTensor`` entries, ``prepare_variables``)
and the served module is a ``QuantizedLM``: its weights stay int8 on the
device and every program dequantizes them inside the call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import quantization
from kf_benchmarks_tpu_torch.models import transformer_lm as lm

# Paged-KV pool sizing: the pool provisions this fraction of the dense
# slab's pages (bucket x pages_per_slot) plus the scratch page, floored at
# one full sequence + scratch so a max-length request always fits an empty
# pool (the JAX package's KV_POOL_FRACTION).
KV_POOL_FRACTION = 0.5

# The verifier's greedy argmax runs max_len / 8 positions of logits at a
# time (gcd-clamped so the chunk divides max_len).
VERIFY_CHUNK_DENOM = 8

# The INT8 gate: minimum prefix-conditioned next-token agreement with the
# f32 arm for quantized serving to be admitted.
QUANTIZE_AGREEMENT_BAR = 0.99


@dataclasses.dataclass(frozen=True)
class LMSpec:
  """The served LM's shape; the defaults are the zoo transformer_lm.
  ``max_len`` is both the ring length and the packed-prefill width.
  ``dtype`` is the compute and cache dtype; parameters stay f32.

  The decode-cost variants, all off by default and None in ``config()``
  when off (so a variant-off fingerprint is the one it was before them):
  ``quantize='int8'`` (per-output-channel INT8 weights dequantized inside
  every program), ``kv_page_size`` (the paged KV pool), ``speculative_k``
  with ``draft_n_layers`` (a truncated draft proposes k tokens a target
  verify). ``model_shards`` (tensor-parallel serving) is refused."""
  vocab: int = lm.VOCAB
  d_model: int = lm.D_MODEL
  n_layers: int = lm.N_LAYERS
  n_heads: int = lm.N_HEADS
  d_ff: int = lm.D_FF
  max_len: int = lm.SEQ_LEN
  attn_block: int = lm.ATTN_BLOCK
  attn_impl: str = "tiled"
  scan_layers: bool = True
  decode_exact: bool = False
  dtype: Any = torch.float32
  param_dtype: Any = torch.float32
  quantize: Optional[str] = None
  kv_page_size: int = 0
  speculative_k: int = 0
  draft_n_layers: int = 0
  model_shards: int = 0

  def __post_init__(self):
    if self.attn_impl not in ("tiled", "flash"):
      raise ValueError(f"attn_impl must be 'tiled' or 'flash', got "
                       f"{self.attn_impl!r}")
    if self.param_dtype != torch.float32:
      raise ValueError(f"param_dtype must be float32 (the port keeps f32 "
                       f"parameters), got {self.param_dtype}")
    if self.quantize not in (None, "int8"):
      raise ValueError(
          f"quantize must be None or 'int8', got {self.quantize!r}")
    if self.kv_page_size < 0 or (
        self.kv_page_size and self.max_len % self.kv_page_size):
      raise ValueError(
          f"kv_page_size ({self.kv_page_size}) must be positive and "
          f"divide max_len ({self.max_len}): partial pages would break "
          "the page-table <-> ring position bijection")
    if self.speculative_k < 0 or self.draft_n_layers < 0:
      raise ValueError("speculative_k/draft_n_layers must be >= 0")
    if self.speculative_k == 1:
      raise ValueError(
          "speculative_k must be >= 2: one proposal per target verify "
          "is strictly slower than plain decode (a verify dispatch "
          "costs a full forward)")
    if self.speculative_k and not (
        0 < self.draft_n_layers < self.n_layers):
      raise ValueError(
          f"speculative_k={self.speculative_k} requires a draft spec: "
          f"0 < draft_n_layers ({self.draft_n_layers}) < n_layers "
          f"({self.n_layers})")
    if self.draft_n_layers and not self.speculative_k:
      raise ValueError(
          "draft_n_layers without speculative_k is inert -- set both")
    if self.model_shards:
      raise ValueError(
          "model_shards (tensor-parallel serving) is not ported yet "
          "(ROADMAP Queue 1 item 11)")

  @property
  def head_dim(self) -> int:
    return self.d_model // self.n_heads

  @property
  def pages_per_slot(self) -> int:
    return self.max_len // self.kv_page_size if self.kv_page_size else 0

  def config(self) -> dict:
    """The fingerprint payload of the engine's prepared programs."""
    name = lambda dt: str(dt).replace("torch.", "")
    return {
        "vocab": self.vocab, "d_model": self.d_model,
        "n_layers": self.n_layers, "n_heads": self.n_heads,
        "d_ff": self.d_ff, "max_len": self.max_len,
        "attn_block": self.attn_block, "attn_impl": self.attn_impl,
        "scan_layers": self.scan_layers, "decode_exact": self.decode_exact,
        "dtype": name(self.dtype), "param_dtype": name(self.param_dtype),
        "quantize": self.quantize,
        "kv_page_size": self.kv_page_size or None,
        "speculative_k": self.speculative_k or None,
        "draft_n_layers": self.draft_n_layers or None,
        "model_shards": self.model_shards or None,
    }


class CacheState(NamedTuple):
  """The decode state: ``k``/``v`` (L, B, T, H, Dh) rings, or the
  (L, P, page, H, Dh) page pools under ``spec.kv_page_size`` (pool row 0
  is the scratch page: never allocated, it takes the writes of
  unallocated table entries); ``pos`` (B,) int32 absolute position of
  each slot's CURRENT token; ``tok`` (B,) int32 that token (not yet in
  the cache: the next decode step writes it). The paged slots' page
  tables are the engine's (serving/engine.py), handed to each step."""
  k: torch.Tensor
  v: torch.Tensor
  pos: torch.Tensor
  tok: torch.Tensor


def forward_module(spec: LMSpec, fused_head: bool = True,
                   generator: Optional[torch.Generator] = None
                   ) -> lm.TransformerLM:
  """The served module (randomly initialised from ``generator``): its
  forward is the prefill / oracle program, its ``decode`` the decode
  step."""
  return lm.TransformerLM(
      spec.vocab, spec.d_model, spec.n_layers, spec.n_heads, spec.d_ff,
      spec.attn_block, spec.attn_block, spec.attn_impl, spec.scan_layers,
      fused_head, spec.max_len, spec.dtype, generator,
      decode_exact=spec.decode_exact)


def decode_module(spec: LMSpec) -> lm.TransformerLM:
  """The single-token KV-ring decode module: the same module and
  parameters as the forward (``TransformerLM.decode``)."""
  return forward_module(spec)


def init_variables(spec: LMSpec, seed: int = 0) -> Dict[str, torch.Tensor]:
  """Synthetic serving weights from ``seed`` (the f32 state_dict, on the
  CPU; any transformer_lm state_dict of the same shape drops in)."""
  module = forward_module(spec, generator=torch.Generator().manual_seed(seed))
  return module.state_dict()


def leaf_sources(spec: LMSpec):
  """``sources`` of quantization.quantize_variables for this LM: each
  entry's flax leaf, so the per-layer ``blocks.<i>`` tensors quantize as
  the JAX package's scanned stack (one scale per output feature shared by
  the layers)."""
  return lambda key, _t: convert.lm_leaf_of(key, spec.scan_layers)


def draft_spec(spec: LMSpec) -> LMSpec:
  """The speculative draft's spec: the same LM truncated to
  ``draft_n_layers``; quantize and kv_page_size carry over (the engine's
  step loop, caches and decode programs run the draft)."""
  if not spec.speculative_k:
    raise ValueError("draft_spec needs speculative_k > 0")
  return dataclasses.replace(spec, n_layers=spec.draft_n_layers,
                             speculative_k=0, draft_n_layers=0)


def truncate_variables(spec: LMSpec, variables):
  """Draft weights from the TARGET's by layer truncation: the embedding,
  positional table, final LN and head, and the first ``draft_n_layers``
  blocks. Float state only; quantize AFTER truncation so the draft gets
  scales over its own layers."""
  if not spec.speculative_k:
    raise ValueError("truncate_variables needs speculative_k > 0")
  if not spec.scan_layers:
    raise ValueError(
        "truncate_variables slices the scanned block stack; "
        "scan_layers=False lays blocks out as separate modules")
  if quantization.has_quantized_leaves(variables):
    raise ValueError("truncate a float tree, then prepare_variables")
  d = spec.draft_n_layers
  return {k: v for k, v in variables.items()
          if not (k.startswith("blocks.") and int(k.split(".")[1]) >= d)}


def prepare_variables(spec: LMSpec, variables):
  """The state the spec's programs take: the INT8 quantized state under
  ``spec.quantize``. Idempotent: an already quantized state passes
  through."""
  if spec.quantize == "int8" and not quantization.has_quantized_leaves(
      variables):
    variables = quantization.quantize_variables(variables,
                                                leaf_sources(spec))
  return variables


def _serving_view(spec: LMSpec, variables):
  """Inside-the-program weight view: ``QTensor`` entries dequantized to
  the compute dtype, the float entries as they are. The JAX package
  dequantizes to param_dtype (f32) and its Dense layers then cast to the
  compute dtype; ``q * scale`` is rounded once either way, so the values
  are the same, and the f32 copy is never written."""
  return quantization.dequantize_variables(variables, spec.dtype)


class _Method(nn.Module):
  """``module.<method>`` as a forward, for ``torch.func.functional_call``."""

  def __init__(self, module: nn.Module, method: str):
    super().__init__()
    self.module = module
    self.method = method

  def forward(self, *args, **kwargs):
    return getattr(self.module, self.method)(*args, **kwargs)


class QuantizedLM:
  """The served module of a quantized spec: the module's structure (its
  own parameters on the meta device, never read) and the quantized state
  on the serving device. Its ``__call__`` and ``decode`` dequantize the
  weights (``_serving_view``) and run the module on them, so inside a
  captured program every call reads the int8 weights. ``decode`` takes
  only the B embedding rows it reads: it dequantizes ``q[tokens]`` (the
  same values, each element being ``q * scale`` of its column) and looks
  them up by row index, where dequantizing the whole 32768-row table
  would be a third of the step's weight pass."""

  def __init__(self, spec: LMSpec, module: lm.TransformerLM, qvars):
    self.spec = spec
    self.qvars = qvars
    self._forward = _Method(module, "forward")
    self._decode = _Method(module, "decode")

  def _call(self, wrapper, qvars, args, kwargs):
    view = {"module." + k: v for k, v in
            _serving_view(self.spec, qvars).items()}
    return torch.func.functional_call(wrapper, view, args, kwargs)

  def __call__(self, *args, **kwargs):
    return self._call(self._forward, self.qvars, args, kwargs)

  def decode(self, tokens, *args, **kwargs):
    embed = self.qvars["embed.weight"]
    if not quantization.is_quantized(embed):
      return self._call(self._decode, self.qvars, (tokens,) + args, kwargs)
    rows = tokens.reshape(-1).long()
    qvars = dict(self.qvars)
    qvars["embed.weight"] = quantization.QTensor(embed.q[rows], embed.scale)
    index = torch.arange(rows.shape[0], device=rows.device)
    return self._call(self._decode, qvars, (index,) + args, kwargs)


def load_module(spec: LMSpec, variables, device, fused_head: bool = True):
  """The served module holding ``variables``, on ``device``, in eval mode:
  the ``TransformerLM`` itself, or for a quantized state a
  ``QuantizedLM`` whose int8 weights are on ``device``."""
  module = forward_module(spec, fused_head)
  if quantization.has_quantized_leaves(variables):
    return QuantizedLM(spec, module.to("meta").eval(),
                       quantization.to_device(variables, device))
  module.load_state_dict(variables)
  return module.to(device).eval()


def kv_pool_pages(spec: LMSpec, bucket: int) -> int:
  """Pool size P of a paged cache for ``bucket`` slots: the scratch page
  plus KV_POOL_FRACTION of the dense slab's pages, floored at one full
  sequence -- strictly below the dense slab for every bucket > 1."""
  pps = spec.pages_per_slot
  return max(pps + 1, 1 + math.ceil(bucket * pps * KV_POOL_FRACTION))


def init_cache(spec: LMSpec, bucket: int, device,
               slots: Optional[int] = None) -> CacheState:
  """Zero caches for ``bucket`` slots: the dense rings, or the page pools
  sized for ``bucket`` (``kv_pool_pages``); ``pos``/``tok`` have ``slots``
  rows (default ``bucket``)."""
  if spec.kv_page_size:
    shape = (spec.n_layers, kv_pool_pages(spec, bucket), spec.kv_page_size,
             spec.n_heads, spec.head_dim)
  else:
    shape = (spec.n_layers, bucket, spec.max_len, spec.n_heads,
             spec.head_dim)
  rows = bucket if slots is None else slots
  return CacheState(
      k=torch.zeros(shape, dtype=spec.dtype, device=device),
      v=torch.zeros(shape, dtype=spec.dtype, device=device),
      pos=torch.zeros(rows, dtype=torch.int32, device=device),
      tok=torch.zeros(rows, dtype=torch.int32, device=device))


def decode_fn(spec: LMSpec):
  """``(module, k, v, pos, tok, active) -> (tok, k, v, pos)``: one greedy
  decode step for every slot, in place: ``k``/``v`` take the step's ring
  writes, ``tok`` the sampled tokens and ``pos`` advances, and the same
  tensors are returned. Inactive slots keep their token and position
  (their ring write lands on their own row, which the next prefill
  re-installs wholesale). Everything stays on the device, so the step is
  one CUDA graph a bucket (serving/engine.py)."""
  def advance(logits, pos, tok, active):
    nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
    tok.copy_(torch.where(active, nxt, tok))
    pos.add_(active.to(torch.int32))

  if spec.kv_page_size:
    @torch.no_grad()
    def paged_step(module, cache_k, cache_v, pos, tok, page_table, active):
      """The paged step: ``page_table`` (B, pages_per_slot) int32 maps each
      slot's logical pages to pool rows; inactive and free slots carry an
      all-0 row, so their writes land on the scratch page."""
      logits, _ = module.decode(tok, cache_k, cache_v, pos, page_table)
      advance(logits, pos, tok, active)
      return tok, cache_k, cache_v, pos

    return paged_step

  @torch.no_grad()
  def step(module, cache_k, cache_v, pos, tok, active):
    logits, _ = module.decode(tok, cache_k, cache_v, pos)
    advance(logits, pos, tok, active)
    return tok, cache_k, cache_v, pos

  return step


def _spans(kv: torch.Tensor, rows: torch.Tensor, offsets: torch.Tensor,
           t_cache: int) -> torch.Tensor:
  """(R, L, t_cache, H, Dh): request i's K or V from its packed row
  ``rows[i]`` starting at ``offsets[i]``, zero past the packed row's end
  (the JAX package pads the stack along T and slices). One gather on
  device index tensors of the pack bucket's size: no host read, a fixed
  shape."""
  l_, _, t, _, _ = kv.shape
  device = kv.device
  rows = rows.to(device, torch.long)
  idx = (offsets.to(device, torch.long)[:, None] +
         torch.arange(t_cache, device=device))                 # (R, t_cache)
  layers = torch.arange(l_, device=device)
  out = kv.permute(1, 0, 2, 3, 4)[rows[:, None, None], layers[None, :, None],
                                  idx.clamp(max=t - 1)[:, None, :]]
  out.masked_fill_((idx >= t)[:, None, :, None, None], 0)
  return out


def prefill_fn(spec: LMSpec):
  """``(module, packed, rows, last_pos, offsets) -> (first_tok, ek, ev)``:
  packed prefill, extract-only.

  ``packed`` is the (B_pack, 3, T) stack from packing.pack_prompts on the
  module's device; ``rows``, ``last_pos`` and ``offsets`` are (B_pack,)
  int32 tensors (moved to the module's device): request i sits in packed
  row ``rows[i]`` at ``offsets[i]`` and ends at ``last_pos[i]``. Returns
  each request's first greedy token (computed from the fused head's hidden
  rows at its last position only) and its per-layer K/V span (B_pack, L,
  T, H, Dh). Spans are stale-inclusive: positions past a prompt hold its
  packed neighbour's K/V until decode overwrites them, which the ``slot <=
  pos`` mask makes invisible. Padding entries give spans too; the install
  drops them. Fixed shapes and device indices throughout, so the prefill
  is one CUDA graph a pack bucket."""
  t_cache = spec.max_len

  @torch.no_grad()
  def prefill(module, packed, rows, last_pos, offsets):
    head, _aux, (kst, vst) = module(packed, return_kv=True)
    device = head.hidden.device
    rows = rows.to(device, torch.long)
    hidden = head.hidden[rows, last_pos.to(device, torch.long)]  # (R, D)
    logits = hidden @ head.kernel.to(spec.dtype)                 # (R, V)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    return first, _spans(kst, rows, offsets, t_cache), \
        _spans(vst, rows, offsets, t_cache)

  return prefill


def install_prefill(cache: CacheState, ek, ev, first, lengths,
                    slots) -> CacheState:
  """Scatter prefilled spans into their decode slots, in place, and return
  the cache. ``slots`` and ``lengths`` are (B_pack,) int32 tensors (moved
  to the cache's device); padding entries carry an out-of-range slot (at
  least the cache's row count) and are dropped, as the JAX package's
  ``mode="drop"`` drops them: each repeats entry 0's write, so every index
  is in range and the duplicate writes carry equal values. Entry 0 is a
  request whenever the wave has one (the engine places requests first); a
  wave of padding alone would write entry 0's span into the last row, so
  the engine's rings keep a spare last row that its padding entries name.
  Fixed shapes and device indices: no host read."""
  src, dst = _install_slots(cache, first, lengths, slots)
  cache.k[:, dst] = ek[src].transpose(0, 1).to(cache.k.dtype)
  cache.v[:, dst] = ev[src].transpose(0, 1).to(cache.v.dtype)
  return cache


def _install_slots(cache: CacheState, first, lengths, slots):
  """``pos``/``tok`` of a wave's entries into their slots, padding entries
  (an out-of-range slot) repeating entry 0's write; returns (src, dst),
  the entry each slot row takes and the rows written."""
  device = cache.pos.device
  b = cache.pos.shape[0]
  slots = slots.to(device, torch.long)
  n = slots.shape[0]
  src = torch.where(slots < b, torch.arange(n, device=device),
                    torch.zeros_like(slots))
  dst = slots[src].clamp(max=b - 1)
  cache.pos[dst] = lengths.to(device, torch.int32)[src]
  cache.tok[dst] = first.to(device)[src]
  return src, dst


def install_prefill_paged(cache: CacheState, ek, ev, first, lengths, slots,
                          req_tables) -> CacheState:
  """Paged prefill install, in place: each request's (L, T, H, Dh) span is
  cut into pages_per_slot pages and written to the pool rows
  ``req_tables`` (B_pack, pages_per_slot) names, in logical page order;
  ``pos``/``tok`` go to ``slots`` as ``install_prefill`` puts them. The
  JAX package marks unallocated pages and padding rows with an
  out-of-range id and drops their writes; here they name the scratch page
  0, which takes them (fixed shapes and device indices, so the install
  is part of the captured prefill)."""
  l_, page = cache.k.shape[0], cache.k.shape[2]
  bpk, _, t, h_, dh = ek.shape
  pps = t // page
  ids = req_tables.to(cache.k.device, torch.long).reshape(-1)

  def paginate(arr):
    # (B_pack, L, T, H, Dh) -> (L, B_pack * pps, page, H, Dh), slot-major,
    # page-minor, as ids flattens.
    pag = arr.reshape(bpk, l_, pps, page, h_, dh).transpose(0, 1)
    return pag.reshape(l_, bpk * pps, page, h_, dh)

  cache.k[:, ids] = paginate(ek).to(cache.k.dtype)
  cache.v[:, ids] = paginate(ev).to(cache.v.dtype)
  _install_slots(cache, first, lengths, slots)
  return cache


def verify_chunk(spec: LMSpec) -> int:
  """Sequence-chunk width of the verify program's argmax head (divides
  max_len)."""
  return math.gcd(spec.max_len, max(1, spec.max_len // VERIFY_CHUNK_DENOM))


def verify_fn(spec: LMSpec):
  """``(module, tokens) -> preds``: the speculative TARGET verifier. One
  full forward over (B, max_len) token rows; ``preds[b, t]`` (int32) is
  the target's greedy choice for position t + 1 given ``tokens[b, :t+1]``.
  The fused head keeps it logits-free in the large: the argmax runs
  ``verify_chunk`` positions at a time, so the biggest logits tensor is
  (B, chunk, V). Fixed shapes: one CUDA graph a bucket."""
  chunk = verify_chunk(spec)

  @torch.no_grad()
  def verify(module, tokens):
    head, _aux = module(tokens)
    kernel = head.kernel.to(spec.dtype)
    t = head.hidden.shape[1]
    preds = [torch.argmax(head.hidden[:, c:c + chunk].to(spec.dtype)
                          @ kernel, dim=-1).to(torch.int32)
             for c in range(0, t, chunk)]
    return torch.cat(preds, dim=1)

  return verify


@torch.no_grad()
def reference_generate(spec: LMSpec, variables, prompt,
                       max_new_tokens: int, device="cpu"
                       ) -> Tuple[Optional[int], List[int]]:
  """Greedy generation straight through the full-sequence forward (dense
  head): the engine-free oracle. O(T^2) per token; a test instrument.
  Returns (first token, every generated token)."""
  module = load_module(spec, variables, device, fused_head=False)
  out: List[int] = []
  toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
  for _ in range(max_new_tokens):
    # Fixed (1, max_len) rows: causal attention hides the zero tail from
    # position len - 1.
    batch = torch.zeros((1, spec.max_len), dtype=torch.int32, device=device)
    batch[0, :len(toks)] = torch.tensor(toks, dtype=torch.int32)
    logits, _ = module(batch)
    nxt = int(torch.argmax(logits[0, len(toks) - 1]))
    out.append(nxt)
    toks.append(nxt)
  return (out[0] if out else None), out


@torch.no_grad()
def quantize_agreement(spec: LMSpec, variables, prompts,
                       max_new_tokens: int, device="cpu") -> Dict[str, Any]:
  """The INT8 accuracy gate on a seeded probe: the f32 arm's greedy rows
  (teacher-forced through ``verify_fn``'s full forward, all prompts in one
  batch), then the QUANTIZED model's greedy choice at every generated
  position scored against them, and the max logit delta of the
  dequantized dense-head forward over the first 4 rows.

  ``spec`` must set ``quantize``; ``variables`` is the float state. Returns
  {agreement, total, max_logit_delta, logit_scale, passed}, ``passed`` =
  agreement >= QUANTIZE_AGREEMENT_BAR. Random-init weights are the
  adversarial case (argmax margins are razor-thin)."""
  if not spec.quantize:
    raise ValueError("quantize_agreement needs a quantized spec")
  fspec = dataclasses.replace(spec, quantize=None)
  qvars = prepare_variables(spec, variables)
  fmodule = load_module(fspec, variables, device)
  qmodule = load_module(spec, qvars, device)
  fvf, qvf = verify_fn(fspec), verify_fn(spec)
  n = len(prompts)
  rows = np.zeros((n, spec.max_len), np.int32)
  lens = []
  for i, prompt in enumerate(prompts):
    p = np.asarray(prompt, np.int32).reshape(-1)
    p = p[:max(1, spec.max_len - max_new_tokens)]
    rows[i, :p.size] = p
    lens.append(p.size)
  q0 = list(lens)
  for _ in range(max_new_tokens):
    preds = fvf(fmodule, torch.from_numpy(rows).to(device)).cpu().numpy()
    for i in range(n):
      if lens[i] < spec.max_len:
        rows[i, lens[i]] = preds[i, lens[i] - 1]
        lens[i] += 1
  qpreds = qvf(qmodule, torch.from_numpy(rows).to(device)).cpu().numpy()
  total = agree = 0
  for i in range(n):
    for t in range(q0[i], lens[i]):
      total += 1
      agree += int(qpreds[i, t - 1] == rows[i, t])
  agreement = agree / max(total, 1)
  del fmodule, qmodule
  dense = load_module(fspec, variables, device, fused_head=False)
  probe = torch.from_numpy(rows[:min(n, 4)]).to(device)
  ref, _ = dense(probe)
  dense.load_state_dict(quantization.dequantize_variables(
      qvars, spec.param_dtype))
  got, _ = dense(probe)
  delta = float((got.float() - ref.float()).abs().max())
  scale = float(ref.float().abs().max())
  return {"agreement": agreement, "total": total,
          "max_logit_delta": delta, "logit_scale": scale,
          "passed": agreement >= QUANTIZE_AGREEMENT_BAR}
