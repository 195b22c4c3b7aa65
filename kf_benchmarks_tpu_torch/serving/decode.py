"""KV-cache LM decode programs for the serving engine.

The port's counterpart of kf_benchmarks_tpu/serving/decode.py on its dense,
single-device path (the INT8, paged-KV, speculative and tensor-parallel
variants are not ported yet). Two programs, each a plain function of the
served module that the engine prepares per bucket:

* **prefill** (``prefill_fn``) -- mixed-length prompts, first-fit packed
  into one ``(B_pack, 3, T)`` stack (data/packing.py ``pack_prompts``),
  run through the full-sequence forward with ``return_kv=True``: one pass
  gives every prompt's first greedy token (from the fused head's hidden
  states at the prompts' last positions; no (B, T, V) logits) and its
  per-layer K/V span, sliced out of its packed row.
* **decode step** (``decode_fn``) -- one token per slot through
  ``TransformerLM.decode``: write K/V into the ring at ``pos % T``, attend
  over ``slot <= pos``, greedy-sample the next token.

``CacheState`` holds the ``(L, B, T, H, Dh)`` K/V rings and the per-slot
``pos``/``tok`` vectors. Every program runs under ``torch.no_grad()``, and
the caches are updated IN PLACE (the decode step's ring writes, the prefill
install's scatter): the counterpart of the JAX package's buffer donation,
so a step's only traffic besides the ring is its (B,) vectors.

``variables`` are the module's ``state_dict`` (f32 parameters); a flax
variable tree of ``_TransformerLMModule`` converts with
``convert.flax_to_state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kf_benchmarks_tpu_torch.models import transformer_lm as lm


@dataclasses.dataclass(frozen=True)
class LMSpec:
  """The served LM's shape; the defaults are the zoo transformer_lm.
  ``max_len`` is both the ring length and the packed-prefill width.
  ``dtype`` is the compute and cache dtype; parameters stay f32."""
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

  def __post_init__(self):
    if self.attn_impl not in ("tiled", "flash"):
      raise ValueError(f"attn_impl must be 'tiled' or 'flash', got "
                       f"{self.attn_impl!r}")
    if self.param_dtype != torch.float32:
      raise ValueError(f"param_dtype must be float32 (the port keeps f32 "
                       f"parameters), got {self.param_dtype}")

  @property
  def head_dim(self) -> int:
    return self.d_model // self.n_heads

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
    }


class CacheState(NamedTuple):
  """The decode state: ``k``/``v`` (L, B, T, H, Dh) rings; ``pos`` (B,)
  int32 absolute position of each slot's CURRENT token; ``tok`` (B,) int32
  that token (not yet in the cache: the next decode step writes it)."""
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


def load_module(spec: LMSpec, variables: Dict[str, torch.Tensor],
                device, fused_head: bool = True) -> lm.TransformerLM:
  """The served module holding ``variables``, on ``device``, in eval
  mode."""
  module = forward_module(spec, fused_head)
  module.load_state_dict(variables)
  return module.to(device).eval()


def init_cache(spec: LMSpec, bucket: int, device) -> CacheState:
  shape = (spec.n_layers, bucket, spec.max_len, spec.n_heads,
           spec.head_dim)
  return CacheState(
      k=torch.zeros(shape, dtype=spec.dtype, device=device),
      v=torch.zeros(shape, dtype=spec.dtype, device=device),
      pos=torch.zeros(bucket, dtype=torch.int32, device=device),
      tok=torch.zeros(bucket, dtype=torch.int32, device=device))


def grow_cache(cache: CacheState, spec: LMSpec, bucket: int) -> CacheState:
  """The cache on a wider bucket (ladder growth): old slots keep their
  contents and positions, new slots start empty."""
  fresh = init_cache(spec, bucket, cache.k.device)
  old = cache.k.shape[1]
  fresh.k[:, :old] = cache.k
  fresh.v[:, :old] = cache.v
  fresh.pos[:old] = cache.pos
  fresh.tok[:old] = cache.tok
  return fresh


def decode_fn(spec: LMSpec):
  """``(module, k, v, pos, tok, active) -> (next_tok, k, v, pos')``: one
  greedy decode step for every slot. ``k``/``v`` are updated in place;
  inactive slots keep their token and position (their ring write lands on
  their own row, which the next prefill re-installs wholesale)."""
  del spec  # the module carries the shape

  @torch.no_grad()
  def step(module, cache_k, cache_v, pos, tok, active):
    logits, _ = module.decode(tok, cache_k, cache_v, pos)
    nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
    nxt = torch.where(active, nxt, tok)
    return nxt, cache_k, cache_v, pos + active.to(torch.int32)

  return step


def _spans(kv: torch.Tensor, rows: List[int], offsets: List[int],
           t_cache: int) -> torch.Tensor:
  """(R, L, t_cache, H, Dh): request i's K or V from its packed row
  ``rows[i]`` starting at ``offsets[i]``, zero past the packed row's end.
  Each span is a narrow of the (L, B_pack, T, H, Dh) stack; only the tail
  is padded (the JAX package pads the whole stack along T first)."""
  l_, _, t, h, dh = kv.shape
  out = kv.new_empty((len(rows), l_, t_cache, h, dh))
  for i, (row, off) in enumerate(zip(rows, offsets)):
    n = min(t - off, t_cache)
    out[i, :, :n] = kv[:, row].narrow(1, off, n)
    out[i, :, n:] = 0
  return out


def prefill_fn(spec: LMSpec):
  """``(module, packed, rows, last_pos, offsets) -> (first_tok, ek, ev)``:
  packed prefill, extract-only.

  ``packed`` is the (B_pack, 3, T) stack from packing.pack_prompts on the
  module's device; ``rows``, ``last_pos`` and ``offsets`` are (B_pack,)
  int32 HOST tensors: request i sits in packed row ``rows[i]`` at
  ``offsets[i]`` and ends at ``last_pos[i]``. Returns each request's first
  greedy token (computed from the fused head's hidden rows at its last
  position only) and its per-layer K/V span (B_pack, L, T, H, Dh). Spans
  are stale-inclusive: positions past a prompt hold its packed neighbour's
  K/V until decode overwrites them, which the ``slot <= pos`` mask makes
  invisible."""
  t_cache = spec.max_len

  @torch.no_grad()
  def prefill(module, packed, rows, last_pos, offsets):
    head, _aux, (kst, vst) = module(packed, return_kv=True)
    device = head.hidden.device
    hidden = head.hidden[rows.to(device, torch.long),
                         last_pos.to(device, torch.long)]       # (R, D)
    logits = hidden @ head.kernel.to(spec.dtype)                 # (R, V)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    rows_l, offs_l = rows.tolist(), offsets.tolist()
    return first, _spans(kst, rows_l, offs_l, t_cache), \
        _spans(vst, rows_l, offs_l, t_cache)

  return prefill


def install_prefill(cache: CacheState, ek, ev, first, lengths,
                    slots) -> CacheState:
  """Scatter prefilled spans into their decode slots, in place, and return
  the cache. ``slots`` and ``lengths`` are (B_pack,) int32 host tensors;
  padding entries carry an out-of-range slot (the bucket) and are dropped
  here (the JAX package's ``mode="drop"``; torch raises on such an
  index)."""
  keep = torch.nonzero(slots < cache.k.shape[1]).flatten()
  device = cache.k.device
  dst = slots[keep].to(device, torch.long)
  src = keep.to(device)
  cache.k[:, dst] = ek[src].transpose(0, 1).to(cache.k.dtype)
  cache.v[:, dst] = ev[src].transpose(0, 1).to(cache.v.dtype)
  cache.pos[dst] = lengths[keep].to(device, torch.int32)
  cache.tok[dst] = first[src]
  return cache


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
