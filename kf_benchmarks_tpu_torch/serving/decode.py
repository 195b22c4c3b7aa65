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


def decode_fn(spec: LMSpec):
  """``(module, k, v, pos, tok, active) -> (tok, k, v, pos)``: one greedy
  decode step for every slot, in place: ``k``/``v`` take the step's ring
  writes, ``tok`` the sampled tokens and ``pos`` advances, and the same
  tensors are returned. Inactive slots keep their token and position
  (their ring write lands on their own row, which the next prefill
  re-installs wholesale). Everything stays on the device, so the step is
  one CUDA graph a bucket (serving/engine.py)."""
  del spec  # the module carries the shape

  @torch.no_grad()
  def step(module, cache_k, cache_v, pos, tok, active):
    logits, _ = module.decode(tok, cache_k, cache_v, pos)
    nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
    tok.copy_(torch.where(active, nxt, tok))
    pos.add_(active.to(torch.int32))
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
  device = cache.k.device
  b = cache.k.shape[1]
  slots = slots.to(device, torch.long)
  n = slots.shape[0]
  src = torch.where(slots < b, torch.arange(n, device=device),
                    torch.zeros_like(slots))
  dst = slots[src].clamp(max=b - 1)
  cache.k[:, dst] = ek[src].transpose(0, 1).to(cache.k.dtype)
  cache.v[:, dst] = ev[src].transpose(0, 1).to(cache.v.dtype)
  cache.pos[dst] = lengths.to(device, torch.int32)[src]
  cache.tok[dst] = first.to(device)[src]
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
