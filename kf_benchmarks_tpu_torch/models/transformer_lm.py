"""Transformer language model: the zoo's decoder-only LM.

The port's counterpart of kf_benchmarks_tpu/models/transformer_lm.py: the
training branch of ``_Block`` (:169-207) with its ``return_kv`` outputs,
the dense-ring and paged decode branches (:139-168, :89-132),
``_TransformerLMModule.__call__`` (:276-384), ``_decode_call`` (:386-451)
and ``TransformerLMModel``. Pre-LN blocks, learned
positions, one Dense(3d) for q, k and v, the fused chunked LM head
(ops/fused_loss.py). The forward and the decode step share every parameter,
so one module (and one weight bridge, convert.py) serves both.

    python -m kf_benchmarks_tpu_torch.cli --model=transformer_lm --use_fp16

Switches, read when the module is made (names and defaults of the JAX
package):

* ``KF_TRANSFORMER_LM_ATTN`` -- ``tiled`` (default): ``blockwise_attention``
  in plain PyTorch ops; ``flash``: the hand-written CUDA flash-attention
  kernels (ops/flash_attention.py), their plain versions on the CPU.
* ``KF_TRANSFORMER_LM_HEAD`` -- ``fused`` (default): the module returns a
  ``FusedLMHead`` and the loss reduces it chunk-wise; ``dense``: logits.
* ``KF_TRANSFORMER_LM_LAYERS`` -- ``scan`` (default): every block under
  ``torch.utils.checkpoint`` (the JAX package's ``nn.remat`` per scanned
  block; the backward recomputes the block); ``loop``: no checkpoint.

The scan layout's block stack is the flax tree's ``blocks`` prefix
(``stacked_prefixes``), which the data-parallel modes treat block by
block, as the JAX package's hooks inside its ``nn.scan`` do:
--overlap_gradient_reduction reduces each block's gradients as one bucket
(ops/overlap.py), and --shard_params sets ``block_hook``, which runs a
block on the parameters of one gather of its shards inside the block's
checkpoint region, so the backward's recompute gathers it again
(ops/overlap.py ``fsdp_block_gatherer``).

Precision follows flax's ``dtype=``/``param_dtype=`` split: parameters are
f32 (bf16 under --fp16_vars, models/model.py ``cast_params``); each Dense
casts its input and parameters to the compute dtype (a no-op on bf16
parameters); the
LayerNorms compute in f32 (eps 1e-6) and the block casts back; the
embedding and position rows are cast to the compute dtype. ``gelu`` is the
tanh approximation (flax's ``nn.gelu`` default).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint

from kf_benchmarks_tpu_torch.data import packing
from kf_benchmarks_tpu_torch.models import model as model_lib
from kf_benchmarks_tpu_torch.ops import fused_loss
from kf_benchmarks_tpu_torch.ops.conv_bn import accum
from kf_benchmarks_tpu_torch.parallel import sequence

VOCAB = 32768
SEQ_LEN = 2048
D_MODEL = 512
N_LAYERS = 6
N_HEADS = 8
D_FF = 2048
ATTN_BLOCK = 512
ATTN_Q_BLOCK = 512


def _env(name: str, default: str, choices) -> str:
  value = os.environ.get(name, default)
  if value not in choices:
    raise ValueError(f"{name} must be {' or '.join(repr(c) for c in choices)}"
                     f", got {value!r}")
  return value


def attn_impl() -> str:
  """KF_TRANSFORMER_LM_ATTN: 'tiled' (default) or 'flash'."""
  return _env("KF_TRANSFORMER_LM_ATTN", "tiled", ("tiled", "flash"))


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
  """flax's lecun_normal: truncated normal, std 1/sqrt(fan_in)."""
  std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
  with torch.no_grad():
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
  """flax ``nn.Dense(dtype=...)``: input, weight and bias cast to the compute
  dtype. ``weight`` is (out, in), the flax kernel transposed."""

  def __init__(self, d_in: int, d_out: int, bias: bool, dtype: torch.dtype,
               generator=None):
    super().__init__()
    self.dtype = dtype
    self.weight = nn.Parameter(torch.empty(d_out, d_in))
    _lecun_normal_(self.weight, d_in, generator)
    self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    bias = None if self.bias is None else self.bias.to(self.dtype)
    return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.Module):
  """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, computed and returned in
  f32 whatever the parameters' dtype (bf16 ones, under --fp16_vars, are
  upcast; f64 ones keep f64)."""

  def __init__(self, d: int):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(d))
    self.bias = nn.Parameter(torch.zeros(d))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dt = accum(self.weight).dtype
    return F.layer_norm(x.to(dt), self.weight.shape, self.weight.to(dt),
                        self.bias.to(dt), 1e-6)


class Block(nn.Module):
  """One pre-LN decoder block (the training branch of ``_Block``)."""

  def __init__(self, d_model: int, n_heads: int, d_ff: int, attn_block: int,
               attn_q_block: int, impl: str, dtype: torch.dtype,
               generator=None, decode_exact: bool = False):
    super().__init__()
    self.n_heads = n_heads
    self.attn_block = attn_block
    self.attn_q_block = attn_q_block
    self.impl = impl
    self.dtype = dtype
    self.decode_exact = decode_exact
    g = generator
    self.ln1 = LayerNorm(d_model)
    self.qkv = Dense(d_model, 3 * d_model, False, dtype, g)
    self.attn_out = Dense(d_model, d_model, True, dtype, g)
    self.ln2 = LayerNorm(d_model)
    self.mlp_up = Dense(d_model, d_ff, True, dtype, g)
    self.mlp_down = Dense(d_ff, d_model, True, dtype, g)

  def _mlp(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    x = x + self.attn_out(att.reshape(x.shape))
    h = self.ln2(x).to(self.dtype)
    h = F.gelu(self.mlp_up(h), approximate="tanh")
    return x + self.mlp_down(h)

  def forward(self, x: torch.Tensor, seg: Optional[torch.Tensor],
              return_kv: bool = False):
    """x (B, T, d) -> x; with ``return_kv`` also this layer's per-position
    K and V projections (B, T, H, Dh), the arrays a decode step would have
    written at those positions (the packed-prefill cache source)."""
    b, t, d = x.shape
    h = self.ln1(x).to(self.dtype)
    qkv = self.qkv(h).reshape(b, t, 3, self.n_heads, d // self.n_heads)
    q, k, v = qkv.unbind(2)
    blk = min(self.attn_block, t)
    if self.impl == "flash":
      att = sequence.pallas_flash_attention(q, k, v, causal=True, block=blk,
                                            segment_ids=seg)
    else:
      att = sequence.blockwise_attention(
          q, k, v, block_size=blk, causal=True,
          q_block_size=min(self.attn_q_block, t), segment_ids=seg)
    x = self._mlp(x, att)
    return (x, k, v) if return_kv else x

  def decode(self, x: torch.Tensor, pos: torch.Tensor, ck: torch.Tensor,
             cv: torch.Tensor, page_table: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """One token per slot over this layer's KV ring: x (B, 1, d), pos (B,)
    absolute positions, ck/cv (B, T, H, Dh) ring buffers. The token's K/V
    are written into the ring at pos % T in place (an indexed copy of B
    rows; the JAX package selects over the whole ring), then it attends
    over the slots s <= pos (parallel/sequence.py decode_attention).

    With ``page_table`` (B, pages_per_slot), ck/cv are this layer's
    (P, page, H, Dh) page pools: the write goes to pool row
    ``table[b, r // page]`` at ``r % page`` for r = pos % (pages_per_slot
    * page), and attention reads the slot's pages through the table (the
    JAX package's paged branch, transformer_lm.py:89-132). A slot whose
    table row is all 0 writes to the scratch page."""
    b, _, d = x.shape
    h = self.ln1(x).to(self.dtype)
    qkv = self.qkv(h).reshape(b, 1, 3, self.n_heads, d // self.n_heads)
    if page_table is not None:
      page = ck.shape[1]
      rpos = pos.long() % (page_table.shape[1] * page)
      row = page_table.long().gather(1, (rpos // page)[:, None])[:, 0]
      ck[row, rpos % page] = qkv[:, 0, 1].to(ck.dtype)
      cv[row, rpos % page] = qkv[:, 0, 2].to(cv.dtype)
      att = sequence.decode_attention(
          qkv[:, :, 0], ck, cv, pos, block=page, impl=self.impl,
          exact=self.decode_exact, q_block=page, page_table=page_table)
      return self._mlp(x, att)
    t = ck.shape[1]
    slot = pos.long() % t
    batch = torch.arange(b, device=x.device)
    ck[batch, slot] = qkv[:, 0, 1].to(ck.dtype)
    cv[batch, slot] = qkv[:, 0, 2].to(cv.dtype)
    att = sequence.decode_attention(
        qkv[:, :, 0], ck, cv, pos, block=min(self.attn_block, t),
        impl=self.impl, exact=self.decode_exact,
        q_block=min(self.attn_q_block, t))
    return self._mlp(x, att)


class TransformerLM(nn.Module):
  """Tokens (B, T), or the packed (B, 3, T) stack [tokens, segment_ids,
  positions], -> (FusedLMHead or (B, T, V) logits, per-token loss weights
  or None). The input's shape is the mode switch, as in the JAX module."""

  def __init__(self, vocab: int, d_model: int, n_layers: int, n_heads: int,
               d_ff: int, attn_block: int, attn_q_block: int, impl: str,
               scan_layers: bool, fused_head: bool, max_len: int,
               dtype: torch.dtype, generator=None,
               decode_exact: bool = False):
    super().__init__()
    self.dtype = dtype
    self.max_len = max_len
    self.scan_layers = scan_layers
    self.fused_head = fused_head
    g = generator
    self.embed = nn.Embedding(vocab, d_model)
    self.pos_embedding = nn.Parameter(torch.empty(max_len, d_model))
    with torch.no_grad():
      # flax: Embed's variance_scaling(1, fan_in, normal) and normal(0.02).
      self.embed.weight.normal_(0.0, d_model ** -0.5, generator=g)
      self.pos_embedding.normal_(0.0, 0.02, generator=g)
    self.blocks = nn.ModuleList(
        Block(d_model, n_heads, d_ff, attn_block, attn_q_block, impl, dtype,
              g, decode_exact) for _ in range(n_layers))
    self.ln_f = LayerNorm(d_model)
    self.lm_head = nn.Parameter(torch.empty(d_model, vocab))
    _lecun_normal_(self.lm_head, d_model, g)
    # hook(l, x, seg) -> x in place of blocks[l](x, seg) in the training
    # forward's checkpoint regions (the FSDP per-block gather), or None.
    self.block_hook = None

  @property
  def stacked_prefixes(self):
    """The flax tree's top-level keys whose leaves stack the layers:
    ``blocks`` in the scan layout, none in the loop layout (whose
    ``block_<l>`` keys are builder layers like any other)."""
    return ("blocks",) if self.scan_layers else ()

  def forward(self, tokens: torch.Tensor, return_kv: bool = False):
    """``return_kv``: also return the stacked per-layer K and V projections,
    each (L, B, T, H, Dh), as a third output (the packed prefill's cache
    source)."""
    seg = positions = None
    if tokens.dim() == 3:
      tokens, seg, positions = tokens[:, 0], tokens[:, 1], tokens[:, 2]
    t = tokens.shape[1]
    x = self.embed(tokens.long()).to(self.dtype)
    pos = (self.pos_embedding[:t] if positions is None
           else self.pos_embedding[positions.long()])
    x = x + pos.to(self.dtype)
    ks, vs = [], []
    for i, block in enumerate(self.blocks):
      if return_kv:
        x, k, v = block(x, seg, return_kv=True)
        ks.append(k)
        vs.append(v)
      elif self.scan_layers and torch.is_grad_enabled():
        run = (block if self.block_hook is None
               else functools.partial(self.block_hook, i))
        x = checkpoint.checkpoint(run, x, seg, use_reentrant=False,
                                  preserve_rng_state=False)
      else:
        x = block(x, seg)
    hidden = self.ln_f(x).to(self.dtype)
    aux = None if seg is None else packing.token_weights_from_segments(seg)
    if self.fused_head:
      out = fused_loss.FusedLMHead(hidden=hidden, kernel=self.lm_head)
    else:
      out = hidden @ self.lm_head.to(self.dtype)
    if return_kv:
      return out, aux, (torch.stack(ks), torch.stack(vs))
    return out, aux

  def decode(self, tokens: torch.Tensor, cache_k: torch.Tensor,
             cache_v: torch.Tensor, pos: torch.Tensor,
             page_table: Optional[torch.Tensor] = None):
    """The single-token KV-ring decode step: ``tokens`` (B,) is each slot's
    current token at absolute position ``pos`` (B,); its K/V are written
    into the (L, B, T, H, Dh) caches at ``pos % T`` in place, and the
    returned (B, 1, V) logits (always the dense head) predict position
    ``pos + 1``. Returns (logits, (cache_k, cache_v)). The position row is
    ``pos % max_len``, the row the full forward adds at that position;
    past the ring's length attention covers the trailing window. With
    ``page_table`` (B, pages_per_slot) the caches are the (L, P, page, H,
    Dh) page pools, shared by every layer's table (``Block.decode``)."""
    x = self.embed(tokens.long().reshape(-1, 1)).to(self.dtype)
    x = x + self.pos_embedding[pos.long() % self.max_len][:, None].to(
        self.dtype)
    for i, block in enumerate(self.blocks):
      x = block.decode(x, pos, cache_k[i], cache_v[i], page_table)
    hidden = self.ln_f(x).to(self.dtype)
    return hidden @ self.lm_head.to(self.dtype), (cache_k, cache_v)


def _head(module_output):
  """(hidden, kernel, weights) of the module's output; the dense head's
  logits come with kernel None (the loss then reduces them chunk-wise)."""
  out, weights = module_output
  if isinstance(out, fused_loss.FusedLMHead):
    return out.hidden, out.kernel, weights
  return out, None, weights


class TransformerLMModel(model_lib.Model):
  """Decoder-only LM over synthetic token streams: batch 8, rate 0.05,
  sequences of SEQ_LEN; throughput prints as sequences/sec on the
  reference's images/sec line."""

  data_name = "token stream"
  # Sequence chunk of the loss: one (B, chunk, V) f32 softmax at a time.
  LOSS_CHUNK = 256

  def __init__(self, params=None):
    super().__init__("transformer_lm", batch_size=8, learning_rate=0.05,
                     params=params)

  def bf16_kernels(self) -> str:
    if attn_impl() == "flash":
      return ("the flash-attention kernels (csrc/flash_attention_fwd.cu, "
              "csrc/flash_attention_bwd.cu, csrc/flash_decode.cu)")
    return ""

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    del nclass
    impl = attn_impl()
    head = _env("KF_TRANSFORMER_LM_HEAD", "fused", ("fused", "dense"))
    layers = _env("KF_TRANSFORMER_LM_LAYERS", "scan", ("scan", "loop"))
    # --attn_block sets both the K/V block and the matched q block.
    attn_block = getattr(self.params, "attn_block", None) or ATTN_BLOCK
    attn_q_block = getattr(self.params, "attn_block", None) or ATTN_Q_BLOCK
    return TransformerLM(VOCAB, D_MODEL, N_LAYERS, N_HEADS, D_FF, attn_block,
                         attn_q_block, impl, layers == "scan",
                         head == "fused", SEQ_LEN, dtype, generator)

  def get_input_shapes(self, subset: str):
    del subset
    n = self.get_batch_size()
    return [[n, SEQ_LEN], [n, SEQ_LEN]]

  def get_synthetic_inputs(self, generator: torch.Generator, nclass: int,
                           device: torch.device):
    """Uniform token ids and their next-token labels (the shifted stream,
    so the objective is the real LM objective), int64 on ``device``."""
    del nclass
    shape, _ = self.get_input_shapes("train")
    tokens = torch.randint(0, VOCAB, shape, generator=generator,
                           device=device)
    return tokens, torch.roll(tokens, -1, dims=1)

  def loss_function(self, logits, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of the module's (head, weights) output."""
    hidden, kernel, weights = _head(logits)
    return fused_loss.fused_softmax_xent(hidden, kernel, labels,
                                         chunk_size=self.LOSS_CHUNK,
                                         weights=weights)

  def accuracy_function(self, logits, labels: torch.Tensor):
    hidden, kernel, weights = _head(logits)
    return fused_loss.fused_top_k_accuracy(hidden, kernel, labels,
                                           chunk_size=self.LOSS_CHUNK,
                                           weights=weights)


def create_transformer_lm_model(params=None):
  return TransformerLMModel(params=params)
