"""Single-device attention schedules over (B, L, H, D).

The port's counterpart of the single-device half of
kf_benchmarks_tpu/parallel/sequence.py:

* ``full_attention`` -- the O(L^2) reference (sequence.py:54);
* ``_block_update`` / ``blockwise_attention`` -- the online-softmax schedule
  over K/V blocks, one- or two-level (sequence.py:114, :405): the LM's
  ``tiled`` attention, in plain PyTorch ops;
* ``pallas_flash_attention`` -- the LM's ``flash`` attention
  (sequence.py:763): here the hand-written CUDA kernels of
  ops/flash_attention.py, with the plain versions on the CPU;
* ``decode_attention`` -- single-query attention over the serving KV ring
  (sequence.py:554): ``flash`` onto the decode kernels of
  ops/flash_attention.py, ``tiled`` the ``_block_update`` online softmax,
  ``exact`` the full-sequence oracle; and over the paged KV pool
  (sequence.py:612-640), the tiled gather schedule.

Masking follows the JAX package: ``_NEG`` in place of -inf, a causal mask
aligned at the top left (``arange(lq)[:, None] >= arange(lk)``), segment
ids compared by equality (padding id 0 attends padding, so no row of a
packed batch is ever fully masked). The ring, zigzag and Ulysses schedules
(sequence parallelism across devices) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from kf_benchmarks_tpu_torch.ops import flash_attention as flash_lib
from kf_benchmarks_tpu_torch.ops.conv_bn import accum

# Finite stand-in for -inf: exp(_NEG - _NEG) stays defined (= 1, zeroed by
# the explicit mask on p) where a fully masked row would give inf - inf.
_NEG = -1e30


def full_attention(q, k, v, causal: bool = False,
                   scale: Optional[float] = None, segment_ids=None):
  """Plain O(L^2) multi-head attention in the accumulation dtype; result in
  q's dtype. ``segment_ids`` (B, L): a query attends only keys of its
  segment."""
  scale = flash_lib.default_scale(q) if scale is None else scale
  s = torch.einsum("bqhd,bkhd->bhqk", accum(q), accum(k)) * scale
  mask = flash_lib.admissible(q.shape[1], k.shape[1], causal, segment_ids,
                              segment_ids, device=q.device)
  if mask is not None:
    s = torch.where(mask, s, torch.full_like(s, _NEG))
  p = torch.softmax(s, dim=-1)
  out = torch.einsum("bhqk,bkhd->bqhd", p, accum(v))
  return out.to(q.dtype)


def _block_update(q, k, v, m, l, o, scale, mask):
  """One online-softmax step over a K/V block.

  q (B,Tq,H,D); k, v (B,Tk,H,D); running max m and denominator l (B,H,Tq);
  running unnormalised output o (B,Tq,H,D) in the accumulation dtype. The
  products take the input dtype with sums in the accumulation dtype; the
  probability tile is cast to v's dtype for the PV product
  (sequence.py:114-145)."""
  s = torch.einsum("bqhd,bkhd->bhqk", accum(q), accum(k)) * scale
  if mask is not None:
    s = torch.where(mask, s, torch.full_like(s, _NEG))
  m_new = torch.maximum(m, s.amax(-1))
  corr = torch.exp(m - m_new)
  p = torch.exp(s - m_new[..., None])
  if mask is not None:
    # A fully masked row has m_new == _NEG and exp(s - m_new) == 1.
    p = torch.where(mask, p, torch.zeros_like(p))
  l_new = l * corr + p.sum(-1)
  pv = torch.einsum("bhqk,bkhd->bqhd", accum(p.to(v.dtype)), accum(v))
  o_new = o * corr.transpose(1, 2)[..., None] + pv
  return m_new, l_new, o_new


def _tile_mask(q_off, tq, k_off, tk, causal, seg_q, seg_k, device):
  """Mask of one (q block, K/V block) tile, broadcastable to
  (B, H, Tq, Tk), or None."""
  mask = None
  if causal:
    qpos = q_off + torch.arange(tq, device=device)
    kpos = k_off + torch.arange(tk, device=device)
    mask = (qpos[:, None] >= kpos[None, :])
  if seg_q is not None:
    seg = (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    mask = seg if mask is None else (mask & seg)
  return mask


def _finish(o, l, dtype):
  return (o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(dtype)


def blockwise_attention(q, k, v, block_size: int, causal: bool = False,
                        scale: Optional[float] = None,
                        q_block_size: Optional[int] = None,
                        segment_ids=None):
  """Flash-style attention as an online softmax over K/V blocks of
  ``block_size``; with ``q_block_size`` also over q blocks (two-level
  tiling), where under ``causal`` the K/V blocks wholly in a q block's
  future are skipped. Exact: every query attends every admissible key.

  The JAX package also skips tiles that are fully cross-segment for every
  batch row (a data-dependent ``lax.cond``); such a tile is an exact no-op
  of the update, and in eager PyTorch the test would cost a host sync, so
  the port runs it. Autograd keeps each tile's intermediates (the JAX
  package rematerialises them per block); the LM's per-block checkpoint
  bounds that to one layer at a time.

  (B, L, H, D) -> (B, L, H, D); L % block_size == 0.
  """
  b, seq, h, d = q.shape
  if seq % block_size != 0:
    raise ValueError(f"seq len {seq} not divisible by block {block_size}")
  scale = flash_lib.default_scale(q) if scale is None else scale
  nblk = seq // block_size
  acc_dtype = accum(q).dtype
  q_block = seq if q_block_size is None else q_block_size
  if seq % q_block != 0:
    raise ValueError(f"seq len {seq} not divisible by q block {q_block}")
  outs = []
  for qi in range(seq // q_block):
    q0 = qi * q_block
    qb = q[:, q0:q0 + q_block]
    sq = None if segment_ids is None else segment_ids[:, q0:q0 + q_block]
    m = torch.full((b, h, q_block), _NEG, dtype=acc_dtype, device=q.device)
    l = torch.zeros((b, h, q_block), dtype=acc_dtype, device=q.device)
    o = torch.zeros((b, q_block, h, d), dtype=acc_dtype, device=q.device)
    for j in range(nblk):
      k0 = j * block_size
      if causal and q_block_size is not None and k0 > q0 + q_block - 1:
        break  # this and every later K/V block lie in the q block's future
      sk = None if segment_ids is None else \
          segment_ids[:, k0:k0 + block_size]
      mask = _tile_mask(q0, q_block, k0, block_size, causal, sq, sk,
                        q.device)
      m, l, o = _block_update(qb, k[:, k0:k0 + block_size],
                              v[:, k0:k0 + block_size], m, l, o, scale, mask)
    outs.append(_finish(o, l, q.dtype))
  return torch.cat(outs, dim=1)


def pallas_flash_attention(q, k, v, causal: bool = False,
                           scale: Optional[float] = None,
                           block: Optional[int] = None, segment_ids=None):
  """Flash attention over (B, L, H, D) through ops/flash_attention.py: the
  hand-written CUDA kernels on the card, their plain versions on the CPU.

  ``block`` is the JAX package's uniform Pallas tile (sequence.py:797-805);
  it is accepted so callers keep their signature and does not set the CUDA
  kernels' tile, which the kernels choose themselves. ``segment_ids``
  (B, L) serves as both the q and the kv segment ids."""
  del block
  return flash_lib.flash_attention(q, k, v, causal=causal, scale=scale,
                                   q_seg=segment_ids, kv_seg=segment_ids)


def decode_attention(q, k, v, pos, block: Optional[int] = None,
                     impl: str = "tiled", scale: Optional[float] = None,
                     exact: bool = False, q_block: Optional[int] = None,
                     page_table=None):
  """Single-query attention over a KV ring buffer: the serving decode
  step's core (sequence.py:554-708, dense ring).

  ``q`` (B, 1, H, D) is the current token's query; ``k``/``v`` are the
  (B, T, H, D) ring buffers with the current token's K/V already written;
  ``pos`` (B,) is each slot's absolute position. Key slot ``s`` takes part
  iff ``s <= pos[b]``, so every slot does once the ring has wrapped; the
  other slots contribute exactly zero whatever they hold.

  * ``impl='flash'``: ops/flash_attention.py ``flash_decode`` -- the
    hand-written decode kernels on a CUDA tensor, their plain masked
    softmax on a CPU tensor.
  * ``impl='tiled'``: the ``_block_update`` online softmax over
    ``block``-sized key blocks, masked per block. V is zeroed at the
    slots past ``pos`` first, so that a non-finite stale value there cannot
    reach the P V product (0 * NaN).
  * ``exact=True``: the oracle mode. q is scattered into a zero q tile of
    the ring's length T at row ``min(pos, T - 1)`` and run through the
    full-sequence program (``full_attention`` for flash,
    ``blockwise_attention`` for tiled) with the causal mask; that row is
    returned. Below the wrap this is the full forward's row; past it the
    causal mask at row T - 1 admits every slot, the fast path's windowed
    semantics.

  ``page_table`` switches to the paged KV layout (serving/decode.py paged
  caches): ``k``/``v`` are then page POOLS (P, page, H, D) shared by the
  slots, and ``page_table`` (B, pages_per_slot) int maps slot b's logical
  page j to a pool row; row 0 is the scratch page that unallocated entries
  name. The fast path, whatever ``impl``, is the dense ``tiled`` schedule
  with each block gathered from the pool and the block pinned to the page
  size (the JAX package's tiled gather, sequence.py:612-640: no flash
  kernel of either package has a block-table mode), so its inputs, block
  by block, are the values of a dense ring holding the same tokens, and
  its result is bitwise the dense tiled path's at ``block = page``.
  ``exact=True`` gathers the dense (B, T, H, D) view out of the pool and
  runs the dense oracle (a test mode: materialising the view is what
  paging avoids).
  """
  if impl not in ("tiled", "flash"):
    raise ValueError(f"impl must be 'tiled' or 'flash', got {impl!r}")
  b, tq, h, d = q.shape
  scale = flash_lib.default_scale(q) if scale is None else scale
  if page_table is not None:
    return _paged_decode_attention(q, k, v, pos, page_table, block, impl,
                                   scale, exact, q_block)
  t = k.shape[1]
  if exact:
    rows = torch.clamp(pos.long(), max=t - 1)
    batch = torch.arange(b, device=q.device)
    qfull = torch.zeros((b, t, h, d), dtype=q.dtype, device=q.device)
    qfull[batch, rows] = q[:, 0]
    if impl == "flash":
      out = full_attention(qfull, k, v, causal=True, scale=scale)
    else:
      blk = min(block or t, t)
      out = blockwise_attention(qfull, k, v, block_size=blk, causal=True,
                                scale=scale,
                                q_block_size=min(q_block or blk, t))
    return out[batch, rows][:, None]
  if impl == "flash":
    return flash_lib.flash_decode(q, k, v, pos, scale)
  blk = min(block or t, t)
  if t % blk != 0:
    raise ValueError(f"cache length {t} not divisible by block {blk}")
  admitted = flash_lib.decode_admitted(pos, t)
  v = torch.where(admitted[:, :, None, None], v,
                  torch.zeros((), dtype=v.dtype, device=v.device))
  acc_dtype = accum(q).dtype
  m = torch.full((b, h, tq), _NEG, dtype=acc_dtype, device=q.device)
  l = torch.zeros((b, h, tq), dtype=acc_dtype, device=q.device)
  o = torch.zeros((b, tq, h, d), dtype=acc_dtype, device=q.device)
  for k0 in range(0, t, blk):
    mask = admitted[:, None, None, k0:k0 + blk]
    m, l, o = _block_update(q, k[:, k0:k0 + blk], v[:, k0:k0 + blk], m, l, o,
                            scale, mask)
  return _finish(o, l, q.dtype)


def _paged_decode_attention(q, k, v, pos, page_table, block, impl, scale,
                            exact, q_block):
  """decode_attention over the (P, page, H, D) pools through the
  (B, pages_per_slot) page table."""
  b, tq, h, d = q.shape
  page = k.shape[1]
  pps = page_table.shape[1]
  table = page_table.long()
  if exact:
    kd = k[table].reshape(b, pps * page, h, d)
    vd = v[table].reshape(b, pps * page, h, d)
    return decode_attention(q, kd, vd, pos, block=block, impl=impl,
                            scale=scale, exact=True, q_block=q_block)
  acc_dtype = accum(q).dtype
  m = torch.full((b, h, tq), _NEG, dtype=acc_dtype, device=q.device)
  l = torch.zeros((b, h, tq), dtype=acc_dtype, device=q.device)
  o = torch.zeros((b, tq, h, d), dtype=acc_dtype, device=q.device)
  kpos = torch.arange(page, device=q.device)
  zero = torch.zeros((), dtype=v.dtype, device=v.device)
  for j in range(pps):
    ids = table[:, j]
    admitted = pos.long()[:, None] >= j * page + kpos[None, :]   # (B, page)
    # V zeroed past pos, as the dense tiled path does: a non-finite stale
    # value on a page (or the scratch page) cannot reach P V.
    vj = torch.where(admitted[:, :, None, None], v[ids], zero)
    m, l, o = _block_update(q, k[ids], vj, m, l, o, scale,
                            admitted[:, None, None, :])
  return _finish(o, l, q.dtype)
