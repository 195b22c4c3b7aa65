"""Flash attention: forward and backward as hand-written CUDA kernels.

The counterpart of the three ``pl.pallas_call``s of JAX's library TPU flash
attention (jax/experimental/pallas/ops/tpu/flash_attention.py), which the
JAX package reaches through parallel/sequence.py ``pallas_flash_attention``:

* ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``: wgmma, TMA
  loads of q, k and v through 4-D tensor maps) replaces
  ``_flash_attention_impl``;
* ``flash_attention_bwd_dkv`` (``csrc/flash_attention_bwd.cu``) replaces
  ``_flash_attention_bwd_dkv``;
* ``flash_attention_bwd_dq`` (the same source) replaces
  ``_flash_attention_bwd_dq``;
* ``flash_decode`` (``csrc/flash_decode.cu``: ``flash_decode_partial`` and
  ``flash_decode_combine``) replaces ``_flash_attention_impl`` in the
  decode mode that parallel/sequence.py ``decode_attention(impl='flash')``
  calls: one query row over a (B, T, H, D) KV ring, key slot s admitted
  iff s <= pos[b].

Layout: q, k, v are (B, L, H, D), the JAX package's layout at its public
attention functions. Mask: under ``causal`` query row r sees keys c <= r
(top-left aligned, also when Lq != Lk); with segment ids a query sees only
keys of its own segment (equality: padding id 0 attends padding). A masked
pair contributes exactly 0; a row with no admissible key (which neither
the causal diagonal nor equal q/kv segment ids can produce) gives o = 0
and lse = +inf.

Each wrapper computes its plain PyTorch version (below it) on a CPU tensor
and launches its kernel on a CUDA tensor or raises; there is no fallback
from one to the other. ``LAUNCHES`` counts kernel launches per wrapper.
``FlashAttention`` is the autograd Function: forward by the forward kernel
(saving lse), backward by the two backward kernels.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from kf_benchmarks_tpu_torch.ops import _build
from kf_benchmarks_tpu_torch.ops.conv_bn import accum

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd_dkv": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_decode_partial": 0,
                            "flash_decode_combine": 0}

# Head dims the kernels are instantiated for (the TPU kernel takes D <= 128;
# the LM runs 64).
KERNEL_HEAD_DIMS = (64, 128)
# Keys per tile of the forward kernel's online softmax
# (csrc/flash_attention.cuh BKV).
KEY_TILE = 64
# A split of the decode kernel takes a multiple of this many keys
# (csrc/flash_decode.cu SPLIT_ALIGN).
DECODE_SPLIT_ALIGN = 64


def reset_launches() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


def default_scale(q: torch.Tensor) -> float:
  return 1.0 / math.sqrt(q.shape[-1])


# -- plain versions ------------------------------------------------------------

def admissible(lq: int, lk: int, causal: bool,
               q_seg: Optional[torch.Tensor] = None,
               kv_seg: Optional[torch.Tensor] = None,
               device=None) -> Optional[torch.Tensor]:
  """Bool mask of admissible (query, key) pairs, broadcastable to
  (B, H, Lq, Lk), or None when every pair is admissible."""
  mask = None
  if causal:
    mask = (torch.arange(lq, device=device)[:, None] >=
            torch.arange(lk, device=device)[None, :])
  if q_seg is not None:
    seg = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    mask = seg if mask is None else (mask & seg)
  return mask


def _probabilities_base(q, k, causal, scale, q_seg, kv_seg):
  """(scale * Q K^T in the accumulation dtype, admissible mask)."""
  s = torch.einsum("bqhd,bkhd->bhqk", accum(q), accum(k)) * scale
  return s, admissible(q.shape[1], k.shape[1], causal, q_seg, kv_seg,
                       device=q.device)


def _exp_base(m):
  """The exponent base of a running max: 0 where no key was admissible."""
  return torch.where(m == -math.inf, torch.zeros_like(m), m)


def flash_attention_fwd_plain(q, k, v, causal: bool = False,
                              scale: Optional[float] = None, q_seg=None,
                              kv_seg=None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
  """(o, lse): the forward kernel's arithmetic in plain ops. Scores and
  the online softmax in the accumulation dtype (f32, f64 for f64 inputs)
  over the kernel's key tiles of KEY_TILE: P relative to the running max,
  rounded to v.dtype before the P V product, the sum l over the unrounded
  P. (Rounding P against the final max instead would differ from the
  kernel by up to 2^-8 of each term, more than an ulp of o where many keys
  cancel.)"""
  scale = default_scale(q) if scale is None else scale
  s_all, mask = _probabilities_base(q, k, causal, scale, q_seg, kv_seg)
  if mask is not None:
    s_all = s_all.masked_fill(~mask, -math.inf)
  b, lq, h, d = q.shape
  m = torch.full((b, h, lq), -math.inf, dtype=s_all.dtype, device=q.device)
  l = torch.zeros_like(m)
  acc = torch.zeros((b, h, lq, d), dtype=s_all.dtype, device=q.device)
  for k0 in range(0, k.shape[1], KEY_TILE):
    s = s_all[..., k0:k0 + KEY_TILE]
    m_new = torch.maximum(m, s.amax(-1))
    base = _exp_base(m_new)
    alpha = torch.exp(m - base)
    p = torch.exp(s - base[..., None])
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", accum(p.to(v.dtype)),
        accum(v[:, k0:k0 + KEY_TILE]))
    m = m_new
  inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
  o = (acc * inv[..., None]).transpose(1, 2)
  lse = torch.where(l > 0, _exp_base(m) + torch.log(l),
                    torch.full_like(l, math.inf))
  return o.to(q.dtype), lse


def _recompute(q, k, v, do, lse, di, causal, scale, q_seg, kv_seg):
  """(P, dS) of the backward, in the accumulation dtype."""
  s, mask = _probabilities_base(q, k, causal, scale, q_seg, kv_seg)
  p = torch.exp(s - accum(lse)[..., None])
  if mask is not None:
    p = torch.where(mask, p, torch.zeros_like(p))
  dp = torch.einsum("bqhd,bkhd->bhqk", accum(do), accum(v))
  ds = (dp - accum(di)[..., None]) * p * scale
  return p, ds


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal: bool = False,
                                  scale: Optional[float] = None, q_seg=None,
                                  kv_seg=None):
  """(dK, dV): dV = P^T dO with P rounded to dO's dtype, dK = dS^T Q with
  dS = scale * P * (dO V^T - di) rounded to q's dtype."""
  scale = default_scale(q) if scale is None else scale
  p, ds = _recompute(q, k, v, do, lse, di, causal, scale, q_seg, kv_seg)
  dv = torch.einsum("bhqk,bqhd->bkhd", accum(p.to(do.dtype)), accum(do))
  dk = torch.einsum("bhqk,bqhd->bkhd", accum(ds.to(q.dtype)), accum(q))
  return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal: bool = False,
                                 scale: Optional[float] = None, q_seg=None,
                                 kv_seg=None):
  """dQ = dS K with dS rounded to q's dtype."""
  scale = default_scale(q) if scale is None else scale
  _, ds = _recompute(q, k, v, do, lse, di, causal, scale, q_seg, kv_seg)
  dq = torch.einsum("bhqk,bkhd->bqhd", accum(ds.to(q.dtype)), accum(k))
  return dq.to(q.dtype)


# -- kernel wrappers -----------------------------------------------------------

def qkv_layout_error(label: str, shape, stride, data_ptr: int):
  """Why the kernels cannot read a (B, L, H, D) q, k or v of this shape,
  element strides and address, or None when they can: D contiguous and
  heads adjacent (the forward's tensor maps walk D, H, L, B), the
  position and batch strides and the base 16-byte aligned, and each
  stride below a tensor map's 2^40 bytes."""
  if len(shape) != 4:
    return f"want {label} (B, L, H, D), got {tuple(shape)}"
  d = shape[3]
  if stride[3] != 1 or stride[2] != d or stride[0] % 8 or stride[1] % 8 \
      or data_ptr % 16:
    return (f"{label} needs D contiguous, heads adjacent and 16-byte "
            f"aligned rows, got strides {tuple(stride)}")
  if max(stride[0], stride[1]) * 2 >= 2 ** 40:
    return f"{label} strides {tuple(stride)} exceed a tensor map's 2^40 bytes"
  return None


def _check_qkv(name: str, q, k, v, q_seg, kv_seg) -> None:
  if q.device.type != "cuda":
    raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, "
                     f"got {q.device}")
  for label, x in (("q", q), ("k", k), ("v", v)):
    if x.device != q.device:
      raise ValueError(f"{name}: q on {q.device}, {label} on {x.device}")
    if x.dtype != torch.bfloat16:
      raise ValueError(f"{name}: the CUDA kernel takes bf16 q, k, v, got "
                       f"{label} {x.dtype} (no f32 variant yet)")
    err = qkv_layout_error(label, x.shape, x.stride(), x.data_ptr())
    if err:
      raise ValueError(f"{name}: {err}")
  b, lq, h, d = q.shape
  if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
    raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                     f"v {tuple(v.shape)} disagree")
  if d not in KERNEL_HEAD_DIMS:
    raise ValueError(f"{name}: the kernel takes head dim in "
                     f"{KERNEL_HEAD_DIMS}, got {d}")
  if (q_seg is None) != (kv_seg is None):
    raise ValueError(f"{name}: pass both q and kv segment ids or neither")
  if q_seg is not None:
    for label, s, want in (("q_seg", q_seg, (b, lq)),
                           ("kv_seg", kv_seg, (b, k.shape[1]))):
      if s.dtype != torch.int32 or tuple(s.shape) != want or \
          not s.is_contiguous() or s.device != q.device:
        raise ValueError(f"{name}: {label} must be a contiguous int32 "
                         f"{want} tensor on {q.device}")


def _check_rows(name: str, label: str, x, shape, dtype, device) -> None:
  if tuple(x.shape) != tuple(shape) or x.dtype != dtype or \
      not x.is_contiguous() or x.device != device:
    raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                     f"{tuple(shape)} tensor on {device}")


def _raise_on_error(name: str, err: int) -> None:
  if err != 0:
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _seg_int32(seg):
  return None if seg is None else seg.to(torch.int32).contiguous()


def _tail(q, k, v, causal, scale):
  """Shape, strides, scale, causal flag and stream arguments."""
  b, lq, h, d = q.shape
  stream = torch.cuda.current_stream(q.device).cuda_stream
  return (b, h, lq, k.shape[1], d, q.stride(0), q.stride(1), k.stride(0),
          k.stride(1), v.stride(0), v.stride(1), float(scale), int(causal),
          stream)


def _ptr(x):
  return None if x is None else x.data_ptr()


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None, q_seg=None,
                        kv_seg=None) -> Tuple[torch.Tensor, torch.Tensor]:
  """(o (B, Lq, H, D), lse (B, H, Lq) f32) = softmax attention."""
  scale = default_scale(q) if scale is None else scale
  if q.device.type == "cpu":
    return flash_attention_fwd_plain(q, k, v, causal, scale, q_seg, kv_seg)
  q_seg, kv_seg = _seg_int32(q_seg), _seg_int32(kv_seg)
  _check_qkv("flash_attention_fwd", q, k, v, q_seg, kv_seg)
  if not scale > 0:
    # The kernel keeps the running max of the unscaled scores, which is
    # the max of the scaled ones only for a positive scale.
    raise ValueError(f"flash_attention_fwd: the kernel takes a positive "
                     f"scale, got {scale}")
  b, lq, h, d = q.shape
  lib = _build.load("flash_attention_fwd")
  with torch.cuda.device(q.device):
    o = torch.empty(b, lq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    err = lib.flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        o.data_ptr(), lse.data_ptr(), *_tail(q, k, v, causal, scale))
  _raise_on_error("flash_attention_fwd", err)
  LAUNCHES["flash_attention_fwd"] += 1
  return o, lse


def _check_bwd(name, q, k, v, do, lse, di, q_seg, kv_seg):
  _check_qkv(name, q, k, v, q_seg, kv_seg)
  b, lq, h, _ = q.shape
  _check_rows(name, "do", do, q.shape, q.dtype, q.device)
  _check_rows(name, "lse", lse, (b, h, lq), torch.float32, q.device)
  _check_rows(name, "di", di, (b, h, lq), torch.float32, q.device)


def flash_attention_bwd_dkv(q, k, v, do, lse, di, causal: bool = False,
                            scale: Optional[float] = None, q_seg=None,
                            kv_seg=None) -> Tuple[torch.Tensor, torch.Tensor]:
  """(dK, dV), each (B, Lk, H, D), from the forward's lse and
  di = rowsum(o * dO) (B, H, Lq) f32."""
  scale = default_scale(q) if scale is None else scale
  if q.device.type == "cpu":
    return flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal, scale,
                                         q_seg, kv_seg)
  q_seg, kv_seg = _seg_int32(q_seg), _seg_int32(kv_seg)
  _check_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, di, q_seg, kv_seg)
  lib = _build.load("flash_attention_bwd")
  with torch.cuda.device(q.device):
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    err = lib.flash_attention_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_tail(q, k, v, causal, scale))
  _raise_on_error("flash_attention_bwd_dkv", err)
  LAUNCHES["flash_attention_bwd_dkv"] += 1
  return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, causal: bool = False,
                           scale: Optional[float] = None, q_seg=None,
                           kv_seg=None) -> torch.Tensor:
  """dQ (B, Lq, H, D) from the forward's lse and di."""
  scale = default_scale(q) if scale is None else scale
  if q.device.type == "cpu":
    return flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal, scale,
                                        q_seg, kv_seg)
  q_seg, kv_seg = _seg_int32(q_seg), _seg_int32(kv_seg)
  _check_bwd("flash_attention_bwd_dq", q, k, v, do, lse, di, q_seg, kv_seg)
  lib = _build.load("flash_attention_bwd")
  with torch.cuda.device(q.device):
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = lib.flash_attention_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        *_tail(q, k, v, causal, scale))
  _raise_on_error("flash_attention_bwd_dq", err)
  LAUNCHES["flash_attention_bwd_dq"] += 1
  return dq


# -- autograd ------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
  """(q, k, v, causal, scale, q_seg, kv_seg) -> o, differentiable in q, k
  and v: the forward kernel saves lse, the backward runs the dK/dV and dQ
  kernels (the plain versions on the CPU)."""

  @staticmethod
  def forward(ctx, q, k, v, causal, scale, q_seg, kv_seg):
    o, lse = flash_attention_fwd(q, k, v, causal, scale, q_seg, kv_seg)
    ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
    ctx.causal, ctx.scale = causal, scale
    return o

  @staticmethod
  def backward(ctx, do):
    q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
    do = do.contiguous()
    # di = rowsum(o * dO), (B, H, Lq): one plain op, as the library takes it
    # in XLA outside its kernels.
    di = (accum(o) * accum(do)).sum(-1).transpose(1, 2).contiguous()
    args = (ctx.causal, ctx.scale, q_seg, kv_seg)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, *args)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, *args)
    return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, q_seg=None, kv_seg=None):
  """Differentiable attention over (B, L, H, D) through ``FlashAttention``."""
  scale = default_scale(q) if scale is None else scale
  return FlashAttention.apply(q, k, v, causal, scale, q_seg, kv_seg)


# -- decode: one query row over a KV ring --------------------------------------

def decode_admitted(pos: torch.Tensor, t: int) -> torch.Tensor:
  """(B, T) bool: key slot s takes part for row b iff s <= pos[b]."""
  return torch.arange(t, device=pos.device)[None, :] <= pos.long()[:, None]


def decode_splits(b: int, h: int, t: int, n_sm: int) -> int:
  """The decode kernel's split count S: B*H*S blocks cover the SMs twice
  where the ring allows, with at least DECODE_SPLIT_ALIGN keys a split."""
  want = -(-2 * n_sm // (b * h))
  return max(1, min(want, -(-t // DECODE_SPLIT_ALIGN)))


def decode_split_bounds(n: torch.Tensor, splits: int, s: int):
  """(k0, k1) per row: split s's keys of a row with n admitted keys (the
  kernel's split_range)."""
  align = DECODE_SPLIT_ALIGN
  per = align * torch.div(n + align * splits - 1, align * splits,
                          rounding_mode="floor")
  k0 = torch.minimum(n, s * per)
  return k0, torch.minimum(n, k0 + per)


def flash_decode_plain(q, k, v, pos, scale: Optional[float] = None):
  """o (B, 1, H, D): the masked softmax over the admitted slots in the
  accumulation dtype, rounded once to q's dtype. V is zeroed at the other
  slots before the P V product, so a non-finite stale value there cannot
  reach the result through 0 * NaN."""
  scale = default_scale(q) if scale is None else scale
  admitted = decode_admitted(pos, k.shape[1])
  s = torch.einsum("bqhd,bkhd->bhqk", accum(q), accum(k)) * scale
  s = s.masked_fill(~admitted[:, None, None, :], -math.inf)
  p = torch.softmax(s, dim=-1)
  vz = torch.where(admitted[:, :, None, None], accum(v),
                   torch.zeros((), dtype=accum(v).dtype, device=v.device))
  return torch.einsum("bhqk,bkhd->bqhd", p, vz).to(q.dtype)


def flash_decode_partial_plain(q, k, v, pos, scale: Optional[float] = None,
                               splits: int = 1):
  """(m, l (B, H, S), o (B, H, S, D)) in the accumulation dtype: per split
  of the admitted keys (``decode_split_bounds``), the max score, the sum of
  exp(score - m) and the unnormalised output; an empty split gives -inf, 0
  and 0."""
  scale = default_scale(q) if scale is None else scale
  t = k.shape[1]
  n = torch.clamp(pos.long() + 1, 0, t)
  kpos = torch.arange(t, device=q.device)
  sc = torch.einsum("bhd,bkhd->bhk", accum(q[:, 0]), accum(k)) * scale
  ms, ls, os_ = [], [], []
  for s_i in range(splits):
    k0, k1 = decode_split_bounds(n, splits, s_i)
    take = (kpos[None, :] >= k0[:, None]) & (kpos[None, :] < k1[:, None])
    masked = sc.masked_fill(~take[:, None, :], -math.inf)
    m = masked.amax(-1)
    p = torch.exp(masked - _exp_base(m)[..., None])
    vz = torch.where(take[:, :, None, None], accum(v),
                     torch.zeros((), dtype=sc.dtype, device=v.device))
    ms.append(m)
    ls.append(p.sum(-1))
    os_.append(torch.einsum("bhk,bkhd->bhd", p, vz))
  return (torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(os_, -2))


def flash_decode_combine_plain(m, l, o, dtype) -> torch.Tensor:
  """o (B, 1, H, D) in ``dtype``: the S partials merged against their max,
  divided by the merged sum (0 where no key was admitted)."""
  w = torch.exp(m - _exp_base(m.amax(-1))[..., None])
  lsum = (l * w).sum(-1)
  acc = (o * w[..., None]).sum(-2)
  inv = torch.where(lsum > 0, 1.0 / lsum, torch.zeros_like(lsum))
  return (acc * inv[..., None])[:, None].to(dtype)


def _check_decode(name: str, q, k, v, pos) -> None:
  if q.device.type != "cuda":
    raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, "
                     f"got {q.device}")
  if q.dim() != 4 or q.shape[1] != 1:
    raise ValueError(f"{name}: want q (B, 1, H, D), got {tuple(q.shape)}")
  b, _, h, d = q.shape
  if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or \
      k.shape[2:] != q.shape[2:]:
    raise ValueError(f"{name}: want k and v (B, T, H, D) = ({b}, T, {h}, "
                     f"{d}), got {tuple(k.shape)} and {tuple(v.shape)}")
  if d not in KERNEL_HEAD_DIMS:
    raise ValueError(f"{name}: the kernel takes head dim in "
                     f"{KERNEL_HEAD_DIMS}, got {d}")
  for label, x in (("q", q), ("k", k), ("v", v)):
    if x.device != q.device:
      raise ValueError(f"{name}: q on {q.device}, {label} on {x.device}")
    if x.dtype != torch.bfloat16:
      raise ValueError(f"{name}: the CUDA kernel takes bf16 q, k, v, got "
                       f"{label} {x.dtype} (no f32 variant yet)")
    # 16-byte loads: D contiguous, heads adjacent, strides and base aligned
    # to 8 elements.
    if x.stride(3) != 1 or x.stride(2) != d or x.stride(0) % 8 or \
        (label != "q" and x.stride(1) % 8) or x.data_ptr() % 16:
      raise ValueError(f"{name}: {label} needs D contiguous, heads adjacent "
                       f"and 16-byte aligned rows, got strides {x.stride()}")
  _check_rows(name, "pos", pos, (b,), torch.int32, q.device)


def flash_decode_partial(q, k, v, pos, scale: Optional[float] = None):
  """(m, l (B, H, S) f32, o (B, H, S, D) f32): the split partials of the
  decode attention, S = ``decode_splits`` of the card (one split on the
  CPU)."""
  scale = default_scale(q) if scale is None else scale
  if q.device.type == "cpu":
    return flash_decode_partial_plain(q, k, v, pos, scale)
  pos = pos.to(torch.int32).contiguous()
  _check_decode("flash_decode_partial", q, k, v, pos)
  b, _, h, d = q.shape
  t = k.shape[1]
  n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
  splits = decode_splits(b, h, t, n_sm)
  lib = _build.load("flash_decode")
  with torch.cuda.device(q.device):
    m = torch.empty(b, h, splits, dtype=torch.float32, device=q.device)
    l = torch.empty(b, h, splits, dtype=torch.float32, device=q.device)
    o = torch.empty(b, h, splits, d, dtype=torch.float32, device=q.device)
    err = lib.flash_decode_partial_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        m.data_ptr(), l.data_ptr(), o.data_ptr(), b, h, t, d, splits,
        q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
  _raise_on_error("flash_decode_partial", err)
  LAUNCHES["flash_decode_partial"] += 1
  return m, l, o


def flash_decode_combine(m, l, o, dtype=torch.bfloat16) -> torch.Tensor:
  """o (B, 1, H, D) in ``dtype`` from ``flash_decode_partial``'s partials."""
  if m.device.type == "cpu":
    return flash_decode_combine_plain(m, l, o, dtype)
  name = "flash_decode_combine"
  if m.device.type != "cuda":
    raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, "
                     f"got {m.device}")
  if dtype != torch.bfloat16:
    raise ValueError(f"{name}: the CUDA kernel writes bf16, got {dtype}")
  b, h, splits = m.shape
  d = o.shape[-1]
  if d not in KERNEL_HEAD_DIMS:
    raise ValueError(f"{name}: the kernel takes head dim in "
                     f"{KERNEL_HEAD_DIMS}, got {d}")
  _check_rows(name, "m", m, (b, h, splits), torch.float32, m.device)
  _check_rows(name, "l", l, (b, h, splits), torch.float32, m.device)
  _check_rows(name, "o", o, (b, h, splits, d), torch.float32, m.device)
  lib = _build.load("flash_decode")
  with torch.cuda.device(m.device):
    out = torch.empty(b, 1, h, d, dtype=dtype, device=m.device)
    err = lib.flash_decode_combine_bf16(
        m.data_ptr(), l.data_ptr(), o.data_ptr(), out.data_ptr(), b, h, d,
        splits, torch.cuda.current_stream(m.device).cuda_stream)
  _raise_on_error(name, err)
  LAUNCHES[name] += 1
  return out


def flash_decode(q, k, v, pos, scale: Optional[float] = None) -> torch.Tensor:
  """Decode attention o (B, 1, H, D) of q (B, 1, H, D) over the ring
  k, v (B, T, H, D): key slot s takes part iff s <= pos[b]. On a CUDA tensor
  the two kernels (split partials, then their merge); on a CPU tensor
  ``flash_decode_plain``."""
  scale = default_scale(q) if scale is None else scale
  if q.device.type == "cpu":
    return flash_decode_plain(q, k, v, pos, scale)
  m, l, o = flash_decode_partial(q, k, v, pos, scale)
  return flash_decode_combine(m, l, o, q.dtype)
