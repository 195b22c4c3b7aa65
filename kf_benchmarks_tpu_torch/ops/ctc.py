"""The CTC loss of the JAX package's DeepSpeech2: optax's ``ctc_loss``.

``ctc_loss`` is ``optax.ctc_loss(logits, logit_paddings, labels,
label_paddings, blank_id)`` written out in torch: the log-softmax inside,
then the forward (alpha) recursion of optax's
``ctc_loss_with_forward_probs`` over every padded CTC frame, with optax's
default ``log_epsilon`` (-1e5) standing for log 0 and padded frames
carrying the previous frame's scores.

Why not ``F.ctc_loss``: on a row whose labels cannot be aligned in its
frames (labels plus adjacent repeats exceed the frames) it gives inf, or 0
under ``zero_infinity``, where optax's log-epsilon path gives a large
finite value and a gradient. The JAX package's DeepSpeech2 meets such rows
on generated LibriSpeech records (a short utterance padded to 3494 frames
keeps 10-30 of the 874 CTC frames for 5-30 labels), so the port gives
optax's values there.

The recursion is a ``torch.autograd.Function`` whose backward is written
out: the reverse pass over the frames, from the scores and intermediates
of every frame that the forward kept (five [T, B, N] tensors beside the
scores: ~1.3 GB at batch 128, 874 frames, 576 labels, against a dozen
more kernels a frame to recompute them), with the derivative of
``logaddexp(a, b)`` as ``exp(a - out)`` and ``exp(b - out)`` (jax's, which
optax's gradient is). Written out, a frame is a dozen small kernels in
the forward and two dozen in the backward, and no autograd node; the label scores are gathered and their gradients scattered by a
one-hot product (optax's einsum), which sums in a fixed order, so the
gradient is the same bitwise from run to run. Nothing reads the device
from the host, so a captured step runs it as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5


def _frame(phi, emit, lp_emit, lp_phi, emit_to_phi, phi_penalty, pad,
           out):
  """One frame of optax's loop_body, in its order of operations, into the
  views ``out``: (phi after the epsilon transition, the unpadded new emit
  scores, the blank scores before and after the blank's emit-to-phi
  transition, that transition's scores, the next phi, the next emit)."""
  prev, new_emit, q0, q, blank, phi_out, emit_out = out
  # emit-to-phi epsilon transition, except before a repeated label
  prev[:, :1].copy_(phi[:, :1])
  torch.logaddexp(phi[:, 1:], emit + emit_to_phi, out=prev[:, 1:])
  # phi-to-emit and the emit self-loop
  torch.logaddexp(prev[:, :-1] + lp_emit, emit + lp_emit, out=new_emit)
  # the blank self-loop, and emit-to-phi through a blank only before a
  # repeated label
  torch.add(prev, lp_phi, out=q0)
  torch.add(emit + lp_phi, phi_penalty, out=blank)
  q[:, :1].copy_(q0[:, :1])
  torch.logaddexp(q0[:, 1:], blank, out=q[:, 1:])
  torch.where(pad, emit, new_emit, out=emit_out)
  torch.where(pad, phi, q, out=phi_out)


class _CTC(torch.autograd.Function):

  @staticmethod
  def forward(ctx, logits, pads, labels, labellens, blank_id, log_epsilon):
    b, t_max, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    one_hot = F.one_hot(labels, k).to(logprobs.dtype)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype),
                   (0, 1))
    emit_to_phi = log_epsilon * repeat
    phi_penalty = log_epsilon * (1.0 - repeat)
    # [T, B, N] label scores and [T, B, 1] blank scores.
    lp_emit = torch.einsum("btk,bnk->tbn", logprobs, one_hot).contiguous()
    lp_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)
    phis = logits.new_full((t_max + 1, b, n + 1), log_epsilon)
    phis[0, :, 0] = 0.0
    emits = logits.new_full((t_max + 1, b, n), log_epsilon)
    # Every frame's intermediates, for the backward.
    prevs, q0s, qs = (logits.new_empty((t_max, b, n + 1)) for _ in range(3))
    new_emits, blanks = (logits.new_empty((t_max, b, n)) for _ in range(2))
    for t in range(t_max):
      _frame(phis[t], emits[t], lp_emit[t], lp_phi[t], emit_to_phi,
             phi_penalty, pads[t], (prevs[t], new_emits[t], q0s[t], qs[t],
                                    blanks[t], phis[t + 1], emits[t + 1]))
    # The last epsilon transition, then the score at each row's label count.
    last = phis[t_max].clone()
    torch.logaddexp(phis[t_max, :, 1:], emits[t_max], out=last[:, 1:])
    ctx.save_for_backward(logprobs, one_hot, lp_emit, emit_to_phi, pads,
                          phis, emits, prevs, new_emits, q0s, qs, blanks,
                          last, labellens)
    ctx.blank_id = blank_id
    return -torch.gather(last, 1, labellens.unsqueeze(1)).squeeze(1)

  @staticmethod
  def backward(ctx, g_loss):
    (logprobs, one_hot, lp_emit, emit_to_phi, pads, phis, emits, prevs,
     new_emits, q0s, qs, blanks, last, labellens) = ctx.saved_tensors
    t_max = lp_emit.shape[0]
    g_last = torch.zeros_like(last).scatter_(
        1, labellens.unsqueeze(1), -g_loss.unsqueeze(1))
    g_phi = g_last.clone()
    g_phi[:, 1:] *= torch.exp(phis[t_max, :, 1:] - last[:, 1:])
    g_emit = g_last[:, 1:] * torch.exp(emits[t_max] - last[:, 1:])
    g_lp_emit = torch.empty_like(lp_emit)
    g_lp_phi = lp_emit.new_empty((t_max, last.shape[0], 1))
    zero = g_phi.new_zeros(())
    for t in range(t_max - 1, -1, -1):
      phi, emit, pad, prev, new_emit, q0, q = (
          phis[t], emits[t], pads[t], prevs[t], new_emits[t], q0s[t], qs[t])
      # The padded frame's select.
      g_q = torch.where(pad, zero, g_phi)
      g_new_emit = torch.where(pad, zero, g_emit)
      g_phi = torch.where(pad, g_phi, zero)
      g_emit = torch.where(pad, g_emit, zero)
      # q[:, 1:] = logaddexp(q0[:, 1:], emit + lp_phi + phi_penalty)
      g_q0 = g_q.clone()
      g_q0[:, 1:] *= torch.exp(q0[:, 1:] - q[:, 1:])
      g_blank = g_q[:, 1:] * torch.exp(blanks[t] - q[:, 1:])
      g_emit += g_blank
      # q0 = prev + lp_phi
      g_lp_phi[t] = (g_q0.sum(1) + g_blank.sum(1)).unsqueeze(1)
      # new_emit = logaddexp(prev[:, :-1] + lp_emit, emit + lp_emit)
      g_prev = g_q0
      w_phi = torch.exp(prev[:, :-1] + lp_emit[t] - new_emit)
      w_emit = torch.exp(emit + lp_emit[t] - new_emit)
      g_prev[:, :-1] += g_new_emit * w_phi
      g_emit += g_new_emit * w_emit
      g_lp_emit[t] = g_new_emit * (w_phi + w_emit)
      # prev[:, 1:] = logaddexp(phi[:, 1:], emit + emit_to_phi)
      g_phi[:, :1] += g_prev[:, :1]
      g_phi[:, 1:] += g_prev[:, 1:] * torch.exp(phi[:, 1:] - prev[:, 1:])
      g_emit += g_prev[:, 1:] * torch.exp(emit + emit_to_phi - prev[:, 1:])
    g_logprobs = torch.einsum("tbn,bnk->btk", g_lp_emit, one_hot)
    g_logprobs[:, :, ctx.blank_id] += g_lp_phi.squeeze(2).transpose(0, 1)
    g_logits = g_logprobs - torch.exp(logprobs) * g_logprobs.sum(
        -1, keepdim=True)
    return g_logits, None, None, None, None, None


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
  """Per-sequence CTC negative log-likelihood, (B,).

  ``logits`` (B, T, K); ``logit_paddings`` (B, T) and ``label_paddings``
  (B, N) hold 1.0 at padding (labels right-padded); ``labels`` (B, N)
  integer classes."""
  n = labels.shape[1]
  pads = (logit_paddings.transpose(0, 1) != 0).unsqueeze(-1)  # [T, B, 1]
  labellens = n - label_paddings.sum(1).long()
  return _CTC.apply(logits, pads, labels.long(), labellens, blank_id,
                    LOG_EPSILON)
