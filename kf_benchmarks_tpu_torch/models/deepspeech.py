"""DeepSpeech2 (speech recognition): the port's counterpart of
kf_benchmarks_tpu/models/deepspeech.py.

The network (``DeepSpeech2Net``): the spectrogram (batch, time, 161, 1)
through two convolutions of 32 filters without bias, each after an explicit
zero pad and followed by batch norm and ReLU ((41, 11) stride (2, 2) pad
(20, 5), then (21, 11) stride (2, 1) pad (10, 5)); the result read as
(batch, time, frequency x channels) in NHWC order; five bidirectional RNN
layers of 800 (LSTM by default, or GRU or tanh RNN), every one but the
first after a batch norm; a batch norm; a dense layer to the 29 characters,
returned in f32. The batch norms of the sequence reduce over batch and
time, the padding frames included, as flax's do.

The layers carry flax's names (``Conv_0``, ``Conv_1``, ``BatchNorm_0``..
``BatchNorm_6``, the cells ``OptimizedLSTMCell_<2l>`` forward and
``_<2l+1>`` backward of layer l, or ``GRUCell_*`` / ``SimpleCell_*``,
``Dense_0``) and each cell keeps flax's per-gate dense layers (LSTM input
kernels ``ii if ig io`` without bias, hidden ``hi hf hg ho`` with bias;
GRU ``ir iz in`` with bias, ``hr hz`` without, ``hn`` with; the simple
cell ``i`` with bias, ``h`` without), so convert.py maps the flax tree one
leaf to one parameter.

The recurrence is cuDNN's (``torch.lstm`` / ``torch.gru`` /
``torch.rnn_tanh``, one bidirectional call a layer, over the whole padded
sequence: flax's ``nn.RNN`` gets no sequence lengths, so its backward
direction reads the padding frames too) from a zero carry. Its weights are
the cell's gate kernels concatenated in torch's gate order (LSTM i f g o,
GRU r z n: flax's own) and its biases the ones flax has, with constant
zeros where flax has none (the LSTM's input bias, the GRU's hidden r and z,
the simple cell's hidden), so no parameter trains that the JAX tree lacks.

The recurrence computes in the compute dtype, as flax's cells do (bf16
under --use_fp16, the carry included): cuDNN's RNN takes bf16 on the H100
(its bf16 cell kernels show in the profile, phase speech of chip_smoke.py
checks it), although ``torch.backends.cudnn.is_acceptable`` names only
half, float and double. torch hands cuDNN the layer's weights as separate
tensors, so cuDNN packs them into its own buffer at each call (a copy of
the layer's weights; PyTorch's warning about it is silenced here).

No hand-written kernel of the port runs on this path: the convolutions,
the RNNs and the dense layer are cuDNN's and cuBLAS's, and the CTC loss
(ops/ctc.py) is optax's recursion in torch.
"""

from __future__ import annotations

import itertools
import math
import warnings
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model as model_lib
from kf_benchmarks_tpu_torch.ops import ctc

SPEECH_LABELS = " abcdefghijklmnopqrstuvwxyz'-"
BLANK_INDEX = 28
# flax's lecun_normal: a normal of variance 1 / fan_in cut at two standard
# deviations, its scale corrected for the cut.
_TRUNC_CORRECTION = 0.87962566103423978
# Filters of both convs (deepspeech.py:103 of the JAX package).
_CONV_FILTERS = 32


class DeepSpeechDecoder:
  """Greedy CTC decoder with WER and CER (deepspeech.py:36-79 of the JAX
  package)."""

  def __init__(self, labels: str = SPEECH_LABELS,
               blank_index: int = BLANK_INDEX):
    self.labels = labels
    self.blank_index = blank_index
    self.int_to_char = dict(enumerate(labels))

  def convert_to_string(self, sequence) -> str:
    return "".join(self.int_to_char[int(i)] for i in sequence)

  def decode(self, char_indexes) -> str:
    """Labels -> transcript (padding and blanks dropped)."""
    return self.convert_to_string(
        [i for i in np.asarray(char_indexes).ravel()
         if 0 <= int(i) < len(self.labels) and int(i) != self.blank_index])

  def decode_logits(self, probs) -> str:
    """The greedy path: argmax a frame, repeats collapsed, blanks
    dropped."""
    best = np.argmax(np.asarray(probs), axis=-1)
    merged = [k for k, _ in itertools.groupby(best)]
    return self.convert_to_string(
        [k for k in merged if int(k) != self.blank_index])

  @staticmethod
  def _levenshtein(a, b) -> int:
    if len(a) < len(b):
      a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
      curr = [i]
      for j, cb in enumerate(b, 1):
        curr.append(min(prev[j] + 1, curr[j - 1] + 1,
                        prev[j - 1] + (ca != cb)))
      prev = curr
    return prev[-1]

  def wer(self, decode: str, target: str) -> float:
    return float(self._levenshtein(decode.split(), target.split()))

  def cer(self, decode: str, target: str) -> float:
    return float(self._levenshtein(list(decode), list(target)))


def postprocess(results: Dict) -> Dict:
  """WER and CER over accumulated ``deepspeech2_prob`` (n, frames, 29) and
  ``deepspeech2_label`` (n, labels) numpy arrays (the JAX package's
  ``DeepSpeech2Model.postprocess``); ``results`` as it is without them."""
  if "deepspeech2_prob" not in results:
    return results
  decoder = DeepSpeechDecoder()
  probs = np.asarray(results["deepspeech2_prob"])
  targets = np.asarray(results["deepspeech2_label"])
  total_wer = total_cer = 0.0
  n = probs.shape[0]
  for i in range(n):
    predicted = decoder.decode_logits(probs[i])
    expected = decoder.decode(targets[i])
    total_cer += decoder.cer(predicted, expected) / max(len(expected), 1)
    total_wer += decoder.wer(predicted, expected) / max(
        len(expected.split()), 1)
  results["CER"] = total_cer / max(n, 1)
  results["WER"] = total_wer / max(n, 1)
  return results


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
  std = math.sqrt(1.0 / fan_in) / _TRUNC_CORRECTION
  nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
  """A flax ``nn.Dense``: ``weight`` (out, in) (the kernel transposed), an
  optional ``bias``; lecun-normal kernel, zero bias (or an orthogonal
  kernel: flax's recurrent kernels)."""

  def __init__(self, cin: int, cout: int, bias: bool, generator=None,
               orthogonal: bool = False):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(cout, cin))
    self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
    with torch.no_grad():
      if orthogonal:
        nn.init.orthogonal_(self.weight, generator=generator)
      else:
        _lecun_normal_(self.weight, cin, generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, self.weight.to(x.dtype),
                    None if self.bias is None else self.bias.to(x.dtype))


# Per cell kind: flax's input and hidden gate layers in torch's gate order,
# and which of them carry a bias.
_GATES = {
    "lstm": (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"),
             False, (True, True, True, True)),
    "gru": (("ir", "iz", "in"), ("hr", "hz", "hn"),
            True, (False, False, True)),
    "rnn": (("i",), ("h",), True, (False,)),
}
_CELL_NAMES = {"lstm": "OptimizedLSTMCell", "gru": "GRUCell",
               "rnn": "SimpleCell"}
_RNN_FNS = {"lstm": torch.lstm, "gru": torch.gru, "rnn": torch.rnn_tanh}


class RNNCell(nn.Module):
  """One direction's cell with flax's per-gate dense layers."""

  def __init__(self, kind: str, cin: int, hidden: int, generator=None):
    super().__init__()
    self.hidden = hidden
    inputs, hiddens, input_bias, hidden_bias = _GATES[kind]
    self.input_gates, self.hidden_gates = inputs, hiddens
    for name in inputs:
      self.add_module(name, Dense(cin, hidden, input_bias, generator))
    for name, bias in zip(hiddens, hidden_bias):
      self.add_module(name, Dense(hidden, hidden, bias, generator,
                                  orthogonal=True))

  def flat_weights(self, dtype: torch.dtype) -> List[torch.Tensor]:
    """(w_ih, w_hh, b_ih, b_hh) in torch's layout and gate order, in
    ``dtype``; zeros where flax has no bias."""
    def cat(names, attr):
      parts = []
      for name in names:
        layer = getattr(self, name)
        t = getattr(layer, attr)
        parts.append(t.to(dtype) if t is not None else
                     layer.weight.new_zeros(self.hidden, dtype=dtype))
      return torch.cat(parts)
    return [cat(self.input_gates, "weight"), cat(self.hidden_gates, "weight"),
            cat(self.input_gates, "bias"), cat(self.hidden_gates, "bias")]


class DeepSpeech2Net(nn.Module):
  """spectrogram (batch, time, bins, 1) -> f32 logits (batch, time', nclass)
  (deepspeech.py:81-151 of the JAX package)."""

  # convert.py: the cells' gate layers nest one level in the flax tree.
  flax_nested = True

  def __init__(self, nclass: int, dtype: torch.dtype = torch.float32,
               num_rnn_layers: int = 5, rnn_type: str = "lstm",
               is_bidirectional: bool = True, rnn_hidden_size: int = 800,
               use_bias: bool = True, num_feature_bins: int = 161,
               generator=None):
    super().__init__()
    if rnn_type not in _GATES:
      raise ValueError(f"Unsupported rnn type {rnn_type!r}")
    self.dtype = dtype
    self.rnn_type = rnn_type
    self.num_rnn_layers = num_rnn_layers
    self.is_bidirectional = is_bidirectional
    self.hidden = rnn_hidden_size
    g = generator
    self.convs = (((41, 11), (2, 2), (20, 5)), ((21, 11), (2, 1), (10, 5)))
    bins = num_feature_bins
    cin = 1
    for i, (k, s, p) in enumerate(self.convs):
      weight = torch.empty(_CONV_FILTERS, cin, *k)
      _lecun_normal_(weight, cin * k[0] * k[1], g)
      self.add_module(f"Conv_{i}", _ConvWeight(weight))
      self.add_module(f"BatchNorm_{i}", self._bn(_CONV_FILTERS))
      bins = (bins + 2 * p[1] - k[1]) // s[1] + 1
      cin = _CONV_FILTERS
    width = bins * _CONV_FILTERS
    dirs = 2 if is_bidirectional else 1
    cell_name = _CELL_NAMES[rnn_type]
    self.layers = []
    for layer in range(num_rnn_layers):
      bn = None
      if layer:
        bn = f"BatchNorm_{len(self.convs) + layer - 1}"
        self.add_module(bn, self._bn(width, features_last=True))
      cells = [f"{cell_name}_{dirs * layer + d}" for d in range(dirs)]
      for name in cells:
        self.add_module(name, RNNCell(rnn_type, width, rnn_hidden_size, g))
      self.layers.append((bn, cells))
      width = dirs * rnn_hidden_size
    self.final_bn = f"BatchNorm_{len(self.convs) + num_rnn_layers - 1}"
    self.add_module(self.final_bn, self._bn(width, features_last=True))
    self.Dense_0 = Dense(width, nclass, use_bias, g)

  @staticmethod
  def _bn(features: int, features_last: bool = False):
    return builder.CompactBatchNorm(features, momentum=0.997, epsilon=1e-5,
                                    use_scale=True,
                                    features_last=features_last)

  def _rnn_layer(self, x: torch.Tensor, cells: List[str]) -> torch.Tensor:
    """One (bi)directional layer over the whole padded sequence from a
    zero carry."""
    weights = [w for name in cells
               for w in getattr(self, name).flat_weights(x.dtype)]
    h0 = x.new_zeros(len(cells), x.shape[0], self.hidden)
    hx = (h0, h0) if self.rnn_type == "lstm" else h0
    with warnings.catch_warnings():
      warnings.filterwarnings("ignore", message="RNN module weights")
      return _RNN_FNS[self.rnn_type](
          x, hx, weights, True, 1, 0.0, self.training,
          self.is_bidirectional, True)[0]

  def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
    x = model_lib.to_model_input(spectrogram, self.dtype)
    for i, (_, stride, pad) in enumerate(self.convs):
      w = getattr(self, f"Conv_{i}").weight.to(
          x.dtype, memory_format=torch.channels_last)
      x = F.conv2d(x, w, None, stride=stride, padding=pad)
      x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
    x = builder.nhwc(x)
    b, t, f, c = x.shape
    x = x.reshape(b, t, f * c)
    for bn, cells in self.layers:
      if bn is not None:
        x = getattr(self, bn)(x)
      x = self._rnn_layer(x, cells)
    x = getattr(self, self.final_bn)(x)
    return self.Dense_0(x).float()


class _ConvWeight(nn.Module):
  """A flax ``nn.Conv`` without bias: ``weight`` OIHW."""

  def __init__(self, weight: torch.Tensor):
    super().__init__()
    self.weight = nn.Parameter(weight)


class DeepSpeech2Model(model_lib.Model):
  """(deepspeech.py:154-261 of the JAX package)"""

  data_name = "librispeech"

  def __init__(self, num_rnn_layers=5, rnn_type="lstm",
               is_bidirectional=True, rnn_hidden_size=800, use_bias=True,
               params=None):
    super().__init__("deepspeech2", batch_size=128, learning_rate=0.0005,
                     params=params)
    self.num_rnn_layers = num_rnn_layers
    self.rnn_type = rnn_type
    self.is_bidirectional = is_bidirectional
    self.rnn_hidden_size = rnn_hidden_size
    self.use_bias = use_bias
    self.num_feature_bins = 161
    self.max_time_steps = 3494
    self.max_label_length = 576

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    return DeepSpeech2Net(
        nclass, dtype, num_rnn_layers=self.num_rnn_layers,
        rnn_type=self.rnn_type, is_bidirectional=self.is_bidirectional,
        rnn_hidden_size=self.rnn_hidden_size, use_bias=self.use_bias,
        num_feature_bins=self.num_feature_bins, generator=generator)

  def get_input_shapes(self, subset):
    del subset
    n = self.get_batch_size()
    return [[n, self.max_time_steps, self.num_feature_bins, 1],
            [n, self.max_label_length], [n], [n]]

  def get_synthetic_inputs(self, generator: torch.Generator, nclass: int,
                           device: torch.device):
    """A uniform [0, 1) spectrogram, uniform labels below the blank, and
    full input and label lengths (deepspeech.py:184-193), made on
    ``device`` from ``generator``."""
    del nclass
    shapes = self.get_input_shapes("train")
    spectrogram = torch.rand(shapes[0], generator=generator, device=device)
    labels = torch.randint(0, BLANK_INDEX, shapes[1], generator=generator,
                           device=device)
    input_lengths = torch.full(shapes[2], self.max_time_steps,
                               dtype=torch.int64, device=device)
    label_lengths = torch.full(shapes[3], self.max_label_length,
                               dtype=torch.int64, device=device)
    return spectrogram, (labels, input_lengths, label_lengths)

  def loss_function(self, logits, labels) -> torch.Tensor:
    """The batch mean of optax's CTC loss (deepspeech.py:197-229): each
    utterance's length scaled onto the CTC frames (f32, floored), the
    frames and labels beyond the lengths padding."""
    target_labels, input_lengths, label_lengths = labels
    ctc_time_steps = logits.shape[1]
    ctc_input_length = torch.floor(
        input_lengths.to(torch.float32) * ctc_time_steps /
        float(self.max_time_steps)).to(torch.int64)
    frame_idx = torch.arange(ctc_time_steps, device=logits.device)[None, :]
    logit_paddings = (frame_idx >= ctc_input_length[:, None]).to(
        torch.float32)
    label_idx = torch.arange(target_labels.shape[1],
                             device=logits.device)[None, :]
    label_paddings = (label_idx >= label_lengths[:, None]).to(torch.float32)
    losses = ctc.ctc_loss(logits, logit_paddings, target_labels,
                          label_paddings, blank_id=BLANK_INDEX)
    return torch.mean(losses)

  def accuracy_function(self, logits, labels) -> Dict[str, torch.Tensor]:
    """The share of frames whose greedy symbol is not the blank as top-1,
    0 as top-5 (deepspeech.py:233-245; the scalars of the shared loop)."""
    del labels
    pred = torch.argmax(torch.softmax(logits, dim=-1), dim=-1)
    top1 = (pred != BLANK_INDEX).float().mean()
    return {"top_1_accuracy": top1, "top_5_accuracy": torch.zeros_like(top1)}

  def postprocess(self, results: Dict) -> Dict:
    return postprocess(results)


def create_deepspeech2_model(params=None):
  return DeepSpeech2Model(params=params)
