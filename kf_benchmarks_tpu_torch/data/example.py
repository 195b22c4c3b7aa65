"""Minimal tf.train.Example wire-format codec (no TensorFlow/protobuf dep):
the port's own copy of the JAX package's data/example.py.

The reference parses ImageNet Example protos with
``tf.parse_single_example`` (ref: scripts/tf_cnn_benchmarks/
preprocessing.py:27-81). This is a hand-rolled encoder/decoder for the
small, stable subset of protobuf wire format those protos use:

    Example      { Features features = 1; }
    Features     { map<string, Feature> feature = 1; }
    Feature      { oneof { BytesList bytes_list = 1;
                           FloatList float_list = 2;
                           Int64List int64_list = 3; } }
    BytesList    { repeated bytes value = 1; }
    FloatList    { repeated float value = 1 [packed]; }
    Int64List    { repeated int64 value = 1 [packed]; }

Decoded form: dict[str, list[bytes] | np.ndarray(float32) | np.ndarray(int64)].
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Union

import numpy as np

FeatureValue = Union[List[bytes], np.ndarray]


# -- varint ------------------------------------------------------------------

def _write_varint(out: bytearray, value: int) -> None:
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return


def _read_varint(buf: bytes, pos: int):
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _read_len_delimited(buf: bytes, pos: int):
  length, pos = _read_varint(buf, pos)
  return buf[pos:pos + length], pos + length


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
  if wire_type == 0:
    _, pos = _read_varint(buf, pos)
  elif wire_type == 1:
    pos += 8
  elif wire_type == 2:
    length, pos = _read_varint(buf, pos)
    pos += length
  elif wire_type == 5:
    pos += 4
  else:
    raise ValueError(f"Unsupported wire type {wire_type}")
  return pos


# -- decode ------------------------------------------------------------------

def _parse_list(buf: bytes, kind: int) -> FeatureValue:
  """kind: 1=bytes_list, 2=float_list, 3=int64_list."""
  pos = 0
  if kind == 1:
    values: List[bytes] = []
    while pos < len(buf):
      tag, pos = _read_varint(buf, pos)
      if tag == (1 << 3) | 2:
        v, pos = _read_len_delimited(buf, pos)
        values.append(bytes(v))
      else:
        pos = _skip_field(buf, pos, tag & 7)
    return values
  floats: List[float] = []
  ints: List[int] = []
  while pos < len(buf):
    tag, pos = _read_varint(buf, pos)
    field, wt = tag >> 3, tag & 7
    if field != 1:
      pos = _skip_field(buf, pos, wt)
    elif kind == 2:  # float_list: packed (wt=2) or unpacked (wt=5)
      if wt == 2:
        packed, pos = _read_len_delimited(buf, pos)
        floats.extend(np.frombuffer(packed, dtype="<f4").tolist())
      else:
        floats.append(struct.unpack_from("<f", buf, pos)[0])
        pos += 4
    else:  # int64_list: packed (wt=2) or unpacked (wt=0)
      if wt == 2:
        packed, pos = _read_len_delimited(buf, pos)
        p2 = 0
        while p2 < len(packed):
          v, p2 = _read_varint(packed, p2)
          ints.append(v - (1 << 64) if v >= (1 << 63) else v)
      else:
        v, pos = _read_varint(buf, pos)
        ints.append(v - (1 << 64) if v >= (1 << 63) else v)
  if kind == 2:
    return np.asarray(floats, dtype=np.float32)
  return np.asarray(ints, dtype=np.int64)


def _parse_feature(buf: bytes) -> FeatureValue:
  pos = 0
  while pos < len(buf):
    tag, pos = _read_varint(buf, pos)
    field, wt = tag >> 3, tag & 7
    if wt == 2 and field in (1, 2, 3):
      inner, pos = _read_len_delimited(buf, pos)
      return _parse_list(inner, field)
    pos = _skip_field(buf, pos, wt)
  return []


def _parse_map_entries(buf: bytes):
  """Iterate (key, value_buf) of a map<string, Message> field -- map
  entries are repeated messages { key = 1; value = 2; }."""
  pos = 0
  while pos < len(buf):
    tag, pos = _read_varint(buf, pos)
    if tag == (1 << 3) | 2:
      entry, pos = _read_len_delimited(buf, pos)
      key = None
      value_buf = b""
      p2 = 0
      while p2 < len(entry):
        t2, p2 = _read_varint(entry, p2)
        if t2 == (1 << 3) | 2:
          k, p2 = _read_len_delimited(entry, p2)
          key = k.decode("utf-8")
        elif t2 == (2 << 3) | 2:
          value_buf, p2 = _read_len_delimited(entry, p2)
        else:
          p2 = _skip_field(entry, p2, t2 & 7)
      if key is not None:
        yield key, value_buf
    else:
      pos = _skip_field(buf, pos, tag & 7)


def _parse_features(feats_buf: bytes) -> Dict[str, FeatureValue]:
  """Features { map<string, Feature> feature = 1 }."""
  return {key: _parse_feature(value_buf)
          for key, value_buf in _parse_map_entries(feats_buf)}


def parse_example(record: bytes) -> Dict[str, FeatureValue]:
  """Decode a serialized Example into {feature_name: value}."""
  pos = 0
  # Example { features = 1 }
  feats_buf = b""
  while pos < len(record):
    tag, pos = _read_varint(record, pos)
    if tag == (1 << 3) | 2:
      feats_buf, pos = _read_len_delimited(record, pos)
    else:
      pos = _skip_field(record, pos, tag & 7)
  return _parse_features(feats_buf)


def parse_sequence_example(record: bytes):
  """Decode a serialized SequenceExample into (context, feature_lists).

  SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }
  FeatureLists    { map<string, FeatureList> feature_list = 1; }
  FeatureList     { repeated Feature feature = 1; }

  The reference parses these with ``tf.io.parse_single_sequence_example``
  (ref: preprocessing.py:1081-1101 LibrispeechPreprocessor). Returns
  (dict[str, FeatureValue], dict[str, list[FeatureValue]]).
  """
  pos = 0
  context_buf = b""
  lists_buf = b""
  while pos < len(record):
    tag, pos = _read_varint(record, pos)
    if tag == (1 << 3) | 2:
      context_buf, pos = _read_len_delimited(record, pos)
    elif tag == (2 << 3) | 2:
      lists_buf, pos = _read_len_delimited(record, pos)
    else:
      pos = _skip_field(record, pos, tag & 7)
  feature_lists: Dict[str, List[FeatureValue]] = {}
  for key, fl_buf in _parse_map_entries(lists_buf):
    steps: List[FeatureValue] = []
    p = 0
    while p < len(fl_buf):
      tag, p = _read_varint(fl_buf, p)
      if tag == (1 << 3) | 2:
        feat_buf, p = _read_len_delimited(fl_buf, p)
        steps.append(_parse_feature(feat_buf))
      else:
        p = _skip_field(fl_buf, p, tag & 7)
    feature_lists[key] = steps
  return _parse_features(context_buf), feature_lists


# -- encode ------------------------------------------------------------------

def _len_delimited(out: bytearray, field: int, payload: bytes) -> None:
  _write_varint(out, (field << 3) | 2)
  _write_varint(out, len(payload))
  out.extend(payload)


def _encode_feature(value) -> bytes:
  inner = bytearray()
  if isinstance(value, (list, tuple)) and value and isinstance(
      value[0], (bytes, str)):
    lst = bytearray()
    for v in value:
      _len_delimited(lst, 1, v.encode() if isinstance(v, str) else v)
    _len_delimited(inner, 1, bytes(lst))
  elif isinstance(value, bytes):
    lst = bytearray()
    _len_delimited(lst, 1, value)
    _len_delimited(inner, 1, bytes(lst))
  else:
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
      packed = arr.astype("<f4").tobytes()
      lst = bytearray()
      _len_delimited(lst, 1, packed)
      _len_delimited(inner, 2, bytes(lst))
    else:
      lst = bytearray()
      payload = bytearray()
      for v in arr.astype(np.int64).ravel().tolist():
        _write_varint(payload, v & ((1 << 64) - 1))
      _len_delimited(lst, 1, bytes(payload))
      _len_delimited(inner, 3, bytes(lst))
  return bytes(inner)


def _encode_features(features: Dict[str, FeatureValue]) -> bytes:
  feats = bytearray()
  for key, value in features.items():
    entry = bytearray()
    _len_delimited(entry, 1, key.encode("utf-8"))
    _len_delimited(entry, 2, _encode_feature(value))
    _len_delimited(feats, 1, bytes(entry))
  return bytes(feats)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
  out = bytearray()
  _len_delimited(out, 1, _encode_features(features))
  return bytes(out)


def encode_sequence_example(context: Dict[str, FeatureValue],
                            feature_lists: Dict[str, Sequence]) -> bytes:
  """Encode a SequenceExample (inverse of parse_sequence_example).
  ``feature_lists`` values are sequences of per-step feature values."""
  lists = bytearray()
  for key, steps in feature_lists.items():
    fl = bytearray()
    for step in steps:
      _len_delimited(fl, 1, _encode_feature(step))
    entry = bytearray()
    _len_delimited(entry, 1, key.encode("utf-8"))
    _len_delimited(entry, 2, bytes(fl))
    _len_delimited(lists, 1, bytes(entry))
  out = bytearray()
  _len_delimited(out, 1, _encode_features(context))
  _len_delimited(out, 2, bytes(lists))
  return bytes(out)
