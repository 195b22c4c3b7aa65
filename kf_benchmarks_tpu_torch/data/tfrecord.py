"""TFRecord file codec: the port's own copy of the JAX package's
data/tfrecord.py.

ImageNet arrives as TFRecord shards, each a sequence of:

    uint64 length (little-endian)
    uint32 masked_crc32c(length_bytes)
    byte   data[length]
    uint32 masked_crc32c(data)

CRC32C uses the Castagnoli polynomial with TFRecord's mask
(((crc >> 15) | (crc << 17)) + 0xa282ead8). The writer's files are the JAX
writer's byte for byte; the CRC itself is computed by the port's host
library (csrc/jpeg.cc), since the byte-at-a-time Python loop of the JAX copy
takes seconds for one shard of photo-sized records. Verification is optional
on read (off by default, as in the JAX package).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List

from kf_benchmarks_tpu_torch.data import jpeg

_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes) -> int:
  return jpeg.crc32c(bytes(data))


def masked_crc32c(data: bytes) -> int:
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


class TFRecordWriter:
  """Writes TFRecord files (the record generator, get_tf_record.py)."""

  def __init__(self, path: str):
    self._f = open(path, "wb")

  def write(self, record: bytes) -> None:
    header = struct.pack("<Q", len(record))
    self._f.write(header)
    self._f.write(struct.pack("<I", masked_crc32c(header)))
    self._f.write(record)
    self._f.write(struct.pack("<I", masked_crc32c(record)))

  def close(self) -> None:
    self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def read_records(path: str, verify: bool = False) -> Iterator[bytes]:
  """Yield raw record payloads from one TFRecord file."""
  with open(path, "rb") as f:
    while True:
      header = f.read(8)
      if not header:
        return
      if len(header) != 8:
        raise IOError(f"Truncated TFRecord header in {path}")
      (length,) = struct.unpack("<Q", header)
      length_crc_bytes = f.read(4)
      if len(length_crc_bytes) != 4:
        raise IOError(f"Truncated TFRecord length CRC in {path}")
      if verify and masked_crc32c(header) != struct.unpack(
          "<I", length_crc_bytes)[0]:
        raise IOError(f"Corrupt TFRecord length CRC in {path}")
      data = f.read(length)
      if len(data) != length:
        raise IOError(f"Truncated TFRecord payload in {path}")
      data_crc_bytes = f.read(4)
      if len(data_crc_bytes) != 4:
        raise IOError(f"Truncated TFRecord payload CRC in {path}")
      if verify and masked_crc32c(data) != struct.unpack(
          "<I", data_crc_bytes)[0]:
        raise IOError(f"Corrupt TFRecord payload CRC in {path}")
      yield data


def shard_path(data_dir: str, subset: str, index: int, total: int) -> str:
  """Canonical shard filename, matched by :func:`list_shards`
  (``<subset>-%05d-of-%05d``, the reference's naming convention)."""
  return os.path.join(data_dir, f"{subset}-{index:05d}-of-{total:05d}")


def list_shards(data_dir: str, subset: str) -> List[str]:
  """Shard discovery: ``<subset>-*-of-*`` files, the naming the reference's
  datasets use (ref: datasets.py:131-137 tf_record_pattern)."""
  prefix = {"train": "train", "validation": "validation"}[subset]
  names = sorted(n for n in os.listdir(data_dir) if n.startswith(prefix + "-"))
  if not names:
    raise ValueError(f"No TFRecord shards matching {prefix}-* in {data_dir}")
  return [os.path.join(data_dir, n) for n in names]
