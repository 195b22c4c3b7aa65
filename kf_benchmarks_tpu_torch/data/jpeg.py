"""The port's JPEG codec: csrc/jpeg.cc through ctypes.

The JAX package decodes its records with PIL (data/preprocessing.py:179-224
there). The machine with the card has no PIL, so the port carries a codec of
its own, written to give what PIL gives on libjpeg-turbo: the integer IDCT,
fancy upsampling and libjpeg's fixed-point colour conversion, and at 1/2, 1/4
and 1/8 scale libjpeg's reduced IDCTs, which is what PIL's ``draft`` asks for
(``draft_scale`` below is Pillow's JpegImageFile.draft rule). The library is
built with g++ into build/host/ at first use (ops/_build.py). A ctypes call
releases the GIL, so the preprocessor's thread pool decodes in parallel.

Baseline, extended-sequential and progressive (SOF2) Huffman files decode;
a progressive file's scans fill the whole image's coefficients before the
same output stage runs. Every failure raises ValueError: a frame type the
codec does not decode (arithmetic-coded, lossless, hierarchical, 12-bit) is
named, and so is a progressive file whose scans stop before AC coefficients
1-9 are complete, which libjpeg would block-smooth; truncated or corrupt
data never decodes to a guess.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from kf_benchmarks_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_ERR_LEN = 256


def library() -> ctypes.CDLL:
  """The codec library, built on first use."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(_build.build_host_library("jpeg"))
      u8p = ctypes.POINTER(ctypes.c_uint8)
      ip = ctypes.POINTER(ctypes.c_int)
      lib.kfj_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ip, ip, ip,
                               ctypes.c_char_p, ctypes.c_int]
      lib.kfj_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_int, u8p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
      lib.kfj_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 u8p, ctypes.c_size_t,
                                 ctypes.POINTER(ctypes.c_size_t),
                                 ctypes.c_char_p, ctypes.c_int]
      lib.kf_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
      lib.kf_crc32c.restype = ctypes.c_uint32
      for fn in (lib.kfj_info, lib.kfj_decode, lib.kfj_encode):
        fn.restype = ctypes.c_int
      _lib = lib
  return _lib


def _u8(a: np.ndarray):
  return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def info(data: bytes) -> Tuple[int, int, int]:
  """(width, height, components) from the headers."""
  w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
  err = ctypes.create_string_buffer(_ERR_LEN)
  if library().kfj_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(c), err, _ERR_LEN):
    raise ValueError(err.value.decode())
  return w.value, h.value, c.value


def draft_scale(size: Tuple[int, int], need: Tuple[int, int]) -> int:
  """Pillow's ``draft`` scale: the largest s in (8, 4, 2, 1) with s <=
  min(W // w, H // h) for a requested (w, h)."""
  scale = min(size[0] // need[0], size[1] // need[1])
  for s in (8, 4, 2, 1):
    if scale >= s:
      return s
  return 1


def decode(data: bytes, scale: int = 1) -> np.ndarray:
  """RGB uint8 (H', W', 3) at 1/``scale``: W' = ceil(W / scale), H' =
  ceil(H / scale). PIL's ``Image.open(...).convert("RGB")`` at scale 1, and
  after ``draft`` at the others."""
  w, h, _ = info(data)
  ow, oh = -(-w // scale), -(-h // scale)
  out = np.empty((oh, ow, 3), np.uint8)
  err = ctypes.create_string_buffer(_ERR_LEN)
  if library().kfj_decode(data, len(data), scale, _u8(out), ow, oh, err,
                          _ERR_LEN):
    raise ValueError(err.value.decode())
  return out


def encode(image: np.ndarray, quality: int = 75,
           subsampling: str = "4:2:0") -> bytes:
  """Baseline JPEG of a uint8 (H, W, 3) or (H, W) image with the standard
  tables at ``quality``."""
  image = np.ascontiguousarray(image, dtype=np.uint8)
  if image.ndim == 2:
    channels = 1
  elif image.ndim == 3 and image.shape[2] == 3:
    channels = 3
  else:
    raise ValueError(f"encode takes (H, W) or (H, W, 3), got {image.shape}")
  mode = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[subsampling]
  h, w = image.shape[:2]
  capacity = w * h * channels * 8 + 4096
  out = np.empty(capacity, np.uint8)
  length = ctypes.c_size_t()
  err = ctypes.create_string_buffer(_ERR_LEN)
  if library().kfj_encode(_u8(image), w, h, channels, int(quality), mode,
                          _u8(out), capacity, ctypes.byref(length), err,
                          _ERR_LEN):
    raise ValueError(err.value.decode())
  return out[:length.value].tobytes()


def crc32c(data: bytes) -> int:
  """CRC32C (Castagnoli) of ``data``."""
  return int(library().kf_crc32c(data, len(data)))
