"""PIL's image operations on uint8 HWC arrays, for the port's input path.

The JAX package's train and eval preprocessing (data/preprocessing.py
there) crops, resizes, flips and colour-jitters PIL images. The machine with
the card has no PIL, so the port does the same operations on numpy arrays:
the arithmetic ones (resize, ``convert("L")``, the ImageEnhance enhancers,
``convert("HSV")`` and back)
in csrc/image_ops.cc, built with g++ at first use and called through ctypes
(which releases the GIL), and the ones that only move bytes (crop, flip)
here. Each gives PIL's result to the bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from kf_benchmarks_tpu_torch.ops import _build

NEAREST, BILINEAR, BICUBIC, BOX = 0, 1, 2, 3

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
  """The image-operation library, built on first use."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(_build.build_host_library("image_ops"))
      u8p = ctypes.POINTER(ctypes.c_uint8)
      lib.kfi_resize.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, u8p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
      lib.kfi_resize.restype = ctypes.c_int
      lib.kfi_grayscale.argtypes = [u8p, ctypes.c_size_t, u8p]
      lib.kfi_grayscale.restype = None
      lib.kfi_enhance.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int,
                                  ctypes.c_double, u8p]
      lib.kfi_enhance.restype = ctypes.c_int
      for name in ("kfi_rgb_to_hsv", "kfi_hsv_to_rgb"):
        getattr(lib, name).argtypes = [u8p, ctypes.c_size_t, u8p]
        getattr(lib, name).restype = None
      _lib = lib
  return _lib


def _u8(a: np.ndarray):
  return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _rgb(image: np.ndarray) -> np.ndarray:
  image = np.ascontiguousarray(image, dtype=np.uint8)
  if image.ndim != 3 or image.shape[2] != 3:
    raise ValueError(f"expected an (H, W, 3) uint8 image, got {image.shape}")
  return image


def crop(image: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
  """``Image.crop((left, upper, right, lower))``: the part outside the
  image is black, as PIL makes it."""
  x0, y0, x1, y1 = (int(v) for v in box)
  h, w = image.shape[:2]
  if 0 <= x0 <= x1 <= w and 0 <= y0 <= y1 <= h:
    return image[y0:y1, x0:x1]
  out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + image.shape[2:],
                 image.dtype)
  sx0, sy0 = max(x0, 0), max(y0, 0)
  sx1, sy1 = min(x1, w), min(y1, h)
  if sx1 > sx0 and sy1 > sy0:
    out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = image[sy0:sy1, sx0:sx1]
  return out


def flip_left_right(image: np.ndarray) -> np.ndarray:
  """``Image.transpose(FLIP_LEFT_RIGHT)``."""
  return image[:, ::-1]


def resize(image: np.ndarray, size: Tuple[int, int],
           method: int) -> np.ndarray:
  """``Image.resize((width, height), method)`` of an (H, W, 3) image."""
  image = _rgb(image)
  ow, oh = int(size[0]), int(size[1])
  h, w = image.shape[:2]
  out = np.empty((oh, ow, 3), np.uint8)
  if library().kfi_resize(_u8(image), w, h, 3, _u8(out), ow, oh,
                          int(method)):
    raise ValueError(f"resize of {w}x{h} to {ow}x{oh} with method "
                     f"{method} refused")
  return out


def grayscale(image: np.ndarray) -> np.ndarray:
  """``convert("L")``: (H, W) uint8."""
  image = _rgb(image)
  out = np.empty(image.shape[:2], np.uint8)
  library().kfi_grayscale(_u8(image), image.shape[0] * image.shape[1],
                          _u8(out))
  return out


def _enhance(image: np.ndarray, kind: int, factor: float) -> np.ndarray:
  image = _rgb(image)
  out = np.empty_like(image)
  library().kfi_enhance(_u8(image), image.shape[0] * image.shape[1], kind,
                        float(factor), _u8(out))
  return out


def brightness(image: np.ndarray, factor: float) -> np.ndarray:
  """``ImageEnhance.Brightness(img).enhance(factor)``."""
  return _enhance(image, 0, factor)


def color(image: np.ndarray, factor: float) -> np.ndarray:
  """``ImageEnhance.Color(img).enhance(factor)``."""
  return _enhance(image, 1, factor)


def contrast(image: np.ndarray, factor: float) -> np.ndarray:
  """``ImageEnhance.Contrast(img).enhance(factor)``."""
  return _enhance(image, 2, factor)


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
  """``convert("HSV")`` of an RGB image: (H, W, 3) uint8 h, s, v."""
  image = _rgb(image)
  out = np.empty_like(image)
  library().kfi_rgb_to_hsv(_u8(image), image.shape[0] * image.shape[1],
                           _u8(out))
  return out


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
  """``Image.fromarray(hsv, "HSV").convert("RGB")``."""
  image = _rgb(image)
  out = np.empty_like(image)
  library().kfi_hsv_to_rgb(_u8(image), image.shape[0] * image.shape[1],
                           _u8(out))
  return out
