"""ctypes bindings for the coordination service (csrc/kfcoord.cc).

The port's counterpart of kf_benchmarks_tpu/parallel/coordination.py, the
control plane KungFu's runtime and kungfu-run's config server give the
reference: membership and ranks, named barriers, a key-value store and
generation-numbered elastic resize requests, over TCP between the
processes of a job. torch.distributed owns the data plane; this owns
host-side coordination:

  CoordinatorServer  -- in-process coordinator (kfrun runs one)
  CoordinatorClient  -- join / barrier / kv_put / kv_get / resize

``csrc/kfcoord.cc`` is the JAX package's ``native/kfcoord.cc``, byte for
byte; the port keeps its own copy and builds it with ``g++`` into the
gitignored ``build/host/`` at first use (ops/_build.py
``build_host_library``), never into ``native/``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from kf_benchmarks_tpu_torch.ops import _build

_lib = None
_lib_lock = threading.Lock()


def _load_library() -> ctypes.CDLL:
  """Load (building if needed) the library."""
  global _lib
  with _lib_lock:
    if _lib is not None:
      return _lib
    lib = ctypes.CDLL(_build.build_host_library("kfcoord"))
    lib.kfcoord_server_start.restype = ctypes.c_void_p
    lib.kfcoord_server_start.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.kfcoord_server_stop.argtypes = [ctypes.c_void_p]
    lib.kfcoord_connect.restype = ctypes.c_void_p
    lib.kfcoord_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.kfcoord_close.argtypes = [ctypes.c_void_p]
    lib.kfcoord_join.restype = ctypes.c_int
    lib.kfcoord_join.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_long)]
    lib.kfcoord_cluster_size.restype = ctypes.c_int
    lib.kfcoord_cluster_size.argtypes = [ctypes.c_void_p]
    lib.kfcoord_generation.restype = ctypes.c_long
    lib.kfcoord_generation.argtypes = [ctypes.c_void_p]
    lib.kfcoord_barrier.restype = ctypes.c_int
    lib.kfcoord_barrier.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.kfcoord_kv_put.restype = ctypes.c_int
    lib.kfcoord_kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p]
    lib.kfcoord_kv_get.restype = ctypes.c_int
    lib.kfcoord_kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.kfcoord_kv_tryget.restype = ctypes.c_int
    lib.kfcoord_kv_tryget.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.kfcoord_resize.restype = ctypes.c_long
    lib.kfcoord_resize.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kfcoord_leave.restype = ctypes.c_int
    lib.kfcoord_leave.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _decode_kv_token(token: str) -> bytes:
  """Inverse of kv_put's wire encoding ('x' + hex for binary payloads;
  raw tokens like RESIZE's decimal target pass through)."""
  return bytes.fromhex(token[1:]) if token.startswith("x") else \
      token.encode()


class CoordinatorServer:
  """In-process coordinator (the config-server role of kungfu-run)."""

  def __init__(self, port: int = 0):
    lib = _load_library()
    out_port = ctypes.c_int(0)
    self._handle = lib.kfcoord_server_start(port, ctypes.byref(out_port))
    if not self._handle:
      raise RuntimeError(f"Failed to start coordinator on port {port}")
    self.port = out_port.value

  def stop(self) -> None:
    if self._handle:
      _load_library().kfcoord_server_stop(self._handle)
      self._handle = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.stop()

  def __del__(self):
    try:
      self.stop()
    except Exception:
      pass


class CoordinatorClient:
  """One worker's connection to the coordinator."""

  def __init__(self, host: str = "127.0.0.1", port: int = 0,
               timeout_ms: int = 10000):
    lib = _load_library()
    self._lib = lib
    self._handle = lib.kfcoord_connect(host.encode(), port, timeout_ms)
    if not self._handle:
      raise RuntimeError(f"Failed to connect to coordinator {host}:{port}")
    self.rank: Optional[int] = None
    self.size: Optional[int] = None
    self.generation: Optional[int] = None

  def join(self, name: str) -> int:
    """Register and get a stable rank (idempotent per name)."""
    size = ctypes.c_int(0)
    gen = ctypes.c_long(0)
    rank = self._lib.kfcoord_join(self._handle, name.encode(),
                                  ctypes.byref(size), ctypes.byref(gen))
    if rank < 0:
      raise RuntimeError("JOIN failed")
    self.rank, self.size, self.generation = rank, size.value, gen.value
    return rank

  def cluster_size(self) -> int:
    n = self._lib.kfcoord_cluster_size(self._handle)
    if n < 0:
      raise RuntimeError("SIZE failed")
    return n

  def current_generation(self) -> int:
    g = self._lib.kfcoord_generation(self._handle)
    if g < 0:
      raise RuntimeError("GEN failed")
    return g

  def barrier(self, name: str, count: int) -> None:
    """Block until ``count`` participants enter barrier ``name``
    (the run_barrier analog, ref: tf_cnn_benchmarks.py:58-60)."""
    if self._lib.kfcoord_barrier(self._handle, name.encode(), count) != 0:
      raise RuntimeError(f"BARRIER {name} failed")

  def kv_put(self, key: str, value: bytes) -> None:
    # "x" prefix keeps the token non-empty (protocol is space-delimited)
    # and distinguishes hex payloads from raw tokens like RESIZE's
    # decimal target size.
    if self._lib.kfcoord_kv_put(self._handle, key.encode(),
                                ("x" + value.hex()).encode()) != 0:
      raise RuntimeError(f"PUT {key} failed")

  def _kv_get_raw(self, key: str, max_len: int = 1 << 20) -> str:
    buf = ctypes.create_string_buffer(max_len)
    n = self._lib.kfcoord_kv_get(self._handle, key.encode(), buf, max_len)
    if n == -2:
      raise ValueError(f"value for {key} exceeds {max_len} bytes")
    if n < 0:
      raise RuntimeError(f"GET {key} failed")
    return buf.value.decode()

  def kv_get(self, key: str, max_len: int = 1 << 20) -> bytes:
    """Blocking fetch (bootstrap exchange: workers GET what rank 0 PUT)."""
    return _decode_kv_token(self._kv_get_raw(key, max_len))

  def _kv_tryget_raw(self, key: str,
                     max_len: int = 1 << 20) -> Optional[str]:
    """Non-blocking probe; None when the key is absent."""
    buf = ctypes.create_string_buffer(max_len)
    n = self._lib.kfcoord_kv_tryget(self._handle, key.encode(), buf,
                                    max_len)
    if n == -3:
      return None
    if n == -2:
      raise ValueError(f"value for {key} exceeds {max_len} bytes")
    if n < 0:
      raise RuntimeError(f"TRYGET {key} failed")
    return buf.value.decode()

  def kv_tryget(self, key: str, max_len: int = 1 << 20) -> Optional[bytes]:
    """Non-blocking kv_get; None when the key is absent."""
    token = self._kv_tryget_raw(key, max_len)
    return None if token is None else _decode_kv_token(token)

  def resize(self, new_size: int) -> int:
    """Request an elastic resize; returns the new generation."""
    gen = self._lib.kfcoord_resize(self._handle, new_size)
    if gen < 0:
      raise RuntimeError("RESIZE failed")
    return gen

  def target_size(self) -> int:
    """The most recently requested elastic target size (blocks until a
    RESIZE has been issued)."""
    return int(self._kv_get_raw("__target_size__"))

  def try_target_size(self) -> Optional[int]:
    """Non-blocking variant; None when no RESIZE was ever issued."""
    token = self._kv_tryget_raw("__target_size__")
    return int(token) if token is not None else None

  def leave(self) -> None:
    self._lib.kfcoord_leave(self._handle)

  def close(self) -> None:
    if self._handle:
      self._lib.kfcoord_close(self._handle)
      self._handle = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
