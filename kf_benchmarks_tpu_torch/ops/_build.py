"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

The libraries go to ``build/kernels/<hash>/`` at the repository root (or
under the directory ``set_build_root`` names: --compilation_cache_dir),
where ``<hash>`` covers every source under ``csrc/`` and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.
``loaded_from_cache()`` says whether this process loaded libraries and
built none. ``nvcc`` is
needed only here, when a kernel is first launched; importing the package
never needs it.

The libraries link the CUDA runtime only: the kernels that load by TMA
(``csrc/sm90.cuh``) look ``cuTensorMapEncodeTiled`` up in
``libcuda.so.1``, which the runtime has loaded, with ``dlsym`` at run
time, so no ``-lcuda`` is needed.

The ranks of a data-parallel run share the build directory: the first to
take its lock builds, and the others wait for it and load what it built.

``build_host_library`` does the same with ``g++`` for the host-side C++ of
``csrc/`` (the coordination service, ``csrc/kfcoord.cc``), into
``build/host/<hash>/``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
HOST_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "host")

# The C++ runtime is linked in and its symbols kept private: in a process
# that has loaded the CUDA libraries, a library that takes its std::
# symbols from the global namespace crashed (a segfault in the first
# std::ostringstream, kfcoord_barrier, on an H100 host; g++ 13.3).
GXX_FLAGS = ["-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared",
             "-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Shape, strides, scale, causal flag and stream of the attention kernels:
# (B, H, Lq, Lk, D), the batch and position strides of q, k and v, the
# softmax scale (a C float: without c_float ctypes would pass an int).
_ATTN_TAIL = ([ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 +
              [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

# C signatures of the exported functions, by library.
_SIGNATURES = {
    "flash_attention_fwd": {
        "flash_attention_fwd_bf16": [ctypes.c_void_p] * 7 + _ATTN_TAIL,
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_dkv_bf16": [ctypes.c_void_p] * 10 + _ATTN_TAIL,
        "flash_attention_bwd_dq_bf16": [ctypes.c_void_p] * 9 + _ATTN_TAIL,
    },
    "flash_decode": {
        # q, k, v, pos, o; B, H, T, D, S; the batch stride of q and the
        # batch and position strides of k and v; scale; stream.
        "flash_decode_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
                             [ctypes.c_longlong] * 5 +
                             [ctypes.c_float, ctypes.c_void_p],
    },
    "conv3x3_same": {
        # x, w, y; N, H, W, C, CO; tile rows and columns; the A box's
        # width, height and images; grid; stream.
        "conv3x3_same_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 +
                             [ctypes.c_void_p],
    },
    "bn_relu_conv3x3_stats": {
        # x, sc, sh, w_k, y, partial, stats; N, H, W, C, CO; tile rows and
        # columns; the A box's width, height and images; grid; stream.
        "bn_relu_conv3x3_stats_bf16": [ctypes.c_void_p] * 7 +
                                      [ctypes.c_int] * 11 +
                                      [ctypes.c_void_p],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
# The kernels' build root when one is set (--compilation_cache_dir), and
# the libraries this process built.
_root = None
_built: List[str] = []


def set_build_root(path) -> None:
  """Build and load the kernels under ``path`` (None: build/kernels)."""
  global _root
  _root = os.path.abspath(path) if path else None


def build_root() -> str:
  return _root or BUILD_ROOT


def loaded_from_cache() -> bool:
  """Whether this process loaded kernel libraries and built none."""
  return bool(_loaded) and not _built


def _sources() -> List[str]:
  return sorted(f for f in os.listdir(CSRC_DIR)
                if f.endswith((".cu", ".cuh")))


def _source_hash() -> str:
  h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for name in _sources():
    h.update(name.encode())
    with open(os.path.join(CSRC_DIR, name), "rb") as f:
      h.update(f.read())
  return h.hexdigest()[:16]


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
    return os.path.join(cuda_home, "bin", "nvcc")
  found = shutil.which("nvcc")
  if found:
    return found
  from torch.utils import cpp_extension
  if cpp_extension.CUDA_HOME:
    candidate = os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc")
    if os.path.exists(candidate):
      return candidate
  raise RuntimeError(
      "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
      "kernels are compiled from kf_benchmarks_tpu_torch/csrc at first use")


def build_all() -> str:
  """Compile every library that is missing from this source hash's build
  directory, all ``nvcc`` processes in parallel, each leaving its output
  (ptxas -v: registers, shared memory, spills) in ``<name>.log`` there.
  Returns the directory."""
  out_dir = os.path.join(build_root(), _source_hash())
  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(out_dir, ".lock"), "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    _build_missing(out_dir)
  return out_dir


def build_host_library(name: str) -> str:
  """``csrc/<name>.cc`` built by ``g++`` into
  ``build/host/<hash>/lib<name>.so`` (the hash covers the source and the
  flags) unless it is there already, under the build directory's lock;
  returns the library's path."""
  src = os.path.join(CSRC_DIR, name + ".cc")
  h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
  with open(src, "rb") as f:
    h.update(f.read())
  out_dir = os.path.join(HOST_BUILD_ROOT, h.hexdigest()[:16])
  path = os.path.join(out_dir, f"lib{name}.so")
  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(out_dir, ".lock"), "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    if not os.path.exists(path):
      tmp = os.path.join(out_dir, f"lib{name}.{os.getpid()}.tmp.so")
      cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
      proc = subprocess.run([cxx] + GXX_FLAGS + ["-o", tmp, src,
                                                 "-lpthread"],
                            capture_output=True, text=True)
      if proc.returncode != 0:
        raise RuntimeError(f"{name}: {cxx} exited {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
      os.replace(tmp, path)
  return path


def _build_missing(out_dir: str) -> None:
  todo = [name for name in _SIGNATURES
          if not os.path.exists(os.path.join(out_dir, name + ".so"))]
  if todo:
    nvcc = _nvcc()
    procs = []
    for name in todo:
      # Each process writes a private file that is renamed into place, so
      # two processes building at once never load a half-written library.
      tmp = os.path.join(out_dir, f"{name}.{os.getpid()}.tmp.so")
      cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp,
                                   os.path.join(CSRC_DIR, name + ".cu")]
      procs.append((name, tmp, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
      out, _ = proc.communicate()
      with open(os.path.join(out_dir, name + ".log"), "w") as f:
        f.write(out)
      if proc.returncode != 0:
        failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
      else:
        os.replace(tmp, os.path.join(out_dir, name + ".so"))
        _built.append(name)
    if failed:
      raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
  """The loaded library ``name`` (built first if needed)."""
  lib = _loaded.get(name)
  if lib is not None:
    return lib
  out_dir = build_all()
  lib = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
  for fn_name, argtypes in _SIGNATURES[name].items():
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
  _loaded[name] = lib
  return lib
