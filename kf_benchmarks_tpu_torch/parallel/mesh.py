"""Process groups: the port's counterpart of kf_benchmarks_tpu/parallel/mesh.py.

The JAX package runs one SPMD program over a mesh of devices; the port runs
one process per rank and joins them in a ``torch.distributed`` process
group: NCCL on the card (one rank per card, rank r on ``cuda:r``), gloo on
the CPU. The group meets through a store on this host (a ``tcp://127.0.0.1``
address or a ``file://`` path), so it needs no network. Without a process
group the port is one rank of a world of one, and every collective of
``parallel/kungfu.py`` and ``ops/allreduce.py`` is skipped by its caller
(``train_step.TrainStep``).
"""

from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist


def is_distributed() -> bool:
  return dist.is_available() and dist.is_initialized()


def world_size() -> int:
  return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
  return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
  """This rank's card on its host: the CUDA device ``init_process_group``
  made current in an NCCL group, else the rank."""
  if is_distributed() and dist.get_backend() == "nccl":
    return torch.cuda.current_device()
  return rank()


def rank_device(device: str, local_rank: int) -> torch.device:
  """``cuda:<local_rank>`` for --device=gpu, the CPU for --device=cpu."""
  if device == "gpu":
    return torch.device("cuda", local_rank)
  return torch.device("cpu")


def local_init_method() -> str:
  """A TCP store address on 127.0.0.1, at a port that was free when
  asked."""
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("127.0.0.1", 0))
    return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def device_count_error(device: str, num_devices: int):
  """Why ``num_devices`` (> 1) ranks cannot run on ``device``, or None."""
  if device != "gpu" or num_devices <= 1:
    return None
  have = torch.cuda.device_count() if torch.cuda.is_available() else 0
  if num_devices > have:
    return (f"--device=gpu --num_devices={num_devices}: NCCL runs one rank "
            f"per card (one device each) and this host has {have} CUDA "
            "device(s); ranks never share a card and never fall back to "
            "gloo (use --device=cpu for gloo ranks on the CPU)")
  return None


def init_process_group(device: str, world: int, rank_: int,
                       init_method: str, timeout_s: float = 600.0,
                       local_rank: int = None) -> torch.device:
  """Joins rank ``rank_`` of ``world`` and returns its device,
  ``cuda:<local_rank>`` (default: the rank, one host) on the card, where
  it is made current before NCCL starts."""
  dev = rank_device(device, rank_ if local_rank is None else local_rank)
  if dev.type == "cuda":
    torch.cuda.set_device(dev)
  dist.init_process_group(
      "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
      world_size=world, rank=rank_,
      timeout=datetime.timedelta(seconds=timeout_s))
  return dev


def destroy_process_group() -> None:
  if is_distributed():
    dist.destroy_process_group()
