"""Cluster manager: multi-process wiring of one job's ranks.

The port's counterpart of kf_benchmarks_tpu/cluster.py (the reference's
BaseClusterManager / GrpcClusterManager, cnn_util.py:201-251). A job is
one process per rank, every one a worker running the same command: the
rank is ``KFCOORD_RANK_HINT`` under the kfrun launcher (else
``--task_index``), the world is ``--worker_hosts`` truncated to
``KFCOORD_WORLD`` (a checkpoint-restart relaunches the same command at
another size), and the ranks join one torch.distributed process group at
``tcp://<worker_hosts[0]>``: NCCL with each rank on ``cuda:<local rank>``,
or gloo on the CPU with ``--device=cpu``. Parameter-server and controller
roles are refused, with the JAX package's messages.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from kf_benchmarks_tpu_torch.parallel import mesh


def process_rank(task_index: int = 0) -> int:
  """This process's rank: the kfrun launcher's ``KFCOORD_RANK_HINT``,
  else ``task_index`` (--task_index)."""
  return int(os.environ.get("KFCOORD_RANK_HINT", task_index))


class ClusterManager:
  """Wires this process into its job (the reference's BaseClusterManager /
  GrpcClusterManager, cnn_util.py:201-251): checks the roles, cuts the
  worker list to the live world and, when the job has more than one
  worker, joins its process group; ``shutdown`` leaves it."""

  def __init__(self, params):
    worker_hosts = list(params.worker_hosts or [])
    env_world = os.environ.get("KFCOORD_WORLD")
    if env_world and worker_hosts:
      worker_hosts = worker_hosts[:max(1, min(int(env_world),
                                              len(worker_hosts)))]
    if params.job_name in ("ps", "controller"):
      raise ValueError(
          f"job_name={params.job_name!r} has no TPU analog: parameter "
          "servers map to sharded optimizer state and the controller "
          "role to the flat SPMD program (SURVEY 5.8); run every "
          "process as a worker.")
    if params.ps_hosts:
      raise ValueError("ps_hosts set but parameter-server processes are "
                       "not part of the TPU design (use sharded state)")
    self.worker_hosts = worker_hosts
    self.rank = process_rank(params.task_index)
    if len(worker_hosts) > 1:
      local = self.rank
      if params.device == "gpu" and torch.cuda.is_available():
        local = self.rank % torch.cuda.device_count()
      mesh.init_process_group(params.device, len(worker_hosts), self.rank,
                              f"tcp://{worker_hosts[0]}", local_rank=local)

  def num_workers(self) -> int:
    return max(len(self.worker_hosts), 1)

  def shutdown(self) -> None:
    mesh.destroy_process_group()


def get_cluster_manager(params) -> Optional[ClusterManager]:
  """(ref: platforms/default/util.py get_cluster_manager)."""
  if not (params.worker_hosts or params.job_name):
    return None
  return ClusterManager(params)
