"""kfrun: multi-process launcher, the ``kungfu-run`` analog.

The port's counterpart of kf_benchmarks_tpu/kfrun.py. The reference
launches one process per device with ``kungfu-run -np N python3
tf_cnn_benchmarks.py ...`` and captures per-process logs as
``127.0.0.1.<port>.{stdout,stderr}.log``. kfrun starts a coordinator
(parallel/coordination.py on csrc/kfcoord.cc), spawns N worker processes
with KFCOORD_* environment variables (host, port, world size, name, rank
hint) and captures their logs under the same names: the first generation
truncates them, later generations append. A worker joins the job's
torch.distributed group through ``--worker_hosts`` (cluster.py) and meets
the others at exit on the coordinator's barrier (parallel/kungfu.py
``run_barrier``).

Elastic resize by checkpoint-restart: a process drives one card, so a
change of world size needs new processes. When the coordinator is asked
for another size, every worker checkpoints, enters a restart barrier and
exits with ``RESTART_EXIT_CODE``; kfrun then relaunches the same command
at the size the workers agreed on, and they resume from the checkpoint in
``--train_dir``. Any other failing worker ends the launch with its exit
code.

Usage:
    python -m kf_benchmarks_tpu_torch.kfrun -np 2 -- python -m \
        kf_benchmarks_tpu_torch.cli --model=resnet152 --use_fp16 \
        --variable_update=kungfu --elastic --train_dir=/tmp/run \
        --worker_hosts=127.0.0.1:29500,127.0.0.1:29501
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Tuple

# Exit code a worker uses to request a coordinated checkpoint-restart
# resize (chosen outside the shell/POSIX reserved ranges).
RESTART_EXIT_CODE = 42
# Coordinated restarts one launch makes at most.
MAX_RESTARTS = 16


def _run_generation(server, np_: int, command: List[str], logdir: str,
                    host: str, extra_env: Optional[dict],
                    opened_logs: Optional[set] = None) -> Tuple[int, bool]:
  """Spawn one generation of ``np_`` workers; wait.

  Returns (exit_code, restart_requested). The first time THIS launch
  opens a worker's log file it truncates it (a fresh launch -- or a
  restart that grows past the previous world size -- must not
  accumulate an earlier job's output); later generations append so one
  job's output stays in one set of files."""
  if opened_logs is None:
    opened_logs = set()
  procs = []
  log_files = []
  try:
    for i in range(np_):
      env = dict(os.environ)
      env.update(extra_env or {})
      env["KFCOORD_HOST"] = host
      env["KFCOORD_PORT"] = str(server.port)
      env["KFCOORD_WORLD"] = str(np_)
      env["KFCOORD_NAME"] = f"worker-{i}"
      env["KFCOORD_RANK_HINT"] = str(i)
      # Per-process log capture, named the way kungfu-run names them.
      tag = f"{host}.{10000 + i}"
      mode = "a" if tag in opened_logs else "w"
      opened_logs.add(tag)
      out = open(os.path.join(logdir, f"{tag}.stdout.log"), mode)
      err = open(os.path.join(logdir, f"{tag}.stderr.log"), mode)
      log_files += [out, err]
      procs.append(subprocess.Popen(command, env=env, stdout=out,
                                    stderr=err))
    # Monitor rather than blindly wait: if one worker dies abnormally
    # while its siblings are parked in the exit barrier, the barrier can
    # never fill -- tear the job down instead of hanging (the
    # kungfu-run failure contract). RESTART_EXIT_CODE is a coordinated
    # exit, not a failure.
    while True:
      codes = [p.poll() for p in procs]
      if all(c is not None for c in codes):
        break
      if any(c not in (None, 0, RESTART_EXIT_CODE) for c in codes):
        time.sleep(1.0)  # grace: let siblings exit on their own
        for p in procs:
          if p.poll() is None:
            p.terminate()
        for p in procs:
          try:
            p.wait(timeout=10)
          except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        codes = [p.poll() for p in procs]
        break
      time.sleep(0.1)
    if (any(c == RESTART_EXIT_CODE for c in codes) and
        all(c in (0, RESTART_EXIT_CODE) for c in codes)):
      return 0, True
    # Report the original failure, not the SIGTERM we delivered: a worker
    # killed by our teardown shows -15, which would mask the real code.
    failures = [c for c in codes
                if c not in (0, RESTART_EXIT_CODE, -signal.SIGTERM)]
    if failures:
      return max(abs(c) for c in failures), False
    return (1 if any(c == -signal.SIGTERM for c in codes) else 0), False
  except KeyboardInterrupt:
    for p in procs:
      p.send_signal(signal.SIGTERM)
    for p in procs:
      p.wait()
    return 130, False
  finally:
    for f in log_files:
      f.close()


def launch(np_: int, command: List[str], logdir: str = ".",
           host: str = "127.0.0.1", base_port: int = 0,
           extra_env: Optional[dict] = None) -> int:
  """Start coordinator + N workers; relaunch on coordinated restarts (at
  most ``MAX_RESTARTS``); return the final generation's worst exit
  code."""
  from kf_benchmarks_tpu_torch.parallel import coordination

  server = coordination.CoordinatorServer(port=base_port)
  try:
    gen_np = np_
    opened_logs: set = set()
    for _ in range(MAX_RESTARTS + 1):
      code, restart = _run_generation(server, gen_np, command, logdir,
                                      host, extra_env,
                                      opened_logs=opened_logs)
      if not restart:
        return code
      # The workers checkpointed and exited for a resize; relaunch at
      # the PROCESS count they agreed on in the scheduled-restart key
      # (the raw RESIZE target is a global DEVICE count; in the port a
      # process drives one card, so the two agree).
      with coordination.CoordinatorClient(host=host,
                                          port=server.port) as client:
        new_np = gen_np
        try:
          gen = client.current_generation()
          sched = client.kv_tryget(f"kf_restart_sched_{gen}")
          if sched:
            new_np = max(1, int(sched.decode().partition(":")[2]))
        except Exception as e:  # noqa: BLE001
          print(f"kfrun: could not read restart target ({e}); "
                f"respawning at np={gen_np}", file=sys.stderr, flush=True)
      print(f"kfrun: coordinated restart, np {gen_np} -> {new_np}",
            file=sys.stderr, flush=True)
      gen_np = new_np
    print(f"kfrun: giving up after {MAX_RESTARTS} restarts",
          file=sys.stderr, flush=True)
    return 1
  finally:
    server.stop()


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog="kfrun", description="kungfu-run-style multi-process launcher")
  parser.add_argument("-np", type=int, required=True, dest="np_",
                      help="number of worker processes")
  parser.add_argument("--logdir", default=".",
                      help="directory for per-process logs")
  parser.add_argument("--host", default="127.0.0.1")
  parser.add_argument("--port", type=int, default=0,
                      help="coordinator port (0 = ephemeral)")
  parser.add_argument("command", nargs=argparse.REMAINDER,
                      help="worker command (prefix with --)")
  args = parser.parse_args(argv)
  command = args.command
  if command and command[0] == "--":
    command = command[1:]
  if not command:
    parser.error("no worker command given")
  sys.exit(launch(args.np_, command, logdir=args.logdir, host=args.host,
                  base_port=args.port))


if __name__ == "__main__":
  main()
