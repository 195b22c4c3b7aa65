"""The port stands alone: importing every module of kf_benchmarks_tpu_torch,
and the root scripts chip_smoke.py and bench_torch.py, loads neither jax nor
the JAX package.

Each check runs in a fresh interpreter (this test process has jax loaded
through tests/conftest.py) and walks the package with pkgutil, so a module
added later is covered without a list to keep. A planted ``import jax``
shows that the check sees it.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
{planted}
import kf_benchmarks_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
names += ["chip_smoke", "bench_torch"]
for name in names:
  importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "kf_benchmarks_tpu") or
             m.startswith(("jax.", "kf_benchmarks_tpu.")))
print(len(names), "modules")
if bad:
  print("loaded:", bad[:10])
  sys.exit(1)
"""


def _check(planted=""):
  env = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
  return subprocess.run(
      [sys.executable, "-c", _CHECK.format(repo=REPO, planted=planted)],
      capture_output=True, text=True, cwd=REPO, env=env, timeout=240)


def test_no_module_of_the_port_loads_jax_or_the_jax_package():
  proc = _check()
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert int(proc.stdout.split()[0]) >= 40, proc.stdout


@pytest.mark.parametrize("planted", ["import jax",
                                     "import kf_benchmarks_tpu.flags"])
def test_the_check_sees_a_planted_import(planted):
  proc = _check(planted)
  assert proc.returncode == 1, proc.stdout + proc.stderr
  assert "loaded:" in proc.stdout
