"""The port stands alone: importing every module of kf_benchmarks_tpu_torch,
and the root scripts chip_smoke.py and bench_torch.py, loads neither jax,
flax nor the JAX package, and not PIL either (the input path decodes and
transforms images with its own codec, data/jpeg.py and data/image_ops.py;
the machine with the card has no PIL).

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
             if m in ("jax", "flax", "PIL", "kf_benchmarks_tpu") or
             m.startswith(("jax.", "flax.", "PIL.", "kf_benchmarks_tpu.")))
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
  assert int(proc.stdout.split()[0]) >= 77, proc.stdout


@pytest.mark.parametrize("planted", ["import jax",
                                     "import kf_benchmarks_tpu.flags",
                                     "import PIL.Image"])
def test_the_check_sees_a_planted_import(planted):
  proc = _check(planted)
  assert proc.returncode == 1, proc.stdout + proc.stderr
  assert "loaded:" in proc.stdout


def test_the_walk_covers_the_telemetry_and_fault_modules():
  """telemetry.py and faults.py are among the modules the check imports,
  and each keeps its own copy of the JAX package's module rather than
  importing it (the JAX package's faults.py is stdlib only, and is
  still not imported)."""
  import pkgutil
  import kf_benchmarks_tpu_torch as pkg
  names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                 pkg.__name__ + ".")}
  for mod in ("telemetry", "faults", "metrics", "tracing", "kfrun"):
    assert f"kf_benchmarks_tpu_torch.{mod}" in names
  for mod in ("telemetry", "faults"):
    with open(os.path.join(REPO, "kf_benchmarks_tpu_torch",
                           mod + ".py")) as f:
      src = f.read()
    assert "kf_benchmarks_tpu." not in src.replace(
        "kf_benchmarks_tpu/", "")


@pytest.mark.parametrize("module", ["kf_benchmarks_tpu_torch.quantization",
                                    "kf_benchmarks_tpu_torch.aot"])
def test_quantization_and_aot_alone_load_neither_jax_nor_pil(module):
  """The two modules of the frozen export keep their own copies of the JAX
  package's quantization.py and aot.py: imported alone, in a fresh
  interpreter, they load no JAX, no JAX package and no PIL."""
  code = (f"import sys; sys.path.insert(0, {REPO!r}); import {module}; "
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'flax', 'PIL', 'kf_benchmarks_tpu')); print(bad); "
          "sys.exit(1 if bad else 0)")
  env = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, cwd=REPO, env=env, timeout=240)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  with open(os.path.join(REPO, *module.split(".")) + ".py") as f:
    src = f.read()
  assert "kf_benchmarks_tpu." not in src.replace("kf_benchmarks_tpu/", "")


NEW_MODULES = ("models.nasnet_model", "models.official_ncf_model",
               "models.ssd_model", "models.ssd_dataloader",
               "models.ssd_constants", "coco_metric",
               "data.coco_record_generator")


@pytest.mark.parametrize("mod", NEW_MODULES)
def test_the_walk_covers_nasnet_ncf_and_the_coco_path(mod):
  """NASNet, NCF, SSD300 and the COCO path are among the modules the
  check imports, and each keeps its own copy of what it needs from the
  JAX package (ssd_constants, ssd_dataloader and coco_metric are numpy
  there, and still not imported)."""
  import pkgutil
  import kf_benchmarks_tpu_torch as pkg
  names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                 pkg.__name__ + ".")}
  assert f"kf_benchmarks_tpu_torch.{mod}" in names
  with open(os.path.join(REPO, "kf_benchmarks_tpu_torch",
                         *mod.split(".")) + ".py") as f:
    src = f.read()
  assert "import jax" not in src and "from jax" not in src
  assert "kf_benchmarks_tpu." not in src.replace("kf_benchmarks_tpu/", "")


def test_the_input_path_still_imports_no_torch():
  """data/preprocessing.py, which the decode pool's workers import, now
  holds the COCO preprocessor (and through it ssd_dataloader): still no
  torch."""
  env = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
  proc = subprocess.run(
      [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
       "import kf_benchmarks_tpu_torch.data.preprocessing; "
       "sys.exit('torch' in sys.modules)" % REPO],
      capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_walk_covers_the_analysis_and_all_reduce_modules():
  """The contract, audit, schedule and autotune modules, the analysis CLI
  and the all-reduce benchmark are among the modules the check imports
  (the JAX package's counterparts of each import jax)."""
  import pkgutil
  import kf_benchmarks_tpu_torch as pkg
  names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                 pkg.__name__ + ".")}
  for mod in ("analysis.contracts", "analysis.audit", "analysis.spmd",
              "analysis.autotune", "analysis.baseline", "analysis.__main__",
              "all_reduce_benchmark"):
    assert f"kf_benchmarks_tpu_torch.{mod}" in names, mod
