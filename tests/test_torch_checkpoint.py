"""The port's checkpoints (kf_benchmarks_tpu_torch/checkpoint.py) and the
resume path of its BenchmarkCNN, on the CPU.

A run resumed from a checkpoint must reach the state of an uninterrupted
run bit for bit: parameters, batch-norm running averages, the optimizer's
momentum buffers and the global step. A copy of the port with one planted
fault (the optimizer's state left out of the restore) must fail that
check. The runs use a small ResNet v1.5 (one block a stage, 32x32 images,
batch 2) put in the registry's place of ``resnet50``.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import optimizers
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import resnet_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_resnet(params=None):
  model = resnet_model.ResnetModel("resnet50", (1, 1, 1, 1), params=params)
  model.image_size = 32
  return model


def _run(train_dir, num_batches, **flags):
  """BenchmarkCNN on the small ResNet (momentum, no warmup); its stats."""
  saved = model_config._MODELS["resnet50"]
  model_config._MODELS["resnet50"] = _small_resnet
  try:
    p = params_lib.make_params(
        model="resnet50", device="cpu", batch_size=2, optimizer="momentum",
        num_batches=num_batches, num_warmup_batches=0, display_every=100,
        train_dir=str(train_dir), **flags)
    return benchmark.BenchmarkCNN(p).run()
  finally:
    model_config._MODELS["resnet50"] = saved


def state_differences(a, b):
  """Where two snapshots differ, bit for bit: the step, every state_dict
  entry of the module (parameters and running averages) and every buffer
  of the optimizer's state. An empty list when they are equal."""
  out = []
  if a["step"] != b["step"]:
    out.append(f"step {a['step']} != {b['step']}")
  if set(a["model"]) != set(b["model"]):
    out.append("module keys differ")
  for k, v in a["model"].items():
    if k in b["model"] and not torch.equal(v, b["model"][k]):
      out.append(f"module {k}")
  sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
  if set(sa) != set(sb):
    out.append(f"optimizer state for {sorted(sa)} != {sorted(sb)}")
  for i in sa:
    for k, v in sa[i].items():
      if k not in sb.get(i, {}) or not torch.equal(v, sb[i][k]):
        out.append(f"optimizer state {i}/{k}")
  return out


def resume_differences(root):
  """Six steps uninterrupted against three, a save, and three more from
  the checkpoint in a new BenchmarkCNN: the differences of their final
  checkpoints (state_differences)."""
  _run(os.path.join(root, "whole"), 6)
  _run(os.path.join(root, "arcs"), 3)
  stats = _run(os.path.join(root, "arcs"), 3)
  assert stats["global_step"] == 6
  whole, _, step_w = checkpoint.load_latest_checkpoint(
      os.path.join(root, "whole"))
  arcs, _, step_a = checkpoint.load_latest_checkpoint(
      os.path.join(root, "arcs"))
  assert step_w == step_a == 6
  return state_differences(whole, arcs)


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
  assert resume_differences(str(tmp_path)) == []


def test_planted_fault_fails_the_state_check(tmp_path):
  """A copy of the port whose restore leaves out the optimizer's state:
  the resumed run's momentum buffers differ, and the check says so."""
  copy = tmp_path / "copy"
  shutil.copytree(os.path.join(REPO, "kf_benchmarks_tpu_torch"),
                  copy / "kf_benchmarks_tpu_torch",
                  ignore=shutil.ignore_patterns("__pycache__", "csrc"))
  src = copy / "kf_benchmarks_tpu_torch" / "checkpoint.py"
  text = src.read_text()
  planted = text.replace('optimizer.load_state_dict(snapshot["optimizer"])',
                         "pass")
  assert planted != text
  src.write_text(planted)
  code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
          "import test_torch_checkpoint as t; "
          "print('DIFF', t.resume_differences(sys.argv[3]))")
  out = subprocess.run(
      [sys.executable, "-c", code, str(copy), os.path.join(REPO, "tests"),
       str(tmp_path / "runs")], capture_output=True, text=True, timeout=120,
      cwd=str(tmp_path), env={**os.environ, "OMP_NUM_THREADS": "2"})
  assert out.returncode == 0, out.stderr[-3000:]
  line = [x for x in out.stdout.splitlines() if x.startswith("DIFF")][-1]
  assert "optimizer state" in line, line
  assert "module" in line, line  # the momentum steers the weights too


def _module_and_optimizer(seed):
  model = _small_resnet()
  gen = torch.Generator().manual_seed(seed)
  module = model.make_module(10, torch.float32, generator=gen)
  opt = optimizers.get_optimizer(
      params_lib.make_params(optimizer="momentum", device="cpu"),
      module.parameters(), learning_rate=0.1)
  x = torch.randn(2, 32, 32, 3, generator=gen) * 60 + 127
  module.train()
  loss = model.loss_function(module(x), torch.tensor([1, 2]))
  loss.backward()
  opt.step()
  return module, opt


def test_round_trip_restores_every_tensor(tmp_path):
  module, opt = _module_and_optimizer(0)
  snap = checkpoint.savable_state(module, opt, 17, input_incarnation=2)
  path = checkpoint.save_checkpoint(str(tmp_path), snap)
  assert os.path.basename(path) == "model.ckpt-17.pt"
  other, other_opt = _module_and_optimizer(1)
  loaded = checkpoint.load_checkpoint(path)
  assert checkpoint.restore_state(other, other_opt, loaded) == 17
  assert loaded["input_incarnation"] == 2
  again = checkpoint.savable_state(other, other_opt, 17)
  assert state_differences(snap, again) == []
  # The running averages are in the module's state.
  assert any(k.endswith(".mean") for k in loaded["model"])


def test_moved_train_dir_resumes(tmp_path):
  """The index names files relative to its directory: a moved directory
  resumes where it was."""
  _run(tmp_path / "a", 2)
  shutil.move(str(tmp_path / "a"), str(tmp_path / "b"))
  path, step = checkpoint.latest_checkpoint(str(tmp_path / "b"))
  assert path == str(tmp_path / "b" / "model.ckpt-2.pt") and step == 2
  assert _run(tmp_path / "b", 1)["global_step"] == 3


def test_max_ckpts_to_keep_prunes(tmp_path):
  _run(tmp_path, 5, save_model_steps=1, max_ckpts_to_keep=2)
  assert [s for s, _ in checkpoint.all_checkpoints(str(tmp_path))] == [4, 5]


def test_a_save_on_the_last_step_is_not_repeated(tmp_path):
  """--save_model_steps 2 over 4 steps writes steps 2 and 4 once each:
  the final save finds step 4 already on disk."""
  stats = _run(tmp_path, 4, save_model_steps=2)
  assert len(stats["checkpoint_save_s"]) == 2
  assert [s for s, _ in checkpoint.all_checkpoints(str(tmp_path))] == [2, 4]


def test_torn_file_is_skipped_and_all_torn_raises(tmp_path, capsys):
  module, opt = _module_and_optimizer(0)
  for step in (1, 2):
    checkpoint.save_checkpoint(
        str(tmp_path), checkpoint.savable_state(module, opt, step))
  newest = tmp_path / "model.ckpt-2.pt"
  newest.write_bytes(newest.read_bytes()[:1000])
  snap, path, step = checkpoint.load_latest_checkpoint(str(tmp_path))
  assert step == 1 and path.endswith("model.ckpt-1.pt")
  assert snap["step"] == 1
  assert "skipping torn/corrupt checkpoint model.ckpt-2.pt" in \
      capsys.readouterr().out
  (tmp_path / "model.ckpt-1.pt").write_bytes(b"")
  with pytest.raises(checkpoint.CheckpointNotFoundException,
                     match="2 corrupt"):
    checkpoint.load_latest_checkpoint(str(tmp_path))
  with pytest.raises(checkpoint.CheckpointNotFoundException):
    checkpoint.load_latest_checkpoint(str(tmp_path / "missing"))
