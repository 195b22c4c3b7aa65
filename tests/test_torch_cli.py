"""The port's CLI end to end on the CPU, and its refusals."""

import re
import subprocess
import sys

import pytest
import torch

from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import validation

torch.set_num_threads(2)

# The reference's step line and total line (utils/log.py).
STEP_LINE = re.compile(r"^(\d+)\timages/sec: (\d+\.\d) \+/- (\d+\.\d) "
                       r"\(jitter = (\d+\.\d)\)\t(\d+\.\d{3})$")
TOTAL_LINE = re.compile(r"^total images/sec: \d+\.\d\d$")


@pytest.mark.parametrize("argv,steps", [
    (["--model=trivial", "--batch_size=2", "--num_batches=4",
      "--display_every=2", "--optimizer=momentum"], [2, 4]),
    (["--model=resnet50", "--batch_size=2", "--num_batches=2",
      "--display_every=1", "--optimizer=momentum"], [1, 2]),
], ids=["trivial", "resnet50"])
def test_cpu_run_prints_reference_lines(argv, steps, capsys):
  rc = cli.main(argv + ["--device=cpu", "--num_warmup_batches=1"])
  assert rc == 0
  out = capsys.readouterr().out.splitlines()
  step_lines = [m for m in map(STEP_LINE.match, out) if m]
  assert [int(m.group(1)) for m in step_lines] == steps
  assert all(float(m.group(5)) > 0 for m in step_lines)
  assert sum(bool(TOTAL_LINE.match(line)) for line in out) == 1
  assert "Step\tImg/sec\ttotal_loss" in out


def test_default_device_without_cuda_fails_loudly(capsys):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default run would start")
  rc = cli.main(["--model=resnet50", "--use_fp16"])
  assert rc != 0
  err = capsys.readouterr().err
  assert "--device=gpu" in err and "no CUDA device" in err


def test_module_entry_point_exits_nonzero_without_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default run would start")
  proc = subprocess.run(
      [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
       "--model=resnet50"], capture_output=True, text=True)
  assert proc.returncode != 0
  assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("overrides,match", [
    # DeepSpeech2 is a model of the LibriSpeech map only, as in the JAX
    # package, whose message the refusal carries.
    pytest.param({"model": "deepspeech2", "device": "cpu"},
                 "Invalid model name 'deepspeech2' for dataset 'imagenet'",
                 id="overrides0-not ported yet"),
    # Data parallel runs one rank per card: more ranks than cards is
    # refused (no shared card, no gloo fallback).
    ({"num_devices": 64, "device": "gpu"}, "one device"),
])
def test_validation_rejects_outside_the_slice(overrides, match):
  with pytest.raises(validation.ParamError, match=match):
    validation.validate_cross_flags(params_lib.make_params(**overrides))


@pytest.mark.parametrize("overrides", [
    {"optimizer": "adagrad"}, {"kungfu_option": "ada_sgd"},
    {"data_format": "NCHW"}, {"device": "tpu"},
    {"health_grad_norm_sigma": 0.0}])
def test_params_reject_unknown_values(overrides):
  with pytest.raises(ValueError):
    params_lib.make_params(**overrides)


def test_gpu_without_fp16_names_the_missing_variant(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  with pytest.raises(validation.ParamError, match="no\\s+f32 variant"):
    validation.validate_cross_flags(params_lib.make_params(model="resnet50"))
