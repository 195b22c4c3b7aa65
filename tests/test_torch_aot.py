"""The frozen forward export (kf_benchmarks_tpu_torch/aot.py) on the CPU.

The smallest port model that reaches K-B: the parity tests' small ResNet-50
v1.5 (full widths, blocks (1, 2, 1, 1): two stride-1 conv_b units, 10
classes) at batch 2 and 224 px, its weights one flax init converted by
convert.py, so the JAX package's ``export_forward`` / ``load_forward`` run
on the same weights. Tolerances:

* the loaded program against the port's in-process eval forward on the same
  batch: bitwise (the exported graph is the same op sequence, the kernels'
  custom ops running their plain versions on the CPU);
* against the JAX package's loaded program: f32, rtol 1e-4 with atol 1e-4
  of the largest logit (convolutions summed in other orders by the two
  frameworks; tests/test_torch_resnet.py's forward tolerance), for the
  float and the INT8 export (the two packages' int8 weights and scales are
  bitwise equal, tests/test_torch_quantization.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from kf_benchmarks_tpu import aot as jax_aot
from kf_benchmarks_tpu_torch import aot
from kf_benchmarks_tpu_torch import params as params_lib
from kf_benchmarks_tpu_torch import validation

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2


@pytest.fixture(scope="module")
def small_resnet():
  """(JAX model, flax variables, port model, port module (eval, f32),
  images (2, 224, 224, 3) f32 numpy)."""
  images, _ = tp.batch(BATCH, 224, seed=3)
  # The weights do not depend on the image size: initialised at 32 px.
  jmodel, variables = tp.jax_model_and_variables(
      np.zeros((1, 32, 32, 3), np.float32))
  jmodel.set_batch_size(BATCH)
  model, module = tp.port_module(variables)
  return jmodel, variables, model, module.eval(), images


def _export(small_resnet, path, **kw):
  _, _, model, module, _ = small_resnet
  return aot.export_forward(model, module.state_dict(), BATCH, str(path),
                            nclass=tp.NCLASS, **kw)


def _close(got, ref):
  np.testing.assert_allclose(got, ref, rtol=1e-4,
                             atol=1e-4 * np.abs(ref).max())


def test_export_load_matches_in_process_and_jax(small_resnet, tmp_path):
  jmodel, variables, _, module, images = small_resnet
  x = torch.from_numpy(images)
  with torch.no_grad():
    live = module(x)
  for quantize in (False, True):
    path = tmp_path / f"port_{quantize}.pt2"
    nbytes = _export(small_resnet, path, quantize=quantize)
    assert nbytes == os.path.getsize(path) > 0
    fn = aot.load_forward(str(path), expect_batch=BATCH,
                          expect_quantize="int8" if quantize else None)
    with torch.no_grad():
      got = fn(x).numpy()
    if not quantize:
      np.testing.assert_array_equal(got, live.numpy())
    jpath = str(tmp_path / f"jax_{quantize}.bin")
    jax_aot.export_forward(jmodel, variables, BATCH, jpath,
                           nclass=tp.NCLASS, quantize=quantize)
    ref = np.asarray(jax_aot.load_forward(jpath)(jnp.asarray(images)))
    _close(got, ref)


def test_int8_artifact_is_under_035_of_the_fp16_one(small_resnet, tmp_path):
  """INT8 stores 1 byte a large weight where FP16 (bf16 compute over f32
  weights, as the JAX package exports it) stores 4."""
  fp16 = _export(small_resnet, tmp_path / "fp16.pt2", dtype=torch.bfloat16)
  int8 = _export(small_resnet, tmp_path / "int8.pt2", dtype=torch.bfloat16,
                 quantize=True)
  assert int8 < 0.35 * fp16, (int8, fp16)


def test_sidecar_keys_equal_the_jax_sidecar(small_resnet, tmp_path):
  jmodel, variables, _, _, _ = small_resnet
  path = tmp_path / "p.pt2"
  _export(small_resnet, path, dtype=torch.bfloat16, quantize=True,
          fingerprint="abc", kv_page_size=8)
  jpath = str(tmp_path / "j.bin")
  jax_aot.export_forward(jmodel, variables, BATCH, jpath, nclass=tp.NCLASS,
                         dtype=jnp.bfloat16, quantize=True,
                         fingerprint="abc", kv_page_size=8)
  sig, jsig = aot.read_signature(str(path)), jax_aot.read_signature(jpath)
  assert sig == jsig  # same keys, and here the same values
  assert sig["quantize_mode"] == "int8" and sig["dtype"] == "bfloat16"
  assert aot.SIGNATURE_SUFFIX == jax_aot.SIGNATURE_SUFFIX
  assert aot.SIGNATURE_VERSION == jax_aot.SIGNATURE_VERSION


def test_mode_mismatch_raises_with_the_sidecar_diff_before_loading(
    small_resnet, tmp_path):
  """A bf16 caller pointed at an INT8 export fails on the sidecar diff,
  naming both sides and the exporting fingerprint, without reading the
  program: the artifact here is not even a program."""
  path = tmp_path / "int8.pt2"
  _export(small_resnet, path, quantize=True, fingerprint="f00d",
          kv_page_size=8)
  with open(path, "wb") as f:
    f.write(b"not a program")
  with pytest.raises(ValueError, match="quantize_mode") as err:
    aot.load_forward(str(path), expect_quantize=None, expect_kv_page_size=8)
  msg = str(err.value)
  assert "sidecar='int8'" in msg and "requested=None" in msg
  assert "exporting fingerprint f00d" in msg
  with pytest.raises(ValueError, match="kv_page_size"):
    aot.load_forward(str(path), expect_quantize="int8",
                     expect_kv_page_size=None)


def test_artifact_without_a_sidecar_loads(small_resnet, tmp_path):
  path = tmp_path / "plain.pt2"
  _export(small_resnet, path)
  sig = aot.read_signature(str(path))
  assert sig["quantize_mode"] is None and sig["kv_page_size"] is None
  os.remove(aot.signature_path(str(path)))
  # No sidecar: the mode cannot be checked, and the program still loads.
  fn = aot.load_forward(str(path), expect_quantize="int8")
  with torch.no_grad():
    assert fn(torch.zeros(BATCH, 224, 224, 3)).shape == (BATCH, tp.NCLASS)


def test_load_moves_the_program_to_the_callers_device(small_resnet,
                                                     tmp_path):
  """A program exported on one device loads onto another: its constants
  and device arguments move (here to the meta device, which runs the
  kernels' fakes), so the output lands there with the program's shape."""
  path = tmp_path / "cpu.pt2"
  _export(small_resnet, path, quantize=True)
  fn = aot.load_forward(str(path), device="meta")
  out = fn(torch.zeros(BATCH, 224, 224, 3, device="meta"))
  assert out.device.type == "meta" and out.shape == (BATCH, tp.NCLASS)


def test_batch_mismatch_lists_the_sibling_batch_sizes(small_resnet,
                                                      tmp_path):
  _, _, model, module, _ = small_resnet
  path = str(tmp_path / "b2.pt2")
  _export(small_resnet, path, fingerprint="fp2")
  # A sibling export at batch 1 in the same directory.
  aot.export_forward(model, module.state_dict(), 1, str(tmp_path / "b1.pt2"),
                     nclass=tp.NCLASS)
  model.set_batch_size(BATCH)
  assert aot.sibling_batch_sizes(path) == [1, 2]
  with pytest.raises(ValueError, match=r"batch 3") as err:
    aot.load_forward(path, expect_batch=3)
  assert "Available exported batch size(s) here: [1, 2]" in str(err.value)
  assert "fingerprint fp2" in str(err.value)
  with pytest.raises(ValueError, match="shape"):
    aot.load_forward(path, expect_shape=(BATCH, 299, 299, 3))


def test_exported_graph_holds_the_kernel_op(small_resnet, tmp_path):
  """The program calls K-B's custom op once a stride-1 conv_b (two in this
  ResNet, 13 in ResNet-50), and holds no plain decomposition of it (the
  plain K-B is nine shifted matmuls): the loaded program launches the
  kernel on the card."""
  path = tmp_path / "g.pt2"
  _export(small_resnet, path, quantize=True)
  program = torch.export.load(str(path))
  targets = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
  assert targets.count("kf_torch.bn_relu_conv3x3_stats.default") == 2
  assert not any(t.startswith("aten.mm") for t in targets), targets
  # Under INT8 the program's constants are int8 weights and f32 scales.
  dtypes = {t.dtype for t in program.state_dict.values()}
  assert torch.int8 in dtypes


@pytest.mark.parametrize("kw,needle", [
    (dict(trt_mode="INT4"), "unknown mode"),
    (dict(trt_mode="FP16"), "requires --forward_only with --aot_save_path"),
    (dict(aot_load_path="x"), "--aot_load_path requires --forward_only"),
    (dict(aot_save_path="x"), "--aot_save_path requires --forward_only"),
    (dict(forward_only=True, aot_load_path="x", aot_save_path="y"),
     "At most one of --aot_load_path and --aot_save_path"),
])
def test_aot_flag_refusals_carry_the_jax_wording(kw, needle):
  with pytest.raises(validation.ParamError, match=needle):
    validation.validate_cross_flags(params_lib.make_params(
        model="resnet50", device="cpu", **kw))


@pytest.mark.parametrize("kw,needle", [
    (dict(model="transformer_lm"), "transformer_lm serves"),
    (dict(model="resnet50", num_devices=2), "one device"),
])
def test_aot_outside_the_image_forward_is_refused(kw, needle):
  """The port's narrowing: the export freezes one replica's image-model
  forward."""
  with pytest.raises(validation.ParamError, match=needle):
    validation.validate_aot_flags(params_lib.make_params(
        device="cpu", forward_only=True, aot_save_path="x", **kw))


def test_fp32_export_on_the_card_is_refused_naming_its_item():
  with pytest.raises(validation.ParamError, match="Queue 2 item 2"):
    validation.validate_aot_flags(params_lib.make_params(
        model="resnet50", device="gpu", use_fp16=True, forward_only=True,
        aot_save_path="x", trt_mode="FP32"))
  # The parity no-ops are defined, with the JAX package's defaults.
  p = params_lib.make_params()
  assert p.trt_max_workspace_size_bytes == 4 << 30
  assert p.freeze_when_forward_only is False and p.trt_mode == ""


def test_cli_exports_and_a_fresh_process_loads(tmp_path):
  """--forward_only --aot_save_path in one process, --aot_load_path in a
  fresh one (the INT8 export at --trt_mode=INT8), and a load that asks
  for the float mode fails on the sidecar diff."""
  path = str(tmp_path / "r50_int8.pt2")
  common = [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
            "--model=resnet50", "--forward_only", "--device=cpu",
            "--batch_size=1", "--num_batches=1", "--num_warmup_batches=0",
            "--trt_mode=INT8"]
  env = {**os.environ, "PYTHONPATH": REPO}
  run = lambda *a: subprocess.run(list(common[:-1]) + list(a), env=env,
                                  cwd=REPO, capture_output=True, text=True,
                                  timeout=300)
  save = run("--trt_mode=INT8", f"--aot_save_path={path}")
  assert save.returncode == 0, save.stdout + save.stderr
  assert "Exported frozen forward program to" in save.stdout
  assert "INT8 serving precision" in save.stdout
  load = run("--trt_mode=INT8", f"--aot_load_path={path}")
  assert load.returncode == 0, load.stdout + load.stderr
  assert "Loaded frozen forward program from" in load.stdout
  assert "total images/sec:" in load.stdout
  wrong = run(f"--aot_load_path={path}")
  assert wrong.returncode != 0
  assert "sidecar='int8', requested=None" in wrong.stderr
