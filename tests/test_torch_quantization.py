"""The port's INT8 weight quantization against the JAX package's, on the CPU.

kf_benchmarks_tpu_torch/quantization.py quantizes the port's state dicts
with the JAX package's rule (kf_benchmarks_tpu/quantization.py) applied to
each weight's flax view, grouping the LM's per-layer tensors as the JAX
scanned stack. Tolerance: none -- q and scale are compared BITWISE with the
JAX ``quantize_variables`` (the same f32 absmax, division, half-to-even
rounding and clip), for every leaf of the full-size transformer_lm
(including the cross-layer scales of the scanned stack and the quantized
``blocks/mlp_up/bias``) and of a converted full-width ResNet-50, both ways
through convert.py's quantized-leaf bridge. The float leaves and the
helper values (``has_quantized_leaves``, ``quantized_fraction``) are
compared exactly as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import quantization as jax_q
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.serving import decode as jax_decode
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import quantization as port_q
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet
from kf_benchmarks_tpu_torch.serving import decode as port_decode

torch.set_num_threads(4)


def _flat(tree, prefix=()):
  """{path: leaf} with the {__int8__, __scale__} dicts kept as leaves."""
  out = {}
  for name, value in tree.items():
    if isinstance(value, dict) and "__int8__" not in value:
      out.update(_flat(value, prefix + (name,)))
    else:
      out[prefix + (name,)] = value
  return out


def _assert_trees_bitwise(jax_tree, port_tree):
  """Every leaf equal bitwise; returns the quantized leaves' paths."""
  a, b = _flat(jax.device_get(jax_tree)), _flat(port_tree)
  assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
  quantized = []
  for path in a:
    x, y = a[path], b[path]
    assert isinstance(x, dict) == isinstance(y, dict), path
    if isinstance(x, dict):
      quantized.append("/".join(path))
      for key in ("__int8__", "__scale__"):
        xv, yv = np.asarray(x[key]), np.asarray(y[key])
        assert xv.dtype == yv.dtype and xv.shape == yv.shape, (path, key)
        assert np.array_equal(xv, yv), (path, key)
    else:
      assert np.array_equal(np.asarray(x, np.float32),
                            np.asarray(y, np.float32)), path
  return sorted(quantized)


def _assert_states_equal(a, b):
  assert a.keys() == b.keys()
  for key in a:
    x, y = a[key], b[key]
    assert port_q.is_quantized(x) == port_q.is_quantized(y), key
    if port_q.is_quantized(x):
      assert torch.equal(x.q, y.q) and torch.equal(x.scale, y.scale), key
      assert x.q.dtype == torch.int8 and x.scale.dtype == torch.float32
    else:
      assert torch.equal(x, y), key


@pytest.fixture(scope="module")
def full_lm():
  """The full-size LM (vocab 32768, d 512, 6 layers): flax variables, the
  JAX quantized tree, the port module and its converted state."""
  jspec, pspec = jax_decode.LMSpec(), port_decode.LMSpec()
  variables = jax.device_get(jax_decode.init_variables(jspec, seed=0))
  module = port_decode.forward_module(pspec)
  state = convert.flax_to_state_dict(variables, module)
  return variables, jax_q.quantize_variables(variables), module, state, pspec


def test_full_size_lm_quantization_is_bitwise_the_jax_package(full_lm):
  variables, jq, module, state, pspec = full_lm
  pq = port_q.quantize_variables(state, port_decode.leaf_sources(pspec))
  quantized = _assert_trees_bitwise(jq, convert.state_dict_to_flax(pq,
                                                                   module))
  # The scanned stack's kernels, mlp_up's (6, 2048) bias, the embeddings
  # and the head; the layer norms and the small biases stay float.
  assert quantized == [
      "params/blocks/attn_out/kernel", "params/blocks/mlp_down/kernel",
      "params/blocks/mlp_up/bias", "params/blocks/mlp_up/kernel",
      "params/blocks/qkv/kernel", "params/embed/embedding",
      "params/lm_head", "params/pos_embedding"]
  # One scale per output feature shared by the six layers: every layer's
  # entry holds the same scale (over (L, in), JAX's axes (0, 1)).
  for sub in ("qkv", "mlp_up", "attn_out", "mlp_down"):
    scales = [pq[f"blocks.{i}.{sub}.weight"].scale for i in range(6)]
    assert all(torch.equal(s, scales[0]) for s in scales)
  ref = np.asarray(jq["params"]["blocks"]["qkv"]["kernel"]["__scale__"])
  assert ref.shape == (1536,)
  np.testing.assert_array_equal(pq["blocks.3.qkv.weight"].scale[:, 0], ref)
  # The bridge the other way: the JAX tree in the port's layout.
  _assert_states_equal(convert.flax_to_quantized_state(jq, module), pq)
  assert port_q.quantized_fraction(pq) == jax_q.quantized_fraction(jq)
  assert port_q.has_quantized_leaves(pq) and \
      jax_q.has_quantized_leaves(jq)
  assert not port_q.has_quantized_leaves(state)


def test_resnet50_quantization_is_bitwise_the_jax_package():
  """Full-width ResNet-50 v1.5 (1001 classes; initialised at 32 px, the
  weights do not depend on the image size): HWIO kernels against the
  port's OIHW weights, the per-output-channel axis moved accordingly."""
  model = jax_resnet.ResnetModel("resnet50_v1.5", (3, 4, 6, 3))
  jmodule = model.make_module(nclass=1001, phase_train=True)
  variables = jax.device_get(jmodule.init(
      jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
  module = port_resnet.ResnetModel("resnet50_v1.5",
                                   (3, 4, 6, 3)).make_module(1001)
  state = convert.flax_to_state_dict(variables, module)
  pq = port_q.quantize_variables(
      state, lambda k, t: convert.flax_source(k, t, module))
  jq = jax_q.quantize_variables(variables)
  quantized = _assert_trees_bitwise(jq, convert.state_dict_to_flax(pq,
                                                                   module))
  # All 53 convs (the stem's 7x7 over 3 channels has 9408 elements) and
  # affine0's kernel; the batch norms stay float.
  assert len(quantized) == 54
  assert "params/affine0/kernel" in quantized
  _assert_states_equal(convert.flax_to_quantized_state(jq, module), pq)
  w = pq["blocks.4.b.weight"]
  assert w.q.shape == (128, 128, 3, 3) and w.scale.shape == (128, 1, 1, 1)
  assert port_q.quantized_fraction(pq) == jax_q.quantized_fraction(jq)


def test_dequantize_round_trips_and_passes_float_leaves():
  """|w - q * scale| <= scale / 2 per output channel, in f32 (tol 1e-7,
  the JAX package's own bound); float entries come back as they went in
  (the same tensor); dequantizing to bf16 rounds q * scale once."""
  g = torch.Generator().manual_seed(0)
  w = torch.randn(64, 128, generator=g) * torch.linspace(0.1, 3.0, 64)[:, None]
  bias = torch.randn(64, generator=g)
  q = port_q.quantize_variables({"d.weight": w, "d.bias": bias}, min_elems=1,
                                sources=lambda k, t: (
                                    (k,), "dense" if t.dim() == 2 else "copy",
                                    None))
  assert q["d.bias"] is bias  # 1-D: passes through
  back = port_q.dequantize_variables(q)
  assert back["d.bias"] is bias
  scale = w.abs().amax(1) / 127.0
  err = (back["d.weight"] - w).abs().amax(1)
  assert bool((err <= scale / 2 + 1e-7).all())
  bf = port_q.dequantize_variables(q, torch.bfloat16)["d.weight"]
  assert bf.dtype == torch.bfloat16
  assert torch.equal(bf, back["d.weight"].to(torch.bfloat16))


def test_small_and_nonfloat_leaves_pass_through():
  """The JAX package's pass-through rule on each entry: not float, fewer
  than 2 axes, or fewer than MIN_QUANT_ELEMS elements."""
  leaves = {"ints": np.arange(8192, dtype=np.int32).reshape(64, 128),
            "vec": np.ones(8192, np.float32),
            "small": np.ones((63, 64), np.float32),
            "big": np.ones((64, 64), np.float32)}
  jq = jax_q.quantize_variables({k: jnp.asarray(v) for k, v in
                                 leaves.items()})
  pq = port_q.quantize_variables({k: torch.from_numpy(v) for k, v in
                                  leaves.items()})
  for key in leaves:
    assert isinstance(jq[key], dict) == port_q.is_quantized(pq[key]), key
  assert port_q.is_quantized(pq["big"])
  assert [k for k in leaves if not port_q.is_quantized(pq[k])] == \
      ["ints", "vec", "small"]
  assert port_q.MIN_QUANT_ELEMS == jax_q.MIN_QUANT_ELEMS
  assert port_q.DEPTHWISE_MULTIPLIER_MAX == jax_q.DEPTHWISE_MULTIPLIER_MAX


@pytest.mark.parametrize("mult", [1, 2])
def test_depthwise_kernel_gets_the_jax_per_channel_scales(mult):
  """A TF-layout depthwise kernel (h, w, in, multiplier) quantizes in the
  JAX package with one scale per (in, multiplier) channel over (h, w).
  The port keeps depthwise weights as (in*mult, 1, h, w) (output channel
  i*mult + m), which is the flax depthwise layout (h, w, 1, in*mult) under
  convert.py's conv transpose: its scales are the same values, bitwise,
  and so are q."""
  rng = np.random.default_rng(mult)
  c = 64
  w_tf = (rng.normal(size=(3, 3, c, mult)) *
          np.linspace(0.01, 4.0, c)[None, None, :, None]).astype(np.float32)
  jq = jax_q.quantize_variables({"dw": jnp.asarray(w_tf)}, min_elems=1)["dw"]
  assert np.asarray(jq["__scale__"]).shape == (c, mult)
  w_port = torch.from_numpy(
      np.ascontiguousarray(w_tf.transpose(2, 3, 0, 1).reshape(c * mult, 1,
                                                              3, 3)))
  pq = port_q.quantize_variables(
      {"dw.weight": w_port}, min_elems=1,
      sources=lambda k, t: ((k,), "conv", None))["dw.weight"]
  assert pq.scale.shape == (c * mult, 1, 1, 1)
  np.testing.assert_array_equal(pq.scale.reshape(c, mult).numpy(),
                                np.asarray(jq["__scale__"]))
  np.testing.assert_array_equal(
      pq.q.reshape(c, mult, 3, 3).permute(2, 3, 0, 1).numpy(),
      np.asarray(jq["__int8__"]))
  # The rule itself, on the flax views: TF layout reduces (h, w) only.
  assert port_q._scale_axes((3, 3, c, mult)) == (0, 1)
  assert port_q._scale_axes((3, 3, 1, c * mult)) == (0, 1, 2)


def test_bf16_weights_take_their_absmax_in_f32():
  """A bf16 weight (--fp16_vars) is upcast before the absmax and the
  division, as the JAX package upcasts: q and scale bitwise equal."""
  rng = np.random.default_rng(3)
  w = rng.normal(size=(96, 64)).astype(np.float32)
  jq = jax_q.quantize_variables({"k": jnp.asarray(w, jnp.bfloat16)})["k"]
  pw = torch.from_numpy(w).to(torch.bfloat16)
  pq = port_q.quantize_variables({"k": pw})["k"]
  np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq["__int8__"]))
  np.testing.assert_array_equal(pq.scale[0].numpy(),
                                np.asarray(jq["__scale__"]))


def test_prepare_variables_is_idempotent():
  """serving's prepare_variables quantizes a float state once; a
  quantized state passes through as the same object (int8 entries
  quantized again would corrupt the scales)."""
  spec = port_decode.LMSpec(vocab=97, d_model=64, n_layers=2, n_heads=4,
                            d_ff=128, max_len=64, attn_block=16,
                            quantize="int8")
  state = port_decode.init_variables(spec, seed=0)
  q = port_decode.prepare_variables(spec, state)
  assert port_q.has_quantized_leaves(q)
  assert port_decode.prepare_variables(spec, q) is q
  plain = port_decode.LMSpec(vocab=97, d_model=64, n_layers=2, n_heads=4,
                             d_ff=128, max_len=64, attn_block=16)
  assert port_decode.prepare_variables(plain, state) is state
