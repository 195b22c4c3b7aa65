"""The weight bridge maps every flax leaf of the JAX package's models onto
the port's state_dict exactly once, in the port's layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.models import trivial_model as jax_trivial
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet
from kf_benchmarks_tpu_torch.models import trivial_model as port_trivial

torch.set_num_threads(2)


def _flax_tree(model, size, nclass):
  """Distinct random values in the shapes of the model's flax variables
  (shapes by jax.eval_shape: no network is run)."""
  module = model.make_module(nclass=nclass, phase_train=True)
  shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))
  rng = np.random.default_rng(0)
  return jax.tree.map(
      lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _pair(name):
  if name == "resnet50":
    return (jax_resnet.create_resnet50_model(), 64,
            port_resnet.create_resnet50_model())
  return jax_trivial.TrivialModel(), 227, port_trivial.TrivialModel()


@pytest.mark.parametrize("name", ["resnet50", "trivial"])
def test_every_flax_leaf_maps_exactly_once(name):
  jmodel, size, pmodel = _pair(name)
  tree = _flax_tree(jmodel, size, 1001)
  module = pmodel.make_module(1001, torch.float32)
  state = convert.flax_to_state_dict(tree, module)
  n_leaves = len(jax.tree_util.tree_leaves(tree))
  assert len(state) == n_leaves == len(module.state_dict())
  module.load_state_dict(state)  # strict: every key, every shape
  seen = set()
  for key, value in module.state_dict().items():
    collection, layer, leaf, kind = convert.leaf_of(key, value)
    assert (collection, layer, leaf) not in seen
    seen.add((collection, layer, leaf))
    np.testing.assert_array_equal(
        convert.to_flax_layout(value.numpy(), kind),
        tree[collection][layer][leaf])


def test_resnet50_layout_and_names():
  jmodel, size, pmodel = _pair("resnet50")
  tree = _flax_tree(jmodel, size, 1001)
  module = pmodel.make_module(1001, torch.float32)
  state = convert.flax_to_state_dict(tree, module)
  # Conv HWIO -> OIHW, Dense (in, out) -> (out, in), BN leaves as they are.
  np.testing.assert_array_equal(
      state["conv_stem.weight"].numpy(),
      np.transpose(tree["params"]["conv_stem"]["kernel"], (3, 2, 0, 1)))
  np.testing.assert_array_equal(state["affine0.weight"].numpy(),
                                tree["params"]["affine0"]["kernel"].T)
  np.testing.assert_array_equal(
      state["blocks.15.c_bn.var"].numpy(),
      tree["batch_stats"]["resnet_v115_c_bn"]["var"])
  assert len(module.blocks) == 16
  assert sum(b.fused for b in module.blocks) == 13


def test_missing_and_extra_leaves_raise():
  jmodel, size, pmodel = _pair("trivial")
  tree = _flax_tree(jmodel, size, 10)
  module = pmodel.make_module(10, torch.float32)
  short = {"params": dict(tree["params"])}
  del short["params"]["affine1"]
  with pytest.raises(KeyError, match="affine1"):
    convert.flax_to_state_dict(short, module)
  extra = {"params": dict(tree["params"])}
  extra["params"]["affine9"] = {"bias": np.zeros(3, np.float32)}
  with pytest.raises(KeyError, match="affine9"):
    convert.flax_to_state_dict(extra, module)


@pytest.mark.parametrize("port,flax", [
    ("conv_stem", "conv_stem"), ("conv_stem_bn", "conv_stem_bn"),
    ("blocks.0.a", "resnet_v10_a"), ("blocks.7.b_bn", "resnet_v17_b_bn"),
    ("blocks.12.shortcut_bn", "resnet_v112_shortcut_bn"),
    ("affine0", "affine0")])
def test_layer_names(port, flax):
  assert convert.flax_layer_name(port) == flax


def _lm_pair(scan):
  from kf_benchmarks_tpu.models import transformer_lm as jax_lm
  from kf_benchmarks_tpu_torch.models import transformer_lm as port_lm
  jmodule = jax_lm._TransformerLMModule(
      vocab=64, d_model=16, n_layers=3, n_heads=2, d_ff=32, attn_block=8,
      max_len=16, scan_layers=scan)
  shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 16), jnp.int32))
  rng = np.random.default_rng(1)
  tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                      shapes)
  module = port_lm.TransformerLM(64, 16, 3, 2, 32, 8, 8, "tiled", scan,
                                 True, 16, torch.float32)
  return tree, module


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "loop"])
def test_lm_every_flax_leaf_maps_exactly_once(scan):
  """The scanned stack (leading layer axis) and the loop layout's block_<i>
  both land on blocks.<i>.<sub>; LayerNorm scale/bias -> weight/bias,
  Dense kernels transposed, embed/pos_embedding/lm_head as they are."""
  tree, module = _lm_pair(scan)
  state = convert.flax_to_state_dict(tree, module)
  module.load_state_dict(state)  # strict: every key, every shape
  flat = convert._flatten(tree)
  n_leaves = sum(v.shape[0] if scan and p[1] == "blocks" else 1
                 for p, v in flat.items())
  assert len(state) == n_leaves
  for key, value in module.state_dict().items():
    path, kind, index = convert.flax_source(key, value, module)
    ref = flat[path] if index is None else flat[path][index]
    np.testing.assert_array_equal(
        convert.to_flax_layout(value.numpy(), kind), ref)
  p = tree["params"]
  blk = (lambda i, sub: jax.tree.map(lambda a: a[i], p["blocks"][sub])) \
      if scan else (lambda i, sub: p[f"block_{i}"][sub])
  np.testing.assert_array_equal(state["blocks.2.qkv.weight"].numpy(),
                                blk(2, "qkv")["kernel"].T)
  np.testing.assert_array_equal(state["blocks.1.ln2.weight"].numpy(),
                                blk(1, "ln2")["scale"])
  np.testing.assert_array_equal(state["embed.weight"].numpy(),
                                p["embed"]["embedding"])
  assert state["lm_head"].shape == (16, 64)  # (d_model, vocab), as in flax


def test_lm_missing_layer_and_extra_leaf_raise():
  tree, module = _lm_pair(True)
  short = jax.tree.map(lambda a: a, tree)
  short["params"]["blocks"]["mlp_up"]["bias"] = \
      tree["params"]["blocks"]["mlp_up"]["bias"][:2]
  with pytest.raises(KeyError, match="mlp_up/bias\\[2\\]"):
    convert.flax_to_state_dict(short, module)
  extra = jax.tree.map(lambda a: a, tree)
  extra["params"]["blocks"]["mlp_up"]["bias"] = np.concatenate(
      [tree["params"]["blocks"]["mlp_up"]["bias"],
       np.zeros((1, 32), np.float32)])
  with pytest.raises(KeyError, match="mlp_up/bias layers \\[3\\]"):
    convert.flax_to_state_dict(extra, module)
  extra = jax.tree.map(lambda a: a, tree)
  extra["params"]["head_bias"] = np.zeros(64, np.float32)
  with pytest.raises(KeyError, match="head_bias"):
    convert.flax_to_state_dict(extra, module)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "loop"])
def test_serving_tree_maps_onto_the_served_module(scan):
  """The serving weights (serving/decode.py ``init_variables``: the
  ``_TransformerLMModule`` tree, scanned ``blocks`` or ``block_<i>``) load
  strictly into the port's served module, which runs both the forward and
  the decode step from the same parameters."""
  from kf_benchmarks_tpu.serving import decode as jax_decode
  from kf_benchmarks_tpu_torch.serving import decode as port_decode
  kw = dict(vocab=97, d_model=32, n_layers=3, n_heads=4, d_ff=64,
            max_len=16, attn_block=8, scan_layers=scan)
  variables = jax.device_get(
      jax_decode.init_variables(jax_decode.LMSpec(**kw), seed=2))
  module = port_decode.forward_module(port_decode.LMSpec(**kw))
  state = convert.flax_to_state_dict(variables, module)
  module.load_state_dict(state)  # strict: every key, every shape
  p = variables["params"]
  qkv = (p["blocks"]["qkv"]["kernel"][2] if scan
         else p["block_2"]["qkv"]["kernel"])
  np.testing.assert_array_equal(state["blocks.2.qkv.weight"].numpy(),
                                np.asarray(qkv).T)
  np.testing.assert_array_equal(state["pos_embedding"].numpy(),
                                p["pos_embedding"])
  # embed, pos_embedding, ln_f (2), lm_head; 11 a block (ln1 2, qkv 1,
  # attn_out 2, ln2 2, mlp_up 2, mlp_down 2).
  assert len(state) == 5 + 3 * 11
