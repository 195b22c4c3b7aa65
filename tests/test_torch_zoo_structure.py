"""Every model of the port's image-classification zoo at full width against
the JAX package's, by structure: the JAX network's parameter and
batch-statistics tree (``jax.eval_shape`` of its init, so nothing is
computed) and the port's state_dict (built on the meta device, which
allocates nothing) map one to one through convert.py, with the same
shapes. Numbers are held in tests/test_torch_zoo_models.py.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from kf_benchmarks_tpu.models import model_config as jax_model_config
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch.models import model_config

NCLASS = 10
# Held by structure in files of their own: NASNet's JAX init draws its
# drop-path noise (tests/test_torch_nasnet.py) and NCF takes ids, not
# images (tests/test_torch_ncf.py).
OWN_FILES = {"imagenet": {"nasnet", "nasnetlarge", "ncf"},
             "cifar10": {"nasnet"}}
_ZOO = [(d, n) for d in ("imagenet", "cifar10")
        for n in sorted(set(jax_model_config.list_models(d)) - OWN_FILES[d])
        if n != "transformer_lm"]


def _jax_shapes(jmodel):
  module = jmodel.make_module(nclass=NCLASS, phase_train=True)
  size = jmodel.image_size
  shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, size, size, 3),
                                               jnp.float32))
  out = {}
  for collection, tree in shapes.items():
    for layer, leaves in tree.items():
      for leaf, v in leaves.items():
        out[(collection, layer, leaf)] = tuple(v.shape)
  return out


@pytest.mark.parametrize("dataset,name", _ZOO,
                         ids=[f"{d}-{n}" for d, n in _ZOO])
def test_full_width_structure_matches_jax(dataset, name):
  """Every layer of the full-size network, by name and shape (no
  arithmetic: JAX's init is traced, the port's built on meta)."""
  want = _jax_shapes(jax_model_config.get_model_config(name, dataset))
  pmodel = model_config.get_model_config(name, None, dataset)
  with torch.device("meta"):
    module = pmodel.make_module(NCLASS)
  got = {}
  for key, t in module.state_dict().items():
    path, kind, index = convert.flax_source(key, t, module)
    assert index is None
    shape = tuple(t.shape)
    if kind == "conv":
      shape = (shape[2], shape[3], shape[1], shape[0])
    elif kind == "dense":
      shape = (shape[1], shape[0])
    got[path] = shape
  assert got == want
