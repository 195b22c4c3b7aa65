"""NCF (NeuMF) of the port (models/official_ncf_model.py) against the JAX
package's, on the CPU in f32, at 300 users and 200 items (full widths):
logits, the loss (the softmax against a column of ones), the accuracy
(``logit > 1.0``) and every gradient, from one converted flax init and one
numpy batch of ids; the full-size variables' names and shapes against
``jax.eval_shape``; and the ids' path under ``--use_fp16``: a step of the
port's benchmark at bf16, K = 1 and K = 2, hands the embedding lookups the
synthetic ids unchanged, ids above 2^8 among them (a bf16 cast would merge
them: bf16 keeps 8 significant bits).

Tolerances: logits and loss within 1e-5 relative, gradients within 1e-5
in relative L2 (a two-layer product and gathers: f32 sums of a few hundred
terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import official_ncf_model as jax_ncf
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import official_ncf_model as port_ncf

torch.set_num_threads(2)

USERS, ITEMS, BATCH = 300, 200, 64
TOL = 1e-5


def _ids(seed=0):
  rng = np.random.default_rng(seed)
  ids = np.stack([rng.integers(0, USERS, BATCH),
                  rng.integers(0, ITEMS, BATCH)], 1).astype(np.int32)
  return ids, rng.integers(0, 2, BATCH).astype(np.int32)


def _rel(a, b):
  return float(np.linalg.norm(np.asarray(a, np.float64) - b) /
               np.linalg.norm(np.asarray(b, np.float64)))


def test_neumf_matches_jax():
  ids, labels = _ids()
  jmod = jax_ncf._NeuMFModule(num_users=USERS, num_items=ITEMS)
  variables = jax.device_get(jmod.init(jax.random.PRNGKey(0),
                                       jnp.asarray(ids)))
  jmodel = jax_ncf.NcfModel()

  def loss_fn(params):
    logits = jmod.apply({"params": params}, jnp.asarray(ids))
    result = BuildNetworkResult(logits=logits, extra_info=None)
    loss = jmodel.loss_function(result, jnp.asarray(labels))
    return loss, (logits[0], jmodel.accuracy_function(
        result, jnp.asarray(labels)))

  (jloss, (jlogits, jacc)), jgrads = jax.value_and_grad(
      loss_fn, has_aux=True)(variables["params"])
  pnet = port_ncf.NeuMF(torch.float32, num_users=USERS, num_items=ITEMS)
  pnet.load_state_dict(convert.flax_to_state_dict(variables, pnet))
  pmodel = port_ncf.NcfModel()
  y = torch.from_numpy(labels)
  logits = pnet(torch.from_numpy(ids))
  loss = pmodel.loss_function(logits, y)
  loss.backward()
  acc = pmodel.accuracy_function(logits, y)
  assert _rel(logits.detach().numpy(), np.asarray(jlogits)) < TOL
  assert abs(float(loss) - float(jloss)) < TOL * abs(float(jloss))
  assert float(acc["top_1_accuracy"]) == float(jacc["top_1_accuracy"])
  assert float(acc["top_5_accuracy"]) == 1.0
  # The accuracy's rule itself: a logit of exactly 1.0 predicts 0.
  edge = torch.tensor([[1.0], [1.0001], [0.5]])
  assert pmodel.accuracy_function(edge, torch.tensor([0, 1, 0]))[
      "top_1_accuracy"] == 1.0
  for key, t in pnet.named_parameters():
    path, kind, _ = convert.flax_source(key, t, pnet)
    g = convert.to_port_layout(np.asarray(jgrads[path[1]][path[2]]), kind)
    assert _rel(t.grad.numpy(), g) < TOL, key


def test_full_size_variables_are_the_jax_packages():
  jmodel = jax_ncf.NcfModel()
  pmodel = model_config.get_model_config("ncf", None, "imagenet")
  assert (pmodel.get_name(), pmodel.batch_size, pmodel.learning_rate) == (
      jmodel.get_name(), jmodel.batch_size, jmodel.learning_rate)
  assert pmodel.get_input_shapes("train") == jmodel.get_input_shapes("train")
  shapes = jax.eval_shape(lambda: jmodel.make_module(2, True).init(
      jax.random.PRNGKey(0), jnp.zeros((2, 2), jnp.int32)))
  with torch.device("meta"):
    pnet = pmodel.make_module(2)
  seen = set()
  for key, t in pnet.state_dict().items():
    path, kind, _ = convert.flax_source(key, t, pnet)
    want = convert.to_port_layout(np.zeros(
        shapes[path[0]][path[1]][path[2]].shape, np.int8), kind).shape
    assert tuple(t.shape) == want, key
    seen.add(path)
  assert seen == {("params", l, k) for l in shapes["params"]
                  for k in shapes["params"][l]}


@pytest.mark.parametrize("k", [1, 2])
def test_ids_reach_the_embeddings_unchanged_under_use_fp16(k, monkeypatch):
  seen = []
  orig = port_ncf.Embedding.forward

  def noting(self, ids, dtype):
    seen.append(ids.clone())
    assert dtype == torch.bfloat16
    return orig(self, ids, dtype)

  monkeypatch.setattr(port_ncf.Embedding, "forward", noting)
  p = port_params.make_params(
      model="ncf", device="cpu", use_fp16=True, batch_size=16,
      num_batches=2, num_warmup_batches=0, steps_per_dispatch=k,
      display_every=1)
  bench = benchmark.BenchmarkCNN(p)
  stats = bench.run()
  assert np.isfinite(stats["last_average_loss"])
  images = bench.final["images"]
  assert images.dtype == torch.int32
  users, items = images[:, 0].long(), images[:, 1].long()
  assert int(users.max()) > 2 ** 8 and int(items.max()) > 2 ** 8
  # Four lookups a forward (two of users, two of items), every one the
  # synthetic ids, bit for bit.
  assert len(seen) == 4 * 2
  for i, ids in enumerate(seen):
    torch.testing.assert_close(ids, users if i % 2 == 0 else items,
                               rtol=0, atol=0)
  # bf16 would have merged them.
  assert not torch.equal(users.to(torch.bfloat16).long(), users)
