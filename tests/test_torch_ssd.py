"""SSD300 of the port (models/ssd_model.py, ssd_dataloader.py,
ssd_constants.py) against the JAX package's, on the CPU.

* The anchors (``DefaultBoxes``, 8732), the IoU matrix, the box encoding
  and the label assignment are numpy in both packages: bitwise. The box
  decoding is torch in the port and jnp in the JAX package: within 2 f32
  ulps of the JAX values, or of 1 where the corners cancel (exp and the
  divisions round in each library's own way).
* The loss on given predictions and targets (smooth-L1 plus the
  hard-negative-mined cross-entropy) within 1e-6 relative, and its
  gradient within 1e-5 in relative L2; the mining's selection itself
  (which anchors count) equal.
* The heads' flatten order: the port's ``flatten_heads`` of NHWC head
  outputs equals the JAX module's reshape and concatenation.
* The rate schedule (host and device forms) and the synthetic batch's
  shapes and dtypes.
* Routing: the port's network runs 13 of its 3x3 convs as the fused unit
  (the second conv of each basic block), none of the heads.
* The whole SSD300 at 300 px, batch 1 (~10 s): logits and loss against
  the JAX package's from one converted init, within 1e-3 of the largest
  logit (ResNet-34's batch norms over one image amplify f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kf_benchmarks_tpu.models import ssd_dataloader as jax_dl
from kf_benchmarks_tpu.models import ssd_model as jax_ssd
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import ssd_constants
from kf_benchmarks_tpu_torch.models import ssd_dataloader as port_dl
from kf_benchmarks_tpu_torch.models import ssd_model as port_ssd

torch.set_num_threads(2)


def _boxes(rng, n):
  y0, x0 = rng.uniform(0, 0.6, n), rng.uniform(0, 0.6, n)
  h, w = rng.uniform(0.05, 0.4, n), rng.uniform(0.05, 0.4, n)
  return np.stack([y0, x0, y0 + h, x0 + w], 1).astype(np.float32)


def test_anchors_iou_and_coding_are_bitwise_the_jax_packages():
  for order in ("ltrb", "xywh"):
    np.testing.assert_array_equal(port_dl.DefaultBoxes()(order),
                                  jax_dl.DefaultBoxes()(order))
  assert port_dl.DefaultBoxes()("ltrb").shape == (8732, 4)
  rng = np.random.default_rng(0)
  a, b = _boxes(rng, 50), _boxes(rng, 7)
  np.testing.assert_array_equal(port_dl.calc_iou_matrix(a, b),
                                jax_dl.calc_iou_matrix(a, b))
  anchors = port_dl.DefaultBoxes()("xywh")[:50]
  cychw = port_dl._ltrb_to_cychw(a)
  np.testing.assert_array_equal(port_dl.encode_boxes(cychw, anchors),
                                jax_dl.encode_boxes(cychw, anchors))
  for n in (0, 1, 3, 9):
    gt = _boxes(rng, n)
    labels = rng.integers(1, 81, n)
    for x, y in zip(port_dl.encode_labels(gt, labels),
                    jax_dl.encode_labels(gt, labels)):
      np.testing.assert_array_equal(x, y)
  enc = rng.normal(size=(3, 8732, 4)).astype(np.float32)
  anchors = port_dl.DefaultBoxes()("xywh")
  got = port_dl.decode_boxes(torch.from_numpy(enc), anchors).numpy()
  want = np.asarray(jax_dl.decode_boxes(jnp.asarray(enc), anchors))
  # Two f32 ulps of the value, or of 1 where cy - h / 2 cancels.
  ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
  assert np.all(np.abs(got - want) <= 2 * ulp)


def _targets(rng, n):
  boxes, classes, matched = [], [], []
  for _ in range(n):
    k = int(rng.integers(1, 5))
    e, c, m = port_dl.encode_labels(_boxes(rng, k), rng.integers(1, 81, k))
    boxes.append(e)
    classes.append(c)
    matched.append(m)
  return np.stack(boxes), np.stack(classes), np.asarray(matched, np.float32)


def test_loss_on_given_predictions_matches_jax():
  rng = np.random.default_rng(1)
  n = 3
  logits = rng.normal(size=(n, 8732, 4 + 81)).astype(np.float32)
  boxes, classes, matched = _targets(rng, n)
  jmodel, pmodel = jax_ssd.SSD300Model(), port_ssd.SSD300Model()
  labels_j = (jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(matched))

  def jloss(lg):
    return jmodel.loss_function(BuildNetworkResult(
        logits=(lg, None), extra_info=None), labels_j)

  jl, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
  x = torch.from_numpy(logits).requires_grad_(True)
  pl = pmodel.loss_function(x, (torch.from_numpy(boxes),
                                torch.from_numpy(classes).long(),
                                torch.from_numpy(matched)))
  pl.backward()
  assert abs(float(pl) - float(jl)) <= 1e-6 * abs(float(jl))
  g, jg = x.grad.numpy(), np.asarray(jg)
  assert np.linalg.norm(g - jg) <= 1e-5 * np.linalg.norm(jg)
  # The mining selects the same anchors: the gradient is zero on the same
  # class logits.
  np.testing.assert_array_equal(np.abs(g[..., 4:]).sum(-1) == 0,
                                np.abs(jg[..., 4:]).sum(-1) == 0)


def test_heads_flatten_location_major_as_the_jax_module():
  rng = np.random.default_rng(2)
  n, label_num = 2, 5
  heads_nhwc = []
  for nd, s in zip(ssd_constants.NUM_DEFAULTS, ssd_constants.FEATURE_SIZES):
    heads_nhwc.append(rng.normal(size=(n, s, s, nd * 4)).astype(np.float32))
    heads_nhwc.append(rng.normal(size=(n, s, s, nd * label_num))
                      .astype(np.float32))
  # The JAX module's flatten (ssd_model.py:85-97 there).
  locs = [h.reshape(n, -1, 4) for h in heads_nhwc[0::2]]
  confs = [h.reshape(n, -1, label_num) for h in heads_nhwc[1::2]]
  want = np.concatenate([np.concatenate(locs, 1), np.concatenate(confs, 1)],
                        2)
  heads = [torch.from_numpy(h).permute(0, 3, 1, 2) for h in heads_nhwc]
  got = port_ssd.flatten_heads(heads, label_num).numpy()
  np.testing.assert_array_equal(got, want)
  assert got.shape == (n, 8732, 4 + label_num)


def test_rate_schedule_inputs_and_routing():
  jmodel, pmodel = jax_ssd.SSD300Model(), port_ssd.SSD300Model()
  for step in (0, 159999, 160000, 199999, 200000, 300000):
    for bs in (32, 64):
      want = float(jmodel.get_learning_rate(step, bs))
      assert pmodel.get_learning_rate(step, bs) == want
      assert float(pmodel.get_learning_rate(
          torch.tensor(float(step)), bs)) == want
  model = model_config.get_model_config("ssd300", None, "coco")
  model.set_batch_size(2)
  images, (boxes, classes, matched) = model.get_synthetic_inputs(
      torch.Generator().manual_seed(0), 81, torch.device("cpu"))
  assert images.shape == (2, 300, 300, 3) and images.dtype == torch.float32
  assert boxes.shape == (2, 8732, 4) and classes.shape == (2, 8732)
  assert matched.shape == (2,) and bool((matched >= 1).all())
  assert int(classes.max()) < 81 and int(classes.min()) == 0
  with torch.device("meta"):
    net = model.make_module(81)
  assert net.fused == [f"resblk{k}_b" for k in range(13)]
  assert model.bf16_kernels()


def test_whole_ssd300_matches_jax():
  rng = np.random.default_rng(3)
  x = rng.uniform(size=(1, 300, 300, 3)).astype(np.float32)
  boxes, classes, matched = _targets(rng, 1)
  jmodel = jax_ssd.SSD300Model()
  jmod = jmodel.make_module(81, phase_train=True)
  variables = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))

  def loss_fn(params):
    (logits, _), _ = jmod.apply(
        {"params": params, "batch_stats": variables["batch_stats"]},
        jnp.asarray(x), mutable=["batch_stats"])
    loss = jmodel.loss_function(BuildNetworkResult(
        logits=(logits, None), extra_info=None),
        (jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(matched)))
    return loss, logits

  jl, jlogits = jax.jit(loss_fn)(variables["params"])
  pmodel = port_ssd.SSD300Model()
  net = pmodel.make_module(81)
  net.load_state_dict(convert.flax_to_state_dict(variables, net))
  net.fuse = False
  net.train()
  logits = net(torch.from_numpy(x))
  loss = pmodel.loss_function(logits, (
      torch.from_numpy(boxes), torch.from_numpy(classes).long(),
      torch.from_numpy(matched)))
  got, want = logits.detach().numpy(), np.asarray(jlogits)
  assert np.max(np.abs(got - want)) <= 1e-3 * np.max(np.abs(want))
  assert abs(float(loss) - float(jl)) <= 1e-3 * abs(float(jl))
