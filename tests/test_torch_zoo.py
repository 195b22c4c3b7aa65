"""The port's zoo beyond ResNet-50 against the JAX package, on the CPU in f32:
ResNet v1.5 and v2 at ResNet-101/152 names, Inception-v3 whole, the
builder layers they need, and which convs take the fused unit.

Both frameworks hold the same flax init (converted by the port's weight
bridge) and get one numpy batch. Tolerances are stated at each check.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu.models import builder as jax_builder
from kf_benchmarks_tpu.models import inception_model as jax_inception
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.models.model import BuildNetworkResult
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import builder as port_builder
from kf_benchmarks_tpu_torch.models import inception_model as port_inception
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import resnet_model as port_resnet
from kf_benchmarks_tpu_torch import params as port_params

torch.set_num_threads(2)

NCLASS = 10
WEIGHT_DECAY = 1e-3
SMALL_COUNTS = (1, 2, 1, 1)


def _batch(n, size, seed):
  rng = np.random.default_rng(seed)
  images = (np.clip(rng.normal(size=(n, size, size, 3)), -2, 2) * 60.0 +
            127.0).astype(np.float32)
  return images, rng.integers(0, NCLASS, n).astype(np.int32)


# Relative size of the input perturbation that measures how far the JAX
# package's own gradients move when its activations move by f32 rounding
# (the two frameworks' forward passes differ by ~1e-6 relative: they sum in
# other orders).
PERTURB = 1e-6


def _jax_train(model, images, labels, seed):
  """(variables, loss with L2, logits, grads, updated batch stats,
  sensitivity) of the JAX package's network in the training phase.
  ``sensitivity[key]`` is |g(x') - g(x)| / |g(x)| for the images x' =
  x * (1 + PERTURB * N(0, 1)): ReLU and max-pool kinks, amplified by the
  batch norms at batch 2, make some gradients move by ~1% under such a
  perturbation."""
  module = model.make_module(nclass=NCLASS, phase_train=True)
  variables = jax.device_get(jax.jit(module.init)(
      jax.random.PRNGKey(seed), jnp.asarray(images)))

  def loss_fn(params, x):
    (logits, aux), upd = module.apply(
        {"params": params, "batch_stats": variables["batch_stats"]},
        x, mutable=["batch_stats"])
    base = model.loss_function(BuildNetworkResult(logits=(logits, aux)),
                               jnp.asarray(labels))
    total = base + WEIGHT_DECAY * jax_train_step.l2_loss(params)
    return total, (logits, upd["batch_stats"])

  grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
  (loss, (logits, new_bs)), grads = grad_fn(variables["params"],
                                            jnp.asarray(images))
  grads = _flat(jax.device_get(grads))
  rng = np.random.default_rng(seed + 1)
  moved = (images * (1 + PERTURB * rng.normal(size=images.shape))).astype(
      np.float32)
  _, grads_moved = grad_fn(variables["params"], jnp.asarray(moved))
  grads_moved = _flat(jax.device_get(grads_moved))
  sensitivity = {k: np.linalg.norm(grads_moved[k] - g) / np.linalg.norm(g)
                 for k, g in grads.items()}
  return (variables, float(loss), np.asarray(logits), grads,
          _flat(jax.device_get(new_bs)), sensitivity)


def _flat(tree):
  return {(layer, leaf): np.asarray(v)
          for layer, leaves in tree.items() for leaf, v in leaves.items()}


def _port_train(pmodel, variables, images, labels, dtype=torch.float32,
                fuse=True):
  """(loss, logits, grads, batch stats) of the port's network holding the
  flax variables, with its arithmetic in ``dtype``; ``fuse=False`` runs
  every conv plain."""
  module = pmodel.make_module(NCLASS, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  module = module.to(dtype)
  module.dtype = dtype
  if isinstance(module, port_builder.GraphNet):
    module.fuse = fuse
  else:
    for block in module.blocks:
      block.fused = block.fused and fuse
  module.train()
  logits = module(torch.from_numpy(images).to(dtype))
  loss = (pmodel.loss_function(logits, torch.from_numpy(labels).long()) +
          WEIGHT_DECAY * port_train_step.l2_loss(module))
  loss.backward()
  prefix = getattr(module, "block_prefix", "resnet_v1")
  grads, stats = {}, {}
  for key, p in module.named_parameters():
    _, layer, leaf, kind = convert.leaf_of(key, p, prefix)
    grads[(layer, leaf)] = convert.to_flax_layout(
        p.grad.double().numpy(), kind)
  for key, b in module.named_buffers():
    _, layer, leaf, _ = convert.leaf_of(key, b, prefix)
    stats[(layer, leaf)] = b.double().numpy()
  return float(loss.detach()), logits.detach().double().numpy(), grads, stats


# Logits and loss: f32 end to end, the two frameworks sum in other orders
# and the port folds the batch norm in front of a fused unit into
# x*sc + sh (test_torch_resnet.py states the same limit).
LOGIT_TOL = 1e-4


def _check_train(ref, got, got64):
  """The port's training phase against the JAX package's.

  Logits and the loss within LOGIT_TOL (relative to the largest logit /
  the loss). Every gradient within max(1e-3, 3 * noise, 3 * sensitivity)
  in relative L2 norm, with noise = |g_f32 - g_f64| / |g_f64| measured on
  the port (the batch norms at batch 2 leave some gradients with only a
  few f32 digits; test_torch_resnet.py explains the rule) and sensitivity
  the JAX package's own move under a PERTURB input perturbation
  (_jax_train). Batch statistics within 1e-4 relative plus 1e-4 of the
  tensor's largest value (the batch variance is a difference of f32
  moments)."""
  _, loss, logits, grads, stats, sensitivity = ref
  g_loss, g_logits, g_grads, g_stats = got
  scale = np.abs(logits).max()
  np.testing.assert_allclose(g_logits, logits, rtol=LOGIT_TOL,
                             atol=LOGIT_TOL * scale)
  assert abs(g_loss - loss) <= LOGIT_TOL * abs(loss)
  assert set(g_grads) == set(grads)
  for key, g_ref in grads.items():
    g, g64 = g_grads[key], got64[2][key]
    noise = np.linalg.norm(g - g64) / np.linalg.norm(g64)
    err = np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)
    limit = max(1e-3, 3.0 * noise, 3.0 * sensitivity[key])
    assert err <= limit, (key, err, noise, sensitivity[key])
  assert set(g_stats) == set(stats)
  for key, s_ref in stats.items():
    np.testing.assert_allclose(g_stats[key], s_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(s_ref).max() + 1e-6,
                               err_msg="/".join(key))


@pytest.mark.parametrize("name", ["resnet101", "resnet152_v2",
                                  "resnet50_v2"])
def test_resnet_train_phase_matches_jax(name):
  """ResNet v1.5 (resnet101's name) and v2 at full widths and one to two
  blocks a stage, 2 images of 64x64: logits, loss with L2, every gradient
  and the updated batch statistics."""
  images, labels = _batch(2, 64, seed=11)
  ref = _jax_train(jax_resnet.ResnetModel(name, SMALL_COUNTS), images,
                   labels, seed=11)
  pmodel = port_resnet.ResnetModel(name, SMALL_COUNTS)
  got = _port_train(pmodel, ref[0], images, labels)
  got64 = _port_train(pmodel, ref[0], images, labels, torch.float64)
  _check_train(ref, got, got64)


def test_resnet_v2_fused_units_match_plain_f64():
  """In f64 v2's fused units give the gradients of its plain-op blocks to
  rounding."""
  images, labels = _batch(2, 32, seed=3)
  model = jax_resnet.ResnetModel("resnet50_v2", SMALL_COUNTS)
  module = model.make_module(nclass=NCLASS, phase_train=True)
  variables = jax.device_get(module.init(jax.random.PRNGKey(3),
                                         jnp.asarray(images)))
  pmodel = port_resnet.ResnetModel("resnet50_v2", SMALL_COUNTS)
  fused = _port_train(pmodel, variables, images, labels, torch.float64)[2]
  plain = _port_train(pmodel, variables, images, labels, torch.float64,
                      fuse=False)[2]
  for key, g in plain.items():
    np.testing.assert_allclose(fused[key], g, rtol=1e-9,
                               atol=1e-9 * np.abs(g).max(),
                               err_msg="/".join(key))


@pytest.mark.parametrize("name,blocks,fused", [
    ("resnet101", 33, 30), ("resnet101_v2", 33, 30),
    ("resnet152", 50, 47), ("resnet152_v2", 50, 47),
    ("resnet50_v2", 16, 13)])
def test_deep_resnets_build_their_blocks_and_fused_units(name, blocks,
                                                         fused):
  """The full-depth networks, built and not run: their block counts, the
  stride-1 conv_b of each block routed through the fused unit, and the
  JAX package's default batch size for the name."""
  pmodel = model_config.get_model_config(name)
  module = pmodel.make_module(1001, torch.float32)
  assert len(module.blocks) == blocks
  assert sum(b.fused for b in module.blocks) == fused
  assert all(b.fused == (b.b.stride == (1, 1)) for b in module.blocks)
  assert pmodel.get_batch_size() == jax_resnet.ResnetModel(
      name, pmodel.layer_counts).get_batch_size()
  assert module.block_prefix == ("resnet_v2" if "v2" in name
                                 else "resnet_v1")


@pytest.fixture(scope="module")
def inception_ref():
  images, labels = _batch(2, 299, seed=5)
  model = jax_inception.Inceptionv3Model()
  return images, labels, _jax_train(model, images, labels, seed=5)


def test_inception_v3_forward_matches_jax(inception_ref):
  """Inception-v3 whole, 2 images at 299x299 (the size that reaches its
  8x8 pool), training phase: logits and the loss with L2 within LOGIT_TOL,
  and the evaluation phase's logits on non-trivial running averages."""
  images, labels, ref = inception_ref
  variables = ref[0]
  pmodel = port_inception.Inceptionv3Model()
  module = pmodel.make_module(NCLASS, torch.float32)
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  module.train()
  with torch.no_grad():
    logits = module(torch.from_numpy(images)).numpy()
    loss = float(pmodel.loss_function(torch.from_numpy(logits),
                                      torch.from_numpy(labels).long()) +
                 WEIGHT_DECAY * port_train_step.l2_loss(module))
  scale = np.abs(ref[2]).max()
  np.testing.assert_allclose(logits, ref[2], rtol=LOGIT_TOL,
                             atol=LOGIT_TOL * scale)
  assert abs(loss - ref[1]) <= LOGIT_TOL * abs(ref[1])
  # Evaluation phase on running averages the training step moved.
  jmodule = jax_inception.Inceptionv3Model().make_module(
      nclass=NCLASS, phase_train=False)
  stats = {layer: {leaf: ref[4][(layer, leaf)] for leaf in ("mean", "var")}
           for layer in variables["batch_stats"]}
  ev = {"params": variables["params"], "batch_stats": stats}
  ref_eval, _ = jax.jit(jmodule.apply)(ev, jnp.asarray(images))
  module.load_state_dict(convert.flax_to_state_dict(ev, module))
  module.eval()
  with torch.no_grad():
    got = module(torch.from_numpy(images)).numpy()
  ref_eval = np.asarray(ref_eval)
  np.testing.assert_allclose(got, ref_eval, rtol=LOGIT_TOL,
                             atol=LOGIT_TOL * np.abs(ref_eval).max())


def test_inception_v3_train_step_matches_jax(inception_ref):
  """One Inception-v3 training step: every gradient and the updated
  batch statistics, at the limits of _check_train."""
  images, labels, ref = inception_ref
  pmodel = port_inception.Inceptionv3Model()
  got = _port_train(pmodel, ref[0], images, labels)
  got64 = _port_train(pmodel, ref[0], images, labels, torch.float64)
  _check_train(ref, got, got64)


def test_inception_routes_only_the_mixed_9_and_10_448_to_384_convs():
  """Exactly two convs take the fused unit: the 3x3 448 -> 384 of column
  4 in mixed_9 and mixed_10, each fed by its 1x1 448's batch norm and
  ReLU; every other conv (of 94) runs plain."""
  module = port_inception.Inceptionv3Model().make_module(1001)
  convs = {name: m for name, m in module.named_children()
           if isinstance(m, port_builder.Conv)}
  assert len(convs) == 94
  want = sorted(name for name, m in convs.items()
                if tuple(m.weight.shape) == (384, 448, 3, 3))
  assert len(want) == 2
  assert sorted(module.fused) == want
  for step in module.steps:
    if step.kind == "conv" and step.args["name"] in want:
      prod = step.args["fused_from"]
      assert tuple(getattr(module, prod).weight.shape) == (448, 2048, 1, 1) \
          or tuple(getattr(module, prod).weight.shape) == (448, 1280, 1, 1)


def test_registry_and_validation_take_the_new_models():
  for name in ("resnet101", "resnet101_v2", "resnet152", "resnet152_v2",
               "resnet50_v2", "inception3"):
    assert name in model_config.list_models()
    validation.validate_cross_flags(port_params.make_params(
        model=name, device="cpu"))
  assert model_config.get_model_config("inception3").get_batch_size() == 32
  assert model_config.get_model_config("inception3").learning_rate == 0.005


# -- the builder's layers, one at a time ---------------------------------------

def _jax_conv(x, kernel, stride, padding):
  return jax.lax.conv_general_dilated(
      jnp.asarray(x), jnp.asarray(kernel), stride, padding,
      dimension_numbers=("NHWC", "HWIO", "NHWC"),
      precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("k,stride,mode,size", [
    ((1, 7), (1, 1), "SAME", 9), ((7, 1), (1, 1), "SAME", 9),
    ((1, 3), (1, 1), "SAME", 8), ((3, 1), (1, 1), "SAME", 8),
    ((5, 5), (1, 1), "SAME", 7), ((3, 3), (2, 2), "VALID", 9),
    ((3, 3), (2, 2), "SAME", 8), ((1, 1), (1, 1), "VALID", 5),
    ((3, 3), (1, 1), "VALID", 7)])
def test_conv_modes_and_non_square_kernels(k, stride, mode, size):
  """VALID and TF SAME (the odd pad after) at non-square kernels, against
  lax.conv in f32 at HIGHEST precision, to 1e-5."""
  rng = np.random.default_rng(size * 10 + k[0])
  x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
  conv = port_builder.Conv(4, 6, k, stride, mode)
  kernel = np.transpose(conv.weight.detach().numpy(), (2, 3, 1, 0))
  ref = np.asarray(_jax_conv(x, kernel, stride, mode))
  got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  assert tuple(got.shape[1:3]) == conv.out_size(size, size)
  np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize("kind,k,stride,mode,size", [
    ("apool", 3, 1, "SAME", 6), ("apool", 3, 2, "SAME", 8),
    ("apool", 2, 2, "SAME", 7), ("apool", 8, 1, "VALID", 8),
    ("apool", 5, 3, "VALID", 17), ("mpool", 3, 2, "VALID", 9),
    ("mpool", 3, 1, "SAME", 6)])
def test_pools_match_the_jax_builder(kind, k, stride, mode, size):
  """mpool / apool against the JAX builder's own: a SAME average divides
  by the in-image count of its window (count_include_pad=False). f32,
  to 1e-6."""
  rng = np.random.default_rng(size)
  x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
  jb = jax_builder.ConvNetBuilder(jnp.asarray(x), phase_train=True)
  ref = np.asarray(getattr(jb, kind)(k, k, stride, stride, mode))
  got = port_builder.pool(torch.from_numpy(x).permute(0, 3, 1, 2), kind,
                          k, stride, mode).permute(0, 2, 3, 1).numpy()
  assert got.shape == ref.shape
  assert got.shape[1:3] == port_builder.pool_out_size(size, size, k,
                                                      stride, mode)
  np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
  if kind == "apool" and mode == "SAME" and stride == 1:
    # The corner's window holds 4 of its 9 elements in the image.
    corner = x[:, :2, :2, :].mean((1, 2))
    np.testing.assert_allclose(got[:, 0, 0, :], corner, rtol=1e-6)


def test_batch_norm_without_scale_matches_jax():
  """A batch norm without scale (the builder's default): no ``scale``
  leaf, the training-phase output and the running update of the JAX
  module at decay 0.999, epsilon 0.001, to 1e-4 / 1e-6."""
  rng = np.random.default_rng(4)
  x = rng.normal(2.0, 0.7, (4, 5, 5, 6)).astype(np.float32)
  bn = jax_builder.CompactBatchNorm(use_running_average=False)
  variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
  assert set(variables["params"]) == {"bias"}
  bias = rng.normal(size=6).astype(np.float32)
  y, upd = bn.apply({"params": {"bias": bias},
                     "batch_stats": variables["batch_stats"]},
                    jnp.asarray(x), mutable=["batch_stats"])
  pbn = port_builder.CompactBatchNorm(6, 0.999, 0.001, use_scale=False)
  assert set(pbn.state_dict()) == {"bias", "mean", "var"}
  with torch.no_grad():
    pbn.bias.copy_(torch.from_numpy(bias))
  got = pbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-4,
                             atol=1e-4)
  for leaf in ("mean", "var"):
    np.testing.assert_allclose(getattr(pbn, leaf).numpy(),
                               np.asarray(upd["batch_stats"][leaf]),
                               rtol=1e-5, atol=1e-6)
  sc, sh = pbn.scale_shift(torch.from_numpy(x).permute(0, 3, 1, 2))
  folded = x * sc.detach().numpy() + sh.detach().numpy()
  np.testing.assert_allclose(folded, np.asarray(y), rtol=1e-4, atol=1e-4)


# A module with every kind of column: a 1x1, a fusable 1x1 64 -> 3x3 64
# chain continued by a 1x3, a column sharing both of its layers and adding
# a 3x1, and a SAME average pool.
MODULE_COLS = [[("conv", 8, 1, 1)],
               [("conv", 64, 1, 1), ("conv", 64, 3, 3), ("conv", 8, 1, 3)],
               [("share",), ("share",), ("conv", 8, 3, 1)],
               [("apool", 3, 3, 1, 1, "SAME"), ("conv", 8, 1, 1)]]


class _JaxModule(flax_nn.Module):
  @flax_nn.compact
  def __call__(self, x):
    cnn = jax_builder.ConvNetBuilder(x, phase_train=True)
    cnn.use_batch_norm = True
    cnn.inception_module("m", MODULE_COLS)
    return cnn.top_layer


def test_inception_module_with_share_matches_jax():
  """inception_module with ``share`` entries and the channel concat, in the
  training phase: output and running averages against the JAX builder's
  (to 1e-4), with the 3x3 64 -> 64 taking the fused unit (its plain
  version on the CPU) because its 1x1's output has no other reader."""
  rng = np.random.default_rng(6)
  x = (rng.normal(size=(2, 7, 7, 5)) * 3.0 + 1.0).astype(np.float32)
  jmod = _JaxModule()
  variables = jax.device_get(jmod.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x)))
  ref, upd = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
  net = port_builder.GraphNet(torch.float32)
  cnn = port_builder.ConvNetBuilder(net, 7, depth=5)
  cnn.use_batch_norm = True
  cnn.inception_module("m", MODULE_COLS)
  cnn.finish()
  assert net.fused == ["conv2"]
  net.load_state_dict(convert.flax_to_state_dict(variables, net))
  net.train()
  got = net(torch.from_numpy(x))
  assert tuple(got.shape) == (2, 32, 7, 7)
  ref = np.asarray(ref)
  np.testing.assert_allclose(port_builder.nhwc(got).detach().numpy(), ref,
                             rtol=1e-4, atol=1e-4 * np.abs(ref).max())
  for layer, leaves in jax.device_get(upd["batch_stats"]).items():
    bn = getattr(net, layer)
    for leaf, v in leaves.items():
      np.testing.assert_allclose(getattr(bn, leaf).numpy(), v, rtol=1e-4,
                                 atol=1e-5, err_msg=f"{layer}/{leaf}")
