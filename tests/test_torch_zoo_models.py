"""The image-classification zoo of the port (VGG, AlexNet, OverFeat, LeNet,
GoogLeNet, Inception-v4 and Inception-v3's auxiliary head, MobileNet v2,
the official ResNets, the CIFAR-10 ResNets, DenseNet) against the JAX
package's, on the CPU in f32.

* Registry: the port's ImageNet, CIFAR-10, COCO and LibriSpeech maps
  hold the JAX package's names; DeepSpeech2 asked of an image dataset is
  refused with the JAX package's message (its numbers:
  tests/test_torch_deepspeech.py); each image
  model's name, image size, default batch and rate schedule (host form at
  several steps, and the device form) are the JAX package's (NASNet's
  numbers: tests/test_torch_nasnet.py; NCF: tests/test_torch_ncf.py).
* Structure, every model at full width: tests/test_torch_zoo_structure.py.
* Numbers: both frameworks hold one flax init (through convert.py) and get
  one numpy batch. Forward logits within max(1e-4 of the largest logit,
  3 x sensitivity, 3 x noise), the loss within max(1e-4 relative, 3 x
  sensitivity, 3 x noise), every gradient within max(2e-3, 3 x sensitivity, 3 x noise) in
  relative L2 norm and the updated batch statistics within 1e-4 relative
  plus 1e-4 of the tensor's largest value. The two frameworks sum in other
  orders, and the batch norms at batch 4 and a few pixels amplify such
  rounding, as tests/test_torch_zoo.py measures it: "sensitivity" is how
  far the JAX package's own logits and gradients move when its input moves
  by f32 rounding (x (1 + 1e-6 N(0, 1))), "noise" how far the port's f32
  values lie from its own f64 ones. A batch norm's bias gradient is the
  sum of a gradient that the next batch norm has centred, so it keeps only
  a few f32 digits in either framework (JAX's f32 reductions move it by
  up to ~2% at these sizes): those leaves are held within
  max(5e-2, 3 x sensitivity, 3 x noise). Whole networks
  where they are small at their own or a reduced size (LeNet, the CIFAR
  AlexNet with its LRN, the trivial model, the CIFAR ResNets and DenseNet
  at one block a stage, the official ResNets at one block a stage and 64
  px, MobileNet v2 at width 0.35 and 64 px); block by block at narrow
  widths where the whole network is too large for a tier-1 CPU test (VGG,
  ImageNet AlexNet and OverFeat layers, GoogLeNet's inception module, the
  Inception-v4 modules, Inception-v3's auxiliary head); whole in the
  ``slow`` tests (GoogLeNet, Inception-v4, DenseNet-40, Inception-v3 with
  its auxiliary head). Networks with dropout are compared in eval mode,
  where dropout is the identity: a mask cannot match JAX's at a seed. The
  train-mode mask is held torch against torch: it comes from the run's
  generator and keeps its share.
* LRN alone against the JAX builder's ``lrn``.
"""

import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import alexnet_model as jax_alexnet
from kf_benchmarks_tpu.models import builder as jax_builder
from kf_benchmarks_tpu.models import densenet_model as jax_densenet
from kf_benchmarks_tpu.models import inception_model as jax_inception
from kf_benchmarks_tpu.models import lenet_model as jax_lenet
from kf_benchmarks_tpu.models import mobilenet_v2 as jax_mobilenet
from kf_benchmarks_tpu.models import model as jax_model_lib
from kf_benchmarks_tpu.models import model_config as jax_model_config
from kf_benchmarks_tpu.models import official_resnet_model as jax_official
from kf_benchmarks_tpu.models import resnet_model as jax_resnet
from kf_benchmarks_tpu.models import trivial_model as jax_trivial
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.models import alexnet_model
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import densenet_model
from kf_benchmarks_tpu_torch.models import googlenet_model
from kf_benchmarks_tpu_torch.models import inception_model
from kf_benchmarks_tpu_torch.models import lenet_model
from kf_benchmarks_tpu_torch.models import mobilenet_v2
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import official_resnet_model
from kf_benchmarks_tpu_torch.models import resnet_model
from kf_benchmarks_tpu_torch.models import trivial_model
from kf_benchmarks_tpu_torch.models import vgg_model

torch.set_num_threads(2)

NCLASS = 10
LOGIT_TOL = 1e-4
GRAD_TOL = 2e-3
BN_BIAS_TOL = 5e-2
STAT_TOL = 1e-4
# NCF is no image classifier: tests/test_torch_ncf.py holds it.
OWN_FILE = {"imagenet": {"ncf"}, "cifar10": set()}


def _batch(n, size, seed, depth=3):
  rng = np.random.default_rng(seed)
  images = (np.clip(rng.normal(size=(n, size, size, depth)), -2, 2) * 60.0
            + 127.0).astype(np.float32)
  return images, rng.integers(0, NCLASS, n).astype(np.int32)


def _flat(tree):
  out = {}
  for layer, leaves in tree.items():
    for leaf, v in leaves.items():
      out[(layer, leaf)] = np.asarray(v)
  return out


def _xent(logits, labels):
  return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                       labels[:, None], -1))


PERTURB = 1e-6


def _jax_run(module, images, labels, train, seed=0):
  """(variables, loss, logits list, grads, updated batch stats, logit
  sensitivity, gradient sensitivity) of a flax module returning (logits,
  aux logits or None)."""
  x, y = jnp.asarray(images), jnp.asarray(labels)
  variables = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed),
                                                  x))
  stats = variables.get("batch_stats", {})

  def loss_fn(params, x):
    if train and stats:
      (logits, aux), upd = module.apply(
          {"params": params, "batch_stats": stats}, x,
          mutable=["batch_stats"])
      new_stats = upd["batch_stats"]
    else:
      logits, aux = module.apply({"params": params, "batch_stats": stats},
                                 x)
      new_stats = stats
    loss = _xent(logits, y)
    if aux is not None:
      loss = loss + 0.4 * _xent(aux, y)
    return loss, ([logits] + ([aux] if aux is not None else []), new_stats)

  grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
  (loss, (logits, new_stats)), grads = grad_fn(variables["params"], x)
  rng = np.random.default_rng(seed + 1)
  moved = (images * (1 + PERTURB * rng.normal(size=images.shape))).astype(
      np.float32)
  (loss_m, (logits_m, _)), grads_m = grad_fn(variables["params"],
                                              jnp.asarray(moved))
  grads, grads_m = (_flat(jax.device_get(g)) for g in (grads, grads_m))
  logit_move = [np.abs(np.asarray(a) - np.asarray(b)).max()
                for a, b in zip(logits, logits_m)] + [abs(float(loss_m) -
                                                          float(loss))]
  grad_move = {k: np.linalg.norm(grads_m[k] - g) / max(np.linalg.norm(g),
                                                       1e-30)
               for k, g in grads.items()}
  return (variables, float(loss), [np.asarray(l) for l in logits], grads,
          _flat(jax.device_get(new_stats)), logit_move, grad_move)


def _port_run(module, variables, images, labels, train,
              dtype=torch.float32):
  module.load_state_dict(convert.flax_to_state_dict(variables, module))
  module.to(dtype)
  module.dtype = dtype
  module.train(train)
  out = module(torch.from_numpy(images).to(dtype))
  outs = list(out) if isinstance(out, tuple) else [out]
  y = torch.from_numpy(labels).long()
  loss = torch.nn.functional.cross_entropy(outs[0], y)
  if len(outs) > 1:
    loss = loss + 0.4 * torch.nn.functional.cross_entropy(outs[1], y)
  loss.backward()
  grads, stats = {}, {}
  for key, p in module.named_parameters():
    _, layer, leaf, kind = convert.leaf_of(key, p)
    grads[(layer, leaf)] = convert.to_flax_layout(p.grad.double().numpy(),
                                                  kind)
  for key, b in module.named_buffers():
    _, layer, leaf, _ = convert.leaf_of(key, b)
    stats[(layer, leaf)] = b.double().numpy()
  return (float(loss.detach()),
          [o.detach().double().numpy() for o in outs], grads, stats)


def _rel(a, b):
  return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _compare(jax_module, port_module, images, labels, train=True):
  """The port's forward and training step against the JAX package's, at
  the tolerances of the module docstring."""
  variables, loss, logits, grads, stats, logit_move, grad_move = _jax_run(
      jax_module, images, labels, train)
  g_loss, g_logits, g_grads, g_stats = _port_run(port_module, variables,
                                                 images, labels, train)
  l64, logits64, grads64, _ = _port_run(copy.deepcopy(port_module),
                                        variables, images, labels, train,
                                        torch.float64)
  assert len(g_logits) == len(logits)
  loss_move = logit_move.pop()
  for got, ref, move, got64 in zip(g_logits, logits, logit_move, logits64):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL, atol=max(
        LOGIT_TOL * np.abs(ref).max(), 3.0 * move,
        3.0 * np.abs(got - got64).max()))
  assert abs(g_loss - loss) <= max(LOGIT_TOL * abs(loss), 3.0 * loss_move,
                                   3.0 * abs(g_loss - l64))
  assert set(g_grads) == set(grads)
  for key, ref in grads.items():
    err = _rel(g_grads[key], ref)
    noise = _rel(g_grads[key], grads64[key])
    floor = (BN_BIAS_TOL if key[1] == "bias" and isinstance(
        getattr(port_module, key[0]), builder.CompactBatchNorm) else GRAD_TOL)
    assert err <= max(floor, 3.0 * grad_move[key], 3.0 * noise), (
        key, err, grad_move[key], noise)
  if train:
    assert set(g_stats) == set(stats)
    for key, ref in stats.items():
      np.testing.assert_allclose(g_stats[key], ref, rtol=STAT_TOL,
                                 atol=STAT_TOL * np.abs(ref).max() + 1e-6,
                                 err_msg="/".join(key))


def _model_pair(jmodel, pmodel, train=True):
  return (jmodel.make_module(nclass=NCLASS, phase_train=train),
          pmodel.make_module(NCLASS, torch.float32))


# -- the registry ------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["imagenet", "cifar10", "coco"])
def test_registry_names_are_the_jax_packages_less_item_7b(dataset):
  """Every name of the JAX package's ImageNet, CIFAR-10 and COCO maps and
  of its LibriSpeech map (DeepSpeech2, the rest of item 7b); a name of the
  LibriSpeech map asked of another dataset is refused with the JAX
  package's message."""
  from kf_benchmarks_tpu_torch import params as params_lib  # noqa: PLC0415
  assert set(model_config.list_models(dataset)) == \
      set(jax_model_config.list_models(dataset))
  assert set(model_config.list_models("librispeech")) == \
      set(jax_model_config.list_models("librispeech")) == {"deepspeech2"}
  assert model_config.get_model_config(
      "deepspeech2", None, "librispeech").get_name() == "deepspeech2"
  message = f"Invalid model name 'deepspeech2' for dataset '{dataset}'"
  with pytest.raises(ValueError, match=message):
    jax_model_config.get_model_config("deepspeech2", dataset)
  with pytest.raises(ValueError, match=message):
    model_config.get_model_config("deepspeech2", None, dataset)
  with pytest.raises(validation.ParamError, match=message):
    validation.validate_cross_flags(params_lib.make_params(
        model="deepspeech2", data_name=dataset, device="cpu"))


_ZOO = [(d, n) for d in ("imagenet", "cifar10")
        for n in sorted(set(jax_model_config.list_models(d)) - OWN_FILE[d])
        if n != "transformer_lm"]


@pytest.mark.parametrize("dataset,name", _ZOO,
                         ids=[f"{d}-{n}" for d, n in _ZOO])
def test_name_size_batch_and_rate_schedule_match_jax(dataset, name):
  jmodel = jax_model_config.get_model_config(name, dataset)
  pmodel = model_config.get_model_config(name, None, dataset)
  assert pmodel.get_name() == jmodel.get_name()
  assert pmodel.image_size == jmodel.image_size
  assert pmodel.get_batch_size() == jmodel.get_batch_size()
  assert pmodel.learning_rate == jmodel.learning_rate
  for batch in (32, 128):
    steps = [0, 1, 5000, 40000, 200000, 500000, 2000000]
    want = [float(jmodel.get_learning_rate(s, batch)) for s in steps]
    got = [float(pmodel.get_learning_rate(s, batch)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30,
                               err_msg=name)
    device = pmodel.get_learning_rate(
        torch.tensor(steps, dtype=torch.float32), batch)
    device = (device.numpy() if isinstance(device, torch.Tensor)
              else np.full(len(steps), device))
    np.testing.assert_allclose(device, want, rtol=1e-6, atol=1e-30,
                               err_msg=name)


# -- whole networks at their own or a reduced size ---------------------------

def test_lenet_matches_jax():
  images, labels = _batch(4, 28, 1)
  _compare(*_model_pair(jax_lenet.Lenet5Model(), lenet_model.Lenet5Model()),
           images, labels)


def test_cifar_alexnet_with_lrn_matches_jax():
  images, labels = _batch(4, 32, 2)
  _compare(*_model_pair(jax_alexnet.AlexnetCifar10Model(),
                        alexnet_model.AlexnetCifar10Model()),
           images, labels)


def test_cifar_trivial_matches_jax():
  images, labels = _batch(4, 32, 3)
  _compare(*_model_pair(jax_trivial.TrivialCifar10Model(),
                        trivial_model.TrivialCifar10Model()),
           images, labels)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_cifar_resnet_matches_jax(version):
  """One basic block a stage (ResNet-8): the 64-channel stage's second 3x3
  takes the fused unit (its plain version here)."""
  name = "resnet8" + ("_v2" if version == "v2" else "")
  pmodel = resnet_model.ResnetCifar10Model(name, (1, 1, 1))
  jmodule, pmodule = _model_pair(
      jax_resnet.ResnetCifar10Model(name, (1, 1, 1)), pmodel)
  assert pmodule.fused == ["resblk2_b"]
  images, labels = _batch(4, 32, 4)
  _compare(jmodule, pmodule, images, labels)


def test_densenet_matches_jax():
  pmodel = densenet_model.DensenetCifar10Model("densenet_small", (1, 1, 1),
                                               12)
  jmodel = jax_densenet.DensenetCifar10Model("densenet_small", (1, 1, 1), 12)
  images, labels = _batch(4, 32, 5)
  _compare(*_model_pair(jmodel, pmodel), images, labels)


@pytest.mark.parametrize("size,version,pixels,batch,fused", [
    (18, 1, 64, 8, ["resblk0_b", "resblk1_b", "resblk2_b", "resblk3_b"]),
    (50, 1, 128, 4, ["resnet_v10_b"]),
    (50, 2, 160, 4, ["resnet_v20_b"])])
def test_official_resnet_matches_jax(size, version, pixels, batch, fused):
  """One block a stage: basic blocks (18) at 64 px and bottlenecks (50, v1
  and v2) at 128 and 160 px (at 64 px their last stage's 2x2 batch norms
  leave the JAX package's own f32 gradients ~1% from the port's f64
  ones, and v2's preactivations ~2% at 128 px)."""
  jmodel = jax_official.OfficialResnetModel(size, version)
  pmodel = official_resnet_model.OfficialResnetModel(size, version)
  for m in (jmodel, pmodel):
    m.block_counts = (1, 1, 1, 1)
    m.image_size = pixels
  jmodule, pmodule = _model_pair(jmodel, pmodel)
  assert pmodule.fused == fused
  images, labels = _batch(batch, pixels, 6)
  _compare(jmodule, pmodule, images, labels)


def test_mobilenet_v2_matches_jax():
  """Every row of V2_DEF at width 0.35 and 64 px, in training (dropout
  off: keep 1.0)."""
  jmodule = jax_mobilenet.MobilenetV2Module(
      nclass=NCLASS, phase_train=True, depth_multiplier=0.35,
      dropout_keep_prob=1.0)
  pmodule = mobilenet_v2.MobilenetV2(NCLASS, torch.float32,
                                     depth_multiplier=0.35,
                                     dropout_keep_prob=1.0)
  images, labels = _batch(4, 64, 7)
  _compare(jmodule, pmodule, images, labels)


def test_make_divisible_matches_jax():
  for v in (3.5, 8.0, 11.2, 16 * 0.35, 320 * 0.35, 1280 * 1.4, 96 * 0.75):
    for divisor in (4, 8):
      assert mobilenet_v2.make_divisible(v, divisor) == \
          jax_mobilenet.make_divisible(v, divisor)


@pytest.mark.parametrize("make", [
    lambda: (jax_lenet.Lenet5Model(), lenet_model.Lenet5Model(), 28),
    lambda: (jax_densenet.DensenetCifar10Model("d", (1, 1, 1), 12),
             densenet_model.DensenetCifar10Model("d", (1, 1, 1), 12), 32),
    lambda: (jax_resnet.ResnetCifar10Model("r_v2", (1, 1, 1)),
             resnet_model.ResnetCifar10Model("r_v2", (1, 1, 1)), 32),
    lambda: (jax_alexnet.AlexnetCifar10Model(),
             alexnet_model.AlexnetCifar10Model(), 32)],
    ids=["lenet", "densenet", "cifar_resnet_v2", "cifar_alexnet"])
def test_weight_bridge_round_trips(make):
  """flax -> the port's state_dict -> flax gives the JAX tree back, leaf
  for leaf (convert.py both ways)."""
  jmodel, pmodel, size = make()
  module = jmodel.make_module(nclass=NCLASS, phase_train=True)
  variables = jax.device_get(jax.jit(module.init)(
      jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))
  port = pmodel.make_module(NCLASS)
  back = convert.state_dict_to_flax(
      convert.flax_to_state_dict(variables, port), port)
  want = {(c,) + k: v for c, tree in variables.items()
          for k, v in _flat(tree).items()}
  got = {(c,) + k: v for c, tree in back.items()
         for k, v in _flat(tree).items()}
  assert set(got) == set(want)
  for key, v in want.items():
    np.testing.assert_array_equal(got[key], v, err_msg="/".join(key))


# -- block by block, at narrow widths ----------------------------------------

class _JaxNet(jax_model_lib.CNNModel):
  """A JAX CNN model whose network is ``build(cnn)`` on the JAX builder."""

  def __init__(self, build, size, depth=3):
    super().__init__("block", size, 4, 0.005, depth=depth)
    self.build = build

  def add_inference(self, cnn):
    self.build(cnn, "jax")


class _PortNet(builder.BuilderModel):
  def __init__(self, build, size, depth=3):
    super().__init__("block", size, 4, 0.005, depth=depth)
    self.build = build

  def add_inference(self, cnn):
    self.build(cnn, "port")


def _compare_block(build, size, depth=3, train=True, seed=8, n=4):
  jmodule, pmodule = _model_pair(_JaxNet(build, size, depth),
                                 _PortNet(build, size, depth), train)
  images, labels = _batch(n, size, seed, depth)
  _compare(jmodule, pmodule, images, labels, train)
  return pmodule


def _vgg_layers(cnn, _):
  for channels, count in zip((8, 16, 16), (1, 2, 1)):
    for _ in range(count):
      cnn.conv(channels, 3, 3)
    cnn.mpool(2, 2)
  cnn.reshape([-1, 16 * 2 * 2])
  cnn.affine(32)
  cnn.dropout()
  cnn.affine(32)
  cnn.dropout()


def _alexnet_layers(cnn, _):
  cnn.conv(8, 11, 11, 4, 4, "VALID")
  cnn.mpool(3, 3, 2, 2)
  cnn.conv(16, 5, 5)
  cnn.mpool(3, 3, 2, 2)
  cnn.conv(16, 3, 3)
  cnn.reshape([-1, 16 * 3 * 3])
  cnn.affine(32)
  cnn.dropout()


def _overfeat_layers(cnn, _):
  cnn.conv(8, 11, 11, 4, 4, mode="VALID")
  cnn.mpool(2, 2)
  cnn.conv(16, 5, 5, 1, 1, mode="VALID")
  cnn.mpool(2, 2)
  cnn.conv(16, 3, 3)
  cnn.reshape([-1, 16 * 2 * 2])
  cnn.affine(24)
  cnn.dropout()


@pytest.mark.parametrize("build,size", [
    (_vgg_layers, 16), (_alexnet_layers, 67), (_overfeat_layers, 75)],
    ids=["vgg", "alexnet", "overfeat"])
def test_convnet_layers_without_batch_norm_match_jax(build, size):
  """The layers VGG, AlexNet and OverFeat are made of (convs with a bias
  and ReLU, SAME and VALID, max pools, flatten, affine, dropout), in eval
  mode; the full networks' layers are held by name and shape above."""
  _compare_block(build, size, train=False)


def test_googlenet_inception_v1_module_matches_jax():
  def build(cnn, _):
    cnn.conv(16, 3, 3)
    googlenet_model.inception_v1(cnn, 8, 8, 12, 4, 8, 8)
  _compare_block(build, 9)


def _v4_stem_and_reductions(cnn, who):
  """Inception-v4's stem and reduction modules: the JAX package's own
  functions on its builder, the port's on the port's."""
  mod = jax_inception if who == "jax" else inception_model
  cnn.use_batch_norm = True
  cnn.conv(16, 3, 3)
  mod.inception_v4_sa(cnn)
  mod.inception_v4_sb(cnn)
  mod.inception_v4_sc(cnn)
  mod.inception_v4_ra(cnn, 16, 16, 24, 24)
  mod.inception_v4_rb(cnn)


def _v4_blocks(cnn, _):
  cnn.use_batch_norm = True
  cnn.conv(16, 1, 1)
  inception_model.inception_v4_a(cnn)
  inception_model.inception_v4_b(cnn)
  inception_model.inception_v4_c(cnn)
  cnn.spatial_mean()
  cnn.dropout(0.8)


def test_inception_v4_stem_and_reduction_modules_match_jax():
  _compare_block(_v4_stem_and_reductions, 35, train=True, n=4)


def test_inception_v4_a_b_c_modules_match_jax():
  _compare_block(_v4_blocks, 5, train=False, n=4)


def test_inception_v3_auxiliary_head_matches_jax():
  """Inception-v3's auxiliary head (a constructor option): its own affine
  layer after the main one, 0.4 of its cross-entropy in the loss."""
  def build(cnn, who):
    cnn.use_batch_norm = True
    cnn.conv(16, 3, 3)
    if who == "port":
      inception_model._inception_v3_aux(cnn)
    else:  # the JAX package's incept_v3_aux (inception_model.py:60-68)
      cnn.aux_top_layer, cnn.aux_top_size = cnn.top_layer, cnn.top_size
      with cnn.switch_to_aux_top_layer():
        cnn.apool(5, 5, 3, 3, mode="VALID")
        cnn.conv(128, 1, 1, mode="SAME")
        cnn.conv(768, 5, 5, mode="VALID", stddev=0.01)
        cnn.reshape([-1, 768])
    cnn.conv(24, 3, 3)
    cnn.apool(17, 17, 1, 1)
    cnn.reshape([-1, 24])
  pmodule = _compare_block(build, 17)
  out = pmodule(torch.from_numpy(_batch(2, 17, 9)[0]))
  assert isinstance(out, tuple) and len(out) == 2
  assert inception_model.Inceptionv3Model(auxiliary=True)._auxiliary


def test_lrn_matches_the_jax_builder():
  rng = np.random.default_rng(10)
  x = (rng.normal(size=(2, 5, 6, 13)) * 4.0).astype(np.float32)

  class Lrn(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x):
      cnn = jax_builder.ConvNetBuilder(x, phase_train=False)
      return cnn.lrn(4, 1.0, 0.001 / 9.0, 0.75)

  for r, bias, alpha, beta in ((4, 1.0, 0.001 / 9.0, 0.75),
                               (2, 2.0, 0.1, 0.5)):
    ref = np.asarray(jax_builder.ConvNetBuilder(
        jnp.asarray(x), phase_train=False).lrn(r, bias, alpha, beta))
    got = builder.nhwc(builder.lrn(builder.nchw(torch.from_numpy(x)), r,
                                   bias, alpha, beta)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
  # alpha multiplies the sum itself: F.local_response_norm divides it by
  # the window first, which would differ here.
  plain = torch.nn.functional.local_response_norm(
      torch.from_numpy(x).permute(0, 3, 1, 2), 9, 0.001 / 9.0, 0.75, 1.0)
  assert not np.allclose(builder.nhwc(plain).numpy(), np.asarray(
      jax_builder.ConvNetBuilder(jnp.asarray(x), phase_train=False).lrn(
          4, 1.0, 0.001 / 9.0, 0.75)), rtol=1e-7, atol=0)


def test_dropout_mask_comes_from_the_runs_generator_and_keeps_its_share():
  """The mask is a function of the run's seed and the step counter alone:
  the same seed and step give the same mask, another seed or another step
  another; it keeps its share and scales the kept values."""
  def net(seed):
    pmodel = _PortNet(_vgg_layers, 16)
    return pmodel.make_module(
        NCLASS, torch.float32,
        generator=torch.Generator().manual_seed(seed))

  images = torch.from_numpy(_batch(4, 16, 11)[0])
  a, b, c = net(1), net(1), net(2)
  b.load_state_dict(a.state_dict())
  c.load_state_dict(a.state_dict())
  assert a.dropout_seed == b.dropout_seed != c.dropout_seed
  for m in (a, b, c):
    m.train()
  ya, yb, yc = a(images), b(images), c(images)
  torch.testing.assert_close(ya, yb, rtol=0, atol=0)
  assert not torch.equal(ya, yc)
  # Again at the same step: the same mask; at another step: another.
  torch.testing.assert_close(a(images), ya, rtol=0, atol=0)
  b.rng_step = torch.tensor(1)
  assert not torch.equal(b(images), ya)
  a.eval()
  b.eval()
  torch.testing.assert_close(a(images), b(images), rtol=0, atol=0)
  # The share kept, and the kept values scaled by 1 / keep_prob.
  x = torch.ones(400, 500)
  u = builder.counter_uniform(x.shape, 3, torch.tensor(0), 0, x.device)
  y = builder.dropout(x, 0.8, u)
  kept = (y != 0).float().mean().item()
  assert abs(kept - 0.8) < 0.005
  assert torch.all((y == 0) | (y == 1.0 / 0.8))


# -- whole networks, slow ----------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", ["googlenet", "inception4"])
def test_whole_imagenet_network_matches_jax_in_eval_mode(name):
  jmodel = jax_model_config.get_model_config(name, "imagenet")
  pmodel = model_config.get_model_config(name, None, "imagenet")
  images, labels = _batch(2, pmodel.image_size, 12)
  _compare(*_model_pair(jmodel, pmodel, train=False), images, labels,
           train=False)


@pytest.mark.slow
def test_whole_densenet40_matches_jax():
  images, labels = _batch(4, 32, 13)
  _compare(*_model_pair(jax_densenet.create_densenet40_k12_model(),
                        densenet_model.create_densenet40_k12_model()),
           images, labels)


@pytest.mark.slow
def test_whole_inception_v3_with_auxiliary_head_matches_jax():
  images, labels = _batch(2, 299, 14)
  _compare(*_model_pair(jax_inception.Inceptionv3Model(auxiliary=True),
                        inception_model.Inceptionv3Model(auxiliary=True),
                        train=False),
           images, labels, train=False)


def test_vgg_names_follow_the_jax_counters():
  with torch.device("meta"):
    net = vgg_model.Vgg11Model().make_module(NCLASS)
  names = [n for n, _ in net.named_children()]
  assert names == ["conv0", "conv1", "conv2", "conv3", "conv4", "conv5",
                   "conv6", "conv7", "affine0", "affine1", "affine2"]


# -- the entry points ----------------------------------------------------------

def _cli(argv, capsys):
  from kf_benchmarks_tpu_torch import cli  # noqa: PLC0415
  rc = cli.main(["--device=cpu", "--num_batches=2", "--num_warmup_batches=1"]
                + argv)
  out = capsys.readouterr().out
  assert rc == 0, out
  assert "total images/sec" in out
  return out


@pytest.mark.parametrize("argv,banner", [
    (["--model=lenet", "--batch_size=4"], "imagenet (synthetic)"),
    (["--model=mobilenet", "--batch_size=1"], "imagenet (synthetic)"),
    (["--model=resnet20", "--data_name=cifar10", "--batch_size=4"],
     "cifar10 (synthetic)"),
    (["--model=alexnet", "--data_name=cifar10", "--batch_size=4"],
     "cifar10 (synthetic)"),
    (["--model=densenet40_k12", "--data_name=cifar10", "--batch_size=2"],
     "cifar10 (synthetic)"),
    (["--model=trivial", "--data_name=cifar10", "--batch_size=4"],
     "cifar10 (synthetic)")],
    ids=["lenet", "mobilenet", "resnet20", "alexnet-cifar10",
         "densenet40_k12", "trivial-cifar10"])
def test_cli_trains_the_zoo(argv, banner, capsys):
  out = _cli(argv, capsys)
  assert banner in out


def test_cli_trains_a_cifar_resnet_on_cifar10_records(tmp_path, capsys):
  """--data_dir with the python pickle batches: the Cifar10ImagePreprocessor
  feeds the 10-class model."""
  import pickle  # noqa: PLC0415
  rng = np.random.default_rng(0)
  d = tmp_path / "cifar10"
  d.mkdir()
  for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
    with open(d / name, "wb") as f:
      pickle.dump({b"data": rng.integers(0, 256, (8, 3072), dtype=np.uint8),
                   b"labels": list(rng.integers(0, 10, 8))}, f)
  out = _cli(["--model=resnet20_v2", f"--data_dir={d}",
              "--data_name=cifar10", "--batch_size=4"], capsys)
  assert f"cifar10 ({d})" in out


def test_cli_refuses_a_model_of_another_dataset(capsys):
  from kf_benchmarks_tpu_torch import cli  # noqa: PLC0415
  assert cli.main(["--device=cpu", "--model=vgg16",
                   "--data_name=cifar10"]) == 1
  assert "not a model of the cifar10 dataset" in capsys.readouterr().err
  assert cli.main(["--device=cpu", "--model=deepspeech2"]) == 1
  assert ("Invalid model name 'deepspeech2' for dataset 'imagenet'" in
          capsys.readouterr().err)



def test_captured_training_of_a_dropout_model_is_refused_on_the_card(
    monkeypatch):
  """--steps_per_dispatch > 1 captures the step on the card. The dropout
  networks' draws read the step counter on the device, so they are
  admitted, and so is DeepSpeech2 on LibriSpeech, whose cuDNN recurrence
  and CTC recursion capture (phase speech of chip_smoke.py); DeepSpeech2
  on an image dataset is refused with the JAX package's message."""
  from kf_benchmarks_tpu_torch import params as params_lib  # noqa: PLC0415
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(validation.mesh, "device_count_error", lambda *a: None)
  flags = dict(device="gpu", use_fp16=True, steps_per_dispatch=2)
  with pytest.raises(validation.ParamError,
                     match="Invalid model name 'deepspeech2'"):
    validation.validate_cross_flags(params_lib.make_params(
        model="deepspeech2", **flags))
  validation.validate_cross_flags(params_lib.make_params(
      model="deepspeech2", data_name="librispeech", **flags))
  for model in ("vgg16", "alexnet", "overfeat", "mobilenet", "nasnet"):
    validation.validate_cross_flags(params_lib.make_params(
        model=model, **flags))
  validation.validate_cross_flags(params_lib.make_params(
      model="resnet20", data_name="cifar10", **flags))