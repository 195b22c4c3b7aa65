"""NASNet-A of the port (models/nasnet_model.py) against the JAX package's
(kf_benchmarks_tpu/models/nasnet_model.py), on the CPU in f32.

Both frameworks hold one flax init (converted by convert.py) and get one
numpy batch:

* one normal cell (its previous input at the same resolution and another
  width: the 1x1 branch of ``_reduce_prev_layer``) and one reduction cell
  (its previous input at twice the resolution: the factorized reduction),
  in training with drop path on, each drop path's noise injected into
  both frameworks (``jax.random.uniform`` in the JAX module, the port
  network's ``uniform``), so the draws cannot differ: outputs, the
  gradients of a fixed projection of them, and the updated batch
  statistics;
* the auxiliary head alone;
* whole narrow networks (3 cells, 8 filters) with the CIFAR stem and with
  the ImageNet stem and the large model's ``skip_reduction_layer_input``:
  logits, auxiliary logits, loss, every gradient and every updated batch
  statistic, with drop path at a progress of 0.3 (so the ramp is held);
* each full-width configuration's variable names and shapes against
  ``jax.eval_shape`` of the JAX module (nothing runs at full width here);
  the ImageNet-stem network (~40 s) is ``slow``;
* drop path's keep schedule on the device (from the step counter) against
  the JAX formula, and its arithmetic in bf16.

Tolerances as tests/test_torch_zoo_models.py: outputs within 1e-4 of their
largest value, gradients within 2e-3 in relative L2, batch statistics
within 1e-4 relative plus 1e-4 of the largest; a batch norm's bias
gradient (a sum of a centred gradient) within 5e-2.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu.models import nasnet_model as jax_nasnet
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import model_config
from kf_benchmarks_tpu_torch.models import nasnet_model

torch.set_num_threads(2)

NCLASS = 10
OUT_TOL = 1e-4
GRAD_TOL = 2e-3
BN_BIAS_TOL = 5e-2
STAT_TOL = 1e-4


def _noise_list(n, count, seed=0):
  rng = np.random.default_rng(seed)
  return [rng.uniform(size=(n, 1, 1, 1)).astype(np.float32)
          for _ in range(count)]


def _inject(monkeypatch, pnet, noise):
  """Both frameworks' drop-path draws become ``noise``, in call order."""
  jax_calls, port_calls = [0], [0]

  def jax_uniform(rng, shape, dtype=jnp.float32, *a, **k):
    del rng, a, k
    v = noise[jax_calls[0]]
    jax_calls[0] += 1
    assert v.shape == tuple(shape)
    return jnp.asarray(v, dtype)

  def port_uniform(shape, device, dtype=torch.float32):
    v = noise[port_calls[0]]
    port_calls[0] += 1
    return torch.from_numpy(v.transpose(0, 3, 1, 2)).to(device, dtype)

  monkeypatch.setattr(jax.random, "uniform", jax_uniform)
  pnet.uniform = port_uniform
  return jax_calls, port_calls


class _JaxCells(jax_nasnet.NasnetModule):
  """Runs the part under test: ``part`` 'normal' / 'reduction' (a cell
  whose previous input is the images and whose input is their 3x3 average
  pool, at stride 1 or 2), or 'aux' (the auxiliary head)."""

  part: str = "normal"

  @flax_nn.compact
  def __call__(self, images, progress=None):
    x = images.astype(self.dtype)
    if self.part == "aux":
      return self._aux_head(x)
    stride = 2 if self.part == "reduction" else 1
    h = flax_nn.avg_pool(x, (3, 3), (stride, stride), "SAME",
                         count_include_pad=False)
    ops = ((jax_nasnet.REDUCTION_OPERATIONS,
            jax_nasnet.REDUCTION_USED_HIDDENSTATES,
            jax_nasnet.REDUCTION_HIDDENSTATE_INDICES)
           if stride == 2 else
           (jax_nasnet.NORMAL_OPERATIONS, jax_nasnet.NORMAL_USED_HIDDENSTATES,
            jax_nasnet.NORMAL_HIDDENSTATE_INDICES))
    return self._cell(h, x, *ops, self.num_conv_filters, stride, 2, 6,
                      progress)


def _port_cells(part):
  class Cells(nasnet_model.NasnetNet):
    def forward(self, images):
      self.begin_draws()
      x = builder.model.to_model_input(images, self.dtype)
      self._progress = None
      if self.total_steps:
        self._progress = (self.step_counter(x.device).float() /
                          self.total_steps)
      return builder.accum(self._run(x, self.training)[0])

    def _run(self, x, train):
      self._counts = {"Conv": 0, "BatchNorm": 0, "Dense": 0}
      if part == "aux":
        return self._aux_head(x, True), None
      stride = 2 if part == "reduction" else 1
      h = builder.pool(x, "apool", 3, stride, "SAME")
      ops = ((nasnet_model.REDUCTION_OPERATIONS,
              nasnet_model.REDUCTION_USED_HIDDENSTATES,
              nasnet_model.REDUCTION_HIDDENSTATE_INDICES)
             if stride == 2 else
             (nasnet_model.NORMAL_OPERATIONS,
              nasnet_model.NORMAL_USED_HIDDENSTATES,
              nasnet_model.NORMAL_HIDDENSTATE_INDICES))
      return self._cell(h, x, *ops, self.num_conv_filters, stride, 2, 6), None
  return Cells


def _images(n, size, channels=3, seed=1):
  rng = np.random.default_rng(seed)
  return rng.normal(size=(n, size, size, channels)).astype(np.float32)


def _rel(a, b):
  return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) /
               max(np.linalg.norm(np.asarray(b)), 1e-30))


def _close(port, ref, tol):
  port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
  assert np.max(np.abs(port - ref)) <= tol * max(np.max(np.abs(ref)), 1e-30)


def _port_grad_of(pnet, key):
  return dict(pnet.named_parameters())[key].grad.numpy()


def _compare_tree(pnet, jgrads, jstats):
  """Every port gradient against the JAX gradient of its flax leaf, and
  the updated batch statistics."""
  for key, t in pnet.state_dict().items():
    path, kind, _ = convert.flax_source(key, t, pnet)
    if path[0] == "params":
      g = convert.to_port_layout(np.asarray(
          jgrads[path[1]][path[2]]), kind)
      tol = BN_BIAS_TOL if (path[1].startswith("BatchNorm") and
                            path[2] == "bias") else GRAD_TOL
      assert _rel(_port_grad_of(pnet, key), g) <= tol, (key, _rel(
          _port_grad_of(pnet, key), g))
    else:
      ref = np.asarray(jstats[path[1]][path[2]])
      got = t.numpy()
      assert np.max(np.abs(got - ref)) <= STAT_TOL * (
          np.max(np.abs(ref)) + 1.0), key


@pytest.mark.parametrize("part,size,channels", [
    ("normal", 8, 12), ("reduction", 8, 12), ("aux", 8, 12)])
def test_cells_and_aux_head_match_jax(part, size, channels, monkeypatch):
  n, filters = 4, 8
  kw = dict(nclass=NCLASS, num_cells=3, num_conv_filters=filters,
            stem_multiplier=1.0, stem_type="cifar", drop_path_keep_prob=0.6)
  jmod = _JaxCells(phase_train=True, part=part, **kw)
  x = _images(n, size, channels)
  variables = jax.device_get(jmod.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      jnp.asarray(x), progress=jnp.float32(3) / 10))
  pnet = _port_cells(part)(NCLASS, torch.float32, size, **{
      k: v for k, v in kw.items() if k != "nclass"})
  # The cells read the images' width: the port builds on 3 channels by
  # default, so rebuild the layers on the test's channel count.
  pnet._building = True
  for name in list(pnet._modules):
    delattr(pnet, name)
  pnet._run(torch.empty(1, channels, size, size, device="meta"), True)
  pnet._building = False
  pnet.load_state_dict(convert.flax_to_state_dict(variables, pnet))
  pnet.train()
  pnet.rng_step = torch.tensor(3)
  pnet.total_steps = 10
  noise = _noise_list(n, 40)
  jcalls, pcalls = _inject(monkeypatch, pnet, noise)
  rng = np.random.default_rng(5)
  out_shape = None

  def jloss(params):
    out, upd = jmod.apply({"params": params,
                           "batch_stats": variables.get("batch_stats", {})},
                          jnp.asarray(x), progress=jnp.float32(3) / 10,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(2)})
    return out, upd

  jout, jupd = jax.jit(jloss)(variables["params"])
  out_shape = jout.shape
  proj = rng.normal(size=out_shape).astype(np.float32)
  jcalls[0] = 0

  def jl(params):
    out, upd = jloss(params)
    return jnp.sum(out * proj), upd

  (_, jupd), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(
      variables["params"])
  pout = pnet(torch.from_numpy(x))
  pout_nhwc = (builder.nhwc(pout) if pout.dim() == 4 else pout)
  _close(pout_nhwc.detach().numpy(), np.asarray(jout), OUT_TOL)
  # The port's forward ran once with statistics; one more would update
  # them again, so the statistics compare after this forward.
  pstats = {k: v.clone() for k, v in pnet.state_dict().items()}
  (pout_nhwc * torch.from_numpy(proj)).sum().backward()
  if part != "aux":
    assert pcalls[0] == jcalls[0] > 0  # drop path drew in both
  pnet.load_state_dict(pstats)
  _compare_tree(pnet, jgrads, jupd.get("batch_stats", {}))


def _whole(stem, skip, size):
  kw = dict(num_cells=3, num_conv_filters=8, stem_multiplier=1.0,
            stem_type=stem, dense_dropout_keep_prob=1.0,
            drop_path_keep_prob=0.7, skip_reduction_layer_input=skip)
  jmod = jax_nasnet.NasnetModule(nclass=NCLASS, phase_train=True, **kw)
  pnet = nasnet_model.NasnetNet(NCLASS, torch.float32, size, **kw)
  return jmod, pnet


@pytest.mark.parametrize("stem,skip,size", [
    ("cifar", False, 16),
    pytest.param("imagenet", True, 128, marks=pytest.mark.slow)],
    ids=["cifar", "large"])
def test_whole_narrow_network_matches_jax(stem, skip, size, monkeypatch):
  n = 4
  jmod, pnet = _whole(stem, skip, size)
  x = _images(n, size)
  labels = np.random.default_rng(2).integers(0, NCLASS, n)
  progress = jnp.float32(3) / 10
  variables = jax.device_get(jax.jit(lambda x: jmod.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      x, progress=progress))(jnp.asarray(x)))
  pnet.load_state_dict(convert.flax_to_state_dict(variables, pnet))
  pnet.train()
  pnet.rng_step = torch.tensor(3)
  pnet.total_steps = 10
  noise = _noise_list(n, 200, seed=4)
  jcalls, pcalls = _inject(monkeypatch, pnet, noise)

  def loss_fn(params):
    (logits, aux), upd = jmod.apply(
        {"params": params, "batch_stats": variables["batch_stats"]},
        jnp.asarray(x), progress=progress, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(2)})
    onehot = jax.nn.one_hot(labels, NCLASS)
    loss = (-jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1)) -
            0.4 * jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(aux), -1)))
    return loss, (logits, aux, upd)

  (jl, (jlogits, jaux, jupd)), jgrads = jax.jit(jax.value_and_grad(
      loss_fn, has_aux=True))(variables["params"])
  model = nasnet_model.NasnetCifarModel()
  logits, aux = pnet(torch.from_numpy(x))
  loss = model.loss_function((logits, aux), torch.from_numpy(labels))
  pstats = {k: v.clone() for k, v in pnet.state_dict().items()}
  loss.backward()
  assert pcalls[0] == jcalls[0] > 0
  _close(logits.detach().numpy(), jlogits, OUT_TOL)
  _close(aux.detach().numpy(), jaux, OUT_TOL)
  assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
  pnet.load_state_dict(pstats)
  _compare_tree(pnet, jgrads, jupd["batch_stats"])
  # Eval mode: no aux head (its layers stepped over by name), no drop
  # path; the classifier is still the training tree's.
  pnet.eval()
  with torch.no_grad():
    plog = pnet(torch.from_numpy(x))
  assert isinstance(plog, torch.Tensor) and plog.shape == (n, NCLASS)


@pytest.mark.parametrize("name,dataset", [
    ("nasnet", "imagenet"), ("nasnetlarge", "imagenet"),
    ("nasnet", "cifar10")])
def test_full_width_variables_are_the_jax_packages(name, dataset):
  from kf_benchmarks_tpu.models import model_config as jax_model_config  # noqa: PLC0415
  jmodel = jax_model_config.get_model_config(name, dataset)
  pmodel = model_config.get_model_config(name, None, dataset)
  nclass = 1001 if dataset == "imagenet" else 10
  assert (pmodel.image_size, pmodel.batch_size, pmodel.learning_rate) == (
      jmodel.image_size, jmodel.batch_size, jmodel.learning_rate)
  jmod = jmodel.make_module(nclass, phase_train=True)
  size = jmodel.image_size
  shapes = jax.eval_shape(lambda: jmod.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      jnp.zeros((2, size, size, 3)), progress=0.5))
  with torch.device("meta"):
    pnet = pmodel.make_module(nclass)
  state = pnet.state_dict()
  seen = set()
  for key, t in state.items():
    path, kind, _ = convert.flax_source(key, t, pnet)
    leaf = shapes[path[0]][path[1]][path[2]]
    want = convert.to_port_layout(np.zeros(leaf.shape, np.int8), kind).shape
    assert tuple(t.shape) == tuple(want), key
    seen.add(path)
  flat = {(c, l, k) for c in shapes for l in shapes[c] for k in shapes[c][l]}
  assert seen == flat


def test_drop_path_schedule_and_bf16_arithmetic():
  # The keep probability on the device equals the JAX formula's.
  for cell, total, step, steps in ((0, 20, 0, 10), (5, 20, 3, 10),
                                   (19, 20, 7, 10), (10, 20, 25, 10)):
    prog_j = jnp.float32(step) / steps
    want = np.asarray(jax_nasnet.drop_path_keep_prob(0.6, cell, total,
                                                     prog_j), np.float32)
    got = nasnet_model.drop_path_keep_prob(
        0.6, cell, total, torch.tensor(step).float() / steps)
    assert float(got) == float(want)
  # bf16: x / keep * floor(keep + U), as the JAX expression rounds it.
  net = nasnet_model.NasnetCifarModel().make_module(NCLASS, torch.bfloat16)
  net.train()
  net.total_steps = 10
  net.rng_step = torch.tensor(4)
  net._progress = torch.tensor(4).float() / 10
  x = torch.randn(8, 4, 3, 3).to(torch.bfloat16)
  u = np.random.default_rng(3).uniform(size=(8, 1, 1, 1)).astype(np.float32)
  net.uniform = lambda shape, device, dtype: torch.from_numpy(u).to(dtype)
  y = net._drop_path(x, 7, 20)
  keep = jnp.asarray(jax_nasnet.drop_path_keep_prob(
      0.6, 7, 20, jnp.float32(4) / 10), jnp.bfloat16)
  xj = jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16)
  yj = xj / keep * jnp.floor(keep + jnp.asarray(u, jnp.bfloat16))
  np.testing.assert_array_equal(
      y.float().numpy().transpose(0, 2, 3, 1), np.asarray(yj, np.float32))
