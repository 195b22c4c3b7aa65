"""The port's auto loss scale (kf_benchmarks_tpu_torch/train_step.py)
against the JAX package's train_step.make_step_fns, on the CPU in f32.

The small ResNet-50 v1.5 (``(1, 2, 1, 1)``, batch 2 at 64 px) starts from
one converted flax init with an initial scale of 2^127: the scaled loss
overflows f32, so the first steps are skipped while the scale halves; with
--fp16_inc_loss_scale_every_n=2 every second clean step doubles it again,
until it passes the f32 range and the next step overflows. Nesterov
momentum runs under a warmup rate, which in both frameworks follows the
count of applied updates (optax keeps its schedule count, like the rest
of its state, on a skipped step). Held: the scale after every step, the
skipped steps, the parameters and the batch-norm averages (the ResNet
tolerance of tests/test_torch_train_step.py, 1e-2, as one vector: the
twelve steps at batch 2 are chaotic in f32; the parameters' update is
more than three times that tolerance, so a run that applies nothing
fails), and on each skipped step the port's weights, momentum buffers and
averages bitwise unchanged. Within the port, every applied step under the
scale is bitwise the step without one: the scales are powers of two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kf_benchmarks_tpu import learning_rate as jax_lr
from kf_benchmarks_tpu import optimizers as jax_optimizers
from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import train_step as jax_train_step
from kf_benchmarks_tpu.parallel import strategies as jax_strategies
from kf_benchmarks_tpu.parallel.mesh import build_mesh
from kf_benchmarks_tpu_torch import convert
from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step

import torch_parity as tp

torch.set_num_threads(2)

STEPS = 12
BATCH = 2
WEIGHT_DECAY = 1e-3
FLAGS = dict(use_fp16=True, fp16_enable_auto_loss_scale=True,
             fp16_loss_scale=2.0 ** 127, fp16_inc_loss_scale_every_n=2,
             optimizer="momentum", init_learning_rate=0.01,
             num_learning_rate_warmup_epochs=1.0, weight_decay=WEIGHT_DECAY)
# An epoch of 5 steps: the warmup spans the run.
EXAMPLES = 10


def _setup(seed=21):
  images, labels = tp.batch(BATCH, 64, seed=seed)
  model, variables = tp.jax_model_and_variables(images, seed=seed)
  return images, labels, model, variables


def _update_count(opt_state):
  """optax's schedule count: the updates applied (a skipped step keeps
  it)."""
  counts = {int(np.asarray(leaf).ravel()[0]) for path, leaf in
            jax.tree_util.tree_flatten_with_path(opt_state)[0]
            if getattr(path[-1], "name", None) == "count"}
  assert len(counts) == 1, counts
  return counts.pop()


def _jax_run(model, variables, images, labels):
  """[(scale after the step, skipped)], final params and batch stats."""
  module = model.make_module(nclass=tp.NCLASS, phase_train=True)
  p = jax_params.make_params(device="cpu", num_devices=1, **FLAGS)
  lr_fn = jax_lr.make_learning_rate_fn(p, model, BATCH, EXAMPLES)
  tx = jax_optimizers.get_optimizer(p, lr_fn)
  init_state, step, _, broadcast_init, _ = jax_train_step.make_step_fns(
      model, module, module, jax_strategies.get_strategy(p), tx, lr_fn, p,
      build_mesh(1, "cpu"))
  stack = lambda tree: jax.tree.map(lambda x: jnp.asarray(x)[None], tree)
  state = init_state(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
  state = state.replace(params=broadcast_init(stack(variables["params"])),
                        batch_stats=stack(variables["batch_stats"]))
  assert float(state.loss_scale) == 2.0 ** 127
  trace = []
  for _ in range(STEPS):
    before = _update_count(state.opt_state)
    state, _ = step(state, jnp.asarray(images), jnp.asarray(labels))
    trace.append((float(state.loss_scale),
                  _update_count(state.opt_state) == before))
  params = convert.replica_variables(jax.device_get(state.params), 0)
  stats = convert.replica_variables(jax.device_get(state.batch_stats), 0)
  return trace, params, stats


def _port_state(module, opt):
  return ([q.detach().clone() for q in module.parameters()],
          [b.clone() for b in port_train_step.batch_stats(module)],
          [v.clone() for st in opt.state.values() for v in st.values()
           if isinstance(v, torch.Tensor)])


def _port_run(variables, images, labels):
  model, module = tp.port_module(variables)
  p = port_params.make_params(device="cpu", **FLAGS)
  opt = port_optimizers.get_optimizer(p, module.parameters())
  lr_fn = port_lr.make_learning_rate_fn(p, model, BATCH, EXAMPLES)
  scale, auto = port_train_step.loss_scale_settings(p)
  assert (scale, auto) == (2.0 ** 127, True)
  step = port_train_step.TrainStep(
      model, module, opt, lr_fn, WEIGHT_DECAY, loss_scale=scale,
      auto_loss_scale=auto,
      inc_loss_scale_every_n=p.fp16_inc_loss_scale_every_n)
  x = torch.from_numpy(images)
  y = torch.from_numpy(labels).long()
  trace, unchanged_on_skip = [], []
  for _ in range(STEPS):
    before = _port_state(module, opt)
    count = step.update_count
    m = step(x, y)
    skipped = step.update_count == count
    trace.append((m["loss_scale"], skipped))
    if skipped:
      after = _port_state(module, opt)
      unchanged_on_skip.append(all(
          len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))
          for a, b in zip(before, after)))
  assert step.global_step == STEPS
  params = {}
  for key, q in module.named_parameters():
    _, layer, leaf, kind = convert.leaf_of(key, q)
    params[(layer, leaf)] = convert.to_flax_layout(q.detach().numpy(), kind)
  return trace, params, tp.port_batch_stats(module), unchanged_on_skip


def test_auto_loss_scale_matches_jax():
  images, labels, model, variables = _setup()
  jax_trace, jax_p, jax_bs = _jax_run(model, variables, images, labels)
  port_trace, port_p, port_bs, unchanged = _port_run(variables, images,
                                                     labels)
  assert port_trace == jax_trace
  scales = [s for s, _ in jax_trace]
  skips = [s for _, s in jax_trace]
  # Skipped at the start (the scale halves), clean steps that double it,
  # and in the end a doubling past the f32 range: an infinite scale,
  # which the JAX package's f32 state keeps (inf / 2 is inf), and a skip.
  assert skips[:4] == [True, True, True, False]
  assert scales[:3] == [2.0 ** 126, 2.0 ** 125, 2.0 ** 124]
  assert any(b > a for a, b in zip(scales, scales[1:]))
  assert scales[-1] == float("inf") and skips[-1] and not skips[-2]
  assert unchanged and all(unchanged)
  init = tp.flat_flax(variables["params"])
  for what, got, ref in (("params", port_p, jax_p),
                         ("batch stats", port_bs, tp.flat_flax(jax_bs))):
    ref = tp.flat_flax(ref) if what == "params" else ref
    keys = sorted(ref)
    assert set(got) == set(ref), what
    g = np.concatenate([got[k].ravel() for k in keys])
    r = np.concatenate([ref[k].ravel() for k in keys])
    assert np.linalg.norm(g - r) <= 1e-2 * np.linalg.norm(r), what
  r0 = np.concatenate([init[k].ravel() for k in sorted(init)])
  r = np.concatenate([tp.flat_flax(jax_p)[k].ravel() for k in sorted(init)])
  assert np.linalg.norm(r - r0) >= 3 * 1e-2 * np.linalg.norm(r)


def test_loss_scaled_steps_equal_unscaled_steps_bitwise():
  """The auto-scaled run against one without a loss scale that takes only
  the steps the first applied: the weights and averages agree bitwise
  after every step (scaling by a power of two and back is exact)."""
  images, labels, _, variables = _setup()
  plain_flags = {k: v for k, v in FLAGS.items()
                 if k != "use_fp16" and not k.startswith("fp16_")}
  runs = []
  for flags in (FLAGS, plain_flags):
    model, module = tp.port_module(variables)
    p = port_params.make_params(device="cpu", **flags)
    scale, auto = port_train_step.loss_scale_settings(p)
    runs.append((module, port_train_step.TrainStep(
        model, module, port_optimizers.get_optimizer(p, module.parameters()),
        port_lr.make_learning_rate_fn(p, model, BATCH, EXAMPLES),
        WEIGHT_DECAY, loss_scale=scale, auto_loss_scale=auto,
        inc_loss_scale_every_n=p.fp16_inc_loss_scale_every_n)))
  (scaled_module, scaled), (plain_module, plain) = runs
  assert not plain.use_loss_scale
  x = torch.from_numpy(images)
  y = torch.from_numpy(labels).long()
  for _ in range(STEPS):
    count = scaled.update_count
    scaled(x, y)
    if scaled.update_count > count:
      plain(x, y)
    for a, b in ((scaled_module.parameters(), plain_module.parameters()),
                 (port_train_step.batch_stats(scaled_module),
                  port_train_step.batch_stats(plain_module))):
      assert all(torch.equal(u, v) for u, v in zip(a, b))
  assert plain.update_count == scaled.update_count == 8


def test_skipped_step_keeps_running_averages_bitwise():
  """A step skipped for an overflow restores the averages its forward
  moved; the step counter still advances and the rate does not."""
  images, labels, _, variables = _setup(seed=3)
  model, module = tp.port_module(variables)
  p = port_params.make_params(device="cpu", **FLAGS)
  opt = port_optimizers.get_optimizer(p, module.parameters())
  step = port_train_step.TrainStep(
      model, module, opt, lambda s: 0.1 * (s + 1), WEIGHT_DECAY,
      loss_scale=2.0 ** 127, auto_loss_scale=True)
  before = [b.clone() for b in port_train_step.batch_stats(module)]
  m = step(torch.from_numpy(images), torch.from_numpy(labels).long())
  assert m["loss_scale"] == 2.0 ** 126 and m["learning_rate"] == 0.1
  assert step.global_step == 1 and step.update_count == 0
  assert step.loss_scale_normal_steps == 0
  for b, old in zip(port_train_step.batch_stats(module), before):
    assert torch.equal(b, old)
  # The forward did move them: a training forward alone changes them.
  module(torch.from_numpy(images))
  assert not all(torch.equal(b, old) for b, old in
                 zip(port_train_step.batch_stats(module), before))


def test_loss_scale_resolution_matches_jax():
  """1 for bfloat16 unless --fp16_loss_scale is given, and 1 without
  --use_fp16 (train_step.py:263-279); the model's float16 scale is the
  JAX package's 128, which the port never computes in."""
  model, _ = tp.port_module(_setup()[3])
  cases = [(dict(), 1.0, False),
           (dict(use_fp16=True), 1.0, False),
           (dict(use_fp16=True, fp16_loss_scale=8.0), 8.0, False),
           (dict(fp16_loss_scale=8.0), 1.0, False),
           (dict(use_fp16=True, fp16_enable_auto_loss_scale=True), 1.0,
            True)]
  for flags, scale, auto in cases:
    p = port_params.make_params(device="cpu", **flags)
    assert port_train_step.loss_scale_settings(p) == (scale, auto), flags
  assert model.get_fp16_loss_scale() == _setup()[2].get_fp16_loss_scale()


def test_loss_scale_state_lives_on_the_device(monkeypatch):
  """The auto-scaled step decides its skip on the device: the loss scale,
  its count of clean steps and the update count are 0-d tensors on the
  module's device, and four steps (three skipped, one applied, as in the
  JAX trace above) run with every host read of a tensor refused -- the
  condition for capturing the step as a CUDA graph -- ending bitwise where
  the same steps end with host reads allowed."""
  images, labels, _, variables = _setup()
  x = torch.from_numpy(images)
  y = torch.from_numpy(labels).long()
  runs = []
  for refuse in (False, True):
    model, module = tp.port_module(variables)
    p = port_params.make_params(device="cpu", **FLAGS)
    step = port_train_step.TrainStep(
        model, module, port_optimizers.get_optimizer(p, module.parameters()),
        port_lr.make_learning_rate_fn(p, model, BATCH, EXAMPLES),
        WEIGHT_DECAY, loss_scale=2.0 ** 127, auto_loss_scale=True,
        inc_loss_scale_every_n=2)
    for t in (step._loss_scale, step._normal_steps, step._update_count):
      assert t.shape == () and t.device == x.device
    with monkeypatch.context() as m:
      if refuse:
        def no_host_read(*_a, **_k):
          raise AssertionError("a host read inside the step")
        for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
          m.setattr(torch.Tensor, name, no_host_read)
      metrics = [step(x, y) for _ in range(4)]
    runs.append((metrics, _port_state(module, step.optimizer),
                 step.counters()))
  (ref_m, ref_state, ref_counters), (got_m, got_state, got_counters) = runs
  assert [float(m["loss_scale"]) for m in got_m] == \
      [2.0 ** 126, 2.0 ** 125, 2.0 ** 124, 2.0 ** 124]
  assert got_counters == ref_counters and got_counters["update_count"] == 1
  for a, b in zip(ref_m, got_m):
    assert all(torch.equal(a[k], b[k]) for k in a)
  for a, b in zip(ref_state, got_state):
    assert all(torch.equal(u, v) for u, v in zip(a, b))
