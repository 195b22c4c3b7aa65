"""The dropout networks' draws under --steps_per_dispatch (torch against
torch, on the CPU).

The port draws each dropout mask (and NASNet's drop-path noise) as a
counter-based function of the run's seed, the train step's step counter
on the device, the replica, the microbatch and the draw's place in the
forward (models/builder.py ``counter_uniform``): no generator state, so a
step captured as a CUDA graph draws each step's own values at each
replay. On the card chip_smoke.py holds K = 8 bitwise against eight
single steps; here:

* a TrainChunk of K = 8 (and 3 + 5) is bitwise eight single steps, losses
  and parameters, for VGG-, AlexNet- and OverFeat-shaped builder networks
  and MobileNet v2 at width 0.35, in training (masks drawn);
* the masks differ from step to step and microbatch to microbatch, and a
  step that resumes at a global step draws that step's masks again
  (the device counter follows ``global_step``);
* the draws are uniform: their mean, the share below a keep probability,
  and the low bits.
"""

import copy

import numpy as np
import pytest
import torch

from kf_benchmarks_tpu_torch import learning_rate as port_lr
from kf_benchmarks_tpu_torch import optimizers as port_optimizers
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import train_step as port_train_step
from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import mobilenet_v2

torch.set_num_threads(2)

NCLASS = 10
BATCH = 4


class _Net(builder.BuilderModel):
  def __init__(self, layers, size):
    super().__init__("net", size, BATCH, 0.01)
    self.layers = layers

  def add_inference(self, cnn):
    self.layers(cnn)


def _vgg(cnn):
  for channels in (8, 16):
    cnn.conv(channels, 3, 3)
    cnn.mpool(2, 2)
  cnn.flatten()
  cnn.affine(32)
  cnn.dropout()
  cnn.affine(32)
  cnn.dropout()


def _alexnet(cnn):
  cnn.conv(8, 5, 5, 2, 2, "VALID")
  cnn.mpool(3, 3, 2, 2)
  cnn.flatten()
  cnn.affine(32)
  cnn.dropout()


def _overfeat(cnn):
  cnn.conv(8, 3, 3, 1, 1, mode="VALID")
  cnn.mpool(2, 2)
  cnn.flatten()
  cnn.affine(24)
  cnn.dropout(0.7)


class _Mobilenet(mobilenet_v2.MobilenetModel):
  def __init__(self):
    super().__init__(depth_multiplier=0.35)
    self.image_size = 32
    self.set_batch_size(BATCH)


MODELS = {"vgg": lambda: _Net(_vgg, 16), "alexnet": lambda: _Net(_alexnet, 16),
          "overfeat": lambda: _Net(_overfeat, 16), "mobilenet": _Mobilenet}


def _step(name, num_grad_accum=1):
  model = MODELS[name]()
  module = model.make_module(NCLASS, torch.float32,
                             generator=torch.Generator().manual_seed(3))
  p = port_params.make_params(device="cpu", optimizer="momentum",
                              init_learning_rate=0.01, weight_decay=1e-4)
  step = port_train_step.TrainStep(
      model, module, port_optimizers.get_optimizer(p, module.parameters()),
      port_lr.make_learning_rate_fn(p, model, BATCH, 1000), p.weight_decay,
      num_grad_accum=num_grad_accum)
  return model, module, step


def _batch(model, seed=0):
  rng = np.random.default_rng(seed)
  size = model.image_size
  images = rng.normal(0.0, 1.0, (BATCH, size, size, 3)).astype(np.float32)
  labels = rng.integers(0, NCLASS, BATCH)
  return torch.from_numpy(images), torch.from_numpy(labels)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("dispatches", [(8,), (3, 5)], ids=["8", "3+5"])
def test_chunk_is_bitwise_the_single_steps(name, dispatches):
  model, module, step = _step(name)
  images, labels = _batch(model)
  singles = [float(step(images, labels)["total_loss"]) for _ in range(8)]
  params = [q.detach().clone() for q in module.parameters()]
  _, module2, step2 = _step(name)
  chunk = port_train_step.TrainChunk(step2, 8)
  chunked = []
  for d in dispatches:
    chunked += [float(v) for v in chunk(images, labels, d)["total_loss"]]
  assert chunked == singles
  assert step2.global_step == step.global_step == 8
  for a, b in zip(params, module2.parameters()):
    torch.testing.assert_close(b.detach(), a, rtol=0, atol=0)
  # Dropout acted: the same batch gives another loss at each step.
  assert len(set(singles)) == 8


def test_masks_follow_the_step_the_microbatch_and_a_resume():
  model, module, step = _step("vgg")
  images, labels = _batch(model)
  module.train()
  module.rng_step = torch.tensor(5)
  y5 = module(images)
  torch.testing.assert_close(module(images), y5, rtol=0, atol=0)
  module.rng_step = torch.tensor(6)
  assert not torch.equal(module(images), y5)
  module.rng_step = torch.tensor(5)
  module.rng_microbatch = 1
  assert not torch.equal(module(images), y5)
  # A resumed step (global step set from a checkpoint) draws its step's
  # masks again: steps 3 and 4 after a restore at 2 are those of a run.
  model, module, step = _step("alexnet")
  images, labels = _batch(model, 1)
  state = None
  losses = []
  for i in range(4):
    if i == 2:
      state = ({k: v.clone() for k, v in module.state_dict().items()},
               copy.deepcopy(step.optimizer.state_dict()))
    losses.append(float(step(images, labels)["total_loss"]))
  _, module2, step2 = _step("alexnet")
  module2.load_state_dict(state[0])
  step2.optimizer.load_state_dict(state[1])
  step2.global_step = 2
  step2.update_count = 2
  again = [float(step2(images, labels)["total_loss"]) for _ in range(2)]
  assert again == losses[2:]


def test_microbatches_draw_their_own_masks():
  model, module, step = _step("vgg", num_grad_accum=2)
  images, labels = _batch(model, 2)
  # Both microbatches of one step get the same half-batch: their masks
  # differ, so their losses do.
  seen = []
  orig = model.loss_function

  def noting(logits, y):
    loss = orig(logits, y)
    seen.append(float(loss.detach()))
    return loss

  model.loss_function = noting
  same = torch.cat([images[:2], images[:2]])
  step(same, torch.cat([labels[:2], labels[:2]]))
  assert len(seen) == 2 and seen[0] != seen[1]


def test_counter_draws_are_uniform():
  u = builder.counter_uniform((1000, 1000), 12345, torch.tensor(7), 3,
                              torch.device("cpu"))
  assert u.dtype == torch.float32 and 0.0 <= float(u.min()) < 1e-5
  # bf16 draws are multiples of 2^-7 below 1, so keep + U never reaches 2.
  b = builder.counter_uniform((1000,), 1, torch.tensor(0), 0,
                              torch.device("cpu"), torch.bfloat16)
  assert b.dtype == torch.bfloat16 and float(b.max()) == 1 - 2 ** -7
  assert torch.equal(b.float() * 128, (b.float() * 128).round())
  assert float(u.max()) < 1.0
  assert abs(float(u.mean()) - 0.5) < 1e-3
  for keep in (0.5, 0.7, 0.8):
    assert abs(float((u < keep).float().mean()) - keep) < 2e-3
  # The 23 bits used: the lowest one is set half the time.
  bits = (u * 2 ** 23).long()
  assert abs(float((bits & 1).float().mean()) - 0.5) < 2e-3
  v = builder.counter_uniform((1000, 1000), 12345, torch.tensor(8), 3,
                              torch.device("cpu"))
  assert abs(float(torch.corrcoef(torch.stack([u.flatten(),
                                               v.flatten()]))[0, 1])) < 5e-3
