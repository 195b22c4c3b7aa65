"""The port's FSDP sharded parameters (--shard_params, ops/sharded.py and
ops/overlap.py ``GatherParams``) against the JAX package's, on the CPU.

* The layout: ``fsdp_stacked_shards`` gives arrays equal to the JAX
  package's on scalar, prime-sized, 4-D and scanned (L, ...) leaves at
  n = 1, 2, 3, 4 and 8.
* The step: one gloo world of 2 ranks and one of 4 (tests/torch_dp_worker.py,
  spawned once each for the file) run --shard_optimizer_state
  --shard_params and the port's replicated step on the three models of
  tests/torch_dp_modes.py. Held against the JAX package's replicated step at
  the module's tolerances; torch against torch, bitwise equal to the port's
  replicated step at 2 ranks, also at --steps_per_dispatch=4 (the
  trivial model and the LM) and --num_grad_accum=2. The LM is held bitwise at weight decay 0: with weight
  decay its block stack's L2 term is summed shard-locally and all-reduced
  (the JAX package's _l2_loss_mixed), the exact value reassociated, so
  there its losses are held at rtol 1e-6 and its weights at 1e-6 of their
  norm against the replicated step (measured: 9.6e-8 and 1.3e-8). Between
  steps each rank holds sum(ceil(size / n)) f32 elements of parameters and
  of momentum.
* The gather: under the LM's block checkpoints each block is gathered in
  its forward and again in its recompute, one packed collective each.
* Checkpoints: a world-2 FSDP checkpoint resumes bitwise equal to an
  uninterrupted run; --eval over it (desharded) scores exactly what --eval
  over the replicated run's checkpoint scores, both written by the CLI at
  two gloo ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kf_benchmarks_tpu import params as jax_params
from kf_benchmarks_tpu import validation as jax_validation
from kf_benchmarks_tpu.ops import sharded as jax_sharded
from kf_benchmarks_tpu_torch import benchmark
from kf_benchmarks_tpu_torch import checkpoint
from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch import params as port_params
from kf_benchmarks_tpu_torch import validation
from kf_benchmarks_tpu_torch.ops import overlap
from kf_benchmarks_tpu_torch.ops import sharded

import torch_dp_modes as modes
import torch_dp_worker as worker

FSDP = dict(shard_optimizer_state=True, shard_params=True)
VARIANTS = {"": {}, "_k4": dict(k=4, steps=4),
            "_m2": dict(params_extra=dict(num_grad_accum=2))}
# (model, variant) pairs held bitwise at two ranks: every model at K = 1
# and M = 2, and K = 4 on the trivial model and the LM (the ResNet's four
# steps are the costliest CPU work of the file).
BITWISE = [(m, s) for m in modes.MODELS for s in VARIANTS
           if not (m == "resnet" and s == "_k4")]
LEAVES = {"scalar": (), "prime": (7,), "conv": (3, 3, 2, 5)}
SCANNED = {"stack_prime": (2, 7), "stack_conv": (3, 3, 2, 5)}
LM_WD_RTOL = 1e-6
_RESULTS = {}


def _cases(world, path):
  cases = []
  variants = VARIANTS if world == 2 else {"": {}}
  for model in modes.MODELS:
    # The LM bitwise at weight decay 0 (module notes).
    wd = dict(weight_decay=0.0) if model == "lm" else {}
    for suffix, extra in variants.items():
      if (model, suffix) not in BITWISE:
        continue
      extra = dict(extra)
      flags = extra.pop("params_extra", {})
      for name, mf in (("replicated", {}), ("fsdp", FSDP)):
        c = modes.case(f"{model}_{name}{suffix}", model, world,
                       {**mf, **flags}, **wd)
        c.update(extra)
        cases.append(c)
  cases += [modes.case("lm_replicated_wd", "lm", world, {}),
            modes.case("lm_fsdp_wd", "lm", world, FSDP)]
  if world == 2:
    lm = lambda name, **kw: modes.case(name, "lm", world,
                                       {**FSDP, "optimizer": "adam"}, **kw)
    cases += [lm("ckpt_full", steps=4),
              lm("ckpt_half", steps=2, save=path, snapshot=True),
              lm("ckpt_resume", steps=2, restore=path)]
  return cases


def torch_results(world, tmp_path_factory):
  if world not in _RESULTS:
    tmp = tmp_path_factory.mktemp(f"fsdp{world}")
    _RESULTS[world] = worker.run_world(
        world, _cases(world, str(tmp / "model.ckpt-2.pt")), tmp)
  return _RESULTS[world]


# -- torch against torch (first: they pay for the spawns) ----------------------

@pytest.mark.parametrize("model,suffix", BITWISE,
                         ids=[m + (s or "_k1") for m, s in BITWISE])
def test_fsdp_bitwise_the_replicated_step_at_two_ranks(model, suffix,
                                                      tmp_path_factory):
  results = torch_results(2, tmp_path_factory)
  modes.check_bitwise(results, f"{model}_fsdp{suffix}",
                      f"{model}_replicated{suffix}")


@pytest.mark.parametrize("world", modes.WORLDS)
def test_lm_weight_decay_over_shards_is_reassociated_only(world,
                                                         tmp_path_factory):
  for res in torch_results(world, tmp_path_factory):
    got, ref = res["lm_fsdp_wd"], res["lm_replicated_wd"]
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=LM_WD_RTOL)
    a, b = got["weights"][-1], ref["weights"][-1]
    assert float((a - b).norm()) <= LM_WD_RTOL * float(b.norm())


@pytest.mark.parametrize("world", modes.WORLDS)
def test_fsdp_holds_one_shard_of_params_and_state(world, tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  for model in modes.MODELS:
    for res in results:
      got = res[f"{model}_fsdp"]
      want = modes.shard_bytes(model, world)
      assert (got["opt_bytes"], got["param_bytes"]) == (want, want), model
    module = worker.port_model(model).make_module(worker.NCLASS)
    prefixes = module.stacked_prefixes if model == "lm" else ()
    buckets, _ = overlap.module_buckets(module, overlap.DEFAULT_BUCKET_MB
                                        << 20, prefixes)
    blocks = worker.LM_LAYERS if model == "lm" else 0
    assert results[0][f"{model}_fsdp"]["buckets"] == len(buckets) + blocks


def test_each_block_is_gathered_in_its_forward_and_its_recompute(
    monkeypatch):
  gathered = []
  apply = overlap.GatherParams.apply
  monkeypatch.setattr(overlap.GatherParams, "apply",
                      lambda spec, *s: gathered.append(len(s)) or
                      apply(spec, *s))
  model = worker.port_model("lm")
  module = model.make_module(worker.NCLASS)
  p = port_params.make_params(device="cpu", **modes.FLAGS, **FSDP)
  step = worker.make_step(model, module, p, 0.05)
  tokens, labels = modes.batches("lm", 1)[0]
  step(torch.from_numpy(tokens), torch.from_numpy(labels).long())
  per_block = len(step.sharding.block_buckets[0])
  top = len(step.sharding.buckets)
  assert gathered == ([len(b) for b in step.sharding.buckets] +
                      [per_block] * (2 * worker.LM_LAYERS))
  assert top == 1 and per_block == 11


def test_checkpoint_resumes_bitwise(tmp_path_factory):
  results = torch_results(2, tmp_path_factory)
  for res in results:
    full, resumed = res["ckpt_full"], res["ckpt_resume"]
    assert resumed["losses"] == full["losses"][2:]
    assert torch.equal(resumed["weights"][-1], full["weights"][-1])
  snap = results[0]["ckpt_half"]["snapshot"]
  assert snap["params_layout"] == snap["opt_state_layout"] == "sharded"
  assert snap["model"]["lm_head"].shape == (
      2, -(-worker.LM_D * worker.LM_VOCAB // 2))


def _cli_train(train_dir, *flags):
  rc = cli.main(["--device=cpu", "--model=trivial", "--num_devices=2",
                 "--batch_size=2", "--num_batches=2",
                 "--num_warmup_batches=0", "--optimizer=momentum",
                 f"--train_dir={train_dir}", *flags])
  assert rc == 0


def _eval(train_dir, monkeypatch):
  monkeypatch.setattr(benchmark, "log_fn", lambda s: None)
  return benchmark.BenchmarkCNN(port_params.make_params(
      model="trivial", device="cpu", batch_size=2, eval=True,
      num_eval_batches=1, train_dir=str(train_dir))).run()


def test_eval_over_an_fsdp_checkpoint_deshards_it(tmp_path, monkeypatch):
  _cli_train(tmp_path / "fsdp", "--shard_optimizer_state",
             "--shard_params")
  _cli_train(tmp_path / "replicated")
  snap, _, step = checkpoint.load_latest_checkpoint(str(tmp_path / "fsdp"))
  assert step == 2 and snap["params_layout"] == "sharded"
  got = _eval(tmp_path / "fsdp", monkeypatch)
  want = _eval(tmp_path / "replicated", monkeypatch)
  for key in ("top_1_accuracy", "top_5_accuracy", "base_loss",
              "global_step"):
    assert got[key] == want[key], key


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("model", modes.MODELS)
@pytest.mark.parametrize("world", modes.WORLDS)
def test_fsdp_matches_the_jax_replicated_step(world, model,
                                              tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  name = "lm_fsdp_wd" if model == "lm" else f"{model}_fsdp"
  modes.check_matches_jax(model, world, results, name)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_fsdp_stacked_shards_equal_the_jax_layout(n):
  rng = np.random.default_rng(n)
  leaves = {**{("plain", k): v for k, v in LEAVES.items()},
            **{("blocks", k): v for k, v in SCANNED.items()}}
  xs = {path: rng.normal(size=shape).astype(np.float32)
        for path, shape in leaves.items()}
  got = sharded.fsdp_stacked_shards(
      {path: torch.from_numpy(x) for path, x in xs.items()}, n, ("blocks",))
  tree = {"plain": {}, "blocks": {}}
  for (top, leaf), x in xs.items():
    tree[top][leaf] = jnp.asarray(x)
  want = jax_sharded.fsdp_stacked_shards(tree, n, ("blocks",))
  for (top, leaf), t in got.items():
    assert np.array_equal(t.numpy(), np.asarray(want[top][leaf])), (top,
                                                                  leaf)
  with pytest.raises(ValueError, match="leading layer axis"):
    sharded.fsdp_stacked_shards({("blocks", "s"): torch.zeros(())}, n,
                                ("blocks",))


# -- validation ----------------------------------------------------------------

def test_shard_params_alone_carries_the_jax_message():
  with pytest.raises(validation.ParamError) as got:
    validation.validate_cross_flags(port_params.make_params(
        shard_params=True))
  with pytest.raises(jax_validation.ParamError) as want:
    jax_validation.validate_cross_flags(jax_params.make_params(
        shard_params=True))
  assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {}, dict(reduce_bucket_mb=1), dict(num_grad_accum=2, batch_size=4),
    dict(steps_per_dispatch=4), dict(optimizer="adam"),
])
def test_compositions_are_admitted_as_in_jax(kw):
  kw = {**FSDP, **kw}
  validation.validate_cross_flags(port_params.make_params(device="cpu",
                                                          **kw))
  jax_validation.validate_cross_flags(jax_params.make_params(**kw))
