"""The port's ops/allreduce.py against the JAX package's, on the CPU.

The spec parser, the size bucketing and the packing are pure: every spec
string tests/test_allreduce.py parses gives the same tuples (and every one
it rejects is rejected). The reducers run in one gloo world of 2 and one of
4 ranks (tests/torch_dp_worker.py, one spawn per world), each rank on its
own seeded tensors, against the JAX reducer of the same kind on a virtual
CPU mesh of the same size fed the same tensors as its replicas': the spec
planner with psum, rsag and hier and a size-ranged spec, small-gradient
packing, gradient repacking and the hierarchical copy, each with the f32
and the bf16 wire. The port reduces every pack with one all_reduce mean,
where the JAX package runs rsag and hier as collectives of their own, so
these cases hold the port's bucketing and packing against other reduction
orders. f32: rtol 1e-6 (sum order only). bf16: both sides round
every rank's tensor to bf16 and sum in bf16 in their own order, so an
element may differ by two bf16 ulps of the largest partial sum (2^-6 of
the sum of the ranks' magnitudes); the bf16 results must also differ from
the f32 ones, which shows that the wire was compacted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from kf_benchmarks_tpu.ops import allreduce as jax_allreduce
from kf_benchmarks_tpu.parallel.mesh import build_mesh
from kf_benchmarks_tpu_torch.ops import allreduce

import torch_dp_worker as worker

# Every spec string of tests/test_allreduce.py.
GOOD_SPECS = ("psum", "rsag#4", "psum:32k:rsag", "nccl", "pscpu:32k:xring",
              "hier#2", "psum:32:rsag", "psum:32k:hier", "rsag",
              "nccl/xring", "psgpu:1m:pscpu/pscpu")
BAD_SPECS = ("bogus", "psum:32k", "psum:zz:rsag", "psum:32k:rsag:16k",
             "psum:32k:rsag:16k:hier", "rsag#x")

SHAPES = ((31, 3), (2,), (1000,), (17, 5, 4), (3,), (64,))
# (label, kind, kwargs): the JAX twin of each is built in _jax_reducer.
REDUCERS = (
    ("psum", "planner", dict(spec="psum")),
    ("rsag", "planner", dict(spec="rsag#2")),
    ("hier", "planner", dict(spec="hier#2")),
    ("ranged", "planner", dict(spec="psum:256:rsag")),
    ("ranged_agg", "planner", dict(spec="psum:256:rsag", agg_max_bytes=64,
                                   agg_max_group=2)),
    ("pack_small", "pack_small", dict(max_bytes=300, max_group=2)),
    ("repack", "repack", dict(chunks=3)),
    ("hier_copy", "hier", {}),
)
WIRES = (False, True)
WORLDS = (2, 4)
_RESULTS = {}


def _tensors(world):
  out = []
  for r in range(world):
    rng = np.random.default_rng(40 + r)
    out.append([(rng.normal(size=s) * (r + 1)).astype(np.float32)
                for s in SHAPES])
  return out


def torch_results(world, tmp_path_factory):
  if world not in _RESULTS:
    case = dict(name="reducers", tensors=_tensors(world),
                reducers=[(f"{label}_{int(w)}", kind, kw, w)
                          for label, kind, kw in REDUCERS for w in WIRES])
    _RESULTS[world] = worker.run_world(
        world, [case], tmp_path_factory.mktemp(f"reducers{world}"))
  return _RESULTS[world]


def _jax_reducer(kind, kwargs, world, wire):
  compact = jnp.bfloat16 if wire else None
  if kind == "planner":
    kw = dict(kwargs)
    spec = jax_allreduce.parse_all_reduce_spec(kw.pop("spec"))
    planner = jax_allreduce.CollectivePlanner(
        spec, num_replicas_hint=world, compact_dtype=compact, **kw)
    return planner.reduce
  if kind == "pack_small":
    return lambda g, ax: jax_allreduce.pack_small_reduce(
        g, ax, kwargs["max_bytes"], kwargs["max_group"], world, compact)
  if kind == "repack":
    return lambda g, ax: jax_allreduce.repack_reduce(
        g, ax, kwargs["chunks"], world, compact)
  return lambda g, ax: jax_allreduce.hier_reduce(g, ax, compact_dtype=compact)


def _jax_reduce(kind, kwargs, world, wire, tensors):
  fn = _jax_reducer(kind, kwargs, world, wire)
  mesh = build_mesh(world, "cpu")
  stacked = [jnp.stack([jnp.asarray(tensors[r][i]) for r in range(world)])
             for i in range(len(SHAPES))]

  def body(*leaves):
    out = fn([jnp.squeeze(x, 0) for x in leaves], "replica")
    return tuple(x[None] for x in out)

  f = jax.jit(jax.shard_map(body, mesh=mesh,
                            in_specs=(P("replica"),) * len(SHAPES),
                            out_specs=(P("replica"),) * len(SHAPES)))
  return [np.asarray(x) for x in f(*stacked)]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_spec_parses_like_jax(spec):
  got = allreduce.parse_all_reduce_spec(spec)
  ref = jax_allreduce.parse_all_reduce_spec(spec)
  assert [tuple(t) for t in got] == [tuple(t) for t in ref]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_spec_rejected_like_jax(spec):
  with pytest.raises(ValueError):
    jax_allreduce.parse_all_reduce_spec(spec)
  with pytest.raises(ValueError):
    allreduce.parse_all_reduce_spec(spec)


def test_size_buckets_match_jax():
  rng = np.random.default_rng(3)
  for _ in range(20):
    sizes = [int(s) for s in rng.integers(1, 5000, rng.integers(0, 30))]
    bound = int(rng.integers(1, 20000))
    assert (allreduce.plan_size_buckets(sizes, bound) ==
            jax_allreduce.plan_size_buckets(sizes, bound))


@pytest.mark.parametrize("multiple", [1, 8])
def test_pack_round_trip(multiple):
  import torch
  tensors = [torch.arange(5, dtype=torch.float32),
             torch.ones(2, 3) * 2, torch.zeros(1, 1, 4, dtype=torch.bfloat16)]
  vec, meta = allreduce.pack_tensors(tensors, multiple_of=multiple)
  assert vec.numel() % multiple == 0 and vec.dtype == torch.float32
  for a, b in zip(tensors, allreduce.unpack_tensors(vec, meta)):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_compact_wire_dtype_rules():
  import torch
  from kf_benchmarks_tpu_torch import params as params_lib
  assert allreduce.compact_wire_dtype(
      params_lib.make_params(use_fp16=True)) == torch.bfloat16
  assert allreduce.compact_wire_dtype(params_lib.make_params()) is None
  assert allreduce.compact_wire_dtype(params_lib.make_params(
      use_fp16=True, compact_gradient_transfer=False)) is None
  assert allreduce.compact_wire_dtype(params_lib.make_params(
      compact_gradient_transfer_f32=True)) == torch.bfloat16


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wire", WIRES, ids=["f32", "bf16"])
@pytest.mark.parametrize("label,kind,kwargs", REDUCERS,
                         ids=[r[0] for r in REDUCERS])
def test_reducer_matches_jax(label, kind, kwargs, wire, world,
                             tmp_path_factory):
  results = torch_results(world, tmp_path_factory)
  tensors = _tensors(world)
  ref = _jax_reduce(kind, kwargs, world, wire, tensors)
  magnitude = [sum(np.abs(tensors[r][i]) for r in range(world)) / world
               for i in range(len(SHAPES))]
  exact = np.mean([tensors[r][0] for r in range(world)], axis=0)
  for rank in range(world):
    got = results[rank]["reducers"][f"{label}_{int(wire)}"]
    f32 = results[rank]["reducers"][f"{label}_0"]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
      assert g.shape == SHAPES[i] and g.dtype == np.float32
      if wire:
        err = np.abs(g - r[rank])
        assert np.all(err <= 2.0 ** -6 * magnitude[i]), (label, i, rank,
                                                         err.max())
      else:
        np.testing.assert_allclose(g, r[rank], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{label} {i} rank {rank}")
    if wire:
      assert not all(np.array_equal(a, b) for a, b in zip(got, f32)), label
    else:
      np.testing.assert_allclose(got[0], exact, rtol=1e-5, atol=1e-6)
