"""Serving path: continuous-batching LM inference on the card.

The port's counterpart of kf_benchmarks_tpu/serving/ on one device:

* ``decode.py`` -- the KV-cache decode programs: packed prefill
  (mixed-length prompts in one pass, riding data/packing.py), the
  single-token decode step (models/transformer_lm.py ``decode``; attention =
  parallel/sequence.py ``decode_attention``, the hand-written decode
  kernel of csrc/flash_decode.cu under ``attn_impl='flash'``), greedy
  sampling, caches updated in place; the decode-cost variants: INT8
  weights dequantized inside every program, the paged KV pool, and the
  speculative verify program with its truncated draft.
* ``engine.py`` -- the host-side request engine: a bounded bucket-ladder
  set of prepared programs, continuous in-flight batching vs static
  batch-and-drain, SLO-aware admission control, the page allocator and
  the speculative rounds, request spans on the ``RunTrace`` timeline and
  ``serving/*`` metrics.
* ``bench.py`` -- ``python -m kf_benchmarks_tpu_torch.serving.bench``: a
  seeded request trace replayed through the engine, one JSON line.
"""

from kf_benchmarks_tpu_torch.serving.decode import (  # noqa: F401
    CacheState, LMSpec, decode_fn, decode_module, forward_module,
    init_cache, init_variables, prefill_fn)
from kf_benchmarks_tpu_torch.serving.engine import (  # noqa: F401
    EngineConfig, Request, RequestResult, ServingEngine, bucket_for,
    poisson_workload)
