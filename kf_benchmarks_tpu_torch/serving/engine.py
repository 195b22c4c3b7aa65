"""Request-driven serving engine: continuous batching and admission control.

The port's counterpart of kf_benchmarks_tpu/serving/engine.py on one
device (the tensor-parallel variant and the ``/metrics`` endpoint are not
ported yet, ROADMAP Queue 1 items 11 and 10):

* **Bounded program set** -- decode and prefill run only at bucket-ladder
  batch widths (default 1/4/16/64/256). Each (program, bucket) is one
  prepared program, made once and cached: run once on its dummy inputs
  (the first kernel launch builds the kernels; cuBLAS and the caching
  allocator warm up) and, on the card, then captured as a CUDA graph that
  every later call replays -- the counterpart of the JAX engine's
  compiled program per (program, bucket). The preparation's wall time
  (first run and capture) lands in the run trace's compile ledger, keyed
  on ``config_fingerprint_key``. At most ``len(ladder)`` programs exist per
  family. The graphs share one memory pool, and every program works on one
  set of static device buffers: the K/V rings of the top bucket plus a
  spare row (the decode bucket b runs on their first b rows; prefill
  padding installs into the spare row), the slots' ``pos``/``tok``/
  ``active`` vectors, and each pack bucket's input stack and index
  vectors. On the CPU, where the caller asked for it, the programs run
  eagerly on the same buffers.
* **Continuous in-flight batching** -- freed slots refill from the queue
  every decode step (``batching='continuous'``); ``'static'`` admits a
  wave, decodes it to completion and only then admits again.
* **SLO-aware admission** -- queue-depth rejection at submit, TTFT-deadline
  expiry at coalesce time, a per-tenant token bucket, and SLO burn-rate
  monitoring (metrics.SLOMonitor); sheds are results and ``serving/*``
  metrics, never exceptions.
* **Decode-cost variants** (spec-driven, composable) -- ``spec.quantize``
  serves the INT8 state, dequantized inside every program;
  ``spec.kv_page_size`` runs the paged KV pool with this engine as the
  page ALLOCATOR: the pool is sized once for the top bucket
  (``kv_pool_pages``; static, like the dense rings, so a captured program
  never sees it move), a request's pages are granted for its whole
  lifetime at prefill and returned at completion, and pool exhaustion
  requeues the wave's remainder (a shed path, never an exception). The
  slots' page tables are host numpy, the authority; each decode replay
  first copies them into the static device table its graph reads.
  ``spec.speculative_k`` runs draft-propose / target-verify rounds: the
  step loop (decode and prefill programs, the KV cache) runs the DRAFT
  (by default the target's first ``draft_n_layers`` layers), and the
  target runs once a round, a captured verify program per bucket over a
  static (bucket, max_len) token buffer; every emitted token is the
  target's own argmax, so greedy output is token-identical to plain
  greedy decode. The draft-cache rewind after a round is host
  bookkeeping and one write of the slots' ``pos``/``tok``.
* **Observability** -- request spans on the active RunTrace ("serving"
  lane), TTFT and per-token latency samples, ``serving/*`` keys in the
  port's metrics.SCHEMA.

Timing: TTFT and token latency are read on the engine's clock once a
program's values have reached the host. On the card the fetch of the next
tokens (``.cpu()``) is the synchronisation, as ``np.asarray(nxt)`` is in the
JAX engine; the loop adds no ``torch.cuda.synchronize()``.

Memory: a slot's bf16 K+V ring at the zoo LM's size is 2 x 6 layers x 2048
x 512 x 2 B = 24 MiB; the shared rings hold the top bucket's 256 slots and
the spare, 6.0 GiB (a ring per bucket of the default ladder would be 341
slots, 8.0 GiB).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kf_benchmarks_tpu_torch import metrics as metrics_lib
from kf_benchmarks_tpu_torch import quantization
from kf_benchmarks_tpu_torch import tracing as tracing_lib
from kf_benchmarks_tpu_torch.analysis import baseline
from kf_benchmarks_tpu_torch.data import packing as packing_lib
from kf_benchmarks_tpu_torch.ops import graphs
from kf_benchmarks_tpu_torch.serving import decode as decode_lib

DEFAULT_BUCKET_LADDER = (1, 4, 16, 64, 256)


def bucket_for(n: int, ladder: Sequence[int]) -> int:
  """Smallest ladder bucket >= n (the top bucket when n overflows)."""
  for b in ladder:
    if n <= b:
      return b
  return ladder[-1]


def config_fingerprint_key(config: Dict[str, Any],
                           program: str = "serving_decode") -> str:
  """Short stable key (analysis/baseline.fingerprint_key) of a serving
  program's shape: the config's non-None fields, the program name and the
  torch version (a new torch may run other kernels)."""
  shape = {k: v for k, v in config.items() if v is not None}
  return baseline.fingerprint_key({"config": shape, "program": program,
                                   "torch": torch.__version__})


@dataclasses.dataclass(frozen=True)
class EngineConfig:
  spec: decode_lib.LMSpec = dataclasses.field(
      default_factory=decode_lib.LMSpec)
  bucket_ladder: Tuple[int, ...] = DEFAULT_BUCKET_LADDER
  batching: str = "continuous"       # or "static" (batch-and-drain)
  max_new_tokens: int = 32           # default per-request cap
  max_queue_depth: int = 64          # submit-time rejection bound
  ttft_slo_s: Optional[float] = None  # default TTFT deadline (expiry)
  tenant_tokens_per_s: Optional[float] = None  # None = unmetered
  tenant_burst_s: float = 4.0        # token-bucket burst window
  # SLO burn-rate monitoring: objectives ttft_deadline (first token within
  # its deadline) and shed_fraction (admitted at all); target = good
  # fraction.
  slo_target: float = 0.99
  slo_fast_window_s: float = 15.0
  slo_slow_window_s: float = 60.0
  slo_burn_threshold: float = 2.0

  def __post_init__(self):
    ladder = tuple(sorted(set(int(b) for b in self.bucket_ladder)))
    if not ladder or ladder[0] < 1:
      raise ValueError(f"bucket ladder must be positive ints, got "
                       f"{self.bucket_ladder}")
    object.__setattr__(self, "bucket_ladder", ladder)
    if self.batching not in ("continuous", "static"):
      raise ValueError(f"batching must be 'continuous' or 'static', "
                       f"got {self.batching!r}")

  def fingerprint_config(self, bucket: int, program: str) -> dict:
    """The program-cache / compile-ledger key payload: the served model's
    shape plus the bucket."""
    return {**self.spec.config(), "bucket": int(bucket),
            "serving_program": program}


@dataclasses.dataclass
class Request:
  rid: Any
  prompt: Any                         # 1-D int32 token array
  max_new_tokens: Optional[int] = None
  tenant: str = "default"
  deadline_s: Optional[float] = None  # TTFT deadline (engine default
                                      # applies when None)
  enqueue_t: Optional[float] = None   # stamped by submit()


@dataclasses.dataclass
class RequestResult:
  rid: Any
  tenant: str
  status: str                         # ok | rejected | expired
  tokens: List[int] = dataclasses.field(default_factory=list)
  ttft_s: Optional[float] = None
  total_s: Optional[float] = None
  shed_reason: Optional[str] = None


class ServingEngine:
  """One-process serving loop over the decode.py programs.

  Synchronous: callers drive it with ``submit`` + ``drain`` or
  ``replay(workload)`` (wall-clock arrival offsets). ``variables`` is the
  served module's state_dict (default: ``init_variables(spec, seed)``),
  float or already quantized; ``draft_variables`` the speculative draft's
  (default: the target's truncation); ``device`` is the card unless the
  caller asks for the CPU. On the card the programs are CUDA graphs;
  ``_eager_programs=True`` (not a flag: for a comparison of the two) runs
  the same programs eagerly there.
  """

  _SLO_BURN_KEYS = {
      "ttft_deadline": ("serving/slo_ttft_burn_fast",
                        "serving/slo_ttft_burn_slow"),
      "shed_fraction": ("serving/slo_shed_burn_fast",
                        "serving/slo_shed_burn_slow"),
  }

  def __init__(self, config: EngineConfig, variables=None, seed: int = 0,
               time_fn: Callable[[], float] = time.monotonic,
               sleep_fn: Callable[[float], None] = time.sleep,
               recorder=None, device="cuda", draft_variables=None,
               _eager_programs: bool = False):
    self.cfg = config
    self.spec = config.spec
    self.device = torch.device(device)
    self._graphs = self.device.type == "cuda" and not _eager_programs
    self._pool = None            # the graphs' shared memory pool
    self._ring: Optional[decode_lib.CacheState] = None
    self._active_buf: Optional[torch.Tensor] = None
    self._table_buf: Optional[torch.Tensor] = None
    self._prefill_bufs: Dict[int, Dict[str, torch.Tensor]] = {}
    self._verify_bufs: Dict[int, torch.Tensor] = {}
    self._time = time_fn
    self._sleep = sleep_fn
    raw = (variables if variables is not None
           else decode_lib.init_variables(self.spec, seed))
    self.variables = decode_lib.prepare_variables(self.spec, raw)
    # The step loop (decode, prefill, the cache) runs _step_spec on
    # self.module: the draft when speculative, where the target's module
    # (self.target) runs the verify program alone.
    if self.spec.speculative_k:
      self._step_spec = decode_lib.draft_spec(self.spec)
      if draft_variables is None:
        # Self-drafting default: the target's first draft_n_layers.
        base = raw
        if quantization.has_quantized_leaves(base):
          base = quantization.dequantize_variables(base,
                                                   self.spec.param_dtype)
        draft_variables = decode_lib.truncate_variables(self.spec, base)
      self.draft_variables = decode_lib.prepare_variables(self._step_spec,
                                                          draft_variables)
      self.module = decode_lib.load_module(self._step_spec,
                                           self.draft_variables, self.device)
      self.target = decode_lib.load_module(self.spec, self.variables,
                                           self.device)
    else:
      self._step_spec = self.spec
      self.draft_variables = None
      self.module = decode_lib.load_module(self.spec, self.variables,
                                           self.device)
      self.target = self.module
    self._queue: collections.deque = collections.deque()
    self._results: Dict[Any, RequestResult] = {}
    self._order: List[Any] = []
    self._bucket = 0
    self._cache: Optional[decode_lib.CacheState] = None
    self._slots: List[Optional[dict]] = []
    self._decode_exes: Dict[int, Callable] = {}
    self._prefill_exes: Dict[int, Callable] = {}
    self._verify_exes: Dict[int, Callable] = {}
    # Paged-KV allocator (spec.kv_page_size): host page tables, one row a
    # slot of the static buffers (the spare row included); pool row 0 is
    # the scratch page, never allocated.
    self._pps = self._step_spec.pages_per_slot
    self._free_pages: List[int] = []
    self._table_np = (np.zeros((config.bucket_ladder[-1] + 1, self._pps),
                               np.int32) if self._pps else None)
    self._kv_pages_peak = 0
    self._kv_fraction_peak = 0.0
    self._spec_rounds = 0
    self._draft_tokens = 0
    self._accepted_tokens = 0
    self._accept_lens: List[float] = []
    self._arrivals = 0
    self._shed = 0
    self._completed = 0
    self._decode_steps = 0
    self._tokens_out = 0
    self._fill_sum = 0.0
    self._queue_depth_sum = 0.0
    self._ticks = 0
    self._ttfts: List[float] = []
    self._token_lat: List[float] = []
    self._tenant_allowance: Dict[str, float] = {}
    self._tenant_last: Dict[str, float] = {}
    self._tenant_ttfts: Dict[str, List[float]] = {}
    self._tenant_token_lat: Dict[str, List[float]] = {}
    self._tenant_tokens: Dict[str, int] = {}
    self._tenant_arrivals: Dict[str, int] = {}
    self._tenant_completed: Dict[str, int] = {}
    self._tenant_shed: Dict[Tuple[str, str], int] = {}
    self.slo = metrics_lib.SLOMonitor(
        objectives={"ttft_deadline": config.slo_target,
                    "shed_fraction": config.slo_target},
        fast_window_s=config.slo_fast_window_s,
        slow_window_s=config.slo_slow_window_s,
        burn_threshold=config.slo_burn_threshold,
        time_fn=time_fn, recorder=recorder)
    self._t_serve0: Optional[float] = None
    self._t_serve1: Optional[float] = None
    self.state = "idle"

  # -- admission ---------------------------------------------------------------

  def submit(self, req: Request) -> bool:
    """Enqueue one request; False when admission shed it (queue depth,
    prompt length, tenant budget). A pre-stamped ``enqueue_t`` is honoured
    (replay stamps the scheduled arrival, so TTFT includes any wait behind
    an in-flight step)."""
    now = self._time()
    if req.enqueue_t is None:
      req.enqueue_t = now
    self._arrivals += 1
    tenant = req.tenant
    self._tenant_arrivals[tenant] = self._tenant_arrivals.get(tenant, 0) + 1
    reg = metrics_lib.active()
    reg.inc("serving/requests")
    reg.inc("serving/requests", labels={"tenant": tenant})
    if len(self._queue) >= self.cfg.max_queue_depth:
      self._shed_request(req, "queue_depth")
      return False
    prompt_len = int(np.asarray(req.prompt).size)
    if prompt_len < 1:
      self._shed_request(req, "empty_prompt")
      return False
    if prompt_len > self.spec.max_len:
      self._shed_request(req, "prompt_too_long")
      return False
    if self.spec.speculative_k and (
        prompt_len + self._max_new(req) + self.spec.speculative_k
        > self.spec.max_len):
      # Verify rows are history ++ proposals laid out flat in a
      # (B, max_len) token batch: the whole lifetime must fit up front.
      self._shed_request(req, "prompt_too_long")
      return False
    if not self._tenant_admit(tenant, prompt_len + self._max_new(req), now):
      self._shed_request(req, "tenant_budget")
      return False
    tracing_lib.active().instant("serving", "enqueue", rid=str(req.rid),
                                 tenant=tenant)
    self._queue.append(req)
    return True

  def _max_new(self, req: Request) -> int:
    return int(req.max_new_tokens or self.cfg.max_new_tokens)

  def _deadline(self, req: Request) -> Optional[float]:
    return (req.deadline_s if req.deadline_s is not None
            else self.cfg.ttft_slo_s)

  def _tenant_admit(self, tenant: str, tokens: int, now: float) -> bool:
    rate = self.cfg.tenant_tokens_per_s
    if rate is None:
      return True
    burst = rate * self.cfg.tenant_burst_s
    allowance = self._tenant_allowance.get(tenant, burst)
    last = self._tenant_last.get(tenant, now)
    allowance = min(burst, allowance + (now - last) * rate)
    self._tenant_last[tenant] = now
    if tokens > allowance:
      self._tenant_allowance[tenant] = allowance
      return False
    self._tenant_allowance[tenant] = allowance - tokens
    return True

  def _shed_request(self, req: Request, reason: str,
                    status: str = "rejected") -> None:
    self._shed += 1
    tenant = req.tenant
    self._tenant_shed[(tenant, reason)] = \
        self._tenant_shed.get((tenant, reason), 0) + 1
    reg = metrics_lib.active()
    reg.inc("serving/shed")
    reg.inc("serving/shed", labels={"tenant": tenant, "shed_reason": reason})
    # A shed is a bad event on the shed-fraction objective, and on the TTFT
    # objective when the request carried a deadline.
    self.slo.observe("shed_fraction", tenant, good=False)
    if self._deadline(req) is not None:
      self.slo.observe("ttft_deadline", tenant, good=False)
    self._publish_slo(tenant)
    tracing_lib.active().instant("serving", "shed", rid=str(req.rid),
                                 reason=reason)
    self._record(RequestResult(rid=req.rid, tenant=tenant, status=status,
                               shed_reason=reason))

  def _publish_slo(self, tenant: str) -> None:
    reg = metrics_lib.active()
    for objective, (fast_key, slow_key) in self._SLO_BURN_KEYS.items():
      burns = self.slo.burn(objective, tenant)
      if burns["fast"] is not None:
        reg.set(fast_key, burns["fast"], labels={"tenant": tenant})
      if burns["slow"] is not None:
        reg.set(slow_key, burns["slow"], labels={"tenant": tenant})

  def _note_first_token(self, req: Request, now: float) -> float:
    ttft = now - req.enqueue_t
    tenant = req.tenant
    self._ttfts.append(ttft)
    self._tenant_ttfts.setdefault(tenant, []).append(ttft)
    tracing_lib.active().add_sample("serving/ttft", ttft)
    metrics_lib.active().observe("serving/ttft_s", ttft,
                                 labels={"tenant": tenant})
    deadline = self._deadline(req)
    if deadline is not None:
      self.slo.observe("ttft_deadline", tenant, good=ttft <= deadline)
      self._publish_slo(tenant)
    return ttft

  def _record(self, result: RequestResult) -> None:
    if result.rid not in self._results:
      self._order.append(result.rid)
    self._results[result.rid] = result

  # -- prepared programs (the bounded set) -------------------------------------

  def _ring_state(self) -> decode_lib.CacheState:
    """The static cache and slot vectors: the top bucket's rows plus a
    spare last row (paged: the pool sized for the top bucket, and the
    device page table the decode programs read)."""
    if self._ring is None:
      top = self.cfg.bucket_ladder[-1]
      rows = top + 1
      if self._pps:
        self._ring = decode_lib.init_cache(self._step_spec, top, self.device,
                                           slots=rows)
        self._table_buf = torch.zeros((rows, self._pps), dtype=torch.int32,
                                      device=self.device)
        self._free_pages = list(range(1, self._ring.k.shape[1]))
      else:
        self._ring = decode_lib.init_cache(self._step_spec, rows,
                                           self.device)
      self._active_buf = torch.zeros(rows, dtype=torch.bool,
                                     device=self.device)
    return self._ring

  def _bucket_view(self, bucket: int) -> decode_lib.CacheState:
    ring = self._ring_state()
    if self._pps:  # the pool is shared by every bucket
      return decode_lib.CacheState(k=ring.k, v=ring.v, pos=ring.pos[:bucket],
                                   tok=ring.tok[:bucket])
    return decode_lib.CacheState(k=ring.k[:, :bucket], v=ring.v[:, :bucket],
                                 pos=ring.pos[:bucket], tok=ring.tok[:bucket])

  def _prepare(self, kind: str, bucket: int, fn: Callable) -> Callable:
    """Run ``fn`` once on its dummy inputs and, on the card, capture it as
    a CUDA graph; record the wall time of both (kernel builds and
    first-use set-up included) in the compile ledger. Returns the callable
    that runs the program: the graph's replay, returning its captured
    outputs, or ``fn`` itself. A failed capture raises."""
    key = config_fingerprint_key(self.cfg.fingerprint_config(bucket, kind),
                                 program=kind)
    t0 = time.monotonic()
    if not self._graphs:
      fn()
      exe = fn
    else:
      graphs.on_side_stream(fn)
      graph = graphs.Graph(fn, pool=self._pool)
      self._pool = graph.pool()

      def exe():
        graph.replay()
        return graph.outputs
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)
    tracing_lib.active().note_compile(key, kind, time.monotonic() - t0,
                                      bucket=bucket,
                                      captured=self._graphs)
    return exe

  def _decode_exe(self, bucket: int) -> Callable:
    if bucket not in self._decode_exes:
      step = decode_lib.decode_fn(self._step_spec)
      module = self.module
      view = self._bucket_view(bucket)
      active = self._active_buf[:bucket]
      # Dummy run: no slot active, so tokens and positions stay; each
      # slot's ring write is the one its next real step makes (paged: the
      # slots' tables as they stand, all 0 for a free slot).
      active.fill_(False)
      if self._pps:
        table = self._table_buf[:bucket]
        table.copy_(torch.from_numpy(self._table_np[:bucket]))
        fn = lambda: step(module, view.k, view.v, view.pos, view.tok, table,
                          active)
      else:
        fn = lambda: step(module, view.k, view.v, view.pos, view.tok, active)
      self._decode_exes[bucket] = self._prepare("serving_decode", bucket, fn)
    return self._decode_exes[bucket]

  def _prefill_exe(self, bucket: int) -> Tuple[Callable,
                                               Dict[str, torch.Tensor]]:
    """The prefill-and-install program of a PACK bucket (the wave's size,
    independent of the decode bucket) and its input buffers."""
    if bucket not in self._prefill_exes:
      prefill = decode_lib.prefill_fn(self._step_spec)
      module = self.module
      ring = self._ring_state()
      idx = lambda: torch.zeros(bucket, dtype=torch.int32, device=self.device)
      bufs = {"packed": torch.zeros((bucket, 3, self.spec.max_len),
                                    dtype=torch.int32, device=self.device),
              "rows": idx(), "last_pos": idx(), "offsets": idx(),
              "lengths": idx(),
              # Dummy run: every entry padding, into the spare row (paged:
              # its pages into the scratch page).
              "slots": idx().fill_(ring.pos.shape[0] - 1)}
      if self._pps:
        bufs["tables"] = torch.zeros((bucket, self._pps), dtype=torch.int32,
                                     device=self.device)

      def program():
        first, ek, ev = prefill(module, bufs["packed"], bufs["rows"],
                                bufs["last_pos"], bufs["offsets"])
        if self._pps:
          decode_lib.install_prefill_paged(ring, ek, ev, first,
                                           bufs["lengths"], bufs["slots"],
                                           bufs["tables"])
        else:
          decode_lib.install_prefill(ring, ek, ev, first, bufs["lengths"],
                                     bufs["slots"])
        return first

      self._prefill_bufs[bucket] = bufs
      self._prefill_exes[bucket] = self._prepare("serving_prefill", bucket,
                                                 program)
    return self._prefill_exes[bucket], self._prefill_bufs[bucket]

  def _verify_exe(self, bucket: int) -> Tuple[Callable, torch.Tensor]:
    """The speculative TARGET's verify program of a decode bucket and its
    static (bucket, max_len) token buffer (undonated, as in the JAX
    engine: its only inputs are the weights and the rows)."""
    if bucket not in self._verify_exes:
      verify = decode_lib.verify_fn(self.spec)
      target = self.target
      rows = torch.zeros((bucket, self.spec.max_len), dtype=torch.int32,
                         device=self.device)
      self._verify_bufs[bucket] = rows
      self._verify_exes[bucket] = self._prepare(
          "serving_verify", bucket, lambda: verify(target, rows))
    return self._verify_exes[bucket], self._verify_bufs[bucket]

  def _program_count(self) -> int:
    return (len(self._decode_exes) + len(self._prefill_exes)
            + len(self._verify_exes))

  def warm(self, buckets: Optional[Sequence[int]] = None) -> int:
    """Prepare the decode and prefill (and, speculative, verify) programs
    for ``buckets`` (default: the whole ladder) before serving, so the
    first wave's TTFT measures the system and not first-use set-up.
    Returns how many were made."""
    n = 0
    for b in (buckets if buckets is not None else self.cfg.bucket_ladder):
      b = bucket_for(int(b), self.cfg.bucket_ladder)
      before = self._program_count()
      self._decode_exe(b)
      self._prefill_exe(b)
      if self.spec.speculative_k:
        self._verify_exe(b)
      n += self._program_count() - before
    return n

  # -- the serving loop --------------------------------------------------------

  def _active_count(self) -> int:
    return sum(1 for s in self._slots if s is not None)

  def _ensure_bucket(self, target: int) -> None:
    """Grow the decode batch up the ladder: the bucket's rows of the
    shared rings (new slots are empty until a prefill installs them)."""
    want = bucket_for(target, self.cfg.bucket_ladder)
    if want <= self._bucket:
      return
    self._cache = self._bucket_view(want)
    self._slots.extend([None] * (want - self._bucket))
    self._bucket = want
    metrics_lib.active().set("serving/decode_bucket", want)

  def _maybe_shrink(self) -> None:
    """Compact the decode batch DOWN the ladder when occupancy fits a
    strictly lower bucket; an empty engine drops its bucket (the rings
    stay, for the prepared programs)."""
    if self._bucket == 0:
      return
    active_idx = [i for i, s in enumerate(self._slots) if s is not None]
    if not active_idx:
      self._bucket = 0
      self._cache = None
      self._slots = []
      metrics_lib.active().set("serving/decode_bucket", 0)
      return
    target = bucket_for(len(active_idx), self.cfg.bucket_ladder)
    if target >= self._bucket:
      return
    # The active slots move to the first rows, in order. Pad rows duplicate
    # slot 0's cache; they carry active=False, so their contents are never
    # read and their writes land on the pad row only.
    keep = torch.tensor(active_idx + [0] * (target - len(active_idx)),
                        dtype=torch.long, device=self.device)
    ring = self._ring_state()
    if self._pps:
      # The pool stays (its page ids with it); the active slots' table
      # rows move with them and every other row names the scratch page,
      # so a pad row's writes land nowhere live.
      table = np.zeros_like(self._table_np)
      table[:len(active_idx)] = self._table_np[active_idx]
      self._table_np = table
    else:
      ring.k[:, :target] = ring.k[:, keep]
      ring.v[:, :target] = ring.v[:, keep]
    ring.pos[:target] = ring.pos[keep]
    ring.tok[:target] = ring.tok[keep]
    self._cache = self._bucket_view(target)
    self._slots = ([self._slots[i] for i in active_idx]
                   + [None] * (target - len(active_idx)))
    self._bucket = target
    metrics_lib.active().set("serving/decode_bucket", target)

  def _coalesce(self, now: float) -> List[Request]:
    """Pop this wave's work: expired requests shed here, live ones admitted
    up to the ladder headroom left by in-flight slots."""
    headroom = self.cfg.bucket_ladder[-1] - self._active_count()
    wave: List[Request] = []
    while self._queue and len(wave) < headroom:
      req = self._queue.popleft()
      deadline = self._deadline(req)
      if deadline is not None and now - req.enqueue_t > deadline:
        self._shed_request(req, "ttft_deadline", status="expired")
        continue
      wave.append(req)
    return wave

  def _pages_needed(self, prompt_len: int, max_new: int) -> int:
    """Pages a request needs for its WHOLE lifetime (prompt + budget +
    speculative lookahead), allocated once at prefill; at most
    pages_per_slot, where the slot's positions wrap inside its pages as
    the dense ring's do."""
    page = self._step_spec.kv_page_size
    need = prompt_len + max_new + self.spec.speculative_k
    return min(self._pps, -(-need // page))

  def _prefill_wave(self, wave: List[Request]) -> None:
    self._ensure_bucket(self._active_count() + len(wave))
    free = [i for i, s in enumerate(self._slots) if s is None]
    # Pack bucket = the wave's own ladder size (every prompt fits a row).
    pack_bucket = bucket_for(len(wave), self.cfg.bucket_ladder)
    prompts = [np.asarray(r.prompt, np.int32) for r in wave]
    packed_np, placements = packing_lib.pack_prompts(
        prompts, self.spec.max_len, pack_bucket)
    placed: List[Tuple[Request, np.ndarray, Tuple[int, int], int]] = []
    overflow: List[Request] = []
    ring = self._ring_state()
    avail_pages = len(self._free_pages)
    for req, prm, place in zip(wave, prompts, placements):
      need = (self._pages_needed(prm.size, self._max_new(req))
              if self._pps else 0)
      if (place is None or len(placed) >= min(len(free), pack_bucket)
          or need > avail_pages):
        # Pool exhaustion lands here too: the request requeues and retries
        # once completions free pages (an empty engine always fits one:
        # the pool holds at least one sequence and the scratch page).
        overflow.append(req)
      else:
        avail_pages -= need
        placed.append((req, prm, place, need))
    # Requests that did not fit go back to the queue head, in order.
    for req in reversed(overflow):
      self._queue.appendleft(req)
    if not placed:
      return
    exe, bufs = self._prefill_exe(pack_bucket)
    host = {"packed": packed_np,
            "rows": np.zeros((pack_bucket,), np.int32),
            "offsets": np.zeros((pack_bucket,), np.int32),
            "last_pos": np.zeros((pack_bucket,), np.int32),
            "lengths": np.zeros((pack_bucket,), np.int32),
            # Padding entries install into the rings' spare row.
            "slots": np.full((pack_bucket,), ring.pos.shape[0] - 1,
                             np.int32)}
    page_lists: List[List[int]] = []
    if self._pps:
      # Unallocated pages and padding rows install into the scratch page.
      host["tables"] = np.zeros((pack_bucket, self._pps), np.int32)
    for i, (req, prm, (row, off), need) in enumerate(placed):
      host["rows"][i], host["offsets"][i] = row, off
      host["lengths"][i] = prm.size
      host["last_pos"][i] = off + prm.size - 1
      host["slots"][i] = free[i]
      if self._pps:
        pages = [self._free_pages.pop() for _ in range(need)]
        page_lists.append(pages)
        self._table_np[free[i], :] = 0
        self._table_np[free[i], :need] = pages
        host["tables"][i, :need] = pages
    if self._pps:
      self._note_pages()
    trace = tracing_lib.active()
    with trace.span("serving", "prefill", requests=len(placed),
                    bucket=pack_bucket):
      for name, value in host.items():
        bufs[name].copy_(torch.from_numpy(value))
      first = exe()
      # The value fetch = completion.
      first_np = first[:len(placed)].cpu().numpy()
    now = self._time()
    for i, (req, prm, _place, _need) in enumerate(placed):
      if self.spec.speculative_k:
        # The prefill ran the DRAFT: its first token is a proposal; TTFT
        # and the first emitted token come from the first verify round.
        slot = {"req": req, "tokens": [], "history": prm.copy(),
                "props": [int(first_np[i])], "t_first": None, "ttft": None}
      else:
        ttft = self._note_first_token(req, now)
        slot = {"req": req, "tokens": [int(first_np[i])], "t_first": now,
                "ttft": ttft}
      if self._pps:
        slot["pages"] = page_lists[i]
      self._slots[free[i]] = slot
      if not self.spec.speculative_k:
        if len(slot["tokens"]) >= self._max_new(req):
          self._complete(free[i], now)
        self._tokens_out += 1

  def _note_pages(self) -> None:
    pool = self._ring_state().k.shape[1]
    in_use = pool - 1 - len(self._free_pages)
    fraction = in_use / max(pool - 1, 1)
    self._kv_pages_peak = max(self._kv_pages_peak, in_use)
    self._kv_fraction_peak = max(self._kv_fraction_peak, fraction)
    reg = metrics_lib.active()
    reg.set("serving/kv_pages_in_use", in_use)
    reg.set("serving/kv_page_fraction", fraction)

  def _run_decode_exe(self, active_np: np.ndarray) -> np.ndarray:
    """One batched decode step of the step model (the draft, when
    speculative); updates the cache in place and returns the sampled
    tokens."""
    exe = self._decode_exe(self._bucket)
    self._active_buf[:self._bucket].copy_(torch.from_numpy(active_np))
    if self._pps:
      self._table_buf[:self._bucket].copy_(
          torch.from_numpy(self._table_np[:self._bucket]))
    nxt, _, _, _ = exe()
    nxt_np = nxt.cpu().numpy()  # the value fetch = completion
    self._decode_steps += 1
    reg = metrics_lib.active()
    reg.inc("serving/decode_steps")
    reg.inc("serving/decode_steps", labels={"bucket": str(self._bucket)})
    return nxt_np

  def _decode_step(self) -> None:
    bucket = self._bucket
    active_np = np.array([s is not None for s in self._slots], np.bool_)
    n_active = int(active_np.sum())
    trace = tracing_lib.active()
    t0 = self._time()
    with trace.span("serving", "decode_step", active=n_active,
                    bucket=bucket):
      nxt_np = self._run_decode_exe(active_np)
    now = self._time()
    step_wall = now - t0
    self._fill_sum += n_active / max(bucket, 1)
    self._tokens_out += n_active
    trace.add_sample("serving/token_latency", step_wall)
    self._token_lat.append(step_wall)
    reg = metrics_lib.active()
    reg.observe("serving/token_latency_s", step_wall)
    reg.set("serving/active", n_active)
    for i, slot in enumerate(self._slots):
      if slot is None:
        continue
      slot["tokens"].append(int(nxt_np[i]))
      if len(slot["tokens"]) >= self._max_new(slot["req"]):
        self._complete(i, now)

  def _speculative_round(self) -> None:
    """One draft-propose / target-verify round (the JAX engine's).

    k - 1 draft decode steps extend every active slot's proposals (a slot
    fresh from prefill already holds the draft's first one, so it offers
    k; a continuing slot offers k - 1). ONE verify of the target then
    scores every slot's row = confirmed history ++ proposals, and the
    engine accepts the longest agreeing prefix plus the verifier's own
    next token (the bonus), so every emitted token is the target's greedy
    argmax. Acceptance is capped at len(proposals) - 1, so every confirmed
    position keeps the K/V the draft wrote while proposing; the rewind
    then sets each slot's ``pos``/``tok`` to its last emitted token, whose
    K/V the next draft step writes (over a rejected proposal's)."""
    trace = tracing_lib.active()
    t0 = self._time()
    bucket = self._bucket
    active_np = np.array([s is not None for s in self._slots], np.bool_)
    n_active = int(active_np.sum())
    for _ in range(self.spec.speculative_k - 1):
      nxt_np = self._run_decode_exe(active_np)
      for i, slot in enumerate(self._slots):
        if slot is not None:
          slot["props"].append(int(nxt_np[i]))
    rows_np = np.zeros((bucket, self.spec.max_len), np.int32)
    for i, slot in enumerate(self._slots):
      if slot is None:
        continue
      row = np.concatenate([slot["history"],
                            np.asarray(slot["props"], np.int32)])
      rows_np[i, :row.size] = row
    exe, rows = self._verify_exe(bucket)
    with trace.span("serving", "verify", active=n_active, bucket=bucket):
      rows.copy_(torch.from_numpy(rows_np))
      preds = exe().cpu().numpy()  # the value fetch = completion
    now = self._time()
    self._spec_rounds += 1
    self._fill_sum += n_active / max(bucket, 1)
    reg = metrics_lib.active()
    reg.inc("serving/spec_rounds")
    reg.set("serving/active", n_active)
    ring = self._ring_state()
    new_pos = ring.pos[:bucket].cpu().numpy().copy()
    new_tok = ring.tok[:bucket].cpu().numpy().copy()
    emitted_total = round_draft = round_accepted = 0
    for i, slot in enumerate(list(self._slots)):
      if slot is None:
        continue
      history, props = slot["history"], slot["props"]
      q0 = history.size
      # props[j] sits at row position q0 + j; the target's choice for that
      # position is preds[i, q0 + j - 1].
      agree = 0
      while (agree < len(props)
             and props[agree] == preds[i, q0 + agree - 1]):
        agree += 1
      a = min(agree, len(props) - 1)
      emit = [int(x) for x in props[:a]] + [int(preds[i, q0 + a - 1])]
      emit = emit[:self._max_new(slot["req"]) - len(slot["tokens"])]
      accepted = float(min(a, len(emit)))
      round_draft += len(props)
      round_accepted += int(accepted)
      self._accept_lens.append(accepted)
      trace.add_sample("serving/accept_len", accepted)
      reg.observe("serving/accept_len", accepted)
      slot["tokens"].extend(emit)
      slot["history"] = np.concatenate([history,
                                        np.asarray(emit, np.int32)])
      slot["props"] = []
      new_pos[i] = slot["history"].size - 1
      new_tok[i] = emit[-1]
      if slot["t_first"] is None:
        slot["t_first"] = now
        slot["ttft"] = self._note_first_token(slot["req"], now)
      emitted_total += len(emit)
      if len(slot["tokens"]) >= self._max_new(slot["req"]):
        self._complete(i, now)
    self._draft_tokens += round_draft
    self._accepted_tokens += round_accepted
    reg.inc("serving/draft_tokens", round_draft)
    reg.inc("serving/accepted_tokens", round_accepted)
    ring.pos[:bucket].copy_(torch.from_numpy(new_pos))
    ring.tok[:bucket].copy_(torch.from_numpy(new_tok))
    self._tokens_out += emitted_total
    per_tok = (now - t0) / max(emitted_total, 1)
    self._token_lat.append(per_tok)
    trace.add_sample("serving/token_latency", per_tok)
    reg.observe("serving/token_latency_s", per_tok)

  def _complete(self, slot_idx: int, now: float) -> None:
    slot = self._slots[slot_idx]
    self._slots[slot_idx] = None
    if self._pps:
      # Return the slot's pages; its table row names the scratch page, so
      # the freed slot's (inactive) writes never reach a page a later
      # request owns.
      self._free_pages.extend(slot["pages"])
      self._table_np[slot_idx, :] = 0
    req = slot["req"]
    tenant = req.tenant
    self._completed += 1
    self._tenant_completed[tenant] = \
        self._tenant_completed.get(tenant, 0) + 1
    self._tenant_tokens[tenant] = \
        self._tenant_tokens.get(tenant, 0) + len(slot["tokens"])
    reg = metrics_lib.active()
    reg.inc("serving/completed")
    reg.inc("serving/completed", labels={"tenant": tenant})
    result = RequestResult(rid=req.rid, tenant=tenant, status="ok",
                           tokens=list(slot["tokens"]), ttft_s=slot["ttft"],
                           total_s=now - req.enqueue_t)
    # Per-tenant token latency: the request's own mean decode interval.
    if len(result.tokens) > 1 and result.ttft_s is not None:
      per_tok = (result.total_s - result.ttft_s) / (len(result.tokens) - 1)
      self._tenant_token_lat.setdefault(tenant, []).append(per_tok)
      reg.observe("serving/token_latency_s", per_tok,
                  labels={"tenant": tenant})
    self.slo.observe("shed_fraction", tenant, good=True)
    self._publish_slo(tenant)
    self._record(result)
    trace = tracing_lib.active()
    trace.add_span("serving", "request", trace.now() - result.total_s,
                   result.total_s,
                   {"rid": str(req.rid), "status": "ok",
                    "ttft_s": round(result.ttft_s, 6),
                    "tokens": len(result.tokens)})

  def _tick(self) -> None:
    self._ticks += 1
    self._queue_depth_sum += len(self._queue)
    metrics_lib.active().set("serving/queue_depth", len(self._queue))
    self._maybe_shrink()
    now = self._time()
    admit = bool(self._queue) and (
        self.cfg.batching == "continuous" or self._active_count() == 0)
    if admit:
      wave = self._coalesce(now)
      if wave:
        self._prefill_wave(wave)
    if self._active_count():
      if self.spec.speculative_k:
        self._speculative_round()
      else:
        self._decode_step()

  def drain(self) -> List[RequestResult]:
    """Serve until queue and slots are empty; every result so far in
    submission order."""
    self.state = "running"
    if self._t_serve0 is None:
      self._t_serve0 = self._time()
    while self._queue or self._active_count():
      self._tick()
    self._t_serve1 = self._time()
    self.state = "drained"
    self._publish()
    return self.results()

  def replay(self, workload: Sequence[Tuple[float, Request]]
             ) -> List[RequestResult]:
    """Replay (arrival_offset_s, request) pairs in wall time: requests
    become visible at their offsets, the loop decodes in between, idle gaps
    sleep until the next arrival."""
    self.state = "running"
    pending = collections.deque(sorted(workload, key=lambda pair: pair[0]))
    start = self._time()
    self._t_serve0 = start
    while pending or self._queue or self._active_count():
      now = self._time() - start
      while pending and pending[0][0] <= now:
        offset, req = pending.popleft()
        # The scheduled arrival is the enqueue time (no coordinated
        # omission behind an in-flight step).
        req.enqueue_t = start + offset
        self.submit(req)
      if not self._queue and not self._active_count() and pending:
        self._sleep(max(0.0, pending[0][0] - (self._time() - start)))
        continue
      self._tick()
    self._t_serve1 = self._time()
    self.state = "drained"
    self._publish()
    return self.results()

  def results(self) -> List[RequestResult]:
    return [self._results[rid] for rid in self._order]

  # -- reporting ---------------------------------------------------------------

  def healthz(self) -> Dict[str, Any]:
    """Engine liveness: "burning" while any SLO stream fires."""
    slo = self.slo.state()
    return {
        "status": slo["status"],
        "serving": {
            "state": self.state,
            "active": self._active_count(),
            "queue_depth": len(self._queue),
            "bucket": self._bucket,
            "completed": self._completed,
            "shed": self._shed,
            "decode_steps": self._decode_steps,
        },
        "slo": slo,
    }

  def _wall(self) -> Optional[float]:
    if self._t_serve0 is None or self._t_serve1 is None:
      return None
    return max(self._t_serve1 - self._t_serve0, 1e-9)

  def stats(self) -> Dict[str, Any]:
    """Flat registered-key stats of the run so far (the serving bench's
    JSON payload). The decode-cost variant keys (paged KV, speculative) are
    None when their variant is off, as the JAX engine reports them."""
    wall = self._wall()
    pct = tracing_lib.percentile
    out = {
        "serving/requests": self._arrivals,
        "serving/completed": self._completed,
        "serving/shed": self._shed,
        "serving/shed_fraction": (self._shed / self._arrivals
                                  if self._arrivals else 0.0),
        "serving/decode_steps": self._decode_steps,
        "serving/decode_bucket": self._bucket,
        "serving/batch_fill_fraction": (
            self._fill_sum / self._decode_steps
            if self._decode_steps else None),
        "serving/queue_depth": (self._queue_depth_sum / self._ticks
                                if self._ticks else None),
        "serving/tokens_per_sec": (self._tokens_out / wall
                                   if wall else None),
    }
    for q in (50, 90, 99):
      out[f"serving/ttft_p{q}"] = pct(self._ttfts, q)
    for q in (50, 90, 99):
      out[f"serving/token_latency_p{q}"] = pct(self._token_lat, q)
    paged, spec_k = bool(self._pps), bool(self.spec.speculative_k)
    out["serving/kv_pages_in_use"] = self._kv_pages_peak if paged else None
    out["serving/kv_page_fraction"] = (self._kv_fraction_peak if paged
                                       else None)
    out["serving/spec_rounds"] = self._spec_rounds if spec_k else None
    out["serving/draft_tokens"] = self._draft_tokens if spec_k else None
    out["serving/accepted_tokens"] = (self._accepted_tokens if spec_k
                                      else None)
    for q in (50, 90, 99):
      out[f"serving/accept_len_p{q}"] = (pct(self._accept_lens, q)
                                         if spec_k else None)
    out["serving/slo_alerts"] = float(len(self.slo.alerts))
    for objective, keys in self._SLO_BURN_KEYS.items():
      for key, window in zip(keys, ("fast", "slow")):
        # The aggregate burn is the worst tenant's.
        out[key] = self._agg_burn(objective, window)
    out["serving_tenants"] = self.tenant_stats()
    return out

  def _agg_burn(self, objective: str, window: str) -> Optional[float]:
    burns = [self.slo.burn(objective, t)[window]
             for t in self._tenants_seen()]
    burns = [b for b in burns if b is not None]
    return max(burns) if burns else None

  def _tenants_seen(self) -> List[str]:
    seen = set(self._tenant_arrivals)
    seen.update(t for (t, _r) in self._tenant_shed)
    return sorted(seen)

  def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
    """Per-tenant stats keyed on registered metric names."""
    pct = tracing_lib.percentile
    wall = self._wall()
    out: Dict[str, Dict[str, Any]] = {}
    for tenant in self._tenants_seen():
      ttfts = self._tenant_ttfts.get(tenant, [])
      lats = self._tenant_token_lat.get(tenant, [])
      sheds = {reason: n for (t, reason), n in
               sorted(self._tenant_shed.items()) if t == tenant}
      ttft_burn = self.slo.burn("ttft_deadline", tenant)
      shed_burn = self.slo.burn("shed_fraction", tenant)
      block = {
          "serving/requests": self._tenant_arrivals.get(tenant, 0),
          "serving/completed": self._tenant_completed.get(tenant, 0),
          "serving/shed": sheds or None,
          "serving/tokens_per_sec": (
              self._tenant_tokens.get(tenant, 0) / wall if wall else None),
      }
      for q in (50, 90, 99):
        block[f"serving/ttft_p{q}"] = pct(ttfts, q)
      for q in (50, 90, 99):
        block[f"serving/token_latency_p{q}"] = pct(lats, q)
      block.update({
          "serving/slo_ttft_burn_fast": ttft_burn["fast"],
          "serving/slo_ttft_burn_slow": ttft_burn["slow"],
          "serving/slo_shed_burn_fast": shed_burn["fast"],
          "serving/slo_shed_burn_slow": shed_burn["slow"],
      })
      out[tenant] = block
    return out

  def _publish(self) -> None:
    reg = metrics_lib.active()
    for key, value in metrics_lib.flatten_stats(self.stats()).items():
      base, labels = metrics_lib.parse_labeled_key(key)
      if metrics_lib.SCHEMA[base].kind in ("counter", "histogram"):
        continue  # published live
      reg.set(base, value, labels=labels or None)


# -- replayable workloads ------------------------------------------------------

def poisson_workload(n: int, rate_per_s: float, spec: decode_lib.LMSpec,
                     seed: int = 0, max_new_tokens: int = 16,
                     mean_prompt_fraction: float = 0.2,
                     tenants: Sequence[str] = ("default",)
                     ) -> List[Tuple[float, Request]]:
  """A seeded, replayable open-loop arrival trace: exponential
  inter-arrivals at ``rate_per_s``, lognormal prompt lengths capped so
  prompt + generation fit the ring, tenants round-robin. Same seed, same
  workload (the JAX package's, draw for draw)."""
  rng = np.random.default_rng(seed)
  cap = max(1, spec.max_len - max_new_tokens - 1)
  lengths = np.minimum(
      packing_lib.sample_document_lengths(
          rng, n, spec.max_len, mean_fraction=mean_prompt_fraction),
      cap)
  gaps = rng.exponential(1.0 / max(rate_per_s, 1e-9), size=n)
  t = np.cumsum(gaps)
  out = []
  for i in range(n):
    prompt = rng.integers(0, spec.vocab, size=int(lengths[i]),
                          dtype=np.int32)
    out.append((float(t[i]), Request(
        rid=i, prompt=prompt, max_new_tokens=max_new_tokens,
        tenant=tenants[i % len(tenants)])))
  return out
