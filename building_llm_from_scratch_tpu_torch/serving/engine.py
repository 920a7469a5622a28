"""Continuous-batching decode engine (port of the core of the JAX package's
``serving/engine.py``).

A fixed batch of ``n_slots`` KV-cache rows; requests are admitted into free
slots at tick boundaries and retired the moment they finish. One tick:

    admit queued requests into free slots
    -> one prefill chunk per mid-prefill slot (chunked policies)
    -> one decode step over ALL slots (B5, or B7 through the page table,
       one launch per layer) -> per-row finite guard -> accept / finish

With ``spec_k=k`` (speculative decoding, ``serving/spec.py``) the decode
step is replaced by a verify step: the drafter proposes k tokens per
decoding slot from the slot's own history (host numpy), one forward
(``verify_slots`` / ``paged_verify_slots``, plain attention: no kernel
takes k+1 queries) scores all k+1 positions, and each row commits 1..k+1
tokens by the exact accept rule (``generate.accept_draft_tokens``), the
same tokens the spec-off engine draws. Rows whose request opted out
(``SamplingParams.spec=False``) commit one. Each slot's cache row carries
k positions of headroom past ``max_len`` for the candidates.

The ``KVCachePolicy`` (``serving/kvcache.py``) picks the prefill tier and
the layout:
  - the default policy prefills each prompt in one bucketed pass
    (``prefill_into_slot``) into contiguous (n_slots, Hkv, Tmax, hd) rows;
  - ``prefill_chunk=C`` prefills in C-token chunks interleaved with decode
    ticks; a mid-prefill row rides the decode tick as an ignored row whose
    garbage append lands where its next chunk writes, and samples nothing;
  - ``prefix_cache`` stores each prompt's chunk-aligned prefix (capped at
    the pane width ``_bucket_len(warmup_prompt_cap)``) and serves later
    requests sharing it from the store: a pane copy into the slot, or with
    ``paged`` a refcounted page-table write (no copy at all);
  - ``paged`` maps each slot's positions onto pages of one shared pool
    through a host-owned page table. Admission reserves a request's
    worst-case page need and bounces the queue head (FCFS kept) while the
    pool cannot promise it; a request that can never fit fails with
    ``page_pool_too_small``;
  - ``kv_quant="int8"`` stores int8 codes with fp32 scale sidecars,
    quantized at every write; its ticks attend with plain
    ``decode_attention`` (B5 and B7 take no int8, as in the JAX package).

With an ``AdapterRegistry`` (``adapters=``, ``serving/adapters.py``) each
request may name a LoRA adapter: its pool row is resolved at admission and
carried per slot (-1 = base model), every prefill and chunk applies the
request's adapter, and every decode tick applies each slot's through the
kernel B6 (one launch per adapted projection and layer, base traffic
included). Prefix-store entries are namespaced by the adapter's install
tag, so no request hits panes computed under other weights.

With a tokenizer (``tokenizer=``), a prompt may be text, and each
request's output is decoded as it grows: only the tail not yet committed
is decoded, a tail that ends inside a multi-byte character waits for the
next token (up to ``_DETOK_HOLD_MAX`` tokens), and each committed piece
goes to ``req.text``, to ``on_token(req, tok, piece)`` and to
``req.stream()``. Without one, a tick does no text work at all.

Free slots ride the fixed-shape decode as ignored rows, as in the JAX
engine. Every row carries its own length, sampling parameters and random
stream, so a request's tokens are the same whether it runs alone, in any
slot, or beside any other traffic.

Host state (lengths, last tokens, sampling parameters, the page table)
lives in numpy. Each decode tick copies tokens, lengths and the page table
to the device in one transfer and reads back once: the sampled tokens
together with the finite flags. Only a final prefill chunk reads anything
back.

Operations (the JAX engine's resilience, ``serving/supervisor.py``):

  - deadlines: ``SamplingParams.deadline_s`` (or the engine's default);
    an expired request is shed when it reaches the queue head, without
    taking a slot (``expired``, HTTP 504), and ``submit`` refuses up front
    when the backlog already predicts a miss (``SLOShedError``, 429);
  - fault isolation: a prefill that raises, a raising callback or a
    NaN-poisoned slot fails that request alone; a slot failed for
    non-finite logits is zeroed before its rows (contiguous) or private
    pages (paged) are reused, so the next occupant never multiplies a
    masked zero by a stale NaN (the plain-torch ticks do);
  - the tick watchdog: a hung tick dumps a flight record and the loop
    restarts (generation-guarded: the abandoned thread commits nothing),
    failing the in-flight requests, keeping the queue and allocating a
    fresh cache, with no new kernel build;
  - ``cancel`` and ``drain`` (admission closed, in-flight and queued work
    finishes within the timeout, the rest ``preempted``);
  - telemetry: ``request_*`` events and one span row per request through
    ``obs/metrics.py``, latency histograms, the tick-phase breakdown every
    ``metrics_every`` decode ticks, the memory ledger, and the
    ``/metrics`` and ``/healthz`` payloads.

``n_ticks`` counts decode ticks, so a kernel's launches are layers x
``n_ticks`` (the JAX engine also counts ticks where every active row was
still prefilling).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.generate import (
    _bucket,
    accept_draft_tokens,
    sample_tokens_dynamic,
)
from building_llm_from_scratch_tpu_torch.models.lora import adapter_fingerprint
from building_llm_from_scratch_tpu_torch.obs.memory import MemoryLedger
from building_llm_from_scratch_tpu_torch.obs.metrics import (
    Histogram,
    RollingRatio,
    get_metrics,
    render_prometheus,
)
from building_llm_from_scratch_tpu_torch.obs.schema import TICK_PHASES
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    decode_slots,
    init_slot_cache,
    paged_decode_slots,
    paged_prefill_chunk_into_slot,
    paged_verify_slots,
    prefill_chunk_into_slot,
    prefill_into_slot,
    verify_slots,
)
from building_llm_from_scratch_tpu_torch.ops.decode_step import (
    check_kernel_shape,
    check_lora_kernel_shape,
    check_paged_kernel_shape,
)
from building_llm_from_scratch_tpu_torch.serving.adapters import (
    BASE_ADAPTER,
    AdapterRegistry,
)
from building_llm_from_scratch_tpu_torch.serving.kvcache import (
    KVCachePolicy,
    PagePool,
    PrefixStore,
    cache_nbytes,
    copy_prefix_into_slot,
    extract_prefix_panes,
)
from building_llm_from_scratch_tpu_torch.serving.queue import (
    EngineDrainingError,
    PromptTooLongError,
    QueueFullError,
    RequestQueue,
    SLOShedError,
)
from building_llm_from_scratch_tpu_torch.serving.request import (
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_EXPIRED,
    FINISH_LENGTH,
    FINISH_PREEMPTED,
    FINISH_REJECTED,
    FINISH_SHED,
    FINISHED,
    QUEUED,
    REJECTED,
    RUNNING,
    Request,
    SamplingParams,
    next_request_id,
    resolve_eos,
)
from building_llm_from_scratch_tpu_torch.serving.scheduler import Scheduler
from building_llm_from_scratch_tpu_torch.serving.spec import NgramDrafter
from building_llm_from_scratch_tpu_torch.serving.supervisor import (
    EngineSupervisor,
    FaultHooks,
)

logger = logging.getLogger(__name__)


class DecodeEngine:
    """The serving runtime: slot-batched KV cache and request lifecycle.

    Drive it by hand (``step()`` / ``run_until_idle()``) or with the
    background thread (``start()`` / ``shutdown()``). ``submit()`` is
    thread-safe either way. The engine runs on the model's device."""

    def __init__(self, model: Transformer, tokenizer=None, *, n_slots: int = 4,
                 max_len: Optional[int] = None, max_queue: int = 64,
                 max_top_k: int = 64, default_max_new_tokens: int = 128,
                 warmup_prompt_cap: int = 256,
                 kv_policy: Optional[KVCachePolicy] = None,
                 adapters: Optional[AdapterRegistry] = None,
                 spec_k: int = 0, drafter=None, metrics_every: int = 32,
                 default_deadline_s: Optional[float] = None,
                 tick_timeout_s: float = 0.0, max_restarts: int = 3,
                 restart_backoff_s: float = 0.5,
                 hooks: Optional[FaultHooks] = None):
        cfg = model.cfg
        self.cfg = cfg
        self.model = model
        self.device = model.device
        #: text in and out: str prompts are encoded with it and every
        #: request's output is decoded as it grows (None: token ids only)
        self.tokenizer = tokenizer
        self.kv_policy = kv_policy or KVCachePolicy()
        self.n_slots = int(n_slots)
        self.max_len = min(int(max_len or cfg.context_length),
                           cfg.context_length)
        self.max_prompt = self.max_len - 1
        #: speculative decoding: k drafted tokens per slot per tick, scored
        #: by one verify forward (0 = off, the plain decode tick)
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.spec_k >= self.max_len:
            raise ValueError(f"spec_k={self.spec_k} must be < the slot "
                             f"capacity {self.max_len}")
        self.drafter = (drafter or NgramDrafter()) if self.spec_k else None
        #: logical row length (the JAX ``_cache_len``): ``spec_k`` positions
        #: of headroom past max_len hold the verify's candidates, which a
        #: row at its last position would otherwise write over committed
        #: k/v (the append's start clamps to fit)
        self._cache_len = self.max_len + self.spec_k
        self._chunk = self.kv_policy.prefill_chunk
        self._paged = self.kv_policy.paged
        if self._chunk > self._cache_len:
            raise ValueError(f"prefill_chunk {self._chunk} exceeds the slot "
                             f"capacity {self._cache_len}")
        # the decode tick launches B5 (B7 when paged) only for a model-dtype
        # cache without speculation; int8 caches and the verify tick attend
        # with plain decode_attention, as in the JAX package
        decode_kernel = not (self.spec_k or self.kv_policy.quantized)
        if self.device.type == "cuda" and decode_kernel:
            # refuse a model or a slot length the kernel cannot take now,
            # not at the first tick
            if self._paged:
                check_paged_kernel_shape(cfg.head_dim, cfg.torch_dtype)
            else:
                check_kernel_shape(self._cache_len, cfg.head_dim,
                                   cfg.torch_dtype)
        #: the LoRA adapter registry (None: base model only); its pool is
        #: an argument of every prefill, chunk and decode call
        self.adapters = adapters
        if adapters is not None:
            if adapters.fingerprint != adapter_fingerprint(cfg):
                raise ValueError("the adapter registry serves another base "
                                 f"model ({adapters.cfg.name}) than {cfg.name}")
            pool_device = adapters.pool_args()[1].device
            if pool_device != self.device:
                raise ValueError(f"the adapter pool is on {pool_device}, "
                                 f"the engine on {self.device}")
            if self.device.type == "cuda" and not self.spec_k:
                # the decode tick's deltas go through B6; the verify tick
                # gathers them (B6 is single-token)
                check_lora_kernel_shape(adapters.max_rank, cfg.torch_dtype)
        self.max_top_k = min(int(max_top_k), cfg.vocab_size)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.warmup_prompt_cap = min(int(warmup_prompt_cap), self.max_len)
        #: decode ticks between cadence rows (0: none)
        self.metrics_every = int(metrics_every)
        self.default_deadline_s = default_deadline_s
        self.hooks = hooks or FaultHooks()
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.supervisor = (EngineSupervisor(self, tick_timeout_s,
                                            max_restarts=max_restarts,
                                            backoff_s=restart_backoff_s)
                           if tick_timeout_s > 0 else None)
        self.queue = RequestQueue(max_queue)
        self.scheduler = Scheduler(self.n_slots)

        S = self.n_slots
        self.page_pool: Optional[PagePool] = None
        self._page_table: Optional[np.ndarray] = None
        if self._paged:
            self._pages_per_slot = self.kv_policy.pages_per_slot(
                self._cache_len)
            self.page_pool = PagePool(
                self.kv_policy.total_pool_pages(S, self._cache_len),
                self.kv_policy.page_bytes(cfg))
            #: page of each slot's logical page, 0 = the trash page
            self._page_table = np.zeros((S, self._pages_per_slot),
                                        np.int32)       # guarded-by: _lock
            #: table columns each slot has mapped, and the admission
            #: reservation still owed to it (worst-case need - mapped)
            self._slot_cols = np.zeros((S,), np.int32)  # guarded-by: _lock
            self._pages_reserved = np.zeros((S,), np.int32)  # guarded-by: _lock
        #: contiguous prefix hits served by a pane copy (0 when paged)
        self.pane_copies = 0                            # guarded-by: _lock
        self.cache = init_slot_cache(cfg, S, self._cache_len, self.device,
                                     policy=self.kv_policy)  # guarded-by: _lock
        #: slot -> chunked-prefill progress; a slot here is admitted but
        #: not decoding yet
        self._prefill_state: dict = {}                  # guarded-by: _lock
        #: prefix pane width, the JAX engine's, so storable spans agree
        self._prefix_pane_len = self._bucket_len(max(self.warmup_prompt_cap, 1))
        self.prefix_store: Optional[PrefixStore] = None
        if self.kv_policy.prefix_cache:
            self.prefix_store = PrefixStore(
                adapter_fingerprint(cfg), chunk_tokens=self._chunk,
                budget_bytes=self.kv_policy.prefix_budget_bytes,
                pane_tokens=self._prefix_pane_len, page_pool=self.page_pool)

        # host-owned per-slot state; the device owns only the k/v cache
        self._lengths = np.zeros((S,), np.int32)        # guarded-by: _lock
        self._last_tokens = np.zeros((S,), np.int32)    # guarded-by: _lock
        self._n_gen = np.zeros((S,), np.int64)          # guarded-by: _lock
        self._seeds = np.zeros((S,), np.int64)          # guarded-by: _lock
        self._temps = np.zeros((S,), np.float32)        # guarded-by: _lock
        self._topks = np.zeros((S,), np.int32)          # guarded-by: _lock
        #: per-slot adapter pool row; -1 = base model (exact zero delta)
        self._adapter_ids = np.full((S,), -1, np.int32)  # guarded-by: _lock
        #: per-slot committed ids (prompt + generated), the drafter's
        #: haystack; kept only when speculation is on
        self._hist = (np.zeros((S, self.max_len), np.int32)
                      if self.spec_k else None)          # guarded-by: _lock
        self._hist_len = np.zeros((S,), np.int32)        # guarded-by: _lock
        #: adapter name ("base" for un-adapted traffic) -> {finished,
        #: failed, tokens}
        self._adapter_counts: dict = {}                 # guarded-by: _lock
        self._generator = torch.Generator(device=self.device)

        self._lock = threading.RLock()
        self._work = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # written by _fail_all / drain; their racy reads are the design:
        # submit repeats its decision after the queue's barrier
        self._dead: Optional[str] = None    # guarded-by: _lock [writes]
        self._draining = False              # guarded-by: _lock [writes]
        # bumped by every restart; a loop thread abandoned before the bump
        # sees it at its next commit point and returns committing nothing
        self._restart_lock = threading.Lock()
        self._generation = 0        # guarded-by: _restart_lock [writes]
        self.n_restarts = 0         # guarded-by: _restart_lock [writes]
        self.warmed_up = False
        if adapters is not None:
            # a load must not reuse a pool row an active slot decodes against
            adapters.set_in_use_probe(self._adapter_rows_in_use)
        #: KV bytes a token of a slot row holds (the telemetry's unit)
        self._kv_bytes_per_token = self.kv_policy.bytes_per_slot(
            cfg, self._cache_len)["bytes_per_token"]
        self._param_bytes = sum(t.numel() * t.element_size()
                                for t in model.flat_params().values())
        # kernel builds and loads before serving: a restart adds none
        self._kernel_base = self._kernel_count()
        #: the service-time EWMAs of SLO admission (finished requests)
        self._tpot_ewma: Optional[float] = None     # guarded-by: _lock
        self._tokens_ewma: Optional[float] = None   # guarded-by: _lock
        self.ttft_hist = Histogram()
        self.tpot_hist = Histogram()
        self.queue_wait_hist = Histogram()
        self.e2e_hist = Histogram()
        #: prefill + prefix-copy wall of each tick that did prefill work
        self.tick_prefill_hist = Histogram(bounds=(
            0.0002, 0.0005, 0.001, 0.002, 0.004, 0.008, 0.015, 0.03,
            0.06, 0.12, 0.2, 0.3, 0.45, 0.7, 1.0, 1.5, 2.2, 3.3, 5.0,
            7.5, 11.0, 17.0, 26.0, 40.0, 60.0))
        self.slo_window = RollingRatio(window_s=300.0)
        self._t_start_mono = time.monotonic()
        # the tick-phase wall (perf_counter only): this cadence window's
        # sums and the totals /metrics exports
        self._tick_acc = {ph: 0.0 for ph in TICK_PHASES}   # guarded-by: _lock
        self._tick_acc_total = 0.0                         # guarded-by: _lock
        self.tick_phase_totals = {ph: 0.0 for ph in TICK_PHASES}  # guarded-by: _lock
        self.tick_seconds_total = 0.0                      # guarded-by: _lock
        self._tick_pf0 = 0.0                               # guarded-by: _lock
        self._window_ticks = 0                             # guarded-by: _lock
        self._window_tokens = 0                            # guarded-by: _lock
        self._window_t0 = time.monotonic()                 # guarded-by: _lock
        self._win_t0_wall = time.time()                    # guarded-by: _lock
        self._window_prefill_chunks = 0                    # guarded-by: _lock
        self._window_spec_drafted = 0                      # guarded-by: _lock
        self._window_spec_accepted = 0                     # guarded-by: _lock

        self.n_ticks = 0                    # decode ticks   guarded-by: _lock
        self.tokens_generated = 0           # guarded-by: _lock
        self.decode_tokens = 0              # tokens sampled by decode ticks
        self.requests_finished = 0          # guarded-by: _lock
        self.requests_rejected = 0          # guarded-by: _lock
        self.requests_failed = 0            # guarded-by: _lock
        self.requests_shed = 0              # guarded-by: _lock
        self.requests_expired = 0           # guarded-by: _lock
        self.prefill_chunks = 0             # guarded-by: _lock
        self.prefill_seconds = 0.0          # guarded-by: _lock
        self.decode_seconds = 0.0           # guarded-by: _lock
        self.detok_seconds = 0.0            # guarded-by: _lock
        #: speculation: k drafted per opted-in decoding row and tick, and
        #: the drafts the accept rule took (before eos / budget truncation)
        self.spec_tokens_drafted = 0        # guarded-by: _lock
        self.spec_tokens_accepted = 0       # guarded-by: _lock
        self.memory_ledger = self._build_memory_ledger()

    def _bucket_len(self, n: int) -> int:
        return min(_bucket(n), self.max_len)

    # -- telemetry ----------------------------------------------------------

    @staticmethod
    def _ev(kind: str, **fields) -> None:
        get_metrics().event(kind, **fields)

    @staticmethod
    def _emit_span(req: Request) -> None:
        """The request's one ``span`` row, at its terminal transition."""
        get_metrics().log_span(**req.trace_row())

    @staticmethod
    def _kernel_count() -> int:
        from building_llm_from_scratch_tpu_torch.ops import _kernels

        return _kernels.STATS["builds"] + _kernels.STATS["loads"]

    @property
    def n_recompiles(self) -> int:
        """Kernel builds and library loads since the engine was warmed up
        (or made): the port's counterpart of the JAX engine's recompiles,
        0 through restarts."""
        return self._kernel_count() - self._kernel_base

    def _build_memory_ledger(self) -> MemoryLedger:
        """The device-memory components this engine owns, measured from the
        live tensors at each read (a restart's fresh cache or pool is
        followed), with their exact expected sizes."""
        ledger = MemoryLedger(emit=self._ev, source="engine",
                              device=self.device)
        ledger.register("model_params", lambda: self._param_bytes)
        bps = self.kv_policy.bytes_per_slot(self.cfg, self.max_len)
        n = self.n_slots
        if self._paged:
            ledger.register("page_pool", lambda: cache_nbytes(self.cache),
                            expected=lambda: (self.page_pool.n_pages
                                              * self.page_pool.page_bytes))
        else:
            parts = self._cache_component_bytes
            ledger.register("slot_kv", lambda: parts()["slot_kv"],
                            expected=lambda: bps["kv_bytes"] * n)
            if bps["scale_bytes"]:
                ledger.register("kv_scales", lambda: parts()["kv_scales"],
                                expected=lambda: bps["scale_bytes"] * n)
            if self.spec_k:
                full = self.kv_policy.bytes_per_slot(self.cfg, self._cache_len)
                ledger.register(
                    "spec_headroom", lambda: parts()["spec_headroom"],
                    expected=lambda: (full["total_bytes"]
                                      - bps["total_bytes"]) * n)
        if self.prefix_store is not None:
            store = self.prefix_store
            # paged entries reference pool pages: attribution only
            ledger.register("prefix_store", lambda: store.bytes_total,
                            device=not self._paged)
            ledger.register_labeled("prefix_store_bytes", "namespace",
                                    store.bytes_by_tag)
            ledger.register_probe("prefix_store", self._prefix_pinned_probe)
        if self.adapters is not None:
            ledger.register("adapter_pool", self.adapters.pool_nbytes)
            ledger.register_labeled("adapter_pool_bytes", "tenant",
                                    self.adapters.bytes_by_adapter)
        ledger.register_labeled("kv_live_bytes", "tenant",
                                self._kv_live_by_tenant)
        return ledger

    def _prefix_pinned_probe(self) -> Optional[dict]:
        """A prefix entry still pinned at a cadence is leaked (pins span one
        pane copy under the engine lock): a ``memory_drift`` of
        ``prefix_store``."""
        pinned, keys = self.prefix_store.pinned_bytes()
        if not pinned:
            return None
        return {"reason": "pinned_orphan", "pinned_bytes": pinned,
                "pinned_entries": keys[:8], "measured_bytes": pinned}

    # holds: _lock
    def _kv_live_by_tenant(self) -> dict:
        """Each occupied slot's KV bytes by tenant (adapter name, "base"):
        mapped pages when paged, committed length x bytes a token else."""
        out: dict = {}
        for slot, req in self.scheduler.active():
            nm = req.params.adapter or BASE_ADAPTER
            if self._paged:
                live = int(self._slot_cols[slot]) * self.page_pool.page_bytes
            else:
                live = int(self._lengths[slot]) * self._kv_bytes_per_token
            out[nm] = out.get(nm, 0) + live
        return out

    # holds: _lock
    def _tick_add(self, phase: str, dt: float) -> None:
        """Wall seconds into one tick phase (window and totals)."""
        self._tick_acc[phase] += dt
        self.tick_phase_totals[phase] += dt

    # holds: _lock
    def _prefill_total(self) -> float:
        return (self.tick_phase_totals["prefill"]
                + self.tick_phase_totals["prefill_shard"]
                + self.tick_phase_totals["prefix_copy"])

    # holds: _lock
    def _nested_acc(self) -> float:
        """Window seconds of the phases nested inside admission."""
        return (self._tick_acc["prefill"] + self._tick_acc["prefill_shard"]
                + self._tick_acc["prefix_copy"]
                + self._tick_acc["callback_detok"])

    # holds: _lock
    def _book_tick_wall(self, t0: float) -> None:
        """A tick's wall into the window and the totals, on every exit of
        ``step``'s timed part (generation aborts too, so the phases never
        sum past it), and its prefill wall into ``tick_prefill_hist``."""
        dt = time.perf_counter() - t0
        self._tick_acc_total += dt
        self.tick_seconds_total += dt
        pf = self._prefill_total() - self._tick_pf0
        if pf > 0:
            self.tick_prefill_hist.observe(pf)

    # -- adapters -----------------------------------------------------------

    def _adapter_rows_in_use(self) -> set:
        """Registry in-use probe: the pool rows active slots reference. The
        lock is taken with a timeout; on timeout every row counts as in use
        (an admission may have resolved a row it has not recorded yet), so
        a load during a stall waits or fails, never overwrites."""
        locked = self._lock.acquire(timeout=1.0)
        try:
            if not locked:
                return set(range(self.adapters.capacity))
            return {int(r) for r in self._adapter_ids if r >= 0}
        finally:
            if locked:
                self._lock.release()

    def _adapter_arg(self, ids: torch.Tensor) -> Optional[dict]:
        """The slot functions' ``adapter`` argument for pool rows ``ids``
        (on the device), or None without a registry."""
        if self.adapters is None:
            return None
        pool, scaling = self.adapters.pool_args()
        return {"pool": pool, "scaling": scaling, "ids": ids}

    def _adapter_tag(self, req: Request) -> Optional[str]:
        """Prefix-store namespace of one request: the adapter's install tag
        (name and install sequence), the shared base namespace for
        un-adapted traffic, or None when the adapter was evicted since
        admission, in which case the request neither hits nor stores."""
        if req.params.adapter is None or self.adapters is None:
            return BASE_ADAPTER
        return self.adapters.load_tag(req.params.adapter)

    # holds: _lock
    def _count_adapter(self, req: Request, outcome: str) -> None:
        """Per-adapter request accounting ("base" for un-adapted traffic)."""
        name = req.params.adapter or BASE_ADAPTER
        c = self._adapter_counts.setdefault(
            name, {"finished": 0, "failed": 0, "tokens": 0})
        c[outcome] += 1
        c["tokens"] += len(req.output_ids)

    # -- admission --------------------------------------------------------

    def encode_prompt(self, prompt: str | Sequence[int] | np.ndarray
                      ) -> np.ndarray:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("text prompt needs a tokenizer")
            prompt = self.tokenizer.encode(prompt)
        ids = np.asarray(prompt, np.int64).reshape(-1)
        if ids.size < 1:
            raise ValueError("empty prompt")
        if int(ids.min()) < 0 or int(ids.max()) >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size}); "
                f"got range [{int(ids.min())}, {int(ids.max())}]")
        return ids.astype(np.int32)

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               block: bool = False, timeout: Optional[float] = None,
               on_token=None) -> Request:
        """Enqueue one request, text or token ids (thread-safe), with an
        optional ``on_token(req, tok, piece)`` called at every generated
        token (``piece`` the text it committed, "" while held or without
        a tokenizer). ``block=False`` rejects with ``QueueFullError`` when
        the queue is full; ``block=True`` waits for space. Raises
        ``EngineDrainingError`` once ``drain()`` closed admission and
        ``SLOShedError`` when the backlog predicts a missed deadline."""
        if self._dead is not None:
            raise RuntimeError(f"engine is dead: {self._dead}")
        if self._draining:
            # the estimate reads the EWMAs under the lock; a timed acquire,
            # since a wedged tick may hold it (Retry-After is best effort)
            retry = None
            lock = self._lock
            locked = lock.acquire(timeout=0.5)
            try:
                if locked:
                    retry = self.estimate_queue_clear_s()
            finally:
                if locked:
                    lock.release()
            raise EngineDrainingError("engine is draining: admission closed",
                                      retry_after_s=retry)
        params = params or SamplingParams(
            max_new_tokens=self.default_max_new_tokens)
        if params.deadline_s is None and self.default_deadline_s:
            params = dataclasses.replace(params,
                                         deadline_s=self.default_deadline_s)
        if params.deadline_s is not None and params.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        ids = self.encode_prompt(prompt)
        if params.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if params.top_k is not None and not (
                1 <= params.top_k <= self.max_top_k):
            raise ValueError(f"top_k={params.top_k} outside this engine's "
                             f"capacity 1..{self.max_top_k} (raise max_top_k)")
        if params.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if params.adapter is not None:
            # an unknown adapter is refused here; admission resolves the
            # name again (an evict in between fails that request alone)
            if self.adapters is None:
                raise ValueError(
                    f"request names adapter '{params.adapter}' but this "
                    "engine has no adapter registry (--serve_adapters)")
            try:
                self.adapters.resolve(params.adapter)
            except KeyError as e:
                raise ValueError(e.args[0]) from None
        if int(ids.size) > self.max_prompt:
            raise PromptTooLongError(
                f"prompt ({ids.size} tokens) exceeds the engine's prompt "
                f"ceiling {self.max_prompt}", prompt_tokens=int(ids.size),
                limit=self.max_prompt)
        total = int(ids.size) + params.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens "
                f"({params.max_new_tokens}) = {total} exceeds the engine's "
                f"slot capacity {self.max_len}")
        # the Request exists before any shed or reject: every terminal
        # outcome carries a request id and closes a span tree
        req = Request(next_request_id(), ids, params, on_token=on_token)
        if params.deadline_s is not None:
            self._shed_if_unmeetable(req)
        try:
            self.queue.put(req, block=block, timeout=timeout)
        except QueueFullError:
            req.state = REJECTED
            req.finish_reason = FINISH_REJECTED
            req.t_finish = time.monotonic()
            with self._lock:
                self.requests_rejected += 1
            self._ev("request_rejected", request_id=req.id,
                     reason="queue_full", queue_depth=len(self.queue))
            self._emit_span(req)
            req._mark_done()
            raise
        if self._dead is not None or self._draining:
            # raced _fail_all / drain: a blocked put can be woken by their
            # queue sweep and land in an engine that will never serve it
            msg = self._dead or "engine is draining"
            if self.queue.remove(req):
                req.error = msg
                req.finish_reason = (FINISH_ERROR if self._dead
                                     else FINISH_PREEMPTED)
                req.state = FINISHED
                req._mark_done()
            elif self._draining and self._dead is None:
                # the loop admitted it first: the drain lets it finish
                with self._work:
                    self._work.notify()
                return req
            if self._dead is not None:
                raise RuntimeError(f"engine is dead: {self._dead}")
            raise EngineDrainingError("engine is draining: admission closed")
        with self._work:
            self._work.notify()
        return req

    def _shed_if_unmeetable(self, req: Request) -> None:
        """SLO admission: raise ``SLOShedError`` (and finish ``req`` as
        shed) when the estimated completion already exceeds its deadline.
        The decision reads the EWMAs under the lock, acquired with a
        timeout: past it (a wedged tick) the request is admitted
        optimistically and the queue's expiry still guards its deadline."""
        deadline = req.params.deadline_s
        shed, est, retry = False, None, None
        lock = self._lock
        locked = lock.acquire(timeout=1.0)
        try:
            if locked:
                est = self.estimate_completion_s(len(self.queue),
                                                 req.params.max_new_tokens)
                shed = est is not None and est > deadline
                if shed:
                    self.requests_shed += 1
                    retry = round(max(self.estimate_queue_clear_s() or 0.0,
                                      0.001), 3)
        finally:
            if locked:
                lock.release()
        if not shed:
            return
        self.slo_window.observe(miss=True)
        req.error = (f"shed at submit: estimated completion {est:.2f}s > "
                     f"deadline {deadline}s")
        req.finish_reason = FINISH_SHED
        req.state = REJECTED
        req.t_finish = time.monotonic()
        self._ev("request_shed", request_id=req.id,
                 reason="slo_predicted_miss", queue_depth=len(self.queue),
                 deadline_s=deadline, estimated_e2e_s=round(est, 4),
                 retry_after_s=retry)
        self._emit_span(req)
        req._mark_done()
        raise SLOShedError(f"deadline {deadline}s unmeetable: estimated "
                           f"completion {est:.2f}s at queue depth "
                           f"{len(self.queue)}", retry_after_s=retry)

    def service_snapshot(self) -> dict:
        """Load and liveness in one read (timed acquire: a wedged engine
        answers with stale but safe values)."""
        lock = self._lock
        locked = lock.acquire(timeout=0.2)
        try:
            return {"queue_depth": len(self.queue),
                    "queue_capacity": self.queue.max_size,
                    "n_active": self.scheduler.n_active,
                    "n_slots": self.n_slots, "tpot_ewma": self._tpot_ewma,
                    "tokens_ewma": self._tokens_ewma,
                    "draining": self._draining,
                    "dead": self._dead is not None}
        finally:
            if locked:
                lock.release()

    # -- the SLO service estimate -------------------------------------------

    # holds: _lock
    def estimate_completion_s(self, queue_depth: int,
                              max_new_tokens: int) -> Optional[float]:
        """Predicted submit-to-finish seconds at ``queue_depth``
        (``service_estimate``); None before any request finished."""
        return service_estimate(queue_depth, self.scheduler.n_active,
                                self.n_slots, self._tpot_ewma,
                                self._tokens_ewma, max_new_tokens)

    # holds: _lock
    def estimate_queue_clear_s(self) -> Optional[float]:
        """Rough seconds until the backlog drains (Retry-After)."""
        return queue_clear_estimate(len(self.queue), self.scheduler.n_active,
                                    self.n_slots, self._tpot_ewma,
                                    self._tokens_ewma)

    # holds: _lock
    def _observe_service_time(self, req: Request) -> None:
        """Fold a normally finished request into the TPOT and length EWMAs
        (alpha 0.2)."""
        tpot = req.tpot_s()
        n_tok = len(req.output_ids)
        if tpot is None or n_tok < 1:
            return
        alpha = 0.2
        self._tpot_ewma = (tpot if self._tpot_ewma is None
                           else (1 - alpha) * self._tpot_ewma + alpha * tpot)
        self._tokens_ewma = (float(n_tok) if self._tokens_ewma is None
                             else (1 - alpha) * self._tokens_ewma
                             + alpha * n_tok)

    # holds: _lock
    def _admission_skip(self, req: Request) -> bool:
        """The scheduler's skip hook: a cancelled or expired request at the
        queue head is finished there, without taking a slot."""
        if req._cancelled:
            self._fail_request(None, req, "cancelled while queued",
                               reason="cancelled", finish=FINISH_CANCELLED)
            return True
        if not req.expired():
            return False
        self.requests_expired += 1
        self.slo_window.observe(miss=True)
        waited = time.monotonic() - req.t_submit
        req.error = (f"deadline {req.params.deadline_s}s passed after "
                     f"{waited:.2f}s in queue")
        req.finish_reason = FINISH_EXPIRED
        req.state = FINISHED
        req.t_finish = time.monotonic()
        self._ev("request_expired", request_id=req.id,
                 reason="deadline_expired", deadline_s=req.params.deadline_s,
                 queue_wait_s=round(waited, 4), queue_depth=len(self.queue))
        self._emit_span(req)
        req._mark_done()
        return True

    # holds: _lock
    def _prime_slot(self, slot: int, req: Request, length: int,
                    adapter_row: int) -> None:
        req.state = RUNNING
        req.slot = slot
        req.t_admit = time.monotonic()
        p = req.params
        self._lengths[slot] = length
        self._adapter_ids[slot] = adapter_row
        self._n_gen[slot] = 0
        self._seeds[slot] = p.seed
        self._temps[slot] = p.temperature
        self._topks[slot] = p.top_k or 0
        if self._hist is not None:
            Tp = int(req.prompt_ids.size)
            self._hist[slot, :Tp] = req.prompt_ids
            self._hist_len[slot] = Tp

    # holds: _lock
    def _first_token(self, logits: torch.Tensor, req: Request) -> tuple:
        """Sample a request's first token from its prefill logits; one
        device->host read of (token, finite flag)."""
        p = req.params
        tok = sample_tokens_dynamic(
            logits[None], np.array([p.seed]), np.array([0]),
            np.array([p.temperature], np.float32),
            np.array([p.top_k or 0], np.int32), self.max_top_k,
            self._generator)
        ok = torch.isfinite(logits).all()
        tok_host, ok_host = torch.stack([tok[0], ok.long()]).tolist()
        return int(tok_host), bool(ok_host)

    # holds: _lock
    def _admit(self, slot: int, req: Request, gen: int, cache: dict) -> None:
        """Prefill one request into ``slot`` and take its first token, or
        with a chunked policy queue it for the chunk pump. Fault-isolated:
        a prefill that raises fails this request alone. The adapter is
        resolved by name again here: one evicted while the request was
        queued fails that request alone. ``gen`` and ``cache`` are the
        tick's (see ``step``): an abandoned thread that returns from the
        hook or the prefill commits nothing."""
        adapter_row = -1
        if req.params.adapter is not None:
            row = (self.adapters.lookup(req.params.adapter)
                   if self.adapters is not None else None)
            if row is None:
                self._fail_request(
                    slot, req, f"adapter_not_loaded: adapter "
                    f"'{req.params.adapter}' evicted while queued",
                    reason="adapter_not_loaded")
                return
            adapter_row = row
        try:
            self.hooks.before_prefill(req)
        except Exception as e:  # noqa: BLE001 — a poison request, isolate it
            if self._generation != gen:
                return          # the restart already failed this request
            self._fail_request(slot, req, f"prefill failed: {e!r}",
                               reason="prefill_error")
            return
        if self._generation != gen:
            return              # a hook that returned after a restart
        if self._chunk > 0:
            self._admit_chunked(slot, req, adapter_row, cache)
            return
        Tp = int(req.prompt_ids.size)
        Tpb = self._bucket_len(Tp)
        padded = np.zeros((Tpb,), np.int64)
        padded[:Tp] = req.prompt_ids
        t0 = time.perf_counter()
        tokens = self._to_device([padded])[None]
        adapter = (self._adapter_arg(torch.tensor(
            [adapter_row], dtype=torch.int32, device=self.device))
            if self.adapters is not None else None)
        logits = prefill_into_slot(self.model, tokens, Tp, slot, cache,
                                   adapter=adapter)
        tok, ok = self._first_token(logits, req)
        if self._generation != gen:
            return              # abandoned mid-prefill: commit nothing
        dt = time.perf_counter() - t0
        self.prefill_seconds += dt
        self._tick_add("prefill", dt)
        self._prime_slot(slot, req, Tp, adapter_row)
        poison = self.hooks.poison_nan(req)
        if self._generation != gen:
            return
        if poison:
            self._poison_slot_cache(slot, cache)    # fault injection
        if not ok:
            self._fail_non_finite(slot, req, "non-finite logits in prefill",
                                  cache)
            return
        self._accept_token(slot, req, tok, gen)

    # -- chunked prefill + prefix cache ------------------------------------

    # holds: _lock
    def _admit_chunked(self, slot: int, req: Request, adapter_row: int,
                       cache: dict) -> None:
        """Chunked admission: probe the prefix store, apply a hit (pane
        copy, or a page-table write when paged), and queue the rest of the
        prompt for ``_chunk_tick``. The row's length is its next write
        position while it prefills, so the decode tick's garbage append
        lands where the next chunk writes."""
        pos = 0
        tag = self._adapter_tag(req) if self.prefix_store is not None else None
        if tag is not None:
            span, entry = self.prefix_store.match(req.prompt_ids, tag)
            if entry is not None:
                self._apply_prefix_hit(slot, req, span, entry, cache)
                pos = span
        self._prime_slot(slot, req, pos, adapter_row)
        self._prefill_state[slot] = {"req": req, "pos": pos,
                                     "Tp": int(req.prompt_ids.size),
                                     "stored": False}

    # holds: _lock
    def _apply_prefix_hit(self, slot: int, req: Request, span: int, entry,
                          cache: dict, prev_pos: int = 0) -> None:
        """Serve the span of a matched (pinned) entry from the store;
        ``prev_pos`` is what the slot had prefilled already (a late hit)."""
        req.prefix_bytes_saved += (span - prev_pos) * self._kv_bytes_per_token
        if self._paged:
            self._apply_paged_hit(slot, entry)
            return
        t0 = time.perf_counter()
        try:
            copy_prefix_into_slot(cache, entry.panes, slot)
        finally:
            self.prefix_store.release(entry)
        self._tick_add("prefix_copy", time.perf_counter() - t0)
        self.pane_copies += 1

    # holds: _lock
    def _apply_paged_hit(self, slot: int, entry) -> None:
        """Paged prefix hit: point the slot's leading columns at the
        entry's shared pages. Incref first, then drop the slot's old
        columns (a late hit's entry may share pages with them), then refund
        the reservation for the columns the share now covers."""
        pages = entry.pages
        try:
            for p in pages:
                self.page_pool.incref(p)
        finally:
            self.prefix_store.release(entry)
        old_cols = int(self._slot_cols[slot])
        old = [int(p) for p in self._page_table[slot, :old_cols]]
        n_new = len(pages)          # == span // page_tokens, by insert
        self._page_table[slot, :n_new] = pages
        self._slot_cols[slot] = n_new
        for p in old:
            self.page_pool.decref(p)
        refund = min(n_new - old_cols, int(self._pages_reserved[slot]))
        if refund > 0:
            self.page_pool.unreserve(refund)
            self._pages_reserved[slot] -= refund

    # holds: _lock
    def _chunk_tick(self, gen: int, cache: dict) -> bool:
        """One prefill chunk for every mid-prefill slot, in slot order.
        False on a generation abort (the caller books the tick and
        returns)."""
        C = self._chunk
        for slot in sorted(self._prefill_state):
            if self._generation != gen:
                return False
            st = self._prefill_state[slot]
            req: Request = st["req"]
            Tp = st["Tp"]
            span_cap = (self.prefix_store.storable_span(Tp)
                        if self.prefix_store is not None else 0)
            # catch-up probe: a sharer's pane may have landed since this
            # slot missed at admission (early insertion below); only
            # admission misses count as misses
            tag = (self._adapter_tag(req)
                   if self.prefix_store is not None and st["pos"] < span_cap
                   else None)
            if tag is not None:
                span, entry = self.prefix_store.match(
                    req.prompt_ids, tag, min_span=st["pos"], count_miss=False)
                if entry is not None:
                    self._apply_prefix_hit(slot, req, span, entry, cache,
                                           prev_pos=st["pos"])
                    st["pos"] = span
                    self._lengths[slot] = span
            t0 = time.perf_counter()
            lo = st["pos"]
            hi = min(lo + C, Tp)
            if self._paged:
                # back the chunk's real columns with pages; the pad tail's
                # columns stay unmapped and scatter into the trash page
                self._ensure_pages(slot, hi)
            logits = self._run_chunk(slot, req, lo, hi, Tp, cache)
            if self._generation != gen:
                return False    # abandoned mid-chunk: commit nothing
            st["pos"] = lo + C
            self.prefill_chunks += 1
            self._window_prefill_chunks += 1
            # early insertion: the moment the chunk covering the storable
            # span lands, store it, so co-admitted sharers catch up now
            if (self.prefix_store is not None and not st["stored"]
                    and 0 < span_cap <= st["pos"]):
                st["stored"] = True
                self._maybe_store_prefix(slot, req, cache)
            if st["pos"] < Tp:
                self._lengths[slot] = st["pos"]
                dt = time.perf_counter() - t0
                self.prefill_seconds += dt
                self._tick_add("prefill", dt)
                continue
            # final chunk: the request's first token (the one chunk that
            # reads back)
            tok, ok = self._first_token(logits, req)
            if self._generation != gen:
                return False
            dt = time.perf_counter() - t0
            self.prefill_seconds += dt
            self._tick_add("prefill", dt)
            del self._prefill_state[slot]
            self._lengths[slot] = Tp
            poison = self.hooks.poison_nan(req)
            if self._generation != gen:
                return False
            if poison:
                self._poison_slot_cache(slot, cache)    # fault injection
            if not ok:
                self._fail_non_finite(slot, req,
                                      "non-finite logits in prefill", cache)
                continue
            self._accept_token(slot, req, tok, gen)
            if self._generation != gen:
                return False
        return True

    # holds: _lock
    def _run_chunk(self, slot: int, req: Request, lo: int, hi: int,
                   Tp: int, cache: dict) -> torch.Tensor:
        """Prefill prompt positions [lo, hi) as one C-token chunk; returns
        its logits. Paged: the chunk's tokens and the slot's table row go to
        the device in one copy."""
        C = self._chunk
        chunk = np.zeros((C,), np.int32)
        chunk[: hi - lo] = req.prompt_ids[lo:hi]
        parts = [chunk, self._adapter_ids[slot:slot + 1]]
        if self._paged:
            parts.append(self._page_table[slot])
        host = self._to_device(parts)
        tokens = host[:C].long()[None]
        adapter = self._adapter_arg(host[C:C + 1])
        if not self._paged:
            return prefill_chunk_into_slot(self.model, tokens, lo, Tp, slot,
                                           cache, adapter=adapter)
        return paged_prefill_chunk_into_slot(
            self.model, tokens, lo, Tp, host[None, C + 1:], cache,
            self._cache_len, adapter=adapter)

    # holds: _lock
    def _maybe_store_prefix(self, slot: int, req: Request,
                            cache: dict) -> None:
        """Store the slot's chunk-aligned prefix (miss path only; a stored
        key is just touched): the slot's own leading pages when paged (the
        store increfs them), else a zero-clamped pane copy."""
        span = self.prefix_store.storable_span(int(req.prompt_ids.size))
        if span <= 0:
            return
        tag = self._adapter_tag(req)
        if tag is None:
            return      # adapter evicted mid-flight: no namespace to own
        prefix_ids = req.prompt_ids[:span]
        if self.prefix_store.contains(prefix_ids, tag):
            return
        if self._paged:
            # span is chunk-aligned and C % P == 0: whole pages
            n_cols = span // self.kv_policy.page_tokens
            pages = [int(p) for p in self._page_table[slot, :n_cols]]
            self.prefix_store.insert_pages(prefix_ids, tag, pages)
            return
        panes = extract_prefix_panes(cache, slot, span,
                                     pane_len=self._prefix_pane_len)
        self.prefix_store.insert(prefix_ids, tag, panes)

    # -- paged page accounting (host bookkeeping) ---------------------------

    # holds: _lock
    def _page_need(self, req: Request) -> int:
        """Worst-case pages of one request: prompt plus max_new_tokens plus
        the spec headroom, capped at the slot's row."""
        toks = min(int(req.prompt_ids.size) + req.params.max_new_tokens
                   + self.spec_k, self._cache_len)
        return -(-toks // self.kv_policy.page_tokens)

    # holds: _lock
    def _admit_pages(self, slot: int, req: Request) -> Optional[bool]:
        """Paged admission gate: reserve the request's worst-case page need
        up front. False: the pool cannot promise it now (the caller
        bounces the request); None: it can never fit, and the request
        failed here."""
        if not self._paged:
            return True
        need = self._page_need(req)
        pool = self.page_pool
        if need > pool.n_pages - 1:
            self._fail_request(
                slot, req,
                f"page_pool_too_small: request needs up to {need} KV pages "
                f"but the pool holds {pool.n_pages - 1}: shorten the "
                "request or size pool_pages for at least one worst-case "
                "request", reason="page_pool_too_small")
            return None
        if pool.available() < need:
            return False
        pool.reserve(need)
        self._pages_reserved[slot] = need
        return True

    # holds: _lock
    def _ensure_pages(self, slot: int, n_tokens: int) -> None:
        """Map enough table columns for ``n_tokens`` tokens, drawing on the
        slot's admission reservation. Unmapped columns stay 0, the trash
        page."""
        P = self.kv_policy.page_tokens
        cols = int(self._slot_cols[slot])
        want = -(-min(n_tokens, self._cache_len) // P)
        want = min(want, self._pages_per_slot,
                   cols + int(self._pages_reserved[slot]))
        while cols < want:
            page = self.page_pool.alloc(from_reserved=True)
            self._pages_reserved[slot] -= 1
            self._page_table[slot, cols] = page
            cols += 1
        self._slot_cols[slot] = cols

    # holds: _lock
    def _release_slot_pages(self, slot: int) -> None:
        """Drop the slot's references (shared pages survive, private ones
        return to the pool) and hand back its unused reservation."""
        for col in range(int(self._slot_cols[slot])):
            self.page_pool.decref(int(self._page_table[slot, col]))
        reserved = int(self._pages_reserved[slot])
        if reserved:
            self.page_pool.unreserve(reserved)
        self._page_table[slot, :] = 0
        self._slot_cols[slot] = 0
        self._pages_reserved[slot] = 0

    # holds: _lock
    def _rewrite_slot_pages(self, slot: int, value: float,
                            cache: dict) -> None:
        """Overwrite the float leaves of the slot's PRIVATE pages (refcount
        1; shared pages belong to co-sharers too) in every layer: NaN is
        the fault-injection poison, zero the scrub of a non-finite failure
        (a freed page is read, masked, by whichever slot draws it next,
        and 0 x NaN is NaN). int8 codes hold no NaN: the poison and the
        scrub ride the scale sidecars."""
        mine = [int(p) for p in self._page_table[slot, :self._slot_cols[slot]]
                if int(p) != 0 and self.page_pool.refcount(int(p)) == 1]
        if not mine:
            return
        idx = torch.tensor(mine, device=self.device)
        for bufs in cache.values():
            for buf in bufs:
                if buf.is_floating_point():
                    buf[idx] = value

    # holds: _lock
    def _poison_slot_cache(self, slot: int, cache: dict) -> None:
        """NaN into one slot's KV (the ``poison_nan`` hook): its next decode
        tick's logits go non-finite on the device, through the same
        kernels, and no other row reads them. Contiguous: the slot's rows
        of every float leaf (the scales of an int8 cache); paged: the
        slot's private pages only (shared ones would fail co-sharers)."""
        if self._paged:
            self._rewrite_slot_pages(slot, float("nan"), cache)
            return
        for bufs in cache.values():
            for buf in bufs:
                if buf.is_floating_point():
                    buf[slot] = float("nan")

    # holds: _lock
    def _fail_non_finite(self, slot: int, req: Request, msg: str,
                         cache: dict) -> None:
        """Fail a request for non-finite logits, zeroing its slot first:
        its private pages (paged) or its rows (contiguous). B5 and B7 never
        read past a row's length, but the plain-torch ticks (the CPU, the
        verify and int8 ticks) weigh every masked position by an exact 0,
        and 0 x NaN is NaN: without the scrub a stale NaN tail would fail
        the slot's next occupant."""
        if self.scheduler.slots[slot] is req:
            if self._paged:
                self._rewrite_slot_pages(slot, 0.0, cache)
            else:
                for bufs in cache.values():
                    for buf in bufs:
                        buf[slot] = 0
        self._fail_request(slot, req, msg, reason="non_finite_logits")

    # -- the tick ---------------------------------------------------------

    # holds: _lock
    def _admit_queued(self, gen: int, cache: dict) -> bool:
        """Admit from the queue until no progress: a request may finish
        during its own admission (eos first, or max_new_tokens=1) and free
        a slot. Expired and cancelled heads are finished without a slot. A
        paged request the pool cannot promise goes back to the queue head
        with everything popped behind it, in order. False on a generation
        abort."""
        while True:
            admitted = self.scheduler.admit_from(self.queue,
                                                 skip=self._admission_skip)
            bounced = None
            for i, (slot, req) in enumerate(admitted):
                ok = self._admit_pages(slot, req)
                if ok is None:
                    continue            # failed for good, slot freed
                if not ok:
                    bounced = i
                    break
                self._admit(slot, req, gen, cache)
                if self._generation != gen:
                    return False
            if bounced is not None:
                for slot, req in reversed(admitted[bounced:]):
                    self.scheduler.retire(slot)
                    self.queue.put_front(req)
                return True
            if not admitted:
                return True

    def step(self) -> bool:
        """One tick: admit into free slots, retire cancelled requests, one
        prefill chunk per mid-prefill slot, then one decode step over the
        slot batch when a row is decoding. Returns False when idle (no
        active slot, nothing queued).

        Generation-guarded: ``_restart`` bumps ``_generation`` and replaces
        the lock, so a tick that returns after the supervisor abandoned it
        sees the bump at its next check and commits nothing. The tick takes
        the cache once, here, and every launch writes that one: a thread
        that wakes past its last check (a host-to-device copy waits for the
        device) writes only the cache the restart abandoned with it, never
        the new one the restarted loop fills."""
        gen = self._generation
        with self._lock:
            # the restart bumps the generation before it swaps the cache,
            # so a cache read before a passing check is this generation's
            cache = self.cache
            if self._generation != gen or self._dead is not None:
                return False
            t_tick0 = time.perf_counter()
            self._tick_pf0 = self._prefill_total()
            self.hooks.before_tick(self)       # injected hang / fault point
            if self._generation != gen:
                self._book_tick_wall(t_tick0)
                return False
            # ``admit`` is the admission remainder: the nested prefill,
            # prefix-copy and callback seconds book into their own phases
            nested0 = self._nested_acc()
            t_adm0 = time.perf_counter()
            if not self._admit_queued(gen, cache):
                self._book_tick_wall(t_tick0)
                return False
            # cancellations retire at the tick boundary: the slot frees now
            # instead of decoding to max_new_tokens for nobody
            for slot, req in self.scheduler.active():
                if req._cancelled:
                    self._fail_request(slot, req, "cancelled by client",
                                       reason="cancelled",
                                       finish=FINISH_CANCELLED)
            self._tick_add("admit", max(time.perf_counter() - t_adm0
                                        - (self._nested_acc() - nested0), 0.0))
            if self._prefill_state and not self._chunk_tick(gen, cache):
                self._book_tick_wall(t_tick0)
                return False
            active = self.scheduler.active()
            if not active:
                # a first-token eos in the chunk pump can free the last
                # slot with requests still queued
                self._book_tick_wall(t_tick0)
                return len(self.queue) > 0
            decoding = [(s, r) for s, r in active
                        if s not in self._prefill_state]
            if not decoding:
                self._book_tick_wall(t_tick0)
                return True
            if self.spec_k:
                return self._verify_tick(decoding, gen, t_tick0, cache)
            if self._paged:
                # the append lands at column lengths // P, which must map a
                # page (mid-prefill rows append into the trash page)
                for slot, _ in decoding:
                    self._ensure_pages(slot, int(self._lengths[slot]) + 1)
            t0 = time.perf_counter()
            logits = self._decode(cache)
            if self._generation == gen:
                # the tick's kernels are launched: count it with them
                self.n_ticks += 1
            nxt = sample_tokens_dynamic(logits, self._seeds, self._n_gen,
                                        self._temps, self._topks,
                                        self.max_top_k, self._generator)
            ok = torch.isfinite(logits).all(dim=-1)
            packed = torch.stack([nxt, ok.long()])
            self._tick_add("decode_dispatch", time.perf_counter() - t0)
            if self._generation != gen:
                self._book_tick_wall(t_tick0)
                return False
            # the tick's one device->host read: tokens and finite flags
            t_fetch = time.perf_counter()
            nxt_host, ok_host = packed.cpu().numpy()
            self._tick_add("host_fetch", time.perf_counter() - t_fetch)
            self.decode_seconds += time.perf_counter() - t0
            cb0 = self._tick_acc["callback_detok"]
            t_commit = time.perf_counter()
            for slot, req in decoding:
                # a slow client inside _accept_token is a wedge point the
                # supervisor may abandon: stop the moment it moves on
                if self._generation != gen:
                    self._book_tick_wall(t_tick0)
                    return False
                # this tick wrote the slot's previous token at _lengths
                self._lengths[slot] += 1
                if not ok_host[slot]:
                    self._fail_non_finite(
                        slot, req,
                        f"non-finite logits at token {len(req.output_ids)}",
                        cache)
                    continue
                self.decode_tokens += 1
                self._accept_token(slot, req, int(nxt_host[slot]), gen)
            self._tick_add("sample_commit", max(
                time.perf_counter() - t_commit
                - (self._tick_acc["callback_detok"] - cb0), 0.0))
            self._window_ticks += 1
            self._book_tick_wall(t_tick0)
            self._maybe_log_metrics()
            return True

    # holds: _lock
    def _to_device(self, parts: list) -> torch.Tensor:
        """The host arrays of one launch in one host-to-device copy. From
        pageable memory the copy waits for the stream's earlier work, so a
        busy device holds the tick here, past its last generation check."""
        return torch.from_numpy(np.concatenate(parts)).to(self.device)

    # holds: _lock
    def _decode(self, cache: dict) -> torch.Tensor:
        """One decode step over every slot; tokens, lengths, the adapter
        rows (and the page table) go to the device in one copy. Returns fp32
        logits (S, V)."""
        S = self.n_slots
        parts = [self._last_tokens, self._lengths, self._adapter_ids]
        if self._paged:
            parts.append(self._page_table.reshape(-1))
        host = self._to_device(parts)
        tokens, lengths = host[:S].long()[:, None], host[S:2 * S]
        adapter = self._adapter_arg(host[2 * S:3 * S])
        if not self._paged:
            return decode_slots(self.model, tokens, lengths, cache,
                                adapter=adapter)
        table = host[3 * S:].view(S, -1)
        return paged_decode_slots(self.model, tokens, lengths, table,
                                  cache, self._cache_len, adapter=adapter)

    # holds: _lock
    def _verify_tick(self, decoding: list, gen: int, t_tick0: float,
                     cache: dict) -> bool:
        """One speculative tick (the JAX ``_verify_tick``): k drafts per
        opted-in decoding slot from its own history, one verify forward
        over every slot, and each row's longest accepted run committed,
        1..k+1 tokens, cut at eos or the budget. Opted-out rows ride the
        same forward and commit one token. Mid-prefill and free rows ride as
        ignored rows, as in the decode tick. One device->host read: the
        tokens, accepted counts and finite flags together. False on a
        generation abort."""
        S, k = self.n_slots, self.spec_k
        t_draft = time.perf_counter()
        drafts = np.zeros((S, k), np.int32)
        for slot, req in decoding:
            if req.params.spec:
                drafts[slot] = self.drafter.propose(
                    self._hist[slot, :self._hist_len[slot]], k)
        self._tick_add("draft", time.perf_counter() - t_draft)
        if self._paged:
            # the candidates land at lengths .. lengths + k; the headroom
            # keeps those columns inside the slot's table
            for slot, _ in decoding:
                self._ensure_pages(slot, int(self._lengths[slot]) + 1 + k)
        t0 = time.perf_counter()
        tokens_in = np.concatenate([self._last_tokens[:, None], drafts], axis=1)
        parts = [tokens_in.reshape(-1), self._lengths, self._adapter_ids]
        if self._paged:
            parts.append(self._page_table.reshape(-1))
        host = self._to_device(parts)
        n = S * (k + 1)
        tokens = host[:n].long().view(S, k + 1)
        lengths = host[n:n + S]
        adapter = self._adapter_arg(host[n + S:n + 2 * S])
        if self._paged:
            table = host[n + 2 * S:].view(S, -1)
            logits = paged_verify_slots(self.model, tokens, lengths, table,
                                        cache, self._cache_len,
                                        adapter=adapter)
        else:
            logits = verify_slots(self.model, tokens, lengths, cache,
                                  adapter=adapter)
        if self._generation == gen:
            self.n_ticks += 1
        toks, n_acc, ok = accept_draft_tokens(
            logits, tokens[:, 1:], self._seeds, self._n_gen, self._temps,
            self._topks, self.max_top_k, self._generator)
        packed = torch.cat([toks.reshape(-1), n_acc, ok.long()])
        self._tick_add("decode_dispatch", time.perf_counter() - t0)
        if self._generation != gen:
            self._book_tick_wall(t_tick0)
            return False
        t_fetch = time.perf_counter()
        back = packed.cpu().numpy()
        self._tick_add("host_fetch", time.perf_counter() - t_fetch)
        toks_host = back[:n].reshape(S, k + 1)
        n_acc_host, ok_host = back[n:n + S], back[n + S:]
        self.decode_seconds += time.perf_counter() - t0
        cb0 = self._tick_acc["callback_detok"]
        t_commit = time.perf_counter()
        for slot, req in decoding:
            if self._generation != gen:
                self._book_tick_wall(t_tick0)
                return False
            if not ok_host[slot]:
                self._fail_non_finite(
                    slot, req,
                    f"non-finite logits at token {len(req.output_ids)}",
                    cache)
                continue
            n_commit = 1
            if req.params.spec:
                accepted = int(n_acc_host[slot])
                n_commit += accepted
                req.spec_drafted += k
                req.spec_accepted += accepted
                self.spec_tokens_drafted += k
                self.spec_tokens_accepted += accepted
                self._window_spec_drafted += k
                self._window_spec_accepted += accepted
            for j in range(n_commit):
                # each commit advances the row's valid prefix by one: this
                # tick appended position j's k/v; the rejected tail lies
                # past the prefix, masked and overwritten next tick
                self._lengths[slot] += 1
                self.decode_tokens += 1
                self._accept_token(slot, req, int(toks_host[slot, j]), gen)
                if self._generation != gen:
                    self._book_tick_wall(t_tick0)
                    return False
                if req.done:
                    break           # eos, budget or a failed callback
        self._tick_add("sample_commit", max(
            time.perf_counter() - t_commit
            - (self._tick_acc["callback_detok"] - cb0), 0.0))
        self._window_ticks += 1
        self._book_tick_wall(t_tick0)
        self._maybe_log_metrics()
        return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # holds: _lock
    def _accept_token(self, slot: int, req: Request, tok: int,
                      gen: int) -> None:
        eos = resolve_eos(req.params, self.cfg.eos_id)
        if eos is not None and tok == eos:
            # the eos token is dropped and the slot frees at this boundary
            self._finish(slot, req, FINISH_EOS)
            return
        if req.t_first_token is None:
            req.t_first_token = time.monotonic()
        req.output_ids.append(tok)
        self._last_tokens[slot] = tok
        self._n_gen[slot] = len(req.output_ids)
        if self._hist is not None:
            # a committed token joins the drafter's haystack (a dropped eos
            # never does)
            self._hist[slot, self._hist_len[slot]] = tok
            self._hist_len[slot] += 1
        self.tokens_generated += 1
        self._window_tokens += 1
        t0 = time.perf_counter()
        piece = ""
        try:
            # the request's own host path: a fault here (a raising
            # on_token, a tokenizer error on this output) fails it alone
            if self.tokenizer is not None or req.on_token is not None:
                piece = self._detok_piece(req)
                if req.on_token is not None:
                    req.on_token(req, tok, piece)
            self.hooks.after_token(req, tok)   # injected slow-client point
        except Exception as e:  # noqa: BLE001 — the client's fault, isolate it
            self._book_callback(req, t0)
            if self._generation != gen:
                return          # the restart already failed this request
            self._fail_request(slot, req, f"token callback failed: {e!r}",
                               reason="callback_error")
            return
        self._book_callback(req, t0)
        if self._generation != gen:
            # the callback is a wedge point: a thread returning from it
            # after a restart must not finish or free slots it lost
            return
        if piece:
            req._push_piece(piece)
        if len(req.output_ids) >= req.params.max_new_tokens:
            self._finish(slot, req, FINISH_LENGTH)

    # holds: _lock
    def _book_callback(self, req: Request, t0: float) -> None:
        dt = time.perf_counter() - t0
        self._tick_add("callback_detok", dt)
        if self.tokenizer is not None or req.on_token is not None:
            self.detok_seconds += dt

    #: tokens a partial multi-byte character may hold detokenization back
    #: before it commits anyway (bounds the tail decoded again per token)
    _DETOK_HOLD_MAX = 16

    def _detok_piece(self, req: Request, final: bool = False) -> str:
        """Incremental detokenization: decode only the tail not yet in
        ``req.text``. A tail ending in U+FFFD is a multi-byte character the
        next token may complete: it is held ("") for up to
        ``_DETOK_HOLD_MAX`` tokens; ``final`` flushes it regardless."""
        if self.tokenizer is None:
            return ""
        tail_ids = req.output_ids[req._detok_start:]
        if not tail_ids:
            return ""
        try:
            tail = self.tokenizer.decode([int(t) for t in tail_ids])
        except KeyError:                # ids the tokenizer lacks: no text
            return ""
        if (not final and tail.endswith("\ufffd")
                and len(tail_ids) < self._DETOK_HOLD_MAX):
            return ""
        req.text += tail
        req._detok_start = len(req.output_ids)
        return tail

    # holds: _lock
    def _free_slot(self, slot: int) -> None:
        if self._paged:
            self._release_slot_pages(slot)
        self.scheduler.retire(slot)
        self._prefill_state.pop(slot, None)     # mid-prefill retirement
        self._lengths[slot] = 0
        self._last_tokens[slot] = 0
        self._n_gen[slot] = 0
        self._seeds[slot] = 0
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._adapter_ids[slot] = -1
        self._hist_len[slot] = 0

    # holds: _lock
    def _fail_request(self, slot: Optional[int], req: Request, msg: str,
                      reason: str, finish: str = FINISH_ERROR) -> None:
        """Fail ONE request and free its slot; the engine keeps serving.
        ``reason`` is the machine-readable cause of the ``request_failed``
        event (``_fail_non_finite`` scrubs the slot first)."""
        if slot is not None and self.scheduler.slots[slot] is req:
            self._free_slot(slot)
        req.error = msg
        req.finish_reason = finish
        req.state = FINISHED
        req.t_finish = time.monotonic()
        self.requests_failed += 1
        self._count_adapter(req, "failed")
        if req.params.deadline_s is not None and finish != FINISH_CANCELLED:
            # a failure misses the SLO; a client's cancel does not count
            self.slo_window.observe(miss=True)
        self._ev("request_failed", request_id=req.id, reason=reason,
                 error=msg, slot=slot, n_tokens=len(req.output_ids),
                 adapter=req.params.adapter)
        self._emit_span(req)
        logger.warning("Request %d failed (%s): %s", req.id, reason, msg)
        req._mark_done()
        with self._work:
            self._work.notify_all()

    # holds: _lock
    def _finish(self, slot: int, req: Request, reason: str) -> None:
        if self.tokenizer is not None:
            tail = self._detok_piece(req, final=True)  # flush held bytes
            if tail:
                req._push_piece(tail)
        req.state = FINISHED
        req.finish_reason = reason
        req.t_finish = time.monotonic()
        if self.scheduler.slots[slot] is req:
            # the final committed length is the request's peak
            req.kv_bytes_peak = (int(self._lengths[slot])
                                 * self._kv_bytes_per_token)
            self._free_slot(slot)
        self.requests_finished += 1
        self._count_adapter(req, "finished")
        self._observe_service_time(req)
        for hist, val in ((self.ttft_hist, req.ttft_s()),
                          (self.tpot_hist, req.tpot_s()),
                          (self.queue_wait_hist, req.queue_wait_s()),
                          (self.e2e_hist, req.e2e_s())):
            if val is not None:
                hist.observe(val)
        if req.params.deadline_s is not None:
            # a completion past its deadline is a miss too
            self.slo_window.observe(
                miss=(req.e2e_s() or 0.0) > req.params.deadline_s)
        sink = get_metrics()
        self._ev("request_done", **req.summary())
        self._emit_span(req)
        sink.gauge("slot_occupancy", self.scheduler.occupancy())
        sink.gauge("queue_depth", len(self.queue))
        req._mark_done()
        with self._work:
            self._work.notify_all()

    # holds: _lock
    def _maybe_log_metrics(self) -> None:
        """Every ``metrics_every`` decode ticks: one ``metrics`` row (the
        window's decode rate and tick-phase breakdown, the gauges) and the
        memory ledger's snapshot. Host arithmetic only."""
        if self.metrics_every <= 0 or self.n_ticks % self.metrics_every:
            return
        now, now_wall = time.monotonic(), time.time()
        dt = max(now - self._window_t0, 1e-9)
        sink = get_metrics()
        sink.gauge("slot_occupancy", self.scheduler.occupancy())
        sink.gauge("queue_depth", len(self.queue))
        sink.gauge("draining", 1.0 if self._draining else 0.0)
        slo = self.slo_window.ratio()
        if slo is not None:
            sink.gauge("slo_miss_ratio", round(slo, 6))
        phases = {f"tick_{ph}_s": round(self._tick_acc[ph], 6)
                  for ph in TICK_PHASES}
        kv = {}
        if self._chunk > 0:
            kv["prefill_chunks"] = self._window_prefill_chunks
        if self.spec_k:
            kv["spec_drafted"] = self._window_spec_drafted
            kv["spec_accepted"] = self._window_spec_accepted
        sink.log_metrics(self.n_ticks,
                         serve_tok_s=round(self._window_tokens / dt, 2),
                         requests_finished=self.requests_finished,
                         tokens_generated=self.tokens_generated,
                         ticks_in_window=self._window_ticks,
                         win_t0=round(self._win_t0_wall, 6),
                         win_dur_s=round(now_wall - self._win_t0_wall, 6),
                         tick_total_s=round(self._tick_acc_total, 6),
                         **phases, **kv)
        self._window_tokens = 0
        self._window_t0 = now
        self._window_ticks = 0
        self._win_t0_wall = now_wall
        self._window_prefill_chunks = 0
        self._window_spec_drafted = 0
        self._window_spec_accepted = 0
        self._tick_acc = {ph: 0.0 for ph in TICK_PHASES}
        self._tick_acc_total = 0.0
        self.memory_ledger.observe(self.n_ticks)

    # -- warm-up and the background loop ------------------------------------

    def warmup(self) -> None:
        """Load (building if needed) the kernel library before serving, so
        the first request pays no nvcc, and re-base ``n_recompiles``: from
        here a build or load counts as one. Emits ``serve_warmup``."""
        t0 = time.monotonic()
        if self.device.type == "cuda":
            from building_llm_from_scratch_tpu_torch.ops._kernels import (
                load_library,
            )

            load_library()
        with self._lock:
            self._kernel_base = self._kernel_count()
            self._window_t0 = time.monotonic()
            self._win_t0_wall = time.time()
            self._window_tokens = 0
            self.warmed_up = True
        kv_fields = self.kv_policy.describe()
        if self._paged:
            kv_fields["pool_pages"] = self.page_pool.n_pages - 1
        spec = ({"spec_k": self.spec_k, "drafter": self.drafter.describe()}
                if self.spec_k else {})
        self._ev("serve_warmup", seconds=round(time.monotonic() - t0, 3),
                 n_slots=self.n_slots, max_len=self.max_len,
                 kv_bytes_per_slot=self.kv_policy.bytes_per_slot(
                     self.cfg, self._cache_len)["total_bytes"],
                 **kv_fields, **spec)

    def start(self) -> None:
        """Run ticks on one background thread until ``shutdown()`` (with
        the supervisor's watchdog when ``tick_timeout_s`` > 0)."""
        if self._thread is not None:
            return
        self._stop.clear()
        if self.supervisor is not None:
            self.supervisor.start()
        self._spawn_loop()

    #: an external per-tick heartbeat (``--stall_timeout``'s flight
    #: recorder without the supervisor)
    _heartbeat = None

    def set_heartbeat(self, fn) -> None:
        self._heartbeat = fn

    def _spawn_loop(self) -> None:
        """Start one loop thread bound to the current generation; a thread
        a restart superseded returns at its next check."""
        gen = self._generation

        def loop():
            while not self._stop.is_set() and self._generation == gen:
                if self.supervisor is not None:
                    self.supervisor.notify_tick()
                if self._heartbeat is not None:
                    self._heartbeat()
                try:
                    progressed = self.step()
                except Exception as e:  # noqa: BLE001 — never die silently
                    if self._generation != gen:
                        return          # superseded: not ours to handle
                    logger.exception("decode-engine loop died")
                    # a batch-wide fault: with a supervisor and budget left
                    # fail the in-flight batch and come back up
                    if self.supervisor is None or not self._restart(
                            reason="loop_error",
                            detail=f"engine loop error: {e!r}"):
                        self._fail_all(f"engine loop error: {e!r}")
                    return
                if not progressed:
                    with self._work:
                        self._work.wait(timeout=0.05)

        self._thread = threading.Thread(target=loop, name="decode-engine",
                                        daemon=True)
        self._thread.start()

    def _restart(self, reason: str, detail: str = "") -> bool:
        """The supervisor's recovery: abandon the (possibly wedged) loop
        thread, fail the in-flight requests, keep the queue, allocate a
        fresh cache (and, paged, a fresh pool with an emptied prefix
        store) under fresh sync primitives, and start a new loop after an
        exponential backoff. The loaded kernel library is kept: no build.
        False once the budget is spent (the caller escalates to
        ``_fail_all``)."""
        with self._restart_lock:
            if self._dead is not None or self._stop.is_set():
                return False
            if self.n_restarts >= self.max_restarts:
                return False
            self.n_restarts += 1
            n_restart = self.n_restarts
            # bump first: the wedged thread checks it at every commit point
            self._generation += 1
            # the abandoned thread may hold the old lock forever
            self._lock = threading.RLock()
            self._work = threading.Condition()
            failed_ids = []
            with self._lock:
                for slot, req in self.scheduler.active():
                    self._fail_request(
                        slot, req, f"engine restarted ({reason}): {detail}",
                        reason="engine_restart")
                    failed_ids.append(req.id)
                for a in (self._lengths, self._last_tokens, self._n_gen,
                          self._seeds, self._temps, self._topks,
                          self._hist_len):
                    a[:] = 0
                self._adapter_ids[:] = -1
                self._prefill_state.clear()
                # the old cache may be half-written; the new one has the
                # same shapes, so every kernel takes it as it took the old
                self.cache = init_slot_cache(self.cfg, self.n_slots,
                                             self._cache_len, self.device,
                                             policy=self.kv_policy)
                if self._paged:
                    # stored entries reference the old pool's pages
                    if self.prefix_store is not None:
                        self.prefix_store.clear()
                    self.page_pool = PagePool(
                        self.kv_policy.total_pool_pages(self.n_slots,
                                                        self._cache_len),
                        self.kv_policy.page_bytes(self.cfg))
                    if self.prefix_store is not None:
                        self.prefix_store.page_pool = self.page_pool
                    self._page_table[:] = 0
                    self._slot_cols[:] = 0
                    self._pages_reserved[:] = 0
            backoff = self.restart_backoff_s * (2.0 ** (n_restart - 1))
            self._ev("engine_restart", reason=reason, detail=detail,
                     n_restart=n_restart, max_restarts=self.max_restarts,
                     backoff_s=round(backoff, 3),
                     n_inflight_failed=len(failed_ids),
                     failed_request_ids=failed_ids,
                     queue_depth=len(self.queue))
            logger.error("Engine restart %d/%d (%s): failed %d in-flight "
                         "request(s), kept %d queued; backoff %.2fs.",
                         n_restart, self.max_restarts, reason,
                         len(failed_ids), len(self.queue), backoff)
            time.sleep(backoff)
            if self._thread is not None:
                self._spawn_loop()
        return True

    def _fail_all(self, msg: str) -> None:
        """Fail every in-flight and queued request and mark the engine dead
        (later ``submit`` calls raise). A timed acquire: the supervisor's
        escalation runs while a wedged tick holds the lock; on timeout the
        wedged loop is retired by a generation bump and fresh primitives."""
        lock = self._lock
        locked = lock.acquire(timeout=5.0)
        try:
            if not locked:
                with self._restart_lock:
                    self._generation += 1
                    self._lock = threading.RLock()
                    self._work = threading.Condition()
            self._dead = msg
            failed_ids = []

            def kill(req, slot=None):
                req.error = msg
                req.finish_reason = FINISH_ERROR
                req.state = FINISHED
                req.t_finish = time.monotonic()
                self.requests_failed += 1
                self._ev("request_failed", request_id=req.id,
                         reason="engine_dead", error=msg, slot=slot,
                         n_tokens=len(req.output_ids))
                self._emit_span(req)
                req._mark_done()
                failed_ids.append(req.id)

            for slot, req in self.scheduler.active():
                self.scheduler.retire(slot)
                kill(req, slot)
            while (req := self.queue.get_nowait()) is not None:
                kill(req)
            self._ev("serve_error", error=msg, n_failed=len(failed_ids),
                     failed_request_ids=failed_ids)
        finally:
            if locked:
                lock.release()
        with self._work:
            self._work.notify_all()

    # -- cancel and graceful drain ------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def cancel(self, req: Request) -> bool:
        """The client gave up on ``req``: a queued request fails now, a
        running one is retired at the next tick boundary. False when it is
        already done. The queued path takes the lock with a timeout: on
        timeout (a wedged tick) the request, already out of the queue, is
        failed without it."""
        if req.done:
            return False
        req._cancelled = True
        if req.state == QUEUED and self.queue.remove(req):
            lock = self._lock
            locked = lock.acquire(timeout=2.0)
            try:
                self._fail_request(None, req, "cancelled while queued",
                                   reason="cancelled", finish=FINISH_CANCELLED)
            finally:
                if locked:
                    lock.release()
        with self._work:
            self._work.notify()
        return True

    def drain(self, timeout: float = 30.0) -> dict:
        """Graceful drain: close admission (``submit`` raises
        ``EngineDrainingError``), let in-flight and queued work finish
        within ``timeout`` seconds, then fail the rest ``preempted``.
        Idempotent, from any thread. The sweep's lock is taken with a
        timeout: a wedged tick is retired by a generation bump instead of
        hanging the drain. Returns the ``drain`` end event's fields."""
        t0 = time.monotonic()
        already = self._draining
        self._draining = True           # a bool store: wedge-safe
        if not already:
            self._ev("drain", phase="start", timeout_s=timeout,
                     n_active=self.scheduler.n_active,
                     queue_depth=len(self.queue))
            logger.warning("Draining: admission closed; finishing %d "
                           "in-flight + %d queued request(s) within %.1fs.",
                           self.scheduler.n_active, len(self.queue), timeout)
        deadline = t0 + timeout
        if self._thread is not None:
            while (time.monotonic() < deadline
                   and (self.scheduler.n_active or len(self.queue))
                   and self._thread.is_alive() and self._dead is None):
                time.sleep(0.01)
        else:
            while time.monotonic() < deadline and self.step():
                pass
        preempted = 0
        lock = self._lock
        lock_wait = min(5.0, max(0.1, timeout))
        locked = lock.acquire(timeout=lock_wait)
        try:
            if not locked:
                logger.error("Drain: decode tick wedged (lock held > %.1fs); "
                             "abandoning it.", lock_wait)
                with self._restart_lock:
                    self._generation += 1
                    self._lock = threading.RLock()
                    self._work = threading.Condition()
            msg = f"preempted: drain timeout {timeout}s elapsed"
            for slot, req in self.scheduler.active():
                self._fail_request(slot, req, msg, reason="preempted",
                                   finish=FINISH_PREEMPTED)
                preempted += 1
            while (req := self.queue.get_nowait()) is not None:
                self._fail_request(None, req, msg, reason="preempted",
                                   finish=FINISH_PREEMPTED)
                preempted += 1
        finally:
            if locked:
                lock.release()
        summary = {"phase": "end", "n_preempted": preempted,
                   "seconds": round(time.monotonic() - t0, 3),
                   "requests_finished": self.requests_finished}
        self._ev("drain", **summary)
        logger.warning("Drain complete in %.2fs (%d preempted).",
                       summary["seconds"], preempted)
        return summary

    def shutdown(self, drain: bool = True) -> None:
        """Stop the loop (and the supervisor); with ``drain`` finish
        everything queued first. Emits ``serve_summary``."""
        if self._thread is not None:
            if drain:
                while ((self.scheduler.n_active or len(self.queue))
                       and self._thread.is_alive() and self._dead is None):
                    time.sleep(0.005)
            self._stop.set()
            with self._work:
                self._work.notify_all()
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("the engine loop did not stop within 30s")
            self._thread = None
        elif drain:
            self.run_until_idle()
        if self.supervisor is not None:
            self.supervisor.stop()
        self._ev("serve_summary", **self.stats())

    # holds: _lock
    def _cache_component_bytes(self) -> dict:
        """Device bytes of the live cache (the JAX engine's ledger parts):
        contiguous rows split into ``slot_kv`` (k/v data of the first
        max_len positions), ``kv_scales`` (their int8 scale sidecars) and
        ``spec_headroom`` (the spec_k positions past max_len, every leaf);
        a paged pool is one ``page_pool`` part. The parts sum to the
        cache's bytes exactly (each leaf's bytes divide by its time
        extent)."""
        if self._paged:
            return {"page_pool": cache_nbytes(self.cache)}
        kv = cache_nbytes({k: self.cache[k] for k in ("k", "v")})
        scales = cache_nbytes({k: v for k, v in self.cache.items()
                               if k.endswith("_scale")})
        slot_kv = kv * self.max_len // self._cache_len
        kv_scales = scales * self.max_len // self._cache_len
        return {"slot_kv": slot_kv, "kv_scales": kv_scales,
                "spec_headroom": kv + scales - slot_kv - kv_scales}

    def stats(self) -> dict:
        with self._lock:
            out = {
                "requests_finished": self.requests_finished,
                "requests_rejected": self.requests_rejected,
                "requests_failed": self.requests_failed,
                "requests_shed": self.requests_shed,
                "requests_expired": self.requests_expired,
                "tokens_generated": self.tokens_generated,
                "decode_tokens": self.decode_tokens,
                "n_ticks": self.n_ticks,
                "n_recompiles": self.n_recompiles,
                "n_restarts": self.n_restarts,
                "draining": self._draining,
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "kv_policy": self.kv_policy.describe(),
                "kv_bytes": self._cache_component_bytes(),
                "memory": self.memory_ledger.describe(),
            }
            if self.spec_k:
                out["spec_k"] = self.spec_k
                out["drafter"] = self.drafter.describe()
                out["spec_tokens_drafted"] = self.spec_tokens_drafted
                out["spec_tokens_accepted"] = self.spec_tokens_accepted
                if self.spec_tokens_drafted:
                    out["spec_acceptance_ratio"] = round(
                        self.spec_tokens_accepted / self.spec_tokens_drafted, 6)
            if self.tokenizer is not None:
                out["detok_seconds"] = self.detok_seconds
            if self._adapter_counts:
                out["per_adapter"] = {nm: dict(c) for nm, c in
                                      sorted(self._adapter_counts.items())}
            if self.adapters is not None:
                out["adapters_loaded"] = self.adapters.n_loaded
            if self._chunk > 0:
                out["prefill_chunks"] = self.prefill_chunks
                out["pane_copies"] = self.pane_copies
            if self._paged:
                out["page_pool"] = self.page_pool.stats()
            if self.prefix_store is not None:
                out["prefix_store"] = self.prefix_store.stats()
            slo = self.slo_window.ratio()
            if slo is not None:
                out["slo_miss_ratio"] = round(slo, 6)
        for name, hist in (("ttft_s", self.ttft_hist),
                           ("tpot_s", self.tpot_hist),
                           ("queue_wait_s", self.queue_wait_hist),
                           ("e2e_s", self.e2e_hist)):
            pct = hist.percentiles((50, 95, 99))
            if pct:
                out[name] = pct
        return out

    def uptime_s(self) -> float:
        return time.monotonic() - self._t_start_mono

    def queue_capacity(self) -> int:
        """The bounded queue's capacity (the 429 payload's field)."""
        return self.queue.max_size

    def metrics_snapshot(self) -> tuple:
        """(counters, gauges, histograms) of ``/metrics`` and ``/healthz``
        (the JAX engine's keys). A timed acquire: a wedged tick holding the
        lock must not hang the scrape (the reads are then stale but
        safe)."""
        lock = self._lock
        locked = lock.acquire(timeout=0.5)
        try:
            counters = {
                "requests_finished": self.requests_finished,
                "requests_failed": self.requests_failed,
                "requests_rejected": self.requests_rejected,
                "requests_shed": self.requests_shed,
                "requests_expired": self.requests_expired,
                "tokens_generated": self.tokens_generated,
                "engine_restarts": self.n_restarts,
                "engine_ticks": self.n_ticks,
                "recompiles": self.n_recompiles,
                "tick_busy_seconds": round(self.tick_seconds_total, 6),
            }
            for ph in TICK_PHASES:
                counters[f"tick_{ph}_seconds"] = round(
                    self.tick_phase_totals[ph], 6)
            store = self.prefix_store
            if store is not None:
                counters["prefix_hits"] = store.n_hits
                counters["prefix_misses"] = store.n_misses
                counters["prefix_evictions"] = store.n_evictions
                counters["prefix_inserts"] = store.n_inserts
            if self.spec_k:
                counters["spec_tokens_drafted"] = self.spec_tokens_drafted
                counters["spec_tokens_accepted"] = self.spec_tokens_accepted
            adapter_active: dict = {}
            for _slot, r in self.scheduler.active():
                nm = r.params.adapter or BASE_ADAPTER
                adapter_active[nm] = adapter_active.get(nm, 0) + 1
            for nm, c in sorted(self._adapter_counts.items()):
                lbl = f'{{adapter="{nm}"}}'
                counters[f"adapter_requests_finished{lbl}"] = c["finished"]
                counters[f"adapter_requests_failed{lbl}"] = c["failed"]
                counters[f"adapter_tokens_generated{lbl}"] = c["tokens"]
            gauges = {
                "slot_occupancy": self.scheduler.occupancy(),
                "slots_active": self.scheduler.n_active,
                "slots_total": self.n_slots,
                "queue_depth": len(self.queue),
                "queue_capacity": self.queue.max_size,
                "draining": 1.0 if self._draining else 0.0,
                "engine_up": 0.0 if self._dead is not None else 1.0,
                "uptime_seconds": round(self.uptime_s(), 3),
            }
            for nm, n_act in sorted(adapter_active.items()):
                gauges[f'adapter_slots_active{{adapter="{nm}"}}'] = n_act
            if self.adapters is not None:
                gauges["adapters_loaded"] = self.adapters.n_loaded
                gauges["adapter_capacity"] = self.adapters.capacity
            gauges["kv_bytes_per_slot"] = self.kv_policy.bytes_per_slot(
                self.cfg, self._cache_len)["total_bytes"]
            if self._paged:
                ps = self.page_pool.stats()
                gauges["kv_pages_total"] = ps["n_pages"]
                gauges["kv_pages_used"] = ps["used"]
                gauges["kv_pages_free"] = ps["free"]
                gauges["kv_pages_reserved"] = ps["reserved"]
                gauges["kv_pages_peak_used"] = ps["peak_used"]
                gauges["kv_page_bytes"] = ps["page_bytes"]
            if self.spec_k:
                gauges["spec_k"] = self.spec_k
                gauges["spec_acceptance_ratio"] = round(
                    self.spec_tokens_accepted
                    / max(self.spec_tokens_drafted, 1), 6)
            if store is not None:
                looked = store.n_hits + store.n_misses
                gauges["prefix_hit_ratio"] = (
                    round(store.n_hits / looked, 6) if looked else 0.0)
                gauges["prefix_entries"] = store.n_entries
                gauges["prefix_bytes"] = store.bytes_total
            self.memory_ledger.snapshot()
            gauges.update(self.memory_ledger.gauges())
            slo = self.slo_window.ratio()
            gauges["slo_miss_ratio"] = round(slo, 6) if slo is not None else 0.0
            hists = {"ttft_seconds": self.ttft_hist,
                     "tpot_seconds": self.tpot_hist,
                     "queue_wait_seconds": self.queue_wait_hist,
                     "e2e_seconds": self.e2e_hist,
                     "tick_prefill_seconds": self.tick_prefill_hist}
        finally:
            if locked:
                lock.release()
        return counters, gauges, hists

    def prometheus_text(self) -> str:
        """The ``GET /metrics`` body (Prometheus text exposition 0.0.4)."""
        counters, gauges, hists = self.metrics_snapshot()
        return render_prometheus(counters, gauges, hists, prefix="bllm_serve_")

    def healthz_payload(self) -> dict:
        """The ``GET /healthz`` body: serving, draining or dead, and a
        structured snapshot."""
        if self._dead is not None:
            status = "dead"
        elif self._draining:
            status = "draining"
        else:
            status = "serving"
        counters, gauges, _ = self.metrics_snapshot()
        return {
            "status": status,
            "slots": self.n_slots,
            "active": self.scheduler.n_active,
            "queue_depth": len(self.queue),
            "queue_capacity": self.queue.max_size,
            "warmed_up": self.warmed_up,
            "draining": self._draining,
            "restarts": self.n_restarts,
            "uptime_s": round(self.uptime_s(), 3),
            "n_ticks": counters["engine_ticks"],
            "occupancy": self.scheduler.occupancy(),
            "slo_miss_ratio": gauges.get("slo_miss_ratio"),
            "counters": counters,
        }


def service_estimate(queue_depth: int, n_active: int, n_slots: int,
                     tpot_ewma: Optional[float], tokens_ewma: Optional[float],
                     max_new_tokens: int) -> Optional[float]:
    """The SLO completion estimate (the JAX formula): the backlog (queue
    position plus the running requests, counted half done) spread over the
    slots times the EWMA service time of a request, plus the request's own
    budget at the EWMA TPOT. None without service history (admission stays
    optimistic)."""
    if tpot_ewma is None or tokens_ewma is None:
        return None
    per_request = tokens_ewma * tpot_ewma
    backlog = queue_depth + 0.5 * n_active
    wait = (backlog / max(n_slots, 1)) * per_request
    return wait + max_new_tokens * tpot_ewma


def queue_clear_estimate(queue_depth: int, n_active: int, n_slots: int,
                         tpot_ewma: Optional[float],
                         tokens_ewma: Optional[float]) -> Optional[float]:
    """Rough seconds until a backlog drains (the Retry-After value)."""
    if tpot_ewma is None or tokens_ewma is None:
        return None
    per_request = tokens_ewma * tpot_ewma
    backlog = queue_depth + n_active
    return round((backlog / max(n_slots, 1)) * per_request, 3)
