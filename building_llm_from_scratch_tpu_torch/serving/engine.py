"""Continuous-batching decode engine (port of the core of the JAX package's
``serving/engine.py``).

A fixed batch of ``n_slots`` KV-cache rows; requests are admitted into free
slots at tick boundaries and retired the moment they finish. One tick:

    admit queued requests into free slots
    -> one prefill chunk per mid-prefill slot (chunked policies)
    -> one decode step over ALL slots (B5, or B7 through the page table,
       one launch per layer) -> per-row finite guard -> accept / finish

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
    ``page_pool_too_small``.

With an ``AdapterRegistry`` (``adapters=``, ``serving/adapters.py``) each
request may name a LoRA adapter: its pool row is resolved at admission and
carried per slot (-1 = base model), every prefill and chunk applies the
request's adapter, and every decode tick applies each slot's through the
kernel B6 (one launch per adapted projection and layer, base traffic
included). Prefix-store entries are namespaced by the adapter's install
tag, so no request hits panes computed under other weights.

Free slots ride the fixed-shape decode as ignored rows, as in the JAX
engine. Every row carries its own length, sampling parameters and random
stream, so a request's tokens are the same whether it runs alone, in any
slot, or beside any other traffic.

Host state (lengths, last tokens, sampling parameters, the page table)
lives in numpy. Each decode tick copies tokens, lengths and the page table
to the device in one transfer and reads back once: the sampled tokens
together with the finite flags. Only a final prefill chunk reads anything
back.

Not ported yet: int8 KV, speculative decoding, deadlines, drain,
the supervisor and restarts, fault-injection hooks and the telemetry sink.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.generate import (
    _bucket,
    sample_tokens_dynamic,
)
from building_llm_from_scratch_tpu_torch.models.lora import adapter_fingerprint
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    decode_slots,
    init_slot_cache,
    paged_decode_slots,
    paged_prefill_chunk_into_slot,
    prefill_chunk_into_slot,
    prefill_into_slot,
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
    copy_prefix_into_slot,
    extract_prefix_panes,
)
from building_llm_from_scratch_tpu_torch.serving.queue import (
    PromptTooLongError,
    QueueFullError,
    RequestQueue,
)
from building_llm_from_scratch_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_REJECTED,
    FINISHED,
    REJECTED,
    RUNNING,
    Request,
    SamplingParams,
    next_request_id,
    resolve_eos,
)
from building_llm_from_scratch_tpu_torch.serving.scheduler import Scheduler


class DecodeEngine:
    """The serving runtime: slot-batched KV cache and request lifecycle.

    Drive it by hand (``step()`` / ``run_until_idle()``) or with the
    background thread (``start()`` / ``shutdown()``). ``submit()`` is
    thread-safe either way. The engine runs on the model's device."""

    def __init__(self, model: Transformer, *, n_slots: int = 4,
                 max_len: Optional[int] = None, max_queue: int = 64,
                 max_top_k: int = 64, default_max_new_tokens: int = 128,
                 warmup_prompt_cap: int = 256,
                 kv_policy: Optional[KVCachePolicy] = None,
                 adapters: Optional[AdapterRegistry] = None):
        cfg = model.cfg
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.kv_policy = kv_policy or KVCachePolicy()
        self.n_slots = int(n_slots)
        self.max_len = min(int(max_len or cfg.context_length),
                           cfg.context_length)
        self.max_prompt = self.max_len - 1
        #: logical row length (the JAX ``_cache_len``; no spec headroom)
        self._cache_len = self.max_len
        self._chunk = self.kv_policy.prefill_chunk
        self._paged = self.kv_policy.paged
        if self._chunk > self._cache_len:
            raise ValueError(f"prefill_chunk {self._chunk} exceeds the slot "
                             f"capacity {self._cache_len}")
        if self.device.type == "cuda":
            # every decode tick launches a kernel: refuse a model or a slot
            # length it cannot take now, not at the first tick
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
            if self.device.type == "cuda":
                check_lora_kernel_shape(adapters.max_rank, cfg.torch_dtype)
        self.max_top_k = min(int(max_top_k), cfg.vocab_size)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.warmup_prompt_cap = min(int(warmup_prompt_cap), self.max_len)
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
        #: adapter name ("base" for un-adapted traffic) -> {finished,
        #: failed, tokens}
        self._adapter_counts: dict = {}                 # guarded-by: _lock
        self._generator = torch.Generator(device=self.device)

        self._lock = threading.RLock()
        self._work = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[str] = None
        if adapters is not None:
            # a load must not reuse a pool row an active slot decodes against
            adapters.set_in_use_probe(self._adapter_rows_in_use)

        self.n_ticks = 0                    # decode ticks   guarded-by: _lock
        self.tokens_generated = 0           # guarded-by: _lock
        self.decode_tokens = 0              # tokens sampled by decode ticks
        self.requests_finished = 0          # guarded-by: _lock
        self.requests_rejected = 0          # guarded-by: _lock
        self.requests_failed = 0            # guarded-by: _lock
        self.prefill_chunks = 0             # guarded-by: _lock
        self.prefill_seconds = 0.0          # guarded-by: _lock
        self.decode_seconds = 0.0           # guarded-by: _lock

    def _bucket_len(self, n: int) -> int:
        return min(_bucket(n), self.max_len)

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

    def encode_prompt(self, prompt: Sequence[int] | np.ndarray) -> np.ndarray:
        if isinstance(prompt, str):
            raise ValueError("text prompts need a tokenizer, which this port "
                             "does not have yet: send token ids")
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
        """Enqueue one request of token ids (thread-safe). ``block=False``
        rejects with ``QueueFullError`` when the queue is full;
        ``block=True`` waits for space."""
        if self._error is not None:
            raise RuntimeError(f"engine is dead: {self._error}")
        params = params or SamplingParams(
            max_new_tokens=self.default_max_new_tokens)
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
        req = Request(next_request_id(), ids, params, on_token=on_token)
        try:
            self.queue.put(req, block=block, timeout=timeout)
        except QueueFullError:
            req.state = REJECTED
            req.finish_reason = FINISH_REJECTED
            req.t_finish = time.monotonic()
            with self._lock:
                self.requests_rejected += 1
            req._mark_done()
            raise
        with self._work:
            self._work.notify()
        return req

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
    def _admit(self, slot: int, req: Request) -> None:
        """Prefill one request into ``slot`` and take its first token, or
        with a chunked policy queue it for the chunk pump. The request's
        adapter is resolved by name again here: one evicted while the
        request was queued fails that request alone."""
        adapter_row = -1
        if req.params.adapter is not None:
            row = (self.adapters.lookup(req.params.adapter)
                   if self.adapters is not None else None)
            if row is None:
                self._fail_request(
                    slot, req, f"adapter_not_loaded: adapter "
                    f"'{req.params.adapter}' evicted while queued")
                return
            adapter_row = row
        if self._chunk > 0:
            self._admit_chunked(slot, req, adapter_row)
            return
        Tp = int(req.prompt_ids.size)
        Tpb = self._bucket_len(Tp)
        padded = np.zeros((1, Tpb), np.int64)
        padded[0, :Tp] = req.prompt_ids
        t0 = time.perf_counter()
        tokens = torch.from_numpy(padded).to(self.device)
        adapter = (self._adapter_arg(torch.tensor(
            [adapter_row], dtype=torch.int32, device=self.device))
            if self.adapters is not None else None)
        logits = prefill_into_slot(self.model, tokens, Tp, slot, self.cache,
                                   adapter=adapter)
        tok, ok = self._first_token(logits, req)
        self.prefill_seconds += time.perf_counter() - t0
        self._prime_slot(slot, req, Tp, adapter_row)
        if not ok:
            self._fail_request(slot, req, "non-finite logits in prefill")
            return
        self._accept_token(slot, req, tok)

    # -- chunked prefill + prefix cache ------------------------------------

    # holds: _lock
    def _admit_chunked(self, slot: int, req: Request, adapter_row: int) -> None:
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
                self._apply_prefix_hit(slot, span, entry)
                pos = span
        self._prime_slot(slot, req, pos, adapter_row)
        self._prefill_state[slot] = {"req": req, "pos": pos,
                                     "Tp": int(req.prompt_ids.size),
                                     "stored": False}

    # holds: _lock
    def _apply_prefix_hit(self, slot: int, span: int, entry) -> None:
        """Serve the span of a matched (pinned) entry from the store."""
        if self._paged:
            self._apply_paged_hit(slot, entry)
            return
        try:
            copy_prefix_into_slot(self.cache, entry.panes, slot)
        finally:
            self.prefix_store.release(entry)
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
    def _chunk_tick(self) -> None:
        """One prefill chunk for every mid-prefill slot, in slot order."""
        C = self._chunk
        for slot in sorted(self._prefill_state):
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
                    self._apply_prefix_hit(slot, span, entry)
                    st["pos"] = span
                    self._lengths[slot] = span
            t0 = time.perf_counter()
            lo = st["pos"]
            hi = min(lo + C, Tp)
            if self._paged:
                # back the chunk's real columns with pages; the pad tail's
                # columns stay unmapped and scatter into the trash page
                self._ensure_pages(slot, hi)
            logits = self._run_chunk(slot, req, lo, hi, Tp)
            st["pos"] = lo + C
            self.prefill_chunks += 1
            # early insertion: the moment the chunk covering the storable
            # span lands, store it, so co-admitted sharers catch up now
            if (self.prefix_store is not None and not st["stored"]
                    and 0 < span_cap <= st["pos"]):
                st["stored"] = True
                self._maybe_store_prefix(slot, req)
            if st["pos"] < Tp:
                self._lengths[slot] = st["pos"]
                self.prefill_seconds += time.perf_counter() - t0
                continue
            # final chunk: the request's first token (the one chunk that
            # reads back)
            tok, ok = self._first_token(logits, req)
            self.prefill_seconds += time.perf_counter() - t0
            del self._prefill_state[slot]
            self._lengths[slot] = Tp
            if not ok:
                self._fail_request(slot, req, "non-finite logits in prefill",
                                   non_finite=True)
                continue
            self._accept_token(slot, req, tok)

    # holds: _lock
    def _run_chunk(self, slot: int, req: Request, lo: int, hi: int,
                   Tp: int) -> torch.Tensor:
        """Prefill prompt positions [lo, hi) as one C-token chunk; returns
        its logits. Paged: the chunk's tokens and the slot's table row go to
        the device in one copy."""
        C = self._chunk
        chunk = np.zeros((C,), np.int32)
        chunk[: hi - lo] = req.prompt_ids[lo:hi]
        parts = [chunk, self._adapter_ids[slot:slot + 1]]
        if self._paged:
            parts.append(self._page_table[slot])
        host = torch.from_numpy(np.concatenate(parts)).to(self.device)
        tokens = host[:C].long()[None]
        adapter = self._adapter_arg(host[C:C + 1])
        if not self._paged:
            return prefill_chunk_into_slot(self.model, tokens, lo, Tp, slot,
                                           self.cache, adapter=adapter)
        return paged_prefill_chunk_into_slot(
            self.model, tokens, lo, Tp, host[None, C + 1:], self.cache,
            self._cache_len, adapter=adapter)

    # holds: _lock
    def _maybe_store_prefix(self, slot: int, req: Request) -> None:
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
        panes = extract_prefix_panes(self.cache, slot, span,
                                     pane_len=self._prefix_pane_len)
        self.prefix_store.insert(prefix_ids, tag, panes)

    # -- paged page accounting (host bookkeeping) ---------------------------

    # holds: _lock
    def _page_need(self, req: Request) -> int:
        """Worst-case pages of one request: prompt plus max_new_tokens,
        capped at the slot's row."""
        toks = min(int(req.prompt_ids.size) + req.params.max_new_tokens,
                   self._cache_len)
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
                "request")
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
    def _rewrite_slot_pages(self, slot: int, value: float) -> None:
        """Overwrite the slot's PRIVATE pages (refcount 1) with ``value`` in
        every layer. Zero is the scrub of a non-finite failure: a freed
        page is read (masked) by whichever slot draws it next, and
        0 x NaN is NaN."""
        mine = [int(p) for p in self._page_table[slot, :self._slot_cols[slot]]
                if int(p) != 0 and self.page_pool.refcount(int(p)) == 1]
        if not mine:
            return
        idx = torch.tensor(mine, device=self.device)
        for bufs in self.cache.values():
            for buf in bufs:
                buf[idx] = value

    # -- the tick ---------------------------------------------------------

    # holds: _lock
    def _admit_queued(self) -> None:
        """Admit from the queue until no progress: a request may finish
        during its own admission (eos first, or max_new_tokens=1) and free
        a slot. A paged request the pool cannot promise goes back to the
        queue head with everything popped behind it, in order."""
        while True:
            admitted = self.scheduler.admit_from(self.queue)
            bounced = None
            for i, (slot, req) in enumerate(admitted):
                ok = self._admit_pages(slot, req)
                if ok is None:
                    continue            # failed for good, slot freed
                if not ok:
                    bounced = i
                    break
                self._admit(slot, req)
            if bounced is not None:
                for slot, req in reversed(admitted[bounced:]):
                    self.scheduler.retire(slot)
                    self.queue.put_front(req)
                return
            if not admitted:
                return

    def step(self) -> bool:
        """One tick: admit into free slots, one prefill chunk per
        mid-prefill slot, then one decode step over the slot batch when a
        row is decoding. Returns False when idle (no active slot, nothing
        queued)."""
        with self._lock:
            self._admit_queued()
            if self._prefill_state:
                self._chunk_tick()
            active = self.scheduler.active()
            if not active:
                # a first-token eos in the chunk pump can free the last
                # slot with requests still queued
                return len(self.queue) > 0
            decoding = [(s, r) for s, r in active
                        if s not in self._prefill_state]
            if not decoding:
                return True
            if self._paged:
                # the append lands at column lengths // P, which must map a
                # page (mid-prefill rows append into the trash page)
                for slot, _ in decoding:
                    self._ensure_pages(slot, int(self._lengths[slot]) + 1)
            t0 = time.perf_counter()
            logits = self._decode()
            nxt = sample_tokens_dynamic(logits, self._seeds, self._n_gen,
                                        self._temps, self._topks,
                                        self.max_top_k, self._generator)
            ok = torch.isfinite(logits).all(dim=-1)
            # the tick's one device->host read: tokens and finite flags
            nxt_host, ok_host = torch.stack([nxt, ok.long()]).cpu().numpy()
            self.decode_seconds += time.perf_counter() - t0
            self.n_ticks += 1
            for slot, req in decoding:
                # this tick wrote the slot's previous token at _lengths
                self._lengths[slot] += 1
                if not ok_host[slot]:
                    self._fail_request(
                        slot, req,
                        f"non-finite logits at token {len(req.output_ids)}",
                        non_finite=True)
                    continue
                self.decode_tokens += 1
                self._accept_token(slot, req, int(nxt_host[slot]))
            return True

    # holds: _lock
    def _decode(self) -> torch.Tensor:
        """One decode step over every slot; tokens, lengths, the adapter
        rows (and the page table) go to the device in one copy. Returns fp32
        logits (S, V)."""
        S = self.n_slots
        parts = [self._last_tokens, self._lengths, self._adapter_ids]
        if self._paged:
            parts.append(self._page_table.reshape(-1))
        host = torch.from_numpy(np.concatenate(parts)).to(self.device)
        tokens, lengths = host[:S].long()[:, None], host[S:2 * S]
        adapter = self._adapter_arg(host[2 * S:3 * S])
        if not self._paged:
            return decode_slots(self.model, tokens, lengths, self.cache,
                                adapter=adapter)
        table = host[3 * S:].view(S, -1)
        return paged_decode_slots(self.model, tokens, lengths, table,
                                  self.cache, self._cache_len, adapter=adapter)

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # holds: _lock
    def _accept_token(self, slot: int, req: Request, tok: int) -> None:
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
        self.tokens_generated += 1
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception as e:  # noqa: BLE001 — the client's fault, isolate it
                self._fail_request(slot, req, f"token callback failed: {e!r}")
                return
        if len(req.output_ids) >= req.params.max_new_tokens:
            self._finish(slot, req, FINISH_LENGTH)

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

    # holds: _lock
    def _fail_request(self, slot: Optional[int], req: Request, msg: str,
                      non_finite: bool = False) -> None:
        """Fail ONE request and free its slot; the engine keeps serving. A
        paged slot failed for non-finite logits has its private pages
        zeroed before they return to the pool."""
        if slot is not None and self.scheduler.slots[slot] is req:
            if self._paged and non_finite:
                self._rewrite_slot_pages(slot, 0.0)
            self._free_slot(slot)
        req.error = msg
        req.finish_reason = FINISH_ERROR
        req.state = FINISHED
        req.t_finish = time.monotonic()
        self.requests_failed += 1
        self._count_adapter(req, "failed")
        req._mark_done()
        with self._work:
            self._work.notify_all()

    # holds: _lock
    def _finish(self, slot: int, req: Request, reason: str) -> None:
        req.state = FINISHED
        req.finish_reason = reason
        req.t_finish = time.monotonic()
        if self.scheduler.slots[slot] is req:
            self._free_slot(slot)
        self.requests_finished += 1
        self._count_adapter(req, "finished")
        req._mark_done()
        with self._work:
            self._work.notify_all()

    # -- background loop --------------------------------------------------

    def start(self) -> None:
        """Run ticks on one background thread until ``shutdown()``."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    progressed = self.step()
                except Exception as e:  # noqa: BLE001 — fail loudly, not silently
                    self._fail_all(f"engine loop error: {e!r}")
                    raise
                if not progressed:
                    with self._work:
                        self._work.wait(timeout=0.05)

        self._thread = threading.Thread(target=loop, name="decode-engine",
                                        daemon=True)
        self._thread.start()

    def _fail_all(self, msg: str) -> None:
        with self._lock:
            self._error = msg
            for slot, req in self.scheduler.active():
                self._fail_request(slot, req, msg)
            while (req := self.queue.get_nowait()) is not None:
                self._fail_request(None, req, msg)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the loop; with ``drain`` finish everything queued first."""
        if self._thread is not None:
            if drain:
                while ((self.scheduler.n_active or len(self.queue))
                       and self._thread.is_alive()):
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

    def stats(self) -> dict:
        with self._lock:
            out = {
                "requests_finished": self.requests_finished,
                "requests_rejected": self.requests_rejected,
                "requests_failed": self.requests_failed,
                "tokens_generated": self.tokens_generated,
                "decode_tokens": self.decode_tokens,
                "n_ticks": self.n_ticks,
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "kv_policy": self.kv_policy.describe(),
            }
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
            return out
