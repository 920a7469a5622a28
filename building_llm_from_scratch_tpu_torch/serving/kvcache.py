"""KV-cache policy, page pool and shared-prefix store (port of the JAX
package's ``serving/kvcache.py``).

One ``KVCachePolicy`` decides the slot cache's layout and the prefill tier:

  - **chunked prefill** (``prefill_chunk=C``): prompts prefill in C-token
    chunks interleaved with decode ticks, so one long prompt never stalls
    the co-resident requests for its whole forward pass;
  - **prefix caching** (``prefix_cache=True``): a hash-keyed (token ids,
    model fingerprint, adapter tag) store of per-layer KV panes. A shared
    prefix (a system prompt) prefills once; later requests copy its panes
    into their slot and prefill only the suffix. LRU eviction under a byte
    budget, with in-use pinning;
  - **paged KV** (``paged=True``): the slot rows map their positions onto
    fixed-size pages of one shared pool through a host-owned per-slot page
    table. A prefix hit becomes a refcounted table write (no copy), freed
    pages recycle across requests, and admission checks free pages;
  - **int8 slot KV** (``kv_quant="int8"``): every append is quantized on
    write (``ops/decode_step.quantize_kv``: int8 codes and one fp32 scale
    per (row, head, position), in (.., Hkv, T, 1) sidecars ``k_scale`` /
    ``v_scale``, paged pools included), and ``decode_attention`` folds the
    scales into its products. KV data bytes are exactly half of bf16's;
    the sidecars add 2 / head_dim (6.25% at head_dim 64).

Telemetry: an LRU eviction emits ``prefix_evict`` (the JAX event's
fields); the memory ledger reads the store's bytes per adapter namespace
(``bytes_by_tag``) and its pinned entries (``pinned_bytes``: pins are held
across one pane copy only, so one still held at a cadence is an orphan).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
# the prefix store's key namespace: the base architecture's fingerprint
from building_llm_from_scratch_tpu_torch.models.lora import (  # noqa: F401
    adapter_fingerprint,
)
from building_llm_from_scratch_tpu_torch.obs.metrics import get_metrics

KV_QUANT_CHOICES = ("model", "int8")


@dataclass(frozen=True)
class KVCachePolicy:
    """Layout and prefix policy of the slot KV cache, fixed per engine."""

    kv_quant: str = "model"          # "model" (cfg dtype) | "int8"
    prefix_cache: bool = False
    prefill_chunk: int = 0           # 0 = monolithic bucketed prefill
    prefix_budget_bytes: int = 256 * 1024 ** 2
    paged: bool = False              # page-table layout over a shared pool
    page_tokens: int = 16            # positions per KV page (paged only)
    pool_pages: int = 0              # usable pool pages; 0 = n_slots full

    def __post_init__(self):
        if self.kv_quant not in KV_QUANT_CHOICES:
            raise ValueError(f"kv_quant must be one of {KV_QUANT_CHOICES}, "
                             f"got '{self.kv_quant}'")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if self.prefix_cache and self.prefill_chunk <= 0:
            raise ValueError(
                "prefix_cache needs chunked prefill (prefill_chunk > 0): "
                "the suffix after a cached span prefills in chunks; the "
                "monolithic bucketed prefill always starts at position 0")
        if self.prefix_budget_bytes < 0:
            raise ValueError("prefix_budget_bytes must be >= 0")
        if self.page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if self.pool_pages < 0:
            raise ValueError("pool_pages must be >= 0")
        if self.paged:
            if self.prefill_chunk <= 0:
                raise ValueError(
                    "paged KV needs chunked prefill (prefill_chunk > 0): "
                    "pages are allocated as the chunk frontier advances")
            if self.prefill_chunk % self.page_tokens != 0:
                raise ValueError(
                    "paged KV needs prefill_chunk to be a multiple of "
                    f"page_tokens (got chunk {self.prefill_chunk}, page "
                    f"{self.page_tokens}): chunk boundaries must land on "
                    "page boundaries, so shared prefix spans are whole "
                    "pages")

    # -- layout ------------------------------------------------------------

    @property
    def quantized(self) -> bool:
        return self.kv_quant == "int8"

    def cache_dtype(self, cfg: ModelConfig) -> torch.dtype:
        return torch.int8 if self.quantized else cfg.torch_dtype

    def alloc(self, cfg: ModelConfig, n_rows: int, max_length: int,
              device: torch.device | str) -> dict:
        """Per-layer k/v buffers: (n_rows, Hkv, max_length, hd) rows, or for
        a paged policy a pool of (total_pool_pages, Hkv, page_tokens, hd)
        pages, page 0 the trash page; in the model dtype, or int8 with fp32
        ``k_scale`` / ``v_scale`` sidecars of the same shape and a trailing
        axis of 1 (one scale per written position and head)."""
        if self.paged:
            rows = (self.total_pool_pages(n_rows, max_length),
                    cfg.n_kv_groups, self.page_tokens)
        else:
            rows = (n_rows, cfg.n_kv_groups, max_length)

        def mk(width: int, dtype: torch.dtype) -> list:
            return [torch.zeros(rows + (width,), dtype=dtype, device=device)
                    for _ in range(cfg.n_layers)]

        dt = self.cache_dtype(cfg)
        cache = {"k": mk(cfg.head_dim, dt), "v": mk(cfg.head_dim, dt)}
        if self.quantized:
            cache["k_scale"] = mk(1, torch.float32)
            cache["v_scale"] = mk(1, torch.float32)
        return cache

    # -- paged layout --------------------------------------------------------

    def pages_per_slot(self, max_length: int) -> int:
        """Page-table width: enough columns to map a full-length row."""
        return -(-max_length // self.page_tokens)

    def total_pool_pages(self, n_rows: int, max_length: int) -> int:
        """Pages on the device: the usable pool (``pool_pages``, by default
        ``n_rows`` full-length rows) plus the trash page 0, which no slot
        owns: zeroed table entries point at it, so out-of-range appends
        land there and reads of it are always masked."""
        usable = self.pool_pages or n_rows * self.pages_per_slot(max_length)
        return usable + 1

    def page_bytes(self, cfg: ModelConfig) -> int:
        """Device bytes of one page across every layer, k and v and their
        scale sidecars: total cache bytes = total_pool_pages x page_bytes."""
        width = torch.empty((), dtype=self.cache_dtype(cfg)).element_size()
        per = 2 * cfg.n_layers * cfg.n_kv_groups * self.page_tokens
        return per * cfg.head_dim * width + (per * 4 if self.quantized else 0)

    def bytes_per_slot(self, cfg: ModelConfig, max_length: int) -> Dict[str, int]:
        """One contiguous slot's cache bytes: ``kv_bytes`` the k and v data
        of every layer (int8 halves bf16's exactly), ``scale_bytes`` the
        fp32 sidecars (0 unquantized)."""
        width = torch.empty((), dtype=self.cache_dtype(cfg)).element_size()
        kv = (2 * cfg.n_layers * max_length * cfg.n_kv_groups * cfg.head_dim
              * width)
        scale = (2 * cfg.n_layers * max_length * cfg.n_kv_groups * 4
                 if self.quantized else 0)
        return {"kv_bytes": kv, "scale_bytes": scale, "total_bytes": kv + scale,
                "bytes_per_token": (kv + scale) // max_length}

    def describe(self) -> dict:
        out = {"kv_quant": self.kv_quant, "prefix_cache": self.prefix_cache,
               "prefill_chunk": self.prefill_chunk}
        if self.paged:
            out.update(kv_paged=True, page_tokens=self.page_tokens,
                       pool_pages=self.pool_pages)
        return out


DEFAULT_POLICY = KVCachePolicy()


def cache_is_quantized(cache: dict) -> bool:
    """Whether appends to ``cache`` quantize and attention reads scales:
    the cache itself says so (its scale sidecars), so the model code never
    needs the policy."""
    return "k_scale" in cache


def cache_nbytes(cache: dict) -> int:
    """Bytes of a cache dict: per-layer buffer lists or stacked panes."""
    total = 0
    for leaves in cache.values():
        if isinstance(leaves, (list, tuple)):
            total += sum(t.numel() * t.element_size() for t in leaves)
        else:
            total += leaves.numel() * leaves.element_size()
    return total


# ---------------------------------------------------------------------------
# the page pool (paged layout only; host-side allocator)
# ---------------------------------------------------------------------------

class PagePool:
    """Host-side allocator and refcounts for the shared device page pool.

    Which page holds which slot's positions is host bookkeeping; the device
    owns only the pool tensors. Refcounts make prefix sharing copy-free: a
    hit increfs the stored entry's pages and writes their ids into the
    slot's table, and a page returns to the free list when its last owner
    (slot or store entry) drops it.

    ``reserved`` is the admission ledger: admitting a request reserves its
    worst-case private page need, and each on-demand allocation for that
    slot draws the reservation down, so two admitted requests never fight
    over the last page mid-decode. Page 0 is the trash page: allocated for
    good, never freed.
    """

    def __init__(self, n_pages: int, page_bytes: int):
        if n_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (trash + 1 usable)")
        self.n_pages = int(n_pages)
        self.page_bytes = int(page_bytes)
        self._lock = threading.Lock()
        self._refs = np.zeros(self.n_pages, np.int64)   # guarded-by: _lock
        self._refs[0] = 1                               # trash page: pinned
        # lowest-id-first free list: dense ids, reproducible sequences
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> lowest
        self.reserved = 0               # guarded-by: _lock
        self.n_allocs = 0               # guarded-by: _lock
        self.n_frees = 0                # guarded-by: _lock
        self.peak_used = 0              # guarded-by: _lock

    def alloc(self, *, from_reserved: bool = False) -> int:
        """Take the lowest free page (refcount 1); ``from_reserved``
        consumes one unit of the admission reservation. Running dry is an
        accounting bug (admission checks ``available()`` first)."""
        with self._lock:
            if not self._free:
                raise RuntimeError(
                    "page pool exhausted: admission reservation accounting "
                    "is broken (alloc past available())")
            page = self._free.pop()
            self._refs[page] = 1
            if from_reserved:
                self.reserved = max(self.reserved - 1, 0)
            self.n_allocs += 1
            self.peak_used = max(self.peak_used,
                                 self.n_pages - 1 - len(self._free))
            return page

    def incref(self, page: int) -> None:
        with self._lock:
            if page == 0 or self._refs[page] <= 0:
                raise RuntimeError(
                    f"incref on unallocated page {page} (use-after-free)")
            self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; True when the page went back to the free
        list."""
        with self._lock:
            if page == 0:
                return False            # the trash page is never freed
            if self._refs[page] <= 0:
                raise RuntimeError(f"decref on free page {page} (double free)")
            self._refs[page] -= 1
            if self._refs[page] == 0:
                self._free.append(page)
                self._free.sort(reverse=True)
                self.n_frees += 1
                return True
            return False

    def refcount(self, page: int) -> int:
        with self._lock:
            return int(self._refs[page])

    def available(self) -> int:
        """Free pages not yet promised to an admitted request."""
        with self._lock:
            return len(self._free) - self.reserved

    def reserve(self, n: int) -> None:
        with self._lock:
            self.reserved += int(n)

    def unreserve(self, n: int) -> None:
        with self._lock:
            self.reserved = max(self.reserved - int(n), 0)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> dict:
        with self._lock:
            return {"n_pages": self.n_pages - 1,     # usable (sans trash)
                    "page_bytes": self.page_bytes,
                    "used": self.n_pages - 1 - len(self._free),
                    "free": len(self._free),
                    "reserved": self.reserved,
                    "peak_used": self.peak_used,
                    "allocs": self.n_allocs,
                    "frees": self.n_frees}


# ---------------------------------------------------------------------------
# pane primitives (contiguous layout)
# ---------------------------------------------------------------------------

@torch.no_grad()
def copy_prefix_into_slot(cache: dict, panes: dict, slot: int) -> dict:
    """Write a stored prefix's stacked (L, Hkv, pane_len, hd) panes (and
    (L, Hkv, pane_len, 1) scale panes of an int8 cache) into row ``slot``
    of the slot cache, IN PLACE: the whole compute of a contiguous prefix
    hit (no forward for the cached span). The pane starts at position 0
    (pane_len <= Tmax)."""
    for name, bufs in cache.items():
        pane = panes[name]
        for layer, buf in enumerate(bufs):
            buf[slot, :, :pane.shape[2]] = pane[layer].to(buf.dtype)
    return cache


@torch.no_grad()
def extract_prefix_panes(cache: dict, slot: int, n_valid: int, *,
                         pane_len: int) -> dict:
    """Row ``slot``'s first ``pane_len`` positions as stacked (L, Hkv,
    pane_len, hd) panes (new tensors; an int8 cache's scales as (L, Hkv,
    pane_len, 1) panes beside them), every position >= ``n_valid`` ZEROED: past the span lies request-private state (the donor's suffix,
    a previous occupant's tail) that must never become shareable, and the
    clamp makes a stored pane a function of the prefix tokens alone."""
    keep = (torch.arange(pane_len, device=cache["k"][0].device)
            < n_valid)[None, :, None]
    out = {}
    for name, bufs in cache.items():
        rows = [torch.where(keep, buf[slot, :, :pane_len],
                            torch.zeros((), dtype=buf.dtype, device=buf.device))
                for buf in bufs]
        out[name] = torch.stack(rows)
    return out


# ---------------------------------------------------------------------------
# the prefix store
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("key", "panes", "nbytes", "pins", "pages", "span", "tag",
                 "hits", "t_insert")

    def __init__(self, key: str, panes: Optional[dict], nbytes: int,
                 pages: Optional[List[int]] = None, span: int = 0,
                 tag: Optional[str] = None):
        self.key = key
        self.panes = panes
        self.nbytes = nbytes
        self.pins = 0
        self.span = span
        self.tag = tag
        self.hits = 0
        self.t_insert = time.monotonic()
        # paged layout: the entry owns references to shared pool pages
        # instead of a pane copy (panes is None); nbytes is their footprint
        self.pages = pages


class PrefixStore:
    """Hash-keyed LRU store of device-resident prefix KV.

    Keys are sha1(model fingerprint, adapter tag, token ids). Spans are
    chunk-granular: a lookup probes the longest multiple-of-``chunk_tokens``
    prefix first and walks down. An entry pinned by an in-flight copy is
    never evicted; eviction skips it and the insert that needed the room
    is skipped instead. With a ``page_pool``, entries hold page references
    and eviction returns them to the pool.
    """

    def __init__(self, fingerprint: str, *, chunk_tokens: int,
                 budget_bytes: int, pane_tokens: int,
                 page_pool: Optional[PagePool] = None):
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self.fingerprint = fingerprint
        self.chunk_tokens = int(chunk_tokens)
        self.budget_bytes = int(budget_bytes)
        self.pane_tokens = int(pane_tokens)
        self.page_pool = page_pool
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()  # guarded-by: _lock
        self.bytes_total = 0            # guarded-by: _lock
        self.n_hits = 0                 # guarded-by: _lock
        self.n_misses = 0               # guarded-by: _lock
        self.n_inserts = 0              # guarded-by: _lock
        self.n_evictions = 0            # guarded-by: _lock
        self.n_insert_skips = 0         # guarded-by: _lock

    def key(self, token_ids, tag: str) -> str:
        h = hashlib.sha1()
        h.update(self.fingerprint.encode())
        h.update(b"\x00")
        h.update(tag.encode())
        h.update(b"\x00")
        h.update(np.ascontiguousarray(token_ids, np.int32).tobytes())
        return h.hexdigest()

    def storable_span(self, prompt_len: int) -> int:
        """Longest chunk-aligned span of a ``prompt_len`` prompt worth
        storing: one below the prompt at most (a hit must leave a suffix
        token to give first-token logits) and at most the pane width."""
        span = ((prompt_len - 1) // self.chunk_tokens) * self.chunk_tokens
        return min(span, self.pane_tokens)

    def match(self, prompt_ids, tag: str, *, min_span: int = 0,
              count_miss: bool = True) -> Tuple[int, Optional[_Entry]]:
        """Longest-prefix lookup: (span, entry), or (0, None) on a miss. A
        returned entry is PINNED until ``release``. Only spans longer than
        ``min_span`` count (the mid-prefill catch-up probe);
        ``count_miss=False`` keeps that probe out of the miss count."""
        n_max = self.storable_span(len(prompt_ids))
        for m in range(n_max // self.chunk_tokens, 0, -1):
            span = m * self.chunk_tokens
            if span <= min_span:
                break
            k = self.key(prompt_ids[:span], tag)
            with self._lock:
                entry = self._entries.get(k)
                if entry is not None:
                    self._entries.move_to_end(k)
                    entry.pins += 1
                    entry.hits += 1
                    self.n_hits += 1
                    return span, entry
        if count_miss:
            with self._lock:
                self.n_misses += 1
        return 0, None

    def release(self, entry: _Entry) -> None:
        with self._lock:
            entry.pins = max(entry.pins - 1, 0)

    def contains(self, token_ids, tag: str) -> bool:
        k = self.key(token_ids, tag)
        with self._lock:
            if k in self._entries:
                self._entries.move_to_end(k)
                return True
        return False

    def insert(self, token_ids, tag: str, panes: dict) -> int:
        """Store one prefix's panes, evicting least-recently-used unpinned
        entries to fit the budget. Returns the entry's bytes, or 0 when
        skipped (counted) or already stored (not counted)."""
        return self._insert_keyed(self.key(token_ids, tag), panes,
                                  cache_nbytes(panes), span=len(token_ids),
                                  tag=tag)

    def insert_pages(self, token_ids, tag: str, pages: List[int]) -> int:
        """Paged insert: store references to the donor slot's pool pages
        (the store increfs each) and charge their footprint to the same
        budget. No device work."""
        if self.page_pool is None:
            raise RuntimeError("insert_pages needs a page_pool-backed "
                               "PrefixStore")
        return self._insert_keyed(self.key(token_ids, tag), None,
                                  len(pages) * self.page_pool.page_bytes,
                                  pages=list(pages), span=len(token_ids),
                                  tag=tag)

    def _insert_keyed(self, k: str, panes: Optional[dict], nbytes: int,
                      pages: Optional[List[int]] = None, span: int = 0,
                      tag: Optional[str] = None) -> int:
        evicted = []
        with self._lock:
            if k in self._entries:
                self._entries.move_to_end(k)
                return 0
            if nbytes > self.budget_bytes:
                self.n_insert_skips += 1
                return 0
            while self.bytes_total + nbytes > self.budget_bytes:
                victim_key = next((key for key, e in self._entries.items()
                                   if e.pins == 0), None)
                if victim_key is None:       # everything evictable pinned
                    self.n_insert_skips += 1
                    return 0
                victim = self._entries.pop(victim_key)
                self.bytes_total -= victim.nbytes
                self.n_evictions += 1
                evicted.append(victim)
            if pages is not None:
                # the store's own references; the donor slot drops its
                # references independently when it retires
                for p in pages:
                    self.page_pool.incref(p)
            self._entries[k] = _Entry(k, panes, nbytes, pages=pages, span=span,
                                      tag=tag)
            self.bytes_total += nbytes
            self.n_inserts += 1
            n_entries, bytes_total = len(self._entries), self.bytes_total
        for victim in evicted:
            self._release_victim_pages(victim)
            get_metrics().event(
                "prefix_evict", key=victim.key, bytes=victim.nbytes,
                span_tokens=victim.span, hits=victim.hits,
                age_s=round(time.monotonic() - victim.t_insert, 3),
                entries_left=n_entries, bytes_left=bytes_total)
        return nbytes

    def _release_victim_pages(self, victim: _Entry) -> None:
        """Return an evicted paged entry's page references to the pool."""
        if victim.pages is not None and self.page_pool is not None:
            for p in victim.pages:
                self.page_pool.decref(p)

    def clear(self) -> None:
        """Drop every entry, returning paged entries' page references. The
        paged engine's restart calls it: the entries reference pages of
        the pool being replaced (a contiguous store's own pane copies
        survive a restart)."""
        with self._lock:
            victims = list(self._entries.values())
            self._entries.clear()
            self.bytes_total = 0
        for victim in victims:
            self._release_victim_pages(victim)

    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    def bytes_by_tag(self) -> Dict[str, int]:
        """The memory ledger's attribution: adapter tag -> stored bytes."""
        out: Dict[str, int] = {}
        with self._lock:
            for e in self._entries.values():
                tag = e.tag if e.tag is not None else "external"
                out[tag] = out.get(tag, 0) + e.nbytes
        return out

    def pinned_bytes(self) -> Tuple[int, List[str]]:
        """(bytes, keys) of the entries pinned now: at a cadence boundary
        any is an orphan (the ledger's ``pinned_orphan`` probe)."""
        with self._lock:
            pinned = [(e.key, e.nbytes) for e in self._entries.values()
                      if e.pins > 0]
        return sum(nb for _k, nb in pinned), [k for k, _nb in pinned]

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.bytes_total,
                "budget_bytes": self.budget_bytes,
                "hits": self.n_hits,
                "misses": self.n_misses,
                "inserts": self.n_inserts,
                "evictions": self.n_evictions,
                "insert_skips": self.n_insert_skips,
                "chunk_tokens": self.chunk_tokens,
                "pane_tokens": self.pane_tokens,
            }
