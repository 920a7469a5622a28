"""Multi-tenant LoRA adapter registry of the serving engine (port of the JAX
package's ``serving/adapters.py``).

Adapters live on the engine's device in one STACKED pool: every leaf of
the adapter tree (``models/lora.py``) with a leading ``(capacity,)`` axis,
beside a ``(capacity,)`` fp32 vector of scales (alpha / rank per row).
Capacity and rank are fixed when the registry is built; adapter identity is
data: each slot carries its pool row (-1 = base model), so any mix of
adapters and base traffic decodes in the same tick, and loading or
evicting an adapter changes no shape.

Visibility rule: a load writes the row's weights (rank zero-padded to
``max_rank``) and its scale IN PLACE into a row that no active slot
references, and only then publishes the new name map; the engine resolves
names to rows at admission, so no request sees a half-written row. An
evict frees the name at once but never zeroes the row: a request in flight
keeps decoding against the weights it was admitted with, and the engine's
in-use probe keeps the row from reuse until it retires.

Artifacts are ``models/lora.save_adapter`` files of either package; a
registry refuses one whose base-config fingerprint differs from its own
(a delta against other base weights is silent garbage). On the card the
pool's rank must be one the kernel B6 takes (``check_lora_kernel_shape``),
checked when the pool is built, before any request.

Concurrency: mutations (``load``/``evict``) serialise on the registry
lock; the engine's reads (``lookup`` per admission, ``pool_args`` per
tick) take no lock and read copy-on-write references. A load emits
``adapter_load`` and an evict ``adapter_evict`` (the JAX events' fields);
the engine's memory ledger reads ``pool_nbytes`` and ``bytes_by_adapter``.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.device import resolve_device
from building_llm_from_scratch_tpu_torch.models.lora import (
    adapted_shapes,
    adapter_fingerprint,
    flatten_lora,
    load_adapter,
    unflatten_lora,
)
from building_llm_from_scratch_tpu_torch.obs.metrics import get_metrics
from building_llm_from_scratch_tpu_torch.ops.decode_step import (
    check_lora_kernel_shape,
)

logger = logging.getLogger(__name__)

#: the name of un-adapted (base-model) traffic in the per-adapter counts
BASE_ADAPTER = "base"

#: legal adapter names (they flow into metric labels and log lines)
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.:-]*$")


class AdapterRegistryFullError(RuntimeError):
    """No free pool row: every row is loaded or still referenced by an
    active slot. Raise the capacity (``--serve_adapter_slots``) or evict."""


class AdapterMismatchError(ValueError):
    """The artifact's base-config fingerprint differs from the registry's:
    its deltas would multiply against the wrong weights."""


class AdapterRegistry:
    """Device-resident stacked pool of LoRA adapters, hot-loadable and
    evictable under live traffic:

        reg = AdapterRegistry(cfg, capacity=8, max_rank=16, device="cuda")
        reg.load("tenant-a", "adapters/a.npz")
        engine = DecodeEngine(model, adapters=reg)
        engine.submit(prompt, SamplingParams(adapter="tenant-a"))

    Lower-rank artifacts are zero-padded up to ``max_rank``: the zero
    columns of A and rows of B add an exactly zero delta."""

    def __init__(self, cfg: ModelConfig, *, capacity: int = 8,
                 max_rank: int = 16, device: torch.device | str = "cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if max_rank < 1:
            raise ValueError("max_rank must be >= 1")
        self.cfg = cfg
        self.capacity = int(capacity)
        self.max_rank = int(max_rank)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every decode tick runs B6 over the pool: refuse a rank or
            # dtype it cannot take now, not at the first tick
            check_lora_kernel_shape(self.max_rank, cfg.torch_dtype)
        self.fingerprint = adapter_fingerprint(cfg)
        self._shapes = adapted_shapes(cfg, self.max_rank)
        pool = unflatten_lora({
            path: torch.zeros((self.capacity,) + shape, dtype=cfg.torch_dtype,
                              device=self.device)
            for path, shape in self._shapes.items()})
        self._lock = threading.Lock()
        # the pool and scales are written in place; the tuple never changes
        self._device: Tuple[Dict[str, Any], torch.Tensor] = (
            pool, torch.zeros((self.capacity,), dtype=torch.float32,
                              device=self.device))
        self._by_name: Dict[str, int] = {}  # guarded-by: _lock [writes]
        self._meta: Dict[str, dict] = {}    # guarded-by: _lock [writes]
        self._rows: List[Optional[str]] = (
            [None] * self.capacity)         # guarded-by: _lock
        # name -> "name#<install>": the per-install identity that derived
        # state (the prefix store's cached panes) is keyed on, so an evicted
        # and reloaded adapter never serves the old install's panes
        self._tags: Dict[str, str] = {}     # guarded-by: _lock [writes]
        self._in_use_probe: Optional[Callable[[], Set[int]]] = None
        self.n_loads = 0                    # guarded-by: _lock
        self.n_evicts = 0                   # guarded-by: _lock

    @classmethod
    def from_artifacts(cls, cfg: ModelConfig, specs: Dict[str, str], *,
                       capacity: int = 0, max_rank: int = 0,
                       device: torch.device | str = "cuda") -> "AdapterRegistry":
        """Build and load a registry from {name: artifact path}. Capacity 0
        leaves one spare row for hot-loads (listed + 1, at least 2); rank 0
        takes the largest artifact's. Each artifact is read once."""
        parsed = {name: (path, load_adapter(path))
                  for name, path in specs.items()}
        if not max_rank:
            max_rank = max((meta["rank"] for _p, (_l, meta) in parsed.values()),
                           default=8)
        if not capacity:
            capacity = max(2, len(specs) + 1)
        reg = cls(cfg, capacity=capacity, max_rank=max_rank, device=device)
        for name, (path, (lora, meta)) in parsed.items():
            reg._install(name, path, lora, meta)
        return reg

    # -- engine-side reads (no lock) ----------------------------------------

    def pool_args(self) -> Tuple[Dict[str, Any], torch.Tensor]:
        """(stacked pool tree, (capacity,) fp32 scales), read every tick."""
        return self._device

    def lookup(self, name: str) -> Optional[int]:
        """Pool row of ``name``; None when not loaded (the engine fails the
        request with ``adapter_not_loaded``)."""
        return self._by_name.get(name)

    def resolve(self, name: str) -> int:
        """Like ``lookup`` but raising ``KeyError`` (the submit check)."""
        row = self._by_name.get(name)
        if row is None:
            raise KeyError(f"adapter '{name}' is not loaded (loaded: "
                           f"{sorted(self._by_name) or 'none'})")
        return row

    def load_tag(self, name: str) -> Optional[str]:
        """Per-install identity of ``name`` (``name#<seq>``), None when not
        loaded: a reload gets a fresh tag, so prefix panes cached under the
        old install stop matching."""
        return self._tags.get(name)

    def names(self) -> List[str]:
        return sorted(self._by_name)

    @property
    def n_loaded(self) -> int:
        return len(self._by_name)

    # -- engine wiring ------------------------------------------------------

    def set_in_use_probe(self, fn: Callable[[], Set[int]]) -> None:
        """The engine's view of the pool rows its active slots reference:
        ``load`` never reuses those rows, even after an evict."""
        self._in_use_probe = fn

    def _rows_in_use(self) -> Set[int]:
        if self._in_use_probe is None:
            return set()
        try:
            return set(self._in_use_probe())
        except Exception:           # noqa: BLE001 — a wedged engine must not
            # block registry admin; at worst no row is reused
            return set(range(self.capacity))

    # -- mutations ----------------------------------------------------------

    def load(self, name: str, path: str) -> int:
        """Load one artifact into a free pool row; returns the row."""
        t0 = time.monotonic()
        lora, meta = load_adapter(path)
        return self._install(name, path, lora, meta, t0)

    def _install(self, name: str, path: str, lora: dict, meta: dict,
                 t0: Optional[float] = None) -> int:
        """Validate one parsed artifact, write it into a free row, then
        publish its name."""
        if not _NAME_RE.match(name):
            raise ValueError(
                f"adapter name '{name}' is invalid: names flow into metrics "
                "labels and must match [A-Za-z0-9][A-Za-z0-9_.:-]*")
        if name == BASE_ADAPTER:
            raise ValueError(
                f"adapter name '{BASE_ADAPTER}' is reserved: it names "
                "un-adapted (base-model) traffic")
        if meta["fingerprint"] != self.fingerprint:
            raise AdapterMismatchError(
                f"adapter '{name}' ({path}) was trained against base config "
                f"{meta.get('model')}/{meta['fingerprint']}, but this "
                f"registry serves {self.cfg.name}/{self.fingerprint}")
        rank = int(meta["rank"])
        if rank > self.max_rank:
            raise ValueError(
                f"adapter '{name}' rank {rank} exceeds the pool's max_rank "
                f"{self.max_rank} (rebuild the registry larger)")
        flat = flatten_lora(lora)
        if set(flat) != set(self._shapes):
            missing = sorted(".".join(p) for p in set(self._shapes) - set(flat))
            extra = sorted(".".join(p) for p in set(flat) - set(self._shapes))
            raise ValueError(f"adapter '{name}' tree mismatch: missing "
                             f"{missing}, unexpected {extra}")
        with self._lock:
            if name in self._by_name:
                raise ValueError(f"adapter '{name}' is already loaded "
                                 "(evict it first to replace)")
            in_use = self._rows_in_use()
            row = next((r for r in range(self.capacity)
                        if self._rows[r] is None and r not in in_use), None)
            if row is None:
                raise AdapterRegistryFullError(
                    f"no free adapter row: {self.n_loaded}/{self.capacity} "
                    f"loaded, {sorted(in_use)} still referenced by active "
                    "slots")
            pool, scaling = self._device
            pool_flat = flatten_lora(pool)
            for path, leaf in flat.items():
                # rank axis: last of A (.., in, r), second to last of B
                axis = leaf.ndim - 1 if path[-1] == "A" else leaf.ndim - 2
                dst = pool_flat[path][row]
                dst.narrow(axis, rank, self.max_rank - rank).zero_()
                dst.narrow(axis, 0, rank).copy_(leaf)
            scaling[row] = float(meta["alpha"]) / float(rank)
            # the row is written in full before its name maps to it
            self._rows[row] = name
            self._by_name = {**self._by_name, name: row}
            self._meta = {**self._meta, name: meta}
            self.n_loads += 1
            self._tags = {**self._tags, name: f"{name}#{self.n_loads}"}
            n_loaded = self.n_loaded
        get_metrics().event(
            "adapter_load", name=name, path=path, row=row, rank=rank,
            alpha=float(meta["alpha"]), n_loaded=n_loaded,
            capacity=self.capacity,
            seconds=round(time.monotonic() - t0, 4) if t0 is not None else None)
        logger.info("Adapter '%s' loaded into row %d (rank %d, %d/%d).",
                    name, row, rank, n_loaded, self.capacity)
        return row

    def replace(self, name: str, path: str) -> int:
        """Evict ``name`` if loaded, then load ``path`` under it: the old
        row stays untouched until its requests retire, and the new install
        gets a fresh ``load_tag``."""
        if self._by_name.get(name) is not None:
            self.evict(name)
        return self.load(name, path)

    def evict(self, name: str) -> int:
        """Unload ``name``: new submits for it are rejected at once; its
        row keeps its weights until every slot referencing it retires.
        Returns the freed row."""
        with self._lock:
            row = self._by_name.get(name)
            if row is None:
                raise KeyError(f"adapter '{name}' is not loaded")
            self._rows[row] = None
            self._by_name = {k: v for k, v in self._by_name.items() if k != name}
            self._meta = {k: v for k, v in self._meta.items() if k != name}
            self._tags = {k: v for k, v in self._tags.items() if k != name}
            self.n_evicts += 1
            n_loaded = self.n_loaded
        get_metrics().event("adapter_evict", name=name, row=row,
                            n_loaded=n_loaded)
        logger.info("Adapter '%s' evicted from row %d (%d loaded).",
                    name, row, n_loaded)
        return row

    # -- introspection ------------------------------------------------------

    def pool_nbytes(self) -> int:
        """Device bytes of the stacked pool and its scales."""
        pool, scaling = self._device
        return (sum(t.numel() * t.element_size()
                    for t in flatten_lora(pool).values())
                + scaling.numel() * scaling.element_size())

    def bytes_by_adapter(self) -> Dict[str, int]:
        """Each loaded adapter owns 1/capacity of the pool."""
        per_row = self.pool_nbytes() // max(self.capacity, 1)
        return {name: per_row for name in self._by_name}

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "max_rank": self.max_rank,
                "n_loaded": self.n_loaded,
                "n_loads": self.n_loads,
                "n_evicts": self.n_evicts,
                "adapters": {
                    name: {"row": row,
                           "rank": self._meta[name]["rank"],
                           "alpha": self._meta[name]["alpha"]}
                    for name, row in sorted(self._by_name.items())
                },
            }
