"""The memory ledger (port of the JAX package's ``obs/memory.py``
``MemoryLedger``).

Each device-memory consumer registers a named component whose bytes are
measured from the live tensors (``nbytes`` sums: metadata, never a device
sync): an engine's weights, slot cache or page pool, prefix store and
adapter pool; a trainer's ``model_params`` and ``optimizer_state``. Host
RSS can ride as a component outside the device sum (``track_host_rss``).
``observe`` (the engine's or the trainer's metrics cadence) snapshots
them, checks each against its exact expectation where one is registered
and runs the invariant probes (``memory_drift``), watches the headroom
against the card's memory (``memory_pressure``) and emits
``memory_snapshot``; ``gauges`` feeds ``/metrics`` and ``legacy_row`` the
trainer's ``hbm_bytes_in_use`` / ``hbm_peak_bytes`` / ``host_rss_bytes``.
The allocator's figures are ``torch.cuda.memory_allocated`` and
``max_memory_allocated`` (absent on the CPU). The XLA compile temps of the
JAX trainer have no counterpart."""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)


def pytree_nbytes(tree: Any) -> int:
    """Bytes of every tensor or array leaf of ``tree`` (nested dicts,
    lists and tuples): metadata only, never a sync."""
    total, stack = 0, [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "nbytes"):
            total += int(node.nbytes)
    return total


def _escape_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def _device_stats(device) -> Dict[str, int]:
    """The allocator's bytes in use and watermark on a CUDA ``device``
    (``{}`` elsewhere)."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return {}
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device))}


def _capacity(device) -> Optional[int]:
    import torch

    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


class MemoryLedger:
    """Byte-exact component ledger with drift and pressure detection.
    ``emit(kind, **fields)`` is the event sink (default: the process-wide
    metrics sink); ``device`` is where the components live."""

    def __init__(self, *, emit: Optional[Callable[..., None]] = None,
                 source: str = "engine", device=None,
                 capacity_bytes: Optional[int] = None,
                 pressure_frac: float = 0.92):
        if emit is None:
            from building_llm_from_scratch_tpu_torch.obs.metrics import (
                emit_event,
            )

            emit = emit_event
        self._emit = emit
        self.source = source
        self.device = device
        self.capacity_bytes = (capacity_bytes if capacity_bytes is not None
                               else _capacity(device))
        self.pressure_frac = float(pressure_frac)
        self._components: Dict[str, Tuple[Callable[[], int], bool]] = {}
        self._expected: Dict[str, Callable[[], int]] = {}
        self._labeled: Dict[str, Tuple[str, Callable[[], Dict[str, int]]]] = {}
        self._probes: Dict[str, Callable[[], Optional[Dict[str, Any]]]] = {}
        self.host_rss: Optional[int] = None
        self.sizes: Dict[str, int] = {}
        self.watermarks: Dict[str, int] = {}
        self.labeled_sizes: Dict[str, Dict[str, int]] = {}
        self.labeled_peaks: Dict[str, Dict[str, int]] = {}
        self._pressure_armed = True
        self.n_snapshots = 0
        self.n_drift_events = 0
        self.n_pressure_events = 0
        self.device_stats: Dict[str, int] = {}

    def register(self, name: str, provider: Callable[[], int], *,
                 device: bool = True,
                 expected: Optional[Callable[[], int]] = None) -> None:
        """Component ``name``: ``provider()`` -> bytes of the live tensors;
        ``expected()`` its exact size (a mismatch is a ``memory_drift``).
        ``device=False``: attribution only, outside the device sum."""
        self._components[name] = (provider, bool(device))
        if expected is not None:
            self._expected[name] = expected

    def register_labeled(self, series: str, label: str,
                         provider: Callable[[], Dict[str, int]]) -> None:
        """An attribution series ``series{label="..."}`` with per-label
        watermarks."""
        self._labeled[series] = (label, provider)

    def register_probe(self, name: str,
                       probe: Callable[[], Optional[Dict[str, Any]]]) -> None:
        """An invariant probe run at each ``observe``: a non-None return is
        a violation, a ``memory_drift`` with ``component=name`` and the
        probe's fields (its ``reason``, default "invariant")."""
        self._probes[name] = probe

    def track_host_rss(self) -> None:
        """Host RSS as a component outside the device sum, so host growth
        (checkpoint staging, the data pipeline) is attributed."""
        from building_llm_from_scratch_tpu_torch.utils.memory import (
            host_rss_bytes,
        )

        self.register("host_rss", lambda: host_rss_bytes() or 0, device=False)

    def snapshot(self) -> Dict[str, int]:
        """Refresh every component; no events, no syncs."""
        for name, (provider, _dev) in self._components.items():
            size = int(provider())
            self.sizes[name] = size
            if size > self.watermarks.get(name, -1):
                self.watermarks[name] = size
        for series, (_label, provider) in self._labeled.items():
            sizes = {str(k): int(v) for k, v in provider().items()}
            self.labeled_sizes[series] = sizes
            peaks = self.labeled_peaks.setdefault(series, {})
            for key, size in sizes.items():
                if size > peaks.get(key, -1):
                    peaks[key] = size
        self.device_stats = _device_stats(self.device)
        if "host_rss" in self.sizes:
            self.host_rss = self.sizes["host_rss"]
        return dict(self.sizes)

    def device_bytes(self) -> int:
        return sum(s for n, s in self.sizes.items() if self._components[n][1])

    def host_bytes(self) -> int:
        return sum(s for n, s in self.sizes.items() if not self._components[n][1])

    def total_bytes(self) -> int:
        return sum(self.sizes.values())

    def headroom_bytes(self) -> Optional[int]:
        if self.capacity_bytes is None:
            return None
        return self.capacity_bytes - self.device_bytes()

    def observe(self, step: Optional[int] = None) -> Dict[str, int]:
        """The cadence entry: snapshot, the detectors, ``memory_snapshot``."""
        comps = self.snapshot()
        self.n_snapshots += 1
        for name, expected_fn in self._expected.items():
            expected, measured = int(expected_fn()), self.sizes.get(name, 0)
            if measured != expected:
                self._drift(name, "reconcile", expected_bytes=expected,
                            measured_bytes=measured,
                            delta_bytes=measured - expected)
        for name, probe in self._probes.items():
            try:
                violation = probe()
            except Exception:
                logger.exception("memory probe %s raised", name)
                continue
            if violation:
                fields = dict(violation)
                self._drift(name, fields.pop("reason", "invariant"), **fields)
        self._check_pressure(step)
        fields: Dict[str, Any] = {"source": self.source, "components": comps,
                                  "total_bytes": self.total_bytes(),
                                  "device_bytes": self.device_bytes()}
        if self.host_bytes():
            fields["host_bytes"] = self.host_bytes()
        if self.capacity_bytes is not None:
            fields["capacity_bytes"] = self.capacity_bytes
            fields["headroom_bytes"] = self.headroom_bytes()
        if self.labeled_sizes:
            fields["labeled"] = {s: dict(v) for s, v in
                                 self.labeled_sizes.items() if v}
        if step is not None:
            fields["step"] = step
        self._emit("memory_snapshot", **fields)
        return comps

    def _drift(self, component: str, reason: str, **fields: Any) -> None:
        self.n_drift_events += 1
        self._emit("memory_drift", component=component, reason=reason,
                   source=self.source, **fields)
        logger.warning("memory_drift[%s]: %s %s", component, reason, fields)

    def _check_pressure(self, step: Optional[int]) -> None:
        """On the upward crossing of ``pressure_frac`` of the card's memory
        the full breakdown rides one ``memory_pressure`` event; re-arms
        below it."""
        if not self.capacity_bytes:
            return
        used = self.device_bytes()
        frac = used / self.capacity_bytes
        if frac < self.pressure_frac:
            self._pressure_armed = True
            return
        if not self._pressure_armed:
            return
        self._pressure_armed = False
        self.n_pressure_events += 1
        fields: Dict[str, Any] = {
            "source": self.source,
            "headroom_bytes": self.capacity_bytes - used,
            "capacity_bytes": self.capacity_bytes,
            "used_frac": round(frac, 6), "threshold_frac": self.pressure_frac,
            "device_bytes": used, "total_bytes": self.total_bytes(),
            "components": {n: s for n, s in self.sizes.items()
                           if self._components[n][1]}}
        if step is not None:
            fields["step"] = step
        self._emit("memory_pressure", **fields)

    def gauges(self) -> Dict[str, Any]:
        """``/metrics`` gauges: each component and its watermark, totals,
        headroom, the attribution series and the allocator's bytes."""
        out: Dict[str, Any] = {}
        for name, size in self.sizes.items():
            lbl = f'{{component="{_escape_label(name)}"}}'
            out[f"mem_component_bytes{lbl}"] = size
            out[f"mem_component_peak_bytes{lbl}"] = self.watermarks[name]
        out["mem_total_bytes"] = self.total_bytes()
        out["mem_device_bytes"] = self.device_bytes()
        if self.capacity_bytes is not None:
            out["mem_capacity_bytes"] = self.capacity_bytes
            out["mem_headroom_bytes"] = self.headroom_bytes()
        out["mem_drift_events"] = self.n_drift_events
        out["mem_pressure_events"] = self.n_pressure_events
        for series, (label, _provider) in self._labeled.items():
            sizes = self.labeled_sizes.get(series, {})
            peaks = self.labeled_peaks.get(series, {})
            for key in sorted(set(sizes) | set(peaks)):
                lbl = f'{{{label}="{_escape_label(key)}"}}'
                if key in sizes:
                    out[f"{series}{lbl}"] = sizes[key]
                if key in peaks:
                    out[f"{series}_peak{lbl}"] = peaks[key]
        for key, gauge in (("bytes_in_use", "hbm_bytes_in_use"),
                           ("peak_bytes_in_use", "hbm_peak_bytes")):
            if key in self.device_stats:
                out[gauge] = self.device_stats[key]
        if self.host_rss is not None:
            out["host_rss_bytes"] = self.host_rss
        return out

    def legacy_row(self) -> Dict[str, int]:
        """The trainer's metrics-row keys from the ledger's last poll:
        ``hbm_bytes_in_use`` and ``hbm_peak_bytes`` (the allocator's, on the
        card) and ``host_rss_bytes``."""
        out: Dict[str, int] = {}
        if "bytes_in_use" in self.device_stats:
            out["hbm_bytes_in_use"] = self.device_stats["bytes_in_use"]
        if "peak_bytes_in_use" in self.device_stats:
            out["hbm_peak_bytes"] = self.device_stats["peak_bytes_in_use"]
        if self.host_rss is not None:
            out["host_rss_bytes"] = self.host_rss
        return out

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "components": dict(self.sizes),
            "watermarks": dict(self.watermarks),
            "total_bytes": self.total_bytes(),
            "device_bytes": self.device_bytes(),
            "n_snapshots": self.n_snapshots,
            "n_drift_events": self.n_drift_events,
            "n_pressure_events": self.n_pressure_events,
        }
        if self.capacity_bytes is not None:
            out["capacity_bytes"] = self.capacity_bytes
            out["headroom_bytes"] = self.headroom_bytes()
        return out
