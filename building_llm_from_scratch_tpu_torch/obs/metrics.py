"""Telemetry: fixed-bucket histograms, the rolling SLO window, the
Prometheus text exposition and the JSONL sink (port of the JAX package's
``obs/metrics.py``).

JSONL rows (one JSON object a line, ``type`` discriminates): one
``header`` first (run metadata), ``metrics`` rows at the engine's or the
trainer's cadence, ``health`` rows (the trainer's per-layer-group arrays,
``obs/health.py``: ``groups`` and parallel lists, kept out of the scalar
rows), typed ``event`` rows and one ``span`` row per request at its
terminal state. A path that already holds a previous run's file is
rotated aside (``.1``, ``.2``, ...) at the first write, so each file keeps
one header. Only rank 0 writes. The module-level sink
(``configure_metrics`` / ``get_metrics`` / ``emit_event``) lets any layer
emit without a handle; it is a no-op until configured. Writes are
lock-guarded: the stall detector and the HTTP handler threads emit beside
the engine loop."""

from __future__ import annotations

import bisect
import json
import logging
import math
import os
import re
import sys
import threading
import time
from typing import IO, Any, Dict, Optional

from building_llm_from_scratch_tpu_torch.obs.schema import SCHEMA_VERSION

logger = logging.getLogger(__name__)


def _is_coordinator() -> bool:
    from building_llm_from_scratch_tpu_torch.parallel.collectives import (
        is_coordinator,
    )

    return is_coordinator()


def _jsonable(value: Any) -> Any:
    """JSON-safe values: numpy and torch scalars become Python scalars,
    non-finite floats strings, unknown objects their repr."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else str(value)
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if getattr(value, "ndim", None):
        tolist = getattr(value, "tolist", None)
        if callable(tolist):
            try:
                return _jsonable(tolist())
            except Exception:
                pass
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    return repr(value)


# ---------------------------------------------------------------------------
# fixed-bucket histograms and the rolling SLO window
# ---------------------------------------------------------------------------

#: latency buckets (seconds) for TTFT / TPOT / e2e / queue wait
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


class Histogram:
    """Thread-safe fixed-bucket histogram with Prometheus semantics:
    ``bounds`` are the inclusive upper edges, an implicit +Inf bucket takes
    the tail, and the counts are cumulative and never forget."""

    def __init__(self, bounds=LATENCY_BUCKETS_S):
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)   # guarded-by: _lock
        self.count = 0                                # guarded-by: _lock
        self.sum = 0.0                                # guarded-by: _lock

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += value

    def snapshot(self) -> Dict[str, Any]:
        """{"buckets": [(le, cumulative count), ..., ("+Inf", n)], "count",
        "sum"}, one consistent view."""
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
        cum, out = 0, []
        for le, c in zip(self.bounds, counts):
            cum += c
            out.append((le, cum))
        out.append(("+Inf", total))
        return {"buckets": out, "count": total, "sum": s}

    def percentile(self, p: float) -> Optional[float]:
        """The p-th percentile, interpolated inside its bucket (the +Inf
        bucket clamps to the largest bound); None when empty."""
        with self._lock:
            counts = list(self._counts)
            total = self.count
        if total == 0:
            return None
        rank = (p / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return self.bounds[-1]

    def percentiles(self, ps=(50, 95, 99)) -> Dict[str, float]:
        out = {}
        for p in ps:
            v = self.percentile(p)
            if v is not None:
                out[f"p{p}"] = round(v, 6)
        return out


class RollingRatio:
    """Miss ratio over the last ``window_s`` seconds (the SLO burn rate),
    kept in ``n_buckets`` sub-windows that expire lazily."""

    def __init__(self, window_s: float = 300.0, n_buckets: int = 30):
        if window_s <= 0 or n_buckets < 1:
            raise ValueError("window_s > 0 and n_buckets >= 1 required")
        self.window_s = float(window_s)
        self.bucket_s = self.window_s / int(n_buckets)
        self._lock = threading.Lock()
        self._buckets: Dict[int, list] = {}   # guarded-by: _lock

    # holds: _lock
    def _expire(self, now: float) -> None:
        horizon = now - self.window_s
        for k in [k for k in self._buckets
                  if (k + 1) * self.bucket_s <= horizon]:
            del self._buckets[k]

    def observe(self, miss: bool, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        k = int(now // self.bucket_s)
        with self._lock:
            self._expire(now)
            b = self._buckets.setdefault(k, [0, 0])
            b[0] += 1
            if miss:
                b[1] += 1

    def counts(self, now: Optional[float] = None) -> tuple:
        """(total, misses) inside the current window."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            total = sum(b[0] for b in self._buckets.values())
            misses = sum(b[1] for b in self._buckets.values())
        return total, misses

    def ratio(self, now: Optional[float] = None) -> Optional[float]:
        total, misses = self.counts(now)
        if total == 0:
            return None
        return misses / total


# ---------------------------------------------------------------------------
# Prometheus text exposition (version 0.0.4)
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_series(prefix: str, name: str, counter: bool = False) -> str:
    """Series of one counter or gauge key; a key may carry a label set
    (``name{adapter="x"}``): only the name part is sanitized and a
    counter's ``_total`` goes before the braces."""
    base, sep, labels = name.partition("{")
    n = _prom_name(prefix + base)
    if counter and not n.endswith("_total"):
        n += "_total"
    return n + sep + labels


def render_prometheus(counters: Dict[str, float], gauges: Dict[str, float],
                      histograms: Dict[str, "Histogram"],
                      prefix: str = "bllm_") -> str:
    """The ``GET /metrics`` body: counters with a ``_total`` suffix, gauges,
    and histograms as ``_bucket{le=}`` / ``_sum`` / ``_count`` series, one
    ``# TYPE`` line per metric name."""
    lines = []
    typed: set = set()

    def emit(name: str, v, kind: str, counter: bool) -> None:
        n = _prom_series(prefix, name, counter=counter)
        bare = n.partition("{")[0]
        if bare not in typed:
            typed.add(bare)
            lines.append(f"# TYPE {bare} {kind}")
        lines.append(f"{n} {v}")

    for name in sorted(counters):
        v = counters[name]
        if isinstance(v, (int, float)):
            emit(name, v, "counter", counter=True)
    for name in sorted(gauges):
        v = gauges[name]
        if isinstance(v, (int, float)):
            emit(name, v, "gauge", counter=False)
    for name in sorted(histograms):
        snap = histograms[name].snapshot()
        base, _sep, labels = name.partition("{")
        labels = labels[:-1] if labels else ""
        n = _prom_name(prefix + base)
        if n not in typed:
            typed.add(n)
            lines.append(f"# TYPE {n} histogram")
        pre = labels + "," if labels else ""
        suffix = "{" + labels + "}" if labels else ""
        for le, cum in snap["buckets"]:
            le_txt = "+Inf" if le == "+Inf" else repr(float(le))
            lines.append(f'{n}_bucket{{{pre}le="{le_txt}"}} {cum}')
        lines.append(f"{n}_sum{suffix} {snap['sum']}")
        lines.append(f"{n}_count{suffix} {snap['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the JSONL sink
# ---------------------------------------------------------------------------

class MetricLogger:
    """Counters, gauges and a typed JSONL sink. ``jsonl_path=None`` keeps
    the counters in memory and writes nothing. Every row is flushed when
    written, so a stopped server keeps every row up to its last one."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 coordinator_only: bool = True):
        self.jsonl_path = jsonl_path
        self.coordinator_only = coordinator_only
        # reentrant: a signal handler may emit while this thread writes
        self._lock = threading.RLock()
        self.counters: Dict[str, float] = {}      # guarded-by: _lock
        self.gauges: Dict[str, float] = {}        # guarded-by: _lock
        self._timings: Dict[str, float] = {}      # guarded-by: _lock
        self._file: Optional[IO[str]] = None      # guarded-by: _lock
        self._closed = False                      # guarded-by: _lock
        self._header_written = False              # guarded-by: _lock
        # rows emitted before the header wait for it
        self._pre_header: list = []               # guarded-by: _lock
        self._last_step = -1                      # guarded-by: _lock

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def timing(self, name: str, seconds: float) -> None:
        """Accumulating timing bucket, drained into the next metrics row
        as ``<name>_s``."""
        with self._lock:
            self._timings[name] = self._timings.get(name, 0.0) + seconds

    # holds: _lock
    def _writable(self) -> bool:
        if self.jsonl_path is None or self._closed:
            return False
        return not self.coordinator_only or _is_coordinator()

    def _write_row(self, row: Dict[str, Any]) -> None:
        """Append one row; never raises (a failed write is logged)."""
        try:
            with self._lock:
                if not self._writable():
                    return
                if not self._header_written and row.get("type") != "header":
                    self._pre_header.append(row)
                    return
                if self._file is None:
                    d = os.path.dirname(self.jsonl_path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    if (os.path.exists(self.jsonl_path)
                            and os.path.getsize(self.jsonl_path) > 0):
                        n = 1
                        while os.path.exists(f"{self.jsonl_path}.{n}"):
                            n += 1
                        os.rename(self.jsonl_path, f"{self.jsonl_path}.{n}")
                    self._file = open(self.jsonl_path, "a")
                self._file.write(json.dumps(_jsonable(row)) + "\n")
                self._file.flush()
        except OSError as e:
            logger.warning("Metrics sink write failed (%s); row dropped.", e)

    def write_header(self, **metadata: Any) -> None:
        row = {"type": "header", "time": time.time(),
               "schema_version": SCHEMA_VERSION}
        row.update(metadata)
        with self._lock:
            self._header_written = True
            buffered, self._pre_header = self._pre_header, []
        self._write_row(row)
        for b in buffered:
            self._write_row(b)

    def log_metrics(self, step: int, monotonic: bool = True,
                    **values: Any) -> None:
        """One ``metrics`` row: the drained timing buckets, the current
        counters and gauges, then ``values``."""
        with self._lock:
            timings = {f"{k}_s": round(v, 6) for k, v in self._timings.items()}
            self._timings.clear()
            extra = dict(self.counters)
            extra.update(self.gauges)
        row = {"type": "metrics", "time": time.time(), "step": int(step)}
        row.update(timings)
        row.update(extra)
        row.update(values)
        with self._lock:
            if monotonic and step < self._last_step and self.jsonl_path:
                logger.warning("Metrics row step went backwards (%d < %d)",
                               step, self._last_step)
            self._last_step = max(self._last_step, int(step))
        self._write_row(row)

    def log_health(self, step: int, groups, **arrays: Any) -> None:
        """One ``health`` row: the ordered group names and parallel
        per-group arrays (the ``obs/health.py`` bundle)."""
        row = {"type": "health", "time": time.time(), "step": int(step),
               "groups": list(groups)}
        row.update(arrays)
        self._write_row(row)

    def log_span(self, name: str, t0: float, dur_s: float,
                 cat: str = "span", children=None, **fields: Any) -> None:
        """One closed ``span`` row: ``t0`` unix seconds, ``dur_s`` its
        length, ``children`` one level of ``{"name", "t0", "dur_s"}``
        clamped inside the rounded root."""
        row: Dict[str, Any] = {"type": "span", "time": time.time(),
                               "name": name, "cat": cat,
                               "t0": round(float(t0), 6),
                               "dur_s": round(float(dur_s), 6)}
        if children:
            root_t0 = row["t0"]
            root_end = root_t0 + row["dur_s"]
            kids = []
            for c in children:
                ct0 = min(max(round(float(c["t0"]), 6), root_t0), root_end)
                cdur = max(min(round(float(c["dur_s"]), 6),
                               root_end - ct0), 0.0)
                kids.append({"name": c["name"], "t0": ct0, "dur_s": cdur})
            row["children"] = kids
        row.update(fields)
        self._write_row(row)

    def event(self, kind: str, step: Optional[int] = None,
              **fields: Any) -> None:
        """One typed ``event`` row (and the ``event:<kind>`` counter)."""
        self.count(f"event:{kind}")
        row = {"type": "event", "time": time.time(), "event": kind}
        if step is not None:
            row["step"] = int(step)
        row.update(fields)
        self._write_row(row)

    def close(self) -> None:
        """Flush rows still waiting for a header (a headerless file beats
        an empty one) and close the file; a closed sink stays closed."""
        with self._lock:
            buffered, self._pre_header = self._pre_header, []
            if buffered:
                self._header_written = True
        for b in buffered:
            self._write_row(b)
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            self._closed = True


_global_logger = MetricLogger(None)
_atexit_registered = False


def _close_global_at_exit() -> None:
    _global_logger.close()


def configure_metrics(jsonl_path: Optional[str],
                      run_metadata: Optional[Dict[str, Any]] = None
                      ) -> MetricLogger:
    """Install the process-wide sink (closing the previous one); with
    ``run_metadata`` the header is written now. ``None`` resets to the
    no-op sink."""
    global _global_logger, _atexit_registered
    _global_logger.close()
    _global_logger = MetricLogger(jsonl_path)
    if jsonl_path is not None and not _atexit_registered:
        import atexit

        atexit.register(_close_global_at_exit)
        _atexit_registered = True
    if jsonl_path is not None and run_metadata is not None:
        _global_logger.write_header(**run_metadata)
    return _global_logger


def get_metrics() -> MetricLogger:
    return _global_logger


def emit_event(kind: str, step: Optional[int] = None, **fields: Any) -> None:
    """Fire-and-forget event through the process-wide sink."""
    _global_logger.event(kind, step=step, **fields)


def run_metadata(args=None, cfg=None, plan=None) -> Dict[str, Any]:
    """The header row's metadata: torch and CUDA versions, the device, the
    process group, the mesh's shape (``plan``: a ``parallel.MeshPlan``),
    the model config, argv and the flags."""
    import dataclasses

    import torch

    from building_llm_from_scratch_tpu_torch.parallel import collectives

    cuda = torch.cuda.is_available()
    meta: Dict[str, Any] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "process_count": collectives.world(),
        "process_index": collectives.rank(),
        "local_device_count": 1,
        "argv": list(sys.argv),
        "mesh_shape": None,
    }
    mesh = getattr(plan, "mesh", None)
    if mesh is not None:
        meta["mesh_shape"] = {str(k): int(v) for k, v in mesh.shape.items()}
    if cfg is not None:
        meta["model"] = dataclasses.asdict(cfg)
    if args is not None:
        meta["flags"] = dict(vars(args))
    return meta
