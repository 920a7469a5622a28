"""Stall detector: dump every thread's stack and the device memory when
the loop it watches stops beating (port of the JAX package's
``obs/stall.py``).

A daemon thread fires when no heartbeat (``notify_step``) lands within
``timeout`` seconds, or within ``factor`` x the median interval once there
is history (floored at ``median_floor``), whichever is sooner. It logs the
stacks and ``torch.cuda.memory_stats()`` (``{}`` on the CPU), emits a
``stall`` event, calls ``on_stall(elapsed, threshold)`` and re-arms at the
next heartbeat. By itself it kills nothing: the serving supervisor's
``on_stall`` is what restarts a wedged loop. The first gap gets
``first_grace`` x the threshold."""

from __future__ import annotations

import logging
import sys
import threading
import time
import traceback
from typing import List, Optional

logger = logging.getLogger(__name__)


def format_all_stacks() -> str:
    """Every live Python thread's stack as one block."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts: List[str] = []
    for ident, frame in sys._current_frames().items():
        parts.append(f"--- Thread {names.get(ident, 'unknown')} "
                     f"(ident {ident}) ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts)


def _device_memory_report() -> dict:
    """The allocator's counters of each visible card (``{}`` without one):
    bytes in use, peak, reserved."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {}
        out = {}
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            }
        return out
    except Exception as e:
        return {"error": repr(e)}


class StallDetector:
    """See the module docstring. Heartbeats come from the watched loop,
    checks run on the detector's own thread."""

    def __init__(self, timeout: float, factor: float = 10.0,
                 poll_interval: float = 0.25, first_grace: float = 5.0,
                 median_floor: float = 30.0, history: int = 64,
                 on_stall=None):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0 seconds, got {timeout}")
        self.timeout = float(timeout)
        self.factor = float(factor)
        self.median_floor = float(median_floor)
        self.poll_interval = float(poll_interval)
        self.first_grace = float(first_grace)
        self.on_stall = on_stall
        self.stall_count = 0
        self._history_max = history
        self._intervals: List[float] = []           # guarded-by: _lock
        self._last: Optional[float] = None          # guarded-by: _lock
        self._fired_for_current_gap = False         # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def notify_step(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._last is not None:
                self._intervals.append(now - self._last)
                if len(self._intervals) > self._history_max:
                    del self._intervals[0]
            self._last = now
            self._fired_for_current_gap = False

    def threshold(self) -> float:
        with self._lock:
            intervals = list(self._intervals)
            armed = self._last is not None
        thr = self.timeout
        if len(intervals) >= 8:
            srt = sorted(intervals)
            thr = min(thr, max(self.factor * srt[len(srt) // 2],
                               self.median_floor))
        if armed and not intervals:
            thr *= self.first_grace
        return thr

    def _check(self) -> None:
        with self._lock:
            last = self._last
            fired = self._fired_for_current_gap
        if last is None or fired:
            return
        elapsed = time.monotonic() - last
        thr = self.threshold()
        if elapsed < thr:
            return
        with self._lock:
            if self._last != last:      # a heartbeat ended the gap meanwhile
                return
            self._fired_for_current_gap = True
        self.stall_count += 1
        self._dump(elapsed, thr)
        if self.on_stall is not None:
            try:
                self.on_stall(elapsed, thr)
            except Exception:
                logger.exception("stall callback failed")

    def _dump(self, elapsed: float, thr: float) -> None:
        mem = _device_memory_report()
        logger.error("STALL: no heartbeat in %.1fs (threshold %.1fs). "
                     "Thread stacks:\n%s\nDevice memory: %s",
                     elapsed, thr, format_all_stacks(), mem)
        from building_llm_from_scratch_tpu_torch.obs.metrics import emit_event

        emit_event("stall", elapsed_s=round(elapsed, 3),
                   threshold_s=round(thr, 3), memory=mem)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self._check()
            except Exception:
                logger.exception("stall detector check failed")

    def start(self) -> "StallDetector":
        if self._thread is not None:
            return self
        with self._lock:
            if self._last is None:
                # armed now: a loop that wedges before its first beat still
                # dumps (after first_grace x the threshold)
                self._last = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="stall-detector", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5 * self.poll_interval + 1)
            self._thread = None

    def __enter__(self) -> "StallDetector":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
