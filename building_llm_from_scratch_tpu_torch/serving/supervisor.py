"""Serving fault isolation: the injectable fault hooks and the tick
watchdog that restarts a wedged decode loop (port of the JAX package's
``serving/supervisor.py``).

The failure classes:
  - a poison request (a prefill that raises, a raising client callback)
    fails alone; its co-residents' tokens are those of a fault-free run;
  - non-finite logits (numerically poisoned KV) retire the slot with an
    error instead of streaming garbage (the engine's per-row finite guard);
  - a hung tick produces a flight record (every thread's stack and the
    device memory, ``obs/stall.StallDetector``) and a restart with bounded
    exponential backoff: the in-flight requests fail, the queue is kept,
    and the restarted loop serves with zero new kernel builds (the loaded
    kernel library survives; only the cache and the loop thread are new).

What a restart can and cannot recover on CUDA: a hang on the host (a
client callback that never returns, a lock held by a stuck thread, an
injected ``before_tick`` wait, a host-to-device copy waiting on a busy
device) is recovered, because the abandoned thread commits nothing after
the generation bump and launches only into the cache it took at the top
of its tick, never the new one. A wedged *kernel* cannot be
pre-empted from the host: the restarted loop's first launch queues behind
it on the same stream, and the flight record is all the supervisor can
give. While a restart runs, the abandoned thread still references the old
cache, so two caches are alive and the device peak rises by one cache.

``FaultHooks`` is the injection surface the fault tests drive; every hook
is a no-op in production. Hooks run inside the engine lock at fixed points
of the tick, so an injected hang looks like a real one to the watchdog.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from building_llm_from_scratch_tpu_torch.obs.stall import StallDetector

logger = logging.getLogger(__name__)


class FaultHooks:
    """Injectable fault points of the serving engine (all no-op; tests
    replace them):

    - ``before_tick(engine)``: start of every tick, in the engine lock.
      Block to simulate a hung tick; raise for a batch-wide loop fault.
    - ``before_prefill(request)``: before a request's prefill. Raise to
      make it a poison request that fails alone.
    - ``poison_nan(request) -> bool``: True overwrites the request's
      freshly prefilled KV with NaN, so its next decode tick goes
      non-finite on the device (the finite guard's path).
    - ``after_token(request, token)``: after each accepted token, in the
      lock. Sleep to simulate a slow consumer."""

    def before_tick(self, engine) -> None:
        pass

    def before_prefill(self, request) -> None:
        pass

    def poison_nan(self, request) -> bool:
        return False

    def after_token(self, request, token) -> None:
        pass


class EngineSupervisor:
    """Tick watchdog and restart policy of one ``DecodeEngine``. The loop
    beats once a tick (idle waits included) into a ``StallDetector`` that
    fires at exactly ``tick_timeout_s`` (its adaptive trigger is floored at
    the timeout); on fire the detector has dumped the flight record and the
    supervisor asks the engine to restart. At most ``max_restarts``, with
    backoff from ``backoff_s`` doubling; past the budget the engine dies
    loudly instead of flapping."""

    def __init__(self, engine, tick_timeout_s: float,
                 max_restarts: int = 3, backoff_s: float = 0.5):
        if tick_timeout_s <= 0:
            raise ValueError(f"tick_timeout_s must be > 0, got {tick_timeout_s}")
        self.engine = engine
        self.tick_timeout_s = float(tick_timeout_s)
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        # serializes stall callbacks; sits above the engine's locks: never
        # taken from engine code
        self._lock = threading.Lock()
        self.n_fires = 0                         # guarded-by: _lock
        self.detector = StallDetector(
            timeout=self.tick_timeout_s, median_floor=self.tick_timeout_s,
            first_grace=1.0, poll_interval=min(0.25, self.tick_timeout_s / 4),
            on_stall=self._on_stall)

    def notify_tick(self) -> None:
        self.detector.notify_step()

    def _on_stall(self, elapsed: float, threshold: float) -> None:
        with self._lock:
            self.n_fires += 1
            logger.error("Serving tick hung for %.1fs (threshold %.1fs): "
                         "restarting the decode loop (watchdog fire %d).",
                         elapsed, threshold, self.n_fires)
            if not self.engine._restart(
                    reason="hung_tick",
                    detail=f"tick made no progress for {elapsed:.1f}s"):
                self.engine._fail_all(
                    f"hung tick and restart budget exhausted "
                    f"({self.max_restarts} restarts)")

    def start(self) -> "EngineSupervisor":
        self.detector.start()
        return self

    def stop(self) -> None:
        self.detector.stop()


def make_serve_stall_detector(timeout_s: float,
                              on_stall: Optional[Callable] = None
                              ) -> StallDetector:
    """The flight recorder alone (``--stall_timeout`` without the
    supervisor): dumps stacks on a hung tick and restarts nothing."""
    return StallDetector(timeout=float(timeout_s),
                         median_floor=float(timeout_s), first_grace=2.0,
                         on_stall=on_stall)
